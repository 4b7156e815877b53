"""The measurement probes of ``tools/`` as kernels, with their plain twins:
copy_f32, cols_view, fma_chain and spectrum_probe (``csrc/probes.cu``).

  - ``copy_f32`` replaces the identity-copy Pallas kernels of
    ``tools/profile_transpose.py::copy_consumer`` (T2a) and
    ``tools/profile_view.py::transpose_forced`` (T6b). Twin: ``clone()``.
  - ``cols_view`` replaces ``tools/profile_transpose.py`` ``gatherk`` (T2b)
    and stands for the relayout the T4–T6 probes do outside their kernels
    (``wm_pallas._plane_cols_view``): natural planes ``[..., H, W]`` ->
    the cols view ``[P, Hb, 8(row), 8(col), Wb]``, element (r, c) of block
    (p, by, bx) at ``[p, by, r, c, bx]``. u8 in gives a u8, bf16 or f32
    view; f32 in an f32 view.
  - ``fma_chain`` replaces ``tools/exp_vpu_roofline.py::_make_kernel``
    (T3): per element ``acc <- acc·1.0000001 + x``, as 8 independent
    chains (``'ilp8'``) or one (``'serial'``), with separate multiplies and
    adds or, ``fused``, one FMA per update.
  - ``spectrum_probe`` replaces the probe spectra of T1
    (``exp_relayout.py``), T4 (``exp_widen.py``), T5
    (``exp_cachednorms.py``) and T6a (``profile_view.py``): K1's one-sided
    Jacobi at an integer schedule (0 gives the sorted column norms) on
    f32 natural planes (``layout='strided'`` or ``'smem'``) or on a u8,
    bf16 or f32 cols view (``'cols'``), with the final values from fresh
    norms or, ``cached`` (f32 cols view), from the Rutishauser-cached ones.
    Spectra come back as ``[P, N, 8]``, ``n = by·Wb + bx``, as K1's do.

Each wrapper runs its twin only for CPU tensors; for a CUDA tensor it
launches its kernel or raises. Each counts its own launches in
``.launches``.
"""

from __future__ import annotations

import torch

from dctsvd_tpu_torch.ops import dct
from dctsvd_tpu_torch.ops.svd_cuda import B, _jacobi8, _sort8
from dctsvd_tpu_torch.ops.wm_cuda import _check, _device_ok, _layout
from dctsvd_tpu_torch.utils import kernels

__all__ = ["LAYOUTS", "CHAIN_MODES", "chain_steps", "copy_f32", "cols_view",
           "fma_chain", "spectrum_probe", "copy_f32_plain", "cols_view_plain",
           "fma_chain_plain", "spectrum_probe_plain", "copy_f32_grid",
           "cols_view_plan"]

LAYOUTS = ("strided", "smem", "cols")        # the C enum's order
CHAIN_MODES = ("ilp8", "serial")
CHAIN_C = 1.0000001
_KIND = {torch.uint8: 0, torch.bfloat16: 1, torch.float32: 2}
_VIEW_KINDS = {(torch.uint8, torch.uint8), (torch.uint8, torch.bfloat16),
               (torch.uint8, torch.float32), (torch.float32, torch.float32)}
_PROBE_KINDS = {("strided", torch.float32, False),
                ("smem", torch.float32, False),
                ("cols", torch.uint8, False), ("cols", torch.bfloat16, False),
                ("cols", torch.float32, False), ("cols", torch.float32, True)}


def _planes(x: torch.Tensor):
    """(P, H, W) of u8 or f32 natural planes [..., H, W]; H and W
    multiples of 8."""
    _check(x, False)
    p, _, h, w = _layout(x, False)
    return p, h, w


COPY_CHUNK4 = 256          # float4s a CTA of copy_f32 (256 threads)
VIEW_WARPS = 4             # warps a CTA of cols_view's vector path,
VIEW_CTAS_PER_SM = 6       # and CTAs an SM (csrc/probes.cu kView*)
CHUNK_BYTES = 128          # a thread's input chunk in that path


def copy_f32_grid(n4: int) -> int:
    """CTAs of copy_f32 for ``n4`` float4s: one a chunk, over the whole
    array (the last one partial)."""
    return -(-n4 // COPY_CHUNK4)


def copy_f32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of copy_f32."""
    return x.clone()


def copy_f32(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of an f32 tensor: the kernel on a CUDA tensor
    (contiguous, a multiple of 4 elements, 16-byte aligned), its twin on
    a CPU tensor."""
    if x.dtype != torch.float32:
        raise ValueError(f"copy_f32 takes float32, got {x.dtype}")
    if _device_ok("copy_f32", x):
        return copy_f32_plain(x)
    if not x.is_contiguous() or x.numel() % 4 or x.data_ptr() % 16:
        raise ValueError("copy_f32 takes a contiguous tensor of a multiple "
                         "of 4 elements on a 16-byte boundary")
    y = torch.empty_like(x)
    if x.numel():
        n4 = x.numel() // 4
        kernels.launch("dctsvd_copy_f32", x.device, x, y, n4,
                       copy_f32_grid(n4))
        copy_f32.launches += 1
    return y


def cols_view_plan(rows: int, w: int, in_size: int, x_ptr: int, y_ptr: int,
                   sms: int) -> tuple:
    """(vector, grid) of cols_view on ``rows`` pixel rows of ``w`` pixels
    of ``in_size`` bytes, from x at ``x_ptr`` to y at ``y_ptr``. The
    vector path moves a 128-byte chunk of one pixel row a thread (4 f32 or
    16 u8 blocks) and stores 16 bytes at a time, so it needs both
    pointers on 16-byte boundaries and Wb a multiple of the chunk's
    blocks. Its warps stride over tiles of 32 chunks, so its grid is a
    CTA of 4 warps for every 4 tiles, up to the 6 CTAs an SM holds.
    Anything else takes the scalar path, one thread an element, 256 a
    CTA, up to 8 CTAs an SM."""
    wb = w // B
    chunk_blocks = CHUNK_BYTES // (B * in_size)
    vector = wb % chunk_blocks == 0 and x_ptr % 16 == 0 and y_ptr % 16 == 0
    if vector:
        want = -(-rows * (wb // chunk_blocks) // (VIEW_WARPS * 32))
        cap = sms * VIEW_CTAS_PER_SM
    else:
        want, cap = -(-rows * w // 256), sms * 8
    return vector, max(1, min(want, cap))


def cols_view_plain(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Plain twin of cols_view: ``swapaxes(x.reshape(P, Hb, 8, Wb, 8),
    -1, -2)`` in ``dtype``, contiguous."""
    p, h, w = _planes(x)
    v = x.reshape(p, h // B, B, w // B, B).permute(0, 1, 2, 4, 3)
    return v.to(x.dtype if dtype is None else dtype).contiguous()


def cols_view(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Natural planes [..., H, W] (u8 or f32) -> the cols view
    [P, Hb, 8, 8, Wb] in ``dtype`` (default: x's). The kernel on a CUDA
    tensor (its vector or scalar path, :func:`cols_view_plan`), its twin
    on a CPU tensor."""
    dtype = x.dtype if dtype is None else dtype
    if (x.dtype, dtype) not in _VIEW_KINDS:
        raise ValueError(f"cols_view: no {x.dtype} -> {dtype} view")
    p, h, w = _planes(x)
    if _device_ok("cols_view", x):
        return cols_view_plain(x, dtype)
    x = x.contiguous()
    y = torch.empty((p, h // B, B, B, w // B), dtype=dtype, device=x.device)
    if y.numel():
        sms = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        vector, grid = cols_view_plan(p * h, w, x.element_size(),
                                      x.data_ptr(), y.data_ptr(), sms)
        kernels.launch("dctsvd_cols_view", x.device, x, _KIND[x.dtype], y,
                       _KIND[dtype], p * h, w, int(vector), grid)
        cols_view.launches += 1
    return y


def chain_steps(mode: str, n_ops: int) -> tuple:
    """(steps, counted operations per element) of a chain of ``n_ops``,
    counted as tools/exp_vpu_roofline.py counts them: ``'ilp8'`` starts at
    8 (the initial products) and adds 2 per update, 8 updates a round,
    until it reaches n_ops (steps = rounds; the 7 final adds go
    uncounted); ``'serial'`` adds 2 per update (steps = updates)."""
    if mode not in CHAIN_MODES:
        raise ValueError(f"unknown chain mode {mode!r}; expected one of "
                         f"{CHAIN_MODES}")
    if mode == "ilp8":
        rounds = max(0, -(-(n_ops - 8) // 16))
        return rounds, 8 + 16 * rounds
    steps = max(0, -(-n_ops // 2))
    return steps, 2 * steps


def fma_chain_plain(x: torch.Tensor, n_ops: int, mode: str = "ilp8",
                    fused: bool = False) -> torch.Tensor:
    """Plain twin of fma_chain. ``fused`` forms each update in float64
    (the product of two floats is exact there) and rounds it to float
    once, which is the FMA's single rounding except where the float64 sum
    itself rounded onto a float tie (double rounding)."""
    steps, _ = chain_steps(mode, n_ops)
    if fused:
        c = torch.tensor(CHAIN_C, dtype=torch.float32).double()
        xd = x.double()

        def step(acc):
            return (acc.double() * c + xd).float()
    else:
        def step(acc):
            return acc * CHAIN_C + x
    if mode == "serial":
        out = x
        for _ in range(steps):
            out = step(out)
        return out
    accs = [x * (1.0 + 0.0625 * k) for k in range(8)]
    for _ in range(steps):
        accs = [step(a) for a in accs]
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def fma_chain(x: torch.Tensor, n_ops: int, mode: str = "ilp8",
              fused: bool = False) -> torch.Tensor:
    """The f32 chain of ``n_ops`` counted operations per element of x: the
    kernel on a CUDA tensor, its twin on a CPU tensor."""
    if x.dtype != torch.float32:
        raise ValueError(f"fma_chain takes float32, got {x.dtype}")
    steps, _ = chain_steps(mode, n_ops)
    if _device_ok("fma_chain", x):
        return fma_chain_plain(x, n_ops, mode, fused)
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel():
        kernels.launch("dctsvd_fma_chain", x.device, x, y, x.numel(), steps,
                       int(mode == "ilp8"), int(fused))
        fma_chain.launches += 1
    return y


def _probe_shape(x: torch.Tensor, layout: str):
    """(P, H, W) of natural planes or of a cols view [P, Hb, 8, 8, Wb]."""
    if layout != "cols":
        return _planes(x)
    if x.ndim != 5 or tuple(x.shape[2:4]) != (B, B):
        raise ValueError(f"a cols view is [P, Hb, 8, 8, Wb], got "
                         f"{tuple(x.shape)}")
    p, hb, _, _, wb = x.shape
    return p, hb * B, wb * B


def _probe_sweeps(sweeps) -> int:
    if isinstance(sweeps, bool) or int(sweeps) != sweeps or sweeps < 0:
        raise ValueError(f"the spectrum probe takes an integer sweep count "
                         f">= 0, got {sweeps!r}")
    return int(sweeps)


def spectrum_probe_plain(x: torch.Tensor, sweeps: int = 4,
                         layout: str = "cols",
                         cached: bool = False) -> torch.Tensor:
    """Plain twin of spectrum_probe: [P, N, 8], sorted descending."""
    full = _probe_sweeps(sweeps)
    p, h, w = _probe_shape(x, layout)
    n = (h // B) * (w // B)
    if layout == "cols":
        g = [x[:, :, :, c, :].to(torch.float32).permute(0, 1, 3, 2)
             .reshape(p, n, B) for c in range(B)]
    else:
        blocks = dct.blockify(x.reshape(p, h, w).to(torch.float32))
        g = [blocks[..., :, c] for c in range(B)]
    s = _jacobi8(g, full, 0, cached=cached)
    _sort8(s)
    return torch.stack(s, dim=-1)


def spectrum_probe(x: torch.Tensor, sweeps: int = 4, layout: str = "cols",
                   cached: bool = False) -> torch.Tensor:
    """Per-block singular values [P, N, 8] of f32 natural planes
    [..., H, W] (``layout`` 'strided' or 'smem') or of a u8/bf16/f32 cols
    view (``'cols'``) at ``sweeps`` full sweeps (an int, 0 allowed). The
    kernel on a CUDA tensor, its twin on a CPU tensor. On the card,
    'strided' reads a plane that is not 16-byte aligned a float a load (an
    instance of its own); 'smem' stages 16-byte pieces and raises
    ValueError for such a plane."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of "
                         f"{LAYOUTS}")
    if (layout, x.dtype, bool(cached)) not in _PROBE_KINDS:
        raise ValueError(f"spectrum_probe has no {layout} {x.dtype} "
                         f"instance{' with cached norms' if cached else ''}")
    full = _probe_sweeps(sweeps)
    p, h, w = _probe_shape(x, layout)
    if _device_ok("spectrum_probe", x):
        return spectrum_probe_plain(x, full, layout, cached)
    x = x.contiguous()
    if layout == "smem" and x.data_ptr() % 16:
        raise ValueError("spectrum_probe: the 'smem' layout stages 16-byte "
                         "pieces and needs a 16-byte aligned plane")
    out = torch.empty(p, (h // B) * (w // B), B, dtype=torch.float32,
                      device=x.device)
    if out.numel():
        kernels.launch("dctsvd_spectrum_probe", x.device, x, _KIND[x.dtype],
                       LAYOUTS.index(layout), int(cached), out, p, h, w, full)
        spectrum_probe.launches += 1
    return out


copy_f32.launches = 0
cols_view.launches = 0
fma_chain.launches = 0
spectrum_probe.launches = 0
