"""The extraction enhancement chain's NLM, CLAHE and unsharp: the wrappers
of K10, K11 and K14 (``csrc/enhance.cu``); their plain twins are
``ops/enhance.py``'s ``nlm_planes_plain``, ``clahe_luts_plain``,
``clahe_apply_plain`` and ``unsharp_plain``.

The JAX package has no ``pl.pallas_call`` for these: ``nlm_gray_u8``
(``dctsvd_tpu/ops/enhance.py:189``, a jitted ``lax.scan`` over the 441
offsets of the search window), ``nlm_color_u8`` (``:234``), ``clahe_u8``
(``:92``) and ``unsharp_u8`` (``:76``, over ``gaussian_blur`` ``:45``) are
XLA graphs.

  - K10 ``nlm_planes`` (``nlm_kernel``): u8 planes [P, H, W] and h² [P]
    (f32) -> u8 planes: NLM with a 7×7 template and a 21×21 search window
    (gray: a plane a frame, h² 49; color: the Y, Cr and Cb planes of each
    frame, h² 9 each).
  - K11 ``clahe_luts`` (``clahe_lut_kernel``): u8 planes [P, H, W] -> the
    tiles' u8 LUTs [P, tiles², 256]; ``clahe_apply``
    (``clahe_apply_kernel``): the planes and their LUTs -> u8 planes;
    ``clahe``: both in one host call (``dctsvd_clahe``), the form
    ``ops/enhance.py::clahe_u8`` takes. ``clahe_plan`` gives the LUT
    stage's row strips.
  - K14 ``unsharp`` (``unsharp_kernel<C>``): u8 planes [..., H, W], or
    BGR frames [..., H, W, 3] each channel blurred as its own plane, ->
    u8: round(amount·e + weight·blur_σ(e)) saturated, the blur
    ``gaussian_blur``'s bytes (``csrc/blur.cuh``) at σ 1 (7 taps), the
    only σ either chain takes.

What each computes, in which order, what bounds it and what its design
does about that: ``csrc/enhance.cu``'s header. The window sums are exact
integers, so only the weights' sums fix NLM's order; every division is
one IEEE division in kernel and twin alike. So each kernel is bit-equal
(``torch.equal``) to its twin run on the card. ``nlm_weights`` launches
K10's weight function alone over window sums 0 .. n − 1, for the check
that its ``expf`` is torch's ``exp`` on every weight NLM can take.

Each wrapper runs its twin only for CPU tensors; for CUDA tensors it
launches its kernel or raises. Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from dctsvd_tpu_torch.ops.dct import host_constant
from dctsvd_tpu_torch.ops.enhance import (_gauss1d, clahe_apply_plain,
                                          clahe_luts_plain, clahe_params,
                                          clahe_plain, nlm_planes_plain,
                                          nlm_weights_plain, unsharp_plain)
from dctsvd_tpu_torch.ops.wm_cuda import _device_ok
from dctsvd_tpu_torch.utils import kernels

__all__ = ["nlm_planes", "clahe_luts", "clahe_apply", "clahe", "clahe_plan",
           "nlm_weights", "unsharp", "nlm_planes_plain", "clahe_luts_plain",
           "clahe_apply_plain", "clahe_plain", "nlm_weights_plain",
           "unsharp_plain",
           "TEMPLATE", "SEARCH", "MAX_WINDOW_SUM", "UNSHARP_SIGMA"]

TEMPLATE, SEARCH = 7, 21   # the kernel's template and search window
#: The largest 7×7 window sum of squared u8 differences.
MAX_WINDOW_SUM = TEMPLATE * TEMPLATE * 255 * 255
#: K10's tiling (csrc/enhance.cu): a CTA's tile (kNlmTileW, kNlmTileH); the
#: pixels a thread sums down one column (kNlmRun) and the row sums a
#: pass-1 item makes along one row (kNlmRowRun).
NLM_TILE = (32, 64)
NLM_RUN = 16
NLM_ROW_RUN = 32
MAX_GRID = 65535           # rows a CLAHE launch takes (grid y)
UNSHARP_SIGMA = 1.0        # K14's blur: σ 1, 7 taps
UNSHARP_ROWS = 32          # K14's row band (kUnsharpRows)
#: K11's LUT stage launches at least this many CTAs a plane batch an SM
#: (row strips of each tile), and its interpolation a CTA of
#: ``CLAHE_APPLY_ROWS`` rows stages the at most ``CLAHE_STAGE_ROWS`` LUT
#: rows those rows touch (kApplyRows, kStageRows).
CLAHE_CTAS_PER_SM = 2
CLAHE_APPLY_ROWS = 2
CLAHE_STAGE_ROWS = 3


class ClahePlan(NamedTuple):
    """K11's launch shape on P planes of H × W (``clahe_plan``)."""
    strips: int        # row strips a tile in the LUT stage
    strip_rows: int    # tile rows a strip


@functools.lru_cache(maxsize=64)
def clahe_plan(p: int, h: int, w: int, tiles: int, sms: int) -> ClahePlan:
    """K11's LUT stage's launch shape for ``p`` planes of ``h`` × ``w``
    on a card of ``sms`` SMs: each of the tiles² tiles (th × tw pixels)
    split into row strips, a CTA a strip, so that a launch has at least
    ``CLAHE_CTAS_PER_SM`` CTAs an SM (a tile has at most th strips; a
    1080p plane on the H100's 132 SMs: 5 strips of 27 rows, 320 CTAs)."""
    th = -(-h // tiles)
    want = -(-CLAHE_CTAS_PER_SM * sms // (tiles * tiles * max(p, 1)))
    # the fewest strips from want on (th at most) with none left empty by
    # the kernel's ceil(th / strips) rows a strip
    strips = max(1, min(th, want))
    while (strips - 1) * -(-th // strips) >= th:
        strips += 1
    return ClahePlan(strips, -(-th // strips))


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# K11's scratch a (device, stream): int32 histograms [P, tiles², 256] then
# tickets [P, tiles²], zeroed once when made (each launch's finishing CTAs
# leave what they used zero again, so no call clears them), and the LUTs
# u8 [P, tiles², 256] that the one-call form passes between its stages,
# in a buffer of their own (never inside a larger batch's histograms).
# One a stream, since two streams' launches could overlap.
_CLAHE_SCRATCH: dict = {}


def _clahe_scratch(device: torch.device, p: int, tiles: int) -> tuple:
    """(counts, LUTs) of K11's scratch for ``p`` planes on the current
    stream of ``device``: int32 [≥ p tiles² 257] zero, u8 [≥ p tiles²
    256]."""
    n = p * tiles * tiles
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _CLAHE_SCRATCH.get(key)
    if buf is None or buf[1].numel() < n * 256:
        buf = (torch.zeros((n * 257,), dtype=torch.int32, device=device),
               torch.empty((n * 256,), dtype=torch.uint8, device=device))
        _CLAHE_SCRATCH[key] = buf
    return buf


def _check_planes(name: str, planes: torch.Tensor) -> tuple:
    """(P, H, W) of u8 planes; raises for another dtype or rank, or a plane
    of 2^31 pixels or more (the kernels' offsets in a plane are 32-bit)."""
    if planes.dtype != torch.uint8 or planes.ndim != 3:
        raise ValueError(f"{name}: takes u8 planes [P, H, W], got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    p, h, w = planes.shape
    if h * w >= 1 << 31:
        raise ValueError(f"{name}: a plane of {h}x{w} is too large for the "
                         "kernel")
    return p, h, w


def nlm_planes(planes: torch.Tensor, h2: torch.Tensor, template: int = 7,
               search: int = 21) -> torch.Tensor:
    """NLM of u8 planes [P, H, W] with h² [P] (f32): K10 on CUDA tensors
    (a 7×7 template and a 21×21 search window only), its twin on CPU
    tensors."""
    p, h, w = _check_planes("nlm_planes", planes)
    if h2.dtype != torch.float32 or tuple(h2.shape) != (p,):
        raise ValueError(f"nlm_planes: h2 must be f32 [{p}], got "
                         f"{h2.dtype} {tuple(h2.shape)}")
    if _device_ok("nlm_planes", planes, h2):
        return nlm_planes_plain(planes, h2, template, search)
    if (template, search) != (TEMPLATE, SEARCH):
        raise ValueError(f"nlm_planes: the kernel takes a {TEMPLATE}x"
                         f"{TEMPLATE} template and a {SEARCH}x{SEARCH} "
                         f"search window, got {template} and {search}")
    x, h2 = planes.contiguous(), h2.contiguous()
    out = torch.empty_like(x)
    if out.numel():
        kernels.launch("dctsvd_nlm", x.device, x, h2, out, p, h, w)
        nlm_planes.launches += 1
    return out


def clahe_luts(planes: torch.Tensor, tiles: int = 8,
               clip_limit: float = 2.0) -> torch.Tensor:
    """The CLAHE LUTs of u8 planes [P, H, W]: u8 [P, tiles², 256]. K11's
    LUT kernel on a CUDA tensor, its twin on a CPU tensor."""
    p, h, w = _check_planes("clahe_luts", planes)
    if not 1 <= tiles <= 255:
        raise ValueError(f"clahe_luts: tiles must be in 1..255, got {tiles}")
    if _device_ok("clahe_luts", planes):
        return clahe_luts_plain(planes, tiles, clip_limit)
    x = planes.contiguous()
    luts = torch.empty((p, tiles * tiles, 256), dtype=torch.uint8,
                       device=x.device)
    if x.numel():
        limit = clahe_params(h, w, tiles, clip_limit)[2]
        plan = clahe_plan(p, h, w, tiles, _sms(x.device.index))
        kernels.launch("dctsvd_clahe_luts", x.device, x, luts,
                       _clahe_scratch(x.device, p, tiles)[0], p, h, w, tiles,
                       int(limit), plan.strips)
        clahe_luts.launches += 1
    return luts


def clahe_apply(planes: torch.Tensor, luts: torch.Tensor,
                tiles: int = 8) -> torch.Tensor:
    """u8 planes [P, H, W] through their tiles' LUTs [P, tiles², 256]
    (``clahe_luts``), bilinearly blended: u8 [P, H, W]. K11's
    interpolation kernel on CUDA tensors, its twin on CPU tensors."""
    p, h, w = _check_planes("clahe_apply", planes)
    if luts.dtype != torch.uint8 or tuple(luts.shape) != (p, tiles * tiles,
                                                          256):
        raise ValueError(f"clahe_apply: luts must be u8 [{p}, "
                         f"{tiles * tiles}, 256], got {luts.dtype} "
                         f"{tuple(luts.shape)}")
    if _device_ok("clahe_apply", planes, luts):
        return clahe_apply_plain(planes, luts, tiles)
    if h > MAX_GRID:
        raise ValueError(f"clahe_apply: {h} rows, the kernel takes at most "
                         f"{MAX_GRID}")
    x, luts = planes.contiguous(), luts.contiguous()
    out = torch.empty_like(x)
    if out.numel():
        kernels.launch("dctsvd_clahe_apply", x.device, x, luts, out, p, h, w,
                       tiles)
        clahe_apply.launches += 1
    return out


def clahe(planes: torch.Tensor, tiles: int = 8,
          clip_limit: float = 2.0) -> torch.Tensor:
    """CLAHE of u8 planes [P, H, W] -> u8 [P, H, W]: on a CUDA tensor
    both K11 kernels, the LUTs then the interpolation, launched on the
    current stream by one host call (``dctsvd_clahe``), each counted once
    in ``clahe_luts.launches`` and ``clahe_apply.launches`` (and the call
    in ``clahe.launches``); on a CPU tensor the twin ``clahe_plain``."""
    p, h, w = _check_planes("clahe", planes)
    if not 1 <= tiles <= 255:
        raise ValueError(f"clahe: tiles must be in 1..255, got {tiles}")
    if _device_ok("clahe", planes):
        return clahe_plain(planes, tiles, clip_limit)
    if h > MAX_GRID:
        raise ValueError(f"clahe: {h} rows, the kernel takes at most "
                         f"{MAX_GRID}")
    x = planes.contiguous()
    out = torch.empty_like(x)
    if out.numel():
        limit = clahe_params(h, w, tiles, clip_limit)[2]
        plan = clahe_plan(p, h, w, tiles, _sms(x.device.index))
        counts, luts = _clahe_scratch(x.device, p, tiles)
        kernels.launch("dctsvd_clahe", x.device, x, luts, out, counts, p, h,
                       w, tiles, int(limit), plan.strips)
        clahe_luts.launches += 1
        clahe_apply.launches += 1
        clahe.launches += 1
    return out


def nlm_weights(n: int, h2: torch.Tensor) -> torch.Tensor:
    """K10's weights exp(−((D / 49) / h²)) of the window sums D = 0 .. n − 1
    at one h² (a 0-d f32 tensor): f32 [n]. The kernel's weight function on
    a CUDA ``h2``, the twin's on a CPU one."""
    if h2.dtype != torch.float32 or h2.numel() != 1:
        raise ValueError(f"nlm_weights: h2 must be one f32, got {h2.dtype} "
                         f"{tuple(h2.shape)}")
    if not 0 < n < 1 << 24:
        raise ValueError(f"nlm_weights: n must be in 1..2^24 - 1, got {n}")
    if _device_ok("nlm_weights", h2):
        d2 = torch.arange(n, dtype=torch.float32)
        return nlm_weights_plain(d2, h2.reshape(()), TEMPLATE * TEMPLATE)
    out = torch.empty((n,), dtype=torch.float32, device=h2.device)
    kernels.launch("dctsvd_nlm_weights", h2.device, h2.contiguous(), out, n)
    nlm_weights.launches += 1
    return out


def unsharp(img_u8: torch.Tensor, amount: float, blur_weight: float,
            sigma: float = 1.0, channels_last: bool = False) -> torch.Tensor:
    """The unsharp mask of u8 planes [..., H, W], or of each channel of u8
    frames [..., H, W, C] with ``channels_last``: K14 on a CUDA tensor
    (σ 1; C 1 or 3), its twin on a CPU tensor."""
    if img_u8.dtype != torch.uint8 or img_u8.ndim < (3 if channels_last
                                                     else 2):
        raise ValueError(f"unsharp: takes u8 planes [..., H, W] or frames "
                         f"[..., H, W, C], got {img_u8.dtype} "
                         f"{tuple(img_u8.shape)}")
    if _device_ok("unsharp", img_u8):
        return unsharp_plain(img_u8, amount, blur_weight, sigma,
                             channels_last)
    c = img_u8.shape[-1] if channels_last else 1
    if c not in (1, 3):
        raise ValueError(f"unsharp: the kernel takes 1 or 3 channels, got "
                         f"{c}")
    if sigma != UNSHARP_SIGMA:
        raise ValueError(f"unsharp: the kernel takes sigma "
                         f"{UNSHARP_SIGMA}, got {sigma}")
    ksize = int(round(sigma * 6 + 1)) | 1
    h, w = img_u8.shape[-3:-1] if channels_last else img_u8.shape[-2:]
    if -(-h // UNSHARP_ROWS) > MAX_GRID:
        raise ValueError(f"unsharp: {h} rows, the kernel takes at most "
                         f"{MAX_GRID * UNSHARP_ROWS}")
    x = img_u8.contiguous()
    out = torch.empty_like(x)
    if out.numel():
        kernels.launch("dctsvd_unsharp", x.device, x, out,
                       host_constant(_gauss1d, ksize, sigma, device="cpu"),
                       float(np.float32(amount)),
                       float(np.float32(blur_weight)),
                       x.numel() // (h * w * c), h, w, c)
        unsharp.launches += 1
    return out


nlm_planes.launches = 0
clahe_luts.launches = 0
clahe_apply.launches = 0
clahe.launches = 0
nlm_weights.launches = 0
unsharp.launches = 0

