"""The blocked extract tail's kernels and their plain twins: K18, the
presence statistic (``csrc/presence.cu``), K5f, the front stage that both
tail forms read, K8 (with K8u, its crop), the default form's normaliser,
and K5, the recompute form's two passes (``csrc/extract_tail.cu``).

K18 ``presence`` replaces the reduction inside the XLA fusion of
``dctsvd_tpu/models/blocked.py::_shrink_sw_hat`` (:767-792; no
``pl.pallas_call``): per plane, the Pearson of column 0 of the raw
estimate against ``sw``'s over 16..31 contiguous block groups (each
group's sums in K9's fixed order: thread t of 256 adds blocks t, t + 256,
..., then a fixed tree; the means first, the centred sums in a second
pass), the ⌈ng/4⌉-th largest of them (NaN last, as torch.sort), and the
decision ``rho0 >= 0.20 + 1.8/√gsz`` (:func:`presence_knee`, the JAX
package's f32 value). Its twin walks the same order, so K18 is bit-equal
to it on the card and a frame's decision is the same alone or in a batch.

K5f ``tail_front`` replaces the front of the XLA fusion of
``dctsvd_tpu/models/blocked.py::_extract_tail_prepared`` (:1003-1016; no
``pl.pallas_call``): from the stego and cover spectra ``s_cw``, ``sc``
[..., (C,) N, 8] (slot order) it writes the natural-order estimates
[..., (C,) N, k], or [..., (C,) N, k + 1] with the erasure flag (1.0 / 0.0)
in column k when ``sw`` is given:

    raw = (s_cw - sc) / max(α, 1e-8), then _shrink_sw_hat's elementwise
    step with the caller's ``engage`` [..., (C,)] and ``scale`` [(C,)],
    then the slot -> natural gather through ``inv_blk``.

The presence decision (K18) and the scale (an eager mean over the shared
sw, models/blocked.py::_sw_scale) come from the caller. On the card the rows
are round_up(k + 1, 4) floats (the returned tensor is a view of their
first columns), the layout K5 reads with 16-byte loads.

K5 ``recon_normalize`` replaces the XLA fusion of
``dctsvd_tpu/models/blocked.py::_normalize_blocks_recompute`` (reached
through ``_extract_tail_prepared(recompute=True)``; no ``pl.pallas_call``):
from the natural-order estimates ``x`` [..., (C,) N, k] (or k + 1 columns,
the erasure flag in column k, > 0.5) and the pixel basis ``eb64``
[(C,) N, k, 64] it rebuilds each block's 64 pixels

    y = x_0·e_0, then y = y + x_j·e_j for j = 1..k-1

in two passes, never storing the f32 reconstruction: a min–max pass for the
plane's window (over unflagged blocks, or over all when that is not
finite), then a paint pass that repaints flagged blocks at the window's
midpoint, maps the window to [0, 255] and writes u8 (clamped, truncated)
or f32 channels-last frames [..., H, W, C] or planes [..., (C,) H, W].

K8 ``normalize_blocks`` replaces the XLA fusion of the default form,
``dctsvd_tpu/models/blocked.py::_normalize_blocks`` with the clip, cast
and unblockify after it (``_extract_tail_prepared(recompute=False)`` at
block-aligned sizes; no ``pl.pallas_call``): K5's window, repaint and
stores, with each block's 64 pixels read from the materialised
reconstruction ``blocks`` [..., (C,) N, 64] (models/blocked.py::_recon's
strided view) and the erasure flags from column k of ``x``. Its twin is
the eager form. Two instances, chosen on the host by :func:`norm_plan`
from the shape and the card's SMs and shared memory:

- resident (the 1080p batches): one CTA an SM, launched cooperatively,
  holds an equal share of each frame's blocks (:func:`block_shares`) in
  shared memory from its load to its paint, with a grid barrier a frame
  between the window and the paint, so the reconstruction is read from
  device memory once; each CTA decodes its planes' (lo, scale, fill)
  itself. A plan whose CTAs cannot all be resident is refused by the
  launch and raises :class:`~dctsvd_tpu_torch.utils.kernels.KernelError`.
- two-pass (a frame whose share does not fit, as a 4K color frame or an 8K
  band; a small frame whose share fits four times, as 512x512 gray; calls
  without normalize): a window kernel, a tiny params kernel and a paint
  kernel, the reconstruction read in each pass.

The scale is one IEEE division, ``255 / max(hi - lo, 1e-12)``, as the JAX
package's ``255.0 / x``: torch's ``255.0 / t`` is ``t.reciprocal() * 255``,
which rounds twice, so the twin writes ``torch.div`` and the kernel
``__fdiv_rn``.

K8u is K8 given a crop: where H or W is not a multiple of 8 (the tail's
unaligned sizes, and the request extract, models/blocked.py::
_extract_planes, at every size), the blocks cover the padded ceil(H/8) x
ceil(W/8) grid, the window takes only the pixels inside the H x W crop
and the paint stores only those, into H x W frames. It replaces the XLA
fusion of ``dctsvd_tpu/models/blocked.py::_masked_normalize`` (:818) with
the clip, cast, unblockify and crop around it; its twin is K8's, given the
crop, byte-equal to ``_masked_normalize`` then the clip and cast. Either
instance takes a crop, and :func:`shape_plan` picks one as for the padded
grid: the resident one wherever a frame's share fits as at 1080p (1079 x
1917 color or gray, 1366 x 768 color), the two-pass one elsewhere (854 x
480, 1366 x 768 gray, 4K). Both are bound as without the crop (bytes: the
product read once or twice). What the crop adds is its stores: a cropped
row starts on no word boundary of the output, so each warp's row of
blocks is realigned to the output's words, u8 through a stage in shared
memory (the resident ring gives up 4 KB a plane for it), and stored as
16-byte words, 4-byte words at the ends, and the bytes of a partial word
at either end one at a time; f32 rows are each lane's own words.

Each wrapper runs its twin only for CPU tensors; for CUDA tensors it
launches its kernel or raises. Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from dctsvd_tpu_torch.ops import cta_tree, dct, wm_cuda
from dctsvd_tpu_torch.utils import kernels
from dctsvd_tpu_torch.utils.config import BLOCK

__all__ = ["presence", "presence_plain", "presence_groups",
           "presence_knee", "tail_front", "tail_front_plain",
           "shrink_estimate", "crop_pixels",
           "recon_normalize", "recon_normalize_plain", "block_window",
           "scale_255", "minmax_blocks", "normalize_blocks_recompute",
           "normalize_blocks", "normalize_blocks_plain", "NormPlan",
           "norm_plan", "shape_plan", "block_shares", "resident_slot_bytes",
           "resident_smem", "device_limits"]

K_MAX = BLOCK            # K5f and K5 are compiled for k = 1..8
FRAME_CHANNELS = (1, 3)  # channels of a channels-last frame on the card
WIN_STRIDE = 32          # u32 between K5's window slots (kWinStride)
_PIXELS = BLOCK * BLOCK


def est_row(k: int) -> int:
    """Floats a row of estimates on the card: the k estimates, the flag,
    zero padding to 16 bytes (csrc/extract_tail.cu::est_row)."""
    return (k + 4) // 4 * 4


# ---------------------------------------------------------------------------
# K5f: the estimator and the slot gather
# ---------------------------------------------------------------------------

def shrink_estimate(raw: torch.Tensor, sw: torch.Tensor, scale: torch.Tensor,
                    engage: torch.Tensor, k: int):
    """The elementwise part of dctsvd_tpu/models/blocked.py::_shrink_sw_hat
    (which has the measurements behind each step), given the
    presence decision ``engage`` [..., (C,)] and the scale [(C,) 1, 1]:
    per-component Cauchy confidence w = 1/(1 + (dev/scale)²) (0 for a
    negative measurement); present: ref + w·(raw − ref), floored at 0;
    absent: raw clamped to [−0.5·ref, 1.5·ref], blocks deviating more
    than 2·scale flagged. Returns (estimate [..., N, 8], flags [..., N])."""
    ref = sw.expand(raw.shape)
    comp = torch.arange(BLOCK, device=raw.device) < k
    zero = torch.zeros((), dtype=raw.dtype, device=raw.device)
    devk = torch.where(comp, torch.abs(raw - ref), zero)
    dev = devk.amax(dim=-1, keepdim=True)
    wgt = torch.where(comp, 1.0 / (1.0 + (devk / scale) ** 2), zero)
    wgt = torch.where(raw < 0.0, zero, wgt)
    shrunk = torch.clamp(ref + wgt * (raw - ref), min=0.0)
    clamped = torch.minimum(torch.maximum(raw, -0.5 * ref), 1.5 * ref)
    est = torch.where(engage[..., None, None], shrunk, clamped)
    bad = (dev[..., 0] > 2.0 * scale[..., 0]) & ~engage[..., None]
    return est, bad


def tail_front_plain(s_cw: torch.Tensor, sc: torch.Tensor,
                     inv_blk: torch.Tensor, alpha: torch.Tensor, k: int,
                     sw: Optional[torch.Tensor] = None,
                     scale: Optional[torch.Tensor] = None,
                     engage: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of K5f, one PyTorch op a step: the raw estimate, the
    shrinkage (with ``sw``), the flag column and one gather for both."""
    raw = (s_cw - sc) / torch.clamp(alpha, min=1e-8)
    if sw is None:
        return raw[..., :k].index_select(-2, inv_blk)
    est, bad = shrink_estimate(raw, sw, scale, engage, k)
    combo = torch.cat([est[..., :k], bad.to(torch.float32)[..., None]],
                      dim=-1)
    return combo.index_select(-2, inv_blk)


def _front_check(s_cw, sc, inv_blk, alpha, k, sw, scale, engage):
    """Check K5f's inputs (dtypes, shapes, contiguity); the channels of sw
    (1 for a shared [N, 8]) and the tensors besides the spectra."""
    for name, t in (("s_cw", s_cw), ("sc", sc), ("alpha", alpha),
                    ("sw", sw), ("scale", scale)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"tail_front takes float32 {name}, got "
                             f"{t.dtype}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k must be in 1..{K_MAX}, got {k}")
    if s_cw.shape != sc.shape or s_cw.ndim < 2 or s_cw.shape[-1] != BLOCK:
        raise ValueError(f"s_cw and sc must be one shape [..., N, {BLOCK}], "
                         f"got {tuple(s_cw.shape)} and {tuple(sc.shape)}")
    n = s_cw.shape[-2]
    if (inv_blk.ndim != 1 or inv_blk.shape[0] != n
            or inv_blk.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"inv_blk must be an integer [{n}], got "
                         f"{inv_blk.dtype} {tuple(inv_blk.shape)}")
    if not (s_cw.is_contiguous() and sc.is_contiguous()):
        raise ValueError("tail_front needs contiguous spectra")
    if sw is None:
        return 1, []
    if scale is None or engage is None:
        raise ValueError("tail_front with sw needs scale and engage")
    chans = sw.shape[0] if sw.ndim == 3 else 1
    if (sw.ndim not in (2, 3) or tuple(sw.shape[-2:]) != (n, BLOCK)
            or (chans > 1 and (s_cw.ndim < 3 or s_cw.shape[-3] != chans))):
        raise ValueError(f"sw must be [(C,) {n}, {BLOCK}] with the channels "
                         f"of s_cw, got {tuple(sw.shape)}")
    if scale.numel() != chans:
        raise ValueError(f"scale must hold {chans} values, got "
                         f"{tuple(scale.shape)}")
    if engage.dtype != torch.bool or engage.shape != s_cw.shape[:-2]:
        raise ValueError(f"engage must be bool {tuple(s_cw.shape[:-2])}, "
                         f"got {engage.dtype} {tuple(engage.shape)}")
    if not all(t.is_contiguous() for t in (sw, scale, engage)):
        raise ValueError("tail_front needs contiguous sw, scale and engage")
    return chans, [sw, scale, engage]


def tail_front(s_cw: torch.Tensor, sc: torch.Tensor, inv_blk: torch.Tensor,
               alpha: torch.Tensor, k: int,
               sw: Optional[torch.Tensor] = None,
               scale: Optional[torch.Tensor] = None,
               engage: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The extract tail's estimator and slot gather (see the module
    docstring): K5f on CUDA tensors, its plain twin on CPU tensors.
    ``s_cw``, ``sc`` f32 [..., (C,) N, 8] (slot order), ``inv_blk`` [N],
    ``alpha`` f32 (one value, or one a plane), with ``sw`` [(C,) N, 8] also
    ``scale`` [(C,) 1, 1] and ``engage`` bool [..., (C,)]; returns f32
    [..., (C,) N, k (+ 1)]."""
    chans, extra = _front_check(s_cw, sc, inv_blk, alpha, k, sw, scale,
                                engage)
    if wm_cuda._device_ok("tail_front", s_cw, sc, inv_blk, alpha, *extra):
        return tail_front_plain(s_cw, sc, inv_blk, alpha, k, sw, scale,
                                engage)
    if any(t.data_ptr() % 16 for t in (s_cw, sc, *extra[:1])):
        raise ValueError("tail_front needs 16-byte aligned spectra and sw "
                         "on the GPU")
    planes = s_cw[..., 0, 0].numel()
    if alpha.numel() == 1:
        a, step = alpha.reshape(1), 0
    else:
        try:
            a = torch.broadcast_to(alpha, (*s_cw.shape[:-2], 1, 1))
        except RuntimeError as err:
            raise ValueError(f"tail_front takes one alpha or one a plane, "
                             f"got {tuple(alpha.shape)}") from err
        a, step = a.reshape(-1).contiguous(), 1
    kx = k + (sw is not None)
    out = torch.empty((*s_cw.shape[:-1], est_row(k)), dtype=torch.float32,
                      device=s_cw.device)
    if out.numel():
        kernels.launch("dctsvd_tail_front", s_cw.device, s_cw, sc,
                       inv_blk.to(torch.int64).contiguous(), a, step, sw,
                       scale, engage, out, planes, chans, s_cw.shape[-2], k,
                       int(sw is not None))
        tail_front.launches += 1
    return out[..., :kx]


tail_front.launches = 0


# ---------------------------------------------------------------------------
# K18: the presence statistic
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def presence_groups(n: int) -> tuple:
    """(gsz, ng, rank) of a plane of ``n`` blocks: groups of gsz =
    max(1, n // 16) contiguous blocks, ng = n // gsz of them (16..31, or n
    where n < 16), and the rank ng - ⌈ng/4⌉ of the statistic, the
    ⌈ng/4⌉-th largest group Pearson."""
    gsz = max(1, n // 16)
    ng = n // gsz
    return gsz, ng, ng - -(-ng // 4)


@functools.lru_cache(maxsize=None)
def presence_knee(gsz: int) -> float:
    """The decision's threshold 0.20 + 1.8/√gsz in f32, as the JAX package
    computes it (one IEEE division): an f32 value, which K18 and its twin
    compare with."""
    g = np.float32(gsz)
    return float(np.float32(0.2) + np.float32(1.8) / np.sqrt(g))


def _presence_layout(s_cw, sw, sc, alpha):
    """Check K18's inputs; (lead dims of the planes, channels)."""
    for name, t in (("s_cw", s_cw), ("sw", sw), ("sc", sc),
                    ("alpha", alpha)):
        if t is None:
            raise ValueError(f"presence needs {name}")
        if t.dtype != torch.float32:
            raise ValueError(f"presence takes float32 {name}, got {t.dtype}")
    if sw.ndim not in (2, 3):
        raise ValueError(f"sw must be [(C,) N, R], got {tuple(sw.shape)}")
    chans = sw.shape[0] if sw.ndim == 3 else 1
    n = sw.shape[-2]
    if (n < 1 or s_cw.ndim < sw.ndim
            or s_cw.shape[s_cw.ndim - sw.ndim:-1] != sw.shape[:-1]):
        raise ValueError(f"s_cw must be [..., "
                         f"{', '.join(map(str, sw.shape[:-1]))}, R], got "
                         f"{tuple(s_cw.shape)}")
    try:
        shape = (s_cw.shape if sc.shape == s_cw.shape
                 else torch.broadcast_shapes(sc.shape, s_cw.shape))
    except RuntimeError:
        shape = None
    if shape != s_cw.shape:
        raise ValueError(f"sc {tuple(sc.shape)} does not broadcast to "
                         f"s_cw {tuple(s_cw.shape)}")
    return tuple(s_cw.shape[:-2]), chans


def presence_plain(s_cw: torch.Tensor, sw: torch.Tensor,
                   sc: torch.Tensor, alpha: torch.Tensor) -> tuple:
    """Plain twin of K18, one PyTorch op a step in the kernel's order (the
    sums of each group walked as K9's twin walks a band: thread t adds
    blocks t, t + 256, ..., then the fixed tree; the means first, the
    centred sums in a second pass)."""
    _presence_layout(s_cw, sw, sc, alpha)
    dev = s_cw.device
    threads, tree = cta_tree.THREADS, cta_tree.tree
    b = torch.div(s_cw[..., :1] - sc[..., :1],
                  torch.clamp(alpha, min=1e-8))[..., 0]
    a = sw[..., 0].expand(b.shape)
    gsz, ng, rank = presence_groups(b.shape[-1])
    rows = -(-gsz // threads)
    lead = b.shape[:-1]

    def walk(x):
        x = x[..., :ng * gsz].reshape(*lead, ng, gsz)
        x = torch.nn.functional.pad(x, (0, rows * threads - gsz))
        return x.reshape(*lead, ng, rows, threads)

    a, b = walk(a), walk(b)
    valid = (torch.arange(rows * threads, device=dev)
             < gsz).reshape(rows, threads)
    zero = _f32(0.0, dev)
    sa = sb = zero
    for r in range(rows):
        sa, sb = sa + a[..., r, :], sb + b[..., r, :]
    cnt = _f32(gsz, dev)
    ma = torch.div(tree(sa), cnt)[..., None]
    mb = torch.div(tree(sb), cnt)[..., None]
    uaa = ubb = uab = zero
    for r in range(rows):
        ok = valid[r]
        da = torch.where(ok, a[..., r, :] - ma, zero)
        db = torch.where(ok, b[..., r, :] - mb, zero)
        uaa, ubb, uab = uaa + da * da, ubb + db * db, uab + da * db
    uaa, ubb, uab = tree(uaa), tree(ubb), tree(uab)
    rho = torch.div(uab, torch.sqrt(uaa) * torch.sqrt(ubb)
                    + _f32(1e-8, dev))
    rho0 = torch.sort(rho, dim=-1).values[..., rank]
    return rho0 >= presence_knee(gsz), rho0


def presence(s_cw: torch.Tensor, sw: torch.Tensor, sc: torch.Tensor,
             alpha: torch.Tensor) -> tuple:
    """The presence decision of each plane (see csrc/presence.cu): K18 on
    CUDA tensors, its plain twin on CPU tensors. ``s_cw`` f32 [..., (C,) N,
    R], column 0 read: the stego spectrum, with ``sc`` (broadcastable to
    it) and ``alpha`` (one value, or one a plane); ``sw`` [(C,) N, R'] in
    slot order. Returns (engage bool [..., (C,)], rho0 f32 [..., (C,)]):
    the ⌈ng/4⌉-th largest group Pearson and whether it reaches the knee."""
    lead, chans = _presence_layout(s_cw, sw, sc, alpha)
    if wm_cuda._device_ok("presence", s_cw, sw, sc, alpha):
        return presence_plain(s_cw, sw, sc, alpha)
    n = s_cw.shape[-2]
    frames = 1
    for d in lead[:len(lead) - (sw.ndim == 3)]:
        frames *= d
    planes = frames * chans
    s = s_cw.reshape(frames, chans, n, s_cw.shape[-1])
    q = torch.broadcast_to(sc, s_cw.shape).reshape(s.shape)
    if alpha.numel() == 1:
        a, step = alpha.reshape(1), 0
    else:
        try:
            a = torch.broadcast_to(alpha, (*lead, 1, 1))
        except RuntimeError as err:
            raise ValueError(f"presence takes one alpha or one a plane, "
                             f"got {tuple(alpha.shape)}") from err
        a, step = a.reshape(-1).contiguous(), 1
    w = sw.reshape(chans, n, sw.shape[-1])
    gsz, ng, _ = presence_groups(n)
    # rho0 [planes], then the groups' Pearsons [planes, ng] (scratch)
    buf = torch.empty(planes * (ng + 1), dtype=torch.float32,
                      device=s_cw.device)
    rho0 = buf[:planes]
    engage = torch.empty((planes,), dtype=torch.bool, device=s_cw.device)
    if planes:
        kernels.launch("dctsvd_presence", s_cw.device, s, s.stride(0),
                       s.stride(1), s.stride(2), q, q.stride(0), q.stride(1),
                       q.stride(2), a, step, w, w.stride(0), w.stride(1),
                       buf[planes:], rho0, engage, planes, chans, n,
                       presence_knee(gsz))
        presence.launches += 1
    return engage.reshape(lead), rho0.reshape(lead)


presence.launches = 0


# ---------------------------------------------------------------------------
# K5: the recompute form's two passes
# ---------------------------------------------------------------------------


def _layout(x: torch.Tensor, eb64: torch.Tensor, h: int, w: int,
            to_frames: bool):
    """Check the shapes; (k, channel dims, frame lead dims)."""
    if x.dtype != torch.float32 or eb64.dtype != torch.float32:
        raise ValueError(f"recon_normalize takes float32 estimates and "
                         f"basis, got {x.dtype} and {eb64.dtype}")
    if eb64.ndim not in (3, 4) or eb64.shape[-1] != _PIXELS:
        raise ValueError(f"eb64 must be [(C,) N, k, 64], got "
                         f"{tuple(eb64.shape)}")
    k = eb64.shape[-2]
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k must be in 1..{K_MAX}, got {k}")
    if h % BLOCK or w % BLOCK or h <= 0 or w <= 0:
        raise ValueError(f"recon_normalize needs block-aligned H and W "
                         f"(multiples of {BLOCK}), got {h}x{w}")
    cdims = tuple(eb64.shape[:-3])
    n = eb64.shape[-3]
    if n != (h // BLOCK) * (w // BLOCK):
        raise ValueError(f"eb64 has {n} blocks, {h}x{w} needs "
                         f"{(h // BLOCK) * (w // BLOCK)}")
    tail = len(cdims) + 2
    if (x.ndim < tail or tuple(x.shape[x.ndim - tail:-1]) != (*cdims, n)
            or x.shape[-1] not in (k, k + 1)):
        raise ValueError(f"x must be [..., {', '.join(map(str, cdims))}"
                         f"{', ' if cdims else ''}{n}, {k} or {k + 1}], got "
                         f"{tuple(x.shape)}")
    if to_frames and len(cdims) != 1:
        raise ValueError("to_frames needs a channel dimension: eb64 "
                         "[C, N, k, 64]")
    return k, cdims, tuple(x.shape[:x.ndim - tail])


def _f32(value: float, device) -> torch.Tensor:
    """A 0-d f32 tensor on ``device``, made by a fill (no host copy)."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


def block_window(blocks: torch.Tensor, bad_nat: Optional[torch.Tensor],
                 inside: Optional[torch.Tensor] = None):
    """The normalisation window (lo, hi), each [..., 1, 1], of each plane of
    [..., N, 64] blocks: min/max over the pixels of unflagged blocks, or
    over all when ``bad_nat`` is None or flags every block: the window of
    :func:`minmax_blocks`, K8's twin. ``inside`` [N, 64] (bool): only its
    pixels enter the window (a crop's; None: all)."""
    inf = _f32(float("inf"), blocks.device)
    lo_in = hi_in = blocks
    if inside is not None:
        lo_in = torch.where(inside, blocks, inf)
        hi_in = torch.where(inside, blocks, -inf)
    if bad_nat is None:
        return (lo_in.amin(dim=(-2, -1), keepdim=True),
                hi_in.amax(dim=(-2, -1), keepdim=True))
    bmin = lo_in.amin(dim=-1)                            # [..., N]
    bmax = hi_in.amax(dim=-1)
    lo = torch.where(bad_nat, inf, bmin).amin(dim=-1, keepdim=True)
    hi = torch.where(bad_nat, -inf, bmax).amax(dim=-1, keepdim=True)
    # every block flagged (mark-free input) -> the plain window; the
    # repaint then flattens the whole plane
    ok = torch.isfinite(lo) & torch.isfinite(hi)
    lo = torch.where(ok, lo, bmin.amin(dim=-1, keepdim=True))
    hi = torch.where(ok, hi, bmax.amax(dim=-1, keepdim=True))
    return lo[..., None], hi[..., None]


def scale_255(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """255 / max(hi - lo, 1e-12) as one IEEE division, as the JAX
    package's ``255.0 / x``: torch's ``255.0 / t`` is
    ``t.reciprocal() * 255``, which rounds twice."""
    return torch.div(_f32(255.0, lo.device), torch.clamp(hi - lo, min=1e-12))


def minmax_blocks(blocks: torch.Tensor, bad_nat: Optional[torch.Tensor],
                  normalize: bool,
                  inside: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's ``_normalize_blocks`` in torch: the min–max
    normalisation of block-aligned planes [..., N, 64] to [0, 255] (f32),
    flagged blocks (``bad_nat`` [..., N]) out of the window and repainted
    at its midpoint (0 without ``normalize``). With ``inside`` (a crop's
    pixels, :func:`crop_pixels`) the window is the crop's: its
    ``_masked_normalize`` on the cropped plane, pixel for pixel inside."""
    if not normalize:
        if bad_nat is None:
            return blocks
        return torch.where(bad_nat[..., None], 0.0, blocks)
    lo, hi = block_window(blocks, bad_nat, inside)
    if bad_nat is not None:
        blocks = torch.where(bad_nat[..., None], (lo + hi) * 0.5, blocks)
    return (blocks - lo) * scale_255(lo, hi)


def normalize_blocks_recompute(produce, bad_nat: Optional[torch.Tensor],
                               normalize: bool,
                               out_u8: bool) -> torch.Tensor:
    """The JAX package's ``_normalize_blocks_recompute`` in torch:
    ``produce()`` rebuilds the [..., N, 64] reconstruction for each pass
    (the window, then the paint) instead of keeping it, and ``out_u8``
    clamps and casts. K5's arithmetic: the scale is one IEEE division, and
    amin/amax let a NaN through."""
    if normalize:
        lo, hi = block_window(produce(), bad_nat)
        scale = scale_255(lo, hi)
    blocks = produce()
    if bad_nat is not None:
        fill = (lo + hi) * 0.5 if normalize else 0.0
        blocks = torch.where(bad_nat[..., None], fill, blocks)
    if normalize:
        blocks = (blocks - lo) * scale
    if out_u8:
        blocks = blocks.clamp(0, 255).to(torch.uint8)
    return blocks


def recon_normalize_plain(x: torch.Tensor, eb64: torch.Tensor, h: int,
                          w: int, normalize: bool = True,
                          out_u8: bool = True,
                          to_frames: bool = False) -> torch.Tensor:
    """Plain twin of K5, one PyTorch op a step in the kernel's order."""
    k, _, _ = _layout(x, eb64, h, w, to_frames)
    sw_nat = x[..., :k]
    bad_nat = x[..., k] > 0.5 if x.shape[-1] == k + 1 else None

    def produce():
        y = sw_nat[..., 0:1] * eb64[..., 0, :]
        for j in range(1, k):
            y = y + sw_nat[..., j:j + 1] * eb64[..., j, :]
        return y

    blocks = normalize_blocks_recompute(produce, bad_nat, normalize, out_u8)
    blocks = blocks.reshape(*blocks.shape[:-1], BLOCK, BLOCK)
    if to_frames:
        return dct.unblockify_to_frames(blocks, h, w)
    return dct.unblockify(blocks, h, w)


def _row_stride(x: torch.Tensor) -> Optional[int]:
    """Floats between consecutive rows of estimates when ``x`` is the
    leading columns of a contiguous [..., N, r] tensor (r), else None."""
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        return None
    rows = x.stride(-2)
    step = rows
    for d in range(x.ndim - 2, -1, -1):
        if x.shape[d] > 1 and x.stride(d) != step:
            return None
        step *= x.shape[d]
    return rows if rows >= x.shape[-1] else None


def _basis_stride(eb64: torch.Tensor) -> int:
    """Floats between consecutive blocks of ``eb64``, whose rows of 64
    pixels are contiguous and 64 floats apart (a slice of the prepared
    [..., N, 8, 8, 8] basis is); raises for any other layout."""
    st = eb64.stride()
    bstride = st[-3]
    ok = (st[-1] == 1 and st[-2] == _PIXELS
          and (eb64.ndim == 3 or st[-4] == eb64.shape[-3] * bstride)
          and bstride % 4 == 0 and eb64.data_ptr() % 16 == 0)
    if not ok:
        raise ValueError(f"recon_normalize needs basis rows of 64 "
                         f"contiguous floats on 16-byte boundaries, a "
                         f"block stride that is a multiple of 4 floats "
                         f"and channels N blocks apart; got strides {st}")
    return bstride


def recon_normalize(x: torch.Tensor, eb64: torch.Tensor, h: int, w: int,
                    normalize: bool = True, out_u8: bool = True,
                    to_frames: bool = False) -> torch.Tensor:
    """Reconstruct, normalise and cast the extracted watermark (see the
    module docstring): K5 on CUDA tensors, its plain twin on CPU tensors.
    ``x`` [..., (C,) N, k or k + 1] f32, ``eb64`` [(C,) N, k, 64] f32;
    returns u8 (``out_u8``) or f32 frames [..., H, W, C] (``to_frames``) or
    planes [..., (C,) H, W]."""
    k, cdims, lead = _layout(x, eb64, h, w, to_frames)
    if wm_cuda._device_ok("recon_normalize", x, eb64):
        return recon_normalize_plain(x, eb64, h, w, normalize, out_u8,
                                     to_frames)
    rows = _row_stride(x)
    if rows is None:
        raise ValueError("recon_normalize needs contiguous estimates on "
                         "the GPU")
    if rows != est_row(k) or x.data_ptr() % 16:
        # K5 reads rows of est_row(k) floats (K5f's layout): pad a copy
        padded = x.new_zeros((*x.shape[:-1], est_row(k)))
        padded[..., :x.shape[-1]] = x
        x = padded[..., :x.shape[-1]]
    bstride = _basis_stride(eb64)
    c = cdims[0] if cdims else 1
    if to_frames and c not in FRAME_CHANNELS:
        raise ValueError(f"recon_normalize writes frames of "
                         f"{FRAME_CHANNELS} channels on the GPU, got {c}")
    frames = 1
    for d in lead:
        frames *= d
    shape = (*lead, h, w, c) if to_frames else (*lead, *cdims, h, w)
    out = torch.empty(shape, dtype=torch.uint8 if out_u8 else torch.float32,
                      device=x.device)
    # each plane's (lo, scale, fill, 0), then its window of pass 1 as
    # order-preserving u32 keys, a slot a cache line (the C entry point
    # sets them to the keys of (+inf, -inf) before pass 1)
    win = torch.empty((frames * c if normalize else 0, 4 + 4 * WIN_STRIDE),
                      dtype=torch.int32, device=x.device)
    if frames:
        kernels.launch("dctsvd_extract_tail", x.device, x, x.shape[-1], eb64,
                       bstride, out, int(out_u8), win, frames, c,
                       int(to_frames), h, w, k, int(normalize))
        recon_normalize.launches += 1
    return out


recon_normalize.launches = 0


# ---------------------------------------------------------------------------
# K8: the default form's normaliser over the materialised reconstruction
# ---------------------------------------------------------------------------


def crop_pixels(h: int, w: int, device) -> Optional[torch.Tensor]:
    """[N, 64] bool: which pixels of the ceil(h/8) x ceil(w/8) blocks (row-
    major pixels of row-major blocks) lie inside the h x w crop; None
    where h and w are multiples of 8."""
    if not (h % BLOCK or w % BLOCK):
        return None
    hb, wb = -(-h // BLOCK), -(-w // BLOCK)
    rows = torch.arange(hb * BLOCK, device=device) < h
    cols = torch.arange(wb * BLOCK, device=device) < w
    plane = (rows[:, None] & cols[None, :]).to(torch.uint8)
    return dct.blockify(plane).reshape(hb * wb, _PIXELS).bool()


def _blocks_layout(blocks: torch.Tensor, x: torch.Tensor, k: int, h: int,
                   w: int, to_frames: bool):
    """Check the shapes; whether ``x`` holds the flag column."""
    if blocks.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError(f"normalize_blocks takes float32 blocks and "
                         f"estimates, got {blocks.dtype} and {x.dtype}")
    if h <= 0 or w <= 0:
        raise ValueError(f"normalize_blocks needs H and W >= 1, got {h}x{w}")
    n = (-(-h // BLOCK)) * (-(-w // BLOCK))
    if blocks.ndim < 2 or tuple(blocks.shape[-2:]) != (n, _PIXELS):
        raise ValueError(f"blocks must be [..., {n}, {_PIXELS}] for {h}x{w}, "
                         f"got {tuple(blocks.shape)}")
    if (k < 1 or x.shape[:-1] != blocks.shape[:-1]
            or x.shape[-1] not in (k, k + 1)):
        raise ValueError(f"x must be [{', '.join(map(str, blocks.shape[:-1]))}"
                         f", {k} or {k + 1}], got {tuple(x.shape)}")
    if to_frames and blocks.ndim < 3:
        raise ValueError("to_frames needs a channel dimension: blocks "
                         "[..., C, N, 64]")
    return x.shape[-1] == k + 1


def normalize_blocks_plain(blocks: torch.Tensor, x: torch.Tensor, k: int,
                           h: int, w: int, normalize: bool = True,
                           out_u8: bool = True,
                           to_frames: bool = False) -> torch.Tensor:
    """Plain twin of K8 and K8u: the eager form (models/blocked.py::
    _normalize_blocks, the clip and cast, the unblockify; where h or w is
    not a multiple of 8, the window over the pixels inside the h x w crop,
    then the crop: _masked_normalize's bytes)."""
    flagged = _blocks_layout(blocks, x, k, h, w, to_frames)
    bad_nat = x[..., k] > 0.5 if flagged else None
    out = minmax_blocks(blocks, bad_nat, normalize,
                        crop_pixels(h, w, blocks.device))
    if out_u8:
        out = out.clamp(0, 255).to(torch.uint8)
    out = out.reshape(*out.shape[:-1], BLOCK, BLOCK)
    hp, wp = -(-h // BLOCK) * BLOCK, -(-w // BLOCK) * BLOCK
    if to_frames:
        return dct.unblockify_to_frames(out, hp, wp)[..., :h, :w, :]
    return dct.unblockify(out, hp, wp)[..., :h, :w]


def _frame_stride(t: torch.Tensor, nlead: int) -> Optional[int]:
    """Elements between consecutive frames when the first ``nlead`` dims of
    ``t`` flatten to one strided dim (0 for a single frame), else None."""
    fs, step = 0, None
    for d in range(nlead - 1, -1, -1):
        if t.shape[d] == 1:
            continue
        if step is None:
            fs = step = t.stride(d)
        elif t.stride(d) != step:
            return None
        step *= t.shape[d]
    return fs


def _blocks_strides(blocks: torch.Tensor, to_frames: bool) -> tuple:
    """(floats between blocks, floats between frames, frame dims) of
    ``blocks`` [..., N, 64] whose 64 pixels a block are contiguous on
    16-byte boundaries: the dims before N are frames, then channels N
    blocks apart (with ``to_frames`` the one before N, else as many as
    lie so); raises for any other layout."""
    st, shape = blocks.stride(), blocks.shape
    bstride = st[-2]
    if shape[-2] == 1 and blocks.ndim > 2:
        # one block a plane (a frame of 8 x 8 pixels or less): its stride
        # is the next dimension's
        bstride = st[-3]
    nlead, step = blocks.ndim - 2, shape[-2] * bstride
    while nlead > 0 and (shape[nlead - 1] == 1 or st[nlead - 1] == step):
        step *= shape[nlead - 1]
        nlead -= 1
        if to_frames:
            break
    fstride = _frame_stride(blocks, nlead)
    if (st[-1] != 1 or fstride is None or bstride % 4 or fstride % 4
            or (to_frames and nlead != blocks.ndim - 3)
            or blocks.data_ptr() % 16):
        raise ValueError(f"normalize_blocks needs the 64 pixels of a block "
                         f"contiguous on 16-byte boundaries, block and "
                         f"frame strides that are multiples of 4 floats "
                         f"and channels N blocks apart; got strides {st}")
    return bstride, fstride, nlead


#: threads a CTA of K8's resident instance (kResThreads)
RES_THREADS = 512
#: ring slots at most (kResMaxSlots)
RES_MAX_SLOTS = 3


@dataclass(frozen=True)
class NormPlan:
    """K8's instance for one call: ``"two_pass"``, or ``"resident"`` with
    ``ctas`` co-resident CTAs, a ring of ``ring`` slots of ``chunk``
    blocks and ``smem`` bytes of shared memory a CTA."""
    instance: str
    ctas: int = 0
    ring: int = 0
    chunk: int = 0
    smem: int = 0


def block_shares(n_blk: int, ctas: int) -> list:
    """Blocks of a plane each resident CTA holds: CTA b takes blocks
    b·N // ctas .. (b + 1)·N // ctas − 1, so no two shares differ by more
    than one block."""
    return [(b + 1) * n_blk // ctas - b * n_blk // ctas for b in range(ctas)]


def resident_slot_bytes(chans: int, chunk: int) -> int:
    """Bytes of a resident ring slot (extract_tail.cu::res_slot_bytes): a
    chunk of ``chunk`` blocks of each of a frame's ``chans`` planes (64
    floats and 4 of padding a block), then their flags (a float each)."""
    return 4 * chans * chunk * (_PIXELS + 5)


def resident_smem(chans: int, chunk: int, ring: int) -> int:
    """Bytes of shared memory a resident CTA takes (extract_tail.cu::
    res_smem): a frame's planes' params and warp windows, then ``ring``
    slots, then each warp's stage for a crop's u8 rows (a pixel row of 32
    blocks a plane)."""
    return (16 * chans * (RES_THREADS // 32 + 1)
            + ring * resident_slot_bytes(chans, chunk)
            + RES_THREADS * BLOCK * chans)


def norm_plan(frames: int, chans: int, n_blk: int, normalize: bool,
              sms: int, smem_limit: int) -> NormPlan:
    """K8's instance for ``frames`` frames of ``chans`` planes of ``n_blk``
    blocks on a card of ``sms`` SMs whose CTA may take ``smem_limit``
    bytes of shared memory (0 where it takes no cooperative launch).

    A CTA an SM, each an equal share of the blocks (block_shares). With
    normalize and 1 or 3 planes a frame, where one frame's share fits one
    CTA's shared memory but four do not, the resident instance reads the
    reconstruction once, at a grid barrier a frame. Where two or three
    shares fit (gray 1080p), a share is one chunk and the ring as many
    slots as fit: the next frame folds while this one waits at its
    barrier. Where only one fits (color 1080p), a frame is two chunks, so
    that the next frame's first half loads while the second half paints.
    Otherwise the two-pass instance: a frame whose share does not fit (a
    4K color frame, an 8K band), a small one whose share fits four times
    or more (512x512 gray, whose frames would each pay a grid barrier for
    little to read), no normalize (the paint pass alone reads once), or
    another count of planes."""
    if (not normalize or frames < 1 or n_blk < 1 or sms < 1
            or chans not in (1, 3)):
        return NormPlan("two_pass")
    ctas = min(sms, n_blk)
    cap = -(-n_blk // ctas)

    def slots(chunk):
        room = smem_limit - resident_smem(chans, chunk, 0)
        return room // resident_slot_bytes(chans, chunk)

    chunk = (cap + 3) // 4 * 4
    ring = slots(chunk)
    if ring > RES_MAX_SLOTS:
        return NormPlan("two_pass")
    if ring < 2:
        half = (-(-cap // 2) + 3) // 4 * 4
        if slots(half) >= 2:
            chunk, ring = half, min(RES_MAX_SLOTS, slots(half))
        elif ring < 1:
            return NormPlan("two_pass")
    return NormPlan("resident", ctas, ring, chunk,
                    resident_smem(chans, chunk, ring))


def shape_plan(frames: int, chans: int, h: int, w: int, normalize: bool,
               sms: int, smem_limit: int) -> NormPlan:
    """K8's instance for ``frames`` frames of ``chans`` h x w planes: the
    :func:`norm_plan` of their ceil(h/8) x ceil(w/8) blocks, a crop's
    padded grid as an aligned plane's."""
    return norm_plan(frames, chans, -(-h // BLOCK) * -(-w // BLOCK),
                     normalize, sms, smem_limit)


_LIMITS: dict = {}


def device_limits(device) -> tuple:
    """(SMs, shared memory a CTA may opt into in bytes, whether it takes
    cooperative launches) of a CUDA device, read once."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _LIMITS:
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(idx):
            kernels.check(kernels.load().dctsvd_device_limits(
                ctypes.cast(out, ctypes.c_void_p)), "dctsvd_device_limits")
        _LIMITS[idx] = tuple(out)
    return _LIMITS[idx]


def normalize_blocks(blocks: torch.Tensor, x: torch.Tensor, k: int, h: int,
                     w: int, normalize: bool = True, out_u8: bool = True,
                     to_frames: bool = False,
                     plan: Optional[NormPlan] = None) -> torch.Tensor:
    """Normalise, cast and unblockify the materialised reconstruction (see
    the module docstring): K8 on CUDA tensors, its plain twin on CPU
    tensors. ``blocks`` [..., (C,) N, 64] f32, ``x`` [..., (C,) N, k or
    k + 1] f32 (column k, when there, the erasure flag); returns u8
    (``out_u8``) or f32 frames [..., H, W, C] (``to_frames``) or planes
    [..., (C,) H, W]. ``plan`` forces an instance (default: shape_plan's
    for the device); each launch counts in ``.launches`` and in
    ``INSTANCE_LAUNCHES``. Where h or w is not a multiple of 8 the blocks
    cover the padded plane and the output is its h x w crop (K8u: either
    instance, whose window leaves the pixels outside it)."""
    flagged = _blocks_layout(blocks, x, k, h, w, to_frames)
    crop = bool(h % BLOCK or w % BLOCK)
    if wm_cuda._device_ok("normalize_blocks", blocks, x):
        return normalize_blocks_plain(blocks, x, k, h, w, normalize, out_u8,
                                      to_frames)
    c = blocks.shape[-3] if to_frames else 1
    if to_frames and c not in FRAME_CHANNELS:
        raise ValueError(f"normalize_blocks writes frames of "
                         f"{FRAME_CHANNELS} channels on the GPU, got {c}")
    bstride, fstride, nlead = _blocks_strides(blocks, to_frames)
    lead = tuple(blocks.shape[:nlead])
    xrow = 0
    if flagged:
        xrow = _row_stride(x)
        if xrow is None:
            raise ValueError("normalize_blocks needs the flags in rows of a "
                             "contiguous tensor on the GPU")
    frames = 1
    for d in lead:
        frames *= d
    chans = 1
    for d in blocks.shape[nlead:-2]:
        chans *= d
    if not to_frames and nlead == 0 and chans not in FRAME_CHANNELS:
        # planes that all lie N blocks apart (one-block planes of several
        # frames): each a frame of one plane, which the resident instance
        # takes
        frames, chans, fstride = chans, 1, blocks.shape[-2] * bstride
    shape = ((*lead, h, w, c) if to_frames
             else (*blocks.shape[:-2], h, w))
    out = torch.empty(shape, dtype=torch.uint8 if out_u8 else torch.float32,
                      device=blocks.device)
    win = torch.empty((frames * chans if normalize else 0,
                       4 + 4 * WIN_STRIDE), dtype=torch.int32,
                      device=blocks.device)
    if frames and out.numel():
        if plan is None:
            sms, smem, coop = device_limits(blocks.device)
            plan = shape_plan(frames, chans, h, w, normalize, sms,
                              smem if coop else 0)
        kernels.launch("dctsvd_normalize_blocks", blocks.device, blocks,
                       bstride, fstride, x if flagged else None, xrow, k,
                       out, int(out_u8), win, frames, chans, int(to_frames),
                       h, w, int(normalize), plan.ctas, plan.ring,
                       plan.chunk)
        normalize_blocks.launches += 1
        INSTANCE_LAUNCHES[plan.instance] += 1
        if crop:
            INSTANCE_LAUNCHES["crop_" + plan.instance] += 1
    return out


normalize_blocks.launches = 0
#: K8's launches by instance (normalize_blocks counts both), and K8u's by
#: instance ("crop_resident", "crop_two_pass": the launches with a crop,
#: counted under their instance too)
INSTANCE_LAUNCHES = {"resident": 0, "two_pass": 0, "crop_resident": 0,
                     "crop_two_pass": 0}
