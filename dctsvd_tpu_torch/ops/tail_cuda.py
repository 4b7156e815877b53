"""The recompute form of the blocked extract tail and its plain twin: K5
(``csrc/extract_tail.cu``), reached through ``extract_color_prepared`` and
``extract_gray_prepared`` with ``recompute=True``.

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

The scale is one IEEE division, ``255 / max(hi - lo, 1e-12)``, as the JAX
package's ``255.0 / x``: torch's ``255.0 / t`` is ``t.reciprocal() * 255``,
which rounds twice, so the twin writes ``torch.div`` and the kernel
``__fdiv_rn``. H and W are multiples of 8; an unaligned frame keeps the
materialising tail (models/blocked.py).

The wrapper runs the twin only for CPU tensors; for CUDA tensors it launches
K5 or raises. It counts its launches in ``.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from dctsvd_tpu_torch.ops import dct, wm_cuda
from dctsvd_tpu_torch.utils import kernels
from dctsvd_tpu_torch.utils.config import BLOCK

__all__ = ["recon_normalize", "recon_normalize_plain", "block_window",
           "normalize_blocks_recompute"]

K_MAX = BLOCK            # K5 is compiled for k = 1..8
FRAME_CHANNELS = (1, 3)  # channels of a channels-last frame on the card
_PIXELS = BLOCK * BLOCK


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


def block_window(blocks: torch.Tensor, bad_nat: Optional[torch.Tensor]):
    """The normalisation window (lo, hi), each [..., 1, 1], of each plane of
    [..., N, 64] blocks: min/max over the pixels of unflagged blocks, or
    over all when ``bad_nat`` is None or flags every block. Shared with
    the materialising tail (models/blocked.py::_normalize_blocks)."""
    if bad_nat is None:
        return (blocks.amin(dim=(-2, -1), keepdim=True),
                blocks.amax(dim=(-2, -1), keepdim=True))
    inf = _f32(float("inf"), blocks.device)
    bmin = blocks.amin(dim=-1)                           # [..., N]
    bmax = blocks.amax(dim=-1)
    lo = torch.where(bad_nat, inf, bmin).amin(dim=-1, keepdim=True)
    hi = torch.where(bad_nat, -inf, bmax).amax(dim=-1, keepdim=True)
    # every block flagged (mark-free input) -> the plain window; the
    # repaint then flattens the whole plane
    ok = torch.isfinite(lo) & torch.isfinite(hi)
    lo = torch.where(ok, lo, bmin.amin(dim=-1, keepdim=True))
    hi = torch.where(ok, hi, bmax.amax(dim=-1, keepdim=True))
    return lo[..., None], hi[..., None]


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
        scale = torch.div(_f32(255.0, lo.device),
                          torch.clamp(hi - lo, min=1e-12))
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
    if not x.is_contiguous():
        raise ValueError("recon_normalize needs contiguous estimates on "
                         "the GPU")
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
    # the plane window of pass 1 as order-preserving u32 keys, set to the
    # keys of (+inf, -inf) by the C entry point before pass 1
    win = torch.empty((frames * c if normalize else 0, 4), dtype=torch.int32,
                      device=x.device)
    if frames:
        kernels.launch("dctsvd_extract_tail", x.device, x, x.shape[-1], eb64,
                       bstride, out, int(out_u8), win, frames, c,
                       int(to_frames), h, w, k, int(normalize))
        recon_normalize.launches += 1
    return out


recon_normalize.launches = 0
