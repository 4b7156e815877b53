"""INTER_AREA resize of u8 images, matching cv2, and its float form
(counterparts of ``resize_area_u8`` and ``resize_area`` in
``dctsvd_tpu/ops/resize.py``).

cv2's INTER_AREA has two regimes:
  1. both axes shrinking: area averaging (f32 weights, round half to even);
  2. otherwise ("zoom" path): per-axis taps ``sx = floor(dx*scale)``,
     ``fx = (dx+1) − (sx+1)*dst/src`` snapped to 0 when ≤ 0, evaluated in
     cv2's 11-bit fixed point with integer gathers (bit-exact).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=128)
def _shrink_weights_np(src: int, dst: int) -> np.ndarray:
    """[dst, src] area-average weights for a shrinking axis."""
    w = np.zeros((dst, src), np.float64)
    scale = src / dst
    for d in range(dst):
        lo = d * scale
        hi = (d + 1) * scale
        i0 = int(np.floor(lo))
        i1 = int(np.ceil(hi))
        for i in range(i0, min(i1, src)):
            cover = min(hi, i + 1) - max(lo, i)
            if cover > 0:
                w[d, i] = cover
        w[d] /= w[d].sum()
    return w


@functools.lru_cache(maxsize=128)
def _zoom_taps_np(src: int, dst: int):
    """(sx0, sx1, fx) int/float tap arrays for cv2's INTER_AREA zoom path."""
    scale = src / dst
    inv = dst / src
    sx = np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64),
                    src - 1)
    # cv2 stores fx as C float — the f32 cast shifts some boundary weights
    fx = (((np.arange(dst) + 1) - (sx + 1) * inv)).astype(np.float32)
    fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx))
    sx1 = np.minimum(sx + 1, src - 1)
    return sx, sx1, fx


def _round_even(x: np.ndarray) -> np.ndarray:
    return np.round(x).astype(np.int64)


def resize_area_u8(img_u8: torch.Tensor, out_h: int, out_w: int,
                   channels_last: bool | None = None) -> torch.Tensor:
    """cv2.resize(img, (out_w, out_h), INTER_AREA) for uint8 [..., H, W] or
    [..., H, W, C]. ``channels_last=None`` infers the layout (a trailing dim
    of <= 4 on a >=3-D tensor is a channel axis)."""
    chan = (img_u8.ndim >= 3 and img_u8.shape[-1] <= 4
            if channels_last is None else channels_last)
    x = torch.movedim(img_u8, -1, 0) if chan else img_u8
    h, w = x.shape[-2], x.shape[-1]
    dev = x.device

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    if out_h <= h and out_w <= w:
        wy = t(_shrink_weights_np(h, out_h), torch.float32)
        wx = t(_shrink_weights_np(w, out_w), torch.float32)
        y = torch.einsum("oh,...hw->...ow", wy, x.to(torch.float32))
        y = torch.einsum("...ow,pw->...op", y, wx)
        out = torch.round(y).clamp(0, 255).to(torch.uint8)
    else:
        sy0, sy1, fy = _zoom_taps_np(h, out_h)
        sx0, sx1, fx = _zoom_taps_np(w, out_w)
        wy0 = t(_round_even((1 - fy) * 2048), torch.int32)
        wy1 = t(_round_even(fy * 2048), torch.int32)
        wx0 = t(_round_even((1 - fx) * 2048), torch.int32)
        wx1 = t(_round_even(fx * 2048), torch.int32)
        xi = x.to(torch.int32)
        hpass = (xi.index_select(-1, t(sx0, torch.long)) * wx0
                 + xi.index_select(-1, t(sx1, torch.long)) * wx1)
        # cv2's u8 VResizeLinear truncation sequence (resize.cpp):
        # ((b0*(S0>>4))>>16 + (b1*(S1>>4))>>16 + 2) >> 2
        s0 = hpass.index_select(-2, t(sy0, torch.long)) >> 4
        s1 = hpass.index_select(-2, t(sy1, torch.long)) >> 4
        vpass = ((wy0[:, None] * s0) >> 16) + ((wy1[:, None] * s1) >> 16)
        out = ((vpass + 2) >> 2).clamp(0, 255).to(torch.uint8)

    return torch.movedim(out, 0, -1) if chan else out


def resize_area(img: torch.Tensor, out_h: int, out_w: int,
                channels_last: bool | None = None) -> torch.Tensor:
    """Float INTER_AREA resize of [..., H, W] or [..., H, W, C] tensors
    (f32, unquantized weights: the area averages when both axes shrink,
    else the zoom path's taps as linear blends); ``channels_last`` as in
    :func:`resize_area_u8`."""
    chan = (img.ndim >= 3 and img.shape[-1] <= 4
            if channels_last is None else channels_last)
    x = torch.movedim(img, -1, 0) if chan else img
    h, w = x.shape[-2], x.shape[-1]
    dev = x.device
    xf = x.to(torch.float32)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    if out_h <= h and out_w <= w:
        wy = t(_shrink_weights_np(h, out_h), torch.float32)
        wx = t(_shrink_weights_np(w, out_w), torch.float32)
        y = torch.einsum("oh,...hw->...ow", wy, xf)
        y = torch.einsum("...ow,pw->...op", y, wx)
    else:
        sy0, sy1, fy = _zoom_taps_np(h, out_h)
        sx0, sx1, fx = _zoom_taps_np(w, out_w)
        fyt = t(fy, torch.float32)[:, None]
        fxt = t(fx, torch.float32)
        hp = (xf.index_select(-1, t(sx0, torch.long)) * (1 - fxt)
              + xf.index_select(-1, t(sx1, torch.long)) * fxt)
        y = (hp.index_select(-2, t(sy0, torch.long)) * (1 - fyt)
             + hp.index_select(-2, t(sy1, torch.long)) * fyt)

    return torch.movedim(y, 0, -1) if chan else y
