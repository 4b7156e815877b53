"""Extraction-enhancement stages: Gaussian/unsharp, CLAHE, non-local means.

Counterpart of ``dctsvd_tpu/ops/enhance.py``, with the same formulations
as plain tensor ops (the JAX package runs them as XLA graphs, not Pallas
kernels):

  - unsharp: separable 7×7 σ=1 Gaussian (cv2's auto kernel size for σ=1 on
    u8) + addWeighted, reflect-101 borders, shift-and-add in f32 (never
    ``conv2d``: cuDNN runs f32 convolutions in TF32 by default);
  - CLAHE: per-tile 256-bin histograms, cv2-style clip and stepped
    redistribution, per-tile LUTs, bilinear interpolation of the four
    neighbouring tiles' LUTs;
  - NLM: for every offset of the 21×21 search window, a 7×7 box-filtered
    patch distance (two cumulative sums) and an exp weight, accumulated
    over the 441 offsets.

All stages take and return uint8 and handle any leading batch dims.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dctsvd_tpu_torch.ops import color as c_ops
from dctsvd_tpu_torch.ops.dct import host_constant


def reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source indices of numpy/jnp 'reflect' padding (edge not repeated)
    of an axis of length n, extended by ``before`` and ``after``."""
    idx = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    m = torch.remainder(idx, period)
    return torch.where(m < n, m, period - m)


def _pad_reflect(x: torch.Tensor, top: int, bottom: int, left: int,
                 right: int) -> torch.Tensor:
    """Reflect-101 padding of the trailing two axes, as an index gather (any
    dtype, any pad width)."""
    h, w = x.shape[-2], x.shape[-1]
    x = x.index_select(-2, reflect_index(h, top, bottom, x.device))
    return x.index_select(-1, reflect_index(w, left, right, x.device))


# ---------------------------------------------------------------------------
# Gaussian + unsharp
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _gauss1d(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_blur(x: torch.Tensor, sigma: float = 1.0,
                  ksize: int | None = None) -> torch.Tensor:
    """cv2.GaussianBlur(x, (0,0), sigma) on float [..., H, W] with cv2's u8
    auto kernel size (cvRound(sigma*6 + 1) | 1) and reflect-101 borders."""
    if ksize is None:
        ksize = int(round(sigma * 6 + 1)) | 1
    k = host_constant(_gauss1d, ksize, sigma, device=x.device)
    pad = ksize // 2
    h, w = x.shape[-2], x.shape[-1]
    xp = _pad_reflect(x.to(torch.float32), pad, pad, pad, pad)
    y = torch.zeros_like(xp[..., pad:pad + h, :])
    for i in range(ksize):
        y = y + k[i] * xp[..., i:i + h, :]
    z = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(ksize):
        z = z + k[i] * y[..., i:i + w]
    return z


def unsharp_u8(img_u8: torch.Tensor, amount: float, blur_weight: float,
               sigma: float = 1.0) -> torch.Tensor:
    """cv2.addWeighted(e, amount, GaussianBlur(e, σ), blur_weight, 0) with
    a saturating round half to even (ref: app_dct_svd_single.py:94-96,
    108-110)."""
    e = img_u8.to(torch.float32)
    sharp = amount * e + blur_weight * gaussian_blur(e, sigma)
    return torch.round(sharp).clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# CLAHE
# ---------------------------------------------------------------------------

def clahe_u8(img_u8: torch.Tensor, tiles: int = 8,
             clip_limit: float = 2.0) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of u8 gray planes
    [..., H, W], following cv2.createCLAHE(clipLimit=2.0,
    tileGridSize=(8,8)): reflect-101 pad to a tile multiple, per-tile
    clipped and redistributed histograms, per-tile LUT = round(cdf · 255 /
    tile area), bilinear interpolation between the four surrounding tile
    LUTs."""
    lead, (h, w) = img_u8.shape[:-2], img_u8.shape[-2:]
    dev = img_u8.device
    planes = img_u8.reshape(-1, h, w)
    p = planes.shape[0]
    th, tw = -(-h // tiles), -(-w // tiles)
    x = _pad_reflect(planes, 0, th * tiles - h, 0, tw * tiles - w)

    # [P, T, th*tw] pixel values per tile, then 256-bin histograms
    t = x.reshape(p, tiles, th, tiles, tw).transpose(2, 3)
    t = t.reshape(p, tiles * tiles, th * tw).to(torch.int64)
    hist = torch.zeros(p, tiles * tiles, 256, dtype=torch.int32, device=dev)
    hist.scatter_add_(-1, t, torch.ones_like(t, dtype=torch.int32))
    hist = hist.to(torch.float32)

    area = th * tw
    limit = max(float(np.floor(np.float32(clip_limit * area / 256.0))), 1.0)
    excess = torch.clamp(hist - limit, min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=limit)
    # cv2's exact redistribution: excess//256 to every bin, then +1 to bins
    # 0, step, 2*step, ... (step = max(256//residual, 1)) until the residual
    # is used up; a uniform spread drifts the cumulative histogram
    batch = torch.floor(excess / 256.0)
    resid = excess - batch * 256.0                      # [P, T, 1], < 256
    hist = hist + batch
    b = torch.arange(256, dtype=torch.float32, device=dev)
    step = torch.clamp(torch.floor(256.0 / torch.clamp(resid, min=1.0)),
                       min=1.0)
    hit = (torch.remainder(b, step) == 0) & (torch.floor(b / step) < resid)
    hist = hist + hit.to(hist.dtype)

    cdf = torch.cumsum(hist, dim=-1)
    scale = torch.tensor(255.0 / area, dtype=torch.float32, device=dev)
    lut = torch.round(cdf * scale).clamp(0, 255)        # [P, T, 256]

    ty = torch.arange(h, dtype=torch.float32, device=dev) / th - 0.5
    tx = torch.arange(w, dtype=torch.float32, device=dev) / tw - 0.5
    y0 = torch.floor(ty).clamp(0, tiles - 1).to(torch.int64)
    x0 = torch.floor(tx).clamp(0, tiles - 1).to(torch.int64)
    y1 = (y0 + 1).clamp(0, tiles - 1)
    x1 = (x0 + 1).clamp(0, tiles - 1)
    wy = (ty - y0).clamp(0.0, 1.0)[:, None]
    wx = (tx - x0).clamp(0.0, 1.0)[None, :]

    flat = lut.reshape(p, tiles * tiles * 256)
    v = planes.to(torch.int64)

    def pick(tyi, txi):
        tid = tyi[:, None] * tiles + txi[None, :]        # [H, W]
        return flat.gather(-1, (tid * 256 + v).reshape(p, h * w)
                           ).reshape(p, h, w)

    v00, v01 = pick(y0, x0), pick(y0, x1)
    v10, v11 = pick(y1, x0), pick(y1, x1)
    out = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
           + wy * ((1 - wx) * v10 + wx * v11))
    out = torch.round(out).clamp(0, 255).to(torch.uint8)
    return out.reshape(*lead, h, w)


# ---------------------------------------------------------------------------
# Non-local means
# ---------------------------------------------------------------------------

def _box_filter(x: torch.Tensor, r: int) -> torch.Tensor:
    """Mean over (2r+1)² windows with reflect-101 borders, via two cumsums."""
    k = 2 * r + 1
    xp = _pad_reflect(x, r, r, r, r)
    c = torch.cumsum(xp, dim=-2)
    c = torch.cat([torch.zeros_like(c[..., :1, :]), c], dim=-2)
    rows = c[..., k:, :] - c[..., :-k, :]
    c2 = torch.cumsum(rows, dim=-1)
    c2 = torch.cat([torch.zeros_like(c2[..., :1]), c2], dim=-1)
    return (c2[..., :, k:] - c2[..., :, :-k]) / (k * k)


def _nlm_f32(x: torch.Tensor, h2, template: int,
             search: int) -> torch.Tensor:
    """NLM on f32 planes [..., H, W]; ``h2`` is h² as a float or a tensor
    that broadcasts against the planes. Returns the u8 result."""
    tr, sr = template // 2, search // 2
    hh, ww = x.shape[-2], x.shape[-1]
    xp = _pad_reflect(x, sr, sr, sr, sr)
    wsum = torch.zeros_like(x)
    vsum = torch.zeros_like(x)
    for dy in range(-sr, sr + 1):
        for dx in range(-sr, sr + 1):
            shifted = xp[..., sr + dy:sr + dy + hh, sr + dx:sr + dx + ww]
            d2 = _box_filter((x - shifted) ** 2, tr)
            wgt = torch.exp(-d2 / h2)
            wsum = wsum + wgt
            vsum = vsum + wgt * shifted
    out = vsum / torch.clamp(wsum, min=1e-12)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def nlm_gray_u8(img_u8: torch.Tensor, h_param: float = 7.0,
                template: int = 7, search: int = 21) -> torch.Tensor:
    """Non-local means on u8 gray planes (cv2.fastNlMeansDenoising's
    parameters: h, templateWindowSize, searchWindowSize).
    weight(offset) = exp(−D/h²), D the template's mean squared patch
    difference at that offset (σ = 0, as at the reference call sites)."""
    return _nlm_f32(img_u8.to(torch.float32), h_param * h_param, template,
                    search)


def nlm_color_u8(img_bgr_u8: torch.Tensor, h_luma: float = 3.0,
                 h_chroma: float = 3.0, template: int = 7,
                 search: int = 21) -> torch.Tensor:
    """Colored NLM following cv2.fastNlMeansDenoisingColored's structure:
    the luma and chroma planes denoised apart, in YCrCb (the JAX package's
    documented deviation from cv2's CIELAB). The three planes run as one
    batch with a per-plane h²."""
    ycc = torch.movedim(c_ops.bgr_to_ycrcb(img_bgr_u8), -1, -3)
    h2 = torch.tensor([h_luma * h_luma, h_chroma * h_chroma,
                       h_chroma * h_chroma], dtype=torch.float32,
                      device=img_bgr_u8.device)[:, None, None]
    out = _nlm_f32(ycc.to(torch.float32), h2, template, search)
    return c_ops.ycrcb_to_bgr(torch.movedim(out, -3, -1))
