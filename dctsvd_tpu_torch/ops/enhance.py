"""Extraction-enhancement stages: Gaussian/unsharp, CLAHE, non-local means.

Counterpart of ``dctsvd_tpu/ops/enhance.py`` (the JAX package runs them as
XLA graphs, not Pallas kernels):

  - unsharp: separable 7×7 σ=1 Gaussian (cv2's auto kernel size for σ=1 on
    u8) + addWeighted, reflect-101 borders, shift-and-add in f32 (never
    ``conv2d``: cuDNN runs f32 convolutions in TF32 by default): K14
    (``csrc/enhance.cu`` over the blur of ``csrc/blur.cuh``), whose plain
    twin is ``unsharp_plain``; ``gaussian_blur`` is the twins' blur (K14's
    and, in ``ops/metrics_cuda.py``, SSIM's K15);
  - CLAHE: per-tile 256-bin histograms, cv2-style clip and stepped
    redistribution, per-tile LUTs, bilinear interpolation of the four
    neighbouring tiles' LUTs: K11 (``csrc/enhance.cu``, two kernels);
  - NLM: for every offset of the 21×21 search window, the 7×7 template's
    sum of squared differences (exact integers) and an exp weight,
    accumulated over the 441 offsets in order: K10.

The public unsharp, CLAHE and NLM functions call the wrappers of
``ops/enhance_cuda.py``, found at each call (so patching
``enhance_cuda.<name>`` reaches every caller); the wrappers run the plain
twins here (``unsharp_plain``, ``clahe_luts_plain``,
``clahe_apply_plain``, ``nlm_planes_plain``) for CPU tensors and launch
the kernels for CUDA tensors. Every division in the twins is one IEEE
division (``torch.div`` of two tensors), so each kernel is bit-equal to
its twin run on the card.

All stages take and return uint8 and handle any leading batch dims.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dctsvd_tpu_torch.ops import color as c_ops
from dctsvd_tpu_torch.ops.dct import host_constant
from dctsvd_tpu_torch.ops.tail_cuda import _f32


def reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source indices of numpy/jnp 'reflect' padding (edge not repeated)
    of an axis of length n, extended by ``before`` and ``after``."""
    idx = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    m = torch.remainder(idx, period)
    return torch.where(m < n, m, period - m)


@functools.lru_cache(maxsize=64)
def _reflect_np(n: int, pad: int) -> np.ndarray:
    return reflect_index(n, pad, pad, "cpu").numpy()


def reflect_table(n: int, pad: int, device) -> torch.Tensor:
    """``reflect_index(n, pad, pad)`` as int32 on ``device``, made once on
    the host: the halo rows or columns the blur kernels (K14, K15) read."""
    return host_constant(_reflect_np, n, pad, device=device,
                         dtype=torch.int32)


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


def unsharp_plain(img_u8: torch.Tensor, amount: float, blur_weight: float,
                  sigma: float = 1.0,
                  channels_last: bool = False) -> torch.Tensor:
    """Plain twin of K14: cv2.addWeighted(e, amount, GaussianBlur(e, σ),
    blur_weight, 0) with a saturating round half to even (ref:
    app_dct_svd_single.py:94-96, 108-110) on u8 planes [..., H, W], or on
    each channel of u8 frames [..., H, W, C] as its own plane."""
    if channels_last:
        planes = torch.movedim(img_u8, -1, -3)
        return torch.movedim(unsharp_plain(planes, amount, blur_weight,
                                           sigma), -3, -1)
    e = img_u8.to(torch.float32)
    sharp = amount * e + blur_weight * gaussian_blur(e, sigma)
    return torch.round(sharp).clamp(0, 255).to(torch.uint8)


def unsharp_u8(img_u8: torch.Tensor, amount: float, blur_weight: float,
               sigma: float = 1.0,
               channels_last: bool = False) -> torch.Tensor:
    """The unsharp mask of u8 planes [..., H, W] (or of each channel of
    frames [..., H, W, C] with ``channels_last``): ``enhance_cuda.unsharp``
    (K14)."""
    from dctsvd_tpu_torch.ops import enhance_cuda
    return enhance_cuda.unsharp(img_u8, amount, blur_weight, sigma,
                                channels_last)


# ---------------------------------------------------------------------------
# CLAHE: K11's plain twins (csrc/enhance.cu clahe_lut_kernel,
# clahe_apply_kernel); clahe_u8 calls the wrappers (ops/enhance_cuda.py)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def clahe_params(h: int, w: int, tiles: int, clip_limit: float) -> tuple:
    """(th, tw, limit, scale) of CLAHE on an H × W plane: the tile size,
    the clip limit in counts and 255 / tile area as the f32 the LUTs
    multiply by (a Python float holding that f32). Cached by its
    arguments."""
    th, tw = -(-h // tiles), -(-w // tiles)
    area = th * tw
    limit = max(float(np.floor(np.float32(clip_limit * area / 256.0))), 1.0)
    return th, tw, limit, float(np.float32(255.0 / area))


def clahe_luts_plain(planes: torch.Tensor, tiles: int = 8,
                     clip_limit: float = 2.0) -> torch.Tensor:
    """Plain twin of K11's LUT kernel: u8 planes [P, H, W] -> the tiles'
    u8 LUTs [P, tiles², 256] (reflect-101 pad to a tile multiple, per-tile
    256-bin histograms, cv2's clip and stepped redistribution, LUT =
    round(cdf · 255 / tile area))."""
    p, h, w = planes.shape
    dev = planes.device
    th, tw, limit, scale = clahe_params(h, w, tiles, clip_limit)
    x = _pad_reflect(planes, 0, th * tiles - h, 0, tw * tiles - w)
    t = x.reshape(p, tiles, th, tiles, tw).transpose(2, 3)
    t = t.reshape(p, tiles * tiles, th * tw).to(torch.int64)
    hist = torch.zeros(p, tiles * tiles, 256, dtype=torch.int32, device=dev)
    hist.scatter_add_(-1, t, torch.ones_like(t, dtype=torch.int32))
    hist = hist.to(torch.float32)

    # every count is an integer below 2^24: the f32 sums are exact
    excess = torch.clamp(hist - limit, min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=limit)
    # cv2's exact redistribution: excess//256 to every bin, then +1 to bins
    # 0, step, 2*step, ... (step = max(256//residual, 1)) until the residual
    # is used up; a uniform spread drifts the cumulative histogram
    c256 = _f32(256.0, dev)
    batch = torch.floor(torch.div(excess, c256))
    resid = excess - batch * 256.0                      # [P, T, 1], < 256
    hist = hist + batch
    b = torch.arange(256, dtype=torch.float32, device=dev)
    step = torch.clamp(torch.floor(torch.div(c256, torch.clamp(resid,
                                                               min=1.0))),
                       min=1.0)
    hit = ((torch.remainder(b, step) == 0)
           & (torch.floor(torch.div(b, step)) < resid))
    hist = hist + hit.to(hist.dtype)
    cdf = torch.cumsum(hist, dim=-1)
    lut = torch.round(cdf * _f32(scale, dev)).clamp(0, 255)
    return lut.to(torch.uint8)


def clahe_apply_plain(planes: torch.Tensor, luts: torch.Tensor,
                      tiles: int = 8) -> torch.Tensor:
    """Plain twin of K11's interpolation: each pixel of u8 planes [P, H, W]
    through the bilinear blend of its four neighbouring tiles' LUTs [P,
    tiles², 256] -> u8 [P, H, W]."""
    p, h, w = planes.shape
    dev = planes.device
    th, tw = -(-h // tiles), -(-w // tiles)
    ty = torch.div(torch.arange(h, dtype=torch.float32, device=dev),
                   _f32(th, dev)) - 0.5
    tx = torch.div(torch.arange(w, dtype=torch.float32, device=dev),
                   _f32(tw, dev)) - 0.5
    y0 = torch.floor(ty).clamp(0, tiles - 1).to(torch.int64)
    x0 = torch.floor(tx).clamp(0, tiles - 1).to(torch.int64)
    y1 = (y0 + 1).clamp(0, tiles - 1)
    x1 = (x0 + 1).clamp(0, tiles - 1)
    wy = (ty - y0).clamp(0.0, 1.0)[:, None]
    wx = (tx - x0).clamp(0.0, 1.0)[None, :]

    flat = luts.to(torch.float32).reshape(p, tiles * tiles * 256)
    v = planes.to(torch.int64)

    def pick(tyi, txi):
        tid = tyi[:, None] * tiles + txi[None, :]        # [H, W]
        return flat.gather(-1, (tid * 256 + v).reshape(p, h * w)
                           ).reshape(p, h, w)

    v00, v01 = pick(y0, x0), pick(y0, x1)
    v10, v11 = pick(y1, x0), pick(y1, x1)
    out = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
           + wy * ((1 - wx) * v10 + wx * v11))
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def clahe_plain(planes: torch.Tensor, tiles: int = 8,
                clip_limit: float = 2.0) -> torch.Tensor:
    """Plain twin of K11's two stages in one call
    (``enhance_cuda.clahe``): ``clahe_luts_plain`` then
    ``clahe_apply_plain`` on u8 planes [P, H, W]."""
    return clahe_apply_plain(planes, clahe_luts_plain(planes, tiles,
                                                      clip_limit), tiles)


def clahe_u8(img_u8: torch.Tensor, tiles: int = 8,
             clip_limit: float = 2.0) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of u8 gray planes
    [..., H, W], following cv2.createCLAHE(clipLimit=2.0,
    tileGridSize=(8,8)): ``enhance_cuda.clahe`` (K11's two stages in one
    host call) on the planes."""
    from dctsvd_tpu_torch.ops import enhance_cuda
    if img_u8.ndim == 2:           # a plane: the chains' case, no reshape
        return enhance_cuda.clahe(img_u8[None], tiles, clip_limit)[0]
    lead, (h, w) = img_u8.shape[:-2], img_u8.shape[-2:]
    planes = img_u8.reshape(-1, h, w)
    return enhance_cuda.clahe(planes, tiles, clip_limit).reshape(*lead, h, w)


# ---------------------------------------------------------------------------
# Non-local means: K10's plain twin (csrc/enhance.cu nlm_kernel); the public
# functions call the wrapper (ops/enhance_cuda.py)
# ---------------------------------------------------------------------------

def _box_sum(e: torch.Tensor, r: int) -> torch.Tensor:
    """Sum over the (2r+1)² window of each pixel of [..., H, W], with
    reflect-101 borders, as direct sums along each axis: exact on integer
    tensors (and on f32 integers whose window sums stay below 2^24)."""
    k = 2 * r + 1
    h, w = e.shape[-2], e.shape[-1]
    ep = _pad_reflect(e, r, r, r, r)
    rows = ep[..., 0:h, :]
    for i in range(1, k):
        rows = rows + ep[..., i:i + h, :]
    out = rows[..., :, 0:w]
    for j in range(1, k):
        out = out + rows[..., :, j:j + w]
    return out


def window_sums(x: torch.Tensor, xp: torch.Tensor, dy: int, dx: int,
                tr: int, sr: int) -> tuple:
    """(D, x(R(p + o))) of offset o = (dy, dx) for int32 planes ``x``
    [..., H, W] and ``xp``, x reflect-padded by ``sr``: D the int32 sum over
    the (2 tr + 1)² template of the reflected squared-difference image,
    Σ_t (x(c) − x(R(c + o)))² with c = R(p + t)."""
    hh, ww = x.shape[-2], x.shape[-1]
    shifted = xp[..., sr + dy:sr + dy + hh, sr + dx:sr + dx + ww]
    diff = x - shifted
    return _box_sum(diff * diff, tr), shifted


def nlm_weights_plain(d2: torch.Tensor, h2: torch.Tensor,
                      area: int = 49) -> torch.Tensor:
    """exp(−((D / area) / h²)) of integer window sums ``d2`` (f32), each
    division one IEEE division (``torch.div`` of two tensors: torch turns
    a division by a Python number into a product by its reciprocal)."""
    d = torch.div(d2, _f32(area, d2.device))
    return torch.exp(torch.neg(torch.div(d, h2)))


def nlm_planes_plain(planes: torch.Tensor, h2: torch.Tensor,
                     template: int = 7, search: int = 21) -> torch.Tensor:
    """Plain twin of K10: NLM on u8 planes [P, H, W] with h² [P] (f32), in
    the kernel's order. For each offset o of the search window, in (dy, dx)
    raster order: D = the template's sum of (x(c) − x(R(c + o)))² over the
    window centres c = R(p + t) (the squared-difference image reflected at
    the borders, as the JAX package's box filter pads it), exact in int32;
    w = exp(−((D / template²) / h²)); wsum += w, vsum += w · x(R(p + o)).
    out = round(vsum / max(wsum, 1e-12)) as u8."""
    tr, sr = template // 2, search // 2
    p = planes.shape[0]
    x = planes.to(torch.int32)
    xp = _pad_reflect(x, sr, sr, sr, sr)
    h2 = h2.to(torch.float32).reshape(p, 1, 1)
    wsum = torch.zeros(planes.shape, dtype=torch.float32,
                       device=planes.device)
    vsum = torch.zeros_like(wsum)
    for dy in range(-sr, sr + 1):
        for dx in range(-sr, sr + 1):
            dist, shifted = window_sums(x, xp, dy, dx, tr, sr)
            wgt = nlm_weights_plain(dist.to(torch.float32), h2,
                                    template * template)
            wsum = wsum + wgt
            vsum = vsum + wgt * shifted.to(torch.float32)
    out = torch.div(vsum, torch.clamp(wsum, min=1e-12))
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def _nlm(planes: torch.Tensor, h2: torch.Tensor, template: int,
         search: int) -> torch.Tensor:
    from dctsvd_tpu_torch.ops import enhance_cuda
    return enhance_cuda.nlm_planes(planes, h2, template, search)


def nlm_gray_u8(img_u8: torch.Tensor, h_param: float = 7.0,
                template: int = 7, search: int = 21) -> torch.Tensor:
    """Non-local means on u8 gray planes [..., H, W]
    (cv2.fastNlMeansDenoising's parameters: h, templateWindowSize,
    searchWindowSize). weight(offset) = exp(−D/h²), D the template's mean
    squared patch difference at that offset (σ = 0, as at the reference
    call sites): ``enhance_cuda.nlm_planes`` (K10)."""
    lead, (h, w) = img_u8.shape[:-2], img_u8.shape[-2:]
    planes = img_u8.reshape(-1, h, w)
    h2 = torch.full((planes.shape[0],), h_param * h_param,
                    dtype=torch.float32, device=img_u8.device)
    return _nlm(planes, h2, template, search).reshape(*lead, h, w)


def nlm_color_u8(img_bgr_u8: torch.Tensor, h_luma: float = 3.0,
                 h_chroma: float = 3.0, template: int = 7,
                 search: int = 21) -> torch.Tensor:
    """Colored NLM following cv2.fastNlMeansDenoisingColored's structure:
    the luma and chroma planes denoised apart, in YCrCb (the JAX package's
    documented deviation from cv2's CIELAB). The frames' three planes run
    as one batch through K10 with a per-plane h², between K17's forward
    (BGR frames to planar YCrCb) and inverse."""
    h, w = img_bgr_u8.shape[-3:-1]
    ycc = c_ops.bgr_to_ycrcb_planes(img_bgr_u8)
    planes = ycc.reshape(-1, h, w)
    h2 = torch.tensor([h_luma * h_luma, h_chroma * h_chroma,
                       h_chroma * h_chroma], dtype=torch.float32,
                      device=img_bgr_u8.device).repeat(planes.shape[0] // 3)
    out = _nlm(planes, h2, template, search).reshape(ycc.shape)
    return c_ops.ycrcb_planes_to_bgr(out)
