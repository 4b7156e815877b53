"""Image watermark pipelines of the parity path: embed, extract, detect.

Counterpart of ``dctsvd_tpu/models/image.py``: whole-frame DCT + full SVD,
additive spread on the top-K singular values, keyed permutation as a
gather. Host concerns (file IO, password -> key, HMAC, npz) live in
``dctsvd_tpu_torch.api`` / ``dctsvd_tpu_torch.io.meta``.

The whole-frame DCT is two f32 basis products and the SVD is the library
call of ``ops.svd.svd_full``: the JAX package has no Pallas kernel on this
path. Functions take tensors and run on their device; ``alpha`` is a
Python float or a 0-d tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dctsvd_tpu_torch.models.blocked import _alpha
from dctsvd_tpu_torch.ops import color, dct, metrics, permute, tail_cuda
from dctsvd_tpu_torch.ops.svd import svd_full
from dctsvd_tpu_torch.utils.config import K_FRAC_DEFAULT


def k_of(length: int, kfrac: float) -> int:
    """K = max(8, int(kfrac · L)) (ref: app_dct_svd_single.py:174)."""
    return max(8, int(kfrac * length))


class GrayEmbedResult(NamedTuple):
    stego_bgr: torch.Tensor   # [H, W, 3] u8
    y_marked: torch.Tensor    # [H, W] f32, pre-clip (feeds the SSIM)
    sc: torch.Tensor          # [L] cover singular values
    uw: torch.Tensor          # [H, L] watermark left basis (DCT domain)
    vwt: torch.Tensor         # [L, W] watermark right basis
    sw: torch.Tensor          # [L] watermark singular values
    psnr: torch.Tensor
    ssim: torch.Tensor


class ColorEmbedResult(NamedTuple):
    stego_bgr: torch.Tensor   # [H, W, 3] u8
    s_cover: torch.Tensor     # [3, L] per-channel cover singular values
    uw: torch.Tensor          # [3, H, L]
    vwt: torch.Tensor         # [3, L, W]
    sw: torch.Tensor          # [3, L]
    psnr: torch.Tensor
    ssim: torch.Tensor


class ParityState(NamedTuple):
    """What extract and detect read from a parity meta, as tensors:
    stacked [3, ...] (B, G, R) for color metas, plain for gray."""
    sc: torch.Tensor          # [(3,) L]
    uw: torch.Tensor          # [(3,) H, L]
    vwt: torch.Tensor         # [(3,) L, W]
    sw: torch.Tensor          # [(3,) L]


def state_from_meta(meta, device) -> ParityState:
    """A parity meta's Sc/Uw/Vwt/Sw (written by either package) as f32
    tensors on ``device``."""
    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    uw, vwt, sw = meta.wm_basis_stacked()
    return ParityState(f32(meta.s_cover_stacked()), f32(uw), f32(vwt),
                       f32(sw))


def _spread(s_cover: torch.Tensor, s_wm: torch.Tensor, alpha,
            k: int) -> torch.Tensor:
    """S'[i] = S[i] + α·Sw[i] for i < K, else S[i]
    (ref: app_dct_svd_single.py:174-175)."""
    l = s_cover.shape[-1]
    mask = (torch.arange(l, device=s_cover.device) < k).to(s_cover.dtype)
    return s_cover + _alpha(alpha, s_cover.device) * mask * s_wm


def _compose(u: torch.Tensor, s: torch.Tensor,
             vt: torch.Tensor) -> torch.Tensor:
    """U · diag(S) · Vt over the trailing axes."""
    return torch.matmul(u * s[..., None, :], vt)


def embed_gray(cover_bgr_u8: torch.Tensor, wm_gray_u8: torch.Tensor,
               perm_idx: torch.Tensor, alpha,
               kfrac: float = K_FRAC_DEFAULT) -> GrayEmbedResult:
    """Gray (Y-channel) embed (ref: app_dct_svd_single.py:168-190).
    ``wm_gray_u8`` is already resized to the cover's H×W."""
    h, w = cover_bgr_u8.shape[-3], cover_bgr_u8.shape[-2]
    y = color.luma_f32(cover_bgr_u8)
    wy_s = permute.permute_plane(wm_gray_u8.to(torch.float32), perm_idx)

    uc, sc, vct = svd_full(dct.dct2(y))
    uw, sw, vwt = svd_full(dct.dct2(wy_s))

    k = k_of(min(h, w), kfrac)
    y_marked = dct.idct2(_compose(uc, _spread(sc, sw, alpha, k), vct))
    stego = color.replace_luma(y_marked, cover_bgr_u8)

    ps = metrics.psnr(cover_bgr_u8, stego)
    ss = metrics.ssim(color.bgr_to_gray(cover_bgr_u8), y_marked)
    return GrayEmbedResult(stego, y_marked, sc, uw, vwt, sw, ps, ss)


def embed_color(cover_bgr_u8: torch.Tensor, wm_bgr_u8: torch.Tensor,
                perm_idx: torch.Tensor, alpha,
                kfrac: float = K_FRAC_DEFAULT) -> ColorEmbedResult:
    """Per-BGR-channel embed with one shared permutation
    (ref: app_dct_svd_single.py:121-167)."""
    h, w = cover_bgr_u8.shape[-3], cover_bgr_u8.shape[-2]
    chans = torch.movedim(cover_bgr_u8.to(torch.float32), -1, 0)  # [3,H,W]
    wm_chans = torch.movedim(wm_bgr_u8.to(torch.float32), -1, 0)
    wm_s = permute.permute_plane(wm_chans, perm_idx)

    uc, sc, vct = svd_full(dct.dct2(chans))      # batched over 3 channels
    uw, sw, vwt = svd_full(dct.dct2(wm_s))

    k = k_of(min(h, w), kfrac)
    marked = dct.idct2(_compose(uc, _spread(sc, sw, alpha, k), vct))
    stego = torch.movedim(marked.clamp(0, 255).to(torch.uint8), 0, -1)

    ps = metrics.psnr(cover_bgr_u8, stego)
    ss = metrics.ssim(color.bgr_to_gray(cover_bgr_u8),
                      color.bgr_to_gray(stego))
    return ColorEmbedResult(stego, sc, uw, vwt, sw, ps, ss)


def _recovered(s_cw: torch.Tensor, sc: torch.Tensor, uw: torch.Tensor,
               vwt: torch.Tensor, alpha, kfrac: float, h: int,
               w: int) -> torch.Tensor:
    """The watermark's DCT plane [..., H, W] from the stego's singular
    values: Ŝw = (S_cw − Sc)/α on the K leading values, recomposed on the
    stored bases' top-left l×l and zero elsewhere."""
    l = min(sc.shape[-1], s_cw.shape[-1], uw.shape[-2], vwt.shape[-2])
    k = k_of(l, kfrac)
    alpha_safe = torch.clamp(_alpha(alpha, s_cw.device), min=1e-8)
    sw_hat = (s_cw[..., :l] - sc[..., :l]) / alpha_safe
    sw_hat = torch.where(torch.arange(l, device=s_cw.device) < k, sw_hat,
                         0.0)
    wm_hat = _compose(uw[..., :l, :l], sw_hat, vwt[..., :l, :l])
    a, b = min(l, h), min(l, w)
    wm_full = torch.zeros(*wm_hat.shape[:-2], h, w, dtype=torch.float32,
                          device=s_cw.device)
    wm_full[..., :a, :b] = wm_hat[..., :a, :b]
    return wm_full


def extract_gray(stego_bgr_u8: torch.Tensor, sc: torch.Tensor,
                 uw: torch.Tensor, vwt: torch.Tensor, inv_idx: torch.Tensor,
                 alpha, kfrac: float = K_FRAC_DEFAULT,
                 normalize: bool = True, shape=None) -> torch.Tensor:
    """Gray extract up to the u8 watermark plane, before enhancement
    (ref: app_dct_svd_single.py:203-222). ``shape`` is the meta's (H, W):
    the canvas and the unpermute are sized from it (default: the stego's
    own shape)."""
    h, w = shape or (stego_bgr_u8.shape[-3], stego_bgr_u8.shape[-2])
    s_cw = svd_full(dct.dct2(color.luma_f32(stego_bgr_u8)),
                    compute_uv=False)
    wm_full = _recovered(s_cw, sc, uw, vwt, alpha, kfrac, h, w)
    wy = permute.unpermute_plane(dct.idct2(wm_full), inv_idx)
    if normalize:
        wy = _minmax_255(wy)
    return wy.clamp(0, 255).to(torch.uint8)


def extract_color(stego_bgr_u8: torch.Tensor, s_cover: torch.Tensor,
                  uw: torch.Tensor, vwt: torch.Tensor, inv_idx: torch.Tensor,
                  alpha, kfrac: float = K_FRAC_DEFAULT,
                  normalize: bool = True, shape=None) -> torch.Tensor:
    """Color extract, before enhancement (ref:
    app_dct_svd_single.py:232-274); ``shape`` as in :func:`extract_gray`."""
    h, w = shape or (stego_bgr_u8.shape[-3], stego_bgr_u8.shape[-2])
    chans = torch.movedim(stego_bgr_u8.to(torch.float32), -1, 0)
    s_cw = svd_full(dct.dct2(chans), compute_uv=False)       # [3, L]
    wm_full = _recovered(s_cw, s_cover, uw, vwt, alpha, kfrac, h, w)
    wm = permute.unpermute_plane(dct.idct2(wm_full), inv_idx)
    if normalize:
        wm = _minmax_255(wm)
    return torch.movedim(wm.clamp(0, 255).to(torch.uint8), 0, -1)


def _minmax_255(x: torch.Tensor) -> torch.Tensor:
    """cv2.normalize(..., 0, 255, NORM_MINMAX) of each [H, W] plane."""
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    return (x - lo) * tail_cuda.scale_255(lo, hi)


def _nc_score(s_cw: torch.Tensor, sc: torch.Tensor, sw: torch.Tensor,
              alpha) -> torch.Tensor:
    """NC between the stored Sw and Ŝw = (S_cw − Sc)/α over every value
    (detect applies no K truncation)."""
    l = min(sc.shape[-1], s_cw.shape[-1], sw.shape[-1])
    alpha_safe = torch.clamp(_alpha(alpha, s_cw.device), min=1e-8)
    sw_hat = (s_cw[..., :l] - sc[..., :l]) / alpha_safe
    return metrics.nc(sw[..., :l], sw_hat)


def detect_gray(stego_bgr_u8: torch.Tensor, sc: torch.Tensor,
                sw: torch.Tensor, alpha) -> torch.Tensor:
    """No-password NC detect score (ref: app_dct_svd_single.py:291-302)."""
    s_cw = svd_full(dct.dct2(color.luma_f32(stego_bgr_u8)),
                    compute_uv=False)
    return _nc_score(s_cw, sc, sw, alpha)


def detect_color(stego_bgr_u8: torch.Tensor, s_cover: torch.Tensor,
                 sw: torch.Tensor, alpha) -> torch.Tensor:
    """Mean of the per-channel NC scores
    (ref: app_dct_svd_single.py:303-318)."""
    chans = torch.movedim(stego_bgr_u8.to(torch.float32), -1, 0)
    s_cw = svd_full(dct.dct2(chans), compute_uv=False)
    return _nc_score(s_cw, s_cover, sw, alpha).mean()
