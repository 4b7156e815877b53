"""Public path-based API (counterpart of ``dctsvd_tpu/api.py``).

``embed / extract / detect`` and ``embed_payload / extract_payload`` keep
the JAX package's signatures, plus an explicit ``device`` (default
``'cuda'``; there is no CPU fallback when no GPU is present — pass
``device='cpu'`` to run on the CPU). ``method='full'`` (the default) is
the parity path (models/image.py: whole-frame DCT + SVD); ``'blocked'``
the 8×8 scheme (models/blocked.py).
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from dctsvd_tpu_torch.io import image_io, meta as metaio
from dctsvd_tpu_torch.models import blocked as m_blocked
from dctsvd_tpu_torch.models import image as m_image
from dctsvd_tpu_torch.models import payload as m_payload
from dctsvd_tpu_torch.ops import color as c_ops
from dctsvd_tpu_torch.ops import resize as r_ops
from dctsvd_tpu_torch.utils import crypto
from dctsvd_tpu_torch.utils.config import (DETECT_THRESH_BLOCKED,
                                           DETECT_THRESH_DEFAULT,
                                           K_FRAC_DEFAULT)

DEFAULT_DEVICE = m_blocked.DEFAULT_DEVICE


class _OpenModeSentinel:
    """Explicit opt-in to the password-less "open" mode (see OPEN_MODE)."""

    def __repr__(self) -> str:  # pragma: no cover
        return "dctsvd_tpu_torch.OPEN_MODE"

    def __bool__(self) -> bool:
        return False             # behaves like "no password" downstream


#: Pass as ``password=`` to *explicitly* request the legacy open mode (no
#: permutation, no HMAC). A plain ``password=None`` also embeds open-mode
#: but warns: the insecure path must be a choice, not a forgotten kwarg.
OPEN_MODE = _OpenModeSentinel()


def _embed_credentials(password):
    """(key, nonce) for an embed; warns when open mode was NOT explicit."""
    if password:
        nonce = crypto.make_nonce()
        return crypto.derive_key(password, nonce), nonce
    if password is not OPEN_MODE:
        warnings.warn(
            "embedding without a password produces an UNAUTHENTICATED "
            "open-mode meta (no keyed permutation, no HMAC). Pass a "
            "password, or password=dctsvd_tpu_torch.OPEN_MODE to opt in "
            "explicitly.", UserWarning, stacklevel=3)
    return None, None


def _plane_indices(key, n: int, device) -> torch.Tensor:
    """The parity path's keyed full-plane shuffle (identity for open
    mode), derived on the host."""
    idx = (crypto.permutation_indices(key, n) if key is not None
           else np.arange(n))
    return torch.as_tensor(idx, device=device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _embed_parity_gray(cover: np.ndarray, wm_gray: torch.Tensor,
                       out_path: str, meta_path: str, *, alpha: float,
                       key, nonce, kfrac: float, device,
                       payload_type: str = "image", extra=None):
    """Parity gray embed of a cover and an H×W u8 gray watermark tensor;
    writes the stego PNG and the (HMAC-signed) gray meta."""
    h, w = cover.shape[:2]
    res = m_image.embed_gray(torch.as_tensor(cover, device=device), wm_gray,
                             _plane_indices(key, h * w, device), alpha,
                             kfrac=kfrac)
    sc, uw, vwt = _np(res.sc), _np(res.uw), _np(res.vwt)
    digest = metaio.gray_digest(key, sc, uw, vwt) if key else None
    out_path = metaio.default_stego_path(out_path)
    image_io.write_png(out_path, _np(res.stego_bgr))
    meta_path = metaio.save_gray_meta(
        meta_path, sc=sc, uw=uw, vwt=vwt, sw=_np(res.sw), shape=(h, w),
        alpha=alpha, kfrac=kfrac, nonce=nonce, digest=digest,
        payload_type=payload_type, extra=extra)
    return out_path, meta_path, float(res.psnr), float(res.ssim)


def embed(cover_path: str, wm_source: str, out_path: str, meta_path: str,
          alpha: float = 0.1, color: bool = False,
          password: Optional[str] = None, kfrac: float = K_FRAC_DEFAULT,
          method: str = "full",
          device=DEFAULT_DEVICE) -> Tuple[str, str, float, float]:
    """Embed a watermark image into a cover image; returns (out_path,
    meta_path, psnr, ssim). ``password=OPEN_MODE`` selects the explicit
    open mode (no permutation, no HMAC); a bare ``password=None`` embeds
    open-mode with a UserWarning."""
    cover = image_io.read_bgr(cover_path)
    wm = image_io.read_bgr(wm_source)
    h, w = cover.shape[:2]
    key, nonce = _embed_credentials(password)
    wm_rs = r_ops.resize_area_u8(torch.as_tensor(wm, device=device), h, w)
    if method == "blocked":
        return m_blocked.embed_paths(cover, _np(wm_rs), out_path, meta_path,
                                     alpha=alpha, color=color, key=key,
                                     nonce=nonce, kfrac=kfrac, device=device)
    if not color:
        return _embed_parity_gray(cover, c_ops.bgr_to_gray(wm_rs), out_path,
                                  meta_path, alpha=alpha, key=key,
                                  nonce=nonce, kfrac=kfrac, device=device)
    res = m_image.embed_color(torch.as_tensor(cover, device=device), wm_rs,
                              _plane_indices(key, h * w, device), alpha,
                              kfrac=kfrac)
    s_bgr, uw, vwt = _np(res.s_cover), _np(res.uw), _np(res.vwt)
    digest = metaio.color_digest(key, s_bgr, uw, vwt) if key else None
    out_path = metaio.default_stego_path(out_path)
    image_io.write_png(out_path, _np(res.stego_bgr))
    meta_path = metaio.save_color_meta(
        meta_path, s_bgr=s_bgr, uw=uw, vwt=vwt, sw=_np(res.sw), shape=(h, w),
        alpha=alpha, kfrac=kfrac, nonce=nonce, digest=digest)
    return out_path, meta_path, float(res.psnr), float(res.ssim)


def _restore_meta_scale(stego: np.ndarray, meta: metaio.Meta) -> np.ndarray:
    """Rescale a stego resized after embedding back to the meta's
    embed-time shape on the host: INTER_LINEAR up, INTER_AREA down."""
    if not meta.shape or stego.shape[:2] == tuple(meta.shape):
        return stego
    import cv2
    h, w = meta.shape
    up = h * w >= stego.shape[0] * stego.shape[1]
    warnings.warn(
        f"stego is {stego.shape[1]}x{stego.shape[0]} but the meta was "
        f"written at {w}x{h}; rescaling to the embed-time shape "
        f"(scores degrade like the resize-restore attack rows)")
    return cv2.resize(stego, (w, h), interpolation=(
        cv2.INTER_LINEAR if up else cv2.INTER_AREA))


def _meta_key(meta: metaio.Meta, password):
    """The key of a signed meta (a password is required), None for an
    open-mode meta."""
    if meta.digest is None:
        return None
    crypto.require_password(password)
    return crypto.derive_key(password, meta.nonce)


def _extract_parity(stego: np.ndarray, meta: metaio.Meta, key, *,
                    normalize: bool, device) -> np.ndarray:
    """HMAC-gated parity extraction to a u8 array (gray plane or BGR)."""
    h, w = meta.shape
    st = m_image.state_from_meta(meta, device)
    if key is not None:
        uw, vwt, _sw = meta.wm_basis_stacked()
        s_cover = meta.s_cover_stacked()
        digest = metaio.color_digest if meta.is_color else metaio.gray_digest
        if not crypto.digests_equal(digest(key, s_cover, uw, vwt),
                                    meta.digest):
            raise ValueError("Wrong password or corrupted meta "
                             "(HMAC verification failed).")
    inv = torch.as_tensor(crypto.inverse_permutation(
        crypto.permutation_indices(key, h * w)) if key is not None
        else np.arange(h * w), device=device)
    fn = m_image.extract_color if meta.is_color else m_image.extract_gray
    wm = fn(torch.as_tensor(stego, device=device), st.sc, st.uw, st.vwt,
            inv, float(meta.alpha), kfrac=meta.kfrac, normalize=normalize,
            shape=(h, w))
    return _np(wm)


def extract(stego_path: str, meta_path: str, out_path: str,
            password: Optional[str] = None, normalize: bool = True,
            enhance: bool = True, device=DEFAULT_DEVICE) -> str:
    """HMAC-gated extraction, then (``enhance``) the NLM -> CLAHE ->
    unsharp chain. Open-mode metas extract with ``password=None``."""
    meta = metaio.load_meta(meta_path)
    stego = _restore_meta_scale(image_io.read_bgr(stego_path), meta)
    key = _meta_key(meta, password)
    if meta.is_blocked:
        return m_blocked.extract_paths(stego, meta, out_path, key,
                                       normalize=normalize, enhance=enhance,
                                       device=device)
    wm_np = _extract_parity(stego, meta, key, normalize=normalize,
                            device=device)
    if enhance:
        from dctsvd_tpu_torch.models import enhance as m_enhance
        fn = (m_enhance.enhance_color_np if meta.is_color
              else m_enhance.enhance_gray_np)
        wm_np = fn(wm_np, device=device)
    out_path = metaio.default_wm_path(out_path)
    image_io.write_png(out_path, wm_np)
    return out_path


def detect(stego_path: str, meta_path: str,
           thresh: Optional[float] = None,
           resync: bool = False,
           rot_range: float = 0.0,
           rot_step: float = 0.05,
           device=DEFAULT_DEVICE) -> Tuple[bool, float]:
    """No-password detection. Parity metas score the global NC against
    0.6; blocked metas the band-median statistic against the ROC-backed
    0.30. An explicit ``thresh`` overrides either. ``resync=True``
    (blocked metas) searches candidate translations, and ``rot_range``
    > 0 also attacker rotations within ±rot_range degrees at rot_step
    resolution; a parity meta has no block grid to realign, so there the
    search is skipped with a warning."""
    meta = metaio.load_meta(meta_path)
    stego = _restore_meta_scale(image_io.read_bgr(stego_path), meta)
    if meta.is_blocked:
        return m_blocked.detect_paths(
            stego, meta, DETECT_THRESH_BLOCKED if thresh is None else thresh,
            resync=resync, rot_range=rot_range, rot_step=rot_step,
            device=device)
    if resync or rot_range:
        warnings.warn("resync applies to blocked metas only; this parity "
                      "meta is scored without a geometry search",
                      UserWarning, stacklevel=2)
    if thresh is None:
        thresh = DETECT_THRESH_DEFAULT
    st = m_image.state_from_meta(meta, device)
    fn = m_image.detect_color if meta.is_color else m_image.detect_gray
    score = float(fn(torch.as_tensor(stego, device=device), st.sc, st.sw,
                     float(meta.alpha)))
    return bool(score >= thresh), score


def embed_payload(cover_path: str, payload, out_path: str, meta_path: str,
                  alpha: float = 0.1, password: Optional[str] = None,
                  kfrac: float = K_FRAC_DEFAULT, repeat: int = 8,
                  method: str = "full",
                  device=DEFAULT_DEVICE) -> Tuple[str, str, float, float]:
    """Embed a text/JSON/bytes payload as a bit-plane watermark (4-byte
    length header, each bit repeated ``repeat`` times) through the gray
    pipeline of ``method``. Password handling as in :func:`embed`."""
    cover = image_io.read_bgr(cover_path)
    h, w = cover.shape[:2]
    data, ptype = m_payload.payload_to_bytes(payload)
    plane = m_payload.bytes_to_bitplane(data, h, w, repeat=repeat)
    key, nonce = _embed_credentials(password)
    extra = {"repeat": int(repeat)}
    if method == "blocked":
        return m_blocked.embed_paths(
            cover, plane, out_path, meta_path, alpha=alpha, color=False,
            key=key, nonce=nonce, kfrac=kfrac, payload_type=ptype,
            extra_meta=extra, device=device)
    return _embed_parity_gray(cover, torch.as_tensor(plane, device=device),
                              out_path, meta_path, alpha=alpha, key=key,
                              nonce=nonce, kfrac=kfrac, device=device,
                              payload_type=ptype, extra=extra)


def extract_payload(stego_path: str, meta_path: str,
                    password: Optional[str] = None, device=DEFAULT_DEVICE):
    """Recover an embedded text/JSON/bytes payload (majority vote over
    the repetitions)."""
    meta = metaio.load_meta(meta_path)
    stego = _restore_meta_scale(image_io.read_bgr(stego_path), meta)
    repeat = int(meta.arrays.get("repeat", 1))
    key = _meta_key(meta, password)
    if meta.is_blocked:
        plane = m_blocked.extract_array(stego, meta, key, normalize=True,
                                        device=device)
    else:
        plane = _extract_parity(stego, meta, key, normalize=True,
                                device=device)
    data = m_payload.bitplane_to_bytes(plane, repeat=repeat)
    return m_payload.bytes_to_payload(data, meta.payload_type)
