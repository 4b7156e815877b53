"""Blocked (8×8) DCT–SVD watermarking: embed, extract, detect and the
serve steps.

Counterpart of ``dctsvd_tpu/models/blocked.py``, with detect resync
(translation and rotation search). The frame becomes a grid of 8×8
blocks; each block's leading singular values carry the keyed,
block-permuted watermark's singular values (α·Sw), and extraction and
detection read them back as (S(stego) − Sc)/α.

The per-frame work runs on the pixel blocks through the hand-written
kernels (ops/wm_cuda.py): K2 embeds, K1 measures the stego spectrum, and
the serve steps (embed, then verify by extract and/or score, per batch)
take K3, which embeds and measures the rounded stego in one kernel. The
watermark's factors come from K4 (ops/svd_cuda.py) once per watermark.
The port always runs these fused semantics — a pixel-domain Jacobi at the
fused schedule, through the kernel on the GPU or its plain twin on the
CPU — so its metas record ``(sweeps, sweeps_xpairs)`` of that schedule
(default s1.25 = ``(1, 7)``), where a CPU run of the JAX package records
``(0, 0)``. Embed and extract must run the same rotation prefix for the
convergence residue to cancel in ``s_cw − sc``; extract and detect replay
the meta's schedule (:func:`replay_sweeps`).

Tensors keep the JAX package's layouts: channels-last u8 BGR frames with
optional leading batch dims, spectra ``[..., (C,) N, 8]`` with the
row-major block index ``n = by·Wb + bx``. Functions take tensors and run
on their device; the path-level entry points take an explicit ``device``.
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dctsvd_tpu_torch.io import image_io, meta as metaio
from dctsvd_tpu_torch.ops import (color, dct, detect_cuda, enhance, metrics,
                                  permute, resync_cuda, svd, tail_cuda,
                                  wm_cuda)
from dctsvd_tpu_torch.utils import crypto
from dctsvd_tpu_torch.utils.config import BLOCK, K_FRAC_DEFAULT

#: Device of the path-level entry points when none is given. There is no
#: CPU fallback: without a GPU, pass ``device='cpu'`` explicitly.
DEFAULT_DEVICE = "cuda"


def k_of_block(kfrac: float, b: int = BLOCK) -> int:
    """Per-block truncation: K = max(1, int(kfrac · b)) leading singular
    values of each 8×8 block carry the mark (kfrac=0.6 -> 4 of 8)."""
    return max(1, int(kfrac * b))


def n_blocks_of(h: int, w: int, b: int = BLOCK) -> int:
    """Block count after reflect-padding to a multiple of b."""
    return (-(-h // b)) * (-(-w // b))


def _pad_axis(x: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    """numpy/jnp 'reflect' padding of one axis by ``pad`` at its end."""
    if not pad:
        return x
    return x.index_select(dim, enhance.reflect_index(x.shape[dim], 0, pad,
                                                     x.device))


def _pad_to_blocks(x: torch.Tensor,
                   b: int = BLOCK) -> Tuple[torch.Tensor, int, int]:
    """Reflect-pad [..., H, W] to multiples of b (an index gather, so it
    works for every dtype)."""
    h, w = x.shape[-2], x.shape[-1]
    ph, pw = (-h) % b, (-w) % b
    x = _pad_axis(_pad_axis(x, x.ndim - 2, ph), x.ndim - 1, pw)
    return x, h + ph, w + pw


def _pad_frames_to_blocks(x: torch.Tensor,
                          b: int = BLOCK) -> Tuple[torch.Tensor, int, int]:
    """Channels-last analog of _pad_to_blocks: pads H, W at axes -3/-2."""
    h, w = x.shape[-3], x.shape[-2]
    ph, pw = (-h) % b, (-w) % b
    x = _pad_axis(_pad_axis(x, x.ndim - 3, ph), x.ndim - 2, pw)
    return x, h + ph, w + pw


def _parse_sweeps_env(raw: str):
    """DCTSVD_FUSED_SWEEPS accepts fractional tiers ('1.5' = one full
    28-pair sweep + the first 14 pairs of a second), quantized onto the
    pair grid here so the kernels' schedule, the meta's (sweeps,
    sweeps_xpairs) and the digest's pair count derive from one number.
    Integral inputs stay ints."""
    return wm_cuda.sched_join(*wm_cuda.sched_split(float(raw)))


_FUSED_SWEEPS = _parse_sweeps_env(
    os.environ.get("DCTSVD_FUSED_SWEEPS", "1.25"))


def embed_sweeps_used():
    """The Jacobi sweep schedule the next embed runs (recorded in the meta
    so extract/detect replay it)."""
    return _FUSED_SWEEPS


def embed_schedule_used() -> tuple:
    """embed_sweeps_used as the two integers that serialize it:
    (full sweeps, extra pairs 0..27)."""
    return wm_cuda.sched_split(_FUSED_SWEEPS)


def replay_sweeps(meta_sweeps):
    """Kernel sweep count for a meta embedded with ``meta_sweeps``: 0 (a
    converged embed, e.g. the JAX package's CPU path) maps to the
    near-converged kernel default 4 — a 0-sweep kernel call would return
    unrotated column norms."""
    return meta_sweeps if meta_sweeps > 0 else wm_cuda._SWEEPS_DEFAULT


def _scalar(value: float, device) -> torch.Tensor:
    """A 0-d f32 tensor on ``device``, made by a fill: a copy from the
    host would block until the card's queue drains (and so serialise the
    shards of a batch)."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _alpha(alpha, device) -> torch.Tensor:
    if isinstance(alpha, torch.Tensor):
        return alpha.to(device=device, dtype=torch.float32)
    return _scalar(alpha, device)


def _k_mask(kfrac: float, device) -> torch.Tensor:
    return (torch.arange(BLOCK, device=device)
            < k_of_block(kfrac)).to(torch.float32)


def _plane_spectrum(plane: torch.Tensor, sweeps=None) -> torch.Tensor:
    """[..., H, W] plane (u8 or f32) -> per-block singular values
    [..., N, 8] at the replayed schedule (None = the serving default)."""
    padded, _, _ = _pad_to_blocks(plane)
    return wm_cuda.spectrum_blocks(
        padded, sweeps=(_FUSED_SWEEPS if sweeps is None
                        else replay_sweeps(sweeps)))


def _frames_spectrum(frames_bhwc: torch.Tensor, sweeps=None) -> torch.Tensor:
    """Channels-last per-block spectrum: [..., H, W, C] -> [..., C, N, 8],
    read straight off the frames (no moveaxis)."""
    padded, _, _ = _pad_frames_to_blocks(frames_bhwc)
    return wm_cuda.spectrum_blocks(
        padded, sweeps=(_FUSED_SWEEPS if sweeps is None
                        else replay_sweeps(sweeps)),
        channels_last=True)


def _scaled_sws(sw: torch.Tensor, alpha: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """α·mask·Sw collapsed to the [P, N, 8] layout the kernels take."""
    sws = (alpha * mask * sw).to(torch.float32)
    if sws.ndim == 2:
        sws = sws[None]
    elif sws.ndim > 3:
        sws = sws.reshape(-1, *sws.shape[-2:])
    return sws.contiguous()


def _embed_planes(planes: torch.Tensor, sw: torch.Tensor, alpha,
                  kfrac: float, out_u8: bool = False):
    """Blocked embed on [..., H, W] planes (u8 or f32) against slot-ordered
    watermark SVs ``sw``. Returns (marked [..., H, W], sc [..., N, 8])."""
    h, w = planes.shape[-2], planes.shape[-1]
    alpha = _alpha(alpha, planes.device)
    sws = _scaled_sws(sw, alpha, _k_mask(kfrac, planes.device))
    padded, _, _ = _pad_to_blocks(planes)
    marked, sc = wm_cuda.embed_blocks(padded, sws, k=k_of_block(kfrac),
                                      sweeps=_FUSED_SWEEPS, out_u8=out_u8)
    return marked[..., :h, :w], sc


def _embed_frames(frames_bhwc: torch.Tensor, sw: torch.Tensor, alpha,
                  kfrac: float):
    """Channels-last embed: [..., H, W, C] frames in, (u8 stego in the same
    layout, sc [..., C, N, 8]) out; the kernel reads and writes the frames
    directly and truncates to u8 itself."""
    h, w = frames_bhwc.shape[-3], frames_bhwc.shape[-2]
    alpha = _alpha(alpha, frames_bhwc.device)
    sws = _scaled_sws(sw, alpha, _k_mask(kfrac, frames_bhwc.device))
    padded, _, _ = _pad_frames_to_blocks(frames_bhwc)
    marked, sc = wm_cuda.embed_blocks(padded, sws, k=k_of_block(kfrac),
                                      sweeps=_FUSED_SWEEPS, out_u8=True,
                                      channels_last=True)
    return marked[..., :h, :w, :], sc


class BlockedEmbedResult(NamedTuple):
    stego_bgr: torch.Tensor   # [..., H, W, 3] u8
    sc: torch.Tensor          # [..., N, 8]  cover block singular values
    uw: torch.Tensor          # [..., N, 8, 8] natural block order
    vwt: torch.Tensor         # [..., N, 8, 8] natural block order
    sw: torch.Tensor          # [..., N, 8]  permuted slot order
    psnr: torch.Tensor
    ssim: torch.Tensor


class PreparedWatermark(NamedTuple):
    """Watermark-side SVD factors, computed once per (watermark, key).

    ``sw`` is in permuted SLOT order (aligned with cover blocks at embed);
    ``uw``/``vwt`` are pre-gathered into NATURAL block order.
    ``inv_blk``/``inv_intra`` are the inverse permutations extraction needs;
    ``ebasis`` is the pixel-domain per-component reconstruction basis
    E[..., n, j, :, :] = IDCT_unshuffled(u_j·v_jᵀ), or None."""
    uw: torch.Tensor          # [..., N, 8, 8]
    sw: torch.Tensor          # [..., N, 8]
    vwt: torch.Tensor         # [..., N, 8, 8]
    inv_blk: torch.Tensor     # [N]
    inv_intra: torch.Tensor   # [64]
    ebasis: Optional[torch.Tensor]   # [..., N, 8, 8, 8]


def prepare_extract_basis(uw_nat: torch.Tensor, vwt_nat: torch.Tensor,
                          inv_intra: torch.Tensor) -> torch.Tensor:
    """E[..., n, j, x, y] = Σ_{a,c} T[x,y,a,c] · U[..., n, a, j] ·
    Vt[..., n, j, c], T the intra-unshuffled IDCT tensor."""
    t = dct.idct_pixel_tensor(BLOCK, row_perm=inv_intra)
    return torch.einsum("xyac,...naj,...njc->...njxy", t, uw_nat, vwt_nat)


def prepared_from_numpy(uw, sw, vwt, inv_blk, inv_intra, ebasis=None, *,
                        device) -> PreparedWatermark:
    """A PreparedWatermark from the JAX package's fields as numpy arrays
    (or a meta's Uw/Sw/Vwt), on ``device``."""
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    def idx(a):
        return torch.as_tensor(np.array(a, np.int64), device=device)

    return PreparedWatermark(f32(uw), f32(sw), f32(vwt), idx(inv_blk),
                             idx(inv_intra),
                             None if ebasis is None else f32(ebasis))


def _prepare(wm_planes: torch.Tensor, blk_idx: torch.Tensor,
             intra_idx: torch.Tensor,
             extract_basis: bool = True) -> PreparedWatermark:
    padded, _, _ = _pad_to_blocks(wm_planes)
    blocks = dct.blockify(padded)
    blocks = permute.permute_block_tensor(blocks, blk_idx, intra_idx)
    coefs = dct.dct2_blocks(blocks)
    uw, sw, vwt = svd.jacobi_svd(coefs, compute_uv=True)
    inv_blk = torch.argsort(blk_idx)
    inv_intra = torch.argsort(intra_idx)
    uw_nat = uw.index_select(-3, inv_blk)
    vwt_nat = vwt.index_select(-3, inv_blk)
    ebasis = (prepare_extract_basis(uw_nat, vwt_nat, inv_intra)
              if extract_basis else None)
    return PreparedWatermark(uw_nat, sw, vwt_nat, inv_blk, inv_intra,
                             ebasis)


def prepare_wm_gray(wm_gray_u8: torch.Tensor, blk_idx: torch.Tensor,
                    intra_idx: torch.Tensor,
                    extract_basis: bool = True) -> PreparedWatermark:
    """Keyed block-permute + block-DCT + SVD (K4) of a gray watermark
    plane. ``extract_basis=False`` skips the [N, 8, 8, 8] pixel basis."""
    return _prepare(wm_gray_u8.to(torch.float32), blk_idx, intra_idx,
                    extract_basis)


def prepare_wm_color(wm_bgr_u8: torch.Tensor, blk_idx: torch.Tensor,
                     intra_idx: torch.Tensor,
                     extract_basis: bool = True) -> PreparedWatermark:
    """Per-BGR-channel prepared watermark (one shared permutation)."""
    chans = torch.movedim(wm_bgr_u8.to(torch.float32), -1, -3)
    return _prepare(chans, blk_idx, intra_idx, extract_basis)


def _no_metrics(cover: torch.Tensor) -> torch.Tensor:
    # -1 sentinel: PSNR is never negative and a real SSIM is never -1
    return torch.full(cover.shape[:-3], -1.0, dtype=torch.float32,
                      device=cover.device)


def embed_gray_prepared(cover_bgr_u8: torch.Tensor, sw: torch.Tensor,
                        alpha, kfrac: float = K_FRAC_DEFAULT,
                        with_metrics: bool = True):
    """Cover-side blocked gray (Y-channel) embed against a prepared
    watermark. Returns (stego_bgr u8, sc, psnr, ssim); psnr/ssim are -1
    when ``with_metrics=False``."""
    y = color.luma_f32(cover_bgr_u8)
    y_marked, sc = _embed_planes(y, sw, alpha, kfrac)
    stego = color.replace_luma(y_marked, cover_bgr_u8)
    if not with_metrics:
        ps = ss = _no_metrics(cover_bgr_u8)
        return stego, sc, ps, ss
    ps = metrics.psnr(cover_bgr_u8, stego)
    ss = metrics.ssim(color.bgr_to_gray(cover_bgr_u8), y_marked)
    return stego, sc, ps, ss


def embed_color_prepared(cover_bgr_u8: torch.Tensor, sw: torch.Tensor,
                         alpha, kfrac: float = K_FRAC_DEFAULT,
                         with_metrics: bool = True):
    """Cover-side blocked per-channel embed against a prepared watermark:
    K2 reads the u8 frames and writes the u8 stego directly."""
    stego, sc = _embed_frames(cover_bgr_u8, sw, alpha, kfrac)
    if not with_metrics:
        ps = ss = _no_metrics(cover_bgr_u8)
        return stego, sc, ps, ss
    ps = metrics.psnr(cover_bgr_u8, stego)
    ss = metrics.ssim(color.bgr_to_gray(cover_bgr_u8),
                      color.bgr_to_gray(stego))
    return stego, sc, ps, ss


def _serve_front(cover_bgr_u8: torch.Tensor, sw: torch.Tensor, alpha,
                 kfrac: float):
    """(stego u8, sc, s_cw) of a frame batch at the fused schedule: K3 on
    block-aligned frames, where the verification spectrum is taken from
    the rounded stego inside the embed kernel; the split calls (K2, then
    K1 on the produced stego) on unaligned frames, which pad."""
    h, w = cover_bgr_u8.shape[-3], cover_bgr_u8.shape[-2]
    if h % BLOCK or w % BLOCK:
        stego, sc, _, _ = embed_color_prepared(cover_bgr_u8, sw, alpha,
                                               kfrac=kfrac,
                                               with_metrics=False)
        return stego, sc, _frames_spectrum(stego)
    sws = _scaled_sws(sw, _alpha(alpha, cover_bgr_u8.device),
                      _k_mask(kfrac, cover_bgr_u8.device))
    return wm_cuda.roundtrip_frames_blocks(
        cover_bgr_u8, sws, sweeps=_FUSED_SWEEPS, k=k_of_block(kfrac))


def serve_verify_color_prepared(cover_bgr_u8: torch.Tensor,
                                sw: torch.Tensor, alpha,
                                ebasis: torch.Tensor, inv_blk: torch.Tensor,
                                kfrac: float = K_FRAC_DEFAULT,
                                normalize: bool = True):
    """Embed a frame batch and extract from the produced stego in one step
    (embed, then confirm the mark recovers before shipping). Returns
    (stego u8 [..., H, W, 3], sc [..., 3, N, 8], recovered wm u8
    [..., H, W, 3]), equal to the split embed_color_prepared +
    extract_color_prepared calls."""
    h, w = cover_bgr_u8.shape[-3], cover_bgr_u8.shape[-2]
    stego, sc, s_cw = _serve_front(cover_bgr_u8, sw, alpha, kfrac)
    rec = _extract_tail_prepared(s_cw, sc, ebasis, inv_blk, alpha, kfrac,
                                 normalize, h, w, sw=sw, to_frames=True,
                                 out_u8=True)
    return stego, sc, rec


def serve_verify_detect_color_prepared(cover_bgr_u8: torch.Tensor,
                                       sw: torch.Tensor, alpha,
                                       ebasis: torch.Tensor,
                                       inv_blk: torch.Tensor,
                                       kfrac: float = K_FRAC_DEFAULT,
                                       normalize: bool = True):
    """Embed + extract-verify + detect-score a frame batch (ship the stego
    only if the mark both recovers and scores). Returns (stego u8
    [..., H, W, 3], sc [..., 3, N, 8], recovered wm u8 [..., H, W, 3],
    scores [...]). Extract and score share the one stego spectrum."""
    h, w = cover_bgr_u8.shape[-3], cover_bgr_u8.shape[-2]
    stego, sc, s_cw = _serve_front(cover_bgr_u8, sw, alpha, kfrac)
    rec = _extract_tail_prepared(s_cw, sc, ebasis, inv_blk, alpha, kfrac,
                                 normalize, h, w, sw=sw, to_frames=True,
                                 out_u8=True)
    return stego, sc, rec, _detect_scores(s_cw, sc, sw, alpha, kfrac, h, w)


def serve_detect_color_prepared(cover_bgr_u8: torch.Tensor,
                                sw: torch.Tensor, alpha,
                                kfrac: float = K_FRAC_DEFAULT):
    """Embed + detect-score a frame batch without the extract image.
    Returns (stego u8 [..., H, W, 3], sc [..., 3, N, 8], scores [...]);
    scores equal detect_color on the produced stego."""
    h, w = cover_bgr_u8.shape[-3], cover_bgr_u8.shape[-2]
    stego, sc, s_cw = _serve_front(cover_bgr_u8, sw, alpha, kfrac)
    return stego, sc, _detect_scores(s_cw, sc, sw, alpha, kfrac, h, w)


def embed_gray(cover_bgr_u8: torch.Tensor, wm_gray_u8: torch.Tensor,
               blk_idx: torch.Tensor, intra_idx: torch.Tensor, alpha,
               kfrac: float = K_FRAC_DEFAULT) -> BlockedEmbedResult:
    """Blocked gray embed (prepare + embed in one call)."""
    pw = prepare_wm_gray(wm_gray_u8, blk_idx, intra_idx,
                         extract_basis=False)
    stego, sc, ps, ss = embed_gray_prepared(cover_bgr_u8, pw.sw, alpha,
                                            kfrac=kfrac)
    return BlockedEmbedResult(stego, sc, pw.uw, pw.vwt, pw.sw, ps, ss)


def embed_color(cover_bgr_u8: torch.Tensor, wm_bgr_u8: torch.Tensor,
                blk_idx: torch.Tensor, intra_idx: torch.Tensor, alpha,
                kfrac: float = K_FRAC_DEFAULT) -> BlockedEmbedResult:
    """Blocked per-BGR-channel embed with one shared permutation."""
    pw = prepare_wm_color(wm_bgr_u8, blk_idx, intra_idx,
                          extract_basis=False)
    stego, sc, ps, ss = embed_color_prepared(cover_bgr_u8, pw.sw, alpha,
                                             kfrac=kfrac)
    return BlockedEmbedResult(stego, sc, pw.uw, pw.vwt, pw.sw, ps, ss)


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------

def _sw_scale(sw: torch.Tensor) -> torch.Tensor:
    """The shrinkage scale [(C,) 1, 1]: the mean of Sw[..., 0]. From the
    shared sw, not the estimate's expanded ref: a reduction's order on the
    card depends on how many outputs it has, so the batch must not be one
    of them (a frame's extract is the same alone or in any batch)."""
    return sw[..., 0].mean(dim=-1, keepdim=True)[..., None] + 1e-6


def _engaged(raw: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """The presence decision [...] of each plane of the raw estimate
    [..., N, 8] (column 0 is all it reads): the ⌈ng/4⌉-th largest Pearson
    over 16 contiguous block groups of (Sw[:, 0], raw[:, 0]), engaged above
    0.20 + 1.8/√gsz. K18 (ops/tail_cuda.py::presence) on the card, its
    twin on the CPU, given sc = 0 and α = 1: (raw - 0) / 1 is raw exactly."""
    return tail_cuda.presence(raw, sw, torch.zeros(1, device=raw.device),
                              torch.ones(1, device=raw.device))[0]


def _masked_normalize(wy: torch.Tensor, bad_nat: Optional[torch.Tensor],
                      hp: int, wp: int, h: int, w: int,
                      normalize: bool) -> torch.Tensor:
    """Min–max normalization to [0, 255] with erasure handling: pixels of
    flagged blocks leave the window and are repainted at its midpoint.
    ``bad_nat`` is the natural-block-order erasure mask [..., N] or None.
    The JAX package's, in eager ops: no extract runs it (K8u, ops/
    tail_cuda.py::normalize_blocks given the crop, does, on the card and
    through its twin on the CPU); the tests hold K8u's twin to it."""
    dims = (-2, -1)
    if bad_nat is None:
        if not normalize:
            return wy
        lo = wy.amin(dim=dims, keepdim=True)
        hi = wy.amax(dim=dims, keepdim=True)
        return (wy - lo) * tail_cuda.scale_255(lo, hi)
    mask8 = bad_nat[..., None, None].expand(*bad_nat.shape, BLOCK, BLOCK)
    mask = dct.unblockify(mask8.to(torch.float32), hp, wp)[..., :h, :w]
    bad_pix = mask > 0.5
    if not normalize:
        return torch.where(bad_pix, 0.0, wy)
    inf = _scalar(float("inf"), wy.device)
    lo = torch.where(bad_pix, inf, wy).amin(dim=dims, keepdim=True)
    hi = torch.where(bad_pix, -inf, wy).amax(dim=dims, keepdim=True)
    # every block flagged (mark-free input) -> the plain window; the
    # repaint below then flattens the whole plane
    ok = torch.isfinite(lo) & torch.isfinite(hi)
    lo = torch.where(ok, lo, wy.amin(dim=dims, keepdim=True))
    hi = torch.where(ok, hi, wy.amax(dim=dims, keepdim=True))
    wy = torch.where(bad_pix, (lo + hi) * 0.5, wy)
    return (wy - lo) * tail_cuda.scale_255(lo, hi)


def _permute_slots(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Slot order -> natural block order: ``take(x, idx, axis=-2)``."""
    return x.index_select(-2, idx)


# the JAX package's names for the recompute normaliser (K5's arithmetic,
# kept beside its kernel) and the channels-last unblockify
_normalize_blocks_recompute = tail_cuda.normalize_blocks_recompute
_unblockify_to_frames = dct.unblockify_to_frames


def _raw_estimate(s_cw, sc, alpha):
    return (s_cw - sc) / torch.clamp(_alpha(alpha, s_cw.device), min=1e-8)


def _extract_planes(s_cw: torch.Tensor, sc: torch.Tensor,
                    uw_nat: torch.Tensor, vwt_nat: torch.Tensor,
                    inv_blk: torch.Tensor, inv_intra: torch.Tensor, alpha,
                    kfrac: float, normalize: bool, h: int, w: int,
                    sw: Optional[torch.Tensor] = None,
                    to_frames: bool = False) -> torch.Tensor:
    """Extract tail from the stego spectrum ``s_cw`` [..., (C,) N, 8] (the
    JAX package's _extract_planes computes it inside; here the caller does,
    so the color path can read the channels-last frames directly): the
    front (K18, then K5f: :func:`_tail_front`), the SVD product and the
    IDCT (library einsums, as the JAX package leaves them to XLA), then
    K8 (aligned) or K8u (unaligned: the crop). Returns u8 planes
    [..., (C,) H, W], or channels-last frames [..., H, W, C] with
    ``to_frames``."""
    hp, wp = h + (-h) % BLOCK, w + (-w) % BLOCK
    k = k_of_block(kfrac)
    x = _tail_front(s_cw, sc, inv_blk, alpha, k, sw)
    # the k estimates zero-padded to 8 columns: the product's shape (and
    # so its bytes) of the masked [..., N, 8] estimate
    sw_nat = torch.nn.functional.pad(x[..., :k], (0, BLOCK - k))
    frame = sw_nat.shape[sw_nat.ndim - (uw_nat.ndim - 1):]   # ((C,) N, 8)

    def pixels(est):
        wm_blocks = torch.einsum("...nij,...nj,...njk->...nik", uw_nat, est,
                                 vwt_nat)
        # inverse DCT with the shared intra-block unshuffle folded in, to
        # natural-order pixel blocks
        return dct.idct2_pixel_blocks(wm_blocks, hp, wp, row_perm=inv_intra)

    # the two products a frame at a time: a batched product's algorithm on
    # the card depends on its shape (small frames' did), and a frame must
    # extract to the same bytes alone or in a batch
    est = sw_nat.reshape(-1, *frame)
    blocks = torch.stack([pixels(e) for e in est])
    blocks = blocks.reshape(*sw_nat.shape[:-1], BLOCK * BLOCK)
    return tail_cuda.normalize_blocks(blocks, x, k, h, w,
                                      normalize=normalize,
                                      to_frames=to_frames)


#: Frames in one product of the extract tail's k-term reconstruction: at
#: 32 the batched product runs as fast as one einsum over a batch of 32
#: (on an H100, 0.44 ms for 1080p color, k = 4); at 8 four products take
#: 1.33 ms, and a call of fewer frames costs one product of 32 either way.
RECON_FRAMES = 32


def _recon(sw_nat: torch.Tensor, eb64: torch.Tensor) -> torch.Tensor:
    """The k-term reconstruction Σ_j sw_nat[..., n, j] · eb64[..., n, j, :]
    ([..., N, 64]) as batched products of RECON_FRAMES frames each, the
    frames (the lead dims that ``eb64`` lacks) zero-padded to a multiple.
    A batched product's algorithm on the card depends on its shape, and a
    frame must extract to the same bytes alone, in a shard or in the
    whole batch: every product here has the same shape, whatever the
    batch. The result is a strided view, as torch.einsum's is."""
    lead = sw_nat.shape[:sw_nat.ndim - (eb64.ndim - 1)]
    frame = sw_nat.shape[len(lead):]                 # (..., N, k)
    k, p = frame[-1], eb64.shape[-1]
    m = eb64[..., 0, 0].numel()                      # planes x blocks
    f = int(torch.Size(lead).numel())                # frames
    x = sw_nat.reshape(f, m, k)
    pad = (-f) % RECON_FRAMES
    if pad:
        x = torch.cat([x, x.new_zeros(pad, m, k)])
    xt = x.permute(1, 0, 2)                          # [m, frames, k]
    e = eb64.reshape(m, k, p)
    out = torch.empty(m, f + pad, p, dtype=torch.float32,
                      device=sw_nat.device)
    for i in range(0, f + pad, RECON_FRAMES):
        torch.bmm(xt[:, i:i + RECON_FRAMES], e,
                  out=out[:, i:i + RECON_FRAMES])
    return out.permute(1, 0, 2)[:f].reshape(*lead, *frame[:-1], p)


def _tail_front(s_cw: torch.Tensor, sc: torch.Tensor, inv_blk: torch.Tensor,
                alpha, k: int,
                sw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The extract tail's estimator and slot gather: the natural-order
    estimates [..., N, k], or [..., N, k + 1] with the erasure flag (1.0)
    as column k when ``sw`` is given (one gather for both). The presence
    decision is K18 (ops/tail_cuda.py::presence, which forms column 0 of
    the raw estimate in its load), the rest K5f (ops/tail_cuda.py::
    tail_front), on the card; their twins on the CPU."""
    alpha = _alpha(alpha, s_cw.device)
    s_cw, sc = (t.contiguous() for t in torch.broadcast_tensors(s_cw, sc))
    if sw is None:
        return tail_cuda.tail_front(s_cw, sc, inv_blk, alpha, k)
    engage, _ = tail_cuda.presence(s_cw, sw, sc, alpha)
    return tail_cuda.tail_front(s_cw, sc, inv_blk, alpha, k, sw,
                                _sw_scale(sw), engage)


def _extract_tail_prepared(s_cw: torch.Tensor, sc: torch.Tensor,
                           ebasis: torch.Tensor, inv_blk: torch.Tensor,
                           alpha, kfrac: float, normalize: bool, h: int,
                           w: int, sw: Optional[torch.Tensor] = None,
                           to_frames: bool = False, out_u8: bool = False,
                           recompute: bool = False) -> torch.Tensor:
    """Extract tail against the prepared pixel basis: estimate -> slot
    gather -> k-term reconstruction -> normalize. ``to_frames`` returns
    channels-last [..., H, W, C] from [..., C, N, 8] input; ``out_u8``
    clips and casts.

    ``recompute`` picks the formulation for block-aligned sizes, as the
    JAX package's does. False (default) materializes the [..., N, 64]
    reconstruction once (_recon) and normalizes it in K8's two passes
    (ops/tail_cuda.py: normalize_blocks); True rebuilds it in each of K5's
    two passes (ops/tail_cuda.py: recon_normalize), which sums the k terms
    in one fixed order where the batched product need not. The two agree
    within a couple of u8 quanta. An unaligned size takes the
    materializing form either way, normalized by K8u (K8 with the crop)."""
    k = k_of_block(kfrac)
    hp, wp = h + (-h) % BLOCK, w + (-w) % BLOCK
    x = _tail_front(s_cw, sc, inv_blk, alpha, k, sw)
    eb = ebasis[..., :k, :, :]
    eb64 = eb.reshape(*eb.shape[:-2], BLOCK * BLOCK)
    if recompute and (hp, wp) == (h, w):
        return tail_cuda.recon_normalize(x, eb64, h, w, normalize=normalize,
                                         out_u8=out_u8, to_frames=to_frames)
    # normalize on the [..., N, 64] block tensor, cast and unblockify (K8
    # on the card, the eager form on the CPU); an unaligned size crops to
    # h x w in the same call (K8u)
    return tail_cuda.normalize_blocks(_recon(x[..., :k], eb64), x, k, h, w,
                                      normalize=normalize, out_u8=out_u8,
                                      to_frames=to_frames)


def _extract_planes_prepared(planes: torch.Tensor, sc: torch.Tensor,
                             ebasis: torch.Tensor, inv_blk: torch.Tensor,
                             alpha, kfrac: float, normalize: bool, h: int,
                             w: int, sw: Optional[torch.Tensor] = None,
                             sweeps=None,
                             recompute: bool = False) -> torch.Tensor:
    """Serving-path extract of f32 planes [..., H, W]: K1's spectrum, then
    the tail against the pixel basis (u8 planes)."""
    s_cw = _plane_spectrum(planes, sweeps)
    return _extract_tail_prepared(s_cw, sc, ebasis, inv_blk, alpha, kfrac,
                                  normalize, h, w, sw=sw, out_u8=True,
                                  recompute=recompute)


def extract_gray_prepared(stego_bgr_u8: torch.Tensor, sc: torch.Tensor,
                          ebasis: torch.Tensor, inv_blk: torch.Tensor,
                          alpha, kfrac: float = K_FRAC_DEFAULT,
                          normalize: bool = True,
                          sw: Optional[torch.Tensor] = None,
                          sweeps=None,
                          recompute: bool = False) -> torch.Tensor:
    """Gray extract against a PreparedWatermark's pixel basis.
    ``recompute`` selects the tail's form (_extract_tail_prepared)."""
    h, w = stego_bgr_u8.shape[-3], stego_bgr_u8.shape[-2]
    return _extract_planes_prepared(color.luma_f32(stego_bgr_u8), sc, ebasis,
                                    inv_blk, alpha, kfrac, normalize, h, w,
                                    sw=sw, sweeps=sweeps,
                                    recompute=recompute)


def extract_color_prepared(stego_bgr_u8: torch.Tensor, sc: torch.Tensor,
                           ebasis: torch.Tensor, inv_blk: torch.Tensor,
                           alpha, kfrac: float = K_FRAC_DEFAULT,
                           normalize: bool = True,
                           sw: Optional[torch.Tensor] = None,
                           sweeps=None,
                           recompute: bool = False) -> torch.Tensor:
    """Color extract against a PreparedWatermark's pixel basis; K1 reads
    the channels-last stego directly. ``recompute`` selects the tail's
    form (_extract_tail_prepared)."""
    h, w = stego_bgr_u8.shape[-3], stego_bgr_u8.shape[-2]
    s_cw = _frames_spectrum(stego_bgr_u8, sweeps)
    return _extract_tail_prepared(s_cw, sc, ebasis, inv_blk, alpha, kfrac,
                                  normalize, h, w, sw=sw, to_frames=True,
                                  out_u8=True, recompute=recompute)


def extract_gray(stego_bgr_u8: torch.Tensor, sc: torch.Tensor,
                 uw: torch.Tensor, vwt: torch.Tensor, inv_blk: torch.Tensor,
                 inv_intra: torch.Tensor, alpha,
                 kfrac: float = K_FRAC_DEFAULT, normalize: bool = True,
                 sw: Optional[torch.Tensor] = None,
                 sweeps=None) -> torch.Tensor:
    """Gray extract of the request path (extract_array): K1 (K6's luma),
    K18, K5f, the product and the IDCT, K8 or K8u: u8 planes [..., H, W]."""
    h, w = stego_bgr_u8.shape[-3], stego_bgr_u8.shape[-2]
    s_cw = _plane_spectrum(color.luma_f32(stego_bgr_u8), sweeps)
    return _extract_planes(s_cw, sc, uw, vwt, inv_blk, inv_intra, alpha,
                           kfrac, normalize, h, w, sw=sw)


def extract_color(stego_bgr_u8: torch.Tensor, sc: torch.Tensor,
                  uw: torch.Tensor, vwt: torch.Tensor, inv_blk: torch.Tensor,
                  inv_intra: torch.Tensor, alpha,
                  kfrac: float = K_FRAC_DEFAULT, normalize: bool = True,
                  sw: Optional[torch.Tensor] = None,
                  sweeps=None) -> torch.Tensor:
    """Color extract of the request path: K1 on the channels-last frames,
    then :func:`extract_gray`'s tail, K8 or K8u writing u8 frames
    [..., H, W, 3]."""
    h, w = stego_bgr_u8.shape[-3], stego_bgr_u8.shape[-2]
    s_cw = _frames_spectrum(stego_bgr_u8, sweeps)
    return _extract_planes(s_cw, sc, uw, vwt, inv_blk, inv_intra, alpha,
                           kfrac, normalize, h, w, sw=sw, to_frames=True)


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------

def band_scale_damp(sw_bands: torch.Tensor,
                    hat_bands: torch.Tensor) -> torch.Tensor:
    """Per-band scale-consistency weight in [0, 1]: 1/(1 + log2(r)^4) for
    over-scaled bands (r = ‖ŝw‖/‖Sw‖ > 1), 1 otherwise."""
    r = (torch.linalg.vector_norm(hat_bands, dim=-1)
         / (torch.linalg.vector_norm(sw_bands, dim=-1) + 1e-8))
    over = torch.clamp(torch.log2(torch.clamp(r, min=1e-9)), min=0.0)
    return 1.0 / (1.0 + over ** 4)


def band_presence_damp(sw_bands: torch.Tensor,
                       hat_bands: torch.Tensor) -> torch.Tensor:
    """Per-band keyed-presence weight in [0, 1]: the Pearson ρ0 over the
    band's blocks between ŝw[:, 0] and Sw[:, 0], ramped in over 0.30 above
    the size-aware knee 0.05 + 1.3/√m."""
    m = sw_bands.shape[-2]
    knee = 0.05 + 1.3 / torch.sqrt(
        _scalar(m, sw_bands.device))
    rho0 = metrics.nc(sw_bands[..., 0], hat_bands[..., 0])
    return torch.clamp((rho0 - knee) / 0.30, 0.0, 1.0)


#: jnp.median over the last axis (parallel/plane.py's median of the
#: gathered bands)
_median_last = detect_cuda.median_last


def _band_scores(s_cw: torch.Tensor, sc: torch.Tensor, sw: torch.Tensor,
                 alpha, k: int, hb: int, wb: int, grid: int = 4, *,
                 reduce: bool) -> torch.Tensor:
    """NC · scale damp · presence damp of each of the grid×grid spatial
    bands of an hb×wb block grid, between the stored ``sw`` [(C,) N, 8] and
    the rectified estimate max(s_cw − sc, 0)/max(α, 1e-8) over the first k
    columns (the JAX package's detect takes it before its _band_nc; K9
    takes it in its load): with ``reduce`` the frame scores of
    :func:`_band_nc`, without it the band scores [..., (C,) g*g]. K9
    (ops/detect_cuda.py) on the card, its twin on the CPU."""
    return detect_cuda.band_scores(s_cw, sc, sw, _alpha(alpha, s_cw.device),
                                   k, hb, wb, grid, reduce=reduce)


def _band_nc(s_cw: torch.Tensor, sc: torch.Tensor, sw: torch.Tensor, alpha,
             k: int, hb: int, wb: int, grid: int = 4) -> torch.Tensor:
    """Median over grid×grid spatial bands of :func:`_band_scores` (robust
    to a minority of destroyed bands), averaged over the channels when
    ``sw`` has them: the frame scores [...], in the same K9 launch."""
    return _band_scores(s_cw, sc, sw, alpha, k, hb, wb, grid, reduce=True)


def _detect_scores(s_cw, sc, sw, alpha, kfrac: float, h: int, w: int):
    """detect_gray's and detect_color's statistic on a measured stego
    spectrum [..., (C,) N, 8] of h×w frames."""
    return _band_nc(s_cw, sc, sw, alpha, k_of_block(kfrac), -(-h // BLOCK),
                    -(-w // BLOCK))


def detect_gray(stego_bgr_u8: torch.Tensor, sc: torch.Tensor,
                sw: torch.Tensor, alpha, kfrac: float = K_FRAC_DEFAULT,
                sweeps=None) -> torch.Tensor:
    """Median-of-band NC between stored and recovered per-block singular
    values, restricted to the k embedded components."""
    h, w = stego_bgr_u8.shape[-3], stego_bgr_u8.shape[-2]
    return _detect_scores(_plane_spectrum(color.luma_f32(stego_bgr_u8),
                                          sweeps), sc, sw, alpha, kfrac, h, w)


def detect_color(stego_bgr_u8: torch.Tensor, sc: torch.Tensor,
                 sw: torch.Tensor, alpha, kfrac: float = K_FRAC_DEFAULT,
                 sweeps=None) -> torch.Tensor:
    """Per-channel band-median NC, averaged over the channels."""
    h, w = stego_bgr_u8.shape[-3], stego_bgr_u8.shape[-2]
    return _detect_scores(_frames_spectrum(stego_bgr_u8, sweeps), sc, sw,
                          alpha, kfrac, h, w)


# ---------------------------------------------------------------------------
# Resync: geometry-searching detect
# ---------------------------------------------------------------------------
# The 8×8 grid makes an unaided blocked detect collapse under a shift of a
# few pixels. Rolling the stego by candidate offsets and scoring each roll
# recovers the aligned score; whole-block offsets scramble the keyed block
# permutation, so they must be part of the search radius. Rotation has a
# resampling realignment: counter-rotating the stego about its center with
# the bilinear warp an attacker used restores the grid everywhere at once,
# so rotation is one more search axis (candidate angle × candidate shift).
# The angle grid must be fine (a residual dθ misaligns a block at radius r
# by ~r·dθ px), and the 0.0 candidate is always in it (derotation by 0 is
# exact). On the card a scan's nonzero angles are one K13 launch
# (ops/resync_cuda.derotate_angles; more only where the stack of
# counter-rotated frames would pass DEROTATE_BUDGET bytes), each chunk of
# rolls one K12 launch (resync_cuda.roll_stack), one K1 and one K9, and a
# scan's scores reach the host in one read.

#: Bytes of counter-rotated frames one K13 launch makes for a scan: 172
#: color or 129 gray 1080p angles, 32 gray 2160x3840 ones.
DEROTATE_BUDGET = 1 << 30

def _resync_angles(rot_range: float, rot_step: float):
    """Candidate attacker angles: 0 first (lossless identity), then the
    ± grid out to rot_range, nearest first so equal scores keep the
    smallest-magnitude estimate."""
    if rot_range <= 0.0:
        return [0.0]
    n = int(round(rot_range / rot_step))
    out = [0.0]
    for k in range(1, n + 1):
        out += [k * rot_step, -k * rot_step]
    return out


def _resync_shifts(window: int, block_radius: int):
    """Candidate roll offsets covering every attacker translation with
    |t| <= 8*block_radius + window - 1 per axis (window=8 spans all
    sub-block offsets; block_radius adds whole-block rings)."""
    r = BLOCK * block_radius + (window - 1)
    return [(dy, dx) for dy in range(-r, r + 1)
            for dx in range(-r, r + 1)]


def _detect_shift_chunk(img: torch.Tensor, sc: torch.Tensor,
                        sw: torch.Tensor, alpha, shifts: torch.Tensor,
                        kfrac: float = K_FRAC_DEFAULT, sweeps=None,
                        color_frames: bool = False) -> torch.Tensor:
    """Detect scores [S] for an [S, 2] tensor of roll offsets of ONE image
    ([H, W] luma plane, or [H, W, 3] u8 BGR with ``color_frames``): the
    rolls stack on a leading batch axis, whose spectrum is one launch."""
    h, w = img.shape[0], img.shape[1]
    stack = resync_cuda.roll_stack(img, shifts)
    s_cw = (_frames_spectrum(stack, sweeps) if color_frames
            else _plane_spectrum(stack, sweeps))
    return _detect_scores(s_cw, sc, sw, alpha, kfrac, h, w)


def _read_scores(parts) -> np.ndarray:
    """A scan's chunk scores, left on the device in chunk order, read to
    the host at once: [chunks, chunk]. The search's only host read."""
    return torch.stack(parts).cpu().numpy()


def _scan_best(scores: np.ndarray, cands, best):
    """The search's choice over one scan, chunk by chunk in scan order:
    ``scores`` [chunks, chunk], ``cands`` the (shifts [chunk, 2], angle)
    of each chunk, ``best`` the (score, shift, angle) so far. The first
    best of a chunk wins it (``np.argmax``: the first maximum, or the
    first NaN); a chunk replaces ``best`` only with a strictly greater
    score."""
    best_score, best_shift, best_angle = best
    for part, (shifts, a) in zip(scores, cands):
        j = int(np.argmax(part))                # first best wins
        if float(part[j]) > best_score:
            best_score = float(part[j])
            best_shift, best_angle = tuple(shifts[j]), a
    return best_score, best_shift, best_angle


def _detect_resync(img, sc, sw, alpha, *, kfrac, sweeps, window,
                   block_radius, chunk, color_frames, rot_range=0.0,
                   rot_step=0.05):
    shifts = np.asarray(_resync_shifts(window, block_radius), np.int64)
    # pad to a chunk multiple with (0, 0): every chunk has one shape, and a
    # duplicate aligned candidate can only tie, never beat, the argmax
    pad = (-len(shifts)) % chunk
    if pad:
        shifts = np.concatenate([shifts, np.zeros((pad, 2), np.int64)])
    shifts_t = torch.as_tensor(shifts, device=img.device)
    best = (-np.inf, (0, 0), 0.0)

    def scan(angles, best):
        # every chunk's scores stay on the device until the scan ends: one
        # host read a scan, so the host never waits on the card between
        # chunks
        parts, cands = [], []
        nonzero = [a for a in angles if a != 0.0]
        per = max(1, DEROTATE_BUDGET
                  // max(1, img.numel() * img.element_size()))
        groups = iter([nonzero[i:i + per]
                       for i in range(0, len(nonzero), per)])
        stack, k = [], 0
        for a in angles:
            if a == 0.0:
                cand = img
            else:
                if k == len(stack):
                    # the next group of this scan's angles, in one launch
                    stack, k = resync_cuda.derotate_angles(
                        img, next(groups), color_frames=color_frames), 0
                cand, k = stack[k], k + 1
            for i in range(0, len(shifts), chunk):
                parts.append(_detect_shift_chunk(
                    cand, sc, sw, alpha, shifts_t[i:i + chunk], kfrac=kfrac,
                    sweeps=sweeps, color_frames=color_frames))
                cands.append((shifts[i:i + chunk], a))
        return _scan_best(_read_scores(parts), cands, best)

    best = scan(_resync_angles(rot_range, rot_step), best)
    if rot_range > 0.0 and best[2] != 0.0:
        # refine around the coarse argmax at step/5: an angle off the
        # coarse grid leaves a residual of up to step/2
        fine = rot_step / 5.0
        best = scan([best[2] + k * fine
                     for k in (-4, -3, -2, -1, 1, 2, 3, 4)], best)
    best_score, best_shift, best_angle = best
    # the roll that realigned is the INVERSE of the attacker translation;
    # the angle grid is already in attacker units
    return (best_score, (-int(best_shift[0]), -int(best_shift[1])),
            float(best_angle))


def detect_gray_resync(stego_bgr_u8: torch.Tensor, sc: torch.Tensor,
                       sw: torch.Tensor, alpha, kfrac: float = K_FRAC_DEFAULT,
                       sweeps=None, window: int = BLOCK,
                       block_radius: int = 0, chunk: int = 64,
                       rot_range: float = 0.0, rot_step: float = 0.05):
    """Geometry-searching detect on ONE [H, W, 3] frame: the best detect
    score over every candidate realignment. Returns (score, (ty, tx),
    angle): the estimated attacker translation in pixels and rotation in
    degrees ((0, 0), 0.0 for an aligned stego). The defaults scan the
    15×15 sub-block offsets; ``block_radius`` adds whole-block rings and
    ``rot_range`` > 0 the counter-rotation axis (each angle re-runs the
    shift scan)."""
    return _detect_resync(color.luma_f32(stego_bgr_u8), sc, sw, alpha,
                          kfrac=kfrac, sweeps=sweeps, window=window,
                          block_radius=block_radius, chunk=chunk,
                          color_frames=False, rot_range=rot_range,
                          rot_step=rot_step)


def detect_color_resync(stego_bgr_u8: torch.Tensor, sc: torch.Tensor,
                        sw: torch.Tensor, alpha,
                        kfrac: float = K_FRAC_DEFAULT, sweeps=None,
                        window: int = BLOCK, block_radius: int = 0,
                        chunk: int = 64, rot_range: float = 0.0,
                        rot_step: float = 0.05):
    """:func:`detect_gray_resync` on the per-channel statistic; rolls and
    derotations act on the u8 frames."""
    return _detect_resync(stego_bgr_u8, sc, sw, alpha, kfrac=kfrac,
                          sweeps=sweeps, window=window,
                          block_radius=block_radius, chunk=chunk,
                          color_frames=True, rot_range=rot_range,
                          rot_step=rot_step)


# ---------------------------------------------------------------------------
# Meta digest and path-level entry points
# ---------------------------------------------------------------------------

# Blocked-meta digest schema (identical to the JAX package's):
#   v1 (no digest_v key): HMAC over Sc, Uw, Vwt only — verified, never
#      written;
#   v2: + Sw and the scalars (mode, alpha, kfrac, full sweeps, shape);
#   v3: the schedule packed as its total PAIR count, so fractional tiers
#      (sweeps_xpairs) are authenticated too.
DIGEST_V = 3


def _digest_v1(key: bytes, sc: np.ndarray, uw: np.ndarray,
               vwt: np.ndarray) -> bytes:
    """Legacy blocked-meta HMAC (digest_v absent): Sc/Uw/Vwt only."""
    return crypto.meta_digest(
        key, [sc.tobytes(), uw.tobytes(), vwt.tobytes()])


def _digest_scalars(key: bytes, sc, uw, vwt, sw, *, mode: str,
                    alpha: float, kfrac: float, packed_sweeps: int,
                    shape) -> bytes:
    scalars = (mode.encode() + struct.pack(
        "<ddqqq", float(alpha), float(kfrac), int(packed_sweeps),
        int(shape[0]), int(shape[1])))
    return crypto.meta_digest(
        key, [sc.tobytes(), uw.tobytes(), vwt.tobytes(), sw.tobytes(),
              scalars])


def _digest(key: bytes, sc: np.ndarray, uw: np.ndarray,
            vwt: np.ndarray, sw: np.ndarray, *, mode: str, alpha: float,
            kfrac: float, sweeps: int, xpairs: int = 0,
            version: int = DIGEST_V, shape) -> bytes:
    """Blocked-meta HMAC over everything extraction consumes (v2/v3)."""
    if version >= 3:
        packed = int(sweeps) * len(wm_cuda.PAIRS) + int(xpairs)
    else:
        packed = int(sweeps)   # v2: integral tiers only
    return _digest_scalars(key, sc, uw, vwt, sw, mode=mode, alpha=alpha,
                           kfrac=kfrac, packed_sweeps=packed, shape=shape)


def _indices(key, h: int, w: int, device):
    """(blk_idx, intra_idx) as int64 tensors; key=None -> identity
    permutation (legacy open mode)."""
    if key is None:
        return (torch.arange(n_blocks_of(h, w), device=device),
                torch.arange(BLOCK * BLOCK, device=device))
    blk, intra = crypto.block_permutation_indices(
        key, n_blocks_of(h, w), BLOCK * BLOCK)
    return (torch.as_tensor(blk, device=device),
            torch.as_tensor(intra, device=device))


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def embed_paths(cover: np.ndarray, wm_resized: np.ndarray, out_path: str,
                meta_path: str, *, alpha: float, color: bool, key: bytes,
                nonce: bytes, kfrac: float, payload_type: str = "image",
                extra_meta: Optional[dict] = None,
                device=DEFAULT_DEVICE):
    """Embed, write the stego PNG and the (HMAC-signed) meta. ``wm_resized``:
    H×W×3 BGR, or an H×W gray plane which skips the gray conversion."""
    h, w = cover.shape[:2]
    blk_idx, intra_idx = _indices(key, h, w, device)
    cover_t = _to_device(cover, device)
    wm_t = _to_device(wm_resized, device)
    if color:
        res = embed_color(cover_t, wm_t, blk_idx, intra_idx, alpha,
                          kfrac=kfrac)
        mode = metaio.MODE_BLOCKED_COLOR
    else:
        from dctsvd_tpu_torch.ops import color as c_ops
        wm_gray = c_ops.bgr_to_gray(wm_t) if wm_t.ndim == 3 else wm_t
        res = embed_gray(cover_t, wm_gray, blk_idx, intra_idx, alpha,
                         kfrac=kfrac)
        mode = metaio.MODE_BLOCKED_GRAY
    sc = res.sc.cpu().numpy()
    uw = res.uw.cpu().numpy()
    vwt = res.vwt.cpu().numpy()
    sw = res.sw.cpu().numpy()
    out_path = metaio.default_stego_path(out_path)
    image_io.write_png(out_path, res.stego_bgr.cpu().numpy())
    sweeps, xpairs = embed_schedule_used()
    kw = dict(mode=mode, payload_type=payload_type,
              Sc=sc, Uw=uw, Vwt=vwt, Sw=sw,
              shape=np.asarray((h, w)), alpha=float(alpha),
              kfrac=float(kfrac), block=BLOCK,
              sweeps=sweeps, sweeps_xpairs=xpairs)
    if extra_meta:
        kw.update(extra_meta)
    if key is not None:
        kw["nonce"] = np.frombuffer(nonce, dtype=np.uint8)
        kw["digest_v"] = DIGEST_V
        kw["digest"] = np.frombuffer(
            _digest(key, sc, uw, vwt, sw, mode=mode, alpha=float(alpha),
                    kfrac=float(kfrac), sweeps=sweeps, xpairs=xpairs,
                    shape=(h, w)),
            dtype=np.uint8)
    meta_path = metaio._npz_path(meta_path)   # savez appends .npz itself
    np.savez_compressed(meta_path, **kw)
    return out_path, meta_path, float(res.psnr), float(res.ssim)


def extract_array(stego: np.ndarray, meta: metaio.Meta, key: bytes, *,
                  normalize: bool = True,
                  device=DEFAULT_DEVICE) -> np.ndarray:
    """HMAC-gated blocked extraction to a u8 array (gray plane or BGR).

    Unlike the JAX package, a v2-digest meta with a nonzero
    ``sweeps_xpairs`` is rejected: v2 does not authenticate xpairs, so
    such a meta could replay a schedule its signer never wrote."""
    h, w = meta.shape
    sc = meta.arrays["Sc"]
    uw = meta.arrays["Uw"]
    vwt = meta.arrays["Vwt"]
    if meta.digest is not None:
        if key is None:
            raise ValueError("This meta requires a password.")
        if meta.digest_v == 2 and int(meta.sweeps_xpairs) != 0:
            raise ValueError(
                "digest schema v2 does not authenticate sweeps_xpairs, but "
                f"this meta carries sweeps_xpairs={meta.sweeps_xpairs}; "
                "refusing an unauthenticated replay schedule")
        if meta.digest_v >= 2:
            expected = _digest(key, sc, uw, vwt, meta.arrays["Sw"],
                               mode=meta.mode, alpha=float(meta.alpha),
                               kfrac=float(meta.kfrac),
                               sweeps=int(meta.sweeps),
                               xpairs=int(meta.sweeps_xpairs),
                               version=meta.digest_v, shape=(h, w))
        else:
            # pre-digest_v meta: Sc/Uw/Vwt-only coverage, verified as
            # written; its other fields ride unauthenticated
            expected = _digest_v1(key, sc, uw, vwt)
        if not crypto.digests_equal(expected, meta.digest):
            raise ValueError(
                "Wrong password or corrupted meta (HMAC verification "
                f"failed; meta digest schema v{meta.digest_v}).")
    else:
        key = None                     # open-mode meta: identity indices
    blk_idx, intra_idx = _indices(key, h, w, device)
    inv_blk = torch.argsort(blk_idx)
    inv_intra = torch.argsort(intra_idx)
    fn = (extract_color if meta.mode == metaio.MODE_BLOCKED_COLOR
          else extract_gray)
    wm = fn(_to_device(stego, device), _to_device(sc, device),
            _to_device(uw, device), _to_device(vwt, device), inv_blk,
            inv_intra, float(meta.alpha), kfrac=meta.kfrac,
            normalize=normalize, sw=_to_device(meta.arrays["Sw"], device),
            sweeps=meta.sched())
    return wm.cpu().numpy()


def extract_paths(stego: np.ndarray, meta: metaio.Meta, out_path: str,
                  key: bytes, *, normalize: bool, enhance: bool,
                  device=DEFAULT_DEVICE) -> str:
    wm_np = extract_array(stego, meta, key, normalize=normalize,
                          device=device)
    if enhance:
        from dctsvd_tpu_torch.models import enhance as m_enhance
        fn = (m_enhance.enhance_color_np
              if meta.mode == metaio.MODE_BLOCKED_COLOR
              else m_enhance.enhance_gray_np)
        wm_np = fn(wm_np, device=device)
    out_path = metaio.default_wm_path(out_path)
    image_io.write_png(out_path, wm_np)
    return out_path


def detect_paths(stego: np.ndarray, meta: metaio.Meta, thresh: float,
                 resync: bool = False, block_radius: int = 0,
                 rot_range: float = 0.0, rot_step: float = 0.05, *,
                 device=DEFAULT_DEVICE):
    """No-password blocked detect: (score >= thresh, score).
    ``resync=True`` always runs the translation search (and, with
    ``rot_range`` > 0, the rotation search) and keeps the better of the
    aligned and the realigned score: the (0, 0) candidate is scored
    exactly, so an aligned stego keeps its score."""
    is_color = meta.mode == metaio.MODE_BLOCKED_COLOR
    fn = detect_color if is_color else detect_gray
    stego_t = _to_device(stego, device)
    sc = _to_device(meta.arrays["Sc"], device)
    sw = _to_device(meta.arrays["Sw"], device)
    score = float(fn(stego_t, sc, sw, float(meta.alpha), kfrac=meta.kfrac,
                     sweeps=meta.sched()))
    if resync:
        rfn = detect_color_resync if is_color else detect_gray_resync
        score2, _shift, _angle = rfn(stego_t, sc, sw, float(meta.alpha),
                                     kfrac=meta.kfrac, sweeps=meta.sched(),
                                     block_radius=block_radius,
                                     rot_range=rot_range, rot_step=rot_step)
        score = max(score, score2)
    return bool(score >= thresh), score
