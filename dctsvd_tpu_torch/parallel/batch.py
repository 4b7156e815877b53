"""Sharded batch pipelines: multi-card detect / embed / extract serving.

Counterpart of ``dctsvd_tpu/parallel/batch.py``, with its names,
arguments and return structures. Images (or a video chunk's frames)
split over the mesh's batch shards, the meta or prepared-watermark
arrays go to each distinct device once, each shard runs the port's
single-device function (models/blocked.py, models/image.py) on its
device, and the outputs come back concatenated along the batch on the
mesh's first device. Nothing waits on the host between two shards'
launches, so shards on separate cards overlap.

The JAX package caches one jitted executable per (body, mesh, statics);
the port runs eagerly and its kernel library loads once
(utils/kernels.py), so there is no cache here.
"""

from __future__ import annotations

from typing import Optional

import torch

from dctsvd_tpu_torch.models import blocked, image as m_image
from dctsvd_tpu_torch.parallel import mesh as mesh_lib
from dctsvd_tpu_torch.utils.config import K_FRAC_DEFAULT


def batch_detect_blocked(stegos: torch.Tensor, sc: torch.Tensor,
                         sw: torch.Tensor, alpha,
                         mesh: Optional[mesh_lib.Mesh] = None,
                         per_frame_sc: bool = False,
                         sweeps: Optional[int] = None) -> torch.Tensor:
    """Scores [B] for a [B, H, W, 3] stego batch. B must divide by the
    mesh's batch shards. Default: one replicated meta scored against many
    images. ``per_frame_sc=True``: ``sc`` is the [B, N, 8] per-frame
    cover spectra from a sharded embed and shards with its frames.
    ``sweeps``: the meta's embed-time Jacobi schedule (``meta.sweeps``),
    replayed by each shard's spectrum as single-device detect does."""
    def body(st, sc_, sw_, a):
        return blocked.detect_gray(st, sc_, sw_, a, sweeps=sweeps)
    if per_frame_sc:
        return mesh_lib.map_shards(mesh, body, (stegos, sc), (sw,), alpha)
    return mesh_lib.map_shards(mesh, body, (stegos,), (sc, sw), alpha)


def batch_detect_full(stegos: torch.Tensor, sc: torch.Tensor,
                      sw: torch.Tensor, alpha,
                      mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """Full-frame (parity-path) batch detect: the parity ``detect_gray``
    of each image against one shared (sc, sw), sharded over the cards.
    Each image goes through ``svd_full`` on its own, so its S is the one
    a single-image detect computes, bit for bit, and Sc cancels exactly
    on an unmarked image."""
    def body(st, sc_, sw_, a):
        return torch.stack([m_image.detect_gray(im, sc_, sw_, a)
                            for im in st])
    return mesh_lib.map_shards(mesh, body, (stegos,), (sc, sw), alpha)


def batch_embed_prepared(frames: torch.Tensor, sw: torch.Tensor, alpha,
                         kfrac: float = K_FRAC_DEFAULT,
                         mesh: Optional[mesh_lib.Mesh] = None):
    """Serving-shaped sharded embed: [B, H, W, 3] frames against a
    PreparedWatermark's slot-ordered ``sw`` (replicated). Returns
    (stego u8, sc), the multi-card analog of
    blocked.embed_gray_prepared."""
    def body(fr, sw_, a):
        stego, sc, _, _ = blocked.embed_gray_prepared(
            fr, sw_, a, kfrac=kfrac, with_metrics=False)
        return stego, sc
    return mesh_lib.map_shards(mesh, body, (frames,), (sw,), alpha)


def batch_extract_prepared(stegos: torch.Tensor, sc: torch.Tensor,
                           ebasis: torch.Tensor, inv_blk: torch.Tensor,
                           sw: torch.Tensor, alpha,
                           kfrac: float = K_FRAC_DEFAULT,
                           mesh: Optional[mesh_lib.Mesh] = None,
                           sweeps: Optional[int] = None) -> torch.Tensor:
    """Sharded serving extract against the prepared pixel basis
    (replicated); per-frame sc shards with its frames. ``sweeps`` replays
    the meta's embed-time schedule (see batch_detect_blocked)."""
    def body(st, sc_, eb, ib, sw_, a):
        return blocked.extract_gray_prepared(st, sc_, eb, ib, a,
                                             kfrac=kfrac, sw=sw_,
                                             sweeps=sweeps)
    return mesh_lib.map_shards(mesh, body, (stegos, sc),
                               (ebasis, inv_blk, sw), alpha)


def batch_serve_verify_detect(frames: torch.Tensor, sw: torch.Tensor, alpha,
                              ebasis: torch.Tensor, inv_blk: torch.Tensor,
                              kfrac: float = K_FRAC_DEFAULT,
                              mesh: Optional[mesh_lib.Mesh] = None):
    """Sharded serve step: embed + extract-verify + detect-score each
    card's frame shard (blocked.serve_verify_detect_color_prepared).
    Returns (stego, sc, recovered, scores); each frame's whole pipeline
    is local to its card."""
    def body(fr, sw_, eb, ib, a):
        return blocked.serve_verify_detect_color_prepared(fr, sw_, a, eb, ib,
                                                          kfrac=kfrac)
    return mesh_lib.map_shards(mesh, body, (frames,), (sw, ebasis, inv_blk),
                               alpha)


def batch_embed_blocked(frames: torch.Tensor, wm_gray: torch.Tensor,
                        blk_idx: torch.Tensor, intra_idx: torch.Tensor, alpha,
                        kfrac: float = K_FRAC_DEFAULT,
                        mesh: Optional[mesh_lib.Mesh] = None) -> dict:
    """Sharded blocked gray embed over a frame batch [B, H, W, 3]; the
    watermark plane and permutation indices replicate, and the watermark
    is prepared (K4) once per distinct device. Returns a dict: ``stego``,
    ``sc``, ``psnr``, ``ssim`` per frame, and the shared ``uw``, ``vwt``,
    ``sw`` once."""
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    prepared = {}

    def body(fr, wm, blk, intra, a):
        if fr.device not in prepared:
            prepared[fr.device] = blocked.prepare_wm_gray(
                wm, blk, intra, extract_basis=False)
        stego, sc, ps, ss = blocked.embed_gray_prepared(
            fr, prepared[fr.device].sw, a, kfrac=kfrac)
        return stego, sc, ps, ss

    stego, sc, ps, ss = mesh_lib.map_shards(
        mesh, body, (frames,), (wm_gray, blk_idx, intra_idx), alpha)
    pw = prepared[mesh_lib.batch_devices(mesh)[0]]
    return {"stego": stego, "sc": sc, "uw": pw.uw, "vwt": pw.vwt,
            "sw": pw.sw, "psnr": ps, "ssim": ss}
