"""Plane-sharded watermarking for very large frames (8K+).

Counterpart of ``dctsvd_tpu/parallel/plane.py``. Every 8×8 block is
independent, so one frame splits into horizontal bands, one per batch
shard of the mesh: each band runs the same embed (K2) with the matching
rows of the prepared watermark's slot-ordered singular values, and the
bands' outputs are disjoint. Detection scores a grid × grid sub-grid of
each band (K1 for the band's spectrum, K9's band scores without its
median), gathers the n·grid² band scores on the mesh's first device and
takes their median.
"""

from __future__ import annotations

from typing import Optional

import torch

from dctsvd_tpu_torch.models import blocked
from dctsvd_tpu_torch.ops import color
from dctsvd_tpu_torch.parallel import mesh as mesh_lib
from dctsvd_tpu_torch.utils.config import BLOCK, K_FRAC_DEFAULT


def _batch_size(mesh: mesh_lib.Mesh) -> int:
    """Shards along the 'batch' axis — not the device count, which also
    counts a 'plane' axis on the 2-D mesh."""
    return mesh.shape[mesh_lib.BATCH_AXIS]


def _check_divisible(h: int, n: int):
    if h % (BLOCK * n) != 0:
        raise ValueError(
            f"plane-sharded path needs H divisible by 8*n_shards "
            f"({BLOCK * n}); pad the frame first (got H={h}).")


def plane_embed_gray(cover_bgr_u8: torch.Tensor, sw: torch.Tensor, alpha,
                     kfrac: float = K_FRAC_DEFAULT,
                     mesh: Optional[mesh_lib.Mesh] = None):
    """One [H, W, 3] frame sharded into horizontal bands across the mesh.

    ``sw`` is the prepared watermark's slot-ordered [N, 8] singular values
    (block row-major, so contiguous slices line up with horizontal bands).
    Returns (stego [H, W, 3] u8, sc [N, 8]) on the mesh's first device.
    """
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    _check_divisible(cover_bgr_u8.shape[0], _batch_size(mesh))

    def body(band, sw_band, a):
        stego, sc, _, _ = blocked.embed_gray_prepared(
            band, sw_band, a, kfrac=kfrac, with_metrics=False)
        return stego, sc
    return mesh_lib.map_shards(mesh, body, (cover_bgr_u8, sw), (), alpha)


def plane_detect_gray(stego_bgr_u8: torch.Tensor, sc: torch.Tensor,
                      sw: torch.Tensor, alpha, grid: int = 2,
                      mesh: Optional[mesh_lib.Mesh] = None,
                      sweeps: Optional[int] = None,
                      kfrac: float = K_FRAC_DEFAULT) -> torch.Tensor:
    """Band-NC detection over a plane-sharded frame: each shard scores a
    ``grid × grid`` sub-grid of its band, the n·grid² band scores are
    gathered, and their median (jnp.median's: the mean of the two middle
    values) is the 0-d score. ``sweeps`` replays the embed-time Jacobi
    schedule (``meta.sweeps``)."""
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    _check_divisible(stego_bgr_u8.shape[0], _batch_size(mesh))
    k = blocked.k_of_block(kfrac)

    def body(band, sc_band, sw_band, a):
        s_cw = blocked._plane_spectrum(color.luma_f32(band), sweeps)
        # restricted to the k embedded components and rectified at 0,
        # exactly like detect_gray (the statistic the threshold was
        # calibrated on): K9's band scores, without its median
        hb_local = band.shape[0] // BLOCK          # band dims, not global
        wb = -(-band.shape[1] // BLOCK)
        return blocked._band_scores(s_cw, sc_band, sw_band, a, k, hb_local,
                                    wb, grid, reduce=False)

    bands = mesh_lib.map_shards(mesh, body, (stego_bgr_u8, sc, sw), (),
                                alpha)
    return blocked._median_last(bands)
