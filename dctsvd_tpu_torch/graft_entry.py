"""Graft entry points: a single-device step and a sharded dry run.

Counterpart of the repository's ``__graft_entry__.py``. :func:`entry`
returns the flagship forward step — the blocked-path gray embed (frame
batch -> stego batch + per-block meta arrays) — and example arguments.
:func:`dryrun_multichip` builds an n-shard 'batch' mesh on one device
and runs one sharded embed -> extract -> detect step on tiny shapes, then
the serving-shaped chunk through ``parallel/batch``. It runs on the card
by default; ``device='cpu'`` runs the kernels' plain twins.
"""

from __future__ import annotations

import numpy as np
import torch


def _example_inputs(batch: int, h: int, w: int, seed: int = 0,
                    device="cuda"):
    """(frames, wm, blk, intra, inv_blk, inv_intra) on ``device``, from a
    seeded generator and the key derive_key("graft", bytes(range(8)))."""
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.utils import crypto

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (batch, h, w, 3), np.uint8)
    wm = rng.integers(0, 256, (h, w), np.uint8)
    key = crypto.derive_key("graft", bytes(range(8)))
    blk, intra = crypto.block_permutation_indices(
        key, blocked.n_blocks_of(h, w))
    iblk = crypto.inverse_permutation(blk)
    iintra = crypto.inverse_permutation(intra)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (frames, wm, blk, intra, iblk, iintra))


def entry(device="cuda"):
    """(fn, example_args): the blocked gray embed step on a frame batch,
    returning (stego, sc, sw)."""
    from dctsvd_tpu_torch.models import blocked

    frames, wm, blk, intra, _, _ = _example_inputs(2, 128, 128,
                                                   device=device)

    def fn(frames, wm_gray, blk_idx, intra_idx, alpha):
        res = blocked.embed_gray(frames, wm_gray, blk_idx, intra_idx, alpha)
        return res.stego_bgr, res.sc, res.sw

    return fn, (frames, wm, blk, intra,
                torch.tensor(0.12, dtype=torch.float32, device=device))


def _require(cond, what) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One sharded embed -> extract -> detect step over an
    ``n_devices``-shard mesh on ``device`` (the shards run one after
    another there), then the serving chunk through
    ``batch_embed_prepared`` (twice), ``batch_extract_prepared`` and
    ``batch_detect_blocked(per_frame_sc=True)``, then
    ``batch_serve_verify_detect``. Raises if a shape or score is off."""
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.parallel import batch as par_batch
    from dctsvd_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(n_devices,
                              devices=[torch.device(device)] * n_devices)
    batch, h, w = n_devices, 64, 64
    frames, wm, blk, intra, iblk, iintra = _example_inputs(batch, h, w,
                                                           device=device)
    alpha = 0.12

    def step(fr, wm_gray, blk_idx, intra_idx, iblk_, iintra_, a):
        emb = blocked.embed_gray(fr, wm_gray, blk_idx, intra_idx, a)
        wm_rec = blocked.extract_gray(emb.stego_bgr, emb.sc, emb.uw,
                                      emb.vwt, iblk_, iintra_, a)
        scores = blocked.detect_gray(emb.stego_bgr, emb.sc, emb.sw, a)
        return emb.stego_bgr, wm_rec, scores

    stego, wm_rec, scores = mesh_lib.map_shards(
        mesh, step, (frames,), (wm, blk, intra, iblk, iintra), alpha)
    mean_score = float(scores.mean())
    _require(stego.shape == (batch, h, w, 3), f"stego {tuple(stego.shape)}")
    _require(wm_rec.shape == (batch, h, w), f"wm_rec {tuple(wm_rec.shape)}")
    _require(scores.shape == (batch,), f"scores {tuple(scores.shape)}")
    _require(mean_score > 0.5, f"mean score {mean_score}")

    # the serving-shaped chunk: the watermark prepared once, then sharded
    # frame batches through the library's embed -> extract -> detect
    pw = blocked.prepare_wm_gray(wm, blk, intra)
    for _ in range(2):
        stego2, sc2 = par_batch.batch_embed_prepared(frames, pw.sw, alpha,
                                                     mesh=mesh)
    rec2 = par_batch.batch_extract_prepared(stego2, sc2, pw.ebasis,
                                            pw.inv_blk, pw.sw, alpha,
                                            mesh=mesh)
    scores2 = par_batch.batch_detect_blocked(stego2, sc2, pw.sw, alpha,
                                             mesh=mesh, per_frame_sc=True)
    _require(stego2.shape == (batch, h, w, 3),
             f"stego2 {tuple(stego2.shape)}")
    _require(rec2.shape == (batch, h, w), f"rec2 {tuple(rec2.shape)}")
    _require(float(scores2.min()) > 0.5, f"scores2 {scores2.tolist()}")

    # the single-dispatch serve + verify + score step
    rng = np.random.default_rng(1)
    wm_c = torch.as_tensor(rng.integers(0, 256, (h, w, 3), np.uint8),
                           device=device)
    pwc = blocked.prepare_wm_color(wm_c, blk, intra)
    stego3, _, rec3, scores3 = par_batch.batch_serve_verify_detect(
        frames, pwc.sw, alpha, pwc.ebasis, pwc.inv_blk, mesh=mesh)
    _require(stego3.shape == (batch, h, w, 3),
             f"stego3 {tuple(stego3.shape)}")
    _require(rec3.shape == (batch, h, w, 3), f"rec3 {tuple(rec3.shape)}")
    # __graft_entry__.py's bound here is 0.3, met by the JAX package's CPU
    # fallback (a converged SVD: min 0.337 on these inputs). At the fused
    # s1.25 schedule, which the port always runs and the JAX package runs
    # on the TPU, its own fused branch (run on the CPU in interpret mode)
    # scores frame 4 of the 8-frame run 0.2806 (the port 0.2805); 64×64
    # frames have 16 bands of 4 blocks.
    _require(float(scores3.min()) > 0.25, f"scores3 {scores3.tolist()}")
