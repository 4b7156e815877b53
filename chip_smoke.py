#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --paint-k-times   # only K2's and K3's time per k
    python3 chip_smoke.py --copy-times      # only copy_f32's and the four
                                            # cols_view instances' times
    python3 chip_smoke.py --probe-times [OLDER_TREE]
                                            # only the spectrum probe's and
                                            # fma_chain's instances' times,
                                            # SASS and ptxas, beside an
                                            # older checkout's, if given
    python3 chip_smoke.py --jacobi-times    # only K1's, K4's, K2r's and
                                            # K1g's times, with their
                                            # ptxas and SASS mix
    python3 chip_smoke.py --svd-drivers     # only the three cuSOLVER
                                            # drivers of the parity SVD
    python3 chip_smoke.py --tail-times      # only the extract steps' times
                                            # at 1080p, batch 32 (and 1, 4,
                                            # 128), in both tail forms, and
                                            # K5f, K5 and K8 alone; K18 and
                                            # the front at 32 and 128
                                            # frames, and the request
                                            # extract, each beside its
                                            # eager form; K8u alone in
                                            # each instance at 1079x1917
                                            # and 480x854
    python3 chip_smoke.py --recon-forms     # only the extract tail's
                                            # k-term product, in each form
    python3 chip_smoke.py --color-bounds    # only K6's and K7's times
                                            # beside their issue bound,
                                            # from the library's SASS
    python3 chip_smoke.py --enhance-times   # only the enhancement
                                            # stages' and chains' times at
                                            # 1080p (the chains' digests),
                                            # and K10, K11, K14 and K9
                                            # alone (copied into an older
                                            # tree that has K14-K17, that
                                            # tree's)
    python3 chip_smoke.py --metrics-times   # only SSIM's, PSNR's and the
                                            # embed's times with and
                                            # without its metrics at 1080p,
                                            # batch 32, eager against
                                            # kernel in turns
    python3 chip_smoke.py --resync-times    # only detect resync's chunk
                                            # split and search times at
                                            # 1080p, with K12 and K13 and
                                            # with their twins (copied into
                                            # an older tree, that tree's)

Run from the root of a checkout on a machine with one CUDA GPU (built for
an H100, ``sm_90a``). It builds the twenty-six hand-written kernels (K1,
K2, K3, K4, K2r, K1g, the extract tail's presence statistic K18, K5f,
K5, K8 and its crop K8u, the gray scheme's color conversions K6
and K7, the detect statistic K9, the enhancement chain's NLM K10, CLAHE
K11 and unsharp K14, detect resync's roll stack K12 and counter-rotation
K13, the embed metrics' SSIM K15 and PSNR sums K16, the color NLM's
YCrCb pair K17, and the probes' copy_f32, cols_view, fma_chain and
spectrum_probe; K2, K3, K5 and K9 in one instance per k) from
``dctsvd_tpu_torch/csrc/``, one nvcc per source, all started together, and
prints each instance's registers and spills; holds each of the seven
watermark kernels against its plain PyTorch twin at the shapes the 1080p
path gives it (all seven bit for bit), with the time of one PyTorch
library call that computes the same function where there is one (and K5,
in color frames and in gray planes, on the stego and on it with three
quadrants zeroed, whose flagged blocks it repaints, beside the eager tail it can
replace; K18, the presence statistic, on the stego and the zeroed
stego at 32 and 128 frames, beside the eager statistic whose decision it
must equal; and K8, the default tail's normaliser, in each of its two
instances (resident and two-pass, each forced by its plan) against its
twin, the eager form, in color frames and gray planes on the stego,
without sw, with three quadrants zeroed, with every block flagged,
without normalize, with f32 output, on 1, 4, 32, 33 and 128 frames, a
frame alone, in a shard and in the batch, and the two-pass instance on
the bench's 4k batch); holds K2
and K3 against their twins at every k = 1..8; drives the blocked color
path (prepare -> embed -> extract -> detect) and the three serve steps on
a batch of 32 1080p frames (with the set-up time of prepare and the
detect rate), the recompute extract tail (color and gray
``extract_*_prepared(recompute=True)``, K5) on the same batch, and the
default one's K8 launches with no eager normaliser call (color, gray,
serve+verify); the request extract (``request_extract``:
``extract_array``, what api.extract, the CLI, the GUI and the payloads
run) on a 1080p color and gray stego and its 1079x1917 and 480x854
crops, each read back from its PNG and meta, and on the zeroed stego and
the clean cover, each launching K1, K18, K5f and K8 (K8u on a crop, in
the instance the plan picks: the resident one at 1079x1917, the two-pass
one at 480x854) once, calling no eager normaliser or statistic,
byte-equal with every twin in its kernel's place and to the eager form
it replaced, K18's decision the eager statistic's; the prepared extract
of the batch of 32 cut to 1079x1917 likewise, and K8u's two instances,
each forced, against their twin there; K9, the detect
statistic, bit-equal to its twin on the
1080p spectra of the batch of 32 and of 128 frames, gray and color
(frame and band scores, grid 2, a shared sc, the clean covers, a clean
host scoring exactly 0, a frame alone and in a shard), within 1e-5 of the
eager form it replaced, timed beside its byte bound, that eager form and
the detect step with either, and detect_gray, detect_color, serve+score
and a resync chunk each launching K9 once and calling no eager band
function (``detect_1080p``); K6
(``luma_f32``, ``bgr_to_gray``) and K7 (``replace_luma``) bit-equal to
their twins on every BGR triple, seeded Y' with its edge values, the
batch of 32 and the scalar path's frames, timed beside their byte and
issue bounds, and the gray slice (prepare -> embed -> extract -> detect)
on the batch of 32 through them, byte-equal with their twins in their
places (``color_1080p``); the slice's gray and color embeds with their
metrics on the batch of 32, each launching K15 (SSIM) and K16 (PSNR's
exact sums) once and no eager blur, K15 on both pairs (u8 with the
marked f32 Y, u8 with u8) and K16 bit-equal to their twins at 1080p, on
a 4K frame, 3x5, 37x51 and a view off its 16-byte alignment, timed beside
their bounds, the eager forms and one F.conv2d of SSIM's five blurs
(``metrics_1080p``); and the recon-embed and Gram-spectrum entries
on 8 frames, each with its launch
counters set to 0 just before and read just after; checks the scores;
runs the CLI on PNG files; runs the T1-T6 probes (``dctsvd_tpu_torch.
tools``) at 1080p batch 32, with their launch counters, then holds each
probe kernel against its twin (``cols_view`` in all four instances, each
timed beside its ``copy_`` yardstick); prints the f32 operation rate of
K1, K2, K3, K4, K2r and K1g beside the issue rate T3 measured. Then the
rest of the image API at 1080p: the parity path gray and color (its
gates, ``svd_full``'s bit stability, the exact cancellation of Sc,
CUDA-event times) and, on a small frame, against the CPU; the
enhancement chains (any degradation fails the run) with each stage's
time, each chain launching K10 (NLM), both K11 kernels (CLAHE's LUTs
and interpolation) and K14 (unsharp) once, the color chain K17 once each
way, neither the eager blur nor the channels-last YCrCb pair, and each
chain's time with the eager NLM, CLAHE, unsharp and YCrCb pair in their
places; K10 bit-equal to its twin on the 1080p extracted
gray plane, the color frame's three YCrCb planes and planes smaller than
its window, K11 (each stage alone and both in one call) on the gray and
luma planes, a single-valued one, small ones, tiles past the plane's
rows, a tile width not a multiple of 16, off alignment and 4K, and K14
(gray plane, channels-last frame; also 1x1 and widths across its column
walks) and K17 (both ways) at 1080p, 4K, 3x5, 37x51 and off alignment,
each
timed beside its bound (K10 also beside its weight's issue bound, from
the library's SASS), its twin and the eager form it replaced; and
against the CPU on a small plane; text and
JSON payloads with both methods, with the blocked method's K1, K2 and K4
launches; detect resync (color and gray) of a rolled and of a rotated
stego: K12 (the roll stack) on one chunk of 64 rolled frames and one of
64 rolled luma planes, and K13 (the counter-rotation) on the rotated
frame, a luma plane and a 2160x3840 plane, at one angle and at a scan's
20 in one launch, each equal to its twin and timed beside its bound, its
twin and one PyTorch call; K1 held to its twin on both chunks; the
chunk's split and each search's time before (the eager forms, a host
read a chunk) and after, with the same result; K1's, K9's and K12's
launches once a chunk, K13's and its cos and sin's once a scan with a
nonzero angle, every candidate of the rotation search equal to its twin,
and one host read of scores a scan. Then
``parallel/``: the batch entry points on the 1080p batch of 32 through a
one-card mesh, four shards of the card (``[cuda:0] * 4``) and one frame
a shard, each held to the unsharded call (stego, sc and the recovered
watermark byte-equal, scores within 1e-5), with K1-K4's launches and
frames/s, batch_embed_blocked's metrics through K15 and K16, and no host
sync; the parity batch detect against the
per-image detect; an 8K frame (4320x7680) in one and in four bands,
equal to the whole-frame embed; the GUI's handlers on a 1080p PNG
(blocked and parity); and the graft entry points (``entry()``,
``dryrun_multichip(4)``), and ``dctsvd_tpu_torch/bench.py``'s thirteen
configs in this process at cut sizes (``BENCH_RUNS``), each giving
``bench.py``'s JSON line with its keys and finite values, with K1-K4's,
K5f's, K8's, K9's, K6's, K7's, K10's, K11's and cols_view's launches,
every call of those kernels
at each new signature made again through the kernel and its twin:
bit-equal. Then
video
(``models/video``) on a seeded 48-frame 1080p clip: the blocked and the
full scheme, gray and color, each embed and extract timed with K1's, K2's
and K4's launches in windows of their own, the decode / device / encode
split, a text video and detect; K1, K2 and K4 bit-equal to their twins on
a chunk of decoded 1080p frames; a resumed embed after an injected crash,
byte-identical to an uninterrupted one; the with-audio variant (a muxed
tone with ffmpeg, the silent fallback without); both schemes on a small
clip against the CPU. Last, the CLI with the parity defaults, the payload
subcommands and the video subcommands (with ``--profile``). It prints one
JSON line per phase.
Before the last line it prints the card's name and power limit and the
``kernels`` table (launches on the main path, kernel, twin and library
times, and each kernel's bound: the least time the card could take, from
the bytes it must move and the f32 operations it does). K1, K2, K3, K4,
K2r, K1g, K18, K5f, K5, K8, K8u, K6 and K7 are held to their twins run
on the card bit for bit; K18's launches are counted on the slice, the
serve steps, the tail phase, the request extracts, video, ``parallel/``
and the bench, K8u's on the request extracts, by instance; K8's launches
are counted
on the slice, the serve steps, the tail phase's default extracts, the
request extracts (the aligned ones), ``parallel/`` and the bench, by
instance (the resident one on every path, the two-pass one on the
bench's 4k and 512gray configs); K9's on
the slice, the serve steps, ``detect_1080p``, the resync searches,
``parallel/`` (``plane_8k``'s detect calls no eager band function) and
the bench;
K6's and K7's on the gray slice, the resync and parity phases,
``plane_8k`` and the bench; K10's and K11's on the enhance phase's
chains, the CLI's enhanced extract (counted in its process) and the
bench's robustness extracts; K12's and K13's on the resync searches and
the bench's geometric config; K14's on the chains, the CLI's enhanced
extract and the bench's robustness extracts; K15's and K16's on the
slice's embeds, batch_embed_blocked, the GUI's and the CLI's embeds (each
CLI call counts in its own process, ``CLI_CHILD``); K17's on the color
chain and the CLI's enhanced color extract.
The last line is ``{"ok": true, "device": {...}}``. Any failed phase
raises, so the exit code is non-zero and no result line is printed.
Without a GPU, or outside a checkout of the repository, it exits non-zero
at once.

TF32 stays off: every f32 product must run in full f32 for the port to
agree with the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
# The card line, CUDA-event timing and the H100 SXM's published peaks
# (NVIDIA's data sheet: f32 outside the tensor cores, HBM3), shared with
# the probes; bound_ms is the larger of ops/PEAK_F32 and bytes/PEAK_BYTES.
from dctsvd_tpu_torch.tools.common import (  # noqa: E402
    PEAK_BYTES, PEAK_F32, card_line as smi_line, cuda_ms as cuda_time)
H, W = 1080, 1920
BATCH = 32            # frames in the 1080p slice run
KERNEL_FRAMES = 8     # frames for the kernel-vs-twin comparisons
ALPHA = 0.12
SWEEPS = 1.25         # the serving default tier (DCTSVD_FUSED_SWEEPS)
K = 4                 # embedded components per block at kfrac 0.6
DETECT_THRESH = 0.30  # utils/config.DETECT_THRESH_BLOCKED
PASSWORD = "chip-smoke"
PAYLOAD_TEXT = "chip smoke: watermark payload, 1080p"
PAYLOAD_NONCES = 8    # seeded embed nonces for the parity payloads
NONCE_SEED = 20261018

# f32 operations per 8x8 block, counted from csrc/ (a rsqrt, sqrt or
# division counts as one operation; compares and selects count none).
DOT = 15                       # 8 products, 7 sums (sum_rows8)
ROT = 15                       # rotation(): d, e, h2 3, 2 rsqrt, c2 3, c, s 3, t
PAIR = DOT + ROT + 4 + 8 * 6   # one-sided pair: apq, angle, norms, columns
PAIR_V = PAIR + 8 * 6          # ... with V riding along
GRAM_PAIR = ROT + 6 * 2 * 3 + 4   # 6 other rows x 2 entries, diagonal


def jacobi_ops(pairs: int, with_v: bool = False) -> int:
    """jacobi8(): first norms, the rotations, fresh final norms."""
    return 8 * DOT + pairs * (PAIR_V if with_v else PAIR) + 8 * (DOT + 1)


def recon_ops(pairs: int) -> int:
    """K2r: jacobi8() with V, 64 divisions (u = g / s), S' = s + sws (8),
    S'_j V[k][j] (64), and 64 pixels of 8 products and 7 sums."""
    return jacobi_ops(pairs, with_v=True) + 64 + 8 + 64 + 64 * DOT


def gram_ops(pairs: int) -> int:
    """K1g: the Gram matrix's 36 dots, the rotations, 8 square roots."""
    return 36 * DOT + pairs * GRAM_PAIR + 8


def paint_ops(k: int) -> int:
    """The paint's work: k*8 dots, k coefficients, 64 pixels x k terms
    (paint_block() computes each dot twice and K3's two lanes repeat the
    angles; the bound counts the work once)."""
    return k * 8 * DOT + k * 25 + 1 + 64 * k * 3


def bound(blocks: int, ops_per_block: int, moved: int) -> dict:
    """The least time the card could take: the larger of the operations
    over the f32 peak and the bytes moved (each input read once, each
    output written once) over the memory rate."""
    t_ops = blocks * ops_per_block / PEAK_F32 * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=blocks * ops_per_block, bytes=moved)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


STARTED = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the
    script started (the run must end within its time limit)."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - STARTED)
    print(json.dumps(obj), flush=True)


def phase_kernels(dev, frames_u8, wm_u8, blk, intra):
    """The eight kernels against their plain twins at the 1080p shapes, each
    with its bound and, where one PyTorch call computes the same function,
    that call's time."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import dct, svd_cuda, wm_cuda

    results = {}
    full, extra = wm_cuda.sched_split(SWEEPS)
    pairs = full * len(wm_cuda.PAIRS) + extra

    # K4 on the DCT coefficients of the keyed 1080p color watermark
    coefs = wm_coefs(wm_u8, blk, intra)                      # [3, N, 8, 8]
    u, s, vt = svd_cuda.jacobi_svd8(coefs)
    u2, s2, vt2 = svd_cuda.jacobi_svd8(coefs)
    require(torch.equal(u, u2) and torch.equal(s, s2)
            and torch.equal(vt, vt2), "K4: two runs differ")
    pu, ps_, pvt = svd_cuda.jacobi_svd8_plain(coefs)
    require(torch.equal(u, pu) and torch.equal(s, ps_)
            and torch.equal(vt, pvt),
            f"K4 vs its twin on the card: U {float((u - pu).abs().max())}, "
            f"S {float((s - ps_).abs().max())}, Vt "
            f"{float((vt - pvt).abs().max())}")
    s_only = svd_cuda.jacobi_svd8(coefs, compute_uv=False)
    require(torch.equal(s_only, svd_cuda.jacobi_svd8_plain(
        coefs, compute_uv=False)), "K4 S only vs its twin on the card")
    smax = float(ps_.max())
    s_err = float((s - ps_).abs().max())
    recon = torch.einsum("...ij,...j,...jk->...ik", u, s, vt)
    rec_err = float((recon - coefs).abs().max())
    eye = torch.eye(8, device=dev)

    def orth(uu, ss):
        # |UᵀU − I| over the pairs of non-zero singular values. After 5
        # sweeps a pair of CLUSTERED values is not fully rotated apart, so
        # the twin (and the JAX kernel: same algorithm) sits near 1e-3
        # there; the kernel is held to the twin's level.
        nz = ss > 1e-6 * smax
        both = nz[..., :, None] & nz[..., None, :]
        return float(((uu.transpose(-1, -2) @ uu - eye).abs() * both).max())

    orth_err, orth_plain = orth(u, s), orth(pu, ps_)
    v_err = float((vt @ vt.transpose(-1, -2) - eye).abs().max())
    require(s_err <= 1e-4 * smax, f"K4 S vs twin: {s_err} > 1e-4*{smax}")
    require(rec_err <= 1e-4 * smax, f"K4 recon: {rec_err} > 1e-4*{smax}")
    require(orth_err <= orth_plain + 1e-4,
            f"K4 U^T U: {orth_err} > twin's {orth_plain} + 1e-4")
    require(v_err <= 1e-4, f"K4 V V^T: {v_err} > 1e-4")
    results["jacobi_svd8"] = dict(
        shape=list(coefs.shape), max_abs_err=s_err, s_max=smax,
        equals_twin=True, s_only_equals_twin=True, recon_err=rec_err,
        orth_err=orth_err, orth_err_plain=orth_plain, v_orth_err=v_err,
        ms=cuda_time(lambda: svd_cuda.jacobi_svd8(coefs), 20),
        plain_ms=cuda_time(lambda: svd_cuda.jacobi_svd8_plain(coefs), 5),
        library_ms=cuda_time(lambda: torch.linalg.svd(coefs), 5),
        **bound(coefs.numel() // 64,
                jacobi_ops(5 * len(wm_cuda.PAIRS), with_v=True) + 64,
                nbytes(coefs, u, s, vt)))
    emit({"phase": "kernel_vs_plain", "kernel": "K4 jacobi_svd8",
          **results["jacobi_svd8"]})

    # K2 on 8 1080p frames at s1.25, k = 4: equal to its twin bit for bit
    pw = blocked.prepare_wm_color(wm_u8, blk, intra, extract_basis=False)
    mask = (torch.arange(8, device=dev) < K).to(torch.float32)
    sws = blocked._scaled_sws(pw.sw, torch.tensor(ALPHA, device=dev), mask)
    x = frames_u8[:KERNEL_FRAMES].contiguous()
    n_blocks = x.numel() // 64

    def k2():
        return wm_cuda.embed_blocks(x, sws, sweeps=SWEEPS, k=K, out_u8=True,
                                    channels_last=True)

    def k2_plain():
        return wm_cuda.embed_blocks_plain(x, sws, sweeps=SWEEPS, k=K,
                                          out_u8=True, channels_last=True)

    y, sc = k2()
    y2, sc2 = k2()
    require(torch.equal(y, y2) and torch.equal(sc, sc2), "K2: two runs differ")
    py, psc = k2_plain()
    d = (y.to(torch.int16) - py.to(torch.int16)).abs()
    byte_err = int(d.max())
    smax = float(psc.max())
    sc_err = float((sc - psc).abs().max())
    require(torch.equal(y, py) and torch.equal(sc, psc),
            f"K2 vs twin: stego |d| max {byte_err} on "
            f"{float((d > 0).float().mean())} of bytes, sc err {sc_err}")
    results["embed_blocks"] = dict(
        shape=list(x.shape), max_abs_err=float(byte_err),
        equals_twin=True, sc_max_abs_err=sc_err, s_max=smax,
        ms=cuda_time(k2, 10), plain_ms=cuda_time(k2_plain, 3),
        library_ms=None,
        **bound(n_blocks, jacobi_ops(pairs) + paint_ops(K),
                nbytes(x, sws, y, sc)))
    emit({"phase": "kernel_vs_plain", "kernel": "K2 embed_blocks",
          **results["embed_blocks"]})

    # K1 on the same frames (channels-last) and on [24, H, W] u8 planes;
    # the library yardstick is svdvals on the same blocks as [P*N, 8, 8]
    def k1():
        return wm_cuda.spectrum_blocks(x, sweeps=SWEEPS, channels_last=True)

    def k1_plain():
        return wm_cuda.spectrum_blocks_plain(x, sweeps=SWEEPS,
                                             channels_last=True)

    s1 = k1()
    require(torch.equal(s1, k1()), "K1: two runs differ")
    ps1 = k1_plain()
    smax = float(ps1.max())
    err = float((s1 - ps1).abs().max())
    require(err <= 1e-4 * smax, f"K1 frames vs twin: {err} > 1e-4*{smax}")
    require(torch.equal(s1, ps1), f"K1 frames vs twin: not bit-equal ({err})")
    planes_u8 = torch.movedim(x, -1, -3).reshape(-1, H, W).contiguous()
    blocks = dct.blockify(planes_u8.to(torch.float32)).reshape(-1, 8, 8)
    svdvals_ms = cuda_time(lambda: torch.linalg.svdvals(blocks), 3)
    del blocks

    def k1p():
        return wm_cuda.spectrum_blocks(planes_u8, sweeps=SWEEPS)

    def k1p_plain():
        return wm_cuda.spectrum_blocks_plain(planes_u8, sweeps=SWEEPS)

    sp = k1p()
    psp = k1p_plain()
    perr = float((sp - psp).abs().max())
    require(perr <= 1e-4 * float(psp.max()),
            f"K1 planes vs twin: {perr} > 1e-4*{float(psp.max())}")
    require(torch.equal(sp, psp), f"K1 planes vs twin: not bit-equal ({perr})")
    results["spectrum_blocks"] = dict(
        shape=list(x.shape), max_abs_err=err, s_max=smax, equals_twin=True,
        ms=cuda_time(k1, 10), plain_ms=cuda_time(k1_plain, 3),
        library_ms=svdvals_ms,
        planes_shape=list(planes_u8.shape), planes_max_abs_err=perr,
        planes_ms=cuda_time(k1p, 10), planes_plain_ms=cuda_time(k1p_plain, 3),
        equals_k2_sc=bool(torch.equal(s1, sc)),
        **bound(n_blocks, jacobi_ops(pairs), nbytes(x, s1)))
    emit({"phase": "kernel_vs_plain", "kernel": "K1 spectrum_blocks",
          **results["spectrum_blocks"]})

    # K3 on the same frames: equal to its twin and to K2, and its s_cw
    # equal to K1 on its stego
    def k3():
        return wm_cuda.roundtrip_frames_blocks(x, sws, sweeps=SWEEPS, k=K)

    def k3_plain():
        return wm_cuda.roundtrip_frames_blocks_plain(x, sws, sweeps=SWEEPS,
                                                     k=K)

    st, sc3, scw = k3()
    st2, sc3b, scw2 = k3()
    require(torch.equal(st, st2) and torch.equal(sc3, sc3b)
            and torch.equal(scw, scw2), "K3: two runs differ")
    pst, psc3, pscw = k3_plain()
    d = (st.to(torch.int16) - pst.to(torch.int16)).abs()
    byte_err3 = int(d.max())
    smax = float(psc3.max())
    sc3_err = float((sc3 - psc3).abs().max())
    scw_err = float((scw - pscw).abs().max())
    require(torch.equal(st, pst) and torch.equal(sc3, psc3)
            and torch.equal(scw, pscw),
            f"K3 vs twin: stego |d| max {byte_err3} on "
            f"{float((d > 0).float().mean())} of bytes, sc err {sc3_err}, "
            f"s_cw err {scw_err}")
    require(torch.equal(scw, wm_cuda.spectrum_blocks(st, sweeps=SWEEPS,
                                                     channels_last=True)),
            "K3 s_cw differs from K1 on its own stego")
    require(torch.equal(st, y) and torch.equal(sc3, sc),
            "K3 stego or sc differs from K2's")
    results["roundtrip_frames_blocks"] = dict(
        shape=list(x.shape), max_abs_err=float(byte_err3),
        equals_twin=True, sc_max_abs_err=sc3_err,
        scw_max_abs_err=scw_err, s_max=smax, scw_equals_k1=True,
        equals_k2=True,
        ms=cuda_time(k3, 10), plain_ms=cuda_time(k3_plain, 3),
        library_ms=None,
        **bound(n_blocks, 2 * jacobi_ops(pairs) + paint_ops(K),
                nbytes(x, sws, st, sc3, scw)))
    emit({"phase": "kernel_vs_plain", "kernel": "K3 roundtrip_frames_blocks",
          **results["roundtrip_frames_blocks"]})

    # K2r on the [24, H, W] planes in f32 (plane p takes sws[p % 3]); K1
    # on them equal to its twin
    planes_f32 = planes_u8.to(torch.float32)
    require(torch.equal(
        wm_cuda.spectrum_blocks(planes_f32, sweeps=SWEEPS),
        wm_cuda.spectrum_blocks_plain(planes_f32, sweeps=SWEEPS)),
        "K1 f32 planes vs twin: not bit-equal")

    def k2r():
        return wm_cuda.embed_blocks_recon(planes_f32, sws, sweeps=SWEEPS)

    def k2r_plain():
        return wm_cuda.embed_blocks_recon_plain(planes_f32, sws,
                                                sweeps=SWEEPS)

    yr, scr = k2r()
    yr2, scr2 = k2r()
    require(torch.equal(yr, yr2) and torch.equal(scr, scr2),
            "K2r: two runs differ")
    pyr, pscr = k2r_plain()
    ymax = float(pyr.abs().max())
    yr_err = float((yr - pyr).abs().max())
    scr_err = float((scr - pscr).abs().max())
    require(torch.equal(yr, pyr) and torch.equal(scr, pscr),
            f"K2r vs twin: not bit-equal (y {yr_err}, sc {scr_err})")
    results["embed_blocks_recon"] = dict(
        shape=list(planes_f32.shape), max_abs_err=yr_err, y_max=ymax,
        sc_max_abs_err=scr_err, equals_twin=True,
        ms=cuda_time(k2r, 10), plain_ms=cuda_time(k2r_plain, 3),
        library_ms=None,
        **bound(n_blocks, recon_ops(pairs),
                nbytes(planes_f32, sws, yr, scr)))
    emit({"phase": "kernel_vs_plain", "kernel": "K2r embed_blocks_recon",
          **results["embed_blocks_recon"]})
    del planes_f32, yr, yr2, pyr

    # K1g on the u8 planes
    def k1g():
        return wm_cuda.spectrum_blocks_gram(planes_u8, sweeps=SWEEPS)

    def k1g_plain():
        return wm_cuda.spectrum_blocks_gram_plain(planes_u8, sweeps=SWEEPS)

    sg = k1g()
    require(torch.equal(sg, k1g()), "K1g: two runs differ")
    psg = k1g_plain()
    smax = float(psg.max())
    g_err = float((sg - psg).abs().max())
    require(torch.equal(sg, psg), f"K1g vs twin: not bit-equal ({g_err})")
    results["spectrum_blocks_gram"] = dict(
        shape=list(planes_u8.shape), max_abs_err=g_err, s_max=smax,
        equals_twin=True,
        vs_onesided_max_abs_err=float((sg - sp).abs().max()),
        ms=cuda_time(k1g, 10), plain_ms=cuda_time(k1g_plain, 3),
        library_ms=svdvals_ms,
        **bound(n_blocks, gram_ops(pairs), nbytes(planes_u8, sg)))
    emit({"phase": "kernel_vs_plain", "kernel": "K1g spectrum_blocks_gram",
          **results["spectrum_blocks_gram"]})

    # K18 on the 1080p batch of 32 (and 128): the presence statistic every
    # extract with sw takes, color and gray spectra
    for name, gray in (("presence", False), ("presence_gray", True)):
        results[name] = presence_row(dev, frames_u8, wm_u8, blk, intra, gray)
        emit({"phase": "kernel_vs_plain", "kernel": f"K18 {name}",
              **results[name]})

    # K5f on the 1080p batch of 32: the extract tail's front stage (both
    # tail forms), color and gray spectra
    for name, gray in (("tail_front", False), ("tail_front_gray", True)):
        results[name] = tail_front_row(dev, frames_u8, wm_u8, blk, intra,
                                       gray)
        emit({"phase": "kernel_vs_plain", "kernel": f"K5f {name}",
              **results[name]})

    # K5 on the 1080p batch of 32: the recompute extract tail's two passes,
    # color frames and gray planes
    for name, gray in (("recon_normalize", False),
                       ("recon_normalize_gray", True)):
        results[name] = tail_kernel_row(dev, frames_u8, wm_u8, blk, intra,
                                        gray)
        emit({"phase": "kernel_vs_plain", "kernel": f"K5 {name}",
              **results[name]})

    # K8 on the 1080p batch of 32: the default extract tail's normaliser
    # over the materialised product, color frames and gray planes, each
    # instance (the resident one is the 1080p plan's; the two-pass one
    # the 4k batch's)
    for name, gray in (("normalize_blocks", False),
                       ("normalize_blocks_gray", True)):
        res, two = tail_k8_row(dev, frames_u8, wm_u8, blk, intra, gray)
        results[name] = res
        emit({"phase": "kernel_vs_plain", "kernel": f"K8 {name}", **res})
        emit({"phase": "kernel_vs_plain", "kernel": f"K8 {name} two-pass",
              **two})
        if not gray:
            two.update(k8_two_pass_4k(dev))
            results["normalize_blocks_two_pass"] = two

    # K2 on smoothed (natural-like) frames: no bound, reported only. Near-
    # degenerate blocks are far from converged at s1.25, so ulp-level
    # differences (FMA contraction, rsqrtf) move their rotations.
    from dctsvd_tpu_torch.ops import metrics
    smooth = metrics.gaussian_blur(
        torch.movedim(x[:2], -1, -3).to(torch.float32), sigma=3.0)
    smooth = torch.movedim(smooth, -3, -1).round().clamp(0, 255).to(
        torch.uint8).contiguous()
    ys, _ = wm_cuda.embed_blocks(smooth, sws, sweeps=SWEEPS, k=K,
                                 out_u8=True, channels_last=True)
    pys, _ = wm_cuda.embed_blocks_plain(smooth, sws, sweeps=SWEEPS, k=K,
                                        out_u8=True, channels_last=True)
    ds = (ys.to(torch.int16) - pys.to(torch.int16)).abs()
    emit({"phase": "kernel_vs_plain_smooth", "kernel": "K2 embed_blocks",
          "max_abs_err": int(ds.max()),
          "bytes_differing": float((ds > 0).float().mean())})
    return results


def wm_coefs(wm_u8, blk, intra):
    """K4's input on the slice: the DCT coefficients of the keyed color
    watermark's 8x8 blocks, [3, N, 8, 8] f32."""
    import torch
    from dctsvd_tpu_torch.ops import dct, permute
    planes = torch.movedim(wm_u8.to(torch.float32), -1, -3)
    return dct.dct2_blocks(permute.permute_block_tensor(
        dct.blockify(planes), blk, intra)).contiguous()


def jacobi_times(covers, coefs, mix: dict, t3: float) -> dict:
    """K1 (u8 channels-last frames, 8 and 32 of them; the 8 frames' 24
    planes in u8 and in f32; s1.25), K4 (U/S/Vt and S only on the
    watermark's [3, N, 8, 8], 5 sweeps), K2r (the 24 planes in f32, the 8
    u8 frames; s1.25) and K1g (the 24 u8 and f32 planes, the 8 u8 frames;
    s1.25): each first checked against its twin run on the card, then two
    readings of 20 launches (CUDA events, after a warm-up); the f32
    operations a second (the bound's count) and, from the SASS mix of the
    instance the row runs (``mix``, by kernel, type and channels), the
    instructions a second, each against T3's unfused rate ``t3`` (one
    instruction per operation)."""
    import torch
    from dctsvd_tpu_torch.ops import svd_cuda, wm_cuda

    x = covers[:KERNEL_FRAMES].contiguous()
    planes_u8 = torch.movedim(x, -1, -3).reshape(-1, H, W).contiguous()
    planes_f32 = planes_u8.to(torch.float32)
    gen = torch.Generator(device=x.device).manual_seed(20261027)
    mask = (torch.arange(8, device=x.device) < K).to(torch.float32)
    sws = torch.rand((3, (H // 8) * (W // 8), 8), generator=gen,
                     device=x.device) * 5 * mask
    k1 = (wm_cuda.spectrum_blocks, wm_cuda.spectrum_blocks_plain)
    k4 = (svd_cuda.jacobi_svd8, svd_cuda.jacobi_svd8_plain)
    k2r = (wm_cuda.embed_blocks_recon, wm_cuda.embed_blocks_recon_plain)
    k1g = (wm_cuda.spectrum_blocks_gram, wm_cuda.spectrum_blocks_gram_plain)
    full, extra = wm_cuda.sched_split(SWEEPS)
    pairs = full * len(wm_cuda.PAIRS) + extra
    k1_ops = jacobi_ops(pairs)
    k4_ops = jacobi_ops(5 * len(wm_cuda.PAIRS), with_v=True) + 64
    frames = dict(sweeps=SWEEPS, channels_last=True)
    planes = dict(sweeps=SWEEPS)
    # name: kernel, twin, inputs, keywords, f32 operations a block, the
    # kernel and the instance's mangled name (type and channels; older
    # trees named the instances of K1, K2r and K1g by type alone,
    # "kernelIhE")
    cases = {
        "K1 frames u8 8": (*k1, (x,), frames, k1_ops, "spectrum_kernel",
                           "kernelIhLi3E"),
        "K1 frames u8 32": (*k1, (covers,), frames, k1_ops,
                            "spectrum_kernel", "kernelIhLi3E"),
        "K1 planes u8 24": (*k1, (planes_u8,), planes, k1_ops,
                            "spectrum_kernel", "kernelIhLi1E"),
        "K1 planes f32 24": (*k1, (planes_f32,), planes, k1_ops,
                             "spectrum_kernel", "kernelIfLi1E"),
        "K4 U/S/Vt": (*k4, (coefs,), {}, k4_ops, "svd8_kernel",
                      "kernelILb1E"),
        "K4 S": (*k4, (coefs,), dict(compute_uv=False),
                 jacobi_ops(5 * len(wm_cuda.PAIRS)), "svd8_kernel",
                 "kernelILb0E"),
        "K2r planes f32 24": (*k2r, (planes_f32, sws), planes,
                              recon_ops(pairs), "embed_recon_kernel",
                              "kernelIfLi1E"),
        "K2r frames u8 8": (*k2r, (x, sws), frames, recon_ops(pairs),
                            "embed_recon_kernel", "kernelIhLi3E"),
        "K1g planes u8 24": (*k1g, (planes_u8,), planes, gram_ops(pairs),
                             "spectrum_gram_kernel", "kernelIhLi1E"),
        "K1g frames u8 8": (*k1g, (x,), frames, gram_ops(pairs),
                            "spectrum_gram_kernel", "kernelIhLi3E"),
        "K1g planes f32 24": (*k1g, (planes_f32,), planes, gram_ops(pairs),
                              "spectrum_gram_kernel", "kernelIfLi1E"),
    }
    rows = {}
    for name, (fn, plain, args, kw, ops, kind, inst) in cases.items():
        got, ref = fn(*args, **kw), plain(*args, **kw)
        got, ref = ((t,) if torch.is_tensor(t) else t for t in (got, ref))
        blocks = args[0].numel() // 64
        ms = [cuda_time(lambda: fn(*args, **kw), 20) for _ in range(2)]
        found = [n for n in mix if kind in n and (inst in n or inst[:8]
                                                  + "E" in n)]
        r = rows[name] = dict(
            shape=list(args[0].shape),
            equals_twin=all(torch.equal(a, b) for a, b in zip(got, ref)),
            max_abs_err=max(float((a - b).abs().max())
                            for a, b in zip(got, ref)),
            ms=ms, op_per_s=blocks * ops / (sum(ms) / 2e3),
            instance=found[0] if found else None)
        r["share_of_t3"] = r["op_per_s"] / t3
        if found:
            per_block = sum(mix[found[0]]["per_lane"].values())
            r.update(instructions_per_block=per_block,
                     issue_share_of_t3=blocks * per_block / (sum(ms) / 2e3)
                     / t3)
        del got, ref
    return rows


def t3_rate(dev) -> float:
    """T3's unfused f32 rate (ilp8, 1032 operations an element, on the
    probes' [96, 135, 8, 240]), as the probes phase measures it."""
    import torch
    from dctsvd_tpu_torch.ops import probe_cuda
    from dctsvd_tpu_torch.tools import exp_vpu_roofline

    gen = torch.Generator(device=dev).manual_seed(PROBE_SEED)
    x = torch.randn((3 * BATCH, H // 8, 8, W // 8), generator=gen,
                    device=dev)
    n_ops = exp_vpu_roofline.N_OPS[-1]
    _, ops = probe_cuda.chain_steps("ilp8", n_ops)
    ms = cuda_time(lambda: exp_vpu_roofline.run(x, "ilp8", n_ops), 10)
    return x.numel() * ops / (ms * 1e-3)


def paint_k_times(dev, covers) -> dict:
    """{k: {"k2_ms", "k3_ms"}}: K2 (u8 in and out) and K3 at every k =
    1..8 on the kernel comparisons' 8 1080p frames at s1.25, CUDA events,
    mean of 10 launches after a warm-up."""
    import torch
    from dctsvd_tpu_torch.ops import wm_cuda

    x = covers[:KERNEL_FRAMES].contiguous()
    gen = torch.Generator(device=dev).manual_seed(20261026)
    sws = torch.rand((3, (H // 8) * (W // 8), 8), generator=gen,
                     device=dev) * 5
    times = {}
    for k in range(1, 9):
        times[k] = dict(
            k2_ms=cuda_time(lambda: wm_cuda.embed_blocks(
                x, sws, sweeps=SWEEPS, k=k, out_u8=True, channels_last=True),
                10),
            k3_ms=cuda_time(lambda: wm_cuda.roundtrip_frames_blocks(
                x, sws, sweeps=SWEEPS, k=k), 10))
    return times


def phase_paint_k_sweep(dev, covers):
    """K2 (u8 and f32 in, u8 and f32 out) and K3 at every k = 1..8 on 2
    1080p frames, each equal to its twin bit for bit; K3's s_cw equal to
    K1 on its stego, and its stego and sc equal to K2's; then each k's
    K2 and K3 times on 8 frames."""
    import torch
    from dctsvd_tpu_torch.ops import wm_cuda

    x = covers[:2].contiguous()
    gen = torch.Generator(device=dev).manual_seed(20261025)
    x_f32 = x.to(torch.float32) + torch.rand(x.shape, generator=gen,
                                             device=dev)
    sws = torch.rand((3, (H // 8) * (W // 8), 8), generator=gen,
                     device=dev) * 5
    cases = 0
    t0 = time.perf_counter()
    for k in range(1, 9):
        for xin in (x, x_f32):
            for out_u8 in (True, False):
                y, sc = wm_cuda.embed_blocks(xin, sws, sweeps=SWEEPS, k=k,
                                             out_u8=out_u8,
                                             channels_last=True)
                py, psc = wm_cuda.embed_blocks_plain(
                    xin, sws, sweeps=SWEEPS, k=k, out_u8=out_u8,
                    channels_last=True)
                y_err = float((y.to(torch.float32)
                               - py.to(torch.float32)).abs().max())
                require(torch.equal(y, py) and torch.equal(sc, psc),
                        f"K2 k={k} {xin.dtype} -> "
                        f"{'u8' if out_u8 else 'f32'} vs twin: y err "
                        f"{y_err}, sc err {float((sc - psc).abs().max())}")
                if xin is x and out_u8:
                    y_k2, sc_k2 = y, sc
                cases += 1
        st, sc3, scw = wm_cuda.roundtrip_frames_blocks(x, sws, sweeps=SWEEPS,
                                                       k=k)
        pst, psc3, pscw = wm_cuda.roundtrip_frames_blocks_plain(
            x, sws, sweeps=SWEEPS, k=k)
        require(torch.equal(st, pst) and torch.equal(sc3, psc3)
                and torch.equal(scw, pscw), f"K3 k={k} vs twin")
        require(torch.equal(st, y_k2) and torch.equal(sc3, sc_k2),
                f"K3 k={k}: stego or sc differs from K2's")
        require(torch.equal(scw, wm_cuda.spectrum_blocks(
            st, sweeps=SWEEPS, channels_last=True)),
            f"K3 k={k}: s_cw differs from K1 on its stego")
        cases += 1
    emit({"phase": "paint_k_sweep", "shape": list(x.shape), "sweeps": SWEEPS,
          "k": list(range(1, 9)), "cases": cases, "all_equal_to_twins": True,
          "seconds": time.perf_counter() - t0,
          "times_8_frames": paint_k_times(dev, covers), "card": smi_line()})


class K8Instance:
    """The launches of one of K8's instances (tail_cuda.INSTANCE_LAUNCHES),
    set to 0 and read as a wrapper's ``.launches``, under the name of its
    counter on the paths: ``normalize_blocks_resident`` or
    ``normalize_blocks_two_pass``."""

    def __init__(self, instance: str):
        self.instance = instance
        self.__name__ = f"normalize_blocks_{instance}"

    @property
    def launches(self) -> int:
        from dctsvd_tpu_torch.ops import tail_cuda
        return tail_cuda.INSTANCE_LAUNCHES[self.instance]

    @launches.setter
    def launches(self, n: int) -> None:
        from dctsvd_tpu_torch.ops import tail_cuda
        tail_cuda.INSTANCE_LAUNCHES[self.instance] = n


K8_INSTANCES = (K8Instance("resident"), K8Instance("two_pass"))


def phase_slice(dev, covers, wm_u8, blk, intra):
    """The 1080p color slice, batch 32, with the launch counters."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import (detect_cuda, metrics, svd_cuda,
                                      tail_cuda, wm_cuda)

    wrappers = [svd_cuda.jacobi_svd8, wm_cuda.embed_blocks,
                wm_cuda.spectrum_blocks, tail_cuda.presence,
                tail_cuda.tail_front, tail_cuda.normalize_blocks,
                detect_cuda.band_scores, *K8_INSTANCES]
    torch.cuda.synchronize()
    for fn in wrappers:
        fn.launches = 0
    t0 = time.perf_counter()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    pw = blocked.prepare_wm_color(wm_u8, blk, intra)
    stop.record()
    stego, sc, psnr, ssim = blocked.embed_color_prepared(covers, pw.sw,
                                                         ALPHA)
    rec = blocked.extract_color_prepared(stego, sc, pw.ebasis, pw.inv_blk,
                                         ALPHA, sw=pw.sw)
    rec2 = blocked.extract_color(stego[:2], sc[:2], pw.uw, pw.vwt,
                                 pw.inv_blk, pw.inv_intra, ALPHA, sw=pw.sw)
    scores = blocked.detect_color(stego, sc, pw.sw, ALPHA)
    clean = blocked.detect_color(covers, sc, pw.sw, ALPHA)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in wrappers}
    for name, n in launches.items():
        require(n >= 1 or name == "normalize_blocks_two_pass",
                f"{name} was not launched on the main path")
    prepare_ms = [start.elapsed_time(stop)]

    require(stego.shape == covers.shape and stego.dtype == torch.uint8,
            f"stego {tuple(stego.shape)} {stego.dtype}")
    require(rec.shape == covers.shape and rec2.shape == covers[:2].shape,
            "extract shapes")
    require(bool(torch.isfinite(psnr).all()) and float(psnr.min()) > 20.0,
            f"psnr {psnr.min()}")
    require(bool(torch.isfinite(scores).all()), "non-finite detect score")
    require(float(scores.min()) >= DETECT_THRESH,
            f"own-stego detect {float(scores.min())} < {DETECT_THRESH}")
    require(float(clean.max()) < DETECT_THRESH,
            f"clean-cover detect {float(clean.max())} >= {DETECT_THRESH}")
    wm_flat = wm_u8.reshape(-1).to(torch.float32)
    ncs = metrics.nc(rec.reshape(rec.shape[0], -1).to(torch.float32),
                     wm_flat)
    nc2 = metrics.nc(rec2.reshape(2, -1).to(torch.float32), wm_flat)
    require(float(ncs.min()) > 0.4 and float(nc2.min()) > 0.4,
            f"extraction NC {float(ncs.min())}, {float(nc2.min())}")

    # steady state: embed + extract of the whole batch, as bench.py's
    # headline row times it (no metrics)
    def step():
        st, sc_ = blocked.embed_color_prepared(covers, pw.sw, ALPHA,
                                               with_metrics=False)[:2]
        return blocked.extract_color_prepared(st, sc_, pw.ebasis,
                                              pw.inv_blk, ALPHA, sw=pw.sw)

    def rate(step) -> float:
        step()
        torch.cuda.synchronize()
        iters = 5
        t1 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        return BATCH * iters / (time.perf_counter() - t1)

    fps = rate(step)
    # detect alone (K1 and the score), and prepare again (its K4 share
    # shows beside K4's time in kernel_vs_plain), CUDA events around it
    detect_fps = rate(lambda: blocked.detect_color(stego, sc, pw.sw, ALPHA))
    for _ in range(3):
        start.record()
        blocked.prepare_wm_color(wm_u8, blk, intra)
        stop.record()
        torch.cuda.synchronize()
        prepare_ms.append(start.elapsed_time(stop))
    out = dict(phase="slice_1080p_color", batch=BATCH, launches=launches,
               first_run_s=seconds, psnr_min=float(psnr.min()),
               ssim_min=float(ssim.min()),
               detect_min=float(scores.min()), clean_max=float(clean.max()),
               extract_nc_min=float(ncs.min()),
               embed_extract_fps=fps, detect_fps=detect_fps,
               prepare_ms=prepare_ms, card=smi_line())
    emit(out)
    return launches


def phase_serve(dev, covers, wm_u8, blk, intra):
    """The three serve steps on the 1080p batch of 32: each equal to the
    split calls on the card, taking K3 (and K5f and K8 for the verify
    steps, K9 for the scoring steps) and neither K2 nor K1."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import detect_cuda, tail_cuda, wm_cuda

    pw = blocked.prepare_wm_color(wm_u8, blk, intra)
    st, sc, _, _ = blocked.embed_color_prepared(covers, pw.sw, ALPHA,
                                                with_metrics=False)
    rec = blocked.extract_color_prepared(st, sc, pw.ebasis, pw.inv_blk,
                                         ALPHA, sw=pw.sw)
    scores = blocked.detect_color(st, sc, pw.sw, ALPHA)
    clean = blocked.detect_color(covers, sc, pw.sw, ALPHA)

    wrappers = [wm_cuda.roundtrip_frames_blocks, wm_cuda.embed_blocks,
                wm_cuda.spectrum_blocks, tail_cuda.presence,
                tail_cuda.tail_front, tail_cuda.normalize_blocks,
                detect_cuda.band_scores, *K8_INSTANCES]
    torch.cuda.synchronize()
    for fn in wrappers:
        fn.launches = 0
    t0 = time.perf_counter()
    v = blocked.serve_verify_color_prepared(covers, pw.sw, ALPHA, pw.ebasis,
                                            pw.inv_blk)
    vd = blocked.serve_verify_detect_color_prepared(covers, pw.sw, ALPHA,
                                                    pw.ebasis, pw.inv_blk)
    d = blocked.serve_detect_color_prepared(covers, pw.sw, ALPHA)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in wrappers}
    require(launches["roundtrip_frames_blocks"] >= 1
            and launches["tail_front"] >= 2 and launches["presence"] >= 2
            and launches["normalize_blocks"] >= 2
            and launches["band_scores"] == 2,
            f"K3, K5f, K8 or K9 not launched by the serve steps: {launches}")
    require(launches["embed_blocks"] == 0 and launches["spectrum_blocks"] == 0,
            f"the serve steps launched K2 or K1: {launches}")

    for name, out in (("serve_verify", v), ("serve_verify_detect", vd),
                      ("serve_detect", d)):
        require(torch.equal(out[0], st) and torch.equal(out[1], sc),
                f"{name}: stego or sc differs from the split calls")
    require(torch.equal(v[2], rec) and torch.equal(vd[2], rec),
            "serve verify: recovered watermark differs from the split calls")
    score_err = max(float((vd[3] - scores).abs().max()),
                    float((d[2] - scores).abs().max()))
    require(score_err <= 1e-5, f"serve scores vs detect_color: {score_err}")
    require(bool(torch.isfinite(vd[3]).all()), "non-finite serve score")
    require(float(vd[3].min()) >= DETECT_THRESH,
            f"own-stego serve score {float(vd[3].min())} < {DETECT_THRESH}")
    require(float(clean.max()) < DETECT_THRESH,
            f"clean-cover detect {float(clean.max())} >= {DETECT_THRESH}")

    def fps(step) -> float:
        step()
        torch.cuda.synchronize()
        iters = 5
        t1 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        return BATCH * iters / (time.perf_counter() - t1)

    # where a serve step's kernel time goes: K3 against the K2 + K1 pair
    # it replaces, on the whole batch
    sws = blocked._scaled_sws(pw.sw, torch.tensor(ALPHA, device=dev),
                              (torch.arange(8, device=dev) < K).float())
    k3_ms = cuda_time(lambda: wm_cuda.roundtrip_frames_blocks(
        covers, sws, sweeps=SWEEPS, k=K), 5)
    k2_ms = cuda_time(lambda: wm_cuda.embed_blocks(
        covers, sws, sweeps=SWEEPS, k=K, out_u8=True, channels_last=True), 5)
    k1_ms = cuda_time(lambda: wm_cuda.spectrum_blocks(
        st, sweeps=SWEEPS, channels_last=True), 5)

    out = dict(
        phase="serve_1080p_color", batch=BATCH, launches=launches,
        first_run_s=seconds, score_max_abs_err=score_err,
        k3_batch_ms=k3_ms, k2_batch_ms=k2_ms, k1_batch_ms=k1_ms,
        detect_min=float(vd[3].min()), clean_max=float(clean.max()),
        serve_verify_fps=fps(lambda: blocked.serve_verify_color_prepared(
            covers, pw.sw, ALPHA, pw.ebasis, pw.inv_blk)),
        serve_score_fps=fps(lambda: blocked.serve_detect_color_prepared(
            covers, pw.sw, ALPHA)),
        card=smi_line())
    emit(out)
    return {name: launches[name] for name in (
        "roundtrip_frames_blocks", "presence", "tail_front",
        "normalize_blocks", "band_scores", "normalize_blocks_resident",
        "normalize_blocks_two_pass")}


def phase_variants(dev, covers):
    """The recon-embed and Gram-spectrum entries (embed_blocks(variant=
    'recon'), spectrum_blocks(method='gram')) once each on the 8-frame
    1080p batch, with their launch counters."""
    import torch
    from dctsvd_tpu_torch.ops import wm_cuda

    x = covers[:KERNEL_FRAMES]
    planes = torch.movedim(x, -1, -3).reshape(-1, H, W).to(torch.float32)
    n = (H // 8) * (W // 8)
    gen = torch.Generator(device=dev).manual_seed(20261021)
    mask = (torch.arange(8, device=dev) < K).to(torch.float32)
    sws = torch.rand((3, n, 8), generator=gen, device=dev) * 5 * mask
    wrappers = [wm_cuda.embed_blocks_recon, wm_cuda.spectrum_blocks_gram]
    torch.cuda.synchronize()
    for fn in wrappers:
        fn.launches = 0
    y, sc = wm_cuda.embed_blocks(planes, sws, sweeps=SWEEPS, k=K,
                                 variant="recon")
    s_gram = wm_cuda.spectrum_blocks(x, sweeps=SWEEPS, channels_last=True,
                                     method="gram")
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in wrappers}
    for name, cnt in launches.items():
        require(cnt >= 1, f"{name} was not launched by its entry")
    require(y.shape == planes.shape and bool(torch.isfinite(y).all()),
            "recon embed: shape or non-finite values")
    # recon and delta run the same rotations: the same cover spectrum
    _, sc_delta = wm_cuda.embed_blocks(planes, sws, sweeps=SWEEPS, k=K)
    require(torch.equal(sc, sc_delta), "recon sc differs from K2's")
    require(s_gram.shape == (KERNEL_FRAMES, 3, n, 8)
            and bool(torch.isfinite(s_gram).all())
            and bool((s_gram >= 0).all())
            and bool((s_gram[..., :-1] >= s_gram[..., 1:]).all()),
            "Gram spectrum: shape, sign, order or non-finite values")
    # reported only: at s1.25 the two forms agree in exact arithmetic,
    # but blocks far from converged part ways in f32 (XᵀX squares the
    # condition number)
    s_one = wm_cuda.spectrum_blocks(x, sweeps=SWEEPS, channels_last=True)
    diff = (s_gram - s_one).abs()
    emit({"phase": "variant_entries", "shape": list(x.shape),
          "launches": launches,
          "gram_vs_onesided_max_abs_err": float(diff.max()),
          "gram_vs_onesided_blocks_over_1e-3": float(
              (diff.amax(-1) > 1e-3 * float(s_one.max())).float().mean()),
          "s_max": float(s_one.max())})
    return launches


def tail_spectra(dev, covers, wm_u8, blk, intra, gray: bool):
    """The extract tail's inputs on the main path for the 1080p batch of
    32: the prepared watermark, the embed's sc and K1's stego spectra
    (color [32, 3, 32400, 8], gray [32, 32400, 8]) of the stego and of the
    same stego with all but its top-left quadrant zeroed (the presence
    test fails and the zeroed blocks, three in four, are flagged, so the
    repaint runs; one zeroed quadrant leaves the mark present and flags
    none)."""
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import color
    if gray:
        pw = blocked.prepare_wm_gray(color.bgr_to_gray(wm_u8), blk, intra)
        st, sc = blocked.embed_gray_prepared(covers, pw.sw, ALPHA,
                                             with_metrics=False)[:2]
    else:
        pw = blocked.prepare_wm_color(wm_u8, blk, intra)
        st, sc = blocked.embed_color_prepared(covers, pw.sw, ALPHA,
                                              with_metrics=False)[:2]
    zeroed = st.clone()
    zeroed[:, H // 2:] = 0
    zeroed[:, :, W // 2:] = 0
    spectra = [blocked._plane_spectrum(color.luma_f32(stego), SWEEPS)
               if gray else blocked._frames_spectrum(stego, SWEEPS)
               for stego in (st, zeroed)]
    return pw, sc, spectra


def tail_inputs(dev, covers, wm_u8, blk, intra, gray: bool):
    """K5's inputs on the main path, as extract_color_prepared or
    extract_gray_prepared(recompute=True) hands them over for the 1080p
    batch of 32 (tail_spectra's two cases): K5f's natural-order estimates
    with the erasure flag (color [32, 3, 32400, 5] f32, gray [32, 32400,
    5], views of rows of 8 floats), and the k = 4 rows of the prepared
    basis (color [3, 32400, 4, 64], gray [32400, 4, 64], a strided
    view)."""
    from dctsvd_tpu_torch.models import blocked
    pw, sc, spectra = tail_spectra(dev, covers, wm_u8, blk, intra, gray)
    xs = [blocked._tail_front(s_cw, sc, pw.inv_blk, ALPHA, K, pw.sw)
          for s_cw in spectra]
    eb = pw.ebasis[..., :K, :, :]
    return xs[0], xs[1], eb.reshape(*eb.shape[:-2], 64)


# f32 operations of K5f a block and plane, at k components: the raw
# estimate (a difference and a division), the deviation, its scale and
# square, 1 + q², the reciprocal, the blend (a difference, a product, a
# sum) and the clamp's two bounds; twice the scale once (compares, selects
# and the absolute value count none)
def front_ops(k: int) -> int:
    return 12 * k + 1


def eager_engaged(raw, sw):
    """The presence statistic as the port ran it in eager ops before K18
    (models/blocked.py::_engaged before K18): metrics.nc over the 16..31
    block groups of column 0, torch.sort, the knee 0.20 + 1.8/sqrt(gsz).
    The reference K18's decision is held to; never called inside a counted
    extract."""
    import torch
    from dctsvd_tpu_torch.ops import metrics
    ref = sw.expand(raw.shape)
    n = raw.shape[-2]
    gsz = max(1, n // 16)
    ng = n // gsz
    a0 = ref[..., :ng * gsz, 0].reshape(*ref.shape[:-2], ng, gsz)
    b0 = raw[..., :ng * gsz, 0].reshape(*raw.shape[:-2], ng, gsz)
    m = -(-ng // 4)
    rho0 = torch.sort(metrics.nc(a0, b0), dim=-1).values[..., ng - m]
    knee = 0.20 + 1.8 / torch.sqrt(torch.full((), float(gsz),
                                              device=raw.device))
    return rho0 >= knee


def eager_statistic(s_cw, sc, sw):
    """The front's presence decision as the port took it before K18: column
    0 of the raw estimate written into a tensor shaped as the spectrum,
    then :func:`eager_engaged`."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    alpha = blocked._alpha(ALPHA, s_cw.device)
    s_cw, sc = (t.contiguous() for t in torch.broadcast_tensors(s_cw, sc))
    raw = torch.empty_like(s_cw)
    torch.div(s_cw[..., :1] - sc[..., :1], torch.clamp(alpha, min=1e-8),
              out=raw[..., :1])
    return eager_engaged(raw, sw)


def front_eager_statistic(s_cw, sc, pw):
    """models/blocked._tail_front as the port ran it before K18: the eager
    statistic (:func:`eager_statistic`), then K5f."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import tail_cuda
    alpha = blocked._alpha(ALPHA, s_cw.device)
    s_cw, sc = (t.contiguous() for t in torch.broadcast_tensors(s_cw, sc))
    return tail_cuda.tail_front(s_cw, sc, pw.inv_blk, alpha, K, pw.sw,
                                blocked._sw_scale(pw.sw),
                                eager_statistic(s_cw, sc, pw.sw))


def eager_front(s_cw, sc, pw):
    """The estimator and the slot gather as the eager tail ran them before
    K5f and K18, written out from the parts every tree of the port has
    since K5f: the raw estimate, the eager presence statistic
    (:func:`eager_engaged`), the shrinkage step, the flag column,
    _permute_slots."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import tail_cuda
    raw = blocked._raw_estimate(s_cw, sc, ALPHA)
    est, bad = tail_cuda.shrink_estimate(raw, pw.sw, blocked._sw_scale(pw.sw),
                                         eager_engaged(raw, pw.sw), K)
    combo = torch.cat([est[..., :K], bad.to(torch.float32)[..., None]],
                      dim=-1)
    return blocked._permute_slots(combo, pw.inv_blk)


# f32 operations of K18 a block: column 0 of the raw estimate (a
# difference and a division), pass 1's two sums, pass 2's two differences,
# three products and three sums
PRESENCE_OPS = 12


def presence_bound(s_cw, sw) -> dict:
    """K18's bound on a batch: the rows of s_cw and sc it reads column 0 of
    (a 32-byte sector a row), sw's rows once (the frames share them), the
    decisions and rho0 written once."""
    planes, n = s_cw[..., 0, 0].numel(), s_cw.shape[-2]
    chans = sw.shape[0] if sw.ndim == 3 else 1
    moved = 2 * planes * n * 32 + chans * n * 32 + planes * 5
    return bound(planes * n, PRESENCE_OPS, moved)


def presence_row(dev, covers, wm_u8, blk, intra, gray: bool) -> dict:
    """K18 against its plain twin run on the card (torch.equal: rho0 and
    the decision) on the main path's 1080p spectra of the batch of 32
    (tail_spectra: the stego and the three-quadrants-zeroed stego) and of
    128 frames, in its load form (s_cw, sc, alpha) and on the raw
    estimate; its decision equal to the eager statistic's on every frame
    (:func:`eager_engaged`, the reference). ms: K18 at 32 frames;
    plain_ms: its twin; eager_ms: the statistic as the front took it
    before (:func:`eager_statistic`); ms_128, eager_ms_128 at 128;
    device_ms, device_ms_128: its two kernels' device time (profiler)."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import tail_cuda

    pw, sc, spectra = tail_spectra(dev, covers, wm_u8, blk, intra, gray)
    alpha = blocked._alpha(ALPHA, dev)
    name = "gray" if gray else "color"
    checks = {}

    def held(case, s_cw, sc_):
        n0 = tail_cuda.presence.launches
        got = tail_cuda.presence(s_cw, pw.sw, sc_, alpha)
        torch.cuda.synchronize()
        require(tail_cuda.presence.launches == n0 + 1,
                f"K18 {name} {case}: not launched")
        ref = tail_cuda.presence_plain(s_cw, pw.sw, sc_, alpha)
        d = float((got[1] - ref[1]).abs().max())
        require(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                f"K18 {name} {case} vs twin: |d rho0| {d}")
        raw = blocked._raw_estimate(s_cw, sc_, ALPHA)
        on_raw = blocked._engaged(raw, pw.sw)
        require(torch.equal(on_raw, got[0]),
                f"K18 {name} {case}: _engaged on the raw estimate differs")
        eager = eager_engaged(raw, pw.sw)
        require(torch.equal(got[0], eager), f"K18 {name} {case}: decision "
                f"differs from the eager statistic's on "
                f"{int((got[0] != eager).sum())} planes")
        return dict(max_abs_err=d, equals_twin=True, equals_eager=True,
                    engaged_share=float(got[0].float().mean()),
                    rho0_min=float(got[1].min()),
                    rho0_max=float(got[1].max()))

    for case, s_cw in zip(("stego", "three_quadrants_zeroed"), spectra):
        checks[case] = held(case, s_cw, sc)
    s128 = spectra[0].repeat(4, *[1] * (spectra[0].ndim - 1))
    sc128 = sc.repeat(4, *[1] * (sc.ndim - 1))
    checks["stego_128"] = held("stego 128", s128, sc128)
    require(checks["stego"]["engaged_share"] == 1.0,
            f"K18 {name}: the stego is not engaged {checks}")
    s_cw = spectra[0]
    out = dict(
        layout=name, shape=list(s_cw.shape), groups=list(
            tail_cuda.presence_groups(s_cw.shape[-2])),
        knee=tail_cuda.presence_knee(tail_cuda.presence_groups(
            s_cw.shape[-2])[0]),
        checks=checks, max_abs_err=max(c["max_abs_err"]
                                       for c in checks.values()),
        equals_twin=True,
        ms=cuda_time(lambda: tail_cuda.presence(s_cw, pw.sw, sc, alpha), 20),
        plain_ms=cuda_time(lambda: tail_cuda.presence_plain(
            s_cw, pw.sw, sc, alpha), 3),
        eager_ms=cuda_time(lambda: eager_statistic(s_cw, sc, pw.sw), 10),
        device_ms=device_ms(lambda: tail_cuda.presence(s_cw, pw.sw, sc,
                                                       alpha), 10,
                            "presence_"),
        ms_128=cuda_time(lambda: tail_cuda.presence(s128, pw.sw, sc128,
                                                    alpha), 20),
        device_ms_128=device_ms(lambda: tail_cuda.presence(
            s128, pw.sw, sc128, alpha), 10, "presence_"),
        eager_ms_128=cuda_time(lambda: eager_statistic(s128, sc128, pw.sw),
                               5),
        library_ms=None, **presence_bound(s_cw, pw.sw))
    out["bound_ms_128"] = presence_bound(s128, pw.sw)["bound_ms"]
    return out


def tail_front_row(dev, covers, wm_u8, blk, intra, gray: bool) -> dict:
    """K5f against its plain twin run on the card (torch.equal) at the
    1080p batch of 32 in one layout, on the stego and on the zeroed stego
    (tail_spectra), given the presence decision of the eager estimator;
    and models/blocked._tail_front (K18, then K5f) equal to the eager
    front (:func:`eager_front`) on the same input. ms: K5f alone;
    plain_ms: its twin; front_ms: _tail_front; eager_ms: the eager front.
    bound_ms counts the spectra, sw and
    inv_blk read once and the k + 1 output columns written once
    (``written_bytes``: the rows of 8 floats K5f writes)."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import tail_cuda

    pw, sc, spectra = tail_spectra(dev, covers, wm_u8, blk, intra, gray)
    alpha = blocked._alpha(ALPHA, dev)
    scale = blocked._sw_scale(pw.sw)
    name = "gray" if gray else "color"
    checks, calls = {}, {}
    for case, s_cw in zip(("stego", "three_quadrants_zeroed"), spectra):
        engage = eager_engaged(blocked._raw_estimate(s_cw, sc, ALPHA),
                               pw.sw)
        args = (s_cw, sc, pw.inv_blk, alpha, K, pw.sw, scale, engage)
        y = tail_cuda.tail_front(*args)
        py = tail_cuda.tail_front_plain(*args)
        d = (y - py).abs()
        require(torch.equal(y, py), f"K5f {name} {case} vs twin: |d| max "
                f"{float(d.max())}")
        require(torch.equal(blocked._tail_front(s_cw, sc, pw.inv_blk, ALPHA,
                                                K, pw.sw),
                            eager_front(s_cw, sc, pw)),
                f"K5f {name} {case}: _tail_front differs from the eager "
                "front")
        checks[case] = dict(
            max_abs_err=float(d.max()), equals_twin=True, equals_eager=True,
            engaged_share=float(engage.float().mean()),
            flagged_share=float((y[..., K] > 0.5).float().mean()))
        calls[case] = args
    require(checks["stego"]["engaged_share"] == 1.0
            and 0 < checks["three_quadrants_zeroed"]["flagged_share"] < 1,
            f"K5f {name}: the cases miss their paths {checks}")
    args = calls["stego"]
    s_cw = spectra[0]
    y = tail_cuda.tail_front(*args)
    planes_blocks = s_cw[..., 0].numel()
    out = dict(
        layout=name, shape=list(s_cw.shape), out_shape=list(y.shape),
        checks=checks, max_abs_err=max(c["max_abs_err"]
                                       for c in checks.values()),
        equals_twin=True,
        ms=cuda_time(lambda: tail_cuda.tail_front(*args), 20),
        plain_ms=cuda_time(lambda: tail_cuda.tail_front_plain(*args), 3),
        front_ms=cuda_time(lambda: blocked._tail_front(
            s_cw, sc, pw.inv_blk, ALPHA, K, pw.sw), 10),
        eager_ms=cuda_time(lambda: eager_front(s_cw, sc, pw), 10),
        library_ms=None, written_bytes=y.untyped_storage().nbytes(),
        **bound(planes_blocks, front_ops(K),
                nbytes(s_cw, sc, pw.sw, pw.inv_blk, y)))
    return out


def tail_kernel_row(dev, covers, wm_u8, blk, intra, gray: bool) -> dict:
    """K5 against its plain twin run on the card (torch.equal) at the
    1080p batch of 32 in one layout (color channels-last frames, or gray
    planes), on the stego and on the stego with three quadrants zeroed
    (flagged blocks, the repaint), with the eager tail's time on the same input
    (the port's other form: product, normaliser, cast, unblockify).
    bound_ms counts each input once; two_pass_bound_ms the bytes of K5's
    design (the estimates and the basis read once a pass)."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import dct, tail_cuda

    x, xz, eb64 = tail_inputs(dev, covers, wm_u8, blk, intra, gray)
    frames = not gray

    def k5(xi=x):
        return tail_cuda.recon_normalize(xi, eb64, H, W, to_frames=frames)

    def k5_plain(xi=x):
        return tail_cuda.recon_normalize_plain(xi, eb64, H, W,
                                               to_frames=frames)

    def eager(xi=x):
        blocks = blocked._recon(xi[..., :K], eb64)
        blocks = tail_cuda.minmax_blocks(blocks, xi[..., K] > 0.5, True)
        blocks = blocks.clamp(0, 255).to(torch.uint8)
        blocks = blocks.reshape(*blocks.shape[:-1], 8, 8)
        if frames:
            return blocked._unblockify_to_frames(blocks, H, W)
        return dct.unblockify(blocks, H, W)

    name = "gray" if gray else "color"
    checks = {}
    for case, xi in (("stego", x), ("three_quadrants_zeroed", xz)):
        y = k5(xi)
        require(torch.equal(y, k5(xi)), f"K5 {name} {case}: two runs differ")
        py = k5_plain(xi)
        d = (y.to(torch.int16) - py.to(torch.int16)).abs()
        require(torch.equal(y, py),
                f"K5 {name} {case} vs twin: |d| max {int(d.max())} on "
                f"{float((d > 0).float().mean())} of bytes")
        de = (y.to(torch.int16) - eager(xi).to(torch.int16)).abs()
        require(int(de.max()) <= 2, f"K5 {name} {case} vs the eager tail: "
                f"{int(de.max())} quanta")
        checks[case] = dict(
            max_abs_err=float(d.max()), equals_twin=True,
            vs_eager_max_quanta=int(de.max()),
            vs_eager_share=float((de > 0).float().mean()),
            flagged_share=float((xi[..., K] > 0.5).float().mean()))
    require(0 < checks["three_quadrants_zeroed"]["flagged_share"] < 1,
            f"K5 {name}: the zeroed quadrants flagged no block or all")
    y = k5()
    # each output byte once, the estimates and the basis once
    basis_bytes = eb64.numel() * 4
    once = nbytes(x, y) + basis_bytes
    pixels = y.numel()
    out = dict(
        layout="frames" if frames else "planes",
        shape=list(x.shape), basis_shape=list(eb64.shape),
        out_shape=list(y.shape), checks=checks,
        max_abs_err=max(c["max_abs_err"] for c in checks.values()),
        equals_twin=True,
        ms=cuda_time(k5, 20), plain_ms=cuda_time(k5_plain, 3),
        eager_ms=cuda_time(eager, 10), library_ms=None,
        two_pass_bytes=nbytes(y) + 2 * (nbytes(x) + basis_bytes),
        **bound(pixels, 2 * K - 1 + 2, once))
    out["two_pass_bound_ms"] = out["two_pass_bytes"] / PEAK_BYTES * 1e3
    return out


K8_BATCHES = (1, 4, 33, 128)    # besides the batch of 32


def k8_inputs(dev, covers, wm_u8, blk, intra, gray: bool):
    """K8's inputs on the main path for the 1080p batch of 32 as
    _extract_tail_prepared hands them over: K5f's estimates (rows of 8
    floats) of the stego and of the three-quadrants-zeroed stego
    (tail_spectra), with the erasure flag, and of the stego without sw (no
    flag column), and the k = 4 rows of the prepared basis."""
    from dctsvd_tpu_torch.models import blocked
    pw, sc, spectra = tail_spectra(dev, covers, wm_u8, blk, intra, gray)
    x, xz = (blocked._tail_front(s_cw, sc, pw.inv_blk, ALPHA, K, pw.sw)
             for s_cw in spectra)
    x_nosw = blocked._tail_front(spectra[0], sc, pw.inv_blk, ALPHA, K)
    eb = pw.ebasis[..., :K, :, :]
    return x, xz, x_nosw, eb.reshape(*eb.shape[:-2], 64)


def k8_plans(dev, frames: int, chans: int):
    """K8's two instances at the 1080p shape: {"resident": the plan the
    card gives (norm_plan), "two_pass": the two-pass plan}."""
    from dctsvd_tpu_torch.ops import tail_cuda
    sms, smem, coop = tail_cuda.device_limits(dev)
    res = tail_cuda.norm_plan(frames, chans, (H // 8) * (W // 8), True, sms,
                              smem if coop else 0)
    require(res.instance == "resident", f"1080p takes {res}")
    return {"resident": res, "two_pass": tail_cuda.NormPlan("two_pass")}


def k8_ptxas(instance: str, gray: bool, crop: bool = False) -> dict:
    """Registers and spills of K8's kernels in one instance (nvcc's
    -Xptxas -v): the resident kernel of the layout (planes for gray,
    channels-last frames of 3 for color) with u8 out, or the two-pass
    window and paint kernels; ``crop``: K8u's."""
    from dctsvd_tpu_torch.utils import kernels
    rep = kernels.ptxas_report(kernels.BUILD_INFO["ptxas"])
    b = "1" if crop else "0"
    if instance == "resident":
        tag = ("ILi1ELb0EhLb" if gray else "ILi3ELb1EhLb") + b + "EE"
        keys = [n for n in rep if "norm_resident_kernel" + tag in n]
    else:
        c = "1" if gray else "3"
        keys = [n for n in rep if f"norm_window_kernelILi{c}ELb{b}EE" in n
                or f"norm_paint_kernelILi{c}EhLb{b}EE" in n]
    return {n: rep[n] for n in keys}


def tail_k8_row(dev, covers, wm_u8, blk, intra, gray: bool) -> tuple:
    """K8's two instances against their plain twin (the eager form) run on
    the card (torch.equal) on models/blocked._recon's product of the main
    path's estimates (k8_inputs), in one layout (color channels-last
    frames, or gray planes): the stego (with sw, no block flagged),
    without sw, with three quadrants zeroed (flagged blocks, the repaint),
    every block flagged, without normalize and with f32 output, at the
    batch of 32 and of 1, 4, 33 and 128 frames (the zeroed stego
    repeated), each instance forced by its plan; a frame's bytes the same
    alone, in a shard of 4 and in the batch (the default plan). Returns
    (the resident instance's row, the two-pass instance's row). ms: the
    instance on the stego at 32 frames; plain_ms: the twin; ms_128 and
    plain_ms_128 at 128; registers and shared memory a CTA (the resident
    plan's); bound_ms counts the reconstruction's frames, the flags (4
    bytes a block) and the output once, two_pass_bound_ms the
    reconstruction and flags read in each pass."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import tail_cuda

    x, xz, x_nosw, eb64 = k8_inputs(dev, covers, wm_u8, blk, intra, gray)
    frames = not gray
    name = "gray" if gray else "color"
    chans = 1 if gray else 3
    every = xz.clone()
    every[..., K] = 1.0

    def calls(xi, plan=None, **kw):
        blocks = blocked._recon(xi[..., :K], eb64)
        if plan is None:
            plan = k8_plans(dev, xi.shape[0], chans)["resident"]
        return (lambda: tail_cuda.normalize_blocks(
                    blocks, xi, K, H, W, to_frames=frames, plan=plan, **kw),
                lambda: tail_cuda.normalize_blocks_plain(
                    blocks, xi, K, H, W, to_frames=frames, **kw))

    def check(case, xi, **kw):
        rows = {}
        for inst, plan in k8_plans(dev, xi.shape[0], chans).items():
            k8, plain = calls(xi, plan, **kw)
            n0 = tail_cuda.INSTANCE_LAUNCHES[inst]
            y = k8()
            require(tail_cuda.INSTANCE_LAUNCHES[inst] == n0 + 1,
                    f"K8 {name} {case}: the {inst} instance not launched")
            require(torch.equal(y, k8()),
                    f"K8 {inst} {name} {case}: two runs differ")
            py = plain()
            d = (y.to(torch.float32) - py.to(torch.float32)).abs()
            require(torch.equal(y, py), f"K8 {inst} {name} {case} vs twin: "
                    f"|d| max {float(d.max())} on "
                    f"{float((d > 0).float().mean())}")
            rows[inst] = (y, dict(
                max_abs_err=float(d.max()), equals_twin=True,
                frames=int(xi.shape[0]), dtype=str(y.dtype),
                flagged_share=float((xi[..., K] > 0.5).float().mean())
                if xi.shape[-1] > K else 0.0))
        return rows

    checks = {"resident": {}, "two_pass": {}}

    def run(key, case, xi, **kw):
        rows = check(case, xi, **kw)
        for inst, (y, row) in rows.items():
            checks[inst][key] = row
        return rows["resident"][0]

    y32 = run("stego", "stego", x)
    run("no_sw", "no_sw", x_nosw)
    yz = run("three_quadrants_zeroed", "zeroed", xz)
    run("all_flagged", "all_flagged", every)
    run("no_normalize", "no_normalize", xz, normalize=False)
    run("f32_out", "f32_out", xz, out_u8=False)
    res = checks["resident"]
    require(res["stego"]["flagged_share"] == 0.0
            and 0 < res["three_quadrants_zeroed"]["flagged_share"] < 1,
            f"K8 {name}: the cases miss their paths {res}")
    for n in K8_BATCHES:
        xb = xz.repeat(-(-n // xz.shape[0]), *[1] * (xz.ndim - 1))[:n]
        run(f"batch_{n}", f"batch {n}", xb)
    for a, b in ((0, 1), (BATCH - 1, BATCH), (4, 8)):
        require(torch.equal(calls(xz[a:b])[0](), yz[a:b]),
                f"K8 {name}: frames {a}:{b} differ alone or in a shard "
                "from the batch")
    x128 = x.repeat(4, *[1] * (x.ndim - 1))
    recon_bytes = x[..., 0].numel() * 64 * 4
    flag_bytes = x[..., 0].numel() * 4
    once = recon_bytes + flag_bytes + nbytes(y32)
    plain_ms = cuda_time(calls(x)[1], 3)
    plain_ms_128 = cuda_time(calls(x128)[1], 2)
    out = {}
    for inst, plan in k8_plans(dev, BATCH, chans).items():
        plan128 = k8_plans(dev, 4 * BATCH, chans)[inst]
        out[inst] = dict(
            instance=inst, plan=str(plan),
            smem_bytes=plan.smem, ptxas=k8_ptxas(inst, gray),
            layout="frames" if frames else "planes",
            shape=list(x.shape[:-1]) + [64], out_shape=list(y32.shape),
            checks=checks[inst],
            max_abs_err=max(c["max_abs_err"]
                            for c in checks[inst].values()),
            equals_twin=True, batch_invariant=True,
            ms=cuda_time(calls(x, plan)[0], 20), plain_ms=plain_ms,
            ms_128=cuda_time(calls(x128, plan128)[0], 20),
            plain_ms_128=plain_ms_128, library_ms=None,
            two_pass_bytes=2 * (recon_bytes + flag_bytes) + nbytes(y32),
            # a pixel: the min and max compares, the difference and the
            # product
            **bound(y32.numel(), 4, once))
        out[inst]["eager_ms"] = plain_ms
        out[inst]["bound_ms_128"] = 4 * out[inst]["bound_ms"]
        out[inst]["two_pass_bound_ms"] = (out[inst]["two_pass_bytes"]
                                          / PEAK_BYTES * 1e3)
        out[inst]["two_pass_bound_ms_128"] = 4 * out[inst][
            "two_pass_bound_ms"]
    res, two = out["resident"], out["two_pass"]
    res.update(two_pass_ms=two["ms"], two_pass_ms_128=two["ms_128"])
    return res, two


def k8_two_pass_4k(dev) -> dict:
    """K8's two-pass instance where the plan takes it on the main path:
    the bench's 4k batch (2 color frames of 2160x3840, 129,600 blocks a
    plane), on models/blocked._recon's product of seeded estimates (a
    block in five flagged), held to the twin (torch.equal) and timed
    beside its one-read bound."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import tail_cuda
    h, w = 2160, 3840
    n = (h // 8) * (w // 8)
    sms, smem, coop = tail_cuda.device_limits(dev)
    require(tail_cuda.norm_plan(2, 3, n, True, sms, smem if coop else 0)
            .instance == "two_pass", "a 4k frame does not take the two-pass "
            "instance")
    gen = torch.Generator(device=dev).manual_seed(20261021)
    x = torch.randn((2, 3, n, 8), generator=gen, device=dev)
    x[..., K] = (torch.rand((2, 3, n), generator=gen, device=dev)
                 < 0.2).float()
    x = x[..., :K + 1]
    eb64 = torch.randn((3, n, K, 64), generator=gen, device=dev)
    blocks = blocked._recon(x[..., :K], eb64)

    def k8():
        return tail_cuda.normalize_blocks(blocks, x, K, h, w, to_frames=True)

    def plain():
        return tail_cuda.normalize_blocks_plain(blocks, x, K, h, w,
                                                to_frames=True)
    n0 = tail_cuda.INSTANCE_LAUNCHES["two_pass"]
    y = k8()
    require(tail_cuda.INSTANCE_LAUNCHES["two_pass"] == n0 + 1,
            "K8 at 4k: the two-pass instance not launched")
    require(torch.equal(y, plain()), "K8 two-pass at 4k vs twin")
    once = x[..., 0].numel() * (64 + 1) * 4 + nbytes(y)
    return dict(ms_4k=cuda_time(k8, 20), plain_ms_4k=cuda_time(plain, 3),
                bound_ms_4k=bound(y.numel(), 4, once)["bound_ms"])


@contextlib.contextmanager
def counted_calls(targets):
    """Counts the calls of the functions ``targets`` ((module, name) pairs)
    made inside the block: {name: calls}. Each still runs."""
    counts, patched = {}, []
    for mod, name in targets:
        orig = getattr(mod, name)
        counts[name] = 0

        def counted(*args, _orig=orig, _name=name, **kw):
            counts[_name] += 1
            return _orig(*args, **kw)
        patched.append((mod, name, orig))
        setattr(mod, name, counted)
    try:
        yield counts
    finally:
        for mod, name, orig in patched:
            setattr(mod, name, orig)


def eager_normaliser_calls():
    """:func:`counted_calls` of the eager normaliser's functions (the twin
    of K8 and K8u, the block-level normaliser and its window, the unaligned
    form) and of the eager presence statistic's (the twin of K18,
    metrics.nc)."""
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import metrics, tail_cuda
    return counted_calls(((tail_cuda, "normalize_blocks_plain"),
                          (tail_cuda, "minmax_blocks"),
                          (tail_cuda, "block_window"),
                          (blocked, "_masked_normalize"),
                          (tail_cuda, "presence_plain"),
                          (metrics, "nc")))


def eager_band_calls():
    """:func:`counted_calls` of the eager band statistic's functions (the
    twin of K9, metrics.nc, the two damps)."""
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import detect_cuda, metrics
    return counted_calls(((detect_cuda, "band_scores_plain"),
                          (metrics, "nc"), (blocked, "band_scale_damp"),
                          (blocked, "band_presence_damp")))


def phase_tail_recompute(dev, covers, wm_u8, blk, intra) -> dict:
    """extract_color_prepared and extract_gray_prepared with recompute=True
    on the 1080p batch of 32, K5's and K5f's counters set to 0 just before
    and read just after: NC > 0.4 against the watermark, within 2 quanta
    of recompute=False on the whole batch, and a frame's bytes the same
    alone, in a shard of 4 and in the batch. Then the default form
    (recompute=False) and serve_verify_color_prepared with K5f's twin in
    its place: byte-equal to their outputs with K5f. The default form's
    color and gray extracts and serve+verify launch K8, each counted alone,
    and call no eager normaliser (:func:`eager_normaliser_calls`); a
    frame's bytes are the same alone, in a shard of 4 and in the batch."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import color, metrics, tail_cuda

    wm_gray = color.bgr_to_gray(wm_u8)
    pwc = blocked.prepare_wm_color(wm_u8, blk, intra)
    pwg = blocked.prepare_wm_gray(wm_gray, blk, intra)
    st, sc = blocked.embed_color_prepared(covers, pwc.sw, ALPHA,
                                          with_metrics=False)[:2]
    stg, scg = blocked.embed_gray_prepared(covers, pwg.sw, ALPHA,
                                           with_metrics=False)[:2]

    def color_x(stego, sc_, **kw):
        return blocked.extract_color_prepared(stego, sc_, pwc.ebasis,
                                              pwc.inv_blk, ALPHA, sw=pwc.sw,
                                              **kw)

    def gray_x(stego, sc_, **kw):
        return blocked.extract_gray_prepared(stego, sc_, pwg.ebasis,
                                             pwg.inv_blk, ALPHA, sw=pwg.sw,
                                             **kw)

    def run(fn, stego, sc_):
        torch.cuda.synchronize()
        tail_cuda.recon_normalize.launches = 0
        tail_cuda.tail_front.launches = 0
        tail_cuda.presence.launches = 0
        t0 = time.perf_counter()
        out = fn(stego, sc_, recompute=True)
        torch.cuda.synchronize()
        return out, (tail_cuda.recon_normalize.launches,
                     tail_cuda.tail_front.launches,
                     tail_cuda.presence.launches), \
            time.perf_counter() - t0

    # K5's color frames, then its gray planes, each counted alone
    rec, (launches, front, k18), seconds = run(color_x, st, sc)
    recg, (launches_g, front_g, k18_g), seconds_g = run(gray_x, stg, scg)
    require(min(launches, launches_g, front, front_g, k18, k18_g) >= 1,
            f"K5 launched {launches} times by the color and {launches_g} "
            f"by the gray recompute extract, K5f {front} and {front_g}, "
            f"K18 {k18} and {k18_g}")
    require(rec.shape == covers.shape and rec.dtype == torch.uint8
            and recg.shape == covers.shape[:-1], "recompute extract shapes")
    row = dict(phase="tail_recompute_1080p", batch=BATCH,
               launches={"recon_normalize": launches,
                         "recon_normalize_gray": launches_g,
                         "tail_front": front, "tail_front_gray": front_g,
                         "presence": k18, "presence_gray": k18_g},
               first_run_s={"color": seconds, "gray": seconds_g})
    for name, got, eager, wm in (
            ("color", rec, color_x(st, sc), wm_u8),
            ("gray", recg, gray_x(stg, scg), wm_gray)):
        d = (got.to(torch.int16) - eager.to(torch.int16)).abs()
        nc = metrics.nc(got.reshape(BATCH, -1).to(torch.float32),
                        wm.reshape(-1).to(torch.float32))
        require(int(d.max()) <= 2, f"{name} recompute vs materialising: "
                f"{int(d.max())} quanta")
        require(float(nc.min()) > 0.4, f"{name} recompute NC "
                f"{float(nc.min())}")
        row[name] = dict(vs_eager_max_quanta=int(d.max()),
                         vs_eager_share=float((d > 0).float().mean()),
                         nc_min=float(nc.min()))
    for name, fn, stego, sc_, whole in (("color", color_x, st, sc, rec),
                                        ("gray", gray_x, stg, scg, recg)):
        parts = [(0, 1), (BATCH - 1, BATCH), (4, 8)]
        require(all(torch.equal(fn(stego[a:b], sc_[a:b], recompute=True),
                                whole[a:b]) for a, b in parts),
                f"{name} recompute: a frame's bytes differ alone, in a "
                "shard of 4 or in the batch")
        row[name]["batch_invariant"] = True

    # the default form's bytes with K5f and with its twin in its place
    def default_outputs():
        return dict(
            color=color_x(st, sc), gray=gray_x(stg, scg),
            serve_verify=blocked.serve_verify_color_prepared(
                covers, pwc.sw, ALPHA, pwc.ebasis, pwc.inv_blk)[2])

    # the default form on the card: K8 on each path, no eager normaliser
    k8, k8_inst = {}, {}
    with eager_normaliser_calls() as eager_calls:
        for name, fn in (
                ("color", lambda: color_x(st, sc)),
                ("gray", lambda: gray_x(stg, scg)),
                ("serve_verify", lambda: blocked.serve_verify_color_prepared(
                    covers, pwc.sw, ALPHA, pwc.ebasis, pwc.inv_blk))):
            torch.cuda.synchronize()
            for c in (tail_cuda.normalize_blocks, *K8_INSTANCES):
                c.launches = 0
            fn()
            torch.cuda.synchronize()
            k8[name] = tail_cuda.normalize_blocks.launches
            k8_inst[name] = {c.__name__: c.launches for c in K8_INSTANCES}
    require(min(k8.values()) >= 1 and not any(eager_calls.values()),
            f"the default aligned extract: K8 launches {k8}, eager "
            f"normaliser or statistic calls {eager_calls}")
    row["default_form"] = dict(normalize_blocks_launches=k8,
                               instance_launches=k8_inst,
                               eager_normaliser_calls=eager_calls)
    row["launches"].update(
        normalize_blocks=k8["color"] + k8["serve_verify"],
        normalize_blocks_gray=k8["gray"],
        **{c.__name__: k8_inst["color"][c.__name__]
           + k8_inst["serve_verify"][c.__name__] for c in K8_INSTANCES},
        **{c.__name__ + "_gray": k8_inst["gray"][c.__name__]
           for c in K8_INSTANCES})
    default_color, default_gray = color_x(st, sc), gray_x(stg, scg)
    for name, fn, stego, sc_, whole in (
            ("color", color_x, st, sc, default_color),
            ("gray", gray_x, stg, scg, default_gray)):
        require(all(torch.equal(fn(stego[a:b], sc_[a:b]), whole[a:b])
                    for a, b in ((0, 1), (BATCH - 1, BATCH), (4, 8))),
                f"{name} default form: a frame's bytes differ alone, in a "
                "shard of 4 or in the batch")
        row["default_form"][f"{name}_batch_invariant"] = True

    with_kernel = default_outputs()
    front_kernel = tail_cuda.tail_front
    tail_cuda.tail_front = tail_cuda.tail_front_plain
    try:
        with_twin = default_outputs()
    finally:
        tail_cuda.tail_front = front_kernel
    for name, out in with_kernel.items():
        require(torch.equal(out, with_twin[name]), f"{name}: the default "
                "tail's bytes differ with K5f's twin as its front")
    row["default_bytes_equal_with_twin_front"] = sorted(with_kernel)
    emit(dict(row, card=smi_line()))
    return row["launches"]


# ---------------------------------------------------------------------------
# The request extract (extract_array: api.extract, the CLI, the GUI, the
# payloads) and the unaligned prepared extract: K1, K18, K5f, K8 or K8u
# ---------------------------------------------------------------------------

REQUEST_SIZES = {"1080p": (H, W), "1079x1917": (1079, 1917),
                 "480x854": (480, 854)}
REQUEST_SEED = 20261027


#: K8u's launches by instance (tail_cuda.INSTANCE_LAUNCHES["crop_*"]: the
#: calls with a crop, counted under their instance too), as wrappers'
#: ``.launches``: normalize_blocks_crop_resident, _crop_two_pass
K8U_INSTANCES = (K8Instance("crop_resident"), K8Instance("crop_two_pass"))


def crop_instance(dev, frames: int, chans: int, h: int, w: int):
    """The instance K8 takes for a call of ``frames`` h x w frames on this
    card (tail_cuda.shape_plan), or None where h and w are multiples of 8
    (no K8u)."""
    from dctsvd_tpu_torch.ops import tail_cuda
    if not (h % 8 or w % 8):
        return None
    sms, smem, coop = tail_cuda.device_limits(dev)
    return tail_cuda.shape_plan(frames, chans, h, w, True, sms,
                                smem if coop else 0).instance


def request_wrappers() -> dict:
    """The kernels a request extract runs: K1, K6 (gray), K18, K5f, K8 and
    its instances, K8u's instances."""
    from dctsvd_tpu_torch.ops import color_cuda, tail_cuda, wm_cuda
    return {"spectrum_blocks": wm_cuda.spectrum_blocks,
            "luma_f32": color_cuda.luma_f32,
            "presence": tail_cuda.presence,
            "tail_front": tail_cuda.tail_front,
            "normalize_blocks": tail_cuda.normalize_blocks,
            **{c.__name__: c for c in (*K8_INSTANCES, *K8U_INSTANCES)}}


@contextlib.contextmanager
def extract_twins():
    """Every kernel of the extract in its twin's place: K1, K18, K5f, K8
    (and K8u) in the modules the extract finds them in, and K6 and K7
    (:func:`color_twins`)."""
    from dctsvd_tpu_torch.ops import tail_cuda, wm_cuda
    saved = [(wm_cuda, "spectrum_blocks"), (tail_cuda, "presence"),
             (tail_cuda, "tail_front"), (tail_cuda, "normalize_blocks")]
    kernels_ = [getattr(m, n) for m, n in saved]
    try:
        for m, n in saved:
            setattr(m, n, getattr(m, f"{n}_plain"))
        with color_twins():
            yield
    finally:
        for (m, n), fn in zip(saved, kernels_):
            setattr(m, n, fn)


def eager_request(stego, sc, uw, vwt, inv_blk, inv_intra, sw, gray: bool):
    """The request extract as the port ran it before K18 and K8u
    (models/blocked.py::extract_gray / extract_color before them), written
    out: K1's spectrum, the raw estimate, the eager statistic and the
    shrinkage step, the masked slot gather, the two products, the IDCT to
    the plane, _masked_normalize, the clip and the cast."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import color, dct, tail_cuda
    h, w = stego.shape[-3], stego.shape[-2]
    hp, wp = h + (-h) % 8, w + (-w) % 8
    s_cw = (blocked._plane_spectrum(color.luma_f32(stego), SWEEPS) if gray
            else blocked._frames_spectrum(stego, SWEEPS))
    raw = blocked._raw_estimate(s_cw, sc, ALPHA)
    est, bad = tail_cuda.shrink_estimate(raw, sw, blocked._sw_scale(sw),
                                         eager_engaged(raw, sw), K)
    est = torch.where(torch.arange(8, device=raw.device) < K, est, 0.0)
    sw_nat = est.index_select(-2, inv_blk)
    wm_blocks = torch.einsum("...nij,...nj,...njk->...nik", uw, sw_nat, vwt)
    wy = dct.idct2_blocks_to_plane(wm_blocks, hp, wp,
                                   row_perm=inv_intra)[..., :h, :w]
    wy = blocked._masked_normalize(wy, bad.index_select(-1, inv_blk), hp,
                                   wp, h, w, True).clamp(0, 255)
    return (wy if gray else torch.movedim(wy, -3, -1)).to(torch.uint8)


def eager_unaligned_tail(blocks, x, h, w):
    """The unaligned default tail's normaliser as the port ran it before
    K8u: the unblockify and crop, _masked_normalize, the clip, the cast
    and the channel move (color frames)."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import dct
    hp, wp = h + (-h) % 8, w + (-w) % 8
    b = blocks.reshape(*blocks.shape[:-1], 8, 8)
    wy = dct.unblockify(b, hp, wp)[..., :h, :w]
    wy = blocked._masked_normalize(wy, x[..., K] > 0.5, hp, wp, h, w, True)
    return torch.movedim(wy.clamp(0, 255).to(torch.uint8), -3, -1)


def counted_extract(fn):
    """(fn(), launches of :func:`request_wrappers`, eager calls): the
    counters set to 0 just before, read just after."""
    import torch
    wr = request_wrappers()
    with eager_normaliser_calls() as eager_calls:
        torch.cuda.synchronize()
        for w_ in wr.values():
            w_.launches = 0
        out = fn()
        torch.cuda.synchronize()
        n = {name: w_.launches for name, w_ in wr.items()}
    return out, n, dict(eager_calls)


def expect_extract(what: str, n: dict, calls: dict, crop, gray: bool) -> None:
    """The launches of one extract: K1, K18, K5f once, K8 once (K8u's
    instance ``crop`` where the size is not a multiple of 8, else None and
    no K8u), K6 once for gray; no eager normaliser or statistic call."""
    want = dict(spectrum_blocks=1, presence=1, tail_front=1,
                normalize_blocks=1,
                **{c.__name__: int(c.instance == f"crop_{crop}")
                   for c in K8U_INSTANCES})
    if gray:
        want["luma_f32"] = 1
    got = {k: n[k] for k in want}
    require(got == want, f"{what}: launches {got}, expected {want}")
    require(not any(calls.values()), f"{what}: eager calls {calls}")


def phase_request_extract(dev, covers, wm_u8):
    """The request extract (models/blocked.py::extract_array, what
    api.extract, the CLI, the GUI and the payloads run) on a 1080p color
    and gray stego embedded by embed_paths from the first cover, and on
    its 1079x1917 and 480x854 crops (K8u's resident and two-pass
    instances, as the plan picks them), each read back from its PNG and
    meta: the stego,
    the stego with three quadrants zeroed (flagged blocks) and the clean
    cover (mark-free). Each call, counted alone, launches K1, K18, K5f and
    K8 (K8u on the crop) once and calls neither _masked_normalize nor
    K18's twin nor metrics.nc; its bytes equal the same call with every
    twin in its kernel's place (:func:`extract_twins`) and the eager form
    it replaced (:func:`eager_request`); K18's decision equals the eager
    statistic's (:func:`eager_engaged`, outside the counted calls). Then
    the prepared extract (extract_color_prepared) of the batch of 32 cut
    to 1079x1917 likewise (K8u on the main path's product), both tail
    forms, a frame the same alone, in a shard and in the batch. Returns
    (launches by layout, K8u's kernel row)."""
    import numpy as np
    import torch
    from dctsvd_tpu_torch.io import image_io, meta as metaio
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import color, dct, metrics, tail_cuda
    from dctsvd_tpu_torch.utils import crypto

    cover_np = covers[0].cpu().numpy()
    wm_np = wm_u8.cpu().numpy()
    rows, totals = {}, {"color": {}, "gray": {}}
    nonces = iter(np.random.default_rng(REQUEST_SEED).bytes(
        crypto.NONCE_BYTES) for _ in range(2 * len(REQUEST_SIZES)))

    def add(layout, n):
        for k, v in n.items():
            totals[layout][k] = totals[layout].get(k, 0) + v

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as td:
        for size, (h, w) in REQUEST_SIZES.items():
            for layout in ("color", "gray"):
                gray = layout == "gray"
                crop = crop_instance(dev, 1, 1 if gray else 3, h, w)
                require(crop == {"1080p": None, "1079x1917": "resident",
                                 "480x854": "two_pass"}[size],
                        f"request {size} {layout}: K8u's plan {crop}")
                nonce = next(nonces)
                key = crypto.derive_key(PASSWORD, nonce)
                sp, mp, _, _ = blocked.embed_paths(
                    cover_np[:h, :w], wm_np[:h, :w],
                    os.path.join(td, f"s_{size}_{layout}.png"),
                    os.path.join(td, f"m_{size}_{layout}"), alpha=ALPHA,
                    color=not gray, key=key, nonce=nonce, kfrac=0.6,
                    device=dev)
                meta = metaio.load_meta(mp)
                stego = image_io.read_bgr(sp)
                zeroed = stego.copy()
                zeroed[h // 2:] = 0
                zeroed[:, w // 2:] = 0
                blk, intra = blocked._indices(key, h, w, dev)
                inv_blk, inv_intra = torch.argsort(blk), torch.argsort(intra)
                sc, uw, vwt, sw = (torch.as_tensor(meta.arrays[a],
                                                   device=dev)
                                   for a in ("Sc", "Uw", "Vwt", "Sw"))
                ref_wm = wm_u8[:h, :w].contiguous()
                if gray:
                    ref_wm = color.bgr_to_gray(ref_wm)
                for case, img in (("stego", stego), ("zeroed", zeroed),
                                  ("clean", cover_np[:h, :w])):
                    what = f"request {size} {layout} {case}"
                    got, n, calls = counted_extract(
                        lambda: blocked.extract_array(img, meta, key,
                                                      device=dev))
                    expect_extract(what, n, calls, crop, gray)
                    add(layout, n)
                    with extract_twins():
                        twin = blocked.extract_array(img, meta, key,
                                                     device=dev)
                    require(np.array_equal(got, twin),
                            f"{what}: differs with the twins "
                            f"({int((got != twin).sum())} bytes)")
                    img_t = torch.as_tensor(np.ascontiguousarray(img),
                                            device=dev)
                    eager = eager_request(img_t, sc, uw, vwt, inv_blk,
                                          inv_intra, sw, gray).cpu().numpy()
                    require(np.array_equal(got, eager),
                            f"{what}: differs from the eager form "
                            f"({int((got != eager).sum())} bytes)")
                    s_cw = (blocked._plane_spectrum(color.luma_f32(img_t),
                                                    SWEEPS) if gray
                            else blocked._frames_spectrum(img_t, SWEEPS))
                    engage, rho0 = tail_cuda.presence(
                        s_cw, sw, sc, blocked._alpha(ALPHA, dev))
                    e_eager = eager_engaged(
                        blocked._raw_estimate(s_cw, sc, ALPHA), sw)
                    require(torch.equal(engage, e_eager),
                            f"{what}: K18's decision {engage.tolist()} vs "
                            f"the eager statistic's {e_eager.tolist()}")
                    nc = float(metrics.nc(
                        torch.as_tensor(got, device=dev).reshape(1, -1)
                        .float(), ref_wm.reshape(-1).float())[0])
                    rows[f"{size}_{layout}_{case}"] = dict(
                        shape=list(got.shape), launches={
                            k: v for k, v in n.items() if v},
                        engaged=engage.reshape(-1).tolist(),
                        rho0=rho0.reshape(-1).tolist(), nc=nc,
                        equals_twins=True, equals_eager=True,
                        sha256=hashlib.sha256(got.tobytes()).hexdigest())
                    if case == "stego":
                        require(bool(engage.all()) and nc > 0.4,
                                f"{what}: engaged {engage.tolist()}, NC {nc}")
                    elif case == "clean":
                        require(not bool(engage.any()),
                                f"{what}: a mark-free cover engaged")
        # the block-layout IDCT against the plane form on the card
        pw = blocked.prepare_wm_color(wm_u8, *(torch.as_tensor(
            a, device=dev) for a in crypto.block_permutation_indices(
                crypto.derive_key(PASSWORD, bytes(8)),
                blocked.n_blocks_of(H, W))))
        coefs = torch.einsum("...nij,...nj,...njk->...nik", pw.uw,
                             pw.sw, pw.vwt)
        plane = dct.idct2_blocks_to_plane(coefs, H, W,
                                          row_perm=pw.inv_intra)
        pix = dct.idct2_pixel_blocks(coefs, H, W, row_perm=pw.inv_intra)
        require(torch.equal(dct.unblockify(pix.reshape(*pix.shape[:-1], 8,
                                                       8), H, W), plane),
                "the block-layout IDCT differs from the plane form")
    prepared, k8u_rows, n_prep = prepared_unaligned(dev, covers, wm_u8)
    add("color", n_prep)
    emit({"phase": "request_extract", "extracts": rows,
          "block_layout_idct_equals_plane": True,
          "prepared_1079x1917": prepared, "launches": totals,
          "card": smi_line()})
    return totals, k8u_rows


def prepared_unaligned(dev, covers, wm_u8):
    """extract_color_prepared on the batch of 32 cut to 1079x1917 (the
    default tail: K1, K18, K5f, the product, K8u), counted alone: its
    launches, no eager call, its bytes with every twin in its kernel's
    place and with recompute=True (the same materialising form at an
    unaligned size), a frame alone, in a shard of 4 and in the batch, and
    K18's decision equal to the eager statistic's on every frame of the
    stego and of the three-quadrants-zeroed stego. Returns (its row, K8u's
    kernel rows on the extract's product, the launches)."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import metrics, tail_cuda
    from dctsvd_tpu_torch.utils import crypto
    h, w = REQUEST_SIZES["1079x1917"]
    key = crypto.derive_key(PASSWORD, bytes(8))
    blk, intra = (torch.as_tensor(a, device=dev) for a in
                  crypto.block_permutation_indices(
                      key, blocked.n_blocks_of(h, w)))
    pw = blocked.prepare_wm_color(wm_u8[:h, :w], blk, intra)
    st, sc = blocked.embed_color_prepared(covers[:, :h, :w], pw.sw, ALPHA,
                                          with_metrics=False)[:2]
    zeroed = st.clone()
    zeroed[:, h // 2:] = 0
    zeroed[:, :, w // 2:] = 0

    def extract(stego, sc_=sc, **kw):
        return blocked.extract_color_prepared(stego, sc_, pw.ebasis,
                                              pw.inv_blk, ALPHA, sw=pw.sw,
                                              **kw)

    out, total = {}, {}
    crop = crop_instance(dev, BATCH, 3, h, w)
    require(crop == "resident", f"prepared 1079x1917: K8u's plan {crop}")
    for case, stego in (("stego", st), ("zeroed", zeroed)):
        what = f"prepared 1079x1917 {case}"
        got, n, calls = counted_extract(lambda: extract(stego))
        expect_extract(what, n, calls, crop, False)
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        with extract_twins():
            require(torch.equal(extract(stego), got),
                    f"{what}: differs with the twins")
        require(torch.equal(extract(stego, recompute=True), got),
                f"{what}: recompute=True differs")
        for a, b in ((0, 1), (BATCH - 1, BATCH), (4, 8)):
            require(torch.equal(extract(stego[a:b], sc[a:b]), got[a:b]),
                    f"{what}: frames {a}:{b} differ alone or in a shard")
        s_cw = blocked._frames_spectrum(stego, SWEEPS)
        engage, _ = tail_cuda.presence(s_cw, pw.sw, sc,
                                       blocked._alpha(ALPHA, dev))
        e_eager = eager_engaged(blocked._raw_estimate(s_cw, sc, ALPHA),
                                pw.sw)
        require(torch.equal(engage, e_eager),
                f"{what}: K18's decision differs from the eager "
                f"statistic's on {int((engage != e_eager).sum())} planes")
        nc = metrics.nc(got.reshape(BATCH, -1).float(),
                        wm_u8[:h, :w].reshape(-1).float())
        out[case] = dict(launches={k: v for k, v in n.items() if v},
                         engaged_share=float(engage.float().mean()),
                         nc_min=float(nc.min()), equals_twins=True,
                         equals_recompute=True, batch_invariant=True)
    require(out["stego"]["engaged_share"] == 1.0
            and out["stego"]["nc_min"] > 0.4,
            f"prepared 1079x1917: {out['stego']}")
    return out, k8u_rows(dev, pw, sc, st, zeroed, h, w), total


def k8u_rows(dev, pw, sc, st, zeroed, h, w) -> dict:
    """K8u's two instances, each forced by its plan, against their plain
    twin run on the card (torch.equal) on the unaligned prepared extract's
    product (models/blocked._recon of K5f's estimates of the batch of 32 at
    1079x1917 color; the stego and the three-quadrants-zeroed stego, whose
    flagged blocks they repaint), without normalize and with f32 output
    too, beside the eager form they replaced (:func:`eager_unaligned_tail`,
    byte-equal). Returns {"resident": its row, "two_pass": its row}. ms:
    the instance on the stego; plain_ms: the twin; eager_ms: the eager
    form; device_ms: its kernels' device time (profiler); ptxas: its u8
    kernels' registers and spills; bound_ms counts the product's padded
    frames, the flags (4 bytes a block) and the cropped output once,
    two_pass_bound_ms the product and flags read in each pass."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import tail_cuda
    eb = pw.ebasis[..., :K, :, :]
    eb64 = eb.reshape(*eb.shape[:-2], 64)
    sms, smem, coop = tail_cuda.device_limits(dev)
    plans = {"resident": tail_cuda.shape_plan(BATCH, 3, h, w, True, sms,
                                              smem if coop else 0),
             "two_pass": tail_cuda.NormPlan("two_pass")}
    require(plans["resident"].instance == "resident",
            f"K8u at {h}x{w}: the plan {plans['resident']}")
    counters = {c.instance: c for c in K8U_INSTANCES}
    checks = {inst: {} for inst in plans}
    for case, stego in (("stego", st), ("three_quadrants_zeroed", zeroed)):
        x = blocked._tail_front(blocked._frames_spectrum(stego, SWEEPS), sc,
                                pw.inv_blk, ALPHA, K, pw.sw)
        blocks = blocked._recon(x[..., :K], eb64)
        eager = eager_unaligned_tail(blocks, x, h, w)
        for kw_name, kw in (("u8", {}), ("no_normalize",
                                         {"normalize": False}),
                            ("f32", {"out_u8": False})):
            py = tail_cuda.normalize_blocks_plain(blocks, x, K, h, w,
                                                  to_frames=True, **kw)
            for inst, plan in plans.items():
                counter = counters["crop_" + inst]
                n0 = counter.launches
                y = tail_cuda.normalize_blocks(blocks, x, K, h, w,
                                               to_frames=True, plan=plan,
                                               **kw)
                torch.cuda.synchronize()
                require(counter.launches == n0 + 1,
                        f"K8u {inst} {case} {kw_name}: not launched")
                d = float((y.float() - py.float()).abs().max())
                require(torch.equal(y, py), f"K8u {inst} {case} {kw_name} "
                        f"vs twin: |d| max {d}")
                row = dict(max_abs_err=d, equals_twin=True,
                           flagged_share=float((x[..., K] > 0.5).float()
                                               .mean()))
                if not kw:
                    require(torch.equal(y, eager), f"K8u {inst} {case}: "
                            "differs from the eager form")
                    row["equals_eager"] = True
                checks[inst][f"{case}_{kw_name}"] = row
        if case == "stego":
            args = (blocks, x)
    require(all(0 < c["three_quadrants_zeroed_u8"]["flagged_share"] < 1
                for c in checks.values()),
            f"K8u: the zeroed quadrants flagged no block or all {checks}")
    blocks, x = args
    y = tail_cuda.normalize_blocks_plain(blocks, x, K, h, w, to_frames=True)
    recon_bytes = x[..., 0].numel() * 64 * 4
    flag_bytes = x[..., 0].numel() * 4
    plain_ms = cuda_time(lambda: tail_cuda.normalize_blocks_plain(
        blocks, x, K, h, w, to_frames=True), 3)
    eager_ms = cuda_time(lambda: eager_unaligned_tail(blocks, x, h, w), 10)
    rows = {}
    for inst, plan in plans.items():
        def k8u(plan=plan):
            return tail_cuda.normalize_blocks(blocks, x, K, h, w,
                                              to_frames=True, plan=plan)
        rows[inst] = dict(
            instance=f"{inst}_crop", plan=str(plan), smem_bytes=plan.smem,
            ptxas=k8_ptxas(inst, False, crop=True), layout="frames",
            shape=list(x.shape[:-1]) + [64], out_shape=list(y.shape),
            checks=checks[inst], max_abs_err=max(
                c["max_abs_err"] for c in checks[inst].values()),
            equals_twin=True, ms=cuda_time(k8u, 20), plain_ms=plain_ms,
            eager_ms=eager_ms, device_ms=device_ms(k8u, 10, "norm_"),
            library_ms=None,
            two_pass_bytes=2 * (recon_bytes + flag_bytes) + nbytes(y),
            **bound(y.numel(), 4, recon_bytes + flag_bytes + nbytes(y)))
        rows[inst]["two_pass_bound_ms"] = (rows[inst]["two_pass_bytes"]
                                           / PEAK_BYTES * 1e3)
    rows["resident"]["two_pass_ms"] = rows["two_pass"]["ms"]
    return rows


# ---------------------------------------------------------------------------
# K9: the detect statistic
# ---------------------------------------------------------------------------

def eager_band_nc(s_cw, sc, sw, alpha, k, hb, wb, grid=4):
    """The eager detect statistic K9 replaced (models/blocked.py at commit
    83dcf91: _sw_hat, _band_scores' to_bands, metrics.nc, band_scale_damp,
    band_presence_damp, _median_last, and detect_color's channel mean),
    kept here as K9's yardstick: the frame scores [...]."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import metrics
    hat = (torch.clamp((s_cw - sc)[..., :k], min=0.0)
           / torch.clamp(blocked._alpha(alpha, s_cw.device), min=1e-8))
    ref = sw[..., :k].expand(hat.shape)
    *lead, _, b = hat.shape
    g = max(1, min(grid, hb, wb))
    gh, gw = hb // g, wb // g

    def to_bands(x):
        x = x.reshape(*lead, hb, wb, b)[..., :g * gh, :g * gw, :]
        x = x.reshape(*lead, g, gh, g, gw, b).transpose(-4, -3)
        return x.reshape(*lead, g * g, gh * gw, b)

    sw_b, hat_b = to_bands(ref), to_bands(hat)
    sw_f = sw_b.reshape(*sw_b.shape[:-2], -1)
    hat_f = hat_b.reshape(*hat_b.shape[:-2], -1)
    scores = blocked._median_last(metrics.nc(sw_f, hat_f)
                                  * blocked.band_scale_damp(sw_f, hat_f)
                                  * blocked.band_presence_damp(sw_b, hat_b))
    return scores.mean(dim=-1) if sw.ndim == 3 else scores


def band_ops(k: int) -> int:
    """f32 operations K9 does for a block of a band: per value the
    estimate (3), pass 1's four sums (6) and pass 2's centred sums (8);
    column 0's sums (2 + 8)."""
    return 17 * k + 10


def detect_row(dev, s_cw, sc, sw, clean, steps, detect, name) -> dict:
    """K9 against its plain twin run on the card (torch.equal) on the main
    path's spectra of one layout at 1080p (gray planes or color frames):
    the stego batch of 32 (frame scores and, ``reduce=False``, the band
    scores; grid 2; a shared sc), the clean covers, a clean host (s_cw =
    sc: every score exactly 0) and 128 frames; a frame's score the same
    alone, in a shard of 4 and in the batch; within 1e-5 of the eager form.
    ms: K9 at 32 frames; plain_ms: its twin; eager_ms: the eager form;
    *_128: at 128 frames; detect_ms_N / detect_ms_eager_N: the detect step
    (``detect(stego, sc)``: K6, K1 and the statistic) on the N frames of
    ``steps`` (32 and 128) with K9 and with the eager form in its place.
    bound_ms counts the s_cw and sc rows of the blocks in
    the bands (one 32-byte sector each), sw's once and the scores once."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import detect_cuda

    hb, wb = H // 8, W // 8
    alpha = blocked._alpha(ALPHA, dev)
    s128 = s_cw.repeat(4, *[1] * (s_cw.ndim - 1))
    sc128 = sc.repeat(4, *[1] * (sc.ndim - 1))

    def k9(s_, q_, **kw):
        return detect_cuda.band_scores(s_, q_, sw, alpha, K, hb, wb, **kw)

    def twin(s_, q_, **kw):
        return detect_cuda.band_scores_plain(s_, q_, sw, alpha, K, hb, wb,
                                             **kw)

    def check(case, s_, q_, **kw):
        y = k9(s_, q_, **kw)
        require(torch.equal(y, k9(s_, q_, **kw)),
                f"K9 {name} {case}: two runs differ")
        py = twin(s_, q_, **kw)
        d = float((y - py).abs().max())
        require(torch.equal(y, py), f"K9 {name} {case} vs twin: |d| max {d}")
        checks[case] = dict(max_abs_err=d, equals_twin=True,
                            shape=list(y.shape), min=float(y.min()),
                            max=float(y.max()))
        return y

    checks = {}
    y = check("stego", s_cw, sc)
    check("stego_bands", s_cw, sc, reduce=False)
    check("grid_2", s_cw, sc, grid=2)
    check("shared_sc", s_cw, sc[0])
    yc = check("clean_cover", clean, sc)
    yz = check("clean_host", sc, sc)
    check("batch_128", s128, sc128)
    require(not bool(yz.any()), f"K9 {name}: a clean host scores "
            f"{float(yz.abs().max())}, not 0")
    require(float(y.min()) >= DETECT_THRESH
            and float(yc.max()) < DETECT_THRESH,
            f"K9 {name}: stego min {float(y.min())}, clean max "
            f"{float(yc.max())}")
    for a, b in ((0, 1), (BATCH - 1, BATCH), (4, 8)):
        require(torch.equal(k9(s_cw[a:b], sc[a:b]), y[a:b]),
                f"K9 {name}: frames {a}:{b} differ alone or in a shard "
                "from the batch")
    eager = eager_band_nc(s_cw, sc, sw, ALPHA, K, hb, wb)
    eager_err = float((y - eager).abs().max())
    require(eager_err <= 1e-5, f"K9 {name} vs the eager form: {eager_err}")

    def with_eager(fn):
        # the detect step with the eager statistic in K9's place
        def step():
            orig = blocked._band_nc
            blocked._band_nc = lambda s_, q_, w_, a_, k_, hb_, wb_: \
                eager_band_nc(s_, q_, w_, a_, k_, hb_, wb_)
            try:
                return fn()
            finally:
                blocked._band_nc = orig
        return step

    bands = hb // 4 * 4 * (wb // 4 * 4)       # blocks in the 4 x 4 bands
    sw_planes = sw[..., 0, 0].numel()

    def k9_bound(s_):
        planes = s_[..., 0, 0].numel()
        moved = (2 * planes + sw_planes) * bands * 32 + 4 * s_.shape[0]
        return bound(planes * bands, band_ops(K), moved)

    out = dict(
        layout=name, shape=list(s_cw.shape), checks=checks,
        max_abs_err=max(c["max_abs_err"] for c in checks.values()),
        equals_twin=True, batch_invariant=True, vs_eager_max_abs_err=eager_err,
        ms=cuda_time(lambda: k9(s_cw, sc), 20),
        plain_ms=cuda_time(lambda: twin(s_cw, sc), 3),
        eager_ms=cuda_time(lambda: eager_band_nc(s_cw, sc, sw, ALPHA, K, hb,
                                                 wb), 10),
        ms_128=cuda_time(lambda: k9(s128, sc128), 20),
        plain_ms_128=cuda_time(lambda: twin(s128, sc128), 2),
        eager_ms_128=cuda_time(lambda: eager_band_nc(s128, sc128, sw, ALPHA,
                                                     K, hb, wb), 5),
        library_ms=None, **k9_bound(s_cw))
    out["bound_ms_128"] = k9_bound(s128)["bound_ms"]
    for st, q in steps:
        n_frames = st.shape[0]
        out[f"detect_ms_{n_frames}"] = cuda_time(lambda: detect(st, q), 5)
        out[f"detect_ms_eager_{n_frames}"] = cuda_time(
            with_eager(lambda: detect(st, q)), 5)
    return out


def phase_detect(dev, covers, wm_u8, blk, intra):
    """K9 at 1080p (:func:`detect_row`, gray planes and color frames, on the
    batch of 32 and 128 frames), then detect_gray, detect_color,
    serve+score (serve_detect_color_prepared) and a resync chunk of 64
    rolls (gray and color), K9's counter set to 0 just before each and
    read just after: each launches K9 once and calls no eager band
    function (:func:`eager_band_calls`). Returns (the two rows, K9's
    launches on those paths, those of the color ones)."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import color, detect_cuda

    pwg = blocked.prepare_wm_gray(color.bgr_to_gray(wm_u8), blk, intra,
                                  extract_basis=False)
    pwc = blocked.prepare_wm_color(wm_u8, blk, intra, extract_basis=False)
    stg, scg = blocked.embed_gray_prepared(covers, pwg.sw, ALPHA,
                                           with_metrics=False)[:2]
    st, sc = blocked.embed_color_prepared(covers, pwc.sw, ALPHA,
                                          with_metrics=False)[:2]
    rows = {}
    for name, stego, sc_, sw, spectrum, detect in (
            ("band_scores", stg, scg, pwg.sw,
             lambda x: blocked._plane_spectrum(color.luma_f32(x)),
             lambda x, q: blocked.detect_gray(x, q, pwg.sw, ALPHA)),
            ("band_scores_color", st, sc, pwc.sw, blocked._frames_spectrum,
             lambda x, q: blocked.detect_color(x, q, pwc.sw, ALPHA))):
        steps = [(stego, sc_), (stego.repeat(4, 1, 1, 1),
                                sc_.repeat(4, *[1] * (sc_.ndim - 1)))]
        rows[name] = detect_row(dev, spectrum(stego), sc_, sw,
                                spectrum(covers), steps, detect, name)
        del steps
        emit({"phase": "kernel_vs_plain", "kernel": f"K9 {name}",
              **rows[name]})

    shifts = torch.as_tensor(blocked._resync_shifts(blocked.BLOCK, 0)[:64],
                             device=dev)
    paths = {
        "detect_gray": lambda: blocked.detect_gray(stg, scg, pwg.sw, ALPHA),
        "detect_color": lambda: blocked.detect_color(st, sc, pwc.sw, ALPHA),
        "serve_score": lambda: blocked.serve_detect_color_prepared(
            covers, pwc.sw, ALPHA),
        "resync_chunk_gray": lambda: blocked._detect_shift_chunk(
            color.luma_f32(stg[0]), scg[0], pwg.sw, ALPHA, shifts),
        "resync_chunk_color": lambda: blocked._detect_shift_chunk(
            st[0], sc[0], pwc.sw, ALPHA, shifts, color_frames=True)}
    k9 = {}
    with eager_band_calls() as eager_calls:
        for pname, fn in paths.items():
            torch.cuda.synchronize()
            detect_cuda.band_scores.launches = 0
            fn()
            torch.cuda.synchronize()
            k9[pname] = detect_cuda.band_scores.launches
    require(all(n == 1 for n in k9.values()) and not any(eager_calls.values()),
            f"the detect paths: K9 launches {k9}, eager band calls "
            f"{eager_calls}")
    emit({"phase": "detect_1080p", "batch": BATCH,
          "band_scores_launches": k9, "eager_band_calls": eager_calls,
          "card": smi_line()})
    return rows, sum(k9.values()), sum(n for p, n in k9.items()
                                       if "gray" not in p)


# ---------------------------------------------------------------------------
# K6 and K7: the gray scheme's color conversions
# ---------------------------------------------------------------------------

COLOR_SEED = 20261025
COLOR_EDGES = (float("nan"), float("inf"), float("-inf"), -0.0, 254.99998,
               255.99998, 256.0, -1e-30, 1e30)
# each instance's wrapper name: the mangled-name stem of its vector kernel
COLOR_KERNELS = {"luma_f32": "luma_kernelIfLb0ELb1E",
                 "bgr_to_gray": "luma_kernelIhLb1ELb1E",
                 "replace_luma": "replace_luma_kernelILb1E"}


def color_wrappers():
    from dctsvd_tpu_torch.ops import color_cuda
    return {name: getattr(color_cuda, name) for name in COLOR_KERNELS}


def zero_color_counts() -> None:
    """K6's and K7's counters set to 0, the card synchronised first."""
    import torch
    torch.cuda.synchronize()
    for w in color_wrappers().values():
        w.launches = 0


def color_counts() -> dict:
    """K6's and K7's launches since zero_color_counts, the card
    synchronised first."""
    import torch
    torch.cuda.synchronize()
    return {name: w.launches for name, w in color_wrappers().items()}


@contextlib.contextmanager
def color_twins():
    """The twins of K6 and K7 in the wrappers' places in ops/color_cuda.py,
    whose names ops/color.py calls."""
    from dctsvd_tpu_torch.ops import color_cuda
    saved = color_wrappers()
    try:
        for name in saved:
            setattr(color_cuda, name, getattr(color_cuda, f"{name}_plain"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(color_cuda, name, fn)


def color_luma(dev, shape, seed):
    """Seeded f32 Y' around the u8 range and past both ends, the edge
    values in the first columns of every 512th row (row 0 among them)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn(shape, generator=gen, device=dev) * 90 + 128
    y[..., ::512, :len(COLOR_EDGES)] = torch.tensor(COLOR_EDGES, device=dev)
    return y


def phase_color(dev, covers, wm_u8, blk, intra):
    """K6 (luma_f32, bgr_to_gray) and K7 (replace_luma) against their
    twins run on the card, torch.equal, on (a) a 4096x4096 frame of all
    2^24 BGR triples, (b) K7 with seeded Y' over it and the edge values
    (NaN, ±inf, −0.0, the truncation's edges), (c) the 32 1080p covers,
    (d) a 1079x1917 frame and a view one pixel into a frame (both the
    scalar path); each instance timed at (c) beside its twin and its
    bytes bound. Then the gray slice at batch 32 (prepare -> embed with
    metrics -> extract -> detect), K6's and K7's counters set to 0 just
    before and read just after, and the same slice with the twins in the
    kernels' places: every output byte-equal; the gray embed+extract
    step's frames/s through each. Returns (kernel rows, the slice's
    launches)."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import color, color_cuda, metrics
    from dctsvd_tpu_torch.utils import kernels

    t0 = time.perf_counter()
    v = torch.arange(1 << 24, device=dev, dtype=torch.int32)
    table = torch.stack([v & 255, (v >> 8) & 255, v >> 16], -1).to(
        torch.uint8).reshape(4096, 4096, 3)
    del v
    odd = covers[0, :1079, :1917].contiguous()
    shifted = covers.reshape(-1)[3:3 + H * W * 3].view(H, W, 3)
    inputs = {"all_triples": table, "frames_1080p": covers,
              "odd_1079x1917": odd, "pixel_offset": shifted}
    lumas = {name: color_luma(dev, x.shape[:-1], COLOR_SEED + i)
             for i, (name, x) in enumerate(inputs.items())}
    checks = {}
    for fn in COLOR_KERNELS:
        wrapper = getattr(color_cuda, fn)
        twin = getattr(color_cuda, f"{fn}_plain")
        checks[fn] = {}
        for name, x in inputs.items():
            args = (lumas[name], x) if fn == "replace_luma" else (x,)
            ptrs = [a.data_ptr() for a in args] + [0]
            vector, _ = color_cuda.color_plan(
                fn, x.shape[-3] * x.shape[-2], *ptrs)
            require(vector == (name in ("all_triples", "frames_1080p")),
                    f"{fn} on {name}: the {'vector' if vector else 'scalar'}"
                    " path")
            got, ref = wrapper(*args), twin(*args)
            err = float((got.to(torch.float32) - ref.to(torch.float32))
                        .abs().max())
            require(torch.equal(got, ref), f"{fn} on {name} "
                    f"{list(x.shape)}: not bit-equal to its twin ({err})")
            checks[fn][name] = dict(shape=list(x.shape), max_abs_err=err,
                                    vector=vector, equals_twin=True)
    del table, lumas, inputs

    # times at the slice's shape beside the bytes bound (the issue bound,
    # which stays under it, is --color-bounds')
    seconds = {"checks": time.perf_counter() - t0}
    t0 = time.perf_counter()
    y32 = color_luma(dev, covers.shape[:-1], COLOR_SEED + 9)
    ptxas = kernels.ptxas_report(kernels.BUILD_INFO["ptxas"])
    results = {}
    for fn, stem in COLOR_KERNELS.items():
        wrapper = getattr(color_cuda, fn)
        twin = getattr(color_cuda, f"{fn}_plain")
        args = (y32, covers) if fn == "replace_luma" else (covers,)
        out = wrapper(*args)
        moved = nbytes(*args, out)
        results[fn] = dict(
            shape=list(covers.shape), max_abs_err=max(
                r["max_abs_err"] for r in checks[fn].values()),
            ms=cuda_time(lambda: wrapper(*args), 20),
            plain_ms=cuda_time(lambda: twin(*args), 3), library_ms=None,
            bound_ms=moved / PEAK_BYTES * 1e3, bound_by="bytes",
            bytes=moved, checks=checks[fn],
            ptxas={n: v for n, v in ptxas.items() if stem in n})
        kname = "K7" if fn == "replace_luma" else "K6"
        emit({"phase": "kernel_vs_plain", "kernel": f"{kname} {fn}",
              **results[fn]})
    del y32
    seconds["times"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # the gray slice at batch 32 through the kernels, then the twins
    def gray_slice():
        pw = blocked.prepare_wm_gray(color.bgr_to_gray(wm_u8), blk, intra)
        stego, sc, psnr, ssim = blocked.embed_gray_prepared(covers, pw.sw,
                                                            ALPHA)
        rec = blocked.extract_gray_prepared(stego, sc, pw.ebasis,
                                            pw.inv_blk, ALPHA, sw=pw.sw)
        return dict(stego=stego, sc=sc, psnr=psnr, ssim=ssim, rec=rec,
                    scores=blocked.detect_gray(stego, sc, pw.sw, ALPHA),
                    clean=blocked.detect_gray(covers, sc, pw.sw, ALPHA)), pw

    zero_color_counts()
    out, pw = gray_slice()
    launches = color_counts()
    require(all(launches.values()),
            f"K6 or K7 not launched on the gray slice: {launches}")
    wm_gray = color.bgr_to_gray(wm_u8)
    nc = metrics.nc(out["rec"].reshape(BATCH, -1).to(torch.float32),
                    wm_gray.reshape(-1).to(torch.float32))
    require(out["stego"].shape == covers.shape
            and out["rec"].shape == covers.shape[:-1], "gray slice shapes")
    require(float(out["psnr"].min()) > 20.0, f"gray psnr {out['psnr']}")
    require(float(out["scores"].min()) >= DETECT_THRESH
            and float(out["clean"].max()) < DETECT_THRESH,
            f"gray detect {float(out['scores'].min())}, clean "
            f"{float(out['clean'].max())}")
    require(float(nc.min()) > 0.4, f"gray extraction NC {float(nc.min())}")

    def step():
        st, sc_ = blocked.embed_gray_prepared(covers, pw.sw, ALPHA,
                                              with_metrics=False)[:2]
        return blocked.extract_gray_prepared(st, sc_, pw.ebasis, pw.inv_blk,
                                             ALPHA, sw=pw.sw)

    def fps() -> float:
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        return BATCH * 5 / (time.perf_counter() - t0)

    fps_kernels = fps()
    with color_twins():
        twin_out, _ = gray_slice()
        fps_twins = fps()
    for name, got in out.items():
        require(torch.equal(got, twin_out[name]), f"gray slice {name}: "
                "differs with K6's and K7's twins in their places")
    seconds["slice"] = time.perf_counter() - t0
    emit({"phase": "color_1080p", "batch": BATCH, "launches": launches,
          "seconds": seconds,
          "gray_slice": dict(psnr_min=float(out["psnr"].min()),
                             ssim_min=float(out["ssim"].min()),
                             detect_min=float(out["scores"].min()),
                             clean_max=float(out["clean"].max()),
                             extract_nc_min=float(nc.min()),
                             bytes_equal_with_twins=sorted(out)),
          "gray_embed_extract_fps": dict(kernels=fps_kernels,
                                         twins=fps_twins),
          "card": smi_line()})
    return results, launches



def color_bounds(dev, covers) -> dict:
    """K6's and K7's issue bound at the 32 1080p covers: the SASS
    instructions of a thread of 4 pixels (the vector instance's body, read
    from the library that runs) at one a lane a clock, at the SM clock read
    while K7 runs; beside each instance's ms and bytes bound."""
    from dctsvd_tpu_torch.ops import color_cuda
    from dctsvd_tpu_torch.utils import kernels

    sass = kernels.sass_mix(kernels.sass_dump(kernels.BUILD_INFO["path"]), 2)
    y32 = color_luma(dev, covers.shape[:-1], COLOR_SEED + 9)
    _, clocks = clocked_ms(lambda: color_cuda.replace_luma(y32, covers),
                           1500)
    pix = covers.numel() // 3
    rows = {}
    for fn, stem in COLOR_KERNELS.items():
        wrapper = getattr(color_cuda, fn)
        args = (y32, covers) if fn == "replace_luma" else (covers,)
        mangled = [n for n in sass if stem in n]
        require(len(mangled) == 1, f"{fn}: SASS of {stem} {mangled}")
        mix = sass[mangled[0]]["main"]
        rows[fn] = dict(
            kernel=mangled[0], sass_per_thread=mix,
            issue_bound_ms=insn_bound_ms(sum(mix.values()) * pix / 4,
                                         clocks["sm_mhz"]),
            bytes_ms=nbytes(*args, wrapper(*args)) / PEAK_BYTES * 1e3,
            ms=cuda_time(lambda: wrapper(*args), 20))
    return dict(shape=list(covers.shape), clocks=clocks, rows=rows)


PROBE_SEED = 20261023
CHAIN_FUSED_TOL = 1e-6   # fused chain vs its float64 twin, x max |twin|:
                         # the twin rounds twice where the FMA rounds once,
                         # which moves about one update in 2^29 by an ulp


SM_F32_LANES = 128       # f32 lanes an SM of the H100 (4 x 32 a quadrant)


def smi_clocks() -> dict:
    """The SM clock (MHz) and power draw (W) as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sm, power = (float(v) for v in out.split(","))
    return dict(sm_mhz=sm, power_w=power)


def clocked_ms(fn, reps: int) -> tuple:
    """(mean ms of fn over reps calls between two CUDA events after a
    warm-up, nvidia-smi's SM clock and power draw read while those calls
    run). The calls are queued before nvidia-smi starts, so with a window
    of a few hundred ms the sample falls inside it; ``in_window`` says
    whether it did (the window had not ended when the sample returned)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    clocks = smi_clocks()
    clocks["in_window"] = not stop.query()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, clocks


def insn_bound_ms(instructions: float, sm_mhz: float) -> float:
    """The instruction bound: the least time the card's f32 lanes take to
    run ``instructions`` f32 instructions at one a lane a clock (an FMA
    counts once): what binds a kernel built -fmad=false, which spends an
    instruction on each multiply and each add, at the SM clock read in
    the run."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return instructions / (sms * SM_F32_LANES * sm_mhz * 1e6) * 1e3


def chain_instructions(mode: str, n_ops: int, fused: bool = False) -> int:
    """f32 instructions an element of fma_chain: ilp8's 8 initial products,
    one FMUL and one FADD (fused: one FFMA) an update, and the 7 adds that
    sum the chains; serial's updates."""
    from dctsvd_tpu_torch.ops import probe_cuda
    steps, _ = probe_cuda.chain_steps(mode, n_ops)
    per_update = 1 if fused else 2
    if mode == "ilp8":
        return 8 + 8 * steps * per_update + 7
    return steps * per_update


def permuted(planes):
    """The cols view of natural planes [P, H, W] as a strided view."""
    p = planes.shape[0]
    return planes.reshape(p, H // 8, 8, W // 8, 8).permute(0, 1, 2, 4, 3)


def copy_times(dev, covers) -> dict:
    """copy_f32 on the probes' 96 f32 planes and the four cols_view
    instances (f32 -> f32 on them, u8 -> u8/bf16/f32 on the covers' 96
    planes), each equal to its twin, each beside its copy_ yardstick (into
    a preallocated output; for cols_view from the permuted view): CUDA
    events, 20 launches a reading, in turns kernel, library, library,
    kernel."""
    import torch
    from dctsvd_tpu_torch.ops import probe_cuda

    def turns(kernel, library, moved):
        k1, l1 = cuda_time(kernel, 20), cuda_time(library, 20)
        l2, k2 = cuda_time(library, 20), cuda_time(kernel, 20)
        return dict(ms=[k1, k2], library_ms=[l1, l2],
                    **bound(0, 0, moved))

    gen = torch.Generator(device=dev).manual_seed(PROBE_SEED)
    planes = torch.randn((3 * BATCH, H, W), generator=gen, device=dev) * 40 \
        + 128                                  # the probes phase's planes
    planes_u8 = torch.movedim(covers, -1, -3).reshape(-1, H, W).contiguous()
    y = probe_cuda.copy_f32(planes)
    require(torch.equal(y, probe_cuda.copy_f32_plain(planes)),
            "copy_f32 vs twin")
    out = torch.empty_like(planes)
    times = {"copy_f32": turns(lambda: probe_cuda.copy_f32(planes),
                               lambda: out.copy_(planes), nbytes(planes, y))}
    del y, out
    for src, d in ((planes, torch.float32), (planes_u8, torch.uint8),
                   (planes_u8, torch.bfloat16), (planes_u8, torch.float32)):
        v = probe_cuda.cols_view(src, d)
        require(torch.equal(v, probe_cuda.cols_view_plain(src, d)),
                f"cols_view {src.dtype} -> {d} vs twin")
        out = torch.empty_like(v)
        name = (f"cols_view {str(src.dtype).split('.')[-1]}->"
                f"{str(d).split('.')[-1]}")
        times[name] = turns(lambda src=src, d=d: probe_cuda.cols_view(src, d),
                            lambda src=src, out=out: out.copy_(permuted(src)),
                            nbytes(src, v))
        del v, out
    return times


def load_parent_kernels(root: str):
    """utils/kernels.py of another checkout of the repository at ``root``
    (an older tree unpacked under build/), loaded as a module of its own
    and built from that tree's csrc/ into that tree's build/: its
    ``launch`` calls the older tree's C entry points."""
    import importlib.util
    path = os.path.join(root, "dctsvd_tpu_torch", "utils", "kernels.py")
    spec = importlib.util.spec_from_file_location("parent_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.load()
    return mod


def probe_instance(mix: dict, stem: str, prefer: tuple):
    """The mangled name in ``mix`` of a probe kernel's instance: the one
    holding ``stem``, and among several the first holding ``stem + p``
    for p in ``prefer``."""
    found = [n for n in mix if stem in n]
    for p in prefer:
        best = [n for n in found if stem + p in n]
        if best:
            return best[0]
    return found[0] if len(found) == 1 else None


def probe_sass(kern, stems) -> dict:
    """{mangled name: {"main", "sweep"}} of the spectrum probe's and
    fma_chain's instances in the library ``kern`` built."""
    mix = kern.sass_mix(kern.sass_dump(kern.BUILD_INFO["path"]), 2)
    return {n: {k: m[k] for k in ("main", "sweep")} for n, m in mix.items()
            if any(st in n for st in stems)}


def per_lane(mix_row: dict, loops) -> dict:
    """What one lane executes when the kernel's one loop runs ``loops``
    times: the body once in "main", then ``loops`` - 1 more; "main" alone
    for a kernel without a loop; None where the loop's count is not known
    (``loops`` None: fma_chain's run-time loop, unrolled by 4 or 8)."""
    if not mix_row["sweep"]:
        return mix_row["main"]
    if loops is None:
        return None
    return {k: v + mix_row["sweep"].get(k, 0) * (loops - 1)
            for k, v in mix_row["main"].items()}


def sass_functions(sass: str) -> dict:
    """{mangled name: its SASS text} of cuobjdump -sass output, runs of
    blanks made one (cuobjdump pads its columns to the widest line of the
    whole object)."""
    import re
    return {part.split(None, 1)[0]: re.sub(r"[ \t]+", " ",
                                           part.split("\n", 1)[1])
            for part in sass.split("Function : ")[1:]}


def probe_times(dev, covers, parent: str = None) -> dict:
    """Every spectrum_probe instance at the probes' shapes (T1 strided and
    smem on the 96 f32 planes at s3; T6a on their f32 cols view at s4; T4
    on the covers' 96 u8 planes as u8, bf16 and f32 views at s0 and s2;
    T5 cached at s2 with its relayout and alone) and fma_chain (ilp8 and
    serial, unfused and fused, at the tool's lengths 256 and 1024 and at
    96, a length that runs the loop), each checked against its twin run on
    the card (bit-equal; fused within CHAIN_FUSED_TOL), then timed with
    CUDA events, 20 launches a reading: with ``parent`` (the root of an
    older checkout) in turns parent, this tree, this tree, parent, each
    tree through its own C entry point and library. Beside each time: the
    bound (ops / 67e12 or bytes / 3.35e12) and the instruction bound (the f32
    operations, or fma_chain's f32 instructions, at one a lane a clock at
    the SM clock read beside T3's window), each instance's registers and
    spills (when the run built the library) and its SASS mix for one
    lane."""
    import torch
    from dctsvd_tpu_torch.ops import dct, probe_cuda, wm_cuda
    from dctsvd_tpu_torch.utils import kernels

    trees = {"change": kernels}
    if parent:
        trees["parent"] = load_parent_kernels(parent)
    stems = ("spectrum_probe_kernel", "fma_chain_kernel")
    info = {}
    for name, kern in trees.items():
        info[name] = dict(
            ptxas={k: v for k, v in kern.ptxas_report(
                kern.BUILD_INFO["ptxas"]).items()
                if any(st in k for st in stems)},
            sass=probe_sass(kern, stems))
    if parent:
        # every other kernel compiles to the same SASS in both trees
        fa, fb = (sass_functions(k.sass_dump(k.BUILD_INFO["path"]))
                  for k in (kernels, trees["parent"]))
        others = sorted(n for n in set(fa) | set(fb)
                        if not any(st in n for st in stems))
        info["other_kernels_same_sass"] = [n for n in others
                                           if fa.get(n) == fb.get(n)]
        info["other_kernels_sass_differs"] = [n for n in others
                                              if fa.get(n) != fb.get(n)]

    gen = torch.Generator(device=dev).manual_seed(PROBE_SEED)
    planes = torch.randn((3 * BATCH, H, W), generator=gen, device=dev) * 40 \
        + 128                                  # the probes phase's planes
    planes_u8 = torch.movedim(covers, -1, -3).reshape(-1, H, W).contiguous()
    view = probe_cuda.cols_view(planes)
    views_u8 = {d: probe_cuda.cols_view(planes_u8, d)
                for d in (torch.uint8, torch.bfloat16, torch.float32)}
    x = torch.randn((3 * BATCH, H // 8, 8, W // 8), generator=gen,
                    device=dev)
    blocks = planes.numel() // 64
    tcode = {torch.uint8: "h", torch.bfloat16: "13__nv_bfloat16",
             torch.float32: "f"}

    def spectrum_call(kern, xin, sweeps, layout, cached):
        p, h, w = probe_cuda._probe_shape(xin, layout)
        out = torch.empty(p, (h // 8) * (w // 8), 8, device=dev)

        def call():
            kern.launch("dctsvd_spectrum_probe", dev, xin,
                        probe_cuda._KIND[xin.dtype],
                        probe_cuda.LAYOUTS.index(layout), int(cached), out,
                        p, h, w, sweeps)
            return out
        return call

    def chain_call(kern, n_ops, mode, fused):
        y = torch.empty_like(x)
        steps, _ = probe_cuda.chain_steps(mode, n_ops)

        def call():
            kern.launch("dctsvd_fma_chain", dev, x, y, x.numel(), steps,
                        int(mode == "ilp8"), int(fused))
            return y
        return call

    # name: (call(kern), twin(), tolerance x max|twin| or None for equal,
    # bound, f32 operations (the instruction bound's count), SASS stem and the
    # preferred instance, loops of the instance's one loop)
    cases = {}
    spectra = [("T1 strided f32 s3", planes, 3, "strided", False),
               ("T1 smem f32 s3", planes, 3, "smem", False),
               ("T6a cols f32 s4", view, 4, "cols", False)]
    for d, v in views_u8.items():
        for sw in (0, 2):
            spectra.append((f"T4 cols {str(d).split('.')[-1]} s{sw}", v, sw,
                            "cols", False))
    spectra.append(("T5 cached s2, spectrum alone", view, 2, "cols", True))
    for name, xin, sw, layout, cached in spectra:
        pairs = sw * len(wm_cuda.PAIRS)
        # cached: 8 square roots of the cached norms for the 8 final dots
        ops = (8 * DOT + pairs * PAIR + 8 if cached else jacobi_ops(pairs))
        cases[name] = (
            lambda kern, a=(xin, sw, layout, cached): spectrum_call(kern, *a),
            lambda a=(xin, sw, layout, cached): probe_cuda.spectrum_probe_plain(
                *a), None,
            bound(blocks, ops, nbytes(xin) + blocks * 32), blocks * ops,
            (f"spectrum_probe_kernelILi{probe_cuda.LAYOUTS.index(layout)}E"
             f"{tcode[xin.dtype]}Lb{int(cached)}E", ("Li1E",)), sw)

    def t5_call(kern):
        def call():
            v = probe_cuda.cols_view(planes)
            return spectrum_call(kern, v, 2, "cols", True)()
        return call
    relayout = bound(0, 0, 2 * nbytes(planes))
    spectrum5 = cases["T5 cached s2, spectrum alone"][3]
    cases["T5 cached s2 with its relayout"] = (
        t5_call, lambda: probe_cuda.spectrum_probe_plain(view, 2, "cols",
                                                         True), None,
        dict(bound_ms=relayout["bound_ms"] + spectrum5["bound_ms"],
             bound_by="bytes (relayout) + " + spectrum5["bound_by"]
             + " (spectrum)"),
        cases["T5 cached s2, spectrum alone"][4],
        cases["T5 cached s2, spectrum alone"][5], 2)
    for mode in probe_cuda.CHAIN_MODES:
        for n_ops in (256, 1024, 96):
            for fused in (False, True):
                steps, ops = probe_cuda.chain_steps(mode, n_ops)
                cases[f"T3 {mode} {n_ops} {'fused' if fused else 'unfused'}"
                      ] = (
                    lambda kern, a=(n_ops, mode, fused): chain_call(kern, *a),
                    lambda a=(n_ops, mode, fused): probe_cuda.fma_chain_plain(
                        x, *a), CHAIN_FUSED_TOL if fused else None,
                    bound(x.numel(), ops, 2 * nbytes(x)),
                    x.numel() * chain_instructions(mode, n_ops, fused),
                    (f"fma_chain_kernelILb{int(mode == 'ilp8')}E"
                     f"Lb{int(fused)}E", (f"Li{steps}E", "Li0E")), None)

    # the clock beside T3's window (ilp8, 1024, unfused: the table's row)
    t3 = cases["T3 ilp8 1024 unfused"][0](kernels)
    t3_ms, clocks = clocked_ms(t3, 500)
    rows, bad = {}, []
    for name, (make, twin, tol, bnd, ops, (stem, prefer), loops) in \
            cases.items():
        calls = {tree: make(kern) for tree, kern in trees.items()}
        ref = twin()
        row = {}
        for tree, call in calls.items():
            got = call().clone()
            err = float((got - ref).abs().max())
            ok = (err <= tol * float(ref.abs().max()) if tol is not None
                  else torch.equal(got, ref))
            row[f"{tree}_equals_twin" if tol is None
                else f"{tree}_within_tol"] = ok
            row[f"{tree}_max_abs_err"] = err
            if tree == "change" and not ok:
                bad.append(name)
        del ref, got
        order = (["parent", "change", "change", "parent"] if parent
                 else ["change", "change"])
        ms = {tree: [] for tree in calls}
        for tree in order:
            ms[tree].append(cuda_time(calls[tree], 20))
        for tree in calls:
            row[f"{tree}_ms"] = ms[tree]
            inst = probe_instance(info[tree]["sass"], stem, prefer)
            row[f"{tree}_instance"] = inst
            if inst:
                row[f"{tree}_per_lane"] = per_lane(info[tree]["sass"][inst],
                                                   loops)
                row[f"{tree}_ptxas"] = info[tree]["ptxas"].get(inst)
        ib = insn_bound_ms(ops, clocks["sm_mhz"])
        row.update(bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
                   insn_bound_ms=ib,
                   share_of_bound=bnd["bound_ms"] / min(ms["change"]),
                   share_of_insn_bound=ib / min(ms["change"]))
        rows[name] = row
    out = dict(t3_clocked_ms=t3_ms, clocks=clocks, times=rows,
               sass={tree: info[tree]["sass"] for tree in trees},
               ptxas={tree: info[tree]["ptxas"] for tree in trees})
    if parent:
        out.update(
            other_kernels_same_sass=info["other_kernels_same_sass"],
            other_kernels_sass_differs=info["other_kernels_sass_differs"])
    return out, bad


def phase_probes(dev, covers):
    """The T1-T6 probes of tools/ through their main() at 1080p, batch 32
    (96 planes), with the four probe kernels' launch counters set to 0
    just before and read just after, and every check their rows carry;
    then each probe kernel against its twin at the probes' full shape,
    with its bound and library yardstick, and every spectrum-probe
    instance against K1 on the same integer-valued planes."""
    import torch
    from dctsvd_tpu_torch.ops import dct, probe_cuda, wm_cuda
    from dctsvd_tpu_torch.tools import (exp_cachednorms, exp_relayout,
                                        exp_vpu_roofline, exp_widen,
                                        profile_transpose, profile_view)

    wrappers = [probe_cuda.copy_f32, probe_cuda.cols_view,
                probe_cuda.fma_chain, probe_cuda.spectrum_probe]
    torch.cuda.synchronize()
    for fn in wrappers:
        fn.launches = 0
    t0 = time.perf_counter()
    rows = [r for mod in (exp_relayout, profile_transpose, exp_vpu_roofline,
                          exp_widen, exp_cachednorms, profile_view)
            for r in mod.main()]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in wrappers}
    for name, n in launches.items():
        require(n >= 1, f"{name} was not launched by the probes")
    for r in rows:
        for key, val in r.items():
            if key.startswith("equals_"):
                require(val is True, f"{r['probe']} {r['row']}: {key}")
            elif "max_abs_err" in key:
                require(val == 0.0, f"{r['probe']} {r['row']}: {key} {val}")
    emit({"phase": "probes", "rows": len(rows), "launches": launches,
          "seconds": seconds, "card": smi_line()})
    t3 = next(r for r in rows if r["probe"] == "T3"
              and r["row"] == "ilp8 n_ops=1024 unfused")["elem_ops_per_s"]

    results = {}
    gen = torch.Generator(device=dev).manual_seed(PROBE_SEED)
    n_planes = 3 * BATCH
    planes = torch.randn((n_planes, H, W), generator=gen, device=dev) * 40 \
        + 128

    # copy_f32 (T2a, T6b) on the 96 f32 planes
    y = probe_cuda.copy_f32(planes)
    err = float((y - probe_cuda.copy_f32_plain(planes)).abs().max())
    require(err == 0.0, f"copy_f32 vs twin: {err}")
    out = torch.empty_like(planes)
    results["copy_f32"] = dict(
        shape=list(planes.shape), max_abs_err=err,
        ms=cuda_time(lambda: probe_cuda.copy_f32(planes), 10),
        plain_ms=cuda_time(lambda: probe_cuda.copy_f32_plain(planes), 10),
        library_ms=cuda_time(lambda: out.copy_(planes), 10),
        **bound(0, 0, nbytes(planes, y)))
    del y, out

    # cols_view (T2b) f32 -> f32 on the planes, and u8 -> u8/bf16/f32 on
    # the covers' 96 planes; the library call is copy_ from the permuted
    # view into the target dtype
    view = probe_cuda.cols_view(planes)
    err = float((view - probe_cuda.cols_view_plain(planes)).abs().max())
    require(err == 0.0, f"cols_view f32 vs twin: {err}")
    planes_u8 = torch.movedim(covers, -1, -3).reshape(-1, H, W).contiguous()
    u8_views = {}
    for d in (torch.uint8, torch.bfloat16, torch.float32):
        v = probe_cuda.cols_view(planes_u8, d)
        require(torch.equal(v, probe_cuda.cols_view_plain(planes_u8, d)),
                f"cols_view u8 -> {d} vs twin")
        out = torch.empty_like(v)
        u8_views[str(d).split(".")[-1]] = dict(
            equals_twin=True,
            ms=cuda_time(lambda d=d: probe_cuda.cols_view(planes_u8, d), 10),
            library_ms=cuda_time(
                lambda out=out: out.copy_(permuted(planes_u8)), 10),
            **bound(0, 0, nbytes(planes_u8, v)))
        del v, out
    out = torch.empty_like(view)
    results["cols_view"] = dict(
        shape=list(planes.shape), max_abs_err=err, u8_views=u8_views,
        ms=cuda_time(lambda: probe_cuda.cols_view(planes), 10),
        plain_ms=cuda_time(lambda: probe_cuda.cols_view_plain(planes), 10),
        library_ms=cuda_time(lambda: out.copy_(permuted(planes)), 10),
        **bound(0, 0, nbytes(planes, view)))
    del out

    # fma_chain (T3) on [96, 135, 8, 240], every mode, length and form;
    # the table row is ilp8 at the longer length (1024), unfused
    x = torch.randn((n_planes, H // 8, 8, W // 8), generator=gen, device=dev)
    chain_errs = {}
    for mode in probe_cuda.CHAIN_MODES:
        for n_ops in exp_vpu_roofline.N_OPS:
            for fused in (False, True):
                yk = probe_cuda.fma_chain(x, n_ops, mode, fused)
                yp = probe_cuda.fma_chain_plain(x, n_ops, mode, fused)
                e = float((yk - yp).abs().max())
                tol = CHAIN_FUSED_TOL * float(yp.abs().max()) if fused else 0
                require(e <= tol, f"fma_chain {mode} {n_ops} fused={fused} "
                        f"vs twin: {e} > {tol}")
                chain_errs[f"{mode}_{n_ops}_{'fused' if fused else 'unfused'}"
                           ] = e
    n_ops = exp_vpu_roofline.N_OPS[-1]
    _, ops = probe_cuda.chain_steps("ilp8", n_ops)
    # the SM clock read beside the timed window gives the instruction bound
    ms, clocks = clocked_ms(lambda: probe_cuda.fma_chain(x, n_ops), 500)
    insns = x.numel() * chain_instructions("ilp8", n_ops)
    results["fma_chain"] = dict(
        shape=list(x.shape), mode="ilp8", n_ops=n_ops, fused=False,
        max_abs_err=chain_errs[f"ilp8_{n_ops}_unfused"], errs=chain_errs,
        ms=ms, clocks=clocks, f32_instructions=insns,
        insn_bound_ms=insn_bound_ms(insns, clocks["sm_mhz"]),
        plain_ms=cuda_time(lambda: probe_cuda.fma_chain_plain(x, n_ops), 3),
        library_ms=None, **bound(x.numel(), ops, 2 * nbytes(x)))
    del x, yk, yp

    # spectrum_probe: s0 is the sorted column norms in every instance;
    # every fresh instance equals K1 bit for bit on integer planes at s2,
    # s3, s4; the table row is T6a's (f32 cols view, s4) on the f32 planes
    planes_if = planes_u8.to(torch.float32)
    view_f32 = probe_cuda.cols_view(planes_u8, torch.float32)
    instances = [("strided", planes_if, False), ("smem", planes_if, False),
                 ("cols", probe_cuda.cols_view(planes_u8), False),
                 ("cols", probe_cuda.cols_view(planes_u8, torch.bfloat16),
                  False),
                 ("cols", view_f32, False), ("cols", view_f32, True)]
    s0 = probe_cuda.spectrum_probe_plain(planes_if, 0, "strided")
    for layout, xin, cached in instances:
        require(torch.equal(probe_cuda.spectrum_probe(xin, 0, layout, cached),
                            s0), f"spectrum_probe {layout} {xin.dtype} "
                f"cached={cached} s0 is not the sorted column norms")
    norms = torch.linalg.vector_norm(
        dct.blockify(planes_if[:8]), dim=-2).sort(dim=-1, descending=True)[0]
    s0_err = float((s0[:8] - norms).abs().max() / norms.max())
    require(s0_err <= 1e-6, f"s0 vs vector_norm: {s0_err}")
    for sweeps in (2, 3, 4):
        k1 = wm_cuda.spectrum_blocks(planes_u8, sweeps=sweeps)
        for layout, xin, cached in instances:
            if not cached:
                require(torch.equal(probe_cuda.spectrum_probe(
                    xin, sweeps, layout), k1), f"spectrum_probe {layout} "
                    f"{xin.dtype} s{sweeps} differs from K1")
    del instances, planes_if, view_f32, k1

    sweeps = profile_view.SWEEPS
    view_sp = probe_cuda.spectrum_probe(view, sweeps)
    err = float((view_sp - probe_cuda.spectrum_probe_plain(view, sweeps))
                .abs().max())
    require(err == 0.0, f"spectrum_probe cols f32 s{sweeps} vs twin: {err}")
    for layout, xin, cached in (("strided", planes, False),
                                ("smem", planes, False),
                                ("cols", view, True)):
        e = float((probe_cuda.spectrum_probe(xin, 2, layout, cached)
                   - probe_cuda.spectrum_probe_plain(xin, 2, layout, cached))
                  .abs().max())
        require(e == 0.0, f"spectrum_probe {layout} cached={cached} s2 vs "
                f"twin: {e}")
    blocks = dct.blockify(planes).reshape(-1, 8, 8)
    pairs = sweeps * len(wm_cuda.PAIRS)
    results["spectrum_probe"] = dict(
        shape=list(view.shape), layout="cols", dtype="float32",
        sweeps=sweeps, max_abs_err=err, s0_vs_vector_norm=s0_err,
        equals_k1_s2_s3_s4=True,
        ms=cuda_time(lambda: probe_cuda.spectrum_probe(view, sweeps), 10),
        plain_ms=cuda_time(
            lambda: probe_cuda.spectrum_probe_plain(view, sweeps), 2),
        library_ms=cuda_time(lambda: torch.linalg.svdvals(blocks), 1),
        **bound(blocks.shape[0], jacobi_ops(pairs), nbytes(view, view_sp)))
    results["spectrum_probe"]["insn_bound_ms"] = insn_bound_ms(
        results["spectrum_probe"]["ops"], clocks["sm_mhz"])
    del blocks
    for name, r in results.items():
        emit({"phase": "probe_kernel_vs_plain", "kernel": name, **r,
              "card": smi_line()})
    return launches, results, t3, clocks


def phase_reference(dev):
    """GPU slice vs the CPU twins on one small frame: stego bytes, extracted
    watermark and detect score."""
    import numpy as np
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.utils import crypto

    rng = np.random.default_rng(7)
    h, w = 64, 80
    cover = rng.integers(0, 256, (h, w, 3), np.uint8)
    wm = rng.integers(0, 256, (h, w, 3), np.uint8)
    key = crypto.derive_key(PASSWORD, bytes(8))
    blk, intra = crypto.block_permutation_indices(key,
                                                  blocked.n_blocks_of(h, w))
    got = {}
    for d in ("cpu", dev):
        b, i = torch.as_tensor(blk, device=d), torch.as_tensor(intra,
                                                               device=d)
        pw = blocked.prepare_wm_color(torch.as_tensor(wm, device=d), b, i)
        st, sc, ps, _ = blocked.embed_color_prepared(
            torch.as_tensor(cover, device=d), pw.sw, ALPHA)
        rec = blocked.extract_color_prepared(st, sc, pw.ebasis, pw.inv_blk,
                                             ALPHA, sw=pw.sw)
        score = blocked.detect_color(st, sc, pw.sw, ALPHA)
        got[str(d)] = (st.cpu(), rec.cpu(), float(score), float(ps))
    (st_c, rec_c, sc_c, ps_c), (st_g, rec_g, sc_g, ps_g) = got.values()
    d_st = (st_c.to(torch.int16) - st_g.to(torch.int16)).abs()
    d_rec = int((rec_c.to(torch.int16) - rec_g.to(torch.int16)).abs().max())
    require(int(d_st.max()) <= 1 and float((d_st > 0).float().mean()) <= 0.01,
            f"small slice stego GPU vs CPU: max {int(d_st.max())}")
    require(d_rec <= 2, f"small slice extract GPU vs CPU: {d_rec} > 2")
    require(abs(sc_c - sc_g) <= 1e-3, f"small slice detect {sc_c} vs {sc_g}")
    emit({"phase": "reference_small", "shape": [h, w, 3],
          "stego_max_abs_diff": int(d_st.max()), "extract_max_abs_diff": d_rec,
          "detect_cpu": sc_c, "detect_gpu": sc_g, "psnr_cpu": ps_c,
          "psnr_gpu": ps_g})


# The CLI's child process: cli.main under launch_counts (the embed nonce
# pinned first where ``--nonce HEX`` leads the arguments); the counts are
# the last line of its standard error.
CLI_CHILD = """import json, sys
if sys.argv[1:2] == ["--nonce"]:
    from dctsvd_tpu_torch.utils import crypto
    nonce = bytes.fromhex(sys.argv[2])
    del sys.argv[1:3]
    crypto.make_nonce = lambda: nonce
import chip_smoke
from dctsvd_tpu_torch import cli
with chip_smoke.launch_counts() as got:
    rc = cli.main(sys.argv[1:])
print(json.dumps(got), file=sys.stderr)
sys.exit(rc)
"""


def cli_call(dev, *args, check=True, nonce=None):
    """``python -m dctsvd_tpu_torch.cli --device DEV ARGS`` in a child
    process (:data:`CLI_CHILD`: with the embed nonce pinned to ``nonce`` if
    given, and the launches of K10, K11, K14, K15, K16 and K17 and the
    eager forms' calls in its process printed after ``cli.main`` returns,
    :func:`child_counts`); raises on a non-zero exit when ``check``."""
    pin = ["--nonce", nonce.hex()] if nonce is not None else []
    proc = subprocess.run(
        [sys.executable, "-c", CLI_CHILD, *pin, "--device", str(dev), *args],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True)
    if check and proc.returncode != 0:
        raise SmokeFailure(f"cli {args[0]} failed "
                           f"({proc.returncode}): {proc.stderr}")
    return proc


def child_counts(proc) -> dict:
    """The launch counts a :func:`cli_call` child printed."""
    return json.loads(proc.stderr.strip().splitlines()[-1])


def cli_video(dev, td: str, clip: str, wm_png: str) -> dict:
    """phase_files' video part: the video subcommands on the clip, each
    command's result read from the last line of its standard output."""
    from dctsvd_tpu_torch.io import image_io

    def cli(*args):
        proc = cli_call(dev, *args)
        return json.loads(proc.stdout.strip().splitlines()[-1])

    t0 = time.perf_counter()
    info = cli("video-info", clip)
    require((info["width"], info["height"], info["total_frames"]) ==
            (W, H, VIDEO_FRAMES), f"CLI video-info {info}")
    vout, prof = os.path.join(td, "v.mp4"), os.path.join(td, "prof")
    vemb = cli("--profile", prof, "video-embed", clip, "--watermark",
               wm_png, "--out", vout, "--scheme", "blocked", "--color",
               "--frame-interval", str(VIDEO_INTERVAL), "--alpha",
               str(VIDEO_ALPHA))
    traces = [os.path.join(prof, f) for f in os.listdir(prof)]
    require(traces and all(os.path.getsize(f) > 0 for f in traces),
            f"--profile left no trace: {traces}")
    vwm = os.path.join(td, "v_wm.png")
    vext = cli("video-extract", vout, vemb["meta"], "--out", vwm)
    vnc = nc_np(image_io.read_bgr(vwm)[..., 0], circle_ref(wm_png, H, W))
    require(vext["text"] is None and vnc > 0.4,
            f"CLI video-extract {vext}, NC {vnc}")
    vdet = cli("video-detect", vout, "--sample-rate", str(VIDEO_INTERVAL))
    require(vdet["total_frames_analyzed"] ==
            len(range(0, VIDEO_FRAMES, VIDEO_INTERVAL))
            and 0.0 < vdet["watermark_likelihood"] <= 1.0,
            f"CLI video-detect {vdet}")
    tout = os.path.join(td, "t.mp4")
    temb = cli("video-embed", clip, "--text", VIDEO_TEXT, "--out", tout,
               "--frame-interval", str(2 * VIDEO_INTERVAL))
    text = cli("video-extract", tout, temb["meta"], "--out",
               os.path.join(td, "t_wm.png"))["text"]
    require(text == VIDEO_TEXT, f"CLI video text {text!r}")
    return dict(info=info, blocked_color_nc=vnc, detect=vdet, text=text,
                profile_trace_bytes=[os.path.getsize(f) for f in traces],
                video_calls_s=time.perf_counter() - t0)


def phase_files(dev, covers, wm_u8, smooth_np, parity_text_recovered,
                clip, wm_png):
    """The CLI on 1080p PNGs (every embed with phase_payload's first nonce,
    ``cli.main`` run with the embed nonce pinned; the embeds launching K15
    and K16 once, the enhanced extract K10, K11, K14 and K17, none an
    eager form, each in its process): the blocked embed ->
    extract -> detect and a wrong password; then the default parity embed
    (color) -> extract with
    the enhancement chain -> detect and its wrong password; and a payload
    through embed-payload -> extract-payload with each method: blocked at
    1080p, recovered exactly; the parity default on phase_payload's
    360×640 crop, recovered exactly if the API recovered it
    (``parity_text_recovered``) and not recovered if it did not. Then the
    video subcommands on the 1080p clip: video-info; video-embed --scheme
    blocked --color (under --profile DIR, which must leave a non-empty
    trace file) -> video-extract (NC > 0.4) -> video-detect; video-embed
    --text (full) -> video-extract, the text recovered. The video
    subcommands run in a thread of their own beside the image ones (each
    call is a child process, most of it the process's start)."""
    from concurrent.futures import ThreadPoolExecutor

    from dctsvd_tpu_torch.io import image_io
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as td, \
            ThreadPoolExecutor(1) as pool:
        video_run = pool.submit(cli_video, dev, td, clip, wm_png)
        cp, wp = os.path.join(td, "cover.png"), os.path.join(td, "wm.png")
        sp = os.path.join(td, "smooth.png")
        image_io.write_png(cp, covers[0].cpu().numpy())
        image_io.write_png(wp, wm_u8.cpu().numpy())
        image_io.write_png(sp, smooth_np)
        stego = os.path.join(td, "stego.png")

        def cli(*args, check=True, nonce=None):
            return cli_call(dev, *args, check=check, nonce=nonce)

        # the embeds' nonce seeded, so that their scores and metrics are the
        # same in every run
        nonce = seeded_nonces(1)[0]
        counts = {}
        proc = cli("embed", cp, wp, "--out", stego, "--method", "blocked",
                   "--color", "--password", PASSWORD, nonce=nonce)
        emb, counts["embed_blocked"] = (json.loads(proc.stdout),
                                        child_counts(proc))
        meta = emb["meta"]
        ext = json.loads(cli("extract", stego, meta, "--out",
                             os.path.join(td, "wm_out.png"), "--no-enhance",
                             "--password", PASSWORD).stdout)
        got = image_io.read_bgr(ext["watermark"])
        require(got.shape == (H, W, 3), f"extracted shape {got.shape}")
        det = json.loads(cli("detect", stego, meta).stdout)
        require(det["watermarked"] is True, f"CLI detect {det}")
        bad = cli("extract", stego, meta, "--out",
                  os.path.join(td, "bad.png"), "--no-enhance", "--password",
                  "wrong-password", check=False)
        require(bad.returncode != 0 and "HMAC" in bad.stderr,
                "wrong password was not refused by the HMAC check")

        t0 = time.perf_counter()
        full = os.path.join(td, "full.png")
        proc = cli("embed", sp, wp, "--out", full, "--color", "--password",
                   PASSWORD, nonce=nonce)
        emb_f, counts["embed_parity"] = (json.loads(proc.stdout),
                                         child_counts(proc))
        meta_f = emb_f["meta"]
        proc = cli("extract", full, meta_f, "--out",
                   os.path.join(td, "full_wm.png"), "--password", PASSWORD)
        ext_f = json.loads(proc.stdout)
        # the launches in each child process: each counter is 0 at its
        # start and read after cli.main returned. The embeds (color) launch
        # K15 and K16 once; the enhanced color extract K10, both K11
        # kernels, K14 and K17 once each way; none calls an eager form
        enhanced = counts["extract_enhanced"] = child_counts(proc)
        for what, n in counts.items():
            want = (dict.fromkeys((*ENHANCE_KERNELS, *YCRCB_KERNELS), 1)
                    if what == "extract_enhanced"
                    else dict.fromkeys(METRIC_KERNELS, 1))
            require(all(n[k] == want.get(k, 0) for k in
                        (*ENHANCE_KERNELS, *YCRCB_KERNELS, *METRIC_KERNELS))
                    and not any(n["eager"].values()),
                    f"the CLI's {what}: launches and eager calls {n}")
        got = image_io.read_bgr(ext_f["watermark"])
        require(got.shape == (H, W, 3), f"parity extracted shape {got.shape}")
        det_f = json.loads(cli("detect", full, meta_f).stdout)
        require(det_f["watermarked"] is True and det_f["score"] > 0.9,
                f"CLI parity detect {det_f}")
        bad_f = cli("extract", full, meta_f, "--out",
                    os.path.join(td, "bad_f.png"), "--password",
                    "wrong-password", check=False)
        require(bad_f.returncode != 0 and "HMAC" in bad_f.stderr,
                "wrong password on a parity meta was not refused")
        # payloads: blocked at 1080p, the parity default on a 360x640
        # crop, with phase_payload's text and first nonce
        crop = os.path.join(td, "crop.png")
        image_io.write_png(crop, smooth_np[:360, :640])
        text = PAYLOAD_TEXT
        payload = {}
        for i, (src, extra, expect) in enumerate((
                (sp, ("--method", "blocked"), True),
                (crop, ("--alpha", "0.15"), parity_text_recovered))):
            pay = os.path.join(td, f"pay{i}.png")
            emb_p = json.loads(cli("embed-payload", src, text, "--out", pay,
                                   "--password", PASSWORD, *extra,
                                   nonce=nonce).stdout)
            ext_p = cli("extract-payload", pay, emb_p["meta"], "--password",
                        PASSWORD, check=False)
            if expect:
                require(ext_p.returncode == 0 and
                        json.loads(ext_p.stdout)["payload"] == text,
                        f"CLI payload {extra}: {ext_p.stdout} "
                        f"{ext_p.stderr[-500:]}")
            else:
                require(ext_p.returncode != 0 or
                        json.loads(ext_p.stdout)["payload"] != text,
                        f"CLI payload {extra}: recovered where the API did "
                        f"not")
            payload["blocked_1080p" if i == 0 else "full_360x640"] = (
                "recovered" if expect else "not recovered, as by the API")

        t1 = time.perf_counter()
        video_cli = video_run.result()
        emit({"phase": "cli_files", "psnr": emb["psnr"], "ssim": emb["ssim"],
              "detect": det, "wrong_password": "refused",
              "parity_color": {"psnr": emb_f["psnr"], "ssim": emb_f["ssim"],
                               "detect": det_f, "enhanced_extract": True,
                               "launches": counts,
                               "wrong_password": "refused"},
              "payload": payload, "video": video_cli,
              "parity_calls_s": t1 - t0})
    return counts


# ---------------------------------------------------------------------------
# The rest of the image API: the parity path, enhancement, payloads, resync
# ---------------------------------------------------------------------------

def smooth_frame(seed: int):
    """A seeded 1080p u8 BGR cover, uniform noise blurred at σ 3 (the
    tests' synthetic host), made on the host with cv2."""
    import cv2
    import numpy as np
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (H, W, 3), np.uint8),
                            (0, 0), 3.0)


def flat_cover(cover):
    """A screenshot-like cover: flat gray with one patch of ``cover``
    (200x300 at 1080p), so each plane's rank is at most the patch's height
    and its SVD has a null space (880 wide at 1080p)."""
    import torch
    h, w = cover.shape[0], cover.shape[1]
    ph, pw, y0, x0 = h * 5 // 27, w * 5 // 32, h * 10 // 27, w * 5 // 12
    flat = torch.full_like(cover, 128)
    flat[y0:y0 + ph, x0:x0 + pw] = cover[:ph, :pw]
    return flat


def nc_np(a, b) -> float:
    import numpy as np
    a = a.astype(np.float64).ravel() - a.mean()
    b = b.astype(np.float64).ravel() - b.mean()
    return float(a @ b / np.sqrt((a @ a) * (b @ b)))


def svd_drivers(dev, cover_np, wm_np):
    """The three cuSOLVER drivers of torch.linalg.svd on the inputs the
    parity embed decomposes at 1080p: the cover's [3, 1080, 1920] f32 DCT
    planes, the keyed watermark's, and a rank-deficient cover's. For each, the time (CUDA events,
    mean of 3 calls after a warm-up), whether two runs give the same bits,
    the largest |S − S_cpu| / s_max against LAPACK on the CPU, the
    reconstruction error, and U's and Vt's orthogonality error."""
    import torch
    from dctsvd_tpu_torch.ops import dct, resize, svd as svd_ops
    from dctsvd_tpu_torch.ops.permute import permute_plane
    from dctsvd_tpu_torch.utils import crypto

    def planes(img):
        return torch.movedim(img, -1, 0).to(torch.float32)

    idx = crypto.permutation_indices(crypto.derive_key(PASSWORD, bytes(8)),
                                     H * W)
    wm = resize.resize_area_u8(torch.as_tensor(wm_np, device=dev), H, W)
    flat = flat_cover(torch.as_tensor(cover_np, device=dev))
    inputs = {"cover": dct.dct2(planes(torch.as_tensor(cover_np,
                                                       device=dev))),
              "watermark": dct.dct2(permute_plane(
                  planes(wm), torch.as_tensor(idx, device=dev))),
              "flat_cover": dct.dct2(planes(flat))}
    eye = torch.eye(min(H, W), device=dev)
    rows = {}
    for name, x in inputs.items():
        s_cpu = torch.linalg.svd(x.cpu(), full_matrices=False).S
        smax = float(s_cpu.max())
        for drv in ("gesvd", "gesvdj", "gesvda"):
            def run():
                return torch.linalg.svd(x, full_matrices=False, driver=drv)
            key = f"{name}_{drv}"
            try:
                a, b = run(), run()
                torch.cuda.synchronize()
            except RuntimeError as err:
                rows[key] = {"error": str(err)[:300]}
                continue
            recon = torch.matmul(a.U * a.S[..., None, :], a.Vh)
            rows[key] = dict(
                bit_stable=all(torch.equal(p, q) for p, q in zip(a, b)),
                s_err_rel=float((a.S.cpu() - s_cpu).abs().max()) / smax,
                recon_err_rel=float((recon - x).abs().max()) / smax,
                u_orth_err=float((a.U.mT @ a.U - eye).abs().max()),
                vt_orth_err=float((a.Vh @ a.Vh.mT - eye).abs().max()),
                ms=cuda_time(run, 3))
    pinned = [v for k, v in rows.items() if k.endswith(svd_ops.SVD_DRIVER)]
    require(all(r.get("bit_stable") for r in pinned),
            f"the pinned driver {svd_ops.SVD_DRIVER} is not bit-stable: "
            f"{rows}")
    emit({"phase": "svd_drivers", "shape": [3, H, W],
          "pinned": svd_ops.SVD_DRIVER, "drivers": rows, "card": smi_line()})


def phase_parity(dev, cover_np, wm_np):
    """The parity path (models/image) at 1080p, gray and color, α 0.12,
    with a password permutation, and gray on a rank-deficient cover
    (flat_cover): the roundtrip gates of
    tests/test_image_roundtrip.py (the clean host being the unmarked
    cover, as there), svd_full's bit stability and the exact cancellation
    of Sc, and CUDA-event times after one untimed embed. Returns the
    extracted gray and color watermarks (for enhance) and K6's and K7's
    launches in the timed embeds, extracts and detects (their counters
    set to 0 just before each and read just after)."""
    import torch
    from dctsvd_tpu_torch.models import image
    from dctsvd_tpu_torch.ops import color, dct, resize
    from dctsvd_tpu_torch.ops.svd import svd_full
    from dctsvd_tpu_torch.utils import crypto

    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 is on for CUDA matmuls")
    key = crypto.derive_key(PASSWORD, bytes(8))
    idx = crypto.permutation_indices(key, H * W)
    perm = torch.as_tensor(idx, device=dev)
    inv = torch.as_tensor(crypto.inverse_permutation(idx), device=dev)
    cover = torch.as_tensor(cover_np, device=dev)
    flat = flat_cover(cover)
    wm = resize.resize_area_u8(torch.as_tensor(wm_np, device=dev), H, W)
    wm_gray = color.bgr_to_gray(wm)
    out, extracted = {}, {}
    n_color = dict.fromkeys(COLOR_KERNELS, 0)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed(fn):
        zero_color_counts()
        start.record()
        res = fn()
        stop.record()
        torch.cuda.synchronize()
        for name, n in color_counts().items():
            n_color[name] += n
        return res, start.elapsed_time(stop)

    # one untimed embed first: the first cuSOLVER call of the process
    # sets the library up, which no request after it pays
    image.embed_gray(cover, wm_gray, perm, ALPHA)
    torch.cuda.synchronize()
    for mode, cover in (("gray", cover), ("color", cover),
                        ("gray_flat_cover", flat)):
        if mode != "color":
            res, embed_ms = timed(lambda: image.embed_gray(
                cover, wm_gray, perm, ALPHA))
            sc, planes, ref = res.sc, color.luma_f32(cover), wm_gray
            ext, det = image.extract_gray, image.detect_gray
        else:
            res, embed_ms = timed(lambda: image.embed_color(
                cover, wm, perm, ALPHA))
            sc, ref = res.s_cover, wm
            planes = torch.movedim(cover.to(torch.float32), -1, 0)
            ext, det = image.extract_color, image.detect_color
        rec, extract_ms = timed(lambda: ext(res.stego_bgr, sc, res.uw,
                                            res.vwt, inv, ALPHA))
        score, detect_ms = timed(lambda: det(res.stego_bgr, sc, res.sw,
                                             ALPHA))
        score = float(score)
        # svd_full's bit stability, and the exact cancellation of Sc on
        # the unmodified cover
        c = dct.dct2(planes)
        u1, s1, v1 = svd_full(c)
        u2, s2, v2 = svd_full(c)
        stable = (torch.equal(u1, u2) and torch.equal(s1, s2)
                  and torch.equal(v1, v2))
        residue = float((svd_full(c, compute_uv=False) - sc).abs().max())
        cover_score = float(det(cover, sc, res.sw, ALPHA))
        svd_ms = cuda_time(lambda: svd_full(c), 3)
        ps, ss = float(res.psnr), float(res.ssim)
        nc = nc_np(rec.cpu().numpy(), ref.cpu().numpy())
        require(ps > 20.0, f"parity {mode} PSNR {ps} <= 20")
        require(score > 0.9, f"parity {mode} own-stego detect {score}")
        require(cover_score < 0.6, f"parity {mode} clean detect "
                f"{cover_score}")
        require(nc > 0.55, f"parity {mode} extraction NC {nc} <= 0.55")
        require(stable, f"svd_full {mode}: two runs differ")
        require(residue == 0.0, f"parity {mode}: S(cover) - Sc = {residue}")
        require(bool(torch.isfinite(res.sw).all()) and rec.dtype ==
                torch.uint8 and tuple(rec.shape) == tuple(ref.shape),
                f"parity {mode} outputs")
        extracted[mode] = rec
        out[mode] = dict(psnr=ps, ssim=ss, detect=score,
                         clean_detect=cover_score,
                         extract_nc=nc, svd_bit_stable=stable,
                         sc_residue=residue, embed_ms=embed_ms,
                         extract_ms=extract_ms, detect_ms=detect_ms,
                         svd_full_ms=svd_ms, svd_shape=list(c.shape))
    emit({"phase": "parity_1080p", "alpha": ALPHA, **out,
          "color_launches": n_color, "card": smi_line()})
    return extracted, n_color


def phase_parity_reference(dev):
    """The parity path on the card against the CPU on one small frame:
    stego bytes within 1 quantum on at most 1 %, PSNR within 0.01 dB,
    SSIM within 1e-3, detect within 1e-3, extractions' NC >= 0.999."""
    import numpy as np
    import torch
    from dctsvd_tpu_torch.models import image
    from dctsvd_tpu_torch.utils import crypto

    rng = np.random.default_rng(11)
    h, w = 64, 80
    cover = rng.integers(0, 256, (h, w, 3), np.uint8)
    wm = rng.integers(0, 256, (h, w, 3), np.uint8)
    key = crypto.derive_key(PASSWORD, bytes(8))
    idx = crypto.permutation_indices(key, h * w)
    inv = crypto.inverse_permutation(idx)
    rows = {}
    for mode in ("gray", "color"):
        got = {}
        for d in ("cpu", dev):
            t = {k: torch.as_tensor(v, device=d) for k, v in
                 dict(cover=cover, wm=wm, idx=idx, inv=inv).items()}
            if mode == "gray":
                res = image.embed_gray(t["cover"], t["wm"][..., 1],
                                       t["idx"], ALPHA)
                sc = res.sc
                rec = image.extract_gray(res.stego_bgr, sc, res.uw, res.vwt,
                                         t["inv"], ALPHA)
                score = image.detect_gray(res.stego_bgr, sc, res.sw, ALPHA)
            else:
                res = image.embed_color(t["cover"], t["wm"], t["idx"], ALPHA)
                sc = res.s_cover
                rec = image.extract_color(res.stego_bgr, sc, res.uw,
                                          res.vwt, t["inv"], ALPHA)
                score = image.detect_color(res.stego_bgr, sc, res.sw, ALPHA)
            got[str(d)] = (res.stego_bgr.cpu().numpy(), rec.cpu().numpy(),
                           float(score), float(res.psnr), float(res.ssim))
        (st_c, rec_c, sc_c, ps_c, ss_c), (st_g, rec_g, sc_g, ps_g, ss_g) = \
            got.values()
        d_st = np.abs(st_c.astype(int) - st_g.astype(int))
        nc = nc_np(rec_c, rec_g)
        require(d_st.max() <= 1 and (d_st > 0).mean() <= 0.01,
                f"parity {mode} stego GPU vs CPU: max {d_st.max()}")
        require(abs(ps_c - ps_g) <= 0.01 and abs(ss_c - ss_g) <= 1e-3,
                f"parity {mode} PSNR/SSIM GPU vs CPU: {ps_g}/{ps_c}, "
                f"{ss_g}/{ss_c}")
        require(abs(sc_c - sc_g) <= 1e-3,
                f"parity {mode} detect GPU {sc_g} vs CPU {sc_c}")
        require(nc >= 0.999, f"parity {mode} extraction NC GPU/CPU {nc}")
        rows[mode] = dict(stego_max_abs_diff=int(d_st.max()),
                          stego_diff_share=float((d_st > 0).mean()),
                          psnr_cpu=ps_c, psnr_gpu=ps_g, ssim_cpu=ss_c,
                          ssim_gpu=ss_g, detect_cpu=sc_c, detect_gpu=sc_g,
                          extract_nc=nc)
    emit({"phase": "parity_reference_small", "shape": [64, 80, 3], **rows})


# ---------------------------------------------------------------------------
# K10 and K11: the enhancement chain's NLM and CLAHE
# ---------------------------------------------------------------------------

# The H100 SXM's special-function units: 16 results (exp2, rcp, rsqrt) a
# clock an SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0), 132 SMs at the 1980 MHz boost clock
# that PEAK_F32 assumes.
PEAK_SFU = 132 * 16 * 1.98e9
SEARCH_OFFSETS = 21 * 21
# f32 or int operations NLM's least-work form does a pixel and offset: the
# squared difference (2), sliding column and row sums (2 + 2), the
# conversion (1), the two divisions (2), wsum's sum, the product by
# x(R(p + o)) and vsum's sum (3); its exp is one SFU result.
NLM_OPS = 12
CLAHE_LUT_OPS_PIXEL = 1      # a histogram increment
CLAHE_LUT_OPS_BIN = 12       # clip, excess, redistribution, scan, LUT
CLAHE_APPLY_OPS = 11         # 1 - wx, 1 - wy, 6 products, 3 sums
# K14 a pixel and channel: each pass's 7 products and 7 sums, then two
# products, a sum, the round and the clamp
UNSHARP_OPS = 2 * 7 * 2 + 5
# K15 a pixel, in the least-work form: x x, y y, x y (3); each pass's 11
# products and 11 sums for five inputs (2 x 110); the map (18: three
# products, three differences, num's 2 products and 2 sums and product,
# den's 3 sums and product and sum, the division); the mean's sum (1)
SSIM_OPS = 3 + 2 * 110 + 18 + 1
# K15's design (csrc/metrics.cu): a CTA walks a band of 32 rows across 8
# blocks of 64 columns; a block's vertical pass 256 threads of 8 outputs
# from 18 halo rows at its 64 new padded columns (the 10 before them
# carried from the block before, made once a walk), the horizontal pass 8
# outputs a thread from five 16-byte loads a plane
SSIM_BLOCK_W, SSIM_CARRY_W = 64, 10   # a block's columns, those carried
SSIM_BLOCK = 32 * SSIM_BLOCK_W    # pixels a block
SSIM_HALO_ROWS = 42
SSIM_WALK = 8                     # blocks a walk
SSIM_V_ITEMS, SSIM_V_ROWS, SSIM_V_IN = 256, 8, 18
SSIM_CARRY_ITEMS = 40             # a walk's first 10 columns x 4 runs
SSIM_CARRY = 5 * 32 * SSIM_CARRY_W    # the planes' values carried a block
SSIM_H_COLS, SSIM_H_IN = 8, 20
SMEM_BYTES_PER_CLOCK = 128    # an SM's shared memory, bytes a clock


def ssim_design() -> dict:
    """K15's work a pixel as its design does it: the f32 instructions (the
    vertical pass's 3 products a halo pixel and 5 x 11 products and sums an
    output, the horizontal pass's 5 x 22, the map's 18, the masking select
    and the sum's add) and the shared memory it loads and stores
    (instructions and bytes): the block's new columns of x and y stored
    once and read once by the vertical pass, its five planes stored, read
    by five 16-byte loads a plane and 8 pixels, and their last 10 columns
    copied to the first, the map stored and read once."""
    runs = (SSIM_V_ITEMS + SSIM_CARRY_ITEMS / SSIM_WALK) / SSIM_BLOCK
    f32 = (runs * (3 * SSIM_V_IN + 5 * SSIM_V_ROWS * 22)
           + 5 * 22 + 18 + 1 + 1)
    carry = SSIM_CARRY / SSIM_BLOCK
    loads = {"vertical": runs * 2 * SSIM_V_IN,
             "horizontal": 5 * (SSIM_H_IN // 4) / SSIM_H_COLS,
             "map": 1.0, "carry": carry}
    load_bytes = {"vertical": 4 * loads["vertical"],
                  "horizontal": 5 * SSIM_H_IN * 4 / SSIM_H_COLS,
                  "map": 4.0, "carry": 4 * carry}
    stores = {"halo": 2 * SSIM_HALO_ROWS
              * (SSIM_BLOCK_W + SSIM_CARRY_W / SSIM_WALK) / SSIM_BLOCK,
              "vertical": 5 * runs * SSIM_V_ROWS, "map": 1.0,
              "carry": carry}
    return dict(f32_insn_per_pixel=f32,
                smem_loads_per_pixel=sum(loads.values()),
                smem_loads=loads,
                smem_stores_per_pixel=sum(stores.values()),
                smem_bytes_per_pixel=sum(load_bytes.values())
                + 4 * sum(stores.values()))


def ssim_bounds(pixels: int, sm_mhz: float) -> dict:
    """K15's restated bound at the SM clock read in the run: the larger of
    its f32 issue floor (:func:`ssim_design`'s instructions at one a lane
    a clock) and its shared-memory floor (its bytes at 128 a clock an
    SM)."""
    import torch
    d = ssim_design()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue = insn_bound_ms(d["f32_insn_per_pixel"] * pixels, sm_mhz)
    smem = (d["smem_bytes_per_pixel"] * pixels
            / (sms * SMEM_BYTES_PER_CLOCK * sm_mhz * 1e6) * 1e3)
    return dict(d, f32_issue_bound_ms=issue, smem_bound_ms=smem,
                restated_bound_ms=max(issue, smem),
                restated_bound_by="f32 issue" if issue >= smem
                else "shared memory")
PSNR_OPS = 3                 # a byte: the difference, its square, the sum
# the 1080p checks' other shapes: a 4K frame, planes smaller than the
# blur's pad, a border-heavy one (a view off its 16-byte alignment is
# the fifth case)
METRIC_SHAPES = {"4k": (2160, 3840), "3x5": (3, 5), "37x51": (37, 51)}
# (``clahe``: K11's two kernels in one host call, which clahe_u8 makes;
# its count is its calls, each also one launch of either K11 kernel)
ENHANCE_KERNELS = ("nlm_planes", "clahe_luts", "clahe_apply", "clahe",
                   "unsharp")
YCRCB_KERNELS = ("bgr_to_ycrcb_planes", "ycrcb_planes_to_bgr")
METRIC_KERNELS = ("ssim", "psnr")
# the K10 planes smaller than its 21-pixel window and a border-heavy one
NLM_BORDER_SHAPES = ((1, 1), (7, 9), (12, 11), (37, 51))
CLAHE_SMALL_SHAPES = ((1, 37, 51), (3, 40, 52), (1, 1, 1), (1, 1081, 1920),
                      (1, 1080, 1936))
# K14's other shapes: a plane of one pixel, and widths across several
# column blocks and walks that are not a multiple of the block
UNSHARP_SHAPES = {"1x1": (1, 1), "37x1000": (37, 1000), "70x333": (70, 333)}


def enhance_wrappers():
    """K10's, K11's and K14's wrappers."""
    from dctsvd_tpu_torch.ops import enhance_cuda
    return {name: getattr(enhance_cuda, name) for name in ENHANCE_KERNELS}


def ycrcb_wrappers() -> dict:
    """K17's wrappers."""
    from dctsvd_tpu_torch.ops import color_cuda
    return {name: getattr(color_cuda, name) for name in YCRCB_KERNELS}


def slice_wrappers() -> dict:
    """The wrappers of this slice's kernels and of the chains' K10 and K11:
    K10, K11, K14 (enhance_cuda), K15, K16 (metrics_cuda), K17
    (color_cuda)."""
    return dict(enhance_wrappers(), **metrics_wrappers(), **ycrcb_wrappers())


def eager_form_calls():
    """:func:`counted_calls` of the eager forms K14-K17 replaced: the
    shift-and-add blur (the twins' unsharp and the SSIM map call it), the
    SSIM map, PSNR's twin, the channels-last YCrCb pair."""
    from dctsvd_tpu_torch.ops import color, metrics_cuda
    from dctsvd_tpu_torch.ops import enhance as e_ops
    return counted_calls(((e_ops, "gaussian_blur"), (metrics_cuda, "ssim_map"),
                          (metrics_cuda, "psnr_plain"),
                          (color, "bgr_to_ycrcb"), (color, "ycrcb_to_bgr")))


@contextlib.contextmanager
def launch_counts():
    """The launches of :func:`slice_wrappers` in the block, each counter set
    to 0 at its start and read at its end (after a synchronise), and the
    calls of the eager forms (:func:`eager_form_calls`): {name: launches,
    ..., "eager": {name: calls}}, filled when the block ends."""
    import torch
    wrappers = slice_wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    out = {}
    with eager_form_calls() as eager:
        yield out
    torch.cuda.synchronize()
    out.update({n: w.launches for n, w in wrappers.items()}, eager=eager)


def offset_view(x):
    """x's values in a view that starts one element past a 16-byte
    boundary (the kernels' scalar paths)."""
    import torch
    flat = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    view = flat[1:1 + x.numel()]
    view.copy_(x.reshape(-1))
    return view.view(x.shape)


def conv_yardstick(planes, sigma: float, ksize: int):
    """One F.conv2d call that blurs f32 planes [N, C, H, W] as the
    separable Gaussian does (the outer product of the taps, groups C) on
    their reflect-padded copy, made beforehand: K14's and K15's library
    yardstick (TF32 off), used nowhere in the port. Returns the call."""
    import torch
    import torch.nn.functional as F
    from dctsvd_tpu_torch.ops.enhance import _gauss1d
    c, r = planes.shape[1], ksize // 2
    k = torch.as_tensor(_gauss1d(ksize, sigma), dtype=torch.float32,
                        device=planes.device)
    weight = torch.outer(k, k).expand(c, 1, ksize, ksize).contiguous()
    padded = F.pad(planes, (r, r, r, r), mode="reflect")
    return lambda: F.conv2d(padded, weight, groups=c)


def eager_box_filter(x, r: int):
    """The eager form's box filter (ops/enhance.py at commit 417cd0b):
    mean over (2r+1)² windows, reflect-101 borders, two cumsums."""
    import torch
    from dctsvd_tpu_torch.ops.enhance import _pad_reflect
    k = 2 * r + 1
    xp = _pad_reflect(x, r, r, r, r)
    c = torch.cumsum(xp, dim=-2)
    c = torch.cat([torch.zeros_like(c[..., :1, :]), c], dim=-2)
    rows = c[..., k:, :] - c[..., :-k, :]
    c2 = torch.cumsum(rows, dim=-1)
    c2 = torch.cat([torch.zeros_like(c2[..., :1]), c2], dim=-1)
    return (c2[..., :, k:] - c2[..., :, :-k]) / (k * k)


def eager_nlm(planes, h2, template: int = 7, search: int = 21):
    """The eager NLM K10 replaced (ops/enhance.py::_nlm_f32 at commit
    417cd0b: a Python loop over the 441 offsets, about 16 ops each), kept
    here as K10's yardstick: u8 planes [P, H, W], h² [P] -> u8."""
    import torch
    from dctsvd_tpu_torch.ops.enhance import _pad_reflect
    x = planes.to(torch.float32)
    h2 = h2.reshape(-1, 1, 1)
    tr, sr = template // 2, search // 2
    hh, ww = x.shape[-2], x.shape[-1]
    xp = _pad_reflect(x, sr, sr, sr, sr)
    wsum = torch.zeros_like(x)
    vsum = torch.zeros_like(x)
    for dy in range(-sr, sr + 1):
        for dx in range(-sr, sr + 1):
            shifted = xp[..., sr + dy:sr + dy + hh, sr + dx:sr + dx + ww]
            d2 = eager_box_filter((x - shifted) ** 2, tr)
            wgt = torch.exp(-d2 / h2)
            wsum = wsum + wgt
            vsum = vsum + wgt * shifted
    out = vsum / torch.clamp(wsum, min=1e-12)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def eager_clahe(img_u8, tiles: int = 8, clip_limit: float = 2.0):
    """The eager CLAHE K11 replaced (ops/enhance.py::clahe_u8 at commit
    417cd0b), kept here as K11's yardstick: u8 planes [..., H, W]."""
    import numpy as np
    import torch
    from dctsvd_tpu_torch.ops.enhance import _pad_reflect
    lead, (h, w) = img_u8.shape[:-2], img_u8.shape[-2:]
    dev = img_u8.device
    planes = img_u8.reshape(-1, h, w)
    p = planes.shape[0]
    th, tw = -(-h // tiles), -(-w // tiles)
    x = _pad_reflect(planes, 0, th * tiles - h, 0, tw * tiles - w)
    t = x.reshape(p, tiles, th, tiles, tw).transpose(2, 3)
    t = t.reshape(p, tiles * tiles, th * tw).to(torch.int64)
    hist = torch.zeros(p, tiles * tiles, 256, dtype=torch.int32, device=dev)
    hist.scatter_add_(-1, t, torch.ones_like(t, dtype=torch.int32))
    hist = hist.to(torch.float32)
    area = th * tw
    limit = max(float(np.floor(np.float32(clip_limit * area / 256.0))), 1.0)
    excess = torch.clamp(hist - limit, min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=limit)
    batch = torch.floor(excess / 256.0)
    resid = excess - batch * 256.0
    hist = hist + batch
    b = torch.arange(256, dtype=torch.float32, device=dev)
    step = torch.clamp(torch.floor(256.0 / torch.clamp(resid, min=1.0)),
                       min=1.0)
    hit = (torch.remainder(b, step) == 0) & (torch.floor(b / step) < resid)
    hist = hist + hit.to(hist.dtype)
    cdf = torch.cumsum(hist, dim=-1)
    scale = torch.tensor(255.0 / area, dtype=torch.float32, device=dev)
    lut = torch.round(cdf * scale).clamp(0, 255)
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
        tid = tyi[:, None] * tiles + txi[None, :]
        return flat.gather(-1, (tid * 256 + v).reshape(p, h * w)
                           ).reshape(p, h, w)

    v00, v01 = pick(y0, x0), pick(y0, x1)
    v10, v11 = pick(y1, x0), pick(y1, x1)
    out = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
           + wy * ((1 - wx) * v10 + wx * v11))
    out = torch.round(out).clamp(0, 255).to(torch.uint8)
    return out.reshape(*lead, h, w)


@contextlib.contextmanager
def eager_enhance():
    """The eager NLM, CLAHE, unsharp and YCrCb pair in the kernels' places
    (the chain as it ran before K10, K11, K14 and K17; the color chain's
    CLAHE keeps K6 and K7)."""
    from dctsvd_tpu_torch.ops import color_cuda, enhance_cuda
    from dctsvd_tpu_torch.ops import enhance as e_ops
    saved = (enhance_cuda.nlm_planes, e_ops.clahe_u8, enhance_cuda.unsharp,
             color_cuda.bgr_to_ycrcb_planes, color_cuda.ycrcb_planes_to_bgr)
    enhance_cuda.nlm_planes = lambda planes, h2, t=7, s=21: eager_nlm(
        planes, h2, t, s)
    e_ops.clahe_u8 = eager_clahe
    enhance_cuda.unsharp = enhance_cuda.unsharp_plain
    color_cuda.bgr_to_ycrcb_planes = color_cuda.bgr_to_ycrcb_planes_plain
    color_cuda.ycrcb_planes_to_bgr = color_cuda.ycrcb_planes_to_bgr_plain
    try:
        yield
    finally:
        (enhance_cuda.nlm_planes, e_ops.clahe_u8, enhance_cuda.unsharp,
         color_cuda.bgr_to_ycrcb_planes,
         color_cuda.ycrcb_planes_to_bgr) = saved


def nlm_bound(planes) -> dict:
    """K10's bound on u8 planes [P, H, W]: the larger of its bytes (a u8
    read and a u8 write a pixel, h² once), the least-work form's f32 or
    int operations over PEAK_F32 and its exps over PEAK_SFU."""
    p, h, w = planes.shape
    n = p * h * w * SEARCH_OFFSETS
    moved = 2 * p * h * w + 4 * p
    t_ops, t_sfu = n * NLM_OPS / PEAK_F32 * 1e3, n / PEAK_SFU * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_sfu, t_bytes),
                bound_by="bytes" if t_bytes > max(t_ops, t_sfu)
                else "operations", ops=n * NLM_OPS, exps=n,
                ops_ms=t_ops, exps_ms=t_sfu, bytes=moved)


def clahe_bound(planes, lut: bool, tiles: int = 8) -> dict:
    """K11's bounds on u8 planes [P, H, W]: the LUT kernel reads the
    planes once and writes the LUTs; the interpolation reads the planes
    and the LUTs and writes the planes."""
    p, h, w = planes.shape
    lut_bytes = p * tiles * tiles * 256
    if lut:
        moved = p * h * w + lut_bytes
        ops = p * h * w * CLAHE_LUT_OPS_PIXEL + lut_bytes * CLAHE_LUT_OPS_BIN
    else:
        moved = 2 * p * h * w + lut_bytes
        ops = p * h * w * CLAHE_APPLY_OPS
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, moved / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, bytes=moved)


def enhance_rows(dev, gray, frames) -> dict:
    """K10 and both K11 kernels against their plain twins run on the card
    (torch.equal) at the main path's shapes: K10 on the 1080p extracted
    gray plane (h² 49) and on the color frame's three YCrCb planes (h² 9),
    and on planes smaller than its window and a border-heavy one
    (NLM_BORDER_SHAPES, two planes each, h² 49 and 9); the CLAHE LUTs and
    interpolation, each alone and both in one call (``ec.clahe``), on the
    gray plane, the color frame's luma plane, a single-valued plane (every
    count in one bin), CLAHE_SMALL_SHAPES (tiles of rows past the plane,
    of a width not a multiple of 16, 1x1), a view off its 16-byte
    alignment and a 4K plane, one after another. Each row: the kernel's ms
    through its wrapper and its device time alone (torch.profiler), its
    twin's, the eager form's (for the CLAHE rows the whole eager CLAHE,
    both stages), and its bound; the LUT row also both stages through
    ``ec.clahe`` (its ms and device time) and ``clahe_u8``, and
    :func:`clahe_scratch_times`."""
    import torch
    from dctsvd_tpu_torch.ops import color
    from dctsvd_tpu_torch.ops import enhance as e_ops
    from dctsvd_tpu_torch.ops import enhance_cuda as ec

    gen = torch.Generator(device=dev).manual_seed(20261018)

    def smooth(shape):
        x = torch.randint(0, 256, shape, generator=gen, device=dev,
                          dtype=torch.uint8).to(torch.float32)
        return torch.round(torch.nn.functional.avg_pool2d(
            x[None], 3, 1, 1, count_include_pad=False)[0]).to(torch.uint8)

    equal = held_equal

    g_planes = gray.reshape(1, *gray.shape[-2:]).contiguous()
    ycc = torch.movedim(color.bgr_to_ycrcb(frames), -1, -3)
    c_planes = ycc.reshape(-1, *ycc.shape[-2:]).contiguous()
    h2g = torch.full((1,), 49.0, device=dev)
    h2c = torch.full((3,), 9.0, device=dev)
    rows = {}
    for name, planes, h2 in (("nlm_planes", g_planes, h2g),
                             ("nlm_planes_color", c_planes, h2c)):
        checks = {"1080p": equal(name, "1080p", ec.nlm_planes(planes, h2),
                                 e_ops.nlm_planes_plain(planes, h2))}
        if name == "nlm_planes":
            h2b = torch.tensor([49.0, 9.0], device=dev)
            for shp in NLM_BORDER_SHAPES:
                x = smooth((2, *shp))
                checks[f"{shp[0]}x{shp[1]}"] = equal(
                    name, shp, ec.nlm_planes(x, h2b),
                    e_ops.nlm_planes_plain(x, h2b))
        eager = eager_nlm(planes, h2)
        rows[name] = dict(
            shape=list(planes.shape), h2=h2.tolist(), checks=checks,
            max_abs_err=max(c["max_abs_err"] for c in checks.values()),
            vs_eager_bytes=int((eager != ec.nlm_planes(planes, h2)).sum()),
            ms=cuda_time(lambda: ec.nlm_planes(planes, h2), 5),
            plain_ms=cuda_time(lambda: e_ops.nlm_planes_plain(planes, h2),
                               1),
            eager_ms=cuda_time(lambda: eager_nlm(planes, h2), 1),
            library_ms=None, **nlm_bound(planes),
            **nlm_weight_issue(planes, lambda: ec.nlm_planes(planes, h2)))
    luma = color.luma_f32(frames).to(torch.uint8).reshape(1, *gray.shape)
    big = torch.randint(0, 256, (1, *METRIC_SHAPES["4k"]), generator=gen,
                        device=dev, dtype=torch.uint8)
    cases = {"gray_1080p": g_planes, "luma_1080p": luma.contiguous(),
             "single_valued": torch.full_like(g_planes, 131),
             **{"x".join(map(str, shp)): smooth(shp)
                for shp in CLAHE_SMALL_SHAPES}, "offset": offset_view(
                 g_planes), "4k": big}
    # K11 in one call (ec.clahe) on each case in turn: successive calls on
    # different planes, each finding the scratch its predecessor left zero
    checks_l, checks_a, checks_c = {}, {}, {}
    for case, x in cases.items():
        ref = e_ops.clahe_luts_plain(x)
        out = e_ops.clahe_apply_plain(x, ref)
        checks_l[case] = equal("clahe_luts", case, ec.clahe_luts(x), ref)
        checks_a[case] = equal("clahe_apply", case, ec.clahe_apply(x, ref),
                               out)
        checks_c[case] = equal("clahe", case, ec.clahe(x), out)
    rows.update(k14_k17_rows(dev, gray, frames, smooth, equal))
    luts = ec.clahe_luts(g_planes)
    eager_ms = cuda_time(lambda: eager_clahe(g_planes), 5)
    plan = ec.clahe_plan(1, *g_planes.shape[-2:], 8,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    for name, checks, kern, plain, lut, stem in (
            ("clahe_luts", checks_l, lambda: ec.clahe_luts(g_planes),
             lambda: e_ops.clahe_luts_plain(g_planes), True, "clahe_lut"),
            ("clahe_apply", checks_a, lambda: ec.clahe_apply(g_planes, luts),
             lambda: e_ops.clahe_apply_plain(g_planes, luts), False,
             "clahe_apply")):
        rows[name] = dict(
            shape=list(g_planes.shape), checks=checks,
            max_abs_err=max(c["max_abs_err"] for c in checks.values()),
            ms=cuda_time(kern, 20), device_ms=device_ms(kern, 20, stem),
            plain_ms=cuda_time(plain, 5), eager_ms=eager_ms,
            library_ms=None, plan=plan._asdict(),
            **clahe_bound(g_planes, lut))
    # both stages through the one host call, and through clahe_u8
    rows["clahe_luts"].update(
        clahe_checks=checks_c,
        clahe_ms=cuda_time(lambda: ec.clahe(g_planes), 20),
        clahe_device_ms=device_ms(lambda: ec.clahe(g_planes), 20, "clahe_"),
        clahe_u8_ms=cuda_time(lambda: e_ops.clahe_u8(gray), 20),
        clahe_scratch_ms=clahe_scratch_times(g_planes))
    return rows


def ycrcb_pair(frames):
    """The color NLM's conversions around K10 on BGR frames: K17's pair
    (planar YCrCb and back)."""
    from dctsvd_tpu_torch.ops import color
    return color.ycrcb_planes_to_bgr(color.bgr_to_ycrcb_planes(frames))


def k14_k17_rows(dev, gray, frames, smooth, equal) -> dict:
    """K14 on the 1080p gray plane (the gray chain's weights) and on the
    BGR frame channels-last (the color chain's), K17 on the frame both
    ways, each against its twin run on the card (``equal``: torch.equal)
    there, on a 4K plane or frame, planes smaller than the blur's pad, a
    border-heavy one and a view off its 16-byte alignment; then each
    timed (and its device time alone, from torch.profiler) beside its
    twin (which is the eager form it replaced), its
    bound and, for K14, one F.conv2d of the same blur
    (:func:`conv_yardstick`)."""
    import torch
    from dctsvd_tpu_torch.ops import color, color_cuda
    from dctsvd_tpu_torch.ops import enhance as e_ops
    from dctsvd_tpu_torch.ops import enhance_cuda as ec

    big = torch.randint(0, 256, (*METRIC_SHAPES["4k"], 3), device=dev,
                        dtype=torch.uint8,
                        generator=torch.Generator(device=dev).manual_seed(
                            20261027))
    rows = {}
    for name, x, cl, aw in (("unsharp", gray, False, (1.25, -0.25)),
                            ("unsharp_color", frames, True, (1.15, -0.15))):
        cases = {"1080p": x, "4k": big if cl else big[..., 0].contiguous(),
                 **{k: smooth((*shp, 3) if cl else shp)
                    for k, shp in {**METRIC_SHAPES,
                                   **UNSHARP_SHAPES}.items() if k != "4k"},
                 "offset": offset_view(x)}
        checks = {case: equal(name, case, ec.unsharp(xi, *aw, 1.0, cl),
                              e_ops.unsharp_plain(xi, *aw, 1.0, cl))
                  for case, xi in cases.items()}
        h, w = x.shape[-3:-1] if cl else x.shape[-2:]
        planes = (torch.movedim(x.reshape(-1, h, w, 3), -1, -3) if cl
                  else x.reshape(-1, 1, h, w)).to(torch.float32)
        plain_ms = cuda_time(lambda: e_ops.unsharp_plain(x, *aw, 1.0, cl), 5)
        _, clocks = clocked_ms(lambda: ec.unsharp(x, *aw, 1.0, cl), 20)
        rows[name] = dict(
            shape=list(x.shape), checks=checks,
            max_abs_err=max(c["max_abs_err"] for c in checks.values()),
            ms=cuda_time(lambda: ec.unsharp(x, *aw, 1.0, cl), 20),
            device_ms=device_ms(lambda: ec.unsharp(x, *aw, 1.0, cl), 20,
                                "unsharp_kernel"),
            plain_ms=plain_ms, eager_ms=plain_ms,
            library_ms=cuda_time(conv_yardstick(planes, 1.0, 7), 20),
            issue_bound_ms=insn_bound_ms(UNSHARP_OPS * x.numel(),
                                         clocks["sm_mhz"]),
            issue_clocks=clocks,
            **bound(x.numel(), UNSHARP_OPS, 2 * x.numel()))
    planes_c = color_cuda.bgr_to_ycrcb_planes(frames)
    for name, x, inverse in (("bgr_to_ycrcb_planes", frames, False),
                             ("ycrcb_planes_to_bgr", planes_c, True)):
        kern = getattr(color_cuda, name)
        twin = getattr(color, f"{name}_plain")
        cases = {"1080p": x}
        for k, shp in (("4k", METRIC_SHAPES["4k"]),
                       *((k, v) for k, v in METRIC_SHAPES.items()
                         if k != "4k")):
            bgr = big if k == "4k" else smooth((*shp, 3))
            cases[k] = color_cuda.bgr_to_ycrcb_planes(bgr) if inverse \
                else bgr
        cases["offset"] = offset_view(x)
        checks = {case: equal(name, case, kern(xi), twin(xi))
                  for case, xi in cases.items()}
        plain_ms = cuda_time(lambda: twin(x).contiguous(), 5)
        rows[name] = dict(
            shape=list(x.shape), checks=checks,
            max_abs_err=max(c["max_abs_err"] for c in checks.values()),
            ms=cuda_time(lambda: kern(x), 20),
            device_ms=device_ms(lambda: kern(x), 20,
                                "ycrcb_bgr" if inverse else "ycrcb_planes"),
            plain_ms=plain_ms, eager_ms=plain_ms, library_ms=None,
            **bound(x.numel(), 0, 2 * x.numel()))
    return rows


def enhance_stages(gray, frames) -> dict:
    """{name: call} of each enhancement stage and chain on a u8 gray plane
    and a u8 BGR frame, through the package's public functions."""
    from dctsvd_tpu_torch.models import enhance
    from dctsvd_tpu_torch.ops import color
    from dctsvd_tpu_torch.ops import enhance as e_ops
    ycc = color.bgr_to_ycrcb(frames)[..., 0]
    return {
        "nlm_gray": lambda: e_ops.nlm_gray_u8(gray, 7.0),
        "clahe_gray": lambda: e_ops.clahe_u8(gray),
        "unsharp_gray": lambda: e_ops.unsharp_u8(gray, 1.25, -0.25),
        "chain_gray": lambda: enhance.enhance_gray_u8(gray),
        "nlm_color": lambda: e_ops.nlm_color_u8(frames, 3.0, 3.0),
        "clahe_luma": lambda: e_ops.clahe_u8(ycc),
        "unsharp_color": lambda: e_ops.unsharp_u8(frames, 1.15, -0.15,
                                                  channels_last=True),
        "ycrcb_pair": lambda: ycrcb_pair(frames),
        "chain_color": lambda: enhance.enhance_color_u8(frames),
    }


def phase_enhance(dev, extracted):
    """The enhancement chains on the 1080p extracted watermarks, with any
    degradation warning an error: K10's, K11's, K14's and K17's counters
    set to 0 just before each chain and read just after (each launches
    K10, both K11 kernels and K14 once, the color chain K17 once each way,
    neither the eager blur nor the channels-last YCrCb pair); each stage's
    time, and each chain's with the eager NLM, CLAHE, unsharp and YCrCb
    pair in the kernels' places; K10, K11, K14 and K17 against their twins
    (:func:`enhance_rows`); and every stage on the card against the CPU
    on a small plane (unsharp and CLAHE within 1 quantum, NLM within 1 on
    >= 99 % of pixels, the chains' mean |Δ| < 0.5). Returns (the kernel
    rows, the chains' launches)."""
    import warnings
    import cv2
    import numpy as np
    import torch
    from dctsvd_tpu_torch.models import enhance
    from dctsvd_tpu_torch.ops import enhance as e_ops

    gray, frames = extracted["gray"], extracted["color"]
    stages = enhance_stages(gray, frames)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        launches, outs = {}, {}
        for chain, fn, x in (("chain_gray", enhance.enhance_gray_u8, gray),
                             ("chain_color", enhance.enhance_color_u8,
                              frames)):
            with launch_counts() as launches[chain]:
                outs[chain] = fn(x)
        for chain, n in launches.items():
            ycc = int(chain == "chain_color")
            require(all(n[k] == 1 for k in ENHANCE_KERNELS)
                    and all(n[k] == ycc for k in YCRCB_KERNELS)
                    and not any(n["eager"].values())
                    and not any(n[k] for k in METRIC_KERNELS),
                    f"{chain}: K10's, K11's, K14's and K17's launches and "
                    f"the eager forms' calls {n}")
        out_g, out_c = outs["chain_gray"], outs["chain_color"]
        ms = {name: cuda_time(fn, 2) for name, fn in stages.items()}
        with eager_enhance():
            eager_g = enhance.enhance_gray_u8(gray)
            eager_c = enhance.enhance_color_u8(frames)
            for name in ("chain_gray", "chain_color"):
                ms[f"{name}_eager"] = cuda_time(stages[name], 1)
    require(out_g.shape == gray.shape and out_c.shape == frames.shape
            and out_g.dtype == torch.uint8, "enhance outputs")
    vs_eager = {"chain_gray": differ(out_g, eager_g),
                "chain_color": differ(out_c, eager_c)}
    rows = enhance_rows(dev, gray, frames)
    for name, row in rows.items():
        kern = ("K10" if "nlm" in name else "K14" if "unsharp" in name
                else "K17" if "ycrcb" in name else "K11")
        emit({"phase": "kernel_vs_plain", "kernel": f"{kern} {name}",
              **row})

    rng = np.random.default_rng(13)
    plane = cv2.GaussianBlur(rng.integers(0, 256, (64, 80), np.uint8),
                             (0, 0), 1.0)
    img = cv2.GaussianBlur(rng.integers(0, 256, (64, 80, 3), np.uint8),
                           (0, 0), 1.0)

    def both(fn, x):
        return [fn(torch.as_tensor(x, device=d)).cpu().numpy().astype(int)
                for d in ("cpu", dev)]

    diffs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for name, fn, x in (
                ("unsharp", lambda t: e_ops.unsharp_u8(t, 1.25, -0.25),
                 plane),
                ("clahe", e_ops.clahe_u8, plane),
                ("nlm_gray", e_ops.nlm_gray_u8, plane),
                ("nlm_color", e_ops.nlm_color_u8, img),
                ("chain_gray", enhance.enhance_gray_u8, plane),
                ("chain_color", enhance.enhance_color_u8, img)):
            a, b = both(fn, x)
            d = np.abs(a - b)
            diffs[name] = dict(max=int(d.max()), share=float((d > 0).mean()),
                               share_over_1=float((d > 1).mean()),
                               mean=float(d.mean()))
    for name in ("unsharp", "clahe"):
        require(diffs[name]["max"] <= 1, f"{name} GPU vs CPU {diffs[name]}")
    for name in ("nlm_gray", "nlm_color"):
        d = diffs[name]
        require(d["share_over_1"] <= 0.01, f"{name} GPU vs CPU {d}")
    for name in ("chain_gray", "chain_color"):
        require(diffs[name]["mean"] < 0.5, f"{name} GPU vs CPU {diffs[name]}")
    emit({"phase": "enhance_1080p", "ms": ms, "launches": launches,
          "chains_vs_eager": vs_eager, "gpu_vs_cpu_64x80": diffs,
          "card": smi_line()})
    return rows, launches


def enhance_times(dev) -> dict:
    """The enhancement stages' and chains' ms (CUDA events, a warm-up and 3
    calls) on a seeded 1080p watermark, gray and color, through this
    tree's package (the stages: NLM, CLAHE, unsharp, the color NLM's YCrCb
    pair), the chains' SHA-256, the launches of every wrapper the tree
    counts in one chain each, and K10, K11, K14 and K9 alone
    (:func:`kernel_times`): run in an older tree that has K14-K17 and
    this one in turns."""
    import torch
    from dctsvd_tpu_torch.ops import color, color_cuda, enhance_cuda
    from dctsvd_tpu_torch.ops import metrics_cuda

    frames = torch.as_tensor(smooth_frame(20261019), device=dev)
    stages = enhance_stages(color.bgr_to_gray(frames), frames)
    ms = {name: cuda_time(fn, 3) for name, fn in stages.items()}
    # the tree's own counted wrappers, whichever it has
    wrappers = {n: f for m in (enhance_cuda, metrics_cuda, color_cuda)
                for n, f in vars(m).items()
                if callable(f) and hasattr(f, "launches")}
    launches = {}
    for chain in ("chain_gray", "chain_color"):
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        stages[chain]()
        torch.cuda.synchronize()
        launches[chain] = {n: w.launches for n, w in wrappers.items()}
    return dict(tree=REPO, ms=ms, launches=launches,
                outputs={name: list(stages[name]().shape)
                         for name in ("chain_gray", "chain_color")},
                digests={name: hashlib.sha256(
                    stages[name]().cpu().numpy().tobytes()).hexdigest()
                    for name in ("chain_gray", "chain_color")},
                kernels=kernel_times(dev, frames))


def clahe_scratch_times(gray) -> dict:
    """K11 in one call (``enhance_cuda.clahe``) on the gray 1080p plane
    [1, H, W] with its scratch kept a stream (the wrapper's: the finishing
    CTAs leave it zero) and with a fresh ``torch.zeros`` a call, in turns
    (kept, fresh, fresh, kept; CUDA events, 20 calls a reading), each
    torch.equal to the twins."""
    import torch
    from dctsvd_tpu_torch.ops import enhance as e_ops
    from dctsvd_tpu_torch.ops import enhance_cuda as ec
    kept = ec._clahe_scratch

    def fresh(device, p, tiles):
        n = p * tiles * tiles
        return (torch.zeros((n * 257,), dtype=torch.int32, device=device),
                torch.empty((n * 256,), dtype=torch.uint8, device=device))

    ref = e_ops.clahe_apply_plain(gray, e_ops.clahe_luts_plain(gray))
    ms = {"kept": [], "fresh": []}
    try:
        for form in ("kept", "fresh", "fresh", "kept"):
            ec._clahe_scratch = kept if form == "kept" else fresh
            require(torch.equal(ec.clahe(gray), ref),
                    f"K11 with its {form} scratch: not bit-equal")
            ms[form].append(cuda_time(lambda: ec.clahe(gray), 20))
    finally:
        ec._clahe_scratch = kept
    return ms


# ---------------------------------------------------------------------------
# K14-K17: the embed metrics (SSIM, PSNR), unsharp and the color NLM's
# YCrCb pair
# ---------------------------------------------------------------------------

def eager_ssim(img1, img2):
    """The eager SSIM K15 replaced (ops/metrics.py::ssim at commit effe12c):
    the twin's map of five shift-and-add blurs, then torch.mean."""
    import torch
    from dctsvd_tpu_torch.ops.metrics_cuda import ssim_map
    return torch.mean(ssim_map(img1, img2), dim=(-2, -1))


def eager_psnr(a, b, image_ndim=None):
    """The eager PSNR K16 replaced (ops/metrics.py::psnr at commit effe12c):
    the f32 mean of squared differences an image."""
    import torch
    from dctsvd_tpu_torch.ops.metrics_cuda import psnr_of_mse
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if image_ndim is None:
        image_ndim = 3 if (a.ndim >= 3 and a.shape[-1] <= 4) else 2
    dims = tuple(range(a.ndim - min(image_ndim, a.ndim), a.ndim))
    return psnr_of_mse(torch.mean((a - b) ** 2, dim=dims))


@contextlib.contextmanager
def eager_metrics():
    """The eager PSNR and SSIM in the kernels' places (every caller reads
    them from ops/metrics.py at each call)."""
    from dctsvd_tpu_torch.ops import metrics
    saved = metrics.psnr, metrics.ssim
    metrics.psnr, metrics.ssim = eager_psnr, eager_ssim
    try:
        yield
    finally:
        metrics.psnr, metrics.ssim = saved


def metrics_wrappers() -> dict:
    """K15's and K16's wrappers."""
    from dctsvd_tpu_torch.ops import metrics_cuda
    return {"ssim": metrics_cuda.ssim, "psnr": metrics_cuda.psnr}


def metrics_inputs(covers, wm_u8, blk, intra) -> dict:
    """The embed metrics' inputs on the batch of frames: the prepared gray
    and color watermarks (``pwg``, ``pwc``), the color embed's stego
    (``stego_c``), the gray embed's marked Y planes (``y_marked``, f32,
    unclipped: its SSIM's second input), the covers' and the color stego's
    u8 gray planes (``gray``, ``gray_s``)."""
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import color
    pwg = blocked.prepare_wm_gray(color.bgr_to_gray(wm_u8), blk, intra)
    pwc = blocked.prepare_wm_color(wm_u8, blk, intra)
    stego_c = blocked.embed_color_prepared(covers, pwc.sw, ALPHA,
                                           with_metrics=False)[0]
    y_marked = blocked._embed_planes(color.luma_f32(covers), pwg.sw, ALPHA,
                                     blocked.K_FRAC_DEFAULT)[0]
    return dict(pwg=pwg, pwc=pwc, stego_c=stego_c, y_marked=y_marked,
                gray=color.bgr_to_gray(covers),
                gray_s=color.bgr_to_gray(stego_c))


def held_equal(name, case, got, ref) -> dict:
    """A kernel's output against its twin's on the card: torch.equal, or
    the run fails."""
    import torch
    d = float((got.to(torch.float64) - ref.to(torch.float64)).abs()
              .max()) if got.numel() else 0.0
    require(torch.equal(got, ref), f"{name} on {case} {list(got.shape)}: "
            f"not bit-equal to its twin ({d})")
    return dict(shape=list(got.shape), max_abs_err=d, equals_twin=True)


def metric_rows(dev, covers, inp) -> dict:
    """K15 on the gray embed's pair (the covers' u8 gray planes, the marked
    f32 Y: ``ssim``) and on the color embed's (u8, u8: ``ssim_u8``), K16 on
    the covers and the color stego (``psnr``), at the batch of 32 1080p
    frames: each torch.equal to its twin run on the card there, on a 4K
    plane or frame pair, 3x5 and 37x51 ones and a view off its 16-byte
    alignment; timed (CUDA events; the kernels' device time alone from
    torch.profiler) beside the twin, the eager form it
    replaced (:func:`eager_ssim`, :func:`eager_psnr`), its bound (K15 also
    its issue bound at the SM clock read while it runs) and, for K15, one
    F.conv2d of its five blurs on their reflect-padded stack
    (:func:`conv_yardstick`; psnr has no one PyTorch call); K15's rows
    also its shared-memory loads and bytes a pixel and its restated bound
    (:func:`ssim_bounds`)."""
    import torch
    from dctsvd_tpu_torch.ops import metrics_cuda as mc

    gen = torch.Generator(device=dev).manual_seed(20261028)

    def pair(shape, f32: bool):
        x = torch.randint(0, 256, shape, generator=gen, device=dev,
                          dtype=torch.uint8)
        y = x + 4 * torch.randn(shape, generator=gen, device=dev)
        return x, (y if f32 else y.round().clamp(0, 255).to(torch.uint8))

    rows = {}
    for name, x, y in (("ssim", inp["gray"], inp["y_marked"]),
                       ("ssim_u8", inp["gray"], inp["gray_s"])):
        f32 = y.dtype == torch.float32
        cases = {"1080p": (x, y),
                 **{k: pair((1, *shp), f32)
                    for k, shp in METRIC_SHAPES.items()},
                 "offset": (offset_view(x[:2]), offset_view(y[:2]))}
        checks = {case: held_equal(name, case, mc.ssim(*xy),
                                   mc.ssim_plain(*xy))
                  for case, xy in cases.items()}
        ms, clocks = clocked_ms(lambda: mc.ssim(x, y), 10)
        xf, yf = x.to(torch.float32), y.to(torch.float32)
        stack = torch.stack([xf, yf, xf * xf, yf * yf, xf * yf], 1)
        del xf, yf
        rows[name] = dict(
            shape=list(x.shape), dtypes=[str(x.dtype), str(y.dtype)],
            checks=checks,
            max_abs_err=max(c["max_abs_err"] for c in checks.values()),
            ms=ms, device_ms=device_ms(lambda: mc.ssim(x, y), 5, "ssim_"),
            plain_ms=cuda_time(lambda: mc.ssim_plain(x, y), 2),
            eager_ms=cuda_time(lambda: eager_ssim(x, y), 2),
            library_ms=cuda_time(conv_yardstick(stack, 1.5, 11), 3),
            **bound(x.numel(), SSIM_OPS, nbytes(x, y) + 4 * x.shape[0]),
            issue_bound_ms=insn_bound_ms(SSIM_OPS * x.numel(),
                                         clocks["sm_mhz"]),
            **ssim_bounds(x.numel(), clocks["sm_mhz"]),
            issue_clocks=clocks)
        del stack
    a, b = covers, inp["stego_c"]
    cases = {"1080p": (a, b),
             **{k: pair((1, *shp, 3), False)
                for k, shp in METRIC_SHAPES.items()},
             "offset": (offset_view(a[:2]), offset_view(b[:2]))}
    checks = {case: held_equal("psnr", case, mc.psnr(*ab), mc.psnr_plain(*ab))
              for case, ab in cases.items()}
    rows["psnr"] = dict(
        shape=list(a.shape), checks=checks,
        max_abs_err=max(c["max_abs_err"] for c in checks.values()),
        ms=cuda_time(lambda: mc.psnr(a, b), 20),
        device_ms=device_ms(lambda: mc.psnr(a, b), 20, "sq_diff"),
        plain_ms=cuda_time(lambda: mc.psnr_plain(a, b), 3),
        eager_ms=cuda_time(lambda: eager_psnr(a, b), 3), library_ms=None,
        **bound(a.numel(), PSNR_OPS, 2 * a.numel() + 4 * a.shape[0]))
    return rows


def phase_metrics(dev, covers, wm_u8, blk, intra):
    """The slice's embeds with metrics on the batch of 32 1080p frames,
    gray and color: each launches K15 and K16 once and no eager form
    (:func:`launch_counts`), its PSNR and SSIM equal to the twins' run on
    the card, PSNR > 20 dB, SSIM in (0, 1]; K15 and K16 against their
    twins (:func:`metric_rows`; the embeds' times are ``--metrics-times``'s).
    Returns (the kernel rows, the embeds' launches)."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import metrics_cuda as mc

    inp = metrics_inputs(covers, wm_u8, blk, intra)
    launches, values = {}, {}
    for scheme, embed, pw, second in (
            ("gray", blocked.embed_gray_prepared, inp["pwg"],
             inp["y_marked"]),
            ("color", blocked.embed_color_prepared, inp["pwc"],
             inp["gray_s"])):
        with launch_counts() as n:
            stego, _, ps, ss = embed(covers, pw.sw, ALPHA)
        launches[scheme] = n
        require(all(n[k] == 1 for k in METRIC_KERNELS)
                and not any(n["eager"].values())
                and not any(n[k] for k in (*ENHANCE_KERNELS,
                                           *YCRCB_KERNELS)),
                f"embed_{scheme}_prepared: K15's and K16's launches and "
                f"the eager forms' calls {n}")
        require(torch.equal(ps, mc.psnr_plain(covers, stego))
                and torch.equal(ss, mc.ssim_plain(inp["gray"], second)),
                f"embed_{scheme}_prepared: its metrics differ from the "
                f"twins' run on the card")
        require(bool(torch.isfinite(ps).all()) and float(ps.min()) > 20.0
                and float(ss.min()) > 0.0 and float(ss.max()) <= 1.0,
                f"embed_{scheme}_prepared: psnr {ps.tolist()} ssim "
                f"{ss.tolist()}")
        values[scheme] = dict(psnr_min=float(ps.min()),
                              ssim_min=float(ss.min()))
    rows = metric_rows(dev, covers, inp)
    for name, row in rows.items():
        emit({"phase": "kernel_vs_plain",
              "kernel": f"{'K16' if name == 'psnr' else 'K15'} {name}",
              **row})
    emit({"phase": "metrics_1080p", "batch": BATCH, "launches": launches,
          "values": values, "card": smi_line()})
    return rows, launches


def kernel_sass(stems) -> dict:
    """The ptxas report (when this run built the library) and the SASS mix
    by class (utils/kernels.py::sass_mix: the body once, and each loop's
    body) of every kernel instance whose name holds one of ``stems``."""
    from dctsvd_tpu_torch.utils import kernels

    def ours(name):
        return any(s in name for s in stems)
    sass = kernels.sass_dump(kernels.BUILD_INFO["path"])
    return dict(
        ptxas={n: v for n, v in kernels.ptxas_report(
            kernels.BUILD_INFO.get("ptxas", "")).items() if ours(n)},
        sass={n: dict(main=m["main"], loops=m["loops"])
              for n, m in kernels.sass_mix(sass, 2).items() if ours(n)})


def metrics_times(dev, covers, wm_u8, blk, intra) -> dict:
    """SSIM, PSNR and the embed with and without its metrics on the batch
    of 32 1080p frames, gray and color, through this tree's package, each
    beside the eager form (:func:`eager_ssim`, :func:`eager_psnr`; the
    embeds under :func:`eager_metrics`) in turns: kernel, eager, eager,
    kernel (CUDA events, a warm-up and 3 calls a reading). The gray SSIM
    takes the gray embed's own pair (the covers' u8 gray planes and the
    marked f32 Y planes), the color SSIM the gray planes of cover and
    stego (u8, u8), PSNR the BGR frames. With each pair's values beside
    the eager form's, K15's device time on each SSIM pair, K15's and
    K16's launches in one embed with metrics where the tree has them, and
    K15's ptxas report and SASS mix (:func:`kernel_sass`)."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import metrics

    inp = metrics_inputs(covers, wm_u8, blk, intra)
    pwg, pwc, stego_c = inp["pwg"], inp["pwc"], inp["stego_c"]
    gray, gray_s, y_marked = inp["gray"], inp["gray_s"], inp["y_marked"]
    pairs = {
        "ssim_gray": (lambda: metrics.ssim(gray, y_marked),
                      lambda: eager_ssim(gray, y_marked)),
        "ssim_color": (lambda: metrics.ssim(gray, gray_s),
                       lambda: eager_ssim(gray, gray_s)),
        "psnr_color": (lambda: metrics.psnr(covers, stego_c),
                       lambda: eager_psnr(covers, stego_c)),
    }
    for scheme, embed, pw in (("gray", blocked.embed_gray_prepared, pwg),
                              ("color", blocked.embed_color_prepared, pwc)):
        def with_metrics(embed=embed, pw=pw):
            return embed(covers, pw.sw, ALPHA)

        def eager_with_metrics(embed=embed, pw=pw):
            with eager_metrics():
                return embed(covers, pw.sw, ALPHA)

        pairs[f"embed_{scheme}_metrics"] = (with_metrics, eager_with_metrics)
        pairs[f"embed_{scheme}"] = (
            lambda embed=embed, pw=pw: embed(covers, pw.sw, ALPHA,
                                             with_metrics=False),) * 2
    ms, values = {}, {}
    # K15 alone: its device time (torch.profiler) on each pair
    device = {name: device_ms(pairs[name][0], 5, "ssim_")
              for name in ("ssim_gray", "ssim_color")}
    for name, (fn, eager) in pairs.items():
        ms[name] = [cuda_time(fn, 3), cuda_time(eager, 3),
                    cuda_time(eager, 3), cuda_time(fn, 3)]
        if not name.startswith("embed"):
            got, ref = fn(), eager()
            values[name] = dict(min=float(got.min()), max=float(got.max()),
                                vs_eager=float((got.to(torch.float64)
                                                - ref.to(torch.float64))
                                               .abs().max()))
    launches = {}
    for scheme, embed, pw in (("gray", blocked.embed_gray_prepared, pwg),
                              ("color", blocked.embed_color_prepared, pwc)):
        torch.cuda.synchronize()
        for w in metrics_wrappers().values():
            w.launches = 0
        embed(covers, pw.sw, ALPHA)
        torch.cuda.synchronize()
        launches[scheme] = {n: w.launches
                            for n, w in metrics_wrappers().items()}
    return dict(tree=REPO, batch=int(covers.shape[0]), ms=ms, values=values,
                device_ms=device, launches=launches,
                k15=kernel_sass(("ssim_kernel",)))


# the SASS opcodes of nlm_weight_kernel that are not the weight: the
# thread's index and bound check, h2's load, the store and the exit
WEIGHT_FRAME_OPS = ("S2R", "S2UR", "LDC", "LDC.64", "ULDC", "ULDC.64",
                    "LDG.E.CONSTANT", "STG.E", "EXIT", "ISETP.GE.AND",
                    "IMAD", "IMAD.WIDE")


def sass_fast_path(sass: str, stem: str) -> list:
    """The SASS opcodes that one thread of the one function whose mangled
    name holds ``stem`` executes on its fast path, in order: from the
    start to its first unpredicated EXIT, leaving out each IEEE division's
    slow path (in a BSSY .. BSYNC region, what follows the region's
    branch)."""
    from dctsvd_tpu_torch.utils import kernels
    parts = [p for p in sass.split("Function : ")[1:]
             if stem in p.split(None, 1)[0]]
    require(len(parts) == 1, f"SASS of {stem}: {len(parts)} functions")
    ops, regions = [], []          # per open region: past its branch?
    for ln in parts[0].splitlines():
        m = kernels._SASS_INSN.search(ln)
        if not m or m[2] == "NOP":
            continue
        op = m[2]
        if op.startswith("BSYNC") and regions:
            regions.pop()
        elif any(regions):
            continue
        ops.append(op)
        if op.startswith("BSSY"):
            regions.append(False)
        elif op.startswith("BRA") and regions:
            regions[-1] = True
        if op == "EXIT" and not re.search(r"\*/\s+@", ln):
            break
    return ops


@functools.lru_cache(maxsize=None)
def weight_sass() -> tuple:
    """The SASS opcodes of K10's weight a pixel and offset: the weight
    kernel's fast path (:func:`sass_fast_path`) less WEIGHT_FRAME_OPS,
    read once from this run's library."""
    from dctsvd_tpu_torch.utils import kernels
    ops = sass_fast_path(kernels.sass_dump(kernels.BUILD_INFO["path"]),
                         "nlm_weight_kernel")
    return tuple(op for op in ops if op not in WEIGHT_FRAME_OPS)


def nlm_weight_issue(planes, fn) -> dict:
    """K10's weight issue bound on u8 planes [P, H, W]: :func:`weight_sass`
    a pixel and offset at one instruction a lane a clock, at the SM clock
    nvidia-smi reads while ``fn`` (K10 on those planes) runs 20 times."""
    _, clocks = clocked_ms(fn, 20)
    ops = len(weight_sass()) * planes.numel() * SEARCH_OFFSETS
    return dict(issue_bound_ms=insn_bound_ms(ops, clocks["sm_mhz"]),
                weight_sass=len(weight_sass()), issue_clocks=clocks)


def device_ms(fn, reps: int, stem: str):
    """Mean device time a call (ms) of the kernels whose name holds
    ``stem``, summed from torch.profiler's CUDA activity over ``reps``
    calls after a warm-up (None where the trace holds no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", None)
                or getattr(e, "cuda_time_total", 0)
                for e in prof.key_averages() if stem in e.key)
    return total / reps / 1e3 or None


def k9_spectra(dev, frames: int, color_: bool, seed: int):
    """Seeded 1080p spectra on the card (tests/test_torch_gpu.py's
    _k9_inputs): sw [(3,) N, 8] sorted descending, sc [frames, (3,) N, 8]
    and s_cw = sc + α (sw · ratio + noise)."""
    import torch
    hb, wb = H // 8, W // 8
    gen = torch.Generator(device=dev).manual_seed(seed)
    cd = (3,) if color_ else ()
    sw = torch.sort(torch.rand((*cd, hb * wb, 8), generator=gen,
                               device=dev) * 40, dim=-1,
                    descending=True).values
    sc = torch.rand((frames, *cd, hb * wb, 8), generator=gen,
                    device=dev) * 200
    ratios = 0.6 + 0.5 * torch.rand((frames,), generator=gen, device=dev)
    hat = (sw * ratios.reshape(frames, *[1] * sw.ndim)
           + 4 * torch.randn(sc.shape, generator=gen, device=dev))
    return sc + ALPHA * hat, sc, sw


def kernel_times(dev, frames) -> dict:
    """K10 and K9 alone at the main path's shapes, through this tree's
    wrappers (so in an older tree, its kernels): K10 on the gray 1080p
    plane of ``frames`` (h² 49), its three YCrCb planes (h² 9) and a
    uniform-noise gray plane (h² 49, where most window sums pass the
    weight's cutoff); K9 on seeded gray spectra of 32 and 128 frames and
    color ones of 128. Each torch.equal to its twin run on the card
    first, then two readings (CUDA events, a warm-up each; K10 5 calls a
    reading, K9 20, which the host's launches can pace) and K9's device
    time from torch.profiler (:func:`device_ms`: its band and median
    kernels), each beside its bound; the
    registers and spills of K10's and K9's instances when this run built
    the library, and K10's weight issue bound (:func:`nlm_weight_issue`)."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import color, detect_cuda
    from dctsvd_tpu_torch.ops import enhance as e_ops
    from dctsvd_tpu_torch.ops import enhance_cuda as ec
    from dctsvd_tpu_torch.utils import kernels

    gen = torch.Generator(device=dev).manual_seed(20261019)
    gray = color.bgr_to_gray(frames).reshape(1, H, W).contiguous()
    ycc = torch.movedim(color.bgr_to_ycrcb(frames), -1, -3)
    noise = torch.randint(0, 256, (1, H, W), generator=gen, device=dev,
                          dtype=torch.uint8)
    rows = {}
    for name, planes, h2v in (("nlm_gray", gray, 49.0),
                              ("nlm_color", ycc.contiguous(), 9.0),
                              ("nlm_noise", noise, 49.0)):
        h2 = torch.full((planes.shape[0],), h2v, device=dev)
        got = ec.nlm_planes(planes, h2)
        require(torch.equal(got, e_ops.nlm_planes_plain(planes, h2)),
                f"K10 {name}: not bit-equal to its twin")
        rows[name] = dict(shape=list(planes.shape), h2=h2v,
                          equals_twin=True, ms=[cuda_time(
                              lambda: ec.nlm_planes(planes, h2), 5)
                              for _ in range(2)], **nlm_bound(planes))
        rows[name].update(nlm_weight_issue(
            planes, lambda: ec.nlm_planes(planes, h2)))
    rows.update(k11_k14_times(dev, gray, frames))
    alpha = blocked._alpha(ALPHA, dev)
    hb, wb = H // 8, W // 8
    bands = hb // 4 * 4 * (wb // 4 * 4)
    for name, n_frames, color_ in (("band_gray_32", 32, False),
                                   ("band_gray_128", 128, False),
                                   ("band_color_128", 128, True)):
        s_cw, sc, sw = k9_spectra(dev, n_frames, color_, 20261020 + n_frames)

        def k9(s_cw=s_cw, sc=sc, sw=sw):
            return detect_cuda.band_scores(s_cw, sc, sw, alpha, K, hb, wb)

        require(torch.equal(k9(), detect_cuda.band_scores_plain(
            s_cw, sc, sw, alpha, K, hb, wb)),
            f"K9 {name}: not bit-equal to its twin")
        planes = s_cw[..., 0, 0].numel()
        moved = ((2 * planes + sw[..., 0, 0].numel()) * bands * 32
                 + 4 * n_frames)
        rows[name] = dict(shape=list(s_cw.shape), equals_twin=True,
                          ms=[cuda_time(k9, 20), cuda_time(k9, 20)],
                          device_ms=device_ms(k9, 20, "band_"),
                          **bound(planes * bands, band_ops(K), moved))
        del s_cw, sc, sw
    out = dict(rows=rows)
    if kernels.BUILD_INFO.get("ptxas"):
        out["ptxas"] = {n: v for n, v in kernels.ptxas_report(
            kernels.BUILD_INFO["ptxas"]).items()
            if any(k in n for k in ("nlm_", "band_", "clahe_", "unsharp_"))}
    out["nlm_weight_sass"] = list(weight_sass())
    out["k11_k14_sass"] = k11_k14_sass()
    return out


def k11_k14_times(dev, gray, frames) -> dict:
    """K11's two kernels and K14 alone at the main path's shapes, through
    this tree's wrappers (so in an older tree, its kernels): the LUTs and
    the interpolation on the gray 1080p plane ``gray`` [1, H, W], K14 on
    it (the gray chain's weights) and on the BGR frame ``frames`` (the
    color chain's); each torch.equal to its twin run on the card first,
    then two readings of 20 calls through the wrapper (CUDA events, which
    the host's launches can pace) and the kernel's device time alone
    (torch.profiler), beside its bound; K14 also beside its issue bound
    (UNSHARP_OPS f32 instructions a pixel and channel at one a lane a
    clock, at the SM clock read while it runs); and the gray chain's CLAHE
    and unsharp stages through ``clahe_u8`` and ``unsharp_u8`` (two
    readings of 20 calls; in this tree ``clahe_u8`` is both K11 kernels
    from one host call)."""
    import torch
    from dctsvd_tpu_torch.ops import enhance as e_ops
    from dctsvd_tpu_torch.ops import enhance_cuda as ec

    luts = ec.clahe_luts(gray)
    require(torch.equal(luts, e_ops.clahe_luts_plain(gray))
            and torch.equal(ec.clahe_apply(gray, luts),
                            e_ops.clahe_apply_plain(gray, luts)),
            "K11: not bit-equal to its twins")
    frame = frames.reshape(H, W, 3)
    calls = {
        "clahe_luts": (lambda: ec.clahe_luts(gray), "clahe_lut",
                       clahe_bound(gray, True)),
        "clahe_apply": (lambda: ec.clahe_apply(gray, luts), "clahe_apply",
                        clahe_bound(gray, False)),
    }
    k14 = {"unsharp_gray": (gray[0], False, (1.25, -0.25)),
           "unsharp_color": (frame, True, (1.15, -0.15))}
    for name, (x, cl, aw) in k14.items():
        require(torch.equal(ec.unsharp(x, *aw, 1.0, cl),
                            e_ops.unsharp_plain(x, *aw, 1.0, cl)),
                f"K14 {name}: not bit-equal to its twin")
        calls[name] = (lambda x=x, cl=cl, aw=aw: ec.unsharp(x, *aw, 1.0, cl),
                       "unsharp_kernel",
                       bound(x.numel(), UNSHARP_OPS, 2 * x.numel()))
    rows = {}
    for name, (fn, stem, bnd) in calls.items():
        rows[name] = dict(equals_twin=True,
                          ms=[cuda_time(fn, 20), cuda_time(fn, 20)],
                          device_ms=device_ms(fn, 20, stem), **bnd)
        if name in k14:
            _, clocks = clocked_ms(fn, 20)
            rows[name].update(issue_bound_ms=insn_bound_ms(
                UNSHARP_OPS * k14[name][0].numel(), clocks["sm_mhz"]),
                issue_clocks=clocks)
    # the gray chain's CLAHE and unsharp stages through their public
    # functions (the host's part included)
    for name, fn in (("clahe_gray", lambda: e_ops.clahe_u8(gray[0])),
                     ("unsharp_gray_u8",
                      lambda: e_ops.unsharp_u8(gray[0], 1.25, -0.25))):
        rows[name] = dict(ms=[cuda_time(fn, 20), cuda_time(fn, 20)])
    return rows


def k11_k14_sass() -> dict:
    """K11's and K14's ptxas report and SASS mix by class
    (:func:`kernel_sass`), and K14's SASS a pixel and channel: its block
    loop's body (the largest loop) over the 16 pixels a thread takes in a
    block (None for a tree whose K14 has no such loop)."""
    out = kernel_sass(("clahe_", "unsharp_kernel"))
    per_pixel = {}
    for name, mix in out["sass"].items():
        if "unsharp_kernel" in name and mix["loops"]:
            body = max(mix["loops"], key=lambda c: sum(c.values()))
            per_pixel[name] = {k: v / 16 for k, v in body.items()}
            per_pixel[name]["total"] = sum(body.values()) / 16
    out["unsharp_sass_per_pixel"] = per_pixel
    return out


def seeded_nonces(n: int) -> list:
    """The first n embed nonces of a seeded sequence."""
    import numpy as np
    from dctsvd_tpu_torch.utils import crypto
    rng = np.random.default_rng(NONCE_SEED)
    return [rng.bytes(crypto.NONCE_BYTES) for _ in range(n)]


@contextlib.contextmanager
def pinned_nonce(nonce: bytes):
    """Embeds in this block take ``nonce`` instead of a random one."""
    from dctsvd_tpu_torch.utils import crypto
    made = crypto.make_nonce
    crypto.make_nonce = lambda: nonce
    try:
        yield
    finally:
        crypto.make_nonce = made


def phase_payload(dev, cover_np):
    """A text and a JSON payload through api.embed_payload /
    extract_payload, each embed with a nonce of a seeded sequence. The
    blocked method at 1080p must recover both exactly; K1's, K2's and
    K4's launches are counted from 0 just before its embeds and read just
    after its extracts. The parity method's min–max normalised bit-plane
    does not decode at 1080p in either package (outcome recorded), and on
    a 360×640 crop it decodes for some keys and not others, in the JAX
    package exactly as here: so it runs there with each of PAYLOAD_NONCES
    nonces on the card and on the CPU, the card must recover the payload
    for the same nonces as the CPU (whose outcomes the CPU tests hold to
    the JAX package's), and each payload must come back exactly for at
    least one nonce. Returns the launches, and whether the card recovered
    the text with the first nonce."""
    import torch
    from dctsvd_tpu_torch import api
    from dctsvd_tpu_torch.io import image_io
    from dctsvd_tpu_torch.ops import svd_cuda, wm_cuda
    wrappers = [svd_cuda.jacobi_svd8, wm_cuda.embed_blocks,
                wm_cuda.spectrum_blocks]
    payloads = {"text": PAYLOAD_TEXT,
                "json": {"owner": "chip-smoke", "id": 20261017,
                         "tags": ["parity", "blocked"]}}
    nonces = seeded_nonces(PAYLOAD_NONCES)
    rows, parity = {}, {}
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as td:
        covers = {"1080p": os.path.join(td, "cover.png"),
                  "360x640": os.path.join(td, "crop.png")}
        image_io.write_png(covers["1080p"], cover_np)
        image_io.write_png(covers["360x640"], cover_np[:360, :640])

        def run(method, size, kind, nonce, device):
            payload = payloads[kind]
            base = os.path.join(td, f"{method}_{size}_{kind}")
            t0 = time.perf_counter()
            with pinned_nonce(nonce):
                out, meta, ps, _ = api.embed_payload(
                    covers[size], payload, base + ".png",
                    base + "_meta.npz", alpha=0.15, password=PASSWORD,
                    method=method, device=device)
            t1 = time.perf_counter()
            try:
                got = api.extract_payload(out, meta, password=PASSWORD,
                                          device=device)
                outcome = "recovered" if got == payload else f"wrong: {got!r}"
            except ValueError as err:
                outcome = f"ValueError: {err}"
            return dict(outcome=outcome, psnr=ps, embed_s=t1 - t0,
                        extract_s=time.perf_counter() - t1)

        torch.cuda.synchronize()
        for fn in wrappers:
            fn.launches = 0
        for kind in payloads:
            rows[f"blocked_1080p_{kind}"] = run("blocked", "1080p", kind,
                                                nonces[0], dev)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in wrappers}
        for kind in payloads:
            rows[f"full_1080p_{kind}"] = run("full", "1080p", kind,
                                             nonces[0], dev)
            card = [run("full", "360x640", kind, n, dev) for n in nonces]
            cpu = [run("full", "360x640", kind, n, "cpu")["outcome"]
                   for n in nonces]
            got = [r["outcome"] for r in card]
            parity[kind] = dict(
                card=got, cpu=cpu, recovered=got.count("recovered"),
                same_outcomes=got == cpu,
                embed_s=[r["embed_s"] for r in card],
                extract_s=[r["extract_s"] for r in card])
    for kind in payloads:
        r = rows[f"blocked_1080p_{kind}"]["outcome"]
        require(r == "recovered", f"blocked 1080p {kind} payload: {r}")
        got, cpu = parity[kind]["card"], parity[kind]["cpu"]
        require([o == "recovered" for o in got] ==
                [o == "recovered" for o in cpu],
                f"parity 360x640 {kind} payload: the card recovered it for "
                f"other nonces than the CPU: {got} vs {cpu}")
        require(parity[kind]["recovered"] >= 1,
                f"parity 360x640 {kind} payload recovered for no nonce: "
                f"{got}")
    for name, n in launches.items():
        require(n >= 1, f"{name} was not launched on the blocked payload "
                f"path: {launches}")
    emit({"phase": "payload_1080p", **rows, "full_360x640": parity,
          "nonces": [n.hex() for n in nonces],
          "blocked_launches": launches, "card": smi_line()})
    return launches, parity["text"]["card"][0] == "recovered"


# ---------------------------------------------------------------------------
# Detect resync: K12 (the roll stack) and K13 (the counter-rotation)
# ---------------------------------------------------------------------------

RESYNC_CHUNK = 64         # the searches' default chunk of rolls
RESYNC_STEP = 0.05        # the rotation search's step (deg) ...
RESYNC_ROT = 0.5          # ... and range
RESYNC_ANGLE = 0.3        # the attacker's rotation
H4K, W4K = 2160, 3840     # the bench geometric config's frame
RESYNC_SEED = 20261026
# f32 operations of K13 a pixel (xx, yy; src_x, src_y 4 each; 2 floors, 2
# upper weights, 2 lower ones, 4 tap weights) and a channel (4 products,
# 3 sums; u8 adds the rounding and the clamp's 2)
ROT_OPS_PIXEL = 18
ROT_OPS_CHANNEL = 7
ROT_OPS_U8 = 3


def resync_wrappers():
    """K12's wrapper and K13's as the search calls it (a scan's angles in
    one launch)."""
    from dctsvd_tpu_torch.ops import resync_cuda
    return {"roll_stack": resync_cuda.roll_stack,
            "derotate_angles": resync_cuda.derotate_angles}


# the rotation search's coarse scan: its 20 nonzero angles (±0.5° at 0.05°)
SCAN_ANGLES = [k * s * RESYNC_STEP for k in range(1, 11) for s in (1, -1)]


def resync_ops():
    """(roll stack, counter-rotation, a scan's counter-rotations) as the
    search calls them now: resync_cuda's names (the kernels, or their twins
    inside :func:`resync_forms`; in a tree without derotate_angles, one
    derotate an angle), or an older tree's eager blocked._roll_stack and
    blocked._derotate."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    try:
        from dctsvd_tpu_torch.ops import resync_cuda as rc
    except ImportError:
        roll, derotate = blocked._roll_stack, blocked._derotate
    else:
        roll, derotate = rc.roll_stack, rc.derotate
        if hasattr(rc, "derotate_angles"):
            return roll, derotate, rc.derotate_angles

    def each(img, angles, color_frames=False):
        return torch.stack([derotate(img, a, color_frames=color_frames)
                            for a in angles])
    return roll, derotate, each


@contextlib.contextmanager
def resync_forms(eager: bool):
    """With ``eager``, K12's and K13's twins (the eager forms they replaced)
    in the kernels' places for every caller; an older tree, which has no
    kernels, runs its own eager forms either way."""
    try:
        from dctsvd_tpu_torch.ops import resync_cuda as rc
    except ImportError:
        yield
        return
    names = [n for n in ("roll_stack", "derotate", "derotate_angles")
             if hasattr(rc, n)]
    saved = {n: getattr(rc, n) for n in names}
    if eager:
        for n in names:
            setattr(rc, n, getattr(rc, f"{n}_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(rc, n, fn)


@contextlib.contextmanager
def counted_reads():
    """The search's host reads of scores (blocked._read_scores), one entry
    a read with its chunks; None in an older tree, which reads each
    chunk's scores as the chunk ends."""
    from dctsvd_tpu_torch.models import blocked
    real = getattr(blocked, "_read_scores", None)
    if real is None:
        yield None
        return
    reads = []
    blocked._read_scores = lambda parts: reads.append(len(parts)) or real(
        parts)
    try:
        yield reads
    finally:
        blocked._read_scores = real


def per_chunk_resync(img, sc, sw, alpha, *, window=8, chunk=RESYNC_CHUNK,
                     color_frames, rot_range=0.0, rot_step=RESYNC_STEP):
    """The search as it ran before the one-read scan, copied here: each
    chunk's scores read to the host as the chunk ends, through the roll
    stack and counter-rotation of :func:`resync_ops`."""
    import numpy as np
    import torch
    from dctsvd_tpu_torch.models import blocked
    _, derotate, _ = resync_ops()
    shifts = np.asarray(blocked._resync_shifts(window, 0), np.int64)
    pad = (-len(shifts)) % chunk
    if pad:
        shifts = np.concatenate([shifts, np.zeros((pad, 2), np.int64)])
    shifts_t = torch.as_tensor(shifts, device=img.device)
    best_score, best_shift, best_angle = -np.inf, (0, 0), 0.0

    def scan(angles):
        nonlocal best_score, best_shift, best_angle
        for a in angles:
            cand = img if a == 0.0 else derotate(img, a,
                                                 color_frames=color_frames)
            for i in range(0, len(shifts), chunk):
                scores = blocked._detect_shift_chunk(
                    cand, sc, sw, alpha, shifts_t[i:i + chunk],
                    sweeps=SWEEPS, color_frames=color_frames).cpu().numpy()
                j = int(np.argmax(scores))
                if float(scores[j]) > best_score:
                    best_score = float(scores[j])
                    best_shift, best_angle = tuple(shifts[i + j]), a

    scan(blocked._resync_angles(rot_range, rot_step))
    if rot_range > 0.0 and best_angle != 0.0:
        fine = rot_step / 5.0
        scan([best_angle + k * fine for k in (-4, -3, -2, -1, 1, 2, 3, 4)])
    return (best_score, (-int(best_shift[0]), -int(best_shift[1])),
            float(best_angle))


def resync_inputs(dev, cover_np, wm_u8, blk, intra) -> dict:
    """The searches' 1080p inputs: a blocked color and gray stego of
    ``cover_np`` rolled by (3, −5) px, the color stego rotated 0.3° with
    cv2, the gray one's luma plane, their sc and sw, the color meta, and a
    seeded 2160×3840 f32 plane (the bench geometric config's size)."""
    import cv2
    import numpy as np
    import torch
    from dctsvd_tpu_torch.io import meta as metaio
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import color

    cover = torch.as_tensor(cover_np, device=dev)
    res = blocked.embed_color(cover, wm_u8, blk, intra, ALPHA)
    gres = blocked.embed_gray(cover, color.bgr_to_gray(wm_u8), blk, intra,
                              ALPHA)
    stego = res.stego_bgr.cpu().numpy()
    meta = metaio.Meta(mode=metaio.MODE_BLOCKED_COLOR, payload_type="image",
                       alpha=ALPHA, kfrac=0.6, shape=(H, W), nonce=None,
                       digest=None, arrays={"Sc": res.sc.cpu().numpy(),
                                            "Sw": res.sw.cpu().numpy()},
                       sweeps=1, sweeps_xpairs=7)
    grolled = torch.roll(gres.stego_bgr, (3, -5), dims=(0, 1))
    m = cv2.getRotationMatrix2D((W / 2, H / 2), RESYNC_ANGLE, 1.0)
    gen = torch.Generator(device=dev).manual_seed(RESYNC_SEED)
    return dict(
        stego=res.stego_bgr, meta=meta, sc=res.sc, sw=res.sw,
        rolled=torch.as_tensor(np.roll(stego, (3, -5), axis=(0, 1)),
                               device=dev),
        rotated=torch.as_tensor(cv2.warpAffine(
            stego, m, (W, H), borderMode=cv2.BORDER_REPLICATE), device=dev),
        gstego=gres.stego_bgr, grolled=grolled, gsc=gres.sc, gsw=gres.sw,
        luma=color.luma_f32(grolled),
        plane_4k=torch.rand((H4K, W4K), generator=gen, device=dev) * 255)


def resync_split(dev, inp) -> dict:
    """How a 1080p search chunk's time splits (ms), through the roll stack
    and counter-rotation the search calls now (:func:`resync_ops`): the
    roll stack of 64 u8 color frames and of 64 f32 luma planes and K1 + K9
    on each stack (CUDA events, 5 calls after a warm-up); a whole chunk
    (roll, K1, K9) on the host clock over 8 chunks, once with no read and
    once with each chunk's scores read to the host as it ends: the read's
    cost is the difference; one counter-rotation of the rotated color
    frame, of the gray stego's luma plane and of the 2160×3840 f32 plane,
    and a scan's 20 (SCAN_ANGLES) of each as the search makes them (CUDA
    events, 5 calls)."""
    import numpy as np
    import torch
    from dctsvd_tpu_torch.models import blocked

    roll, derotate, derotate_scan = resync_ops()
    shifts = torch.as_tensor(np.asarray(blocked._resync_shifts(
        blocked.BLOCK, 0)[:RESYNC_CHUNK], np.int64), device=dev)
    out = {}
    for name, img, sc, sw, cl in (
            ("color", inp["rolled"], inp["sc"], inp["sw"], True),
            ("gray", inp["luma"], inp["gsc"], inp["gsw"], False)):
        spectrum = (blocked._frames_spectrum if cl
                    else blocked._plane_spectrum)
        stack = roll(img, shifts)

        def k1_k9(stack=stack, sc=sc, sw=sw, spectrum=spectrum):
            return blocked._detect_scores(spectrum(stack, SWEEPS), sc, sw,
                                          ALPHA, 0.6, H, W)

        def chunk(img=img, sc=sc, sw=sw, cl=cl):
            return blocked._detect_shift_chunk(img, sc, sw, ALPHA, shifts,
                                               sweeps=SWEEPS, color_frames=cl)

        out[f"roll_{name}_ms"] = cuda_time(lambda: roll(img, shifts), 5)
        out[f"k1_k9_{name}_ms"] = cuda_time(k1_k9, 5)
        del stack
        chunk()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(8):
            chunk()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(8):
            chunk().cpu()
        t2 = time.perf_counter()
        out[f"chunk_{name}_ms"] = (t1 - t0) / 8 * 1e3
        out[f"chunk_{name}_read_each_ms"] = (t2 - t1) / 8 * 1e3
        out[f"read_{name}_ms"] = (out[f"chunk_{name}_read_each_ms"]
                                  - out[f"chunk_{name}_ms"])
    for name, img, cl in (("color", inp["rotated"], True),
                          ("gray", inp["luma"], False),
                          ("gray_4k", inp["plane_4k"], False)):
        out[f"derotate_{name}_ms"] = cuda_time(
            lambda: derotate(img, RESYNC_ANGLE, color_frames=cl), 5)
        out[f"derotate_scan_{name}_ms"] = cuda_time(
            lambda: derotate_scan(img, SCAN_ANGLES, color_frames=cl), 5)
        out[f"derotate_scan_{name}_device_ms"] = device_ms(
            lambda: derotate_scan(img, SCAN_ANGLES, color_frames=cl), 5,
            "derotate_kernel")
    return out


def resync_searches(inp) -> dict:
    """The phase's three searches at 1080p: the color and gray translation
    searches on the rolled stegos and the color rotation search (±0.5° at
    0.05°, refined at 0.01°) on the rotated one."""
    from dctsvd_tpu_torch.models import blocked
    return {
        "shift_color": lambda: blocked.detect_color_resync(
            inp["rolled"], inp["sc"], inp["sw"], ALPHA, sweeps=SWEEPS),
        "shift_gray": lambda: blocked.detect_gray_resync(
            inp["grolled"], inp["gsc"], inp["gsw"], ALPHA, sweeps=SWEEPS),
        "rotation_color": lambda: blocked.detect_color_resync(
            inp["rotated"], inp["sc"], inp["sw"], ALPHA, sweeps=SWEEPS,
            rot_range=RESYNC_ROT, rot_step=RESYNC_STEP)}


def timed_search(fn) -> tuple:
    """(fn(), host seconds, the host reads of scores it made), the card
    synchronised on both sides."""
    import torch
    torch.cuda.synchronize()
    with counted_reads() as reads:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return out, dt, reads


def resync_times(dev, cover_np, wm_u8, blk, intra) -> dict:
    """The search and its chunks' parts at 1080p through this tree's
    package (copied into an older tree, that tree's): :func:`resync_split`
    and each of :func:`resync_searches` twice (host clock, with its host
    reads), with the kernels (``kernel``, where the tree has them) and with
    their twins in their places (``eager``); and K13's ptxas report and
    SASS mix (:func:`kernel_sass`)."""
    inp = resync_inputs(dev, cover_np, wm_u8, blk, intra)
    try:
        from dctsvd_tpu_torch.ops import resync_cuda  # noqa: F401
        forms = (("kernel", False), ("eager", True))
    except ImportError:
        forms = (("eager", True),)
    out = {}
    for form, eager in forms:
        with resync_forms(eager):
            split = resync_split(dev, inp)
            runs = {}
            for name, fn in resync_searches(inp).items():
                runs[name] = []
                for _ in range(2):
                    (score, shift, angle), dt, reads = timed_search(fn)
                    runs[name].append(dict(s=dt, reads=reads, score=score,
                                           shift=list(shift), angle=angle))
        out[form] = dict(split=split, searches=runs)
    return dict(tree=REPO, **out, k13=kernel_sass(("derotate_kernel",)))


def phase_resync(dev, cover_np, wm_u8, blk, intra):
    """detect resync at 1080p on blocked stegos (:func:`resync_inputs`):
    the color and gray translation searches of a stego rolled by (3, −5)
    px, detect_paths(resync=True) on the color one, and the rotation
    search (rot_range 0.5) of the color stego rotated 0.3°.

    First K12 and K13 against their twins run on the card, torch.equal: K12
    on the first chunk of 64 rolls of each search's input (u8 color frames
    [64, H, W, 3], f32 luma planes [64, H, W]), K13 on the rotated color
    frame, the luma plane and a 2160×3840 f32 plane at 0.3° and at the
    rotation search's 20 coarse angles in one launch (every slice); K1 is
    held to its twin bit for bit on both stacks. Each is timed (CUDA events
    around the wrapper, per scan and per angle for K13's scan, and the
    kernel's device time from torch.profiler) beside its bound, its twin
    (the eager form it replaced) and one PyTorch call computing the same
    function (K12: the advanced-indexing gather with its indices made
    beforehand; K13: grid_sample on the frame as f32, bilinear, zeros
    outside, over the same angles with their grids made beforehand). Then
    the chunk's split (:func:`resync_split`) and each search (host clock)
    before, with the eager forms in the kernels' places and
    each chunk's scores read as it ends (:func:`per_chunk_resync`), and
    after, through the port; each search finds the same score, shift and
    angle both ways.

    The counters of K1, K9, K12 and K13 are set to 0 just before each
    search and read just after: K1, K9 and K12 launch once a chunk (and
    K1, K9 once more for detect_paths' aligned detect), K13 (through
    derotate_angles) and rotation_cs_batch's ops once a scan with a nonzero
    angle, derotate and rotation_cs never; the search reads its scores to
    the host once a scan (twice for the rotation search). The rotation
    search runs once more with each scan's candidates held to
    derotate_plain. K6's and K7's counters are set to 0
    just before the gray search and read just after (it launches luma_f32
    once, and no other). Returns (K1's launches on each search, K6's and
    K7's on the gray search, K9's on each search, K12's and K13's on each
    search, the kernel rows)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import detect_cuda, resync_cuda, wm_cuda

    inp = resync_inputs(dev, cover_np, wm_u8, blk, intra)
    shifts = blocked._resync_shifts(blocked.BLOCK, 0)
    n_chunks = -(-len(shifts) // RESYNC_CHUNK)
    first = torch.as_tensor(np.asarray(shifts[:RESYNC_CHUNK], np.int64),
                            device=dev)
    sched = blocked.replay_sweeps(SWEEPS)

    # K12 and K13 against their twins, timed; K1 on K12's stacks
    rows, twin = {}, {}
    for name, img, kw in (("roll_stack", inp["rolled"],
                           dict(channels_last=True)),
                          ("roll_stack_gray", inp["luma"], {})):
        stack = resync_cuda.roll_stack(img, first)
        ref = resync_cuda.roll_stack_plain(img, first)
        require(torch.equal(stack.view(torch.uint8), ref.view(torch.uint8)),
                f"K12 {name} {list(stack.shape)}: not equal to its twin")
        del ref
        got = wm_cuda.spectrum_blocks(stack, sweeps=sched, **kw)
        ref = wm_cuda.spectrum_blocks_plain(stack, sweeps=sched, **kw)
        err = float((got - ref).abs().max())
        require(torch.equal(got, ref),
                f"K1 on a resync chunk {list(stack.shape)} vs twin: "
                f"not bit-equal ({err})")
        twin[name] = dict(shape=list(stack.shape), max_abs_err=err,
                          equals_twin=True)
        del got, ref
        h, w = img.shape[0], img.shape[1]
        ridx = torch.remainder(torch.arange(h, device=dev)[None, :]
                               - first[:, :1], h)[:, :, None]
        cidx = torch.remainder(torch.arange(w, device=dev)[None, :]
                               - first[:, 1:], w)[:, None, :]
        plain_ms = cuda_time(lambda: resync_cuda.roll_stack_plain(img, first),
                             5)
        rows[name] = dict(
            shape=list(stack.shape), max_abs_err=0.0, equals_twin=True,
            ms=cuda_time(lambda: resync_cuda.roll_stack(img, first), 5),
            device_ms=device_ms(lambda: resync_cuda.roll_stack(img, first),
                                5, "roll_rows"),
            plain_ms=plain_ms, eager_ms=plain_ms,
            library_ms=cuda_time(lambda: img[ridx, cidx], 5),
            **bound(1, 0, nbytes(img, stack)))
        del stack, ridx, cidx
    require(SCAN_ANGLES == blocked._resync_angles(RESYNC_ROT,
                                                   RESYNC_STEP)[1:],
            "SCAN_ANGLES is not the rotation search's coarse scan")
    n_angles = len(SCAN_ANGLES)
    for name, img, cl in (("derotate", inp["rotated"], True),
                          ("derotate_gray", inp["luma"], False),
                          ("derotate_gray_4k", inp["plane_4k"], False)):
        got = resync_cuda.derotate(img, RESYNC_ANGLE, color_frames=cl)
        ref = resync_cuda.derotate_plain(img, RESYNC_ANGLE, cl)
        err = float((got.to(torch.float64) - ref.to(torch.float64))
                    .abs().max())
        require(torch.equal(got, ref), f"K13 {name} {list(img.shape)}: not "
                f"equal to its twin ({err})")
        require(torch.equal(resync_cuda.derotate(img, 0.0, color_frames=cl),
                            img), f"K13 {name} at 0°: not the input")
        del ref
        # a scan's 20 angles in one launch, each slice against the twin
        stack = resync_cuda.derotate_angles(img, SCAN_ANGLES,
                                            color_frames=cl)
        for k, a in enumerate(SCAN_ANGLES):
            ref = resync_cuda.derotate_plain(img, a, cl)
            err = max(err, float((stack[k].to(torch.float64)
                                  - ref.to(torch.float64)).abs().max()))
            require(torch.equal(stack[k], ref), f"K13 {name} "
                    f"{list(img.shape)} at {a}° of a scan: not equal to "
                    f"its twin ({err})")
        del ref
        h, w = got.shape[0], got.shape[1]
        c = img.shape[-1] if cl else 1
        planes = (torch.movedim(img, -1, 0) if cl else img[None]).to(
            torch.float32)[None]
        ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                                torch.arange(w, device=dev), indexing="ij")
        xx, yy = xs - w * 0.5, ys - h * 0.5

        def grid_of(cs):
            return torch.stack([(cs[0] * xx + cs[1] * yy + w * 0.5) / (w - 1),
                                (-cs[1] * xx + cs[0] * yy + h * 0.5)
                                / (h - 1)], dim=-1) * 2 - 1
        grid = grid_of(resync_cuda.rotation_cs(RESYNC_ANGLE, dev))[None]
        plain_ms = cuda_time(lambda: resync_cuda.derotate_plain(
            img, RESYNC_ANGLE, cl), 5)
        ops = (ROT_OPS_PIXEL + c * (ROT_OPS_CHANNEL + ROT_OPS_U8
                                    * (img.dtype == torch.uint8)))
        one = dict(
            ms=cuda_time(lambda: resync_cuda.derotate(
                img, RESYNC_ANGLE, color_frames=cl), 5),
            device_ms=device_ms(lambda: resync_cuda.derotate(
                img, RESYNC_ANGLE, color_frames=cl), 20, "derotate_kernel"),
            plain_ms=plain_ms, eager_ms=plain_ms,
            library_ms=cuda_time(lambda: F.grid_sample(
                planes, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True), 5),
            **bound(h * w, ops, nbytes(img, got)))
        del got, grid
        # the scan: the wrapper (its cos and sin, the launch) per scan and
        # per angle, the kernel alone, the twin angle by angle, and one
        # grid_sample over the same angles with its grids made beforehand
        grids = torch.stack([grid_of(cs) for cs in
                             resync_cuda.rotation_cs_batch(SCAN_ANGLES, dev)])
        planes_a = planes.expand(n_angles, *planes.shape[1:])
        scan_ms = cuda_time(lambda: resync_cuda.derotate_angles(
            img, SCAN_ANGLES, color_frames=cl), 5)
        scan_plain_ms = cuda_time(lambda: resync_cuda.derotate_angles_plain(
            img, SCAN_ANGLES, cl), 1)
        scan = dict(
            angles=n_angles, ms=scan_ms, ms_per_angle=scan_ms / n_angles,
            device_ms=device_ms(lambda: resync_cuda.derotate_angles(
                img, SCAN_ANGLES, color_frames=cl), 10, "derotate_kernel"),
            plain_ms=scan_plain_ms, eager_ms=scan_plain_ms,
            library_ms=cuda_time(lambda: F.grid_sample(
                planes_a, grids, mode="bilinear", padding_mode="zeros",
                align_corners=True), 3),
            **bound(n_angles * h * w, ops, nbytes(img, stack)))
        scan["library_ms_per_angle"] = scan["library_ms"] / n_angles
        scan["device_share_of_bound"] = (scan["bound_ms"] / scan["device_ms"]
                                         if scan["device_ms"] else None)
        del stack, planes, planes_a, grids
        # the main path runs the scan: its numbers lead, the one angle's
        # are beside them
        rows[name] = dict(shape=list(img.shape), max_abs_err=err,
                          equals_twin=True, **scan,
                          **{f"{k}_one": v for k, v in one.items()})
    for name, r in rows.items():
        kernel = "K13" if name.startswith("derotate") else "K12"
        emit({"phase": "kernel_vs_plain", "kernel": f"{kernel} {name}", **r})
    k4 = rows.pop("derotate_gray_4k")
    rows["derotate_gray"].update({f"{k}_4k": k4[k] for k in
                                  ("ms", "device_ms", "plain_ms",
                                   "library_ms", "bound_ms", "ms_one",
                                   "device_ms_one", "library_ms_one")})

    # before (the eager forms, a read a chunk) and after, split and searches
    with resync_forms(eager=True):
        split_before = resync_split(dev, inp)
        before = {}
        for name, kw in (("shift_color", dict(img=inp["rolled"],
                                              color_frames=True)),
                         ("shift_gray", dict(img=inp["luma"],
                                             color_frames=False)),
                         ("rotation_color", dict(
                             img=inp["rotated"], color_frames=True,
                             rot_range=RESYNC_ROT))):
            sc, sw = ((inp["sc"], inp["sw"]) if kw["color_frames"]
                      else (inp["gsc"], inp["gsw"]))
            img = kw.pop("img")
            before[name] = timed_search(lambda: per_chunk_resync(
                img, sc, sw, ALPHA, **kw))[:2]
    split_after = resync_split(dev, inp)
    emit({"phase": "resync_split", "before": split_before,
          "after": split_after,
          "search_s": {"before": {n: b[1] for n, b in before.items()}},
          "card": smi_line()})

    counters = dict(K1=wm_cuda.spectrum_blocks, K9=detect_cuda.band_scores,
                    K12=resync_cuda.roll_stack,
                    K13=resync_cuda.derotate_angles,
                    K13_one_angle=resync_cuda.derotate)

    def counted(fn):
        # and the calls of the cos and sin makers: rotation_cs_batch's ops
        # once a scan with a nonzero angle, rotation_cs (one angle's) never
        cs_calls = dict.fromkeys(("rotation_cs", "rotation_cs_batch"), 0)
        real = {n: getattr(resync_cuda, n) for n in cs_calls}

        def counting(name):
            def call(*args, **kw):
                cs_calls[name] += 1
                return real[name](*args, **kw)
            return call
        for c in counters.values():
            c.launches = 0
        for n in cs_calls:
            setattr(resync_cuda, n, counting(n))
        try:
            out, dt, reads = timed_search(fn)
        finally:
            for n, f in real.items():
                setattr(resync_cuda, n, f)
        return out, dt, reads, {**{k: c.launches for k, c in
                                   counters.items()}, **cs_calls}

    searches = resync_searches(inp)
    after = {}
    for name in ("shift_color", "shift_gray", "rotation_color"):
        if name == "shift_gray":
            zero_color_counts()
        after[name] = counted(searches[name])
        if name == "shift_gray":
            n_color = color_counts()
    path = counted(lambda: blocked.detect_paths(
        inp["rolled"].cpu().numpy(), inp["meta"], DETECT_THRESH,
        resync=True, device=dev))
    # the rotation search again, each scan's counter-rotated candidates
    # held to derotate_plain at their angles (untimed)
    real_angles, checked = resync_cuda.derotate_angles, []

    def checked_angles(img, angles, color_frames=False):
        out = real_angles(img, angles, color_frames=color_frames)
        for k, a in enumerate(angles):
            require(torch.equal(out[k], resync_cuda.derotate_plain(
                img, a, color_frames)), f"the rotation search's candidate "
                f"at {a}°: not equal to its twin")
        checked.append(len(angles))
        return out
    checked_angles.launches = 0     # the wrapper counts on its module's name
    resync_cuda.derotate_angles = checked_angles
    try:
        rechecked = searches["rotation_color"]()
    finally:
        resync_cuda.derotate_angles = real_angles
    require(rechecked == after["rotation_color"][0],
            f"the rotation search {rechecked} with its candidates checked, "
            f"{after['rotation_color'][0]} without")
    require(checked == [len(SCAN_ANGLES)] + (
        [8] if after["rotation_color"][0][2] != 0.0 else []),
        f"the rotation search's scans {checked}")
    plain = {name: float(fn(img, sc, sw, ALPHA, sweeps=SWEEPS))
             for name, fn, img, sc, sw in (
                 ("shift_color", blocked.detect_color, inp["rolled"],
                  inp["sc"], inp["sw"]),
                 ("shift_gray", blocked.detect_gray, inp["grolled"],
                  inp["gsc"], inp["gsw"]),
                 ("rotation_color", blocked.detect_color, inp["rotated"],
                  inp["sc"], inp["sw"]))}

    (score, shift, _), _, _, _ = after["shift_color"]
    (gscore, gshift, _), _, _, _ = after["shift_gray"]
    (rscore, rshift, rangle), _, _, _ = after["rotation_color"]
    (found, path_score), _, path_reads, _ = path
    angles = len(blocked._resync_angles(RESYNC_ROT, RESYNC_STEP))
    refined = 8 if rangle != 0.0 else 0         # the step/5 refinement
    chunks = {"shift_color": n_chunks, "shift_gray": n_chunks,
              "rotation_color": n_chunks * (angles + refined),
              "detect_paths_resync": n_chunks}
    launches = {name: after[name][3] for name in after}
    launches["detect_paths_resync"] = path[3]
    require(shift == (3, -5), f"resync shift {shift} != (3, -5)")
    require(score >= DETECT_THRESH and found and path_score >= score - 1e-6,
            f"resync scores {score}, {path_score} (found {found})")
    require(gshift == (3, -5) and gscore >= DETECT_THRESH,
            f"gray resync shift {gshift}, score {gscore}")
    require(abs(rangle - RESYNC_ANGLE) <= RESYNC_STEP / 5 + 1e-6,
            f"rotation resync angle {rangle} vs {RESYNC_ANGLE}")
    require(rscore >= DETECT_THRESH, f"rotation resync score {rscore}")
    for name, n in launches.items():
        aligned = name == "detect_paths_resync"     # + its aligned detect
        rot = name == "rotation_color"
        scans = (1 + (refined > 0)) if rot else 0   # with a nonzero angle
        want = dict(K1=chunks[name] + aligned, K9=chunks[name] + aligned,
                    K12=chunks[name], K13=scans, K13_one_angle=0,
                    rotation_cs=0, rotation_cs_batch=scans)
        require(n == want, f"launches on the {name} search {n}, expected "
                f"{want} ({n_chunks} chunks a scan of {len(shifts)} shifts)")
    reads = {name: after[name][2] for name in after}
    reads["detect_paths_resync"] = path_reads
    want_reads = {name: [chunks[name]] for name in reads}
    want_reads["rotation_color"] = [n_chunks * angles, n_chunks * refined]
    require(reads == want_reads, f"host reads of the searches {reads}, "
            f"expected {want_reads}: one a scan")
    for name, (out_before, _) in before.items():
        require(out_before == after[name][0],
                f"{name}: {after[name][0]} through the kernels, "
                f"{out_before} through the eager forms")
    emit({"phase": "resync_1080p", "launches": launches, "host_reads": reads,
          "color_launches": n_color, "k1_chunk_vs_twin": twin,
          "rotation_candidates_vs_twin": checked,
          "plain_detect": plain,
          "searches": {name: dict(score=out[0], found=list(out[1]),
                                  angle=out[2], search_s=dt,
                                  search_s_before=before[name][1])
                       for name, (out, dt, _, _) in after.items()},
          "detect_paths": dict(score=path_score, found=found, s=path[1]),
          "card": smi_line()})
    per_kernel = {k: {name: n[k] for name, n in launches.items()}
                  for k in counters}
    return per_kernel, n_color, rows


# ---------------------------------------------------------------------------
# Video: both schemes at 1080p, resume, the audio contract, small reference
# ---------------------------------------------------------------------------

VIDEO_FRAMES = 48       # frames of the 1080p clip (2 s at 24 fps)
VIDEO_FPS = 24.0
VIDEO_ALPHA = 0.08      # tests/test_video.py's
VIDEO_INTERVAL = 8      # -> 6 marked frames, 2 dispatches of 4
VIDEO_CHUNK = 4         # models/video.py's default chunk
VIDEO_SEED = 20261024
VIDEO_TEXT = "CHIP SMOKE 1080p"


def write_clip(path: str, h: int, w: int, n: int, seed: int = VIDEO_SEED):
    """tests/test_video.py's synthetic clip at h×w: a σ3-blurred seeded
    noise frame rolled 2 px a frame, written by the port's VideoWriter."""
    import cv2
    import numpy as np
    from dctsvd_tpu_torch.io import video_io
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                            (0, 0), 3.0)
    with video_io.VideoWriter(path, VIDEO_FPS, w, h) as wr:
        for i in range(n):
            wr.write(np.roll(base, i * 2, axis=1))


def write_circle(path: str):
    """tests/test_video.py's watermark: a filled circle on 48×48."""
    import cv2
    import numpy as np
    wm = np.zeros((48, 48), np.uint8)
    cv2.circle(wm, (24, 24), 16, 255, -1)
    cv2.imwrite(path, wm)


def circle_ref(wm_png: str, h: int, w: int):
    """The watermark resized to the frame as the NC reference
    (INTER_AREA)."""
    import cv2
    return cv2.resize(cv2.imread(wm_png, cv2.IMREAD_GRAYSCALE), (w, h),
                      interpolation=cv2.INTER_AREA)


def video_probe() -> dict:
    """cv2's version, the Video I/O lines of its build information and
    whether an ffmpeg binary runs."""
    import cv2
    from dctsvd_tpu_torch.io import video_io
    lines, on = [], False
    for line in cv2.getBuildInformation().splitlines():
        if "Video I/O" in line:
            on = True
        elif on and (not line.strip() or not line.startswith("    ")):
            break
        if on:
            lines.append(line.strip())
    return dict(cv2=cv2.__version__, video_io=lines,
                ffmpeg=video_io.ffmpeg_available())


def video_wrappers():
    from dctsvd_tpu_torch.ops import svd_cuda, tail_cuda, wm_cuda
    return {"spectrum_blocks": wm_cuda.spectrum_blocks,
            "embed_blocks": wm_cuda.embed_blocks,
            "jacobi_svd8": svd_cuda.jacobi_svd8,
            "presence": tail_cuda.presence,
            "tail_front": tail_cuda.tail_front,
            "normalize_blocks": tail_cuda.normalize_blocks}


def counted_run(fn, wrappers=None):
    """(fn(), seconds, launches of K1, K2, K4, K5f, K8 or of ``wrappers``): the
    counters set to 0 just before and read just after, the card
    synchronised on both sides."""
    import torch
    wrappers = wrappers or video_wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt, {n: w.launches for n, w in wrappers.items()}


def video_split(dev, clip: str, wm_plane, scheme: str, color: bool,
                out_path: str) -> dict:
    """The embed's work done serially under utils/profiling.StageTimer:
    decode (every frame read, and the marked ones put in the device
    layout), device (upload, the embed of each chunk, download) and
    encode (every frame written). The pipeline overlaps the three."""
    import cv2
    import numpy as np
    import torch
    from dctsvd_tpu_torch.io import video_io
    from dctsvd_tpu_torch.models import video
    from dctsvd_tpu_torch.utils import profiling
    timer = profiling.StageTimer()
    hwc = color and scheme == "blocked"
    with timer.stage("decode"):
        with video_io.VideoReader(clip) as reader:
            frames = [f for f in reader]
        idx = list(range(0, len(frames), VIDEO_INTERVAL))
        if hwc:
            planes = [frames[i] for i in idx]
        elif color:
            planes = [np.moveaxis(frames[i], -1, 0) for i in idx]
        else:
            planes = [cv2.cvtColor(frames[i], cv2.COLOR_BGR2GRAY)
                      for i in idx]
    wm_d = torch.as_tensor(wm_plane, device=dev)
    if scheme == "blocked":
        _, sw, _ = video._wm_svd_blocked(wm_d)
        fn = (video._embed_frames_color_blocked if color
              else video._embed_frame_gray_blocked)
    else:
        _, sw, _ = video._wm_svd(wm_d)
        fn = video._embed_frame_color if color else video._embed_frame_gray
    torch.cuda.synchronize()
    marked = []
    for c0 in range(0, len(planes), VIDEO_CHUNK):
        part = planes[c0:c0 + VIDEO_CHUNK]
        part = part + [part[-1]] * (VIDEO_CHUNK - len(part))
        with timer.stage("device"):
            m, s = fn(torch.from_numpy(np.stack(part)).to(dev), sw,
                      VIDEO_ALPHA)
            m, s = m.cpu().numpy(), s.cpu().numpy()
        marked.extend(m[:len(planes) - c0])
    with timer.stage("encode"):
        h, w = frames[0].shape[:2]
        with video_io.VideoWriter(out_path, VIDEO_FPS, w, h) as wr:
            for i, f in enumerate(frames):
                if i % VIDEO_INTERVAL:
                    wr.write(f)
                    continue
                m = marked[i // VIDEO_INTERVAL]
                if hwc:
                    wr.write(m)
                elif color:
                    wr.write(np.ascontiguousarray(np.moveaxis(m, 0, -1)))
                else:
                    wr.write(cv2.cvtColor(m, cv2.COLOR_GRAY2BGR))
    return {k: dict(seconds=v, calls=timer.counts[k])
            for k, v in timer.totals.items()}


def video_kernels_vs_twin(dev, clip: str, marked_color: str, meta_path: str,
                          wm_plane) -> dict:
    """K2 on one chunk of 4 decoded 1080p frames (channels-last u8, and
    their u8 gray planes), K1 on 4 decoded frames of the blocked color
    stego at its meta's schedule, and K4 on the watermark's natural-order
    blocks (5 sweeps), each bit-equal to its twin run on the card and
    timed beside it (CUDA events)."""
    import cv2
    import numpy as np
    import torch
    from dctsvd_tpu_torch.io import meta as metaio
    from dctsvd_tpu_torch.io import video_io
    from dctsvd_tpu_torch.models import blocked, video
    from dctsvd_tpu_torch.ops import dct, svd_cuda, wm_cuda

    def decoded(path):
        with video_io.VideoReader(path) as r:
            return np.stack([r.seek_read(i) for i in
                             range(0, VIDEO_CHUNK * VIDEO_INTERVAL,
                                   VIDEO_INTERVAL)])

    frames = decoded(clip)
    gray = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in frames])
    frames_d = torch.as_tensor(frames, device=dev)
    gray_d = torch.as_tensor(gray, device=dev)
    stego_d = torch.as_tensor(decoded(marked_color), device=dev)
    wm_d = torch.as_tensor(wm_plane, device=dev)
    padded, _, _ = blocked._pad_to_blocks(wm_d.to(torch.float32))
    coefs = dct.dct2_plane_blocks(padded)
    _, sw, _ = video._wm_svd_blocked(wm_d)
    mask = (torch.arange(8, device=dev) < K).to(torch.float32)
    sws = blocked._scaled_sws(sw, torch.tensor(VIDEO_ALPHA, device=dev),
                              mask)
    sched = blocked.replay_sweeps(metaio.load_video_meta(meta_path).sched())
    cases = {
        "K2 embed_blocks frames_u8": (
            lambda: wm_cuda.embed_blocks(frames_d, sws, sweeps=SWEEPS, k=K,
                                         out_u8=True, channels_last=True),
            lambda: wm_cuda.embed_blocks_plain(
                frames_d, sws, sweeps=SWEEPS, k=K, out_u8=True,
                channels_last=True), frames_d),
        "K2 embed_blocks gray_u8": (
            lambda: wm_cuda.embed_blocks(gray_d, sws, sweeps=SWEEPS, k=K,
                                         out_u8=True),
            lambda: wm_cuda.embed_blocks_plain(gray_d, sws, sweeps=SWEEPS,
                                               k=K, out_u8=True), gray_d),
        "K1 spectrum_blocks stego_frames_u8": (
            lambda: wm_cuda.spectrum_blocks(stego_d, sweeps=sched,
                                            channels_last=True),
            lambda: wm_cuda.spectrum_blocks_plain(stego_d, sweeps=sched,
                                                  channels_last=True),
            stego_d),
        "K4 jacobi_svd8 wm_natural": (
            lambda: svd_cuda.jacobi_svd8(coefs),
            lambda: svd_cuda.jacobi_svd8_plain(coefs), coefs),
    }
    out = {}
    for name, (kern, plain, x) in cases.items():
        got, ref = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max(float((a.to(torch.float32) - b.to(torch.float32))
                        .abs().max()) for a, b in zip(got, ref))
        require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                f"{name} on a decoded 1080p video chunk "
                f"{list(x.shape)}: not bit-equal to its twin ({err})")
        out[name] = dict(shape=list(x.shape), equals_twin=True,
                         max_abs_err=err, ms=cuda_time(kern, 10),
                         plain_ms=cuda_time(plain, 2))
    return out


def phase_video(dev, td: str, clip: str, wm_png: str):
    """models/video at 1080p through its entry points: the blocked and the
    full scheme, gray and color, at frame interval 8 (6 marked frames of
    48, 2 dispatches), each embed and extract timed end to end with K1's,
    K2's and K4's launches counted in a window of its own; the meta shapes
    of tests/test_video.py at this size; extraction NC > 0.4 against the
    resized watermark; the decode / device / encode split of each embed
    (StageTimer, serial); svd_full's time per marked frame; a text video
    (full, gray) round trip; detect at sample rate 8 (6 frames, likelihood
    in (0, 1], a missing path an error dict); then K1, K2 and K4 bit-equal
    to their twins on a chunk of decoded 1080p frames. Returns the launches
    of K1, K2 and K4 over the video runs."""
    import cv2
    import numpy as np
    import torch
    from dctsvd_tpu_torch.io import meta as metaio
    from dctsvd_tpu_torch.io import video_io
    from dctsvd_tpu_torch.models import video
    from dctsvd_tpu_torch.ops import dct
    from dctsvd_tpu_torch.ops.svd import svd_full

    probe = video_probe()
    ref = circle_ref(wm_png, H, W)
    n_blocks = (H // 8) * (W // 8)
    marked_idx = list(range(0, VIDEO_FRAMES, VIDEO_INTERVAL))
    nm = len(marked_idx)
    dispatches = -(-nm // VIDEO_CHUNK)
    expect_shape = {("blocked", False): (nm, n_blocks, 8),
                    ("blocked", True): (nm, 3, n_blocks, 8),
                    ("full", False): (nm, min(H, W)),
                    ("full", True): (nm, 3, min(H, W))}
    wm_plane = video._prepare_wm_plane(wm_png, None, 0, W, H, device=dev)
    total = {n: 0 for n in video_wrappers()}
    runs = {}
    for scheme in ("blocked", "full"):
        for color in (False, True):
            name = f"{scheme}_{'color' if color else 'gray'}"
            out = os.path.join(td, f"{name}.mp4")
            meta_p = os.path.join(td, f"{name}_meta.npz")
            embed = (video.embed_watermark_video_color if color
                     else video.embed_watermark_video)
            _, embed_s, n_embed = counted_run(lambda: embed(
                clip, wm_png, out, meta_p, alpha=VIDEO_ALPHA,
                frame_interval=VIDEO_INTERVAL, scheme=scheme, device=dev))
            wm_out = os.path.join(td, f"{name}_wm.png")
            _, extract_s, n_extract = counted_run(
                lambda: video.extract_watermark_video(out, meta_p, wm_out,
                                                      device=dev))
            meta = metaio.load_video_meta(meta_p)
            nc = nc_np(cv2.imread(wm_out, cv2.IMREAD_GRAYSCALE), ref)
            if scheme == "blocked":
                want_e = {"jacobi_svd8": 1, "embed_blocks": dispatches,
                          "spectrum_blocks": 0, "presence": 0,
                          "tail_front": 0, "normalize_blocks": 0}
                # video consumes the raw estimates: no normaliser
                want_x = {"jacobi_svd8": 0, "embed_blocks": 0,
                          "spectrum_blocks": dispatches,
                          "presence": dispatches,
                          "tail_front": dispatches,
                          "normalize_blocks": 0}
            else:
                want_e = want_x = {n: 0 for n in total}
            require(n_embed == want_e and n_extract == want_x,
                    f"video {name} launches: embed {n_embed} (expected "
                    f"{want_e}), extract {n_extract} (expected {want_x})")
            require(list(meta.frame_indices) == marked_idx,
                    f"video {name} frame indices {list(meta.frame_indices)}")
            require(meta.s_orig.shape == expect_shape[(scheme, color)],
                    f"video {name} s_orig {meta.s_orig.shape}")
            require(meta.uw.shape == ((n_blocks, 8, 8) if scheme == "blocked"
                                      else (H, min(H, W))),
                    f"video {name} uw {meta.uw.shape}")
            require(meta.scheme == scheme and meta.is_color == color,
                    f"video {name} meta scheme {meta.scheme}")
            require(nc > 0.4, f"video {name} extraction NC {nc} <= 0.4")
            for n in total:
                total[n] += n_embed[n] + n_extract[n]
            split = video_split(dev, clip, wm_plane, scheme, color,
                                os.path.join(td, f"{name}_split.mp4"))
            runs[name] = dict(
                embed_s=embed_s, embed_fps=VIDEO_FRAMES / embed_s,
                extract_s=extract_s, extract_marked_fps=nm / extract_s,
                extract_nc=nc, launches_embed=n_embed,
                launches_extract=n_extract, split_s=split,
                s_orig_shape=list(meta.s_orig.shape),
                sweeps=[meta.sweeps, meta.sweeps_xpairs])
    # svd_full per marked frame: one gray plane, three color planes
    with video_io.VideoReader(clip) as reader:
        frame = reader.seek_read(0)
    gray = torch.as_tensor(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY),
                           device=dev).to(torch.float32)
    planes = torch.movedim(torch.as_tensor(frame, device=dev), -1, 0).to(
        torch.float32)
    svd_ms = {"gray_1_plane": cuda_time(lambda: svd_full(dct.dct2(gray)), 3),
              "color_3_planes": cuda_time(
                  lambda: svd_full(dct.dct2(planes)), 3)}

    text_out = os.path.join(td, "text.mp4")
    text_meta = os.path.join(td, "text_meta.npz")
    t0 = time.perf_counter()
    video.embed_text_watermark_video(clip, VIDEO_TEXT, text_out, text_meta,
                                     alpha=VIDEO_ALPHA,
                                     frame_interval=VIDEO_INTERVAL * 2,
                                     device=dev)
    got_text = video.extract_text_watermark_video(
        text_out, text_meta, os.path.join(td, "text_wm.png"), device=dev)
    text_s = time.perf_counter() - t0
    require(got_text == VIDEO_TEXT, f"video text round trip: {got_text!r}")

    det, detect_s, _ = counted_run(lambda: video.detect_watermark_video(
        os.path.join(td, "full_gray.mp4"), frame_sample_rate=VIDEO_INTERVAL,
        device=dev))
    missing = video.detect_watermark_video(os.path.join(td, "missing.mp4"),
                                           device=dev)
    require(det.get("total_frames_analyzed") == nm
            and 0.0 < det["watermark_likelihood"] <= 1.0,
            f"video detect: {det}")
    require(set(missing) == {"error"}, f"detect on a missing path: {missing}")
    twin = video_kernels_vs_twin(dev, clip,
                                 os.path.join(td, "blocked_color.mp4"),
                                 os.path.join(td, "blocked_color_meta.npz"),
                                 wm_plane)
    det.pop("frame_statistics")
    emit({"phase": "video_1080p", "machine": probe,
          "clip": dict(frames=VIDEO_FRAMES, fps=VIDEO_FPS, shape=[H, W, 3],
                       alpha=VIDEO_ALPHA, frame_interval=VIDEO_INTERVAL,
                       marked=nm, chunk=VIDEO_CHUNK),
          **runs, "svd_full_ms": svd_ms,
          "text": dict(recovered=got_text, frame_interval=2 * VIDEO_INTERVAL,
                       embed_extract_s=text_s),
          "detect": dict(det, seconds=detect_s), "missing_path": missing,
          "kernels_vs_twin_on_video_chunk": twin,
          "launches_video": total, "card": smi_line()})
    return total


def phase_video_resume(dev, td: str, clip: str, wm_png: str):
    """A blocked color embed with resume=True and segment_frames=16: a crash
    injected at the second dispatch (``_embed_frames_color_blocked``
    patched), then the rerun; its output must be byte-identical to an
    uninterrupted resumed run, with equal s_orig."""
    import numpy as np
    from dctsvd_tpu_torch.io import meta as metaio
    from dctsvd_tpu_torch.io import video_io
    from dctsvd_tpu_torch.models import video
    wm_plane = video._prepare_wm_plane(wm_png, None, 0, W, H, device=dev)
    kw = dict(color=True, resume=True, segment_frames=16, scheme="blocked",
              device=dev)
    out_a = os.path.join(td, "resume_a.mp4")
    meta_a = os.path.join(td, "resume_a.npz")
    t0 = time.perf_counter()
    video._embed_video_impl(clip, out_a, meta_a, wm_plane, VIDEO_ALPHA,
                            VIDEO_INTERVAL, **kw)
    plain_s = time.perf_counter() - t0
    out_b = os.path.join(td, "resume_b.mp4")
    meta_b = os.path.join(td, "resume_b.npz")
    orig = video._embed_frames_color_blocked
    calls = {"n": 0}

    def crash(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected crash")
        return orig(*args, **kwargs)

    video._embed_frames_color_blocked = crash
    try:
        video._embed_video_impl(clip, out_b, meta_b, wm_plane, VIDEO_ALPHA,
                                VIDEO_INTERVAL, **kw)
        raise SmokeFailure("the injected crash did not propagate")
    except RuntimeError as err:
        require("injected" in str(err), f"resume crash: {err}")
    finally:
        video._embed_frames_color_blocked = orig
    ck = metaio.load_video_meta(meta_b)
    segs = video_io.SegmentedVideoWriter.existing_segments(out_b)
    require(ck.frames_done > 0 and ck.segments_done >= 1 and segs
            and not os.path.exists(out_b),
            f"resume checkpoint: frames_done {ck.frames_done}, segments "
            f"{ck.segments_done}, files {segs}")
    require(len(ck.s_orig) == len(ck.frame_indices),
            "a checkpoint without an s_orig row for each recorded frame")
    t0 = time.perf_counter()
    video._embed_video_impl(clip, out_b, meta_b, wm_plane, VIDEO_ALPHA,
                            VIDEO_INTERVAL, **kw)
    resumed_s = time.perf_counter() - t0
    full, res = metaio.load_video_meta(meta_a), metaio.load_video_meta(meta_b)
    with open(out_a, "rb") as fa, open(out_b, "rb") as fb:
        same = fa.read() == fb.read()
    require(same, "the resumed output is not byte-identical to the "
            "uninterrupted run's")
    require(list(res.frame_indices) == list(full.frame_indices)
            and np.array_equal(res.s_orig, full.s_orig),
            "the resumed meta's s_orig differs from the uninterrupted run's")
    emit({"phase": "video_resume_1080p", "segment_frames": 16,
          "crash_at_dispatch": 2, "checkpoint_frames_done": ck.frames_done,
          "checkpoint_segments": ck.segments_done,
          "byte_identical": same, "s_orig_equal": True,
          "uninterrupted_s": plain_s, "resumed_s": resumed_s,
          "output_bytes": os.path.getsize(out_b), "card": smi_line()})


def phase_video_audio(dev, td: str, clip: str, wm_png: str):
    """The with-audio color embed (blocked): with an ffmpeg binary, a
    generated tone is muxed into the host clip (lavfi sine) and the embed
    must report had_audio True; without one it must report False and
    leave the silent output in place."""
    from dctsvd_tpu_torch.io import video_io
    from dctsvd_tpu_torch.models import video
    host = clip
    have = video_io.ffmpeg_available()
    if have:
        host = os.path.join(td, "clip_tone.mp4")
        proc = subprocess.run(
            ["ffmpeg", "-y", "-i", clip, "-f", "lavfi", "-i",
             "sine=frequency=440:duration=2", "-c:v", "copy", "-c:a", "aac",
             "-shortest", host], capture_output=True, timeout=120)
        require(proc.returncode == 0, f"muxing a tone: {proc.stderr[-300:]}")
    out = os.path.join(td, "audio.mp4")
    t0 = time.perf_counter()
    _, _, had_audio = video.embed_watermark_video_color_with_audio(
        host, wm_png, out, os.path.join(td, "audio_meta.npz"),
        alpha=VIDEO_ALPHA, frame_interval=VIDEO_INTERVAL, scheme="blocked",
        device=dev)
    seconds = time.perf_counter() - t0
    require(had_audio is have, f"had_audio {had_audio} with ffmpeg {have}")
    require(os.path.exists(out) and not os.path.exists(out + ".temp.mp4"),
            "with-audio output missing or its temp left behind")
    emit({"phase": "video_audio",
          "case": "ffmpeg present: tone muxed" if have else
          "no ffmpeg binary: silent fallback",
          "had_audio": had_audio, "seconds": seconds, "card": smi_line()})


def phase_video_reference(dev, td: str):
    """Both schemes, gray and color, on a 96×128×24 clip on the card and on
    the CPU: frame indices equal; s_orig within 1e-5·s_max (full) or
    1e-3·s_max with 99 % within 1e-4·s_max (blocked; the CPU tests'
    bounds); each extraction NC > 0.4 and the two extractions' NC >=
    0.99."""
    import cv2
    import numpy as np
    from dctsvd_tpu_torch.io import meta as metaio
    from dctsvd_tpu_torch.models import video
    h, w = 96, 128
    clip = os.path.join(td, "small.mp4")
    wm_png = os.path.join(td, "small_wm.png")
    write_clip(clip, h, w, 24)
    write_circle(wm_png)
    ref = circle_ref(wm_png, h, w)
    rows = {}
    for scheme in ("full", "blocked"):
        for color in (False, True):
            name = f"{scheme}_{'color' if color else 'gray'}"
            got = []
            for d in ("cpu", dev):
                base = os.path.join(td, f"small_{name}_{d}")
                embed = (video.embed_watermark_video_color if color
                         else video.embed_watermark_video)
                embed(clip, wm_png, base + ".mp4", base + ".npz",
                      alpha=VIDEO_ALPHA, frame_interval=5, scheme=scheme,
                      device=d)
                video.extract_watermark_video(base + ".mp4", base + ".npz",
                                              base + ".png", device=d)
                got.append((metaio.load_video_meta(base + ".npz"),
                            cv2.imread(base + ".png", cv2.IMREAD_GRAYSCALE)))
            (m_c, x_c), (m_g, x_g) = got
            smax = float(np.abs(m_c.s_orig).max())
            err = np.abs(m_g.s_orig - m_c.s_orig) / smax
            nc_pair, nc_c, nc_g = nc_np(x_c, x_g), nc_np(x_c, ref), nc_np(
                x_g, ref)
            require(list(m_c.frame_indices) == list(m_g.frame_indices),
                    f"small video {name}: frame indices differ")
            if scheme == "full":
                require(err.max() <= 1e-5,
                        f"small video {name}: s_orig {err.max()} > 1e-5")
            else:
                require(err.max() <= 1e-3 and (err <= 1e-4).mean() >= 0.99,
                        f"small video {name}: s_orig {err.max()}, "
                        f"{(err <= 1e-4).mean()} within 1e-4")
            require(nc_pair >= 0.99 and min(nc_c, nc_g) > 0.4,
                    f"small video {name}: NC card-cpu {nc_pair}, "
                    f"{nc_c}, {nc_g}")
            rows[name] = dict(s_orig_max_rel_err=float(err.max()),
                              share_within_1e4=float((err <= 1e-4).mean()),
                              nc_card_vs_cpu=nc_pair, nc_cpu=nc_c,
                              nc_card=nc_g)
    emit({"phase": "video_reference_small", "shape": [h, w, 3], "frames": 24,
          **rows, "card": smi_line()})


# ---------------------------------------------------------------------------
# parallel/ (frame batches over a mesh, 8K frames in bands), the GUI
# handlers and the graft entry points
# ---------------------------------------------------------------------------

PLANE_H, PLANE_W = 4320, 7680   # one 8K frame: 518,400 blocks


def parallel_wrappers():
    from dctsvd_tpu_torch.ops import detect_cuda, wm_cuda
    return dict(video_wrappers(),
                roundtrip_frames_blocks=wm_cuda.roundtrip_frames_blocks,
                band_scores=detect_cuda.band_scores,
                **{c.__name__: c for c in K8_INSTANCES})


def _signature(value):
    """A call argument's shape, dtype and layout, or the value itself (a
    list, as of a scan's angles, as a tuple)."""
    import torch
    if isinstance(value, torch.Tensor):
        return (tuple(value.shape), str(value.dtype), value.stride())
    if isinstance(value, list):
        return tuple(value)
    return value


def twinned_wrappers():
    """K1..K4's, K5f's, K8's, K9's, K6's, K7's, K10's, K11's, K12's and K13's
    wrappers and cols_view's (T2b, the bench budget's view row): {name:
    wrapper}, the
    calls :func:`recorded_calls` notes."""
    from dctsvd_tpu_torch.ops import probe_cuda
    return dict(parallel_wrappers(), cols_view=probe_cuda.cols_view,
                **color_wrappers(), **enhance_wrappers(),
                **resync_wrappers())


@contextlib.contextmanager
def recorded_calls():
    """Records the first call of K1..K4's, K5f's, K8's, K9's, K6's, K7's,
    K10's, K11's, K12's, K13's and cols_view's wrappers at each signature
    (shapes, dtypes, strides and the other arguments) made inside the
    block: {(name, signature): (args, kwargs)}. The wrappers
    stay the ones that launch and count: a recorder only notes the
    inputs, then calls the wrapper (whose count, kept on the module's
    name, is the recorder's while it stands in for it)."""
    from dctsvd_tpu_torch.ops import (color_cuda, detect_cuda, enhance_cuda,
                                      probe_cuda, resync_cuda, svd, svd_cuda,
                                      tail_cuda, wm_cuda)
    calls = {}
    patched = []
    for name, orig in twinned_wrappers().items():
        def recorder(*args, _orig=orig, _name=name, **kw):
            key = (_name, tuple(_signature(a) for a in args),
                   tuple(sorted((k, _signature(v)) for k, v in kw.items())))
            calls.setdefault(key, (args, kw))
            return _orig(*args, **kw)
        recorder.launches = orig.launches
        for mod in (wm_cuda, svd_cuda, svd, probe_cuda, tail_cuda,
                    color_cuda, detect_cuda, enhance_cuda, resync_cuda):
            if getattr(mod, name, None) is orig:
                patched.append((mod, name, orig))
                setattr(mod, name, recorder)
    try:
        yield calls
    finally:
        for mod, name, orig in patched:
            setattr(mod, name, orig)


def recorded_vs_twin(calls: dict) -> list:
    """Each recorded call of K1..K4, K5f, K8, K9, K6, K7, K10, K11, K12, K13
    and cols_view again,
    through its kernel and through its plain twin on the same inputs on
    the card: bit-equal, or the run fails. One row a call: its input shapes, max
    |kernel - twin|, and the kernel's and the twin's ms (CUDA events, 3
    and 1 calls)."""
    import torch
    from dctsvd_tpu_torch.ops import (color_cuda, detect_cuda, enhance_cuda,
                                      probe_cuda, resync_cuda, svd_cuda,
                                      tail_cuda, wm_cuda)
    twins = {"spectrum_blocks": wm_cuda.spectrum_blocks_plain,
             "embed_blocks": wm_cuda.embed_blocks_plain,
             "roundtrip_frames_blocks":
                 wm_cuda.roundtrip_frames_blocks_plain,
             "jacobi_svd8": svd_cuda.jacobi_svd8_plain,
             "cols_view": probe_cuda.cols_view_plain,
             "presence": tail_cuda.presence_plain,
             "tail_front": tail_cuda.tail_front_plain,
             "normalize_blocks": tail_cuda.normalize_blocks_plain,
             "band_scores": detect_cuda.band_scores_plain,
             **{name: getattr(color_cuda, f"{name}_plain")
                for name in COLOR_KERNELS},
             **{name: getattr(enhance_cuda, f"{name}_plain")
                for name in ENHANCE_KERNELS},
             "roll_stack": resync_cuda.roll_stack_plain,
             "derotate_angles": resync_cuda.derotate_angles_plain}
    kernels_ = twinned_wrappers()
    rows = []
    for (name, _, _), (args, kw) in calls.items():
        plain_kw = {k: v for k, v in kw.items()
                    if k not in ("method", "variant")}
        require(kw.get("method", "onesided") == "onesided"
                and kw.get("variant", "delta") == "delta",
                f"{name}: a variant call on the path {kw}")

        def kern():
            return kernels_[name](*args, **kw)

        def plain():
            return twins[name](*args, **plain_kw)
        got, ref = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max(float((a.to(torch.float32) - b.to(torch.float32))
                        .abs().max()) for a, b in zip(got, ref))
        shapes = [list(a.shape) for a in args if isinstance(a, torch.Tensor)]
        require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                f"{name} on the path's inputs {shapes}: not bit-equal to "
                f"its twin ({err})")
        rows.append(dict(name=name, inputs=shapes,
                         dtype=str(args[0].dtype), equals_twin=True,
                         max_abs_err=err, ms=cuda_time(kern, 3),
                         plain_ms=cuda_time(plain, 1)))
    return rows


def differ(a, b) -> dict:
    """How two tensors of one call differ: equal, and for u8 the share of
    differing bytes and the largest difference, else the largest
    absolute difference."""
    import torch
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    out = dict(equal=bool(torch.equal(a, b)), max=float(d.max()))
    if a.dtype == torch.uint8:
        out.update(share=float((d > 0).to(torch.float64).mean()),
                   bytes=int((d > 0).sum()))
    return out


def tail_times(covers, wm_u8, blk, intra) -> dict:
    """ms of the steps that run the extract tail on the 1080p batch of 32,
    CUDA events, two readings of 10 calls after a warm-up: the slice's
    embed+extract step, color and gray extract alone, serve+verify, the
    extracts on 1 and 4 frames, and the tail's estimator and gather alone
    (``front_*``: models/blocked._tail_front where the tree has it, K5f
    since it does, K18 before it where the tree has K18; ``front_*_eager``:
    :func:`eager_front`, the parts every tree has;
    ``front_*_eager_statistic``: K5f after the eager statistic, the
    front before K18), also at 128 frames;
    the presence statistic alone (``presence_*``: K18 where the tree has
    it; ``presence_*_eager``: :func:`eager_statistic`), also at 128
    frames; the request extract on one 1080p and one 1079x1917 frame
    (``request_*``: the tree's extract_color / extract_gray, K1, K18, K5f,
    K8 or K8u where the tree has them; ``request_*_eager``:
    :func:`eager_request`).
    Where extract_color_prepared takes
    ``recompute``, each extract row has a ``_recompute`` twin (K5), color
    extract at batch 128 (the bench's headline batch) runs in both forms,
    K5's output there held to its twin first, and the kernels run alone on
    the front's output: ``k5_*`` (K5), ``k5_paint_*`` (its paint pass, no
    normalize), where the tree has it, ``k5f_*`` (K5f) and ``k8_*`` (K8 on
    the product of the same estimates; the extract rows are the default
    form, K8 since it exists), and at 128 frames :func:`k8_at_128`. Only
    entry points every tree of the port has otherwise, so that this
    function, copied into an older tree, times that tree."""
    import inspect

    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import color, tail_cuda
    from dctsvd_tpu_torch.utils import crypto
    pwc = blocked.prepare_wm_color(wm_u8, blk, intra)
    pwg = blocked.prepare_wm_gray(color.bgr_to_gray(wm_u8), blk, intra)
    st, sc, _, _ = blocked.embed_color_prepared(covers, pwc.sw, ALPHA,
                                                with_metrics=False)
    stg, scg, _, _ = blocked.embed_gray_prepared(covers, pwg.sw, ALPHA,
                                                 with_metrics=False)
    forms = {"": {}}
    if "recompute" in inspect.signature(
            blocked.extract_color_prepared).parameters:
        forms["_recompute"] = {"recompute": True}
    steps = {}
    for suffix, kw in forms.items():
        def step(kw=kw):
            s, c = blocked.embed_color_prepared(covers, pwc.sw, ALPHA,
                                                with_metrics=False)[:2]
            return blocked.extract_color_prepared(
                s, c, pwc.ebasis, pwc.inv_blk, ALPHA, sw=pwc.sw, **kw)
        steps["embed_extract" + suffix] = step
        steps["extract_color" + suffix] = (
            lambda kw=kw: blocked.extract_color_prepared(
                st, sc, pwc.ebasis, pwc.inv_blk, ALPHA, sw=pwc.sw, **kw))
        steps["extract_gray" + suffix] = (
            lambda kw=kw: blocked.extract_gray_prepared(
                stg, scg, pwg.ebasis, pwg.inv_blk, ALPHA, sw=pwg.sw, **kw))
        if not suffix:
            steps["serve_verify"] = (
                lambda: blocked.serve_verify_color_prepared(
                    covers, pwc.sw, ALPHA, pwc.ebasis, pwc.inv_blk))
        # the same extracts on one frame and on four (a shard of 4)
        for n in (1, 4):
            steps[f"extract_color_{n}{suffix}"] = (
                lambda n=n, kw=kw: blocked.extract_color_prepared(
                    st[:n], sc[:n], pwc.ebasis, pwc.inv_blk, ALPHA,
                    sw=pwc.sw, **kw))
            steps[f"extract_gray_{n}{suffix}"] = (
                lambda n=n, kw=kw: blocked.extract_gray_prepared(
                    stg[:n], scg[:n], pwg.ebasis, pwg.inv_blk, ALPHA,
                    sw=pwg.sw, **kw))
    # the front both forms read: the estimate and the slot gather on the
    # stego spectrum (K1's output), through the tree's _tail_front and
    # eager (written out from the parts every tree has)
    k = blocked.k_of_block(0.6)
    s_cw = blocked._frames_spectrum(st, SWEEPS)
    s_cwg = blocked._plane_spectrum(color.luma_f32(stg), SWEEPS)
    if hasattr(blocked, "_tail_front"):
        steps["front_color"] = lambda: blocked._tail_front(
            s_cw, sc, pwc.inv_blk, ALPHA, k, pwc.sw)
        steps["front_gray"] = lambda: blocked._tail_front(
            s_cwg, scg, pwg.inv_blk, ALPHA, k, pwg.sw)
    steps["front_color_eager"] = lambda: eager_front(s_cw, sc, pwc)
    steps["front_gray_eager"] = lambda: eager_front(s_cwg, scg, pwg)
    if hasattr(tail_cuda, "tail_front"):
        steps["front_color_eager_statistic"] = (
            lambda: front_eager_statistic(s_cw, sc, pwc))
        steps["front_gray_eager_statistic"] = (
            lambda: front_eager_statistic(s_cwg, scg, pwg))
    # the presence statistic alone: K18 where the tree has it, and as the
    # front took it before (eager_statistic)
    if hasattr(tail_cuda, "presence"):
        a = blocked._alpha(ALPHA, s_cw.device)
        steps["presence_color"] = lambda a=a: tail_cuda.presence(
            s_cw, pwc.sw, sc, a)
        steps["presence_gray"] = lambda a=a: tail_cuda.presence(
            s_cwg, pwg.sw, scg, a)
    steps["presence_color_eager"] = lambda: eager_statistic(s_cw, sc, pwc.sw)
    steps["presence_gray_eager"] = lambda: eager_statistic(s_cwg, scg,
                                                           pwg.sw)
    # the request extract (extract_color / extract_gray, what extract_array
    # runs) on one frame, 1080p and 1079x1917, through the tree's entry
    # points and eager (eager_request)
    h, w = 1079, 1917
    blk_u, intra_u = (torch.as_tensor(a_, device=st.device) for a_ in
                      crypto.block_permutation_indices(
                          crypto.derive_key(PASSWORD, bytes(8)),
                          blocked.n_blocks_of(h, w)))
    wm_c = wm_u8[:h, :w].contiguous()
    pwc_u = blocked.prepare_wm_color(wm_c, blk_u, intra_u)
    pwg_u = blocked.prepare_wm_gray(color.bgr_to_gray(wm_c), blk_u, intra_u)
    one = covers[:1, :h, :w].contiguous()
    req = {"1080p": (st[:1], sc[:1], pwc, stg[:1], scg[:1], pwg),
           "1079x1917": (*blocked.embed_color_prepared(
               one, pwc_u.sw, ALPHA, with_metrics=False)[:2], pwc_u,
               *blocked.embed_gray_prepared(
                   one, pwg_u.sw, ALPHA, with_metrics=False)[:2], pwg_u)}
    for size, (stc, scc, pc, stgg, scgg, pg) in req.items():
        for lay, x_, c_, p_ in (("color", stc, scc, pc),
                                ("gray", stgg, scgg, pg)):
            fn = blocked.extract_gray if lay == "gray" else \
                blocked.extract_color
            steps[f"request_{lay}_{size}"] = (
                lambda fn=fn, x_=x_, c_=c_, p_=p_: fn(
                    x_, c_, p_.uw, p_.vwt, p_.inv_blk, p_.inv_intra, ALPHA,
                    sw=p_.sw, sweeps=SWEEPS))
            steps[f"request_{lay}_{size}_eager"] = (
                lambda x_=x_, c_=c_, p_=p_, g=lay == "gray": eager_request(
                    x_, c_, p_.uw, p_.vwt, p_.inv_blk, p_.inv_intra, p_.sw,
                    g))
    # the kernels alone on the front's output: K5 (and its paint pass
    # alone, without normalize) where the tree has it, and K5f
    if "_recompute" in forms:
        for name, s_, sc_, pw, frames in (("color", s_cw, sc, pwc, True),
                                          ("gray", s_cwg, scg, pwg, False)):
            x = blocked._tail_front(s_, sc_, pw.inv_blk, ALPHA, k, pw.sw)
            eb = pw.ebasis[..., :k, :, :]
            eb64 = eb.reshape(*eb.shape[:-2], 64)
            steps[f"k5_{name}"] = (
                lambda x=x, e=eb64, fr=frames: tail_cuda.recon_normalize(
                    x, e, H, W, to_frames=fr))
            steps[f"k5_paint_{name}"] = (
                lambda x=x, e=eb64, fr=frames: tail_cuda.recon_normalize(
                    x, e, H, W, normalize=False, to_frames=fr))
            if hasattr(tail_cuda, "tail_front"):
                raw = blocked._raw_estimate(s_, sc_, ALPHA)
                args = (s_, sc_, pw.inv_blk, blocked._alpha(ALPHA, s_.device),
                        k, pw.sw, blocked._sw_scale(pw.sw),
                        blocked._engaged(raw, pw.sw))
                steps[f"k5f_{name}"] = (
                    lambda a=args: tail_cuda.tail_front(*a))
            # K8 alone on the product of the same estimates; where the
            # tree has its two instances, each, and the resident one
            # without normalize (no fold, no grid barrier)
            if hasattr(tail_cuda, "normalize_blocks"):
                blocks = blocked._recon(x[..., :k], eb64)
                steps[f"k8_{name}"] = (
                    lambda b=blocks, x=x, fr=frames:
                    tail_cuda.normalize_blocks(b, x, k, H, W, to_frames=fr))
            if hasattr(tail_cuda, "NormPlan"):
                plans = k8_plans(x.device, x.shape[0], 3 if frames else 1)
                for inst, kw in (("two_pass", {}), ("resident", {}),
                                 ("resident_no_normalize",
                                  {"normalize": False})):
                    steps[f"k8_{name}_{inst}"] = (
                        lambda b=blocks, x=x, fr=frames, kw=kw,
                        p=plans[inst.split("_no_")[0]]:
                        tail_cuda.normalize_blocks(b, x, k, H, W,
                                                   to_frames=fr, plan=p,
                                                   **kw))
    out = {name: [cuda_time(fn, 10) for _ in range(2)]
           for name, fn in steps.items()}
    if hasattr(tail_cuda, "normalize_blocks"):
        out.update(k8u_times(covers, wm_u8))
    # the bench's batch of 128: the 32 frames four times
    st128, sc128 = st.repeat(4, 1, 1, 1), sc.repeat(4, 1, 1, 1)
    # the front and the presence statistic at 128 frames, eager beside
    s128 = blocked._frames_spectrum(st128, SWEEPS)
    at128 = {"front_color_eager_128": lambda: eager_front(s128, sc128, pwc),
             "presence_color_eager_128": lambda: eager_statistic(
                 s128, sc128, pwc.sw)}
    if hasattr(blocked, "_tail_front"):
        at128["front_color_128"] = lambda: blocked._tail_front(
            s128, sc128, pwc.inv_blk, ALPHA, k, pwc.sw)
        at128["front_color_eager_statistic_128"] = (
            lambda: front_eager_statistic(s128, sc128, pwc))
    if hasattr(tail_cuda, "presence"):
        at128["presence_color_128"] = lambda: tail_cuda.presence(
            s128, pwc.sw, sc128, blocked._alpha(ALPHA, s128.device))
    out.update({name: [cuda_time(fn, 5) for _ in range(2)]
                for name, fn in at128.items()})
    del s128
    if "_recompute" in forms:
        # hold K5's output at the bench's batch to the twin, and the entry
        # point's to K5 on its inputs, before timing
        x128 = blocked._tail_front(blocked._frames_spectrum(st128, SWEEPS),
                                   sc128, pwc.inv_blk, ALPHA, k, pwc.sw)
        eb = pwc.ebasis[..., :k, :, :]
        eb64 = eb.reshape(*eb.shape[:-2], 64)
        y = tail_cuda.recon_normalize(x128, eb64, H, W, to_frames=True)
        require(torch.equal(y, tail_cuda.recon_normalize_plain(
            x128, eb64, H, W, to_frames=True)), "K5 at batch 128 vs twin")
        require(torch.equal(y, blocked.extract_color_prepared(
            st128, sc128, pwc.ebasis, pwc.inv_blk, ALPHA, sw=pwc.sw,
            recompute=True)), "extract at batch 128 vs K5")
        del x128, y
    for suffix, kw in forms.items():
        out["extract_color_128" + suffix] = [
            cuda_time(lambda kw=kw: blocked.extract_color_prepared(
                st128, sc128, pwc.ebasis, pwc.inv_blk, ALPHA, sw=pwc.sw,
                **kw), 5) for _ in range(2)]
    if hasattr(tail_cuda, "normalize_blocks"):
        out.update(k8_at_128(st128, sc128, stg.repeat(4, 1, 1, 1),
                             scg.repeat(4, 1, 1), pwc, pwg, k))
    return out


def k8u_times(covers, wm_u8) -> dict:
    """K8u (K8 with a crop) alone on the product of the 32 frames cut to
    1079x1917 (color frames and gray planes) and to 480x854 (color), each
    held to its twin first, then two readings of 10 CUDA-event calls and
    its kernels' device time (``*_device``, profiler, 10 calls): the plan
    the tree picks (``k8u_*``: the resident instance where the tree's crop
    takes it, else the two-pass one), at 1079x1917 the two-pass instance
    forced (``k8u_*_two_pass``) and the resident one forced where the tree
    has shape_plan (``k8u_*_resident``, and without normalize, no fold or
    grid barrier: ``k8u_*_resident_no_normalize``, beside K8's
    ``k8_*_resident_no_normalize``); and the 32-frame prepared extract
    at 1079x1917 (``extract_color_1079x1917``: K1, K18, K5f, the product,
    K8u)."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import color, tail_cuda
    from dctsvd_tpu_torch.utils import crypto
    out = {}
    k = blocked.k_of_block(0.6)
    for (h, w), layouts in (((1079, 1917), ("color", "gray")),
                            ((480, 854), ("color",))):
        blk, intra = (torch.as_tensor(a, device=covers.device) for a in
                      crypto.block_permutation_indices(
                          crypto.derive_key(PASSWORD, bytes(8)),
                          blocked.n_blocks_of(h, w)))
        cut = covers[:, :h, :w].contiguous()
        wm = wm_u8[:h, :w].contiguous()
        for lay in layouts:
            gray = lay == "gray"
            if gray:
                pw = blocked.prepare_wm_gray(color.bgr_to_gray(wm), blk,
                                             intra)
                st, sc = blocked.embed_gray_prepared(
                    cut, pw.sw, ALPHA, with_metrics=False)[:2]
                s_cw = blocked._plane_spectrum(color.luma_f32(st), SWEEPS)
            else:
                pw = blocked.prepare_wm_color(wm, blk, intra)
                st, sc = blocked.embed_color_prepared(
                    cut, pw.sw, ALPHA, with_metrics=False)[:2]
                s_cw = blocked._frames_spectrum(st, SWEEPS)
            x = blocked._tail_front(s_cw, sc, pw.inv_blk, ALPHA, k, pw.sw)
            eb = pw.ebasis[..., :k, :, :]
            blocks = blocked._recon(x[..., :k], eb.reshape(*eb.shape[:-2],
                                                           64))
            name = f"k8u_{lay}" + ("" if h == 1079 else f"_{h}x{w}")
            plans = {"": {}}
            if h == 1079:
                plans["_two_pass"] = {"plan": tail_cuda.NormPlan("two_pass")}
                if hasattr(tail_cuda, "shape_plan"):
                    sms, smem, _ = tail_cuda.device_limits(covers.device)
                    res = tail_cuda.shape_plan(x.shape[0], 1 if gray else 3,
                                               h, w, True, sms, smem)
                    plans["_resident"] = {"plan": res}
                    plans["_resident_no_normalize"] = {"plan": res,
                                                       "normalize": False}
            for suffix, kw in plans.items():
                def call(kw=kw):
                    return tail_cuda.normalize_blocks(
                        blocks, x, k, h, w, to_frames=not gray, **kw)
                ref = tail_cuda.normalize_blocks_plain(
                    blocks, x, k, h, w, to_frames=not gray,
                    normalize=kw.get("normalize", True))
                require(torch.equal(call(), ref),
                        f"{name}{suffix} vs twin")
                out[name + suffix] = [cuda_time(call, 10) for _ in range(2)]
                out[name + suffix + "_device"] = device_ms(call, 10, "norm_")
            if lay == "color" and h == 1079:
                def extract():
                    return blocked.extract_color_prepared(
                        st, sc, pw.ebasis, pw.inv_blk, ALPHA, sw=pw.sw)
                out["extract_color_1079x1917"] = [cuda_time(extract, 10)
                                                  for _ in range(2)]
            del x, blocks, ref
    return out


def k8_at_128(st128, sc128, stg128, scg128, pwc, pwg, k) -> dict:
    """At the bench's batch of 128: K8 alone on the color product (held to
    its twin first), two readings of 10 launches; K5f's gray instance on
    the gray spectra (held to its twin first), two readings of 50
    launches, with its byte bound (``k5f_gray_128_bound_ms``: the spectra,
    sw and inv_blk read once, the k + 1 columns written once)."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import color, tail_cuda
    out = {}
    x = blocked._tail_front(blocked._frames_spectrum(st128, SWEEPS), sc128,
                            pwc.inv_blk, ALPHA, k, pwc.sw)
    eb = pwc.ebasis[..., :k, :, :]
    blocks = blocked._recon(x[..., :k], eb.reshape(*eb.shape[:-2], 64))
    y = tail_cuda.normalize_blocks(blocks, x, k, H, W, to_frames=True)
    require(torch.equal(y, tail_cuda.normalize_blocks_plain(
        blocks, x, k, H, W, to_frames=True)), "K8 at batch 128 vs twin")
    out["k8_color_128"] = [cuda_time(lambda: tail_cuda.normalize_blocks(
        blocks, x, k, H, W, to_frames=True), 10) for _ in range(2)]
    out["k8_color_128_two_pass_bound_ms"] = (
        (2 * x[..., 0].numel() * (64 + 1) * 4 + y.numel()) / PEAK_BYTES * 1e3)
    out["k8_color_128_bound_ms"] = (
        (x[..., 0].numel() * (64 + 1) * 4 + y.numel()) / PEAK_BYTES * 1e3)
    if hasattr(tail_cuda, "NormPlan"):
        # the two-pass instance at the same batch, held to the twin first
        two = tail_cuda.NormPlan("two_pass")
        require(torch.equal(y, tail_cuda.normalize_blocks(
            blocks, x, k, H, W, to_frames=True, plan=two)),
            "K8 two-pass at batch 128 vs twin")
        out["k8_color_128_two_pass"] = [cuda_time(
            lambda: tail_cuda.normalize_blocks(blocks, x, k, H, W,
                                               to_frames=True, plan=two),
            10) for _ in range(2)]
    del x, blocks, y
    s_cw = blocked._plane_spectrum(color.luma_f32(stg128), SWEEPS)
    if hasattr(tail_cuda, "normalize_blocks"):
        # K8 on the gray product at 128 (each instance where the tree has
        # two), held to the twin first
        xg = blocked._tail_front(s_cw, scg128, pwg.inv_blk, ALPHA, k,
                                 pwg.sw)
        eb = pwg.ebasis[..., :k, :, :]
        bg = blocked._recon(xg[..., :k], eb.reshape(*eb.shape[:-2], 64))
        yg = tail_cuda.normalize_blocks_plain(bg, xg, k, H, W)
        variants = {"": {}}
        if hasattr(tail_cuda, "NormPlan"):
            variants["_two_pass"] = {"plan": tail_cuda.NormPlan("two_pass")}
        for suffix, kw in variants.items():
            require(torch.equal(yg, tail_cuda.normalize_blocks(
                bg, xg, k, H, W, **kw)), f"K8{suffix} gray at 128 vs twin")
            out["k8_gray_128" + suffix] = [cuda_time(
                lambda kw=kw: tail_cuda.normalize_blocks(bg, xg, k, H, W,
                                                         **kw), 10)
                for _ in range(2)]
        out["k8_gray_128_bound_ms"] = (
            (xg[..., 0].numel() * (64 + 1) * 4 + yg.numel()) / PEAK_BYTES
            * 1e3)
        del xg, bg, yg
    raw = blocked._raw_estimate(s_cw, scg128, ALPHA)
    args = (s_cw, scg128, pwg.inv_blk, blocked._alpha(ALPHA, s_cw.device), k,
            pwg.sw, blocked._sw_scale(pwg.sw), blocked._engaged(raw, pwg.sw))
    y = tail_cuda.tail_front(*args)
    require(torch.equal(y, tail_cuda.tail_front_plain(*args)),
            "K5f gray at batch 128 vs twin")
    out["k5f_gray_128"] = [cuda_time(lambda: tail_cuda.tail_front(*args), 50)
                           for _ in range(2)]
    out["k5f_gray_128_bound_ms"] = nbytes(
        s_cw, scg128, pwg.sw, pwg.inv_blk, y) / PEAK_BYTES * 1e3
    return out


def k5_times(dev, covers, wm_u8, blk, intra) -> dict:
    """ms of K5 (normalize, and its paint pass alone without), K5f and,
    where the tree has it, K8 (normalize, and its paint pass alone) on the
    main path's inputs at the 1080p batch of 32, color frames and gray
    planes, and K8 on 128 color frames, CUDA events, two readings of 20
    launches. Checks nothing: it times patched copies of the tree under
    build/ (the smoke and --tail-times hold the kernels to their
    twins)."""
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.ops import tail_cuda
    out = {}
    for name, gray in (("color", False), ("gray", True)):
        pw, sc, spectra = tail_spectra(dev, covers, wm_u8, blk, intra, gray)
        s_cw = spectra[0]
        x = blocked._tail_front(s_cw, sc, pw.inv_blk, ALPHA, K, pw.sw)
        eb = pw.ebasis[..., :K, :, :]
        eb64 = eb.reshape(*eb.shape[:-2], 64)
        raw = blocked._raw_estimate(s_cw, sc, ALPHA)
        args = (s_cw, sc, pw.inv_blk, blocked._alpha(ALPHA, dev), K, pw.sw,
                blocked._sw_scale(pw.sw), blocked._engaged(raw, pw.sw))
        rows = [("k5", lambda: tail_cuda.recon_normalize(
                    x, eb64, H, W, to_frames=not gray)),
                ("k5_paint", lambda: tail_cuda.recon_normalize(
                    x, eb64, H, W, normalize=False, to_frames=not gray)),
                ("k5f", lambda: tail_cuda.tail_front(*args))]
        if hasattr(tail_cuda, "normalize_blocks"):
            blocks = blocked._recon(x[..., :K], eb64)
            rows += [("k8", lambda: tail_cuda.normalize_blocks(
                         blocks, x, K, H, W, to_frames=not gray)),
                     ("k8_paint", lambda: tail_cuda.normalize_blocks(
                         blocks, x, K, H, W, normalize=False,
                         to_frames=not gray))]
        for row, fn in rows:
            out[f"{row}_{name}"] = [cuda_time(fn, 20) for _ in range(2)]
        if hasattr(tail_cuda, "normalize_blocks") and not gray:
            del blocks
            x128 = x.repeat(4, 1, 1, 1)
            b128 = blocked._recon(x128[..., :K], eb64)
            out["k8_color_128"] = [cuda_time(
                lambda: tail_cuda.normalize_blocks(b128, x128, K, H, W,
                                                   to_frames=True), 20)
                for _ in range(2)]
            del x128, b128
    return out


def recon_forms(dev) -> dict:
    """The extract tail's k-term product Σ_j x[f, m, j]·e[m, j, :] (k = 4,
    64 pixels) at the 1080p color (3 × 32,400 blocks) and gray (32,400)
    shapes, in each candidate form, on 1, 4, 8 and 32 frames: ms (CUDA
    events, two readings of 10 calls after a warm-up), and whether a
    frame's bytes are the same alone, in a shard of 4 or 8 and in the
    batch of 32 (``invariant``). ``port`` is models/blocked._recon."""
    import torch
    from dctsvd_tpu_torch.models import blocked

    def einsum(x, e):
        return torch.einsum("fmj,mjp->fmp", x, e)

    def chunked(c, frames_as_n=False):
        def form(x, e):
            f, m, k = x.shape
            pad = (-f) % c
            if pad:
                x = torch.cat([x, x.new_zeros(pad, m, k)])
            if frames_as_n:      # [m, 64, k] @ [m, k, c]
                xt, et = x.permute(1, 2, 0), e.transpose(1, 2)
                out = torch.empty(m, e.shape[-1], f + pad, device=x.device)
                for i in range(0, f + pad, c):
                    out[:, :, i:i + c] = torch.bmm(et, xt[:, :, i:i + c])
                return out.permute(2, 0, 1)[:f]
            xt = x.permute(1, 0, 2)
            out = torch.empty(m, f + pad, e.shape[-1], device=x.device)
            for i in range(0, f + pad, c):
                torch.bmm(xt[:, i:i + c], e, out=out[:, i:i + c])
            return out.permute(1, 0, 2)[:f]
        return form

    def per_frame(x, e):
        return torch.stack([torch.bmm(xi[:, None, :], e)[:, 0] for xi in x])

    def addcmul(x, e):
        out = x[..., 0:1] * e[:, 0]
        for j in range(1, x.shape[-1]):
            out.addcmul_(x[..., j:j + 1], e[:, j])
        return out

    forms = dict(einsum=einsum, bmm_8=chunked(8), bmm_32=chunked(32),
                 bmm_8_frames_as_n=chunked(8, True), per_frame=per_frame,
                 addcmul=addcmul, port=blocked._recon)
    gen = torch.Generator(device=dev).manual_seed(20261032)
    rows = {}
    for shape, m in (("color", 3 * H * W // 64), ("gray", H * W // 64)):
        x = torch.randn(BATCH, m, K + 1, generator=gen,
                        device=dev)[..., :K]         # a strided slice, as
        e = torch.randn(m, K, 64, generator=gen, device=dev)   # the tail's
        for name, form in forms.items():
            whole = form(x, e)
            parts = [(0, 1), (BATCH - 1, BATCH), (4, 8), (8, 16)]
            invariant = all(torch.equal(form(x[a:b], e), whole[a:b])
                            for a, b in parts)
            rows.setdefault(shape, {})[name] = dict(
                invariant=invariant,
                max_abs_vs_einsum=float((whole - einsum(x, e)).abs().max()),
                ms={str(f): [cuda_time(lambda f=f: form(x[:f], e), 10)
                             for _ in range(2)] for f in (1, 4, 8, BATCH)})
    return rows


def parallel_meshes(calls, ref, meshes, rows, launches, st, sc, sharded):
    """phase_parallel's loop: each entry point through the unsharded call
    and each mesh, held to the unsharded outputs, its launches counted
    and its time taken (into ``rows`` and ``launches``)."""
    import warnings

    import torch
    # outputs compared within 1e-5 (scores and metrics); the rest exactly
    scored = {"serve": {"3"}, "detect_blocked": {"0"},
              "embed_blocked": {"psnr", "ssim"}}
    for mname, mesh in [("unsharded", None)] + list(meshes.items()):
        fns = calls if mesh is None else sharded(mesh, st, sc)
        shards = 1 if mesh is None else len(mesh.devices)
        # each shard launches its kernels once, K4 once a device
        expect = {"serve": {"roundtrip_frames_blocks": shards,
                            "tail_front": shards,
                            "normalize_blocks": shards,
                            "band_scores": shards},
                  "embed_prepared": {"embed_blocks": shards},
                  "extract_prepared": {"spectrum_blocks": shards,
                                       "tail_front": shards,
                                       "normalize_blocks": shards},
                  "detect_blocked": {"spectrum_blocks": shards,
                                     "band_scores": shards},
                  "embed_blocked": {"embed_blocks": shards,
                                    "jacobi_svd8": 1}}
        for name, fn in fns.items():
            row = {}
            if mesh is not None:
                torch.cuda.set_sync_debug_mode("warn")
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    out, _, n = counted_run(fn, parallel_wrappers())
                torch.cuda.set_sync_debug_mode("default")
                row["host_syncs"] = len(caught)
                require(not caught, f"{mname} {name} synchronised with "
                        f"the host: {[str(w.message) for w in caught]}")
                row["launches"] = n
                for k, v in n.items():
                    launches[k] += v
                for k, v in expect[name].items():
                    require(n[k] == v, f"{mname} {name}: {k} launched "
                            f"{n[k]} times, expected {v}")
                r = ref[name]
                if isinstance(out, dict):
                    cmp = {k: differ(out[k], r[k]) for k in out}
                else:
                    out = out if isinstance(out, tuple) else (out,)
                    r = r if isinstance(r, tuple) else (r,)
                    cmp = {str(i): differ(o, q) for i, (o, q) in
                           enumerate(zip(out, r))}
                row["vs_unsharded"] = cmp
                for key, d in cmp.items():
                    if key in scored.get(name, ()):
                        require(d["max"] <= 1e-5, f"{mname} {name} {key}: "
                                f"{d['max']} from the unsharded call")
                    else:
                        require(d["equal"], f"{mname} {name} {key} differs "
                                f"from the unsharded call: {d}")
            ms = cuda_time(fn, 3)
            row.update(ms=ms, frames_per_s=BATCH / ms * 1e3)
            rows.setdefault(name, {})[mname] = row


def phase_parallel(dev, covers, wm_u8, blk, intra):
    """parallel/batch on the 1080p batch of 32 through four meshes: the
    unsharded single-device calls, a one-card mesh, four shards on this
    card ([cuda:0] * 4, one after another) and one frame a shard. Each
    entry point's outputs are held to the unsharded call's (stego, sc
    and the recovered watermark byte-equal, scores and metrics within
    1e-5), its launches of K1..K4 and K5f counted in a window of its own,
    its frames/s timed with CUDA events after a warm-up; no sharded call
    may synchronise with the host (CUDA sync debug mode, after the
    unsharded calls have put the constants on the card). Every call of
    K1..K4 and K5f on these paths, at each shape it took (the batch of
    32, a shard of 8, one frame), is then made again through its kernel
    and its plain twin on the same inputs: bit-equal.
    Then batch_detect_full on four σ3-blurred frames, against the
    per-image parity detect, with the batched SVD's difference beside
    it. batch_embed_blocked's metrics launch K15 and K16 and no eager
    form. Returns the launches on the meshes."""
    import torch
    from dctsvd_tpu_torch.models import blocked, image
    from dctsvd_tpu_torch.ops import color, dct, svd
    from dctsvd_tpu_torch.parallel import batch as pbatch
    from dctsvd_tpu_torch.parallel import mesh as pmesh

    pwc = blocked.prepare_wm_color(wm_u8, blk, intra)
    wm_gray = color.bgr_to_gray(wm_u8)
    pwg = blocked.prepare_wm_gray(wm_gray, blk, intra)

    def unsharded():
        st, sc, _, _ = blocked.embed_gray_prepared(covers, pwg.sw, ALPHA,
                                                   with_metrics=False)
        emb = blocked.embed_gray(covers, wm_gray, blk, intra, ALPHA)
        return dict(
            serve=lambda: blocked.serve_verify_detect_color_prepared(
                covers, pwc.sw, ALPHA, pwc.ebasis, pwc.inv_blk),
            embed_prepared=lambda: blocked.embed_gray_prepared(
                covers, pwg.sw, ALPHA, with_metrics=False)[:2],
            extract_prepared=lambda: blocked.extract_gray_prepared(
                st, sc, pwg.ebasis, pwg.inv_blk, ALPHA, sw=pwg.sw),
            detect_blocked=lambda: blocked.detect_gray(st, sc, pwg.sw,
                                                       ALPHA),
            embed_blocked=lambda: blocked.embed_gray(
                covers, wm_gray, blk, intra, ALPHA)), (st, sc, emb)

    def sharded(mesh, st, sc):
        return dict(
            serve=lambda: pbatch.batch_serve_verify_detect(
                covers, pwc.sw, ALPHA, pwc.ebasis, pwc.inv_blk, mesh=mesh),
            embed_prepared=lambda: pbatch.batch_embed_prepared(
                covers, pwg.sw, ALPHA, mesh=mesh),
            extract_prepared=lambda: pbatch.batch_extract_prepared(
                st, sc, pwg.ebasis, pwg.inv_blk, pwg.sw, ALPHA, mesh=mesh),
            detect_blocked=lambda: pbatch.batch_detect_blocked(
                st, sc, pwg.sw, ALPHA, mesh=mesh, per_frame_sc=True),
            embed_blocked=lambda: pbatch.batch_embed_blocked(
                covers, wm_gray, blk, intra, ALPHA, mesh=mesh))

    calls, (st, sc, emb) = unsharded()
    ref = {name: fn() for name, fn in calls.items()}
    ref["embed_blocked"] = dict(stego=emb.stego_bgr, sc=emb.sc, uw=emb.uw,
                                vwt=emb.vwt, sw=emb.sw, psnr=emb.psnr,
                                ssim=emb.ssim)
    meshes = {"one_card": pmesh.make_mesh(1),
              "four_shards": pmesh.make_mesh(devices=[dev] * 4),
              "frame_shards": pmesh.make_mesh(devices=[dev] * BATCH)}
    require(meshes["one_card"].devices == (dev,), "one-card mesh")
    rows, launches = {}, {n: 0 for n in parallel_wrappers()}
    with recorded_calls() as path_calls, launch_counts() as metric_calls:
        parallel_meshes(calls, ref, meshes, rows, launches, st, sc, sharded)
    # batch_embed_blocked's embeds with metrics: K15 and K16, no eager form
    require(all(metric_calls[k] >= 1 for k in METRIC_KERNELS)
            and not any(metric_calls["eager"].values()),
            f"parallel: K15's and K16's launches and the eager forms' calls "
            f"{metric_calls}")
    launches.update({k: metric_calls[k] for k in METRIC_KERNELS})
    twin_rows = recorded_vs_twin(path_calls)
    own = ref["serve"][3]
    require(float(own.min()) > 0.8, f"own serve score {float(own.min())}")
    own = ref["detect_blocked"]
    require(float(own.min()) > 0.8, f"own gray score {float(own.min())}")

    # the parity detect of a batch against one meta, per image
    covers_np = [smooth_frame(20261030 + i) for i in range(3)]
    idx = torch.arange(H * W, device=dev)
    c0 = torch.as_tensor(covers_np[0], device=dev)
    res = image.embed_gray(c0, wm_gray, idx, ALPHA)
    batch4 = torch.stack([res.stego_bgr, c0] + [
        torch.as_tensor(c, device=dev) for c in covers_np[1:]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = pbatch.batch_detect_full(batch4, res.sc, res.sw, ALPHA,
                                    mesh=meshes["four_shards"])
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    single = torch.stack([image.detect_gray(im, res.sc, res.sw, ALPHA)
                          for im in batch4])
    batched = image.detect_gray(batch4, res.sc, res.sw, ALPHA)
    y = color.luma_f32(batch4)
    s_b = svd.svd_full(dct.dct2(y), compute_uv=False)
    s_1 = torch.stack([svd.svd_full(dct.dct2(p), compute_uv=False)
                       for p in y])
    require(torch.equal(full, single),
            f"batch_detect_full {full.tolist()} != per image "
            f"{single.tolist()}")
    require(float(full[0]) > 0.6 and float(full[1]) == 0.0,
            f"batch_detect_full scores {full.tolist()}")
    emit({"phase": "parallel_1080p", "batch": BATCH, "calls": rows,
          "launches": launches, "kernels_vs_twin": twin_rows,
          "detect_full": dict(
              scores=full.tolist(), seconds=full_s,
              batched_call_scores=batched.tolist(),
              batched_s_equal=bool(torch.equal(s_b, s_1)),
              batched_s_max_rel=float(((s_b - s_1).abs()
                                       / s_1.abs().amax(-1, keepdim=True))
                                      .max())),
          "card": smi_line()})
    return launches


def phase_plane(dev):
    """parallel/plane on one seeded 4320x7680 cover: one band (a one-card
    mesh) and four bands ([cuda:0] * 4). The stego and sc equal
    embed_gray_prepared on the whole frame; the own stego scores > 0.8,
    the cover < 0.3; embed and detect timed with CUDA events. K2 and K1,
    at each shape the bands gave them (the whole 8K luma plane, a
    1080-row band), and K6 and K7 at theirs, are made again through the
    kernel and the plain twin on the same inputs: bit-equal. Returns the
    launches on the meshes (K1-K4's, K5f's, K8's, K6's and K7's)."""
    import torch
    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.parallel import mesh as pmesh
    from dctsvd_tpu_torch.parallel import plane as pplane
    from dctsvd_tpu_torch.utils import crypto

    gen = torch.Generator(device=dev).manual_seed(20261031)
    cover = torch.randint(0, 256, (PLANE_H, PLANE_W, 3), generator=gen,
                          device=dev, dtype=torch.uint8)
    wm = torch.randint(0, 256, (PLANE_H, PLANE_W), generator=gen,
                       device=dev, dtype=torch.uint8)
    key = crypto.derive_key(PASSWORD, bytes(8))
    blk, intra = (torch.as_tensor(a, device=dev) for a in
                  crypto.block_permutation_indices(
                      key, blocked.n_blocks_of(PLANE_H, PLANE_W)))
    pw = blocked.prepare_wm_gray(wm, blk, intra, extract_basis=False)
    ref_st, ref_sc, _, _ = blocked.embed_gray_prepared(cover, pw.sw, ALPHA,
                                                       with_metrics=False)
    rows = {}
    launches = dict.fromkeys([*parallel_wrappers(), *COLOR_KERNELS], 0)
    meshes = (("one_band", pmesh.make_mesh(1)),
              ("four_bands", pmesh.make_mesh(devices=[dev] * 4)))
    with recorded_calls() as path_calls:
        for mname, mesh in meshes:
            n_bands = len(mesh.devices)
            # the recorders, which keep the counts while they stand in
            counted = dict(parallel_wrappers(), **color_wrappers())
            (st, sc), _, n_emb = counted_run(
                lambda: pplane.plane_embed_gray(cover, pw.sw, ALPHA,
                                                mesh=mesh), counted)
            with eager_band_calls() as eager_calls:
                score, _, n_det = counted_run(
                    lambda: pplane.plane_detect_gray(st, sc, pw.sw, ALPHA,
                                                     mesh=mesh), counted)
            clean = pplane.plane_detect_gray(cover, sc, pw.sw, ALPHA,
                                             mesh=mesh)
            require(n_emb["embed_blocks"] == n_bands
                    and n_det["spectrum_blocks"] == n_bands
                    and n_det["band_scores"] == n_bands
                    and not any(eager_calls.values()),
                    f"{mname}: launches {n_emb} {n_det}, eager band calls "
                    f"{eager_calls}")
            for k in launches:
                launches[k] += n_emb[k] + n_det[k]
            require(torch.equal(st, ref_st) and torch.equal(sc, ref_sc),
                    f"{mname}: stego {differ(st, ref_st)}, sc "
                    f"{differ(sc, ref_sc)} against the whole-frame embed")
            require(float(score) > 0.8 and abs(float(clean)) < 0.3,
                    f"{mname}: score {float(score)}, clean {float(clean)}")
            rows[mname] = dict(
                score=float(score), clean=float(clean),
                embed_ms=cuda_time(lambda: pplane.plane_embed_gray(
                    cover, pw.sw, ALPHA, mesh=mesh), 3),
                detect_ms=cuda_time(lambda: pplane.plane_detect_gray(
                    st, sc, pw.sw, ALPHA, mesh=mesh), 3),
                launches=dict(embed=n_emb, detect=n_det))
    twin_rows = recorded_vs_twin(path_calls)
    rows["whole_frame"] = dict(
        embed_ms=cuda_time(lambda: blocked.embed_gray_prepared(
            cover, pw.sw, ALPHA, with_metrics=False), 3),
        detect_ms=cuda_time(lambda: blocked.detect_gray(
            ref_st, ref_sc, pw.sw, ALPHA), 3))
    emit({"phase": "plane_8k", "shape": [PLANE_H, PLANE_W, 3],
          "blocks": blocked.n_blocks_of(PLANE_H, PLANE_W), "rows": rows,
          "launches": launches, "kernels_vs_twin": twin_rows,
          "card": smi_line()})
    return launches


def phase_gui(dev, td: str, cover_np, wm_np):
    """The GUI's handlers on a 1080p PNG on the card, blocked and parity:
    embed (its nonce seeded, so that the stego, whose SHA-256 it prints,
    and its PSNR and SSIM are the same in every run; its metrics through
    K15 and K16, once each, no eager form), detect (scored above the
    meta's threshold) and extract. Returns K15's and K16's launches."""
    import cv2
    from dctsvd_tpu_torch import gui
    from dctsvd_tpu_torch.utils.config import (DETECT_THRESH_BLOCKED,
                                               DETECT_THRESH_DEFAULT)
    cp, wp = os.path.join(td, "gui_host.png"), os.path.join(td, "gui_wm.png")
    cv2.imwrite(cp, cover_np)
    cv2.imwrite(wp, wm_np)
    rows, launches = {}, {}
    nonce = seeded_nonces(1)[0]
    for method, blocked_ in (("blocked", True), ("parity", False)):
        out = os.path.join(td, f"gui_{method}.png")
        meta = os.path.join(td, f"gui_{method}_meta.npz")
        t0 = time.perf_counter()
        with pinned_nonce(nonce), launch_counts() as n:
            e = gui.handle_embed(cp, wp, out, PASSWORD, ALPHA, False,
                                 blocked_, device=dev)
        t1 = time.perf_counter()
        require(all(n[k] == 1 for k in METRIC_KERNELS)
                and not any(n["eager"].values()),
                f"gui {method} embed: K15's and K16's launches and the "
                f"eager forms' calls {n}")
        launches[method] = n
        d = gui.handle_detect(out, meta, device=dev)
        t2 = time.perf_counter()
        x = gui.handle_extract(out, meta, os.path.join(td, f"gui_{method}_"
                                                       "wm.png"),
                               PASSWORD, device=dev)
        t3 = time.perf_counter()
        for what, r in (("embed", e), ("detect", d), ("extract", x)):
            require(r.ok, f"gui {method} {what}: {r.message}")
        score = float(d.message.split()[1])
        thresh = DETECT_THRESH_BLOCKED if blocked_ else DETECT_THRESH_DEFAULT
        require(score > thresh and "Watermarked" in d.message,
                f"gui {method} detect: {d.message}")
        require(cv2.imread(x.preview_path) is not None,
                f"gui {method}: no extracted watermark")
        with open(out, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        rows[method] = dict(score=score, embed_s=t1 - t0, detect_s=t2 - t1,
                            extract_s=t3 - t2,
                            embed_message=e.message.splitlines()[-1],
                            stego_sha256=digest)
    emit({"phase": "gui_handlers", "shape": list(cover_np.shape), **rows,
          "launches": launches, "card": smi_line()})
    return {k: sum(n[k] for n in launches.values()) for k in METRIC_KERNELS}


def phase_graft(dev):
    """graft_entry: entry()'s step once on the card, then
    dryrun_multichip(4) on four shards of this card."""
    import torch
    from dctsvd_tpu_torch import graft_entry
    fn, args = graft_entry.entry()
    (stego, sc, sw), entry_s, n_entry = counted_run(lambda: fn(*args),
                                                    parallel_wrappers())
    require(stego.shape == (2, 128, 128, 3) and stego.is_cuda
            and sc.shape == (2, 256, 8) and sw.shape == (256, 8),
            f"entry shapes {stego.shape} {sc.shape} {sw.shape}")
    _, dry_s, n_dry = counted_run(lambda: graft_entry.dryrun_multichip(4),
                                  parallel_wrappers())
    require(n_dry["roundtrip_frames_blocks"] == 4,
            f"dryrun launches {n_dry}")
    emit({"phase": "graft_dryrun", "entry_s": entry_s,
          "entry_launches": n_entry, "dryrun_s": dry_s,
          "dryrun_launches": n_dry, "device": str(torch.device(dev)),
          "card": smi_line()})


#: dctsvd_tpu_torch/bench.py's configs at the sizes the bench phase runs
#: them, cut from bench.py's defaults (which ``python -m
#: dctsvd_tpu_torch.bench`` runs): config -> (function, keyword arguments).
BENCH_RUNS = {
    "1080p": ("bench_embed_extract", dict(h=1080, w=1920, batch=32, iters=2,
                                          color=True)),
    "1080pgray": ("bench_embed_extract", dict(h=1080, w=1920, batch=32,
                                              iters=2, color=False)),
    "512gray": ("bench_embed_extract", dict(h=512, w=512, batch=128, iters=2,
                                            color=False)),
    "4k": ("bench_embed_extract", dict(h=2160, w=3840, batch=2, iters=2,
                                       color=True)),
    "detect": ("bench_detect", dict(batch=32, iters=2)),
    "budget": ("bench_budget", dict(batch=32, iters=2)),
    "1080p-full": ("bench_full_path", dict(batch=1, iters=1)),
    "8k-plane": ("bench_8k_plane", dict(iters=1)),
    "mesh": ("bench_mesh_scaling", dict(n_devices=4)),
    "video": ("bench_video", dict(frames=24)),
    "robustness": ("bench_robustness", dict(h=1080, w=1920, alphas=(0.13,))),
    "geometric": ("bench_geometric", dict(h=1080, w=1920, alphas=(0.13,))),
    "detect-roc": ("bench_detect_roc", dict(h=256, w=256, n_hosts=12,
                                            n_natural=12, alphas=(0.14,))),
}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
BENCH_EXTRA_KEYS = {"video": {"codec_only_fps", "device_step_marked_fps"},
                    "budget": {"budget"}, "mesh": {"overhead_curve"}}


def finite_numbers(obj) -> bool:
    """Every number in a JSON value is finite (and none is missing)."""
    if isinstance(obj, dict):
        return all(finite_numbers(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(finite_numbers(v) for v in obj)
    if isinstance(obj, (bool, str)):
        return True
    return isinstance(obj, (int, float)) and math.isfinite(obj)


def phase_bench(dev):
    """dctsvd_tpu_torch/bench.py's thirteen configs in this process, at
    the cut sizes of BENCH_RUNS, through the bench's own functions: each
    gives bench.py's JSON line (``bench.result_line``) with its keys and
    finite values, and passes bench.py's own checks (the 8K score and the
    mesh's lowest score above 0.5, inside the functions). The launches of
    :func:`twinned_wrappers` (K1-K4, K5f, K8, K9, K6, K7, K10, K11, K12,
    K13 and cols_view, the budget's T2b row) are counted for each
    config, set to 0 just before it runs and read just after, and summed
    over the phase. Every call of those kernels in a config, at each
    signature the config gave it and not checked in an earlier config,
    is then made again through its kernel and its plain twin on the same
    inputs (``recorded_vs_twin``, after the counts were read): bit-equal.
    Returns the phase's launches."""
    import torch
    from dctsvd_tpu_torch import bench
    rows, checked = {}, set()
    launches = dict.fromkeys(twinned_wrappers(), 0)
    for config, (fn, kw) in BENCH_RUNS.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with recorded_calls() as calls:
            # the recorders stand in for the wrappers and keep the counts
            result, seconds, n = counted_run(
                lambda: getattr(bench, fn)(device=dev, **kw),
                twinned_wrappers())
        peak = torch.cuda.max_memory_allocated() / 2**30
        for name, v in n.items():
            launches[name] += v
        line = bench.result_line(config, result,
                                 mesh_devices=kw.get("n_devices", 8),
                                 n_cards=torch.cuda.device_count())
        keys = BENCH_KEYS | BENCH_EXTRA_KEYS.get(config, set())
        require(set(line) == keys, f"bench {config}: keys {sorted(line)}")
        require(finite_numbers(line), f"bench {config}: {line}")
        twin_rows = recorded_vs_twin({k: v for k, v in calls.items()
                                      if k not in checked})
        checked.update(calls)
        del calls
        rows[config] = dict(line=line, seconds=seconds, peak_gib=peak,
                            launches={k: v for k, v in n.items() if v},
                            kernels_vs_twin=twin_rows)
    require(all(launches.values()), f"bench launches {launches}")
    emit({"phase": "bench", "configs": rows, "launches": launches,
          "calls_vs_twin": sum(len(r["kernels_vs_twin"])
                               for r in rows.values()),
          "card": smi_line()})
    return launches


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "dctsvd_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require(torch.get_float32_matmul_precision() == "highest",
            "float32 matmul precision must be 'highest' (TF32 off)")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from dctsvd_tpu_torch.models import blocked
    from dctsvd_tpu_torch.utils import crypto, kernels

    card = smi_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    kernels.load()
    gen = torch.Generator(device=dev).manual_seed(20261016)
    covers = torch.randint(0, 256, (BATCH, H, W, 3), generator=gen,
                           device=dev, dtype=torch.uint8)
    wm_u8 = torch.randint(0, 256, (H, W, 3), generator=gen, device=dev,
                          dtype=torch.uint8)
    key = crypto.derive_key(PASSWORD, bytes(8))
    blk_np, intra_np = crypto.block_permutation_indices(
        key, blocked.n_blocks_of(H, W))
    blk = torch.as_tensor(blk_np, device=dev)
    intra = torch.as_tensor(intra_np, device=dev)
    if argv == ["--jacobi-times"]:
        # the instances' registers and spills (when this run built the
        # library) and their SASS by class, at each kernel's schedule
        kinds = ((SWEEPS, "spectrum_kernel"), (5, "svd8_kernel"),
                 (SWEEPS, "embed_recon_kernel"),
                 (SWEEPS, "spectrum_gram_kernel"))

        def ours(name):
            return any(kind in name for _, kind in kinds)

        sass = kernels.sass_dump(kernels.BUILD_INFO["path"])
        mix = {n: m for sw, kind in kinds
               for n, m in kernels.sass_mix(sass, sw).items() if kind in n}
        t3 = t3_rate(dev)
        rows = jacobi_times(covers, wm_coefs(wm_u8, blk, intra), mix, t3)
        emit({"phase": "jacobi_times",
              "nvcc_seconds": kernels.BUILD_INFO["seconds"],
              "ptxas": {k: v for k, v in kernels.ptxas_report(
                  kernels.BUILD_INFO["ptxas"]).items() if ours(k)},
              "sass": mix, "t3_unfused_op_per_s": t3, "times": rows,
              "card": card})
        bad = [name for name, r in rows.items() if not r["equals_twin"]]
        require(not bad, f"not equal to the twin on the card: {bad}")
        return 0
    if argv[:1] == ["--probe-times"] and len(argv) <= 2:
        # the spectrum probe's and fma_chain's instances, timed beside an
        # older tree's (argv[1]: its root) in one process
        out, bad = probe_times(dev, covers, argv[1] if argv[1:] else None)
        emit({"phase": "probe_times",
              "nvcc_seconds": kernels.BUILD_INFO["seconds"], **out,
              "card": card})
        require(not bad, f"not equal to the twin on the card: {bad}")
        return 0
    if argv == ["--svd-drivers"]:
        svd_drivers(dev, smooth_frame(20261017),
                    wm_u8[::8, ::8].cpu().numpy())
        return 0
    if argv == ["--paint-k-times"]:
        emit({"phase": "paint_k_times",
              "nvcc_seconds": kernels.BUILD_INFO["seconds"],
              "times_8_frames": paint_k_times(dev, covers), "card": card})
        return 0
    if argv == ["--color-bounds"]:
        emit({"phase": "color_bounds", **color_bounds(dev, covers),
              "card": card})
        return 0
    if argv == ["--tail-times"]:
        # K5f's and K5's k = 4 instances (the main path's): registers and
        # spills (when this run built the library), and their SASS by
        # class, the kernel's body once ("main"), its outermost loop's body
        # ("sweep") and every loop's ("loops", inner first: K5's frame
        # loops, K5f's plane loop)
        sass = kernels.sass_dump(kernels.BUILD_INFO["path"])
        k5 = {n: {c: m.get(c) for c in ("main", "sweep", "loops")}
              for n, m in kernels.sass_mix(sass, 2).items()
              if "tail_" in n and "ILi4E" in n}
        emit({"phase": "tail_times", "times": tail_times(covers, wm_u8, blk,
                                                          intra),
              "k5_ptxas": {n: v for n, v in kernels.ptxas_report(
                  kernels.BUILD_INFO["ptxas"]).items() if n in k5},
              "k5_sass": k5, "card": card})
        return 0
    if argv == ["--k5-times"]:
        emit({"phase": "k5_times",
              "nvcc_seconds": kernels.BUILD_INFO["seconds"],
              "ptxas": {n: v for n, v in kernels.ptxas_report(
                  kernels.BUILD_INFO["ptxas"]).items()
                  if "tail_" in n and "ILi4E" in n or "norm_" in n},
              "times": k5_times(dev, covers, wm_u8, blk, intra),
              "card": card})
        return 0
    if argv == ["--recon-forms"]:
        emit({"phase": "recon_forms", "forms": recon_forms(dev),
              "card": card})
        return 0
    if argv == ["--resync-times"]:
        emit({"phase": "resync_times",
              **resync_times(dev, covers[0].cpu().numpy(), wm_u8, blk,
                             intra),
              "nvcc_seconds": kernels.BUILD_INFO["seconds"], "card": card})
        return 0
    if argv == ["--enhance-times"]:
        emit({"phase": "enhance_times", **enhance_times(dev),
              "nvcc_seconds": kernels.BUILD_INFO["seconds"], "card": card})
        return 0
    if argv == ["--metrics-times"]:
        emit({"phase": "metrics_times",
              **metrics_times(dev, covers, wm_u8, blk, intra),
              "nvcc_seconds": kernels.BUILD_INFO["seconds"], "card": card})
        return 0
    if argv == ["--copy-times"]:
        emit({"phase": "copy_times",
              "nvcc_seconds": kernels.BUILD_INFO["seconds"],
              "ptxas": {k: v for k, v in kernels.ptxas_report(
                  kernels.BUILD_INFO["ptxas"]).items()
                  if "copy_f32" in k or "cols_view" in k},
              "times": copy_times(dev, covers), "card": card})
        return 0
    ptxas = kernels.ptxas_report(kernels.BUILD_INFO["ptxas"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": kernels.BUILD_INFO["seconds"],
          "library": os.path.relpath(kernels.BUILD_INFO["path"], REPO),
          "ptxas": ptxas, "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card})

    results = phase_kernels(dev, covers, wm_u8, blk, intra)
    phase_paint_k_sweep(dev, covers)
    launches = phase_slice(dev, covers, wm_u8, blk, intra)
    # K5f's launches on each path (one counter for both layouts; the gray
    # row's are the gray recompute extract's)
    front_paths = {"slice": launches.pop("tail_front")}
    # K18's likewise (the gray row's: the gray recompute extract's and the
    # gray request extracts')
    k18_paths = {"slice": launches.pop("presence")}
    # K8's likewise, in all and by instance (the gray rows': the gray
    # default extract's)
    k8_all = {"slice": launches.pop("normalize_blocks")}
    k8_paths = {"slice": launches.pop("normalize_blocks_resident")}
    k8_two = {"slice": launches.pop("normalize_blocks_two_pass")}
    # K9's likewise (both layouts; the color row's: the detect phase's
    # color calls)
    k9_paths = {"slice": launches.pop("band_scores")}
    serve = phase_serve(dev, covers, wm_u8, blk, intra)
    front_paths["serve"] = serve.pop("tail_front")
    k18_paths["serve"] = serve.pop("presence")
    k8_all["serve"] = serve.pop("normalize_blocks")
    k8_paths["serve"] = serve.pop("normalize_blocks_resident")
    k8_two["serve"] = serve.pop("normalize_blocks_two_pass")
    k9_paths["serve"] = serve.pop("band_scores")
    launches.update(serve)
    launches.update(phase_variants(dev, covers))
    tail = phase_tail_recompute(dev, covers, wm_u8, blk, intra)
    front_paths["tail_recompute"] = tail.pop("tail_front")
    front_gray = {"tail_recompute": tail.pop("tail_front_gray")}
    k18_paths["tail_recompute"] = tail.pop("presence")
    k18_gray = {"tail_recompute": tail.pop("presence_gray")}
    k8_all["tail_default"] = tail.pop("normalize_blocks")
    k8_paths["tail_default"] = tail.pop("normalize_blocks_resident")
    k8_two["tail_default"] = tail.pop("normalize_blocks_two_pass")
    k8_gray = {"tail_default": tail.pop("normalize_blocks_resident_gray")}
    require(tail.pop("normalize_blocks_gray") == k8_gray["tail_default"]
            and tail.pop("normalize_blocks_two_pass_gray") == 0,
            "the gray default extract at 1080p: K8's launches not all the "
            "resident instance's")
    launches.update(tail)
    # the request extract (extract_array) and the unaligned prepared
    # extract: K1, K18, K5f, K8 and K8u
    request, k8u_rows_ = phase_request_extract(dev, covers, wm_u8)
    results["normalize_blocks_crop"] = k8u_rows_["resident"]
    results["normalize_blocks_crop_two_pass"] = k8u_rows_["two_pass"]
    k18_paths["request_extract"] = request["color"]["presence"]
    k18_gray["request_extract"] = request["gray"]["presence"]
    front_paths["request_extract"] = sum(r["tail_front"]
                                         for r in request.values())

    def summed(key):
        return sum(r.get(key, 0) for r in request.values())
    # K8u's launches by instance; K8's rows keep the aligned calls'
    k8u_res = summed("normalize_blocks_crop_resident")
    k8u_two = summed("normalize_blocks_crop_two_pass")
    k8_all["request_extract"] = summed("normalize_blocks") - k8u_res - k8u_two
    k8_paths["request_extract"] = summed("normalize_blocks_resident") - k8u_res
    k8_two["request_extract"] = summed("normalize_blocks_two_pass") - k8u_two
    k8u_paths = {"request_extract": k8u_res}
    k8u_two_paths = {"request_extract": k8u_two}
    detect_results, k9_paths["detect_1080p"], k9_color = phase_detect(
        dev, covers, wm_u8, blk, intra)
    results.update(detect_results)
    color_results, color_slice = phase_color(dev, covers, wm_u8, blk, intra)
    results.update(color_results)
    metric_results, metric_launches = phase_metrics(dev, covers, wm_u8, blk,
                                                    intra)
    results.update(metric_results)
    phase_reference(dev)
    smooth = smooth_frame(20261017)
    wm_np = wm_u8[::8, ::8].cpu().numpy()          # a 135x240 watermark
    extracted, parity_color = phase_parity(dev, smooth, wm_np)
    phase_parity_reference(dev)
    enhance_results, enhance_launches = phase_enhance(dev, extracted)
    results.update(enhance_results)
    payload_launches, parity_text_recovered = phase_payload(dev, smooth)
    # resync on a noise cover: on smooth content neighbouring shifts and
    # angles score within the statistic's noise of the true one
    resync_launches, resync_color, resync_rows = phase_resync(
        dev, covers[0].cpu().numpy(), wm_u8, blk, intra)
    results.update(resync_rows)
    par_launches = phase_parallel(dev, covers, wm_u8, blk, intra)
    plane_launches = phase_plane(dev)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as gtd:
        gui_launches = phase_gui(dev, gtd, smooth, wm_np)
    phase_graft(dev)
    bench_launches = phase_bench(dev)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as vtd:
        clip, wm_png = (os.path.join(vtd, f) for f in ("clip.mp4", "wm.png"))
        write_clip(clip, H, W, VIDEO_FRAMES)
        write_circle(wm_png)
        video_launches = phase_video(dev, vtd, clip, wm_png)
        phase_video_resume(dev, vtd, clip, wm_png)
        phase_video_audio(dev, vtd, clip, wm_png)
        phase_video_reference(dev, vtd)
        cli_counts = phase_files(dev, covers, wm_u8, smooth,
                                  parity_text_recovered, clip, wm_png)
    probe_launches, probe_results, t3, clocks = phase_probes(dev, covers)
    launches.update(probe_launches)
    results.update(probe_results)
    # the operation-bound watermark kernels' f32 rates against the unfused
    # issue rate T3 measured in this run
    # (and their instruction bounds at the SM clock read beside T3's window)
    rates = {}
    for name in ("spectrum_blocks", "embed_blocks", "roundtrip_frames_blocks",
                 "jacobi_svd8", "embed_blocks_recon", "spectrum_blocks_gram"):
        rate = results[name]["ops"] / (results[name]["ms"] * 1e-3)
        ib = insn_bound_ms(results[name]["ops"], clocks["sm_mhz"])
        rates[name] = dict(op_per_s=rate, share_of_t3=rate / t3,
                           insn_bound_ms=ib,
                           insn_share=ib / results[name]["ms"])
    emit({"phase": "rates", "t3_unfused_op_per_s": t3, "clocks": clocks,
          **rates, "card": smi_line()})

    # name: (source, TPU kernel it replaces)
    sources = {
        "jacobi_svd8": ("dctsvd_tpu_torch/csrc/svd8.cu",
                        "dctsvd_tpu/ops/svd_pallas.py:76"),
        "embed_blocks": ("dctsvd_tpu_torch/csrc/wm_paint.cuh",
                         "dctsvd_tpu/ops/wm_pallas.py:329"),
        "spectrum_blocks": ("dctsvd_tpu_torch/csrc/wm_kernels.cu",
                            "dctsvd_tpu/ops/wm_pallas.py:460"),
        "roundtrip_frames_blocks": ("dctsvd_tpu_torch/csrc/wm_paint.cuh",
                                    "dctsvd_tpu/ops/wm_pallas.py:377"),
        "embed_blocks_recon": ("dctsvd_tpu_torch/csrc/wm_variants.cu",
                               "dctsvd_tpu/ops/wm_pallas.py:271"),
        "spectrum_blocks_gram": ("dctsvd_tpu_torch/csrc/wm_variants.cu",
                                 "dctsvd_tpu/ops/wm_pallas.py:491"),
        "recon_normalize": ("dctsvd_tpu_torch/csrc/extract_tail.cu",
                            "dctsvd_tpu/models/blocked.py:898"),
        "recon_normalize_gray": ("dctsvd_tpu_torch/csrc/extract_tail.cu",
                                 "dctsvd_tpu/models/blocked.py:898"),
        "tail_front": ("dctsvd_tpu_torch/csrc/extract_tail.cu",
                       "dctsvd_tpu/models/blocked.py:1003"),
        "tail_front_gray": ("dctsvd_tpu_torch/csrc/extract_tail.cu",
                            "dctsvd_tpu/models/blocked.py:1003"),
        "normalize_blocks": ("dctsvd_tpu_torch/csrc/extract_tail.cu",
                             "dctsvd_tpu/models/blocked.py:869"),
        "normalize_blocks_gray": ("dctsvd_tpu_torch/csrc/extract_tail.cu",
                                  "dctsvd_tpu/models/blocked.py:869"),
        "normalize_blocks_two_pass": (
            "dctsvd_tpu_torch/csrc/extract_tail.cu",
            "dctsvd_tpu/models/blocked.py:869"),
        "normalize_blocks_crop": ("dctsvd_tpu_torch/csrc/extract_tail.cu",
                                  "dctsvd_tpu/models/blocked.py:818"),
        "normalize_blocks_crop_two_pass": (
            "dctsvd_tpu_torch/csrc/extract_tail.cu",
            "dctsvd_tpu/models/blocked.py:818"),
        "presence": ("dctsvd_tpu_torch/csrc/presence.cu",
                     "dctsvd_tpu/models/blocked.py:767"),
        "presence_gray": ("dctsvd_tpu_torch/csrc/presence.cu",
                          "dctsvd_tpu/models/blocked.py:767"),
        "copy_f32": ("dctsvd_tpu_torch/csrc/probes.cu",
                     "tools/profile_transpose.py:45"),
        "cols_view": ("dctsvd_tpu_torch/csrc/probes.cu",
                      "tools/profile_transpose.py:112"),
        "fma_chain": ("dctsvd_tpu_torch/csrc/probes.cu",
                      "tools/exp_vpu_roofline.py:57"),
        "spectrum_probe": ("dctsvd_tpu_torch/csrc/probes.cu",
                           "tools/profile_view.py:44"),
        "luma_f32": ("dctsvd_tpu_torch/csrc/color.cu",
                     "dctsvd_tpu/ops/color.py:63"),
        "bgr_to_gray": ("dctsvd_tpu_torch/csrc/color.cu",
                        "dctsvd_tpu/ops/color.py:55"),
        "replace_luma": ("dctsvd_tpu_torch/csrc/color.cu",
                         "dctsvd_tpu/ops/color.py:75"),
        "band_scores": ("dctsvd_tpu_torch/csrc/detect.cu",
                        "dctsvd_tpu/models/blocked.py:1191"),
        "band_scores_color": ("dctsvd_tpu_torch/csrc/detect.cu",
                              "dctsvd_tpu/models/blocked.py:1191"),
        "nlm_planes": ("dctsvd_tpu_torch/csrc/enhance.cu",
                       "dctsvd_tpu/ops/enhance.py:189"),
        "nlm_planes_color": ("dctsvd_tpu_torch/csrc/enhance.cu",
                             "dctsvd_tpu/ops/enhance.py:234"),
        "clahe_luts": ("dctsvd_tpu_torch/csrc/enhance.cu",
                       "dctsvd_tpu/ops/enhance.py:92"),
        "clahe_apply": ("dctsvd_tpu_torch/csrc/enhance.cu",
                        "dctsvd_tpu/ops/enhance.py:92"),
        "roll_stack": ("dctsvd_tpu_torch/csrc/resync.cu",
                       "dctsvd_tpu/models/blocked.py:1381"),
        "roll_stack_gray": ("dctsvd_tpu_torch/csrc/resync.cu",
                            "dctsvd_tpu/models/blocked.py:1381"),
        "derotate": ("dctsvd_tpu_torch/csrc/resync.cu",
                     "dctsvd_tpu/models/blocked.py:1310"),
        "derotate_gray": ("dctsvd_tpu_torch/csrc/resync.cu",
                          "dctsvd_tpu/models/blocked.py:1310"),
        "unsharp": ("dctsvd_tpu_torch/csrc/enhance.cu",
                    "dctsvd_tpu/ops/enhance.py:76"),
        "unsharp_color": ("dctsvd_tpu_torch/csrc/enhance.cu",
                          "dctsvd_tpu/ops/enhance.py:76"),
        "ssim": ("dctsvd_tpu_torch/csrc/metrics.cu",
                 "dctsvd_tpu/ops/metrics.py:52"),
        "ssim_u8": ("dctsvd_tpu_torch/csrc/metrics.cu",
                    "dctsvd_tpu/ops/metrics.py:52"),
        "psnr": ("dctsvd_tpu_torch/csrc/metrics.cu",
                 "dctsvd_tpu/ops/metrics.py:23"),
        "bgr_to_ycrcb_planes": ("dctsvd_tpu_torch/csrc/color.cu",
                                "dctsvd_tpu/ops/color.py:31"),
        "ycrcb_planes_to_bgr": ("dctsvd_tpu_torch/csrc/color.cu",
                                "dctsvd_tpu/ops/color.py:42"),
    }
    # launches of K1, K2 and K4 on each path that drives them: the slice's,
    # the blocked payloads', the video runs', (K1) each resync search's;
    # K3's on the serve steps; K1-K4's through parallel/ (batch and
    # plane, on the one-card and the four-shard meshes) and through the
    # bench's thirteen configs
    paths = {name: {"slice": launches[name],
                    "payload": payload_launches[name],
                    "video": video_launches[name]}
             for name in payload_launches}
    paths["spectrum_blocks"].update(
        {f"resync_{n}": v for n, v in resync_launches["K1"].items()})
    paths["roundtrip_frames_blocks"] = {
        "serve": launches["roundtrip_frames_blocks"]}
    for name, by_path in paths.items():
        by_path["parallel"] = par_launches[name] + plane_launches[name]
        by_path["bench"] = bench_launches[name]
        launches[name] = sum(by_path.values())
    # K5 (color frames, gray planes): the recompute extracts (the default
    # tail is the eager form)
    for name in ("recon_normalize", "recon_normalize_gray"):
        paths[name] = {"tail_recompute": launches[name]}
    # K5f: both tail forms, the serve steps, video, parallel/ and the bench
    front_paths.update(video=video_launches["tail_front"],
                       parallel=par_launches["tail_front"]
                       + plane_launches["tail_front"],
                       bench=bench_launches["tail_front"])
    paths["tail_front"], paths["tail_front_gray"] = front_paths, front_gray
    # K18: every extract with sw (K5f's paths, and the request extracts)
    k18_paths.update(video=video_launches["presence"],
                     parallel=par_launches["presence"]
                     + plane_launches["presence"],
                     bench=bench_launches["presence"])
    paths["presence"], paths["presence_gray"] = k18_paths, k18_gray
    # K8u by instance: the resident one on the 1079x1917 request extracts
    # and prepared extract, the two-pass one on the 480x854 request
    # extracts
    paths["normalize_blocks_crop"] = k8u_paths
    paths["normalize_blocks_crop_two_pass"] = k8u_two_paths
    for name in ("presence", "presence_gray", "normalize_blocks_crop",
                 "normalize_blocks_crop_two_pass"):
        idle = [p for p, n in paths[name].items() if n == 0]
        require(not idle, f"{name} was not launched on the paths {idle}")
        launches[name] = sum(paths[name].values())
    # K8: the default tail on the slice, the serve steps, the tail phase's
    # default extracts, parallel/ and the bench (video's blocked extract
    # averages the raw estimates and normalises nothing), by instance: the
    # resident one on every path (1080p), the two-pass one where a frame
    # does not fit or is small (the bench's 4k and 512gray configs)
    for by_path, key in ((k8_all, "normalize_blocks"),
                         (k8_paths, "normalize_blocks_resident"),
                         (k8_two, "normalize_blocks_two_pass")):
        by_path.update(parallel=par_launches[key] + plane_launches[key],
                       bench=bench_launches[key])
    require(all(k8_all[p] == k8_paths[p] + k8_two[p] for p in k8_all),
            f"K8's launches {k8_all} are not its instances' {k8_paths} "
            f"{k8_two}")
    idle = [p for p, n in k8_paths.items() if n == 0]
    require(not idle, f"K8's resident instance was not launched on the "
            f"paths {idle}")
    require(k8_two["bench"] >= 1, f"K8's two-pass instance was not "
            f"launched by the bench: {k8_two}")
    paths["normalize_blocks"], paths["normalize_blocks_gray"] = (k8_paths,
                                                                 k8_gray)
    paths["normalize_blocks_two_pass"] = k8_two
    for name in ("tail_front", "tail_front_gray", "normalize_blocks",
                 "normalize_blocks_gray", "normalize_blocks_two_pass"):
        launches[name] = sum(paths[name].values())
    # K9: the slice's detects, the serve steps' scores, the detect phase,
    # the resync searches, parallel/ (batch, serve and plane) and the bench
    k9_paths.update(resync=sum(resync_launches["K9"].values()),
                    parallel=par_launches["band_scores"]
                    + plane_launches["band_scores"],
                    bench=bench_launches["band_scores"])
    idle = [p for p, n in k9_paths.items() if n == 0]
    require(not idle, f"K9 was not launched on the paths {idle}")
    paths["band_scores"] = k9_paths
    paths["band_scores_color"] = {"detect_1080p": k9_color}
    for name in ("band_scores", "band_scores_color"):
        launches[name] = sum(paths[name].values())
    # cols_view: the probes' launches and the bench budget's T2b row
    paths["cols_view"] = {"probes": launches["cols_view"],
                          "bench": bench_launches["cols_view"]}
    launches["cols_view"] = sum(paths["cols_view"].values())
    # K6 and K7: the gray slice, the gray resync search (luma_f32 alone:
    # it embeds nothing), the 8K plane path (no bgr_to_gray: its gray
    # watermark is made outside and it embeds with no metrics), the
    # parity path and the bench
    idle_ok = {("bgr_to_gray", "resync"), ("replace_luma", "resync"),
               ("bgr_to_gray", "plane_8k")}
    for name in COLOR_KERNELS:
        paths[name] = {"slice": color_slice[name],
                       "resync": resync_color[name],
                       "plane_8k": plane_launches[name],
                       "parity": parity_color[name],
                       "bench": bench_launches[name]}
        launches[name] = sum(paths[name].values())
        idle = [p for p, n in paths[name].items()
                if n == 0 and (name, p) not in idle_ok]
        require(not idle, f"{name} was not launched on the paths {idle}")
    # K10 (one counter; the gray row's: the gray chain and the bench's
    # robustness extracts, the color row's: the color chain and the CLI's
    # enhanced color extract) and K11: the enhance phase's chains, the
    # CLI's enhanced extract and the bench
    paths["nlm_planes"] = {
        "enhance": enhance_launches["chain_gray"]["nlm_planes"],
        "bench": bench_launches["nlm_planes"]}
    cli_enhance = cli_counts["extract_enhanced"]
    paths["nlm_planes_color"] = {
        "enhance": enhance_launches["chain_color"]["nlm_planes"],
        "cli_files": cli_enhance["nlm_planes"]}
    for name in ("clahe_luts", "clahe_apply"):
        paths[name] = {"enhance": sum(n[name] for n in
                                      enhance_launches.values()),
                       "cli_files": cli_enhance[name],
                       "bench": bench_launches[name]}
    # K14 (one counter; the gray row's: the gray chain and the bench's
    # robustness extracts, the color row's: the color chain and the CLI's
    # enhanced color extract) and K17 (the color chain and that extract)
    paths["unsharp"] = {
        "enhance": enhance_launches["chain_gray"]["unsharp"],
        "bench": bench_launches["unsharp"]}
    paths["unsharp_color"] = {
        "enhance": enhance_launches["chain_color"]["unsharp"],
        "cli_files": cli_enhance["unsharp"]}
    for name in YCRCB_KERNELS:
        paths[name] = {"enhance": enhance_launches["chain_color"][name],
                       "cli_files": cli_enhance[name]}
    # K15 (the gray row's: the (u8, f32) pairs of the gray embeds, the
    # slice's, batch_embed_blocked's and the GUI's; the u8 row's: the color
    # embeds', the slice's and the CLI's) and K16 (every one of them)
    cli_embeds = {k: cli_counts["embed_blocked"][k]
                  + cli_counts["embed_parity"][k] for k in METRIC_KERNELS}
    paths["ssim"] = {"metrics": metric_launches["gray"]["ssim"],
                     "parallel": par_launches["ssim"],
                     "gui": gui_launches["ssim"]}
    paths["ssim_u8"] = {"metrics": metric_launches["color"]["ssim"],
                        "cli_files": cli_embeds["ssim"]}
    paths["psnr"] = {"metrics": sum(n["psnr"]
                                    for n in metric_launches.values()),
                     "parallel": par_launches["psnr"],
                     "gui": gui_launches["psnr"],
                     "cli_files": cli_embeds["psnr"]}
    for name in ("nlm_planes", "nlm_planes_color", "clahe_luts",
                 "clahe_apply", "unsharp", "unsharp_color", *YCRCB_KERNELS,
                 "ssim", "ssim_u8", "psnr"):
        idle = [p for p, n in paths[name].items() if n == 0]
        require(not idle, f"{name} was not launched on the paths {idle}")
        launches[name] = sum(paths[name].values())
    # K12 (u8 color frames: the color searches and detect_paths; f32 planes:
    # the gray search and the bench's geometric config) and K13, a launch a
    # scan (color: the rotation search; f32 planes: the bench's rotation
    # rows)
    k12, k13 = resync_launches["K12"], resync_launches["K13"]
    paths["roll_stack"] = {"resync": k12["shift_color"]
                           + k12["rotation_color"]
                           + k12["detect_paths_resync"]}
    paths["roll_stack_gray"] = {"resync": k12["shift_gray"],
                                "bench": bench_launches["roll_stack"]}
    paths["derotate"] = {"resync": k13["rotation_color"]}
    paths["derotate_gray"] = {"bench": bench_launches["derotate_angles"]}
    for name in ("roll_stack", "roll_stack_gray", "derotate",
                 "derotate_gray"):
        idle = [p for p, n in paths[name].items() if n == 0]
        require(not idle, f"{name} was not launched on the paths {idle}")
        launches[name] = sum(paths[name].values())
    table = []
    for name, (src, repl) in sources.items():
        r = results[name]
        extra = {"launches_by_path": paths[name]} if name in paths else {}
        for key in ("instance", "smem_bytes", "two_pass_ms",
                    "two_pass_ms_128", "two_pass_bound_ms_128",
                    "eager_ms", "front_ms", "issue_bound_ms", "ms_128",
                    "plain_ms_128", "two_pass_bound_ms", "eager_ms_128",
                    "device_ms_128",
                    "bound_ms_128", "detect_ms_32", "detect_ms_128",
                    "detect_ms_eager_32", "detect_ms_eager_128", "ms_4k",
                    "plain_ms_4k", "library_ms_4k", "bound_ms_4k",
                    "device_ms", "device_ms_4k", "angles", "ms_per_angle",
                    "library_ms_per_angle", "device_share_of_bound",
                    "ms_one", "device_ms_one", "plain_ms_one",
                    "library_ms_one", "bound_ms_one", "ms_one_4k",
                    "device_ms_one_4k", "library_ms_one_4k",
                    "smem_loads_per_pixel", "smem_bytes_per_pixel",
                    "f32_insn_per_pixel", "smem_bound_ms",
                    "f32_issue_bound_ms", "restated_bound_ms"):
            if key in r:
                extra[key] = r[key]
        table.append(dict(name=name, route="cuda", source=src,
                          replaces=repl, launches=launches[name], **extra,
                          max_abs_err=r["max_abs_err"], ms=r["ms"],
                          plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                          bound_by=r["bound_by"],
                          library_ms=r["library_ms"]))
    print(smi_line(), flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
