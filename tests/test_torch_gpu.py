"""The port's CUDA kernels on a GPU: each against its plain twin (K1, K2,
K3, K4, K2r and K1g bit for bit, against the twin run on the card, K2 and
K3 at every k, and near the twin run on the CPU), the launch
counters, the slice on the card against the slice on the CPU, the
serve steps on the card against the split calls, the probe kernels
(copy_f32, cols_view, fma_chain, spectrum_probe) against their twins and
against K1, K5 (the recompute extract tail) against its twin run on the
card in every layout and at k = 1, 4, 8, K5f (the extract tail's front
stage) against its twin run on the card at 1080p on 1 to 128 frames and
at every k, the default tail's bytes with either front, K8 (the default
tail's normaliser) against its twin run on the card in every layout, on
1 to 128 1080p frames and through the default extract, K18 (the
presence statistic) against its twin run on the card at 1080p on 1 to
128 frames, at tiny, unaligned and 4K block grids, with its decision the
eager statistic's, K8u (K8 with a crop) in each instance against its
twin at six unaligned sizes in every layout, on 1 and 128 frames at
1079x1917, and refusing a resident plan beyond the card, the request
extract (extract_color / extract_gray) byte-equal with every twin forced
and alone or in a batch, K6 and K7 (the gray scheme's color
conversions) against their twins run on the card on every BGR triple,
at 1080p, 8K, on the scalar path and over 2^31 bytes,
with the gray paths' bytes the same with either, K12 and K13 (detect
resync's roll stack and counter-rotation, one angle and a scan's 20 in one
launch) against their twins run on the card from 1×1 to 2160×3840 frames,
the batched cos and sin against the per-angle ones, and a rotation search
on the card against the CPU with one K13 launch a scan, K9 (the detect
statistic) against its twin run on the card on 1 to 128 1080p frames, at
small and tiny block grids, at grid 4 and 2, with a shared sc, on a clean
host, at every k and over the scale damp's range, and the detect paths
through it, K10 (NLM) and both K11 kernels (CLAHE's LUTs and
interpolation, alone and in one call) against their twins run on the
card at 1080p, 4K, at their strips' and runs' edges, on a single-valued
plane, off alignment, on successive calls and on planes smaller than
NLM's window, K10's exp against torch's at every window sum, the 1080p
extracts launching each once, K14 (unsharp, also across its column
walks), K15
(SSIM), K16 (PSNR's sums) and K17 (the color NLM's YCrCb pair) against
their twins run on the card from 1×1 to 2160×3840 and on a view off its
16-byte alignment, the embeds launching K15 and K16 and the chains K14
and K17 (and never the eager blur), and the parity path, the enhancement
stages and detect resync on the card against the CPU.

Marked ``cuda``: every test skips where torch.cuda.is_available() is false.
This file imports no jax, so on a GPU machine without jax it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import math

import numpy as np
import pytest
import torch

from dctsvd_tpu_torch.models import blocked as tb
from dctsvd_tpu_torch.models import enhance as tenh
from dctsvd_tpu_torch.models import image as timg
from dctsvd_tpu_torch.ops import (color, color_cuda, dct, detect_cuda,
                                  probe_cuda, resync_cuda, svd, svd_cuda,
                                  tail_cuda, wm_cuda)
from dctsvd_tpu_torch.ops import enhance as e_ops
from dctsvd_tpu_torch.ops import enhance_cuda, metrics, metrics_cuda
from dctsvd_tpu_torch.utils import crypto, kernels

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

SEED = 20261020
ALPHA = 0.12


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _frames(shape=(2, 64, 80, 3), seed=SEED):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


PAINT_K = list(range(1, 9))
PAINT_SHAPE = (1, 72, 88, 3)    # 99 blocks a plane, 297 in all: not a
                                # multiple of the 128 threads of a block


@pytest.mark.parametrize("shape", [(2, 64, 80, 3), PAINT_SHAPE],
                         ids=["2x64x80", "ragged"])
@pytest.mark.parametrize("sweeps", [1.25, 2])
@pytest.mark.parametrize("layout", ["frames", "planes_u8", "planes_f32"])
def test_spectrum_kernel_matches_twin(dev, layout, sweeps, shape):
    """K1 equals its twin run on the card bit for bit in each layout (u8
    channels-last frames, u8 and f32 planes), and its twin run on the CPU
    within 1e-4 of s_max."""
    x = _frames(shape)
    cl = layout == "frames"
    if not cl:
        x = np.ascontiguousarray(np.moveaxis(x, -1, -3))
        if layout == "planes_f32":
            x = x.astype(np.float32)
    xt = torch.from_numpy(x)
    n0 = wm_cuda.spectrum_blocks.launches
    got = wm_cuda.spectrum_blocks(xt.to(dev), sweeps=sweeps,
                                  channels_last=cl)
    torch.cuda.synchronize()
    assert wm_cuda.spectrum_blocks.launches == n0 + 1
    assert torch.equal(got, wm_cuda.spectrum_blocks_plain(
        xt.to(dev), sweeps=sweeps, channels_last=cl))
    ref = wm_cuda.spectrum_blocks_plain(xt, sweeps=sweeps, channels_last=cl)
    smax = float(ref.max())
    assert float((got.cpu() - ref).abs().max()) <= 1e-4 * smax


@pytest.mark.parametrize("case", ["u8 frames off 16 bytes", "u8 4 channels",
                                  "f32 frames"])
def test_spectrum_kernel_byte_path_matches_twin(dev, case):
    """The layouts K1 reads pixel by pixel (a pointer off a 16-byte
    boundary, other channel counts, f32 channels-last) equal the twin run
    on the card."""
    shape = (2, 16, 24, 4) if case == "u8 4 channels" else (2, 16, 24, 3)
    x = torch.from_numpy(_frames(shape)).to(dev)
    if case == "f32 frames":
        x = x.to(torch.float32) + 0.5
    elif case == "u8 frames off 16 bytes":
        base = torch.empty(x.numel() + 1, dtype=torch.uint8, device=dev)
        x = base[1:].view(x.shape).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16
    got = wm_cuda.spectrum_blocks(x, sweeps=1.25, channels_last=True)
    assert torch.equal(got, wm_cuda.spectrum_blocks_plain(
        x, sweeps=1.25, channels_last=True))


def _paint_inputs(dtype: str, seed=SEED + 7):
    """Frames of PAINT_SHAPE (u8, or f32 with a fractional part) and a
    watermark row for every one of the 8 components."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 256, PAINT_SHAPE, np.uint8))
    if dtype == "f32":
        x = x.to(torch.float32) + torch.from_numpy(
            rng.random(PAINT_SHAPE).astype(np.float32))
    n = (PAINT_SHAPE[1] // 8) * (PAINT_SHAPE[2] // 8)
    sws = torch.from_numpy((rng.random((3, n, 8)) * 5).astype(np.float32))
    return x, sws


@pytest.mark.parametrize("kinds", ["u8->u8", "u8->f32", "f32->u8",
                                   "f32->f32"])
@pytest.mark.parametrize("sweeps", [1.25, 2])
@pytest.mark.parametrize("k", PAINT_K)
def test_embed_kernel_matches_twin(dev, k, sweeps, kinds):
    """K2's instance for k equals its twin run on the card bit for bit:
    the same floats in the same order."""
    src, dst = kinds.split("->")
    x, sws = (t.to(dev) for t in _paint_inputs(src))
    n0 = wm_cuda.embed_blocks.launches
    y, sc = wm_cuda.embed_blocks(x, sws, sweeps=sweeps, k=k,
                                 out_u8=dst == "u8", channels_last=True)
    torch.cuda.synchronize()
    assert wm_cuda.embed_blocks.launches == n0 + 1
    py, psc = wm_cuda.embed_blocks_plain(x, sws, sweeps=sweeps, k=k,
                                         out_u8=dst == "u8",
                                         channels_last=True)
    assert y.dtype == py.dtype
    assert torch.equal(y, py)
    assert torch.equal(sc, psc)


@pytest.mark.parametrize("shape", [(3, 500), (1,)], ids=["1500", "1"])
def test_svd8_kernel_matches_twin(dev, shape):
    """K4's U, S and Vt and its S-only instance equal the twin run on the
    card bit for bit, on block counts that leave a CTA partly empty; U S Vt
    rebuild the input within 1e-4 of s_max."""
    a = torch.randn(*shape, 8, 8,
                    generator=torch.Generator().manual_seed(5))
    n0 = svd_cuda.jacobi_svd8.launches
    u, s, vt = svd_cuda.jacobi_svd8(a.to(dev))
    s_only = svd_cuda.jacobi_svd8(a.to(dev), compute_uv=False)
    torch.cuda.synchronize()
    assert svd_cuda.jacobi_svd8.launches == n0 + 2
    for got, ref in zip((u, s, vt), svd_cuda.jacobi_svd8_plain(a.to(dev))):
        assert torch.equal(got, ref)
    assert torch.equal(s_only, svd_cuda.jacobi_svd8_plain(
        a.to(dev), compute_uv=False))
    pu, ps, pvt = svd_cuda.jacobi_svd8_plain(a)
    smax = float(ps.max())
    assert float((s.cpu() - ps).abs().max()) <= 1e-4 * smax
    assert float((s_only.cpu() - ps).abs().max()) <= 1e-4 * smax
    rec = torch.einsum("...ij,...j,...jk->...ik", u, s, vt).cpu()
    assert float((rec - a).abs().max()) <= 1e-4 * smax


def test_svd8_kernel_off_16_bytes(dev):
    """A view off a 16-byte boundary is copied to an aligned one first (K4
    reads 16-byte pieces) and still equals the twin."""
    a = torch.randn(37, 8, 8, generator=torch.Generator().manual_seed(6))
    base = torch.empty(a.numel() + 1, device=dev)
    av = base[1:].view(a.shape).copy_(a.to(dev))
    assert av.is_contiguous() and av.data_ptr() % 16
    for got, ref in zip(svd_cuda.jacobi_svd8(av),
                        svd_cuda.jacobi_svd8_plain(av)):
        assert torch.equal(got, ref)


def _sws(seed=SEED + 1, n=80):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(((rng.standard_normal((3, n, 8)) ** 2) * 3
                             * (np.arange(8) < 4)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_embed_kernel_on_planes_matches_twin(dev, dtype):
    """K2 on [P, H, W] planes (one channel a pixel) with one shared
    watermark row, as the gray path calls it."""
    x, sws = _paint_inputs(dtype)
    x = torch.movedim(x, -1, -3).contiguous().to(dev)      # [1, 3, H, W]
    sws = sws[:1].to(dev)
    n0 = wm_cuda.embed_blocks.launches
    y, sc = wm_cuda.embed_blocks(x, sws, sweeps=1.25, k=4)
    torch.cuda.synchronize()
    assert wm_cuda.embed_blocks.launches == n0 + 1
    py, psc = wm_cuda.embed_blocks_plain(x, sws, sweeps=1.25, k=4)
    assert torch.equal(y, py) and torch.equal(sc, psc)


@pytest.mark.parametrize("sweeps", [1.25, 2])
@pytest.mark.parametrize("k", PAINT_K)
def test_roundtrip_kernel_matches_twin(dev, k, sweeps):
    """K3's instance for k equals its twin run on the card bit for bit,
    its s_cw is K1 on its stego, and its stego and sc are K2's."""
    x, sws = (t.to(dev) for t in _paint_inputs("u8"))
    n0 = wm_cuda.roundtrip_frames_blocks.launches
    st, sc, scw = wm_cuda.roundtrip_frames_blocks(x, sws, sweeps=sweeps, k=k)
    torch.cuda.synchronize()
    assert wm_cuda.roundtrip_frames_blocks.launches == n0 + 1
    pst, psc, pscw = wm_cuda.roundtrip_frames_blocks_plain(x, sws,
                                                           sweeps=sweeps, k=k)
    assert torch.equal(st, pst)
    assert torch.equal(sc, psc)
    assert torch.equal(scw, pscw)
    assert torch.equal(scw, wm_cuda.spectrum_blocks(st, sweeps=sweeps,
                                                    channels_last=True))
    st2, sc2 = wm_cuda.embed_blocks(x, sws, sweeps=sweeps, k=k, out_u8=True,
                                    channels_last=True)
    assert torch.equal(st, st2) and torch.equal(sc, sc2)


@pytest.mark.parametrize("kernel", ["K2 u8", "K2 f32", "K3"])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_paint_kernels_near_the_cpu_twin(dev, k, kernel):
    """K2 and K3 against their twins run on the CPU, which the CPU tests
    hold to wm_pallas: stego bytes at most one quantum apart on at most 1 %
    of them (f32 output within 1e-3), spectra within 1e-4 of s_max."""
    x, sws = torch.from_numpy(_frames()), _sws()
    if kernel == "K3":
        got = wm_cuda.roundtrip_frames_blocks(x.to(dev), sws.to(dev),
                                              sweeps=1.25, k=k)
        ref = wm_cuda.roundtrip_frames_blocks_plain(x, sws, sweeps=1.25, k=k)
    else:
        out_u8 = kernel == "K2 u8"
        got = wm_cuda.embed_blocks(x.to(dev), sws.to(dev), sweeps=1.25, k=k,
                                   out_u8=out_u8, channels_last=True)
        ref = wm_cuda.embed_blocks_plain(x, sws, sweeps=1.25, k=k,
                                         out_u8=out_u8, channels_last=True)
    y, py = got[0].cpu(), ref[0]
    if y.dtype == torch.uint8:
        d = (y.to(torch.int16) - py.to(torch.int16)).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 0.01
    else:
        assert float((y - py).abs().max()) <= 1e-3
    smax = float(ref[1].max())
    for s, ps in zip(got[1:], ref[1:]):
        assert float((s.cpu() - ps).abs().max()) <= 1e-4 * smax


# name: (frames, channels a pixel, dtype, channels-last); every shape holds
# two frames, and neither Wb (10 at 64x80, 240 at 1080p) is a multiple of
# the 32 blocks of a warp (K2r). "frames" and "frames_u8" are one layout:
# each test keeps the case names it had.
VARIANT_LAYOUTS = {
    "frames_u8": ((2, 64, 80), 3, np.uint8, True),
    "frames": ((2, 64, 80), 3, np.uint8, True),
    "planes_u8": ((2, 64, 80), 3, np.uint8, False),
    "planes_f32": ((2, 64, 80), 3, np.float32, False),
    "frames_f32": ((2, 64, 80), 3, np.float32, True),
    "frames_c1": ((2, 64, 80), 1, np.uint8, True),
    "frames_c2": ((2, 64, 80), 2, np.uint8, True),
    "frames_u8_1080p": ((2, 1080, 1920), 3, np.uint8, True),
    "planes_f32_1080p": ((2, 1080, 1920), 3, np.float32, False),
}


def _variant_input(layout):
    """(x on the CPU, channels_last, sws [C, N, 8]) of a layout: seeded u8
    pixels (f32 ones carry a fraction), planes as [2, C, H, W]."""
    (f, h, w), c, dtype, cl = VARIANT_LAYOUTS[layout]
    x = _frames((f, h, w, c))
    if dtype == np.float32:
        x = x.astype(np.float32) + np.random.default_rng(SEED + 6).random(
            x.shape, np.float32)
    if not cl:
        x = np.ascontiguousarray(np.moveaxis(x, -1, -3))
    sws = _sws(n=(h // 8) * (w // 8))[np.arange(c) % 3]
    return torch.from_numpy(x), cl, sws


@pytest.mark.parametrize("layout", ["frames_u8", "planes_f32", "planes_u8",
                                    "frames_f32", "frames_c1", "frames_c2",
                                    "frames_u8_1080p", "planes_f32_1080p"])
def test_recon_kernel_matches_twin(dev, layout):
    """K2r equals its twin run on the card bit for bit, output and sc, and
    its sc equals K2's on the same input."""
    x, cl, sws = _variant_input(layout)
    x, sws = x.to(dev), sws.to(dev)
    n0 = wm_cuda.embed_blocks_recon.launches
    y, sc = wm_cuda.embed_blocks(x, sws, sweeps=1.25, variant="recon",
                                 channels_last=cl)
    torch.cuda.synchronize()
    assert wm_cuda.embed_blocks_recon.launches == n0 + 1
    py, psc = wm_cuda.embed_blocks_recon_plain(x, sws, sweeps=1.25,
                                               channels_last=cl)
    assert torch.equal(y, py), float((y - py).abs().max())
    assert torch.equal(sc, psc), float((sc - psc).abs().max())
    _, sc_k2 = wm_cuda.embed_blocks(x, sws, sweeps=1.25, channels_last=cl)
    assert torch.equal(sc, sc_k2)


@pytest.mark.parametrize("layout", ["frames", "planes_u8", "planes_f32",
                                    "frames_f32", "frames_c1", "frames_c2",
                                    "frames_u8_1080p", "planes_f32_1080p"])
def test_gram_kernel_matches_twin(dev, layout):
    """K1g equals its twin run on the card bit for bit."""
    x, cl, _ = _variant_input(layout)
    x = x.to(dev)
    n0 = wm_cuda.spectrum_blocks_gram.launches
    got = wm_cuda.spectrum_blocks(x, sweeps=1.5, channels_last=cl,
                                  method="gram")
    torch.cuda.synchronize()
    assert wm_cuda.spectrum_blocks_gram.launches == n0 + 1
    ref = wm_cuda.spectrum_blocks_gram_plain(x, sweeps=1.5, channels_last=cl)
    assert torch.equal(got, ref), float((got - ref).abs().max())


def test_serve_steps_take_the_fused_kernel(dev):
    h, w = 64, 80
    cover = torch.from_numpy(_frames((2, h, w, 3), SEED + 4)).to(dev)
    wm = _frames((h, w, 3), SEED + 5)
    key = crypto.derive_key("gpu", bytes(8))
    blk, intra = crypto.block_permutation_indices(key, tb.n_blocks_of(h, w))
    pw = tb.prepare_wm_color(torch.as_tensor(wm, device=dev),
                             torch.as_tensor(blk, device=dev),
                             torch.as_tensor(intra, device=dev))
    counters = (wm_cuda.roundtrip_frames_blocks, wm_cuda.embed_blocks,
                wm_cuda.spectrum_blocks)
    before = [fn.launches for fn in counters]
    st, sc, rec, scores = tb.serve_verify_detect_color_prepared(
        cover, pw.sw, ALPHA, pw.ebasis, pw.inv_blk)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1, 0, 0]
    st2, sc2, _, _ = tb.embed_color_prepared(cover, pw.sw, ALPHA,
                                             with_metrics=False)
    rec2 = tb.extract_color_prepared(st2, sc2, pw.ebasis, pw.inv_blk, ALPHA,
                                     sw=pw.sw)
    scores2 = tb.detect_color(st2, sc2, pw.sw, ALPHA)
    assert torch.equal(st, st2) and torch.equal(sc, sc2)
    assert torch.equal(rec, rec2)
    assert float((scores - scores2).abs().max()) <= 1e-5
    assert float(scores.min()) >= 0.30


def test_slice_on_gpu_matches_cpu(dev):
    h, w = 60, 84                      # unaligned: pads on both devices
    cover = _frames((1, h, w, 3), SEED + 2)
    wm = _frames((h, w, 3), SEED + 3)
    key = crypto.derive_key("gpu", bytes(8))
    blk, intra = crypto.block_permutation_indices(key, tb.n_blocks_of(h, w))
    out = {}
    for d in ("cpu", dev):
        b, i = torch.as_tensor(blk, device=d), torch.as_tensor(intra,
                                                               device=d)
        pw = tb.prepare_wm_color(torch.as_tensor(wm, device=d), b, i)
        st, sc, _, _ = tb.embed_color_prepared(
            torch.as_tensor(cover, device=d), pw.sw, ALPHA)
        rec = tb.extract_color(st, sc, pw.uw, pw.vwt, pw.inv_blk,
                               pw.inv_intra, ALPHA, sw=pw.sw)
        score = tb.detect_color(st, sc, pw.sw, ALPHA)
        out[str(d)] = (st.cpu(), rec.cpu(), float(score))
    (st_c, rec_c, s_c), (st_g, rec_g, s_g) = out.values()
    d_st = (st_c.to(torch.int16) - st_g.to(torch.int16)).abs()
    assert int(d_st.max()) <= 1 and float((d_st > 0).float().mean()) <= 0.01
    assert int((rec_c.to(torch.int16) - rec_g.to(torch.int16)).abs().max()) \
        <= 2
    assert abs(s_c - s_g) <= 1e-3 and s_g >= 0.30


PROBE_SHAPES = [(3, 64, 80), (2, 1080, 1920)]
PROBE_SPECTRA = [("strided", torch.float32, False),
                 ("smem", torch.float32, False),
                 ("cols", torch.uint8, False),
                 ("cols", torch.bfloat16, False),
                 ("cols", torch.float32, False),
                 ("cols", torch.float32, True)]


def _int_planes(shape, seed=SEED + 6):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 256, shape, np.uint8))


def _probe_input(planes_u8, layout, dtype):
    """The probe's input for integer planes: f32 natural planes, or a cols
    view in ``dtype``."""
    if layout == "cols":
        return probe_cuda.cols_view_plain(planes_u8, dtype)
    return planes_u8.to(torch.float32)


# the probes' shapes, and a length that leaves a partial last chunk
COPY_SHAPES = PROBE_SHAPES + [(4 * (probe_cuda.COPY_CHUNK4 + 3),)]


@pytest.mark.parametrize("shape", COPY_SHAPES)
def test_copy_kernel_matches_twin(dev, shape):
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        shape).astype(np.float32))
    n0 = probe_cuda.copy_f32.launches
    y = probe_cuda.copy_f32(x.to(dev))
    torch.cuda.synchronize()
    assert probe_cuda.copy_f32.launches == n0 + 1
    assert torch.equal(y.cpu(), probe_cuda.copy_f32_plain(x))


VIEW_KINDS = [(torch.uint8, torch.uint8), (torch.uint8, torch.bfloat16),
              (torch.uint8, torch.float32), (torch.float32, torch.float32)]
# the probes' shapes ((3, 64, 80): Wb = 10, the scalar path; 1080p: the
# vector path), Wb = 241 (rows off 16-byte boundaries: the scalar path),
# and Wb = 208 on 8 rows (the vector path; u8 in leaves a partial warp
# tile of 8 chunks)
VIEW_SHAPES = PROBE_SHAPES + [(1, 16, 1928), (1, 8, 1664)]


def _view_input(shape, src):
    x = _int_planes(shape)
    return x.to(torch.float32) + 0.25 if src == torch.float32 else x


@pytest.mark.parametrize("kinds", VIEW_KINDS)
@pytest.mark.parametrize("shape", VIEW_SHAPES)
def test_cols_view_kernel_matches_twin(dev, kinds, shape):
    src, dst = kinds
    x = _view_input(shape, src)
    n0 = probe_cuda.cols_view.launches
    v = probe_cuda.cols_view(x.to(dev), dst)
    torch.cuda.synchronize()
    assert probe_cuda.cols_view.launches == n0 + 1
    assert v.dtype == dst
    assert torch.equal(v.cpu(), probe_cuda.cols_view_plain(x, dst))


def _off_16_bytes(x):
    """x's copy on the card one element past a 16-byte boundary."""
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    xv = base[1:].view(x.shape)
    xv.copy_(x)
    assert xv.is_contiguous() and xv.data_ptr() % 16
    return xv


@pytest.mark.parametrize("kinds", VIEW_KINDS)
def test_cols_view_kernel_at_an_unaligned_pointer(dev, kinds):
    """A contiguous view one element past a 16-byte boundary takes the
    scalar path and still equals the twin."""
    src, dst = kinds
    x = _view_input((2, 16, 1920), src)
    xv = _off_16_bytes(x.to(dev))
    n0 = probe_cuda.cols_view.launches
    v = probe_cuda.cols_view(xv, dst)
    torch.cuda.synchronize()
    assert probe_cuda.cols_view.launches == n0 + 1
    assert torch.equal(v.cpu(), probe_cuda.cols_view_plain(x, dst))


@pytest.mark.parametrize("mode", probe_cuda.CHAIN_MODES)
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("shape", [(2, 5, 8, 30), (3, 135, 8, 240)])
def test_fma_chain_kernel_matches_twin(dev, mode, fused, shape):
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        shape).astype(np.float32))
    n0 = probe_cuda.fma_chain.launches
    y = probe_cuda.fma_chain(x.to(dev), 256, mode, fused)
    torch.cuda.synchronize()
    assert probe_cuda.fma_chain.launches == n0 + 1
    ref = probe_cuda.fma_chain_plain(x, 256, mode, fused)
    if fused:      # the twin rounds twice where the FMA rounds once
        assert float((y.cpu() - ref).abs().max()) <= 1e-6 * float(
            ref.abs().max())
    else:
        assert torch.equal(y.cpu(), ref)


# the lengths whose step counts are template constants of fma_chain_kernel
# (tools/exp_vpu_roofline.py N_OPS), and one that runs the run-time loop
CHAIN_LENGTHS = [256, 1024, 96]


@pytest.mark.parametrize("n_ops", CHAIN_LENGTHS)
@pytest.mark.parametrize("mode", probe_cuda.CHAIN_MODES)
@pytest.mark.parametrize("fused", [False, True])
def test_fma_chain_kernel_at_each_length(dev, mode, fused, n_ops):
    """Each instance of the chain (unrolled at the tool's two lengths, the
    loop at any other) against its twin run on the card: bit-equal
    unfused, within CHAIN_FUSED_TOL fused (the twin rounds twice where the
    FMA rounds once)."""
    x = torch.from_numpy(np.random.default_rng(SEED + 21).standard_normal(
        (3, 135, 8, 240)).astype(np.float32)).to(dev)
    n0 = probe_cuda.fma_chain.launches
    y = probe_cuda.fma_chain(x, n_ops, mode, fused)
    torch.cuda.synchronize()
    assert probe_cuda.fma_chain.launches == n0 + 1
    ref = probe_cuda.fma_chain_plain(x, n_ops, mode, fused)
    if fused:
        assert float((y - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    else:
        assert torch.equal(y, ref)


# the spectrum probe's own shapes: the probes' two, then a warp's blocks
# straddling block rows with the plane ending mid-warp (Wb = 25, 225
# blocks a plane), and one block row of Wb = 257 (the last CTA holds one
# block)
SPECTRUM_SHAPES = PROBE_SHAPES + [(2, 72, 200), (1, 8, 2056)]


@pytest.mark.parametrize("sweeps", [0, 2])
@pytest.mark.parametrize("case", PROBE_SPECTRA)
@pytest.mark.parametrize("shape", SPECTRUM_SHAPES)
def test_spectrum_probe_kernel_equals_twin_on_the_card(dev, case, shape,
                                                      sweeps):
    """Every instance computes its twin's floats in the twin's order: on
    the card the two are bit-equal, the cached instance too."""
    layout, dtype, cached = case
    x = _probe_input(_int_planes(shape), layout, dtype).to(dev)
    got = probe_cuda.spectrum_probe(x, sweeps, layout, cached)
    ref = probe_cuda.spectrum_probe_plain(x, sweeps, layout, cached)
    assert torch.equal(got, ref), (layout, dtype, cached)


@pytest.mark.parametrize("shape", [(2, 72, 200), (1, 8, 2056)])
def test_spectrum_probe_off_16_bytes(dev, shape):
    """A plane that is not 16-byte aligned: 'strided' reads it a float a
    load and still equals K1; 'smem' refuses it and launches nothing."""
    planes = _int_planes(shape)
    x = _off_16_bytes(planes.to(torch.float32).to(dev))
    k1 = wm_cuda.spectrum_blocks(planes.to(dev), sweeps=3)
    assert torch.equal(probe_cuda.spectrum_probe(x, 3, "strided"), k1)
    n0 = probe_cuda.spectrum_probe.launches
    with pytest.raises(ValueError, match="16-byte"):
        probe_cuda.spectrum_probe(x, 3, "smem")
    assert probe_cuda.spectrum_probe.launches == n0


@pytest.mark.parametrize("case", PROBE_SPECTRA)
@pytest.mark.parametrize("shape", SPECTRUM_SHAPES)
def test_spectrum_probe_kernel_matches_twin(dev, case, shape):
    layout, dtype, cached = case
    x = _probe_input(_int_planes(shape), layout, dtype)
    n0 = probe_cuda.spectrum_probe.launches
    got = probe_cuda.spectrum_probe(x.to(dev), 2, layout, cached)
    torch.cuda.synchronize()
    assert probe_cuda.spectrum_probe.launches == n0 + 1
    ref = probe_cuda.spectrum_probe_plain(x, 2, layout, cached)
    # a cached norm n of a small value carries the rounding of s_max^2 from
    # every rotation (the card's rsqrtf and the CPU's rsqrt round apart),
    # and sqrt(n) magnifies it to about sqrt(k * 2^-23) * s_max
    tol = 1e-3 if cached else 1e-4
    assert float((got.cpu() - ref).abs().max()) <= tol * float(ref.max())


@pytest.mark.parametrize("sweeps", [2, 3, 4])
@pytest.mark.parametrize("shape", SPECTRUM_SHAPES)
def test_spectrum_probe_equals_k1(dev, sweeps, shape):
    """Every fresh instance computes K1's floats in K1's order: bit-equal
    to K1 on the same integer-valued planes at the same schedule."""
    planes = _int_planes(shape)
    k1 = wm_cuda.spectrum_blocks(planes.to(dev), sweeps=sweeps)
    for layout, dtype, cached in PROBE_SPECTRA:
        if cached:
            continue
        x = _probe_input(planes, layout, dtype).to(dev)
        assert torch.equal(probe_cuda.spectrum_probe(x, sweeps, layout), k1), \
            (layout, dtype)


def test_spectrum_probe_s0_is_the_sorted_column_norms(dev):
    planes = _int_planes((3, 64, 80))
    norms = torch.linalg.vector_norm(dct.blockify(planes.to(torch.float32)),
                                     dim=-2).sort(dim=-1, descending=True)[0]
    outs = [probe_cuda.spectrum_probe(
        _probe_input(planes, layout, dtype).to(dev), 0, layout, cached).cpu()
        for layout, dtype, cached in PROBE_SPECTRA]
    for out in outs:
        assert torch.equal(out, outs[0])
    assert float((outs[0] - norms).abs().max()) <= 1e-6 * float(norms.max())


def _nc(a, b):
    a = a.astype(np.float64).ravel() - a.mean()
    b = b.astype(np.float64).ravel() - b.mean()
    return float(a @ b / np.sqrt((a @ a) * (b @ b)))


def test_svd_full_is_stable_and_cancels(dev):
    """svd_full pins one cuSOLVER driver: two calls give the same bits, and
    compute_uv=False returns exactly the S of the full call."""
    x = torch.as_tensor(_frames((3, 72, 96), SEED + 8), device=dev)
    c = dct.dct2(x.to(torch.float32))
    u, s, vt = svd.svd_full(c)
    u2, s2, vt2 = svd.svd_full(c)
    assert torch.equal(u, u2) and torch.equal(s, s2) and torch.equal(vt, vt2)
    assert torch.equal(svd.svd_full(c, compute_uv=False), s)
    s_cpu = torch.linalg.svd(c.cpu(), full_matrices=False).S
    assert float((s.cpu() - s_cpu).abs().max()) <= 1e-5 * float(s_cpu.max())


@pytest.mark.parametrize("mode", ["gray", "color"])
def test_parity_on_gpu_matches_cpu(dev, mode):
    """Parity embed, extract and detect on the card against the CPU: stego
    within 1 quantum on at most 1 % of bytes, PSNR within 0.01 dB, SSIM
    within 1e-3, detect within 1e-3, extractions' NC >= 0.999."""
    h, w = 60, 84
    cover = _frames((h, w, 3), SEED + 9)
    wm = _frames((h, w, 3), SEED + 10)
    idx = crypto.permutation_indices(crypto.derive_key("gpu", bytes(8)),
                                     h * w)
    inv = crypto.inverse_permutation(idx)
    out = {}
    for d in ("cpu", dev):
        c, m = torch.as_tensor(cover, device=d), torch.as_tensor(wm, device=d)
        i, v = torch.as_tensor(idx, device=d), torch.as_tensor(inv, device=d)
        if mode == "gray":
            res = timg.embed_gray(c, m[..., 0], i, ALPHA)
            sc = res.sc
            rec = timg.extract_gray(res.stego_bgr, sc, res.uw, res.vwt, v,
                                    ALPHA)
            score = timg.detect_gray(res.stego_bgr, sc, res.sw, ALPHA)
        else:
            res = timg.embed_color(c, m, i, ALPHA)
            sc = res.s_cover
            rec = timg.extract_color(res.stego_bgr, sc, res.uw, res.vwt, v,
                                     ALPHA)
            score = timg.detect_color(res.stego_bgr, sc, res.sw, ALPHA)
        out[str(d)] = (res.stego_bgr.cpu().numpy(), rec.cpu().numpy(),
                       float(score), float(res.psnr), float(res.ssim))
    (st_c, rec_c, s_c, p_c, ss_c), (st_g, rec_g, s_g, p_g, ss_g) = \
        out.values()
    d = np.abs(st_c.astype(int) - st_g.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
    assert abs(p_c - p_g) <= 0.01 and abs(ss_c - ss_g) <= 1e-3
    assert abs(s_c - s_g) <= 1e-3 and s_g > 0.9
    assert _nc(rec_c, rec_g) >= 0.999


def test_enhance_on_gpu_matches_cpu(dev):
    """Every enhancement stage on the card against the CPU: unsharp and
    CLAHE within 1 quantum, NLM within 1 quantum on >= 99 % of pixels, the
    chains' mean |Δ| < 0.5; no stage degrades."""
    import warnings
    plane = _frames((40, 52), SEED + 11)
    img = _frames((40, 52, 3), SEED + 12)
    cases = [(lambda t: e_ops.unsharp_u8(t, 1.25, -0.25), plane, "q1"),
             (e_ops.clahe_u8, plane, "q1"),
             (e_ops.nlm_gray_u8, plane, "nlm"),
             (e_ops.nlm_color_u8, img, "nlm"),
             (tenh.enhance_gray_u8, plane, "chain"),
             (tenh.enhance_color_u8, img, "chain")]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for fn, x, tol in cases:
            a, b = (fn(torch.as_tensor(x, device=d)).cpu().numpy().astype(int)
                    for d in ("cpu", dev))
            diff = np.abs(a - b)
            if tol == "q1":
                assert diff.max() <= 1
            elif tol == "nlm":
                assert (diff <= 1).mean() >= 0.99
            else:
                assert diff.mean() < 0.5


def test_resync_on_gpu_matches_cpu(dev):
    """Resync on the card: one K1 launch a chunk, chunk scores within 1e-3
    of the CPU's, the same recovered shift, and derotate (K13) within 1
    quantum of the CPU and exact at 0°."""
    h, w = 64, 80
    cover = _frames((h, w, 3), SEED + 13)
    wm = _frames((h, w, 3), SEED + 14)
    key = crypto.derive_key("gpu", bytes(8))
    blk, intra = crypto.block_permutation_indices(key, tb.n_blocks_of(h, w))
    got = {}
    for d in ("cpu", dev):
        res = tb.embed_color(torch.as_tensor(cover, device=d),
                             torch.as_tensor(wm, device=d),
                             torch.as_tensor(blk, device=d),
                             torch.as_tensor(intra, device=d), ALPHA)
        rolled = torch.roll(res.stego_bgr, (2, -3), dims=(0, 1))
        shifts = torch.as_tensor(tb._resync_shifts(4, 0), device=d)
        n0 = wm_cuda.spectrum_blocks.launches
        chunk = tb._detect_shift_chunk(rolled, res.sc, res.sw, ALPHA, shifts,
                                       color_frames=True)
        launched = wm_cuda.spectrum_blocks.launches - n0
        found = tb.detect_color_resync(rolled, res.sc, res.sw, ALPHA,
                                       window=4, chunk=16)
        rot = resync_cuda.derotate(res.stego_bgr, 0.7, color_frames=True)
        assert torch.equal(resync_cuda.derotate(res.stego_bgr, 0.0,
                                                color_frames=True),
                           res.stego_bgr)
        got[str(d)] = (chunk.cpu(), found, rot.cpu(), launched)
    (c_c, f_c, r_c, n_c), (c_g, f_g, r_g, n_g) = got.values()
    assert n_c == 0 and n_g == 1
    assert float((c_c - c_g).abs().max()) <= 1e-3
    assert f_c[1] == f_g[1] == (2, -3) and abs(f_c[0] - f_g[0]) <= 1e-3
    assert int((r_c.to(torch.int16) - r_g.to(torch.int16)).abs().max()) <= 1


@pytest.mark.parametrize("layout", ["frames_u8", "luma_f32"])
def test_spectrum_on_a_resync_chunk_equals_twin(dev, layout):
    """K1 on one chunk of 64 rolls, gathered as the resync search gathers
    it (u8 color frames, or f32 luma planes for gray resync), is bit-equal
    to its plain twin."""
    from dctsvd_tpu_torch.ops import color
    img = torch.as_tensor(_frames((96, 128, 3), SEED + 15), device=dev)
    if layout == "luma_f32":
        img = color.luma_f32(img)
    shifts = torch.as_tensor(tb._resync_shifts(tb.BLOCK, 0)[:64], device=dev)
    stack = resync_cuda.roll_stack(img, shifts)
    kw = dict(channels_last=True) if layout == "frames_u8" else {}
    got = wm_cuda.spectrum_blocks(stack, sweeps=1.25, **kw)
    assert torch.equal(got, wm_cuda.spectrum_blocks_plain(stack, sweeps=1.25,
                                                          **kw))


# K12 and K13: frames from 1×1 to 2160×3840 in the three layouts
RESYNC_SHAPES = [(1, 1), (2, 3), (37, 51), (129, 95), (1080, 1920),
                 (2160, 3840)]
RESYNC_LAYOUTS = ["u8 frames", "u8 plane", "f32 plane"]
RESYNC_ANGLES = [0.05, -0.3, 0.3, 7.5, 90.0, 180.0]


def _resync_frame(dev, shape, layout, seed=SEED + 21):
    """A seeded frame on the card: u8 BGR [H, W, 3], a u8 plane [H, W] or
    an f32 plane of both signs [H, W]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if layout == "f32 plane":
        return torch.randn(shape, generator=gen, device=dev) * 60
    x = torch.randint(0, 256, (*shape, 3), generator=gen, device=dev,
                      dtype=torch.uint8)
    return x if layout == "u8 frames" else x[..., 0].contiguous()


def _roll_shifts(h, w):
    """Offsets with zero, both signs, |d| >= H and W, and the search's."""
    return [(0, 0), (3, -5), (-7, 7), (1, 0), (0, -1), (h, w),
            (-h - 1, 2 * w + 3), (5 * h + 2, -3 * w - 1)]


@pytest.mark.parametrize("shape", RESYNC_SHAPES,
                         ids=[f"{h}x{w}" for h, w in RESYNC_SHAPES])
@pytest.mark.parametrize("layout", RESYNC_LAYOUTS)
def test_k12_roll_stack_equals_twin(dev, layout, shape):
    """K12 equals its twin run on the card byte for byte, for 8 offsets
    and for one (S = 1), with one launch each."""
    x = _resync_frame(dev, shape, layout)
    for sh in (_roll_shifts(*shape), [(-4, 9)]):
        shifts = torch.as_tensor(sh, device=dev)
        n0 = resync_cuda.roll_stack.launches
        got = resync_cuda.roll_stack(x, shifts)
        torch.cuda.synchronize()
        assert resync_cuda.roll_stack.launches == n0 + 1
        ref = resync_cuda.roll_stack_plain(x, shifts)
        assert got.shape == ref.shape and torch.equal(
            got.view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.parametrize("layout", RESYNC_LAYOUTS)
@pytest.mark.parametrize("instance", ["vector", "scalar"])
def test_k12_on_a_search_chunk_equals_twin(dev, layout, instance):
    """K12 on the first chunk of 64 of the 15×15 search at 1080p equals its
    twin; an input 1 element off its 16-byte boundary takes the scalar
    instance and equals it too."""
    x = _resync_frame(dev, (1080, 1920), layout)
    if instance == "scalar":
        base = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        x = base[1:].view(x.shape).copy_(x)
    shifts = torch.as_tensor(tb._resync_shifts(tb.BLOCK, 0)[:64], device=dev)
    out = torch.empty((64, *x.shape), dtype=x.dtype, device=dev)
    row = x.shape[1] * (x.shape[2] if x.ndim == 3 else 1) * x.element_size()
    assert resync_cuda.roll_plan(row, x.data_ptr(), out.data_ptr()) == (
        instance == "vector")
    got = resync_cuda.roll_stack(x, shifts)
    assert torch.equal(got.view(torch.uint8), resync_cuda.roll_stack_plain(
        x, shifts).view(torch.uint8))


@pytest.mark.parametrize("angle", RESYNC_ANGLES)
@pytest.mark.parametrize("shape", RESYNC_SHAPES,
                         ids=[f"{h}x{w}" for h, w in RESYNC_SHAPES])
@pytest.mark.parametrize("layout", RESYNC_LAYOUTS)
def test_k13_derotate_equals_twin(dev, layout, shape, angle):
    """K13 equals its twin run on the card (torch.equal), one launch."""
    x = _resync_frame(dev, shape, layout)
    cl = layout == "u8 frames"
    n0 = resync_cuda.derotate.launches
    got = resync_cuda.derotate(x, angle, color_frames=cl)
    torch.cuda.synchronize()
    assert resync_cuda.derotate.launches == n0 + 1
    ref = resync_cuda.derotate_plain(x, angle, cl)
    assert got.dtype == x.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("shape", RESYNC_SHAPES,
                         ids=[f"{h}x{w}" for h, w in RESYNC_SHAPES])
@pytest.mark.parametrize("layout", RESYNC_LAYOUTS)
def test_k13_at_angle_zero_is_the_input(dev, layout, shape):
    x = _resync_frame(dev, shape, layout)
    got = resync_cuda.derotate(x, 0.0, color_frames=layout == "u8 frames")
    assert torch.equal(got, x)


def test_k13_on_a_batch_of_planes_and_four_channels(dev):
    """K13 on a batch of f32 planes [3, H, W] and on u8 frames with 4
    channels equals its twin."""
    planes = torch.randn((3, 37, 51), device=dev) * 60
    assert torch.equal(resync_cuda.derotate(planes, 0.3),
                       resync_cuda.derotate_plain(planes, 0.3))
    frames = torch.randint(0, 256, (2, 37, 51, 4), device=dev,
                           dtype=torch.uint8)
    assert torch.equal(resync_cuda.derotate(frames, -7.5, color_frames=True),
                       resync_cuda.derotate_plain(frames, -7.5, True))


# K13 batched: the resync search's angles (±0.5° at 0.05°, 20 nonzero)
SEARCH_ANGLES = [k * s * 0.05 for k in range(1, 11) for s in (1, -1)]
DEROTATE_ANGLE_CASES = {
    "1080p u8 frames": ((1080, 1920), "u8 frames"),
    "1080p f32 plane": ((1080, 1920), "f32 plane"),
    "2160x3840 f32 plane": ((2160, 3840), "f32 plane"),
    **{f"{h}x{w} {layout}": ((h, w), layout) for h, w in ((3, 5), (37, 51))
       for layout in RESYNC_LAYOUTS},
    "offset u8 frames": ((37, 52), "u8 frames"),
    "offset f32 plane": ((37, 52), "f32 plane"),
}


def test_rotation_cs_batch_equals_per_angle(dev):
    """The scan's (cos, sin) pairs made in one pass of rotation_cs's ops
    equal rotation_cs angle by angle (torch.equal): the search's grids,
    its refinement, and angles of every size."""
    rng = np.random.default_rng(SEED + 24)
    lists = [SEARCH_ANGLES, [0.3 + k * 0.01 for k in (-4, -3, -2, -1, 1, 2,
                                                       3, 4)],
             RESYNC_ANGLES, list(rng.uniform(-360.0, 360.0, 257)),
             [0.0, -0.0, 1e-7, 45.0, 720.5, -1e4]]
    for angles in lists:
        got = resync_cuda.rotation_cs_batch(angles, dev)
        ref = torch.stack([resync_cuda.rotation_cs(a, dev) for a in angles])
        assert got.shape == (len(angles), 2) and torch.equal(got, ref)


@pytest.mark.parametrize("case", list(DEROTATE_ANGLE_CASES))
def test_k13_derotate_angles_equals_twin(dev, case):
    """K13 on a scan's 20 angles in one launch: every slice equals
    derotate_plain at its angle (torch.equal), in the vector instance and,
    for widths not a multiple of 4 and a view off its 16-byte alignment,
    the scalar one; derotate counts no launch."""
    shape, layout = DEROTATE_ANGLE_CASES[case]
    x = _resync_frame(dev, shape, layout)
    if case.startswith("offset"):
        x = _offset(x)
    cl = layout == "u8 frames"
    n0 = resync_cuda.derotate_angles.launches
    n1 = resync_cuda.derotate.launches
    got = resync_cuda.derotate_angles(x, SEARCH_ANGLES, color_frames=cl)
    torch.cuda.synchronize()
    assert resync_cuda.derotate_angles.launches == n0 + 1
    assert resync_cuda.derotate.launches == n1
    assert got.shape == (len(SEARCH_ANGLES), *x.shape)
    for k, a in enumerate(SEARCH_ANGLES):
        assert torch.equal(got[k], resync_cuda.derotate_plain(x, a, cl)), a


def test_k13_derotate_plan_picks_the_instance(dev):
    """derotate_plan: the vector instance for widths a multiple of 4 and an
    aligned output, the scalar one otherwise."""
    assert resync_cuda.derotate_plan(1920, 256)
    assert not resync_cuda.derotate_plan(1918, 256)
    assert not resync_cuda.derotate_plan(1920, 260)


def test_rotation_search_on_gpu_matches_cpu(dev):
    """A rotation search on the card (K12 a chunk, K13 once a scan, two
    host reads) finds the shift and angle the same search finds on the
    CPU, its score within 1e-3; every counter-rotated candidate equals
    derotate_plain at its angle."""
    import cv2
    h, w = 96, 128
    # a σ1-blurred cover: a noise cover's mark does not survive the
    # attacker's bilinear rotation at this size
    cover = cv2.GaussianBlur(_frames((h, w, 3), SEED + 22), (0, 0), 1.0)
    wm = _frames((h, w, 3), SEED + 23)
    key = crypto.derive_key("gpu", bytes(8))
    blk, intra = crypto.block_permutation_indices(key, tb.n_blocks_of(h, w))
    res = tb.embed_color(torch.as_tensor(cover), torch.as_tensor(wm),
                         torch.as_tensor(blk), torch.as_tensor(intra), ALPHA)
    rot = cv2.warpAffine(res.stego_bgr.numpy(), cv2.getRotationMatrix2D(
        (w / 2, h / 2), 2.4, 1.0), (w, h), borderMode=cv2.BORDER_REPLICATE)
    kw = dict(window=2, chunk=4, rot_range=3.0, rot_step=1.0)
    found, reads, scans = {}, [], []
    real_read, real_angles = tb._read_scores, resync_cuda.derotate_angles

    def checked_angles(img, angles, color_frames=False):
        out = real_angles(img, angles, color_frames=color_frames)
        scans.append(len(angles))
        for k, a in enumerate(angles):
            assert torch.equal(out[k], resync_cuda.derotate_plain(
                img, a, color_frames))
        return out

    tb._read_scores = lambda parts: reads.append(len(parts)) or real_read(
        parts)
    # the wrapper counts on its module's name, here the checking one
    checked_angles.launches = 0
    resync_cuda.derotate_angles = checked_angles
    try:
        for d in ("cpu", dev):
            n12 = resync_cuda.roll_stack.launches
            n13 = checked_angles.launches
            found[str(d)] = tb.detect_color_resync(
                torch.as_tensor(rot, device=d), res.sc.to(d), res.sw.to(d),
                ALPHA, **kw)
            launched = (resync_cuda.roll_stack.launches - n12,
                        checked_angles.launches - n13)
    finally:
        tb._read_scores = real_read
        resync_cuda.derotate_angles = real_angles
    (s_c, t_c, a_c), (s_g, t_g, a_g) = found.values()
    assert (t_g, a_g) == (t_c, a_c) and abs(s_g - s_c) <= 1e-3
    assert abs(a_g - 2.4) <= 0.2 + 1e-6
    assert reads == [7 * 3, 8 * 3] * 2
    assert scans == [6, 8] * 2
    assert launched == (15 * 3, 2)


def _video_chunk(k=4, h=96, w=128, seed=SEED + 16):
    """k frames of tests/test_video.py's synthetic clip at h×w: a
    σ3-blurred noise frame rolled 2 px a frame, u8 BGR [k, h, w, 3]."""
    import cv2
    base = cv2.GaussianBlur(_frames((h, w, 3), seed), (0, 0), 3.0)
    return np.stack([np.roll(base, 2 * i, axis=1) for i in range(k)])


def _circle(h=96, w=128):
    import cv2
    wm = np.zeros((48, 48), np.uint8)
    cv2.circle(wm, (24, 24), 16, 255, -1)
    return cv2.resize(wm, (w, h), interpolation=cv2.INTER_AREA)


def _close_u8(a, b):
    d = (a.cpu().to(torch.int16) - b.cpu().to(torch.int16)).abs()
    return int(d.max()) <= 1 and float((d > 0).float().mean()) <= 0.01


@pytest.mark.parametrize("color", [False, True], ids=["gray", "color"])
@pytest.mark.parametrize("scheme", ["full", "blocked"])
def test_video_device_functions_on_gpu_match_cpu(dev, scheme, color):
    """models/video's device functions on a 96×128 chunk of 4 frames of
    the smooth (σ3-blurred) clip, card against CPU: the watermark's Sw
    within 1e-5·s_max; s_orig within 1e-5·s_max (full) or within
    1e-3·s_max and 1e-4·s_max on >= 99 % (blocked: tests/test_torch_video
    .py's bounds on smooth frames); marked bytes within 1 quantum on <= 1 %
    (full), and for the blocked scheme at most 1 % of bytes differing and
    at most 0.1 % by more than 1 quantum: on near-rank-1 blocks the
    unconverged s1.25 rotations amplify the last-ulp differences between
    the card's and the CPU's arithmetic (measured on an H100: 0.076 % of
    color bytes differ, 0.015 % by 2-6 quanta; 0 on noise frames; K2 is
    bit-equal to its twin run on the card either way). The recovery runs
    on the card and on the CPU from the same inputs (the CPU's marked
    frames, s_orig and watermark factors): within 1e-3·max|est| (full),
    within 2 quanta after clipping (blocked). Blocked: K4, K2 and K1
    launched once each."""
    from dctsvd_tpu_torch.models import video as tv
    import cv2
    frames = _video_chunk()
    if color and scheme == "full":
        planes = np.ascontiguousarray(np.moveaxis(frames, -1, 1))
    elif color:
        planes = frames
    else:
        planes = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
                           for f in frames])
    wm = _circle()
    fns = (svd_cuda.jacobi_svd8, wm_cuda.embed_blocks,
           wm_cuda.spectrum_blocks)
    got, cpu = [], None
    for d in ("cpu", dev):
        n0 = [f.launches for f in fns]
        x = torch.as_tensor(planes, device=d)
        if scheme == "full":
            uw, sw, vtw = tv._wm_svd(torch.as_tensor(wm, device=d))
            fn = tv._embed_frame_color if color else tv._embed_frame_gray
        else:
            uw, sw, vtw = tv._wm_svd_blocked(torch.as_tensor(wm, device=d))
            fn = (tv._embed_frames_color_blocked if color
                  else tv._embed_frame_gray_blocked)
        marked, s_orig = fn(x, sw, ALPHA)
        # the recovery from the CPU's outputs, moved to this device
        if cpu is None:
            cpu = (marked, s_orig, uw, sw, vtw)
        m_in, s_in, uw_in, sw_in, vtw_in = (t.to(d) for t in cpu)
        if scheme == "full":
            est = tv._recover_wm(tv._frame_singular_values(m_in), s_in,
                                 uw_in, vtw_in, ALPHA)
        else:
            est = tv._recover_wm_blocked(m_in, s_in, uw_in, vtw_in, ALPHA,
                                         0.6, 96, 128, sw=sw_in, sweeps=1.25,
                                         channels_last=color)
        torch.cuda.synchronize()
        got.append((sw.cpu(), marked.cpu(), s_orig.cpu(), est.cpu(),
                    [f.launches - n for f, n in zip(fns, n0)]))
    (sw_c, m_c, s_c, e_c, n_c), (sw_g, m_g, s_g, e_g, n_g) = got
    assert n_c == [0, 0, 0]
    assert n_g == ([0, 0, 0] if scheme == "full" else [1, 1, 1])
    assert m_g.dtype == torch.uint8 and m_g.shape == m_c.shape
    if scheme == "full":
        assert _close_u8(m_g, m_c)
    else:
        d = (m_g.to(torch.int16) - m_c.to(torch.int16)).abs()
        assert float((d > 0).float().mean()) <= 0.01
        assert float((d > 1).float().mean()) <= 0.001
    assert float((sw_g - sw_c).abs().max()) <= 1e-5 * float(sw_c.max())
    err = (s_g - s_c).abs() / float(s_c.abs().max())
    if scheme == "full":
        assert float(err.max()) <= 1e-5
        assert float((e_g - e_c).abs().max()) <= 1e-3 * float(
            e_c.abs().max())
    else:
        assert float(err.max()) <= 1e-3
        assert float((err <= 1e-4).float().mean()) >= 0.99
        diff = (e_g.clamp(0, 255).to(torch.int16)
                - e_c.clamp(0, 255).to(torch.int16)).abs()
        assert int(diff.max()) <= 2


def test_blocked_video_embed_extract_on_gpu(dev, tmp_path):
    """A blocked color video through models/video's entry points on the
    card: K4 once and K2 once a chunk on embed, K1 once a chunk on
    extract; the extraction correlates with the watermark (NC > 0.4)."""
    import cv2
    from dctsvd_tpu_torch.io import video_io
    from dctsvd_tpu_torch.models import video as tv
    clip, wm_png = str(tmp_path / "clip.mp4"), str(tmp_path / "wm.png")
    frames = _video_chunk(k=24)
    with video_io.VideoWriter(clip, 24.0, 128, 96) as w:
        for f in frames:
            w.write(f)
    wm = np.zeros((48, 48), np.uint8)
    cv2.circle(wm, (24, 24), 16, 255, -1)
    cv2.imwrite(wm_png, wm)
    fns = (svd_cuda.jacobi_svd8, wm_cuda.embed_blocks,
           wm_cuda.spectrum_blocks)
    n0 = [f.launches for f in fns]
    out, meta = tv.embed_watermark_video_color(
        clip, wm_png, str(tmp_path / "m.mp4"), str(tmp_path / "m.npz"),
        alpha=0.08, frame_interval=5, scheme="blocked", device=dev)
    torch.cuda.synchronize()
    n1 = [f.launches for f in fns]
    tv.extract_watermark_video(out, meta, str(tmp_path / "wm_out.png"),
                               device=dev)
    torch.cuda.synchronize()
    n2 = [f.launches for f in fns]
    assert [b - a for a, b in zip(n0, n1)] == [1, 2, 0]
    assert [b - a for a, b in zip(n1, n2)] == [0, 0, 2]
    got = cv2.imread(str(tmp_path / "wm_out.png"), cv2.IMREAD_GRAYSCALE)
    a = got.astype(np.float64).ravel() - got.mean()
    b = _circle().astype(np.float64).ravel() - _circle().mean()
    assert a @ b / np.sqrt((a @ a) * (b @ b)) > 0.4


def _close_on_devices(got, ref, name):
    """A card output against the same call's on the CPU: u8 within 1
    quantum on at most 1 % of the bytes, floats within 1e-4 of their
    largest value (scores 1e-3); a watermark recovered from the same
    inputs on both devices within 2 quanta (``recovered``); one that each
    device recovers from its own stego and sc correlates with the CPU's
    above 0.95 per frame (``fused``)."""
    got = got.cpu()
    if name == "fused":
        a = got.reshape(got.shape[0], -1).to(torch.float64)
        b = ref.reshape(ref.shape[0], -1).to(torch.float64)
        a, b = a - a.mean(1, keepdim=True), b - b.mean(1, keepdim=True)
        nc = (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))
        assert float(nc.min()) > 0.95, (name, nc.tolist())
    elif name == "recovered":
        d = (got.to(torch.int16) - ref.to(torch.int16)).abs()
        assert int(d.max()) <= 2, (name, int(d.max()))
    elif ref.dtype == torch.uint8:
        d = (got.to(torch.int16) - ref.to(torch.int16)).abs()
        assert int(d.max()) <= 1, name
        assert float((d > 0).float().mean()) <= 0.01, name
    else:
        tol = 1e-3 if name in ("scores", "psnr", "ssim") else \
            1e-4 * float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol, name


def test_make_mesh_takes_the_cards(dev):
    from dctsvd_tpu_torch.parallel import mesh as pmesh
    m = pmesh.make_mesh()
    n = torch.cuda.device_count()
    assert m.shape == {"batch": n} and m.devices[0] == dev
    assert pmesh.make_mesh(1).devices == (dev,)
    assert pmesh.make_mesh(devices=["cuda"] * 2).devices == (dev, dev)
    with pytest.raises(ValueError):
        pmesh.make_mesh(n + 1)


def test_parallel_batch_on_gpu_matches_cpu(dev):
    """Each parallel/batch entry point on four shards of the card against
    the same call on four shards of the CPU, with K1-K4 launched once a
    shard (K4 once a device)."""
    from dctsvd_tpu_torch.parallel import batch as pb
    from dctsvd_tpu_torch.parallel import mesh as pmesh
    h, w = 64, 80
    frames = _frames((8, h, w, 3), SEED + 20)
    wm = _frames((h, w, 3), SEED + 21)
    key = crypto.derive_key("gpu", bytes(8))
    blk, intra = crypto.block_permutation_indices(key, tb.n_blocks_of(h, w))
    out = {}
    for d in ("cpu", dev):
        mesh = pmesh.make_mesh(devices=[d] * 4)
        t = {n: torch.as_tensor(a, device=d) for n, a in
             (("frames", frames), ("wm", wm), ("blk", blk),
              ("intra", intra))}
        pwc = tb.prepare_wm_color(t["wm"], t["blk"], t["intra"])
        pwg = tb.prepare_wm_gray(t["wm"][..., 0], t["blk"], t["intra"])
        counters = (wm_cuda.spectrum_blocks, wm_cuda.embed_blocks,
                    wm_cuda.roundtrip_frames_blocks, svd_cuda.jacobi_svd8)
        n0 = [f.launches for f in counters]
        r = {}
        r["stego"], r["sc"], r["recovered"], r["scores"] = \
            pb.batch_serve_verify_detect(t["frames"], pwc.sw, ALPHA,
                                         pwc.ebasis, pwc.inv_blk, mesh=mesh)
        st, sc = pb.batch_embed_prepared(t["frames"], pwg.sw, ALPHA,
                                         mesh=mesh)
        r["gray_stego"], r["gray_sc"] = st, sc
        # both devices extract from the CPU's stego and sc: the card's
        # own differ by a quantum or an ulp, which 1/alpha amplifies
        if d != "cpu":
            st, sc = (x.to(d) for x in (out["cpu"]["gray_stego"],
                                        out["cpu"]["gray_sc"]))
        r["gray_recovered"] = pb.batch_extract_prepared(
            st, sc, pwg.ebasis, pwg.inv_blk, pwg.sw, ALPHA, mesh=mesh)
        r["gray_scores"] = pb.batch_detect_blocked(st, sc, pwg.sw, ALPHA,
                                                   mesh=mesh,
                                                   per_frame_sc=True)
        emb = pb.batch_embed_blocked(t["frames"], t["wm"][..., 0], t["blk"],
                                     t["intra"], ALPHA, mesh=mesh)
        # U and Vt are held by K4's own tests; the factors' signs may
        # differ between devices where two singular values nearly tie
        r.update({f"blocked_{k}": v for k, v in emb.items()
                  if k not in ("uw", "vwt")})
        if d == dev:
            torch.cuda.synchronize()
            assert [f.launches - b for f, b in zip(counters, n0)] == \
                [8, 8, 4, 1]
            # the shards equal the unsharded calls on the card
            one = pmesh.make_mesh(devices=[d])
            ref = pb.batch_serve_verify_detect(t["frames"], pwc.sw, ALPHA,
                                               pwc.ebasis, pwc.inv_blk,
                                               mesh=one)
            for a, b in zip((r["stego"], r["sc"], r["recovered"]), ref[:3]):
                assert torch.equal(a, b)
            assert float((r["scores"] - ref[3]).abs().max()) <= 1e-5
            assert torch.equal(r["gray_recovered"], pb.batch_extract_prepared(
                st, sc, pwg.ebasis, pwg.inv_blk, pwg.sw, ALPHA, mesh=one))
            # the serve step's fused recovery reads the card's own stego
            # and sc; the same tail from the CPU's stego and sc is within
            # 2 quanta of the CPU's recovery, so what the NC bound below
            # allows comes from those inputs, not from the tail
            r["serve_tail"] = tb.extract_color_prepared(
                out["cpu"]["stego"].to(d), out["cpu"]["sc"].to(d),
                pwc.ebasis, pwc.inv_blk, ALPHA, sw=pwc.sw)
        out[str(d)] = r
    cpu, gpu = out["cpu"], out[str(dev)]
    cpu["serve_tail"] = cpu["recovered"]
    for name, ref in cpu.items():
        kind = {"recovered": "fused", "serve_tail": "recovered"}.get(
            name, name.split("_")[-1] if name.startswith(("gray", "blocked"))
            else name)
        _close_on_devices(gpu[name], ref, kind)
    assert float(gpu["scores"].min()) >= 0.30
    assert float(gpu["gray_scores"].min()) >= 0.30


def test_parallel_plane_on_gpu_matches_cpu(dev):
    """parallel/plane in four bands of the card: the stego equals the
    whole-frame embed on the card, and the card's bands match the CPU's."""
    from dctsvd_tpu_torch.parallel import mesh as pmesh
    from dctsvd_tpu_torch.parallel import plane as pp
    h, w = 256, 128
    cover = _frames((h, w, 3), SEED + 22)
    wm = _frames((h, w), SEED + 23)
    key = crypto.derive_key("gpu", bytes(8))
    blk, intra = crypto.block_permutation_indices(key, tb.n_blocks_of(h, w))
    out = {}
    for d in ("cpu", dev):
        mesh = pmesh.make_mesh(devices=[d] * 4)
        c = torch.as_tensor(cover, device=d)
        pw = tb.prepare_wm_gray(torch.as_tensor(wm, device=d),
                                torch.as_tensor(blk, device=d),
                                torch.as_tensor(intra, device=d),
                                extract_basis=False)
        st, sc = pp.plane_embed_gray(c, pw.sw, ALPHA, mesh=mesh)
        whole = tb.embed_gray_prepared(c, pw.sw, ALPHA, with_metrics=False)
        assert torch.equal(st, whole[0]) and torch.equal(sc, whole[1])
        score = pp.plane_detect_gray(st, sc, pw.sw, ALPHA, mesh=mesh)
        clean = pp.plane_detect_gray(c, sc, pw.sw, ALPHA, mesh=mesh)
        out[str(d)] = dict(stego=st, sc=sc, scores=torch.stack([score,
                                                                clean]))
    for name, ref in out["cpu"].items():
        _close_on_devices(out[str(dev)][name], ref, name)
    s = out[str(dev)]["scores"]
    assert float(s[0]) > 0.8 and abs(float(s[1])) < 0.3


def test_parallel_detect_full_on_gpu(dev):
    """The parity batch detect on the card equals the per-image detect
    bit for bit (each image's own SVD), and the unmarked cover cancels."""
    from dctsvd_tpu_torch.parallel import batch as pb
    from dctsvd_tpu_torch.parallel import mesh as pmesh
    frames = torch.as_tensor(_frames((3, 64, 80, 3), SEED + 24), device=dev)
    wm = torch.as_tensor(_frames((64, 80), SEED + 25), device=dev)
    res = timg.embed_gray(frames[0], wm, torch.arange(64 * 80, device=dev),
                          ALPHA)
    batch = torch.cat([res.stego_bgr[None], frames])
    got = pb.batch_detect_full(batch, res.sc, res.sw, ALPHA,
                               mesh=pmesh.make_mesh(devices=[dev] * 2))
    single = torch.stack([timg.detect_gray(im, res.sc, res.sw, ALPHA)
                          for im in batch])
    assert torch.equal(got, single)
    assert float(got[0]) > 0.9 and float(got[1]) == 0.0


def _tail_inputs(layout, k, flags, frames=2, h=64, w=8 * 35, seed=SEED + 30):
    """K5's inputs: seeded estimates [frames, (3,) N, k (+1 flag column,
    a fifth of the blocks flagged)] and a basis sliced from [(3,) N, 8, 8,
    8] as the prepared one is (block stride 512 floats). 35 blocks a row
    leave a partial last warp group in both layouts."""
    rng = np.random.default_rng(seed)
    n = (h // 8) * (w // 8)
    cd = (3,) if layout != "planes" else ()
    x = (rng.standard_normal((frames, *cd, n, k)) * 3).astype(np.float32)
    if flags:
        f = (rng.random((frames, *cd, n, 1)) < 0.2).astype(np.float32)
        x = np.concatenate([x, f], axis=-1)
    basis = torch.from_numpy(
        rng.standard_normal((*cd, n, 8, 8, 8)).astype(np.float32))
    return (torch.from_numpy(x), basis[..., :k, :, :].reshape(*cd, n, k, 64),
            h, w)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("out_u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("normalize", [True, False],
                         ids=["normalize", "raw"])
@pytest.mark.parametrize("flags", [True, False], ids=["flags", "no_flags"])
@pytest.mark.parametrize("layout", ["frames", "planes", "color_planes"])
def test_tail_kernel_matches_twin(dev, layout, flags, normalize, out_u8, k):
    """K5 equals its twin run on the card (torch.equal) in each layout:
    color channels-last frames, gray planes and color planes."""
    x, eb64, h, w = _tail_inputs(layout, k, flags)
    x, eb64 = x.to(dev), eb64.to(dev)
    cl = layout == "frames"
    n0 = tail_cuda.recon_normalize.launches
    got = tail_cuda.recon_normalize(x, eb64, h, w, normalize=normalize,
                                    out_u8=out_u8, to_frames=cl)
    torch.cuda.synchronize()
    assert tail_cuda.recon_normalize.launches == n0 + 1
    ref = tail_cuda.recon_normalize_plain(x, eb64, h, w, normalize=normalize,
                                          out_u8=out_u8, to_frames=cl)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.equal(got, ref), float(
        (got.to(torch.float64) - ref.to(torch.float64)).abs().max())


@pytest.mark.parametrize("frames", [8, 70])
@pytest.mark.parametrize("layout", ["frames", "planes"])
def test_tail_kernel_is_batch_invariant(dev, layout, frames):
    """A frame's bytes are the same alone, in a shard of 4 and in the
    batch. K5's window pass folds 8 frames at a time and a CTA walks a
    share of the frames, so the batch of 70 runs partial chunks and frame
    splits: there the whole batch is also held to the twin, and the
    shards cross the chunk boundaries."""
    x, eb64, h, w = _tail_inputs(layout, 4, True, frames=frames)
    x, eb64 = x.to(dev), eb64.to(dev)
    cl = layout == "frames"
    whole = tail_cuda.recon_normalize(x, eb64, h, w, to_frames=cl)
    if frames > 32:
        assert torch.equal(whole, tail_cuda.recon_normalize_plain(
            x, eb64, h, w, to_frames=cl))
    for i in (0, 5, frames - 1):
        assert torch.equal(
            tail_cuda.recon_normalize(x[i], eb64, h, w, to_frames=cl),
            whole[i])
    for a in sorted({4, min(30, frames - 4), frames - 6}):
        assert torch.equal(
            tail_cuda.recon_normalize(x[a:a + 4], eb64, h, w, to_frames=cl),
            whole[a:a + 4])


def test_tail_kernel_all_flagged_and_nan(dev):
    """Every block of a plane flagged flattens it (as the twin does); a
    NaN in an unflagged block of another plane propagates through its
    window as torch.amin lets it (f32 out, compared with NaN equal)."""
    x, eb64, h, w = _tail_inputs("frames", 4, True)
    x[0, 1, :, 4] = 1.0
    x[1, 2, 7, 0] = float("nan")
    x[1, 2, 7, 4] = 0.0
    x, eb64 = x.to(dev), eb64.to(dev)
    for out_u8 in (True, False):
        got = tail_cuda.recon_normalize(x, eb64, h, w, out_u8=out_u8,
                                        to_frames=True)
        ref = tail_cuda.recon_normalize_plain(x, eb64, h, w, out_u8=out_u8,
                                              to_frames=True)
        plane = got[0, ..., 1]
        assert torch.equal(plane, plane[:1, :1].expand_as(plane))
        if out_u8:
            assert torch.equal(got[0], ref[0])
        else:
            assert bool(torch.isnan(got[1, ..., 2]).all())
            torch.testing.assert_close(got, ref, rtol=0, atol=0,
                                       equal_nan=True)


def test_tail_wrapper_never_runs_the_twin_on_the_card(dev, monkeypatch):
    """A CUDA tensor launches K5 (the twin is not reached) and a basis
    the kernel cannot read raises instead of falling back."""
    x, eb64, h, w = _tail_inputs("frames", 4, True)
    x, eb64 = x.to(dev), eb64.to(dev)
    ref = tail_cuda.recon_normalize(x, eb64, h, w, to_frames=True)

    def refuse(*args, **kwargs):
        raise AssertionError("the twin ran for a CUDA tensor")

    monkeypatch.setattr(tail_cuda, "recon_normalize_plain", refuse)
    n0 = tail_cuda.recon_normalize.launches
    assert torch.equal(tail_cuda.recon_normalize(x, eb64, h, w,
                                                 to_frames=True), ref)
    assert tail_cuda.recon_normalize.launches == n0 + 1
    buf = torch.empty(eb64.numel() + 1, device=dev)
    off = buf[1:].view(eb64.shape).copy_(eb64)        # 4 bytes off 16
    with pytest.raises(ValueError, match="16-byte"):
        tail_cuda.recon_normalize(x, off, h, w, to_frames=True)
    with pytest.raises(ValueError, match="contiguous"):
        tail_cuda.recon_normalize(x.transpose(0, 1).contiguous().transpose(
            0, 1), eb64, h, w, to_frames=True)


@pytest.mark.parametrize("path", ["color", "gray"])
def test_recompute_entry_points_on_the_card(dev, path):
    """extract_*_prepared(recompute=True) on the card launches K5 and
    stays within 2 quanta of recompute=False and of the CPU run."""
    h, w = 64, 80
    cover = torch.from_numpy(_frames((2, h, w, 3), SEED + 31))
    wm = torch.from_numpy(_frames((h, w, 3), SEED + 32))
    key = crypto.derive_key("gpu", bytes(8))
    blk, intra = crypto.block_permutation_indices(key, tb.n_blocks_of(h, w))
    out = {}
    for d in ("cpu", dev):
        b, i = torch.as_tensor(blk, device=d), torch.as_tensor(intra,
                                                               device=d)
        if path == "color":
            pw = tb.prepare_wm_color(wm.to(d), b, i)
            st, sc, _, _ = tb.embed_color_prepared(cover.to(d), pw.sw,
                                                   ALPHA)
            fn = tb.extract_color_prepared
        else:
            pw = tb.prepare_wm_gray(wm[..., 0].to(d), b, i)
            st, sc, _, _ = tb.embed_gray_prepared(cover.to(d), pw.sw, ALPHA)
            fn = tb.extract_gray_prepared
        n0 = tail_cuda.recon_normalize.launches
        rec = fn(st, sc, pw.ebasis, pw.inv_blk, ALPHA, sw=pw.sw,
                 recompute=True)
        eager = fn(st, sc, pw.ebasis, pw.inv_blk, ALPHA, sw=pw.sw)
        torch.cuda.synchronize()
        assert tail_cuda.recon_normalize.launches == n0 + (d != "cpu")
        d_e = (rec.to(torch.int16) - eager.to(torch.int16)).abs()
        assert int(d_e.max()) <= 2
        out[str(d)] = rec.cpu()
    assert int((out["cpu"].to(torch.int16)
                - out[str(dev)].to(torch.int16)).abs().max()) <= 2


# ---------------------------------------------------------------------------
# K5f, the extract tail's front stage (the estimator and the slot gather)
# ---------------------------------------------------------------------------

def _equal_nan(a, b):
    """torch.equal with NaN equal to NaN."""
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a.masked_fill(nan, 0), b.masked_fill(nan, 0)))


@pytest.mark.parametrize("k", list(range(1, 9)))
@pytest.mark.parametrize("layout", ["color", "gray", "shared_sw",
                                    "alpha_per_frame"])
def test_tail_front_kernel_matches_twin(dev, layout, k):
    """K5f equals its twin run on the card (NaN equal to NaN) at every k,
    with and without sw, on seeded spectra with exact ties (raw 0), zero
    and negative estimates, zero sw entries, a NaN, and both presence
    decisions; sw shared by the channels and one alpha a frame too."""
    rng = np.random.default_rng(SEED + 41 + k)
    f, n = 3, 300
    cd = (3,) if layout != "gray" else ()
    sc = rng.uniform(0, 50, (f, *cd, n, 8)).astype(np.float32)
    s_cw = sc + rng.normal(0, 2, sc.shape).astype(np.float32)
    s_cw[..., ::7, :] = sc[..., ::7, :]               # raw exactly 0
    s_cw[0, ..., 5, 1] = np.nan
    sw = rng.uniform(0, 30, ((3,) if layout in ("color", "alpha_per_frame")
                             else ()) + (n, 8)).astype(np.float32)
    sw[..., ::11, :] = 0.0
    sw[..., ::13, 2:] = 0.0
    t = {name: torch.from_numpy(a).to(dev)
         for name, a in (("s_cw", s_cw), ("sc", sc), ("sw", sw))}
    inv_blk = torch.from_numpy(rng.permutation(n)).to(dev)
    alpha = (torch.tensor([0.1, 0.15, 0.05], device=dev).reshape(3, 1, 1, 1)
             if layout == "alpha_per_frame" else
             torch.tensor(0.12, device=dev))
    engage = torch.from_numpy(rng.random((f, *cd)) < 0.5).to(dev)
    scale = tb._sw_scale(t["sw"])
    for with_sw in (True, False):
        args = ((t["sw"], scale, engage) if with_sw else ())
        n0 = tail_cuda.tail_front.launches
        got = tail_cuda.tail_front(t["s_cw"], t["sc"], inv_blk, alpha, k,
                                   *args)
        torch.cuda.synchronize()
        assert tail_cuda.tail_front.launches == n0 + 1
        ref = tail_cuda.tail_front_plain(t["s_cw"], t["sc"], inv_blk, alpha,
                                         k, *args)
        assert _equal_nan(got, ref), float(
            (got - ref).abs().nan_to_num(0).max())
        if with_sw:
            flags = got[..., k]
            assert bool(((flags == 0) | (flags == 1)).all())


FRONT_FRAMES = (1, 4, 32, 70, 128)
FRONT_SHAPES = {"color": (1080, 1920), "gray": (1080, 1920),
                "unaligned": (1083, 1917)}
_FRONT_STATES = {}


def _front_state(dev, name):
    """The 1080p inputs of K5f for one path: a prepared watermark, 128
    stego frames (8 seeded noise covers, 16 times) with their sc, and the
    stego spectrum of each case: the stego, the stego with all but its
    top-left quadrant zeroed (absent, three blocks in four flagged), an
    all-zero mark-free frame (every block flagged), and the stego with
    one NaN."""
    if name in _FRONT_STATES:
        return _FRONT_STATES[name]
    h, w = FRONT_SHAPES[name]
    rng = np.random.default_rng(SEED + 40)
    covers = torch.from_numpy(rng.integers(0, 256, (8, h, w, 3), np.uint8))
    covers = covers.to(dev).repeat(16, 1, 1, 1)
    wm = torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8)).to(dev)
    key = crypto.derive_key("gpu-front", bytes(8))
    blk, intra = (torch.as_tensor(a, device=dev) for a in
                  crypto.block_permutation_indices(key,
                                                   tb.n_blocks_of(h, w)))
    if name == "gray":
        pw = tb.prepare_wm_gray(wm[..., 0], blk, intra)
        st, sc = tb.embed_gray_prepared(covers, pw.sw, ALPHA,
                                        with_metrics=False)[:2]

        def spectrum(x):
            return tb._plane_spectrum(color.luma_f32(x))
    else:
        pw = tb.prepare_wm_color(wm, blk, intra)
        st, sc = tb.embed_color_prepared(covers, pw.sw, ALPHA,
                                         with_metrics=False)[:2]
        spectrum = tb._frames_spectrum
    zeroed = st.clone()
    zeroed[:, h // 2:] = 0
    zeroed[:, :, w // 2:] = 0
    s_cw = {"stego": spectrum(st), "zeroed": spectrum(zeroed),
            "black": spectrum(torch.zeros_like(st))}
    s_cw["no_sw"] = s_cw["stego"]
    s_cw["nan"] = s_cw["stego"].clone()
    s_cw["nan"][1, ..., 3, 2] = float("nan")
    _FRONT_STATES[name] = out = dict(pw=pw, st=st, sc=sc, s_cw=s_cw)
    return out


@pytest.mark.parametrize("case", ["stego", "zeroed", "black", "no_sw", "nan"])
@pytest.mark.parametrize("path", list(FRONT_SHAPES))
def test_tail_front_at_1080p_matches_twin(dev, path, case):
    """models/blocked._tail_front (K5f after the presence statistic) equals
    the twin run on the card with the eager presence decision on 1, 4, 32,
    70 and 128 frames (NaN equal to NaN), and a frame's rows are the same
    alone, in a shard of 4 and in the batch of 128."""
    st = _front_state(dev, path)
    pw, sc, s_cw = st["pw"], st["sc"], st["s_cw"][case]
    sw = None if case == "no_sw" else pw.sw
    alpha = torch.tensor(ALPHA, device=dev)
    whole = tb._tail_front(s_cw, sc, pw.inv_blk, ALPHA, 4, sw)
    for n in FRONT_FRAMES:
        n0 = tail_cuda.tail_front.launches
        got = tb._tail_front(s_cw[:n], sc[:n], pw.inv_blk, ALPHA, 4, sw)
        torch.cuda.synchronize()
        assert tail_cuda.tail_front.launches == n0 + 1
        extra = ()
        if sw is not None:
            raw = tb._raw_estimate(s_cw[:n], sc[:n], ALPHA)
            extra = (sw, tb._sw_scale(sw), tb._engaged(raw, sw))
        ref = tail_cuda.tail_front_plain(s_cw[:n], sc[:n], pw.inv_blk,
                                         alpha, 4, *extra)
        assert _equal_nan(got, ref), n
        assert _equal_nan(got, whole[:n]), n
    for i in (0, 5, 127):
        assert _equal_nan(tb._tail_front(s_cw[i], sc[i], pw.inv_blk, ALPHA,
                                         4, sw), whole[i])
    for a in (4, 62, 122):
        assert _equal_nan(tb._tail_front(s_cw[a:a + 4], sc[a:a + 4],
                                         pw.inv_blk, ALPHA, 4, sw),
                          whole[a:a + 4])
    if sw is None:
        return
    flagged = whole[..., 4] > 0.5
    if case in ("stego", "nan"):
        assert not bool(flagged.any())
    elif case == "zeroed":
        assert 0 < float(flagged.float().mean()) < 1
    else:
        assert bool(flagged.all())


@pytest.mark.parametrize("path", ["color", "gray"])
def test_default_tail_bytes_are_the_same_with_either_front(dev, path,
                                                           monkeypatch):
    """The default extract (recompute=False), the recompute extract and,
    for color, serve_verify_color_prepared give the same bytes with K5f as
    with its twin run on the card in its place (4 frames at 1080p)."""
    st = _front_state(dev, path)
    pw, stego, sc = st["pw"], st["st"][:4], st["sc"][:4]
    fn = (tb.extract_color_prepared if path == "color"
          else tb.extract_gray_prepared)

    def outputs():
        out = [fn(stego, sc, pw.ebasis, pw.inv_blk, ALPHA, sw=pw.sw),
               fn(stego, sc, pw.ebasis, pw.inv_blk, ALPHA, sw=pw.sw,
                  recompute=True)]
        if path == "color":
            out.append(tb.serve_verify_color_prepared(
                stego, pw.sw, ALPHA, pw.ebasis, pw.inv_blk)[2])
        return out

    n0 = tail_cuda.tail_front.launches
    kernel = outputs()
    assert tail_cuda.tail_front.launches == n0 + len(kernel)
    monkeypatch.setattr(tail_cuda, "tail_front", tail_cuda.tail_front_plain)
    eager = outputs()
    for a, b in zip(kernel, eager):
        assert torch.equal(a, b)


def _k8_inputs(dev, layout, flags, frames=2, seed=SEED + 50):
    """K8's inputs from _tail_inputs' estimates and basis: the product as
    models/blocked._recon makes it on the card (a strided view), and the
    estimates whose column 4 flags blocks."""
    x, eb64, h, w = _tail_inputs(layout, 4, flags, frames=frames, seed=seed)
    x, eb64 = x.to(dev), eb64.to(dev)
    return tb._recon(x[..., :4], eb64), x, eb64, h, w


def _k8_plan(dev, instance, frames, chans, n_blk):
    """K8's plan forcing ``instance``: the two-pass one, or the resident
    one: norm_plan's with normalize where it takes it (the 1080p batches),
    else a whole share a slot in a ring of RES_MAX_SLOTS (the small test
    frames, which norm_plan gives the two-pass instance)."""
    if instance == "two_pass":
        return tail_cuda.NormPlan("two_pass")
    sms, smem, coop = tail_cuda.device_limits(dev)
    assert coop
    plan = tail_cuda.norm_plan(frames, chans, n_blk, True, sms, smem)
    if plan.instance == "resident":
        return plan
    ctas = min(sms, n_blk)
    chunk = (-(-n_blk // ctas) + 3) // 4 * 4
    ring = tail_cuda.RES_MAX_SLOTS
    need = tail_cuda.resident_smem(chans, chunk, ring)
    assert need <= smem
    return tail_cuda.NormPlan("resident", ctas, ring, chunk, need)


def _k8_counted(instance, fn, crop=False):
    """fn()'s result, holding that it launched K8 once, as ``instance``,
    and (``crop``) as K8u's instance of that name (else not as K8u)."""
    n0 = tail_cuda.normalize_blocks.launches
    before = dict(tail_cuda.INSTANCE_LAUNCHES)
    got = fn()
    torch.cuda.synchronize()
    assert tail_cuda.normalize_blocks.launches == n0 + 1
    want = dict(before)
    want[instance] += 1
    if crop:
        want["crop_" + instance] += 1
    assert tail_cuda.INSTANCE_LAUNCHES == want
    return got


@pytest.mark.parametrize("instance", ["resident", "two_pass"])
@pytest.mark.parametrize("out_u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("normalize", [True, False],
                         ids=["normalize", "raw"])
@pytest.mark.parametrize("flags", [True, False], ids=["flags", "no_flags"])
@pytest.mark.parametrize("layout", ["frames", "planes", "color_planes"])
def test_k8_matches_twin(dev, layout, flags, normalize, out_u8, instance):
    """K8 equals its twin, the eager form, run on the card (torch.equal)
    in each layout: color channels-last frames, gray planes, color
    planes; each instance."""
    blocks, x, _, h, w = _k8_inputs(dev, layout, flags)
    cl = layout == "frames"
    plan = _k8_plan(dev, instance, 2, 1 if layout == "planes" else 3,
                    blocks.shape[-2])
    got = _k8_counted(instance, lambda: tail_cuda.normalize_blocks(
        blocks, x, 4, h, w, normalize=normalize, out_u8=out_u8,
        to_frames=cl, plan=plan))
    ref = tail_cuda.normalize_blocks_plain(blocks, x, 4, h, w,
                                           normalize=normalize,
                                           out_u8=out_u8, to_frames=cl)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.equal(got, ref), float(
        (got.to(torch.float64) - ref.to(torch.float64)).abs().max())


@pytest.mark.parametrize("instance", ["resident", "two_pass"])
@pytest.mark.parametrize("frames", [8, 70])
@pytest.mark.parametrize("layout", ["frames", "planes"])
def test_k8_is_batch_invariant(dev, layout, frames, instance):
    """A frame's bytes are the same alone, in a shard of 4 and in the
    batch (70 frames: partial chunks of 8, frame splits, and a product of
    three RECON_FRAMES slices), and the whole batch equals the twin; each
    instance."""
    blocks, x, eb64, h, w = _k8_inputs(dev, layout, True, frames=frames)
    cl = layout == "frames"
    plan = _k8_plan(dev, instance, frames, 3 if cl else 1,
                    blocks.shape[-2])
    whole = _k8_counted(instance, lambda: tail_cuda.normalize_blocks(
        blocks, x, 4, h, w, to_frames=cl, plan=plan))
    assert torch.equal(whole, tail_cuda.normalize_blocks_plain(
        blocks, x, 4, h, w, to_frames=cl))

    def alone(a, b):
        xs = x[a:b]
        return _k8_counted(instance, lambda: tail_cuda.normalize_blocks(
            tb._recon(xs[..., :4], eb64), xs, 4, h, w, to_frames=cl,
            plan=plan))
    for i in (0, 5, frames - 1):
        assert torch.equal(alone(i, i + 1), whole[i:i + 1])
    for a in sorted({4, min(30, frames - 4), frames - 6}):
        assert torch.equal(alone(a, a + 4), whole[a:a + 4])


@pytest.mark.parametrize("instance", ["resident", "two_pass"])
def test_k8_all_flagged_and_nan(dev, instance):
    """Every block of a plane flagged flattens it; a NaN in an unflagged
    block of another plane propagates through its window (f32 out,
    compared with NaN equal), as the twin's amin and amax let it; each
    instance."""
    blocks, x, _, h, w = _k8_inputs(dev, "frames", True)
    x[0, 1, :, 4] = 1.0
    blocks = blocks.clone()
    blocks[1, 2, 7, 5] = float("nan")
    x[1, 2, 7, 4] = 0.0
    plan = _k8_plan(dev, instance, 2, 3, blocks.shape[-2])
    for out_u8 in (True, False):
        got = _k8_counted(instance, lambda: tail_cuda.normalize_blocks(
            blocks, x, 4, h, w, out_u8=out_u8, to_frames=True, plan=plan))
        ref = tail_cuda.normalize_blocks_plain(blocks, x, 4, h, w,
                                               out_u8=out_u8, to_frames=True)
        plane = got[0, ..., 1]
        assert torch.equal(plane, plane[:1, :1].expand_as(plane))
        if out_u8:
            assert torch.equal(got, ref)
        else:
            assert bool(torch.isnan(got[1, ..., 2]).all())
            torch.testing.assert_close(got, ref, rtol=0, atol=0,
                                       equal_nan=True)


def test_k8_wrapper_never_runs_the_twin_on_the_card(dev, monkeypatch):
    """A CUDA tensor launches K8 (the twin is not reached), and a product
    or flags the kernel cannot read raise instead of falling back."""
    blocks, x, _, h, w = _k8_inputs(dev, "frames", True)
    ref = tail_cuda.normalize_blocks(blocks, x, 4, h, w, to_frames=True)

    def refuse(*args, **kwargs):
        raise AssertionError("the twin ran for a CUDA tensor")

    monkeypatch.setattr(tail_cuda, "normalize_blocks_plain", refuse)
    n0 = tail_cuda.normalize_blocks.launches
    assert torch.equal(tail_cuda.normalize_blocks(blocks, x, 4, h, w,
                                                  to_frames=True), ref)
    assert tail_cuda.normalize_blocks.launches == n0 + 1
    buf = torch.empty(blocks.numel() + 1, device=dev)
    off = buf[1:].view(blocks.shape).copy_(blocks)       # 4 bytes off 16
    with pytest.raises(ValueError, match="16-byte"):
        tail_cuda.normalize_blocks(off, x, 4, h, w, to_frames=True)
    with pytest.raises(ValueError, match="16-byte"):
        tail_cuda.normalize_blocks(blocks.transpose(-1, -2).contiguous()
                                   .transpose(-1, -2), x, 4, h, w,
                                   to_frames=True)
    with pytest.raises(ValueError, match="rows"):
        tail_cuda.normalize_blocks(blocks, x.transpose(0, 1).contiguous()
                                   .transpose(0, 1), 4, h, w, to_frames=True)


@pytest.mark.parametrize("frames", [1, 4, 32, 33, 128])
@pytest.mark.parametrize("path", ["color", "gray"])
def test_k8_instances_match_twin_at_1080p(dev, path, frames):
    """Each K8 instance equals the twin run on the card (torch.equal) on
    the main path's product (models/blocked._recon's strided view of K5f's
    1080p estimates) at 1, 4, 32, 33 and 128 frames: the stego with three
    quadrants zeroed (flagged blocks) and without sw (no flag column),
    with and without normalize, u8 and f32 out."""
    st = _front_state(dev, path)
    pw, cl = st["pw"], path == "color"
    k = tb.k_of_block(tb.K_FRAC_DEFAULT)
    eb = pw.ebasis[..., :k, :, :]
    eb64 = eb.reshape(*eb.shape[:-2], 64)
    for case, sw in (("zeroed", pw.sw), ("no_sw", None)):
        x = tb._tail_front(st["s_cw"][case][:frames], st["sc"][:frames],
                           pw.inv_blk, ALPHA, k, sw)
        if sw is not None:
            assert 0 < float((x[..., k] > 0.5).float().mean()) < 1
        blocks = tb._recon(x[..., :k], eb64)
        assert not blocks.is_contiguous()
        for instance in ("resident", "two_pass"):
            plan = _k8_plan(dev, instance, frames, 3 if cl else 1,
                            blocks.shape[-2])
            for normalize in (True, False):
                for out_u8 in (True, False):
                    kw = dict(normalize=normalize, out_u8=out_u8,
                              to_frames=cl)
                    got = _k8_counted(instance,
                                      lambda: tail_cuda.normalize_blocks(
                                          blocks, x, k, 1080, 1920,
                                          plan=plan, **kw))
                    ref = tail_cuda.normalize_blocks_plain(
                        blocks, x, k, 1080, 1920, **kw)
                    assert torch.equal(got, ref), (case, instance, kw)


def test_k8_plan_takes_the_instance_by_shape(dev):
    """On the card the 1080p batches (color and gray) take the resident
    instance and a 4K color frame the two-pass one, each launched once
    by the default plan and equal to the twin."""
    sms, smem, coop = tail_cuda.device_limits(dev)
    assert coop and sms >= 1 and smem > 0
    for chans in (3, 1):
        assert tail_cuda.norm_plan(32, chans, 32400, True, sms,
                                   smem).instance == "resident"
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    for (h, w), instance in (((1080, 1920), "resident"),
                             ((2160, 3840), "two_pass")):
        n = (h // 8) * (w // 8)
        blocks = torch.randn((2, 3, n, 64), generator=gen, device=dev)
        x = torch.randn((2, 3, n, 5), generator=gen, device=dev)
        x[..., 4] = (x[..., 4] > 1.0).float()
        got = _k8_counted(instance, lambda: tail_cuda.normalize_blocks(
            blocks, x, 4, h, w, to_frames=True))
        assert torch.equal(got, tail_cuda.normalize_blocks_plain(
            blocks, x, 4, h, w, to_frames=True))


def test_k8_resident_plan_beyond_the_card_raises(dev):
    """A resident plan whose CTAs cannot all be resident (twice the SMs,
    each above half an SM's shared memory) is refused by the cooperative
    launch and raises KernelError without hanging, as does one above a
    CTA's shared memory; no launch is counted, and the next call runs."""
    blocks, x, _, h, w = _k8_inputs(dev, "frames", True)
    sms, smem, _ = tail_cuda.device_limits(dev)
    ctas = min(2 * sms, blocks.shape[-2])    # a share of 1 or 2 blocks
    chunk = 4
    while tail_cuda.resident_smem(3, chunk + 4, 1) <= smem:
        chunk += 4
    assert tail_cuda.resident_smem(3, chunk, 1) > smem // 2
    n0 = tail_cuda.normalize_blocks.launches
    for plan in (tail_cuda.NormPlan("resident", ctas, 1, chunk),
                 tail_cuda.NormPlan("resident", sms, 1, chunk + 4)):
        with pytest.raises(kernels.KernelError):
            tail_cuda.normalize_blocks(blocks, x, 4, h, w, to_frames=True,
                                       plan=plan)
        torch.cuda.synchronize()
    assert tail_cuda.normalize_blocks.launches == n0
    plan = _k8_plan(dev, "resident", 2, 3, blocks.shape[-2])
    got = _k8_counted("resident", lambda: tail_cuda.normalize_blocks(
        blocks, x, 4, h, w, to_frames=True, plan=plan))
    assert torch.equal(got, tail_cuda.normalize_blocks_plain(
        blocks, x, 4, h, w, to_frames=True))


@pytest.mark.parametrize("case", ["stego", "zeroed", "black", "no_sw"])
@pytest.mark.parametrize("path", ["color", "gray"])
def test_default_extract_takes_k8_at_1080p(dev, path, case, monkeypatch):
    """The default extract at 1080p launches K8 once and gives the bytes
    of K8's twin in its place, on 1, 4, 32, 33 and 128 frames; a frame's
    bytes are the same alone, in a shard of 4 and in the batch of 128."""
    st = _front_state(dev, path)
    pw, sc, s_cw = st["pw"], st["sc"], st["s_cw"][case]
    sw = None if case == "no_sw" else pw.sw

    def extract(a, b):
        return tb._extract_tail_prepared(
            s_cw[a:b], sc[a:b], pw.ebasis, pw.inv_blk, ALPHA,
            tb.K_FRAC_DEFAULT, True,
            1080, 1920, sw=sw, to_frames=path == "color", out_u8=True)

    kernel = {}
    for n in (1, 4, 32, 33, 128):
        n0 = tail_cuda.normalize_blocks.launches
        kernel[n] = extract(0, n)
        torch.cuda.synchronize()
        assert tail_cuda.normalize_blocks.launches == n0 + 1
    for i in (0, 5, 127):
        assert torch.equal(extract(i, i + 1), kernel[128][i:i + 1])
    for a in (4, 62, 122):
        assert torch.equal(extract(a, a + 4), kernel[128][a:a + 4])
    monkeypatch.setattr(tail_cuda, "normalize_blocks",
                        tail_cuda.normalize_blocks_plain)
    for n, got in kernel.items():
        assert torch.equal(got, extract(0, n)), n


# ---------------------------------------------------------------------------
# K18 (the presence statistic) and K8u (K8 with a crop), and the request
# extract (extract_gray / extract_color, extract_array's) through K1, K18,
# K5f and K8 / K8u.
# ---------------------------------------------------------------------------

def _eager_engaged(raw, sw):
    """The presence statistic as the port ran it in eager ops before K18:
    metrics.nc over the groups, torch.sort, the knee."""
    ref = sw.expand(raw.shape)
    n = raw.shape[-2]
    gsz = max(1, n // 16)
    ng = n // gsz
    a0 = ref[..., :ng * gsz, 0].reshape(*ref.shape[:-2], ng, gsz)
    b0 = raw[..., :ng * gsz, 0].reshape(*raw.shape[:-2], ng, gsz)
    rho0 = torch.sort(metrics.nc(a0, b0), dim=-1).values[..., ng - -(-ng // 4)]
    knee = 0.20 + 1.8 / torch.sqrt(torch.full((), float(gsz),
                                              device=raw.device))
    return rho0 >= knee


def _k18_counted(fn):
    n0 = tail_cuda.presence.launches
    got = fn()
    torch.cuda.synchronize()
    assert tail_cuda.presence.launches == n0 + 1
    return got


def _k18_equal(s_cw, sw, sc=None, alpha=None):
    """K18 against its twin run on the card: rho0 (NaN equal) and the
    decision; returns K18's (engage, rho0). Without sc and alpha, s_cw is
    the raw estimate, handed in as models/blocked._engaged hands it (sc =
    0, alpha = 1)."""
    if sc is None:
        sc = torch.zeros(1, device=s_cw.device)
        alpha = torch.ones(1, device=s_cw.device)
    got = _k18_counted(lambda: tail_cuda.presence(s_cw, sw, sc, alpha))
    ref = tail_cuda.presence_plain(s_cw, sw, sc, alpha)
    assert torch.equal(got[0], ref[0])
    assert _equal_nan(got[1], ref[1]), float(
        (got[1] - ref[1]).abs().nan_to_num(0).max())
    return got


@pytest.mark.parametrize("case", ["stego", "zeroed", "black", "nan"])
@pytest.mark.parametrize("path", list(FRONT_SHAPES))
def test_k18_at_1080p_matches_twin(dev, path, case):
    """K18 equals its twin run on the card (rho0 and decision) on the
    1080p stego spectra (and 1083x1917's) of 1, 4, 32 and 128 frames, on
    the spectra and on the raw estimate (sc = 0, alpha = 1); a frame's
    decision is the same alone, in a shard and in the batch, and equal to
    the eager statistic's."""
    st = _front_state(dev, path)
    pw, sc, s_cw = st["pw"], st["sc"], st["s_cw"][case]
    alpha = torch.tensor(ALPHA, device=dev)
    whole = _k18_equal(s_cw, pw.sw, sc, alpha)
    raw = tb._raw_estimate(s_cw, sc, ALPHA)
    assert torch.equal(_k18_equal(raw, pw.sw)[0], whole[0])
    assert torch.equal(whole[0], _eager_engaged(raw, pw.sw))
    for n in (1, 4, 32):
        got = _k18_equal(s_cw[:n], pw.sw, sc[:n], alpha)
        assert torch.equal(got[0], whole[0][:n])
        assert _equal_nan(got[1], whole[1][:n])
    for i in (5, 127):
        got = _k18_equal(s_cw[i], pw.sw, sc[i], alpha)
        assert _equal_nan(got[1], whole[1][i])
    want = {"stego": True, "nan": True, "black": False}.get(case)
    if want is not None:
        assert bool((whole[0] == want).all())


@pytest.mark.parametrize("shape", [(65, 83), (129, 243), (2160, 3840),
                                   (7, 9), (8, 16)],
                         ids=["65x83", "129x243", "4k", "7x9", "8x16"])
@pytest.mark.parametrize("layout", ["color", "gray", "shared_sw",
                                    "alpha_per_frame", "shared_sc"])
def test_k18_matches_twin(dev, layout, shape):
    """K18 equals its twin run on the card on seeded estimates: present,
    absent and NaN planes side by side, at sizes whose groups are tiny
    (1 block: 7x9, 8x16), unaligned, and past the resident group (4K:
    8,100 blocks a group); sw shared by the channels, one alpha a frame,
    sc shared by the frames."""
    h, w = shape
    n = (-(-h // 8)) * (-(-w // 8))
    rng = np.random.default_rng(SEED + 60 + n)
    f = 2 if n > 100000 else 4
    cd = (3,) if layout != "gray" else ()
    sw = rng.uniform(1, 30, ((3,) if layout not in ("gray", "shared_sw")
                             else ()) + (n, 8)).astype(np.float32)
    raw = np.broadcast_to(sw, (f, *cd, n, 8)) + rng.normal(0, 2, (f, *cd, n,
                                                                   8))
    raw[1] = rng.normal(0, 40, raw[1].shape)               # absent
    sc = rng.uniform(0, 200, (f, *cd, n, 8)).astype(np.float32)
    if layout == "shared_sc":
        sc = sc[:1]
    s_cw = (sc + raw * ALPHA).astype(np.float32)
    s_cw[-1, ..., n // 2, 0] = np.nan
    alpha = (torch.tensor([0.1, 0.15, 0.05, 0.12][:f], device=dev).reshape(
        f, *[1] * (len(cd) + 2)) if layout == "alpha_per_frame"
        else torch.tensor(ALPHA, device=dev))
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in (("s_cw", s_cw), ("sc", sc), ("sw", sw))}
    if layout == "alpha_per_frame":
        t["s_cw"] = (t["sc"] + torch.from_numpy(raw.astype(np.float32)).to(
            dev) * alpha).contiguous()
    engage, _ = _k18_equal(t["s_cw"], t["sw"], t["sc"], alpha)
    raw_t = (t["s_cw"] - t["sc"]) / torch.clamp(alpha, min=1e-8)
    _k18_equal(raw_t, t["sw"])
    if n >= 16 * 30:
        assert bool(engage[0].all()) and not bool(engage[1].any())


def test_k18_never_runs_the_twin_on_the_card(dev, monkeypatch):
    """A CUDA tensor launches K18 (the twin is not reached); _tail_front
    and _engaged launch it once each."""
    st = _front_state(dev, "color")
    pw, sc, s_cw = st["pw"], st["sc"][:2], st["s_cw"]["stego"][:2]
    ref = tail_cuda.presence(s_cw, pw.sw, sc, torch.tensor(ALPHA,
                                                           device=dev))

    def refuse(*args, **kwargs):
        raise AssertionError("the twin ran for a CUDA tensor")

    monkeypatch.setattr(tail_cuda, "presence_plain", refuse)
    monkeypatch.setattr(metrics, "nc", refuse)
    got = _k18_counted(lambda: tb._engaged(tb._raw_estimate(s_cw, sc, ALPHA),
                                           pw.sw))
    assert torch.equal(got, ref[0])
    _k18_counted(lambda: tb._tail_front(s_cw, sc, pw.inv_blk, ALPHA, 4,
                                        pw.sw))


K8U_SIZES = [(65, 83), (129, 243), (1083, 1917), (1080, 1917), (1079, 1920),
             (3, 5)]


def _k8u_inputs(dev, h, w, layout, flags, frames, seed):
    """K8u's inputs at h x w: seeded estimates whose column 4 flags a
    share of the blocks (none: no flag column), a basis, and the product
    as models/blocked._recon makes it on the card (a strided view)."""
    n = (-(-h // 8)) * (-(-w // 8))
    gen = torch.Generator(device=dev).manual_seed(seed)
    cd = (3,) if layout != "planes" else ()
    x = torch.randn((frames, *cd, n, 5), generator=gen, device=dev)
    share = {"none": 0.0, "some": 0.2, "all": 1.0}[flags]
    x[..., 4] = (torch.rand(x.shape[:-1], generator=gen, device=dev)
                 < share).float()
    eb64 = torch.randn((*cd, n, 4, 64), generator=gen, device=dev)
    if flags == "none":
        x = x[..., :4].contiguous()
    return tb._recon(x[..., :4], eb64), x, n


@pytest.mark.parametrize("instance", ["resident", "two_pass"])
@pytest.mark.parametrize("out_u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("normalize", [True, False],
                         ids=["normalize", "raw"])
@pytest.mark.parametrize("flags", ["none", "some", "all"])
@pytest.mark.parametrize("layout", ["frames", "planes", "color_planes"])
@pytest.mark.parametrize("hw", K8U_SIZES,
                         ids=[f"{h}x{w}" for h, w in K8U_SIZES])
def test_k8u_matches_twin(dev, hw, layout, flags, normalize, out_u8,
                          instance):
    """K8u (K8 with a crop) equals its twin run on the card (torch.equal)
    at unaligned sizes, off the 8-pixel grid in either dimension or both,
    in every layout, on the product's strided view; each instance, its
    plan forced."""
    h, w = hw
    frames = 2 if h < 1000 else 3
    blocks, x, n = _k8u_inputs(dev, h, w, layout, flags, frames,
                               SEED + 70 + h + w)
    kw = dict(normalize=normalize, out_u8=out_u8,
              to_frames=layout == "frames")
    plan = _k8_plan(dev, instance, frames, 1 if layout == "planes" else 3, n)
    got = _k8_counted(instance, lambda: tail_cuda.normalize_blocks(
        blocks, x, 4, h, w, plan=plan, **kw), crop=True)
    ref = tail_cuda.normalize_blocks_plain(blocks, x, 4, h, w, **kw)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert (got.shape[-3:-1] if layout == "frames"
            else got.shape[-2:]) == (h, w)
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("instance", ["resident", "two_pass"])
@pytest.mark.parametrize("frames", [1, 128])
@pytest.mark.parametrize("layout", ["frames", "planes"])
def test_k8u_at_1079x1917(dev, layout, frames, instance):
    """K8u on 1 and 128 frames at 1079x1917 (color frames, gray planes)
    equals its twin run on the card, each instance (the default plan is
    the resident one, as at 1080p)."""
    h, w = 1079, 1917
    chans = 3 if layout == "frames" else 1
    blocks, x, n = _k8u_inputs(dev, h, w, layout, "some", frames,
                               SEED + 71 + frames)
    sms, smem, _ = tail_cuda.device_limits(dev)
    assert tail_cuda.shape_plan(frames, chans, h, w, True, sms,
                                smem).instance == "resident"
    plan = _k8_plan(dev, instance, frames, chans, n)
    cl = layout == "frames"
    got = _k8_counted(instance, lambda: tail_cuda.normalize_blocks(
        blocks, x, 4, h, w, to_frames=cl, plan=plan), crop=True)
    assert torch.equal(got, tail_cuda.normalize_blocks_plain(
        blocks, x, 4, h, w, to_frames=cl))
    if instance == "resident":
        assert torch.equal(got, _k8_counted(
            instance, lambda: tail_cuda.normalize_blocks(
                blocks, x, 4, h, w, to_frames=cl), crop=True))


def test_k8u_resident_plan_beyond_the_card_raises(dev):
    """A crop's resident plan whose CTAs cannot all be resident raises
    KernelError (no two-pass fallback) and counts no launch; the crop's
    default plan then runs."""
    h, w = 129, 243                            # 527 blocks a plane
    blocks, x, n = _k8u_inputs(dev, h, w, "frames", "some", 2, SEED + 72)
    sms, smem, _ = tail_cuda.device_limits(dev)
    chunk = 4
    while tail_cuda.resident_smem(3, chunk + 4, 1) <= smem:
        chunk += 4
    before = dict(tail_cuda.INSTANCE_LAUNCHES)
    n0 = tail_cuda.normalize_blocks.launches
    assert n >= 2 * sms
    for plan in (tail_cuda.NormPlan("resident", 2 * sms, 1, chunk),
                 tail_cuda.NormPlan("resident", sms, 1, chunk + 4)):
        with pytest.raises(kernels.KernelError):
            tail_cuda.normalize_blocks(blocks, x, 4, h, w, to_frames=True,
                                       plan=plan)
        torch.cuda.synchronize()
    assert tail_cuda.normalize_blocks.launches == n0
    assert tail_cuda.INSTANCE_LAUNCHES == before
    got = _k8_counted("two_pass", lambda: tail_cuda.normalize_blocks(
        blocks, x, 4, h, w, to_frames=True), crop=True)
    assert torch.equal(got, tail_cuda.normalize_blocks_plain(
        blocks, x, 4, h, w, to_frames=True))


def _request_state(dev, h, w):
    """A 1080p-derived request: 4 seeded noise covers cut to h x w, their
    color and gray stego (the prepared watermarks' factors), and the
    extract's inputs."""
    rng = np.random.default_rng(SEED + 80)
    covers = torch.from_numpy(rng.integers(0, 256, (4, h, w, 3),
                                           np.uint8)).to(dev)
    wm = torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8)).to(dev)
    key = crypto.derive_key("gpu-request", bytes(8))
    blk, intra = (torch.as_tensor(a, device=dev) for a in
                  crypto.block_permutation_indices(key,
                                                   tb.n_blocks_of(h, w)))
    out = {}
    for path in ("color", "gray"):
        if path == "color":
            pw = tb.prepare_wm_color(wm, blk, intra, extract_basis=False)
            st, sc = tb.embed_color_prepared(covers, pw.sw, ALPHA,
                                             with_metrics=False)[:2]
        else:
            pw = tb.prepare_wm_gray(wm[..., 0], blk, intra,
                                    extract_basis=False)
            st, sc = tb.embed_gray_prepared(covers, pw.sw, ALPHA,
                                            with_metrics=False)[:2]
        zeroed = st.clone()
        zeroed[:, h // 2:] = 0
        zeroed[:, :, w // 2:] = 0
        out[path] = (pw, sc, {"stego": st, "zeroed": zeroed})
    return out


def _request_extract(path, pw, sc, stego, sw=True):
    fn = tb.extract_color if path == "color" else tb.extract_gray
    return fn(stego, sc, pw.uw, pw.vwt, pw.inv_blk, pw.inv_intra, ALPHA,
              sw=pw.sw if sw else None)


@pytest.mark.parametrize("hw", [(1080, 1920), (1079, 1917), (65, 83)],
                         ids=["1080p", "1079x1917", "65x83"])
def test_request_extract_equals_the_twins(dev, hw, monkeypatch):
    """The request extract (extract_color / extract_gray, what
    extract_array runs) launches K1, K18, K5f and K8 (K8u where unaligned)
    once each, calls neither _masked_normalize nor metrics.nc, and gives
    the bytes it gives with every twin in its kernel's place (K6's too);
    a frame's bytes are the same alone and in the batch; the stego, the
    zeroed stego and without sw."""
    h, w = hw
    state = _request_state(dev, h, w)

    def refuse(*args, **kwargs):
        raise AssertionError("an eager form ran")

    sms, smem, _ = tail_cuda.device_limits(dev)
    kernel = {}
    with monkeypatch.context() as m:
        m.setattr(tb, "_masked_normalize", refuse)
        m.setattr(metrics, "nc", refuse)
        for path, (pw, sc, stegos) in state.items():
            # K8's instance: as the plan picks it (K8u's where unaligned)
            inst = tail_cuda.shape_plan(4, 3 if path == "color" else 1, h,
                                        w, True, sms, smem).instance
            for case, st in stegos.items():
                for sw in (True, False):
                    wrappers = [wm_cuda.spectrum_blocks, tail_cuda.presence,
                                tail_cuda.tail_front,
                                tail_cuda.normalize_blocks]
                    n0 = [f.launches for f in wrappers]
                    i0 = dict(tail_cuda.INSTANCE_LAUNCHES)
                    got = _request_extract(path, pw, sc, st, sw)
                    torch.cuda.synchronize()
                    ran = [f.launches - n for f, n in zip(wrappers, n0)]
                    assert ran == [1, int(sw), 1, 1], (path, case, ran)
                    i0[inst] += 1
                    if h % 8 or w % 8:
                        i0["crop_" + inst] += 1
                    assert tail_cuda.INSTANCE_LAUNCHES == i0, (path, inst)
                    assert got.dtype == torch.uint8 and got.shape == (
                        (4, h, w, 3) if path == "color" else (4, h, w))
                    kernel[path, case, sw] = got
                    for i in (0, 3):
                        assert torch.equal(_request_extract(
                            path, pw, sc[i:i + 1], st[i:i + 1], sw),
                            got[i:i + 1])
    for name in ("presence", "tail_front", "normalize_blocks"):
        monkeypatch.setattr(tail_cuda, name,
                            getattr(tail_cuda, f"{name}_plain"))
    monkeypatch.setattr(wm_cuda, "spectrum_blocks",
                        wm_cuda.spectrum_blocks_plain)
    monkeypatch.setattr(color_cuda, "luma_f32", color_cuda.luma_f32_plain)
    for (path, case, sw), got in kernel.items():
        pw, sc, stegos = state[path]
        assert torch.equal(_request_extract(path, pw, sc, stegos[case], sw),
                           got), (path, case, sw)


def test_tail_front_wrapper_never_runs_the_twin_on_the_card(dev,
                                                            monkeypatch):
    """A CUDA tensor launches K5f (the twin is not reached), and spectra
    the kernel cannot read raise instead of falling back."""
    rng = np.random.default_rng(SEED + 42)
    sc = torch.from_numpy(rng.uniform(0, 9, (2, 3, 40, 8)).astype(
        np.float32)).to(dev)
    s_cw = sc + 0.5
    inv_blk = torch.arange(40, device=dev).flip(0)
    alpha = torch.tensor(ALPHA, device=dev)
    ref = tail_cuda.tail_front(s_cw, sc, inv_blk, alpha, 4)

    def refuse(*args, **kwargs):
        raise AssertionError("the twin ran for a CUDA tensor")

    monkeypatch.setattr(tail_cuda, "tail_front_plain", refuse)
    assert torch.equal(tail_cuda.tail_front(s_cw, sc, inv_blk, alpha, 4),
                       ref)
    buf = torch.empty(s_cw.numel() + 1, device=dev)
    off = buf[1:].view(s_cw.shape).copy_(s_cw)        # 4 bytes off 16
    with pytest.raises(ValueError, match="16-byte"):
        tail_cuda.tail_front(off, sc, inv_blk, alpha, 4)
    with pytest.raises(ValueError, match="one alpha or one a plane"):
        tail_cuda.tail_front(s_cw, sc, inv_blk,
                             torch.full((8,), ALPHA, device=dev), 4)


# ---------------------------------------------------------------------------
# K6 (luma_f32, bgr_to_gray) and K7 (replace_luma): ops/color_cuda.py
# ---------------------------------------------------------------------------

COLOR_FNS = ["luma_f32", "bgr_to_gray", "replace_luma"]
COLOR_EDGES = [float("nan"), float("inf"), float("-inf"), -0.0, 254.99998,
               255.99998, 256.0, -1e-30, 1e30]


def _color_luma(shape, dev, seed):
    """Seeded Y' around the u8 range and past both ends, with the edge
    values in the first columns of every 512th row."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn(shape, generator=gen, device=dev) * 90 + 128
    y[..., ::512, :len(COLOR_EDGES)] = torch.tensor(COLOR_EDGES, device=dev)
    return y


def _color_frames(shape, dev, seed=SEED + 50):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, shape, generator=gen, device=dev,
                         dtype=torch.uint8)


def _color_check(fn, x, y=None):
    """The wrapper on CUDA tensors launches its kernel once and equals its
    twin run on the card."""
    wrapper = getattr(color_cuda, fn)
    twin = getattr(color_cuda, f"{fn}_plain")
    args = (y, x) if fn == "replace_luma" else (x,)
    n0 = wrapper.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1
    ref = twin(*args)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref)
    return got


@pytest.mark.parametrize("fn", COLOR_FNS)
def test_color_kernel_on_every_triple(dev, fn):
    """A 4096x4096 frame holding all 2^24 BGR triples (K7 with seeded Y'
    and the edge values: NaN, ±inf, −0.0, the truncation's edges)."""
    v = torch.arange(1 << 24, device=dev, dtype=torch.int32)
    x = torch.stack([v & 255, (v >> 8) & 255, v >> 16], -1).to(
        torch.uint8).reshape(4096, 4096, 3)
    _color_check(fn, x, _color_luma((4096, 4096), dev, SEED + 51))


@pytest.mark.parametrize("frames", [1, 4, 32])
@pytest.mark.parametrize("fn", COLOR_FNS)
def test_color_kernel_at_1080p(dev, fn, frames):
    x = _color_frames((frames, 1080, 1920, 3), dev)
    _color_check(fn, x, _color_luma(x.shape[:-1], dev, SEED + 52))


@pytest.mark.parametrize("fn", COLOR_FNS)
def test_color_kernel_at_8k(dev, fn):
    x = _color_frames((4320, 7680, 3), dev)
    _color_check(fn, x, _color_luma(x.shape[:-1], dev, SEED + 53))


@pytest.mark.parametrize("case", ["1079x1917", "pixel_offset"])
@pytest.mark.parametrize("fn", COLOR_FNS)
def test_color_kernel_scalar_path(dev, fn, case):
    """Frames of a pixel count that is not a multiple of 4, and a view
    that starts one pixel into a frame, take the scalar path."""
    if case == "1079x1917":
        x = _color_frames((2, 1079, 1917, 3), dev)
    else:
        flat = _color_frames((2 * 1080 * 1920 * 3 + 3,), dev)
        x = flat[3:].view(2, 1080, 1920, 3)
    y = _color_luma(x.shape[:-1], dev, SEED + 54)
    ptrs = ((y.data_ptr(), x.data_ptr(), 0) if fn == "replace_luma"
            else (x.data_ptr(), 0))
    assert not color_cuda.color_plan(fn, x.shape[-3] * x.shape[-2],
                                     *ptrs)[0]
    _color_check(fn, x, y)


@pytest.mark.parametrize("fn", COLOR_FNS)
def test_color_kernel_over_2_31_bytes(dev, fn):
    """350 1080p frames, 2.18e9 BGR bytes in one launch: equal to the twin
    run on the card in chunks of 35 frames."""
    x = _color_frames((350, 1080, 1920, 3), dev)
    y = (_color_luma(x.shape[:-1], dev, SEED + 55)
         if fn == "replace_luma" else None)
    wrapper = getattr(color_cuda, fn)
    twin = getattr(color_cuda, f"{fn}_plain")
    got = wrapper(y, x) if y is not None else wrapper(x)
    for a in range(0, 350, 35):
        ref = (twin(y[a:a + 35], x[a:a + 35]) if y is not None
               else twin(x[a:a + 35]))
        assert torch.equal(got[a:a + 35], ref)


def test_color_wrappers_never_run_the_twin_on_the_card(dev, monkeypatch):
    """CUDA tensors launch K6 and K7 (no twin is reached); mixed devices
    raise."""
    x = _color_frames((2, 64, 80, 3), dev)
    y = _color_luma(x.shape[:-1], dev, SEED + 56)
    refs = [color_cuda.luma_f32(x), color_cuda.bgr_to_gray(x),
            color_cuda.replace_luma(y, x)]

    def refuse(*args, **kwargs):
        raise AssertionError("a twin ran for a CUDA tensor")

    for fn in COLOR_FNS:
        monkeypatch.setattr(color_cuda, f"{fn}_plain", refuse)
    got = [color_cuda.luma_f32(x), color_cuda.bgr_to_gray(x),
           color_cuda.replace_luma(y, x)]
    assert all(torch.equal(a, b) for a, b in zip(got, refs))
    with pytest.raises(ValueError):
        color_cuda.replace_luma(y.cpu(), x)


def test_gray_paths_equal_with_color_twins(dev, monkeypatch):
    """The gray embed (with its metrics), extract and detect give the same
    stego, sc, metrics, extracted bytes and scores through K6 and K7 as
    with their twins run on the card in their place (4 frames at 1080p)."""
    covers = _color_frames((4, 1080, 1920, 3), dev, SEED + 57)
    wm = _color_frames((1080, 1920), dev, SEED + 58)
    key = crypto.derive_key("gpu-color", bytes(8))
    blk, intra = (torch.as_tensor(a, device=dev) for a in
                  crypto.block_permutation_indices(
                      key, tb.n_blocks_of(1080, 1920)))
    pw = tb.prepare_wm_gray(wm, blk, intra)

    def outputs():
        st, sc, ps, ss = tb.embed_gray_prepared(covers, pw.sw, ALPHA)
        rec = tb.extract_gray_prepared(st, sc, pw.ebasis, pw.inv_blk, ALPHA,
                                       sw=pw.sw)
        return [st, sc, ps, ss, rec, tb.detect_gray(st, sc, pw.sw, ALPHA)]

    counters = {fn: getattr(color_cuda, fn).launches for fn in COLOR_FNS}
    kernel = outputs()
    assert all(getattr(color_cuda, fn).launches > n
               for fn, n in counters.items())
    for fn in COLOR_FNS:
        plain = getattr(color_cuda, f"{fn}_plain")
        monkeypatch.setattr(color_cuda, fn, plain)
    twin = outputs()
    for a, b in zip(kernel, twin):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K9: the detect statistic
# ---------------------------------------------------------------------------

K9_SHAPES = {"1080p": (1080, 1920), "65x83": (65, 83), "64x80": (64, 80),
             "1x1": (8, 8), "2x3": (16, 24), "3x17": (24, 136)}


def _k9_inputs(dev, hw, frames, color_, seed=SEED, ratios=None):
    """Seeded spectra on the card: sw [(3,) N, 8] sorted descending per
    block, sc [frames, (3,) N, 8], and s_cw = sc + α·ŝ with ŝ = sw · ratio
    (0.6–1.1, or ``ratios`` [frames]) plus noise. Returns (s_cw, sc, sw,
    hb, wb)."""
    h, w = hw
    hb, wb = -(-h // 8), -(-w // 8)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cd = (3,) if color_ else ()
    sw = torch.sort(torch.rand((*cd, hb * wb, 8), generator=gen,
                               device=dev) * 40, dim=-1,
                    descending=True).values
    sc = torch.rand((frames, *cd, hb * wb, 8), generator=gen,
                    device=dev) * 200
    if ratios is None:
        ratios = 0.6 + 0.5 * torch.rand((frames,), generator=gen, device=dev)
    ratios = ratios.reshape(frames, *[1] * (sw.ndim))
    hat = sw * ratios + 4 * torch.randn(sc.shape, generator=gen, device=dev)
    return sc + ALPHA * hat, sc, sw, hb, wb


def _k9_equal(s_cw, sc, sw, hb, wb, k=4, **kw):
    """K9 once (its counter up by one), torch.equal to its twin run on the
    card; returns K9's output."""
    alpha = torch.full((), ALPHA, dtype=torch.float32, device=s_cw.device)
    n0 = detect_cuda.band_scores.launches
    got = detect_cuda.band_scores(s_cw, sc, sw, alpha, k, hb, wb, **kw)
    torch.cuda.synchronize()
    assert detect_cuda.band_scores.launches == n0 + 1
    ref = detect_cuda.band_scores_plain(s_cw, sc, sw, alpha, k, hb, wb, **kw)
    assert got.shape == ref.shape
    assert torch.equal(got, ref), float((got - ref).abs().max())
    return got


@pytest.mark.parametrize("frames", [1, 4, 32, 33, 128])
@pytest.mark.parametrize("layout", ["gray", "color"])
def test_k9_matches_twin_at_1080p(dev, layout, frames):
    """K9 equals its twin run on the card at 1080p on 1 to 128 frames, and
    a frame's score is the same alone and in the batch."""
    s_cw, sc, sw, hb, wb = _k9_inputs(dev, K9_SHAPES["1080p"], frames,
                                      layout == "color", SEED + frames)
    got = _k9_equal(s_cw, sc, sw, hb, wb)
    assert got.shape == (frames,) and float(got.min()) > 0.3
    for i in {0, frames // 2, frames - 1}:
        assert torch.equal(_k9_equal(s_cw[i:i + 1], sc[i:i + 1], sw, hb, wb),
                           got[i:i + 1])


@pytest.mark.parametrize("grid", [4, 2])
@pytest.mark.parametrize("shape", list(K9_SHAPES))
@pytest.mark.parametrize("layout", ["gray", "color"])
def test_k9_matches_twin_at_each_grid(dev, layout, shape, grid):
    """K9's frame scores and band scores (reduce=False) equal its twin's at
    1080p, an unaligned and an aligned small frame and tiny block grids
    (1x1, 2x3, 3x17: g < 4, down to one block a band), at grid 4 and 2."""
    s_cw, sc, sw, hb, wb = _k9_inputs(dev, K9_SHAPES[shape], 4,
                                      layout == "color", SEED + grid)
    _k9_equal(s_cw, sc, sw, hb, wb, grid=grid)
    g = max(1, min(grid, hb, wb))
    bands = _k9_equal(s_cw, sc, sw, hb, wb, grid=grid, reduce=False)
    assert bands.shape == (*s_cw.shape[:-2], g * g)


@pytest.mark.parametrize("layout", ["gray", "color"])
def test_k9_shared_sc_and_clean_host(dev, layout):
    """A shared sc [(3,) N, 8] (the resync chunks': frame stride 0) gives
    the scores of the same sc repeated per frame; a clean host (s_cw = sc)
    scores exactly 0."""
    s_cw, sc, sw, hb, wb = _k9_inputs(dev, K9_SHAPES["1080p"], 8,
                                      layout == "color", SEED + 71)
    shared = sc[0]
    got = _k9_equal(s_cw, shared, sw, hb, wb)
    assert torch.equal(got, _k9_equal(
        s_cw, shared.expand(sc.shape).contiguous(), sw, hb, wb))
    clean = _k9_equal(sc, sc, sw, hb, wb)
    assert not bool(clean.any())
    assert not bool(_k9_equal(sc, sc, sw, hb, wb, reduce=False).any())


@pytest.mark.parametrize("layout", ["gray", "color"])
def test_k9_over_the_scale_damps_range(dev, layout):
    """33 frames whose estimate is sw scaled by r = 0.5 .. 8 (the scale
    damp's whole range, log2 through libdevice in both): K9 equals its
    twin, and the scores fall as r grows past ~1.3."""
    ratios = torch.logspace(math.log10(0.5), math.log10(8.0), 33,
                            device=dev)
    s_cw, sc, sw, hb, wb = _k9_inputs(dev, K9_SHAPES["1080p"], 33,
                                      layout == "color", SEED + 72,
                                      ratios=ratios)
    got = _k9_equal(s_cw, sc, sw, hb, wb)
    assert float(got[-1]) < 0.1 < 0.5 < float(got[:8].min())
    _k9_equal(s_cw, sc, sw, hb, wb, reduce=False)


@pytest.mark.parametrize("k", list(range(1, 9)))
def test_k9_at_every_k(dev, k):
    """Each of K9's eight instances equals its twin (color, 65x83)."""
    s_cw, sc, sw, hb, wb = _k9_inputs(dev, K9_SHAPES["65x83"], 3, True,
                                      SEED + k)
    _k9_equal(s_cw, sc, sw, hb, wb, k=k)
    _k9_equal(s_cw, sc, sw, hb, wb, k=k, reduce=False)


def test_k9_wrapper_never_runs_the_twin_on_the_card(dev, monkeypatch):
    """A CUDA tensor launches K9 (the twin is not reached); mixed devices
    and a k outside 1..8 raise."""
    s_cw, sc, sw, hb, wb = _k9_inputs(dev, K9_SHAPES["64x80"], 2, False)
    alpha = torch.full((), ALPHA, device=dev)
    ref = detect_cuda.band_scores(s_cw, sc, sw, alpha, 4, hb, wb)

    def refuse(*args, **kwargs):
        raise AssertionError("the twin ran for a CUDA tensor")

    monkeypatch.setattr(detect_cuda, "band_scores_plain", refuse)
    strided = s_cw.transpose(0, 1).contiguous().transpose(0, 1)
    assert torch.equal(detect_cuda.band_scores(strided, sc, sw, alpha, 4, hb,
                                               wb), ref)
    with pytest.raises(ValueError, match="devices"):
        detect_cuda.band_scores(s_cw, sc.cpu(), sw, alpha, 4, hb, wb)
    with pytest.raises(ValueError, match="k must"):
        detect_cuda.band_scores(s_cw, sc, sw, alpha, 9, hb, wb)


@pytest.mark.parametrize("path", ["gray", "color"])
def test_detect_paths_take_k9_at_1080p(dev, path, monkeypatch):
    """detect_gray / detect_color at 1080p on 4 frames launch K9 once and
    give the scores of K9's twin in its place; the resync chunk launches
    it once too."""
    covers = _color_frames((4, 1080, 1920, 3), dev, SEED + 73)
    wm = _color_frames((1080, 1920, 3), dev, SEED + 74)
    key = crypto.derive_key("gpu-detect", bytes(8))
    blk, intra = (torch.as_tensor(a, device=dev) for a in
                  crypto.block_permutation_indices(
                      key, tb.n_blocks_of(1080, 1920)))
    if path == "gray":
        pw = tb.prepare_wm_gray(color.bgr_to_gray(wm), blk, intra,
                                extract_basis=False)
        st, sc = tb.embed_gray_prepared(covers, pw.sw, ALPHA,
                                        with_metrics=False)[:2]
        detect, img = tb.detect_gray, color.luma_f32(st[0])
    else:
        pw = tb.prepare_wm_color(wm, blk, intra, extract_basis=False)
        st, sc = tb.embed_color_prepared(covers, pw.sw, ALPHA,
                                         with_metrics=False)[:2]
        detect, img = tb.detect_color, st[0]
    shifts = torch.as_tensor([[0, 0], [3, -5], [1, 1]], device=dev)
    k9 = detect_cuda.band_scores

    def run():
        n0 = k9.launches
        scores = detect(st, sc, pw.sw, ALPHA)
        chunk = tb._detect_shift_chunk(img, sc[0], pw.sw, ALPHA, shifts,
                                       color_frames=path == "color")
        torch.cuda.synchronize()
        return scores, chunk, k9.launches - n0

    scores, chunk, n = run()
    assert n == 2 and float(scores.min()) > 0.3
    assert float(chunk[0]) > 0.3 > float(chunk[1])
    monkeypatch.setattr(detect_cuda, "band_scores",
                        detect_cuda.band_scores_plain)
    twin_scores, twin_chunk, _ = run()
    assert torch.equal(scores, twin_scores)
    assert torch.equal(chunk, twin_chunk)


def _k9_planned(monkeypatch):
    """Records each plan K9's wrapper takes (vector, resident, rows)."""
    plans = []
    orig = detect_cuda.band_plan

    def record(*args):
        plans.append(orig(*args))
        return plans[-1]

    monkeypatch.setattr(detect_cuda, "band_plan", record)
    return plans


def _unaligned(t):
    """A copy of ``t`` whose data starts 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    base = (-flat.data_ptr() % 16) // 4 + 1
    out = flat[base:base + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("layout", ["gray", "color"])
@pytest.mark.parametrize("blocks", [2048, 2049])
def test_k9_at_the_resident_edge(dev, blocks, layout, monkeypatch):
    """Bands of 256 · RESIDENT_ROWS blocks (hb 64, wb 128, grid 2) are read
    once, with each thread's rows in registers; one block more (hb 6, wb
    1366, grid 2: 2,049 a band) reads the band again. Both equal the
    twin."""
    hw = (64 * 8, 128 * 8) if blocks == 2048 else (6 * 8, 1366 * 8)
    s_cw, sc, sw, hb, wb = _k9_inputs(dev, hw, 3, layout == "color",
                                      SEED + blocks)
    assert (hb // 2) * (wb // 2) == blocks
    plans = _k9_planned(monkeypatch)
    _k9_equal(s_cw, sc, sw, hb, wb, grid=2)
    _k9_equal(s_cw, sc, sw, hb, wb, grid=2, reduce=False)
    resident = blocks <= 256 * detect_cuda.RESIDENT_ROWS
    assert plans == [(True, resident, -(-blocks // 256))] * 2


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["vector", "scalar"])
@pytest.mark.parametrize("k", list(range(1, 9)))
def test_k9_both_load_instances_at_every_k(dev, k, aligned, monkeypatch):
    """Each k on the vector instance (16-byte row loads) and on the scalar
    one (s_cw and sw 4 bytes past a 16-byte boundary), on a resident band
    (65x83) and a re-read one (hb 6, wb 1366, grid 2): equal to the twin."""
    plans = _k9_planned(monkeypatch)
    for hw, grid in (((65, 83), 4), ((6 * 8, 1366 * 8), 2)):
        s_cw, sc, sw, hb, wb = _k9_inputs(dev, hw, 2, True, SEED + 90 + k)
        if not aligned:
            s_cw, sw = _unaligned(s_cw), _unaligned(sw)
        _k9_equal(s_cw, sc, sw, hb, wb, k=k, grid=grid)
        _k9_equal(s_cw, sc, sw, hb, wb, k=k, grid=grid, reduce=False)
    assert [p[:2] for p in plans] == [(aligned, True)] * 2 + [
        (aligned, False)] * 2


@pytest.mark.parametrize("layout", ["gray", "color"])
def test_k9_unaligned_view_takes_the_scalar_instance(dev, layout,
                                                     monkeypatch):
    """An sc view 4 bytes off its 16-byte boundary at 1080p takes the
    scalar instance and gives the vector instance's scores."""
    s_cw, sc, sw, hb, wb = _k9_inputs(dev, K9_SHAPES["1080p"], 4,
                                      layout == "color", SEED + 93)
    plans = _k9_planned(monkeypatch)
    got = _k9_equal(s_cw, sc, sw, hb, wb)
    assert torch.equal(_k9_equal(s_cw, _unaligned(sc), sw, hb, wb), got)
    assert plans == [(True, True, 8), (False, True, 8)]


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["vector", "scalar"])
def test_k9_sc_with_frame_stride_0(dev, aligned, monkeypatch):
    """One sc [(3,) N, 8] for every frame (the kernel reads it at frame
    stride 0), on both load instances: equal to the twin and to that sc
    repeated per frame."""
    s_cw, sc, sw, hb, wb = _k9_inputs(dev, K9_SHAPES["1080p"], 6, True,
                                      SEED + 94)
    shared = sc[0] if aligned else _unaligned(sc[0])
    plans = _k9_planned(monkeypatch)
    got = _k9_equal(s_cw, shared, sw, hb, wb)
    assert torch.equal(got, _k9_equal(
        s_cw, shared.expand(sc.shape).contiguous(), sw, hb, wb))
    assert plans[0] == (aligned, True, 8)


def test_k9_8k_shard_band_takes_the_reread_path(dev, monkeypatch):
    """An 8K plane shard (1080 × 7680, parallel/plane.py's grid 2: 32,160
    blocks a band) and a 4K frame (8,040) read their bands twice: equal
    to the twin."""
    plans = _k9_planned(monkeypatch)
    for hw, grid in (((1080, 7680), 2), ((2160, 3840), 4)):
        s_cw, sc, sw, hb, wb = _k9_inputs(dev, hw, 2, False, SEED + 95)
        _k9_equal(s_cw, sc, sw, hb, wb, grid=grid)
        _k9_equal(s_cw, sc, sw, hb, wb, grid=grid, reduce=False)
    assert plans == [(True, False, 126)] * 2 + [(True, False, 32)] * 2


# ---------------------------------------------------------------------------
# K10 and K11: the enhancement chain's NLM and CLAHE
# ---------------------------------------------------------------------------

# planes [P, H, W] and their h² (gray 49; a color frame's YCrCb planes 9)
K10_SHAPES = {"1080p_gray": ((1, 1080, 1920), (49.0,)),
              "1080p_ycrcb": ((3, 1080, 1920), (9.0,) * 3),
              "1x1": ((1, 1, 1), (49.0,)), "7x9": ((1, 7, 9), (49.0,)),
              "12x11": ((2, 12, 11), (49.0, 9.0)),
              "37x51": ((3, 37, 51), (9.0,) * 3)}
# the edges of K10's tiling: heights and widths below the 7-pixel
# template (2, 3, 4, 6), one below, at and one above the tile's width and
# height and the run a thread sums down a column, several tiles; and a
# 0/255 checkerboard, whose window sums reach 49 · 255²
_TW, _TH = enhance_cuda.NLM_TILE
_T = enhance_cuda.NLM_RUN
K10_SHAPES.update({
    "2x3": ((1, 2, 3), (49.0,)), "3x2": ((1, 3, 2), (9.0,)),
    "4x6": ((2, 4, 6), (49.0, 9.0)), "6x4": ((1, 6, 4), (49.0,)),
    "6x2": ((1, 6, 2), (9.0,)),
    **{f"{h}x{w}": ((2, h, w), (49.0, 9.0))
       for h, w in ((_TH - 1, _TW - 1), (_TH, _TW), (_TH + 1, _TW + 1),
                    (_T - 1, _T + 1), (_T, _T), (_T + 1, _T - 1),
                    (2 * _TH + 1, 3 * _TW - 1))},
    "checker_40x52": ((2, 40, 52), (49.0, 9.0)),
    # h² other than the chains' 9 and 49, of all-ones significands
    "37x51_h2_ones": ((2, 37, 51), (float.fromhex("0x1.fffffep4"),
                                    float.fromhex("0x1.fffffep0"))),
    f"checker_{2 * _TH + 1}x{2 * _TW + 1}": ((1, 2 * _TH + 1, 2 * _TW + 1),
                                             (49.0,))})
K11_SHAPES = {"1080p_gray": (1, 1080, 1920), "1080p_luma": None,
              "37x51": (1, 37, 51), "3x40x52": (3, 40, 52),
              "1x1": (1, 1, 1)}


def _enh_planes(dev, shape, seed):
    """Seeded u8 planes on the card: noise smoothed by a 3×3 mean, so NLM
    finds similar patches."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 256, shape, generator=gen, device=dev,
                      dtype=torch.uint8).to(torch.float32)
    x = torch.nn.functional.avg_pool2d(x[None], 3, 1, 1,
                                       count_include_pad=False)[0]
    return torch.round(x).to(torch.uint8).contiguous()


@pytest.mark.parametrize("shape", list(K10_SHAPES))
def test_k10_matches_twin(dev, shape):
    """K10 equals its twin run on the card (torch.equal) at 1080p (a gray
    plane, a frame's three YCrCb planes), on planes smaller than its
    21-pixel window and its 7-pixel template, at the edges of its tiles
    and runs, and on a 0/255 checkerboard, in one launch."""
    dims, h2 = K10_SHAPES[shape]
    if shape.startswith("checker"):
        y, x_ = torch.meshgrid(torch.arange(dims[1], device=dev),
                               torch.arange(dims[2], device=dev),
                               indexing="ij")
        x = (((y + x_) % 2) * 255).to(torch.uint8).expand(dims).contiguous()
    else:
        x = _enh_planes(dev, dims, SEED + 80)
    h2 = torch.tensor(h2, device=dev)
    n0 = enhance_cuda.nlm_planes.launches
    got = enhance_cuda.nlm_planes(x, h2)
    torch.cuda.synchronize()
    assert enhance_cuda.nlm_planes.launches == n0 + 1
    ref = e_ops.nlm_planes_plain(x, h2)
    assert torch.equal(got, ref), int((got.int() - ref.int()).abs().max())


@pytest.mark.parametrize("h2", [9.0, 49.0])
def test_k10_weights_are_torch_exp(dev, h2):
    """K10's weight function equals the twin's torch.exp(−((n/49)/h²)) on
    the card for every window sum n in [0, 49 · 255²]; the weights are
    non-increasing in n and +0.0 from the first zero D0 on, so K10's skip
    past its cutoff (the bisection's D0) adds only zeros."""
    n = enhance_cuda.MAX_WINDOW_SUM + 1
    h2t = torch.full((), h2, device=dev)
    got = enhance_cuda.nlm_weights(n, h2t)
    ref = e_ops.nlm_weights_plain(
        torch.arange(n, dtype=torch.float32, device=dev), h2t)
    bad = int((got != ref).sum())
    assert bad == 0 and float(got[0]) == 1.0 and float(got[-1]) == 0.0
    assert bool((got[1:] <= got[:-1]).all())
    d0 = int(torch.nonzero(got == 0)[0])
    assert not bool(got[d0:].any()) and float(got[d0 - 1]) > 0.0


# h² other than the chains' 9 and 49: significands of all ones or near
# them, a power of two, and far from 1
K10_OTHER_H2 = [float.fromhex("0x1.fffffep0"), float.fromhex("0x1.fffffep4"),
                float.fromhex("0x1.000002p3"), 12.25, 0.5, 1e-3, 1e20,
                1e-35, 1e35]


@pytest.mark.parametrize("h2", K10_OTHER_H2, ids=str)
def test_k10_weights_equal_the_twin_at_other_h2(dev, h2):
    """At other h² too K10's weights equal the twin's for every window
    sum (two IEEE divisions and libdevice's expf, as torch's)."""
    n = enhance_cuda.MAX_WINDOW_SUM + 1
    h2t = torch.full((), h2, device=dev)
    got = enhance_cuda.nlm_weights(n, h2t)
    ref = e_ops.nlm_weights_plain(
        torch.arange(n, dtype=torch.float32, device=dev), h2t)
    assert int((got != ref).sum()) == 0


@pytest.mark.parametrize("shape", list(K11_SHAPES))
def test_k11_matches_twin(dev, shape):
    """Both CLAHE kernels equal their twins run on the card (torch.equal):
    the LUTs, the interpolation (on the twin's LUTs) and clahe_u8, on a
    1080p gray plane, a 1080p color frame's luma plane and small planes."""
    dims = K11_SHAPES[shape]
    if dims is None:
        frame = torch.from_numpy(_frames((1080, 1920, 3), SEED + 81)).to(dev)
        x = color.luma_f32(frame).to(torch.uint8)[None]
    else:
        x = _enh_planes(dev, dims, SEED + 82)
    n0 = (enhance_cuda.clahe_luts.launches, enhance_cuda.clahe_apply.launches)
    luts = enhance_cuda.clahe_luts(x)
    ref = e_ops.clahe_luts_plain(x)
    assert torch.equal(luts, ref)
    assert torch.equal(enhance_cuda.clahe_apply(x, ref),
                       e_ops.clahe_apply_plain(x, ref))
    assert torch.equal(e_ops.clahe_u8(x), e_ops.clahe_apply_plain(x, ref))
    torch.cuda.synchronize()
    assert (enhance_cuda.clahe_luts.launches - n0[0],
            enhance_cuda.clahe_apply.launches - n0[1]) == (2, 2)


# K11 at its edges: every count in one bin (the largest excess), tiles of
# rows past the plane (th 136: not a multiple of the 28-row strip), a tile
# width not a multiple of the 16-byte run (tw 242), a view off its 16-byte
# alignment, a 4K plane; tile grids whose staged LUT rows fill the default
# 48 KB of shared memory (64 tiles: 3 rows of 16 KB) and pass it by the
# interpolation's opt-in (65 tiles; 255, the most the kernels take:
# 195,840 bytes)
K11_EDGES = ["single_valued", "1081x1920", "1080x1936", "offset", "4k",
             "tiles64", "tiles65", "tiles255"]


@pytest.mark.parametrize("case", K11_EDGES)
def test_k11_edges_match_twin(dev, case):
    """Both K11 kernels, alone and in one call (enhance_cuda.clahe), equal
    their twins run on the card (torch.equal) at their edges."""
    dims = {"1081x1920": (1, 1081, 1920), "1080x1936": (1, 1080, 1936),
            "4k": (1, 2160, 3840)}.get(case, (1, 1080, 1920))
    tiles = int(case[5:]) if case.startswith("tiles") else 8
    x = _enh_planes(dev, dims, SEED + 86)
    if case == "single_valued":
        x = torch.full_like(x, 131)
    elif case == "offset":
        x = _offset(x)
    ref = e_ops.clahe_luts_plain(x, tiles)
    out = e_ops.clahe_apply_plain(x, ref, tiles)
    assert torch.equal(enhance_cuda.clahe_luts(x, tiles), ref)
    assert torch.equal(enhance_cuda.clahe_apply(x, ref, tiles), out)
    assert torch.equal(enhance_cuda.clahe(x, tiles), out)


def test_k11_successive_calls_leave_the_scratch_clean(dev):
    """K11's LUT stage leaves its scratch (histograms, tickets) zero for
    the next call: successive calls on different planes, and on batches
    of other sizes, each equal the twins."""
    planes = [_enh_planes(dev, (1, 1080, 1920), SEED + 87 + i)
              for i in range(2)]
    planes += [_enh_planes(dev, (3, 40, 52), SEED + 89),
               torch.full((1, 1080, 1920), 7, dtype=torch.uint8,
                          device=dev), planes[0]]
    for x in planes:
        assert torch.equal(enhance_cuda.clahe(x), e_ops.clahe_plain(x))
        assert torch.equal(enhance_cuda.clahe_luts(x),
                           e_ops.clahe_luts_plain(x))


def test_clahe_u8_launches_each_k11_kernel_once_in_one_call(dev):
    """clahe_u8 on a 1080p plane makes one host call (enhance_cuda.clahe),
    which launches each K11 kernel once; the LUT stage's grid has at
    least two CTAs an SM of the card."""
    x = _enh_planes(dev, (1080, 1920), SEED + 90)
    wrappers = (enhance_cuda.clahe, enhance_cuda.clahe_luts,
                enhance_cuda.clahe_apply)
    n0 = [w.launches for w in wrappers]
    got = e_ops.clahe_u8(x)
    torch.cuda.synchronize()
    assert [w.launches - n for w, n in zip(wrappers, n0)] == [1, 1, 1]
    assert torch.equal(got, e_ops.clahe_plain(x[None])[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = enhance_cuda.clahe_plan(1, 1080, 1920, 8, sms)
    assert 64 * plan.strips >= 2 * sms


def test_enhance_wrappers_never_run_the_twins_on_the_card(dev, monkeypatch):
    """CUDA tensors launch K10 and K11 through both chains (the twins are
    not reached); mixed devices and a template or search window the
    kernel does not take raise."""
    plane = _enh_planes(dev, (40, 52), SEED + 83)
    frame = torch.stack([plane, plane.flip(0), plane.flip(1)], -1)
    ref = (tenh.enhance_gray_u8(plane), tenh.enhance_color_u8(frame))

    def refuse(*args, **kwargs):
        raise AssertionError("a twin ran for a CUDA tensor")

    for name in ("nlm_planes_plain", "clahe_luts_plain", "clahe_apply_plain"):
        monkeypatch.setattr(enhance_cuda, name, refuse)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(tenh.enhance_gray_u8(plane), ref[0])
        assert torch.equal(tenh.enhance_color_u8(frame), ref[1])
    h2 = torch.full((1,), 49.0, device=dev)
    with pytest.raises(ValueError, match="devices"):
        enhance_cuda.nlm_planes(plane[None], h2.cpu())
    with pytest.raises(ValueError, match="template"):
        enhance_cuda.nlm_planes(plane[None], h2, 5, 21)


@pytest.mark.parametrize("color_", [False, True], ids=["gray", "color"])
def test_extract_at_1080p_launches_k10_and_k11_once(dev, tmp_path, color_):
    """api.extract with the enhancement chain on a 1080p blocked stego
    launches K10 once (gray: one plane; color: the three YCrCb planes in
    one batch) and each CLAHE kernel once, and writes the watermark."""
    import cv2
    from dctsvd_tpu_torch import api
    from dctsvd_tpu_torch.io import image_io
    cp, wp = str(tmp_path / "cover.png"), str(tmp_path / "wm.png")
    image_io.write_png(cp, _frames((1080, 1920, 3), SEED + 84))
    image_io.write_png(wp, _frames((270, 480, 3), SEED + 85))
    out, meta, _, _ = api.embed(cp, wp, str(tmp_path / "s.png"),
                                str(tmp_path / "m.npz"), alpha=ALPHA,
                                color=color_, password="pw",
                                method="blocked", device=dev)
    torch.cuda.synchronize()
    kernels_ = (enhance_cuda.nlm_planes, enhance_cuda.clahe_luts,
                enhance_cuda.clahe_apply)
    for k in kernels_:
        k.launches = 0
    wm = api.extract(out, meta, str(tmp_path / "x.png"), password="pw",
                     device=dev)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels_] == [1, 1, 1]
    got = cv2.imread(wm, cv2.IMREAD_UNCHANGED)
    assert got.shape[:2] == (1080, 1920)


# K14-K17: unsharp, SSIM, PSNR's sums and the color NLM's YCrCb pair
METRIC_SHAPES = {"1080p": (1080, 1920), "4k": (2160, 3840), "3x5": (3, 5),
                 "37x51": (37, 51), "1x1": (1, 1)}


def _offset(x: torch.Tensor) -> torch.Tensor:
    """x's values in a view that starts one element past a 16-byte
    boundary."""
    flat = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    view = flat[1:1 + x.numel()]
    view.copy_(x.reshape(-1))
    return view.view(x.shape)


def _bgr(shape, dev, seed):
    return torch.from_numpy(_frames(shape, seed)).to(dev)


def _launched(wrapper, fn):
    """fn()'s result, asserting that it launched ``wrapper`` once."""
    n0 = wrapper.launches
    out = fn()
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1
    return out


@pytest.mark.parametrize("layout", ["planes", "frames"])
@pytest.mark.parametrize("shape", list(METRIC_SHAPES) + ["offset"])
def test_k14_matches_twin(dev, shape, layout):
    """K14 equals its twin run on the card (torch.equal): u8 planes and BGR
    frames channels-last (each channel its own plane), at both chains'
    weights."""
    h, w = METRIC_SHAPES.get(shape, (37, 51))
    dims = {"planes": (2, h, w), "frames": (h, w, 3)}[layout]
    x = _enh_planes(dev, dims, SEED + 90) if layout == "planes" else \
        _bgr(dims, dev, SEED + 90)
    if shape == "offset":
        x = _offset(x)
    cl = layout != "planes"
    for amount, weight in ((1.25, -0.25), (1.15, -0.15)):
        got = _launched(enhance_cuda.unsharp, lambda: enhance_cuda.unsharp(
            x, amount, weight, 1.0, cl))
        assert torch.equal(got, e_ops.unsharp_plain(x, amount, weight, 1.0,
                                                    cl))


# K14 across its column blocks and walks (64 columns a block, 2 blocks a
# walk) at widths that are not a multiple of either, and a band of rows
# past the plane
K14_WALKS = {"37x1000": (37, 1000), "70x333": (70, 333), "33x130": (33, 130),
             "1080x1000": (1080, 1000)}


@pytest.mark.parametrize("layout", ["planes", "frames"])
@pytest.mark.parametrize("shape", list(K14_WALKS))
def test_k14_walks_match_twin(dev, shape, layout):
    """K14 equals its twin run on the card (torch.equal) where its CTAs
    walk several column blocks and carry their columns, planes and BGR
    frames channels-last, and off its 16-byte alignment."""
    h, w = K14_WALKS[shape]
    dims = {"planes": (2, h, w), "frames": (h, w, 3)}[layout]
    x = _enh_planes(dev, dims, SEED + 91) if layout == "planes" else \
        _bgr(dims, dev, SEED + 91)
    cl = layout != "planes"
    for xi in (x, _offset(x)):
        got = _launched(enhance_cuda.unsharp, lambda: enhance_cuda.unsharp(
            xi, 1.15, -0.15, 1.0, cl))
        assert torch.equal(got, e_ops.unsharp_plain(xi, 1.15, -0.15, 1.0,
                                                    cl))


@pytest.mark.parametrize("call", ["unsharp_sigma", "unsharp_channels",
                                  "ssim", "psnr"])
def test_kernels_raise_for_what_they_do_not_take(dev, call):
    """A CUDA tensor the kernel does not take raises ValueError and
    launches nothing, never a plain form on the card: K14 at another σ or
    channel count, K15 and K16 on other dtypes."""
    x = _enh_planes(dev, (2, 37, 51), SEED + 99)
    f = x.to(torch.float32)
    wrapper, fn = {
        "unsharp_sigma": (enhance_cuda.unsharp, lambda: enhance_cuda.unsharp(
            x, 1.25, -0.25, 1.5)),
        "unsharp_channels": (enhance_cuda.unsharp,
                             lambda: enhance_cuda.unsharp(
                                 _bgr((37, 51, 4), dev, SEED + 99), 1.15,
                                 -0.15, 1.0, True)),
        "ssim": (metrics_cuda.ssim, lambda: metrics_cuda.ssim(f, f)),
        "psnr": (metrics_cuda.psnr, lambda: metrics_cuda.psnr(f, x)),
    }[call]
    n0 = wrapper.launches
    with pytest.raises(ValueError, match="the kernel takes"):
        fn()
    assert wrapper.launches == n0


@pytest.mark.parametrize("pair", ["u8", "f32"])
@pytest.mark.parametrize("shape", list(METRIC_SHAPES) + ["offset", "batch"])
def test_k15_matches_twin(dev, shape, pair):
    """K15 equals its twin run on the card (torch.equal): the map's f32 ops
    and the fixed-order mean, (u8, u8) and (u8, f32), in one launch for a
    batch of 32 1080p planes."""
    h, w = METRIC_SHAPES.get(shape, (1080, 1920))
    p = 32 if shape == "batch" else 2
    x = _enh_planes(dev, (p, h, w), SEED + 91)
    gen = torch.Generator(device=dev).manual_seed(SEED + 92)
    noise = torch.randn((p, h, w), generator=gen, device=dev) * 4
    y = x.to(torch.float32) + noise
    if pair == "u8":
        y = torch.round(y).clamp(0, 255).to(torch.uint8)
    if shape == "offset":
        x, y = _offset(x), _offset(y)
    got = _launched(metrics_cuda.ssim, lambda: metrics_cuda.ssim(x, y))
    assert torch.equal(got, metrics_cuda.ssim_plain(x, y))
    assert bool(((got > 0.5) & (got <= 1.0)).all())


# K15's CTA covers two 32-column sum tiles: widths of an odd tile count,
# a CTA's last tile past the plane, planes narrower than a tile
K15_EDGE_SHAPES = [(32, 64), (33, 65), (70, 33), (100, 7), (6, 200),
                   (31, 97)]


@pytest.mark.parametrize("pair", ["u8", "f32"])
@pytest.mark.parametrize("shape", K15_EDGE_SHAPES,
                         ids=[f"{h}x{w}" for h, w in K15_EDGE_SHAPES])
def test_k15_at_the_edges_of_its_tiles(dev, shape, pair):
    """K15 equals its twin run on the card at the edges of its CTAs' two
    sum tiles."""
    x = _enh_planes(dev, (2, *shape), SEED + 96)
    gen = torch.Generator(device=dev).manual_seed(SEED + 97)
    y = x.to(torch.float32) + torch.randn((2, *shape), generator=gen,
                                          device=dev) * 4
    if pair == "u8":
        y = torch.round(y).clamp(0, 255).to(torch.uint8)
    got = _launched(metrics_cuda.ssim, lambda: metrics_cuda.ssim(x, y))
    assert torch.equal(got, metrics_cuda.ssim_plain(x, y))


@pytest.mark.parametrize("shape", list(METRIC_SHAPES) + ["offset", "batch",
                                                         "planes"])
def test_k16_matches_twin(dev, shape):
    """K16's exact sums equal the twin's f64 sums on the card (torch.equal
    of the PSNR), on 16-byte loads and on the byte path, and equal frames
    give 99.0."""
    h, w = METRIC_SHAPES.get(shape, (1080, 1920))
    dims = {"batch": (32, h, w, 3), "planes": (4, h, w)}.get(shape,
                                                            (2, h, w, 3))
    a, b = _bgr(dims, dev, SEED + 93), _bgr(dims, dev, SEED + 94)
    if shape == "offset":
        a, b = _offset(a), _offset(b)
        assert not metrics_cuda.psnr_plan(a[0].numel(), a.data_ptr(),
                                          b.data_ptr())
    got = _launched(metrics_cuda.psnr, lambda: metrics_cuda.psnr(a, b))
    assert torch.equal(got, metrics_cuda.psnr_plain(a, b))
    assert bool((metrics_cuda.psnr(a, a) == 99.0).all())


@pytest.mark.parametrize("shape", list(METRIC_SHAPES) + ["offset", "triples"])
def test_k17_matches_twin(dev, shape):
    """K17 equals its twins run on the card (torch.equal) both ways: every
    BGR triple, 1080p and 4K frames, planes of a pixel count not a multiple
    of 4 and a view off its alignment (the scalar path)."""
    if shape == "triples":
        v = torch.arange(1 << 24, device=dev, dtype=torch.int32)
        x = torch.stack([v & 255, (v >> 8) & 255, v >> 16], -1).to(
            torch.uint8).reshape(4096, 4096, 3)
    else:
        x = _bgr((2, *METRIC_SHAPES.get(shape, (37, 51)), 3), dev,
                 SEED + 95)
        if shape == "offset":
            x = _offset(x)
    planes = _launched(color_cuda.bgr_to_ycrcb_planes,
                       lambda: color_cuda.bgr_to_ycrcb_planes(x))
    assert torch.equal(planes, color.bgr_to_ycrcb_planes_plain(x))
    if shape == "offset":
        planes = _offset(planes)
    back = _launched(color_cuda.ycrcb_planes_to_bgr,
                     lambda: color_cuda.ycrcb_planes_to_bgr(planes))
    assert torch.equal(back, color.ycrcb_planes_to_bgr_plain(planes))


def _no_eager_blur(monkeypatch):
    """Make the eager blur and the twins' maps raise: a kernel path that
    reached them fails."""
    def refuse(*args, **kwargs):
        raise AssertionError("the eager blur ran for a CUDA tensor")
    for mod, name in ((e_ops, "gaussian_blur"), (metrics_cuda, "ssim_map"),
                      (e_ops, "unsharp_plain"),
                      (enhance_cuda, "unsharp_plain"),
                      (color, "bgr_to_ycrcb"), (color, "ycrcb_to_bgr")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("scheme", ["gray", "color"])
def test_embed_with_metrics_launches_k15_and_k16(dev, scheme, monkeypatch):
    """An embed with metrics on 1080p frames launches K15 and K16 once each
    and never the eager blur; its PSNR and SSIM equal the twins' on the
    card."""
    frames = _bgr((2, 1080, 1920, 3), dev, SEED + 96)
    wm = _bgr((1080, 1920, 3), dev, SEED + 97)
    key = crypto.derive_key("pw", bytes(8))
    blk, intra = (torch.as_tensor(a, device=dev) for a in
                  crypto.block_permutation_indices(
                      key, tb.n_blocks_of(1080, 1920)))
    if scheme == "gray":
        pw = tb.prepare_wm_gray(color.bgr_to_gray(wm), blk, intra)
        embed = tb.embed_gray_prepared
    else:
        pw = tb.prepare_wm_color(wm, blk, intra)
        embed = tb.embed_color_prepared
    stego, _, ps_ref, ss_ref = embed(frames, pw.sw, ALPHA)
    _no_eager_blur(monkeypatch)
    torch.cuda.synchronize()
    for k in (metrics_cuda.ssim, metrics_cuda.psnr):
        k.launches = 0
    stego2, _, ps, ss = embed(frames, pw.sw, ALPHA)
    torch.cuda.synchronize()
    assert (metrics_cuda.ssim.launches, metrics_cuda.psnr.launches) == (1, 1)
    assert torch.equal(stego, stego2)
    assert torch.equal(ps, ps_ref) and torch.equal(ss, ss_ref)
    monkeypatch.undo()
    assert torch.equal(ps, metrics_cuda.psnr_plain(frames, stego))
    assert bool((ps > 20).all()) and bool((ss > 0.5).all())


@pytest.mark.parametrize("color_", [False, True], ids=["gray", "color"])
def test_chains_launch_k14_and_k17(dev, color_, monkeypatch):
    """Each enhancement chain on a 1080p watermark launches K14 once (and
    the color chain K17 once each way), never the eager blur or YCrCb
    chain, and gives the bytes of the chain with those stages' twins."""
    x = _bgr((1080, 1920, 3), dev, SEED + 98)
    if not color_:
        x = color.bgr_to_gray(x)
    chain = tenh.enhance_color_u8 if color_ else tenh.enhance_gray_u8
    kern = (enhance_cuda.unsharp, color_cuda.bgr_to_ycrcb_planes,
            color_cuda.ycrcb_planes_to_bgr)
    for k in kern:
        k.launches = 0
    saved = {n: getattr(color_cuda, n) for n in ("bgr_to_ycrcb_planes",
                                                 "ycrcb_planes_to_bgr")}
    with monkeypatch.context() as m:
        _no_eager_blur(m)
        got = chain(x)
        torch.cuda.synchronize()
    assert [k.launches for k in kern] == [1] + [int(color_)] * 2
    with monkeypatch.context() as m:
        m.setattr(enhance_cuda, "unsharp", lambda *a: e_ops.unsharp_plain(*a))
        for n, fn in saved.items():
            m.setattr(color_cuda, n, getattr(color, f"{n}_plain"))
        twins = chain(x)
    assert torch.equal(got, twins)


@pytest.mark.parametrize("method", ["blocked", "full"])
def test_api_embed_launches_k15_and_k16(dev, tmp_path, method):
    """api.embed (blocked and parity) computes its metrics through K15
    and K16, once each."""
    from dctsvd_tpu_torch import api
    from dctsvd_tpu_torch.io import image_io
    cp, wp = str(tmp_path / "cover.png"), str(tmp_path / "wm.png")
    image_io.write_png(cp, _frames((256, 320, 3), SEED + 99))
    image_io.write_png(wp, _frames((64, 80, 3), SEED + 100))
    for k in (metrics_cuda.ssim, metrics_cuda.psnr):
        k.launches = 0
    _, _, ps, ss = api.embed(cp, wp, str(tmp_path / "s.png"),
                             str(tmp_path / "m.npz"), alpha=ALPHA,
                             password="pw", method=method, device=dev)
    torch.cuda.synchronize()
    assert (metrics_cuda.ssim.launches, metrics_cuda.psnr.launches) == (1, 1)
    assert ps > 15 and 0 < ss <= 1
