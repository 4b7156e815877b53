"""The port's serve steps and the plain twins of K3 (embed + verification
spectrum), K2r (recon embed) and K1g (Gram spectrum) against the JAX
package on the CPU, and the wrappers' refusals.

Inputs are uniform u8 noise from a seeded numpy generator, 64×80 (and an
unaligned 65×83), batch 2: its blocks are well conditioned, so a twin and
its Pallas kernel in interpret mode agree to rounding. Tolerances, with
their reasons:

- stego bytes within 1 quantum on at most 1 % of the bytes: the twin and
  the Pallas kernel round the same painted value, but a 1-ulp difference
  in a rotation (torch's and XLA's rsqrt) can move a value across an
  integer (the bound of tests/test_torch_kernels.py);
- sc within SC_TOL·s_max and s_cw within SPEC_TOL·s_max: the spectra of
  test_torch_kernels.py, where the two Jacobi replays differ by rounding;
- K2r's f32 output within RECON_TOL·max|y| and K1g within SPEC_TOL·s_max:
  the same rotations, so only rounding separates twin and kernel;
- extracted u8 within 2 quanta and scores within 1e-3 against the JAX
  package (tests/test_torch_blocked.py: the recon einsum and the
  normaliser sum in another order);
- the serve steps against the port's own split calls: stego, sc and the
  recovered watermark exactly, scores within 1e-5, because the fused path
  must run the very same arithmetic as the split one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dctsvd_tpu.models import blocked as jb
from dctsvd_tpu.ops import wm_pallas
from dctsvd_tpu.utils import crypto as jcrypto
from dctsvd_tpu_torch.models import blocked as tb
from dctsvd_tpu_torch.ops import wm_cuda
from dctsvd_tpu_torch.utils import crypto

torch.set_num_threads(2)

SEED = 20261019
ALPHA = 0.15
SWEEPS = 1.25
K = 4
SPEC_TOL = 5e-4     # × s_max, as tests/test_torch_kernels.py
SC_TOL = 1e-4       # × s_max
RECON_TOL = 1e-5    # × max|y|
PW = "torch-serve"


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache():
    """Keep this module's interpret-mode Pallas executables out of the
    persistent compile cache (segfaults XLA:CPU late in a full suite; see
    tests/test_wm_pallas.py)."""
    from jax._src import compilation_cache as cc
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    cc.reset_cache()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (2, 64, 80, 3), np.uint8)
    n = (64 // 8) * (80 // 8)
    mask = (np.arange(8) < K).astype(np.float32)
    sws = ((rng.standard_normal((3, n, 8)) ** 2) * 3 * mask).astype(
        np.float32)
    return frames, sws


def _rel_err(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _assert_stego_close(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape
    d = np.abs(got.numpy().astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("k", [1, K, 8])
@pytest.mark.parametrize("sweeps", [1.25, 2])
def test_roundtrip_twin_matches_pallas(data, sweeps, k):
    frames, sws = data
    sws = sws * (np.arange(8) < k).astype(np.float32)
    ref_st, ref_sc, ref_scw = wm_pallas.roundtrip_frames_blocks(
        jnp.asarray(frames), jnp.asarray(sws), sweeps=sweeps, k=k,
        interpret=True)
    st, sc, scw = wm_cuda.roundtrip_frames_blocks(
        torch.from_numpy(frames), torch.from_numpy(sws), sweeps=sweeps, k=k)
    _assert_stego_close(st, ref_st)
    assert tuple(sc.shape) == tuple(scw.shape) == (2, 3, 80, 8)
    assert _rel_err(sc, ref_sc) <= SC_TOL
    assert _rel_err(scw, ref_scw) <= SPEC_TOL
    assert not np.array_equal(st.numpy(), frames)     # the mark is painted
    # the contract: s_cw is the spectrum of the returned stego, bit for bit
    assert torch.equal(scw, wm_cuda.spectrum_blocks_plain(
        st, sweeps=sweeps, channels_last=True))


@pytest.mark.parametrize("sweeps", [1.25, 1.5])
def test_gram_twin_matches_pallas(data, sweeps):
    frames, _ = data
    planes = np.ascontiguousarray(np.moveaxis(frames, -1, -3))
    ref = wm_pallas.spectrum_plane_blocks(jnp.asarray(planes), sweeps=sweeps,
                                          method="gram", interpret=True)
    got = wm_cuda.spectrum_blocks(torch.from_numpy(planes), sweeps=sweeps,
                                  method="gram")
    assert tuple(got.shape) == np.asarray(ref).shape == (2, 3, 80, 8)
    assert _rel_err(got, ref) <= SPEC_TOL
    # channels-last frames read the same blocks
    got_f = wm_cuda.spectrum_blocks_gram(torch.from_numpy(frames),
                                         sweeps=sweeps, channels_last=True)
    assert torch.equal(got_f, got)
    # the same rotation prefix as the one-sided form
    # (test_wm_pallas.py::test_fractional_replay_cross_path's 5e-3)
    one = wm_cuda.spectrum_blocks_plain(torch.from_numpy(planes),
                                        sweeps=sweeps)
    assert _rel_err(got, one) <= 5e-3


@pytest.mark.parametrize("sweeps", [1.25, 1.5])
@pytest.mark.parametrize("layout", ["frames_u8", "planes_f32"])
def test_recon_twin_matches_pallas(data, layout, sweeps):
    frames, sws = data
    if layout == "frames_u8":
        x, cl, s = frames, True, sws
    else:
        x, cl, s = frames[..., 1].astype(np.float32), False, sws[:1]
    ref_y, ref_sc = wm_pallas.embed_plane_blocks(
        jnp.asarray(x), jnp.asarray(s), sweeps=sweeps, variant="recon",
        channels_last=cl, interpret=True)
    y, sc = wm_cuda.embed_blocks(torch.from_numpy(x), torch.from_numpy(s),
                                 sweeps=sweeps, k=K, variant="recon",
                                 channels_last=cl)
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    assert _rel_err(y, ref_y) <= RECON_TOL
    assert _rel_err(sc, ref_sc) <= SC_TOL
    # V rides along without touching the rotations: the same sc as K2's
    _, scd = wm_cuda.embed_blocks(torch.from_numpy(x), torch.from_numpy(s),
                                  sweeps=sweeps, k=K, channels_last=cl)
    assert torch.equal(sc, scd)


def _prepared(h, w, seed):
    rng = np.random.default_rng(seed)
    covers = rng.integers(0, 256, (2, h, w, 3), np.uint8)
    wm = rng.integers(0, 256, (h, w, 3), np.uint8)
    key = crypto.derive_key(PW, bytes(range(8)))
    blk, intra = crypto.block_permutation_indices(key, tb.n_blocks_of(h, w))
    pw = tb.prepare_wm_color(torch.from_numpy(wm), torch.as_tensor(blk),
                             torch.as_tensor(intra))
    return torch.from_numpy(covers), pw


@pytest.mark.parametrize("hw", [(64, 80), (65, 83)])
def test_serve_steps_equal_split_calls(hw):
    covers, pw = _prepared(*hw, SEED + 1)
    stego, sc, _, _ = tb.embed_color_prepared(covers, pw.sw, ALPHA,
                                              with_metrics=False)
    rec = tb.extract_color_prepared(stego, sc, pw.ebasis, pw.inv_blk, ALPHA,
                                    sw=pw.sw)
    scores = tb.detect_color(stego, sc, pw.sw, ALPHA)

    st1, sc1, rec1 = tb.serve_verify_color_prepared(covers, pw.sw, ALPHA,
                                                    pw.ebasis, pw.inv_blk)
    st2, sc2, rec2, sco2 = tb.serve_verify_detect_color_prepared(
        covers, pw.sw, ALPHA, pw.ebasis, pw.inv_blk)
    st3, sc3, sco3 = tb.serve_detect_color_prepared(covers, pw.sw, ALPHA)
    for st_, sc_ in ((st1, sc1), (st2, sc2), (st3, sc3)):
        assert torch.equal(st_, stego) and torch.equal(sc_, sc)
    assert torch.equal(rec1, rec) and torch.equal(rec2, rec)
    for sco in (sco2, sco3):
        assert sco.shape == scores.shape == (2,)
        assert float((sco - scores).abs().max()) <= 1e-5


def test_serve_verify_detect_matches_jax_fused_branch():
    """The JAX package's fused serve+verify+detect body, composed from its
    parts: the Pallas roundtrip kernel (interpret mode), the materializing
    extract tail and the band score, on the same prepared watermark."""
    h, w = 64, 80
    rng = np.random.default_rng(SEED + 2)
    covers = rng.integers(0, 256, (2, h, w, 3), np.uint8)
    wm = rng.integers(0, 256, (h, w, 3), np.uint8)
    key = jcrypto.derive_key(PW, bytes(range(8)))
    blk, intra = jcrypto.block_permutation_indices(key, jb.n_blocks_of(h, w))
    pj = jb.prepare_wm_color(jnp.asarray(wm), jnp.asarray(blk),
                             jnp.asarray(intra))
    alpha = jnp.float32(ALPHA)
    mask = (jnp.arange(8) < K).astype(jnp.float32)
    sws = jb._scaled_sws(pj.sw, alpha, mask)
    st_j, sc_j, scw_j = wm_pallas.roundtrip_frames_blocks(
        jnp.asarray(covers), sws, sweeps=SWEEPS, k=K, interpret=True)
    rec_j = jb._extract_tail_prepared(scw_j, sc_j, pj.ebasis, pj.inv_blk,
                                      alpha, 0.6, True, h, w, sw=pj.sw,
                                      to_frames=True, out_u8=True,
                                      recompute=False)
    sw_hat = jnp.maximum((scw_j - sc_j)[..., :K], 0.0) / alpha
    scores_j = jnp.mean(jb._band_nc(pj.sw[..., :K], sw_hat, h // 8, w // 8),
                        axis=-1)

    st = tb.prepared_from_numpy(pj.uw, pj.sw, pj.vwt, pj.inv_blk,
                                pj.inv_intra, pj.ebasis, device="cpu")
    stego, sc, rec, scores = tb.serve_verify_detect_color_prepared(
        torch.from_numpy(covers), st.sw, ALPHA, st.ebasis, st.inv_blk)
    _assert_stego_close(stego, st_j)
    np.testing.assert_allclose(sc.numpy(), np.asarray(sc_j), rtol=0,
                               atol=SC_TOL * float(np.asarray(sc_j).max()))
    d = np.abs(rec.numpy().astype(int) - np.asarray(rec_j).astype(int))
    assert rec.shape == covers.shape and d.max() <= 2
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_j), rtol=0,
                               atol=1e-3)
    assert float(scores.min()) > 0.3


def test_new_wrappers_take_the_twin_for_cpu_tensors(data):
    frames, sws = data
    x, s = torch.from_numpy(frames), torch.from_numpy(sws)
    counters = (wm_cuda.roundtrip_frames_blocks, wm_cuda.embed_blocks_recon,
                wm_cuda.spectrum_blocks_gram, wm_cuda.embed_blocks,
                wm_cuda.spectrum_blocks)
    before = [fn.launches for fn in counters]
    st, sc, scw = wm_cuda.roundtrip_frames_blocks(x, s, sweeps=SWEEPS, k=K)
    st2, sc2, scw2 = wm_cuda.roundtrip_frames_blocks_plain(x, s,
                                                           sweeps=SWEEPS, k=K)
    assert torch.equal(st, st2) and torch.equal(sc, sc2) \
        and torch.equal(scw, scw2)
    y, _ = wm_cuda.embed_blocks_recon(x, s, sweeps=SWEEPS, channels_last=True)
    assert torch.equal(y, wm_cuda.embed_blocks_recon_plain(
        x, s, sweeps=SWEEPS, channels_last=True)[0])
    g = wm_cuda.spectrum_blocks(x, sweeps=SWEEPS, channels_last=True,
                                method="gram")
    assert torch.equal(g, wm_cuda.spectrum_blocks_gram_plain(
        x, sweeps=SWEEPS, channels_last=True))
    assert before == [fn.launches for fn in counters]


@pytest.mark.parametrize("k", [0, 9])
def test_paint_wrappers_refuse_k_outside_1_to_8(data, k):
    """K2 and K3 are compiled for k = 1..8 only; the wrappers refuse any
    other k before they reach a kernel or a twin."""
    frames, sws = data
    x, s = torch.from_numpy(frames), torch.from_numpy(sws)
    with pytest.raises(ValueError, match="k must be in 1..8"):
        wm_cuda.embed_blocks(x, s, k=k, out_u8=True, channels_last=True)
    with pytest.raises(ValueError, match="k must be in 1..8"):
        wm_cuda.roundtrip_frames_blocks(x, s, k=k)


def test_new_wrappers_refuse_bad_input(data):
    frames, sws = data
    x, s = torch.from_numpy(frames), torch.from_numpy(sws)
    with pytest.raises(ValueError, match="delta variant"):
        wm_cuda.embed_blocks(x, s, out_u8=True, channels_last=True,
                             variant="recon")
    with pytest.raises(ValueError, match="unknown embed variant"):
        wm_cuda.embed_blocks(x, s, channels_last=True, variant="fused")
    with pytest.raises(ValueError, match="unknown spectrum method"):
        wm_cuda.spectrum_blocks(x, channels_last=True, method="twosided")
    with pytest.raises(ValueError, match="u8 channels-last"):
        wm_cuda.roundtrip_frames_blocks(x.to(torch.float32), s)
    with pytest.raises(ValueError, match="multiples of 8"):
        wm_cuda.roundtrip_frames_blocks(x[:, :60], s)
    with pytest.raises(ValueError, match="sws"):
        wm_cuda.roundtrip_frames_blocks(x, s[:, :10])
    with pytest.raises(ValueError, match="0-sweep"):
        wm_cuda.roundtrip_frames_blocks(x, s, sweeps=0)
    with pytest.raises(ValueError, match="0-sweep"):
        wm_cuda.spectrum_blocks(x, sweeps=0, channels_last=True,
                                method="gram")
    meta = torch.empty((1, 64, 80, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wm_cuda.roundtrip_frames_blocks(meta, s)
    with pytest.raises(ValueError, match="unsupported device"):
        wm_cuda.spectrum_blocks_gram(meta, channels_last=True)
    with pytest.raises(ValueError, match="unsupported device"):
        wm_cuda.embed_blocks_recon(meta, s, channels_last=True)
