"""The port's graft entry points (dctsvd_tpu_torch/graft_entry.py)
against the repository's __graft_entry__.py on the CPU: the same example
inputs, the embed step, and the sharded dry run on a mesh of eight
shards on the CPU.

The dry run's serve scores are held to the JAX package's fused branch
(its Pallas roundtrip kernel in interpret mode, as tests/test_torch_serve.py
composes it) within 1e-3: at the fused s1.25 schedule those inputs score
below the 0.3 that __graft_entry__.py asserts on its converged CPU
fallback."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jgraft
from dctsvd_tpu.models import blocked as jb
from dctsvd_tpu.ops import wm_pallas
from dctsvd_tpu_torch import graft_entry
from dctsvd_tpu_torch.models import blocked as tb

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache():
    """Keep the interpret-mode Pallas executable out of the persistent
    compile cache (see tests/test_torch_serve.py)."""
    from jax._src import compilation_cache as cc
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    cc.reset_cache()


@pytest.mark.parametrize("shape", [(2, 128, 128), (8, 64, 64)])
def test_example_inputs_match_jax(shape):
    got = graft_entry._example_inputs(*shape, device="cpu")
    ref = jgraft._example_inputs(*shape)
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_entry_step():
    fn, args = graft_entry.entry(device="cpu")
    stego, sc, sw = fn(*args)
    assert stego.shape == (2, 128, 128, 3) and stego.dtype == torch.uint8
    assert sc.shape == (2, 256, 8) and sw.shape == (256, 8)
    ref = tb.embed_gray(*args)
    assert torch.equal(stego, ref.stego_bgr) and torch.equal(sc, ref.sc)
    score = tb.detect_gray(stego, sc, sw, args[-1])
    assert float(score.min()) > 0.3


def test_entry_takes_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        graft_entry.entry()
    with pytest.raises((RuntimeError, AssertionError)):
        graft_entry.dryrun_multichip(2)


def test_dryrun_multichip_cpu():
    graft_entry.dryrun_multichip(8, device="cpu")


def test_dryrun_serve_scores_match_jax_fused_branch():
    """The dry run's serve step, scored as the JAX package's fused branch
    scores it: within 1e-3 on each of the eight frames."""
    h = w = 64
    frames, _, blk, intra, _, _ = jgraft._example_inputs(8, h, w)
    rng = np.random.default_rng(1)
    wm_c = rng.integers(0, 256, (h, w, 3), np.uint8)
    pj = jb.prepare_wm_color(jnp.asarray(wm_c), blk, intra)
    alpha, k = jnp.float32(0.12), 4
    sws = jb._scaled_sws(pj.sw, alpha, (jnp.arange(8) < k).astype(
        jnp.float32))
    _, sc_j, scw_j = wm_pallas.roundtrip_frames_blocks(
        frames, sws, sweeps=1.25, k=k, interpret=True)
    sw_hat = jnp.maximum((scw_j - sc_j)[..., :k], 0.0) / alpha
    ref = np.asarray(jnp.mean(jb._band_nc(pj.sw[..., :k], sw_hat, h // 8,
                                          w // 8), axis=-1))
    st = tb.prepared_from_numpy(pj.uw, pj.sw, pj.vwt, pj.inv_blk,
                                pj.inv_intra, pj.ebasis, device="cpu")
    _, _, _, scores = tb.serve_verify_detect_color_prepared(
        torch.as_tensor(np.array(frames)), st.sw, 0.12, st.ebasis,
        st.inv_blk)
    np.testing.assert_allclose(scores.numpy(), ref, rtol=0, atol=1e-3)
    assert 0.25 < float(scores.min()) < 0.3
