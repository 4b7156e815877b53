"""The recompute form of the port's extract tail (``recompute=True``: the
plain twin of K5, ops/tail_cuda.py) against the JAX package's
``recompute=True`` on the CPU, against the port's own materialising form,
and the wrapper's refusals.

Inputs are uniform u8 noise from a seeded numpy generator, 64×80 (and an
unaligned 65×83), batch 2, α 0.15; both packages read the same watermark
state (models.blocked.prepared_from_numpy) and the same stego, embedded by
the port. The JAX side runs its XLA route on the CPU. Tolerances, with
their reasons:

- against the JAX package, extracted u8 within 2 quanta: the bound
  tests/test_torch_serve.py holds port against JAX (the k-term sum and
  the estimator round in another order);
- against the port's ``recompute=False``, within 2 quanta: the
  reference's own "couple of quanta" between its two forms
  (dctsvd_tpu/models/blocked.py::_extract_tail_prepared): the batched
  product may pair the k terms otherwise, and the eager normaliser
  multiplies by a reciprocal where the recompute form divides;
- an unaligned frame takes the materialising form either way: equal;
- a frame extracts to the same bytes alone and in a batch: equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dctsvd_tpu.models import blocked as jb
from dctsvd_tpu.ops import color as jcolor
from dctsvd_tpu.ops import dct as jdct
from dctsvd_tpu.utils import crypto as jcrypto
from dctsvd_tpu_torch.models import blocked as tb
from dctsvd_tpu_torch.ops import tail_cuda

torch.set_num_threads(2)

SEED = 20261033
ALPHA = 0.15
SWEEPS = 1.25
K = 4
PW = "torch-tail"
SHAPES = [(64, 80), (65, 83)]
CASES = ["sw", "no_sw", "zeroed_quadrant", "no_normalize"]


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache():
    """Keep this module's executables out of the persistent compile cache
    (segfaults XLA:CPU late in a full suite; see tests/test_wm_pallas.py)."""
    from jax._src import compilation_cache as cc
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    cc.reset_cache()


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def states():
    """Per (path, shape): the JAX prepared watermark, the port's state
    from it, and the port's stego and sc of 2 noise covers."""
    out = {}
    for i, (h, w) in enumerate(SHAPES):
        rng = np.random.default_rng(SEED + i)
        covers = rng.integers(0, 256, (2, h, w, 3), np.uint8)
        wm = rng.integers(0, 256, (h, w, 3), np.uint8)
        key = jcrypto.derive_key(PW, bytes(range(8)))
        blk, intra = jcrypto.block_permutation_indices(key,
                                                       jb.n_blocks_of(h, w))
        for path in ("color", "gray"):
            if path == "color":
                pj = jb.prepare_wm_color(jnp.asarray(wm), jnp.asarray(blk),
                                         jnp.asarray(intra))
                embed = tb.embed_color_prepared
            else:
                wm_gray = jcolor.bgr_to_gray(jnp.asarray(wm))
                pj = jb.prepare_wm_gray(wm_gray, jnp.asarray(blk),
                                        jnp.asarray(intra))
                embed = tb.embed_gray_prepared
            st = tb.prepared_from_numpy(pj.uw, pj.sw, pj.vwt, pj.inv_blk,
                                        pj.inv_intra, pj.ebasis, device="cpu")
            stego, sc, _, _ = embed(torch.from_numpy(covers), st.sw, ALPHA)
            out[path, (h, w)] = dict(pj=pj, st=st, stego=stego, sc=sc)
    return out


def _case_inputs(s, case):
    """(stego, sw-or-None for each side, normalize) of a case."""
    stego = s["stego"]
    if case == "zeroed_quadrant":
        stego = stego.clone()
        h, w = stego.shape[1:3]
        stego[:, :h // 2, :w // 2] = 0
    use_sw = case != "no_sw"
    return (stego, s["pj"].sw if use_sw else None,
            s["st"].sw if use_sw else None, case != "no_normalize")


def _port(path, s, case, recompute):
    stego, _, sw, normalize = _case_inputs(s, case)
    fn = (tb.extract_color_prepared if path == "color"
          else tb.extract_gray_prepared)
    return fn(stego, s["sc"], s["st"].ebasis, s["st"].inv_blk, ALPHA,
              normalize=normalize, sw=sw, sweeps=SWEEPS, recompute=recompute)


def _within(got: torch.Tensor, ref, quanta=2):
    ref = np.asarray(ref)
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape
    d = np.abs(got.numpy().astype(int) - ref.astype(int))
    assert d.max() <= quanta, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("hw", SHAPES, ids=["64x80", "65x83"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("path", ["color", "gray"])
def test_recompute_matches_jax_recompute(states, path, case, hw):
    s = states[path, hw]
    stego, sw_j, _, normalize = _case_inputs(s, case)
    fn = (jb.extract_color_prepared if path == "color"
          else jb.extract_gray_prepared)
    ref = fn(jnp.asarray(stego.numpy()), jnp.asarray(s["sc"].numpy()),
             s["pj"].ebasis, s["pj"].inv_blk, jnp.float32(ALPHA),
             normalize=normalize, sw=sw_j, sweeps=SWEEPS, recompute=True)
    _within(_port(path, s, case, True), ref)


@pytest.mark.parametrize("hw", SHAPES, ids=["64x80", "65x83"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("path", ["color", "gray"])
def test_recompute_matches_materializing_form(states, path, case, hw):
    s = states[path, hw]
    got = _port(path, s, case, True)
    ref = _port(path, s, case, False)
    if hw[0] % 8 or hw[1] % 8:
        assert torch.equal(got, ref)     # the einsum path either way
    else:
        _within(got, ref)


def test_zeroed_quadrant_flags_blocks(states):
    """The zeroed-quadrant case reaches the erasure repaint."""
    s = states["color", SHAPES[0]]
    stego, _, sw, _ = _case_inputs(s, "zeroed_quadrant")
    s_cw = tb._frames_spectrum(stego, SWEEPS)
    x = tb._tail_front(s_cw, s["sc"], s["st"].inv_blk, ALPHA, K, sw)
    flags = x[..., K]
    assert tuple(x.shape[-2:]) == (80, K + 1)
    assert 0 < float(flags.sum()) < flags.numel()


def _tail_case(layout, k=K, flags=True, frames=2, h=64, w=80, seed=SEED,
               flag_share=0.2):
    """Seeded estimates [frames, (3,) N, k (+1)] and a basis sliced as the
    prepared [(3,) N, 8, 8, 8] one is."""
    rng = np.random.default_rng(seed)
    n = (h // 8) * (w // 8)
    cd = (3,) if layout == "frames" else ()
    x = (rng.standard_normal((frames, *cd, n, k)) * 3).astype(np.float32)
    if flags:
        f = (rng.random((frames, *cd, n, 1)) < flag_share).astype(np.float32)
        x = np.concatenate([x, f], axis=-1)
    basis = torch.from_numpy(
        rng.standard_normal((*cd, n, 8, 8, 8)).astype(np.float32))
    eb64 = basis[..., :k, :, :].reshape(*cd, n, k, 64)
    return torch.from_numpy(x), eb64


def _jax_tail(x, eb64, h, w, normalize, to_frames):
    """The JAX package's recompute tail on the same estimates."""
    k = eb64.shape[-2]
    xj, ej = jnp.asarray(x.numpy()), jnp.asarray(eb64.numpy())
    sw_nat = xj[..., :k]
    bad = xj[..., k] > 0.5 if x.shape[-1] == k + 1 else None

    def produce():
        return jnp.sum(sw_nat[..., :, None] * ej, axis=-2)

    blocks = jb._normalize_blocks_recompute(produce, bad, normalize, True)
    blocks = blocks.reshape(*blocks.shape[:-1], 8, 8)
    if to_frames:
        return jb._unblockify_to_frames(blocks, h, w)
    return jdct.unblockify(blocks, h, w)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("flags", [True, False], ids=["flags", "no_flags"])
@pytest.mark.parametrize("layout", ["frames", "planes"])
def test_twin_matches_jax_normalizer(layout, flags, normalize):
    x, eb64 = _tail_case(layout, flags=flags)
    cl = layout == "frames"
    got = tail_cuda.recon_normalize(x, eb64, 64, 80, normalize=normalize,
                                    to_frames=cl)
    assert got.shape == ((2, 64, 80, 3) if cl else (2, 64, 80))
    _within(got, _jax_tail(x, eb64, 64, 80, normalize, cl))


@pytest.mark.parametrize("layout", ["frames", "planes"])
def test_twin_is_batch_invariant(layout):
    """Frame i of a batch of 4 is byte-equal to frame i alone, and a shard
    of 2 to its frames of the batch."""
    x, eb64 = _tail_case(layout, frames=4, seed=SEED + 5)
    cl = layout == "frames"
    whole = tail_cuda.recon_normalize(x, eb64, 64, 80, to_frames=cl)
    for i in range(4):
        alone = tail_cuda.recon_normalize(x[i], eb64, 64, 80, to_frames=cl)
        assert torch.equal(alone, whole[i])
    assert torch.equal(
        tail_cuda.recon_normalize(x[1:3], eb64, 64, 80, to_frames=cl),
        whole[1:3])


@pytest.mark.parametrize("layout", ["frames", "planes"])
def test_all_flagged_plane_is_flat(layout):
    """Every block flagged (a mark-free input): the unflagged window is
    empty, the whole one takes its place and the repaint flattens each
    plane at its midpoint, as in the JAX package."""
    x, eb64 = _tail_case(layout, seed=SEED + 6)
    x[..., K] = 1.0
    cl = layout == "frames"
    got = tail_cuda.recon_normalize(x, eb64, 64, 80, to_frames=cl)
    planes = torch.movedim(got, -1, 1) if cl else got[:, None]
    flat = planes.reshape(*planes.shape[:2], -1)
    assert torch.equal(flat, flat[..., :1].expand_as(flat))
    _within(got, _jax_tail(x, eb64, 64, 80, True, cl))


def test_wrapper_takes_the_twin_for_cpu_tensors():
    x, eb64 = _tail_case("frames")
    before = tail_cuda.recon_normalize.launches
    got = tail_cuda.recon_normalize(x, eb64, 64, 80, out_u8=False,
                                    to_frames=True)
    assert torch.equal(got, tail_cuda.recon_normalize_plain(
        x, eb64, 64, 80, out_u8=False, to_frames=True))
    assert got.dtype == torch.float32
    assert tail_cuda.recon_normalize.launches == before


@pytest.mark.parametrize("bad", ["dtype", "k9", "unaligned", "columns",
                                 "blocks", "frames_without_channels",
                                 "device"])
def test_wrapper_refuses_bad_input(bad):
    x, eb64 = _tail_case("frames")
    h, w, cl = 64, 80, True
    match = "float32"
    if bad == "dtype":
        x = x.to(torch.float64)
    elif bad == "k9":
        eb64 = torch.zeros(3, 80, 9, 64)
        x = torch.zeros(2, 3, 80, 10)
        match = "k must be in 1..8"
    elif bad == "unaligned":
        h, match = 65, "block-aligned"
    elif bad == "columns":
        x, match = x[..., :2].contiguous(), "x must be"
    elif bad == "blocks":
        w, match = 88, "blocks"
    elif bad == "frames_without_channels":
        x, eb64 = _tail_case("planes")
        match = "channel dimension"
    else:
        x = torch.empty(x.shape, device="meta")
        eb64 = torch.empty(eb64.shape, device="meta")
        match = "unsupported device"
    with pytest.raises(ValueError, match=match):
        tail_cuda.recon_normalize(x, eb64, h, w, to_frames=cl)
