"""The port's extract tail against the JAX package on the CPU: the
recompute form (``recompute=True``: the plain twin of K5,
ops/tail_cuda.py) against the JAX package's ``recompute=True`` and the
port's own materialising form; the front (K5f's twin); the min–max
normalisers' one-division scale; the default form's normaliser (K8's
twin, also on planes holding NaN, ±inf and every block flagged) and the
default extract; K8's plan (which instance a shape takes, each CTA's
share); each wrapper's refusals.

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
  product may pair the k terms otherwise;
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
from dctsvd_tpu_torch.ops import color as tcolor
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
    return _states(SHAPES)


def _states(shapes):
    out = {}
    for i, (h, w) in enumerate(shapes):
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


# ---------------------------------------------------------------------------
# K5f, the front stage both tail forms read: the estimator and the slot
# gather (ops/tail_cuda.py::tail_front, through models/blocked._tail_front)
# against the JAX package's front (dctsvd_tpu/models/blocked.py:1003-1016:
# the raw estimate, _shrink_sw_hat, the flag column, _permute_slots).
#
# Flags and the presence decision must be equal. Estimates agree within
# FRONT_RTOL of the largest |sw| (NaN where the JAX package has NaN): the
# shrinkage scale (a mean) and the group Pearsons reduce in another order
# in XLA than in torch, so w, and the blend through it, may move by a few
# ulp; everything else is the same elementwise IEEE arithmetic.
# ---------------------------------------------------------------------------

FRONT_RTOL = 1e-6
FRONT_CASES = ["stego", "zeroed", "black", "no_sw", "nan"]
# 480 and 527 blocks: groups of 30 and 32, whose knee (0.53, 0.52) a
# stego clears (at 64x80, groups of 5, the knee is 1.0: never engaged)
FRONT_SHAPES = [(128, 240), (129, 243)]
FRONT_STATES = [("color", FRONT_SHAPES[0]), ("gray", FRONT_SHAPES[0]),
                ("color", FRONT_SHAPES[1])]


@pytest.fixture(scope="module")
def front_states():
    return _states(FRONT_SHAPES)


def _front_inputs(s, path, case):
    """(s_cw, sc, inv_blk, sw) numpy arrays of a case: the stego spectrum
    (K1's twin at s1.25) against the embed's sc. ``zeroed``: all but the
    top-left quadrant of the stego zeroed (the presence test fails and the
    zeroed blocks are flagged); ``black``: an all-zero, mark-free frame
    (every block flagged); ``nan``: one NaN in s_cw."""
    stego = s["stego"]
    if case == "zeroed":
        stego = stego.clone()
        h, w = stego.shape[1:3]
        stego[:, h // 2:] = 0
        stego[:, :, w // 2:] = 0
    elif case == "black":
        stego = torch.zeros_like(stego)
    if path == "color":
        s_cw = tb._frames_spectrum(stego, SWEEPS)
    else:
        s_cw = tb._plane_spectrum(tcolor.luma_f32(stego), SWEEPS)
    s_cw = s_cw.numpy().copy()
    if case == "nan":
        s_cw[1, ..., 3, 2] = np.nan
    sw = None if case == "no_sw" else s["st"].sw.numpy()
    return s_cw, s["sc"].numpy(), s["st"].inv_blk.numpy(), sw


def _jax_front(s_cw, sc, inv_blk, sw):
    """The JAX package's front, and its presence decision (the statistic
    of its _shrink_sw_hat, which does not return it, from its own
    metrics.nc on the same groups)."""
    from dctsvd_tpu.ops import metrics as jmetrics
    raw = (jnp.asarray(s_cw) - jnp.asarray(sc)) / jnp.maximum(
        jnp.float32(ALPHA), 1e-8)
    est, bad = jb._shrink_sw_hat(raw, None if sw is None else
                                 jnp.asarray(sw), K)
    if bad is None:
        return np.asarray(jb._permute_slots(est[..., :K],
                                            jnp.asarray(inv_blk))), None
    combo = jnp.concatenate([est[..., :K], bad.astype(jnp.float32)[..., None]],
                            axis=-1)
    ref = jnp.broadcast_to(jnp.asarray(sw), raw.shape)
    n = raw.shape[-2]
    gsz = max(1, n // 16)
    ng = n // gsz
    a0 = ref[..., :ng * gsz, 0].reshape(*ref.shape[:-2], ng, gsz)
    b0 = raw[..., :ng * gsz, 0].reshape(*raw.shape[:-2], ng, gsz)
    rho0 = jnp.sort(jmetrics.nc(a0, b0), axis=-1)[..., ng - -(-ng // 4)]
    engage = rho0 >= 0.20 + 1.8 / jnp.sqrt(jnp.float32(gsz))
    return (np.asarray(jb._permute_slots(combo, jnp.asarray(inv_blk))),
            np.asarray(engage))


@pytest.mark.parametrize("case", FRONT_CASES)
@pytest.mark.parametrize("state", FRONT_STATES,
                         ids=["color128x240", "gray128x240", "color129x243"])
def test_front_matches_jax_front(front_states, state, case):
    s = front_states[state]
    s_cw, sc, inv_blk, sw = _front_inputs(s, state[0], case)
    ref, engage_j = _jax_front(s_cw, sc, inv_blk, sw)
    got = tb._tail_front(_t(s_cw), _t(sc), _t(inv_blk), ALPHA, K,
                         None if sw is None else _t(sw)).numpy()
    assert got.shape == ref.shape == (*s_cw.shape[:-1], K + (sw is not None))
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    tol = FRONT_RTOL * float(np.abs(sc).max() if sw is None
                             else np.abs(sw).max())
    assert np.abs(np.where(nan, 0, got) - np.where(nan, 0, ref)).max() <= tol
    if sw is None:
        return
    assert np.array_equal(got[..., K], ref[..., K])        # the flags
    raw = (_t(s_cw) - _t(sc)) / ALPHA
    engage = tb._engaged(raw, _t(sw)).numpy()
    assert np.array_equal(engage, engage_j)
    flagged = got[..., K] > 0.5
    if case in ("stego", "nan"):
        assert engage.all() and not flagged.any()
    elif case == "zeroed":
        assert not engage.all() and 0 < flagged.mean() < 1
    elif case == "black":
        assert not engage.any() and flagged.all()
    if case == "nan":
        assert np.isnan(got).any()


def test_front_wrapper_takes_the_twin_for_cpu_tensors(states):
    s = states["color", SHAPES[0]]
    s_cw, sc, inv_blk, sw = (_t(a) for a in
                             _front_inputs(s, "color", "stego"))
    a = torch.tensor(ALPHA)
    scale, engage = tb._sw_scale(sw), tb._engaged((s_cw - sc) / a, sw)
    before = tail_cuda.tail_front.launches
    got = tail_cuda.tail_front(s_cw, sc, inv_blk, a, K, sw, scale, engage)
    assert torch.equal(got, tail_cuda.tail_front_plain(
        s_cw, sc, inv_blk, a, K, sw, scale, engage))
    assert torch.equal(got, tb._tail_front(s_cw, sc, inv_blk, ALPHA, K, sw))
    assert tail_cuda.tail_front.launches == before


@pytest.mark.parametrize("bad", ["dtype", "non_contiguous", "inv_blk_length",
                                 "inv_blk_dtype", "k9", "sw_channels",
                                 "engage_shape", "device"])
def test_front_wrapper_refuses_bad_input(states, bad):
    s = states["color", SHAPES[0]]
    s_cw, sc, inv_blk, sw = (_t(a) for a in
                             _front_inputs(s, "color", "stego"))
    a, k = torch.tensor(ALPHA), K
    scale, engage = tb._sw_scale(sw), tb._engaged((s_cw - sc) / a, sw)
    match = "float32"
    if bad == "dtype":
        s_cw = s_cw.to(torch.float64)
    elif bad == "non_contiguous":
        s_cw = s_cw.transpose(0, 1).contiguous().transpose(0, 1)
        match = "contiguous"
    elif bad == "inv_blk_length":
        inv_blk, match = inv_blk[:-1], "inv_blk"
    elif bad == "inv_blk_dtype":
        inv_blk, match = inv_blk.to(torch.float32), "inv_blk"
    elif bad == "k9":
        k, match = 9, "k must be in 1..8"
    elif bad == "sw_channels":
        sw, match = sw[:2].contiguous(), "sw must be"
    elif bad == "engage_shape":
        engage, match = engage[0], "engage"
    else:
        s_cw, sc = (torch.empty(t.shape, device="meta") for t in (s_cw, sc))
        match = "unsupported device"
    with pytest.raises(ValueError, match=match):
        tail_cuda.tail_front(s_cw, sc, inv_blk, a, k, sw, scale, engage)


# ---------------------------------------------------------------------------
# The min–max normalisers' scale: one IEEE division, 255 / max(hi - lo,
# 1e-12), as the JAX package's ``255.0 / x`` (torch's ``255.0 / t`` is a
# reciprocal and a product, which rounds twice and moved about 1e-4 of the
# u8 bytes below by one quantum; each case's message counts them). Each normaliser, then clip and cast, is
# byte-equal to the JAX package's on the same seeded f32 input: min and max
# are exact in any order and the rest is the same elementwise arithmetic.
# Inputs: 96 planes, values ~ N(s, s²) at scales s from 1e-3 to 1e3, a
# fifth of the blocks flagged where flags are on.
# ---------------------------------------------------------------------------

NORM_SCALES = [1e-3, 1e-1, 1.0, 10.0, 1e3]
NORM_PLANES, NORM_H, NORM_W = 96, 48, 40


def _norm_input(scale, flags, seed=SEED + 40):
    """f32 planes [P, H, W], their blocks [P, N, 64] (row-major pixels of
    each block) and the flags [P, N] or None."""
    rng = np.random.default_rng(seed)
    planes = (rng.standard_normal((NORM_PLANES, NORM_H, NORM_W)) * scale
              + scale).astype(np.float32)
    hb, wb = NORM_H // 8, NORM_W // 8
    blocks = planes.reshape(NORM_PLANES, hb, 8, wb, 8).transpose(
        0, 1, 3, 2, 4).reshape(NORM_PLANES, hb * wb, 64)
    bad = (rng.random((NORM_PLANES, hb * wb)) < 0.2) if flags else None
    return planes, np.ascontiguousarray(blocks), bad


def _u8(t):
    return t.clamp(0, 255).to(torch.uint8).numpy()


def _u8_jax(a):
    return np.asarray(jnp.clip(a, 0, 255).astype(jnp.uint8))


def _opt(a, conv):
    return None if a is None else conv(a)


def _bytes_equal(got, ref):
    """Byte-equal, or fail naming how many bytes differ and of how many."""
    assert got.shape == ref.shape
    assert np.array_equal(got, ref), (
        f"{int((got != ref).sum())} of {got.size} bytes differ")


@pytest.mark.parametrize("flags", [True, False], ids=["flags", "no_flags"])
@pytest.mark.parametrize("scale", NORM_SCALES)
def test_normalize_blocks_equals_jax(scale, flags):
    _, blocks, bad = _norm_input(scale, flags)
    got = tail_cuda.minmax_blocks(torch.from_numpy(blocks),
                                  _opt(bad, torch.from_numpy), True)
    ref = jb._normalize_blocks(jnp.asarray(blocks), _opt(bad, jnp.asarray),
                               True)
    _bytes_equal(_u8(got), _u8_jax(ref))


@pytest.mark.parametrize("flags", [True, False], ids=["flags", "no_flags"])
@pytest.mark.parametrize("scale", NORM_SCALES)
def test_masked_normalize_equals_jax(scale, flags):
    planes, _, bad = _norm_input(scale, flags, seed=SEED + 41)
    # an unaligned crop of the planes, as the materialising tail passes
    h, w = NORM_H - 3, NORM_W - 5
    args = (NORM_H, NORM_W, h, w, True)
    got = tb._masked_normalize(torch.from_numpy(planes[:, :h, :w]),
                               _opt(bad, torch.from_numpy), *args)
    ref = jb._masked_normalize(jnp.asarray(planes[:, :h, :w]),
                               _opt(bad, jnp.asarray), *args)
    _bytes_equal(_u8(got), _u8_jax(ref))


@pytest.mark.parametrize("scale", NORM_SCALES)
def test_minmax_255_equals_jax(scale):
    from dctsvd_tpu.models import image as jimage
    from dctsvd_tpu_torch.models import image as timage
    planes, _, _ = _norm_input(scale, False, seed=SEED + 42)
    got = timage._minmax_255(torch.from_numpy(planes))
    ref = jax.vmap(jimage._minmax_255)(jnp.asarray(planes))
    _bytes_equal(_u8(got), _u8_jax(ref))


# ---------------------------------------------------------------------------
# K8, the default form's normaliser over the materialised product
# (ops/tail_cuda.py::normalize_blocks): its twin is byte-equal to the JAX
# package's _normalize_blocks, clip and cast, and unblockify on the same
# reconstruction (the same arithmetic since the scale divides once); the
# default tail stays within 2 quanta of the JAX package's (the bound
# tests/test_torch_serve.py holds, for the estimator's and the product's
# order); the wrapper takes the twin on the CPU and refuses what the
# kernel does not take.
# ---------------------------------------------------------------------------


def _k8_case(layout, flags=True, frames=2, h=64, w=80, seed=SEED + 60,
             flag_share=0.2):
    """The product [frames, (3,) N, 64] of seeded estimates and basis, as
    models/blocked._recon makes it (a strided view), and the estimates
    [frames, (3,) N, k (+1)] whose column k flags blocks."""
    x, eb64 = _tail_case(layout, flags=flags, frames=frames, h=h, w=w,
                         seed=seed, flag_share=flag_share)
    return tb._recon(x[..., :K], eb64), x


def _jax_default(blocks, x, h, w, normalize, out_u8, to_frames):
    bj = jnp.asarray(blocks.numpy())
    bad = (jnp.asarray(x.numpy()[..., K] > 0.5) if x.shape[-1] == K + 1
           else None)
    out = jb._normalize_blocks(bj, bad, normalize)
    if out_u8:
        out = jnp.clip(out, 0, 255).astype(jnp.uint8)
    out = out.reshape(*out.shape[:-1], 8, 8)
    if to_frames:
        return np.asarray(jb._unblockify_to_frames(out, h, w))
    return np.asarray(jdct.unblockify(out, h, w))


@pytest.mark.parametrize("out_u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("flags", [True, False], ids=["flags", "no_flags"])
@pytest.mark.parametrize("layout", ["frames", "planes"])
def test_k8_twin_equals_jax_normalizer(layout, flags, normalize, out_u8):
    blocks, x = _k8_case(layout, flags=flags)
    cl = layout == "frames"
    got = tail_cuda.normalize_blocks(blocks, x, K, 64, 80,
                                     normalize=normalize, out_u8=out_u8,
                                     to_frames=cl)
    ref = _jax_default(blocks, x, 64, 80, normalize, out_u8, cl)
    assert got.shape == ref.shape == ((2, 64, 80, 3) if cl else (2, 64, 80))
    assert got.dtype == (torch.uint8 if out_u8 else torch.float32)
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("layout", ["frames", "planes"])
def test_k8_all_flagged_equals_jax(layout):
    """Every block flagged: the whole window, each plane flat."""
    blocks, x = _k8_case(layout, seed=SEED + 61)
    x[..., K] = 1.0
    cl = layout == "frames"
    got = tail_cuda.normalize_blocks(blocks, x, K, 64, 80, to_frames=cl)
    assert np.array_equal(got.numpy(),
                          _jax_default(blocks, x, 64, 80, True, True, cl))
    planes = torch.movedim(got, -1, 1) if cl else got[:, None]
    flat = planes.reshape(*planes.shape[:2], -1)
    assert torch.equal(flat, flat[..., :1].expand_as(flat))


@pytest.mark.parametrize("hw", SHAPES, ids=["64x80", "65x83"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("path", ["color", "gray"])
def test_default_matches_jax_default(states, path, case, hw):
    s = states[path, hw]
    stego, sw_j, _, normalize = _case_inputs(s, case)
    fn = (jb.extract_color_prepared if path == "color"
          else jb.extract_gray_prepared)
    ref = fn(jnp.asarray(stego.numpy()), jnp.asarray(s["sc"].numpy()),
             s["pj"].ebasis, s["pj"].inv_blk, jnp.float32(ALPHA),
             normalize=normalize, sw=sw_j, sweeps=SWEEPS, recompute=False)
    _within(_port(path, s, case, False), ref)


def test_k8_wrapper_takes_the_twin_for_cpu_tensors(states):
    """The default extract reaches K8's wrapper at aligned and (K8u, the
    crop) unaligned sizes, which runs the twin for CPU tensors and counts
    no launch."""
    blocks, x = _k8_case("frames")
    before = tail_cuda.normalize_blocks.launches
    got = tail_cuda.normalize_blocks(blocks, x, K, 64, 80, out_u8=False,
                                     to_frames=True)
    assert torch.equal(got, tail_cuda.normalize_blocks_plain(
        blocks, x, K, 64, 80, out_u8=False, to_frames=True))
    calls = []
    orig = tail_cuda.normalize_blocks

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return orig(*args, **kw)
    tail_cuda.normalize_blocks = spy
    try:
        _port("color", states["color", SHAPES[0]], "sw", False)
        _port("color", states["color", SHAPES[1]], "sw", False)
    finally:
        tail_cuda.normalize_blocks = orig
    assert calls == [(2, 3, 80, 64), (2, 3, 99, 64)]   # 64x80, 65x83
    assert tail_cuda.normalize_blocks.launches == before


@pytest.mark.parametrize("instance", ["resident", "two_pass"])
def test_k8u_wrapper_takes_either_plan(instance):
    """A crop (63x80 and 64x77 of the 8x10 blocks) with either instance's
    plan forced gives the twin's bytes through the wrapper on CPU tensors
    (the plan is the card's), and launches nothing."""
    blocks, x = _k8_case("frames")
    plan = (tail_cuda.NormPlan("resident", 132, 2, 4) if instance ==
            "resident" else tail_cuda.NormPlan("two_pass"))
    before = dict(tail_cuda.INSTANCE_LAUNCHES)
    for h, w in ((63, 80), (64, 77)):
        for out_u8 in (True, False):
            got = tail_cuda.normalize_blocks(blocks, x, K, h, w, out_u8=out_u8,
                                             to_frames=True, plan=plan)
            ref = tail_cuda.normalize_blocks_plain(blocks, x, K, h, w,
                                                   out_u8=out_u8,
                                                   to_frames=True)
            assert got.shape == (2, h, w, 3) and torch.equal(got, ref)
    assert tail_cuda.INSTANCE_LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "blocks", "columns", "lead",
                                 "frames_without_channels", "device"])
def test_k8_wrapper_refuses_bad_input(bad):
    blocks, x = _k8_case("frames")
    h, w, cl, match, kw = 64, 80, True, "float32", {}
    if bad == "dtype":
        blocks = blocks.to(torch.float64)
    elif bad == "blocks":
        w, match = 88, "blocks must be"
    elif bad == "columns":
        x, match = x[..., :2].contiguous(), "x must be"
    elif bad == "lead":
        x, match = x[:1], "x must be"
    elif bad == "frames_without_channels":
        blocks, x = _k8_case("planes")
        blocks, x = blocks[0], x[0]
        match = "channel dimension"
    else:
        blocks = torch.empty(blocks.shape, device="meta")
        x = torch.empty(x.shape, device="meta")
        match = "unsupported device"
    with pytest.raises(ValueError, match=match):
        tail_cuda.normalize_blocks(blocks, x, K, h, w, to_frames=cl, **kw)


# Inputs that leave the plain path: a NaN in an unflagged block, ±inf
# (+inf unflagged, -inf in a block the repaint covers), a plane with every
# block flagged beside unflagged ones; on 1, 4 and 33 frames at the card
# tests' 64×280 (35 blocks a row). Compared in f32 (a NaN window makes
# the plane NaN, whose u8 cast neither package defines) and, where every
# value is finite, in u8 too.
K8_SPECIAL = ["nan", "inf", "all_flagged_beside_unflagged"]


def _k8_special(layout, case, frames):
    blocks, x = _k8_case(layout, frames=frames, w=280, seed=SEED + 62)
    cl = layout == "frames"
    last = frames - 1
    if case == "nan":
        at = (0, 1, 7) if cl else (0, 7)
        blocks[at + (5,)] = float("nan")
        x[at + (K,)] = 0.0
    elif case == "inf":
        up, down = ((0, 1, 9), (last, 2, 11)) if cl else ((0, 9), (last, 11))
        blocks[up + (3,)] = float("inf")
        x[up + (K,)] = 0.0
        blocks[down + (0,)] = -float("inf")
        x[down + (K,)] = 1.0
    else:
        x[(0, 1) if cl else (0,)][..., K] = 1.0
        if not cl and frames > 1:
            x[1, :, K] = 0.0
    return blocks, x


@pytest.mark.parametrize("frames", [1, 4, 33])
@pytest.mark.parametrize("case", K8_SPECIAL)
@pytest.mark.parametrize("layout", ["frames", "planes"])
def test_k8_twin_equals_jax_on_special_planes(layout, case, frames):
    blocks, x = _k8_special(layout, case, frames)
    cl = layout == "frames"
    kinds = [False] + ([True] if case == "all_flagged_beside_unflagged"
                       else [])
    for out_u8 in kinds:
        got = tail_cuda.normalize_blocks(blocks, x, K, 64, 280,
                                         out_u8=out_u8, to_frames=cl)
        ref = _jax_default(blocks, x, 64, 280, True, out_u8, cl)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got.numpy(), ref)
    if case == "nan":
        nan_plane = got[0, ..., 1] if cl else got[0]
        assert bool(torch.isnan(nan_plane).all())
    elif case == "all_flagged_beside_unflagged":
        flat = got[0, ..., 1] if cl else got[0]
        assert torch.equal(flat, flat[:1, :1].expand_as(flat))
        if cl:                       # its unflagged neighbour spans [0, 255]
            assert float(got[0, ..., 0].max()) == 255.0


# K8's plan (tail_cuda.norm_plan): which instance a batch takes, with the
# SM count and shared memory of an H100 (132 SMs, 232,448 bytes a CTA)
# unless a case says otherwise. 1080p is 32,400 blocks a plane, 4K
# 129,600, an 8K band of 1080 rows 129,600, 512x512 4,096. An (h, w) in
# place of the blocks is a crop's plan through tail_cuda.shape_plan (K8u),
# whose padded grid is as many blocks as an aligned plane's: 1079x1917
# 32,400 (1080p's plan), 768x1366 16,416, 480x854 6,420, 2159x3839
# 129,600.
H100 = (132, 232448)
_AT_LIMIT = tail_cuda.resident_smem(3, 200, 1)
_FOUR_GRAY = tail_cuda.resident_smem(1, 200, 4)
K8_PLANS = {
    # id: (frames, chans, n_blk, (sms, smem), instance, (ring, chunk))
    "1080p_color_32": (32, 3, 32400, H100, "resident", (2, 124)),
    "1080p_color_128": (128, 3, 32400, H100, "resident", (2, 124)),
    "1080p_gray_32": (32, 1, 32400, H100, "resident", (3, 248)),
    "1080p_gray_128": (128, 1, 32400, H100, "resident", (3, 248)),
    "one_frame": (1, 3, 32400, H100, "resident", (2, 124)),
    "512gray_128": (128, 1, 4096, H100, "two_pass", None),
    "4k_color": (2, 3, 129600, H100, "two_pass", None),
    "4k_gray": (2, 1, 129600, H100, "two_pass", None),
    "8k_band": (1, 1, 129600, H100, "two_pass", None),
    "8k_plane": (1, 1, 518400, H100, "two_pass", None),
    "at_the_limit": (8, 3, 132 * 200, (132, _AT_LIMIT), "resident",
                     (2, 100)),
    "a_block_over": (8, 3, 132 * 200 + 1, (132, _AT_LIMIT), "two_pass",
                     None),
    "three_gray_shares": (8, 1, 132 * 200, (132, _FOUR_GRAY - 1),
                          "resident", (3, 200)),
    "four_gray_shares": (8, 1, 132 * 200, (132, _FOUR_GRAY), "two_pass",
                         None),
    "114_sms_color": (32, 3, 32400, (114, 232448), "two_pass", None),
    "114_sms_gray": (32, 1, 32400, (114, 232448), "resident", (2, 288)),
    "no_cooperative_launch": (32, 3, 32400, (132, 0), "two_pass", None),
    "2_planes": (32, 2, 32400, H100, "two_pass", None),
    "tiny_frame": (2, 3, 40, H100, "two_pass", None),
    "1079x1917_color_32": (32, 3, (1079, 1917), H100, "resident", (2, 124)),
    "1079x1917_gray_32": (32, 1, (1079, 1917), H100, "resident", (3, 248)),
    "1366x768_color": (32, 3, (768, 1366), H100, "resident", (2, 128)),
    "1366x768_gray": (32, 1, (768, 1366), H100, "two_pass", None),
    "854x480_color": (32, 3, (480, 854), H100, "two_pass", None),
    "2159x3839_color": (2, 3, (2159, 3839), H100, "two_pass", None),
}


@pytest.mark.parametrize("case", list(K8_PLANS))
def test_k8_plan_by_shape(case):
    frames, chans, n_blk, (sms, smem), instance, want = K8_PLANS[case]
    if isinstance(n_blk, tuple):
        h, w = n_blk
        assert h % 8 or w % 8
        plan = tail_cuda.shape_plan(frames, chans, h, w, True, sms, smem)
        assert tail_cuda.shape_plan(frames, chans, h, w, False, sms,
                                    smem).instance == "two_pass"
        n_blk = -(-h // 8) * -(-w // 8)
        assert plan == tail_cuda.norm_plan(frames, chans, n_blk, True, sms,
                                           smem)
    else:
        plan = tail_cuda.norm_plan(frames, chans, n_blk, True, sms, smem)
    assert plan.instance == instance, plan
    assert tail_cuda.norm_plan(frames, chans, n_blk, False, sms,
                               smem).instance == "two_pass"
    if instance == "two_pass":
        assert plan == tail_cuda.NormPlan("two_pass")
        return
    assert (plan.ring, plan.chunk) == want
    assert plan.ctas == min(sms, n_blk)
    shares = tail_cuda.block_shares(n_blk, plan.ctas)
    assert len(shares) == plan.ctas and sum(shares) == n_blk
    assert max(shares) - min(shares) <= 1 and min(shares) >= 1
    assert plan.chunk % 4 == 0
    chunks = -(-max(shares) // plan.chunk)            # a frame's chunks
    assert plan.ring >= chunks
    assert plan.smem == tail_cuda.resident_smem(chans, plan.chunk,
                                                plan.ring)
    assert plan.smem <= smem
    # the ring takes every slot that fits, and a frame's whole share does
    # not fit four times
    assert tail_cuda.resident_smem(chans, plan.chunk, plan.ring + 1) > smem
    assert tail_cuda.resident_smem(chans, (max(shares) + 3) // 4 * 4,
                                   4) > smem


def test_k8_layout_of_the_product():
    """The strides the kernel is given for the product's strided view
    (blocks F_pad·64 floats apart, frames 64, channels N blocks apart),
    and the layouts it refuses: pixels not contiguous, block or frame
    strides off 16 bytes, channels not N blocks apart."""
    blocks, _ = _k8_case("frames", frames=3)
    pad = tb.RECON_FRAMES
    assert tail_cuda._blocks_strides(blocks, True) == (pad * 64, 64, 1)
    assert tail_cuda._blocks_strides(blocks, False) == (pad * 64, 64, 1)
    gray, _ = _k8_case("planes", frames=3)
    assert tail_cuda._blocks_strides(gray, False) == (pad * 64, 64, 1)
    assert tail_cuda._blocks_strides(gray[:1], False)[1:] == (0, 0)
    wide = torch.zeros(2, 3, 80, 68)
    refused = {
        "pixels": torch.zeros(2, 3, 64, 80).transpose(-1, -2),
        "block_stride": wide[..., 2:66],
        "channels": torch.zeros(3, 2, 80, 64).transpose(0, 1),
    }
    for name, t in refused.items():
        with pytest.raises(ValueError, match="normalize_blocks needs"):
            tail_cuda._blocks_strides(t, True)
