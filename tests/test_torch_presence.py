"""The rest of the extract tail against the JAX package on the CPU: K18's
twin (the presence statistic, ops/tail_cuda.py::presence_plain) against
the JAX package's statistic, K8u's twin (K8 with a crop,
tail_cuda.normalize_blocks_plain at sizes that are not multiples of 8)
against its ``_masked_normalize`` with the clip and cast, the request
extract's block-layout IDCT against the plane form, and the request
extract itself (models/blocked.py::extract_array) against the JAX
package's.

Inputs come from seeded numpy generators. Tolerances, with their reasons:

- K18's rho0 within 1e-5 of the JAX package's (a Pearson in [-1, 1]; the
  twin sums each group in the kernel's fixed order, metrics.nc in numpy's
  and XLA's), NaN where it has NaN, and the decision equal;
- K8u's twin byte-equal (u8) and equal (f32) to the JAX normaliser: min
  and max are exact in any order, the rest is the same elementwise
  arithmetic (the scale divides once in both);
- the block-layout IDCT torch.equal to the plane form: one contraction,
  its output left in another order;
- the request extract within 2 u8 quanta of the JAX package's: the bound
  tests/test_torch_cli.py holds extract_array to (the estimator and the
  products round in another order).
"""

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dctsvd_tpu.io import meta as jmeta
from dctsvd_tpu.models import blocked as jb
from dctsvd_tpu.ops import dct as jdct
from dctsvd_tpu.ops import metrics as jmetrics
from dctsvd_tpu.utils import crypto as jcrypto
from dctsvd_tpu_torch.io import meta as tmeta
from dctsvd_tpu_torch.models import blocked as tb
from dctsvd_tpu_torch.ops import dct as tdct
from dctsvd_tpu_torch.ops import tail_cuda

torch.set_num_threads(2)

SEED = 20261025
ALPHA = 0.15
PW = "torch-presence"


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


# ---------------------------------------------------------------------------
# K18's twin against the JAX package's presence statistic
# (dctsvd_tpu/models/blocked.py::_shrink_sw_hat, which does not return its
# decision: the same groups through its own metrics.nc, sort and knee).
# ---------------------------------------------------------------------------

# case: (blocks a plane, what the estimate is, the decision expected of
# every plane or None where the case does not fix it)
PRESENCE_CASES = {
    "present": (480, "present", True),
    "absent": (480, "absent", False),
    "zeroed_quadrant": (480, "zeroed", None),
    "mark_free": (480, "mark_free", False),
    "n_below_16": (12, "present", False),
    "n_not_multiple_of_16": (1000, "present", True),
    "n_47": (47, "present", None),
    "nan": (480, "nan", True),
    "1080p": (32400, "present", True),
}


def _presence_case(case, layout, frames=3):
    """(s_cw, sc, sw) numpy arrays of a case: the stego spectrum's column
    rows [F, (3,) N, 8] with sc, and sw [(3,) N, 8], whose raw estimate
    (s_cw - sc) / ALPHA is Sw plus noise (present), with a quarter of the
    blocks, scattered, destroyed (zeroed: large negative estimates, as a
    zeroed quadrant's blocks in slot order), with three quarters destroyed
    (absent), unrelated to Sw (mark_free), or present with one NaN."""
    n, kind, _ = PRESENCE_CASES[case]
    rng = np.random.default_rng(SEED + sum(map(ord, case + layout)))
    cd = (3,) if layout == "color" else ()
    sw = rng.uniform(1, 30, (*cd, n, 8)).astype(np.float32)
    ref = np.broadcast_to(sw, (frames, *cd, n, 8))
    raw = ref + rng.normal(0, 1.5, ref.shape)
    destroyed = {"zeroed": 0.25, "absent": 0.75}.get(kind)
    if destroyed:
        hit = rng.random((frames, *cd, n)) < destroyed
        raw[hit] = -rng.uniform(100, 1000, raw[hit].shape)
    if kind == "mark_free":
        raw = rng.normal(0, 40, ref.shape)
    sc = rng.uniform(0, 200, ref.shape).astype(np.float32)
    s_cw = (sc + raw * ALPHA).astype(np.float32)
    if kind == "nan":
        s_cw[1, ..., n // 3, 0] = np.nan
    return s_cw, sc, sw


def _jax_presence(raw, sw):
    """The JAX package's statistic: rho0 and the decision."""
    ref = jnp.broadcast_to(jnp.asarray(sw), raw.shape)
    n = raw.shape[-2]
    gsz = max(1, n // 16)
    ng = n // gsz
    a0 = ref[..., :ng * gsz, 0].reshape(*ref.shape[:-2], ng, gsz)
    b0 = raw[..., :ng * gsz, 0].reshape(*raw.shape[:-2], ng, gsz)
    rho0 = jnp.sort(jmetrics.nc(a0, b0), axis=-1)[..., ng - -(-ng // 4)]
    engage = rho0 >= 0.20 + 1.8 / jnp.sqrt(jnp.float32(gsz))
    return np.asarray(rho0), np.asarray(engage)


@pytest.mark.parametrize("layout", ["color", "gray"])
@pytest.mark.parametrize("case", list(PRESENCE_CASES))
def test_presence_twin_matches_jax(case, layout):
    s_cw, sc, sw = _presence_case(case, layout)
    raw = (jnp.asarray(s_cw) - jnp.asarray(sc)) / jnp.maximum(
        jnp.float32(ALPHA), 1e-8)
    rho_j, engage_j = _jax_presence(raw, sw)
    a = torch.tensor(ALPHA)
    got = tail_cuda.presence(torch.from_numpy(s_cw), torch.from_numpy(sw),
                             torch.from_numpy(sc), a)
    # the raw estimate through the load form, as models/blocked._engaged
    # hands it (sc = 0, alpha = 1)
    raw_t = (torch.from_numpy(s_cw) - torch.from_numpy(sc)) / a
    from_raw = tail_cuda.presence(raw_t, torch.from_numpy(sw),
                                  torch.zeros(1), torch.ones(1))
    assert torch.equal(tb._engaged(raw_t, torch.from_numpy(sw)), from_raw[0])
    for engage, rho0 in (got, from_raw):
        assert engage.dtype == torch.bool
        assert tuple(engage.shape) == rho_j.shape == s_cw.shape[:-2]
        nan = np.isnan(rho_j)
        assert np.array_equal(np.isnan(rho0.numpy()), nan)
        assert np.abs(np.where(nan, 0, rho0.numpy() - rho_j)).max() <= 1e-5
        assert np.array_equal(engage.numpy(), engage_j)
    want = PRESENCE_CASES[case][2]
    if want is not None:
        assert bool((got[0] == want).all()), got[1]


@pytest.mark.parametrize("gsz", [1, 2, 5, 30, 62, 2025, 8100, 32400])
def test_presence_knee_is_the_jax_packages(gsz):
    knee = 0.20 + 1.8 / jnp.sqrt(jnp.float32(gsz))
    assert tail_cuda.presence_knee(gsz) == float(knee)
    assert np.float32(tail_cuda.presence_knee(gsz)) == np.asarray(knee)


@pytest.mark.parametrize("n, want", [(12, (1, 12, 9)), (16, (1, 16, 12)),
                                     (31, (1, 31, 23)), (32, (2, 16, 12)),
                                     (47, (2, 23, 17)), (480, (30, 16, 12)),
                                     (1000, (62, 16, 12)),
                                     (32400, (2025, 16, 12))])
def test_presence_groups(n, want):
    assert tail_cuda.presence_groups(n) == want


def test_presence_is_batch_invariant_and_routes_engaged():
    """A frame's rho0 is the same alone and in the batch (one fixed order
    a group), and models/blocked._engaged is the wrapper's decision (the
    twin on the CPU; no launch counted)."""
    s_cw, sc, sw = (torch.from_numpy(a) for a in
                    _presence_case("zeroed_quadrant", "color", frames=5))
    a = torch.tensor(ALPHA)
    before = tail_cuda.presence.launches
    engage, rho0 = tail_cuda.presence(s_cw, sw, sc, a)
    for i in range(5):
        e1, r1 = tail_cuda.presence(s_cw[i], sw, sc[i], a)
        assert torch.equal(r1, rho0[i]) and torch.equal(e1, engage[i])
    raw = tb._raw_estimate(s_cw, sc, ALPHA)
    assert torch.equal(tb._engaged(raw, sw), engage)
    assert tail_cuda.presence.launches == before


@pytest.mark.parametrize("bad", ["dtype", "blocks", "channels", "sc_shape",
                                 "no_alpha", "device"])
def test_presence_refuses_bad_input(bad):
    s_cw, sc, sw = (torch.from_numpy(a) for a in
                    _presence_case("present", "color"))
    a, match = torch.tensor(ALPHA), "float32"
    if bad == "dtype":
        s_cw = s_cw.double()
    elif bad == "blocks":
        sw, match = sw[:, :-1], "s_cw must be"
    elif bad == "channels":
        sw, match = sw[:2], "s_cw must be"
    elif bad == "sc_shape":
        sc, match = sc[..., :-1, :], "does not broadcast"
    elif bad == "no_alpha":
        a, match = None, "needs alpha"
    else:
        s_cw = torch.empty(s_cw.shape, device="meta")
        match = "unsupported device"
    with pytest.raises(ValueError, match=match):
        tail_cuda.presence(s_cw, sw, sc, a)


# ---------------------------------------------------------------------------
# K8u's twin against the JAX package's _masked_normalize with the clip and
# cast, on the unblockified, cropped plane of seeded blocks (N(s, s²) at a
# few scales); the flags none, a fifth or all of the blocks.
# ---------------------------------------------------------------------------

CROP_SIZES = [(65, 83), (129, 243), (1083, 1917), (3, 5)]


def _crop_case(h, w, layout, flags, seed):
    rng = np.random.default_rng(seed)
    hb, wb = -(-h // 8), -(-w // 8)
    frames = 1 if h > 1000 else 2
    cd = (3,) if layout == "frames" else ()
    scale = float(10.0 ** rng.integers(-2, 3))
    blocks = (rng.standard_normal((frames, *cd, hb * wb, 64)) * scale
              + scale).astype(np.float32)
    x = rng.standard_normal((frames, *cd, hb * wb, 5)).astype(np.float32)
    share = {"none": 0.0, "some": 0.2, "all": 1.0}[flags]
    x[..., 4] = (rng.random(x.shape[:-1]) < share).astype(np.float32)
    return blocks, x


def _jax_masked(blocks, x, h, w, normalize, flags, frames):
    hb, wb = -(-h // 8), -(-w // 8)
    b = jnp.asarray(blocks).reshape(*blocks.shape[:-1], 8, 8)
    wy = jdct.unblockify(b, hb * 8, wb * 8)[..., :h, :w]
    bad = jnp.asarray(x[..., 4] > 0.5) if flags != "none" else None
    out = jb._masked_normalize(wy, bad, hb * 8, wb * 8, h, w, normalize)
    u8 = jnp.clip(out, 0, 255).astype(jnp.uint8)
    if frames:
        out, u8 = (jnp.moveaxis(t, -3, -1) for t in (out, u8))
    return np.asarray(out), np.asarray(u8)


@pytest.mark.parametrize("normalize", [True, False],
                         ids=["normalize", "raw"])
@pytest.mark.parametrize("flags", ["none", "some", "all"])
@pytest.mark.parametrize("layout", ["frames", "planes"])
@pytest.mark.parametrize("hw", CROP_SIZES,
                         ids=[f"{h}x{w}" for h, w in CROP_SIZES])
def test_k8u_twin_equals_jax_masked_normalize(hw, layout, flags, normalize):
    h, w = hw
    blocks, x = _crop_case(h, w, layout, flags, SEED + h + w)
    ref_f32, ref_u8 = _jax_masked(blocks, x, h, w, normalize, flags,
                                  layout == "frames")
    tx = torch.from_numpy(x if flags != "none" else x[..., :4].copy())
    for out_u8, ref in ((True, ref_u8), (False, ref_f32)):
        got = tail_cuda.normalize_blocks(torch.from_numpy(blocks), tx, 4, h,
                                         w, normalize=normalize,
                                         out_u8=out_u8,
                                         to_frames=layout == "frames")
        assert got.shape == ref.shape
        assert np.array_equal(got.numpy(), ref), (
            f"{int((got.numpy() != ref).sum())} of {ref.size} differ")
    if flags == "all" and normalize:
        planes = got if layout == "planes" else torch.movedim(got, -1, 1)
        flat = planes.reshape(*planes.shape[:2], -1) if layout == "frames" \
            else planes.reshape(planes.shape[0], -1)
        assert torch.equal(flat, flat[..., :1].expand_as(flat))


def test_k8u_window_leaves_the_pixels_outside_the_crop():
    """An extreme value outside the crop moves no byte; inside it does."""
    h, w = 65, 83
    blocks, x = _crop_case(h, w, "planes", "some", SEED + 7)
    x[..., 4] = 0.0
    base = tail_cuda.normalize_blocks(torch.from_numpy(blocks),
                                      torch.from_numpy(x), 4, h, w)
    outside = blocks.copy()
    wb = -(-w // 8)
    outside[:, 8 * wb + wb - 1, 63] = 1e9      # row 15, column 87
    inside = blocks.copy()
    inside[:, 0, 0] = 1e9
    got = [tail_cuda.normalize_blocks(torch.from_numpy(b),
                                      torch.from_numpy(x), 4, h, w)
           for b in (outside, inside)]
    assert torch.equal(got[0], base) and not torch.equal(got[1], base)


def test_one_block_frames_take_the_products_layout():
    """A frame of one block a plane (8 x 8 pixels or less): the product's
    strided view (models/blocked._recon) has an arbitrary stride on its
    one-block dimension; the kernel is given the channels' instead, and
    the twin's bytes do not depend on it."""
    rng = np.random.default_rng(SEED + 9)
    x = torch.from_numpy(rng.standard_normal((2, 3, 1, 5)).astype(
        np.float32))
    x[..., 4] = 0.0
    eb64 = torch.from_numpy(rng.standard_normal((3, 1, 4, 64)).astype(
        np.float32))
    blocks = tb._recon(x[..., :4], eb64)
    pad = tb.RECON_FRAMES
    assert tail_cuda._blocks_strides(blocks, True) == (pad * 64, 64, 1)
    got = tail_cuda.normalize_blocks(blocks, x, 4, 3, 5, to_frames=True)
    ref = tail_cuda.normalize_blocks(blocks.contiguous(), x, 4, 3, 5,
                                     to_frames=True)
    assert got.shape == (2, 3, 5, 3) and torch.equal(got, ref)


# ---------------------------------------------------------------------------
# The request extract's IDCT: natural-order pixel blocks, the plane
# form's product with its output left in block order.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("perm", [False, True], ids=["plain", "unshuffle"])
@pytest.mark.parametrize("shape", [((), 72, 88), ((2,), 64, 80),
                                   ((1, 3), 136, 248)],
                         ids=["72x88", "2x64x80", "3x136x248"])
def test_block_layout_idct_equals_plane(shape, perm):
    lead, h, w = shape
    rng = np.random.default_rng(SEED + h)
    coefs = torch.from_numpy(rng.standard_normal(
        (*lead, (h // 8) * (w // 8), 8, 8)).astype(np.float32) * 50)
    row_perm = torch.from_numpy(rng.permutation(64)) if perm else None
    plane = tdct.idct2_blocks_to_plane(coefs, h, w, row_perm=row_perm)
    blocks = tdct.idct2_pixel_blocks(coefs, h, w, row_perm=row_perm)
    assert blocks.shape == (*lead, (h // 8) * (w // 8), 64)
    assert torch.equal(tdct.unblockify(
        blocks.reshape(*blocks.shape[:-1], 8, 8), h, w), plane)
    ref = jdct.idct2_blocks_to_plane(jnp.asarray(coefs.numpy()), h, w,
                                     row_perm=None if row_perm is None else
                                     jnp.asarray(row_perm.numpy()))
    np.testing.assert_allclose(plane.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# The request extract (extract_array: api.extract, the CLI, the GUI,
# payloads) against the JAX package's, on a port-embedded stego read back
# from its PNG and meta, aligned and unaligned, gray and color, clean and
# with three quadrants zeroed (flagged blocks).
# ---------------------------------------------------------------------------

REQUEST_SIZES = [(64, 80), (65, 83), (128, 240), (129, 243)]


@pytest.fixture(scope="module")
def request_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_presence")
    out = {}
    for i, (h, w) in enumerate(REQUEST_SIZES):
        rng = np.random.default_rng(SEED + 100 + i)
        cover = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                                 (0, 0), 1.0)
        wm = rng.integers(0, 256, (h, w, 3), np.uint8)
        for color in (True, False):
            nonce = bytes(range(i, i + 16))
            key = jcrypto.derive_key(PW, nonce)
            sp, mp, _, _ = tb.embed_paths(
                cover, wm, str(d / f"s_{h}x{w}_{color}.png"),
                str(d / f"m_{h}x{w}_{color}.npz"), alpha=ALPHA, color=color,
                key=key, nonce=nonce, kfrac=0.6, device="cpu")
            out[(h, w), color] = (cv2.imread(sp, cv2.IMREAD_COLOR), mp, key)
    return out


@pytest.mark.parametrize("case", ["stego", "zeroed"])
@pytest.mark.parametrize("color", [True, False], ids=["color", "gray"])
@pytest.mark.parametrize("hw", REQUEST_SIZES,
                         ids=[f"{h}x{w}" for h, w in REQUEST_SIZES])
def test_request_extract_matches_jax(request_files, hw, color, case):
    stego, mp, key = request_files[hw, color]
    if case == "zeroed":
        stego = stego.copy()
        stego[hw[0] // 2:] = 0
        stego[:, hw[1] // 2:] = 0
    mj, mt = jmeta.load_meta(mp), tmeta.load_meta(mp)
    ref = np.asarray(jb.extract_array(stego, mj, key))
    calls = []
    orig = tail_cuda.normalize_blocks

    def spy(*args, **kw):
        calls.append(args[3:5])
        return orig(*args, **kw)
    tail_cuda.normalize_blocks = spy
    try:
        got = tb.extract_array(stego, mt, key, device="cpu")
    finally:
        tail_cuda.normalize_blocks = orig
    assert calls == [hw]                       # K8 / K8u, once
    assert got.dtype == np.uint8 and got.shape == ref.shape == (
        (*hw, 3) if color else hw)
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 2, (d.max(), (d > 0).mean())
