"""The port's detect statistic (dctsvd_tpu_torch/ops/detect_cuda.py, K9's
plain twin, and the detect paths over it) against the JAX package on the
CPU.

Spectra come from numpy with a seed: sw sorted descending in each block,
sc per frame, and s_cw = sc + α·ŝ with ŝ genuine (sw scaled by 0.6-1.1
plus noise) or mark-free (noise alone); the same arrays go to both
packages. The twin's frame and band scores are held within 1e-5 of the
JAX package's _band_nc and of its metrics.nc · band_scale_damp ·
band_presence_damp band scores; the detect paths (detect_gray,
detect_color, a resync chunk, the serve+score step) within 1e-3, the
tolerance tests/test_torch_blocked.py pins."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dctsvd_tpu.models import blocked as jb
from dctsvd_tpu.ops import color as jcolor
from dctsvd_tpu.ops import metrics as jmetrics
from dctsvd_tpu.ops import wm_pallas
from dctsvd_tpu.utils import crypto as jcrypto
from dctsvd_tpu_torch.models import blocked as tb
from dctsvd_tpu_torch.ops import color as tcolor
from dctsvd_tpu_torch.ops import detect_cuda

torch.set_num_threads(2)

SEED = 20261027
ALPHA = 0.12
K = 4
SWEEPS = 1.25
PW = "torch-detect"
TOL = 1e-5          # the twin against the JAX statistic, per score
PATH_TOL = 1e-3     # the detect paths against the JAX package's

GRIDS = {"135x240": (135, 240), "9x11": (9, 11), "3x17": (3, 17),
         "1x1": (1, 1), "2x3": (2, 3)}


def _spectra(hb, wb, color, mark, frames=2, seed=SEED, shared=False):
    """(s_cw [frames, (3,) N, 8], sc [frames, (3,) N, 8] or, ``shared``,
    one [(3,) N, 8] for every frame, sw [(3,) N, 8]) as f32 numpy."""
    rng = np.random.default_rng(seed)
    cd = (3,) if color else ()
    n = hb * wb
    sw = -np.sort(-rng.random((*cd, n, 8)) * 40, axis=-1)
    sc = rng.random(((1 if shared else frames), *cd, n, 8)) * 200
    noise = rng.normal(0.0, 4.0, (frames, *cd, n, 8))
    if mark == "genuine":
        ratio = rng.uniform(0.6, 1.1, (frames, *[1] * sw.ndim))
        hat = sw * ratio + noise
    else:
        hat = noise
    s_cw = sc + ALPHA * hat
    return (s_cw.astype(np.float32),
            (sc[0] if shared else sc).astype(np.float32),
            sw.astype(np.float32))


def _twin(s_cw, sc, sw, hb, wb, grid=4, reduce=True):
    return detect_cuda.band_scores_plain(
        torch.from_numpy(s_cw), torch.from_numpy(sc), torch.from_numpy(sw),
        torch.tensor(ALPHA, dtype=torch.float32), K, hb, wb, grid,
        reduce=reduce).numpy()


def _jax_hat(s_cw, sc):
    """detect_gray's / detect_color's rectified estimate."""
    return (jnp.maximum((jnp.asarray(s_cw) - jnp.asarray(sc))[..., :K], 0.0)
            / jnp.maximum(jnp.float32(ALPHA), 1e-8))


def _jax_scores(s_cw, sc, sw, hb, wb, grid=4):
    """The JAX package's frame scores: _band_nc, and detect_color's
    channel mean."""
    scores = jb._band_nc(jnp.asarray(sw)[..., :K], _jax_hat(s_cw, sc), hb,
                         wb, grid=grid)
    return np.asarray(jnp.mean(scores, axis=-1) if sw.ndim == 3 else scores)


def _jax_bands(s_cw, sc, sw, hb, wb, grid):
    """The band scores dctsvd_tpu/parallel/plane.py::_detect_body forms
    before its all_gather (metrics.nc · band_scale_damp ·
    band_presence_damp over to_bands' cut), batched over the frames."""
    hat = _jax_hat(s_cw, sc)
    ref = jnp.broadcast_to(jnp.asarray(sw)[..., :K], hat.shape)
    g = max(1, min(grid, hb, wb))
    gh, gw = hb // g, wb // g

    def to_bands(x):
        lead = x.shape[:-2]
        x = x.reshape(*lead, hb, wb, K)[..., :g * gh, :g * gw, :]
        x = jnp.swapaxes(x.reshape(*lead, g, gh, g, gw, K), -4, -3)
        return x.reshape(*lead, g * g, gh * gw, K)

    sw_b, hat_b = to_bands(ref), to_bands(hat)
    sw_f = sw_b.reshape(*sw_b.shape[:-2], -1)
    hat_f = hat_b.reshape(*hat_b.shape[:-2], -1)
    return np.asarray(jmetrics.nc(sw_f, hat_f)
                      * jb.band_scale_damp(sw_f, hat_f)
                      * jb.band_presence_damp(sw_b, hat_b))


@pytest.mark.parametrize("mark", ["genuine", "mark_free"])
@pytest.mark.parametrize("sc_mode", ["per_frame", "shared"])
@pytest.mark.parametrize("layout", ["gray", "color"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_twin_frame_scores_match_jax(grid, layout, sc_mode, mark):
    """Frame scores (median of the bands, channel mean in color) within
    1e-5 of the JAX package's _band_nc, with sc per frame or one shared
    [(3,) N, 8] (as the resync chunks pass it); at 1080p genuine estimates
    score above the detector's 0.30 threshold and mark-free ones below
    it."""
    hb, wb = GRIDS[grid]
    s_cw, sc, sw = _spectra(hb, wb, layout == "color", mark,
                            shared=sc_mode == "shared")
    got = _twin(s_cw, sc, sw, hb, wb)
    ref = _jax_scores(s_cw, np.broadcast_to(sc, s_cw.shape), sw, hb, wb)
    assert got.shape == ref.shape == (2,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    if grid == "135x240":
        assert (got > 0.3).all() if mark == "genuine" else (got < 0.3).all()


@pytest.mark.parametrize("layout", ["gray", "color"])
@pytest.mark.parametrize("grid", ["135x240", "9x11", "3x17", "2x3"])
def test_twin_band_scores_match_jax_at_grid_2(grid, layout):
    """At grid 2 the frame scores are within 1e-5 of the JAX _band_nc(...,
    grid=2), and the band scores (reduce=False, what parallel/plane.py
    gathers) band by band within 1e-5 of the composition the JAX package's
    plane-sharded detect forms."""
    hb, wb = GRIDS[grid]
    s_cw, sc, sw = _spectra(hb, wb, layout == "color", "genuine",
                            seed=SEED + 1)
    np.testing.assert_allclose(_twin(s_cw, sc, sw, hb, wb, grid=2),
                               _jax_scores(s_cw, sc, sw, hb, wb, grid=2),
                               rtol=0, atol=TOL)
    bands = _twin(s_cw, sc, sw, hb, wb, grid=2, reduce=False)
    ref = _jax_bands(s_cw, sc, sw, hb, wb, 2)
    g = max(1, min(2, hb, wb))
    assert bands.shape == ref.shape == (*s_cw.shape[:-2], g * g)
    np.testing.assert_allclose(bands, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("layout", ["gray", "color"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_twin_band_scores_match_jax(grid, layout):
    """The band scores at the default grid within 1e-5 of the JAX
    composition, band by band, and their median (channel mean in color)
    is the frame score."""
    hb, wb = GRIDS[grid]
    s_cw, sc, sw = _spectra(hb, wb, layout == "color", "genuine",
                            seed=SEED + 2)
    bands = _twin(s_cw, sc, sw, hb, wb, reduce=False)
    np.testing.assert_allclose(bands, _jax_bands(s_cw, sc, sw, hb, wb, 4),
                               rtol=0, atol=TOL)
    med = tb._median_last(torch.from_numpy(bands))
    frame = med.mean(dim=-1) if layout == "color" else med
    np.testing.assert_allclose(frame.numpy(), _twin(s_cw, sc, sw, hb, wb),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("layout", ["gray", "color"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_clean_host_scores_exactly_zero(grid, layout):
    """s_cw = sc (an unmarked host measured against its own meta): every
    band and frame score is exactly 0, in the twin and in the JAX
    package."""
    hb, wb = GRIDS[grid]
    _, sc, sw = _spectra(hb, wb, layout == "color", "genuine")
    assert not _twin(sc, sc, sw, hb, wb).any()
    assert not _twin(sc, sc, sw, hb, wb, reduce=False).any()
    assert not _jax_scores(sc, sc, sw, hb, wb).any()


def test_twin_refuses_bad_input():
    """Shapes, dtypes, k and alpha the statistic cannot take raise."""
    s_cw, sc, sw = (torch.from_numpy(a) for a in
                    _spectra(9, 11, True, "genuine"))
    a = torch.tensor(ALPHA)
    with pytest.raises(ValueError, match="blocks"):
        detect_cuda.band_scores(s_cw, sc, sw, a, K, 9, 10)
    with pytest.raises(ValueError, match="k must"):
        detect_cuda.band_scores(s_cw, sc, sw, a, 0, 9, 11)
    with pytest.raises(ValueError, match="float32"):
        detect_cuda.band_scores(s_cw.double(), sc, sw, a, K, 9, 11)
    with pytest.raises(ValueError, match="broadcast"):
        detect_cuda.band_scores(s_cw, sc[:, :2], sw, a, K, 9, 11)
    with pytest.raises(ValueError, match="s_cw"):
        detect_cuda.band_scores(s_cw[:, 0], sc[:, 0], sw, a, K, 9, 11)
    with pytest.raises(ValueError, match="one alpha"):
        detect_cuda.band_scores(s_cw, sc, sw, a.repeat(2), K, 9, 11)


# grids (hb, wb, grid) of the main paths: a 512² frame (m = 256), 1080p
# (1,980), 4K (8,040) and an 8K plane shard's band (parallel/plane.py's
# grid 2: 32,160 blocks)
PLAN_GRIDS = {"512": ((64, 64, 4), 1, True), "1080p": ((135, 240, 4), 8, True),
              "4k": ((270, 480, 4), 32, False),
              "8k_shard": ((135, 960, 2), 126, False),
              "resident_edge": ((64, 128, 2), 8, True),
              "past_the_edge": ((6, 1366, 2), 9, False)}


@pytest.mark.parametrize("grid", list(PLAN_GRIDS))
def test_band_plan_takes_the_resident_path_up_to_its_rows(grid):
    """K9's plan: a band of at most 256 · RESIDENT_ROWS blocks is read
    once (each thread keeps its rows), a larger one twice; the rows a
    band spans are ceil(m / 256)."""
    (hb, wb, g), rows, resident = PLAN_GRIDS[grid]
    ptrs, strides = (1 << 20, 2 << 20, 3 << 20), (4 * hb * wb * 8, hb * wb * 8,
                                                  0, hb * wb * 8, hb * wb * 8)
    assert detect_cuda.band_plan(hb, wb, g, ptrs, strides) == (True, resident,
                                                               rows)
    assert detect_cuda.RESIDENT_ROWS == 8


@pytest.mark.parametrize("case", ["s_cw_pointer", "sc_pointer", "sw_pointer",
                                  "frame_stride", "plane_stride"])
def test_band_plan_takes_the_scalar_instance_off_16_bytes(case):
    """A row pointer off its 16-byte boundary, or a stride that is not a
    multiple of 4 floats, takes the scalar instance; sc's frame stride of
    0 (a shared sc) keeps the vector one."""
    ptrs, strides = [1 << 20, 2 << 20, 3 << 20], [8 * 32400, 8 * 32400, 0,
                                                  8 * 32400, 8 * 32400]
    assert detect_cuda.band_plan(135, 240, 4, ptrs, strides)[0]
    if case.endswith("pointer"):
        ptrs[["s_cw", "sc", "sw"].index(case.split("_p")[0])] += 4
    elif case == "frame_stride":
        strides[0] += 2
    else:
        strides[1] += 2
    vector, resident, rows = detect_cuda.band_plan(135, 240, 4, ptrs,
                                                   strides)
    assert (vector, resident, rows) == (False, True, 8)


# ---------------------------------------------------------------------------
# The detect paths over the twin, against the JAX package
# ---------------------------------------------------------------------------

def _stegos(h, w, layout, seed=SEED + 3):
    """The port's blocked stego of two seeded covers on the CPU, its sc,
    the covers and the prepared watermark's sw."""
    rng = np.random.default_rng(seed)
    covers = rng.integers(0, 256, (2, h, w, 3), np.uint8)
    wm = rng.integers(0, 256, (h, w, 3), np.uint8)
    key = jcrypto.derive_key(PW, bytes(range(8)))
    blk, intra = (torch.as_tensor(a) for a in
                  jcrypto.block_permutation_indices(key,
                                                    jb.n_blocks_of(h, w)))
    if layout == "gray":
        pw = tb.prepare_wm_gray(tcolor.bgr_to_gray(torch.from_numpy(wm)),
                                blk, intra, extract_basis=False)
        st, sc, _, _ = tb.embed_gray_prepared(torch.from_numpy(covers),
                                              pw.sw, ALPHA,
                                              with_metrics=False)
    else:
        pw = tb.prepare_wm_color(torch.from_numpy(wm), blk, intra,
                                 extract_basis=False)
        st, sc, _, _ = tb.embed_color_prepared(torch.from_numpy(covers),
                                               pw.sw, ALPHA,
                                               with_metrics=False)
    return st.numpy(), sc.numpy(), covers, pw.sw.numpy()


@pytest.mark.parametrize("hw", [(64, 80), (65, 83)], ids=["64x80", "65x83"])
@pytest.mark.parametrize("layout", ["gray", "color"])
def test_detect_matches_jax(layout, hw):
    """detect_gray / detect_color on the stego and on the covers within
    1e-3 of the JAX package's (sweeps=1.25)."""
    st, sc, covers, sw = _stegos(*hw, layout)
    jfn, tfn = ((jb.detect_gray, tb.detect_gray) if layout == "gray"
                else (jb.detect_color, tb.detect_color))
    for img in (st, covers):
        ref = jfn(jnp.asarray(img), jnp.asarray(sc), jnp.asarray(sw),
                  jnp.float32(ALPHA), sweeps=SWEEPS)
        got = tfn(torch.from_numpy(img), torch.from_numpy(sc),
                  torch.from_numpy(sw), ALPHA, sweeps=SWEEPS)
        assert got.shape == (2,)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=PATH_TOL)
    assert float(tfn(torch.from_numpy(st), torch.from_numpy(sc),
                     torch.from_numpy(sw), ALPHA).min()) > 0.3


@pytest.mark.parametrize("layout", ["gray", "color"])
def test_shift_chunk_matches_jax(layout):
    """A resync chunk of rolls of one stego (a shared sc) within 1e-3 of
    the JAX package's _detect_shift_chunk; the aligned roll wins."""
    st, sc, _, sw = _stegos(64, 80, layout, seed=SEED + 4)
    rolled = np.roll(st[0], (2, -3), axis=(0, 1))
    shifts = np.asarray([(0, 0), (1, -1), (-2, 3), (3, 3)], np.int64)
    color = layout == "color"
    jimg = (jnp.asarray(rolled) if color
            else jcolor.luma_f32(jnp.asarray(rolled)))
    timg = (torch.from_numpy(rolled) if color
            else tcolor.luma_f32(torch.from_numpy(rolled)))
    ref = np.asarray(jb._detect_shift_chunk(
        jimg, jnp.asarray(sc[0]), jnp.asarray(sw), jnp.float32(ALPHA),
        jnp.asarray(shifts.astype(np.int32)), sweeps=SWEEPS,
        color_frames=color))
    got = tb._detect_shift_chunk(
        timg, torch.from_numpy(sc[0]), torch.from_numpy(sw), ALPHA,
        torch.from_numpy(shifts), sweeps=SWEEPS, color_frames=color).numpy()
    assert got.shape == ref.shape == (4,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=PATH_TOL)
    assert int(np.argmax(got)) == 2 and got[2] > 0.3


def test_serve_score_matches_jax():
    """serve_detect_color_prepared's scores within 1e-3 of the JAX
    package's fused serve body, composed from its parts (the Pallas
    roundtrip kernel in interpret mode, then detect_color's statistic);
    its stego and sc are the split calls'."""
    h, w = 64, 80
    rng = np.random.default_rng(SEED + 5)
    covers = rng.integers(0, 256, (2, h, w, 3), np.uint8)
    wm = rng.integers(0, 256, (h, w, 3), np.uint8)
    key = jcrypto.derive_key(PW, bytes(range(8)))
    blk, intra = jcrypto.block_permutation_indices(key, jb.n_blocks_of(h, w))
    pj = jb.prepare_wm_color(jnp.asarray(wm), jnp.asarray(blk),
                             jnp.asarray(intra))
    alpha = jnp.float32(ALPHA)
    mask = (jnp.arange(8) < K).astype(jnp.float32)
    _, sc_j, scw_j = wm_pallas.roundtrip_frames_blocks(
        jnp.asarray(covers), jb._scaled_sws(pj.sw, alpha, mask),
        sweeps=SWEEPS, k=K, interpret=True)
    ref = _jax_scores(np.asarray(scw_j), np.asarray(sc_j), np.asarray(pj.sw),
                      h // 8, w // 8)
    sw = torch.from_numpy(np.array(pj.sw))
    stego, sc, scores = tb.serve_detect_color_prepared(
        torch.from_numpy(covers), sw, ALPHA)
    np.testing.assert_allclose(scores.numpy(), ref, rtol=0, atol=PATH_TOL)
    assert float(scores.min()) > 0.3
    split = tb.embed_color_prepared(torch.from_numpy(covers), sw, ALPHA,
                                    with_metrics=False)
    assert torch.equal(stego, split[0]) and torch.equal(sc, split[1])
    assert torch.equal(scores, tb.detect_color(stego, sc, sw, ALPHA))
