"""The port's enhancement stages and chains (dctsvd_tpu_torch/ops/enhance.py,
models/enhance.py) against the JAX package on the CPU, and K10's and K11's
wrappers (ops/enhance_cuda.py) on CPU tensors.

Tolerances: unsharp and CLAHE within 1 quantum (the JAX package's own
bound against cv2, tests/test_enhance.py); NLM within 1 quantum on at
least 99 % of pixels; the whole chains' mean |Δ| < 0.5. NLM's twin sums
each window exactly in integers; its border semantics (the squared
difference image reflected, not x) and its sums are held to a float64
numpy form exactly. The chain degrades stage by stage where the JAX
package collapses any failure to unsharp only (an intended divergence):
with NLM failing the output is exactly the port's un-denoised chain,
which holds the chain tolerance (mean |Δ| < 0.5) against the JAX
package's ``enhance_gray_u8(x, denoise=False)``. A kernel error
(``utils/kernels.KernelError``) is the device's, never a stage's."""

import warnings

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctsvd_tpu.models import enhance as jme
from dctsvd_tpu.ops import enhance as je
from dctsvd_tpu_torch.models import enhance as tme
from dctsvd_tpu_torch.ops import color as tcolor
from dctsvd_tpu_torch.ops import enhance as te
from dctsvd_tpu_torch.ops import enhance_cuda as tec
from dctsvd_tpu_torch.ops import metrics as tmetrics
from dctsvd_tpu_torch.utils.kernels import KernelError

torch.set_num_threads(2)

SEED = 20261021
H100_SMS = 132          # the card clahe_plan is checked for


def _plane(shape, seed=SEED, sigma=2.0):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, shape, np.uint8), (0, 0),
                            sigma)


def _diff(got: torch.Tensor, ref) -> np.ndarray:
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape and got.dtype == torch.uint8
    return np.abs(got.numpy().astype(int) - ref.astype(int))


SHAPES = [(64, 80), (96, 128), (37, 51)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_unsharp_matches_jax(shape):
    img = _plane(shape)
    for amount, weight in ((1.25, -0.25), (1.15, -0.15)):
        d = _diff(te.unsharp_u8(torch.as_tensor(img), amount, weight),
                  je.unsharp_u8(jnp.asarray(img), amount, weight))
        assert d.max() <= 1


@pytest.mark.parametrize("shape", SHAPES + [(3, 40, 52)], ids=str)
def test_clahe_matches_jax(shape):
    """Batched planes map over the 2-D body, as in the JAX package."""
    img = _plane(shape)
    d = _diff(te.clahe_u8(torch.as_tensor(img)), je.clahe_u8(jnp.asarray(img)))
    assert d.max() <= 1


@pytest.mark.parametrize("shape", SHAPES + [(3, 40, 52)], ids=str)
def test_clahe_wrapper_runs_the_twins_on_the_cpu(shape):
    """enhance_cuda.clahe (K11's two stages in one host call) on a CPU
    tensor is clahe_luts_plain then clahe_apply_plain, counts no launch,
    and is within 1 of the JAX package's clahe_u8."""
    img = _plane(shape)
    x = torch.as_tensor(img).reshape(-1, *shape[-2:])
    wrappers = (tec.clahe, tec.clahe_luts, tec.clahe_apply)
    counts = [f.launches for f in wrappers]
    got = tec.clahe(x)
    assert torch.equal(got, te.clahe_apply_plain(x, te.clahe_luts_plain(x)))
    assert torch.equal(got, te.clahe_plain(x))
    assert [f.launches for f in wrappers] == counts
    assert _diff(got.reshape(shape), je.clahe_u8(jnp.asarray(img))).max() <= 1


def test_clahe_u8_makes_one_wrapper_call(monkeypatch):
    """clahe_u8 hands all its planes (leading dims flattened) to
    enhance_cuda.clahe once, and neither stage's own wrapper."""
    calls = []

    def one(planes, tiles, clip_limit):
        calls.append((tuple(planes.shape), tiles, clip_limit))
        return planes.clone()

    def refuse(*args, **kwargs):
        raise AssertionError("clahe_u8 called a stage's own wrapper")

    monkeypatch.setattr(tec, "clahe", one)
    monkeypatch.setattr(tec, "clahe_luts", refuse)
    monkeypatch.setattr(tec, "clahe_apply", refuse)
    x = torch.as_tensor(np.stack([_plane((40, 52), seed=SEED + 30 + i)
                                  for i in range(6)])).reshape(2, 3, 40, 52)
    assert torch.equal(te.clahe_u8(x), x)
    assert calls == [((6, 40, 52), 8, 2.0)]


def _launch_recorder(monkeypatch):
    """Where the kernel would run (``_device_ok`` false), the launches
    ``kernels.launch`` is asked for, in order, instead of launching."""
    launched = []
    monkeypatch.setattr(tec, "_device_ok", lambda *a: False)
    monkeypatch.setattr(tec.kernels, "launch",
                        lambda name, dev, *args: launched.append((name,
                                                                  args)))
    return launched


def test_clahe_is_one_launch_call_counted_once_a_kernel(monkeypatch):
    """On the card path clahe makes one host call, ``dctsvd_clahe``, with
    the plan's strips and the scratch, and moves each K11 counter (and its
    own) by one."""
    launched = _launch_recorder(monkeypatch)
    monkeypatch.setattr(tec, "_sms", lambda index: H100_SMS)
    scratch = (torch.zeros(64 * 257, dtype=torch.int32),
               torch.empty(64 * 256, dtype=torch.uint8))
    monkeypatch.setattr(tec, "_clahe_scratch", lambda dev, p, t: scratch)
    x = torch.as_tensor(_plane((1080, 1920), seed=SEED + 31))[None]
    wrappers = (tec.clahe, tec.clahe_luts, tec.clahe_apply)
    for f in wrappers:          # the counts stand again after the test
        monkeypatch.setattr(f, "launches", 0)
    tec.clahe(x)
    assert [f.launches for f in wrappers] == [1, 1, 1]
    assert len(launched) == 1
    name, args = launched[0]
    assert name == "dctsvd_clahe"
    assert args[0] is x and args[1] is scratch[1] and args[3] is scratch[0]
    assert args[2].shape == x.shape
    assert args[4:] == (1, 1080, 1920, 8, 253, 5)


def test_unsharp_wrapper_passes_no_reflect_table(monkeypatch):
    """K14 reflects its halo itself: the wrapper passes the frame, the
    output, σ 1's 7 taps in host memory and the scalars, no index
    table."""
    launched = _launch_recorder(monkeypatch)
    for x, cl, c in ((torch.as_tensor(_plane((2, 37, 51), seed=SEED + 32)),
                      False, 1),
                     (torch.as_tensor(_plane((37, 51, 3), seed=SEED + 33)),
                      True, 3)):
        launched.clear()
        tec.unsharp(x, 1.25, -0.25, 1.0, cl)
        (name, args), = launched
        assert name == "dctsvd_unsharp"
        taps = args[2]
        assert taps.device.type == "cpu" and taps.dtype == torch.float32
        assert taps.shape == (7,)
        assert args[3:] == (1.25, -0.25, x.numel() // (37 * 51 * c), 37,
                            51, c)
        assert not any(isinstance(a, torch.Tensor)
                       and a.dtype == torch.int32 for a in args)


# K11's launch shapes (clahe_plan): (P, H, W, tiles)
CLAHE_PLANS = [(1, 1080, 1920, 8), (1, 1081, 1920, 8), (1, 2160, 3840, 8),
               (3, 1080, 1920, 8), (128, 1080, 1920, 8), (1, 37, 51, 8),
               (3, 40, 52, 8), (1, 1, 1, 8), (1, 20, 30, 1),
               (2, 50, 70, 3), (1, 120, 150, 100)]


@pytest.mark.parametrize("p,h,w,tiles", CLAHE_PLANS, ids=str)
def test_clahe_plan_covers_each_tile_once(p, h, w, tiles):
    """The LUT stage's strips cover a tile's th rows once, none empty
    (strip_rows as the kernel derives it from strips), and fill the card
    (2 CTAs an SM of the H100's 132) where a tile has the rows for it."""
    plan = tec.clahe_plan(p, h, w, tiles, H100_SMS)
    th = -(-h // tiles)
    assert 1 <= plan.strips <= th
    assert plan.strip_rows == -(-th // plan.strips)
    assert (plan.strips - 1) * plan.strip_rows < th
    assert th <= plan.strips * plan.strip_rows
    ctas = tiles * tiles * plan.strips * p
    assert ctas >= min(tec.CLAHE_CTAS_PER_SM * H100_SMS,
                       tiles * tiles * th * p)
    if (p, h, w, tiles) == (1, 1080, 1920, 8):
        assert tuple(plan) == (5, 27) and ctas == 320


@pytest.mark.parametrize("tiles", [1, 2, 3, 8, 17, 64, 255])
def test_clahe_apply_band_stays_inside_its_staged_rows(tiles):
    """Every band of the interpolation's rows touches at most the
    ``CLAHE_STAGE_ROWS`` LUT rows it stages, and at most tiles (the kernel
    traps otherwise): the tile rows of each row as clahe_apply_plain
    computes them (one f32 division)."""
    for h in [*range(1, 200), 1080, 1081, 2160]:
        th = -(-h // tiles)
        ty = torch.div(torch.arange(h, dtype=torch.float32),
                       torch.tensor(float(th))) - 0.5
        y0 = torch.floor(ty).clamp(0, tiles - 1).to(torch.int64)
        y1 = (y0 + 1).clamp(0, tiles - 1)
        need = min(tiles, tec.CLAHE_STAGE_ROWS)
        for b in range(0, h, tec.CLAHE_APPLY_ROWS):
            last = min(b + tec.CLAHE_APPLY_ROWS, h) - 1
            assert int(y1[last] - y0[b]) + 1 <= need, (h, b)


@pytest.mark.parametrize("sigma", [1.0, 1.5])
def test_gaussian_blur_is_the_metrics_blur(sigma):
    """SSIM's blur (ops/metrics) is the enhancement module's."""
    x = _plane((37, 51)).astype(np.float32)
    a = te.gaussian_blur(torch.as_tensor(x), sigma)
    assert torch.equal(a, tmetrics.gaussian_blur(torch.as_tensor(x), sigma))
    b = np.asarray(je.gaussian_blur(jnp.asarray(x), sigma))
    assert np.abs(a.numpy() - b).max() <= 1e-3


def test_box_filter_matches_jax():
    """The twin's exact window sum (integer inputs, reflect-101 borders) is
    the float64 sum, and over 49 within the JAX package's cumsum box
    filter's f32 error."""
    x = np.random.default_rng(SEED).integers(0, 65026, (2, 29, 33))
    a = te._box_sum(torch.as_tensor(x, dtype=torch.int32), 3).numpy()
    assert np.array_equal(a, _box_sum_f64(x, 3))
    b = np.asarray(je._box_filter(jnp.asarray(x.astype(np.float32)), 3))
    assert np.abs(a / 49.0 - b).max() <= 1e-6 * 65025.0 * 49


def _reflect(i, n):
    """numpy reflect-101 indices (period 2(n - 1); all 0 when n = 1)."""
    if n == 1:
        return np.zeros_like(i)
    m = np.mod(i, 2 * (n - 1))
    return np.where(m < n, m, 2 * (n - 1) - m)


def _box_sum_f64(e, r):
    """Σ over the (2r+1)² window of e[..., R(y + ty), R(x + tx)], float64."""
    h, w = e.shape[-2:]
    ys, xs = np.arange(h), np.arange(w)
    out = np.zeros(e.shape, np.float64)
    for ty in range(-r, r + 1):
        for tx in range(-r, r + 1):
            out += e[..., _reflect(ys + ty, h)[:, None],
                     _reflect(xs + tx, w)[None, :]]
    return out


def _window_sum_f64(x, dy, dx, tr=3):
    """D of offset (dy, dx): Σ_t (x(c) − x(R(c + o)))², c = R(p + t), in
    float64 (the JAX package's box filter over the reflected
    squared-difference image)."""
    h, w = x.shape[-2:]
    ys, xs = np.arange(h), np.arange(w)
    x = x.astype(np.float64)
    e = (x - x[..., _reflect(ys + dy, h)[:, None],
               _reflect(xs + dx, w)[None, :]]) ** 2
    return _box_sum_f64(e, tr)


def _nlm_f64(x, h2, tr=3, sr=10):
    """NLM in float64 from _window_sum_f64, [H, W] -> float64."""
    h, w = x.shape
    ys, xs = np.arange(h), np.arange(w)
    wsum = np.zeros((h, w))
    vsum = np.zeros((h, w))
    for dy in range(-sr, sr + 1):
        for dx in range(-sr, sr + 1):
            wgt = np.exp(-(_window_sum_f64(x, dy, dx, tr) / 49.0) / h2)
            wsum += wgt
            vsum += wgt * x[_reflect(ys + dy, h)[:, None],
                            _reflect(xs + dx, w)[None, :]]
    return vsum / wsum


BORDER_SHAPES = [(9, 12), (12, 11), (37, 51)]


@pytest.mark.parametrize("shape", BORDER_SHAPES, ids=str)
def test_nlm_window_sums_reflect_the_squared_difference(shape):
    """Every offset's window sums equal the float64 form's, on planes
    whose 3-pixel border frame is a large share (the 9-row plane, smaller
    than the 21-pixel window, folds more than once); a form that pads x
    once and takes plain differences differs there."""
    x = _plane(shape, seed=SEED + 5, sigma=1.0).astype(np.int32)
    xt = torch.as_tensor(x)
    xp = te._pad_reflect(xt, 10, 10, 10, 10)
    xq = te._pad_reflect(xt, 13, 13, 13, 13).double()
    h, w = shape
    naive_differs = False
    for dy in range(-10, 11):
        for dx in range(-10, 11):
            dist, shifted = te.window_sums(xt, xp, dy, dx, 3, 10)
            ref = _window_sum_f64(x, dy, dx)
            assert np.array_equal(dist.numpy(), ref), (dy, dx)
            naive = sum((xq[13 + ty:13 + ty + h, 13 + tx:13 + tx + w]
                         - xq[13 + ty + dy:13 + ty + dy + h,
                              13 + tx + dx:13 + tx + dx + w]) ** 2
                        for ty in range(-3, 4) for tx in range(-3, 4))
            naive_differs |= not np.array_equal(naive.numpy(), ref)
    assert naive_differs


@pytest.mark.parametrize("shape", BORDER_SHAPES, ids=str)
@pytest.mark.parametrize("h", [3.0, 7.0])
def test_nlm_twin_matches_float64_form(shape, h):
    """The twin's output within 1 quantum of the float64 NLM everywhere,
    the border frame included."""
    x = _plane(shape, seed=SEED + 6, sigma=1.0)
    got = te.nlm_gray_u8(torch.as_tensor(x), h).numpy().astype(int)
    ref = _nlm_f64(x.astype(np.float64), h * h)
    assert np.abs(got - ref).max() <= 0.5 + 1.0


@pytest.mark.parametrize("phase", [0, 1])
def test_nlm_box_sum_is_exact_at_its_largest(phase):
    """Alternating 0/255 columns: the offsets (0, ±1) give every window
    sum 49 · 255² = 3,186,225 (the largest there is), held exactly; the
    NLM output against the float64 form and the JAX package."""
    x = np.zeros((40, 52), np.uint8)
    x[:, phase::2] = 255
    x[12:20, 20:31] = 128
    xt = torch.as_tensor(x.astype(np.int32))
    xp = te._pad_reflect(xt, 10, 10, 10, 10)
    dist, _ = te.window_sums(xt, xp, 0, 1, 3, 10)
    assert int(dist.max()) == tec.MAX_WINDOW_SUM == 3186225
    assert np.array_equal(dist.numpy(), _window_sum_f64(x, 0, 1))
    for h in (7.0, 50.0):
        got = te.nlm_gray_u8(torch.as_tensor(x), h)
        assert np.abs(got.numpy() - _nlm_f64(x.astype(np.float64),
                                             h * h)).max() <= 1.5
        d = _diff(got, je.nlm_gray_u8(jnp.asarray(x), h))
        assert (d <= 1).mean() >= 0.99


def _k10_walk(x, dy, dx, tile, run, row_run, tr=3, sr=10):
    """A numpy model of K10's walk (csrc/enhance.cu nlm_kernel) for offset
    (dy, dx) on an int plane [H, W]: for each tw × th tile, the staged halo
    x(R(g)) for g within tr + sr of the tile; the footprint (the tile ± tr)
    with each cell's reflected centre R(g) as a halo row and column (a row
    or column past the plane's last + tr clamped to it); each cell's
    squared difference (x(R(g)) − x(R(R(g) + o)))² from two halo reads;
    pass 1's row sums over the cells col .. col + 2 tr, running along each
    run of ``row_run`` columns (the first a sum of 2 tr + 1 cells, each next
    one the last plus a cell and less a cell); pass 2's column sums of
    those, running down each run of ``run`` rows. Returns D [H, W]."""
    h, w = x.shape
    tw, th = tile
    halo = tr + sr
    taps = 2 * tr + 1
    out = np.zeros((h, w), np.int64)
    for ty0 in range(0, h, th):
        for tx0 in range(0, w, tw):
            rows = _reflect(np.arange(ty0 - halo, ty0 + th + halo), h)
            cols = _reflect(np.arange(tx0 - halo, tx0 + tw + halo), w)
            xs = x[rows[:, None], cols[None, :]].astype(np.int64)
            crow = _reflect(np.minimum(np.arange(ty0 - tr, ty0 + th + tr),
                                       h - 1 + tr), h) - (ty0 - halo)
            ccol = _reflect(np.minimum(np.arange(tx0 - tr, tx0 + tw + tr),
                                       w - 1 + tr), w) - (tx0 - halo)
            cen = xs[crow[:, None], ccol[None, :]]
            shifted = xs[crow[:, None] + dy, ccol[None, :] + dx]
            d2 = (cen - shifted) ** 2                  # [th + 6, tw + 6]
            rs = np.zeros((th + 2 * tr, tw), np.int64)
            for col0 in range(0, tw, row_run):
                seg = d2[:, col0:col0 + row_run + taps - 1]
                steps = seg[:, taps:] - seg[:, :row_run - 1]
                first = seg[:, :taps].sum(axis=1, keepdims=True)
                rs[:, col0:col0 + row_run] = np.cumsum(
                    np.concatenate([first, steps], axis=1), axis=1)
            dist = np.zeros((th, tw), np.int64)
            for row0 in range(0, th, run):
                seg = rs[row0:row0 + run + taps - 1]
                steps = seg[taps:] - seg[:run - 1]
                first = seg[:taps].sum(axis=0, keepdims=True)
                dist[row0:row0 + run] = np.cumsum(
                    np.concatenate([first, steps], axis=0), axis=0)
            hh, ww = min(th, h - ty0), min(tw, w - tx0)
            out[ty0:ty0 + hh, tx0:tx0 + ww] = dist[:hh, :ww]
    return out


# K10's own tiling, and a small one that puts several tiles, interior and
# border runs on these planes
K10_TILINGS = {"kernel": (tec.NLM_TILE, tec.NLM_RUN, tec.NLM_ROW_RUN),
               "small": ((8, 8), 4, 8)}


@pytest.mark.parametrize("tiling", list(K10_TILINGS))
@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (7, 9), (12, 11),
                                   (33, 40), (37, 51)], ids=str)
def test_k10_walk_equals_window_sums(shape, tiling):
    """The numpy model of K10's walk (footprint, reflected centres, running
    row and column sums over its runs) gives every offset's window sums
    exactly as the twin's window_sums, on planes smaller than the template
    and the search window, and across several tiles."""
    tile, run, row_run = K10_TILINGS[tiling]
    x = _plane(shape, seed=SEED + 9, sigma=1.0).astype(np.int32)
    xt = torch.as_tensor(x)
    xp = te._pad_reflect(xt, 10, 10, 10, 10)
    for dy in range(-10, 11):
        for dx in range(-10, 11):
            ref, _ = te.window_sums(xt, xp, dy, dx, 3, 10)
            got = _k10_walk(x, dy, dx, tile, run, row_run)
            assert np.array_equal(got, ref.numpy()), (dy, dx)


def _sinusoid(shape, noise, seed):
    """A smooth sinusoid (per channel in color) and the same plus seeded
    Gaussian noise of σ ``noise``, both u8."""
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 128 + 60 * np.sin(2 * np.pi * xx / 23.0) * np.cos(
        2 * np.pi * yy / 17.0)
    if len(shape) == 3:
        base = np.stack([base, 255 - base, 0.5 * base + 40], -1)
    noisy = base + np.random.default_rng(seed).normal(0, noise, shape)
    return (np.clip(np.round(base), 0, 255).astype(np.uint8),
            np.clip(np.round(noisy), 0, 255).astype(np.uint8))


@pytest.mark.parametrize("shape,noise", [((64, 80), 4.0), ((96, 128), 2.0),
                                         ((64, 80, 3), 2.0),
                                         ((96, 128, 3), 3.0)], ids=str)
def test_nlm_denoises_as_jax(shape, noise):
    """Gray NLM (h 7) and color NLM (h 3) on sinusoid-plus-noise planes
    that NLM really denoises (the output nearer the clean plane than the
    input, more than half a quantum from the input on average): within 1
    quantum of the JAX package on >= 99 % of pixels."""
    clean, x = _sinusoid(shape, noise, SEED + len(shape) + int(noise))
    if len(shape) == 2:
        got = te.nlm_gray_u8(torch.as_tensor(x), 7.0)
        ref = je.nlm_gray_u8(jnp.asarray(x), 7.0)
    else:
        got = te.nlm_color_u8(torch.as_tensor(x), 3.0, 3.0)
        ref = je.nlm_color_u8(jnp.asarray(x), 3.0, 3.0)
    d = _diff(got, ref)
    assert (d <= 1).mean() >= 0.99
    g = got.numpy().astype(float)
    assert np.abs(g - x).mean() > 0.5
    if len(shape) == 2:    # color NLM runs in YCrCb, which rounds the BGR
        assert ((g - clean) ** 2).mean() < ((x.astype(float) - clean) ** 2
                                            ).mean()


def test_enhance_wrappers_run_the_twins_on_the_cpu():
    """CPU tensors run each twin (equal outputs) and count no launch;
    mixed devices raise; the kernel's template and search are the only
    shapes it takes on the card, the twin takes any."""
    x = torch.as_tensor(_plane((2, 23, 29), seed=SEED + 7))
    h2 = torch.tensor([49.0, 9.0])
    counts = [f.launches for f in (tec.nlm_planes, tec.clahe_luts,
                                   tec.clahe_apply, tec.nlm_weights)]
    assert torch.equal(tec.nlm_planes(x, h2), te.nlm_planes_plain(x, h2))
    assert torch.equal(tec.nlm_planes(x, h2, 5, 11),
                       te.nlm_planes_plain(x, h2, 5, 11))
    luts = tec.clahe_luts(x)
    assert luts.shape == (2, 64, 256) and luts.dtype == torch.uint8
    assert torch.equal(luts, te.clahe_luts_plain(x))
    assert torch.equal(tec.clahe_apply(x, luts),
                       te.clahe_apply_plain(x, luts))
    w = tec.nlm_weights(100, torch.tensor(9.0))
    assert w[0] == 1.0 and torch.all(w[1:] < w[:-1])
    assert counts == [f.launches for f in (tec.nlm_planes, tec.clahe_luts,
                                           tec.clahe_apply,
                                           tec.nlm_weights)] == [0] * 4
    meta = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="devices"):
        tec.nlm_planes(x, meta)
    with pytest.raises(ValueError, match="devices"):
        tec.clahe_apply(x, torch.empty((2, 64, 256), dtype=torch.uint8,
                                       device="meta"))
    with pytest.raises(ValueError, match="u8 planes"):
        tec.clahe_luts(x.float())
    with pytest.raises(ValueError, match="h2"):
        tec.nlm_planes(x, torch.tensor([49.0]))


def test_clahe_luma_through_k6_k7_equals_the_ycrcb_form():
    """The color chain's CLAHE stage (K6's luma, CLAHE, K7's replace_luma)
    is byte-equal to bgr_to_ycrcb -> CLAHE of Y -> ycrcb_to_bgr on seeded
    frames; and on all 2^24 BGR triples K6's luma is YCrCb's Y and K7
    with a random new Y is the YCrCb round trip."""
    frames = torch.as_tensor(np.stack([_plane((37, 51, 3), seed=SEED + i)
                                       for i in range(8, 11)]))

    def ycrcb_form(x):
        ycc = tcolor.bgr_to_ycrcb(x)
        y = te.clahe_u8(ycc[..., 0])
        return tcolor.ycrcb_to_bgr(torch.cat([y[..., None], ycc[..., 1:]],
                                             dim=-1))

    for x in (frames, frames[0]):
        assert torch.equal(tme._clahe_luma(x), ycrcb_form(x))
    v = torch.arange(1 << 24, dtype=torch.int32)
    bgr = torch.stack([v & 255, (v >> 8) & 255, v >> 16], -1).to(
        torch.uint8).reshape(4096, 4096, 3)
    ycc = tcolor.bgr_to_ycrcb(bgr)
    assert torch.equal(tcolor.luma_f32(bgr).to(torch.uint8), ycc[..., 0])
    y = torch.as_tensor(np.random.default_rng(SEED + 9).integers(
        0, 256, (4096, 4096), np.uint8))
    assert torch.equal(tcolor.replace_luma(y.to(torch.float32), bgr),
                       tcolor.ycrcb_to_bgr(torch.cat(
                           [y[..., None], ycc[..., 1:]], dim=-1)))


@pytest.mark.parametrize("kind", ["gray", "color"])
def test_nlm_matches_jax(kind):
    if kind == "gray":
        img = _plane((32, 40), sigma=1.0)
        d = _diff(te.nlm_gray_u8(torch.as_tensor(img)),
                  je.nlm_gray_u8(jnp.asarray(img)))
    else:
        img = _plane((32, 40, 3), sigma=1.0)
        d = _diff(te.nlm_color_u8(torch.as_tensor(img)),
                  je.nlm_color_u8(jnp.asarray(img)))
    assert (d <= 1).mean() >= 0.99


@pytest.mark.parametrize("kind", ["gray", "color"])
def test_chain_matches_jax(kind):
    shape = (32, 40) if kind == "gray" else (32, 40, 3)
    img = _plane(shape, seed=SEED + 1, sigma=1.0)
    t_fn = tme.enhance_gray_np if kind == "gray" else tme.enhance_color_np
    j_fn = jme.enhance_gray_np if kind == "gray" else jme.enhance_color_np
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = t_fn(img, device="cpu")
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert np.abs(got.astype(int) - j_fn(img).astype(int)).mean() < 0.5


def _raise(*args, **kwargs):
    raise ValueError("stage broken for the test")


def test_gray_chain_degrades_stage_by_stage(monkeypatch):
    img = _plane((32, 40), seed=SEED + 2, sigma=1.0)
    x = torch.as_tensor(img)
    plain = tme.enhance_gray_u8(x, denoise=False)
    monkeypatch.setattr(te, "nlm_gray_u8", _raise)
    with pytest.warns(RuntimeWarning, match="NLM.*ValueError"):
        no_nlm = tme.enhance_gray_u8(x)
    assert torch.equal(no_nlm, plain)
    ref = jme.enhance_gray_u8(jnp.asarray(img), denoise=False)
    assert _diff(no_nlm, ref).mean() < 0.5
    monkeypatch.setattr(te, "clahe_u8", _raise)
    with pytest.warns(RuntimeWarning) as rec:
        unsharp_only = tme.enhance_gray_u8(x)
    assert [str(w.message).split()[2] for w in rec] == ["NLM", "CLAHE"]
    assert torch.equal(unsharp_only, te.unsharp_u8(x, 1.25, -0.25))


def test_color_chain_degrades_stage_by_stage(monkeypatch):
    img = _plane((32, 40, 3), seed=SEED + 3, sigma=1.0)
    x = torch.as_tensor(img)
    plain = tme.enhance_color_u8(x, denoise=False)
    monkeypatch.setattr(te, "nlm_color_u8", _raise)
    with pytest.warns(RuntimeWarning, match="NLM"):
        assert torch.equal(tme.enhance_color_u8(x), plain)
    monkeypatch.setattr(te, "clahe_u8", _raise)
    with pytest.warns(RuntimeWarning) as rec:
        got = tme.enhance_color_u8(x)
    assert [str(w.message).split()[2] for w in rec] == ["NLM", "CLAHE"]
    ref = torch.movedim(te.unsharp_u8(torch.movedim(x, -1, -3), 1.15, -0.15),
                        -3, -1)
    assert torch.equal(got, ref)


def test_device_errors_are_not_skipped(monkeypatch):
    """An out-of-memory error is the device's, not the stage's: it
    propagates instead of degrading the chain."""
    def oom(*args, **kwargs):
        raise torch.OutOfMemoryError("out of memory")
    monkeypatch.setattr(te, "nlm_gray_u8", oom)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(torch.OutOfMemoryError):
            tme.enhance_gray_u8(torch.as_tensor(_plane((16, 16))))


@pytest.mark.parametrize("kind", ["gray", "color"])
def test_kernel_errors_are_not_skipped(monkeypatch, kind):
    """A kernel that fails to build or launch (KernelError, raised by
    utils/kernels.py) inside the NLM stage propagates from the chain with
    no degradation warning: a broken kernel is never hidden behind the
    un-denoised output."""
    def broken(*args, **kwargs):
        raise KernelError("nvcc failed (1): for the test")
    monkeypatch.setattr(tec, "nlm_planes", broken)
    shape = (16, 16) if kind == "gray" else (16, 16, 3)
    x = torch.as_tensor(_plane(shape, seed=SEED + 10))
    chain = tme.enhance_gray_u8 if kind == "gray" else tme.enhance_color_u8
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(KernelError, match="nvcc failed"):
            chain(x)
    assert issubclass(KernelError, RuntimeError)


@pytest.mark.parametrize("shape", [(3, 5, 3), (37, 51, 3), (2, 40, 52, 3),
                                   (16, 24, 4)], ids=str)
def test_unsharp_channels_last_twin(shape):
    """K14's channels-last twin is byte-equal to the planar form (each
    channel its own plane) and within 1 quantum of the JAX package on each
    channel."""
    img = np.stack([_plane(shape[-3:], seed=SEED + 20 + i, sigma=1.0)
                    for i in range(int(np.prod(shape[:-3])))])
    img = img.reshape(shape)
    x = torch.as_tensor(img)
    got = te.unsharp_u8(x, 1.15, -0.15, channels_last=True)
    planar = te.unsharp_plain(torch.movedim(x, -1, -3).contiguous(), 1.15,
                              -0.15)
    assert torch.equal(got, torch.movedim(planar, -3, -1))
    assert torch.equal(got, te.unsharp_plain(x, 1.15, -0.15,
                                             channels_last=True))
    ref = np.moveaxis(np.asarray(je.unsharp_u8(
        jnp.asarray(np.moveaxis(img, -1, -3)), 1.15, -0.15)), -3, -1)
    assert _diff(got, ref).max() <= 1


def test_unsharp_wrapper_takes_the_twin_on_the_cpu(monkeypatch):
    def no_launch(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a kernel")

    monkeypatch.setattr(tec.kernels, "launch", no_launch)
    n0 = tec.unsharp.launches
    x = torch.as_tensor(_plane((37, 51), seed=SEED + 21))
    assert torch.equal(tec.unsharp(x, 1.25, -0.25),
                       te.unsharp_plain(x, 1.25, -0.25))
    assert tec.unsharp.launches == n0
    with pytest.raises(ValueError):
        tec.unsharp(x.float(), 1.25, -0.25)


@pytest.mark.parametrize("sigma,shape,channels_last", [
    (1.5, (37, 51), False), (1.0, (16, 24, 4), True)], ids=["sigma", "c4"])
def test_unsharp_wrapper_raises_where_the_kernel_would_not_take(
        monkeypatch, sigma, shape, channels_last):
    """Where the kernel would run (``_device_ok`` false: a CUDA tensor), σ
    other than 1 and channel counts other than 1 or 3 raise ValueError
    before any launch; a CPU tensor takes the twin for both."""
    def no_launch(*args, **kwargs):
        raise AssertionError("the kernel launched")

    x = torch.as_tensor(_plane(shape, seed=SEED + 23))
    assert torch.equal(tec.unsharp(x, 1.25, -0.25, sigma, channels_last),
                       te.unsharp_plain(x, 1.25, -0.25, sigma, channels_last))
    monkeypatch.setattr(tec, "_device_ok", lambda *a: False)
    monkeypatch.setattr(tec.kernels, "launch", no_launch)
    with pytest.raises(ValueError, match="the kernel takes"):
        tec.unsharp(x, 1.25, -0.25, sigma, channels_last)


def test_public_unsharp_calls_the_wrapper(monkeypatch):
    seen = []
    monkeypatch.setattr(tec, "unsharp", lambda *a: seen.append(a) or "w")
    x = torch.as_tensor(_plane((8, 8, 3), seed=SEED + 22))
    assert te.unsharp_u8(x, 1.15, -0.15, channels_last=True) == "w"
    assert seen[0][1:] == (1.15, -0.15, 1.0, True)
