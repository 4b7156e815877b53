"""The embed's quality metrics (dctsvd_tpu_torch/ops/metrics.py and the
wrappers of K15 and K16, ops/metrics_cuda.py) on the CPU, where each
wrapper runs its plain twin.

Tolerances: SSIM and PSNR within 1e-5 of scale of the JAX package's
(``dctsvd_tpu/ops/metrics.py``): the twins' sums run in K15's fixed order
(SSIM) or exactly in integers (PSNR), where the JAX package takes f32
means in XLA's order. The fixed-order mean is held to a float64 sum of the
same map within 1e-6 relative, and to a walk of the kernel's threads
written out in numpy f32; PSNR's integer sums to a float64 reference
exactly. The kernels themselves run in tests/test_torch_gpu.py on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctsvd_tpu.ops import color as jcolor
from dctsvd_tpu.ops import metrics as jmetrics
from dctsvd_tpu_torch.models import blocked as tb
from dctsvd_tpu_torch.ops import color, metrics, metrics_cuda
from dctsvd_tpu_torch.utils import crypto, kernels

torch.set_num_threads(2)

SEED = 20261022
REL = 1e-5      # f32 sums taken in another order than XLA's
SHAPES = {"3x5": (1, 3, 5), "37x51": (1, 37, 51), "135x240": (1, 135, 240),
          "batch2": (2, 64, 80)}


def _rng(i: int) -> np.random.Generator:
    return np.random.default_rng(SEED + i)


def _close(got: torch.Tensor, ref, rel=REL):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


def _pair(shape, kind: str, seed: int):
    """A smooth u8 plane batch and its second input: u8 (a noisy copy, as a
    color stego's gray) or f32 (noisy and unclipped, as a marked Y)."""
    rng = _rng(seed)
    x = rng.integers(0, 256, shape).astype(np.float32)
    x = np.round((x + np.roll(x, 1, -1) + np.roll(x, 1, -2)) / 3)
    y = x + rng.standard_normal(shape).astype(np.float32) * 4
    x = x.astype(np.uint8)
    if kind == "u8":
        y = np.clip(np.round(y), 0, 255).astype(np.uint8)
    return x, y.astype(np.float32) if kind == "f32" else y


@pytest.mark.parametrize("kind", ["u8", "f32"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ssim_twin_matches_jax(shape, kind):
    x, y = _pair(SHAPES[shape], kind, 1)
    got = metrics.ssim(torch.from_numpy(x), torch.from_numpy(y))
    ref = jmetrics.ssim(jnp.asarray(x), jnp.asarray(y))
    assert got.dtype == torch.float32
    _close(got, ref)
    _close(metrics_cuda.ssim_plain(torch.from_numpy(x),
                                   torch.from_numpy(y)), ref)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_psnr_twin_matches_jax(shape):
    rng = _rng(2)
    dims = (*SHAPES[shape], 3)
    a = rng.integers(0, 256, dims, np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-6, 7, dims), 0,
                255).astype(np.uint8)
    got = metrics.psnr(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, jmetrics.psnr(jnp.asarray(a), jnp.asarray(b)))
    # gray planes: the trailing two axes an image
    _close(metrics.psnr(torch.from_numpy(a[..., 0]),
                        torch.from_numpy(b[..., 0])),
           jmetrics.psnr(jnp.asarray(a[..., 0]), jnp.asarray(b[..., 0])))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fixed_order_mean_near_float64(shape):
    """K15's fixed-order mean of a map within 1e-6 relative of its float64
    mean."""
    x, y = _pair(SHAPES[shape], "f32", 3)
    m = metrics_cuda.ssim_map(torch.from_numpy(x), torch.from_numpy(y))
    got = metrics_cuda.fixed_order_mean(m).numpy()
    ref = m.to(torch.float64).mean(dim=(-2, -1)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def _walk(m: np.ndarray) -> np.ndarray:
    """K15's sum written thread by thread in numpy f32: each tile's threads
    (warp w, lane c) over rows w + 8 q, the lane butterfly, the warps in
    order; then the finish kernel's threads over the partials."""
    f = np.float32
    t = metrics_cuda.SSIM_TILE
    lanes, warps = 32, metrics_cuda.WARPS

    def block_sum(vals):                    # [256] a thread's sums
        v = vals.reshape(warps, lanes).copy()
        for o in (16, 8, 4, 2, 1):
            v = np.stack([v[:, i] + v[:, i ^ o] for i in range(lanes)], 1)
        s = f(0)
        for k in range(warps):
            s = f(s + v[k, 0])
        return s

    out = []
    for plane in m:
        h, w = plane.shape
        parts = []
        for ty in range(-(-h // t)):
            for tx in range(-(-w // t)):
                acc = np.zeros(warps * lanes, np.float32)
                for tid in range(warps * lanes):
                    c, wp = tid % lanes, tid // lanes
                    for q in range(t // warps):
                        r, col = ty * t + wp + warps * q, tx * t + c
                        v = plane[r, col] if r < h and col < w else f(0)
                        acc[tid] = f(acc[tid] + v)
                parts.append(block_sum(acc))
        n, lanes_f = len(parts), metrics_cuda.FINISH_LANES
        acc = np.zeros(lanes_f, np.float32)
        for j in range(-(-n // lanes_f)):
            for tid in range(lanes_f):
                idx = j * lanes_f + tid
                acc[tid] = f(acc[tid] + (parts[idx] if idx < n else f(0)))
        out.append(f(block_sum(acc) / f(h * w)))
    return np.array(out, np.float32)


@pytest.mark.parametrize("shape", [(1, 3, 5), (2, 37, 51), (1, 70, 33)],
                         ids=str)
def test_fixed_order_mean_walks_the_kernel(shape):
    """The twin's vectorised order is the kernel's thread walk, bit for
    bit."""
    m = _rng(4).standard_normal(shape).astype(np.float32)
    got = metrics_cuda.fixed_order_mean(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, _walk(m))


def test_psnr_sums_are_exact():
    """K16's twin sums squared differences exactly (float64, integers below
    2^53): its mse is the
    float64 sum over n rounded to f32, on frames whose f32 sum would
    round; equal frames give the 99.0 cap."""
    rng = _rng(5)
    a = rng.integers(0, 256, (2, 300, 400, 3), np.uint8)
    b = rng.integers(0, 256, (2, 300, 400, 3), np.uint8)
    got = metrics_cuda.psnr_plain(torch.from_numpy(a), torch.from_numpy(b))
    d = a.astype(np.float64) - b.astype(np.float64)
    sums = (d * d).reshape(2, -1).sum(1)
    assert np.array_equal(sums, np.round(sums))
    mse = (sums / d[0].size).astype(np.float32)
    ref = 20.0 * np.log10(255.0 / np.sqrt(mse.astype(np.float64)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    eq = metrics.psnr(torch.from_numpy(a), torch.from_numpy(a))
    assert eq.tolist() == [99.0, 99.0]


def _state(h, w, seed):
    rng = _rng(seed)
    covers = rng.integers(0, 256, (2, h, w, 3), np.uint8)
    wm = rng.integers(0, 256, (h, w, 3), np.uint8)
    key = crypto.derive_key("pw", bytes(range(8)))
    blk, intra = (torch.as_tensor(i) for i in crypto.block_permutation_indices(
        key, tb.n_blocks_of(h, w)))
    return covers, wm, blk, intra


@pytest.mark.parametrize("scheme", ["gray", "color"])
def test_embed_metrics_match_jax(scheme):
    """The metrics an embed returns are the JAX package's metrics of the
    embed's own pair: PSNR of cover and stego, SSIM of the cover's gray
    and the marked Y (gray, f32) or the stego's gray (color)."""
    covers, wm, blk, intra = _state(64, 80, 6)
    c = torch.from_numpy(covers)
    if scheme == "gray":
        pw = tb.prepare_wm_gray(color.bgr_to_gray(torch.from_numpy(wm)),
                                blk, intra)
        stego, _, ps, ss = tb.embed_gray_prepared(c, pw.sw, 0.12)
        second = tb._embed_planes(color.luma_f32(c), pw.sw, 0.12,
                                  tb.K_FRAC_DEFAULT)[0].numpy()
    else:
        pw = tb.prepare_wm_color(torch.from_numpy(wm), blk, intra)
        stego, _, ps, ss = tb.embed_color_prepared(c, pw.sw, 0.12)
        second = np.asarray(jcolor.bgr_to_gray(jnp.asarray(stego.numpy())))
    _close(ps, jmetrics.psnr(jnp.asarray(covers), jnp.asarray(stego.numpy())))
    _close(ss, jmetrics.ssim(jcolor.bgr_to_gray(jnp.asarray(covers)),
                             jnp.asarray(second)))
    assert float(ps.min()) > 20 and 0.5 < float(ss.min()) <= 1


@pytest.mark.parametrize("name", ["ssim", "psnr"])
def test_cpu_tensors_take_the_twin(name, monkeypatch):
    """CPU tensors never reach a kernel and leave the counter alone."""
    def no_launch(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a kernel")

    monkeypatch.setattr(kernels, "launch", no_launch)
    wrapper = getattr(metrics_cuda, name)
    n0 = wrapper.launches
    x, y = _pair((2, 37, 51), "u8", 7)
    got = wrapper(torch.from_numpy(x), torch.from_numpy(y))
    twin = getattr(metrics_cuda, f"{name}_plain")
    assert torch.equal(got, twin(torch.from_numpy(x), torch.from_numpy(y)))
    assert wrapper.launches == n0


@pytest.mark.parametrize("name,args", [
    ("ssim", (np.uint8, np.uint8)), ("ssim", (np.uint8, np.float32)),
    ("ssim", (np.float32, np.float32)), ("psnr", (np.uint8, np.uint8)),
    ("psnr", (np.float32, np.float32))])
def test_public_names_call_the_wrappers(name, args, monkeypatch):
    """ops/metrics.py's pairs of every dtype reach the wrapper in
    ops/metrics_cuda.py found at the call."""
    seen = []
    monkeypatch.setattr(metrics_cuda, name,
                        lambda *a: seen.append(a) or "wrapper")
    x = [torch.zeros((2, 8, 8), dtype=torch.from_numpy(np.zeros(1, t)).dtype)
         for t in args]
    assert getattr(metrics, name)(*x) == "wrapper" and len(seen) == 1


@pytest.mark.parametrize("name", ["ssim", "psnr"])
def test_cpu_tensors_of_other_dtypes_take_the_twin(name):
    """f32 pairs on the CPU run the twin, within REL of the JAX package."""
    x, y = _pair((2, 37, 51), "f32", 8)
    x = x.astype(np.float32)
    got = getattr(metrics, name)(torch.from_numpy(x), torch.from_numpy(y))
    twin = getattr(metrics_cuda, f"{name}_plain")
    assert torch.equal(got, twin(torch.from_numpy(x), torch.from_numpy(y)))
    _close(got, getattr(jmetrics, name)(jnp.asarray(x), jnp.asarray(y)))


def test_wrappers_check_their_inputs(monkeypatch):
    """Shapes are checked on every device; the dtypes only where a kernel
    would run (``_device_ok`` false: CUDA tensors), where a dtype the
    kernel does not take raises before any launch."""
    def no_launch(*args, **kwargs):
        raise AssertionError("a dtype the kernel does not take launched")

    x = torch.zeros((2, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="shapes"):
        metrics_cuda.ssim(x, x[:, :4])
    with pytest.raises(ValueError, match="shapes"):
        metrics_cuda.psnr(x, x[:, :4])
    monkeypatch.setattr(metrics_cuda, "_device_ok", lambda *a: False)
    monkeypatch.setattr(kernels, "launch", no_launch)
    with pytest.raises(ValueError, match="the kernel takes u8"):
        metrics_cuda.ssim(x.float(), x)
    with pytest.raises(ValueError, match="the kernel takes u8"):
        metrics_cuda.ssim(x, x.to(torch.float64))
    with pytest.raises(ValueError, match="the kernel takes u8"):
        metrics_cuda.psnr(x, x.float())


def test_psnr_plan():
    """16-byte loads only where each image's bytes are a multiple of 16 and
    both pointers are 16-byte aligned."""
    assert metrics_cuda.psnr_plan(1080 * 1920 * 3, 0, 256)
    assert not metrics_cuda.psnr_plan(37 * 51 * 3, 0, 256)
    assert not metrics_cuda.psnr_plan(1080 * 1920 * 3, 1, 256)
