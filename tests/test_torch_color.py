"""The gray scheme's color conversions (dctsvd_tpu_torch/ops/color_cuda.py:
K6 ``luma_f32`` / ``bgr_to_gray`` and K7 ``replace_luma``) on the CPU,
where each wrapper runs its plain twin: all 2^24 BGR triples byte-equal to
the JAX package (``dctsvd_tpu/ops/color.py``), replace_luma also on
seeded Y' and a row of edge values (NaN, ±inf, −0.0, values at the
truncation's edges); the wrappers' device, dtype and shape checks, their
launch counters, layouts (leading dims, empty batches, strided views),
and the vector / scalar plan of the kernels. The kernels themselves run
in tests/test_torch_gpu.py on a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dctsvd_tpu.ops import color as jcolor
from dctsvd_tpu_torch.ops import color, color_cuda
from dctsvd_tpu_torch.utils import kernels

torch.set_num_threads(2)

SEED = 20261015
EDGES = np.array([np.nan, np.inf, -np.inf, -0.0, 254.99998, 255.99998,
                  256.0, -1e-30, 1e30], np.float32)
WRAPPERS = ["luma_f32", "bgr_to_gray", "replace_luma"]


def all_triples() -> np.ndarray:
    """A 4096x4096 BGR frame holding every u8 triple once."""
    v = np.arange(1 << 24, dtype=np.uint32)
    bgr = np.stack([v & 255, (v >> 8) & 255, v >> 16], axis=-1)
    return bgr.astype(np.uint8).reshape(4096, 4096, 3)


def seeded_luma(shape, seed=SEED) -> np.ndarray:
    """Y' around the u8 range and past both ends, with the edge values
    in the first columns of every 512th row."""
    y = np.random.default_rng(seed).standard_normal(shape) * 90 + 128
    y = y.astype(np.float32)
    y[..., ::512, :len(EDGES)] = EDGES
    return y


@pytest.mark.parametrize("fn", ["luma_f32", "bgr_to_gray"])
def test_all_triples_byte_equal(fn):
    x = all_triples()
    got = getattr(color, fn)(torch.from_numpy(x)).numpy()
    ref = np.asarray(getattr(jcolor, fn)(jnp.asarray(x)))
    assert got.dtype == ref.dtype and got.shape == (4096, 4096)
    np.testing.assert_array_equal(got, ref)


def test_replace_luma_all_triples_byte_equal():
    x = all_triples()
    y = seeded_luma(x.shape[:-1])
    got = color.replace_luma(torch.from_numpy(y), torch.from_numpy(x))
    ref = jcolor.replace_luma(jnp.asarray(y), jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_edge_values_byte_equal():
    """Each edge value of Y' on 256 triples: truncation, saturation, NaN
    and −0.0 as the JAX package casts them."""
    x = all_triples()[::16, ::16][:len(EDGES)]             # [9, 256, 3]
    y = np.repeat(EDGES[:, None], x.shape[1], axis=1)
    got = color.replace_luma(torch.from_numpy(y), torch.from_numpy(x))
    ref = jcolor.replace_luma(jnp.asarray(y), jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("fn", WRAPPERS)
def test_public_names_call_the_wrappers(fn, monkeypatch):
    """ops/color.py's public name calls the wrapper in ops/color_cuda.py
    found at the call, so that one patch there reaches every caller."""
    seen = []

    def stand_in(*args):
        seen.append(args)
        return "wrapper"

    monkeypatch.setattr(color_cuda, fn, stand_in)
    x = _frames((8, 8, 3))
    args = (torch.zeros(8, 8), x) if fn == "replace_luma" else (x,)
    assert getattr(color, fn)(*args) == "wrapper"
    assert len(seen) == 1 and all(a is b for a, b in zip(seen[0], args))


def _frames(shape, seed=SEED) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape, np.uint8))


def _call(fn: str, bgr: torch.Tensor, y: torch.Tensor = None):
    if fn == "replace_luma":
        if y is None:
            y = torch.from_numpy(seeded_luma(bgr.shape[:-1], SEED + 1))
        return color_cuda.replace_luma(y, bgr)
    return getattr(color_cuda, fn)(bgr)


def _twin(fn: str, bgr: torch.Tensor, y: torch.Tensor = None):
    twin = getattr(color_cuda, f"{fn}_plain")
    if fn == "replace_luma":
        if y is None:
            y = torch.from_numpy(seeded_luma(bgr.shape[:-1], SEED + 1))
        return twin(y, bgr)
    return twin(bgr)


@pytest.mark.parametrize("fn", WRAPPERS)
def test_cpu_tensors_take_the_twin(fn, monkeypatch):
    """CPU tensors never reach a kernel and leave the counter alone."""
    def no_launch(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a kernel")

    monkeypatch.setattr(kernels, "launch", no_launch)
    wrapper = getattr(color_cuda, fn)
    n0 = wrapper.launches
    x = _frames((2, 24, 40, 3))
    assert torch.equal(_call(fn, x), _twin(fn, x))
    assert wrapper.launches == n0


@pytest.mark.parametrize("case", ["batch_dims", "empty_batch", "crop",
                                  "band"])
@pytest.mark.parametrize("fn", WRAPPERS)
def test_layouts_match_the_contiguous_input(fn, case):
    """Leading batch dims, an empty batch, a strided crop and a band of
    rows give what the same pixels give as a contiguous frame."""
    base = _frames((2, 3, 32, 48, 3))
    ybase = torch.from_numpy(seeded_luma(base.shape[:-1], SEED + 2))
    if case == "batch_dims":
        got = _call(fn, base, ybase)
        ref = torch.stack([_call(fn, base[i, j].clone(),
                                 ybase[i, j].clone())
                           for i in range(2) for j in range(3)])
        assert torch.equal(got.reshape(ref.shape), ref)
        return
    if case == "empty_batch":
        got = _call(fn, base[:0], ybase[:0])
        want = {"luma_f32": torch.float32}.get(fn, torch.uint8)
        assert got.dtype == want
        assert got.shape == (base[:0].shape if fn == "replace_luma"
                             else base[:0].shape[:-1])
        return
    idx = ((slice(None), 1, slice(3, -2, 2), slice(1, -1))
           if case == "crop" else (0, slice(None), slice(8, 24)))
    x, y = base[idx], ybase[idx]
    assert not x.is_contiguous()
    got = _call(fn, x, y)
    assert torch.equal(got, _call(fn, x.contiguous(), y.contiguous()))


BAD_FRAMES = ["bgr_int16", "bgr_float", "four_channels", "meta_device"]
BAD_LUMA = ["y_float64", "y_shape", "mixed_devices"]


@pytest.mark.parametrize("fn, case", [
    *((fn, case) for fn in WRAPPERS for case in BAD_FRAMES),
    *(("replace_luma", case) for case in BAD_LUMA)])
def test_bad_inputs_raise(fn, case):
    """A bad dtype, a mismatched shape, mixed devices or a device that is
    neither the CPU nor a card raise ValueError."""
    x = _frames((1, 8, 8, 3))
    y = torch.zeros((1, 8, 8), dtype=torch.float32)
    if case == "bgr_int16":
        x = x.to(torch.int16)
    elif case == "bgr_float":
        x = x.to(torch.float32)
    elif case == "four_channels":
        x = _frames((1, 8, 8, 4))
    elif case == "y_float64":
        y = y.to(torch.float64)
    elif case == "y_shape":
        y = torch.zeros((1, 8, 9), dtype=torch.float32)
    elif case == "mixed_devices":
        y = y.to("meta")
    elif case == "meta_device":
        x, y = x.to("meta"), y.to("meta")
    with pytest.raises(ValueError):
        _call(fn, x, y)


@pytest.mark.parametrize("kind, pix, offs, plan", [
    # 1080p: 518,400 groups of 4 pixels a frame, 2025 CTAs of 256
    ("luma_f32", 1080 * 1920, (0, 0), (True, 2025)),
    ("bgr_to_gray", 1080 * 1920, (0, 0), (True, 2025)),
    ("replace_luma", 1080 * 1920, (0, 0, 0), (True, 2025)),
    # 4096²: every triple
    ("luma_f32", 4096 * 4096, (0, 0), (True, 16384)),
    # 1079x1917: not a multiple of 4 pixels, a pixel a thread
    ("luma_f32", 1079 * 1917, (0, 0), (False, 8080)),
    ("replace_luma", 1079 * 1917, (0, 0, 0), (False, 8080)),
    # a view one pixel into a frame: BGR 3 bytes off the word
    ("luma_f32", 1080 * 1920, (3, 0), (False, 8100)),
    ("bgr_to_gray", 1080 * 1920, (3, 0), (False, 8100)),
    ("replace_luma", 1080 * 1920, (0, 3, 0), (False, 8100)),
    # Y' one float past a float4 boundary (4-byte aligned only)
    ("replace_luma", 1080 * 1920, (4, 0, 0), (False, 8100)),
    # a u8 gray plane out on a word (4 bytes) is enough, an f32 one not
    ("bgr_to_gray", 1080 * 1920, (0, 4), (True, 2025)),
    ("luma_f32", 1080 * 1920, (0, 4), (False, 8100)),
    # a 12-byte word-aligned offset (4 pixels) keeps the vector path
    ("luma_f32", 1080 * 1920, (12, 0), (True, 2025)),
    # one pixel, and four
    ("bgr_to_gray", 1, (0, 0), (False, 1)),
    ("replace_luma", 4, (0, 0, 0), (True, 1)),
])
def test_color_plan(kind, pix, offs, plan):
    """The vector path where the frame holds whole groups of 4 pixels and
    every pointer sits on its boundary; the scalar path elsewhere; the
    CTAs that cover one frame."""
    base = 1 << 20
    assert color_cuda.color_plan(kind, pix, *(base + o for o in offs)) \
        == plan


def test_color_plan_counts_its_pointers():
    with pytest.raises(ValueError):
        color_cuda.color_plan("replace_luma", 16, 0, 0)


# K17: the color NLM's planar YCrCb pair
YCRCB = ["bgr_to_ycrcb_planes", "ycrcb_planes_to_bgr"]


def test_ycrcb_planes_all_triples_byte_equal():
    """K17's twins, both ways, byte-equal to the JAX package's
    bgr_to_ycrcb and ycrcb_to_bgr (planar) on every BGR triple, and the
    inverse on every YCrCb triple."""
    x = all_triples()
    planes = color.bgr_to_ycrcb_planes(torch.from_numpy(x))
    ref = np.moveaxis(np.asarray(jcolor.bgr_to_ycrcb(jnp.asarray(x))), -1, -3)
    assert planes.shape == (3, 4096, 4096)
    np.testing.assert_array_equal(planes.numpy(), ref)
    ycc = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))
    got = color.ycrcb_planes_to_bgr(ycc)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcolor.ycrcb_to_bgr(jnp.asarray(x))))


@pytest.mark.parametrize("fn", YCRCB)
def test_ycrcb_public_names_call_the_wrappers(fn, monkeypatch):
    seen = []
    monkeypatch.setattr(color_cuda, fn, lambda *a: seen.append(a) or "w")
    x = _frames((3, 8, 8))
    assert getattr(color, fn)(x) == "w" and seen[0][0] is x


@pytest.mark.parametrize("fn", YCRCB)
def test_ycrcb_cpu_tensors_take_the_twin(fn, monkeypatch):
    def no_launch(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a kernel")

    monkeypatch.setattr(kernels, "launch", no_launch)
    wrapper = getattr(color_cuda, fn)
    n0 = wrapper.launches
    x = _frames((2, 24, 40, 3)) if fn == YCRCB[0] else _frames((2, 3, 24, 40))
    got = wrapper(x)
    assert torch.equal(got, getattr(color, f"{fn}_plain")(x))
    assert wrapper.launches == n0


def test_ycrcb_planes_round_trip_and_bad_inputs():
    """The planar pair inverts as the channels-last pair does; a frame
    without 3 channels or planes without 3 raise."""
    x = _frames((2, 24, 40, 3))
    ref = color.ycrcb_to_bgr(color.bgr_to_ycrcb(x))
    assert torch.equal(
        color.ycrcb_planes_to_bgr(color.bgr_to_ycrcb_planes(x)), ref)
    with pytest.raises(ValueError):
        color_cuda.bgr_to_ycrcb_planes(_frames((2, 8, 8, 4)))
    with pytest.raises(ValueError):
        color_cuda.ycrcb_planes_to_bgr(_frames((2, 4, 8, 8)))
    with pytest.raises(ValueError):
        color_cuda.bgr_to_ycrcb_planes(_frames((8, 3)))


@pytest.mark.parametrize("kind, offs, plan", [
    ("bgr_to_ycrcb_planes", (0, 0), (True, 2025)),
    ("ycrcb_planes_to_bgr", (0, 0), (True, 2025)),
    ("bgr_to_ycrcb_planes", (3, 0), (False, 8100)),
    ("ycrcb_planes_to_bgr", (0, 1), (False, 8100))])
def test_ycrcb_plan(kind, offs, plan):
    assert color_cuda.color_plan(kind, 1080 * 1920,
                                 *((1 << 20) + o for o in offs)) == plan
