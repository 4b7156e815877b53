"""The port's plain tensor ops (dctsvd_tpu_torch/ops) against the JAX
package on the CPU: color, permute and resize byte-equal; the DCT, the
Gaussian blur and the metrics within 1e-5 relative (f32, summed in
another order); reflect padding byte-equal on an unaligned size."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dctsvd_tpu.models import blocked as jb
from dctsvd_tpu.ops import color as jcolor
from dctsvd_tpu.ops import dct as jdct
from dctsvd_tpu.ops import enhance as jenhance
from dctsvd_tpu.ops import metrics as jmetrics
from dctsvd_tpu.ops import permute as jpermute
from dctsvd_tpu.ops import resize as jresize
from dctsvd_tpu_torch.models import blocked as tb
from dctsvd_tpu_torch.ops import color, dct, metrics, permute, resize

torch.set_num_threads(2)

SEED = 20261016
REL = 1e-5      # f32 products and sums taken in another order than XLA's


def _rng(i: int) -> np.random.Generator:
    return np.random.default_rng(SEED + i)


def _close(got: torch.Tensor, ref, rel=REL):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("shape", [(2, 64, 80, 3), (60, 84, 3)])
@pytest.mark.parametrize("fn", ["bgr_to_ycrcb", "ycrcb_to_bgr",
                                "bgr_to_gray", "luma_f32"])
def test_color_byte_equal(fn, shape):
    x = _rng(1).integers(0, 256, shape, np.uint8)
    got = getattr(color, fn)(torch.from_numpy(x)).numpy()
    ref = np.asarray(getattr(jcolor, fn)(jnp.asarray(x)))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_replace_luma_byte_equal():
    rng = _rng(2)
    x = rng.integers(0, 256, (2, 60, 84, 3), np.uint8)
    y = (rng.standard_normal((2, 60, 84)) * 90 + 128).astype(np.float32)
    got = color.replace_luma(torch.from_numpy(y), torch.from_numpy(x))
    ref = jcolor.replace_luma(jnp.asarray(y), jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_permute_block_tensor_equal():
    rng = _rng(3)
    blocks = rng.standard_normal((3, 80, 8, 8)).astype(np.float32)
    blk, intra = rng.permutation(80), rng.permutation(64)
    got = permute.permute_block_tensor(torch.from_numpy(blocks),
                                       torch.from_numpy(blk),
                                       torch.from_numpy(intra))
    ref = jpermute.permute_block_tensor(jnp.asarray(blocks),
                                        jnp.asarray(blk), jnp.asarray(intra))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("src,dst", [
    ((64, 48, 3), (512, 512)),     # upscale: zoom path
    ((512, 256, 3), (64, 64)),     # integer shrink
    ((100, 90, 3), (41, 37)),      # fractional shrink
    ((64, 200, 3), (128, 50)),     # mixed axes
    ((64, 48), (200, 300)),        # gray plane
    ((60, 84, 3), (64, 80)),       # the unaligned test size, grown
])
def test_resize_area_u8_byte_equal(src, dst):
    x = _rng(4).integers(0, 256, src, np.uint8)
    got = resize.resize_area_u8(torch.from_numpy(x), *dst)
    ref = jresize.resize_area_u8(jnp.asarray(x), *dst)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_dct_blocks_and_layout():
    x = (_rng(5).standard_normal((2, 3, 64, 80)) * 50 + 128).astype(
        np.float32)
    blocks_t = dct.blockify(torch.from_numpy(x))
    blocks_j = jdct.blockify(jnp.asarray(x))
    np.testing.assert_array_equal(blocks_t.numpy(), np.asarray(blocks_j))
    np.testing.assert_array_equal(dct.unblockify(blocks_t, 64, 80).numpy(), x)
    _close(dct.dct2_blocks(blocks_t), jdct.dct2_blocks(blocks_j))
    np.testing.assert_array_equal(dct._dct_matrix_np(8),
                                  jdct._dct_matrix_np(8))


def test_idct_with_row_perm():
    rng = _rng(6)
    coefs = rng.standard_normal((3, 80, 8, 8)).astype(np.float32) * 40
    perm = rng.permutation(64)
    got = dct.idct2_blocks_to_plane(torch.from_numpy(coefs), 64, 80,
                                    row_perm=torch.from_numpy(perm))
    ref = jdct.idct2_blocks_to_plane(jnp.asarray(coefs), 64, 80,
                                     row_perm=jnp.asarray(perm))
    _close(got, ref)
    t = dct.idct_pixel_tensor(8, row_perm=torch.from_numpy(perm))
    _close(t, jdct.idct_pixel_tensor(8, row_perm=jnp.asarray(perm)))


@pytest.mark.parametrize("shape", [(2, 64, 80), (60, 84)])
@pytest.mark.parametrize("sigma", [1.0, 1.5])
def test_gaussian_blur(shape, sigma):
    x = (_rng(7).random(shape) * 255).astype(np.float32)
    _close(metrics.gaussian_blur(torch.from_numpy(x), sigma=sigma),
           jenhance.gaussian_blur(jnp.asarray(x), sigma=sigma))


def test_psnr_ssim_nc():
    rng = _rng(8)
    a = rng.integers(0, 256, (2, 60, 84, 3), np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-6, 7, a.shape), 0,
                255).astype(np.uint8)
    _close(metrics.psnr(torch.from_numpy(a), torch.from_numpy(b)),
           jmetrics.psnr(jnp.asarray(a), jnp.asarray(b)))
    assert float(metrics.psnr(torch.from_numpy(a), torch.from_numpy(a))[0]) \
        == 99.0
    ga, gb = a[..., 0].astype(np.float32), b[..., 0].astype(np.float32)
    _close(metrics.ssim(torch.from_numpy(ga), torch.from_numpy(gb)),
           jmetrics.ssim(jnp.asarray(ga), jnp.asarray(gb)))
    fa = rng.standard_normal((4, 300)).astype(np.float32)
    fb = (fa + 0.5 * rng.standard_normal((4, 300))).astype(np.float32)
    _close(metrics.nc(torch.from_numpy(fa), torch.from_numpy(fb)),
           jmetrics.nc(jnp.asarray(fa), jnp.asarray(fb)))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_reflect_pad_unaligned(dtype):
    x = (_rng(9).random((2, 3, 60, 84)) * 255).astype(dtype)
    got, hp, wp = tb._pad_to_blocks(torch.from_numpy(x))
    ref, hp_j, wp_j = jb._pad_to_blocks(jnp.asarray(x))
    assert (hp, wp) == (hp_j, wp_j) == (64, 88)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    fr = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    got_f, _, _ = tb._pad_frames_to_blocks(torch.from_numpy(fr))
    ref_f, _, _ = jb._pad_frames_to_blocks(jnp.asarray(fr))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(ref_f))


def test_port_imports_without_jax():
    """The port imports torch and never jax, nor the JAX package."""
    code = (
        "import sys\n"
        "import dctsvd_tpu_torch, dctsvd_tpu_torch.cli\n"
        "import dctsvd_tpu_torch.models.blocked\n"
        "import dctsvd_tpu_torch.utils.kernels\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dctsvd_tpu' or m.startswith('dctsvd_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=repo)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# The general Jacobi SVD, its values-only alias, idct2_blocks and the float
# resize_area against the JAX package (its XLA formulations on the CPU).
# Tolerances: S within 1e-5 of the largest singular value (the same f32
# rotations, with dots summed in another order); U·S·Vᵀ within
# tests/test_svd.py's 2e-4 of the input; idct2_blocks within
# tests/test_dct.py's 1e-4; resize_area within tests/test_resize.py's 1.0 of
# cv2 and within 1e-4 of the JAX package's (f32 sums of up to a few dozen
# weighted pixels of at most 255, in another order).
# ---------------------------------------------------------------------------

SVD_CASES = {
    "16x8": dict(shape=(10, 16, 8)),
    "10x6": dict(shape=(7, 10, 6)),
    "32x32": dict(shape=(3, 32, 32)),
    "zero": dict(shape=(4, 12, 8), kind="zero"),
    "rank1": dict(shape=(5, 16, 8), kind="rank1"),
    "s1.25": dict(shape=(10, 16, 8), sweeps=1.25),
    "unsorted": dict(shape=(10, 16, 8), sort_descending=False),
    "values_only": dict(shape=(10, 16, 8), compute_uv=False),
}


def _svd_input(case):
    c = SVD_CASES[case]
    rng = _rng(50)
    a = rng.normal(size=c["shape"]).astype(np.float32) * 3
    if c.get("kind") == "zero":
        a[:] = 0
    elif c.get("kind") == "rank1":
        u = rng.normal(size=(*c["shape"][:-1], 1))
        v = rng.normal(size=(c["shape"][0], 1, c["shape"][-1]))
        a = (u * v).astype(np.float32)
    kw = {k: c[k] for k in ("sweeps", "sort_descending", "compute_uv")
          if k in c}
    return a, kw


@pytest.mark.parametrize("case", list(SVD_CASES))
def test_jacobi_svd_matches_jax(case):
    from dctsvd_tpu.ops import svd as jsvd
    from dctsvd_tpu_torch.ops import svd
    a, kw = _svd_input(case)
    got = svd.jacobi_svd(torch.from_numpy(a), **kw)
    ref = jsvd.jacobi_svd(jnp.asarray(a), impl="xla", **kw)
    if not kw.get("compute_uv", True):
        got, ref = (None, got, None), (None, ref, None)
    s, s_ref = got[1].numpy(), np.asarray(ref[1])
    assert s.shape == s_ref.shape == (*a.shape[:-2], a.shape[-1])
    tol = 1e-5 * max(float(np.abs(s_ref).max()), 1e-30)
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=tol)
    if kw.get("sort_descending", True):
        assert (np.diff(s, axis=-1) <= 0).all()
    if got[0] is not None:
        u, vt = got[0].numpy(), got[2].numpy()
        assert u.shape == a.shape and vt.shape == (*a.shape[:-2],
                                                   a.shape[-1], a.shape[-1])
        rec = np.einsum("bij,bj,bjk->bik", u, s, vt)
        np.testing.assert_allclose(rec, a, atol=2e-4)


def test_jacobi_singular_values_matches_jax():
    from dctsvd_tpu.ops import svd as jsvd
    from dctsvd_tpu_torch.ops import svd
    a, _ = _svd_input("16x8")
    got = svd.jacobi_singular_values(torch.from_numpy(a)).numpy()
    ref = np.asarray(jsvd.jacobi_singular_values(jnp.asarray(a)))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(ref.max()))
    np.testing.assert_allclose(got, np.linalg.svd(a, compute_uv=False),
                               rtol=2e-5, atol=1e-4)


def test_jacobi_svd_routes(monkeypatch):
    """The shape alone picks the route: sorted 8×8 takes the kernel (K4's
    twin on the CPU) whatever DCTSVD_SVD_IMPL says (the JAX package's
    variable; the port reads none), unsorted 8×8 and every other shape
    the plain formulation; n > m raises."""
    from dctsvd_tpu_torch.ops import svd, svd_cuda
    a = torch.from_numpy(_rng(51).normal(size=(6, 8, 8)).astype(np.float32))
    k4 = svd_cuda.jacobi_svd8(a, sweeps=5, compute_uv=True)
    monkeypatch.setenv("DCTSVD_SVD_IMPL", "xla")
    for x, y in zip(svd.jacobi_svd(a), k4):
        assert torch.equal(x, y)
    with pytest.raises(TypeError):
        svd.jacobi_svd(a, impl="xla")

    def refuse(*args, **kw):
        raise AssertionError("the kernel route was taken")
    monkeypatch.setattr(svd, "jacobi_svd8", refuse)
    for x, y in zip(svd.jacobi_svd(a, sort_descending=False),
                    svd._jacobi_svd_plain(a, sort_descending=False)):
        assert torch.equal(x, y)
    svd.jacobi_svd(torch.zeros(2, 9, 8))
    svd.jacobi_svd(torch.zeros(2, 8, 6))
    with pytest.raises(ValueError, match="m >= n"):
        svd.jacobi_svd(torch.zeros(2, 6, 8))


def test_idct2_blocks_matches_jax():
    x = _rng(52).normal(size=(3, 40, 8, 8)).astype(np.float32)
    coefs = dct.dct2_blocks(torch.from_numpy(x))
    got = dct.idct2_blocks(coefs)
    ref = jdct.idct2_blocks(jnp.asarray(coefs.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), x, atol=1e-4)


@pytest.mark.parametrize("src,dst", [
    ((64, 48), (512, 512)), ((96, 80), (40, 30)), ((2, 60, 84, 3), (45, 63)),
    ((50, 70, 3), (50, 140))])
def test_resize_area_matches_jax_and_cv2(src, dst):
    import cv2
    img = _rng(53).integers(0, 256, src, np.uint8)
    got = resize.resize_area(torch.from_numpy(img.astype(np.float32)), *dst)
    ref = np.asarray(jresize.resize_area(jnp.asarray(img.astype(np.float32)),
                                         *dst))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    frames = img.reshape(-1, *img.shape[-3:]) if img.ndim == 4 else [img]
    want = np.stack([cv2.resize(f, dst[::-1], interpolation=cv2.INTER_AREA)
                     for f in frames]).reshape(got.shape)
    assert np.abs(got.numpy() - want.astype(np.float32)).max() <= 1.0
