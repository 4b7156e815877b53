"""The probe kernels' plain twins (``dctsvd_tpu_torch/ops/probe_cuda.py``)
and the port's ``dctsvd_tpu_torch/tools`` probes against the JAX package's
Pallas probes in ``tools/`` (T1-T6), run in interpret mode on the CPU;
the wrappers' routing; ``main()`` refusing to run without a card; and no
module of the port importing jax or the JAX package.

``tools/`` is not a package: each ``tools/*.py`` is loaded by file path,
and its ``pl`` is replaced by a copy of ``jax.experimental.pallas`` whose
``pallas_call`` runs in interpret mode. Nothing in ``tools/`` or
``dctsvd_tpu/`` changes. Inputs are made from a seeded numpy generator
and handed to both sides."""

import ast
import functools
import importlib.util
import pathlib
import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from dctsvd_tpu.ops import wm_pallas
from dctsvd_tpu_torch.ops import probe_cuda, wm_cuda
from dctsvd_tpu_torch.tools import (exp_cachednorms, exp_relayout,
                                    exp_vpu_roofline, exp_widen,
                                    profile_transpose, profile_view)
from dctsvd_tpu_torch.utils import kernels

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
SEED = 20261024
SPEC_TOL = 5e-4     # spectra, × s_max (tests/test_torch_kernels.py)
CHAIN_TOL = 1e-6    # T3 chains, × max |ref|
SHAPE = (1, 1, 24, 64)          # [B, C, H, W]: 3 block rows of 8 blocks
TOOLS = ("exp_relayout", "profile_transpose", "exp_vpu_roofline",
         "exp_widen", "exp_cachednorms", "profile_view")
PORT_TOOLS = (exp_relayout, profile_transpose, exp_vpu_roofline, exp_widen,
              exp_cachednorms, profile_view)
_JNP = {torch.uint8: jnp.uint8, torch.bfloat16: jnp.bfloat16,
        torch.float32: jnp.float32}


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache():
    """Keep this module's interpret-mode Pallas executables out of the
    persistent compile cache: serializing them segfaults XLA:CPU when the
    process has the full suite's compilation state behind it (see
    tests/test_wm_pallas.py). reset_cache() clears jax's
    use-the-cache latch so the flag flip takes effect."""
    from jax._src import compilation_cache as cc
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    cc.reset_cache()


def _interpret_pl():
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                  if not k.startswith("__")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return ns


@pytest.fixture(scope="module")
def jax_tools():
    """The JAX probes of tools/, loaded by path, their pallas_call in
    interpret mode."""
    ns = _interpret_pl()
    mods = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in TOOLS:
            spec = importlib.util.spec_from_file_location(
                f"_jax_tools_{name}", REPO / "tools" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mp.setattr(mod, "pl", ns)
            mods[name] = mod
        yield mods


def _f32_planes(shape=SHAPE, seed=SEED):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 40 + 128).astype(np.float32)


def _u8_planes(shape=SHAPE, seed=SEED):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _rel_err(got, ref):
    got = np.asarray(torch.as_tensor(got).to(torch.float32))
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("port_form", exp_relayout.FORMS)
@pytest.mark.parametrize("jax_form", sorted(exp_relayout.JAX_FORMS))
def test_t1_natural_spectrum_matches_jax(jax_tools, jax_form, port_form):
    x = _f32_planes()
    ref = jax_tools["exp_relayout"].spectrum_nat(jnp.asarray(x), 3, 3,
                                                 jax_form)
    got = exp_relayout.spectrum_nat(torch.from_numpy(x), 3, port_form)
    assert tuple(got.shape) == np.asarray(ref).shape == (1, 1, 24, 8)
    assert _rel_err(got, ref) <= SPEC_TOL


def test_t2a_copy_matches_jax(jax_tools):
    x = _f32_planes((2, 24, 64))
    v = x.reshape(2, 3, 8, 8, 8).swapaxes(3, 4)
    ref = jax_tools["profile_transpose"].copy_consumer(jnp.asarray(v), r=3)
    got = profile_transpose.copy_consumer(torch.from_numpy(
        np.ascontiguousarray(v)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_t2b_cols_view_matches_gatherk_and_plane_cols_view(dtype):
    x = _u8_planes((2, 24, 64)) if dtype == torch.uint8 else _f32_planes(
        (2, 24, 64))
    xj = jnp.asarray(x)
    # gatherk's body on each [r, 8, W] window, over every window at once
    gather = jnp.swapaxes(xj.reshape(2, 3, 8, 8, 8), -1, -2)
    view = wm_pallas._plane_cols_view(xj)[0]
    got = probe_cuda.cols_view(torch.from_numpy(x))
    assert got.dtype == dtype and tuple(got.shape) == (2, 3, 8, 8, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(gather))
    np.testing.assert_array_equal(got.numpy(), np.asarray(view))


@pytest.mark.parametrize("n_ops", [16, 64])
@pytest.mark.parametrize("mode", probe_cuda.CHAIN_MODES)
def test_t3_chain_matches_jax(jax_tools, mode, n_ops):
    x = np.random.default_rng(SEED).standard_normal((2, 3, 8, 16)).astype(
        np.float32)
    p, hb, b, wb = x.shape
    spec = pl.BlockSpec((1, hb, b, wb), lambda i, j: (i, j, 0, 0))
    ref = jax_tools["exp_vpu_roofline"].pl.pallas_call(
        jax_tools["exp_vpu_roofline"]._make_kernel(n_ops, mode),
        grid=(p, 1), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32))(jnp.asarray(x))
    got = exp_vpu_roofline.run(torch.from_numpy(x), mode, n_ops)
    assert _rel_err(got, ref) <= CHAIN_TOL


@pytest.mark.parametrize("mode", probe_cuda.CHAIN_MODES)
def test_t3_lengths_take_the_unrolled_chain(mode):
    """The tool's two lengths give the step counts that fma_chain_kernel
    compiles as constants (csrc/probes.cu launch_chain: kShort, kLong), so
    T3 times the fully unrolled instances."""
    src = (REPO / "dctsvd_tpu_torch" / "csrc" / "probes.cu").read_text()
    consts = {name: (int(ilp8), int(serial)) for name, ilp8, serial in
              re.findall(
                  r"(kShort|kLong) = kIlp8 \? (\d+) : (\d+)", src)}
    col = probe_cuda.CHAIN_MODES.index(mode)
    steps = [probe_cuda.chain_steps(mode, n)[0]
             for n in exp_vpu_roofline.N_OPS]
    assert steps == [consts["kShort"][col], consts["kLong"][col]]


@pytest.mark.parametrize("sweeps", exp_widen.SWEEPS)
@pytest.mark.parametrize("dtype", exp_widen.VIEW_DTYPES)
def test_t4_widen_matches_jax(jax_tools, dtype, sweeps):
    x = _u8_planes()
    ref = jax_tools["exp_widen"].spectrum_dtype(jnp.asarray(x), sweeps,
                                                _JNP[dtype])
    got = exp_widen.spectrum_dtype(torch.from_numpy(x), sweeps, dtype)
    assert tuple(got.shape) == np.asarray(ref).shape
    assert _rel_err(got, ref) <= SPEC_TOL


def test_t5_cached_norms_match_jax(jax_tools):
    x = _f32_planes()
    ref = jax_tools["exp_cachednorms"].spectrum_cached(jnp.asarray(x), 2, 3)
    got = exp_cachednorms.spectrum_cached(torch.from_numpy(x), 2)
    assert _rel_err(got, ref) <= SPEC_TOL
    fresh = exp_cachednorms.spectrum_cached(torch.from_numpy(x), 2,
                                            cached=False)
    assert not torch.equal(got, fresh)     # the cached values really differ


def test_t6a_view_spectrum_matches_jax(jax_tools):
    x = _f32_planes((3, 24, 64))
    view, _, hb, wb = wm_pallas._plane_cols_view(jnp.asarray(x))
    s = jax_tools["profile_view"].pl.pallas_call(
        wm_pallas._make_spectrum_kernel(profile_view.SWEEPS), grid=(3, 1),
        in_specs=[pl.BlockSpec((1, hb, 8, 8, wb),
                               lambda i, j: (i, j, 0, 0, 0))],
        out_specs=pl.BlockSpec((1, hb, 8, wb), lambda i, j: (i, j, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((3, hb, 8, wb), jnp.float32))(view)
    ref = jnp.transpose(s.reshape(-1, 8, wb), (0, 2, 1)).reshape(3, -1, 8)
    got = profile_view.call_kernel(probe_cuda.cols_view(torch.from_numpy(x)))
    assert _rel_err(got, ref) <= SPEC_TOL


@pytest.mark.parametrize("sweeps", [2, 3, 4])
def test_probe_twins_equal_k1_twin(sweeps):
    """Every fresh layout and dtype of the spectrum-probe twin computes K1's
    twin's floats in its order: equal on integer planes."""
    x = torch.from_numpy(_u8_planes((3, 24, 64)))
    k1 = wm_cuda.spectrum_blocks_plain(x, sweeps=sweeps)
    xf = x.to(torch.float32)
    for layout in ("strided", "smem"):
        assert torch.equal(probe_cuda.spectrum_probe(xf, sweeps, layout), k1)
    for dtype in exp_widen.VIEW_DTYPES:
        view = probe_cuda.cols_view(x, dtype)
        assert torch.equal(probe_cuda.spectrum_probe(view, sweeps), k1)


def test_probe_s0_is_the_sorted_column_norms():
    x = torch.from_numpy(_f32_planes((2, 24, 64)))
    view = probe_cuda.cols_view(x)
    norms = torch.linalg.vector_norm(
        x.reshape(2, 3, 8, 8, 8).permute(0, 1, 3, 2, 4).reshape(2, 24, 8, 8),
        dim=-2).sort(dim=-1, descending=True)[0]
    for cached in (False, True):
        s0 = probe_cuda.spectrum_probe(view, 0, cached=cached)
        assert float((s0 - norms).abs().max()) <= 1e-6 * float(norms.max())
    assert torch.equal(probe_cuda.spectrum_probe(x, 0, "strided"),
                       probe_cuda.spectrum_probe(view, 0))


def test_probe_wrappers_take_the_twin_for_cpu_tensors():
    x = torch.from_numpy(_f32_planes((2, 24, 64)))
    fns = (probe_cuda.copy_f32, probe_cuda.cols_view, probe_cuda.fma_chain,
           probe_cuda.spectrum_probe)
    before = [fn.launches for fn in fns]
    assert torch.equal(probe_cuda.copy_f32(x), x)
    view = probe_cuda.cols_view(x)
    assert torch.equal(view, probe_cuda.cols_view_plain(x))
    assert torch.equal(probe_cuda.fma_chain(x, 16, "serial", fused=True),
                       probe_cuda.fma_chain_plain(x, 16, "serial", True))
    assert torch.equal(probe_cuda.spectrum_probe(view, 2, cached=True),
                       probe_cuda.spectrum_probe_plain(view, 2, cached=True))
    # a launch count moves only where a kernel launches
    assert before == [fn.launches for fn in fns]
    assert not kernels._LIB          # nothing was built or loaded


def test_probe_wrappers_refuse_other_devices_and_bad_input():
    x = torch.from_numpy(_f32_planes((2, 24, 64)))
    meta = torch.empty((2, 24, 64), device="meta")
    for call in (lambda: probe_cuda.copy_f32(meta),
                 lambda: probe_cuda.cols_view(meta),
                 lambda: probe_cuda.fma_chain(meta, 16),
                 lambda: probe_cuda.spectrum_probe(meta, 2, "strided")):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    with pytest.raises(ValueError, match="float32"):
        probe_cuda.copy_f32(x.to(torch.uint8))
    with pytest.raises(ValueError, match="no torch.float32 -> torch.uint8"):
        probe_cuda.cols_view(x, torch.uint8)
    with pytest.raises(ValueError, match="multiples of 8"):
        probe_cuda.cols_view(x[:, :20])
    with pytest.raises(ValueError, match="chain mode"):
        probe_cuda.fma_chain(x, 16, "ilp4")
    view = probe_cuda.cols_view(x)
    for sweeps in (1.25, -1, True):
        with pytest.raises(ValueError, match="integer sweep count"):
            probe_cuda.spectrum_probe(view, sweeps)
    with pytest.raises(ValueError, match="layout"):
        probe_cuda.spectrum_probe(x, 2, "tiled")
    with pytest.raises(ValueError, match="no smem torch.uint8"):
        probe_cuda.spectrum_probe(x.to(torch.uint8), 2, "smem")
    with pytest.raises(ValueError, match="cached norms"):
        probe_cuda.spectrum_probe(probe_cuda.cols_view(
            x.to(torch.uint8)), 2, cached=True)
    with pytest.raises(ValueError, match="cols view"):
        probe_cuda.spectrum_probe(x, 2, "cols")


@pytest.mark.parametrize("n4, grid", [(1, 1), (256, 1), (257, 2),
                                      (96 * 1080 * 1920 // 4, 194400)])
def test_copy_f32_grid_covers_the_array_once(n4, grid):
    """One CTA a 256-float4 chunk, the last one partial."""
    assert probe_cuda.copy_f32_grid(n4) == grid
    assert (grid - 1) * probe_cuda.COPY_CHUNK4 < n4 <= grid * \
        probe_cuda.COPY_CHUNK4


H100_SMS = 132


@pytest.mark.parametrize("rows, w, in_size, x_off, y_off, plan", [
    # 1080p planes: Wb = 240, a multiple of 4 (f32) and 16 (u8) blocks;
    # 48,600 or 12,150 CTAs of tiles, capped at 6 CTAs an SM
    (96 * 1080, 1920, 4, 0, 0, (True, 6 * H100_SMS)),
    (96 * 1080, 1920, 1, 0, 0, (True, 6 * H100_SMS)),
    # Wb = 208 on 8 rows of u8: 104 chunks, one CTA with a partial tile
    (8, 1664, 1, 0, 0, (True, 1)),
    # Wb = 10 and Wb = 241: rows off 16-byte boundaries
    (3 * 64, 80, 4, 0, 0, (False, 60)),
    (3 * 64, 80, 1, 0, 0, (False, 60)),
    (16, 1928, 4, 0, 0, (False, 121)),
    # a view one element past a 16-byte boundary, and an unaligned output
    (2 * 16, 1920, 4, 4, 0, (False, 240)),
    (2 * 16, 1920, 1, 1, 0, (False, 240)),
    (2 * 16, 1920, 4, 0, 8, (False, 240)),
])
def test_cols_view_plan(rows, w, in_size, x_off, y_off, plan):
    """The vector path where both pointers and every row sit on 16-byte
    boundaries and the chunks tile each row; the scalar path elsewhere."""
    base = 1 << 20
    assert probe_cuda.cols_view_plan(rows, w, in_size, base + x_off,
                                     base + y_off, H100_SMS) == plan


@pytest.mark.parametrize("tool", PORT_TOOLS, ids=TOOLS)
def test_probe_main_raises_without_a_card(tool, monkeypatch, capsys):
    """A probe measures the card: with no CUDA device its main() raises
    before it prints anything, so no CPU time is ever reported."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main()
    assert capsys.readouterr().out == ""


def test_port_imports_neither_jax_nor_the_jax_package():
    pkg = REPO / "dctsvd_tpu_torch"
    files = sorted(pkg.rglob("*.py"))
    assert pkg / "tools" / "exp_widen.py" in files
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "dctsvd_tpu",
                                           "bench")]
    assert not bad, bad
