"""The plain twins of the port's CUDA kernels (K1 spectrum, K2 embed, K4
8×8 SVD) against the JAX package's Pallas kernels, run in interpret mode on
the CPU, and the wrappers' routing rules. The CUDA kernels themselves run
only on a GPU (tests/test_torch_gpu.py, chip_smoke.py).

Inputs are uniform u8 noise from a seeded numpy generator: its blocks are
well conditioned, so the twin and the Pallas kernel agree to rounding.
(On smooth content the near-degenerate blocks are far from converged at
s1.25, and ulp-level differences move their rotations — the JAX package's
own Pallas and XLA replays differ there just as much.)"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dctsvd_tpu.ops import dct as jdct
from dctsvd_tpu.ops import svd as jsvd
from dctsvd_tpu.ops import svd_pallas, wm_pallas
from dctsvd_tpu_torch.ops import svd_cuda, wm_cuda
from dctsvd_tpu_torch.utils import kernels

torch.set_num_threads(2)

SEED = 20261017
SPEC_TOL = 5e-4     # K1 twin vs kernel/replay, × s_max (test_wm_pallas.py)
SC_TOL = 1e-4       # K2 sc, × s_max
SVD_TOL = 1e-5      # K4 S, × s_max


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


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (2, 64, 80, 3), np.uint8)
    n = (64 // 8) * (80 // 8)
    mask = (np.arange(8) < 4).astype(np.float32)
    sws = ((rng.standard_normal((3, n, 8)) ** 2) * 3 * mask).astype(
        np.float32)
    return frames, sws


def _rel_err(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("sweeps", [0.01, 0.5, 1, 1.25, 1.5, 1.75, 1.999,
                                    2, 2.0357, 3.9999, 4, 5])
def test_schedule_math_matches_jax(sweeps):
    assert wm_cuda.PAIRS == wm_pallas.PAIRS
    assert wm_cuda.sched_split(sweeps) == wm_pallas.sched_split(sweeps)
    assert wm_cuda._schedule(sweeps) == wm_pallas._schedule(sweeps)
    full, xp = wm_cuda.sched_split(sweeps)
    assert wm_cuda.sched_join(full, xp) == wm_pallas.sched_join(full, xp)
    assert wm_cuda.sched_split(1.999) == (2, 0)


def test_sort_net_and_rotation_constants():
    assert svd_cuda._SORT_NET == svd_pallas._SORT_NET
    app = torch.tensor([4.0, 1.0, 2.0, 0.0])
    aqq = torch.tensor([1.0, 4.0, 2.0, 0.0])
    apq = torch.tensor([0.5, -0.5, 1.0, 0.0])
    c, s, t = svd_cuda._rotation(app, aqq, apq)
    jc, js, jt, _ = svd_pallas._rotation(jnp.asarray(app.numpy()),
                                         jnp.asarray(aqq.numpy()),
                                         jnp.asarray(apq.numpy()))
    for a, b in ((c, jc), (s, js), (t, jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert float(c[3]) == 1.0 and float(s[3]) == 0.0   # d = e = 0


@pytest.mark.parametrize("layout", ["frames", "planes"])
def test_spectrum_twin_matches_pallas(data, layout):
    frames, _ = data
    if layout == "frames":
        x, cl = frames, True
    else:
        x, cl = np.ascontiguousarray(np.moveaxis(frames, -1, -3)), False
    ref = wm_pallas.spectrum_plane_blocks(jnp.asarray(x), sweeps=1.25,
                                          channels_last=cl, interpret=True)
    got = wm_cuda.spectrum_blocks(torch.from_numpy(x), sweeps=1.25,
                                  channels_last=cl)
    assert tuple(got.shape) == np.asarray(ref).shape == (2, 3, 80, 8)
    assert _rel_err(got, ref) <= SPEC_TOL


@pytest.mark.parametrize("sweeps", [1.25, 2, 4])
def test_spectrum_twin_matches_xla_replay(data, sweeps):
    frames, _ = data
    planes = np.moveaxis(frames, -1, -3).astype(np.float32)
    ref = jsvd._jacobi_svd_xla(jdct.blockify(jnp.asarray(planes)),
                               sweeps=sweeps, compute_uv=False)
    got = wm_cuda.spectrum_blocks(torch.from_numpy(planes), sweeps=sweeps)
    assert _rel_err(got, ref) <= SPEC_TOL


@pytest.mark.parametrize("k", list(range(1, 9)))
def test_embed_twin_matches_pallas_u8_frames(data, k):
    frames, _ = data
    n = (64 // 8) * (80 // 8)
    sws = ((np.random.default_rng(SEED + 2).standard_normal((3, n, 8)) ** 2)
           * 3 * (np.arange(8) < k)).astype(np.float32)
    ref_y, ref_sc = wm_pallas.embed_plane_blocks(
        jnp.asarray(frames), jnp.asarray(sws), sweeps=1.25, k=k,
        out_u8=True, channels_last=True, interpret=True)
    y, sc = wm_cuda.embed_blocks(torch.from_numpy(frames),
                                 torch.from_numpy(sws), sweeps=1.25, k=k,
                                 out_u8=True, channels_last=True)
    ref_y = np.asarray(ref_y)
    assert y.dtype == torch.uint8 and tuple(y.shape) == ref_y.shape
    d = np.abs(y.numpy().astype(int) - ref_y.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
    assert _rel_err(sc, ref_sc) <= SC_TOL
    assert not np.array_equal(y.numpy(), frames)      # the mark is painted


def test_embed_twin_matches_pallas_f32_gray(data):
    """f32 gray planes with one shared watermark (sws indexed by p % 1)."""
    frames, sws = data
    planes = frames[..., 1].astype(np.float32)          # [2, 64, 80]
    ref_y, ref_sc = wm_pallas.embed_plane_blocks(
        jnp.asarray(planes), jnp.asarray(sws[:1]), sweeps=1.25, k=4,
        interpret=True)
    y, sc = wm_cuda.embed_blocks(torch.from_numpy(planes),
                                 torch.from_numpy(sws[:1]), sweeps=1.25, k=4)
    assert y.dtype == torch.float32
    assert _rel_err(y, ref_y) <= 1e-5
    assert _rel_err(sc, ref_sc) <= SC_TOL


@pytest.mark.parametrize("compute_uv", [True, False])
def test_svd8_twin_matches_pallas(compute_uv):
    rng = np.random.default_rng(SEED + 1)
    blocks = rng.integers(0, 256, (3, 40, 8, 8)).astype(np.float32)
    a = np.array(jdct.dct2_blocks(jnp.asarray(blocks)))
    ref = svd_pallas.jacobi_svd_pallas(jnp.asarray(a), compute_uv=compute_uv,
                                       interpret=True)
    got = svd_cuda.jacobi_svd8(torch.from_numpy(a), compute_uv=compute_uv)
    if not compute_uv:
        assert _rel_err(got, ref) <= SVD_TOL
        return
    u, s, vt = got
    assert _rel_err(s, ref[1]) <= SVD_TOL
    smax = float(np.asarray(ref[1]).max())
    rec = torch.einsum("...ij,...j,...jk->...ik", u, s, vt).numpy()
    assert np.abs(rec - a).max() <= 1e-4 * smax
    np.testing.assert_allclose(np.abs(vt.numpy()), np.abs(np.asarray(ref[2])),
                               atol=1e-3)


def test_wrappers_take_the_twin_for_cpu_tensors(data):
    frames, sws = data
    x = torch.from_numpy(frames)
    before = (wm_cuda.spectrum_blocks.launches, wm_cuda.embed_blocks.launches,
              svd_cuda.jacobi_svd8.launches)
    s = wm_cuda.spectrum_blocks(x, sweeps=1.25, channels_last=True)
    assert torch.equal(s, wm_cuda.spectrum_blocks_plain(
        x, sweeps=1.25, channels_last=True))
    y, _ = wm_cuda.embed_blocks(x, torch.from_numpy(sws), sweeps=1.25, k=4,
                                out_u8=True, channels_last=True)
    y2, _ = wm_cuda.embed_blocks_plain(x, torch.from_numpy(sws), sweeps=1.25,
                                       k=4, out_u8=True, channels_last=True)
    assert torch.equal(y, y2)
    a = torch.randn(5, 8, 8)
    assert torch.equal(svd_cuda.jacobi_svd8(a, compute_uv=False),
                       svd_cuda.jacobi_svd8_plain(a, compute_uv=False))
    # a launch count moves only where a kernel launches
    assert before == (wm_cuda.spectrum_blocks.launches,
                      wm_cuda.embed_blocks.launches,
                      svd_cuda.jacobi_svd8.launches)
    assert not kernels._LIB          # nothing was built or loaded


def test_wrappers_refuse_other_devices_and_bad_input(data):
    frames, sws = data
    meta = torch.empty((1, 64, 80, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wm_cuda.spectrum_blocks(meta, channels_last=True)
    with pytest.raises(ValueError, match="unsupported device"):
        svd_cuda.jacobi_svd8(torch.empty((2, 8, 8), device="meta"))
    x = torch.from_numpy(frames)
    with pytest.raises(ValueError, match="0-sweep"):
        wm_cuda.spectrum_blocks(x, sweeps=0, channels_last=True)
    with pytest.raises(ValueError, match="multiples of 8"):
        wm_cuda.spectrum_blocks(x[:, :60], channels_last=True)
    with pytest.raises(ValueError, match="sws"):
        wm_cuda.embed_blocks(x, torch.from_numpy(sws[:, :10]),
                             channels_last=True)
    with pytest.raises(ValueError, match="divide"):
        wm_cuda.embed_blocks(x, torch.zeros(4, 80, 8), channels_last=True)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No nvcc: load() raises instead of falling back to anything."""
    monkeypatch.setattr(kernels, "_LIB", [])
    monkeypatch.setattr(kernels, "_BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(kernels.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load()
    assert not (tmp_path / "build").exists()


# two entries of an nvcc -Xptxas -v log, as ptxas prints them
PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN6dctsvd12embed_kernelIhhLi4EEEvPKT_PKfiPT0_Pflliiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN6dctsvd12embed_kernelIhhLi4EEEvPKT_PKfiPT0_Pflliiiii
    24 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN6dctsvd16roundtrip_kernelILi4EEEvPKhPKfiPhPfS6_lliiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN6dctsvd16roundtrip_kernelILi4EEEvPKhPKfiPhPfS6_lliiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 102 registers, used 0 barriers, 8192 bytes smem, 400 bytes cmem[0]
"""


PTXAS_LOG_K5 = PTXAS_LOG.replace("Li4E", "Li5E").replace("Used 96", "Used 95")


@pytest.mark.parametrize("mangled,counts", [
    ("_ZN6dctsvd12embed_kernelIhhLi4EEEvPKT_PKfiPT0_Pflliiiii",
     dict(stack_frame=24, spill_stores=12, spill_loads=16, registers=96)),
    ("_ZN6dctsvd12embed_kernelIhhLi5EEEvPKT_PKfiPT0_Pflliiiii",
     dict(stack_frame=24, spill_stores=12, spill_loads=16, registers=95)),
    ("_ZN6dctsvd16roundtrip_kernelILi4EEEvPKhPKfiPhPfS6_lliiiii",
     dict(stack_frame=0, spill_stores=0, spill_loads=0, registers=102)),
    ("_ZN6dctsvd16roundtrip_kernelILi5EEEvPKhPKfiPhPfS6_lliiiii",
     dict(stack_frame=0, spill_stores=0, spill_loads=0, registers=102)),
])
def test_ptxas_report_keeps_each_instance_apart(mangled, counts):
    """Every template instance keeps its own counts under its mangled
    name."""
    rep = kernels.ptxas_report(PTXAS_LOG + PTXAS_LOG_K5)
    assert len(rep) == 4
    assert rep[mangled] == counts


# one kernel of a cuobjdump -sass listing, as cuobjdump prints it: a loop
# (the sweeps) between a load and a store, EXIT and the branch-to-self
# that ends the body, then a subroutine that is not counted
SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN6dctsvd4kernEv
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;             /* 0x00000a00ff017b82 */
                                                                      /* 0x000fe40000000800 */
        /*0010*/                   LDG.E.U8 R2, desc[UR4][R2.64] ;    /* 0x0000000402027981 */
        /*0020*/                   I2FP.F32.U32 R3, R2 ;              /* 0x0000000200037245 */
.L_x_0:
        /*0030*/                   FMUL R4, R3, R3 ;
        /*0040*/                   FADD R3, R4, R3 ;
        /*0050*/                   MUFU.RSQ R5, R3 ;
        /*0060*/                   ISETP.NE.AND P0, PT, R6, RZ, PT ;
        /*0070*/               @P0 BRA `(.L_x_0) ;
        /*0080*/                   FSEL R3, R3, R5, P1 ;
        /*0090*/                   STG.E desc[UR4][R8.64], R3 ;
        /*00a0*/                   EXIT ;
.L_x_1:
        /*00b0*/                   BRA `(.L_x_1);
        /*00c0*/                   NOP;
        /*00d0*/                   FFMA R1, R2, R3, R4 ;
"""


# the same listing with branch targets as addresses and no label lines
SASS_BY_ADDRESS = "\n".join(
    ln for ln in SASS.replace("`(.L_x_0)", "0x30").replace(
        "`(.L_x_1)", "0xb0").splitlines() if not ln.startswith(".L_"))


@pytest.mark.parametrize("sass", [SASS, SASS_BY_ADDRESS],
                         ids=["labels", "addresses"])
@pytest.mark.parametrize("sweeps", [1.25, 5])
def test_sass_mix_counts_the_sweep_loop(sweeps, sass):
    """The body up to the branch-to-self by class, the loop body apart,
    and one lane's count at a schedule: main + sweep * (sweeps - 2)."""
    mix = kernels.sass_mix(sass, sweeps)["_ZN6dctsvd4kernEv"]
    assert mix["main"] == dict(load=2, conversion=1, f32=2, mufu=1,
                               integer=1, other=2, f32_compare_select=1,
                               store=1)
    assert mix["sweep"] == dict(f32=2, mufu=1, integer=1, other=1)
    assert mix["per_lane"]["f32"] == 2 + 2 * (sweeps - 2)
    assert mix["per_lane"]["store"] == 1
    assert mix["loops"] == [mix["sweep"]]


def test_sass_mix_counts_every_loop():
    """A loop inside another: "sweep" is the outer body, "loops" holds the
    inner body first, then the outer one."""
    isetp = "ISETP.NE.AND P0, PT, R6, RZ, PT ;"
    fadd = "FADD R3, R4, R3 ;"
    nested = SASS.replace(
        isetp, isetp + "\n        /*0068*/    @P0 BRA `(.L_x_2) ;").replace(
        fadd, fadd + "\n.L_x_2:")
    mix = kernels.sass_mix(nested, 2)["_ZN6dctsvd4kernEv"]
    assert mix["loops"] == [dict(mufu=1, integer=1, other=1),
                            dict(f32=2, mufu=1, integer=1, other=2)]
    assert mix["sweep"] == mix["loops"][1]


_C_TYPES = {"int": kernels._I, "long long": kernels._LL,
            "float": kernels._F}


def _c_entries() -> dict:
    """{name: [ctypes type of each parameter]} of every ``extern "C"``
    entry point in csrc/: pointers as c_void_p, int, long long and float
    as theirs."""
    import re
    out = {}
    for f in sorted(kernels._CSRC.glob("*.cu*")):
        for m in re.finditer(r'extern "C" int (dctsvd_\w+)\(([^)]*)\)',
                             f.read_text()):
            out[m[1]] = [kernels._P if "*" in p
                         else _C_TYPES[" ".join(p.split()[:-1])]
                         for p in m[2].split(",")]
    return out


@pytest.mark.parametrize("name", sorted(kernels._SIGNATURES))
def test_c_entry_matches_its_signature(name):
    """Each launcher's ctypes argtypes name the C entry's parameters, in
    order (ctypes would pass a wrong one without a word); every entry in
    csrc/ has argtypes."""
    entries = _c_entries()
    assert set(entries) == set(kernels._SIGNATURES)
    assert entries[name] == kernels._SIGNATURES[name]
