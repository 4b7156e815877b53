"""The port's parallel/ (dctsvd_tpu_torch/parallel: mesh, batch, plane)
against the JAX package's parallel/ on the CPU, and against the port's
own unsharded calls.

The JAX side runs its parallel/ entry points on the 8-device virtual CPU
mesh of tests/conftest.py, on its fused branch: the Pallas kernels in
interpret mode at the s1.25 schedule, the path its TPU runs (on the CPU
it otherwise takes a converged XLA fallback, a different schedule from
the one the port always runs). The port's side runs on a mesh of
``[cpu] * 8``. Both start from the same watermark state
(models.blocked.prepared_from_numpy) and 64×64 seeded noise frames.

Tolerances, those of tests/test_torch_serve.py: against the JAX package,
stego bytes within 1 quantum on at most 1 % of the bytes, sc within
SC_TOL·s_max, extracted u8 within 2 quanta, scores within 1e-3; against
the port's own unsharded call, every tensor exact and scores within
1e-5 (the sharded call runs each shard through the very same function).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dctsvd_tpu.models import blocked as jb
from dctsvd_tpu.ops import wm_pallas
from dctsvd_tpu.parallel import batch as jpb
from dctsvd_tpu.parallel import mesh as jmesh
from dctsvd_tpu.parallel import plane as jplane
from dctsvd_tpu.utils import crypto as jcrypto
from dctsvd_tpu_torch.models import blocked as tb
from dctsvd_tpu_torch.models import image as timg
from dctsvd_tpu_torch.parallel import batch as tpb
from dctsvd_tpu_torch.parallel import mesh as tmesh
from dctsvd_tpu_torch.parallel import plane as tplane

torch.set_num_threads(2)

SEED = 20261026
ALPHA = 0.12
SC_TOL = 1e-4       # × s_max, as tests/test_torch_serve.py
PW = "torch-parallel"
H = W = 64
B = 16
CPU8 = [torch.device("cpu")] * 8


class _Interpreted:
    """A jitted Pallas entry point whose ``__wrapped__`` body runs the
    kernel in interpret mode (the JAX package's fused branch calls the
    bodies through ``__wrapped__``)."""

    def __init__(self, fn):
        self.__wrapped__ = functools.partial(fn.__wrapped__, interpret=True)


def _clear_jax_parallel_caches():
    jpb._sharded_jit.cache_clear()
    jpb._embed_full_meta_jit.cache_clear()
    jplane._embed_jit.cache_clear()
    jplane._detect_jit.cache_clear()
    jax.clear_caches()


@pytest.fixture(autouse=True, scope="module")
def _jax_fused_branch():
    """The JAX package on its fused branch for this module, its compiled
    executables dropped on both sides so no other module sees them, and
    its interpret-mode Pallas executables kept out of the persistent
    compile cache (see tests/test_torch_serve.py)."""
    from jax._src import compilation_cache as cc
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    _clear_jax_parallel_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jb, "_USE_FUSED_MEMO", [True])
        for name in ("spectrum_plane_blocks", "embed_plane_blocks",
                     "roundtrip_frames_blocks"):
            mp.setattr(wm_pallas, name,
                       _Interpreted(getattr(wm_pallas, name)))
        yield
    _clear_jax_parallel_caches()
    jax.config.update("jax_enable_compilation_cache", True)
    cc.reset_cache()


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmesh.make_mesh(8), tmesh.make_mesh(8, devices=CPU8)


def _keys(h, w):
    key = jcrypto.derive_key(PW, bytes(range(8)))
    return jcrypto.block_permutation_indices(key, jb.n_blocks_of(h, w))


@pytest.fixture(scope="module")
def case():
    """Seeded noise frames, a gray and a color watermark, and their
    prepared states in both packages."""
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (B, H, W, 3), np.uint8)
    wm = rng.integers(0, 256, (H, W, 3), np.uint8)
    blk, intra = _keys(H, W)
    pj = jb.prepare_wm_gray(jnp.asarray(wm[..., 0]), jnp.asarray(blk),
                            jnp.asarray(intra))
    pjc = jb.prepare_wm_color(jnp.asarray(wm), jnp.asarray(blk),
                              jnp.asarray(intra))

    def port(p):
        return tb.prepared_from_numpy(p.uw, p.sw, p.vwt, p.inv_blk,
                                      p.inv_intra, p.ebasis, device="cpu")
    return dict(frames=frames, wm=wm, blk=blk, intra=intra, pj=pj, pjc=pjc,
                pt=port(pj), ptc=port(pjc))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _assert_stego_close(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape
    d = np.abs(got.numpy().astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())


def _assert_sc_close(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=SC_TOL * float(np.abs(ref).max()))


def _assert_u8_close(got: torch.Tensor, ref, quanta=2):
    ref = np.asarray(ref)
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape
    assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= quanta


def _assert_equal(got, ref):
    """The sharded output equals the unsharded one: tensors exactly."""
    assert torch.equal(got, ref), float((got.float() - ref.float())
                                        .abs().max())


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

def test_mesh_shapes():
    m = tmesh.make_mesh(8, devices=CPU8)
    assert m.axis_names == (tmesh.BATCH_AXIS,)
    assert m.shape == {"batch": 8} and len(m.devices) == 8
    assert m == tmesh.make_mesh(devices=CPU8) and hash(m) == hash(
        tmesh.make_mesh(devices=CPU8))
    m2 = tmesh.make_mesh(devices=CPU8, plane=2)
    assert m2.axis_names == (tmesh.BATCH_AXIS, tmesh.PLANE_AXIS)
    assert m2.shape == {"batch": 4, "plane": 2}
    assert all(len(row) == 2 for row in m2.devices)
    assert tplane._batch_size(m2) == 4 and len(tmesh.batch_devices(m2)) == 4
    # the same axis sizes as the JAX package's meshes
    assert dict(jmesh.make_mesh(8, plane=2).shape) == m2.shape
    assert tmesh.make_mesh(3, devices=CPU8).shape == {"batch": 3}
    assert tmesh.batch_sharding(m).split and not tmesh.replicated(m).split
    assert tmesh.batch_sharding(m).mesh is m


def test_mesh_refusals(monkeypatch):
    with pytest.raises(ValueError, match="requested a 9-device mesh"):
        tmesh.make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="plane=3"):
        tmesh.make_mesh(devices=CPU8, plane=3)
    m = tmesh.make_mesh(devices=CPU8)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_batch(torch.zeros(12, 2), m)
    # no card and no explicit devices: the mesh, and so every entry point
    # given no mesh, raises; nothing falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    x = torch.zeros(8, 16, 16, 3, dtype=torch.uint8)
    sw = torch.zeros(4, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpb.batch_detect_blocked(x, sw, sw, ALPHA)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplane.plane_embed_gray(x[0], sw, ALPHA)


def test_shard_replicate_gather():
    m = tmesh.make_mesh(4, devices=CPU8)
    x = torch.arange(24.0).reshape(8, 3)
    parts = tmesh.shard_batch(x, m)
    assert [tuple(p.shape) for p in parts] == [(2, 3)] * 4
    assert torch.equal(tmesh.gather(parts, m), x)
    assert list(tmesh.replicate(x, m)) == [torch.device("cpu")]
    one = tmesh.make_mesh(1, devices=CPU8)
    y = torch.ones(3)
    assert tmesh.gather([y], one) is y              # one shard: no copy


def test_init_distributed_passthrough(monkeypatch):
    """Every given argument, and only those, reaches
    torch.distributed.init_process_group (NCCL); no argument defers to
    the environment, as jax.distributed.initialize() does."""
    import torch.distributed as dist
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    tmesh.init_distributed()
    assert calls[-1] == {"backend": "nccl"}
    tmesh.init_distributed("10.0.0.1:1234", num_processes=4, process_id=2)
    assert calls[-1] == dict(backend="nccl", init_method="tcp://10.0.0.1:1234",
                             world_size=4, rank=2)
    tmesh.init_distributed(num_processes=2)
    assert calls[-1] == dict(backend="nccl", world_size=2)


# ---------------------------------------------------------------------------
# batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gray_embed(case, meshes):
    """The port's sharded gray embed of the batch, and the JAX package's."""
    jm, tm = meshes
    st, sc = tpb.batch_embed_prepared(_t(case["frames"]), case["pt"].sw,
                                      ALPHA, mesh=tm)
    sj, scj = jpb.batch_embed_prepared(jnp.asarray(case["frames"]),
                                       case["pj"].sw, ALPHA, mesh=jm)
    return st, sc, sj, scj


def test_batch_embed_prepared(case, gray_embed):
    st, sc, sj, scj = gray_embed
    _assert_stego_close(st, sj)
    _assert_sc_close(sc, scj)
    ref = tb.embed_gray_prepared(_t(case["frames"]), case["pt"].sw, ALPHA,
                                 with_metrics=False)
    _assert_equal(st, ref[0])
    _assert_equal(sc, ref[1])


def test_batch_extract_prepared(case, meshes, gray_embed):
    jm, tm = meshes
    st, sc, _, _ = gray_embed
    pt, pj = case["pt"], case["pj"]
    rec = tpb.batch_extract_prepared(st, sc, pt.ebasis, pt.inv_blk, pt.sw,
                                     ALPHA, mesh=tm)
    rec_j = jpb.batch_extract_prepared(jnp.asarray(st.numpy()),
                                       jnp.asarray(sc.numpy()), pj.ebasis,
                                       pj.inv_blk, pj.sw, ALPHA, mesh=jm)
    _assert_u8_close(rec, rec_j)
    _assert_equal(rec, tb.extract_gray_prepared(st, sc, pt.ebasis,
                                                pt.inv_blk, ALPHA, sw=pt.sw))


@pytest.mark.parametrize("frames", [1, 5, tb.RECON_FRAMES + 1])
def test_recon_same_bytes_alone_and_in_a_batch(frames):
    """The extract tail's k-term product gives each frame the same bytes
    alone, in any slice and in the whole batch (a batched product's
    algorithm may depend on its shape), and agrees with the einsum."""
    gen = torch.Generator().manual_seed(20261033)
    x = torch.randn(frames, 3, 40, 5, generator=gen)[..., :4]
    e = torch.randn(3, 40, 4, 64, generator=gen)
    whole = tb._recon(x, e)
    assert whole.shape == (frames, 3, 40, 64)
    ref = torch.einsum("...nj,...njp->...np", x, e)
    assert float((whole - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    for a, b in ((0, 1), (frames - 1, frames), (frames // 2, frames)):
        assert torch.equal(tb._recon(x[a:b], e), whole[a:b])


@pytest.mark.parametrize("per_frame_sc", [False, True])
@pytest.mark.parametrize("sweeps", [None, 2])
def test_batch_detect_blocked(case, meshes, gray_embed, per_frame_sc,
                              sweeps):
    """Own stegos and clean covers in one batch, against the first
    frame's sc (replicated) or each frame's own (per_frame_sc)."""
    jm, tm = meshes
    st, sc, _, _ = gray_embed
    pt, pj = case["pt"], case["pj"]
    frames = torch.cat([st[:B // 2], _t(case["frames"][B // 2:])])
    sc_in = sc if per_frame_sc else sc[0]
    got = tpb.batch_detect_blocked(frames, sc_in, pt.sw, ALPHA, mesh=tm,
                                   per_frame_sc=per_frame_sc, sweeps=sweeps)
    ref_j = np.asarray(jpb.batch_detect_blocked(
        jnp.asarray(frames.numpy()), jnp.asarray(sc_in.numpy()), pj.sw,
        ALPHA, mesh=jm, per_frame_sc=per_frame_sc, sweeps=sweeps))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), ref_j, rtol=0, atol=1e-3)
    ref = tb.detect_gray(frames, sc_in, pt.sw, ALPHA, sweeps=sweeps)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    if per_frame_sc:         # the blocked detect threshold, 0.30
        assert float(got[:B // 2].min()) > 0.3
        assert float(got[B // 2:].abs().max()) < 0.3


def test_batch_detect_full(case, meshes):
    """The parity-path detect of each image against one shared (sc, sw):
    the stego of frame 0 scores and the clean frame 0 cancels to exactly
    0. Against the JAX package every image
    but that one: its score is the NC of the two LAPACK builds' last-ulp
    differences in S, amplified by 1/alpha."""
    jm, tm = meshes
    frames = case["frames"][:8]
    wm = torch.as_tensor(case["wm"][..., 0])
    idx = torch.as_tensor(np.random.default_rng(SEED).permutation(H * W))
    res = timg.embed_gray(torch.as_tensor(frames[0]), wm, idx, ALPHA)
    batch = np.concatenate([res.stego_bgr.numpy()[None], frames])
    got = tpb.batch_detect_full(torch.as_tensor(batch), res.sc, res.sw,
                                ALPHA, mesh=tmesh.make_mesh(
                                    3, devices=CPU8))
    ref_j = np.asarray(jpb.batch_detect_full(
        jnp.asarray(batch[:8]), jnp.asarray(res.sc.numpy()),
        jnp.asarray(res.sw.numpy()), ALPHA, mesh=jm))
    others = [0] + list(range(2, 8))
    np.testing.assert_allclose(got[others].numpy(), ref_j[others], rtol=0,
                               atol=1e-3)
    single = torch.stack([timg.detect_gray(torch.as_tensor(im), res.sc,
                                           res.sw, ALPHA) for im in batch])
    _assert_equal(got, single)
    assert float(got[0]) > 0.9 and float(got[1]) == 0.0


def test_batch_serve_verify_detect(case, meshes):
    jm, tm = meshes
    ptc, pjc = case["ptc"], case["pjc"]
    frames = case["frames"][:8]
    got = tpb.batch_serve_verify_detect(_t(frames), ptc.sw, ALPHA,
                                        ptc.ebasis, ptc.inv_blk, mesh=tm)
    ref_j = jpb.batch_serve_verify_detect(jnp.asarray(frames), pjc.sw,
                                          ALPHA, pjc.ebasis, pjc.inv_blk,
                                          mesh=jm)
    _assert_stego_close(got[0], ref_j[0])
    _assert_sc_close(got[1], ref_j[1])
    _assert_u8_close(got[2], ref_j[2])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref_j[3]),
                               rtol=0, atol=1e-3)
    ref = tb.serve_verify_detect_color_prepared(_t(frames), ptc.sw, ALPHA,
                                                ptc.ebasis, ptc.inv_blk)
    for g, r in zip(got[:3], ref[:3]):
        _assert_equal(g, r)
    np.testing.assert_allclose(got[3].numpy(), ref[3].numpy(), rtol=0,
                               atol=1e-5)
    assert float(got[3].min()) > 0.3


def test_batch_embed_blocked(case, meshes):
    """The watermark is prepared per device inside; stego, sc, psnr and
    ssim per frame, the factors once."""
    jm, tm = meshes
    frames = case["frames"][:8]
    args = (case["wm"][..., 0], case["blk"], case["intra"])
    got = tpb.batch_embed_blocked(_t(frames), *map(_t, args), ALPHA,
                                  mesh=tm)
    ref_j = jpb.batch_embed_blocked(jnp.asarray(frames),
                                    *map(jnp.asarray, args), ALPHA, mesh=jm)
    _assert_stego_close(got["stego"], ref_j["stego"])
    _assert_sc_close(got["sc"], ref_j["sc"])
    _assert_sc_close(got["sw"], ref_j["sw"])
    np.testing.assert_allclose(got["psnr"].numpy(), np.asarray(ref_j["psnr"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["ssim"].numpy(), np.asarray(ref_j["ssim"]),
                               rtol=0, atol=1e-3)
    assert got["uw"].shape == ref_j["uw"].shape == (64, 8, 8)
    ref = tb.embed_gray(_t(frames), *map(_t, args), ALPHA)
    for key, r in (("stego", ref.stego_bgr), ("sc", ref.sc), ("uw", ref.uw),
                   ("vwt", ref.vwt), ("sw", ref.sw), ("psnr", ref.psnr),
                   ("ssim", ref.ssim)):
        _assert_equal(got[key], r)


# ---------------------------------------------------------------------------
# plane
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plane_case():
    h, w = 512, 128
    rng = np.random.default_rng(SEED + 1)
    cover = rng.integers(0, 256, (h, w, 3), np.uint8)
    wm = rng.integers(0, 256, (h, w), np.uint8)
    blk, intra = _keys(h, w)
    pj = jb.prepare_wm_gray(jnp.asarray(wm), jnp.asarray(blk),
                            jnp.asarray(intra), extract_basis=False)
    return cover, pj, torch.as_tensor(np.array(pj.sw))


def test_plane_embed_detect(meshes, plane_case):
    """Bands on 8 shards: the stego and sc equal the whole-frame embed's
    exactly; the gathered band median fires on the stego and not on the
    cover; both match the JAX package's plane path."""
    jm, tm = meshes
    cover, pj, sw = plane_case
    stego, sc = tplane.plane_embed_gray(_t(cover), sw, ALPHA, mesh=tm)
    ref = tb.embed_gray_prepared(_t(cover), sw, ALPHA, with_metrics=False)
    _assert_equal(stego, ref[0])
    _assert_equal(sc, ref[1])
    sj, scj = jplane.plane_embed_gray(jnp.asarray(cover), pj.sw, ALPHA,
                                      mesh=jm)
    _assert_stego_close(stego, sj)
    _assert_sc_close(sc, scj)

    score = tplane.plane_detect_gray(stego, sc, sw, ALPHA, mesh=tm)
    clean = tplane.plane_detect_gray(_t(cover), sc, sw, ALPHA, mesh=tm)
    assert score.ndim == 0 and float(score) > 0.8
    assert abs(float(clean)) < 0.3
    for img, got in ((stego, score), (_t(cover), clean)):
        ref_j = float(jplane.plane_detect_gray(
            jnp.asarray(img.numpy()), jnp.asarray(sc.numpy()), pj.sw, ALPHA,
            mesh=jm))
        assert abs(float(got) - ref_j) <= 1e-3
    # one band per shard on a 2-D mesh as well: 4 batch shards
    m2 = tmesh.make_mesh(devices=CPU8, plane=2)
    _assert_equal(tplane.plane_embed_gray(_t(cover), sw, ALPHA,
                                          mesh=m2)[0], stego)


def test_plane_refuses_indivisible_height(meshes, plane_case):
    _, tm = meshes
    cover, _, sw = plane_case
    with pytest.raises(ValueError, match=r"divisible by 8\*n_shards \(64\)"):
        tplane.plane_embed_gray(_t(cover[:-8]), sw, ALPHA, mesh=tm)
    with pytest.raises(ValueError, match="got H=504"):
        tplane.plane_detect_gray(_t(cover[:-8]), sw, sw, ALPHA, mesh=tm)
