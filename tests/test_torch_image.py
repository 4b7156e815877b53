"""The port's parity path (dctsvd_tpu_torch/models/image.py, the whole-plane
dct2/idct2, permute_plane, svd_full, and the api with ``method='full'``)
against the JAX package on the CPU.

Both sides embed with the same nonce (pinned with monkeypatch in both
packages' crypto modules), so both derive the same permutation. Tolerances:
stego bytes within 1 quantum on at most 1 % of the bytes; PSNR within
0.01 dB and SSIM within 1e-3; detect within 1e-3; the two extractions' NC
>= 0.999 (the outer bound is the README's oracle tolerances: 0.1 dB, 0.001
and 1e-3). dct2/idct2 within 1e-5 of the plane's scale, permute_plane
exact, svd_full's S within 1e-6 of s_max. Cross-package metas agree
within these tolerances, not bit for bit: the two SVDs differ at f32 ulp
level."""

import warnings

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctsvd_tpu import api as japi
from dctsvd_tpu.models import image as jimg
from dctsvd_tpu.ops import dct as jdct
from dctsvd_tpu.ops import permute as jperm
from dctsvd_tpu.ops import svd as jsvd
from dctsvd_tpu.utils import crypto as jcrypto
from dctsvd_tpu_torch import api as tapi
from dctsvd_tpu_torch.io import meta as tmeta
from dctsvd_tpu_torch.models import image as timg
from dctsvd_tpu_torch.ops import dct as tdct
from dctsvd_tpu_torch.ops import permute as tperm
from dctsvd_tpu_torch.ops import svd as tsvd
from dctsvd_tpu_torch.utils import crypto as tcrypto

torch.set_num_threads(2)

SEED = 20261022
PW = "parity-port"
NONCE = bytes(range(8))
ALPHA = 0.12


def _nc(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    a, b = a - a.mean(), b - b.mean()
    return float(a @ b / np.sqrt((a @ a) * (b @ b)))


def _assert_stego_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())


def _images(h, w, seed=SEED):
    rng = np.random.default_rng(seed)
    cover = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                             (0, 0), 2.0)
    wm = rng.integers(0, 256, (h, w, 3), np.uint8)
    return cover, wm


@pytest.mark.parametrize("shape", [(64, 80), (61, 83), (3, 96, 128)],
                         ids=str)
def test_dct2_idct2_match_jax(shape):
    x = (np.random.default_rng(SEED).random(shape) * 255).astype(np.float32)
    c = tdct.dct2(torch.as_tensor(x))
    cj = np.asarray(jdct.dct2(jnp.asarray(x)))
    scale = float(np.abs(cj).max())
    assert np.abs(c.numpy() - cj).max() <= 1e-5 * scale
    back = tdct.idct2(c).numpy()
    assert np.abs(back - np.asarray(jdct.idct2(jnp.asarray(cj)))).max() \
        <= 1e-5 * 255
    assert np.abs(back - x).max() <= 1e-3


def test_permute_plane_matches_jax():
    x = np.random.default_rng(SEED).integers(0, 256, (3, 37, 51)).astype(
        np.float32)
    idx = jcrypto.permutation_indices(jcrypto.derive_key(PW, NONCE), 37 * 51)
    inv = jcrypto.inverse_permutation(idx)
    got = tperm.permute_plane(torch.as_tensor(x), torch.as_tensor(idx))
    ref = np.asarray(jperm.permute_plane(jnp.asarray(x), jnp.asarray(idx)))
    assert np.array_equal(got.numpy(), ref)
    back = tperm.unpermute_plane(got, torch.as_tensor(inv))
    assert np.array_equal(back.numpy(), x)


@pytest.mark.parametrize("shape", [(64, 80), (3, 96, 128), (61, 83)],
                         ids=str)
def test_svd_full_values_only_is_the_full_s(shape):
    """compute_uv=False runs the full decomposition: its S is bit-equal to
    the full call's, so S(unmodified) − Sc cancels exactly."""
    x = tdct.dct2(torch.as_tensor(
        np.random.default_rng(SEED + 1).integers(0, 256, shape).astype(
            np.float32)))
    u, s, vt = tsvd.svd_full(x)
    assert torch.equal(tsvd.svd_full(x, compute_uv=False), s)
    assert tuple(u.shape[-2:]) == (shape[-2], min(shape[-2:]))
    assert tuple(vt.shape[-2:]) == (min(shape[-2:]), shape[-1])
    sj = np.asarray(jsvd.svd_full(jnp.asarray(x.numpy()), compute_uv=False))
    assert np.abs(s.numpy() - sj).max() <= 1e-6 * float(sj.max())


@pytest.mark.parametrize("shape", [(64, 80), (61, 83)], ids=str)
@pytest.mark.parametrize("mode", ["gray", "color"])
def test_models_match_jax(mode, shape):
    h, w = shape
    cover, wm = _images(h, w)
    idx = jcrypto.permutation_indices(jcrypto.derive_key(PW, NONCE), h * w)
    inv = jcrypto.inverse_permutation(idx)
    tj = dict(cover=jnp.asarray(cover), idx=jnp.asarray(idx),
              inv=jnp.asarray(inv), alpha=jnp.float32(ALPHA))
    tt = dict(cover=torch.as_tensor(cover), idx=torch.as_tensor(idx),
              inv=torch.as_tensor(inv), alpha=ALPHA)
    if mode == "gray":
        wm_in = wm[..., 1]
        rj = jimg.embed_gray(tj["cover"], jnp.asarray(wm_in), tj["idx"],
                             tj["alpha"])
        rt = timg.embed_gray(tt["cover"], torch.as_tensor(wm_in), tt["idx"],
                             ALPHA)
        sc_j, sc_t = rj.sc, rt.sc
        ext_j, ext_t = jimg.extract_gray, timg.extract_gray
        det_j, det_t = jimg.detect_gray, timg.detect_gray
    else:
        rj = jimg.embed_color(tj["cover"], jnp.asarray(wm), tj["idx"],
                              tj["alpha"])
        rt = timg.embed_color(tt["cover"], torch.as_tensor(wm), tt["idx"],
                              ALPHA)
        sc_j, sc_t = rj.s_cover, rt.s_cover
        ext_j, ext_t = jimg.extract_color, timg.extract_color
        det_j, det_t = jimg.detect_color, timg.detect_color
    _assert_stego_close(rt.stego_bgr.numpy(), rj.stego_bgr)
    assert abs(float(rt.psnr) - float(rj.psnr)) <= 0.01
    assert abs(float(rt.ssim) - float(rj.ssim)) <= 1e-3
    assert np.abs(rt.sw.numpy() - np.asarray(rj.sw)).max() \
        <= 1e-6 * float(np.abs(rj.sw).max())
    # each side extracts and detects from the same stego with its own state
    stego = np.array(rj.stego_bgr)
    wj = ext_j(jnp.asarray(stego), sc_j, rj.uw, rj.vwt, tj["inv"],
               tj["alpha"])
    wt = ext_t(torch.as_tensor(stego), sc_t, rt.uw, rt.vwt, tt["inv"], ALPHA)
    assert wt.shape == wj.shape and wt.dtype == torch.uint8
    assert _nc(wt.numpy(), wj) >= 0.999
    dj = float(det_j(jnp.asarray(stego), sc_j, rj.sw, tj["alpha"]))
    dt = float(det_t(torch.as_tensor(stego), sc_t, rt.sw, ALPHA))
    assert abs(dj - dt) <= 1e-3 and dt > 0.9
    # the unmodified cover cancels exactly against the port's own Sc
    assert float(det_t(tt["cover"], sc_t, rt.sw, ALPHA)) == 0.0


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parity")
    cover, _ = _images(64, 80, SEED + 2)
    wm = np.random.default_rng(SEED + 3).integers(0, 256, (40, 40, 3),
                                                   np.uint8)
    cp, wp = str(d / "cover.png"), str(d / "wm.png")
    cv2.imwrite(cp, cover)
    cv2.imwrite(wp, wm)
    return d, cp, wp


def _pin_nonce(monkeypatch):
    for mod in (jcrypto, tcrypto):
        monkeypatch.setattr(mod, "make_nonce", lambda: NONCE)


@pytest.mark.parametrize("color", [False, True], ids=["gray", "color"])
def test_api_parity_metas_cross(pngs, monkeypatch, color):
    """Both packages embed the same files with the same nonce; each meta
    then verifies, extracts and detects in the other package."""
    d, cp, wp = pngs
    _pin_nonce(monkeypatch)
    tag = "c" if color else "g"
    res = {}
    for name, api, kw in (("jax", japi, {}), ("port", tapi,
                                             {"device": "cpu"})):
        res[name] = api.embed(cp, wp, str(d / f"{name}{tag}_s.png"),
                              str(d / f"{name}{tag}_m.npz"), alpha=ALPHA,
                              color=color, password=PW, **kw)
    (sj, mj, pj, ssj), (st, mt, pt, sst) = res["jax"], res["port"]
    assert tmeta.load_meta(mt).mode == ("color" if color else "gray")
    _assert_stego_close(cv2.imread(st), cv2.imread(sj))
    assert abs(pt - pj) <= 0.01 and abs(sst - ssj) <= 1e-3
    for stego, meta in ((st, mt), (sj, mj)):
        xj = japi.extract(stego, meta, str(d / "xj.png"), password=PW,
                          enhance=False)
        xt = tapi.extract(stego, meta, str(d / "xt.png"), password=PW,
                          enhance=False, device="cpu")
        assert _nc(cv2.imread(xt), cv2.imread(xj)) >= 0.999
        fj, scj = japi.detect(stego, meta)
        ft, sct = tapi.detect(stego, meta, device="cpu")
        assert fj and ft and abs(scj - sct) <= 1e-3
    # the default extract runs the enhancement chain
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = tapi.extract(st, mt, str(d / "enh.png"), password=PW,
                           device="cpu")
    assert cv2.imread(out).shape == (64, 80, 3)


def test_api_parity_refusals_and_open_mode(pngs, monkeypatch):
    d, cp, wp = pngs
    _pin_nonce(monkeypatch)
    sj, mj, _, _ = japi.embed(cp, wp, str(d / "r_s.png"), str(d / "r_m.npz"),
                              alpha=ALPHA, password=PW)
    with pytest.raises(ValueError, match="HMAC"):
        tapi.extract(sj, mj, str(d / "bad.png"), password="wrong",
                     device="cpu")
    with pytest.raises(ValueError, match="password"):
        tapi.extract(sj, mj, str(d / "bad.png"), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        so, mo, _, _ = tapi.embed(cp, wp, str(d / "o_s.png"),
                                  str(d / "o_m.npz"), alpha=ALPHA,
                                  password=tapi.OPEN_MODE, device="cpu")
    assert tmeta.load_meta(mo).digest is None
    xt = tapi.extract(so, mo, str(d / "o_x.png"), enhance=False,
                      device="cpu")
    xj = japi.extract(so, mo, str(d / "o_xj.png"), enhance=False)
    assert _nc(cv2.imread(xt), cv2.imread(xj)) >= 0.999
    found, score = tapi.detect(so, mo, device="cpu")
    assert found and score > 0.9
    assert not tapi.detect(cp, mo, device="cpu")[0]


def test_resync_on_a_parity_meta_warns(pngs, monkeypatch):
    """A parity meta has no block grid: asking for resync warns and scores
    the plain detect."""
    d, cp, wp = pngs
    _pin_nonce(monkeypatch)
    st, mt, _, _ = tapi.embed(cp, wp, str(d / "w_s.png"), str(d / "w_m.npz"),
                              alpha=ALPHA, password=PW, device="cpu")
    plain = tapi.detect(st, mt, device="cpu")
    with pytest.warns(UserWarning, match="resync applies to blocked"):
        assert tapi.detect(st, mt, resync=True, rot_range=0.5,
                           device="cpu") == plain


def test_state_from_meta(pngs, monkeypatch):
    d, cp, wp = pngs
    _pin_nonce(monkeypatch)
    _, mp, _, _ = japi.embed(cp, wp, str(d / "m_s.png"), str(d / "m_m.npz"),
                             alpha=ALPHA, color=True, password=PW)
    m = tmeta.load_meta(mp)
    st = timg.state_from_meta(m, "cpu")
    assert st.sc.shape == (3, 64) and st.uw.shape == (3, 64, 64)
    assert st.vwt.shape == (3, 64, 80) and st.sw.shape == (3, 64)
    assert all(t.dtype == torch.float32 for t in st)
    assert np.array_equal(st.sc[1].numpy(), m.arrays["Sg"])
