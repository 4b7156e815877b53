"""The port's path-level entry points (api, cli, extract_array /
detect_paths) on the CPU, and blocked metas crossing between the two
packages: a meta written by either one verifies, extracts and detects in
the other. The API's and the CLI's defaults (the parity path, the
enhancement chain) and detect resync run."""

import warnings

import cv2
import numpy as np
import pytest
import torch

from dctsvd_tpu import api as japi
from dctsvd_tpu.io import meta as jmeta
from dctsvd_tpu.models import blocked as jb
from dctsvd_tpu.utils import crypto as jcrypto
from dctsvd_tpu_torch import api as tapi
from dctsvd_tpu_torch import cli as tcli
from dctsvd_tpu_torch.io import meta as tmeta
from dctsvd_tpu_torch.models import blocked as tb

torch.set_num_threads(2)

SEED = 20261019
PW = "cross-package"
H, W = 64, 80


def _nc(a, b):
    a = a.astype(np.float64).ravel() - a.mean()
    b = b.astype(np.float64).ravel() - b.mean()
    return float(a @ b / np.sqrt((a @ a) * (b @ b)))


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(SEED)
    cover = cv2.GaussianBlur(rng.integers(0, 256, (H, W, 3), np.uint8),
                             (0, 0), 1.0)
    wm = rng.integers(0, 256, (40, 40, 3), np.uint8)
    cp, wp = str(d / "cover.png"), str(d / "wm.png")
    cv2.imwrite(cp, cover)
    cv2.imwrite(wp, wm)
    return d, cp, wp


@pytest.fixture(scope="module")
def port_color(pngs):
    """A color stego + v3 meta written by the port."""
    d, cp, wp = pngs
    out, mp, ps, ss = tapi.embed(cp, wp, str(d / "port_s.png"),
                                 str(d / "port_m.npz"), alpha=0.15,
                                 color=True, password=PW, method="blocked",
                                 device="cpu")
    return out, mp, ps, ss


def _key(meta):
    return jcrypto.derive_key(PW, meta.nonce)


def test_port_meta_records_schedule_and_digest(port_color):
    out, mp, ps, ss = port_color
    m = tmeta.load_meta(mp)
    assert m.mode == tmeta.MODE_BLOCKED_COLOR and m.digest_v == 3
    assert (m.sweeps, m.sweeps_xpairs) == (1, 7) == tb.embed_schedule_used()
    assert m.arrays["Sc"].shape == (3, 80, 8)
    assert m.arrays["Uw"].dtype == np.float32
    assert ps > 20 and 0 < ss <= 1


def test_port_meta_extracts_and_detects_in_jax(port_color):
    out, mp, _, _ = port_color
    stego = cv2.imread(out, cv2.IMREAD_COLOR)
    mj, mt = jmeta.load_meta(mp), tmeta.load_meta(mp)
    wm_j = jb.extract_array(stego, mj, _key(mj))
    wm_t = tb.extract_array(stego, mt, _key(mt), device="cpu")
    assert wm_t.shape == wm_j.shape == (H, W, 3)
    assert np.abs(wm_t.astype(int) - wm_j.astype(int)).max() <= 2
    found_j, score_j = jb.detect_paths(stego, mj, 0.30)
    found_t, score_t = tb.detect_paths(stego, mt, 0.30, device="cpu")
    assert found_j and found_t
    assert abs(score_j - score_t) <= 1e-3


def test_jax_meta_extracts_and_detects_in_port(pngs):
    """A JAX CPU meta records the converged schedule (0, 0); the port
    replays it at the kernel default (4 sweeps)."""
    d, cp, wp = pngs
    out, mp, _, _ = japi.embed(cp, wp, str(d / "jax_s.png"),
                               str(d / "jax_m.npz"), alpha=0.15, color=True,
                               password=PW, method="blocked")
    m = tmeta.load_meta(mp)
    assert (m.sweeps, m.sweeps_xpairs) == (0, 0)
    found_t, score_t = tapi.detect(out, mp, device="cpu")
    found_j, score_j = japi.detect(out, mp)
    assert found_t and found_j and score_t >= 0.30 and score_j >= 0.30
    xt = tapi.extract(out, mp, str(d / "x_t.png"), password=PW,
                      enhance=False, device="cpu")
    xj = japi.extract(out, mp, str(d / "x_j.png"), password=PW,
                      enhance=False)
    assert _nc(cv2.imread(xt), cv2.imread(xj)) >= 0.9
    with pytest.raises(ValueError, match="HMAC"):
        tapi.extract(out, mp, str(d / "bad.png"), password="nope",
                     enhance=False, device="cpu")


def _rewrite(src, dst, version, *, sweeps, xpairs, signed_xpairs=None):
    """Re-sign ``src`` as an older digest schema."""
    with np.load(src) as z:
        kw = {k: z[k] for k in z.files}
    m = tmeta.load_meta(src)
    key = _key(m)
    sc, uw, vwt, sw = (kw["Sc"], kw["Uw"], kw["Vwt"], kw["Sw"])
    kw["sweeps"], kw["sweeps_xpairs"] = sweeps, xpairs
    if version == 1:
        kw.pop("digest_v")
        dig = tb._digest_v1(key, sc, uw, vwt)
    else:
        kw["digest_v"] = version
        dig = tb._digest(key, sc, uw, vwt, sw, mode=m.mode,
                         alpha=float(m.alpha), kfrac=float(m.kfrac),
                         sweeps=sweeps,
                         xpairs=xpairs if signed_xpairs is None
                         else signed_xpairs,
                         version=version, shape=m.shape)
    kw["digest"] = np.frombuffer(dig, np.uint8)
    np.savez_compressed(dst, **kw)
    return dst


@pytest.mark.parametrize("version", [1, 2])
def test_legacy_digest_metas_verify_in_both(port_color, tmp_path, version):
    out, mp, _, _ = port_color
    stego = cv2.imread(out, cv2.IMREAD_COLOR)
    old = _rewrite(mp, str(tmp_path / f"v{version}.npz"), version,
                   sweeps=2, xpairs=0)
    mt, mj = tmeta.load_meta(old), jmeta.load_meta(old)
    assert mt.digest_v == version
    wm_t = tb.extract_array(stego, mt, _key(mt), device="cpu")
    wm_j = jb.extract_array(stego, mj, _key(mj))
    assert np.abs(wm_t.astype(int) - wm_j.astype(int)).max() <= 2
    bad = jcrypto.derive_key("wrong", mt.nonce)
    with pytest.raises(ValueError, match="HMAC"):
        tb.extract_array(stego, mt, bad, device="cpu")
    with pytest.raises(ValueError, match="HMAC"):
        jb.extract_array(stego, mj, bad)


def test_v2_meta_with_xpairs_is_refused(port_color, tmp_path):
    """v2 digests do not cover sweeps_xpairs: the JAX package accepts such
    a meta (ADVICE r5), the port refuses it — an intended divergence."""
    out, mp, _, _ = port_color
    stego = cv2.imread(out, cv2.IMREAD_COLOR)
    forged = _rewrite(mp, str(tmp_path / "v2x.npz"), 2, sweeps=1, xpairs=7)
    mj, mt = jmeta.load_meta(forged), tmeta.load_meta(forged)
    assert jb.extract_array(stego, mj, _key(mj)).shape == (H, W, 3)
    with pytest.raises(ValueError, match="sweeps_xpairs"):
        tb.extract_array(stego, mt, _key(mt), device="cpu")


def test_gray_and_open_mode_metas_cross(pngs):
    d, cp, wp = pngs
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out, mp, _, _ = tapi.embed(cp, wp, str(d / "open_s.png"),
                                   str(d / "open_m.npz"), alpha=0.15,
                                   password=tapi.OPEN_MODE, method="blocked",
                                   device="cpu")
    m = tmeta.load_meta(mp)
    assert m.digest is None and m.mode == tmeta.MODE_BLOCKED_GRAY
    stego = cv2.imread(out, cv2.IMREAD_COLOR)
    wm_t = tb.extract_array(stego, m, None, device="cpu")
    wm_j = jb.extract_array(stego, jmeta.load_meta(mp), None)
    assert wm_t.shape == (H, W)
    assert np.abs(wm_t.astype(int) - wm_j.astype(int)).max() <= 2
    assert tapi.detect(out, mp, device="cpu")[0]
    with pytest.warns(UserWarning, match="UNAUTHENTICATED"):
        tapi.embed(cp, wp, str(d / "open2_s.png"), str(d / "open2_m.npz"),
                   method="blocked", device="cpu")


def test_unported_paths_raise(pngs, port_color, tmp_path):
    """The paths that raised NotImplementedError before they were ported —
    the parity embed (the default method), extract with the enhancement
    chain (the default), detect resync, and a parity meta's extract and
    detect — now run on the CPU."""
    d, cp, wp = pngs
    out, mp, _, _ = port_color
    s, parity, ps, _ = tapi.embed(cp, wp, str(tmp_path / "s.png"),
                                  str(tmp_path / "m.npz"), password=PW,
                                  device="cpu")
    assert tmeta.load_meta(parity).mode == tmeta.MODE_GRAY and ps > 20
    x = tapi.extract(out, mp, str(tmp_path / "x.png"), password=PW,
                     device="cpu")
    assert cv2.imread(x).shape == (H, W, 3)
    assert tapi.detect(out, mp, resync=True, device="cpu")[0]
    assert tapi.detect(s, parity, device="cpu")[0]
    y = tapi.extract(s, parity, str(tmp_path / "y.png"), password=PW,
                     enhance=False, device="cpu")
    assert cv2.imread(y, cv2.IMREAD_GRAYSCALE).shape == (H, W)


def test_cli_embed_extract_detect(pngs, tmp_path, capsys):
    import json
    d, cp, wp = pngs
    stego = str(tmp_path / "s.png")
    base = ["--device", "cpu"]
    assert tcli.main(base + ["embed", cp, wp, "--out", stego, "--method",
                             "blocked", "--color", "--password", PW]) == 0
    emb = json.loads(capsys.readouterr().out)
    assert emb["meta"].endswith("s_meta.npz") and emb["psnr"] > 20
    assert tcli.main(base + ["extract", stego, emb["meta"], "--out",
                             str(tmp_path / "x.png"), "--no-enhance",
                             "--password", PW]) == 0
    got = cv2.imread(json.loads(capsys.readouterr().out)["watermark"])
    assert got.shape == (H, W, 3)
    assert tcli.main(base + ["detect", stego, emb["meta"]]) == 0
    assert json.loads(capsys.readouterr().out)["watermarked"] is True
    assert tcli.main(base + ["detect", cp, emb["meta"]]) == 1
    with pytest.raises(ValueError, match="HMAC"):
        tcli.main(base + ["extract", stego, emb["meta"], "--no-enhance",
                          "--out", str(tmp_path / "y.png"), "--password",
                          "wrong"])


@pytest.mark.parametrize("argv", [
    ["embed", "{cp}", "{wp}", "--password", "pw"],
    ["extract", "{stego}", "{meta}", "--password", PW],
    ["detect", "{stego}", "{meta}", "--resync"],
])
def test_cli_unported_paths_raise(pngs, port_color, tmp_path, argv):
    """The CLI's defaults that raised NotImplementedError before the
    parity path, the enhancement chain and resync were ported now run:
    embed with no --method, extract without --no-enhance, detect
    --resync."""
    d, cp, wp = pngs
    out, mp, _, _ = port_color
    argv = [a.format(cp=cp, wp=wp, stego=out, meta=mp) for a in argv]
    argv += ["--out", str(tmp_path / "o.png")] if argv[0] != "detect" else []
    assert tcli.main(["--device", "cpu"] + argv) == 0
    if argv[0] != "detect":
        assert cv2.imread(str(tmp_path / "o.png")) is not None


def test_restore_meta_scale(port_color, tmp_path):
    """A stego rescaled after embedding is restored to the meta's shape."""
    out, mp, _, _ = port_color
    small = cv2.resize(cv2.imread(out), (W // 2, H // 2),
                       interpolation=cv2.INTER_AREA)
    sp = str(tmp_path / "small.png")
    cv2.imwrite(sp, small)
    with pytest.warns(UserWarning, match="rescaling"):
        found, score = tapi.detect(sp, mp, device="cpu")
    assert isinstance(found, bool) and np.isfinite(score)


def test_cli_payload_both_methods(tmp_path, capsys):
    """embed-payload / extract-payload: text through the parity default,
    a JSON file through the blocked method."""
    import json
    rng = np.random.default_rng(SEED + 1)
    cp = str(tmp_path / "cover.png")
    cv2.imwrite(cp, cv2.GaussianBlur(
        rng.integers(0, 256, (128, 160, 3), np.uint8), (0, 0), 3.0))
    text, obj = "cli payload", {"owner": "cli", "n": 3}
    spec = tmp_path / "obj.json"
    spec.write_text(json.dumps(obj))
    for method, payload, arg in (("full", text, text),
                                 ("blocked", obj, "@" + str(spec))):
        out = str(tmp_path / f"{method}.png")
        assert tcli.main(["--device", "cpu", "embed-payload", cp, arg,
                          "--out", out, "--password", PW, "--alpha", "0.15",
                          "--method", method]) == 0
        emb = json.loads(capsys.readouterr().out)
        assert emb["meta"].endswith(f"{method}_meta.npz")
        assert tcli.main(["--device", "cpu", "extract-payload", out,
                          emb["meta"], "--password", PW]) == 0
        assert json.loads(capsys.readouterr().out)["payload"] == payload
