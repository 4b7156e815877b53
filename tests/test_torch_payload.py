"""The port's payload codec (dctsvd_tpu_torch/models/payload.py, a copy of
the JAX package's) and ``api.embed_payload`` / ``extract_payload`` with both
methods against the JAX package on the CPU.

Tolerances: payload_to_bytes / bytes_to_bitplane byte-equal; a payload
embedded by either package (same nonce, pinned with monkeypatch) is
recovered exactly by both, and the two parity stegos are within 1 quantum
on at most 1 % of the bytes (the blocked stegos differ by design: a CPU run
of the JAX package embeds at the converged schedule, the port at the
fused s1.25 one)."""

import cv2
import numpy as np
import pytest
import torch

from dctsvd_tpu import api as japi
from dctsvd_tpu.models import payload as jpay
from dctsvd_tpu.utils import crypto as jcrypto
from dctsvd_tpu_torch import api as tapi
from dctsvd_tpu_torch.io import meta as tmeta
from dctsvd_tpu_torch.models import payload as tpay
from dctsvd_tpu_torch.utils import crypto as tcrypto

torch.set_num_threads(2)

SEED = 20261023
PW = "payload-port"
NONCE = bytes(range(8))
TEXT = "port payload ✓"
OBJ = {"owner": "port", "id": 7, "tags": ["a", "b"]}


@pytest.mark.parametrize("payload", [TEXT, OBJ, b"\x00\xffraw"],
                         ids=["text", "json", "bytes"])
@pytest.mark.parametrize("repeat", [1, 3, 8])
def test_codec_matches_jax(payload, repeat):
    data_t, kind_t = tpay.payload_to_bytes(payload)
    data_j, kind_j = jpay.payload_to_bytes(payload)
    assert (data_t, kind_t) == (data_j, kind_j)
    plane = tpay.bytes_to_bitplane(data_t, 61, 83, repeat=repeat)
    assert np.array_equal(plane, jpay.bytes_to_bitplane(data_j, 61, 83,
                                                        repeat=repeat))
    # a few flipped bits: the majority vote decides in both alike
    noisy = plane.copy().reshape(-1)
    noisy[np.random.default_rng(SEED).choice(200, 5, replace=False)] ^= 255
    noisy = noisy.reshape(plane.shape)
    got_t = tpay.bitplane_to_bytes(noisy, repeat=repeat)
    assert got_t == jpay.bitplane_to_bytes(noisy, repeat=repeat)
    if repeat >= 3:
        assert tpay.bytes_to_payload(got_t, kind_t) == payload


def test_codec_errors_match_jax():
    for mod in (tpay, jpay):
        with pytest.raises(ValueError, match="repeat"):
            mod.bytes_to_bitplane(b"x", 8, 8, repeat=0)
        with pytest.raises(ValueError, match="too large"):
            mod.bytes_to_bitplane(b"x" * 64, 8, 8)


@pytest.fixture(scope="module")
def cover_png(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_payload")
    rng = np.random.default_rng(SEED)
    cover = cv2.GaussianBlur(rng.integers(0, 256, (128, 160, 3), np.uint8),
                             (0, 0), 3.0)
    p = str(d / "cover.png")
    cv2.imwrite(p, cover)
    return d, p


@pytest.mark.parametrize("method", ["full", "blocked"])
def test_payload_metas_cross(cover_png, monkeypatch, method):
    """Text with a password and JSON in open mode: each package's stego and
    meta decode in both packages."""
    d, cp = cover_png
    for mod in (jcrypto, tcrypto):
        monkeypatch.setattr(mod, "make_nonce", lambda: NONCE)
    for payload, pw in ((TEXT, PW), (OBJ, tapi.OPEN_MODE)):
        jpw = japi.OPEN_MODE if pw is tapi.OPEN_MODE else pw
        xpw = None if pw is tapi.OPEN_MODE else pw
        sj, mj, _, _ = japi.embed_payload(cp, payload, str(d / "j.png"),
                                          str(d / "j_m.npz"), alpha=0.15,
                                          password=jpw, method=method)
        st, mt, _, _ = tapi.embed_payload(cp, payload, str(d / "t.png"),
                                          str(d / "t_m.npz"), alpha=0.15,
                                          password=pw, method=method,
                                          device="cpu")
        m = tmeta.load_meta(mt)
        assert m.payload_type == ("text" if payload == TEXT else "json")
        assert int(m.arrays["repeat"]) == 8
        if method == "full":
            a, b = cv2.imread(st).astype(int), cv2.imread(sj).astype(int)
            assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 0.01
        for stego, meta in ((st, mt), (sj, mj)):
            assert tapi.extract_payload(stego, meta, password=xpw,
                                        device="cpu") == payload
            assert japi.extract_payload(stego, meta, password=xpw) == payload


@pytest.mark.parametrize("method", ["full", "blocked"])
def test_payload_wrong_password_is_refused(cover_png, method):
    d, cp = cover_png
    st, mt, _, _ = tapi.embed_payload(cp, TEXT, str(d / "w.png"),
                                      str(d / "w_m.npz"), alpha=0.15,
                                      password=PW, method=method,
                                      device="cpu")
    with pytest.raises(ValueError, match="HMAC"):
        tapi.extract_payload(st, mt, password="wrong", device="cpu")
    with pytest.raises(ValueError, match="password"):
        tapi.extract_payload(st, mt, device="cpu")


@pytest.mark.parametrize("text, decodes", [
    ("short", False), ("a payload of forty-odd bytes, 8x", True)])
def test_parity_payload_outcome_matches_jax_at_360x640(tmp_path, monkeypatch,
                                                      text, decodes):
    """The parity payload decodes only while the cover is small next to
    the payload (its min–max normalised bit-plane's zero level rises with
    the cover's size): at 360×640, with this cover and nonce, a 5-byte
    payload fails and a 32-byte one decodes, and the port's outcome — the
    payload, or the decoder's error — is the JAX package's."""
    for mod in (jcrypto, tcrypto):
        monkeypatch.setattr(mod, "make_nonce", lambda: NONCE)
    rng = np.random.default_rng(SEED + 2)
    cp = str(tmp_path / "cover.png")
    cv2.imwrite(cp, cv2.GaussianBlur(
        rng.integers(0, 256, (360, 640, 3), np.uint8), (0, 0), 3.0))

    def outcome(api, **kw):
        out, mp, _, _ = api.embed_payload(cp, text, str(tmp_path / "s.png"),
                                          str(tmp_path / "m.npz"),
                                          alpha=0.12, password=PW, **kw)
        try:
            return api.extract_payload(out, mp, password=PW, **kw)
        except ValueError as err:
            return f"ValueError: {err}"

    got = outcome(tapi, device="cpu")
    assert got == outcome(japi)
    assert (got == text) == decodes, got


# The first eight embed nonces of chip_smoke.py's seeded sequence, and the
# ones for which its JSON payload decodes on its 360×640 crop.
_SMOKE_RNG = np.random.default_rng(20261018)
SMOKE_NONCES = [_SMOKE_RNG.bytes(8) for _ in range(8)]
SMOKE_JSON_DECODES = {0, 3}


@pytest.fixture(scope="module")
def smoke_crop(tmp_path_factory):
    """chip_smoke.py's 360×640 payload cover: the top-left crop of its
    seeded 1080p σ3-blurred noise frame."""
    rng = np.random.default_rng(20261017)
    frame = cv2.GaussianBlur(rng.integers(0, 256, (1080, 1920, 3), np.uint8),
                             (0, 0), 3.0)
    cp = str(tmp_path_factory.mktemp("smoke_crop") / "crop.png")
    cv2.imwrite(cp, frame[:360, :640])
    return cp


@pytest.mark.parametrize("i", range(8))
def test_parity_payload_decodes_for_the_same_keys_as_jax(smoke_crop,
                                                         tmp_path,
                                                         monkeypatch, i):
    """At 360×640 the parity method decodes a 60-byte JSON payload for
    some embed keys and not others — a failed decode is a decoder error
    or a silently wrong payload (bit errors) — in the JAX package exactly
    as in the port: for each of chip_smoke.py's eight seeded nonces the
    port's outcome (the payload, the wrong payload, or the decoder's
    error) equals the JAX package's, and only nonces 0 and 3 decode."""
    payload = {"owner": "chip-smoke", "id": 20261017,
               "tags": ["parity", "blocked"]}
    for mod in (jcrypto, tcrypto):
        monkeypatch.setattr(mod, "make_nonce", lambda: SMOKE_NONCES[i])

    def outcome(api, **kw):
        out, mp, _, _ = api.embed_payload(
            smoke_crop, payload, str(tmp_path / "s.png"),
            str(tmp_path / "m.npz"), alpha=0.15, password="chip-smoke",
            method="full", **kw)
        try:
            return api.extract_payload(out, mp, password="chip-smoke", **kw)
        except ValueError as err:
            return f"ValueError: {err}"

    got = outcome(tapi, device="cpu")
    assert got == outcome(japi)
    assert (got == payload) == (i in SMOKE_JSON_DECODES), got
