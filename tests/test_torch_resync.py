"""The port's detect resync (dctsvd_tpu_torch/models/blocked.py: _derotate,
_resync_angles/_resync_shifts, _detect_shift_chunk, _detect_resync,
detect_*_resync, detect_paths(resync=)) and ``api.detect(resync=)``
against the JAX package on the CPU.

Stegos come from the port's blocked embed, whose metas record the fused
s1.25 schedule; the JAX package's detect replays that schedule exactly on
the CPU. Tolerances: the candidate lists identical; _derotate within 1 u8
quantum (1e-3 on f32 planes) and exact at 0°; per-chunk scores within
1e-3; recovered shift and angle equal.

Every embed takes a nonce of a seeded sequence (``NONCES``), never one
from os.urandom: the translation search's score at 64×80 depends on the
embed key, in the JAX package as in the port, so the shared stegos use
the first nonce and the translation test runs each of the eight."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctsvd_tpu import api as japi
from dctsvd_tpu.models import blocked as jb
from dctsvd_tpu_torch import api as tapi
from dctsvd_tpu_torch import cli as tcli
from dctsvd_tpu_torch.io import meta as tmeta
from dctsvd_tpu_torch.models import blocked as tb
from dctsvd_tpu_torch.utils import crypto as tcrypto

torch.set_num_threads(2)

SEED = 20261024
PW = "resync-port"
H, W = 64, 80


@pytest.mark.parametrize("window, radius", [(8, 0), (4, 1), (1, 0)])
def test_candidate_lists_match_jax(window, radius):
    assert tb._resync_shifts(window, radius) == jb._resync_shifts(window,
                                                                  radius)
    for rng_, step in ((0.0, 0.05), (0.5, 0.05), (1.2, 0.1), (1.0, 0.3)):
        assert tb._resync_angles(rng_, step) == jb._resync_angles(rng_, step)


@pytest.mark.parametrize("layout", ["u8 frames", "u8 plane", "f32 plane"])
@pytest.mark.parametrize("angle", [0.0, 0.3, -1.0, 7.5])
def test_derotate_matches_jax(layout, angle):
    rng = np.random.default_rng(SEED)
    frames = cv2.GaussianBlur(rng.integers(0, 256, (37, 51, 3), np.uint8),
                              (0, 0), 1.0)
    x = {"u8 frames": frames, "u8 plane": frames[..., 0],
         "f32 plane": frames[..., 1].astype(np.float32) + 0.25}[layout]
    cl = layout == "u8 frames"
    got = tb._derotate(torch.as_tensor(x), angle, color_frames=cl).numpy()
    ref = np.asarray(jb._derotate(jnp.asarray(x), jnp.float32(angle),
                                  color_frames=cl))
    assert got.dtype == x.dtype and got.shape == x.shape
    tol = 1e-3 if x.dtype == np.float32 else 1
    assert np.abs(got.astype(np.float64) - ref).max() <= tol
    if angle == 0.0:
        assert np.array_equal(got, x)


NONCE_SEED = 20261018     # chip_smoke.py's seeded nonce sequence
_NONCE_RNG = np.random.default_rng(NONCE_SEED)
NONCES = [_NONCE_RNG.bytes(tcrypto.NONCE_BYTES) for _ in range(8)]


def _embed_with_nonce(d, nonce: bytes, color: bool, name: str):
    """The port's blocked embed of the seeded cover and watermark under
    ``nonce``: (stego path, meta path)."""
    cp, wp = str(d / "cover.png"), str(d / "wm.png")
    if not (d / "cover.png").exists():
        rng = np.random.default_rng(SEED + 1)
        cover = cv2.GaussianBlur(rng.integers(0, 256, (H, W, 3), np.uint8),
                                 (0, 0), 1.0)
        cv2.imwrite(cp, cover)
        cv2.imwrite(wp, rng.integers(0, 256, (H, W, 3), np.uint8))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcrypto, "make_nonce", lambda: nonce)
        s, m, _, _ = tapi.embed(cp, wp, str(d / f"{name}.png"),
                                str(d / f"{name}_m.npz"), alpha=0.14,
                                color=color, password=PW, method="blocked",
                                device="cpu")
    return s, m


@pytest.fixture(scope="module")
def stegos(tmp_path_factory):
    """Port-embedded blocked stegos (gray and color) with their metas,
    under the first seeded nonce."""
    d = tmp_path_factory.mktemp("torch_resync")
    return d, {tag: _embed_with_nonce(d, NONCES[0], tag == "color", tag)
               for tag in ("gray", "color")}


def _state(path, meta_path):
    m = tmeta.load_meta(meta_path)
    return cv2.imread(path), m, m.arrays["Sc"], m.arrays["Sw"]


@pytest.mark.parametrize("tag", ["gray", "color"])
def test_shift_chunk_scores_match_jax(stegos, tag):
    d, out = stegos
    stego, m, sc, sw = _state(*out[tag])
    rolled = np.roll(stego, (2, -3), axis=(0, 1))
    color = tag == "color"
    shifts = np.asarray(tb._resync_shifts(4, 0)[:16] + [(-2, 3), (0, 0)],
                        np.int32)
    if color:
        jimg, timg = jnp.asarray(rolled), torch.as_tensor(rolled)
    else:
        from dctsvd_tpu.ops import color as jcolor
        from dctsvd_tpu_torch.ops import color as tcolor
        jimg = jcolor.luma_f32(jnp.asarray(rolled))
        timg = tcolor.luma_f32(torch.as_tensor(rolled))
    ref = np.asarray(jb._detect_shift_chunk(
        jimg, jnp.asarray(sc), jnp.asarray(sw), jnp.float32(m.alpha),
        jnp.asarray(shifts), kfrac=m.kfrac, sweeps=m.sched(),
        color_frames=color))
    got = tb._detect_shift_chunk(
        timg, torch.as_tensor(sc), torch.as_tensor(sw), m.alpha,
        torch.as_tensor(shifts.astype(np.int64)), kfrac=m.kfrac,
        sweeps=m.sched(), color_frames=color).numpy()
    assert got.shape == ref.shape == (len(shifts),)
    assert np.abs(got - ref).max() <= 1e-3
    assert got[-2] > 0.9 > got[-1]         # the realigning roll wins


@pytest.mark.parametrize("tag", ["gray", "color"])
@pytest.mark.parametrize("i", range(len(NONCES)))
def test_translation_resync_matches_jax(stegos, tag, i):
    """For each seeded nonce the port's translation search recovers the
    JAX package's shift and angle (the true ones), its score is within
    1e-3 of JAX's and on the same side of 0.8. Whether a key's score
    clears 0.8 at 64×80 is a property of the scheme, the same in both
    packages, so it is held to the JAX package's outcome and not
    asserted on its own."""
    d, _ = stegos
    stego, m, sc, sw = _state(*_embed_with_nonce(
        d, NONCES[i], tag == "color", f"{tag}_n{i}"))
    shifted = cv2.warpAffine(stego, np.float32([[1, 0, -3], [0, 1, 2]]),
                             (W, H), borderMode=cv2.BORDER_REPLICATE)
    jfn = jb.detect_color_resync if tag == "color" else jb.detect_gray_resync
    tfn = tb.detect_color_resync if tag == "color" else tb.detect_gray_resync
    rj = jfn(jnp.asarray(shifted), jnp.asarray(sc), jnp.asarray(sw), m.alpha,
             kfrac=m.kfrac, sweeps=m.sched())
    rt = tfn(torch.as_tensor(shifted), torch.as_tensor(sc),
             torch.as_tensor(sw), m.alpha, kfrac=m.kfrac, sweeps=m.sched())
    assert rt[1:] == rj[1:] == ((2, -3), 0.0)
    assert abs(rt[0] - rj[0]) <= 1e-3
    assert (rt[0] > 0.8) == (rj[0] > 0.8), (rt[0], rj[0])


def test_rotation_resync_matches_jax(stegos):
    """A cv2 rotation about the center, searched on the angle axis alone
    (window 1): both packages recover the same angle, the coarse grid's
    argmax refined at step/5."""
    d, out = stegos
    stego, m, sc, sw = _state(*out["color"])
    rot = cv2.warpAffine(stego, cv2.getRotationMatrix2D((W / 2, H / 2), 2.4,
                                                        1.0), (W, H),
                         borderMode=cv2.BORDER_REPLICATE)
    kw = dict(kfrac=m.kfrac, sweeps=m.sched(), window=1, chunk=1,
              rot_range=3.0, rot_step=1.0)
    rj = jb.detect_color_resync(jnp.asarray(rot), jnp.asarray(sc),
                                jnp.asarray(sw), m.alpha, **kw)
    rt = tb.detect_color_resync(torch.as_tensor(rot), torch.as_tensor(sc),
                                torch.as_tensor(sw), m.alpha, **kw)
    assert rt[1:] == rj[1:] and rt[1] == (0, 0)
    assert abs(rt[2] - 2.4) <= 0.2 + 1e-6
    assert abs(rt[0] - rj[0]) <= 1e-3


def test_api_detect_resync_matches_jax(stegos):
    """api.detect(resync=True) keeps the better of the aligned and the
    realigned score; rot_range adds the angle axis."""
    d, out = stegos
    stego, mp = out["gray"]
    sp = str(d / "rolled.png")
    cv2.imwrite(sp, np.roll(cv2.imread(stego), (1, 2), axis=(0, 1)))
    plain_t = tapi.detect(sp, mp, device="cpu")
    rs_t = tapi.detect(sp, mp, resync=True, device="cpu")
    rs_j = japi.detect(sp, mp, resync=True)
    assert rs_t[0] and rs_j[0] and abs(rs_t[1] - rs_j[1]) <= 1e-3
    assert rs_t[1] >= plain_t[1] and rs_t[1] > 0.9
    rot_t = tapi.detect(sp, mp, resync=True, rot_range=0.1, rot_step=0.1,
                        device="cpu")
    assert rot_t[1] >= rs_t[1] - 1e-6
    aligned = tapi.detect(stego, mp, device="cpu")
    assert tapi.detect(stego, mp, resync=True, device="cpu") == aligned


def test_cli_detect_resync(stegos, capsys):
    import json
    d, out = stegos
    stego, mp = out["color"]
    sp = str(d / "cli_rolled.png")
    cv2.imwrite(sp, np.roll(cv2.imread(stego), (-2, 3), axis=(0, 1)))
    assert tcli.main(["--device", "cpu", "detect", sp, mp, "--resync",
                      "--resync-rot", "0.05", "--resync-rot-step",
                      "0.05"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["watermarked"] is True and got["score"] > 0.9
