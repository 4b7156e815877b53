"""The port's detect resync (dctsvd_tpu_torch/models/blocked.py:
_resync_angles/_resync_shifts, _detect_shift_chunk, _detect_resync and its
one-read scan, detect_*_resync, detect_paths(resync=); ops/resync_cuda.py:
the twins of K12 roll_stack and K13 derotate and derotate_angles) and
``api.detect(resync=)`` against the JAX package on the CPU.

Stegos come from the port's blocked embed, whose metas record the fused
s1.25 schedule; the JAX package's detect replays that schedule exactly on
the CPU. Tolerances: the candidate lists identical; roll_stack_plain
byte-equal to the JAX package's roll stack; derotate_plain and each slice
of derotate_angles_plain within 1 u8 quantum (1e-3 on f32 planes) and
exact at 0°; per-chunk scores within 1e-3; recovered shift and angle
equal; the one-read scan's choice, with a scan's angles counter-rotated
by one derotate_angles call, equal to the per-chunk loop's it replaced.

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
from dctsvd_tpu_torch.ops import resync_cuda
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
    got = resync_cuda.derotate_plain(torch.as_tensor(x), angle,
                                     color_frames=cl).numpy()
    ref = np.asarray(jb._derotate(jnp.asarray(x), jnp.float32(angle),
                                  color_frames=cl))
    assert got.dtype == x.dtype and got.shape == x.shape
    tol = 1e-3 if x.dtype == np.float32 else 1
    assert np.abs(got.astype(np.float64) - ref).max() <= tol
    if angle == 0.0:
        assert np.array_equal(got, x)


@pytest.mark.parametrize("layout", ["u8 frames", "u8 plane", "f32 plane"])
def test_derotate_angles_plain_matches_jax(layout):
    """K13's batched twin: each slice of derotate_angles_plain is
    derotate_plain at its angle, within test_derotate_matches_jax's
    tolerance of the JAX package's _derotate at that angle."""
    rng = np.random.default_rng(SEED)
    frames = cv2.GaussianBlur(rng.integers(0, 256, (37, 51, 3), np.uint8),
                              (0, 0), 1.0)
    x = {"u8 frames": frames, "u8 plane": frames[..., 0],
         "f32 plane": frames[..., 1].astype(np.float32) + 0.25}[layout]
    cl = layout == "u8 frames"
    angles = (0.0, 0.3, -1.0, 7.5)
    got = resync_cuda.derotate_angles_plain(torch.as_tensor(x), angles,
                                            color_frames=cl)
    assert got.dtype == torch.as_tensor(x).dtype
    assert got.shape == (len(angles), *x.shape)
    tol = 1e-3 if x.dtype == np.float32 else 1
    for k, angle in enumerate(angles):
        assert torch.equal(got[k], resync_cuda.derotate_plain(
            torch.as_tensor(x), angle, cl))
        ref = np.asarray(jb._derotate(jnp.asarray(x), jnp.float32(angle),
                                      color_frames=cl))
        assert np.abs(got[k].numpy().astype(np.float64) - ref).max() <= tol
    assert np.array_equal(got[0].numpy(), x)
    assert resync_cuda.derotate_angles_plain(torch.as_tensor(x), [],
                                             cl).shape == (0, *x.shape)


def _frame(layout):
    """A seeded 37×51 frame in one of K12's and K13's layouts."""
    rng = np.random.default_rng(SEED + 2)
    frames = rng.integers(0, 256, (37, 51, 3), np.uint8)
    return {"u8 frames": frames, "u8 plane": frames[..., 0],
            "f32 plane": (rng.standard_normal((37, 51)) * 60).astype(
                np.float32)}[layout]


# (dy, dx) offsets for a 37×51 frame: zero, both signs, |d| >= H and W
ROLL_SHIFTS = {
    "search": [(0, 0), (3, -5), (-7, 7), (1, 0), (0, -1), (-3, -3)],
    "beyond": [(37, 51), (-38, 52), (75, -103), (-111, -255), (0, 0)],
    "one": [(-4, 9)],
}


@pytest.mark.parametrize("shifts", list(ROLL_SHIFTS))
@pytest.mark.parametrize("layout", ["u8 frames", "u8 plane", "f32 plane"])
def test_roll_stack_plain_matches_jax(layout, shifts):
    """K12's twin is byte-equal to the JAX package's roll stack,
    jax.vmap(jnp.roll) as _detect_shift_chunk takes it."""
    import jax
    x = _frame(layout)
    sh = np.asarray(ROLL_SHIFTS[shifts], np.int64)
    axes = (-3, -2) if layout == "u8 frames" else (-2, -1)
    ref = np.asarray(jax.vmap(lambda s: jnp.roll(jnp.asarray(x), (s[0], s[1]),
                                                 axis=axes))(
        jnp.asarray(sh.astype(np.int32))))
    got = resync_cuda.roll_stack_plain(torch.as_tensor(x),
                                       torch.as_tensor(sh)).numpy()
    assert got.dtype == x.dtype and got.shape == (len(sh), *x.shape)
    assert np.array_equal(got.view(np.uint8), ref.view(np.uint8))


@pytest.mark.parametrize("layout", ["u8 frames", "u8 plane", "f32 plane"])
def test_resync_wrappers_on_cpu_run_their_twins(layout):
    """On CPU tensors roll_stack and derotate return their twins' results
    and count no launch."""
    x = torch.as_tensor(_frame(layout))
    cl = layout == "u8 frames"
    shifts = torch.as_tensor(ROLL_SHIFTS["beyond"])
    n12, n13 = resync_cuda.roll_stack.launches, resync_cuda.derotate.launches
    n13a = resync_cuda.derotate_angles.launches
    assert torch.equal(resync_cuda.roll_stack(x, shifts),
                       resync_cuda.roll_stack_plain(x, shifts))
    for angle in (0.0, 0.3, -7.5):
        assert torch.equal(resync_cuda.derotate(x, angle, color_frames=cl),
                           resync_cuda.derotate_plain(x, angle, cl))
    angles = (0.3, 0.0, -7.5)
    assert torch.equal(resync_cuda.derotate_angles(x, angles,
                                                   color_frames=cl),
                       resync_cuda.derotate_angles_plain(x, angles, cl))
    assert resync_cuda.roll_stack.launches == n12
    assert resync_cuda.derotate.launches == n13
    assert resync_cuda.derotate_angles.launches == n13a


@pytest.mark.parametrize("case", ["int16 frame", "4-d frame", "int32 shifts",
                                  "shifts [S, 3]", "inf angle",
                                  "plane as frames", "nan among angles",
                                  "int16 frame of angles",
                                  "plane as frames of angles"])
def test_resync_wrappers_reject_what_the_kernels_do_not_take(case):
    x = torch.zeros((6, 7, 3), dtype=torch.uint8)
    sh = torch.zeros((2, 2), dtype=torch.int64)
    calls = {
        "int16 frame": lambda: resync_cuda.roll_stack(x.to(torch.int16), sh),
        "4-d frame": lambda: resync_cuda.roll_stack(x[None], sh),
        "int32 shifts": lambda: resync_cuda.roll_stack(x, sh.to(torch.int32)),
        "shifts [S, 3]": lambda: resync_cuda.roll_stack(
            x, torch.zeros((2, 3), dtype=torch.int64)),
        "inf angle": lambda: resync_cuda.derotate(x, float("inf"), True),
        "plane as frames": lambda: resync_cuda.derotate(x[:, 0, 0], 0.3,
                                                        True),
        "nan among angles": lambda: resync_cuda.derotate_angles(
            x, [0.3, float("nan")], True),
        "int16 frame of angles": lambda: resync_cuda.derotate_angles(
            x.to(torch.int16), [0.3], True),
        "plane as frames of angles": lambda: resync_cuda.derotate_angles(
            x[:, 0, 0], [0.3], True),
    }
    with pytest.raises(ValueError):
        calls[case]()


def _per_chunk_resync(img, sc, sw, alpha, *, kfrac, sweeps, window,
                      block_radius, chunk, color_frames, rot_range=0.0,
                      rot_step=0.05):
    """The search as it read its scores before the one-read scan: each
    chunk's scores read to the host as the chunk ends, and chosen there."""
    shifts = np.asarray(tb._resync_shifts(window, block_radius), np.int64)
    pad = (-len(shifts)) % chunk
    if pad:
        shifts = np.concatenate([shifts, np.zeros((pad, 2), np.int64)])
    shifts_t = torch.as_tensor(shifts, device=img.device)
    best_score, best_shift, best_angle = -np.inf, (0, 0), 0.0

    def scan(angles):
        nonlocal best_score, best_shift, best_angle
        for a in angles:
            cand = img if a == 0.0 else resync_cuda.derotate(
                img, a, color_frames=color_frames)
            for i in range(0, len(shifts), chunk):
                scores = tb._detect_shift_chunk(
                    cand, sc, sw, alpha, shifts_t[i:i + chunk], kfrac=kfrac,
                    sweeps=sweeps, color_frames=color_frames).cpu().numpy()
                j = int(np.argmax(scores))
                if float(scores[j]) > best_score:
                    best_score = float(scores[j])
                    best_shift, best_angle = tuple(shifts[i + j]), a

    scan(tb._resync_angles(rot_range, rot_step))
    if rot_range > 0.0 and best_angle != 0.0:
        fine = rot_step / 5.0
        scan([best_angle + k * fine for k in (-4, -3, -2, -1, 1, 2, 3, 4)])
    return (best_score, (-int(best_shift[0]), -int(best_shift[1])),
            float(best_angle))


# Synthetic chunk scores: {case: {(angle, chunk): {position: score}}} over
# seeded scores in [0, 0.5), for window 2 (9 shifts, padded to 3 chunks of
# 4) and the angles 0, ±0.05, ±0.1 refined at 0.01
SCAN_CASES = {
    "ties across chunks": {(0.0, 0): {2: 0.9}, (0.0, 1): {0: 0.9}},
    "ties within a chunk": {(0.05, 1): {1: 0.95, 3: 0.95}},
    "nan before the best": {(0.0, 0): {0: float("nan"), 1: 0.99},
                            (0.0, 2): {3: 0.7}},
    "ties across angles": {(0.05, 0): {1: 0.8}, (-0.05, 0): {1: 0.8},
                           (0.06, 2): {0: 0.8}, (0.02, 1): {2: 0.85}},
    "all nan": "nan",
}


@pytest.mark.parametrize("rot_range", [0.0, 0.1])
@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_one_read_scan_chooses_as_the_per_chunk_loop(monkeypatch, case,
                                                     rot_range):
    """The search that reads a scan's scores at once picks the score,
    shift and angle the per-chunk loop it replaced picks, on synthetic
    scores with ties across and within chunks and angles, and NaNs; it
    reads once a scan (twice when the refinement runs), the loop once a
    chunk."""
    chunk, window = 4, 2
    n_shifts = len(tb._resync_shifts(window, 0))
    pattern = SCAN_CASES[case]

    def fake_chunk(cand, sc, sw, alpha, shifts, **kw):
        a = 0.0 if isinstance(cand, torch.Tensor) else cand[1]
        i = int(np.flatnonzero(
            np.all(np.asarray(tb._resync_shifts(window, 0)) ==
                   shifts[0].numpy(), axis=1))[0]) // chunk
        rng = np.random.default_rng(abs(hash((round(a, 9), i))) % 2**32)
        part = rng.uniform(0.0, 0.5, chunk).astype(np.float32)
        if pattern == "nan":
            part[:] = np.nan
        else:
            for (pa, pi), cells in pattern.items():
                if abs(pa - a) < 1e-9 and pi == i:
                    for j, v in cells.items():
                        part[j] = v
        return torch.as_tensor(part)

    reads, derotations = [], []
    real_read = tb._read_scores

    def counted_read(parts):
        reads.append(len(parts))
        return real_read(parts)

    def counted_angles(img, angles, color_frames=False):
        derotations.append(list(angles))
        return [("rot", a) for a in angles]

    monkeypatch.setattr(tb, "_detect_shift_chunk", fake_chunk)
    monkeypatch.setattr(resync_cuda, "derotate",
                        lambda img, a, color_frames=False: ("rot", a))
    monkeypatch.setattr(resync_cuda, "derotate_angles", counted_angles)
    monkeypatch.setattr(tb, "_read_scores", counted_read)
    img = torch.zeros((16, 16, 3), dtype=torch.uint8)
    kw = dict(kfrac=0.6, sweeps=None, window=window, block_radius=0,
              chunk=chunk, color_frames=True, rot_range=rot_range,
              rot_step=0.05)
    got = tb._detect_resync(img, None, None, 0.1, **kw)
    ref = _per_chunk_resync(img, None, None, 0.1, **kw)
    assert got[1:] == ref[1:]
    assert got[0] == ref[0] or (np.isnan(got[0]) and np.isnan(ref[0]))
    chunks = -(-n_shifts // chunk)
    angles = len(tb._resync_angles(rot_range, 0.05))
    refined = rot_range > 0.0 and got[2] != 0.0
    assert reads == [chunks * angles] + ([chunks * 8] if refined else [])
    # one derotate_angles call a scan with a nonzero angle, its angles in
    # the scan's order (the per-chunk loop counter-rotated one at a time)
    coarse = [a for a in tb._resync_angles(rot_range, 0.05) if a != 0.0]
    assert derotations[:1] == ([coarse] if coarse else [])
    assert len(derotations) == bool(coarse) + refined
    if refined:    # about the coarse scan's best, a nonzero angle
        assert any(derotations[1] == [c + k * 0.01 for k in
                                      (-4, -3, -2, -1, 1, 2, 3, 4)]
                   for c in coarse)
    if case == "all nan":
        assert got == (-np.inf, (0, 0), 0.0)


@pytest.mark.parametrize("per", [1, 2, 5, 6])
def test_scan_groups_its_angles_under_the_byte_budget(monkeypatch, per):
    """A scan counter-rotates its nonzero angles in groups of as many
    frames as DEROTATE_BUDGET bytes hold, in the scan's order, and
    chooses as with one group: here a budget of ``per`` frames splits the
    coarse scan's 6 nonzero angles (±0.15 at 0.05) into ceil(6 / per)
    calls."""
    img = torch.zeros((16, 16, 3), dtype=torch.uint8)
    calls = []

    def fake_chunk(cand, sc, sw, alpha, shifts, **kw):
        a = 0.0 if isinstance(cand, torch.Tensor) else cand[1]
        score = 1.0 - abs(a - 0.1) - 0.01 * float(shifts[:, 0].abs().sum())
        return torch.full((len(shifts),), score, dtype=torch.float32)

    def counted_angles(img, angles, color_frames=False):
        calls.append(list(angles))
        return [("rot", a) for a in angles]

    monkeypatch.setattr(tb, "_detect_shift_chunk", fake_chunk)
    monkeypatch.setattr(resync_cuda, "derotate_angles", counted_angles)
    kw = dict(kfrac=0.6, sweeps=None, window=2, block_radius=0, chunk=4,
              color_frames=True, rot_range=0.15, rot_step=0.05)
    monkeypatch.setattr(tb, "DEROTATE_BUDGET", 10 ** 9)
    whole = tb._detect_resync(img, None, None, 0.1, **kw)
    assert [len(c) for c in calls] == [6, 8]
    calls.clear()
    monkeypatch.setattr(tb, "DEROTATE_BUDGET", per * img.numel())
    assert tb._detect_resync(img, None, None, 0.1, **kw) == whole
    coarse = [a for a in tb._resync_angles(0.15, 0.05) if a != 0.0]
    fine = [0.1 + k * 0.01 for k in (-4, -3, -2, -1, 1, 2, 3, 4)]
    want = [coarse[i:i + per] for i in range(0, 6, per)] + [
        fine[i:i + per] for i in range(0, 8, per)]
    assert calls == want and whole[2] == 0.1


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


def test_resync_reads_scores_once_a_scan(stegos, monkeypatch):
    """A rotation search reads its scores to the host twice (the coarse
    scan and the refinement), a translation search once, whatever the
    chunks; the rotation found is test_rotation_resync_matches_jax's."""
    d, out = stegos
    stego, m, sc, sw = _state(*out["color"])
    rot = cv2.warpAffine(stego, cv2.getRotationMatrix2D((W / 2, H / 2), 2.4,
                                                        1.0), (W, H),
                         borderMode=cv2.BORDER_REPLICATE)
    reads = []
    real_read = tb._read_scores
    monkeypatch.setattr(tb, "_read_scores",
                        lambda parts: reads.append(len(parts))
                        or real_read(parts))
    args = (torch.as_tensor(rot), torch.as_tensor(sc), torch.as_tensor(sw),
            m.alpha)
    found = tb.detect_color_resync(*args, kfrac=m.kfrac, sweeps=m.sched(),
                                   window=1, chunk=1, rot_range=3.0,
                                   rot_step=1.0)
    assert abs(found[2] - 2.4) <= 0.2 + 1e-6
    assert reads == [7, 8]
    reads.clear()
    tb.detect_color_resync(*args, kfrac=m.kfrac, sweeps=m.sched(), window=2,
                           chunk=4)
    assert reads == [3]


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
