"""The port's enhancement stages and chains (dctsvd_tpu_torch/ops/enhance.py,
models/enhance.py) against the JAX package on the CPU.

Tolerances: unsharp and CLAHE within 1 quantum (the JAX package's own
bound against cv2, tests/test_enhance.py); NLM within 1 quantum on at
least 99 % of pixels; the whole chains' mean |Δ| < 0.5. The chain
degrades stage by stage where the JAX package collapses any failure to
unsharp only (an intended divergence): with NLM failing the output is
exactly the port's un-denoised chain, which holds the chain tolerance
(mean |Δ| < 0.5) against the JAX package's
``enhance_gray_u8(x, denoise=False)``."""

import warnings

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctsvd_tpu.models import enhance as jme
from dctsvd_tpu.ops import enhance as je
from dctsvd_tpu_torch.models import enhance as tme
from dctsvd_tpu_torch.ops import enhance as te
from dctsvd_tpu_torch.ops import metrics as tmetrics

torch.set_num_threads(2)

SEED = 20261021


def _plane(shape, seed=SEED, sigma=2.0):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, shape, np.uint8), (0, 0),
                            sigma)


def _diff(got: torch.Tensor, ref) -> np.ndarray:
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape and got.dtype == torch.uint8
    return np.abs(got.numpy().astype(int) - ref.astype(int))


SHAPES = [(64, 80), (96, 128), (37, 51)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_unsharp_matches_jax(shape):
    img = _plane(shape)
    for amount, weight in ((1.25, -0.25), (1.15, -0.15)):
        d = _diff(te.unsharp_u8(torch.as_tensor(img), amount, weight),
                  je.unsharp_u8(jnp.asarray(img), amount, weight))
        assert d.max() <= 1


@pytest.mark.parametrize("shape", SHAPES + [(3, 40, 52)], ids=str)
def test_clahe_matches_jax(shape):
    """Batched planes map over the 2-D body, as in the JAX package."""
    img = _plane(shape)
    d = _diff(te.clahe_u8(torch.as_tensor(img)), je.clahe_u8(jnp.asarray(img)))
    assert d.max() <= 1


@pytest.mark.parametrize("sigma", [1.0, 1.5])
def test_gaussian_blur_is_the_metrics_blur(sigma):
    """SSIM's blur (ops/metrics) is the enhancement module's."""
    x = _plane((37, 51)).astype(np.float32)
    a = te.gaussian_blur(torch.as_tensor(x), sigma)
    assert torch.equal(a, tmetrics.gaussian_blur(torch.as_tensor(x), sigma))
    b = np.asarray(je.gaussian_blur(jnp.asarray(x), sigma))
    assert np.abs(a.numpy() - b).max() <= 1e-3


def test_box_filter_matches_jax():
    x = (np.random.default_rng(SEED).random((2, 29, 33)) * 65025.0
         ).astype(np.float32)
    a = te._box_filter(torch.as_tensor(x), 3).numpy()
    b = np.asarray(je._box_filter(jnp.asarray(x), 3))
    assert np.abs(a - b).max() <= 1e-6 * 65025.0 * 49


@pytest.mark.parametrize("kind", ["gray", "color"])
def test_nlm_matches_jax(kind):
    if kind == "gray":
        img = _plane((32, 40), sigma=1.0)
        d = _diff(te.nlm_gray_u8(torch.as_tensor(img)),
                  je.nlm_gray_u8(jnp.asarray(img)))
    else:
        img = _plane((32, 40, 3), sigma=1.0)
        d = _diff(te.nlm_color_u8(torch.as_tensor(img)),
                  je.nlm_color_u8(jnp.asarray(img)))
    assert (d <= 1).mean() >= 0.99


@pytest.mark.parametrize("kind", ["gray", "color"])
def test_chain_matches_jax(kind):
    shape = (32, 40) if kind == "gray" else (32, 40, 3)
    img = _plane(shape, seed=SEED + 1, sigma=1.0)
    t_fn = tme.enhance_gray_np if kind == "gray" else tme.enhance_color_np
    j_fn = jme.enhance_gray_np if kind == "gray" else jme.enhance_color_np
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = t_fn(img, device="cpu")
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert np.abs(got.astype(int) - j_fn(img).astype(int)).mean() < 0.5


def _raise(*args, **kwargs):
    raise ValueError("stage broken for the test")


def test_gray_chain_degrades_stage_by_stage(monkeypatch):
    img = _plane((32, 40), seed=SEED + 2, sigma=1.0)
    x = torch.as_tensor(img)
    plain = tme.enhance_gray_u8(x, denoise=False)
    monkeypatch.setattr(te, "nlm_gray_u8", _raise)
    with pytest.warns(RuntimeWarning, match="NLM.*ValueError"):
        no_nlm = tme.enhance_gray_u8(x)
    assert torch.equal(no_nlm, plain)
    ref = jme.enhance_gray_u8(jnp.asarray(img), denoise=False)
    assert _diff(no_nlm, ref).mean() < 0.5
    monkeypatch.setattr(te, "clahe_u8", _raise)
    with pytest.warns(RuntimeWarning) as rec:
        unsharp_only = tme.enhance_gray_u8(x)
    assert [str(w.message).split()[2] for w in rec] == ["NLM", "CLAHE"]
    assert torch.equal(unsharp_only, te.unsharp_u8(x, 1.25, -0.25))


def test_color_chain_degrades_stage_by_stage(monkeypatch):
    img = _plane((32, 40, 3), seed=SEED + 3, sigma=1.0)
    x = torch.as_tensor(img)
    plain = tme.enhance_color_u8(x, denoise=False)
    monkeypatch.setattr(te, "nlm_color_u8", _raise)
    with pytest.warns(RuntimeWarning, match="NLM"):
        assert torch.equal(tme.enhance_color_u8(x), plain)
    monkeypatch.setattr(te, "clahe_u8", _raise)
    with pytest.warns(RuntimeWarning) as rec:
        got = tme.enhance_color_u8(x)
    assert [str(w.message).split()[2] for w in rec] == ["NLM", "CLAHE"]
    ref = torch.movedim(te.unsharp_u8(torch.movedim(x, -1, -3), 1.15, -0.15),
                        -3, -1)
    assert torch.equal(got, ref)


def test_device_errors_are_not_skipped(monkeypatch):
    """An out-of-memory error is the device's, not the stage's: it
    propagates instead of degrading the chain."""
    def oom(*args, **kwargs):
        raise torch.OutOfMemoryError("out of memory")
    monkeypatch.setattr(te, "nlm_gray_u8", oom)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(torch.OutOfMemoryError):
            tme.enhance_gray_u8(torch.as_tensor(_plane((16, 16))))
