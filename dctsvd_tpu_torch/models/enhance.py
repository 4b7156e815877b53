"""The extraction enhancement chain (counterpart of
``dctsvd_tpu/models/enhance.py``):

Gray:  NLM(h=7,7,21) → CLAHE(2.0, 8×8) → unsharp(1.25, −0.25, σ=1)
       (ref: app_dct_svd_single.py:88-96,223,227)
Color: colored NLM(3,3,7,21) → CLAHE on Y only → unsharp(1.15, −0.15, σ=1)
       (ref: app_dct_svd_single.py:98-110,275-277)

The reference wraps NLM and CLAHE each in its own try/except and goes on
without the stage that failed (ref: :89-93,223-224,275-276); the chain
here degrades the same way, stage by stage: if NLM raises, CLAHE and
unsharp run on the un-denoised input; if CLAHE raises, unsharp runs
alone. Each degradation emits a RuntimeWarning naming the stage and the
exception. A device error (out of memory, a failed launch, a kernel
that does not build: ``utils/kernels.KernelError``) is not a stage
failure and propagates, so a broken NLM or CLAHE kernel (K10, K11) is
never hidden behind the un-denoised output. With no stage failing the
output is the JAX package's, within the tolerances of
tests/test_torch_enhance.py.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from dctsvd_tpu_torch.ops import color as c_ops
from dctsvd_tpu_torch.ops import enhance as e_ops
from dctsvd_tpu_torch.utils.kernels import KernelError

DEFAULT_DEVICE = "cuda"

#: Errors of the device and its kernels, which no stage may skip past.
_DEVICE_ERRORS = tuple(getattr(torch, name) for name in
                       ("OutOfMemoryError", "AcceleratorError")
                       if hasattr(torch, name)) + (KernelError,)


def _stage(stage: str, fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)``; if the stage raises (other than a device error), warn
    and return ``x`` unchanged."""
    try:
        return fn(x)
    except _DEVICE_ERRORS:
        raise
    except Exception as err:
        warnings.warn(f"enhancement stage {stage} failed and is skipped "
                      f"({type(err).__name__}: {err})", RuntimeWarning,
                      stacklevel=3)
        return x


def enhance_gray_u8(x: torch.Tensor, denoise: bool = True) -> torch.Tensor:
    """The gray chain on u8 planes [..., H, W]."""
    if denoise:
        x = _stage("NLM", lambda v: e_ops.nlm_gray_u8(
            v, h_param=7.0, template=7, search=21), x)
    x = _stage("CLAHE", lambda v: e_ops.clahe_u8(v, tiles=8, clip_limit=2.0),
               x)
    return e_ops.unsharp_u8(x, 1.25, -0.25, sigma=1.0)


def _clahe_luma(x: torch.Tensor) -> torch.Tensor:
    """CLAHE of the Y plane of BGR frames, with their Cr and Cb: K6's
    luma and K7's replace_luma, byte-equal to bgr_to_ycrcb, a new Y and
    ycrcb_to_bgr (tests/test_torch_enhance.py, on every BGR triple)."""
    y = e_ops.clahe_u8(c_ops.luma_f32(x).to(torch.uint8), tiles=8,
                       clip_limit=2.0)
    return c_ops.replace_luma(y.to(torch.float32), x)


def enhance_color_u8(x: torch.Tensor, denoise: bool = True) -> torch.Tensor:
    """The color chain on u8 BGR frames [..., H, W, 3]."""
    if denoise:
        x = _stage("NLM", lambda v: e_ops.nlm_color_u8(
            v, h_luma=3.0, h_chroma=3.0, template=7, search=21), x)
    x = _stage("CLAHE", _clahe_luma, x)
    # each channel blurred as its own plane, in the frames' own layout
    return e_ops.unsharp_u8(x, 1.15, -0.15, sigma=1.0, channels_last=True)


def enhance_gray_np(img_u8: np.ndarray, denoise: bool = True,
                    device=DEFAULT_DEVICE) -> np.ndarray:
    x = torch.as_tensor(np.ascontiguousarray(img_u8), device=device)
    return enhance_gray_u8(x, denoise=denoise).cpu().numpy()


def enhance_color_np(img_bgr_u8: np.ndarray, denoise: bool = True,
                     device=DEFAULT_DEVICE) -> np.ndarray:
    x = torch.as_tensor(np.ascontiguousarray(img_bgr_u8), device=device)
    return enhance_color_u8(x, denoise=denoise).cpu().numpy()
