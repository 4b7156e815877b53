"""The gray scheme's color conversions and the color NLM's YCrCb pair: the
wrappers of K6, K7 and K17 (``csrc/color.cu``); their plain twins are
``ops/color.py``'s ``*_plain``.

The JAX package has no ``pl.pallas_call`` for these: ``luma_f32``,
``bgr_to_gray`` and ``replace_luma`` (``dctsvd_tpu/ops/color.py:55-83``)
are one XLA fusion inside the jitted ``embed_gray_prepared``
(``dctsvd_tpu/models/blocked.py:415-429``) and the gray extract and
detect. All of it is cv2's exact integer arithmetic, so each kernel is
bit-equal to its twin, to cv2 and to the JAX package:
  BGR→YCrCb (14-bit):  Y  = (R·4899 + G·9617 + B·1868 + 2^13) >> 14
                       Cr = ((R−Y)·11682 + 128·2^14 + 2^13) >> 14
                       Cb = ((B−Y)·9241  + 128·2^14 + 2^13) >> 14
  YCrCb→BGR (14-bit):  R = Y + ((Cr−128)·22987 + 2^13 >> 14), …
  BGR→GRAY  (15-bit):  g = (R·9798 + G·19235 + B·3735 + 2^14) >> 15

  - K6 ``luma_f32`` / ``bgr_to_gray`` (``luma_kernel<Out, kGray>``): u8
    BGR frames [..., H, W, 3] -> the 14-bit Y plane as f32, or the 15-bit
    gray plane as u8, [..., H, W].
  - K7 ``replace_luma`` (``replace_luma_kernel``): f32 Y' [..., H, W] and
    u8 BGR [..., H, W, 3] -> u8 BGR: Y' clamped and truncated to u8 with
    the original's Cr and Cb, converted back to BGR.
  - K17 ``bgr_to_ycrcb_planes`` (``ycrcb_planes_kernel``): u8 BGR
    [..., H, W, 3] -> planar u8 YCrCb [..., 3, H, W] (the layout
    ``nlm_color_u8`` feeds to K10), and ``ycrcb_planes_to_bgr``
    (``ycrcb_bgr_kernel``) back: ``bgr_to_ycrcb`` and ``ycrcb_to_bgr``
    of ``dctsvd_tpu/ops/color.py:31,42``, around ``nlm_color_u8``
    (``dctsvd_tpu/ops/enhance.py:234``), with the planar layout's copy
    folded into the conversion.

A frame is the last two dims before the channel; the kernels take it whole
in a (4-pixel groups, frames) grid with 32-bit offsets inside a frame, so
its BGR bytes must stay under 2^31. :func:`color_plan` picks the vector
path (4 pixels a thread) or the scalar one (a pixel a thread).

Each wrapper runs its twin only for CPU tensors; for CUDA tensors it
launches its kernel or raises. Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import math

import torch

from dctsvd_tpu_torch.ops.color import (bgr_to_gray_plain,
                                        bgr_to_ycrcb_planes_plain,
                                        luma_f32_plain, replace_luma_plain,
                                        ycrcb_planes_to_bgr_plain)
from dctsvd_tpu_torch.ops.wm_cuda import _device_ok
from dctsvd_tpu_torch.utils import kernels

__all__ = ["luma_f32", "bgr_to_gray", "replace_luma",
           "bgr_to_ycrcb_planes", "ycrcb_planes_to_bgr", "luma_f32_plain",
           "bgr_to_gray_plain", "replace_luma_plain",
           "bgr_to_ycrcb_planes_plain", "ycrcb_planes_to_bgr_plain",
           "color_plan"]

COLOR_THREADS = 256    # threads a CTA (csrc/color.cu kColorThreads)
# The byte alignment of each pointer the vector path reads or writes, in
# the C entry's order: u8 BGR as 32-bit words, f32 Y as float4, u8 gray as
# one 32-bit word, each YCrCb plane as 32-bit words.
VECTOR_ALIGN = {"luma_f32": (4, 16), "bgr_to_gray": (4, 4),
                "replace_luma": (16, 4, 4), "bgr_to_ycrcb_planes": (4, 4),
                "ycrcb_planes_to_bgr": (4, 4)}


def color_plan(kind: str, pix: int, *ptrs: int) -> tuple:
    """(vector, grid) of K6 (``kind`` 'luma_f32' or 'bgr_to_gray'; ptrs:
    the BGR input, the plane out), K7 ('replace_luma'; ptrs: Y', the BGR
    input, the BGR out) or K17 ('bgr_to_ycrcb_planes' or
    'ycrcb_planes_to_bgr'; ptrs: the input, the output) on frames of
    ``pix`` pixels. The vector path takes
    4 pixels a thread, so it needs ``pix`` a multiple of 4 and every
    pointer on its ``VECTOR_ALIGN`` boundary (a frame then starts on one
    too); anything else takes the scalar path, a pixel a thread. grid:
    the CTAs of COLOR_THREADS threads that cover one frame."""
    align = VECTOR_ALIGN[kind]
    if len(ptrs) != len(align):
        raise ValueError(f"{kind}: {len(align)} pointers, got {len(ptrs)}")
    vector = pix % 4 == 0 and all(p % a == 0 for p, a in zip(ptrs, align))
    units = pix // 4 if vector else pix
    return vector, max(1, -(-units // COLOR_THREADS))


def _check_bgr(name: str, bgr: torch.Tensor) -> None:
    if bgr.dtype != torch.uint8:
        raise ValueError(f"{name}: BGR frames must be uint8, got {bgr.dtype}")
    if bgr.ndim < 1 or bgr.shape[-1] != 3:
        raise ValueError(f"{name}: BGR frames are [..., H, W, 3], got "
                         f"{tuple(bgr.shape)}")


def _frames(name: str, bgr: torch.Tensor) -> tuple:
    """(frames, pixels a frame) of BGR [..., H, W, 3]; raises for a frame
    whose bytes reach 2^31 (the kernels' offsets in a frame are 32-bit)."""
    frames, pix = math.prod(bgr.shape[:-3]), math.prod(bgr.shape[-3:-1])
    if 3 * pix >= 1 << 31 or frames >= 1 << 31:
        raise ValueError(f"{name}: a frame of {pix} pixels or {frames} "
                         "frames is too large for the kernel")
    return frames, pix


def _luma(name: str, bgr: torch.Tensor, dtype, wrapper) -> torch.Tensor:
    """K6 on CUDA BGR frames: the plane [..., H, W] in ``dtype``."""
    bgr = bgr.contiguous()
    y = torch.empty(bgr.shape[:-1], dtype=dtype, device=bgr.device)
    if y.numel():
        frames, pix = _frames(name, bgr)
        vector, grid = color_plan(name, pix, bgr.data_ptr(), y.data_ptr())
        kernels.launch("dctsvd_luma", bgr.device, bgr, y,
                       int(dtype == torch.uint8), frames, pix, int(vector),
                       grid)
        wrapper.launches += 1
    return y


def luma_f32(bgr_u8: torch.Tensor) -> torch.Tensor:
    """Quantized-u8 Y plane as float32 (only the Y lane of bgr_to_ycrcb):
    uint8 [..., H, W, 3] BGR -> float32 [..., H, W]. K6 on a CUDA tensor,
    its twin on a CPU tensor."""
    _check_bgr("luma_f32", bgr_u8)
    if _device_ok("luma_f32", bgr_u8):
        return luma_f32_plain(bgr_u8)
    return _luma("luma_f32", bgr_u8, torch.float32, luma_f32)


def bgr_to_gray(bgr_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H, W, 3] BGR -> uint8 [..., H, W] gray, bit-exact with
    cv2. K6 on a CUDA tensor, its twin on a CPU tensor."""
    _check_bgr("bgr_to_gray", bgr_u8)
    if _device_ok("bgr_to_gray", bgr_u8):
        return bgr_to_gray_plain(bgr_u8)
    return _luma("bgr_to_gray", bgr_u8, torch.uint8, bgr_to_gray)


def replace_luma(y_f32: torch.Tensor, bgr_ref_u8: torch.Tensor) -> torch.Tensor:
    """Clip Y to u8 (truncation, as the JAX package does), recombine with the
    original Cr/Cb and convert back to BGR: float32 [..., H, W] and uint8
    [..., H, W, 3] -> uint8 [..., H, W, 3]. K7 on CUDA tensors, its twin
    on CPU tensors."""
    _check_bgr("replace_luma", bgr_ref_u8)
    if y_f32.dtype != torch.float32:
        raise ValueError(f"replace_luma: Y must be float32, got "
                         f"{y_f32.dtype}")
    if tuple(y_f32.shape) != tuple(bgr_ref_u8.shape[:-1]):
        raise ValueError(f"replace_luma: Y {tuple(y_f32.shape)} does not "
                         f"match the frames {tuple(bgr_ref_u8.shape)}")
    if _device_ok("replace_luma", y_f32, bgr_ref_u8):
        return replace_luma_plain(y_f32, bgr_ref_u8)
    y, bgr = y_f32.contiguous(), bgr_ref_u8.contiguous()
    out = torch.empty_like(bgr)
    if out.numel():
        frames, pix = _frames("replace_luma", bgr)
        vector, grid = color_plan("replace_luma", pix, y.data_ptr(),
                                  bgr.data_ptr(), out.data_ptr())
        kernels.launch("dctsvd_replace_luma", bgr.device, y, bgr, out,
                       frames, pix, int(vector), grid)
        replace_luma.launches += 1
    return out


def _ycrcb(name: str, x: torch.Tensor, out: torch.Tensor, inverse: bool,
           wrapper) -> torch.Tensor:
    """K17 on CUDA frames, BGR to planes or back, into ``out``."""
    if out.numel():
        frames, pix = _frames(name, out if inverse else x)
        vector, grid = color_plan(name, pix, x.data_ptr(), out.data_ptr())
        kernels.launch("dctsvd_ycrcb", x.device, x, out, int(inverse),
                       frames, pix, int(vector), grid)
        wrapper.launches += 1
    return out


def bgr_to_ycrcb_planes(bgr_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H, W, 3] BGR -> uint8 [..., 3, H, W] planar YCrCb,
    bit-exact with cv2. K17 on a CUDA tensor, its twin on a CPU tensor."""
    _check_bgr("bgr_to_ycrcb_planes", bgr_u8)
    if bgr_u8.ndim < 3:
        raise ValueError(f"bgr_to_ycrcb_planes: BGR frames are [..., H, W, "
                         f"3], got {tuple(bgr_u8.shape)}")
    if _device_ok("bgr_to_ycrcb_planes", bgr_u8):
        return bgr_to_ycrcb_planes_plain(bgr_u8)
    x = bgr_u8.contiguous()
    out = torch.empty((*x.shape[:-3], 3, *x.shape[-3:-1]), dtype=torch.uint8,
                      device=x.device)
    return _ycrcb("bgr_to_ycrcb_planes", x, out, False, bgr_to_ycrcb_planes)


def ycrcb_planes_to_bgr(ycc_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3, H, W] planar YCrCb -> uint8 [..., H, W, 3] BGR,
    bit-exact with cv2. K17 on a CUDA tensor, its twin on a CPU tensor."""
    if ycc_u8.dtype != torch.uint8 or ycc_u8.ndim < 3 or ycc_u8.shape[-3] != 3:
        raise ValueError(f"ycrcb_planes_to_bgr: takes u8 planes [..., 3, H, "
                         f"W], got {ycc_u8.dtype} {tuple(ycc_u8.shape)}")
    if _device_ok("ycrcb_planes_to_bgr", ycc_u8):
        return ycrcb_planes_to_bgr_plain(ycc_u8)
    x = ycc_u8.contiguous()
    out = torch.empty((*x.shape[:-3], *x.shape[-2:], 3), dtype=torch.uint8,
                      device=x.device)
    return _ycrcb("ycrcb_planes_to_bgr", x, out, True, ycrcb_planes_to_bgr)


luma_f32.launches = 0
bgr_to_gray.launches = 0
replace_luma.launches = 0
bgr_to_ycrcb_planes.launches = 0
ycrcb_planes_to_bgr.launches = 0
