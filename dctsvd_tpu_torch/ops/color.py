"""Color conversions, bit-exact with OpenCV's fixed-point u8 paths.

Counterpart of ``dctsvd_tpu/ops/color.py``; the integer arithmetic is the
same, so results are byte-equal to cv2 and to the JAX package:
  BGR→YCrCb (14-bit):  Y  = (R·4899 + G·9617 + B·1868 + 2^13) >> 14
                       Cr = ((R−Y)·11682 + 128·2^14 + 2^13) >> 14
                       Cb = ((B−Y)·9241  + 128·2^14 + 2^13) >> 14
  YCrCb→BGR (14-bit):  R = Y + ((Cr−128)·22987 + 2^13 >> 14), …
  BGR→GRAY  (15-bit):  g = (R·9798 + G·19235 + B·3735 + 2^14) >> 15

All functions take/return channel-last uint8 tensors with any leading
batch dims, but for the planar YCrCb pair ([..., 3, H, W] planes).
``luma_f32`` and ``bgr_to_gray`` (K6), ``replace_luma`` (K7), the gray
scheme's conversions, and ``bgr_to_ycrcb_planes`` / ``ycrcb_planes_to_bgr``
(K17, the color NLM's pair) call the wrappers of the same names in
``ops/color_cuda.py``, which launch the hand-written kernels on CUDA tensors
and run the plain twins here (``*_plain``) on CPU tensors; that module is
where a caller's call lands, so it is the one name to patch.
``bgr_to_ycrcb`` and ``ycrcb_to_bgr`` (channels-last) are plain torch.
"""

from __future__ import annotations

import torch


def _descale(x: torch.Tensor, shift: int) -> torch.Tensor:
    return (x + (1 << (shift - 1))) >> shift


def _bgr_i32(bgr_u8: torch.Tensor):
    x = bgr_u8.to(torch.int32)
    return x[..., 0], x[..., 1], x[..., 2]


def bgr_to_ycrcb(bgr_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] BGR -> uint8 [..., 3] YCrCb, bit-exact with cv2."""
    b, g, r = _bgr_i32(bgr_u8)
    y = _descale(r * 4899 + g * 9617 + b * 1868, 14)
    cr = _descale((r - y) * 11682 + (128 << 14), 14)
    cb = _descale((b - y) * 9241 + (128 << 14), 14)
    out = torch.stack([y, cr, cb], dim=-1)
    return out.clamp(0, 255).to(torch.uint8)


def ycrcb_to_bgr(ycc_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] YCrCb -> uint8 [..., 3] BGR, bit-exact with cv2."""
    x = ycc_u8.to(torch.int32)
    y, cr, cb = x[..., 0], x[..., 1] - 128, x[..., 2] - 128
    r = y + _descale(cr * 22987, 14)
    # cv2 folds the negative G coefficients into one descale; the arithmetic
    # right shift floors, so the sign must stay inside the shift to match.
    g = y + _descale(cr * -11698 + cb * -5636, 14)
    b = y + _descale(cb * 29049, 14)
    out = torch.stack([b, g, r], dim=-1)
    return out.clamp(0, 255).to(torch.uint8)


def bgr_to_gray_plain(bgr_u8: torch.Tensor) -> torch.Tensor:
    """Plain twin of K6's gray instance: uint8 [..., 3] BGR -> uint8 [...]
    gray, bit-exact with cv2."""
    b, g, r = _bgr_i32(bgr_u8)
    y = _descale(r * 9798 + g * 19235 + b * 3735, 15)
    return y.clamp(0, 255).to(torch.uint8)


def luma_f32_plain(bgr_u8: torch.Tensor) -> torch.Tensor:
    """Plain twin of K6's luma instance: the quantized-u8 Y plane as
    float32 (only the Y lane of bgr_to_ycrcb)."""
    b, g, r = _bgr_i32(bgr_u8)
    y = _descale(r * 4899 + g * 9617 + b * 1868, 14)
    return y.clamp(0, 255).to(torch.float32)


def replace_luma_plain(y_f32: torch.Tensor,
                       bgr_ref_u8: torch.Tensor) -> torch.Tensor:
    """Plain twin of K7: clip Y to u8 (truncation, as the JAX package
    does), recombine with the original Cr/Cb and convert back to BGR."""
    ycc = bgr_to_ycrcb(bgr_ref_u8)
    y = y_f32.clamp(0, 255).to(torch.uint8)
    ycc = torch.cat([y[..., None], ycc[..., 1:]], dim=-1)
    return ycrcb_to_bgr(ycc)


def bgr_to_ycrcb_planes_plain(bgr_u8: torch.Tensor) -> torch.Tensor:
    """Plain twin of K17's forward: uint8 [..., H, W, 3] BGR -> uint8
    [..., 3, H, W] planar YCrCb (a view of bgr_to_ycrcb)."""
    return torch.movedim(bgr_to_ycrcb(bgr_u8), -1, -3)


def ycrcb_planes_to_bgr_plain(ycc_u8: torch.Tensor) -> torch.Tensor:
    """Plain twin of K17's inverse: uint8 [..., 3, H, W] planar YCrCb ->
    uint8 [..., H, W, 3] BGR."""
    return ycrcb_to_bgr(torch.movedim(ycc_u8, -3, -1))


# The public names call the wrappers, found at each call: ops/color_cuda.py
# imports the twins above from this module.

def bgr_to_gray(bgr_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H, W, 3] BGR -> uint8 [..., H, W] gray, bit-exact with
    cv2: ``color_cuda.bgr_to_gray`` (K6)."""
    from dctsvd_tpu_torch.ops import color_cuda
    return color_cuda.bgr_to_gray(bgr_u8)


def luma_f32(bgr_u8: torch.Tensor) -> torch.Tensor:
    """Quantized-u8 Y plane as float32 (only the Y lane of bgr_to_ycrcb):
    ``color_cuda.luma_f32`` (K6)."""
    from dctsvd_tpu_torch.ops import color_cuda
    return color_cuda.luma_f32(bgr_u8)


def replace_luma(y_f32: torch.Tensor, bgr_ref_u8: torch.Tensor) -> torch.Tensor:
    """Clip Y to u8 (truncation, as the JAX package does), recombine with the
    original Cr/Cb and convert back to BGR: ``color_cuda.replace_luma``
    (K7)."""
    from dctsvd_tpu_torch.ops import color_cuda
    return color_cuda.replace_luma(y_f32, bgr_ref_u8)


def bgr_to_ycrcb_planes(bgr_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H, W, 3] BGR -> uint8 [..., 3, H, W] planar YCrCb,
    bit-exact with cv2: ``color_cuda.bgr_to_ycrcb_planes`` (K17)."""
    from dctsvd_tpu_torch.ops import color_cuda
    return color_cuda.bgr_to_ycrcb_planes(bgr_u8)


def ycrcb_planes_to_bgr(ycc_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3, H, W] planar YCrCb -> uint8 [..., H, W, 3] BGR,
    bit-exact with cv2: ``color_cuda.ycrcb_planes_to_bgr`` (K17)."""
    from dctsvd_tpu_torch.ops import color_cuda
    return color_cuda.ycrcb_planes_to_bgr(ycc_u8)
