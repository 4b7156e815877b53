"""Detect resync's search: the wrappers of K12 ``roll_stack`` and K13
``derotate`` (``csrc/resync.cu``) and their plain twins.

The JAX package has no ``pl.pallas_call`` for these: the roll stack is the
``jax.vmap(jnp.roll)`` of ``_detect_shift_chunk``
(``dctsvd_tpu/models/blocked.py:1381``) and the counter-rotation is
``_derotate`` (``:1310``, ``map_coordinates(order=1, mode='constant')`` at
``:1333``), each an XLA fusion.

  - K12 ``roll_stack`` (``roll_rows_vector``, ``roll_rows_scalar``): one
    frame [H, W] or [H, W, C] (u8 or f32) and an [S, 2] int64 tensor of
    (dy, dx) offsets on the same device -> the S rolls [S, H, W(, C)],
    ``out[s, r, c] = img[(r - dy_s) mod H, (c - dx_s) mod W]``
    (``torch.roll``'s sense, any offsets). :func:`roll_plan` picks the
    instance.
  - K13 ``derotate`` and ``derotate_angles`` (``derotate_kernel``):
    planes [..., H, W] or, with ``color_frames``, frames [..., H, W, C]
    (u8 or f32) and an angle in degrees -> the frame counter-rotated about
    (W/2, H/2), bilinear with zeros outside, integer inputs rounded half to
    even and clamped to [0, 255]; ``derotate_angles`` takes a list of A
    angles and returns the A counter-rotations stacked [A, ...] from one
    launch (the resync search's scan), ``derotate`` is its A = 1 case.
    :func:`derotate_plan` picks the instance (a thread's ROT_PIXELS pixels
    stored whole, or element by element).

K12 copies and K13 repeats its twin's f32 operations one by one in the
twin's order (``csrc/resync.cu``'s header), with the twin's own cos and
sin (:func:`rotation_cs`, or :func:`rotation_cs_batch` for a scan's
angles in one pass of the same ops): each is equal (``torch.equal``) to
its twin run on the card. None makes the host wait: the offsets and the
angles' cos and sin stay on the device, and a scan's angles reach it by a
non-blocking copy from pinned memory.

Each wrapper runs its twin only for CPU tensors; for CUDA tensors it
launches its kernel or raises. Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import math

import torch

from dctsvd_tpu_torch.ops.wm_cuda import _device_ok
from dctsvd_tpu_torch.utils import kernels

__all__ = ["roll_stack", "roll_stack_plain", "roll_plan", "derotate",
           "derotate_plain", "derotate_angles", "derotate_angles_plain",
           "derotate_plan", "rotation_cs", "rotation_cs_batch"]

DTYPES = (torch.uint8, torch.float32)
DEROTATE_CHANNELS = (1, 3, 4)    # K13's instances
ROT_PIXELS = 4                   # csrc/resync.cu kRotPix: pixels a thread
VECTOR_ALIGN = 16


def _check_dtype(name: str, x: torch.Tensor) -> None:
    if x.dtype not in DTYPES:
        raise ValueError(f"{name} takes uint8 or float32, got {x.dtype}")


def roll_plan(row_bytes: int, *ptrs: int) -> bool:
    """K12's instance: the vector one (16 output bytes a thread) when a
    row's bytes are a multiple of 16 and every pointer (the frame, the
    stack) is on a 16-byte boundary; else the scalar one."""
    return row_bytes % 16 == 0 and all(p % 16 == 0 for p in ptrs)


def roll_stack_plain(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """The rolls of ONE image ([H, W] or [H, W, C]) by each of an [S, 2]
    tensor of offsets (``torch.roll`` semantics), stacked on a leading
    axis [S, H, W(, C)] by one indexing op."""
    h, w = img.shape[0], img.shape[1]
    rows = torch.remainder(
        torch.arange(h, device=img.device)[None, :] - shifts[:, :1], h)
    cols = torch.remainder(
        torch.arange(w, device=img.device)[None, :] - shifts[:, 1:], w)
    return img[rows[:, :, None], cols[:, None, :]]


def roll_stack(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """The S rolls of one frame (see the module docstring): K12 on CUDA
    tensors, its twin on CPU tensors."""
    _check_dtype("roll_stack", img)
    if img.ndim not in (2, 3):
        raise ValueError(f"roll_stack takes [H, W] or [H, W, C], got "
                         f"{tuple(img.shape)}")
    if shifts.dtype != torch.int64 or shifts.ndim != 2 or \
            shifts.shape[1] != 2:
        raise ValueError(f"roll_stack takes int64 shifts [S, 2], got "
                         f"{shifts.dtype} {tuple(shifts.shape)}")
    if _device_ok("roll_stack", img, shifts):
        return roll_stack_plain(img, shifts)
    x, sh = img.contiguous(), shifts.contiguous()
    out = torch.empty((shifts.shape[0], *img.shape), dtype=img.dtype,
                      device=img.device)
    if out.numel():
        h, w = img.shape[0], img.shape[1]
        c = img.shape[2] if img.ndim == 3 else 1
        esize = img.element_size()
        vector = roll_plan(w * c * esize, x.data_ptr(), out.data_ptr())
        kernels.launch("dctsvd_roll_stack", img.device, x, sh, out,
                       shifts.shape[0], h, w, c, esize, int(vector))
        roll_stack.launches += 1
    return out


roll_stack.launches = 0


def rotation_cs(angle_deg: float, device) -> torch.Tensor:
    """f32 [cos, sin] of ``angle_deg`` on ``device``: deg2rad, cos and sin
    of an f32 tensor made by a fill (a copy from the host would wait for
    the card's queue to drain)."""
    th = torch.deg2rad(torch.full((), float(angle_deg), dtype=torch.float32,
                                  device=device))
    return torch.stack([torch.cos(th), torch.sin(th)])


def rotation_cs_batch(angles, device) -> torch.Tensor:
    """f32 [A, 2] (cos, sin) of each angle on ``device``: rotation_cs's
    deg2rad, cos and sin once, on an [A] f32 tensor of the angles (each
    the f32 value ``torch.full`` makes of it). On a card the angles reach
    it by a non-blocking copy from pinned memory, so the host does not
    wait for the card's queue."""
    th = torch.tensor([float(a) for a in angles], dtype=torch.float32)
    if torch.device(device).type == "cuda":
        th = th.pin_memory().to(device, non_blocking=True)
    th = torch.deg2rad(th)
    return torch.stack([torch.cos(th), torch.sin(th)], dim=-1)


def derotate_plan(w: int, *ptrs: int) -> bool:
    """K13's instance: the vector one (a thread's ROT_PIXELS pixels stored
    whole) when W is a multiple of ROT_PIXELS and every output pointer is
    on a 16-byte boundary; else the scalar one."""
    return w % ROT_PIXELS == 0 and all(p % VECTOR_ALIGN == 0 for p in ptrs)


def derotate_plain(img: torch.Tensor, angle_deg: float,
                   color_frames: bool = False) -> torch.Tensor:
    """Inverse-rotate ``img`` ([H, W] plane, or [H, W, C] frames with
    ``color_frames``) about its center by ``angle_deg`` degrees: the
    realignment candidate for a stego rotated with
    ``cv2.getRotationMatrix2D((w/2, h/2), angle_deg, 1.0)`` + warpAffine.
    Integer-tap bilinear sampling with zeros outside the frame
    (``map_coordinates(order=1, mode='constant')``), so
    ``derotate_plain(x, 0.0)`` is exactly x; integer inputs are rounded
    half to even and clipped to [0, 255]."""
    x = torch.movedim(img, -1, 0) if color_frames else img
    h, w = x.shape[-2], x.shape[-1]
    dev = x.device
    # cv2 convention: center (w/2, h/2), y-down; the inverse map samples
    # src = R(+a)·(dst − c) + c with R = [[cos, sin], [−sin, cos]]
    c, s = rotation_cs(angle_deg, dev)
    cy, cx = h * 0.5, w * 0.5
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    src_x = c * xx + s * yy + cx
    src_y = -s * xx + c * yy + cy

    def taps(coord):
        lower = torch.floor(coord)
        upper_w = coord - lower
        i0 = lower.to(torch.int64)
        return [(i0, 1 - upper_w), (i0 + 1, upper_w)]

    planes = x.to(torch.float32).reshape(-1, h * w)
    out = None
    for iy, wy in taps(src_y):
        for ix, wx in taps(src_x):
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(-1)
            val = planes.index_select(-1, flat).reshape(-1, h, w)
            term = (wy * wx) * torch.where(valid, val, 0.0)
            out = term if out is None else out + term
    out = out.reshape(x.shape)
    if not img.dtype.is_floating_point:
        out = torch.round(out).clamp(0, 255)
    out = out.to(img.dtype)
    return torch.movedim(out, 0, -1) if color_frames else out


def derotate_angles_plain(img: torch.Tensor, angles,
                          color_frames: bool = False) -> torch.Tensor:
    """Plain twin of :func:`derotate_angles`: :func:`derotate_plain` of
    ``img`` at each angle, stacked [A, ...]."""
    if not len(angles):
        return img.new_empty((0, *img.shape))
    return torch.stack([derotate_plain(img, a, color_frames)
                        for a in angles])


def _check_derotate(name: str, img: torch.Tensor, angles,
                    color_frames: bool) -> None:
    _check_dtype(name, img)
    if img.ndim < 2 + color_frames:
        layout = "[..., H, W, C]" if color_frames else "[..., H, W]"
        raise ValueError(f"{name} takes {layout}, got {tuple(img.shape)}")
    bad = [a for a in angles if not math.isfinite(a)]
    if bad:
        raise ValueError(f"{name} takes finite angles, got {bad[0]}")


def _derotate_launch(img: torch.Tensor, cs: torch.Tensor,
                     color_frames: bool) -> torch.Tensor:
    """K13 on a CUDA tensor for the A rows of ``cs`` ([A, 2] f32 on the
    device) -> ([A, *img.shape], whether it launched: not for an empty
    frame)."""
    c = img.shape[-1] if color_frames else 1
    h, w = ((img.shape[-3], img.shape[-2]) if color_frames
            else (img.shape[-2], img.shape[-1]))
    if c not in DEROTATE_CHANNELS:
        raise ValueError(f"derotate: the kernel takes {DEROTATE_CHANNELS} "
                         f"channels, got {c}")
    x = img.contiguous()
    out = torch.empty((cs.shape[0], *x.shape), dtype=x.dtype,
                      device=x.device)
    if not out.numel():
        return out, False
    frames = x.numel() // (h * w * c)
    kernels.launch("dctsvd_derotate", img.device, x, cs, out, cs.shape[0],
                   frames, h, w, c, int(img.dtype == torch.uint8),
                   int(derotate_plan(w, out.data_ptr())))
    return out, True


def derotate_angles(img: torch.Tensor, angles,
                    color_frames: bool = False) -> torch.Tensor:
    """The counter-rotations of ``img`` by each of ``angles`` (degrees),
    stacked [A, ...]: on a CUDA tensor one K13 launch for all A, their cos
    and sin made in one pass (:func:`rotation_cs_batch`); on a CPU tensor
    the twin, angle by angle."""
    angles = [float(a) for a in angles]
    _check_derotate("derotate_angles", img, angles, color_frames)
    if _device_ok("derotate_angles", img) or not angles:
        return derotate_angles_plain(img, angles, color_frames)
    out, launched = _derotate_launch(
        img, rotation_cs_batch(angles, img.device), color_frames)
    derotate_angles.launches += launched
    return out


def derotate(img: torch.Tensor, angle_deg: float,
             color_frames: bool = False) -> torch.Tensor:
    """The counter-rotation of :func:`derotate_plain`: K13 on a CUDA
    tensor (planes [..., H, W], or frames [..., H, W, C] with C in
    DEROTATE_CHANNELS; :func:`derotate_angles`' launch for one angle), its
    twin on a CPU tensor."""
    _check_derotate("derotate", img, [angle_deg], color_frames)
    if _device_ok("derotate", img):
        return derotate_plain(img, angle_deg, color_frames)
    out, launched = _derotate_launch(
        img, rotation_cs(angle_deg, img.device)[None], color_frames)
    derotate.launches += launched
    return out[0]


derotate.launches = 0
derotate_angles.launches = 0
