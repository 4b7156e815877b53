"""The embed's quality metrics on the card: the wrappers of K15 (SSIM) and
K16 (PSNR's sum of squared differences) in ``csrc/metrics.cu``, and their
plain twins ``ssim_plain`` and ``psnr_plain``.

The JAX package has no ``pl.pallas_call`` for these: ``ssim``
(``dctsvd_tpu/ops/metrics.py:52``, five blurs of ``_gaussian_blur`` ``:44``)
and ``psnr`` (``:23``) are XLA fusions under the jitted embeds.

  - K15 ``ssim``: u8 planes [..., H, W] and planes of u8 (the color
    embed's gray stego) or f32 (the gray embed's unclipped marked Y) ->
    f32 [...]: the SSIM map of five 11-tap σ 1.5 blurs (``csrc/blur.cuh``,
    byte for byte ``ops/enhance.py::gaussian_blur``) and its mean a plane,
    summed in a fixed order: a tile's partial (SSIM_TILE² pixels: a
    thread's column at rows w, w + 8, w + 16, w + 24, a butterfly over the
    32 lanes, the 8 warps in order), then the plane's partials (a thread
    every FINISH_LANES-th, the same butterfly and warp order), then one
    IEEE division by H·W. The twin makes the same map with the eager ops
    and walks the same order, so the kernel is bit-equal to it on the
    card; against the JAX package's ``jnp.mean`` the order costs a few
    ulps (tests/test_torch_metrics.py holds 1e-5 of scale).
  - K16 ``psnr``: u8 pairs -> f32 [...]: the exact integer sum of squared
    differences an image (u32 a thread, u64 a CTA, one u64 atomic a CTA),
    divided once by the image's size in f64 and rounded to f32, then the
    twin's torch ops on the [B] vector (sqrt, the 1e-12 floor, log10, the
    99.0 cap) on the device, with no host read. The twin sums in float64,
    exactly for u8 pairs. This mse differs from the JAX package's f32 mean
    by a few ulps.

Each wrapper runs its twin for CPU tensors, of any dtype; for CUDA
tensors it launches its kernel, or raises ``ValueError`` for dtypes the
kernel does not take. Each counts its launches in ``.launches`` (K15's
finish kernel is part of its launch).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from dctsvd_tpu_torch.ops.dct import host_constant
from dctsvd_tpu_torch.ops.enhance import (_gauss1d, gaussian_blur,
                                          reflect_table)
from dctsvd_tpu_torch.ops.tail_cuda import _f32
from dctsvd_tpu_torch.ops.wm_cuda import _device_ok
from dctsvd_tpu_torch.utils import kernels

__all__ = ["ssim", "psnr", "ssim_plain", "psnr_plain", "ssim_map",
           "fixed_order_mean", "psnr_plan", "SSIM_TILE", "FINISH_LANES"]

SSIM_TILE = 32          # csrc/metrics.cu kSsimTile: a CTA's output tile
SSIM_SIGMA, SSIM_TAPS = 1.5, 11
WARPS = 8               # kSsimThreads / 32 (and the finish kernel's)
FINISH_LANES = 256      # kFinishThreads
#: The f32 constants of the SSIM map: torch casts the Python scalars to f32.
C1 = float(np.float32((0.01 * 255) ** 2))
C2 = float(np.float32((0.03 * 255) ** 2))
VECTOR_ALIGN = 16       # K16's 16-byte loads


def ssim_map(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """The SSIM map [..., H, W] (f32) of the eager form: five
    ``gaussian_blur`` calls (σ 1.5, 11 taps) and the map's ops."""
    x = img1.to(torch.float32)
    y = img2.to(torch.float32)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2

    def blur(v):
        return gaussian_blur(v, sigma=SSIM_SIGMA, ksize=SSIM_TAPS)

    mu1 = blur(x)
    mu2 = blur(y)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(x * x) - mu1_sq
    s2 = blur(y * y) - mu2_sq
    s12 = blur(x * y) - mu12
    num = (2 * mu12 + c1) * (2 * s12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2) + 1e-12
    return num / den


def _lane_tree(v: torch.Tensor) -> torch.Tensor:
    """The kernel's butterfly over the last axis of 32 lanes: lane i adds
    lane i + o at o = 16, 8, 4, 2, 1 (lane 0's sum)."""
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def _warp_order(v: torch.Tensor) -> torch.Tensor:
    """The warps' totals [..., WARPS] summed from 0 in warp order."""
    s = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for k in range(WARPS):
        s = s + v[..., k]
    return s


def fixed_order_mean(m: torch.Tensor) -> torch.Tensor:
    """The mean a plane of maps [P, H, W] (f32) in K15's order: each
    SSIM_TILE² tile's partial (thread (w, c): column c, rows w + 8 q, q =
    0..3, from 0, pixels past the plane adding 0; the lane butterfly; the
    warps in order), then the partials in row-major tile order (thread t:
    t, t + 256, ... from 0, 0 past the last; the butterfly; the warps),
    then one IEEE division by f32(H·W) -> [P]."""
    p, h, w = m.shape
    t = SSIM_TILE
    ty, tx = -(-h // t), -(-w // t)
    m = F.pad(m, (0, tx * t - w, 0, ty * t - h))
    m = m.reshape(p, ty, t // WARPS, WARPS, tx, t)
    acc = torch.zeros_like(m[:, :, 0])                  # [P, TY, 8, TX, 32]
    for q in range(t // WARPS):
        acc = acc + m[:, :, q]
    part = _warp_order(_lane_tree(acc).transpose(2, 3))  # [P, TY, TX]
    part = part.reshape(p, ty * tx)
    steps = -(-part.shape[1] // FINISH_LANES)
    part = F.pad(part, (0, steps * FINISH_LANES - part.shape[1]))
    part = part.reshape(p, steps, FINISH_LANES)
    acc = torch.zeros_like(part[:, 0])
    for j in range(steps):
        acc = acc + part[:, j]
    total = _warp_order(_lane_tree(acc.reshape(p, WARPS, 32)))
    return torch.div(total, _f32(h * w, m.device))


def ssim_plain(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Plain twin of K15: the eager map (:func:`ssim_map`) of planes
    [..., H, W] and its mean a plane in the kernel's order
    (:func:`fixed_order_mean`) -> f32 [...]."""
    lead, (h, w) = img1.shape[:-2], img1.shape[-2:]
    m = ssim_map(img1, img2).reshape(-1, h, w)
    return fixed_order_mean(m).reshape(lead)


def _mse_of(sums: torch.Tensor, n: int) -> torch.Tensor:
    """The sums an image (K16's int64, the twin's f64) over n, divided once
    in f64, as f32."""
    n64 = torch.full((), float(n), dtype=torch.float64, device=sums.device)
    return torch.div(sums.to(torch.float64), n64).to(torch.float32)


def psnr_of_mse(mse: torch.Tensor) -> torch.Tensor:
    """20·log10(255 / max(√mse, 1e-12)), 99.0 where mse ≤ 1e-12: the eager
    form's ops on the [B] vector."""
    val = 20.0 * torch.log10(255.0 / torch.clamp(torch.sqrt(mse), min=1e-12))
    return torch.where(mse <= 1e-12, torch.full_like(val, 99.0), val)


def _images(a: torch.Tensor, image_ndim: int | None) -> tuple:
    """(lead, n) of a [..., image] tensor: ``image_ndim`` trailing axes
    form one image (default 3 when the trailing dim looks like a channel
    axis, else 2)."""
    if image_ndim is None:
        image_ndim = 3 if (a.ndim >= 3 and a.shape[-1] <= 4) else 2
    k = min(image_ndim, a.ndim)
    return a.shape[:a.ndim - k], math.prod(a.shape[a.ndim - k:])


def psnr_plain(a: torch.Tensor, b: torch.Tensor,
               image_ndim: int | None = None) -> torch.Tensor:
    """Plain twin of K16: PSNR from the float64 sum of squared differences
    an image, of pairs of any dtype. For u8 pairs every term and partial
    sum is an integer below 2^53, so the sum is exact in any order, as
    K16's integer sums are."""
    lead, n = _images(a, image_ndim)
    d = (a.reshape(-1, n).to(torch.float64)
         - b.reshape(-1, n).to(torch.float64))
    return psnr_of_mse(_mse_of((d * d).sum(dim=1), n)).reshape(lead)


def psnr_plan(n: int, *ptrs: int) -> bool:
    """K16's vector instance (16-byte loads): images of n bytes with n a
    multiple of 16 and every pointer 16-byte aligned (each image then
    starts on the boundary too); else a byte a thread."""
    return n % VECTOR_ALIGN == 0 and all(p % VECTOR_ALIGN == 0 for p in ptrs)


def _check_shapes(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")


def _check_dtypes(name: str, a: torch.Tensor, b: torch.Tensor,
                  b_dtypes) -> None:
    """The kernel's dtypes: u8 first, then one of ``b_dtypes``."""
    if a.dtype != torch.uint8 or b.dtype not in b_dtypes:
        want = " or ".join(map(str, b_dtypes))
        raise ValueError(f"{name}: the kernel takes u8 with {want}, got "
                         f"{a.dtype} and {b.dtype}")


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """SSIM of planes [..., H, W] against planes of the same shape -> f32
    [...]: K15 on CUDA tensors (u8 against u8 or f32), its twin on CPU
    tensors."""
    _check_shapes("ssim", img1, img2)
    if img1.ndim < 2:
        raise ValueError(f"ssim: takes planes [..., H, W], got "
                         f"{tuple(img1.shape)}")
    if _device_ok("ssim", img1, img2):
        return ssim_plain(img1, img2)
    _check_dtypes("ssim", img1, img2, (torch.uint8, torch.float32))
    lead, (h, w) = img1.shape[:-2], img1.shape[-2:]
    x = img1.reshape(-1, h, w).contiguous()
    y = img2.reshape(-1, h, w).contiguous()
    p, dev = x.shape[0], x.device
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    if p and h and w:
        r = SSIM_TAPS // 2
        part = torch.empty((p * -(-h // SSIM_TILE) * -(-w // SSIM_TILE),),
                           dtype=torch.float32, device=dev)
        kernels.launch(
            "dctsvd_ssim", dev, x, y, int(y.dtype == torch.float32),
            reflect_table(h, r, dev), reflect_table(w, r, dev),
            host_constant(_gauss1d, SSIM_TAPS, SSIM_SIGMA, device="cpu"),
            C1, C2, part, out, p, h, w)
        ssim.launches += 1
    return out.reshape(lead)


def psnr(a: torch.Tensor, b: torch.Tensor,
         image_ndim: int | None = None) -> torch.Tensor:
    """PSNR an image of pairs [..., image] (``image_ndim`` trailing axes,
    as ``ops/metrics.psnr``) -> f32 [...]: K16's exact sums on CUDA
    tensors (u8 pairs), its twin on CPU tensors."""
    _check_shapes("psnr", a, b)
    if _device_ok("psnr", a, b):
        return psnr_plain(a, b, image_ndim)
    _check_dtypes("psnr", a, b, (torch.uint8,))
    lead, n = _images(a, image_ndim)
    x = a.reshape(-1, n).contiguous()
    y = b.reshape(-1, n).contiguous()
    sums = torch.zeros((x.shape[0],), dtype=torch.int64, device=x.device)
    if sums.numel() and n:
        kernels.launch("dctsvd_sq_diff", x.device, x, y, n, x.shape[0], sums,
                       int(psnr_plan(n, x.data_ptr(), y.data_ptr())))
        psnr.launches += 1
    return psnr_of_mse(_mse_of(sums, n)).reshape(lead)


ssim.launches = 0
psnr.launches = 0
