"""Quality metrics (PSNR / SSIM / NC) on tensors with leading batch dims.

Counterpart of ``dctsvd_tpu/ops/metrics.py``; SSIM uses the Gaussian blur
of ``ops/enhance.py`` (the shift-and-add form in f32):
  - psnr: 20·log10(255/max(√mse, 1e-12)), capped at 99.0 for mse ≤ 1e-12;
  - ssim: simplified luminance SSIM over 11×11 σ=1.5 Gaussian windows with
    reflect-101 borders, C1=(0.01·255)², C2=(0.03·255)²;
  - nc: zero-mean cosine similarity with +1e-8 in the denominator.
"""

from __future__ import annotations

import torch

from dctsvd_tpu_torch.ops.enhance import gaussian_blur


def psnr(a: torch.Tensor, b: torch.Tensor,
         image_ndim: int | None = None) -> torch.Tensor:
    """Per-image PSNR over leading batch dims. ``image_ndim``: trailing axes
    forming ONE image (default 3 when the trailing dim looks like a channel
    axis, else 2)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if image_ndim is None:
        image_ndim = 3 if (a.ndim >= 3 and a.shape[-1] <= 4) else 2
    dims = tuple(range(a.ndim - min(image_ndim, a.ndim), a.ndim))
    mse = torch.mean((a - b) ** 2, dim=dims)
    val = 20.0 * torch.log10(255.0 / torch.clamp(torch.sqrt(mse), min=1e-12))
    return torch.where(mse <= 1e-12, torch.full_like(val, 99.0), val)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Simplified single-scale SSIM on gray float32 planes [..., H, W]."""
    x = img1.to(torch.float32)
    y = img2.to(torch.float32)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2

    def blur(v):
        return gaussian_blur(v, sigma=1.5, ksize=11)

    mu1 = blur(x)
    mu2 = blur(y)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(x * x) - mu1_sq
    s2 = blur(y * y) - mu2_sq
    s12 = blur(x * y) - mu12
    num = (2 * mu12 + c1) * (2 * s12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2) + 1e-12
    return torch.mean(num / den, dim=(-2, -1))


def nc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Zero-mean normalized correlation along the last axis."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    a = a - a.mean(dim=-1, keepdim=True)
    b = b - b.mean(dim=-1, keepdim=True)
    den = (torch.linalg.vector_norm(a, dim=-1)
           * torch.linalg.vector_norm(b, dim=-1) + 1e-8)
    return (a * b).sum(dim=-1) / den
