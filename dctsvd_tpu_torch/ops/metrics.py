"""Quality metrics (PSNR / SSIM / NC) on tensors with leading batch dims.

Counterpart of ``dctsvd_tpu/ops/metrics.py``:
  - psnr: 20·log10(255/max(√mse, 1e-12)), capped at 99.0 for mse ≤ 1e-12;
  - ssim: simplified luminance SSIM over 11×11 σ=1.5 Gaussian windows with
    reflect-101 borders (the blur of ``ops/enhance.py``), C1=(0.01·255)²,
    C2=(0.03·255)²;
  - nc: zero-mean cosine similarity with +1e-8 in the denominator.

``psnr`` and ``ssim`` call the wrappers of ``ops/metrics_cuda.py``,
found at each call (patching ``metrics_cuda.<name>`` reaches every
caller): on CUDA tensors K16 (u8 pairs) and K15 (u8 planes against u8 or
f32 planes, every embed's pairs), which raise ``ValueError`` for other
dtypes; on CPU tensors of any dtype their plain twins.
"""

from __future__ import annotations

import torch

# SSIM's blur, re-exported as in the JAX package's module
from dctsvd_tpu_torch.ops.enhance import gaussian_blur  # noqa: F401


def psnr(a: torch.Tensor, b: torch.Tensor,
         image_ndim: int | None = None) -> torch.Tensor:
    """Per-image PSNR over leading batch dims. ``image_ndim``: trailing axes
    forming ONE image (default 3 when the trailing dim looks like a channel
    axis, else 2): ``metrics_cuda.psnr`` (K16)."""
    from dctsvd_tpu_torch.ops import metrics_cuda
    return metrics_cuda.psnr(a, b, image_ndim)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Simplified single-scale SSIM on gray planes [..., H, W]:
    ``metrics_cuda.ssim`` (K15)."""
    from dctsvd_tpu_torch.ops import metrics_cuda
    return metrics_cuda.ssim(img1, img2)


def nc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Zero-mean normalized correlation along the last axis."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    a = a - a.mean(dim=-1, keepdim=True)
    b = b - b.mean(dim=-1, keepdim=True)
    den = (torch.linalg.vector_norm(a, dim=-1)
           * torch.linalg.vector_norm(b, dim=-1) + 1e-8)
    return (a * b).sum(dim=-1) / den
