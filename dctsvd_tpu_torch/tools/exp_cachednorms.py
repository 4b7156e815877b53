"""T5: final singular values from the Rutishauser-cached norms against
fresh ones (the port of ``tools/exp_cachednorms.py``).

Both rows relay the f32 planes into the cols view and run the spectrum
probe on it at s2, the one with the fresh final norms (K1's), the other
with sqrt(max(n, 0)) of the cached norms n, which saves 8 dots per block.
The deviation is the tool's: |s_cached − s_fresh| / (s_fresh[..., :1] +
1e-9), its mean and max.

    python -m dctsvd_tpu_torch.tools.exp_cachednorms
"""

from __future__ import annotations

import torch

from dctsvd_tpu_torch.ops import probe_cuda
from dctsvd_tpu_torch.tools import common

SWEEPS = 2


def spectrum_cached(planes: torch.Tensor, sweeps: int = SWEEPS,
                    cached: bool = True) -> torch.Tensor:
    """f32 planes [..., H, W] -> [..., N, 8] through the f32 cols view,
    with cached (default) or fresh final norms."""
    *lead, h, w = planes.shape
    view = probe_cuda.cols_view(planes.reshape(-1, h, w).to(torch.float32))
    s = probe_cuda.spectrum_probe(view, sweeps, layout="cols", cached=cached)
    return s.reshape(*lead, s.shape[-2], s.shape[-1])


def main() -> list:
    dev = common.require_cuda()
    card = common.card_line()
    gen = torch.Generator(device=dev).manual_seed(0)
    planes = torch.randn((common.PLANES, common.H, common.W), generator=gen,
                         device=dev) * 40 + 128
    rows = []
    for cached in (False, True):
        rows.append(common.emit(
            "T5", f"spectrum {'cached' if cached else 'fresh'} s{SWEEPS}",
            card, shape=list(planes.shape),
            ms=common.cuda_ms(
                lambda c=cached: spectrum_cached(planes, SWEEPS, c))))
    s_fresh = spectrum_cached(planes, SWEEPS, cached=False)
    s_cached = spectrum_cached(planes, SWEEPS)
    rel = (s_cached - s_fresh).abs() / (s_fresh[..., :1] + 1e-9)
    rows.append(common.emit(
        "T5", f"cached vs fresh rel dev s{SWEEPS}", card,
        shape=list(planes.shape), rel_dev_mean=float(rel.mean()),
        rel_dev_max=float(rel.max())))
    return rows


if __name__ == "__main__":
    main()
