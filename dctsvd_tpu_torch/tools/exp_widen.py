"""T4: what the input dtype of the cols view costs (the port of
``tools/exp_widen.py``).

u8 planes are relaid into a u8, bf16 or f32 cols view by the hand-written
cols-view kernel, then the spectrum probe runs on the view: at s0 (the
sorted column norms, the kernel's fixed cost) and at s2. bf16 holds
0..255 exactly, so all three views give the same spectrum.

    python -m dctsvd_tpu_torch.tools.exp_widen
"""

from __future__ import annotations

import torch

from dctsvd_tpu_torch.ops import probe_cuda
from dctsvd_tpu_torch.tools import common

VIEW_DTYPES = (torch.uint8, torch.bfloat16, torch.float32)
SWEEPS = (0, 2)


def spectrum_dtype(planes: torch.Tensor, sweeps: int,
                   view_dtype: torch.dtype) -> torch.Tensor:
    """u8 planes [..., H, W] -> [..., N, 8] through a ``view_dtype`` cols
    view."""
    *lead, h, w = planes.shape
    view = probe_cuda.cols_view(planes.reshape(-1, h, w), view_dtype)
    s = probe_cuda.spectrum_probe(view, sweeps, layout="cols")
    return s.reshape(*lead, s.shape[-2], s.shape[-1])


def main() -> list:
    dev = common.require_cuda()
    card = common.card_line()
    gen = torch.Generator(device=dev).manual_seed(0)
    chans = torch.randint(0, 256, (common.BATCH, 3, common.H, common.W),
                          generator=gen, device=dev, dtype=torch.uint8)
    small = chans[:1, :1, :24, :64]
    a, b, c = (spectrum_dtype(small, 3, d) for d in VIEW_DTYPES)
    planes = chans.reshape(-1, common.H, common.W)
    rows = [common.emit(
        "T4", "small s3: bf16 and f32 views against the u8 view", card,
        shape=list(small.shape),
        bf16_max_abs_err=float((a - b).abs().max()),
        f32_max_abs_err=float((a - c).abs().max()))]
    for d in VIEW_DTYPES:
        view = probe_cuda.cols_view(planes, d)
        view_ms = common.cuda_ms(lambda d=d: probe_cuda.cols_view(planes, d))
        for sweeps in SWEEPS:
            rows.append(common.emit(
                "T4", f"spectrum view={str(d).split('.')[-1]} s{sweeps}",
                card, shape=list(chans.shape),
                ms=common.cuda_ms(
                    lambda s=sweeps, d=d: spectrum_dtype(chans, s, d)),
                view_ms=view_ms,
                spectrum_ms=common.cuda_ms(
                    lambda s=sweeps, v=view: probe_cuda.spectrum_probe(
                        v, s, layout="cols"))))
        del view
    return rows


if __name__ == "__main__":
    main()
