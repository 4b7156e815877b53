"""T6: the cost of the cols-view relayout around a spectrum kernel (the
port of ``tools/profile_view.py``).

Rows at s4 on 96 f32 planes of 1080×1920: the relayout plus the spectrum
probe on the view; the probe on a view made beforehand; the relayout
alone, forced through the copy kernel; and K1 on the natural planes,
which reads each block by stride with no relayout (the reference row).

    python -m dctsvd_tpu_torch.tools.profile_view
"""

from __future__ import annotations

import torch

from dctsvd_tpu_torch.ops import probe_cuda, wm_cuda
from dctsvd_tpu_torch.tools import common

SWEEPS = 4


def call_kernel(view: torch.Tensor) -> torch.Tensor:
    return probe_cuda.spectrum_probe(view, SWEEPS, layout="cols")


def with_transpose(chans: torch.Tensor) -> torch.Tensor:
    h, w = chans.shape[-2:]
    return call_kernel(probe_cuda.cols_view(chans.reshape(-1, h, w)))


def transpose_forced(chans: torch.Tensor) -> torch.Tensor:
    h, w = chans.shape[-2:]
    return probe_cuda.copy_f32(probe_cuda.cols_view(chans.reshape(-1, h, w)))


def k1_natural(chans: torch.Tensor) -> torch.Tensor:
    return wm_cuda.spectrum_blocks(chans, sweeps=SWEEPS)


def main() -> list:
    dev = common.require_cuda()
    card = common.card_line()
    gen = torch.Generator(device=dev).manual_seed(0)
    chans = torch.randn((common.BATCH, 3, common.H, common.W), generator=gen,
                        device=dev) * 50 + 128
    view = probe_cuda.cols_view(chans.reshape(-1, common.H, common.W))
    k1 = k1_natural(chans).reshape(view.shape[0], -1, 8)
    rows = []
    for name, fn, x in (
            (f"spectrum kernel + in-transpose s{SWEEPS}", with_transpose,
             chans),
            (f"spectrum kernel, pre-transposed input s{SWEEPS}", call_kernel,
             view),
            ("transpose alone (forced via copy kernel)", transpose_forced,
             chans),
            (f"K1 on the natural planes s{SWEEPS}", k1_natural, chans)):
        out = fn(x)
        check = (dict(equals_view=bool(torch.equal(out, view)))
                 if fn is transpose_forced else dict(max_abs_err_vs_k1=float(
                     (out.reshape(k1.shape) - k1).abs().max())))
        rows.append(common.emit(
            "T6", name, card, shape=list(chans.shape), **check,
            ms=common.cuda_ms(lambda fn=fn, x=x: fn(x))))
    return rows


if __name__ == "__main__":
    main()
