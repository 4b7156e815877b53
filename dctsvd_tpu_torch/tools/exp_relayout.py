"""T1: the spectrum of f32 natural-layout planes, relaid inside the kernel
(the port of ``tools/exp_relayout.py``).

The JAX tool tries three Mosaic spellings of one in-kernel relayout of a
natural window [R·8, W]: ``slice2d`` (strided lane slices ``x2d[:, c::8]``)
and ``laxslice`` (the same through ``lax.slice``) gather column c of every
block from each 8th element; ``transpose`` relays the window as a whole
(``swapaxes(x.reshape(R, 8, Wb, 8), -1, -2)``) before the Jacobi. On the
GPU that is two forms of the spectrum probe: ``'strided'`` stands for
slice2d and laxslice (each thread reads its block by stride, as K1 does),
``'smem'`` for transpose (each warp copies its 32 blocks' pixel rows
coalesced into shared memory of its own, and each thread takes its block
from there).

    python -m dctsvd_tpu_torch.tools.exp_relayout

Rows (96 f32 planes of 1080×1920, s3): K1 on the natural planes (the
shipped kernel) and each form, with its distance from K1.
"""

from __future__ import annotations

import torch

from dctsvd_tpu_torch.ops import probe_cuda, wm_cuda
from dctsvd_tpu_torch.tools import common

FORMS = ("strided", "smem")
JAX_FORMS = {"slice2d": "strided", "laxslice": "strided", "transpose": "smem"}


def spectrum_nat(planes: torch.Tensor, sweeps: int = 3,
                 form: str = "strided") -> torch.Tensor:
    """[..., H, W] -> [..., N, 8] through the probe on the natural layout."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; expected one of {FORMS}")
    *lead, h, w = planes.shape
    s = probe_cuda.spectrum_probe(planes.reshape(-1, h, w).to(torch.float32),
                                  sweeps, layout=form)
    return s.reshape(*lead, s.shape[-2], s.shape[-1])


def main() -> list:
    dev = common.require_cuda()
    card = common.card_line()
    gen = torch.Generator(device=dev).manual_seed(0)
    chans = torch.randn((common.BATCH, 3, common.H, common.W), generator=gen,
                        device=dev) * 40 + 128
    small = chans[:1, :1, :24, :64]
    ref_small = wm_cuda.spectrum_blocks(small, sweeps=3)
    k1 = wm_cuda.spectrum_blocks(chans, sweeps=3)
    rows = [common.emit(
        "T1", "spectrum K1 (natural, by stride) s3", card,
        shape=list(chans.shape),
        ms=common.cuda_ms(lambda: wm_cuda.spectrum_blocks(chans, sweeps=3)))]
    for form in FORMS:
        got = spectrum_nat(chans, 3, form)
        rows.append(common.emit(
            "T1", f"spectrum natural/{form} s3", card,
            shape=list(chans.shape),
            small_max_abs_err=float(
                (spectrum_nat(small, 3, form) - ref_small).abs().max()),
            max_abs_err_vs_k1=float((got - k1).abs().max()),
            ms=common.cuda_ms(lambda form=form: spectrum_nat(chans, 3, form))))
    return rows


if __name__ == "__main__":
    main()
