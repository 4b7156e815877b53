"""T3: the f32 instruction rate of the card on the Jacobi body's value
shape (the port of ``tools/exp_vpu_roofline.py``).

A chain of ``acc·1.0000001 + x`` per element of [96, 135, 8, 240] f32: 8
independent chains (``'ilp8'``, the throughput ceiling) or one dependent
chain (``'serial'``, the latency floor), at 256 and 1024 counted
operations per element, each as separate multiplies and adds (unfused:
what every kernel built with ``-fmad=false`` executes) and as one FMA per
update (fused: the arithmetic behind the data sheet's 67 TFLOP/s).
Operations are counted as the JAX tool counts them
(:func:`~dctsvd_tpu_torch.ops.probe_cuda.chain_steps`); each row gives
the element-op rate and its share of that peak.

    python -m dctsvd_tpu_torch.tools.exp_vpu_roofline
"""

from __future__ import annotations

import torch

from dctsvd_tpu_torch.ops import probe_cuda
from dctsvd_tpu_torch.tools import common

N_OPS = (256, 1024)


def run(planes: torch.Tensor, mode: str, n_ops: int,
        fused: bool = False) -> torch.Tensor:
    return probe_cuda.fma_chain(planes, n_ops, mode, fused)


def main() -> list:
    dev = common.require_cuda()
    card = common.card_line()
    gen = torch.Generator(device=dev).manual_seed(0)
    planes = torch.randn((common.PLANES, common.H // 8, 8, common.W // 8),
                         generator=gen, device=dev)
    rows = []
    for mode in probe_cuda.CHAIN_MODES:
        for n_ops in N_OPS:
            for fused in (False, True):
                _, ops = probe_cuda.chain_steps(mode, n_ops)
                ms = common.cuda_ms(
                    lambda m=mode, n=n_ops, f=fused: run(planes, m, n, f))
                rate = planes.numel() * ops / (ms * 1e-3)
                rows.append(common.emit(
                    "T3", f"{mode} n_ops={n_ops} "
                    f"{'fused' if fused else 'unfused'}", card,
                    shape=list(planes.shape), ops_per_element=ops, ms=ms,
                    elem_ops_per_s=rate,
                    share_of_peak_f32=rate / common.PEAK_F32))
    return rows


if __name__ == "__main__":
    main()
