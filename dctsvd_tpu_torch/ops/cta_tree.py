"""The fixed order in which a CTA of 256 threads adds its partial sums,
shared by K9 (``csrc/detect.cu``) and K18 (``csrc/presence.cu``), for
their plain twins: each warp's 32 lanes halved at shuffle offsets 16, 8,
4, 2, 1, then the 8 warp sums at 4, 2, 1."""

from __future__ import annotations

import torch

#: a CTA's threads (csrc/detect.cu kBandThreads, csrc/presence.cu
#: kPresThreads): the lanes of the twins' walks and tree
THREADS = 256
WARP = 32


def tree(x: torch.Tensor) -> torch.Tensor:
    """[..., THREADS] -> [...]: the kernels' fixed tree."""
    x = x.reshape(*x.shape[:-1], THREADS // WARP, WARP)
    for width in (WARP, THREADS // WARP):
        o = width // 2
        while o:
            x = x[..., :o] + x[..., o:2 * o]
            o //= 2
        x = x[..., 0]
    return x
