"""What every probe's ``main()`` shares: the card check, the card line,
CUDA-event timing and the one JSON line per row.

A probe measures the card and nothing else: :func:`require_cuda` raises
where there is none, so a CPU time is never printed as a probe result.
"""

from __future__ import annotations

import json
import subprocess

import torch

H, W, BATCH = 1080, 1920, 32     # the probes' own size: 1080p, batch 32
PLANES = 3 * BATCH               # color planes of the batch
# The H100 SXM's data sheet: f32 outside the tensor cores, and HBM3.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def require_cuda() -> torch.device:
    """The current CUDA device, or RuntimeError where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes measure the GPU: no CUDA device "
                           "(torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls after one
    warm-up, between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def gbps(moved: int, ms: float) -> dict:
    """The rate of ``moved`` bytes in ``ms`` and its share of the HBM
    peak."""
    rate = moved / (ms * 1e-3)
    return dict(bytes=moved, gb_per_s=rate / 1e9,
                share_of_peak_bytes=rate / PEAK_BYTES)


def emit(probe: str, row: str, card: str, **fields) -> dict:
    """Print one row as a JSON line and return it."""
    out = dict(probe=probe, row=row, **fields, card=card)
    print(json.dumps(out), flush=True)
    return out
