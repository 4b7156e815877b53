"""Tracing, profiling and throughput observability (counterpart of
``dctsvd_tpu/utils/profiling.py``).

  - :func:`trace` — context manager around ``torch.profiler`` writing a
    Chrome trace (viewable in Perfetto) of any pipeline section
    (CLI: ``--profile DIR``).
  - :class:`StageTimer` — wall time per named stage, synchronising the
    GPU at stage boundaries so numbers mean what they say under
    asynchronous launches.
  - :class:`Throughput` — frames/s counters for the video streamer.

The JAX package's ``enable_debug_checks`` (``jax_debug_nans`` /
``jax_debug_infs``) has no PyTorch counterpart and is not ported.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

logger = logging.getLogger("dctsvd_tpu_torch")


def setup_logging(level: int = logging.INFO,
                  structured: bool = False) -> None:
    handler = logging.StreamHandler()
    if structured:
        class _Json(logging.Formatter):
            def format(self, rec):
                return json.dumps({
                    "t": round(rec.created, 3), "lvl": rec.levelname,
                    "msg": rec.getMessage(), "mod": rec.module})
        handler.setFormatter(_Json())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(level)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the CPU, and of CUDA when a GPU is
    present, written as a Chrome trace JSON into ``log_dir``; a no-op for
    None. Yields the profiler (None for None), whose ``key_averages()``
    are read after the block."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_"
                                 f"{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


@dataclass
class StageTimer:
    """Accumulates wall time per stage; ``stage(...)`` synchronises the GPU
    at exit (once CUDA is initialised) so asynchronous launches are
    charged to the stage that issued them. A CUDA error raised by the
    synchronise propagates."""
    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 4),
                    "calls": self.counts[k],
                    "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3)}
                for k, v in self.totals.items()}


@dataclass
class Throughput:
    """Frames/sec counter with periodic logging."""
    name: str = "frames"
    log_every: int = 100
    _n: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    def add(self, n: int = 1):
        self._n += n
        if self.log_every and self._n % self.log_every == 0:
            logger.info("%s: %d processed, %.1f/s", self.name, self._n,
                        self.rate())

    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._n / dt if dt > 0 else 0.0
