"""Profiling helpers: device traces, a samples/s meter, FLOP counts.

Port of the JAX package's ``utils/profiling.py``:
- ``trace`` wraps ``torch.profiler`` (CPU and, where present, CUDA
  activity) and writes a Chrome trace file into ``logdir`` (view it in
  Perfetto or chrome://tracing);
- ``Throughput`` is the same running samples/s meter;
- ``flops_of`` counts a call's FLOPs with
  ``torch.utils.flop_counter.FlopCounterMode`` (2 per multiply-add of the
  matmuls and convolutions, forward and, if the call differentiates,
  backward), in place of XLA's cost analysis.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block: ``with trace('out/trace') as prof: step()``; on
    exit ``<logdir>/trace.json`` holds the Chrome trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Throughput:
    """Running samples/s with warmup skip (reference evaluate_2D.py:229-231
    skips the first 20 batches before timing)."""

    def __init__(self, warmup_batches: int = 20):
        self.warmup = warmup_batches
        self.n_batches = 0
        self.n_samples = 0
        self.t0: Optional[float] = None

    def update(self, batch_size: int) -> None:
        self.n_batches += 1
        if self.n_batches == self.warmup:
            self.t0 = time.perf_counter()
            self.n_samples = 0
        elif self.n_batches > self.warmup:
            self.n_samples += batch_size

    @property
    def samples_per_sec(self) -> float:
        if self.t0 is None or self.n_samples == 0:
            return 0.0
        return self.n_samples / max(time.perf_counter() - self.t0, 1e-9)


def flops_of(fn: Callable, *args) -> float:
    """FLOPs of one call ``fn(*args)``, counted by torch's FLOP counter."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())
