"""Device time of the CUDA kernels a callable launches, under torch.profiler.

Shared by ``chip_smoke.py``, ``chip_ab.py`` and ``chip_ablation.py``; it
imports nothing of the port, so ``chip_ab.py`` can time a parent commit's
package with it.
"""

from __future__ import annotations

import time

import torch


def kernel_times(prof, steps: int) -> dict[str, float]:
    """{kernel name: device ms per step} from a finished ``torch.profiler``
    window over ``steps`` calls.  The device events are read from the
    profiler's raw results, ``prof.profiler.kineto_results`` (not public
    API; as of torch 2.11): ``key_averages()`` would first build a Python
    event tree of every CPU op too, which takes 10-30 s a window for a train
    step's ~10,000 launches and measures nothing more.
    ``tests/test_torch_cuda.py`` holds this sum to ``key_averages()``'s on
    the card, so that a torch whose raw results differ fails there."""
    per: dict[str, float] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue                     # CPU ops: their kernels are listed themselves
        per[e.name()] = per.get(e.name(), 0.0) + e.duration_ns() / 1e6 / steps
    return per


def device_busy(fn, steps: int = 3, tries: int = 3) -> tuple[float, float, list]:
    """(wall ms/step, kernel ms/step, [(kernel, ms/step), ...] largest first)
    from torch.profiler over ``steps`` calls after one call and a
    synchronize: the device time of every CUDA kernel (``kernel_times``),
    summed (one stream: kernels do not overlap).  The profiler now and then
    records no device event; such a window is retried, up to ``tries``
    windows, and a kernel time of 0 means that none recorded one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3 / steps
        per = kernel_times(prof, steps)
        if sum(per.values()) > 0:
            break
    top = sorted(per.items(), key=lambda kv: -kv[1])
    return wall, sum(per.values()), top
