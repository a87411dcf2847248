"""Device time of the CUDA kernels a callable launches, under torch.profiler.

Shared by ``chip_smoke.py``, ``chip_ab.py`` and ``chip_ablation.py``; it
imports nothing of the port, so ``chip_ab.py`` can time a parent commit's
package with it.
"""

from __future__ import annotations

import time

import torch


def device_busy(fn, steps: int = 3, tries: int = 3) -> tuple[float, float, list]:
    """(wall ms/step, kernel ms/step, [(kernel, ms/step), ...] largest first)
    from torch.profiler over ``steps`` calls after one call and a
    synchronize: the device time of every CUDA kernel, summed (one stream:
    kernels do not overlap).  The profiler now and then records no device
    event; such a window is retried, up to ``tries`` windows, and a kernel
    time of 0 means that none recorded one."""
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
        per = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue                 # CPU ops: their kernels are listed themselves
            dt = getattr(e, "self_device_time_total", None)
            if dt is None:
                dt = e.self_cuda_time_total
            per[e.key] = per.get(e.key, 0.0) + dt / 1e3 / steps
        if sum(per.values()) > 0:
            break
    top = sorted(per.items(), key=lambda kv: -kv[1])
    return wall, sum(per.values()), top
