"""The traced window: ``torch.profiler`` over a fixed number of units, and
its reduction to device intervals, kernel times by name and idle gaps by
what the host was doing.

Device time is the union of the intervals in which a kernel, a copy or a
memset ran (so two streams that overlap count once); the window is the
host clock from a synchronize before the first unit to a synchronize after
the last.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


SPAN_PREFIX = "bench."


class DeviceEvent(NamedTuple):
    name: str
    start_us: float
    end_us: float


class TraceSummary(NamedTuple):
    window_s: float                 # host clock, synchronize to synchronize
    device: List[DeviceEvent]       # every kernel, copy and memset
    host: List[DeviceEvent]         # every host-side event (ops, runtime calls, spans)
    units: int                      # units of work inside the window

    def busy_s(self) -> float:
        """Seconds in which anything ran on the device (union of intervals)."""
        return sum(e - s for s, e in merged(self.device)) * 1e-6

    def kernel_s(self, pattern: str) -> Optional[float]:
        """Summed seconds of the device events whose name matches the regex
        ``pattern``; None where none does."""
        rx = re.compile(pattern)
        hits = [e.end_us - e.start_us for e in self.device if rx.search(e.name)]
        return sum(hits) * 1e-6 if hits else None

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for e in self.device:
            key = short(e.name)
            by[key] = by.get(key, 0.0) + (e.end_us - e.start_us) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, probe: int = 64) -> List[List]:
        """Idle seconds between device intervals, summed by the innermost
        host event under each gap's middle (the ``probe`` longest gaps
        looked at), the ``n`` largest sums."""
        ivs = merged(self.device)
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(ivs, ivs[1:]) if b[0] > a[1]]
        gaps.sort(reverse=True)
        if not gaps or not self.host:
            return []
        starts = np.array([h.start_us for h in self.host])
        ends = np.array([h.end_us for h in self.host])
        by: Dict[str, float] = {}
        for length, g0, g1 in gaps[:probe]:
            mid = 0.5 * (g0 + g1)
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if hit.size:
                inner = hit[np.argmin(ends[hit] - starts[hit])]
                key = short(self.host[inner].name)
            else:
                key = "(no host event)"
            by[key] = by.get(key, 0.0) + length * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def merged(events: Sequence[DeviceEvent]) -> List[Tuple[float, float]]:
    ivs = sorted((e.start_us, e.end_us) for e in events)
    out: List[List[float]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def traced(run_units, units: int, device: torch.device) -> TraceSummary:
    """Run ``run_units(units)`` under the profiler and reduce its trace."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    with profile(activities=acts, acc_events=True) as prof:
        sync()
        t0 = time.perf_counter()
        run_units(units)
        sync()
        window = time.perf_counter() - t0
    dev: List[DeviceEvent] = []
    host: List[DeviceEvent] = []
    for evt in prof.events():
        tr = evt.time_range
        item = DeviceEvent(evt.name, float(tr.start), float(tr.end))
        if getattr(evt, "is_user_annotation", False) or evt.name.startswith(SPAN_PREFIX):
            # a span's shadow on the device timeline is no device work
            host.append(item)
        elif evt.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(item)
        else:
            host.append(item)
    return TraceSummary(window, dev, host, units)
