"""Training metrics: ``AverageMeter`` (port of the JAX package's
``core/metrics.py:96-114``).  PCK, AUC and EPE are not ported yet."""

from __future__ import annotations

from typing import Dict


class AverageMeter:
    """Running scalar averages for the training loop (reference
    core/function.py:1272-1316).  Host-side, tiny."""

    def __init__(self):
        self.sums: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def update(self, values: Dict[str, float], n: int = 1) -> None:
        for k, v in values.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v) * n
            self.counts[k] = self.counts.get(k, 0) + n

    def averages(self) -> Dict[str, float]:
        return {k: self.sums[k] / max(self.counts[k], 1) for k in self.sums}

    def reset(self) -> None:
        self.sums.clear()
        self.counts.clear()
