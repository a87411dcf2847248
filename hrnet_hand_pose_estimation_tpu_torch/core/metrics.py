"""Evaluation metrics: EPE / PCK / AUC accumulators and loss averaging.

Port of the JAX package's ``core/metrics.py``, which replicates the
reference's evaluation protocol:

- per-joint EPE = sum of visibility-masked L2 errors / per-joint visible
  count (reference tools/evaluate_2D.py:268-271,283);
- PCK@t counts ``error < t`` over all visible joints (:272-274), thresholds
  1..49 px for 2D and 1..50 mm for 3D (evaluate_3D.py);
- AUC is the trapezoid of the PCK curve (lib/utils/misc.py:288); the
  reference's plot slices the curve to its first 30 thresholds before
  integrating (misc.py:281), so ``pck_auc`` takes an explicit range.

The accumulators are float32 tensors, as in the JAX package, and may live
on any device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch


class PoseMetricState(NamedTuple):
    """Running sums for EPE/PCK accumulation (2D or 3D)."""

    err_sum: torch.Tensor     # (K,) visibility-masked error sums
    vis_sum: torch.Tensor     # (K,) visible counts
    pck_sum: torch.Tensor     # (T,) counts of error < threshold over all joints

    @classmethod
    def create(cls, num_joints: int, thresholds: torch.Tensor, device="cpu") -> "PoseMetricState":
        return cls(
            err_sum=torch.zeros((num_joints,), dtype=torch.float32, device=device),
            vis_sum=torch.zeros((num_joints,), dtype=torch.float32, device=device),
            pck_sum=torch.zeros((len(thresholds),), dtype=torch.float32, device=device),
        )

    def update(self, pred: torch.Tensor, gt: torch.Tensor, visibility: torch.Tensor,
               thresholds: torch.Tensor) -> "PoseMetricState":
        """pred/gt: (B, K, D); visibility: (B, K)."""
        vis = visibility.float()
        err = torch.linalg.vector_norm(pred.float() - gt.float(), dim=2) * vis
        th = thresholds.to(err.device, torch.float32)
        pck = ((err[None, :, :] < th[:, None, None]) * vis[None, :, :]).sum(dim=(1, 2))
        return PoseMetricState(
            err_sum=self.err_sum + err.sum(dim=0),
            vis_sum=self.vis_sum + vis.sum(dim=0),
            pck_sum=self.pck_sum + pck,
        )

    def merge(self, other: "PoseMetricState") -> "PoseMetricState":
        return PoseMetricState(*(a + b for a, b in zip(self, other)))

    # -- results ------------------------------------------------------------
    def epe_per_joint(self) -> np.ndarray:
        return self.err_sum.cpu().numpy() / np.maximum(self.vis_sum.cpu().numpy(), 1e-12)

    def epe_mean(self) -> float:
        return float(self.epe_per_joint().mean())

    def pck_curve(self) -> np.ndarray:
        return self.pck_sum.cpu().numpy() / max(float(self.vis_sum.sum()), 1e-12)


def default_thresholds_2d() -> torch.Tensor:
    """1..49 px (reference tools/evaluate_2D.py:167)."""
    return torch.arange(1, 50, dtype=torch.float32)


def default_thresholds_3d() -> torch.Tensor:
    """1..50 mm (reference tools/evaluate_3D.py)."""
    return torch.arange(1, 51, dtype=torch.float32)


def pck_auc(pck: np.ndarray, thresholds, start: int = 0, end: int | None = 30) -> float:
    """Trapezoid AUC of the PCK curve (reference misc.py:288).

    The reference slices to the first 30 thresholds before integrating
    (misc.py:281); pass ``end=None`` for the full curve.
    """
    pck = np.asarray(pck)[start:end]
    th = np.asarray(thresholds)[start:end]
    area = (pck[0] + 2.0 * pck[1:-1].sum() + pck[-1]) * (th[1] - th[0]) / 2.0
    return float(area / (th[-1] - th[0]))


def pck_at(pck: np.ndarray, thresholds, value: float) -> float:
    """PCK at a given threshold (e.g. 20 px / 20 mm)."""
    idx = int(np.argmin(np.abs(np.asarray(thresholds) - value)))
    return float(np.asarray(pck)[idx])


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
