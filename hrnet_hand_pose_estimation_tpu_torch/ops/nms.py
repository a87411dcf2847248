"""Box and keypoint NMS, in PyTorch.

Port of the JAX package's ``ops/nms.py`` (the reference's native NMS stack:
lib/nms/cpu_nms.pyx greedy IoU NMS, nms_kernel.cu, nms/nms.py:17-60 with
``soft_nms``, and the OKS-NMS of the COCO evaluation in
lib/dataset/coco.py).  The keep masks and the rescored boxes are JAX's.

The pairwise IoU / OKS matrix is computed on the input's device.  Greedy
NMS is a serial scan: JAX runs it as a ``lax.fori_loop`` over the rows of
the sorted matrix; run eagerly on a card, that loop is four launches a
row, so the port compares the whole matrix with the threshold on the
device and runs the scan over that boolean matrix on the host (the same
keep mask: the scan is pure logic on the same comparisons).  Soft-NMS
rescores with a data-dependent argmax each round and stays a loop on the
device.  The JAX package reaches no Pallas kernel here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (N, 4) [x1, y1, x2, y2] boxes (the +1 area
    convention of the reference cpu_nms.pyx)."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    xx1 = torch.maximum(x1[:, None], x1[None, :])
    yy1 = torch.maximum(y1[:, None], y1[None, :])
    xx2 = torch.minimum(x2[:, None], x2[None, :])
    yy2 = torch.minimum(y2[:, None], y2[None, :])
    w = torch.clamp(xx2 - xx1 + 1, min=0.0)
    h = torch.clamp(yy2 - yy1 + 1, min=0.0)
    inter = w * h
    return inter / (area[:, None] + area[None, :] - inter)


def _greedy_keep(scores: torch.Tensor, sim: torch.Tensor, thresh: float) -> torch.Tensor:
    """The keep mask (N,) bool, in the input order, of the greedy scan in
    descending score order (stable on ties, as ``jnp.argsort``): a kept
    candidate suppresses every later one whose similarity exceeds
    ``thresh``."""
    order = torch.argsort(-scores, stable=True)
    over = (sim[order][:, order] > thresh).cpu().numpy()
    n = over.shape[0]
    keep = np.ones(n, bool)
    for i in range(n):
        if keep[i]:
            keep[i + 1:] &= ~over[i, i + 1:]
    out = torch.zeros(n, dtype=torch.bool, device=scores.device)
    out[order] = torch.from_numpy(keep).to(scores.device)
    return out


def nms(dets: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy IoU NMS (reference nms/nms.py:34-60).  dets: (N, 5) [x1, y1,
    x2, y2, score] -> keep mask (N,) bool, the reference's index list as a
    mask."""
    return _greedy_keep(dets[:, 4], iou_matrix(dets[:, :4]), thresh)


def soft_nms(dets: torch.Tensor, sigma: float = 0.5, score_thresh: float = 0.001,
             method: str = "gaussian") -> torch.Tensor:
    """Soft-NMS (reference cpu_soft_nms): the scores of overlapping boxes
    decay (``gaussian``, or ``linear`` above IoU 0.3) instead of the boxes
    being removed.  Returns the rescored dets (N, 5)."""
    n = dets.shape[0]
    boxes, scores = dets[:, :4], dets[:, 4]
    ious = iou_matrix(boxes)
    one = torch.ones((), dtype=scores.dtype, device=scores.device)
    for _ in range(n):
        # the current maximum among the live scores (the order emerges as it goes)
        m = torch.argmax(scores)
        ov = ious[m]
        if method == "gaussian":
            decay = torch.exp(-(ov * ov) / sigma)
        else:
            decay = torch.where(ov > 0.3, 1.0 - ov, one)
        decay = decay.index_fill(0, m[None], 1.0)
        # freeze the picked box by negating it; only live scores decay
        new = torch.where(scores > 0, scores * decay, scores)
        scores = new.index_put((m[None],), -scores[m][None])
    final = torch.where(scores < 0, -scores, scores)
    final = torch.where(final > score_thresh, final, torch.zeros_like(final))
    return torch.cat([boxes, final[:, None]], dim=1)


# the 17 published COCO keypoint sigmas (reference nms/nms.py:77)
COCO_SIGMAS = (0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72,
               0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89, 0.89)
COCO_SIGMAS = tuple(s / 10.0 for s in COCO_SIGMAS)


def oks_matrix(kpts: torch.Tensor, areas: torch.Tensor,
               sigmas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pairwise object-keypoint similarity (COCO OKS).  kpts: (N, K, 3)
    [x, y, visibility]; areas: (N,)."""
    k = kpts.shape[1]
    if sigmas is None:
        sigmas = (torch.tensor(COCO_SIGMAS, dtype=kpts.dtype, device=kpts.device) if k == 17
                  else torch.full((k,), 0.05, dtype=kpts.dtype, device=kpts.device))
    var = (2 * sigmas) ** 2
    dx = kpts[:, None, :, 0] - kpts[None, :, :, 0]
    dy = kpts[:, None, :, 1] - kpts[None, :, :, 1]
    e = (dx ** 2 + dy ** 2) / var[None, None] / (
        (areas[:, None, None] + areas[None, :, None]) / 2 + 1e-12) / 2.0
    vis = (kpts[:, :, 2] > 0).to(kpts.dtype)
    both = vis[:, None, :] * vis[None, :, :]
    return (torch.exp(-e) * both).sum(-1) / torch.clamp(both.sum(-1), min=1)


def oks_nms(kpts: torch.Tensor, scores: torch.Tensor, areas: torch.Tensor, thresh: float,
            sigmas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy OKS-NMS keep mask (N,) bool (the reference coco.py's OKS-NMS)."""
    return _greedy_keep(scores, oks_matrix(kpts, areas, sigmas), thresh)
