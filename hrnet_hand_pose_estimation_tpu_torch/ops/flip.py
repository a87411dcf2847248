"""Horizontal-flip utilities for flip-test TTA and joint augmentation.

Port of the JAX package's ``ops/flip.py:17-55`` (reference
lib/utils/transforms.py:16-47) on NHWK heatmaps and (..., K, 2) joints.
The hand legend has no left/right pairs, so the pair swap is usually a
no-op; the mechanism stays for datasets that define pairs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _perm(k: int, matched_parts: Sequence[Tuple[int, int]]) -> list[int]:
    perm = list(range(k))
    for a, b in matched_parts:
        perm[a], perm[b] = perm[b], perm[a]
    return perm


def flip_back(heatmaps: torch.Tensor,
              matched_parts: Sequence[Tuple[int, int]] = ()) -> torch.Tensor:
    """Un-flip (B, H, W, K) heatmaps predicted on a horizontally flipped input."""
    out = heatmaps.flip(2)
    if matched_parts:
        out = out[..., _perm(out.shape[-1], matched_parts)]
    return out


def shift_heatmap(heatmaps: torch.Tensor) -> torch.Tensor:
    """1-px right shift after flip-back when TEST.SHIFT_HEATMAP is on
    (reference core/function.py:695-699 copies columns 0..W-2 into 1..W-1)."""
    return torch.cat([heatmaps[:, :, :1, :], heatmaps[:, :, :-1, :]], dim=2)


def fliplr_joints(joints: torch.Tensor, joints_vis: torch.Tensor, width: int,
                  matched_parts: Sequence[Tuple[int, int]] = ()
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flip 2D joints horizontally: u -> width - u - 1, swap paired joints,
    zero invisible entries (reference transforms.py:33-47)."""
    joints = joints.clone()
    joints[..., 0] = width - joints[..., 0] - 1.0
    if matched_parts:
        perm = _perm(joints.shape[-2], matched_parts)
        joints = joints[..., perm, :]
        joints_vis = (joints_vis[..., perm, :] if joints_vis.dim() == joints.dim()
                      else joints_vis[..., perm])
    return joints * joints_vis, joints_vis
