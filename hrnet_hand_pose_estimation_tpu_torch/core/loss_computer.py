"""Config-driven 2D loss assembly for the train and eval steps.

Port of the JAX package's ``core/loss_computer.py:18-76`` (the reference's
``AverageMeter.computeLosses``, lib/core/function.py:1319-1378): model
outputs and batch targets -> ``(total, {name: value})`` with the
``LOSS.*_FACTOR`` weights, under the JAX package's keys.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import losses as L


class LossComputer2D:
    """2D losses: heatmap (or OHKM) / pose2d / bone / joint angle."""

    def __init__(self, cfg):
        lc = cfg.LOSS
        self.with_heatmap = bool(lc.WITH_HEATMAP_LOSS)
        self.with_pose2d = bool(lc.WITH_POSE2D_LOSS)
        self.with_bone = bool(lc.WITH_BONE_LOSS)
        self.with_jointangle = bool(lc.WITH_JOINTANGLE_LOSS)
        self.use_ohkm = bool(lc.USE_OHKM)
        self.topk = int(lc.TOPK)
        self.f_heatmap = float(lc.HEATMAP_LOSS_FACTOR)
        self.f_pose2d = float(lc.POSE2D_LOSS_FACTOR)
        self.f_bone = float(lc.BONE_LOSS_FACTOR)
        self.f_jointangle = float(lc.JOINTANGLE_LOSS_FACTOR)

    def __call__(self, heatmaps_pred: Optional[torch.Tensor] = None,
                 heatmaps_gt: Optional[torch.Tensor] = None,
                 pose2d_pred: Optional[torch.Tensor] = None,
                 pose2d_gt: Optional[torch.Tensor] = None,
                 visibility: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        device = next(t.device for t in (heatmaps_pred, pose2d_pred) if t is not None)
        total = torch.zeros((), dtype=torch.float32, device=device)
        out: Dict[str, torch.Tensor] = {}

        if self.with_heatmap:
            if self.use_ohkm:
                hl = L.joints_ohkm_mse_loss(heatmaps_pred, heatmaps_gt, visibility,
                                            topk=self.topk)
            else:
                hl = L.heatmap_loss(heatmaps_pred, heatmaps_gt)
            out["heatmap_loss"] = hl
            total = total + self.f_heatmap * hl

        if self.with_pose2d:
            pl = L.joints_mse_loss(pose2d_pred[..., 0:2], pose2d_gt[..., 0:2], visibility)
            out["pose2d_loss"] = pl
            total = total + self.f_pose2d * pl

        if self.with_bone or self.with_jointangle:
            # wrist-centred, middle-finger-normalised poses (reference
            # function.py:1352-1373 via scale_pose2d)
            rel_pred = L.scale_pose(pose2d_pred[..., 0:2])
            rel_gt = L.scale_pose(pose2d_gt[..., 0:2])
            if self.with_bone:
                bl = L.bone_length_loss(rel_pred, rel_gt)
                out["bone_loss"] = bl
                total = total + self.f_bone * bl
            if self.with_jointangle:
                jl = L.joint_angle_loss(rel_pred)
                out["jointangle_loss"] = jl
                total = total + self.f_jointangle * jl

        out["total_loss"] = total
        return total, out
