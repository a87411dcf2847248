"""Config-driven 2D and 3D loss assembly for the train and eval steps.

Port of the JAX package's ``core/loss_computer.py`` (the reference's
``AverageMeter.computeLosses``, lib/core/function.py:1319-1378): model
outputs and batch targets -> ``(total, {name: value})`` with the
``LOSS.*_FACTOR`` weights, under the JAX package's keys.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import losses as L


class LossComputer2D:
    """2D losses: heatmap (or OHKM) / pose2d / bone / joint angle.

    ``count_sum`` (a data-parallel step's ``parallel/distributed.sum_counts``)
    makes every value this rank's share of the loss over the global batch
    (``core/losses.py``); the shares sum to the global losses."""

    def __init__(self, cfg, count_sum: L.CountSum = None):
        self.count_sum = count_sum
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
                                            topk=self.topk, count_sum=self.count_sum)
            else:
                hl = L.heatmap_loss(heatmaps_pred, heatmaps_gt, count_sum=self.count_sum)
            out["heatmap_loss"] = hl
            total = total + self.f_heatmap * hl

        if self.with_pose2d:
            pl = L.joints_mse_loss(pose2d_pred[..., 0:2], pose2d_gt[..., 0:2], visibility,
                                   count_sum=self.count_sum)
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


class LossComputer3D:
    """3D losses: pose3d + volumetric CE + KCS, with the 2D terms of
    ``LossComputer2D`` (reference function3D.py:159-198).  ``count_sum``
    as ``LossComputer2D``'s: every value this rank's share."""

    def __init__(self, cfg, count_sum: L.CountSum = None):
        lc = cfg.LOSS
        self.count_sum = count_sum
        self.loss2d = LossComputer2D(cfg, count_sum=count_sum)
        self.with_pose3d = bool(lc.WITH_POSE3D_LOSS)
        self.with_vce = bool(lc.WITH_VOLUMETRIC_CE_LOSS)
        self.with_kcs = bool(lc.WITH_KCS_LOSS)
        self.f_pose3d = float(lc.POSE3D_LOSS_FACTOR)
        self.f_vce = float(lc.VOLUMETRIC_LOSS_FACTOR)
        self.f_kcs = float(lc.KCS_LOSS_FACTOR)

    def __call__(self, pose3d_pred: Optional[torch.Tensor] = None,
                 pose3d_gt: Optional[torch.Tensor] = None,
                 coord_volumes: Optional[torch.Tensor] = None,
                 volumes_pred: Optional[torch.Tensor] = None,
                 validity: Optional[torch.Tensor] = None,
                 **loss2d_kwargs) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if loss2d_kwargs:
            total, out = self.loss2d(**loss2d_kwargs)
        else:
            device = next(t.device for t in (pose3d_pred, volumes_pred) if t is not None)
            total, out = torch.zeros((), dtype=torch.float32, device=device), {}

        if self.with_pose3d and pose3d_pred is not None:
            p3 = L.joints_3d_mse_loss(pose3d_pred, pose3d_gt)
            out["pose3d_loss"] = p3
            total = total + self.f_pose3d * p3

        if self.with_vce and volumes_pred is not None:
            v = L.volumetric_ce_loss(coord_volumes, volumes_pred, pose3d_gt, validity,
                                     count_sum=self.count_sum)
            out["volumetric_ce_loss"] = v
            total = total + self.f_vce * v

        if self.with_kcs and pose3d_pred is not None:
            k = L.kcs_loss(pose3d_pred, pose3d_gt, count_sum=self.count_sum)
            out["kcs_loss"] = k
            total = total + self.f_kcs * k

        out["total_loss"] = total
        return total, out
