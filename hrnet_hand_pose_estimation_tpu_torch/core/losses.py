"""The 2D losses, in PyTorch.

Port of the JAX package's ``core/losses.py:23-167`` and ``scale_pose``
(:209), themselves the reference's lib/core/loss.py:15-223 without its
per-sample loops.  Each is ``f(pred, target, ...) -> 0-d float32 tensor``
and differentiable.  The reductions are the reference's, unconventional ones
included: heatmap losses sum over H, W and average over B, K; the joint
losses without visibility divide by K, not B*K (loss.py:50).  The 3D losses
(``joints_3d_mse_loss``, ``volumetric_ce_loss``, ``kcs_loss``) are not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.legends import BONE_PARENTS_REF


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as ``jnp.linalg.norm`` computes it."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def heatmap_loss(pred: torch.Tensor, gt: torch.Tensor, mode: str = "l2") -> torch.Tensor:
    """HeatmapLoss (reference loss.py:15-28): per-pixel L2 or L1, summed over
    the plane, averaged over batch*joints.  pred/gt: (B, H, W, K)."""
    pred, gt = pred.float(), gt.float()
    if mode == "l2":
        err = (pred - gt) ** 2
    elif mode == "l1":
        err = torch.abs(pred - gt)
    else:
        raise ValueError(f"unknown heatmap loss mode {mode!r}")
    return torch.mean(torch.sum(err, dim=(1, 2)))


def joints_mse_loss(pose_pred: torch.Tensor, pose_gt: torch.Tensor,
                    visibility: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JointsMSELoss (reference loss.py:30-50): mean Euclidean distance.
    pose_pred/gt: (B, K, D); visibility: (B, K) or None."""
    d = _norm(pose_pred.float() - pose_gt.float())
    if visibility is not None:
        vis = visibility.float()
        return torch.sum(d * vis) / torch.clamp(torch.sum(vis), min=1.0)
    return torch.sum(d) / pose_pred.shape[1]


def joints_mse_smooth_loss(pose_pred: torch.Tensor, pose_gt: torch.Tensor,
                           visibility: Optional[torch.Tensor] = None,
                           threshold: float = 400.0) -> torch.Tensor:
    """JointsMSESmoothLoss (reference loss.py:52-69): squared error, softly
    capped as ``d^0.1 * threshold^0.9`` above the threshold."""
    diff = (pose_gt.float() - pose_pred.float()) ** 2
    if visibility is not None:
        diff = diff * visibility[..., None].float()
    capped = torch.where(diff > threshold, torch.pow(diff, 0.1) * threshold ** 0.9, diff)
    if visibility is not None:
        return torch.sum(capped) / torch.clamp(torch.sum(visibility.float()), min=1.0)
    return torch.sum(capped) / pose_gt.shape[1]


def joints_mae_loss(pose_pred: torch.Tensor, pose_gt: torch.Tensor,
                    visibility: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JointsMAELoss (reference loss.py:71-91)."""
    err = torch.abs(pose_gt.float() - pose_pred.float())
    if visibility is not None:
        vis = visibility.float()
        if vis.dim() == err.dim() - 1:
            vis = vis[..., None]
        return torch.sum(err * vis) / torch.clamp(torch.sum(vis), min=1.0)
    return torch.sum(err) / pose_gt.shape[1]


def joints_ohkm_mse_loss(output: torch.Tensor, target: torch.Tensor,
                         target_weight: Optional[torch.Tensor] = None,
                         topk: int = 8) -> torch.Tensor:
    """Online hard keypoint mining MSE (reference loss.py:93-135): per-joint
    0.5 * MSE over the plane, then the mean of each sample's top-k joints.
    output/target: (B, H, W, K); target_weight: (B, K) or (B, K, 1)."""
    b, h, w, k = output.shape
    pred = output.float().reshape(b, h * w, k)
    gt = target.float().reshape(b, h * w, k)
    if target_weight is not None:
        tw = target_weight.reshape(b, 1, k).float()
        pred = pred * tw
        gt = gt * tw
    per_joint = 0.5 * torch.mean((pred - gt) ** 2, dim=1)          # (B, K)
    topv, _ = torch.topk(per_joint, topk, dim=1)
    return torch.mean(torch.sum(topv, dim=1) / topk)


def bone_length_loss(pose_pred: torch.Tensor, pose_gt: torch.Tensor) -> torch.Tensor:
    """BoneLengthLoss (reference loss.py:150-177): the 20 bones between
    consecutive joint indices (data/legends.py BONE_PARENTS_REF); the sum
    over batch and bones of the squared length error, divided by 20."""
    parents = torch.from_numpy(BONE_PARENTS_REF.astype(np.int64)).to(pose_pred.device)
    children = parents + 1

    def lengths(p):
        return _norm((p[:, children, :] - p[:, parents, :]).float())

    return torch.sum((lengths(pose_gt) - lengths(pose_pred)) ** 2) / 20.0


# finger f's joint chain [4f, 4f+1, ..., 4f+4] (reference loss.py:198-201)
_CHAIN = (np.arange(5) * 4)[:, None] + np.arange(5)[None, :]


def joint_angle_loss(pose_pred: torch.Tensor) -> torch.Tensor:
    """JointAngleLoss (reference loss.py:179-223), batched over (B, fingers).

    The coplanarity of the four finger bones when the input is 3D, and the
    consistency of consecutive rotation directions, penalising negative dot
    products quadratically.  2D inputs are lifted with z = 0.
    """
    p = pose_pred.float()
    is3d = p.shape[2] == 3
    if not is3d:
        p = torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)
    chain = p[:, torch.from_numpy(_CHAIN).to(p.device), :]        # (B, 5, 5, 3)
    bones = chain[:, :, 1:, :] - chain[:, :, :-1, :]                 # (B, 5, 4, 3)
    b1, b2, b3, b4 = (bones[:, :, i, :] for i in range(4))
    rot_tip = torch.linalg.cross(b4, b3, dim=-1)
    rot_mid = torch.linalg.cross(b3, b2, dim=-1)
    rot_palm = torch.linalg.cross(b2, b1, dim=-1)

    loss = torch.zeros((), dtype=torch.float32, device=p.device)
    if is3d:
        coplane = torch.sum(rot_palm * b4, dim=-1) + torch.sum(rot_mid * b4, dim=-1)
        loss = loss + torch.sum(coplane)
    d1 = torch.sum(rot_tip * rot_mid, dim=-1)
    d2 = torch.sum(rot_palm * rot_mid, dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    loss = loss + torch.sum(torch.where(d1 < 0, d1 ** 2, zero))
    loss = loss + torch.sum(torch.where(d2 < 0, d2 ** 2, zero))
    return loss


def scale_pose(pose: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Wrist-centred, middle-finger-normalised pose (reference
    lib/utils/transforms.py:124-175).  pose: (B, K, D), D in {2, 3}; joint 0
    is the wrist, joint 9 the middle palm."""
    rel = pose.float() - pose[:, 0:1, :].float()
    ref_len = _norm(rel[:, 9, :] - rel[:, 0, :])
    return rel / torch.clamp(ref_len, min=eps)[:, None, None]
