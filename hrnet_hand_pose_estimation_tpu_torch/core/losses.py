"""The 2D losses, in PyTorch.

Port of the JAX package's ``core/losses.py:23-167`` and ``scale_pose``
(:209), themselves the reference's lib/core/loss.py:15-223 without its
per-sample loops.  Each is ``f(pred, target, ...) -> 0-d float32 tensor``
and differentiable.  The reductions are the reference's, unconventional ones
included: heatmap losses sum over H, W and average over B, K; the joint
losses without visibility divide by K, not B*K (loss.py:50).  The 3D losses
``joints_3d_mse_loss``, ``volumetric_ce_loss`` and ``kcs_loss`` are the JAX
package's ``core/losses.py:106-110, 169-206``.

``count_sum`` (the 2D losses that divide by a count of the batch): in a
data-parallel step each rank holds a slice of the global batch, and the
loss is this rank's share of the global loss, its own numerator over the
global denominator ``count_sum(local count)``
(``parallel/distributed.sum_counts``), so the ranks' shares sum to the loss
JAX computes on the global batch, ``sum(d * vis) / max(1, sum(vis))`` over
all of it.  The 3D losses that average over the batch take it too:
``volumetric_ce_loss`` (over B*K) and ``kcs_loss`` (over the B Gram
matrices' entries, each sample's own).  The losses that sum over the batch
(the joint losses without visibility, ``joints_3d_mse_loss``, the bone and
joint-angle losses) are shares as they are.  Without ``count_sum`` every
loss is computed as before.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..data.legends import BONE_PARENTS_REF, KC_MATRIX


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as ``jnp.linalg.norm`` computes it."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


CountSum = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _count(n, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(n), dtype=torch.float32, device=like.device)


def heatmap_loss(pred: torch.Tensor, gt: torch.Tensor, mode: str = "l2",
                 count_sum: CountSum = None) -> torch.Tensor:
    """HeatmapLoss (reference loss.py:15-28): per-pixel L2 or L1, summed over
    the plane, averaged over batch*joints.  pred/gt: (B, H, W, K)."""
    pred, gt = pred.float(), gt.float()
    if mode == "l2":
        err = (pred - gt) ** 2
    elif mode == "l1":
        err = torch.abs(pred - gt)
    else:
        raise ValueError(f"unknown heatmap loss mode {mode!r}")
    if count_sum is not None:
        return torch.sum(err) / count_sum(_count(pred.shape[0] * pred.shape[3], pred))
    return torch.mean(torch.sum(err, dim=(1, 2)))


def _visible_count(vis: torch.Tensor, count_sum: CountSum) -> torch.Tensor:
    """max(1, sum(vis)), the sum over the global batch with ``count_sum``."""
    total = torch.sum(vis)
    return torch.clamp(total if count_sum is None else count_sum(total), min=1.0)


def joints_mse_loss(pose_pred: torch.Tensor, pose_gt: torch.Tensor,
                    visibility: Optional[torch.Tensor] = None,
                    count_sum: CountSum = None) -> torch.Tensor:
    """JointsMSELoss (reference loss.py:30-50): mean Euclidean distance.
    pose_pred/gt: (B, K, D); visibility: (B, K) or None."""
    d = _norm(pose_pred.float() - pose_gt.float())
    if visibility is not None:
        vis = visibility.float()
        return torch.sum(d * vis) / _visible_count(vis, count_sum)
    return torch.sum(d) / pose_pred.shape[1]


def joints_mse_smooth_loss(pose_pred: torch.Tensor, pose_gt: torch.Tensor,
                           visibility: Optional[torch.Tensor] = None,
                           threshold: float = 400.0, count_sum: CountSum = None) -> torch.Tensor:
    """JointsMSESmoothLoss (reference loss.py:52-69): squared error, softly
    capped as ``d^0.1 * threshold^0.9`` above the threshold."""
    diff = (pose_gt.float() - pose_pred.float()) ** 2
    if visibility is not None:
        diff = diff * visibility[..., None].float()
    capped = torch.where(diff > threshold, torch.pow(diff, 0.1) * threshold ** 0.9, diff)
    if visibility is not None:
        return torch.sum(capped) / _visible_count(visibility.float(), count_sum)
    return torch.sum(capped) / pose_gt.shape[1]


def joints_mae_loss(pose_pred: torch.Tensor, pose_gt: torch.Tensor,
                    visibility: Optional[torch.Tensor] = None,
                    count_sum: CountSum = None) -> torch.Tensor:
    """JointsMAELoss (reference loss.py:71-91)."""
    err = torch.abs(pose_gt.float() - pose_pred.float())
    if visibility is not None:
        vis = visibility.float()
        if vis.dim() == err.dim() - 1:
            vis = vis[..., None]
        return torch.sum(err * vis) / _visible_count(vis, count_sum)
    return torch.sum(err) / pose_gt.shape[1]


def joints_ohkm_mse_loss(output: torch.Tensor, target: torch.Tensor,
                         target_weight: Optional[torch.Tensor] = None,
                         topk: int = 8, count_sum: CountSum = None) -> torch.Tensor:
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
    if count_sum is not None:
        return torch.sum(torch.sum(topv, dim=1) / topk) / count_sum(_count(b, output))
    return torch.mean(torch.sum(topv, dim=1) / topk)


def joints_3d_mse_loss(pose3d_pred: torch.Tensor, pose3d_gt: torch.Tensor) -> torch.Tensor:
    """Joints3DMSELoss (reference loss.py:137-148): the sum of the joints'
    Euclidean errors over the batch, divided by K.  (B, K, 3) each."""
    return torch.sum(_norm(pose3d_gt.float() - pose3d_pred.float())) / pose3d_pred.shape[1]


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


def volumetric_ce_loss(coord_volumes: torch.Tensor, volumes_pred: torch.Tensor,
                       keypoints_gt: torch.Tensor, validity: torch.Tensor,
                       count_sum: CountSum = None) -> torch.Tensor:
    """VolumetricCELoss (reference loss.py:225-256), loop-free: per joint,
    -log(prob + 1e-6) of the voxel whose centre is nearest the ground truth,
    weighted by validity and averaged over B*K.

    coord_volumes (B, X, Y, Z, 3) voxel centres in world mm; volumes_pred
    (B, X, Y, Z, K) probabilities; keypoints_gt (B, K, 3); validity (B, K) or
    (B, K, 1).  The nearest voxel is the argmin over the flattened volume of
    ||c||^2 - 2 c.k + ||k||^2, the JAX package's formula; ``torch.argmin``
    returns the first index of a tie on the CPU and on the card alike, as
    ``jnp.argmin`` does.
    """
    b, _, _, _, k = volumes_pred.shape
    cv = coord_volumes.reshape(b, -1, 3).float()                       # (B, V, 3)
    kp = keypoints_gt.float()                                          # (B, K, 3)
    d = (torch.sum(cv ** 2, dim=-1)[:, :, None]
         - 2.0 * torch.einsum("bvc,bkc->bvk", cv, kp)
         + torch.sum(kp ** 2, dim=-1)[:, None, :])
    nearest = torch.argmin(d, dim=1)                                   # (B, K)
    vols = volumes_pred.reshape(b, -1, k).float()
    probs = torch.gather(vols, 1, nearest[:, None, :])[:, 0, :]        # (B, K)
    val = validity.reshape(b, k).float()
    nll = torch.sum(val * (-torch.log(probs + 1e-6)))
    return nll / (b * k) if count_sum is None else nll / count_sum(_count(b * k, nll))


def kcs_loss(pose3d_pred: torch.Tensor, pose3d_gt: torch.Tensor,
             count_sum: CountSum = None) -> torch.Tensor:
    """Kinematic-chain-space loss (reference function3D.py:159-189): the MSE
    between the Gram matrices of ``KC_MATRIX @ pose3d`` (the bone vectors),
    each sample's matrix its own, so a rank's share is its squared errors'
    sum over the global count of entries."""
    kc = torch.as_tensor(KC_MATRIX, dtype=torch.float32, device=pose3d_pred.device)

    def gram(p):
        bones = torch.einsum("jk,bkc->bjc", kc, p.float())
        return torch.einsum("bjc,bkc->bjk", bones, bones)

    err = (gram(pose3d_pred) - gram(pose3d_gt)) ** 2
    if count_sum is None:
        return torch.mean(err)
    return torch.sum(err) / count_sum(_count(err.numel(), err))
