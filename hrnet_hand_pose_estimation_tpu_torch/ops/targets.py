"""Gaussian heatmap targets, on the device and on the host.

Port of the JAX package's ``ops/targets.py:25-77``.  Semantics of the
reference (lib/dataset/target_generators/target_generators.py:15-53):

- the joint centre is the *truncated* coordinate (so -0.5 truncates to 0);
- a joint contributes iff its visibility is > 0 and 0 <= x, y < res;
- the map is exactly 0 outside the window ``|d| <= int(3 sigma + 1)``.

``gaussian_targets`` makes the train batch's targets on the device: on a
CUDA tensor it launches the hand-written kernel
(``ops/kernels/gaussian_targets.py``), on a CPU tensor it runs the kernel's
plain twin.  ``gaussian_targets_np`` is the numpy copy for the host input
pipeline (``data/synthetic.py``).

``scale_aware_gaussian_targets`` (JAX ``ops/targets.py:80``) is the
per-joint-sigma variant, plain PyTorch on the joints' device.

CPM's targets (JAX ``ops/targets.py:107-140``, reference
MHP_CPMDataset.py:193-224): ``gaussian_centermap``, the centre map that
``models/cpm.CPMVolumetric`` makes on the device when it is given none, and
``cpm_heatmaps_np``, the (K+1)-channel background-first target of the host
pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.gaussian_targets import fused_gaussian_targets, gaussian_targets_reference

__all__ = ["cpm_heatmaps_np", "gaussian_centermap", "gaussian_targets", "gaussian_targets_np",
           "gaussian_targets_reference", "scale_aware_gaussian_targets"]


def gaussian_targets(joints: torch.Tensor, visibility: torch.Tensor, output_res: int,
                     sigma: float = 2.0) -> torch.Tensor:
    """(B, K, 2) joints [u, v] in heatmap pixels + (B, K) visibility ->
    (B, res, res, K) float32 targets, on the joints' device."""
    return fused_gaussian_targets(joints.float(), visibility.float(), output_res, sigma)


def gaussian_targets_np(joints: np.ndarray, visibility: np.ndarray, output_res: int,
                        sigma: float = 2.0) -> np.ndarray:
    """Numpy twin of :func:`gaussian_targets` for the host input pipeline;
    a (K, 2) input gives one (res, res, K) map."""
    joints = np.asarray(joints, dtype=np.float32)
    single = joints.ndim == 2
    if single:
        joints = joints[None]
        visibility = np.asarray(visibility)[None]
    x = np.trunc(joints[..., 0]).astype(np.int32)
    y = np.trunc(joints[..., 1]).astype(np.int32)
    in_range = (x >= 0) & (y >= 0) & (x < output_res) & (y < output_res)
    valid = (np.asarray(visibility) > 0) & in_range

    px = np.arange(output_res, dtype=np.int32)
    dx = px[None, :, None] - x[:, None, :]
    dy = px[None, :, None] - y[:, None, :]
    win = int(3 * sigma + 1)
    sig2 = 2.0 * float(sigma) ** 2
    gx = np.exp(-(dx.astype(np.float32) ** 2) / sig2) * (np.abs(dx) <= win)
    gy = np.exp(-(dy.astype(np.float32) ** 2) / sig2) * (np.abs(dy) <= win)
    hm = gy[:, :, None, :] * gx[:, None, :, :]
    hm = hm * valid[:, None, None, :].astype(np.float32)
    return hm[0] if single else hm


def scale_aware_gaussian_targets(joints: torch.Tensor, visibility: torch.Tensor,
                                 sigmas: torch.Tensor, output_res: int) -> torch.Tensor:
    """The per-joint-sigma variant (reference ScaleAwareHeatmapGenerator
    :56-92): (B, K, 2) joints, (B, K) visibility and (B, K) sigmas ->
    (B, res, res, K) float32.  The window follows the same ``3 sigma + 1``
    rule, per joint."""
    x = torch.trunc(joints[..., 0]).to(torch.int32)
    y = torch.trunc(joints[..., 1]).to(torch.int32)
    in_range = (x >= 0) & (y >= 0) & (x < output_res) & (y < output_res)
    valid = (visibility > 0) & in_range

    px = torch.arange(output_res, dtype=torch.int32, device=joints.device)
    dx = px[None, :, None] - x[:, None, :]
    dy = px[None, :, None] - y[:, None, :]
    win = torch.trunc(3.0 * sigmas + 1.0)[:, None, :]              # (B, 1, K)
    sig2 = 2.0 * sigmas[:, None, :] ** 2
    gx = torch.exp(-(dx.float() ** 2) / sig2) * (dx.abs() <= win)
    gy = torch.exp(-(dy.float() ** 2) / sig2) * (dy.abs() <= win)
    hm = gy[:, :, None, :] * gx[:, None, :, :]
    return hm * valid[:, None, None, :].float()


def gaussian_centermap(center: torch.Tensor, res: int, sigma: float = 3.0) -> torch.Tensor:
    """CPM's single-channel centre map: an unwindowed Gaussian of ``sigma``
    at ``center``, clipped to <= 1 and zeroed below 0.0099.

    center: (B, 2) [u, v] in input pixels; returns (B, res, res, 1) float32.
    """
    px = torch.arange(res, dtype=torch.float32, device=center.device)
    du = px[None, :] - center[:, 0:1].float()
    dv = px[None, :] - center[:, 1:2].float()
    sig2 = 2.0 * float(sigma) ** 2
    g = torch.exp(-(dv[:, :, None] ** 2 + du[:, None, :] ** 2) / sig2)
    g = torch.clamp(g, max=1.0) * (g >= 0.0099)
    return g[..., None]


def cpm_heatmaps_np(pose2d: np.ndarray, hm_size: int, sigma: float, stride: float) -> np.ndarray:
    """CPM's 22-channel target for one sample: channel 0 is the background
    ``1 - max(joints)``; the joint channels are unwindowed Gaussians at the
    int-truncated, stride-divided coordinates, clipped to <= 1 and zeroed
    below 0.0099.  (K, 2) input pixels -> (hm_size, hm_size, K + 1) HWC."""
    k = pose2d.shape[0]
    grid = np.arange(hm_size, dtype=np.float32)
    joints = np.zeros((hm_size, hm_size, k), np.float32)
    for i in range(k):
        x = int(pose2d[i, 0]) * 1.0 / stride
        y = int(pose2d[i, 1]) * 1.0 / stride
        g = np.exp(-((grid[None, :] - x) ** 2 + (grid[:, None] - y) ** 2) / 2.0 / sigma / sigma)
        g[g > 1] = 1
        g[g < 0.0099] = 0
        joints[:, :, i] = g
    bg = 1.0 - joints.max(axis=2, keepdims=True)
    return np.concatenate([bg, joints], axis=2)
