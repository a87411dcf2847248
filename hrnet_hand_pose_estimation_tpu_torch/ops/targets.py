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
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.gaussian_targets import fused_gaussian_targets, gaussian_targets_reference

__all__ = ["gaussian_targets", "gaussian_targets_np", "gaussian_targets_reference"]


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
