"""Camera ops with lens distortion, batched, in PyTorch.

Port of the JAX package's ``ops/cameras.py`` (reference
lib/utils/cameras_cuda.py:27-92): the world <-> camera rigid transforms and
``project_point_radial``, the pinhole projection with radial (k1..k3) and
tangential (p1, p2) distortion.  All ops broadcast over leading axes.
"""

from __future__ import annotations

from typing import Tuple

import torch


def world_to_camera_frame(points: torch.Tensor, R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """x_cam = R (x_world - T).  points (..., N, 3); R (..., 3, 3); T (..., 3)."""
    d = points - T[..., None, :]
    # written out, so a float32 product never goes through a TF32 matmul
    return (R[..., None, :, :] * d[..., None, :]).sum(-1)


def camera_to_world_frame(points: torch.Tensor, R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """x_world = R^T x_cam + T."""
    return (R.transpose(-1, -2)[..., None, :, :] * points[..., None, :]).sum(-1) + T[..., None, :]


def project_point_radial(points: torch.Tensor, R: torch.Tensor, T: torch.Tensor,
                         f: torch.Tensor, c: torch.Tensor, k: torch.Tensor,
                         p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project world points with radial + tangential distortion
    (reference cameras_cuda.py:27-56).

    points (..., N, 3); f (..., 2) focal; c (..., 2) principal point;
    k (..., 3) radial coefficients; p (..., 2) tangential coefficients.
    Returns (uv (..., N, 2), depth (..., N)).
    """
    cam = world_to_camera_frame(points, R, T)
    z = cam[..., 2]
    xy = cam[..., :2] / z[..., None]
    r2 = (xy ** 2).sum(-1)
    radial = 1.0 + k[..., None, 0] * r2 + k[..., None, 1] * r2 ** 2 + k[..., None, 2] * r2 ** 3
    tan = p[..., None, 0] * xy[..., 1] + p[..., None, 1] * xy[..., 0]
    xy_d = xy * (radial + tan)[..., None] + torch.stack(
        [p[..., None, 1] * r2, p[..., None, 0] * r2], dim=-1)
    uv = xy_d * f[..., None, :] + c[..., None, :]
    return uv, z
