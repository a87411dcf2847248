"""Volumetric triangulation ops, in PyTorch: coordinate volumes, the
bilinear sampler, unprojection and the 3D soft-argmax.

Port of the JAX package's ``ops/volumetric.py`` (reference
triangulation_model_utils/op.py:84-168 and volumetric.py:98-131).  The
unprojection projects every voxel of every sample through every view at
once, bilinear-gathers the feature maps (align_corners=True and zero
padding, as ``F.grid_sample``) and aggregates across views.  The small
products are float32 multiply-adds, never TF32 matmuls.

The JAX package reaches no Pallas kernel here; on the card these are
PyTorch's own elementwise, gather and reduction kernels.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def build_coord_volume(base_point: torch.Tensor, cuboid_size: float,
                       volume_size: int) -> torch.Tensor:
    """Axis-aligned cuboid of voxel-centre coordinates around a base point.

    base_point: (B, 3) world position (mm); the cuboid spans
    ``[base - size/2, base + size/2]`` (reference triangulation.py:407-456).
    Returns (B, S, S, S, 3) with meshgrid indexing='ij' (x, y, z axes).
    """
    s = volume_size
    xs = torch.from_numpy(np.linspace(0.0, cuboid_size, s, dtype=np.float32)).to(
        base_point.device) - cuboid_size / 2.0
    grid = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"), dim=-1)   # (S, S, S, 3)
    return base_point[:, None, None, None, :] + grid[None]


def rotation_matrix(axis: Sequence[float], theta: torch.Tensor) -> torch.Tensor:
    """Rotation about ``axis`` by ``theta`` rad (reference volumetric.py:98-112,
    quaternion form); theta of any shape (...) -> (..., 3, 3)."""
    axis = torch.as_tensor(axis, dtype=torch.float32, device=theta.device)
    axis = axis / torch.linalg.vector_norm(axis)
    half = theta / 2.0
    a = torch.cos(half)
    s = torch.sin(half)
    b, c, d = -axis[0] * s, -axis[1] * s, -axis[2] * s
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return torch.stack([
        torch.stack([aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)], dim=-1),
        torch.stack([2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)], dim=-1),
        torch.stack([2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc], dim=-1),
    ], dim=-2)


def rotate_coord_volume(coord_volume: torch.Tensor, theta: torch.Tensor, axis: Sequence[float],
                        center: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate voxel coordinates about ``center`` (the reference rotates the
    cuboid about its centre in training, triangulation.py:437-448).
    coord_volume: (B, S, S, S, 3); theta: (B,) rad; center: (B, 3) or None
    (the origin)."""
    rot = rotation_matrix(axis, theta)                                 # (B, 3, 3)
    if center is None:
        center = torch.zeros(coord_volume.shape[0], 3, dtype=coord_volume.dtype,
                             device=coord_volume.device)
    c = center[:, None, None, None, :]
    d = coord_volume - c
    return (rot[:, None, None, None] * d[..., None, :]).sum(-1) + c


def bilinear_sample_nhwc(images: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with zero padding, matching
    ``F.grid_sample(align_corners=True, padding_mode='zeros')`` after the
    caller converts normalised coords to pixel units.

    images: (..., H, W, C); coords: (..., N, 2) pixel [x, y].
    Returns (..., N, C).
    """
    h, w, c = images.shape[-3:]
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0)[..., None].to(images.dtype)
    dy = (y - y0)[..., None].to(images.dtype)
    flat = images.reshape(*images.shape[:-3], h * w, c)

    def gather(ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
        valid = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        idx = (torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1)).long()
        vals = torch.gather(flat, -2, idx[..., None].expand(*idx.shape, c))
        return vals * valid[..., None].to(images.dtype)

    v00 = gather(x0, y0)
    v01 = gather(x0 + 1, y0)
    v10 = gather(x0, y0 + 1)
    v11 = gather(x0 + 1, y0 + 1)
    return (v00 * (1 - dx) * (1 - dy) + v01 * dx * (1 - dy)
            + v10 * (1 - dx) * dy + v11 * dx * dy)


def unproject_heatmaps(features: torch.Tensor, proj_matrices: torch.Tensor,
                       coord_volumes: torch.Tensor, aggregation: str = "softmax",
                       vol_confidences: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lift per-view feature maps into a shared 3D volume (reference
    op.py:99-168, loop-free).

    features: (B, V, H, W, C) per-view maps (NHWC); proj_matrices: (B, V, 3,
    4) heatmap-scale projections; coord_volumes: (B, X, Y, Z, 3) world voxel
    centres; aggregation 'sum' | 'max' | 'softmax' | 'conf...';
    vol_confidences: (B, V, C) for the 'conf' aggregations.  Returns (B, X,
    Y, Z, C): the features' dtype, float32 for 'softmax'.

    The reference's grid_sample conventions, kept for parity: normalised
    coords ``2 (u / H - 0.5)`` (the x axis divides by H too: square maps
    everywhere), align_corners=True, zero padding, voxels behind a camera
    zeroed.
    """
    b, v, h, w, c = features.shape
    vol_shape = coord_volumes.shape[1:4]
    n = math.prod(vol_shape)
    grid = coord_volumes.reshape(b, 1, n, 3)
    p = proj_matrices[:, :, None]                                       # (B, V, 1, 3, 4)
    # P [x, y, z, 1] per row, accumulated left to right as a length-4 dot
    uvw = [((p[..., i, 0] * grid[..., 0] + p[..., i, 1] * grid[..., 1])
            + p[..., i, 2] * grid[..., 2]) + p[..., i, 3] for i in range(3)]  # (B, V, N) each
    depth = uvw[2]
    invalid = depth <= 0.0
    safe_depth = torch.where(depth == 0.0, torch.ones_like(depth), depth)
    # normalised g = 2 (u / H - 0.5); grid_sample with align_corners=True
    # then samples pixel (g + 1) / 2 (dim - 1) = u (dim - 1) / H
    px = uvw[0] / safe_depth * (w - 1) / h
    py = uvw[1] / safe_depth * (h - 1) / w
    samples = bilinear_sample_nhwc(features, torch.stack([px, py], dim=-1))   # (B, V, N, C)
    samples = samples * (~invalid)[..., None].to(samples.dtype)

    if aggregation == "sum":
        vol = samples.sum(1)
    elif aggregation == "max":
        vol = samples.amax(1)
    elif aggregation == "softmax":
        s32 = samples.float()
        vol = (torch.softmax(s32, dim=1) * s32).sum(1)
    elif aggregation.startswith("conf"):
        if vol_confidences is None:
            raise ValueError("conf aggregation needs vol_confidences")
        vol = (samples * vol_confidences[:, :, None, :]).sum(1)
    else:
        raise ValueError(f"unknown aggregation {aggregation!r}")
    return vol.reshape(b, *vol_shape, c)


def integrate_volumes_with_coordinates(volumes: torch.Tensor, coord_volumes: torch.Tensor,
                                       softmax: bool = True
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3D soft-argmax over per-joint volumes (reference op.py:84-96).

    volumes: (B, X, Y, Z, K); coord_volumes: (B, X, Y, Z, 3).
    Returns (coords (B, K, 3), probs (B, X, Y, Z, K)), float32.
    """
    b, x, y, z, k = volumes.shape
    # (B, K, N): each joint's volume contiguous, so the softmax and the
    # expectation reduce along memory (a reduction over N of the NDHWK
    # layout strides by K and took 12 ms at 64^3, B=4 on an H100)
    flat = volumes.reshape(b, -1, k).transpose(1, 2).float().contiguous()
    if softmax:
        flat = torch.softmax(flat, dim=-1)
    else:
        flat = torch.relu(flat)
        flat = flat / torch.clamp(flat.sum(-1, keepdim=True), min=1e-12)
    cv = coord_volumes.reshape(b, 1, -1, 3).float()
    # the expectation per axis as float32 sums (no TF32 matmul)
    coords = torch.stack([(flat * cv[..., i]).sum(-1) for i in range(3)], dim=-1)
    return coords, flat.transpose(1, 2).reshape(b, x, y, z, k)
