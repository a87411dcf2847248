"""Volumetric ops, in PyTorch: for now only the bilinear sampler.

Port of ``bilinear_sample_nhwc`` of the JAX package's ``ops/volumetric.py:65-100``,
which ``ops/image.affine_warp`` needs.  The rest of that module (coordinate
volumes, unprojection, the 3D soft-argmax) comes with the 3D stack
(ROADMAP A9).
"""

from __future__ import annotations

import torch


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
