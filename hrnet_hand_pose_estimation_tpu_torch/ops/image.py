"""Device-side image preprocessing: resize, normalise, affine warp.

Port of the JAX package's ``ops/image.py``: the crop -> resize -> normalise
chain of inference runs on the device, batched, in NHWC.

``jax.image.resize(..., "bilinear")`` antialiases when it shrinks an image
(its ``antialias=True`` default: a triangle filter widened by the scale
factor, normalised over the taps inside the image).  ``F.interpolate`` does
the same only with ``antialias=True``; with it, upsampling is the plain
half-pixel bilinear with clamped edges, as in JAX.  So ``resize_bilinear``
always passes ``antialias=True``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device))


def resize_bilinear(images: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Batched bilinear resize of (B, H, W, C) float images (half-pixel
    centres, like cv2.resize; antialiased when shrinking, as jax.image.resize)."""
    x = images.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=tuple(int(s) for s in out_hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8/float images -> ImageNet-normalised float32 (reference
    ToTensor + Normalize): uint8 is divided by 255 first."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    mean, std = _stats(x)
    return (x - mean) / std


def preprocess_for_inference(images: torch.Tensor, size: int) -> torch.Tensor:
    """Resize + normalise for inference (reference tools/inference.py:118-124):
    (B, H, W, 3) uint8/float -> (B, size, size, 3) float32."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    x = resize_bilinear(x, (size, size))
    mean, std = _stats(x)
    return (x - mean) / std


def affine_warp(images: torch.Tensor, mats: torch.Tensor,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    """Batched inverse-affine warp with bilinear sampling + zero padding.

    mats: (B, 2, 3) forward affines mapping input -> output pixels (the
    convention of data/transforms.affine_matrix); sampling inverts them.
    """
    from .volumetric import bilinear_sample_nhwc

    b = images.shape[0]
    oh, ow = (int(s) for s in out_hw)
    mats = mats.float()
    last = torch.tensor([[[0.0, 0.0, 1.0]]], dtype=mats.dtype, device=mats.device)
    full = torch.cat([mats, last.expand(b, 1, 3)], dim=1)
    inv = torch.linalg.inv(full)[:, :2]                          # (B, 2, 3)
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=mats.device),
                            torch.arange(ow, dtype=torch.float32, device=mats.device),
                            indexing="ij")
    grid = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)
    src = torch.einsum("bij,nj->bni", inv, grid)                 # (B, N, 2) [x, y]
    out = bilinear_sample_nhwc(images.float(), src)
    return out.reshape(b, oh, ow, images.shape[-1])
