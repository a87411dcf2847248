"""Bounding-box and crop helpers, and the heatmap-to-uv conversion.

Port of the JAX package's ``utils/image_util.py`` (reference
lib/utils/image_util.py and heatmap_util.py): the numpy helpers are the
same; ``compute_uv_from_heatmaps`` decodes on the heatmaps' device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.decode import hard_argmax, heatmap_maxvals


def expand_bbox(bbox: Tuple[float, float, float, float], ratio: float,
                img_w: int, img_h: int) -> Tuple[int, int, int, int]:
    """Expand an (x, y, w, h) box by ``ratio`` about its centre, clamped."""
    x, y, w, h = bbox
    cx, cy = x + w / 2.0, y + h / 2.0
    w2, h2 = w * ratio, h * ratio
    x0 = int(max(0, cx - w2 / 2))
    y0 = int(max(0, cy - h2 / 2))
    x1 = int(min(img_w, cx + w2 / 2))
    y1 = int(min(img_h, cy + h2 / 2))
    return x0, y0, x1 - x0, y1 - y0


def square_bbox(bbox: Tuple[float, float, float, float], img_w: int,
                img_h: int) -> Tuple[int, int, int]:
    """Smallest clamped square containing the box (the RHD crop convention,
    reference RHDDataset.py:84-101): returns (x0, y0, side)."""
    x, y, w, h = bbox
    side = int(min(max(img_w, 1), 2 * max(w, h)))
    x0 = max(0, min(int(x - (side - w) / 2), img_w - side))
    y0 = max(0, min(img_h - side, int(y - (side - h) / 2)))
    return x0, y0, side


def pad_to_square(img: np.ndarray, value: int = 0) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Pad an HWC image to square; returns (padded, (pad_x, pad_y))."""
    h, w = img.shape[:2]
    side = max(h, w)
    out = np.full((side, side, *img.shape[2:]), value, img.dtype)
    py, px = (side - h) // 2, (side - w) // 2
    out[py:py + h, px:px + w] = img
    return out, (px, py)


def crop_patch(img: np.ndarray, x0: int, y0: int, side: int) -> np.ndarray:
    """Clamped square crop."""
    h, w = img.shape[:2]
    x0 = max(0, min(x0, w - side))
    y0 = max(0, min(y0, h - side))
    return img[y0:y0 + side, x0:x0 + side]


def compute_uv_from_heatmaps(hms, target_size: Tuple[int, int]) -> torch.Tensor:
    """(B, h, w, K) heatmaps -> (B, K, 3) [u, v, conf] float32, u and v
    scaled to target_size (reference heatmap_util.compute_uv_from_heatmaps),
    on the heatmaps' device (numpy arrays go to the CPU)."""
    hms = torch.as_tensor(hms)
    b, h, w, k = hms.shape
    uv = hard_argmax(hms)
    conf = heatmap_maxvals(hms).float()
    scale = torch.tensor([target_size[0] / w, target_size[1] / h], dtype=torch.float32,
                         device=hms.device)
    return torch.cat([uv * scale, conf], dim=-1)
