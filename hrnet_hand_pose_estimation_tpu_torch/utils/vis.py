"""Debug visualisation: joint overlays, heatmap sheets, the DEBUG dump.

Port of the JAX package's ``utils/vis.py`` (reference lib/utils/vis.py:20-240
and lib/utils/hand_skeleton.py), on numpy arrays.  cv2 is imported inside
the functions that draw or write, so the module imports on a machine
without it (the card's may lack it).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

from ..data.legends import BONE_CHILDREN, BONE_PARENTS
from ..data.transforms import denormalize_image

FINGER_COLORS = [
    (0, 0, 255), (0, 255, 0), (255, 0, 0), (0, 255, 255), (255, 0, 255),
]


def _host(x) -> Optional[np.ndarray]:
    """A tensor or array as a float32 numpy array (None stays None)."""
    if x is None:
        return None
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def draw_hand(canvas: np.ndarray, pose2d: np.ndarray,
              visibility: Optional[np.ndarray] = None) -> np.ndarray:
    """Skeleton overlay (the role of hand_skeleton.Hand, reference :10-85)."""
    import cv2

    for b, (p, c) in enumerate(zip(BONE_PARENTS, BONE_CHILDREN)):
        if visibility is not None and (visibility[p] <= 0 or visibility[c] <= 0):
            continue
        p1 = tuple(int(v) for v in pose2d[p][:2])
        p2 = tuple(int(v) for v in pose2d[c][:2])
        cv2.line(canvas, p1, p2, FINGER_COLORS[b // 4], 2)
    for uv in pose2d:
        cv2.circle(canvas, (int(uv[0]), int(uv[1])), 2, (255, 255, 255), -1)
    return canvas


def save_batch_image_with_joints(batch_images: np.ndarray, batch_joints: np.ndarray,
                                 file_name: str, nrow: int = 8) -> None:
    """Grid of images with joint overlays (reference vis.py:20-51).
    batch_images: (B, H, W, 3) normalised floats; joints in image pixels."""
    import cv2

    b, h, w = batch_images.shape[:3]
    ncol = min(nrow, b)
    nrows = math.ceil(b / ncol)
    grid = np.zeros((nrows * h, ncol * w, 3), np.uint8)
    for i in range(b):
        img = np.ascontiguousarray(cv2.cvtColor(denormalize_image(batch_images[i]),
                                                cv2.COLOR_RGB2BGR))
        draw_hand(img, batch_joints[i])
        r, c = divmod(i, ncol)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
    cv2.imwrite(file_name, grid)


def save_batch_heatmaps(batch_images: np.ndarray, batch_heatmaps: np.ndarray,
                        file_name: str) -> None:
    """Per-joint heatmap sheet beside the input (reference vis.py:54-117).
    batch_heatmaps: (B, h, w, K)."""
    import cv2

    b, hh, _, k = batch_heatmaps.shape
    h = w = hh
    sheet = np.zeros((b * h, (k + 1) * w, 3), np.uint8)
    for i in range(b):
        img = cv2.cvtColor(denormalize_image(batch_images[i]), cv2.COLOR_RGB2BGR)
        sheet[i * h:(i + 1) * h, :w] = cv2.resize(img, (w, h))
        for j in range(k):
            hm = batch_heatmaps[i, :, :, j]
            hm = (255 * (hm - hm.min()) / max(hm.max() - hm.min(), 1e-12)).astype(np.uint8)
            sheet[i * h:(i + 1) * h, (j + 1) * w:(j + 2) * w] = cv2.applyColorMap(
                hm, cv2.COLORMAP_JET)
    cv2.imwrite(file_name, sheet)


def save_debug_images(cfg, batch_images, batch_joints_gt, batch_joints_pred,
                      batch_heatmaps_gt, batch_heatmaps_pred, prefix: str) -> None:
    """The DEBUG.*-gated dump set (reference vis.py:193-240):
    ``{prefix}_{gt,pred,hm_gt,hm_pred}.jpg``.  Arrays or tensors."""
    d = cfg.DEBUG
    if not d.DEBUG:
        return
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    imgs = _host(batch_images)
    if d.SAVE_BATCH_IMAGES_GT and batch_joints_gt is not None:
        save_batch_image_with_joints(imgs, _host(batch_joints_gt), f"{prefix}_gt.jpg")
    if d.SAVE_BATCH_IMAGES_PRED and batch_joints_pred is not None:
        save_batch_image_with_joints(imgs, _host(batch_joints_pred), f"{prefix}_pred.jpg")
    if d.SAVE_HEATMAPS_GT and batch_heatmaps_gt is not None:
        save_batch_heatmaps(imgs, _host(batch_heatmaps_gt), f"{prefix}_hm_gt.jpg")
    if d.SAVE_HEATMAPS_PRED and batch_heatmaps_pred is not None:
        save_batch_heatmaps(imgs, _host(batch_heatmaps_pred), f"{prefix}_hm_pred.jpg")
