"""RHD (Rendered Hand Dataset) readers.

Port of the JAX package's ``data/rhd.py`` (reference
lib/dataset/RHDDataset.py:25-139 and RHDDatasetKeypoints.py:96-140):

- per sample, the hand (of the 42 annotated keypoints) with more visible
  joints, the left one on a tie;
- a square crop of side ``min(W, int(2*max(w, h)))`` around the hand's box,
  clamped into the image;
- joints reordered into the standard legend by ``IDX_RHD``, the crop corner
  and size carried through for the evaluator's rescale (``rescale =
  "crop_corner"``);
- the raw reader reorders ``pose2d`` but not ``visibility``, as the JAX
  package does (ROADMAP C24); the keypoint reader reorders both;
- the full-frame variant keeps the 320x320 frame and picks the right hand on
  a visibility tie (strict ``>``).

Images are read by ``utils/zipreader.imread`` (PNG decoded in numpy).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from ..ops.targets import gaussian_targets_np
from ..utils.zipreader import IMREAD_COLOR, IMREAD_IGNORE_ORIENTATION, imread
from .cv import bgr_to_rgb
from .legends import IDX_RHD


class RHDDataset:
    """Raw RHD samples (crop + joints in crop coords)."""

    name = "RHD"
    orig_img_size = (320, 320)
    rescale = "crop_corner"

    def __init__(self, root: str, subset: str, data_format: Optional[str] = None,
                 transforms=None):
        self.data_dir = os.path.join(root, self.name, subset)
        self.transform = transforms
        with open(os.path.join(self.data_dir, f"anno_{subset}.pickle"), "rb") as f:
            self.anno_all = pickle.load(f)
        self.images = sorted(os.listdir(os.path.join(self.data_dir, "color")))
        self.reorder_idx = IDX_RHD

    def __len__(self) -> int:
        return len(self.images)

    def _frame(self, idx: int) -> np.ndarray:
        path = os.path.join(self.data_dir, "color", self.images[idx])
        return bgr_to_rgb(imread(path, IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION))

    def _load_raw(self, idx: int):
        orig_img = self._frame(idx)
        uv_vis = np.asarray(self.anno_all[idx]["uv_vis"])
        kp_uv = uv_vis[:, :2]
        kp_vis = uv_vis[:, 2:] == 1
        if kp_vis[0:21].sum() >= kp_vis[21:42].sum():
            pose2d, vis = kp_uv[0:21], kp_vis[0:21]
        else:
            pose2d, vis = kp_uv[21:42], kp_vis[21:42]

        x, y = pose2d[:, 0], pose2d[:, 1]
        left, right = np.min(x), np.max(x)
        bottom, top = np.max(y), np.min(y)
        w, h = right - left, bottom - top
        crop_size = min(orig_img.shape[1], int(2 * w if w > h else 2 * h))
        corner = [
            max(0, min(int(left - (crop_size - w) / 2), orig_img.shape[0] - crop_size)),
            max(0, min(orig_img.shape[1] - crop_size, int(top - (crop_size - h) / 2))),
        ]
        cropped = orig_img[corner[1]:corner[1] + crop_size, corner[0]:corner[0] + crop_size, :]
        pose2d = pose2d - np.asarray(corner)
        return orig_img, cropped, pose2d, vis.astype(np.float32), np.asarray(corner), crop_size

    def __getitem__(self, idx: int):
        orig_img, cropped, pose2d, vis, corner, crop_size = self._load_raw(idx)
        if self.transform is not None:
            cropped, joints = self.transform(cropped, [pose2d])
            pose2d = joints[0]
        return {
            "orig_imgs": orig_img,
            "imgs": np.ascontiguousarray(cropped, np.float32),
            "pose2d": np.asarray(pose2d, np.float32)[self.reorder_idx],
            "visibility": vis,
            "corner": corner.astype(np.float32),
            "crop_size": np.float32(crop_size),
        }


class RHDDatasetKeypoints(RHDDataset):
    """The transform chain + Gaussian heatmap targets."""

    def __init__(self, cfg, subset: str, heatmap_generator=None, transforms=None):
        super().__init__(cfg.DATA_DIR, subset, cfg.DATASET.DATA_FORMAT, None)
        self.transforms = transforms
        self.hm_size = int(cfg.MODEL.HEATMAP_SIZE[0])
        self.sigma = float(cfg.MODEL.SIGMA)
        self.heatmap_generator = heatmap_generator
        self.exception = False

    def __getitem__(self, idx: int):
        orig_img, cropped, pose2d, vis, corner, crop_size = self._load_raw(idx)
        img, joints = self.transforms(cropped, [pose2d])
        pose2d = np.asarray(joints[0], np.float32)[self.reorder_idx]
        vis = vis[self.reorder_idx]
        if self.heatmap_generator is not None:
            heatmaps = self.heatmap_generator(pose2d, vis[:, 0])
        else:
            heatmaps = gaussian_targets_np(pose2d, vis[:, 0], self.hm_size, self.sigma)
        return {
            "imgs": img.astype(np.float32),
            "pose2d": pose2d,
            "heatmaps": heatmaps.astype(np.float32),
            "visibility": vis.astype(np.float32),
            "corner": corner.astype(np.float32),
            "crop_size": np.float32(crop_size),
        }


class RHDFullFrameDataset(RHDDataset):
    """The full-frame variant (the reference's *_twohands readers' live
    path): the uncropped frame with the more visible hand's 21 joints in
    image coordinates; the right hand on a visibility tie."""

    def _load_raw(self, idx: int):
        orig_img = self._frame(idx)
        uv_vis = np.asarray(self.anno_all[idx]["uv_vis"])
        if uv_vis[0:21, 2].sum() > uv_vis[21:42, 2].sum():
            joints = uv_vis[0:21]
        else:
            joints = uv_vis[21:42]
        pose2d = joints[:, :2]
        vis = (joints[:, 2:] == 1).astype(np.float32)
        return orig_img, orig_img, pose2d, vis, np.zeros(2), np.float32(orig_img.shape[1])


class RHDFullFrameDatasetKeypoints(RHDDatasetKeypoints, RHDFullFrameDataset):
    """Transform chain + heatmaps over the full frame."""
