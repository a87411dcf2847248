"""STB (Stereo Hand Pose Tracking Benchmark) evaluation reader.

Port of the JAX package's ``data/stb.py`` (reference
lib/dataset/STB_dataset.py:126-247):

- ``<root>/STB/<set>/images/<seq>/<prefix>_<i>.png`` colour frames (decoded
  in numpy) and ``<root>/STB/<set>/labels/<seq>_SK.mat`` with ``handPara``
  (3, 21, N) depth-frame keypoints, read by ``scipy.io``;
- the depth -> colour transform (``data/cv.rodrigues`` of the SK rotation),
  the STB -> standard joint order, mm -> cm and the palm -> wrist
  extrapolation, in the reference's order; the SK colour camera's K.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import List

import numpy as np

from ..utils.zipreader import imread
from .cv import bgr_to_rgb
from .cv import rodrigues as _rodrigues

# SK (depth sensor) color-camera constants (reference STB_dataset.py:20-40)
SK_FX_COLOR = 607.92271
SK_FY_COLOR = 607.88192
SK_TX_COLOR = 314.78337
SK_TY_COLOR = 236.42484
SK_ROT = np.array([[0.00531, -0.01196, 0.00301]])
SK_TRANS = np.array([[-24.0381, -0.4563, -1.2326]])  # mm

# STB stores palm centre instead of wrist; and its joint order differs from
# the SNAP/standard legend (reference STB_to_Snap_id)
STB_TO_STD = np.array(
    [0, 17, 18, 19, 20, 13, 14, 15, 16, 9, 10, 11, 12, 5, 6, 7, 8, 1, 2, 3, 4]
)


def depth_to_color(pose: np.ndarray) -> np.ndarray:
    """SK depth-frame -> color-frame (reference SK_xyz_depth2color)."""
    R = _rodrigues(SK_ROT)
    return (pose - SK_TRANS) @ R


def palm_to_wrist(pose: np.ndarray) -> np.ndarray:
    """Replace palm centre with an extrapolated wrist.

    Reference palm2wrist (STB_dataset.py:190-195):
    ``wrist = ring_root + 2.0 * (palm - ring_root)`` where ``ring_root`` is
    ``loc_bn_ring_L_01`` = index 13 in SNAP order (applied AFTER the
    STB->Snap joint remap).
    """
    root, ring_root = 0, 13
    out = pose.copy()
    out[:, root] = pose[:, ring_root] + 2.0 * (pose[:, root] - pose[:, ring_root])
    return out


class STBDataset:
    name = "STB"
    orig_img_size = (640, 480)

    def __init__(self, root: str, set_name: str = "evaluation",
                 data_format=None, transforms=None, image_prefix: str = "SK_color"):
        import scipy.io as sio

        self.data_dir = osp.join(root, self.name, set_name)
        self.transform = transforms
        image_root = osp.join(self.data_dir, "images")
        ann_dir = osp.join(self.data_dir, "labels")
        self.image_paths: List[str] = []
        gts = []
        for seq in sorted(os.listdir(image_root)):
            mat = sio.loadmat(osp.join(ann_dir, f"{seq}_SK.mat"))
            pose = mat["handPara"].transpose(2, 1, 0)      # N x 21 x 3 (depth frame)
            pose = depth_to_color(pose)
            # Snap joint order, then mm->cm, then wrist extrapolation — the
            # reference's exact pipeline order (STB_dataset.py:152-155)
            pose = pose[:, STB_TO_STD, :] / 10.0
            pose = palm_to_wrist(pose)
            gts.append(pose.astype(np.float32))
            for i in range(pose.shape[0]):
                self.image_paths.append(
                    osp.join(image_root, seq, f"{image_prefix}_{i}.png"))
        self.pose_gts = np.concatenate(gts, axis=0)
        # reference STB_dataset.py:156-160: wrist root + reference-bone scale
        # (|mid_L_02 - mid_L_01|, Snap indices 10/9) per frame
        self.pose_roots = self.pose_gts[:, 0, :]
        self.pose_scales = np.linalg.norm(
            self.pose_gts[:, 10, :] - self.pose_gts[:, 9, :], axis=1)
        self.K = np.array([
            [SK_FX_COLOR, 0, SK_TX_COLOR],
            [0, SK_FY_COLOR, SK_TY_COLOR],
            [0, 0, 1.0],
        ], np.float32)

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx: int):
        img = bgr_to_rgb(imread(self.image_paths[idx]))
        pose3d = self.pose_gts[idx]
        uvw = (self.K @ pose3d.T).T
        pose2d = (uvw[:, :2] / uvw[:, 2:3]).astype(np.float32)
        if self.transform is not None:
            img, joints = self.transform(img, [pose2d])
            pose2d = np.asarray(joints[0], np.float32)
        return {
            "imgs": np.asarray(img, np.float32),
            "pose2d": pose2d,
            "pose3d": pose3d,
            "visibility": np.ones((21, 1), np.float32),
            "K": self.K,
        }
