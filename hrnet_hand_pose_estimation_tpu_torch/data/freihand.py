"""FreiHand readers.

Port of the JAX package's ``data/freihand.py`` (reference
lib/dataset/FreiHandDataset.py:18-373 and FreiHandDatasetKeypoints.py):

- annotations: ``training_K.json`` / ``training_mano.json`` /
  ``training_xyz.json``, zipped per sample;
- 2D keypoints by pinhole projection of the 3D joints through K;
- the fixed 80/20 train/validation split of the 32560 unique samples
  (``N_UNIQUE``); a sample index reads its annotation at ``idx % 32560``;
- joints already in the standard legend's order.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..ops.targets import gaussian_targets_np
from ..utils.zipreader import imread
from .cv import bgr_to_rgb

N_UNIQUE = 32560


def project_points(xyz: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Pinhole projection (reference frei_utils/fh_utils projectPoints)."""
    uvw = (K @ xyz.T).T
    return uvw[:, :2] / uvw[:, 2:3]


def load_db_annotation(base_path: str, set_name: str = "training"):
    """The (K, mano, xyz) json triplet, zipped per sample."""
    def _json(name):
        with open(os.path.join(base_path, f"{set_name}_{name}.json")) as f:
            return json.load(f)

    return list(zip(_json("K"), _json("mano"), _json("xyz")))


class FreiHandDataset:
    name = "FreiHand"
    orig_img_size = (224, 224)

    def __init__(self, root: str, set_name: str, data_format: Optional[str] = None,
                 transforms=None):
        self.data_dir = os.path.join(root, self.name)
        split = 0.8
        if set_name in ("train", "training"):
            self.sample_lst = range(0, int(N_UNIQUE * split))
        else:
            self.sample_lst = range(int(N_UNIQUE * split), N_UNIQUE)
        self.transform = transforms
        self.db_data_anno = load_db_annotation(self.data_dir, "training")

    def __len__(self) -> int:
        return len(self.sample_lst)

    def _load_raw(self, idx: int):
        sample_id = self.sample_lst[idx] if idx < len(self.sample_lst) else idx
        img_path = os.path.join(self.data_dir, "training", "rgb", "%08d.jpg" % sample_id)
        img = bgr_to_rgb(imread(img_path))
        K, mano, xyz = (np.asarray(a) for a in self.db_data_anno[sample_id % N_UNIQUE])
        return img, project_points(xyz, K), xyz, K, img_path

    def __getitem__(self, idx: int):
        img, uv, xyz, K, img_path = self._load_raw(idx)
        joints = np.concatenate([uv, np.ones((21, 1))], axis=1)
        if self.transform is not None:
            img, joints_list = self.transform(img, [joints[:, :2]])
            joints = np.concatenate([joints_list[0], np.ones((21, 1))], axis=1)
        return {
            "imgs": np.asarray(img, np.float32),
            "pose2d": joints[:, :2].astype(np.float32),
            "pose3d": xyz.astype(np.float32),
            "visibility": np.ones((21, 1), np.float32),
            "K": K.astype(np.float32),
            "img_path": img_path,
        }

    def evaluate(self, cfg, preds: np.ndarray, scores=None, output_dir: str = ".",
                 *args, **kwargs):
        """Write a COCO-style keypoint json and return the mean EPE against
        the projected ground truth (reference FreiHandDataset.evaluate
        :127,288-357)."""
        res_dir = os.path.join(output_dir, "results")
        os.makedirs(res_dir, exist_ok=True)
        res_file = os.path.join(res_dir, f"keypoints_{self.__class__.__name__}_results.json")
        with open(res_file, "w") as f:
            json.dump(_coco_keypoint_results(np.asarray(preds), scores), f)

        errs = []
        for i in range(min(len(preds), len(self))):
            _, uv, _, _, _ = self._load_raw(i)
            errs.append(np.linalg.norm(np.asarray(preds)[i][:, :2] - uv, axis=1).mean())
        epe = float(np.mean(errs)) if errs else float("nan")
        return {"EPE_px": epe, "res_file": res_file}


def _coco_keypoint_results(preds: np.ndarray, scores: Optional[np.ndarray] = None):
    """COCO-style keypoint result records."""
    out = []
    for i, kp in enumerate(preds):
        kps = np.concatenate([kp[:, :2], np.ones((kp.shape[0], 1), kp.dtype)], axis=1).reshape(-1)
        out.append({
            "image_id": int(i),
            "category_id": 1,
            "keypoints": [float(v) for v in kps],
            "score": float(scores[i]) if scores is not None else 1.0,
        })
    return out


class FreiHandDatasetKeypoints(FreiHandDataset):
    """The transform chain + heatmap targets."""

    def __init__(self, cfg, set_name: str, heatmap_generator=None, transforms=None):
        super().__init__(cfg.DATA_DIR, set_name, cfg.DATASET.DATA_FORMAT, None)
        self.transforms = transforms
        self.hm_size = int(cfg.MODEL.HEATMAP_SIZE[0])
        self.sigma = float(cfg.MODEL.SIGMA)
        self.heatmap_generator = heatmap_generator
        self.exception = False

    def __getitem__(self, idx: int):
        img, uv, xyz, K, _ = self._load_raw(idx)
        img, joints = self.transforms(img, [uv])
        pose2d = np.asarray(joints[0], np.float32)
        vis = np.ones((21,), np.float32)
        if self.heatmap_generator is not None:
            heatmaps = self.heatmap_generator(pose2d, vis)
        else:
            heatmaps = gaussian_targets_np(pose2d, vis, self.hm_size, self.sigma)
        return {
            "imgs": img.astype(np.float32),
            "pose2d": pose2d,
            "pose3d": xyz.astype(np.float32),
            "heatmaps": heatmaps.astype(np.float32),
            "visibility": vis[:, None],
            "K": K.astype(np.float32),
        }
