"""Procedural synthetic hand-pose samples for tests and smoke runs.

Port of the JAX package's ``data/synthetic.py:25-116`` (``SyntheticDataset``,
2D): 21 joints along 5 synthetic fingers radiating from a random wrist,
rendered as Gaussian blobs on a noisy background, with the
RHD_kpt-compatible record schema.  Samples are a function of
``(seed, index)`` (and of the transforms' generator, when they augment).
A transform chain (``data/transforms.HandTransforms``) is applied as the
JAX package applies it.  The CPM schema and the multi-view dataset are not
ported yet (ROADMAP A9, A10).
"""

from __future__ import annotations

import numpy as np

from ..ops.targets import gaussian_targets_np
from .transforms import normalize_image


def synthetic_pose(rng: np.random.Generator, size: float = 1.0) -> np.ndarray:
    """A hand-like 21x3 skeleton: wrist + 5 chains of 4 joints."""
    wrist = np.zeros(3)
    pose = [wrist]
    for f in range(5):
        ang = (-0.6 + 0.3 * f) + rng.uniform(-0.1, 0.1)
        direction = np.array([np.sin(ang), -np.cos(ang), rng.uniform(-0.2, 0.2)])
        direction /= np.linalg.norm(direction)
        seg = size * (0.9 + 0.2 * rng.random()) / 4
        p = wrist
        for j in range(4):
            p = p + direction * seg * (1.0 - 0.1 * j)
            pose.append(p.copy())
    return np.asarray(pose, np.float32)


def render_blob_image(pose2d: np.ndarray, img_size: int,
                      rng: np.random.Generator) -> np.ndarray:
    """Render joints as bright Gaussian blobs on a noisy background."""
    ys, xs = np.mgrid[0:img_size, 0:img_size].astype(np.float32)
    img = rng.uniform(0, 0.15, size=(img_size, img_size, 3)).astype(np.float32)
    for k, (u, v) in enumerate(pose2d):
        blob = np.exp(-((xs - u) ** 2 + (ys - v) ** 2) / (2 * (img_size / 48.0) ** 2))
        img[..., k % 3] += blob
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


class SyntheticDataset:
    """2D single-view synthetic dataset (RHD_kpt-compatible schema)."""

    name = "Synthetic"
    orig_img_size = (256, 256)
    rescale = "crop_corner"

    def __init__(self, cfg=None, subset: str = "training", heatmap_generator=None,
                 transforms=None, length: int = 64, img_size: int = 64,
                 hm_size: int = 16, sigma: float = 2.0, seed: int = 0):
        if cfg is not None:
            if str(cfg.MODEL.NAME) == "CPM":
                raise NotImplementedError("the CPM sample schema is not ported yet")
            img_size = int(cfg.MODEL.IMAGE_SIZE[0])
            hm_size = int(cfg.MODEL.HEATMAP_SIZE[0])
            sigma = float(cfg.MODEL.SIGMA)
        self.length = length
        self.img_size = img_size
        self.hm_size = hm_size
        self.sigma = sigma
        self.seed = seed + (0 if subset in ("train", "training") else 10_000)
        self.transforms = transforms
        self.heatmap_generator = heatmap_generator
        self.exception = False

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int):
        rng = np.random.default_rng((self.seed, idx))
        pose3d = synthetic_pose(rng, size=self.img_size * 0.35)
        center = rng.uniform(0.35, 0.65, size=2) * self.img_size
        pose2d = pose3d[:, :2] + center
        img = render_blob_image(pose2d, self.img_size, rng)
        if self.transforms is not None:
            img, joints = self.transforms(img, [pose2d])
            pose2d = np.asarray(joints[0], np.float32)
        else:
            img = normalize_image(img)
            pose2d = pose2d * self.hm_size / self.img_size
        vis = np.ones((21, 1), np.float32)
        hms = (self.heatmap_generator(pose2d, vis[:, 0]) if self.heatmap_generator
               else gaussian_targets_np(pose2d, vis[:, 0], self.hm_size, self.sigma))
        return {
            "imgs": np.asarray(img, np.float32),
            "pose2d": pose2d.astype(np.float32),
            "heatmaps": hms.astype(np.float32),
            "visibility": vis,
            "corner": np.zeros(2, np.float32),
            "crop_size": np.float32(self.img_size),
        }
