"""Procedural synthetic hand-pose samples for tests and smoke runs.

Port of the JAX package's ``data/synthetic.py:25-116`` (``SyntheticDataset``,
2D): 21 joints along 5 synthetic fingers radiating from a random wrist,
rendered as Gaussian blobs on a noisy background, with the
RHD_kpt-compatible record schema.  Samples are a function of
``(seed, index)`` (and of the transforms' generator, when they augment).
A transform chain (``data/transforms.HandTransforms``) is applied as the
JAX package applies it.  ``SyntheticMultiViewDataset`` (``data/synthetic.py:
118-192``) is the calibrated multi-view set of the 3D stack.  Under
``MODEL.NAME == "CPM"`` a sample also carries ``centermaps`` and its
``heatmaps`` are CPM's (K+1)-channel background-first targets (JAX
``data/synthetic.py:76-78``, ``:106-114``).
"""

from __future__ import annotations

import numpy as np

from ..ops.targets import cpm_heatmaps_np, gaussian_targets_np
from .mhp import _cpm_centermap_np
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
        # CPM models read centre maps and (K+1)-channel background targets
        self.cpm = cfg is not None and str(cfg.MODEL.NAME) == "CPM"

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
        out = {
            "imgs": np.asarray(img, np.float32),
            "pose2d": pose2d.astype(np.float32),
            "heatmaps": hms.astype(np.float32),
            "visibility": vis,
            "corner": np.zeros(2, np.float32),
            "crop_size": np.float32(self.img_size),
        }
        if self.cpm:
            stride = self.img_size / self.hm_size
            out["heatmaps"] = cpm_heatmaps_np(pose2d * stride, self.hm_size, self.sigma, stride)
            out["centermaps"] = _cpm_centermap_np(center.astype(np.float32), self.img_size)
        return out


class SyntheticMultiViewDataset:
    """Calibrated multi-view synthetic dataset (MHP_mv-compatible schema):
    one world skeleton (mm) per sample seen by ``n_views`` cameras on a
    ring 500 mm out, each view rendered as blobs at its projection."""

    name = "SyntheticMV"
    orig_img_size = (64, 64)

    def __init__(self, cfg=None, subset: str = "training", heatmap_generator=None,
                 transform=None, length: int = 16, img_size: int = 64,
                 hm_size: int = 16, n_views: int = 4, sigma: float = 2.0,
                 seed: int = 0):
        if cfg is not None:
            img_size = int(cfg.MODEL.IMAGE_SIZE[0])
            hm_size = int(cfg.MODEL.HEATMAP_SIZE[0])
            n_views = int(cfg.DATASET.NUM_VIEWS)
            sigma = float(cfg.MODEL.SIGMA)
        self.length = length
        self.img_size = img_size
        self.hm_size = hm_size
        self.n_views = n_views
        self.sigma = sigma
        self.seed = seed + (0 if subset in ("train", "training") else 10_000)
        self.transform = transform
        self.orig_img_size = (img_size, img_size)
        f = img_size * 1.8
        c = (img_size - 1) / 2
        self.intrinsic_matrix = np.array([[f, 0, c], [0, f, c], [0, 0, 1]], np.float32)
        self.exception = False

    def __len__(self) -> int:
        return self.length

    def _extrinsics(self, view: int) -> np.ndarray:
        ang = 2 * np.pi * view / self.n_views + 0.3
        c, s = np.cos(ang), np.sin(ang)
        ry = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        tx = 0.15 * view + 0.1
        ct, st = np.cos(tx), np.sin(tx)
        rx = np.array([[1, 0, 0], [0, ct, -st], [0, st, ct]], np.float32)
        t = np.array([[0.0], [0.0], [500.0]], np.float32)
        return np.concatenate([rx @ ry, t], axis=1)

    def __getitem__(self, idx: int):
        rng = np.random.default_rng((self.seed, idx))
        pose3d = synthetic_pose(rng, size=90.0)       # mm-scale world skeleton
        pose3d = pose3d + rng.uniform(-25, 25, size=3).astype(np.float32)
        imgs, poses2d, viss, exts, hms = [], [], [], [], []
        for v in range(self.n_views):
            ext = self._extrinsics(v)
            cam = ext[:, :3] @ pose3d.T + ext[:, 3:]
            uvw = self.intrinsic_matrix @ cam
            pose2d = (uvw[:2] / uvw[2:]).T.astype(np.float32)
            img = render_blob_image(pose2d, self.img_size, rng)
            if self.transform is not None:
                img, joints = self.transform(img, [pose2d])
                pose2d = np.asarray(joints[0], np.float32)
            else:
                img = normalize_image(img)
                pose2d = pose2d * self.hm_size / self.img_size
            vis = np.ones((21, 1), np.float32)
            hms.append(gaussian_targets_np(pose2d, vis[:, 0], self.hm_size, self.sigma))
            imgs.append(np.asarray(img, np.float32))
            poses2d.append(pose2d)
            viss.append(vis)
            exts.append(ext)
        return {
            "imgs": np.stack(imgs),
            "pose2d": np.stack(poses2d),
            "pose3d": pose3d,
            "visibility": np.stack(viss),
            "extrinsic_matrices": np.stack(exts),
            "intrinsic_matrix": self.intrinsic_matrix,
            "heatmaps": np.stack(hms),
        }
