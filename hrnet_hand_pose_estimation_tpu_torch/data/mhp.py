"""MHP (MVHM "Multi-view Hand Pose") readers: single-view, multi-view,
temporal-sequence and CPM variants.

Port of the JAX package's ``data/mhp.py`` (reference lib/dataset/MHPDataset.py,
MHPMultiViewDataset.py:31-222, MHPSeqDataset.py, MHP_CPMDataset.py:100-240
and MHP_CPMMultiViewDataset.py:36-270):

- layout: ``annotated_frames/data_{1..21}/{frame}_webcam_{1..4}.jpg``,
  ``annotations/data_i/{frame}_joints.txt`` (world-coordinate 3D),
  ``calibrations/data_i/webcam_j/{rvec,tvec}.pkl`` (Rodrigues extrinsics,
  pickled by Python 2: loaded with ``encoding="latin1"``);
- shared intrinsics Fx=614.878 Fy=615.479 Cx=313.219 Cy=231.288 and 640x480
  frames; train split data_1..16, evaluation data_17..21;
- joints reordered to the standard legend by ``IDX_MHP`` (the file stores
  the wrist last);
- multi-view samples get a black disc of radius 50 px centred on a random
  keypoint, drawn by ``data/cv.circle_filled`` (cv2.circle's pixels) from
  ``np.random.default_rng(4 * frame + cam)``, and mark the joints in the
  disc or out of frame invisible;
- the CPM variants resize each frame to the model input with
  ``data/cv.resize`` (cv2.resize's INTER_LINEAR), targets (K+1)-channel with
  a background channel 0, a sigma-3 centre map and CPM's (x - 128) / 256;
- ``MHPSeqDataset`` folds views into frames, (F*V, H, W, 3): PoseAggr then
  sees T = F*V (ROADMAP C23).

Frames are read by ``utils/zipreader.imread``: the dataset's JPEG content
needs cv2; PNG content under the same names is decoded in numpy.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Tuple

import numpy as np

from ..ops.targets import cpm_heatmaps_np, gaussian_targets_np
from ..utils.zipreader import imread
from .cv import bgr_to_rgb, circle_filled, resize
from .cv import rodrigues as rodrigues64
from .legends import IDX_MHP

INTRINSICS = np.array(
    [[614.878, 0.0, 313.219],
     [0.0, 615.479, 231.288],
     [0.0, 0.0, 1.0]], dtype=np.float32,
)
ORIG_SIZE = (640, 480)  # (W, H)
TRAIN_DIRS = range(1, 17)
EVAL_DIRS = range(17, 22)
OCCLUSION_RADIUS = 50


def read_annotation_3d(path: str) -> np.ndarray:
    """Parse a ``{frame}_joints.txt`` world-coordinate annotation file."""
    pts = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4:
                pts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif len(parts) == 3:
                pts.append([float(p) for p in parts])
    return np.asarray(pts, np.float32)


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """The rotation of a Rodrigues vector, computed in float64, in float32."""
    return rodrigues64(rvec).astype(np.float32)


class _MHPBase:
    name = "MHP"
    orig_img_size = list(ORIG_SIZE)

    def __init__(self, data_dir: str, subset: str):
        self.data_dir = data_dir
        dirs = TRAIN_DIRS if subset in ("train", "training") else EVAL_DIRS
        self.frames: List[Tuple[str, int]] = []        # (data_subdir, frame_idx)
        self.rvec: Dict[str, Dict[str, np.ndarray]] = {}
        self.tvec: Dict[str, Dict[str, np.ndarray]] = {}
        self.pose3d: Dict[Tuple[str, int], np.ndarray] = {}
        for i in dirs:
            sub = f"data_{i}"
            frame_dir = os.path.join(data_dir, "annotated_frames", sub)
            if not os.path.isdir(frame_dir):
                continue
            self.rvec[sub] = {}
            self.tvec[sub] = {}
            for cam in range(1, 5):
                calib = os.path.join(data_dir, "calibrations", sub, f"webcam_{cam}")
                with open(os.path.join(calib, "rvec.pkl"), "rb") as f:
                    self.rvec[sub][str(cam)] = pickle.load(f, encoding="latin1")
                with open(os.path.join(calib, "tvec.pkl"), "rb") as f:
                    self.tvec[sub][str(cam)] = pickle.load(f, encoding="latin1")
            n_frames = len(os.listdir(frame_dir)) // 4
            for fidx in range(n_frames):
                anno = os.path.join(data_dir, "annotations", sub, f"{fidx}_joints.txt")
                self.pose3d[(sub, fidx)] = read_annotation_3d(anno)[IDX_MHP]
                self.frames.append((sub, fidx))

    def __len__(self) -> int:
        return len(self.frames)

    def _view(self, sub: str, fidx: int, cam: int, occlude: bool = True):
        """Load one calibrated view: image + projected 2D + extrinsics."""
        img_path = os.path.join(self.data_dir, "annotated_frames", sub,
                                f"{fidx}_webcam_{cam}.jpg")
        img = bgr_to_rgb(imread(img_path))
        pose3d_world = self.pose3d[(sub, fidx)]
        R = rodrigues(self.rvec[sub][str(cam)])
        t = np.asarray(self.tvec[sub][str(cam)], np.float32).reshape(3, 1)
        extrinsic = np.concatenate([R, t], axis=1)                    # 3x4
        cam_pts = (R @ pose3d_world.T + t)                            # 3x21
        uvw = INTRINSICS @ cam_pts
        pose2d = (uvw[:2] / uvw[2:]).T.astype(np.float32)             # 21x2

        vis = np.ones((21, 1), np.float32)
        if occlude:
            # seeded by 4 * frame + cam (MHPMultiViewDataset.py:170-171)
            rng = np.random.default_rng(4 * fidx + cam)
            center = pose2d[int(rng.integers(0, 21))].astype(int)
            img = circle_filled(img, center.tolist(), OCCLUSION_RADIUS, (0, 0, 0))
            d = np.linalg.norm(pose2d - center, axis=1)
            vis[d <= OCCLUSION_RADIUS] = 0.0
        h, w = img.shape[:2]
        oob = (pose2d[:, 0] < 0) | (pose2d[:, 1] < 0) | \
              (pose2d[:, 0] >= w) | (pose2d[:, 1] >= h)
        vis[oob] = 0.0
        return img, pose2d, vis, extrinsic, pose3d_world


class MHPDataset(_MHPBase):
    """Single-view samples: every (frame, cam) pair is one item
    (reference MHPDataset.py)."""

    def __init__(self, root: str, subset: str, data_format=None, transforms=None,
                 occlude: bool = False):
        super().__init__(os.path.join(root, "MHP"), subset)
        self.transform = transforms
        self.occlude = occlude

    def __len__(self) -> int:
        return 4 * len(self.frames)

    def __getitem__(self, idx: int):
        sub, fidx = self.frames[idx // 4]
        cam = idx % 4 + 1
        img, pose2d, vis, extrinsic, pose3d = self._view(sub, fidx, cam, self.occlude)
        orig = img
        if self.transform is not None:
            img, joints = self.transform(img, [pose2d])
            pose2d = np.asarray(joints[0], np.float32)
        return {
            "orig_imgs": orig,
            "imgs": np.asarray(img, np.float32),
            "pose2d": pose2d,
            "pose3d": pose3d,
            "visibility": vis,
            "extrinsic_matrices": extrinsic,
            "intrinsic_matrix": INTRINSICS,
        }


class MHPDatasetKeypoints(MHPDataset):
    """Single-view + transform chain + heatmaps (reference MHPDatasetKeypoints.py)."""

    def __init__(self, cfg, subset: str, heatmap_generator=None, transforms=None):
        MHPDataset.__init__(self, cfg.DATA_DIR, subset, cfg.DATASET.DATA_FORMAT, None)
        self.transforms = transforms
        self.hm_size = int(cfg.MODEL.HEATMAP_SIZE[0])
        self.sigma = float(cfg.MODEL.SIGMA)
        self.heatmap_generator = heatmap_generator
        self.exception = False

    def __getitem__(self, idx: int):
        sub, fidx = self.frames[idx // 4]
        cam = idx % 4 + 1
        img, pose2d, vis, extrinsic, pose3d = self._view(sub, fidx, cam, occlude=False)
        img, joints = self.transforms(img, [pose2d])
        pose2d = np.asarray(joints[0], np.float32)
        if self.heatmap_generator is not None:
            heatmaps = self.heatmap_generator(pose2d, vis[:, 0])
        else:
            heatmaps = gaussian_targets_np(pose2d, vis[:, 0], self.hm_size, self.sigma)
        return {
            "imgs": img.astype(np.float32),
            "pose2d": pose2d,
            "pose3d": pose3d,
            "heatmaps": heatmaps.astype(np.float32),
            "visibility": vis,
            "extrinsic_matrices": extrinsic,
            "intrinsic_matrix": INTRINSICS,
        }


class MHPMultiViewDataset(_MHPBase):
    """All four calibrated views per frame + occlusion augmentation
    (reference MHPMultiViewDataset.py:31-222)."""

    def __init__(self, cfg, subset: str, heatmap_generator=None, transform=None):
        super().__init__(os.path.join(cfg.DATA_DIR, "MHP"), subset)
        self.transform = transform
        self.heatmap_generator = heatmap_generator
        self.hm_size = int(cfg.MODEL.HEATMAP_SIZE[0])
        self.sigma = float(cfg.MODEL.SIGMA)
        self.n_views = int(cfg.DATASET.NUM_VIEWS)
        self.exception = False

    def __getitem__(self, idx: int):
        sub, fidx = self.frames[idx]
        imgs, origs, poses2d, viss, exts, hms = [], [], [], [], [], []
        pose3d = self.pose3d[(sub, fidx)]
        for cam in range(1, self.n_views + 1):
            img, pose2d, vis, extrinsic, _ = self._view(sub, fidx, cam, occlude=True)
            origs.append(img)
            if self.transform is not None:
                img, joints = self.transform(img, [pose2d])
                pose2d = np.asarray(joints[0], np.float32)
            if self.heatmap_generator is not None:
                hms.append(self.heatmap_generator(pose2d, vis[:, 0]))
            else:
                hms.append(gaussian_targets_np(pose2d, vis[:, 0], self.hm_size, self.sigma))
            imgs.append(np.asarray(img, np.float32))
            poses2d.append(pose2d)
            viss.append(vis)
            exts.append(extrinsic)
        return {
            "orig_imgs": np.stack(origs),
            "imgs": np.stack(imgs),
            "pose2d": np.stack(poses2d),
            "pose3d": pose3d,
            "visibility": np.stack(viss),
            "extrinsic_matrices": np.stack(exts),
            "intrinsic_matrix": INTRINSICS,
            "heatmaps": np.stack(hms),
        }


class MHPSeqDataset(_MHPBase):
    """Temporal windows for PredRNN/TCN/PoseAggr (reference MHPSeqDataset.py):
    item = all views of frames ``fidx + stride*seq_idx`` for each offset in
    SEQ_IDX, folded as (views*frames, ...)."""

    def __init__(self, cfg, subset: str, heatmap_generator=None, transform=None):
        super().__init__(os.path.join(cfg.DATA_DIR, "MHP"), subset)
        self.transform = transform
        self.heatmap_generator = heatmap_generator
        self.hm_size = int(cfg.MODEL.HEATMAP_SIZE[0])
        self.sigma = float(cfg.MODEL.SIGMA)
        self.seq_idx = [int(i) for i in cfg.DATASET.SEQ_IDX]
        self.stride = int(cfg.DATASET.STRIDE)
        self.n_views = int(cfg.DATASET.NUM_VIEWS)
        # valid anchors: whole window stays inside the same data_ subdir
        self.anchors = []
        per_sub: Dict[str, int] = {}
        for sub, fidx in self.frames:
            per_sub[sub] = max(per_sub.get(sub, 0), fidx + 1)
        for sub, fidx in self.frames:
            lo = fidx + self.stride * min(self.seq_idx)
            hi = fidx + self.stride * max(self.seq_idx)
            if lo >= 0 and hi < per_sub[sub]:
                self.anchors.append((sub, fidx))
        self.exception = False

    def __len__(self) -> int:
        return len(self.anchors)

    def __getitem__(self, idx: int):
        sub, fidx = self.anchors[idx]
        imgs, poses2d, viss, hms = [], [], [], []
        for off in self.seq_idx:
            f = fidx + self.stride * off
            for cam in range(1, self.n_views + 1):
                img, pose2d, vis, _, _ = self._view(sub, f, cam, occlude=False)
                if self.transform is not None:
                    img, joints = self.transform(img, [pose2d])
                    pose2d = np.asarray(joints[0], np.float32)
                hms.append(gaussian_targets_np(pose2d, vis[:, 0], self.hm_size, self.sigma))
                imgs.append(np.asarray(img, np.float32))
                poses2d.append(pose2d)
                viss.append(vis)
        return {
            "imgs": np.stack(imgs),            # (F*V, H, W, 3)
            "pose2d": np.stack(poses2d),
            "heatmaps": np.stack(hms),
            "visibility": np.stack(viss),
            "pose3d": self.pose3d[(sub, fidx)],
        }


# ----------------------------------------------------------------- CPM path
def _cpm_center(pose2d: np.ndarray, h: int, w: int) -> np.ndarray:
    """Hand centre as the midpoint of the in-frame coordinate extents
    (reference MHP_CPMDataset.py:171-184; falls back to the image centre)."""

    def mid(vals, lim):
        hi = vals[vals < lim]
        lo = vals[vals > 0]
        if hi.size == 0 or lo.size == 0:
            return lim / 2.0
        return float(hi.max() + lo.min()) / 2.0

    return np.array([mid(pose2d[:, 0], w), mid(pose2d[:, 1], h)], np.float32)


def _cpm_centermap_np(center: np.ndarray, res: int) -> np.ndarray:
    """(res, res, 1) sigma-3 centre map, clipped like the reference
    (MHP_CPMDataset.py:220-224: <=1, zeroed below 0.0099)."""
    g = np.arange(res, dtype=np.float32)
    d2 = (g[None, :] - center[0]) ** 2 + (g[:, None] - center[1]) ** 2
    m = np.exp(-d2 / (2.0 * 3.0 * 3.0))
    m[m > 1] = 1
    m[m < 0.0099] = 0
    return m[..., None].astype(np.float32)


def cpm_normalize(img: np.ndarray) -> np.ndarray:
    """CPM image normalisation: (x - 128)/256 on the raw 0-255 image
    (Mytransforms.normalize with mean 128 / std 256 on an UNscaled
    to_tensor — MHP_CPMDataset.py:226-227)."""
    return (np.asarray(img, np.float32) - 128.0) / 256.0


class MHPCPMDataset(MHPDataset):
    """CPM single-view variant (reference MHP_CPMDataset.py:100-240):
    image resized to the model input, (K+1)-channel stride-divided targets
    with a background channel at index 0, sigma-3 centre map at input
    resolution, CPM (x-128)/256 normalisation, pose2d emitted in heatmap
    pixels.  The reference's random Mytransforms augmentation chain is not
    replicated (documented divergence): this path matches its eval-time
    geometry."""

    def __init__(self, cfg, subset: str, heatmap_generator=None, transforms=None):
        MHPDataset.__init__(self, cfg.DATA_DIR, subset, cfg.DATASET.DATA_FORMAT, None)
        self.input_size = int(cfg.MODEL.IMAGE_SIZE[0])
        self.hm_size = int(cfg.MODEL.HEATMAP_SIZE[0])
        self.sigma = float(cfg.DATASET.SIGMA)
        self.stride = self.input_size / self.hm_size
        self.exception = False

    def __getitem__(self, idx: int):
        sub, fidx = self.frames[idx // 4]
        cam = idx % 4 + 1
        img, pose2d, vis, extrinsic, pose3d = self._view(sub, fidx, cam,
                                                         occlude=False)
        h0, w0 = img.shape[:2]
        img = resize(img, (self.input_size, self.input_size))
        pose2d = pose2d * np.array([self.input_size / w0, self.input_size / h0],
                                   np.float32)
        center = _cpm_center(pose2d, self.input_size, self.input_size)
        heatmaps = cpm_heatmaps_np(pose2d, self.hm_size, self.sigma, self.stride)
        return {
            "imgs": cpm_normalize(img),
            "pose2d": (pose2d / self.stride).astype(np.float32),
            "heatmaps": heatmaps,
            "visibility": vis,
            "centermaps": _cpm_centermap_np(center, self.input_size),
            "extrinsic_matrices": extrinsic,
            "intrinsic_matrix": INTRINSICS,
            "pose3d": pose3d,
        }


class MHPCPMMultiViewDataset(MHPMultiViewDataset):
    """CPM multi-view variant (reference MHP_CPMMultiViewDataset.py:36-270):
    per-view CPM targets + centre maps alongside the calibrated projections;
    ``factor = input_size / hm_size`` as in reference :212-214."""

    def __init__(self, cfg, subset: str, heatmap_generator=None, transform=None):
        super().__init__(cfg, subset, heatmap_generator, transform)
        self.input_size = int(cfg.MODEL.IMAGE_SIZE[0])

    def __getitem__(self, idx: int):
        sub, fidx = self.frames[idx]
        imgs, poses2d, viss, exts, hms, cms = [], [], [], [], [], []
        input_size = self.input_size
        factor = input_size / self.hm_size
        for cam in range(1, self.n_views + 1):
            img, pose2d, vis, extrinsic, _ = self._view(sub, fidx, cam,
                                                        occlude=True)
            h0, w0 = img.shape[:2]
            img = resize(img, (input_size, input_size))
            pose2d = pose2d * np.array([input_size / w0, input_size / h0],
                                       np.float32)
            center = _cpm_center(pose2d, input_size, input_size)
            hms.append(cpm_heatmaps_np(pose2d, self.hm_size, self.sigma, factor))
            cms.append(_cpm_centermap_np(center, input_size))
            imgs.append(cpm_normalize(img))
            poses2d.append((pose2d / factor).astype(np.float32))
            viss.append(vis)
            exts.append(extrinsic)
        return {
            "imgs": np.stack(imgs),
            "pose2d": np.stack(poses2d),
            "heatmaps": np.stack(hms),
            "visibility": np.stack(viss),
            "centermaps": np.stack(cms),
            "extrinsic_matrices": np.stack(exts),
            "intrinsic_matrix": INTRINSICS,
            "pose3d": self.pose3d[(sub, fidx)],
        }
