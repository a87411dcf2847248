"""FHA (First-Person Hand Action) readers and the object and skeleton
helpers.

Port of the JAX package's ``data/fha.py`` (reference
lib/dataset/FHADataset.py:30-231 and FHA_utils.py:10-45):

- ``Videos/Subject_k/<action>/<seq>/color/color_%04d.jpeg`` frames;
  ``Hand_pose_annotation_v1/Subject_k/<action>/<seq>/skeleton.txt``: a
  frame id and 63 floats (21 world joints, mm) per row;
  ``Object_6D_pose_annotation_v1/.../object_pose.txt`` 4x4 object poses;
  ``Object_models/<name>_model/<name>_model.ply`` object meshes (ascii PLY);
- the skeleton reordered by ``REORDER_IDX``; 3D in camera coordinates
  through the published extrinsic, 2D its intrinsic projection, joints
  outside the 1920x1080 frame invisible;
- samples are windows of ``n_frames`` frames at ``stride``.

The frames are JPEG: on a machine without cv2 only PNG content under
their names is read (``utils/zipreader.imread``).  ``FHA`` is not
registered in either package (ROADMAP C25); ``FHA_kpt`` is.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List, Tuple

import numpy as np

from ..ops.targets import gaussian_targets_np
from ..utils.zipreader import IMREAD_COLOR, IMREAD_IGNORE_ORIENTATION, imread
from .cv import bgr_to_rgb

# published FHA color-camera calibration (reference FHA_utils.py:116-123)
CAM_EXTR = np.array([
    [0.999988496304, -0.00468848412856, 0.000982563360594, 25.7],
    [0.00469115935266, 0.999985218048, -0.00273845880292, 1.22],
    [-0.000969709653873, 0.00274303671904, 0.99999576807, 3.902],
    [0.0, 0.0, 0.0, 1.0],
], dtype=np.float64)
CAM_INTR = np.array([
    [1395.749023, 0.0, 935.732544],
    [0.0, 1395.749268, 540.681030],
    [0.0, 0.0, 1.0],
], dtype=np.float64)
ORIG_SIZE = (1920, 1080)

# skeleton.txt joint order -> standard legend (FHADataset.py:87-91)
REORDER_IDX = np.array([0, 1, 6, 7, 8, 2, 9, 10, 11, 3, 12, 13, 14,
                        4, 15, 16, 17, 5, 18, 19, 20])

OBJECT_NAMES = ("juice_bottle", "liquid_soap", "milk", "salt")

TRAIN_SUBJECTS = ["Subject_1", "Subject_2", "Subject_3", "Subject_4"]
EVAL_SUBJECTS = ["Subject_5", "Subject_6"]


def world_to_cam(skel_world: np.ndarray) -> np.ndarray:
    """(N, 3) world mm -> camera coords (FHADataset.py:163-165)."""
    hom = np.concatenate([skel_world, np.ones((len(skel_world), 1))], axis=1)
    return (CAM_EXTR @ hom.T).T[:, :3].astype(np.float32)


def project_fha(skel_world: np.ndarray) -> np.ndarray:
    """World skeleton (N, 3) -> image plane (N, 2) (FHADataset.py:163-167)."""
    cam = world_to_cam(skel_world)
    uvw = (CAM_INTR @ cam.T).T
    return (uvw[:, :2] / uvw[:, 2:3]).astype(np.float32)


def get_skeleton(sample: Dict, skel_root: str) -> np.ndarray:
    """One frame's raw (21, 3) skeleton (FHA_utils.py:24-32; NOT reordered)."""
    path = osp.join(skel_root, sample["subject"], sample["action_name"],
                    sample["seq_idx"], "skeleton.txt")
    vals = np.loadtxt(path)
    if vals.ndim == 1:
        vals = vals[None]
    return vals[:, 1:].reshape(vals.shape[0], 21, -1)[sample["frame_idx"]]


def get_obj_transform(sample: Dict, obj_root: str) -> np.ndarray:
    """Frame's 4x4 object pose; file stores it transposed
    (FHA_utils.py:35-45)."""
    path = osp.join(obj_root, sample["subject"], sample["action_name"],
                    sample["seq_idx"], "object_pose.txt")
    with open(path) as f:
        line = f.readlines()[sample["frame_idx"]].strip().split(" ")
    return np.array(line[1:], np.float32).reshape(4, 4).T


def _load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal ascii-PLY vertex/face loader (the reference uses trimesh,
    FHA_utils.py:10-21; trimesh is not in this image)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    n_v = n_f = 0
    i = 0
    for i, ln in enumerate(lines):
        if ln.startswith("element vertex"):
            n_v = int(ln.split()[-1])
        elif ln.startswith("element face"):
            n_f = int(ln.split()[-1])
        elif ln == "end_header":
            break
    body = lines[i + 1:]
    verts = np.array([[float(x) for x in ln.split()[:3]]
                      for ln in body[:n_v]])
    faces = np.array([[int(x) for x in ln.split()[1:4]]
                      for ln in body[n_v:n_v + n_f]], dtype=np.int64)
    return verts, faces


def load_objects(obj_root: str) -> Dict[str, Dict[str, np.ndarray]]:
    """{name: {verts, faces}} for the four FHA objects (FHA_utils.py:10-21)."""
    models = {}
    for name in OBJECT_NAMES:
        path = osp.join(obj_root, f"{name}_model", f"{name}_model.ply")
        if not osp.isfile(path):
            continue
        verts, faces = _load_ply(path)
        models[name] = {"verts": verts, "faces": faces}
    return models


def transform_obj_verts(verts: np.ndarray, obj_trans: np.ndarray) -> np.ndarray:
    """Object-model mm verts -> camera coords (FHA_utils.py:131-144):
    scale x1000, apply the 4x4 object pose, then the camera extrinsic."""
    hom = np.concatenate([verts * 1000.0, np.ones((len(verts), 1))], axis=1)
    world = (obj_trans @ hom.T).T
    return (CAM_EXTR @ world.T).T[:, :3]


class FHADataset:
    name = "FHA"
    orig_img_size = list(ORIG_SIZE)

    def __init__(self, root: str, set_name: str, data_format=None,
                 transforms=None, n_frames: int = 1, stride: int = 1):
        self.video_root = osp.join(root, self.name, "Videos")
        skel_candidates = [osp.join(root, self.name, "Hand_pose_annotation_v1"),
                           osp.join(root, "Hand_pose_annotation_v1")]
        self.skel_root = next((p for p in skel_candidates if osp.isdir(p)),
                              skel_candidates[0])
        self.transform = transforms
        self.n_frames = max(1, int(n_frames))
        self.stride = max(1, int(stride))
        subjects = TRAIN_SUBJECTS if set_name in ("train", "training") else EVAL_SUBJECTS
        self.samples: List[Tuple[str, int]] = []   # (video_rel_dir, start frame)
        self.skeletons = {}
        for sub in subjects:
            sub_dir = osp.join(self.video_root, sub)
            if not osp.isdir(sub_dir):
                continue
            for action in sorted(os.listdir(sub_dir)):
                for seq in sorted(os.listdir(osp.join(sub_dir, action))):
                    rel = osp.join(sub, action, seq)
                    skel_path = osp.join(self.skel_root, rel, "skeleton.txt")
                    color_dir = osp.join(self.video_root, rel, "color")
                    if not (osp.isfile(skel_path) and osp.isdir(color_dir)):
                        continue
                    vals = np.loadtxt(skel_path)
                    if vals.ndim == 1:
                        vals = vals[None]
                    # reorder to standard legend (FHADataset.py:150)
                    self.skeletons[rel] = vals[:, 1:].reshape(-1, 21, 3)[:, REORDER_IDX]
                    n = min(len(vals), len(os.listdir(color_dir)))
                    # window count (FHADataset.py:215: n - stride*(NFrames-1))
                    n_windows = n - self.stride * (self.n_frames - 1)
                    self.samples += [(rel, i) for i in range(max(0, n_windows))]

    def __len__(self):
        return len(self.samples)

    def _frame(self, rel: str, frame: int):
        img_path = osp.join(self.video_root, rel, "color",
                            "color_%04d.jpeg" % frame)
        img = imread(img_path, IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION)
        return bgr_to_rgb(img), img_path

    def _load_raw(self, idx: int):
        """One window: stacked frames + per-frame cam-coord 3D + projected 2D
        with in-frame visibility (FHADataset.py:144-190)."""
        rel, start = self.samples[idx]
        frames, pose3d_cam, pose2d, vis, paths = [], [], [], [], []
        for i in range(start, start + self.stride * self.n_frames, self.stride):
            img, img_path = self._frame(rel, i)
            skel = self.skeletons[rel][i]
            cam = world_to_cam(skel)
            uvw = (CAM_INTR @ cam.astype(np.float64).T).T
            uv = (uvw[:, :2] / uvw[:, 2:3]).astype(np.float32)
            v = ((uv[:, 0] >= 0) & (uv[:, 0] < ORIG_SIZE[0])
                 & (uv[:, 1] >= 0) & (uv[:, 1] < ORIG_SIZE[1])).astype(np.float32)
            frames.append(img)
            pose3d_cam.append(cam)
            pose2d.append(uv)
            vis.append(v)
            paths.append(img_path)
        return frames, pose2d, pose3d_cam, vis, paths

    def __getitem__(self, idx: int):
        frames, pose2d, pose3d, vis, paths = self._load_raw(idx)
        if self.transform is not None:
            outs = [self.transform(f, [np.concatenate(
                [p, v[:, None]], axis=1)]) for f, p, v in zip(frames, pose2d, vis)]
            frames = [o[0] for o in outs]
            pose2d = [np.asarray(o[1][0], np.float32)[:, :2] for o in outs]
        if self.n_frames == 1:
            return {
                "imgs": np.asarray(frames[0], np.float32),
                "pose2d": pose2d[0],
                "pose3d": pose3d[0],
                "visibility": vis[0][:, None],
                "img_path": paths[0],
            }
        return {
            "imgs": np.stack([np.asarray(f, np.float32) for f in frames]),
            "pose2d": np.stack(pose2d),
            "pose3d": np.stack(pose3d),
            "visibility": np.stack(vis)[..., None],
            "img_paths": paths,
        }


class FHADatasetKeypoints(FHADataset):
    def __init__(self, cfg, set_name: str, heatmap_generator=None,
                 transforms=None):
        super().__init__(cfg.DATA_DIR, set_name, cfg.DATASET.DATA_FORMAT, None)
        self.transforms = transforms
        self.hm_size = int(cfg.MODEL.HEATMAP_SIZE[0])
        self.sigma = float(cfg.MODEL.SIGMA)
        self.heatmap_generator = heatmap_generator
        self.exception = False

    def __getitem__(self, idx: int):
        frames, pose2d, pose3d, vis, _ = self._load_raw(idx)
        img, uv, v = frames[0], pose2d[0], vis[0]
        if self.transforms is not None:
            img, joints = self.transforms(
                img, [np.concatenate([uv, v[:, None]], axis=1)])
            uv = np.asarray(joints[0], np.float32)[:, :2]
        hms = (self.heatmap_generator(uv, v) if self.heatmap_generator
               else gaussian_targets_np(uv, v, self.hm_size, self.sigma))
        return {
            "imgs": np.asarray(img, np.float32),
            "pose2d": uv,
            "pose3d": pose3d[0],
            "heatmaps": hms.astype(np.float32),
            "visibility": v[:, None],
        }
