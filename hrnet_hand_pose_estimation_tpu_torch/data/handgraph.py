"""HandGraph (CMU "3D Hand Shape and Pose", synthetic) readers and the
camera and mesh utilities.

Port of the JAX package's ``data/handgraph.py`` (reference
lib/dataset/HandGraphDataset.py:34-135, HandGraphDatasetKeypoints.py:18-148
and HandGraph_utils/utils.py:12-245):

- ``images/l*/cam*/*.png``: RGBA 360x360 renders, read with
  ``IMREAD_UNCHANGED`` (decoded in numpy) and cut to RGB; the validation
  split is the camera folders listed in ``3D_labels/val-camera.txt``;
- file names like ``handV2_..._l21_cam01_.0001.png``: the pose id is the
  last ``_`` field with the leading dot zeroed, minus one; the camera id the
  ``cam`` field minus one;
- ``3D_labels/camPosition.txt`` (N_pose, N_cam, 7) and
  ``3D_labels/handGestures.txt`` (N_pose, 21, 3);
- the camera: R = Rz Ry Rx from xyz euler degrees, flipped by
  diag(1, -1, -1), applied as ``(x - t) @ R``; K = [[f, 0, W/2], [0, f, H/2],
  [0, 0, 1]];
- the ``.obj`` hand-mesh loader with the arm's vertices stripped.

No shipped YAML's name reaches these readers' raw class through the
registry: ``HandGraph`` is not registered in either package (ROADMAP C25);
``HandGraph_kpt`` is.
"""

from __future__ import annotations

import glob
import math
import os.path as osp
from typing import List, Sequence, Tuple

import numpy as np

from ..ops.targets import gaussian_targets_np
from ..utils.zipreader import IMREAD_UNCHANGED, imread
from .cv import bgr_to_rgb

# (reference HandGraph_utils/utils.py, vectorised where the original loops)

def get_train_val_im_paths(image_dir: str, val_set_path: str,
                           train_val_flag: str) -> List[str]:
    """Image paths of the train or val split (utils.py:12-38): validation =
    cameras whose folder name appears in val-camera.txt."""
    with open(val_set_path) as reader:
        val_cameras = {line.strip() for line in reader if line.strip()}
    image_paths: List[str] = []
    for lighting_folder in sorted(glob.glob(osp.join(image_dir, "l*"))):
        for cam_folder in sorted(glob.glob(osp.join(lighting_folder, "cam*"))):
            is_val = osp.basename(cam_folder) in val_cameras
            if (train_val_flag in ("val", "evaluation") and is_val) or \
                    (train_val_flag in ("train", "training") and not is_val):
                image_paths += sorted(glob.glob(osp.join(cam_folder, "*.png")))
    return image_paths


def extract_pose_camera_id(im_filename: str) -> Tuple[int, int]:
    """'..._l21_cam01_.0001.png' -> (pose_id, camera_id), both 0-based
    (utils.py:41-51)."""
    fields = osp.splitext(im_filename)[0].split("_")
    pose_id = int(fields[-1].replace(".", "0")) - 1
    camera_id = int(fields[-2][3:]) - 1
    return pose_id, camera_id


def load_camera_param(camera_param_path: str) -> np.ndarray:
    """camPosition.txt -> (N_pose, N_cam, 7): f, t(3), euler xyz deg
    (utils.py:54-65; first column is the camera name)."""
    names = np.loadtxt(camera_param_path, usecols=(0,), dtype=str)
    num_cameras = len(np.unique(names))
    params = np.loadtxt(camera_param_path, usecols=(1, 2, 3, 4, 5, 6, 7))
    return params.reshape((-1, num_cameras, 7))


def load_global_pose3d_gt(pose3d_gt_path: str) -> np.ndarray:
    """handGestures.txt -> (N_pose, 21, 3) (utils.py:68-77; first column is
    the joint name)."""
    names = np.loadtxt(pose3d_gt_path, usecols=(0,), dtype=str)
    num_joints = len(np.unique(names))
    vals = np.loadtxt(pose3d_gt_path, usecols=(1, 2, 3))
    return vals.reshape((-1, num_joints, 3))


def euler_xyz_to_rot_mx(euler_angle: np.ndarray) -> np.ndarray:
    """xyz euler angles (degrees) -> R = Rz @ Ry @ Rx (utils.py:80-100)."""
    rad = np.asarray(euler_angle, np.float64) * math.pi / 180.0
    s, c = np.sin(rad), np.cos(rad)
    rot_x = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    rot_y = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    rot_z = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    return rot_z @ rot_y @ rot_x


def transform_global_to_cam(global_3d: np.ndarray, camera_param: np.ndarray,
                            use_translation: bool = True) -> np.ndarray:
    """Global -> camera frame: ``(x - t) @ (R @ diag(1,-1,-1))``
    (utils.py:103-125 — right-multiplication, y/z axes flipped)."""
    pose3d = global_3d - camera_param[1:4] if use_translation else global_3d
    rot_mx = euler_xyz_to_rot_mx(camera_param[4:7])
    aux_mx = np.diag([1.0, -1.0, -1.0])
    return pose3d @ (rot_mx @ aux_mx)


def cam_projection(local_pose3d: np.ndarray, cam_proj_mat: np.ndarray) -> np.ndarray:
    """Pinhole projection (utils.py:128-140)."""
    xyz = local_pose3d @ cam_proj_mat.T
    return xyz[:, :2] / xyz[:, 2:3]


def cam_deprojection(pose_2d: np.ndarray, cam_proj_mat: np.ndarray,
                     z=1.0) -> np.ndarray:
    """2D points + reference depth -> 3D rays (utils.py:142-152)."""
    ones = np.ones((pose_2d.shape[0], 1), dtype=pose_2d.dtype)
    hetero = z * np.hstack((pose_2d, ones))
    return hetero @ np.linalg.inv(cam_proj_mat.T)


def load_mesh_from_obj(mesh_file: str,
                       arm_index_range: Sequence[int] = (473, 529)):
    """Hand-mesh .obj loader (utils.py:155-192): vertices, per-face normals
    (every 3rd ``vn``), triangle indices; optionally strips arm vertices."""
    mesh_pts, mesh_tri_idx, mesh_vn = [], [], []
    id_vn, state = 0, "V"
    with open(mesh_file) as reader:
        for line in reader:
            fields = line.strip().split()
            if not fields:
                continue
            if fields[0] == "v":
                if state != "V":
                    break
                mesh_pts.append([float(f) for f in fields[1:]])
            elif fields[0] == "f":
                state = "F"
                mesh_tri_idx.append([int(f.split("/")[0]) - 1 for f in fields[1:]])
            elif fields[0] == "vn":
                state = "N"
                if id_vn % 3 == 0:
                    mesh_vn.append([float(f) for f in fields[1:]])
                id_vn += 1
    mesh_pts = np.array(mesh_pts)
    mesh_vn = np.array(mesh_vn)
    mesh_tri_idx = np.array(mesh_tri_idx)
    if len(arm_index_range) > 1 and arm_index_range[1] > arm_index_range[0]:
        return remove_arm_vertices(mesh_pts, mesh_vn, mesh_tri_idx,
                                   arm_index_range)
    return mesh_pts, mesh_vn, mesh_tri_idx


def remove_arm_vertices(mesh_pts, mesh_vn, mesh_tri_idx, arm_index_range):
    """Strip arm-range vertices and reindex faces (utils.py:211-245),
    vectorised: a face survives iff none of its vertices is in the range."""
    lo, hi = arm_index_range[0], arm_index_range[1]
    keep_vertex = np.ones(len(mesh_pts), bool)
    keep_vertex[lo:hi] = False
    hand_mesh_pts = mesh_pts[keep_vertex]
    if np.size(mesh_tri_idx) <= 1:
        return hand_mesh_pts, [], []
    in_arm = (mesh_tri_idx >= lo) & (mesh_tri_idx < hi)
    keep_face = ~in_arm.any(axis=1)
    tri = mesh_tri_idx[keep_face]
    tri = np.where(tri >= hi, tri - (hi - lo), tri)
    # the obj may carry more per-vertex normals than faces; the reference
    # indexes normals by face id, so align before masking
    vn = mesh_vn[:len(mesh_tri_idx)] if len(mesh_vn) >= len(mesh_tri_idx) else mesh_vn
    return hand_mesh_pts, (vn[keep_face] if len(vn) == len(keep_face) else vn), tri


def get_mesh_tri_vertices(mesh_vertices: np.ndarray,
                          mesh_tri_idx: np.ndarray) -> np.ndarray:
    """(N_tris, 3, 3) coordinates of each face's vertices (utils.py:195-208)."""
    return mesh_vertices[mesh_tri_idx]


# ---------------------------------------------------------------- dataset

class HandGraphDataset:
    """Raw reader (reference HandGraphDataset.py:34-135)."""

    name = "HandGraph"
    orig_img_size = (360, 360)

    def __init__(self, root: str, set_name: str, data_format=None,
                 transforms=None):
        self.data_dir = osp.join(root, self.name)
        self.set_name = set_name
        self.transform = transforms
        labels = osp.join(self.data_dir, "3D_labels")
        self.image_dir = osp.join(self.data_dir, "images")
        self.global_mesh_gt_dir = osp.join(self.data_dir, "hand_3D_mesh")
        self.image_paths = get_train_val_im_paths(
            self.image_dir, osp.join(labels, "val-camera.txt"), set_name)
        self.all_camera_params = load_camera_param(
            osp.join(labels, "camPosition.txt"))
        self.all_global_pose3d_gt = load_global_pose3d_gt(
            osp.join(labels, "handGestures.txt"))

    def __len__(self):
        return len(self.image_paths)

    def _load_raw(self, idx: int):
        img_path = self.image_paths[idx]
        pose_id, camera_id = extract_pose_camera_id(osp.basename(img_path))
        cam_param = self.all_camera_params[pose_id][camera_id]
        local_pose3d = transform_global_to_cam(
            self.all_global_pose3d_gt[pose_id], cam_param)

        rgba = imread(img_path, IMREAD_UNCHANGED)
        img = bgr_to_rgb(rgba[:, :, :3])
        h, w = img.shape[:2]
        fl = cam_param[0]
        K = np.array([[fl, 0, w / 2.0], [0, fl, h / 2.0], [0, 0, 1.0]],
                     np.float64)
        pose2d = cam_projection(local_pose3d, K).astype(np.float32)
        return img, pose2d, local_pose3d.astype(np.float32), K, img_path

    def __getitem__(self, idx: int):
        img, pose2d, pose3d, K, img_path = self._load_raw(idx)
        visibility = np.ones((21, 1), np.float32)
        if self.transform is not None:
            img, joints = self.transform(
                img, [np.concatenate([pose2d, visibility], axis=1)])
            pose2d = np.asarray(joints[0], np.float32)[:, :2]
        return {
            "imgs": np.asarray(img, np.float32),
            "pose2d": pose2d,
            "pose3d": pose3d,
            "visibility": visibility,
            "K": K.astype(np.float32),
            "img_path": img_path,
        }


class HandGraphDatasetKeypoints(HandGraphDataset):
    """Training reader: transform chain + Gaussian heatmaps
    (reference HandGraphDatasetKeypoints.py:18-148)."""

    def __init__(self, cfg, set_name: str, heatmap_generator=None,
                 transforms=None):
        super().__init__(cfg.DATA_DIR, set_name, cfg.DATASET.DATA_FORMAT, None)
        self.transforms = transforms
        self.hm_size = int(cfg.MODEL.HEATMAP_SIZE[0])
        self.sigma = float(cfg.MODEL.SIGMA)
        self.heatmap_generator = heatmap_generator
        self.exception = False

    def __getitem__(self, idx: int):
        img, pose2d, pose3d, K, _ = self._load_raw(idx)
        vis = np.ones((21,), np.float32)
        if self.transforms is not None:
            img, joints = self.transforms(
                img, [np.concatenate([pose2d, vis[:, None]], axis=1)])
            pose2d = np.asarray(joints[0], np.float32)[:, :2]
        hms = (self.heatmap_generator(pose2d, vis) if self.heatmap_generator
               else gaussian_targets_np(pose2d, vis, self.hm_size, self.sigma))
        return {
            "imgs": np.asarray(img, np.float32),
            "pose2d": pose2d,
            "pose3d": pose3d,
            "heatmaps": hms.astype(np.float32),
            "visibility": vis[:, None],
        }
