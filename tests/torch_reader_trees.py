"""Tiny on-disk trees of every dataset format the readers take, written
without cv2 or JAX.

Each ``write_*`` lays out one dataset under ``root`` in its own file names
and formats (pickles, json, txt, ``.mat``, ``.ply``), with seeded data: hand
keypoints that fall inside the frames and images of smooth gradients plus
noise.  Every image is PNG content, written here with ``zlib``, also under
the ``.jpg`` / ``.jpeg`` names of the formats that ship JPEGs, so that a
machine without cv2 decodes all of it (``utils/zipreader`` of the port reads
PNG by its signature).  ``filters="mixed"`` cycles the five PNG row filters;
the default, Sub on every row, is what ``cv2.imwrite`` writes with its
default settings.

``chip_smoke.py`` loads this file by path; the CPU reader tests import it.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
import zlib
from pathlib import Path
from typing import Dict

import numpy as np

MHP_INTRINSICS = np.array([[614.878, 0.0, 313.219], [0.0, 615.479, 231.288], [0.0, 0.0, 1.0]])
FREI_N_UNIQUE = 32560
FREI_EVAL_START = int(FREI_N_UNIQUE * 0.8)
FHA_CAM_INTR = np.array([[1395.749023, 0.0, 935.732544], [0.0, 1395.749268, 540.681030],
                         [0.0, 0.0, 1.0]])


# ------------------------------------------------------------------- PNG
def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_row(ft: int, row: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """PNG filter ``ft`` of one (W, C) row of uint8 samples given the row
    above (zeros for the first)."""
    x = row.astype(np.int16)
    up = prev.astype(np.int16)
    left = np.zeros_like(x)
    left[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:] = up[:-1]
    if ft == 0:
        pred = np.zeros_like(x)
    elif ft == 1:
        pred = left
    elif ft == 2:
        pred = up
    elif ft == 3:
        pred = (left + up) >> 1
    else:
        pa = np.abs(up - upleft)
        pb = np.abs(left - upleft)
        pc = np.abs(left + up - 2 * upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    return ((x - pred) & 255).astype(np.uint8)


def png_bytes(img: np.ndarray, filters: str = "sub", level: int = 1) -> bytes:
    """PNG of a uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA image (the
    samples in the file's order, RGB)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    prev = np.zeros((w, ch), np.uint8)
    rows = []
    for r in range(h):
        ft = 1 if filters == "sub" else r % 5
        rows.append(bytes([ft]) + _filter_row(ft, img[r], prev).tobytes())
        prev = img[r]
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(b"".join(rows), level))
            + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray, filters: str = "sub") -> None:
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(img, filters))


def image(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    """Smooth gradients plus noise: resampling it means something."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = [128 + 100 * np.sin(xx / (9 + 3 * c) + yy / (13 + 2 * c) + seed) for c in range(channels)]
    img = np.stack(base, -1) + g.normal(0, 12, size=(h, w, channels))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def hand_points(g: np.random.Generator, cx: float, cy: float, spread: float) -> np.ndarray:
    """21 (u, v) points of a hand-sized cloud around (cx, cy)."""
    return np.stack([g.uniform(cx - spread, cx + spread, 21),
                     g.uniform(cy - spread, cy + spread, 21)], 1)


# ------------------------------------------------------------------- RHD
def write_rhd(root, subset: str, n: int, size: int = 320, seed: int = 0,
              filters: str = "sub", extent: int = 0) -> None:
    """``RHD/<subset>/color/%05d.png`` + ``anno_<subset>.pickle`` ({i:
    {"uv_vis": (42, 3)}}): the left or the right hand more visible, with
    ties, partly hidden joints and hands near a border.  ``extent`` > 0
    gives every hand a box exactly that wide (integer u at both ends) and
    at most that high, so the reader's crop is 2 * extent px."""
    d = Path(root) / "RHD" / subset
    g = np.random.default_rng(seed)
    anno = {}
    for i in range(n):
        write_png(d / "color" / f"{i:05d}.png", image(size, size, seed * 1000 + i), filters)
        uv = np.zeros((42, 3), np.float32)
        for hand in (0, 1):
            cx, cy = g.uniform(0.15 * size, 0.85 * size, 2)
            pts = hand_points(g, cx, cy, g.uniform(0.03, 0.12) * size)
            if extent:
                u0, v0 = np.floor(g.uniform(0, size - extent, 2))
                pts = np.stack([g.uniform(u0, u0 + extent, 21), g.uniform(v0, v0 + extent, 21)], 1)
                pts[0, 0], pts[1, 0] = u0, u0 + extent
            uv[21 * hand:21 * hand + 21, :2] = pts
            uv[21 * hand:21 * hand + 21, 2] = g.uniform(size=21) < (0.9 if hand == i % 2 else 0.4)
        if i % 4 == 3:                                 # a visibility tie
            uv[21:, 2] = uv[:21, 2]
        anno[i] = {"uv_vis": uv, "xyz": g.normal(size=(42, 3)).astype(np.float32),
                   "K": np.eye(3, dtype=np.float32)}
    with open(d / f"anno_{subset}.pickle", "wb") as f:
        pickle.dump(anno, f)


# -------------------------------------------------------------- FreiHand
def write_freihand(root, n_train: int, n_eval: int, size: int = 224, seed: int = 0,
                   filters: str = "sub") -> Dict[str, list]:
    """``FreiHand/training/rgb/%08d.jpg`` (PNG content) for the first
    ``n_train`` training ids and the first ``n_eval`` evaluation ids, and
    the three json lists of all 32560 samples (0 where never read)."""
    d = Path(root) / "FreiHand"
    g = np.random.default_rng(seed)
    ks, manos, xyzs = [0] * FREI_N_UNIQUE, [0] * FREI_N_UNIQUE, [0] * FREI_N_UNIQUE
    ids = list(range(n_train)) + list(range(FREI_EVAL_START, FREI_EVAL_START + n_eval))
    for sid in ids:
        write_png(d / "training" / "rgb" / f"{sid:08d}.jpg", image(size, size, sid), filters)
        f = g.uniform(400, 600)
        ks[sid] = [[f, 0.0, size / 2], [0.0, f, size / 2], [0.0, 0.0, 1.0]]
        manos[sid] = [g.normal(size=61).tolist()]
        xyzs[sid] = (g.uniform(-0.05, 0.05, size=(21, 3)) + [0, 0, 0.6]).tolist()
    for name, data in (("K", ks), ("mano", manos), ("xyz", xyzs)):
        with open(d / f"training_{name}.json", "w") as fh:
            json.dump(data, fh)
    return {"ids": ids}


# ------------------------------------------------------------------- MHP
def write_mhp(root, frames: Dict[str, int], size=(640, 480), seed: int = 0,
              filters: str = "sub") -> None:
    """``MHP/annotated_frames/data_i/{f}_webcam_{c}.jpg`` (PNG content),
    ``annotations/data_i/{f}_joints.txt`` (the world joints, wrist last as
    the file stores them) and ``calibrations/data_i/webcam_c/{rvec,tvec}.pkl``
    (numpy arrays pickled with protocol 2); ``frames`` maps data_i to its
    frame count.  The four cameras look at the hand from 350-450 mm."""
    d = Path(root) / "MHP"
    g = np.random.default_rng(seed)
    w, h = size
    for sub, n in frames.items():
        rvecs, tvecs = [], []
        for cam in range(1, 5):
            rvec = np.array([[g.uniform(-0.3, 0.3)], [g.uniform(-0.3, 0.3)], [g.uniform(-0.3, 0.3)]])
            tvec = np.array([[g.uniform(-30, 30)], [g.uniform(-30, 30)], [g.uniform(350, 450)]])
            calib = d / "calibrations" / sub / f"webcam_{cam}"
            calib.mkdir(parents=True, exist_ok=True)
            for name, val in (("rvec", rvec), ("tvec", tvec)):
                with open(calib / f"{name}.pkl", "wb") as fh:
                    pickle.dump(val, fh, protocol=2)
            rvecs.append(rvec)
            tvecs.append(tvec)
        (d / "annotations" / sub).mkdir(parents=True, exist_ok=True)
        centre = g.uniform(-20, 20, size=3)
        for f in range(n):
            centre = centre + g.uniform(-3, 3, size=3)       # a hand moving through frames
            pts = centre + g.uniform(-60, 60, size=(21, 3))
            with open(d / "annotations" / sub / f"{f}_joints.txt", "w") as fh:
                for j, p in enumerate(pts):
                    fh.write(f"{j} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
            for cam in range(1, 5):
                write_png(d / "annotated_frames" / sub / f"{f}_webcam_{cam}.jpg",
                          image(h, w, 1000 * int(sub.split("_")[1]) + 4 * f + cam), filters)


# ------------------------------------------------------------- HandGraph
def write_handgraph(root, n_poses: int, n_cams: int, size: int = 360, seed: int = 0,
                    filters: str = "sub") -> None:
    """``HandGraph/images/l21/camNN/handV2_gPoses_ren_l21_camNN_.MMMM.png``
    RGBA renders and ``3D_labels/{camPosition,handGestures,val-camera}.txt``
    (the last camera is the validation split)."""
    d = Path(root) / "HandGraph"
    labels = d / "3D_labels"
    labels.mkdir(parents=True, exist_ok=True)
    g = np.random.default_rng(seed)
    with open(labels / "camPosition.txt", "w") as f:
        for _ in range(n_poses):
            for c in range(n_cams):
                r = g.uniform(-20, 20, size=3)
                f.write(f"cam{c + 1:02d} {g.uniform(400, 500):.3f} {g.uniform(-5, 5):.3f} "
                        f"{g.uniform(-5, 5):.3f} -600.0 {180 + r[0]:.3f} {r[1]:.3f} {r[2]:.3f}\n")
    with open(labels / "handGestures.txt", "w") as f:
        for _ in range(n_poses):
            pts = g.uniform(-50, 50, size=(21, 3))
            for j in range(21):
                f.write(f"joint{j:02d} {pts[j, 0]:.5f} {pts[j, 1]:.5f} {pts[j, 2]:.5f}\n")
    with open(labels / "val-camera.txt", "w") as f:
        f.write(f"cam{n_cams:02d}\n")
    for p in range(n_poses):
        for c in range(n_cams):
            name = f"handV2_gPoses_ren_l21_cam{c + 1:02d}_.{p + 1:04d}.png"
            write_png(d / "images" / "l21" / f"cam{c + 1:02d}" / name,
                      image(size, size, 100 * p + c, channels=4), filters)


# ------------------------------------------------------------------- FHA
def write_fha(root, subject: str, n: int, size=(1920, 1080), seed: int = 0,
              filters: str = "sub") -> None:
    """``FHA/Videos/<subject>/pour_milk/1/color/color_%04d.jpeg`` (PNG
    content) and ``FHA/Hand_pose_annotation_v1/.../skeleton.txt`` (a frame
    id and 63 world-coordinate floats per row)."""
    rel = Path(subject) / "pour_milk" / "1"
    d = Path(root) / "FHA"
    g = np.random.default_rng(seed)
    w, h = size
    skel_dir = d / "Hand_pose_annotation_v1" / rel
    skel_dir.mkdir(parents=True, exist_ok=True)
    with open(skel_dir / "skeleton.txt", "w") as f:
        for i in range(n):
            pts = g.uniform(-60, 60, size=(21, 3)) + [0, 0, 500]
            f.write(" ".join([str(i)] + [f"{v:.5f}" for v in pts.reshape(-1)]) + "\n")
    for i in range(n):
        write_png(d / "Videos" / rel / "color" / f"color_{i:04d}.jpeg", image(h, w, i), filters)


# ------------------------------------------------------------------- STB
def write_stb(root, seq: str, n: int, size=(640, 480), seed: int = 0,
              filters: str = "sub", set_name: str = "evaluation") -> None:
    """``STB/<set>/images/<seq>/SK_color_%d.png`` and
    ``STB/<set>/labels/<seq>_SK.mat`` with ``handPara`` (3, 21, N) in the
    depth frame, mm."""
    import scipy.io

    d = Path(root) / "STB" / set_name
    g = np.random.default_rng(seed)
    (d / "labels").mkdir(parents=True, exist_ok=True)
    pose = g.uniform(-50, 50, size=(3, 21, n)) + np.array([0.0, 0.0, 450.0])[:, None, None]
    scipy.io.savemat(str(d / "labels" / f"{seq}_SK.mat"), {"handPara": pose})
    w, h = size
    for i in range(n):
        write_png(d / "images" / seq / f"SK_color_{i}.png", image(h, w, i), filters)


# ------------------------------------------------------------- COCO, MPII
def write_coco(root, n_images: int, size: int = 160, seed: int = 0, filters: str = "sub",
               set_name: str = "val2017") -> Dict[int, np.ndarray]:
    """``images/<set>/%012d.jpg`` (PNG content) and
    ``annotations/person_keypoints_<set>.json``: one person each, a crowd
    annotation and one without keypoints (both skipped by the reader)."""
    d = Path(root)
    g = np.random.default_rng(seed)
    images, annotations, gt = [], [], {}
    for img_id in range(1, n_images + 1):
        fname = f"{img_id:012d}.jpg"
        write_png(d / "images" / set_name / fname, image(size, size, img_id), filters)
        images.append({"id": img_id, "file_name": fname, "width": size, "height": size})
        kps = np.zeros((17, 3), np.float32)
        kps[:, :2] = g.uniform(0.2 * size, 0.8 * size, size=(17, 2))
        kps[:, 2] = np.where(g.uniform(size=17) < 0.8, 2, 0)
        gt[img_id] = kps
        box = [float(0.15 * size), float(0.15 * size), float(0.7 * size), float(0.7 * size)]
        annotations.append({"id": 10 * img_id, "image_id": img_id, "category_id": 1,
                            "num_keypoints": int((kps[:, 2] > 0).sum()), "iscrowd": 0,
                            "keypoints": kps.reshape(-1).tolist(), "bbox": box,
                            "area": box[2] * box[3]})
    annotations.append(dict(annotations[0], id=1, iscrowd=1))
    annotations.append(dict(annotations[0], id=2, num_keypoints=0))
    (d / "annotations").mkdir(parents=True, exist_ok=True)
    with open(d / "annotations" / f"person_keypoints_{set_name}.json", "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return gt


def write_mpii(root, n: int, size: int = 160, seed: int = 0, filters: str = "sub",
               set_name: str = "valid") -> None:
    """``images/im%d.jpg`` (PNG content) and ``annot/<set>.json`` with
    joints, visibility, centre and scale."""
    d = Path(root)
    g = np.random.default_rng(seed)
    anns = []
    for i in range(n):
        write_png(d / "images" / f"im{i}.jpg", image(size, size, 50 + i), filters)
        anns.append({"image": f"im{i}.jpg",
                     "joints": g.uniform(0.25 * size, 0.75 * size, size=(16, 2)).tolist(),
                     "joints_vis": (g.uniform(size=16) < 0.85).astype(int).tolist(),
                     "center": [size / 2 + g.uniform(-5, 5), size / 2 + g.uniform(-5, 5)],
                     "scale": float(0.6 * size / 200)})
    (d / "annot").mkdir(parents=True, exist_ok=True)
    with open(d / "annot" / f"{set_name}.json", "w") as f:
        json.dump(anns, f)


def write_all(root, subset: str = "evaluation", size: int = 64) -> None:
    """One small tree of every format for ``subset`` ('training' or
    'evaluation', the configs' TRAIN_SET / TEST_SET), frames of about
    ``size`` px: enough for every registered reader to build and give an
    item."""
    train = subset in ("train", "training")
    write_rhd(root, subset, 2, size=max(size, 64))
    write_freihand(root, 2 if train else 0, 0 if train else 2, size=size)
    write_mhp(root, {"data_1" if train else "data_17": 5})
    write_handgraph(root, 2, 2, size=size)
    write_fha(root, "Subject_1" if train else "Subject_5", 2, size=(size * 2, size))
    write_stb(root, "B1Counting", 2, size=(size, size), set_name=subset)
    write_coco(root, 2, size=size, set_name=subset)
    write_mpii(root, 2, size=size, set_name=subset)
