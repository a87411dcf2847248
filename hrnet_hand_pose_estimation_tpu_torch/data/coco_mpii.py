"""COCO and MPII human-pose readers, and COCO's keypoint evaluation.

Port of the JAX package's ``data/coco_mpii.py`` (reference
lib/dataset/coco.py:445, mpii.py:181, JointsDataset.py):

- COCO: ``annotations/person_keypoints_<set>.json`` read as plain json
  (no pycocotools), one sample per non-crowd annotation with keypoints, its
  GT box cropped; ``evaluate``: per-instance rescoring (mean confidence of
  the joints above ``in_vis_thre`` times the box score), per-image OKS-NMS on
  the port's ``ops/nms.oks_nms`` (on ``device``, the card by default), the
  reference's ``keypoints_<set>_results_0.json`` and a numpy OKS-AP;
- MPII: ``annot/<set>.json`` with centre / scale entries, a square crop of
  ``scale * 200`` px.

Both give the hand readers' record (imgs / pose2d / visibility / heatmaps)
through the shared transform chain.  Images go through
``utils/zipreader.imread``: COCO's and MPII's JPEGs need cv2.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.nms import COCO_SIGMAS, oks_nms
from ..ops.targets import gaussian_targets_np
from ..utils.zipreader import imread
from .cv import bgr_to_rgb

def _on(x: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def bbox_to_center_scale(bbox, aspect_ratio: float, pixel_std: float = 200.0):
    """COCO bbox -> (center, scale) (reference coco.py _box2cs semantics)."""
    x, y, w, h = bbox
    center = np.array([x + w * 0.5, y + h * 0.5], np.float32)
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    else:
        w = h * aspect_ratio
    scale = np.array([w / pixel_std, h / pixel_std], np.float32) * 1.25
    return center, scale


class COCOKeypointsDataset:
    name = "COCO"
    num_joints = 17

    def __init__(self, root: str, set_name: str = "val2017",
                 transforms=None, hm_size: int = 64, sigma: float = 2.0):
        self.img_dir = os.path.join(root, "images", set_name)
        ann_file = os.path.join(root, "annotations",
                                f"person_keypoints_{set_name}.json")
        with open(ann_file) as f:
            data = json.load(f)
        images = {im["id"]: im for im in data["images"]}
        self.samples: List[Dict] = []
        for ann in data["annotations"]:
            if ann.get("num_keypoints", 0) <= 0 or ann.get("iscrowd"):
                continue
            kps = np.asarray(ann["keypoints"], np.float32).reshape(-1, 3)
            self.samples.append({
                "file": images[ann["image_id"]]["file_name"],
                "image_id": int(ann["image_id"]),
                "keypoints": kps,
                "bbox": ann["bbox"],
                "area": ann.get("area", ann["bbox"][2] * ann["bbox"][3]),
            })
        self.transforms = transforms
        self.hm_size = hm_size
        self.sigma = sigma
        self.exception = False

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        s = self.samples[idx]
        img = bgr_to_rgb(imread(os.path.join(self.img_dir, s["file"])))
        kps = s["keypoints"].copy()
        x, y, w, h = [int(v) for v in s["bbox"]]
        x, y = max(0, x), max(0, y)
        crop = img[y:y + max(h, 1), x:x + max(w, 1)]
        kps[:, :2] -= [x, y]
        vis = (kps[:, 2] > 0).astype(np.float32)
        if self.transforms is not None:
            crop, joints = self.transforms(crop, [kps[:, :2]])
            pose2d = np.asarray(joints[0], np.float32)
        else:
            pose2d = kps[:, :2]
        hms = gaussian_targets_np(pose2d, vis, self.hm_size, self.sigma)
        return {
            "imgs": np.asarray(crop, np.float32),
            "pose2d": pose2d,
            "heatmaps": hms.astype(np.float32),
            "visibility": vis[:, None],
        }

    def evaluate_oks(self, preds: np.ndarray, scores: np.ndarray,
                     oks_thresh: float = 0.9, device="cuda"):
        """OKS-NMS keep mask of the predictions (the role the native nms
        build played in reference coco.py's evaluate), on ``device``."""
        areas = np.asarray([s["area"] for s in self.samples[: len(preds)]],
                           np.float32)
        kpts = np.concatenate(
            [preds[..., :2], np.ones((*preds.shape[:2], 1), np.float32)], -1)
        keep = oks_nms(_on(kpts, device), _on(scores, device), _on(areas, device), oks_thresh)
        return keep.cpu().numpy()

    def evaluate(self, preds, all_boxes, image_ids, output_dir,
                 in_vis_thre: float = 0.2, oks_thre: float = 0.9,
                 image_set: str = "val2017", device="cuda"):
        """Full COCO keypoint results path (reference coco.py:288-445):
        per-instance rescoring (mean visible-joint confidence x box score),
        per-image OKS-NMS via ops/nms.py, and the reference-format
        ``keypoints_<set>_results_<rank>.json``.

        ``preds``: (N, K, 3) [u, v, conf]; ``all_boxes``: (N, 6)
        [cx, cy, sx, sy, area, box_score]; ``image_ids``: per-instance int
        image ids.  Returns (name_values, AP) where AP comes from the
        numpy OKS-AP evaluator below (no pycocotools: the same metric
        definition, simplified matching).  The OKS-NMS runs on ``device``.
        """
        preds = np.asarray(preds, np.float32)
        all_boxes = np.asarray(all_boxes, np.float32)
        by_image: Dict[int, List[int]] = {}
        inst_scores = np.zeros(len(preds), np.float32)
        for i in range(len(preds)):
            conf = preds[i, :, 2]
            valid = conf > in_vis_thre
            kpt_score = float(conf[valid].mean()) if valid.any() else 0.0
            inst_scores[i] = kpt_score * float(all_boxes[i, 5])
            by_image.setdefault(int(image_ids[i]), []).append(i)

        results = []
        for img_id, idxs in by_image.items():
            idxs = np.asarray(idxs)
            kpts = preds[idxs]
            keep = oks_nms(_on(kpts, device), _on(inst_scores[idxs], device),
                           _on(all_boxes[idxs, 4], device), oks_thre).cpu().numpy()
            if not keep.any():            # reference keeps everything then
                keep = np.ones(len(idxs), bool)
            for i in idxs[keep]:
                results.append({
                    "image_id": img_id,
                    "category_id": 1,
                    "keypoints": [float(v) for v in preds[i].reshape(-1)],
                    "score": float(inst_scores[i]),
                    "center": [float(v) for v in all_boxes[i, 0:2]],
                    "scale": [float(v) for v in all_boxes[i, 2:4]],
                })

        res_folder = os.path.join(output_dir, "results")
        os.makedirs(res_folder, exist_ok=True)
        res_file = os.path.join(
            res_folder, f"keypoints_{image_set}_results_0.json")
        with open(res_file, "w") as f:
            json.dump(results, f, sort_keys=True, indent=4)

        ap = self.oks_average_precision(results)
        name_values = {"AP": ap, "res_file": res_file,
                       "num_results": len(results)}
        return name_values, ap

    def oks_average_precision(self, results: List[Dict],
                              thresholds: Optional[np.ndarray] = None) -> float:
        """Numpy OKS-AP over the loaded GT annotations: greedy best-OKS
        matching per image at thresholds 0.5:0.05:0.95 (the COCOeval metric
        definition, without area-range/maxDets stratification)."""
        if thresholds is None:
            thresholds = np.arange(0.5, 1.0, 0.05)
        gts_by_image: Dict[int, List[Dict]] = {}
        for s in self.samples:
            gts_by_image.setdefault(s.get("image_id", -1), []).append(s)
        dets = sorted(results, key=lambda r: -r["score"])
        n_gt = sum(len(v) for v in gts_by_image.values())
        if n_gt == 0 or not dets:
            return 0.0
        # COCO_SIGMAS has 17 entries; for other joint counts fall back to a
        # constant sigma exactly like ops.nms.oks_matrix does
        if self.num_joints == len(COCO_SIGMAS):
            sig = np.asarray(COCO_SIGMAS, np.float32)
        else:
            sig = np.full((self.num_joints,), 0.05, np.float32)
        var = (2 * sig) ** 2
        aps = []
        for t in thresholds:
            matched = {k: np.zeros(len(v), bool) for k, v in gts_by_image.items()}
            tp = np.zeros(len(dets))
            for d_i, det in enumerate(dets):
                gts = gts_by_image.get(det["image_id"], [])
                best, best_g = 0.0, -1
                dk = np.asarray(det["keypoints"], np.float32).reshape(-1, 3)
                for g_i, gt in enumerate(gts):
                    gk = gt["keypoints"]
                    vis = gk[:, 2] > 0
                    if not vis.any():
                        continue
                    d2 = ((dk[vis, :2] - gk[vis, :2]) ** 2).sum(-1)
                    e = d2 / (var[vis] * 2.0 * max(gt["area"], 1.0))
                    oks = float(np.exp(-e).mean())
                    if oks > best:
                        best, best_g = oks, g_i
                if (best >= t and best_g >= 0
                        and det["image_id"] in matched
                        and not matched[det["image_id"]][best_g]):
                    matched[det["image_id"]][best_g] = True
                    tp[d_i] = 1
            cum_tp = np.cumsum(tp)
            recall = cum_tp / n_gt
            precision = cum_tp / (np.arange(len(dets)) + 1)
            # 101-point interpolated AP (COCOeval convention)
            ap = 0.0
            for r in np.linspace(0, 1, 101):
                p = precision[recall >= r]
                ap += float(p.max()) if len(p) else 0.0
            aps.append(ap / 101)
        return float(np.mean(aps))


class MPIIDataset:
    name = "MPII"
    num_joints = 16

    def __init__(self, root: str, set_name: str = "valid",
                 transforms=None, hm_size: int = 64, sigma: float = 2.0):
        ann_file = os.path.join(root, "annot", f"{set_name}.json")
        with open(ann_file) as f:
            self.anns = json.load(f)
        self.img_dir = os.path.join(root, "images")
        self.transforms = transforms
        self.hm_size = hm_size
        self.sigma = sigma
        self.exception = False

    def __len__(self):
        return len(self.anns)

    def __getitem__(self, idx: int):
        a = self.anns[idx]
        img = bgr_to_rgb(imread(os.path.join(self.img_dir, a["image"])))
        joints = np.asarray(a["joints"], np.float32)
        vis = np.asarray(a["joints_vis"], np.float32)
        center = np.asarray(a["center"], np.float32)
        scale = float(a["scale"]) * 200.0
        half = scale / 2.0
        x0, y0 = int(max(0, center[0] - half)), int(max(0, center[1] - half))
        crop = img[y0:y0 + int(scale), x0:x0 + int(scale)]
        joints = joints - [x0, y0]
        if self.transforms is not None:
            crop, jl = self.transforms(crop, [joints])
            joints = np.asarray(jl[0], np.float32)
        hms = gaussian_targets_np(joints, vis, self.hm_size, self.sigma)
        return {
            "imgs": np.asarray(crop, np.float32),
            "pose2d": joints,
            "heatmaps": hms.astype(np.float32),
            "visibility": vis[:, None],
        }
