"""Triangulation sanity check.

Port of the JAX package's ``tools/dlt_check.py`` (reference
tools/DLT.py:78-151): project known 3D points through calibrated cameras
(the MHP intrinsics on a ring of views), recover them with each
triangulation method, and print the errors side by side.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.dlt_check [--views 4] \\
        [--noise 0.5] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from ..data.mhp import INTRINSICS


def ring_projections(views: int) -> np.ndarray:
    """(V, 3, 4) projections of a ring of MHP cameras 600 mm out, each
    tilted differently about x."""
    projs = []
    for i in range(views):
        ang = 2 * np.pi * i / views + 0.3
        c, s = np.cos(ang), np.sin(ang)
        ry = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        tx = 0.2 + 0.1 * i
        ct, st = np.cos(tx), np.sin(tx)
        rx = np.array([[1, 0, 0], [0, ct, -st], [0, st, ct]], np.float32)
        ext = np.concatenate([rx @ ry, [[0], [0], [600.0]]], axis=1).astype(np.float32)
        projs.append(INTRINSICS @ ext)
    return np.stack(projs)


def check(views: int = 4, noise: float = 0.0, device="cuda") -> Dict[str, np.ndarray]:
    """{method: per-joint 3D error (mm)} of eigh, svd, sii and ransac on 21
    seeded points, and 'rec_eigh' the eigh reconstruction; prints the table."""
    import torch

    from ..ops.geometry import triangulate_batch

    rng = np.random.default_rng(0)
    projs = ring_projections(views)
    pose3d = rng.uniform(-80, 80, size=(1, 21, 3)).astype(np.float32)
    hom = np.concatenate([pose3d, np.ones_like(pose3d[..., :1])], -1)
    img = np.einsum("vij,bkj->bvki", projs, hom)
    pose2d = img[..., :2] / img[..., 2:3]
    pose2d += rng.normal(scale=noise, size=pose2d.shape)

    pts = torch.from_numpy(pose2d.astype(np.float32)).to(device)
    prj = torch.from_numpy(projs).to(device)[None].expand(1, views, 3, 4)
    print(f"{views} views, noise={noise}px")
    print(f"{'method':<8} {'mean err (mm)':>14} {'max err (mm)':>14}")
    out = {}
    for method in ("eigh", "svd", "sii", "ransac"):
        rec = triangulate_batch(pts, prj, method=method).cpu().numpy()
        err = np.linalg.norm(rec - pose3d, axis=2)[0]
        out[method] = err
        if method == "eigh":
            out["rec_eigh"] = rec[0]
        print(f"{method:<8} {err.mean():>14.4f} {err.max():>14.4f}")
    print("\nGT vs recovered (eigh), first 3 joints:")
    for k in range(3):
        print(" gt", np.round(pose3d[0, k], 2).tolist(),
              " rec", np.round(out["rec_eigh"][k], 2).tolist())
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--views", type=int, default=4)
    p.add_argument("--noise", type=float, default=0.0, help="2D noise std (px)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    check(args.views, args.noise, args.device)


if __name__ == "__main__":
    main()
