"""Hand pose on NeRF/LLFF camera data (experiment).

Port of the JAX package's ``tools/nerf_pose_est.py`` (reference
tools/nerf_pose_est.py:27-223 and load_llff.py): read an LLFF scene's
``poses_bounds.npy``, run the 2D model on each view, and triangulate the
views' keypoints by RANSAC with the calibrated projections.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.nerf_pose_est --cfg <exp.yaml> \\
        --scene <dir with images/ and poses_bounds.npy> [--out_dir <dir>] [--device cpu]

Needs cv2 to read the images.
"""

from __future__ import annotations

import os

import numpy as np

from ._common import base_parser, load_cfg


def load_llff_poses(scene_dir: str):
    """Parse ``poses_bounds.npy`` (reference load_llff.py): rows are 3x5
    [R|t|hwf] matrices and 2 depth bounds per image.  Returns (c2w (N, 3, 4),
    hwf (N, 3), bounds (N, 2)) float32, c2w in [right, down, forward] axes."""
    arr = np.load(os.path.join(scene_dir, "poses_bounds.npy"))          # (N, 17)
    poses = arr[:, :-2].reshape(-1, 3, 5)
    bounds = arr[:, -2:]
    c2w = poses[:, :, :4]
    hwf = poses[:, :, 4]
    # LLFF axes [down, right, back] -> [right, down, forward]
    c2w = np.concatenate([c2w[:, :, 1:2], c2w[:, :, 0:1], -c2w[:, :, 2:3], c2w[:, :, 3:4]],
                         axis=2)
    return c2w.astype(np.float32), hwf.astype(np.float32), bounds.astype(np.float32)


def llff_projections(c2w: np.ndarray, hwf: np.ndarray) -> np.ndarray:
    """Camera-to-world -> (N, 3, 4) projections P = K [R|t] (world to image)."""
    n = c2w.shape[0]
    projs = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        h, w, f = hwf[i]
        K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]], np.float32)
        R = c2w[i, :, :3].T                         # world -> camera rotation
        t = -R @ c2w[i, :, 3]
        projs[i] = K @ np.concatenate([R, t[:, None]], axis=1)
    return projs


def estimate(cfg, scene: str, out_dir: str, model_path: str = "", device="cuda"):
    """Decode each view of ``scene`` with the 2D model of ``cfg``, triangulate
    by RANSAC, write ``pose3d.txt`` and ``pose2d_per_view.txt`` to
    ``out_dir``.  Returns (kp2d (V, K, 2) original px, kp3d (K, 3))."""
    import cv2
    import torch

    from ..data.transforms import normalize_image
    from ..models import build_model
    from ..ops.geometry import triangulate_batch
    from ..parallel.train_step import make_forward_fn
    from ._common import load_weights

    device = torch.device(device)
    model = build_model(cfg)
    load_weights(cfg, model, model_path)
    model.to(device).eval()
    size = int(cfg.MODEL.IMAGE_SIZE[0])
    hm = float(cfg.MODEL.HEATMAP_SIZE[0])

    c2w, hwf, _ = load_llff_poses(scene)
    projs = llff_projections(c2w, hwf)
    img_dir = os.path.join(scene, "images")
    names = sorted(f for f in os.listdir(img_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))[: len(projs)]
    fwd = make_forward_fn(cfg, model)

    views = []
    for i, name in enumerate(names):
        img = cv2.cvtColor(cv2.imread(os.path.join(img_dir, name)), cv2.COLOR_BGR2RGB)
        inp = torch.from_numpy(normalize_image(cv2.resize(img, (size, size)))[None]).to(device)
        _, pose = fwd(inp)
        # heatmap coords -> the original image's pixels
        h0, w0 = hwf[i][0], hwf[i][1]
        views.append(pose[0].float().cpu().numpy() * np.asarray([w0 / hm, h0 / hm]))
    kp2d = np.stack(views).astype(np.float32)                            # (V, K, 2)
    kp3d = triangulate_batch(torch.from_numpy(kp2d[None]).to(device),
                             torch.from_numpy(projs[None, : len(kp2d)]).to(device),
                             method="ransac")[0].float().cpu().numpy()

    os.makedirs(out_dir, exist_ok=True)
    np.savetxt(os.path.join(out_dir, "pose3d.txt"), kp3d)
    np.savetxt(os.path.join(out_dir, "pose2d_per_view.txt"), kp2d.reshape(len(kp2d), -1))
    print(f"{len(kp2d)} views -> wrote {out_dir}/pose3d.txt")
    return kp2d, kp3d


def main() -> None:
    p = base_parser(__doc__)
    p.add_argument("--scene", required=True, help="LLFF scene directory")
    p.add_argument("--out_dir", default="nerf_pose_out")
    args = p.parse_args()
    estimate(load_cfg(args), args.scene, args.out_dir, args.model_path, args.device)


if __name__ == "__main__":
    main()
