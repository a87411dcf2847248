"""Multi-view 3D inference demo.

Port of the JAX package's ``tools/infer_3d.py`` (reference
tools/infer_3D.py:105-359): run a triangulation net over multi-view test
samples, write each sample's views side by side with the 2D skeletons
(needs cv2) and its 3D keypoints, and print each sample's 3D error.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.infer_3d --cfg <exp.yaml> \\
        [--model_path <ckpt>] [--out_dir <dir>] [--num_samples 2] [--device cpu]

cv2 is imported only to write the overlays; without it the tool writes
the 3D keypoints alone.
"""

from __future__ import annotations

import importlib.util
import os

from ._common import base_parser, load_cfg


def infer(cfg, out_dir: str, num_samples: int = 2, model_path: str = "", device="cuda"):
    """Run the config's net on its first test batch; write
    ``sample<b>_pose3d.txt`` (and ``sample<b>_views.png`` with cv2) for the
    first ``num_samples`` samples.  Returns (kp2d, kp3d, batch) as numpy."""
    import numpy as np
    import torch

    from ..data.transforms import denormalize_image
    from .evaluate_3d import build_evaluator

    ev, loader = build_evaluator(cfg, model_path=model_path, device=device)
    batch = next(iter(loader))
    orig_size = tuple(getattr(loader.dataset, "orig_img_size", (640, 480)))
    proj = ev.projections(batch, orig_size)
    kp2d, kp3d = ev.forward(torch.from_numpy(np.asarray(batch["imgs"], np.float32)).to(ev.device),
                            proj)
    kp2d, kp3d = kp2d.float().cpu().numpy(), kp3d.float().cpu().numpy()

    os.makedirs(out_dir, exist_ok=True)
    draw = importlib.util.find_spec("cv2") is not None
    hm = float(cfg.MODEL.HEATMAP_SIZE[0])
    size = int(cfg.MODEL.IMAGE_SIZE[0])
    for b in range(min(num_samples, kp2d.shape[0])):
        np.savetxt(os.path.join(out_dir, f"sample{b}_pose3d.txt"), kp3d[b])
        err = np.linalg.norm(kp3d[b] - np.asarray(batch["pose3d"][b]), axis=1)
        wrote = f"sample{b}_pose3d.txt"
        if draw:
            import cv2

            from ..data.legends import BONE_CHILDREN, BONE_PARENTS

            panels = []
            for v in range(kp2d.shape[1]):
                img = cv2.cvtColor(denormalize_image(np.asarray(batch["imgs"][b, v])),
                                   cv2.COLOR_RGB2BGR).copy()
                pts = kp2d[b, v]
                # vol keeps heatmap coords; alg / ransac the original image's
                if "vol" in str(cfg.MODEL.TRIANGULATION_MODEL_NAME):
                    pts = pts * (size / hm)
                else:
                    pts = pts * np.asarray([size / orig_size[0], size / orig_size[1]])
                for p_, c_ in zip(BONE_PARENTS, BONE_CHILDREN):
                    cv2.line(img, tuple(int(t) for t in pts[p_]), tuple(int(t) for t in pts[c_]),
                             (0, 255, 0), 1)
                panels.append(img)
            cv2.imwrite(os.path.join(out_dir, f"sample{b}_views.png"),
                        np.concatenate(panels, axis=1))
            wrote += f", sample{b}_views.png"
        print(f"sample {b}: wrote {wrote} in {out_dir}; 3D EPE {err.mean():.2f} mm")
    return kp2d, kp3d, batch


def main() -> None:
    p = base_parser(__doc__)
    p.add_argument("--out_dir", default="inference3d_out")
    p.add_argument("--num_samples", type=int, default=2)
    args = p.parse_args()
    infer(load_cfg(args), args.out_dir, args.num_samples, args.model_path, args.device)


if __name__ == "__main__":
    main()
