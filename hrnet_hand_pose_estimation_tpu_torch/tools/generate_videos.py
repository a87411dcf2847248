"""Render a dataset's samples with their ground-truth skeletons into videos.

Port of the JAX package's ``tools/generate_videos.py`` (reference
tools/generate_videos.py:37-57, FreiHandDataset.generate_videos): the
first TEST_DATASET's samples, denormalised, with ``utils/vis.draw_hand``
over them, ``--frames_per_video`` to an XVID video.  cv2 draws and writes
(imported at the call).

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.generate_videos \\
        --cfg <exp.yaml> --out_dir videos/ [--device cpu]
"""

from __future__ import annotations

import os

from ._common import base_parser, load_cfg


def main() -> None:
    p = base_parser(__doc__)
    p.add_argument("--out_dir", default="videos")
    p.add_argument("--frames_per_video", type=int, default=100)
    p.add_argument("--max_videos", type=int, default=1)
    args = p.parse_args()

    import cv2
    import numpy as np

    from ..data.build import build_dataset
    from ..data.transforms import denormalize_image
    from ..utils.vis import draw_hand

    cfg = load_cfg(args)
    ds = build_dataset(cfg, list(cfg.DATASET.TEST_DATASET)[0], is_train=False)
    os.makedirs(args.out_dir, exist_ok=True)
    size = int(cfg.MODEL.IMAGE_SIZE[0])
    hm = float(cfg.MODEL.HEATMAP_SIZE[0])
    idx = 0
    for v in range(args.max_videos):
        path = os.path.join(args.out_dir, f"VIDEO_{v:06d}.avi")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"XVID"), 25, (size, size))
        n = 0
        for _ in range(min(args.frames_per_video, len(ds) - idx)):
            sample = ds[idx]
            idx += 1
            img = cv2.cvtColor(denormalize_image(np.asarray(sample["imgs"])),
                               cv2.COLOR_RGB2BGR).copy()
            writer.write(draw_hand(img, np.asarray(sample["pose2d"])[:, :2] * (size / hm)))
            n += 1
        writer.release()
        print(f"wrote {path} ({n} frames)")


if __name__ == "__main__":
    main()
