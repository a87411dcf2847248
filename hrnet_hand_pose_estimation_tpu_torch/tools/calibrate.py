"""Offline calibration for the int8 W8A8 serving path.

Port of the JAX package's ``tools/calibrate.py``: runs calibration batches
through the bf16 trunk walk, records per-site input-activation maxima, and
writes the portable JSON record (``core.quant_infer.save_calibration``;
one record serves both packages).  Serving entries then build their
quantization parameters from the record:

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.calibrate --cfg <exp.yaml> \\
        [--model_path <ckpt>] --image_path <dir-or-file> --out calibration.json
    python -m hrnet_hand_pose_estimation_tpu_torch.tools.inference --cfg <exp.yaml> \\
        --serving int8 --calib calibration.json --image_path ...
"""

from __future__ import annotations

import os

from ._common import base_parser, load_cfg


def collect_images(image_path: str, size: int, limit: int):
    """Load + resize + normalize calibration frames (dir or single file)."""
    import cv2
    import numpy as np

    from ..data.transforms import normalize_image

    paths = ([os.path.join(image_path, f)
              for f in sorted(os.listdir(image_path))
              if f.lower().endswith((".png", ".jpg", ".jpeg"))]
             if os.path.isdir(image_path) else [image_path])
    frames = []
    for path in paths[:limit]:
        img = cv2.imread(path)
        if img is None:
            continue
        rgb = cv2.cvtColor(cv2.resize(img, (size, size)), cv2.COLOR_BGR2RGB)
        frames.append(normalize_image(rgb))
    if not frames:
        raise SystemExit(f"no readable images under {image_path!r}")
    return np.stack(frames)


def main() -> None:
    p = base_parser(__doc__)
    p.add_argument("--image_path", required=True,
                   help="calibration images: a directory or a single file")
    p.add_argument("--out", default="calibration.json", help="output JSON record")
    p.add_argument("--max_images", type=int, default=64,
                   help="cap on calibration frames (batched 8 at a time)")
    args = p.parse_args()

    import torch

    from ..core.fast_infer import precast_variables
    from ..core.quant_infer import calibrate, save_calibration
    from ..models import build_model
    from ._common import load_weights

    cfg = load_cfg(args)
    if "hrnet" not in str(cfg.MODEL.NAME).lower():
        raise SystemExit(
            f"int8 serving calibration covers the HRNet trunk; config "
            f"builds {str(cfg.MODEL.NAME)!r}")
    model = build_model(cfg)
    size = int(cfg.MODEL.IMAGE_SIZE[0])
    state = load_weights(cfg, model, args.model_path, device=args.device)
    weights = precast_variables(cfg, state, device=args.device)

    frames = collect_images(args.image_path, size, args.max_images)
    batches = [torch.from_numpy(frames[i:i + 8]) for i in range(0, len(frames), 8)]
    amax = calibrate(cfg, weights, batches)
    save_calibration(args.out, amax, cfg)
    print(f"calibrated {len(amax)} sites over {len(frames)} frames -> {args.out}")


if __name__ == "__main__":
    main()
