"""Resize every image of a directory to a square size.

Port of the JAX package's ``tools/resize_images.py`` (reference
tools/resize_images.py).  cv2 reads, resizes (INTER_LINEAR) and writes;
it is imported at the call.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.resize_images \\
        --src dir/ --dst out/ --size 256
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence


def main(argv: Sequence[str] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--size", type=int, default=256)
    args = p.parse_args(argv)

    import cv2

    os.makedirs(args.dst, exist_ok=True)
    names = [f for f in sorted(os.listdir(args.src))
             if f.lower().endswith((".png", ".jpg", ".jpeg"))]
    for name in names:
        img = cv2.imread(os.path.join(args.src, name))
        if img is None:
            raise SystemExit(f"cannot read {os.path.join(args.src, name)}")
        cv2.imwrite(os.path.join(args.dst, name), cv2.resize(img, (args.size, args.size)))
    print(f"resized {len(names)} images -> {args.dst}")


if __name__ == "__main__":
    main()
