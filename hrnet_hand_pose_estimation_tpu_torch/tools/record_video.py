"""Record a camera to a video file.

Port of the JAX package's ``tools/record_video.py`` (reference
tools/record_video.py:1-32), through cv2 (imported at the call).

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.record_video \\
        --out output.avi --seconds 10
"""

from __future__ import annotations

import argparse
from typing import Sequence


def main(argv: Sequence[str] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="output.avi")
    p.add_argument("--camera", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)

    try:
        import cv2
    except ImportError as err:
        raise SystemExit(f"record_video needs OpenCV (cv2) to read a camera: {err}") from err

    cap = cv2.VideoCapture(args.camera)
    if not cap.isOpened():
        raise SystemExit(f"cannot open camera {args.camera}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*"XVID"), fps, (w, h))
    for _ in range(int(fps * args.seconds)):
        ok, frame = cap.read()
        if not ok:
            break
        writer.write(frame)
    writer.release()
    cap.release()
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
