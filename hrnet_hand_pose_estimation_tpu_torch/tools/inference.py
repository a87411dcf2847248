"""Single-image / directory / video inference demo.

Port of the JAX package's ``tools/inference.py`` (reference
tools/inference.py:27-246): resize + normalise a frame, forward, decode,
scale predictions to the input image, render the skeleton overlay; video
mode writes ``pred_results.mp4`` + ``pose2d_pred.txt``.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.inference --cfg <exp.yaml> \\
        [--model_path <ckpt>] --image_path <img-or-dir> --out_dir <dir> \\
        [--serving std|fast|int8] [--calib <record.json>] [--device cpu]

cv2 is imported only by the functions that read, convert or write images.
"""

from __future__ import annotations

import os

from ._common import base_parser, load_cfg


def predict_one_img(fwd, img_bgr, cfg, device="cuda"):
    """(pose2d (K, 2) in input-image pixels of the resized frame, heatmaps
    (H, W, K) or None) of one BGR frame."""
    import cv2
    import numpy as np
    import torch

    from ..data.transforms import normalize_image

    size = int(cfg.MODEL.IMAGE_SIZE[0])
    hm = int(cfg.MODEL.HEATMAP_SIZE[0])
    rgb = cv2.cvtColor(cv2.resize(img_bgr, (size, size)), cv2.COLOR_BGR2RGB)
    inp = torch.from_numpy(normalize_image(rgb)[None]).to(device)
    heatmaps, pose2d = fwd(inp)
    # scale heatmap coords to the resized input (reference inference.py:139)
    hm_out = None if heatmaps is None else heatmaps.float().cpu().numpy()[0]
    return pose2d.cpu().numpy()[0] * (size / hm), hm_out


def draw_skeleton(img_bgr, pose2d):
    import cv2

    from ..data.legends import BONE_CHILDREN, BONE_PARENTS

    colors = [(0, 0, 255), (0, 255, 0), (255, 0, 0), (0, 255, 255), (255, 0, 255)]
    for b, (p, c) in enumerate(zip(BONE_PARENTS, BONE_CHILDREN)):
        p1 = tuple(int(v) for v in pose2d[p])
        p2 = tuple(int(v) for v in pose2d[c])
        cv2.line(img_bgr, p1, p2, colors[b // 4], 2)
    for u, v in pose2d.astype(int):
        cv2.circle(img_bgr, (int(u), int(v)), 3, (255, 255, 255), -1)
    return img_bgr


def make_serving_fn(cfg, state, mode: str, calib_images=(), device="cuda",
                    calib_path: str = ""):
    """The forward for --serving, ``fwd(images) -> (heatmaps or None, pose2d)``
    in heatmap pixels, on normalized (B, H, W, 3) images on ``device``:

    - 'std': the plain model forward (``parallel/train_step.make_forward_fn``)
      of the config's model with ``state`` loaded;
    - 'fast': the bf16 serving path (``precast_variables`` + ``make_fast_infer``);
    - 'int8': the W8A8 serving path, calibrated on ``calib_images``
      (normalized frames: calibration data ~ serving data) or on a saved
      ``calib_path`` record (tools/calibrate.py), with
      ``prepare_serving_qparams`` + ``make_quant_infer``.
    """
    import numpy as np
    import torch

    if mode == "std":
        from ..models import build_model
        from ..parallel.train_step import make_forward_fn

        model = build_model(cfg)
        model.load_state_dict(state)
        return make_forward_fn(cfg, model.to(device).eval())
    if mode not in ("fast", "int8"):
        raise SystemExit(f"unknown --serving mode: {mode}")
    if not cfg.MODEL.HEATMAP_SOFTMAX:
        raise SystemExit(
            "--serving fast/int8 decode via the fused softmax soft-argmax "
            "head; this config has MODEL.HEATMAP_SOFTMAX: false -- use "
            "--serving std")
    from ..core.fast_infer import make_fast_infer, precast_variables

    weights = precast_variables(cfg, state, device=device)
    if mode == "fast":
        fast = make_fast_infer(cfg, device=device)
        return lambda x: (None, fast(weights, x))
    from ..core.quant_infer import (calibrate, load_calibration, make_quant_infer,
                                    prepare_serving_qparams)

    if calib_path:
        amax = load_calibration(calib_path, cfg)
    else:
        amax = calibrate(cfg, weights, [torch.from_numpy(np.stack(calib_images))])
    qparams = prepare_serving_qparams(cfg, {k: v.to(device) for k, v in state.items()}, amax)
    qfn = make_quant_infer(cfg, device=device)
    return lambda x: (None, qfn(weights, qparams, x))


def _calibration_frames(args, size: int):
    """The first 8 serving inputs, normalized: the int8 path calibrates on them."""
    import cv2

    from ..data.transforms import normalize_image

    calib = []
    if args.video_path:
        cap = cv2.VideoCapture(args.video_path)
        while len(calib) < 8:
            ok, frame = cap.read()
            if not ok:
                break
            calib.append(normalize_image(cv2.cvtColor(cv2.resize(frame, (size, size)),
                                                      cv2.COLOR_BGR2RGB)))
        cap.release()
    elif args.image_path:
        cand = ([os.path.join(args.image_path, f) for f in sorted(os.listdir(args.image_path))]
                if os.path.isdir(args.image_path) else [args.image_path])
        for path in cand[:8]:
            img = cv2.imread(path)
            if img is None:
                continue
            calib.append(normalize_image(cv2.cvtColor(cv2.resize(img, (size, size)),
                                                      cv2.COLOR_BGR2RGB)))
    return calib


def main() -> None:
    p = base_parser(__doc__)
    p.add_argument("--image_path", default="", help="image file or directory")
    p.add_argument("--video_path", default="", help="video file")
    p.add_argument("--out_dir", default="inference_out")
    p.add_argument("--serving", default="std", choices=("std", "fast", "int8"),
                   help="forward path: std model, bf16 fast path, or the "
                        "calibrated int8 W8A8 serving trunk")
    p.add_argument("--calib", default="",
                   help="saved calibration record (tools/calibrate.py) for "
                        "--serving int8; skips on-the-fly calibration")
    args = p.parse_args()

    import cv2
    import numpy as np

    from ..models import build_model
    from ._common import load_weights

    cfg = load_cfg(args)
    model = build_model(cfg)
    size = int(cfg.MODEL.IMAGE_SIZE[0])
    state = load_weights(cfg, model, args.model_path, device=args.device)

    calib = []
    if args.serving == "int8" and not args.calib:
        calib = _calibration_frames(args, size)
        if not calib:
            raise SystemExit("--serving int8 needs at least one input to "
                             "calibrate on (or a saved --calib record)")
    fwd = make_serving_fn(cfg, state, args.serving, calib, device=args.device,
                          calib_path=args.calib)

    os.makedirs(args.out_dir, exist_ok=True)

    if args.video_path:
        cap = cv2.VideoCapture(args.video_path)
        fps = cap.get(cv2.CAP_PROP_FPS) or 25
        writer = None
        poses = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            pose2d, _ = predict_one_img(fwd, frame, cfg, args.device)
            canvas = draw_skeleton(cv2.resize(frame, (size, size)), pose2d)
            if writer is None:
                writer = cv2.VideoWriter(
                    os.path.join(args.out_dir, "pred_results.mp4"),
                    cv2.VideoWriter_fourcc(*"mp4v"), fps, (size, size))
            writer.write(canvas)
            poses.append(pose2d.reshape(-1))
        cap.release()
        if writer:
            writer.release()
        np.savetxt(os.path.join(args.out_dir, "pose2d_pred.txt"), np.stack(poses))
        print(f"wrote {len(poses)} frames to {args.out_dir}")
        return

    paths = []
    if os.path.isdir(args.image_path):
        paths = [os.path.join(args.image_path, f) for f in sorted(os.listdir(args.image_path))
                 if f.lower().endswith((".png", ".jpg", ".jpeg"))]
    elif args.image_path:
        paths = [args.image_path]
    if not paths:
        raise SystemExit("--image_path or --video_path required")

    for path in paths:
        img = cv2.imread(path)
        pose2d, _ = predict_one_img(fwd, img, cfg, args.device)
        canvas = draw_skeleton(cv2.resize(img, (size, size)), pose2d)
        out_path = os.path.join(args.out_dir, "pred_" + os.path.basename(path))
        cv2.imwrite(out_path, canvas)
        print(f"{path}: wrote {out_path}; wrist at {pose2d[0].round(1).tolist()}")


if __name__ == "__main__":
    main()
