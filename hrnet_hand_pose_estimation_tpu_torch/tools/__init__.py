"""The port's command-line tools, twins of the JAX package's ``tools/``:

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.evaluate_2d --cfg <exp.yaml>
    python -m hrnet_hand_pose_estimation_tpu_torch.tools.inference --cfg <exp.yaml> --image_path <img>
    python -m hrnet_hand_pose_estimation_tpu_torch.tools.calibrate --cfg <exp.yaml> --image_path <dir>
    python -m hrnet_hand_pose_estimation_tpu_torch.tools.train --cfg <exp.yaml>
    python -m hrnet_hand_pose_estimation_tpu_torch.tools.evaluate_3d --cfg <exp.yaml> [--dlt]
    python -m hrnet_hand_pose_estimation_tpu_torch.tools.infer_3d --cfg <exp.yaml>
    python -m hrnet_hand_pose_estimation_tpu_torch.tools.dlt_check [--views 4]

Each runs on ``cuda`` unless ``--device cpu`` is passed and writes the JAX
tool's artifacts in its formats.  cv2 is imported only by the functions
that read or write image files.
"""
