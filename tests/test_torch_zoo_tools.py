"""The port's CLI tools run the single-image model zoo on the CPU from the
shipped RHD YAMLs with ``opts`` on ``Synthetic_kpt`` (no RHD data here),
cut to 64 px: ``tools.train`` swin and pose_resnet, ``tools.evaluate_2d``
and ``tools.inference --serving std`` swin, hamburger and pose_resnet;
``--serving fast`` stays the HRNet's."""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RHD = os.path.join(REPO, "experiments", "RHD")
SMOKE = os.path.join(REPO, "experiments", "synthetic_smoke.yaml")
TOOLS = "hrnet_hand_pose_estimation_tpu_torch.tools."

torch.set_num_threads(1)

SYNTH = ["DATASET.DATASET", "['Synthetic_kpt']", "DATASET.TEST_DATASET", "['Synthetic_kpt']",
         "MODEL.IMAGE_SIZE", "[64, 64]", "MODEL.HEATMAP_SIZE", "[16, 16]", "WORKERS", "0",
         "TRAIN.IMAGES_PER_GPU", "8", "TEST.IMAGES_PER_GPU", "8", "DEBUG.DEBUG", "False"]
# each tool's model, cut to a few seconds on one CPU thread
CUTS = {
    "swin": (os.path.join(RHD, "RHD_SwinTransformer_trainable_softmax_pose2dloss_v1.yaml"),
             ["MODEL.EMB_DIM", "[16]", "MODEL.NUM_HEADS", "[2, 2, 2, 2]",
              "MODEL.DEPTHS", "[2, 2, 2, 2]"]),
    "hamburger": (os.path.join(RHD, "RHD_HRNet_MatrixDecomp_trainable_softmax_pose2dloss_v2.yaml"),
                  ["MODEL.R", "16"]),
    "pose_resnet": (SMOKE, ["MODEL.NAME", "pose_resnet", "MODEL.EXTRA.NUM_LAYERS", "18",
                            "MODEL.EXTRA.NUM_DECONV_FILTERS", "[32, 32, 32]"]),
}


def _run(tool, model, args, cwd, extra=()):
    yaml, cut = CUTS[model]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", TOOLS + tool, "--cfg", yaml, "--device", "cpu",
                           *args, *SYNTH, *cut, *extra], capture_output=True, text=True,
                          env=env, cwd=cwd, timeout=500)


@pytest.mark.parametrize("model", ["swin", "pose_resnet"])
def test_train_tool_runs_the_zoo(tmp_path, model):
    """One short epoch of ``tools.train`` (the generic step) with a
    validation and a checkpoint."""
    r = _run("train", model, [], tmp_path,
             ["OUTPUT_DIR", str(tmp_path), "TRAIN.BEGIN_EPOCH", "0", "TRAIN.END_EPOCH", "1",
              "PRINT_FREQ", "1", "AUTO_RESUME", "False"])
    assert r.returncode == 0, r.stderr[-1500:]
    log = r.stdout + r.stderr
    assert "Validate[0]" in log and "nonfinite_grads=0.00000" in log, log[-1500:]
    assert len(list(tmp_path.glob("*/*/checkpoints/ckpt_0.pt"))) == 1


@pytest.mark.parametrize("model", ["swin", "hamburger", "pose_resnet"])
def test_evaluate_and_inference_tools_run_the_zoo(tmp_path, model):
    """``tools.evaluate_2d`` writes the artifacts, ``tools.inference
    --serving std`` an overlay; ``--serving fast`` refuses the zoo model."""
    r = _run("evaluate_2d", model, ["--out", str(tmp_path / "ev")], tmp_path)
    assert r.returncode == 0, r.stderr[-1500:]
    results = json.loads(r.stdout[r.stdout.index("{"):])
    assert all(np.isfinite(v) for v in results.values())
    out = next((tmp_path / "ev").iterdir())
    assert np.loadtxt(out / "PCK2d.txt").shape == (2, 49)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    cv2.imwrite(str(img_dir / "a.png"),
                np.random.default_rng(0).integers(0, 255, size=(64, 64, 3)).astype(np.uint8))
    r = _run("inference", model, ["--image_path", str(img_dir), "--out_dir",
                                  str(tmp_path / "out"), "--serving", "std"], tmp_path)
    assert r.returncode == 0, r.stderr[-1500:]
    assert (tmp_path / "out" / "pred_a.png").exists()
    if model == "swin":
        r = _run("inference", model, ["--image_path", str(img_dir), "--out_dir",
                                      str(tmp_path / "out"), "--serving", "fast"], tmp_path)
        assert r.returncode != 0 and "HRNet only" in r.stderr
