"""The port's CLI tools (``python -m hrnet_hand_pose_estimation_tpu_torch.tools.*``)
end to end on the CPU with ``--device cpu`` on experiments/synthetic_smoke.yaml,
mirroring tests/test_tools_behavior.py:225-290 for the JAX tools: each run
exits 0 and writes the JAX tool's artifacts in their formats."""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "experiments", "synthetic_smoke.yaml")
TOOLS = "hrnet_hand_pose_estimation_tpu_torch.tools."

torch.set_num_threads(1)


@pytest.fixture
def rng():
    """A fresh generator per test: drawing from conftest's shared ``rng``
    would shift the data of other test files in the same worker."""
    return np.random.default_rng(0)


def _run(tool, args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", TOOLS + tool, "--cfg", SMOKE, "--device", "cpu",
                           *args], capture_output=True, text=True, env=env, cwd=cwd, timeout=500)


def _images(tmp_path, rng, names=("a",)):
    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir)
    for name in names:
        cv2.imwrite(str(img_dir / f"{name}.png"),
                    rng.integers(0, 255, size=(64, 64, 3)).astype(np.uint8))
    return img_dir


def test_evaluate_2d_tool_writes_the_artifacts(tmp_path):
    r = _run("evaluate_2d", ["--out", str(tmp_path / "ev")], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    results = json.loads(r.stdout[r.stdout.index("{"):])
    assert set(results) == {"EPE_px", "PCK_AUC_30", "PCK_AUC_full", "PCK@20px", "fps"}
    out = tmp_path / "ev" / "eval2D_results_synthetic_smoke"
    epe = (out / "mse2d_each_joint.txt").read_text().splitlines()
    assert len(epe) == 21 and all(len(line.split(".")[1]) == 4 for line in epe)
    assert np.loadtxt(out / "PCK2d.txt").shape == (2, 49)


@pytest.mark.parametrize("serving", ["std", "fast"])
def test_inference_tool_serving(tmp_path, rng, serving):
    """--serving std / fast write a skeleton overlay per image (reference
    tools/inference.py:27-246 image mode)."""
    img_dir = _images(tmp_path, rng)
    out = tmp_path / "out"
    r = _run("inference", ["--image_path", str(img_dir), "--out_dir", str(out),
                           "--serving", serving], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    assert (out / "pred_a.png").exists() and "wrist at" in r.stdout


@pytest.mark.slow
def test_inference_tool_int8_serving(tmp_path, rng):
    """--serving int8 calibrates on the input frames and serves the W8A8 trunk."""
    img_dir = _images(tmp_path, rng, ("a", "b"))
    out = tmp_path / "out"
    r = _run("inference", ["--image_path", str(img_dir), "--out_dir", str(out),
                           "--serving", "int8"], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    assert (out / "pred_a.png").exists() and (out / "pred_b.png").exists()


@pytest.mark.slow
def test_calibrate_tool_and_saved_record_serving(tmp_path, rng):
    """calibrate writes the portable record; inference and evaluate_2d serve
    int8 from it (calibrate once, deploy)."""
    img_dir = _images(tmp_path, rng, ("a", "b"))
    calib = str(tmp_path / "calibration.json")
    r = _run("calibrate", ["--image_path", str(img_dir), "--out", calib], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    rec = json.load(open(calib))
    assert rec["version"] == 1 and any(s.startswith("stage4") for s in rec["amax"])
    r = _run("inference", ["--image_path", str(img_dir), "--out_dir", str(tmp_path / "out"),
                           "--serving", "int8", "--calib", calib], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    r = _run("evaluate_2d", ["--out", str(tmp_path / "ev"), "--serving", "int8",
                             "--calib", calib], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    assert (tmp_path / "ev" / "eval2D_results_synthetic_smoke" / "PCK2d.txt").exists()


def test_train_tool_checkpoints_and_logs(tmp_path):
    """One epoch of the smoke config: its checkpoint, the best snapshot, and
    a log with the model summary; then the snapshot evaluated."""
    out = tmp_path / "run"
    r = _run("train", ["OUTPUT_DIR", str(out), "TRAIN.END_EPOCH", "1"], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    run = out / "Synthetic_kpt" / "synthetic_smoke"
    assert (run / "checkpoints" / "ckpt_0.pt").exists()
    assert (run / "checkpoints" / "best.pt").exists()
    log = "".join(p.read_text() for p in run.glob("*_train.log"))
    assert "Model PoseHRNet" in log and "GFLOPs/batch" in log and "Validate[0]" in log
    # the snapshot serves the evaluation tool through --model_path
    r = _run("evaluate_2d", ["--out", str(tmp_path / "ev"), "--model_path",
                             str(run / "checkpoints" / "best.pt")], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    assert np.isfinite(json.loads(r.stdout[r.stdout.index("{"):])["EPE_px"])


def test_tools_refuse_bad_arguments(tmp_path):
    r = _run("inference", ["--serving", "fast"], tmp_path)
    assert r.returncode != 0 and "--image_path or --video_path required" in r.stderr
    r = _run("evaluate_2d", ["--serving", "fp8"], tmp_path)
    assert r.returncode != 0 and "invalid choice" in r.stderr
