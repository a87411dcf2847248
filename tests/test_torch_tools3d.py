"""The port's 3D training tools and the 2D trainer's debug dump, on the CPU.

- ``tools.train3d`` and ``tools.train3d_gan`` for one epoch of two batches
  on experiments/synthetic_vol_smoke.yaml (V2V at 32^3), as subprocesses:
  they exit 0 and write the checkpoint of the epoch and the best model;
- ``tools.nerf_pose_est`` on an LLFF scene the test writes (three views,
  ``poses_bounds.npy`` and PNGs): the JAX tool's pose reader and
  projections, and the RANSAC triangulation of the written 2D keypoints;
- C12: the 2D ``Trainer`` with ``DEBUG.DEBUG`` writes the JAX trainer's
  debug file names for the first validation batch of each epoch.
"""

import importlib.util
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer
from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import DataLoader
from hrnet_hand_pose_estimation_tpu_torch.data.synthetic import SyntheticDataset
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.tools import nerf_pose_est as port_nerf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOL_SMOKE = os.path.join(REPO, "experiments", "synthetic_vol_smoke.yaml")
SMOKE = os.path.join(REPO, "experiments", "synthetic_smoke.yaml")
TOOLS = "hrnet_hand_pose_estimation_tpu_torch.tools."

torch.set_num_threads(1)


def _run(tool, cfg, args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", TOOLS + tool, "--cfg", cfg, "--device", "cpu",
                           *args], capture_output=True, text=True, env=env, cwd=cwd, timeout=500)


@pytest.mark.parametrize("tool", ["train3d", "train3d_gan"])
def test_train3d_tools_run_one_epoch(tmp_path, tool):
    out = tmp_path / "out"
    r = _run(tool, VOL_SMOKE, ["MODEL.VOLUME_SIZE", "32", "OUTPUT_DIR", str(out),
                               "TRAIN.IMAGES_PER_GPU", "8", "TEST.IMAGES_PER_GPU", "8"], tmp_path)
    assert r.returncode == 0, r.stderr[-1500:]
    log = r.stdout + r.stderr
    assert "Validate3D[0]" in log and "pose3d_loss=" in log
    if tool == "train3d_gan":
        assert "critic_loss=" in log and "adv_loss=" in log
    ckpts = [f for _, _, files in os.walk(out) for f in files]
    assert "best.pt" in ckpts and any(f.startswith("ckpt") or "0" in f for f in ckpts)


def _jax_nerf_tool():
    """The JAX package's tools/nerf_pose_est.py module (its helpers import
    nothing of JAX at module level)."""
    tools = os.path.join(REPO, "tools")
    sys.path.insert(0, tools)
    try:
        spec = importlib.util.spec_from_file_location("jax_nerf_pose_est",
                                                      os.path.join(tools, "nerf_pose_est.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.remove(tools)


def _scene(path, rng, n=3, size=96):
    """An LLFF scene: n cameras 900 mm from the origin looking at it, in
    LLFF's [down, right, back] axes, images of ``size`` px."""
    rows = []
    for i in range(n):
        ang = 0.4 + 0.7 * i
        fwd = -np.array([np.sin(ang), 0.1, np.cos(ang)])
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        centre = -900.0 * fwd
        c2w = np.stack([down, right, -fwd, centre], axis=1)          # LLFF columns
        hwf = np.array([[size], [size], [120.0]])
        rows.append(np.concatenate([np.concatenate([c2w, hwf], 1).reshape(-1), [100., 2000.]]))
    os.makedirs(path / "images")
    np.save(path / "poses_bounds.npy", np.stack(rows))
    for i in range(n):
        cv2.imwrite(str(path / "images" / f"view{i}.png"),
                    rng.integers(0, 255, size=(size, size, 3)).astype(np.uint8))


def test_nerf_pose_est_on_a_written_scene(tmp_path):
    rng = np.random.default_rng(0)
    scene = tmp_path / "scene"
    _scene(scene, rng)
    jax_tool = _jax_nerf_tool()
    want = jax_tool.load_llff_poses(str(scene))
    got = port_nerf.load_llff_poses(str(scene))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(port_nerf.llff_projections(got[0], got[1]),
                               jax_tool.llff_projections(want[0], want[1]), rtol=1e-6)
    # the origin projects to each image's centre: the cameras look at it
    proj = port_nerf.llff_projections(got[0], got[1])
    uvw = proj @ np.array([0.0, 0.0, 0.0, 1.0])
    np.testing.assert_allclose(uvw[:, :2] / uvw[:, 2:], 48.0, atol=1e-3)

    out = tmp_path / "out"
    r = _run("nerf_pose_est", SMOKE, ["--scene", str(scene), "--out_dir", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr[-1500:]
    kp3d = np.loadtxt(out / "pose3d.txt")
    kp2d = np.loadtxt(out / "pose2d_per_view.txt").reshape(3, 21, 2)
    assert kp3d.shape == (21, 3) and np.isfinite(kp3d).all()
    assert ((kp2d >= 0) & (kp2d <= 96)).all()
    from hrnet_hand_pose_estimation_tpu_torch.ops.geometry import triangulate_batch

    again = triangulate_batch(torch.from_numpy(kp2d[None].astype(np.float32)),
                              torch.from_numpy(proj[None].astype(np.float32)), method="ransac")
    np.testing.assert_allclose(kp3d, again[0].numpy(), rtol=1e-4, atol=1e-3)


def test_debug_dump_writes_the_jax_file_names(tiny_cfg, tmp_path):
    """C12: one epoch with DEBUG.DEBUG and every SAVE_* flag writes the first
    validation batch as ``debug_e{epoch}_{name}_{gt,pred,hm_gt,hm_pred}.jpg``,
    the names the JAX trainer's ``save_debug_images`` writes."""
    from hrnet_hand_pose_estimation_tpu.utils.vis import save_debug_images as jax_save

    cfg = config_from_dict(tiny_cfg.to_dict(), freeze=False)
    cfg.merge_from_list(["OUTPUT_DIR", str(tmp_path), "TRAIN.BEGIN_EPOCH", 0,
                         "TRAIN.END_EPOCH", 1, "WORKERS", 0, "DEBUG.DEBUG", True,
                         "DEBUG.SAVE_BATCH_IMAGES_GT", True, "DEBUG.SAVE_BATCH_IMAGES_PRED", True,
                         "DEBUG.SAVE_HEATMAPS_GT", True, "DEBUG.SAVE_HEATMAPS_PRED", True])
    cfg.freeze()
    train = {"synthetic": DataLoader(SyntheticDataset(cfg, length=2), 2, num_workers=0)}
    val = {"synthetic": DataLoader(SyntheticDataset(cfg, "validation", length=4), 2,
                                   shuffle=False, num_workers=0)}
    out = tmp_path / "run"
    Trainer(cfg, build_model(cfg), train, val, output_dir=str(out), device="cpu").fit()
    got = sorted(f for f in os.listdir(out) if f.startswith("debug_"))
    batch = next(iter(val["synthetic"]))
    jax_dir = tmp_path / "jax"
    jax_save(cfg, batch["imgs"], batch["pose2d"] * 4, batch["pose2d"] * 4, batch["heatmaps"],
             batch["heatmaps"], prefix=str(jax_dir / "debug_e0_synthetic"))
    assert got == sorted(os.listdir(jax_dir)) and len(got) == 4
    for name in got:
        img = cv2.imread(str(out / name))
        assert img is not None and img.shape == cv2.imread(str(jax_dir / name)).shape
