"""The port's 3D evaluation (``core/evaluator3d.Evaluator3D``) against the
JAX package's on ``Synthetic_mv`` (4 samples, 2 views, tiny widths, V2V at
32^3), in model mode for the alg, ransac and vol nets and in dlt mode, on
shared float32 weights; and the port's 3D tools as CPU subprocess smokes.

Limits: every metric to 1e-3 relative (the 2D ones, decoded by B4's twin
on both sides' logits, to 1e-4).  The alg, ransac and vol nets run a DLT
by eigh (the vol net's base point), which the port solves in float64 from
its float32 A^T A: on a random net's detections, which disagree across
views, a float32 eigh is mm to km off the exact DLT (tests/
test_torch_triangulation.py), and the 3D metrics of such points say
nothing.  So the JAX evaluator runs here with its ``jnp.linalg.eigh``
solved in float64 on the host (``jax_eigh64``, a test-time patch of the
JAX geometry module's ``jnp``; no file of the JAX package changes).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.core.evaluator3d import Evaluator3D as JaxEvaluator3D
from hrnet_hand_pose_estimation_tpu.data.build import make_test_dataloader as jax_loaders
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu.models.triangulation import \
    build_triangulation_net as jax_build_net
from hrnet_hand_pose_estimation_tpu.ops.geometry import compose_projection as jax_compose
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator3d import Evaluator3D
from hrnet_hand_pose_estimation_tpu_torch.data.build import make_test_dataloader
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.triangulation import build_triangulation_net
from hrnet_hand_pose_estimation_tpu_torch.parallel.mesh import make_mesh
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from tests.test_torch_triangulation import activate, init_like, jax_eigh64  # noqa: F401

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
KEYS_2D = ("EPE2D_px", "PCK2D_AUC_30")
KEYS_3D = ("EPE3D_mm", "PCK3D_AUC", "PCK3D@20mm")


def eval3d_cfg(tiny_cfg, kind):
    cfg = tiny_cfg.clone()
    cfg.defrost()
    cfg.DATASET.DATASET = ["Synthetic_mv"]
    cfg.DATASET.TEST_DATASET = ["Synthetic_mv"]
    cfg.DATASET.NUM_VIEWS = 2
    cfg.MODEL.TRIANGULATION_MODEL_NAME = kind
    cfg.MODEL.VOLUME_SIZE = 32
    cfg.MODEL.CUBOID_SIZE = 400.0
    cfg.MODEL.VOL_CONFIDENCES = False
    cfg.MODEL.ALG_CONFIDENCES = False
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TEST.IMAGES_PER_GPU = 2
    cfg.WORKERS = 0
    cfg.EXP_NAME = "port_eval3d"
    return cfg.freeze()


def jax_side(jcfg, mode, kind, loader):
    """(JAX model, activated numpy variables) on the first batch's shapes."""
    rng = np.random.default_rng(11)
    batch = next(iter(loader))
    images = jnp.asarray(batch["imgs"])
    if mode == "dlt":
        model = jax_build_model(jcfg)
        args = (images.reshape(-1, *images.shape[2:]), False)
    else:
        model = jax_build_net(jcfg, kind)
        if kind == "vol":
            model = model.clone(dtype=jnp.float32)
        proj = jax_compose(jnp.asarray(batch["intrinsic_matrix"])[:, None],
                           jnp.asarray(batch["extrinsic_matrices"]))
        args = (images, proj, False)
    return model, activate(init_like(model, rng, *args), rng)


@pytest.mark.parametrize("mode,kind", [("model", "alg"), ("model", "ransac"), ("model", "vol"),
                                       ("dlt", "alg")])
def test_evaluator3d_matches_jax(tiny_cfg, tmp_path, jax_eigh64, mode, kind):
    jcfg = eval3d_cfg(tiny_cfg, kind)
    jloader = next(iter(jax_loaders(jcfg, n_devices=1).values()))
    jloader.dataset.length = 4
    jmodel, variables = jax_side(jcfg, mode, kind, jloader)
    want = JaxEvaluator3D(jcfg, jmodel, variables, mode=mode).run(jloader, output_dir=str(
        tmp_path / "jax"))

    cfg = config_from_dict(jcfg.to_dict())
    loader = make_test_dataloader(cfg)["Synthetic_mv"]
    loader.dataset.length = 4
    model = (build_model(cfg) if mode == "dlt"
             else build_triangulation_net(cfg, kind, dtype=torch.float32))
    ev = Evaluator3D(cfg, model, from_jax_variables(variables, model), mode=mode, device="cpu")
    got = ev.run(loader, output_dir=str(tmp_path / "port"))

    assert set(got) == set(want)
    assert all(np.isfinite(v) for v in got.values())
    for key in KEYS_2D:
        assert got[key] == pytest.approx(want[key], rel=1e-4), key
    for key in KEYS_3D:
        assert got[key] == pytest.approx(want[key], rel=1e-3, abs=1e-6), key
    sub = "eval3D_results_port_eval3d"
    for name, shape in (("mse2d_each_joint.txt", (21,)), ("mse3d_each_joint.txt", (21,)),
                        ("PCK2d.txt", (2, 49)), ("PCK3d.txt", (2, 50))):
        port = np.loadtxt(tmp_path / "port" / sub / name)
        assert port.shape == np.loadtxt(tmp_path / "jax" / sub / name).shape == shape, name


def test_views_subset_and_entry_checks(tiny_cfg):
    """``views`` evaluates a subset of the views, as JAX's, also over a
    'model' mesh axis; an unknown mode raises."""
    cfg = config_from_dict(eval3d_cfg(tiny_cfg, "alg").to_dict())
    cfg.defrost()
    cfg.DATASET.NUM_VIEWS = 3
    cfg.freeze()
    loader = make_test_dataloader(cfg)["Synthetic_mv"]
    loader.dataset.length = 2
    ev = Evaluator3D(cfg, build_triangulation_net(cfg, "alg"), None, device="cpu")
    res = ev.run(loader, views=[0, 2])
    assert all(np.isfinite(v) for v in res.values())
    # a 'model' mesh axis (JAX's tensor parallelism) is taken: the row's split net
    ev = Evaluator3D(cfg, build_triangulation_net(cfg, "alg"), None, device="cpu",
                     mesh=make_mesh(("data", "model"), (1, 2), ["cpu", "cpu"]))
    assert all(np.isfinite(v) for v in ev.run(loader, views=[0, 2]).values())
    with pytest.raises(ValueError, match="mode"):
        Evaluator3D(cfg, build_triangulation_net(cfg, "alg"), None, mode="x", device="cpu")


def _tool(args, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "hrnet_hand_pose_estimation_tpu_torch.tools." +
                          args[0], *args[1:]], capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_evaluate_3d_tool_smoke(tmp_path):
    """tools.evaluate_3d on experiments/synthetic_vol_smoke.yaml (V2V at
    32^3), in model mode and with --dlt (the volumetric backbone as the 2D
    model), on the CPU."""
    for extra in ([], ["--dlt", "MODEL.NAME", "pose_hrnet_volumetric"]):
        out = tmp_path / ("dlt" if extra else "vol")
        text = _tool(["evaluate_3d", "--cfg", "experiments/synthetic_vol_smoke.yaml", "--device",
                      "cpu", "--out", str(out), *extra, "MODEL.VOLUME_SIZE", "32",
                      "TPU.COMPUTE_DTYPE", "float32"], tmp_path)
        res = json.loads(text[text.index("{"):])
        assert set(res) == {"EPE2D_px", "EPE3D_mm", "PCK3D_AUC", "PCK3D@20mm", "PCK2D_AUC_30"}
        assert all(np.isfinite(v) for v in res.values())
        d = out / "eval3D_results_synthetic_vol_smoke"
        assert np.loadtxt(d / "PCK3d.txt").shape == (2, 50)


def test_dlt_check_and_infer_3d_tool_smoke(tmp_path):
    text = _tool(["dlt_check", "--views", "4", "--noise", "0.5", "--device", "cpu"], tmp_path)
    rows = {line.split()[0]: [float(x) for x in line.split()[1:]] for line in text.splitlines()
            if line.split()[:1] and line.split()[0] in ("eigh", "svd", "sii", "ransac")}
    assert set(rows) == {"eigh", "svd", "sii", "ransac"}
    assert rows["eigh"][0] < 2.0 and rows["svd"][0] < 2.0      # mean error, mm
    text = _tool(["infer_3d", "--cfg", "experiments/synthetic_vol_smoke.yaml", "--device", "cpu",
                  "--out_dir", str(tmp_path / "inf"), "--num_samples", "1",
                  "MODEL.VOLUME_SIZE", "32", "TPU.COMPUTE_DTYPE", "float32"], tmp_path)
    assert "3D EPE" in text
    assert np.loadtxt(tmp_path / "inf" / "sample0_pose3d.txt").shape == (21, 3)
