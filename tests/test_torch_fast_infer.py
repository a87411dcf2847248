"""The port's bf16 serving slice (core/fast_infer.make_fast_infer) against
the JAX package's, and the port's independence from JAX."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.core.fast_infer import make_fast_infer as jax_make_fast_infer
from hrnet_hand_pose_estimation_tpu.models.hrnet import hrnet_from_cfg as jax_hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import make_fast_infer, precast_variables
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import fused_bottleneck_chain
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_head_decode import fused_head_decode_v2
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables, init_variables

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def test_slice_matches_jax_fast_infer(tiny_cfg, rng):
    """Same weights as tests/test_pallas_kernels.py::test_fast_infer_path_parity."""
    std = jax_hrnet_from_cfg(tiny_cfg, head="softmax", dtype=jnp.bfloat16)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    v = std.init(jax.random.key(0), jnp.asarray(x), False)
    v = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * 0.05).astype(np.float32) if a.ndim > 1 else
        (np.abs(rng.normal(size=a.shape)) * 0.05 + 0.5).astype(np.float32), v)
    want = np.asarray(jax_make_fast_infer(tiny_cfg, pallas_layer1=False, interpret=True)(
        v, jnp.asarray(x)))

    cfg = config_from_dict(tiny_cfg.to_dict())
    weights = precast_variables(cfg, from_jax_variables(jax.tree.map(np.asarray, v)), device="cpu")
    got = make_fast_infer(cfg, device="cpu")(weights, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 21, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0.05)


def test_serving_weights_and_inputs(tiny_cfg):
    cfg = config_from_dict(tiny_cfg.to_dict())
    weights = precast_variables(cfg, init_variables(cfg, seed=3), device="cpu")
    convs = [m for m in weights.model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert all(m.weight.dtype == torch.bfloat16 and m.bias is not None for m in convs)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in weights.model.stage2.modules())
    assert weights.layer1[1] == (True, False, False, False)
    infer = make_fast_infer(cfg, device="cpu")
    before = (fused_bottleneck_chain.launches, fused_head_decode_v2.launches)
    out = infer(weights, torch.zeros(3, 64, 64, 3))
    assert out.shape == (3, 21, 2) and torch.isfinite(out).all()
    assert (fused_bottleneck_chain.launches, fused_head_decode_v2.launches) == before
    with pytest.raises(ValueError, match="images must be"):
        infer(weights, torch.zeros(3, 32, 32, 3))


def test_port_imports_no_jax():
    """The port and the chip scripts' imports run with jax, flax, the JAX
    package, cv2 and yaml blocked, as on the card's machine."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'hrnet_hand_pose_estimation_tpu', 'cv2',\n"
        "             'yaml'):\n"
        "    sys.modules[name] = None\n"
        "import pkgutil, importlib, hrnet_hand_pose_estimation_tpu_torch as port\n"
        "for mod in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import chip_smoke, chip_conditioning\n"
        "for name in ('core.quant_infer', 'ops.kernels.conv_int8', 'ops.kernels.int8_chain',\n"
        "             'ops.kernels.fused_head_decode', 'core.fast_infer',\n"
        "             'ops.kernels.fused_bottleneck', 'ops.s2d', 'ops.targets',\n"
        "             'ops.kernels.gaussian_targets', 'ops.flip', 'data.legends',\n"
        "             'data.synthetic', 'data.pipeline', 'core.losses', 'core.loss_computer',\n"
        "             'core.metrics', 'core.trainer', 'parallel.train_step',\n"
        "             'parallel.checkpoint', 'utils.logging_utils',\n"
        "             'ops.kernels.softmax_decode', 'ops.decode', 'ops.image', 'ops.volumetric',\n"
        "             'data.transforms', 'data.build', 'core.evaluator', 'utils.summary',\n"
        "             'tools._common', 'tools.evaluate_2d', 'tools.inference',\n"
        "             'tools.calibrate', 'tools.train', 'ops.upsample', 'ops.cameras',\n"
        "             'ops.geometry', 'models.v2v', 'models.triangulation',\n"
        "             'core.evaluator3d', 'tools.evaluate_3d', 'tools.infer_3d',\n"
        "             'tools.dlt_check', 'core.trainer3d', 'core.trainer3d_gan', 'utils.vis',\n"
        "             'tools.train3d', 'tools.train3d_gan', 'tools.nerf_pose_est',\n"
        "             'models.cpm', 'models.multiview_hrnet', 'core.train_variants',\n"
        "             'data.mhp', 'models.pose_resnet', 'models.swin', 'models.hamburger',\n"
        "             'models.transformers', 'ops.precision', 'ops.deform_conv',\n"
        "             'models.temporal', 'models.pose_aggr', 'models.ftl',\n"
        "             'models.hourglass', 'models.mesh', 'models.mano', 'utils.graph',\n"
        "             'utils.renderer', 'ops.nms', 'utils.zipreader', 'data.cv',\n"
        "             'data.native', 'data.rhd', 'data.freihand', 'data.handgraph', 'data.fha',\n"
        "             'data.stb', 'data.coco_mpii', 'utils.fold_bn', 'utils.image_util',\n"
        "             'utils.profiling', 'parallel.precision', 'tools.accuracy_gate_full',\n"
        "             'tools.perf_latency', 'tools.compare', 'tools.resize_images',\n"
        "             'tools.generate_videos', 'tools.tsne_visualization', 'tools.record_video',\n"
        "             'tools.perf_bn_levers', 'tools.perf_multistep_sweep',\n"
        "             'tools.perf_int8_probe', 'tools.perf_quant_e2e', 'tools.perf_train_profile',\n"
        "             'parallel.mesh', 'parallel.distributed', 'parallel.tensor_parallel'):\n"
        "    assert port.__name__ + '.' + name in sys.modules, name\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax', 'cv2', 'yaml') for m in sys.modules"
        " if sys.modules[m] is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=300)


def test_port_sources_have_no_jax_import_lines():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|hrnet_hand_pose_estimation_tpu)(\.|\s|$)")
    files = list((REPO / "hrnet_hand_pose_estimation_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "chip_conditioning.py"]
    bad = [f"{f}:{i}" for f in files for i, line in enumerate(f.read_text().splitlines(), 1)
           if pattern.match(line)]
    assert len(files) > 10 and not bad
