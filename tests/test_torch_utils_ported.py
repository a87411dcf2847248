"""The port's utils/fold_bn, utils/image_util, parallel/precision and
utils/profiling (and utils/summary on flops_of) against the JAX package's
and its tests (tests/test_aux_ops.py, tests/test_profiling_and_vis.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu.utils import image_util as JIU
from hrnet_hand_pose_estimation_tpu.utils.fold_bn import fold_batchnorm as jax_fold_batchnorm
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.parallel.precision import (
    DynamicLossScaler, apply_updates_unless_overflow, cast_to_compute)
from hrnet_hand_pose_estimation_tpu_torch.utils import image_util as IU
from hrnet_hand_pose_estimation_tpu_torch.utils.fold_bn import conv_bn_pairs, fold_batchnorm
from hrnet_hand_pose_estimation_tpu_torch.utils.profiling import Throughput, flops_of, trace
from hrnet_hand_pose_estimation_tpu_torch.utils.summary import model_summary
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from torch_zoo_parity import jax_variables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_pair(tiny_cfg):
    """(JAX float32 tiny HRNet, its variables filled by leaf, port cfg)."""
    jcfg = tiny_cfg.clone()
    jcfg.defrost()
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jcfg.freeze()
    jm = jax_build_model(jcfg)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    return jcfg, jm, jax_variables(jm, 0, x, False), config_from_dict(jcfg.to_dict())


def test_fold_batchnorm_matches_jax(tiny_pair):
    """Every conv-BN pair folded as JAX's fold_batchnorm folds it (through
    the weight bridge, 1e-6), the BN left as the identity plus the folded
    bias; an eval forward of the folded state gives the unfolded one's
    logits within float32 rounding."""
    _, _, v, pcfg = tiny_pair
    model = build_model(pcfg).eval()
    state = from_jax_variables(v, model)
    want = from_jax_variables(jax.device_get(jax_fold_batchnorm(v)), model)
    got = fold_batchnorm(model, state)
    pairs = conv_bn_pairs(model)
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    assert len(pairs) == n_bn and pairs["bn1"] == "conv1" and pairs["last_layer.1"] == "last_layer.0"
    assert set(got) == set(want) == set(state)
    for name, val in want.items():
        np.testing.assert_allclose(got[name].numpy(), val.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    assert torch.equal(got["bn1.weight"], torch.ones(64))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        model.load_state_dict(state)
        ref = model.forward_logits(x)[0]
        model.load_state_dict(got)
        out = model.forward_logits(x)[0]
    # float32 rounding of the folded products, relative to the logits' scale
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


def test_fold_batchnorm_leaves_transposed_convs():
    """SimpleBaseline's deconv BNs follow ConvTranspose2d, whose weight is
    (in, out, ...): no pair; its stem and block pairs fold."""
    from hrnet_hand_pose_estimation_tpu_torch.models.pose_resnet import PoseResNet

    model = PoseResNet(num_layers=18, num_joints=21, num_deconv_layers=2,
                       deconv_filters=(16, 16)).eval()
    pairs = conv_bn_pairs(model)
    assert pairs["bn1"] == "conv1" and "layer1.0.bn2" in pairs
    assert not any(name.startswith("deconv_layers") for name in pairs)
    got = fold_batchnorm(model)
    assert torch.equal(got["deconv_layers.1.weight"], model.state_dict()["deconv_layers.1.weight"])


def test_image_util_matches_jax():
    """tests/test_aux_ops.py's image helpers (test_image_util_helpers) on
    the port, each against JAX's on the same inputs."""
    rng = np.random.default_rng(0)
    for bbox, ratio, size in [((10, 10, 20, 10), 1.5, (100, 100)),
                              ((90, 5, 30, 40), 2.0, (100, 80)), ((0, 0, 5, 5), 0.5, (64, 64))]:
        assert IU.expand_bbox(bbox, ratio, *size) == JIU.expand_bbox(bbox, ratio, *size)
        assert IU.square_bbox(bbox, *size) == JIU.square_bbox(bbox, *size)
    x0, y0, w, h = IU.expand_bbox((10, 10, 20, 10), 1.5, 100, 100)
    assert w == 30 and h == 15 and x0 == 5
    img = rng.uniform(size=(10, 20, 3)).astype(np.float32)
    (padded, off), (jpadded, joff) = IU.pad_to_square(img), JIU.pad_to_square(img)
    assert off == joff and np.array_equal(padded, jpadded) and padded.shape[:2] == (20, 20)
    assert np.array_equal(IU.crop_patch(img, 15, 5, 8), JIU.crop_patch(img, 15, 5, 8))
    hms = rng.uniform(size=(2, 8, 8, 3)).astype(np.float32)
    hms[0, 3, 5, 0] = 7.0
    got = IU.compute_uv_from_heatmaps(hms, (64, 48))
    want = np.asarray(JIU.compute_uv_from_heatmaps(hms, (64, 48)))
    assert got.shape == (2, 3, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0, 0].numpy(), [5 * 8, 3 * 6, 7.0], atol=1e-6)


def test_dynamic_loss_scaler_backoff_and_growth():
    """tests/test_aux_ops.py::test_dynamic_loss_scaler_backoff_and_growth."""
    scaler = DynamicLossScaler(init_scale=8.0, scale_window=2)
    state = scaler.init()
    grads = {"w": torch.tensor([8.0, 16.0])}
    g, state, overflow = scaler.unscale_and_update(grads, state)
    assert not bool(overflow)
    np.testing.assert_allclose(g["w"].numpy(), [1.0, 2.0])
    _, state, _ = scaler.unscale_and_update(grads, state)   # the window: doubles
    assert float(state.scale) == 16.0 and int(state.growth_counter) == 0
    bad = {"w": torch.tensor([float("inf"), 1.0])}
    _, state, overflow = scaler.unscale_and_update(bad, state)
    assert bool(overflow) and float(state.scale) == 8.0
    assert float(scaler.scale_loss(torch.tensor(2.0), state)) == 16.0


def test_apply_updates_skips_on_overflow():
    """tests/test_aux_ops.py::test_apply_updates_skips_on_overflow, and the
    compute-dtype cast."""
    params = {"w": torch.tensor([1.0])}
    updates = {"w": torch.tensor([0.5])}
    out = apply_updates_unless_overflow(params, updates, torch.tensor(True))
    np.testing.assert_allclose(out["w"].numpy(), [1.0])
    out = apply_updates_unless_overflow(params, updates, torch.tensor(False))
    np.testing.assert_allclose(out["w"].numpy(), [1.5])
    cast = cast_to_compute({"w": torch.ones(2), "n": torch.ones(2, dtype=torch.int32)})
    assert cast["w"].dtype == torch.bfloat16 and cast["n"].dtype == torch.int32


def test_throughput_meter_warmup():
    """tests/test_profiling_and_vis.py::test_throughput_meter_warmup."""
    th = Throughput(warmup_batches=2)
    assert th.samples_per_sec == 0.0
    for _ in range(5):
        th.update(16)
    assert th.samples_per_sec > 0
    assert th.n_samples == 3 * 16       # the warm-up batches are not counted


def test_flops_of_matmul_and_the_tiny_hrnet(tiny_pair):
    """2 * M * N * K for a matmul (tests/test_profiling_and_vis.py::
    test_flops_of_matmul); on the tiny HRNet's float32 forward at B=1 the
    count is 1.0205 of XLA's cost analysis (measured: XLA counts the
    elementwise work, the counter every conv and matmul), and
    model_summary reports it."""
    a, b = torch.ones(64, 128), torch.ones(128, 32)
    assert flops_of(lambda a, b: a @ b, a, b) == 2 * 64 * 128 * 32
    _, jm, v, pcfg = tiny_pair
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    cost = jax.jit(lambda v, x: jm.apply(v, x, False)).lower(v, x).compile().cost_analysis()
    xla = float((cost[0] if isinstance(cost, list) else cost)["flops"])
    model = build_model(pcfg).eval()
    got = flops_of(model, torch.zeros(1, 64, 64, 3))
    print(f"tiny HRNet at B=1: {got / 1e9:.4f} GFLOPs (torch), XLA {xla / 1e9:.4f}, "
          f"ratio {got / xla:.4f}")
    assert got / xla == pytest.approx(1.0205, abs=1e-3)
    line = model_summary(model, pcfg, batch=2)
    assert line.endswith(f"{2 * got / 1e9:.2f} GFLOPs/batch (torch FLOP counter)"), line


def test_trace_writes_a_file(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    path = tmp_path / "t" / "trace.json"
    assert path.exists() and os.path.getsize(path) > 100
