"""Port model (PyTorch PoseHRNet, ops, weight bridge) against the JAX package.

The same weights and inputs, made with numpy from a seed, go through the
JAX model and the port; tolerances are the JAX package's own
(tests/test_models.py: features 2e-4, heatmaps 1e-6 in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.config import load_config as jax_load_config
from hrnet_hand_pose_estimation_tpu.models.hrnet import hrnet_from_cfg as jax_hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu.ops import decode as jax_decode
from hrnet_hand_pose_estimation_tpu.ops import upsample as jax_upsample
from hrnet_hand_pose_estimation_tpu.utils.torch_convert import convert_hrnet_state_dict
from hrnet_hand_pose_estimation_tpu_torch.config import (POSE_HIGH_RESOLUTION_NET_EXTRA,
                                                         config_from_dict)
from hrnet_hand_pose_estimation_tpu_torch.models import build_model, registered_models
from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import PoseHRNet, hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.ops import decode, upsample
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables, init_variables

torch.set_num_threads(1)


def port_cfg(jax_cfg):
    return config_from_dict(jax_cfg.to_dict())


def jax_variables(model, x, rng):
    """Random f32 variables (the shapes of model.init), non-degenerate BN."""
    v = model.init(jax.random.key(0), jnp.asarray(x), False)
    v = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.05).astype(np.float32), v)
    v = jax.tree_util.tree_map_with_path(
        lambda path, a: np.abs(a) + 0.5 if "var" in jax.tree_util.keystr(path) else np.asarray(a), v)
    return v


@pytest.mark.parametrize("head", ["softmax", "plain"])
def test_pose_hrnet_matches_jax_f32(tiny_cfg, head):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    jm = jax_hrnet_from_cfg(tiny_cfg, head=head, dtype=jnp.float32)
    v = jax_variables(jm, x, rng)
    want = jm.apply(v, jnp.asarray(x), False)

    model = hrnet_from_cfg(port_cfg(tiny_cfg), head=head)
    model.load_state_dict(from_jax_variables(v, model))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), atol=2e-4)
    if head == "softmax":
        np.testing.assert_allclose(got.heatmaps.numpy(), np.asarray(want.heatmaps), atol=1e-6)
        assert float(got.temperature.detach()) == float(want.temperature)
    else:
        assert got.temperature is None and want.temperature is None
        np.testing.assert_allclose(got.heatmaps.numpy(), np.asarray(want.heatmaps), atol=2e-4)


@pytest.mark.slow
def test_pose_hrnet_w32_matches_jax_f32():
    cfg = jax_load_config(opts=["MODEL.NAME", "pose_hrnet_softmax"], freeze=False)
    cfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
    cfg.freeze()
    model = hrnet_from_cfg(port_cfg(cfg))
    state = init_variables(port_cfg(cfg), seed=0)
    model.load_state_dict(state)
    x = np.random.default_rng(0).normal(size=(1, 256, 256, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    jm = jax_hrnet_from_cfg(cfg, head="softmax", dtype=jnp.float32)
    v = convert_hrnet_state_dict({k: t.numpy() for k, t in state.items()})
    want = jm.apply(v, jnp.asarray(x), False)
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), atol=2e-3)
    np.testing.assert_allclose(got.heatmaps.numpy(), np.asarray(want.heatmaps), atol=1e-6)


def test_weight_bridge_round_trip(tiny_cfg):
    """port state_dict -> JAX convert_hrnet_state_dict -> from_jax_variables
    gives back the same tensors, key for key."""
    cfg = port_cfg(tiny_cfg)
    state = init_variables(cfg, seed=4)
    variables = convert_hrnet_state_dict({k: t.numpy() for k, t in state.items()})
    back = from_jax_variables(variables, hrnet_from_cfg(cfg))
    assert set(back) == set(state)
    for key, val in state.items():
        assert torch.equal(back[key], val), key


def test_weight_bridge_is_strict(tiny_cfg):
    cfg = port_cfg(tiny_cfg)
    state = init_variables(cfg, seed=4)
    variables = convert_hrnet_state_dict({k: t.numpy() for k, t in state.items()})
    model = hrnet_from_cfg(cfg)

    extra = {"params": dict(variables["params"], bogus={"kernel": np.zeros((1, 1, 2, 2))}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="bogus"):
        from_jax_variables(extra, model)
    with pytest.raises(KeyError, match="no place"):
        from_jax_variables(dict(variables, cache={}), model)

    params = dict(variables["params"])
    del params["final_conv"]
    with pytest.raises(KeyError, match="last_layer.3"):
        from_jax_variables({"params": params, "batch_stats": variables["batch_stats"]}, model)


def test_init_variables_seeded_and_folding_relevant(tiny_cfg):
    cfg = port_cfg(tiny_cfg)
    a, b = init_variables(cfg, seed=7), init_variables(cfg, seed=7)
    c = init_variables(cfg, seed=8)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    var = a["layer1.0.bn2.running_var"]
    mean = a["layer1.0.bn2.running_mean"]
    assert (var - 1).abs().mean() > 0.1 and mean.abs().mean() > 0.05
    hrnet_from_cfg(cfg).load_state_dict(a)          # strict load


def test_registry(tiny_cfg):
    assert registered_models() == ["CPM", "FTL", "HRNet_Emb_TCN", "HRNet_PredRNN", "HourGlass",
                                   "alg",
                                   "multiview_pose_hrnet", "my_pose_transformer", "pose_hrnet",
                                   "pose_hrnet_PoseAggr", "pose_hrnet_hamburger",
                                   "pose_hrnet_softmax", "pose_hrnet_trainable_softmax",
                                   "pose_hrnet_transformer", "pose_hrnet_volumetric",
                                   "pose_resnet", "ransac", "swin_transformer", "vol", "vol_CPM"]
    cfg = port_cfg(tiny_cfg)
    model = build_model(cfg)
    assert isinstance(model, PoseHRNet) and model.head == "softmax" and not model.training
    from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
    from hrnet_hand_pose_estimation_tpu_torch.models.cpm import CPM
    from hrnet_hand_pose_estimation_tpu_torch.models.ftl import FTLMultiviewNet
    from hrnet_hand_pose_estimation_tpu_torch.models.hourglass import HGFilter
    from hrnet_hand_pose_estimation_tpu_torch.models.hamburger import PoseHRNetHamburger
    from hrnet_hand_pose_estimation_tpu_torch.models.multiview_hrnet import MultiViewPoseNet
    from hrnet_hand_pose_estimation_tpu_torch.models.pose_resnet import PoseResNet
    from hrnet_hand_pose_estimation_tpu_torch.models.swin import SwinPose
    from hrnet_hand_pose_estimation_tpu_torch.models.pose_aggr import PoseAggrNet
    from hrnet_hand_pose_estimation_tpu_torch.models.temporal import HRNetEmbTCN, HRNetPredRNN
    from hrnet_hand_pose_estimation_tpu_torch.models.transformers import (PoolingTransformer,
                                                                          PoseTransformer)

    for name, kind in (("CPM", CPM), ("multiview_pose_hrnet", MultiViewPoseNet),
                       ("pose_resnet", PoseResNet), ("swin_transformer", SwinPose),
                       ("pose_hrnet_hamburger", PoseHRNetHamburger),
                       ("my_pose_transformer", PoolingTransformer),
                       ("pose_hrnet_transformer", PoseTransformer),
                       ("pose_hrnet_PoseAggr", PoseAggrNet), ("HRNet_PredRNN", HRNetPredRNN),
                       ("HRNet_Emb_TCN", HRNetEmbTCN), ("FTL", FTLMultiviewNet),
                       ("HourGlass", HGFilter)):
        other = config_from_dict(cfg.to_dict(), freeze=False)
        other.MODEL.NAME = name
        model = build_model(other.freeze())
        assert isinstance(model, kind) and not model.training, name
    with pytest.raises(KeyError, match="Registered"):
        from hrnet_hand_pose_estimation_tpu_torch.models import get_builder
        get_builder("pose_cpm_nope")


@pytest.mark.parametrize("src,dst", [(8, 16), (2, 16), (5, 13), (16, 64)])
def test_upsample_matches_jax(src, dst):
    x = np.random.default_rng(src * dst).normal(size=(2, src, src + 1, 3)).astype(np.float32)
    want = jax_upsample.upsample_bilinear_align_corners(jnp.asarray(x), (dst, dst + 2))
    got = upsample.upsample_bilinear_align_corners(torch.from_numpy(x), (dst, dst + 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(upsample.align_corners_matrix(src, dst),
                                  jax_upsample._align_corners_matrix(src, dst))
    near = upsample.upsample_nearest(torch.from_numpy(x), 4).numpy()
    np.testing.assert_array_equal(near, np.asarray(jax_upsample.upsample_nearest(jnp.asarray(x), 4)))


def test_softmax_decode_matches_jax():
    logits = np.random.default_rng(1).normal(size=(3, 16, 12, 21)).astype(np.float32) * 3
    for temp in (1.0, 2.5):
        want = jax_decode.soft_argmax(jax_decode.spatial_softmax(jnp.asarray(logits), temp))
        probs = decode.spatial_softmax(torch.from_numpy(logits), temp)
        np.testing.assert_allclose(probs.sum(dim=(1, 2)).numpy(), 1.0, atol=1e-5)
        np.testing.assert_allclose(decode.soft_argmax(probs).numpy(), np.asarray(want), atol=1e-4)
