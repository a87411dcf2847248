"""The port's FTL multiview net (``models/ftl.py``) and ``_fold_views``
against the JAX package's: the view folding, the transposed convs (odd input
sizes too), the forward at 2 and 4 views, the gradient of the head (the
backbone gets none), the bridge both ways, the registry's net and
``init_variables``, and ROADMAP C21 (JAX's tools cannot train or evaluate
FTL; the port's raise).

tiny_cfg's HRNet (64 px, 120-channel features on a 16x16 plane): the
encoder head gives a 6x6 plane (12 homogeneous triplets a channel), the
decoder 6 -> 9 -> 16 -> 16.  Weights from ``tests/torch_zoo_parity.py``, the
BN running statistics set to those of one train-mode forward of the test
inputs, the final conv scaled by 12 (logits varying by ~2 a plane, as a
trained head's); cameras from ``models.ftl.seeded_cameras``.  Float32, limits:
keypoints_2d 1e-3 px, heatmaps 1e-5, keypoints_3d 1e-3 of max|kp3d|, the
head's gradients 1e-4 of their largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu.models import ftl as jax_ftl
from hrnet_hand_pose_estimation_tpu.models.hrnet import hrnet_from_cfg as jax_hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu.models.triangulation import _fold_views as jax_fold_views
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.ftl import (FTLMultiviewNet,
                                                             conv_transpose_torch,
                                                             seeded_cameras)
from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.models.triangulation import _fold_views
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import (_tree_kind, _weight,
                                                                from_jax_variables,
                                                                init_variables)
from torch_zoo_parity import jax_variables, zoo_cfgs

torch.set_num_threads(1)
B = 2


def inputs(v, seed=1):
    images = np.random.default_rng(seed).normal(size=(B, v, 64, 64, 3)).astype(np.float32)
    extr, intr = seeded_cameras(B, v, 64, seed)
    return images, extr.numpy(), intr.numpy()


def jax_pair(tiny_cfg, v):
    """(JAX FTL float32, its variables with the batch statistics of the test
    inputs, the port net with them (float32), the inputs)."""
    jcfg, pcfg = zoo_cfgs(tiny_cfg, "pose_hrnet_softmax")
    jm = jax_ftl.FTLMultiviewNet(backbone=jax_hrnet_from_cfg(jcfg, head="softmax"),
                                 num_views=v, dtype=jnp.float32)
    x, extr, intr = inputs(v)
    variables = jax_variables(jm, 0, x[:1], extr[:1], intr[:1], False)
    _, upd = jax.jit(lambda var: jm.apply(var, x, extr, intr, True, mutable=["batch_stats"]))(
        variables)
    # flax's update is 0.9 old + 0.1 batch: solved for the batch's
    variables["batch_stats"] = jax.tree.map(
        lambda n, o: np.asarray((np.asarray(n, np.float64) - 0.9 * o) / 0.1, np.float32),
        upd["batch_stats"], variables["batch_stats"])
    # the decoder has no BN: the head scaled so the logits vary by ~2 a plane,
    # as a trained head's, instead of ~0.16 (a nearly flat softmax)
    head = variables["params"]["final_layer"]
    variables["params"]["final_layer"] = {k: v * 12.0 for k, v in head.items()}
    model = FTLMultiviewNet(hrnet_from_cfg(pcfg, head="softmax"), num_views=v,
                            dtype=torch.float32).eval()
    model.load_state_dict(from_jax_variables(variables, model))
    return jm, variables, model, (x, extr, intr)


@pytest.fixture(scope="module")
def four_views(tiny_cfg):
    return jax_pair(tiny_cfg, 4)


def test_fold_views():
    x = np.random.default_rng(0).normal(size=(3, 4, 5, 6, 2)).astype(np.float32)
    got, b, v = _fold_views(torch.from_numpy(x))
    want, jb, jv = jax_fold_views(jnp.asarray(x))
    assert (b, v) == (jb, jv) == (3, 4) and got.shape == (12, 5, 6, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size,stride,padding,out_pad", [(6, 2, 2, 0), (9, 2, 2, 1),
                                                         (16, 1, 1, 0), (7, 2, 2, 1)])
def test_conv_transpose_matches_flax(size, stride, padding, out_pad):
    """The port's ``ConvTranspose2d(3, s, p, op)`` with the bridge's flipped,
    axis-swapped kernel against flax's ``ConvTranspose`` with padding
    (k-1-p, k-1-p+op), odd input sizes included: the same size, 1e-5."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size + 1, 5)).astype(np.float32)
    kernel = rng.normal(size=(3, 3, 5, 4)).astype(np.float32)
    bias = rng.normal(size=(4,)).astype(np.float32)
    pad = [(2 - padding, 2 - padding + out_pad)] * 2
    layer = fnn.ConvTranspose(4, (3, 3), strides=(stride, stride), padding=pad)
    want = np.asarray(layer.apply({"params": {"kernel": kernel, "bias": bias}}, x))
    port = conv_transpose_torch(5, 4, 3, stride, padding, out_pad)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.ascontiguousarray(_weight(kernel, "deconv2"))))
        port.bias.copy_(torch.from_numpy(bias))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert got.shape[1] == (size - 1) * stride - 2 * padding + 3 + out_pad
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def jax_forward(jm, variables, x, extr, intr, float64: bool):
    """JAX's eval forward, in float64 (under ``enable_x64``: the backbone and
    the net in float64; JAX's own softmax, decode and SII cast to float32)
    or in float32."""
    if not float64:
        return jax.jit(jm.apply, static_argnums=4)(variables, x, extr, intr, False)
    with jax.enable_x64(True):
        j64 = jm.clone(dtype=jnp.float64, backbone=jm.backbone.clone(dtype=jnp.float64))
        cast = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        out = jax.jit(j64.apply, static_argnums=4)(
            cast, *(jnp.asarray(a, jnp.float64) for a in (x, extr, intr)), False)
        return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("views,float64", [(2, True), (4, True), (4, False)])
def test_forward_matches_jax(tiny_cfg, four_views, views, float64):
    """In float64 on both sides: keypoints_2d within 1e-3 px, heatmaps
    within 1e-5, keypoints_3d within 1e-3 of max|kp3d|, at 2 and 4 views.
    In float32 the FTL is ill-conditioned (the features in the world frame
    are ~2 m of camera translation plus ~1e-2 of signal, and the BN after
    the view fusion divides the difference by its spread): the two sides
    part by ~2.5e-5 on the heatmaps, so float32 is held to 1e-4 there and
    to the same keypoint limits.  The decode spreads; the maps sum to 1."""
    jm, variables, model, (x, extr, intr) = (four_views if views == 4
                                              else jax_pair(tiny_cfg, views))
    want = jax_forward(jm, variables, x, extr, intr, float64)
    dtype = torch.float64 if float64 else torch.float32
    port = model.to(dtype)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a).to(dtype) for a in (x, extr, intr)))
    model.float()
    assert got.keypoints_2d.shape == (B, views, 21, 2) and got.keypoints_3d.shape == (B, 21, 3)
    assert got.heatmaps.shape == (B, views, 16, 16, 21)
    assert float(np.asarray(want.keypoints_2d).std()) > 0.5
    np.testing.assert_allclose(got.heatmaps.sum(dim=(2, 3)).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(got.heatmaps.numpy(), np.asarray(want.heatmaps), rtol=0,
                               atol=1e-5 if float64 else 1e-4)
    np.testing.assert_allclose(got.keypoints_2d.numpy(), np.asarray(want.keypoints_2d),
                               rtol=0, atol=1e-3)
    kp3d = np.asarray(want.keypoints_3d)
    assert np.abs(got.keypoints_3d.numpy() - kp3d).max() <= 1e-3 * np.abs(kp3d).max()


def jax_head_grads(jm, variables, x, extr, intr, target, r, float64: bool):
    """JAX's gradient of sum(target * r) in eval mode, by the port's names
    (float32 numpy), in float32 or with the nets in float64."""
    dt = np.float64 if float64 else np.float32
    with jax.enable_x64(float64):
        j = (jm.clone(dtype=jnp.float64, backbone=jm.backbone.clone(dtype=jnp.float64))
             if float64 else jm)
        cast = jax.tree.map(lambda a: jnp.asarray(a, dt), variables)
        args = [jnp.asarray(a, dt) for a in (x, extr, intr)]

        def loss(p):
            return jnp.sum(getattr(j.apply(dict(cast, params=p), *args, False), target) * r)

        grads = jax.device_get(jax.jit(jax.grad(loss))(cast["params"]))
    return from_jax_variables({"params": jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                      grads)})


@pytest.mark.parametrize("target", ["keypoints_2d", "keypoints_3d"])
def test_head_gradient_matches_jax(four_views, target):
    """The gradient of sum(target * r), r seeded (eval mode), float32: no
    backbone parameter gets one (``.detach()`` where JAX stops the
    gradient), nor in JAX; the head's parameters within max(1e-4, 2x the
    witness) of the largest of JAX's.  The witness is JAX's own float32
    gradient against its gradient with the nets in float64: the gradient
    is ill-conditioned in float32 (JAX's float32 and float64 gradients of
    deconv2's kernel part by ~5e-3 of the largest; JAX computes the FTL's
    geometry in float32 whatever the nets' dtype), so a fixed 1e-4 would
    hold JAX itself to less than it meets."""
    jm, variables, model, (x, extr, intr) = four_views
    shape = (B, 4, 21, 2) if target == "keypoints_2d" else (B, 21, 3)
    r = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    want = jax_head_grads(jm, variables, x, extr, intr, target, r, False)
    want64 = jax_head_grads(jm, variables, x, extr, intr, target, r, True)
    model.zero_grad(set_to_none=True)
    out = model(*(torch.from_numpy(a) for a in (x, extr, intr)))
    (getattr(out, target) * torch.from_numpy(r)).sum().backward()
    got = dict(model.named_parameters())
    backbone = [n for n in got if n.startswith("backbone.")]
    assert backbone and all(got[n].grad is None for n in backbone)
    assert all(not want[n].any() for n in backbone)
    head = [n for n in got if not n.startswith("backbone.")]
    assert all(got[n].grad is not None for n in head)
    gmax = max(float(want[n].abs().max()) for n in head)
    assert gmax > 0
    worst = max((float((got[n].grad - want[n]).abs().max()) / gmax, n) for n in head)
    witness = max(float((want64[n] - want[n]).abs().max()) / gmax for n in head)
    assert worst[0] <= max(1e-4, 2 * witness), (worst, witness)


def test_train_mode_matches_jax(four_views):
    """A train-mode forward (BN on the batch's statistics, the running
    statistics updated, the backbone's head's too, as JAX's forward runs it):
    every updated running statistic within 1e-4 of JAX's largest of its
    kind, the heatmaps within 1e-4 (float32)."""
    jm, variables, model, (x, extr, intr) = four_views
    want, upd = jax.jit(lambda v: jm.apply(v, x, extr, intr, True, mutable=["batch_stats"]))(
        variables)
    model.train()
    try:
        with torch.no_grad():
            got = model(*(torch.from_numpy(a) for a in (x, extr, intr)))
    finally:
        state = {k: v.clone() for k, v in model.state_dict().items()}
        model.eval().load_state_dict(from_jax_variables(variables, model))
    new = from_jax_variables({"params": variables["params"],
                              "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    head_bn = "backbone.last_layer.1.running_mean"
    assert not torch.equal(state[head_bn], from_jax_variables(variables)[head_bn])
    for kind in ("running_mean", "running_var"):
        keys = [k for k in new if k.endswith(kind)]
        scale = max(float(new[k].abs().max()) for k in keys)
        assert max(float((state[k] - new[k]).abs().max()) for k in keys) <= 1e-4 * scale
    np.testing.assert_allclose(got.heatmaps.numpy(), np.asarray(want.heatmaps), rtol=0,
                               atol=1e-4)


def test_bridge_is_strict_both_ways(four_views):
    """Every FTL leaf has its place and every key of the port is filled; a
    leaf too many or one missing raises.  The tree routes as FTL before the
    SimpleBaseline rule (it has a top-level final_layer); the deconvs are
    flipped as transposed convs."""
    jm, variables, model, _ = four_views
    assert "final_layer" in variables["params"] and _tree_kind(variables["params"]) == "ftl"
    sd = from_jax_variables(variables, model)
    assert set(sd) == set(model.state_dict())
    k = np.asarray(variables["params"]["deconv1"]["kernel"])
    np.testing.assert_array_equal(sd["deconv1.weight"].numpy(),
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))
    extra = dict(variables, params=dict(variables["params"],
                                        bogus={"kernel": np.zeros((1, 1, 1, 1), np.float32)}))
    with pytest.raises(KeyError):
        from_jax_variables(extra, model)
    fewer = dict(variables, params={k: v for k, v in variables["params"].items()
                                    if k != "deconv3"})
    with pytest.raises(KeyError):
        from_jax_variables(fewer, model)


def test_registry_init_variables_and_bf16(tiny_cfg):
    """The registry's FTL (its own convs in bf16, as JAX's registry builds
    them) takes ``init_variables``'s state; at the YAML's widths (w32, 4
    views) its parameters and BN statistics are the JAX model's by name and
    shape; its bf16 keypoints stay within 0.5 px of the float32 net's."""
    _, pcfg = zoo_cfgs(tiny_cfg, "FTL")
    model = build_model(pcfg)
    assert isinstance(model, FTLMultiviewNet) and model.dtype == torch.bfloat16
    state = init_variables(pcfg, 0)
    model.load_state_dict(state)
    f32 = FTLMultiviewNet(hrnet_from_cfg(pcfg, head="softmax"), dtype=torch.float32).eval()
    f32.load_state_dict(state)
    x, extr, intr = (torch.from_numpy(a) for a in inputs(4, seed=3))
    with torch.no_grad():
        low, ref = model(x, extr, intr), f32(x, extr, intr)
    assert float(ref.keypoints_2d.std()) > 0.5
    assert float((low.keypoints_2d - ref.keypoints_2d).abs().max()) <= 0.5
    assert torch.isfinite(low.keypoints_3d).all()

    from hrnet_hand_pose_estimation_tpu.config import load_config as jax_load_config
    from hrnet_hand_pose_estimation_tpu_torch.config import load_config

    yaml = "experiments/MHP/MHP_HRNet_w32_softmax_pose2dloss_FTL_v1.yaml"
    jm = jax_build_model(jax_load_config(yaml))
    full = build_model(load_config(yaml))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 4, 256, 256, 3)),
                                            jnp.zeros((1, 4, 3, 4)), jnp.eye(3)[None], False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    assert sorted(zeros["params"]) == ["backbone", "channel_expansion", "deconv1", "deconv2",
                                       "deconv3", "encoder_head", "final_layer",
                                       "fuse_after_ftl"]
    assert set(from_jax_variables(zeros, full)) == set(full.state_dict())


_HRNET = ["layer1", "stage2_m0", "stage3_m0", "stage4_m0", "stem1", "stem2", "transition1_0",
          "transition1_1_0", "transition2_2_0", "transition3_3_0"]
_POSE_HRNET = {"backbone": _HRNET, "final_conv": [], "head_cb": [], "trainable_temp": None}
# model -> (its kind, the top-level keys of its JAX tree and of its
# ``backbone``, as ``jax.eval_shape`` of the JAX models' init gives them at
# tiny sizes): ``_tree_kind`` reads nothing else
TREES = {
    "pose_hrnet": ("hrnet", _POSE_HRNET),
    "vol": ("net", {"backbone": _POSE_HRNET, "process_features": [], "volume_net": []}),
    "alg": ("net", {"backbone": _POSE_HRNET}),
    "multiview_pose_hrnet": ("net", {"aggregation": [], "backbone": _POSE_HRNET}),
    "CPM": ("cpm", {**{f"s1_conv{i}": [] for i in range(1, 8)},
                    **{f"stage{i}": [] for i in range(2, 7)}, "trunk": []}),
    "pose_resnet": ("pose_resnet", {"backbone": ["bn1", "conv1", "layer1", "layer2", "layer3",
                                                 "layer4"],
                                    "deconv0": [], "deconv_bn0": [], "final_layer": []}),
    "swin_transformer": ("swin", {"embed_norm": [], "final_conv": [], "merge0": [],
                                  "patch_embed": [], "stage0_block0": [],
                                  "trainable_temp": None}),
    "my_pose_transformer": ("rvt", {"backbone": ["bn1", "conv1", "layer1"], "head": [],
                                    "keypoint_tokens": None, "norm": [], "patch_embed": [],
                                    "stage0_block0": []}),
    "pose_hrnet_PoseAggr": ("temporal", {"backbone": _POSE_HRNET, "deform_kernel1": None,
                                         "offset_feats": [], "offsets1": [],
                                         "trainable_temp": None}),
    "pose_hrnet_transformer": ("temporal", {"backbone": _POSE_HRNET, "spatial_embed": [],
                                            "spatial_pos": None}),
    "FTL": ("ftl", {"backbone": _POSE_HRNET, "channel_expansion": [], "deconv1": [],
                    "deconv2": [], "deconv3": [], "encoder_head": [], "final_layer": [],
                    "fuse_after_ftl": []}),
    "HourGlass": ("hourglass", {"conv1": [], "bn1": [], "conv2": [], "down_conv2": [],
                                "conv3": [], "conv4": [], "m0": [], "top_m_0": [],
                                "conv_last0": [], "bn_end0": [], "l0": []}),
    "HandMeshNet": ("mesh", {"lift": [], "cheb1": [], "cheb0": [], "out": [],
                             "pose_head": []}),
}


def _tree(keys):
    return {k: ({c: {} for c in v} if isinstance(v, list) else
                _tree(v) if isinstance(v, dict) else np.zeros(())) for k, v in keys.items()}


@pytest.mark.parametrize("name", sorted(TREES))
def test_tree_kind_routes_every_tree(name):
    """``_tree_kind`` with the FTL, HGFilter and HandMeshNet rules (FTL's
    tested before the SimpleBaseline's ``final_layer`` rule) still routes
    every earlier tree as before."""
    kind, keys = TREES[name]
    assert _tree_kind(_tree(keys)) == kind


def test_c21_jax_fails_and_the_port_raises(tiny_cfg):
    """JAX's create_train_state calls ``model.init(rng, images, False)`` and
    raises TypeError (the cameras are missing); the port's train state,
    train step, eval step, forward function, Evaluator2D and Trainer raise
    NotImplementedError naming C21."""
    jcfg, pcfg = zoo_cfgs(tiny_cfg, "FTL")
    jm = jax_build_model(jcfg)
    with pytest.raises(TypeError, match="intrinsics"):
        jax_ts.create_train_state(jcfg, jm, jax.random.key(0),
                                  {"images": jnp.zeros((1, 4, 64, 64, 3))})
    port = build_model(pcfg)
    for make in (lambda: TS.create_train_state(pcfg, port, device="cpu"),
                 lambda: TS.make_train_step(pcfg, port, None),
                 lambda: TS.make_eval_step(pcfg, port), lambda: TS.make_forward_fn(pcfg, port),
                 lambda: Evaluator2D(pcfg, port, None, device="cpu"),
                 lambda: Trainer(pcfg, port, {}, device="cpu")):
        with pytest.raises(NotImplementedError, match="C21"):
            make()


def test_c21_train_tool_raises_before_reading_data():
    """``tools.train`` on the shipped FTL YAML (its MHP_mv data absent here)
    exits with NotImplementedError naming C21, before it reads any data."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-m", "hrnet_hand_pose_estimation_tpu_torch.tools.train",
                          "--cfg", "experiments/MHP/MHP_HRNet_w32_softmax_pose2dloss_FTL_v1.yaml",
                          "--device", "cpu"], cwd=repo, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert "NotImplementedError" in res.stderr and "C21" in res.stderr, res.stderr[-2000:]
