"""The port's SimpleBaseline (``models/pose_resnet.py``) against the JAX
package's: the 2D transposed conv, the forward in float32 and bfloat16, one
train step, the eval step, and the reference parameter names.

A ResNet-18 with three 16-wide deconvs at 64x64 (16x16 maps), B = 2;
weights from ``tests/torch_zoo_parity.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu.models.pose_resnet import PoseResNet as JaxPoseResNet
from hrnet_hand_pose_estimation_tpu.utils.torch_convert import _resolve_pose_resnet
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.pose_resnet import DeconvLayer, PoseResNet
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import (_weight, from_jax_variables,
                                                                init_variables)
from torch_train_parity import make_batch
from torch_zoo_parity import jax_variables, rel_gap, step_parity, train_grads, zoo_cfgs

torch.set_num_threads(1)
B = 2
WIDTHS = dict(num_layers=18, num_joints=21, num_deconv_layers=3, deconv_filters=(16, 16, 16))
EXTRA = {"NUM_LAYERS": 18, "NUM_DECONV_LAYERS": 3, "NUM_DECONV_FILTERS": [16, 16, 16]}


def cfgs(tiny_cfg, **overrides):
    jcfg, pcfg = zoo_cfgs(tiny_cfg, "pose_resnet", **overrides)
    for cfg in (jcfg, pcfg):
        cfg.defrost()
        cfg.MODEL.EXTRA.merge_from_mapping(EXTRA)
        cfg.freeze()
    return jcfg, pcfg


@pytest.fixture(scope="module")
def shared():
    """(JAX PoseResNet float32, variables, port model with them, images)."""
    images = np.random.default_rng(1).normal(size=(B, 64, 64, 3)).astype(np.float32)
    jm = JaxPoseResNet(**WIDTHS, dtype=jnp.float32)
    variables = jax_variables(jm, 0, images[:1], False)
    model = PoseResNet(**WIDTHS).eval()
    model.load_state_dict(from_jax_variables(variables, model))
    return jm, variables, model, images


def test_deconv_matches_flax_conv_transpose():
    """flax ``ConvTranspose(4, 2, padding (2, 2))`` against ``DeconvLayer``
    with the bridge's flipped, axis-swapped kernel: twice the size, 1e-5."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    layer = fnn.ConvTranspose(4, (4, 4), strides=(2, 2), padding=[(2, 2), (2, 2)],
                              use_bias=False)
    kernel = rng.normal(size=(4, 4, 6, 4)).astype(np.float32)
    want = np.asarray(layer.apply({"params": {"kernel": kernel}}, x))
    port = DeconvLayer(6, 4)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.ascontiguousarray(_weight(kernel,
                                                                        "deconv_layers.0"))))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("final_conv_kernel", [1, 3])
def test_forward_matches_jax(final_conv_kernel):
    """Float32 logits and features within 1e-4 of their largest value; the
    soft-argmax decode of the logits (JAX's HEATMAP_SOFTMAX decode) within
    1e-4 of its largest coordinate."""
    widths = dict(WIDTHS, final_conv_kernel=final_conv_kernel)
    images = np.random.default_rng(3).normal(size=(B, 64, 64, 3)).astype(np.float32)
    jm = JaxPoseResNet(**widths, dtype=jnp.float32)
    variables = jax_variables(jm, final_conv_kernel, images[:1], False)
    want = jm.apply(variables, images, False)
    model = PoseResNet(**widths).eval()
    model.load_state_dict(from_jax_variables(variables, model))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got.heatmaps.shape == (B, 16, 16, 21) and got.heatmaps.dtype == torch.float32
    assert got.features.shape == (B, 2, 2, 512) and got.temperature is None
    assert rel_gap(got.heatmaps, want.heatmaps) <= 1e-4
    assert rel_gap(got.features, want.features) <= 1e-4
    from hrnet_hand_pose_estimation_tpu.ops.decode import soft_argmax as jax_soft_argmax
    from hrnet_hand_pose_estimation_tpu_torch.ops.decode import soft_argmax

    assert rel_gap(soft_argmax(got.heatmaps), jax_soft_argmax(want.heatmaps)) <= 1e-4


def test_bf16_forward_tracks_jax(shared):
    """bfloat16 autocast against JAX's ``dtype=bf16``: the logits no farther
    from JAX's bf16 ones than twice JAX's bf16 logits are from its float32
    ones, in max and in mean."""
    jm, variables, model, images = shared
    f32 = np.asarray(jm.apply(variables, images, False).heatmaps)
    jbf = np.asarray(jm.clone(dtype=jnp.bfloat16).apply(variables, images, False).heatmaps)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = model(torch.from_numpy(images)).heatmaps.numpy()
    d_port, d_wit = np.abs(got - jbf), np.abs(jbf - f32)
    assert d_wit.max() > 0
    assert d_port.max() <= 2 * d_wit.max() and d_port.mean() <= 2 * d_wit.mean()


def test_train_step_matches_jax(tiny_cfg, shared, monkeypatch):
    """One float32 adam step of the generic 2D step (the pose loss, as the
    zoo's RHD configs train) against JAX's jitted step from the same
    variables: the losses at rtol 1e-5, the new BN statistics within 1e-5.
    The float32 gradients are reported: a max-pool or ReLU input within
    rounding of a tie takes the other side in the two frameworks; the next
    test holds them in float64."""
    jm, variables, _, images = shared
    jcfg, pcfg = cfgs(tiny_cfg, TRAIN__OPTIMIZER="adam", TRAIN__LR=1e-3,
                      LOSS__WITH_HEATMAP_LOSS=False)
    batch = dict(make_batch(4), images=images)
    gaps = step_parity(jcfg, pcfg, jm, variables, batch, monkeypatch)
    print(f"float32 gradient gap {gaps['grad'][0]:.3g} of max|g| at {gaps['grad'][1]}")
    assert all(g <= 1e-5 for g in gaps["loss"].values()), gaps["loss"]
    assert gaps["stats"] <= 1e-5


def test_eval_step_matches_jax(tiny_cfg, shared):
    """The eval step (flip test off and on) against JAX's: maps 1e-4 of
    their largest value, the soft-argmax of the logits 1e-4 of its largest
    coordinate."""
    jm, variables, _, images = shared
    for flip in (False, True):
        jcfg, pcfg = cfgs(tiny_cfg, TEST__FLIP_TEST=flip)
        state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                  batch_stats=variables["batch_stats"], opt_state=None)
        want = jax_ts.make_eval_step(jcfg, jm)(state, {"images": jnp.asarray(images)})
        model = build_model(pcfg)
        pstate, _ = TS.create_train_state(pcfg, model, device="cpu")
        model.load_state_dict(from_jax_variables(variables, model))
        got = TS.make_eval_step(pcfg, model)(pstate, {"images": torch.from_numpy(images)})
        assert rel_gap(got["heatmaps"], want["heatmaps"]) <= 1e-4, flip
        assert rel_gap(got["pose2d_pred"], want["pose2d_pred"]) <= 1e-4, flip


def test_parameter_names_are_the_reference_names(tiny_cfg):
    """Every port parameter and BN statistic is named as the reference
    SimpleBaseline's: JAX's ``_resolve_pose_resnet`` maps each name to a
    leaf of the JAX model, the names reach every JAX leaf, and the strict
    bridge maps the tree so built back onto exactly those names with the
    port's shapes; ``init_variables`` makes a full state of the registry's
    model."""
    jm = JaxPoseResNet(**WIDTHS)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), False))
    model = PoseResNet(**WIDTHS)
    sd = model.state_dict()
    leaf_of = {"weight": ("params", "kernel"), "bias": ("params", "bias"),
               "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}
    tree, reached = {}, set()
    for name in sd:
        stem, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        path, kind = _resolve_pose_resnet(stem)
        coll, jleaf = leaf_of[leaf]
        if kind == "bn" and leaf == "weight":
            jleaf = "scale"
        node, sub = shapes[coll], tree.setdefault(coll, {})
        for key in path:
            node, sub = node[key], sub.setdefault(key, {})
        sub[jleaf] = np.zeros(node[jleaf].shape, np.float32)
        reached.add((coll,) + tuple(path) + (jleaf,))
    every = {(coll,) + tuple(getattr(k, "key", k) for k in keys)
             for coll in shapes for keys, _ in jax.tree_util.tree_flatten_with_path(
                 dict(shapes[coll]))[0]}
    assert reached == every
    assert set(from_jax_variables(tree, model)) == set(sd)
    _, pcfg = cfgs(tiny_cfg)
    build_model(pcfg).load_state_dict(init_variables(pcfg, 0))


def test_train_gradients_match_jax_in_float64(shared):
    """The float32 step's gradients part where a max-pool or ReLU input is
    within rounding of a tie (5.7e-3 of max|g| measured at conv1 here): in
    float64 on both sides, the train-mode gradients of a linear function of
    the logits agree within 1e-6 of max|g|."""
    jm, variables, _, images = shared
    model = PoseResNet(**WIDTHS)
    model.load_state_dict(from_jax_variables(variables, model))
    got, want, gmax = train_grads(jm, variables, model, images, float64=True)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=0, atol=1e-6 * gmax,
                                   err_msg=name)
