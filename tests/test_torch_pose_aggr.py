"""The port's PoseAggr (``models/pose_aggr.py``) against the JAX package's:
the forward with the offset chain in float32 and in bfloat16, the plain
output without HEATMAP_SOFTMAX, the evaluation through B4's twin, the
generic 2D train step on (B, T, H, W, 3) frames, the initial distributions,
the bridge and the shipped YAMLs' full-width models.

tiny_cfg's HRNet (64 px, 16x16 maps) as the logits backbone, T = 3 frames,
two offset blocks and two dilations (1, 2), B = 2; weights from
``tests/torch_zoo_parity.py``, the BN running statistics those of the test
frames.  The generic JAX step with PoseAggr's default 20 blocks and five
dilations takes minutes to compile here, so the net is built directly.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.config import load_config as jax_load_config
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu.models.hrnet import hrnet_from_cfg as jax_hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu.models.pose_aggr import PoseAggrNet as JaxPoseAggrNet
from hrnet_hand_pose_estimation_tpu.ops.decode import soft_argmax as jax_soft_argmax
from hrnet_hand_pose_estimation_tpu_torch.config import load_config
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.models.pose_aggr import PoseAggrNet, fusion_weights
from hrnet_hand_pose_estimation_tpu_torch.ops.decode import soft_argmax
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables, init_variables
from torch_train_parity import make_batch
from torch_zoo_parity import (batch_statistics, jax_train_step, jax_variables, rel_gap,
                              step_parity, zoo_cfgs)

torch.set_num_threads(1)
B, T = 2, 3
SMALL = dict(seq_len=T, num_joints=21, dilation_rates=(1, 2), offset_blocks=2,
             trainable_softmax=True)
# the YAMLs' pose loss alone (jitted, JAX's heatmap loss sums in one
# accumulator, 1.7e-5 off its float64 value: tests/torch_train_parity.py)
CFG = dict(DATASET__SEQ_IDX=[-1, 0, 1], MODEL__DILATION_RATES=[1, 2],
           MODEL__TRAINABLE_SOFTMAX=True, LOSS__WITH_HEATMAP_LOSS=False)
MHP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments",
                   "MHP")


def port_net(pcfg, variables=None, **kw):
    model = PoseAggrNet(hrnet_from_cfg(pcfg, head="plain"), **dict(SMALL, **kw)).eval()
    if variables is not None:
        model.load_state_dict(from_jax_variables(variables, model))
    return model


@pytest.fixture(scope="module")
def shared(tiny_cfg):
    """(JAX cfg, port cfg, the JAX net with a float32 offset chain, its
    variables (temperature 1.3), frames)."""
    jcfg, pcfg = zoo_cfgs(tiny_cfg, "pose_hrnet_PoseAggr", **CFG)
    jm = JaxPoseAggrNet(backbone=jax_hrnet_from_cfg(jcfg, head="plain"), dtype=jnp.float32,
                        **SMALL)
    frames = np.random.default_rng(1).normal(size=(B, T, 64, 64, 3)).astype(np.float32)
    variables = batch_statistics(jm, jax_variables(jm, 0, frames[:1], False), frames)
    variables["params"]["trainable_temp"] = np.float32(1.3)
    return jcfg, pcfg, jm, variables, frames


@pytest.fixture(scope="module")
def jax_step(shared):
    """JAX's jitted train step of the test net, returning its gradients:
    one compile for both offset cases."""
    jcfg, _, jm, _, _ = shared
    with pytest.MonkeyPatch.context() as mp:
        yield jax_train_step(jcfg, jm, mp)


def jax_forward(jm, variables, frames):
    return jax.jit(jm.apply, static_argnums=2)(variables, frames, False)


def test_forward_and_evaluation_match_jax(shared):
    """Float32 offset chain: the fused logits and the probabilities within
    1e-4 of their largest value of JAX's, the decode within 1e-3 px;
    ``Evaluator2D`` decodes ``forward_logits`` through B4's twin (the JAX
    evaluator's ``soft_argmax`` of the probabilities) within 1e-3 px."""
    _, pcfg, jm, variables, frames = shared
    want = jax_forward(jm, variables, frames)
    model = port_net(pcfg, variables, offset_dtype=torch.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(frames))
    assert got.heatmaps.shape == (B, 16, 16, 21)
    assert float(got.temperature.detach()) == pytest.approx(1.3)
    assert float(np.abs(np.asarray(want.features)).std()) > 0.1
    assert rel_gap(got.features, want.features) <= 1e-4
    assert rel_gap(got.heatmaps, want.heatmaps) <= 1e-4
    coords = np.asarray(jax_soft_argmax(want.heatmaps))
    assert np.abs(soft_argmax(got.heatmaps).numpy() - coords).max() <= 1e-3
    ev = Evaluator2D(pcfg, model, None, device="cpu")
    assert ev.decode_logits
    assert np.abs(ev.forward(torch.from_numpy(frames)).numpy() - coords).max() <= 1e-3


def test_bf16_offset_chain_and_plain_output(shared):
    """The registry's offset chain in bfloat16 (the JAX module's default
    dtype): the port's fused logits within twice JAX's own bfloat16 gap
    from the float32 chain.  Without HEATMAP_SOFTMAX both return the fused
    logits as the heatmaps, within 1e-4 of JAX's, and the port's net has no
    softmax head (the evaluator takes the argmax)."""
    _, pcfg, jm, variables, frames = shared
    want32 = np.asarray(jax_forward(jm, variables, frames).features)
    want16 = np.asarray(jax_forward(jm.clone(dtype=jnp.bfloat16), variables, frames).features)
    with torch.no_grad():
        got16 = port_net(pcfg, variables)(torch.from_numpy(frames)).features.numpy()
    witness = rel_gap(want16, want32)
    print(f"bf16 chain: port {rel_gap(got16, want32):.3g}, JAX {witness:.3g} of max|fused|")
    assert 0 < witness and rel_gap(got16, want32) <= 2 * witness

    plain = {"params": {k: v for k, v in variables["params"].items() if k != "trainable_temp"},
             "batch_stats": variables["batch_stats"]}
    want = jax_forward(jm.clone(heatmap_softmax=False), plain, frames)
    model = port_net(pcfg, plain, offset_dtype=torch.float32, heatmap_softmax=False)
    with torch.no_grad():
        got = model(torch.from_numpy(frames))
    assert not hasattr(model, "head") and got.temperature is None
    assert got.heatmaps.dtype == torch.float32
    assert rel_gap(got.heatmaps, want.heatmaps) <= 1e-4


def group_gap(got, want, prefix):
    """(cosine, max gap over max|g|) of the gradients of the parameters
    named ``prefix...``, flattened into one vector a side."""
    names = [n for n in got if n.startswith(prefix)]
    a = torch.cat([got[n].flatten() for n in names]).double()
    b = torch.cat([want[n].flatten() for n in names]).double()
    assert b.abs().max() > 0, prefix
    return float(a @ b / (a.norm() * b.norm())), float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("offsets", ["zero", "random"])
def test_train_step_matches_jax(shared, jax_step, offsets):
    """One generic 2D train step on (B, T, H, W, 3) frames (the pose loss,
    adam, the trainable temperature) from JAX's state: the losses within
    1e-5 and the BN statistics within 1e-4 of JAX's jitted step; the
    gradients of the deform kernels, the offset heads and the temperature
    within 1e-4 of their largest.

    The tiny HRNet's train-mode float32 gradient is ill-conditioned (BN over
    a 2x2 coarsest branch): the backbone's is held to a cosine of 0.99999
    and 1e-2 of its max|g|.  With the offset heads at zero every sample sits
    on the grid (the offset chain's gradient zero on both sides).  With
    random offsets the gradient through the offsets is piecewise constant in
    the sample positions (a bilinear cell's slope), so rounding that moves a
    sample across a cell edge moves it: a 1e-6 relative change of the
    frames moves the port's own backbone gradient by 1e-2 of its max.
    There the backbone's, the offset chain's and the offset heads'
    gradients are held to a cosine of 0.9999 and 5e-2 of their max|g|; the
    deform kernels' and the temperature's (continuous) stay within 1e-4."""
    jcfg, pcfg, jm, variables, frames = shared
    if offsets == "zero":
        params = dict(variables["params"])
        for i in (1, 2):
            params[f"offsets{i}"] = {"kernel": np.zeros_like(params[f"offsets{i}"]["kernel"])}
        variables = dict(variables, params=params)
    gaps = step_parity(jcfg, pcfg, jm, variables, dict(make_batch(4), images=frames),
                       model=port_net(pcfg, offset_dtype=torch.float32), jax_step=jax_step)
    assert set(gaps["loss"]) >= {"pose2d_loss", "total_loss", "temperature"}
    assert all(g <= 1e-5 for g in gaps["loss"].values()), gaps["loss"]
    assert gaps["stats"] <= 1e-4
    got, want = gaps["grads"], gaps["jax_grads"]
    smooth = ("deform_kernel", "trainable_temp") + (("offsets",) if offsets == "zero" else ())
    rough = ("backbone.",) if offsets == "zero" else ("backbone.", "offset_feats.", "offsets")
    min_cos, max_gap = (0.99999, 1e-2) if offsets == "zero" else (0.9999, 5e-2)
    for prefix in smooth:
        assert group_gap(got, want, prefix)[1] <= 1e-4, prefix
    for prefix in rough:
        cos, gap = group_gap(got, want, prefix)
        print(f"{offsets} offsets, {prefix} gradient: cosine {cos:.7f}, gap {gap:.3g} of max|g|")
        assert cos >= min_cos and gap <= max_gap, (prefix, cos, gap)
    if offsets == "zero":
        assert not any(got[n].any() or want[n].any() for n in got
                       if n.startswith("offset_feats."))


def test_init_weights_bridge_and_fusion_weights(shared):
    """``create_train_state`` gives flax's distributions (deform kernels and
    offset heads normal(0.001), the temperature 1); the strict bridge fills
    every key; ``init_variables`` makes a full state of the registry's net;
    the fusion weights are JAX's at five frames and normalised otherwise."""
    _, pcfg, _, variables, _ = shared
    fresh = port_net(pcfg)
    TS.create_train_state(pcfg, fresh, device="cpu")
    with torch.no_grad():
        for name in ("deform_kernel1", "offsets2.weight"):
            assert 0.0008 < float(fresh.get_parameter(name).std()) < 0.0012, name
        assert float(fresh.trainable_temp) == 1.0
    assert set(from_jax_variables(variables, fresh)) == set(fresh.state_dict())
    registry = build_model(pcfg)
    assert isinstance(registry, PoseAggrNet) and registry.offset_dtype == torch.bfloat16
    registry.load_state_dict(init_variables(pcfg, 0))
    assert torch.allclose(fusion_weights(5), torch.tensor([0.1, 0.25, 0.3, 0.25, 0.1]))
    w3 = fusion_weights(3)
    assert torch.allclose(w3, torch.tensor([0.25, 0.3, 0.25]) / 0.8) and float(w3.sum()) == 1.0


@functools.lru_cache(maxsize=None)
def jax_shapes(jm):
    """The JAX net's variable shapes (one trace for equal nets: v1 and v2
    differ only in which frames they read)."""
    return jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 5, 64, 64, 3)), False))


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_shipped_yaml_builds_at_full_width(version):
    """``..._PoseAggr_v1`` / ``_v2``: the registry's net (w32, 5 frames, 20
    offset blocks in bfloat16, dilations 3-24, a trainable temperature, the
    softmax head) has exactly the JAX model's parameters and BN statistics
    by name and shape."""
    path = os.path.join(MHP, f"MHP_HRNet_w32_trainable_softmax_pose2dloss_PoseAggr_{version}.yaml")
    model = build_model(load_config(path))
    assert (model.seq_len, model.dilation_rates, len(model.offset_feats)) == (
        5, (3, 6, 12, 18, 24), 20)
    assert model.head == "softmax" and model.trainable_softmax
    shapes = jax_shapes(jax_build_model(jax_load_config(path)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    assert set(from_jax_variables(zeros, model)) == set(model.state_dict())
