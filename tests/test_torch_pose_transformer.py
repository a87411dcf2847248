"""The port's PoseFormer (``PoseTransformer`` in ``models/transformers.py``)
against the JAX package's: the forward (the backbone's per-frame maps, the
refined pose), its decode through B4's twin or the argmax, ROADMAP C20 (the
generic train step at one sequence, the transformer's zero gradient, the
refusal at two), the eval step's per-frame outputs, the initial
distributions, the bridge and the shipped YAML's full-width model.

tiny_cfg's HRNet (64 px, 16x16 maps) as the softmax backbone, F = 3 frames,
embed ratio 8, depth 1, 2 heads; weights from ``tests/torch_zoo_parity.py``
with the BN running statistics of the test frames.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu.config import load_config as jax_load_config
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu.models.hrnet import hrnet_from_cfg as jax_hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu.models.transformers import PoseTransformer as JaxPoseTransformer
from hrnet_hand_pose_estimation_tpu_torch.config import load_config
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.models.transformers import PoseTransformer
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables, init_variables
from torch_train_parity import make_batch
from torch_zoo_parity import batch_statistics, jax_variables, rel_gap, step_parity, zoo_cfgs

torch.set_num_threads(1)
F = 3
SMALL = dict(num_frames=F, num_joints=21, embed_dim_ratio=8, depth=1, num_heads=2)
# the YAML's pose loss alone (jitted, JAX's heatmap loss sums in one
# accumulator, 1.7e-5 off its float64 value: tests/torch_train_parity.py)
CFG = dict(DATASET__SEQ_IDX=[-1, 0, 1], LOSS__WITH_HEATMAP_LOSS=False)
MHP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments",
                   "MHP")


def port_net(pcfg, variables=None, **kw):
    model = PoseTransformer(hrnet_from_cfg(pcfg, head="softmax"), **dict(SMALL, **kw)).eval()
    if variables is not None:
        model.load_state_dict(from_jax_variables(variables, model))
    return model


def frames(b, seed=1):
    return np.random.default_rng(seed).normal(size=(b, F, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def shared(tiny_cfg):
    """(JAX cfg, port cfg, the JAX net, its variables (temperature 1.3,
    random position embeddings), two sequences)."""
    jcfg, pcfg = zoo_cfgs(tiny_cfg, "pose_hrnet_transformer", **CFG)
    jm = JaxPoseTransformer(backbone=jax_hrnet_from_cfg(jcfg, head="softmax"), **SMALL)
    x = frames(2)
    variables = batch_statistics(jm, jax_variables(jm, 0, x[:1], False), x)
    params = variables["params"]
    params["backbone"]["trainable_temp"] = np.float32(1.3)
    rng = np.random.default_rng(2)
    for name in ("spatial_pos", "temporal_pos"):
        params[name] = (0.5 * rng.normal(size=params[name].shape)).astype(np.float32)
    params["frame_weights"] = rng.normal(size=(F, 1)).astype(np.float32)
    return jcfg, pcfg, jm, variables, x


@pytest.mark.parametrize("use_softmax", [True, False])
def test_forward_matches_jax(shared, use_softmax):
    """The per-frame probabilities (B*F, h, w, K) within 1e-5 of JAX's, the
    refined pose (B, K, 2) within 1e-4 of its largest value (decoding the
    backbone's logits through B4's twin with ``use_softmax``, else the
    argmax of the probabilities); under a bfloat16 autocast the transformer
    still runs in float32."""
    _, pcfg, jm, variables, x = shared
    jm = jm.clone(use_softmax=use_softmax)
    want = jax.jit(jm.apply, static_argnums=2)(variables, x, False)
    model = port_net(pcfg, variables, use_softmax=use_softmax)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        with torch.autocast("cpu", dtype=torch.bfloat16):
            low = model(torch.from_numpy(x))
    assert got.heatmaps.shape == (2 * F, 16, 16, 21) and got.pose2d_refined.shape == (2, 21, 2)
    assert float(got.temperature.detach()) == pytest.approx(1.3)
    np.testing.assert_allclose(got.heatmaps.numpy(), np.asarray(want.heatmaps), rtol=0,
                               atol=1e-5)
    assert float(np.asarray(want.pose2d_refined).std()) > 0.1
    assert rel_gap(got.pose2d_refined, want.pose2d_refined) <= 1e-4
    assert low.pose2d_refined.dtype == torch.float32 and torch.isfinite(low.pose2d_refined).all()


def test_c20_train_step_at_one_sequence(shared, monkeypatch):
    """ROADMAP C20: JAX's generic step trains the backbone's F per-frame maps
    against the one centre-frame target; the port's step gives JAX's losses
    within 1e-5 and BN statistics within 1e-4, the backbone's gradient
    within a cosine of 0.99999 and 1e-2 of max|g| (the tiny HRNet's
    train-mode float32 gradient; tests/test_torch_pose_aggr.py), and on both
    sides a zero gradient for every parameter outside the backbone (whose
    softmax temperature trains)."""
    jcfg, pcfg, jm, variables, x = shared
    batch = dict(make_batch(4, b=1), images=x[:1])
    gaps = step_parity(jcfg, pcfg, jm, variables, batch, monkeypatch, model=port_net(pcfg))
    assert set(gaps["loss"]) >= {"pose2d_loss", "total_loss", "temperature"}
    assert all(g <= 1e-5 for g in gaps["loss"].values()), gaps["loss"]
    assert gaps["stats"] <= 1e-4
    got, want = gaps["grads"], gaps["jax_grads"]
    head = [n for n in got if not n.startswith("backbone.")]
    assert len(head) > 10 and not any(got[n].any() or want[n].any() for n in head)
    names = [n for n in got if n.startswith("backbone.")]
    a = torch.cat([got[n].flatten() for n in names]).double()
    b = torch.cat([want[n].flatten() for n in names]).double()
    cos = float(a @ b / (a.norm() * b.norm()))
    assert cos >= 0.99999 and float((a - b).abs().max() / b.abs().max()) <= 1e-2, cos


def test_c20_two_sequences_raise_and_eval_step_is_per_frame(shared):
    """At B = 2 JAX's step fails on the loss's shapes; the port's raises
    ValueError naming C20 before the loss, with the state as it was (the BN
    statistics its forward moved put back).  The eval step returns JAX's
    per-frame maps and decodes, (B*F, ...), within 1e-5 and 1e-4 px."""
    jcfg, pcfg, jm, variables, x = shared
    batch = {k: jnp.asarray(v) for k, v in dict(make_batch(4), images=x).items()}
    tx = jax_ts.make_optimizer(jcfg, 1000)
    state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
    with pytest.raises(TypeError, match="broadcast|incompatible"):
        jax_ts.make_train_step(jcfg, jm, tx)(state, batch)
    want = jax_ts.make_eval_step(jcfg, jm)(state, batch)

    model = port_net(pcfg, variables)
    pstate, ptx = TS.create_train_state(pcfg, model, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model))
    step = TS.make_train_step(pcfg, model, ptx)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    stats = (pstate.stats.clone(), pstate.counts.clone())
    with pytest.raises(ValueError, match="C20"):
        step(pstate, tbatch)
    assert int(pstate.step) == 0
    assert torch.equal(pstate.stats, stats[0]) and torch.equal(pstate.counts, stats[1])
    got = TS.make_eval_step(pcfg, model)(pstate, tbatch)
    assert got["heatmaps"].shape == (2 * F, 16, 16, 21) and got["pose2d_pred"].shape == (2 * F,
                                                                                         21, 2)
    np.testing.assert_allclose(got["heatmaps"].numpy(), np.asarray(want["heatmaps"]), atol=1e-5)
    np.testing.assert_allclose(got["pose2d_pred"].numpy(), np.asarray(want["pose2d_pred"]),
                               atol=1e-4)


def test_init_weights_bridge_and_shipped_yaml(shared):
    """``create_train_state`` gives flax's distributions (zero position
    embeddings, small normal frame weights, LayerNorm 1 and 0, the backbone's
    convs normal(0.001)); the strict bridge fills every key;
    ``init_variables`` makes a full state of the registry's net; the shipped
    ``..._PoseFormer_v1`` (w32, 9 frames, ratio 32, depth 4, 8 heads) has
    exactly the JAX model's parameters and BN statistics by name and shape."""
    _, pcfg, _, variables, _ = shared
    fresh = port_net(pcfg)
    TS.create_train_state(pcfg, fresh, device="cpu")
    with torch.no_grad():
        assert not fresh.spatial_pos.any() and not fresh.temporal_pos.any()
        assert 0 < float(fresh.frame_weights.abs().max()) < 0.1
        assert (fresh.head_norm.weight == 1).all() and not fresh.head_norm.bias.any()
        assert float(fresh.backbone.conv1.weight.std()) < 0.002
        assert float(fresh.backbone.trainable_temp) == 1.0
    assert set(from_jax_variables(variables, fresh)) == set(fresh.state_dict())
    registry = build_model(pcfg)
    assert isinstance(registry, PoseTransformer) and registry.num_frames == F
    registry.load_state_dict(init_variables(pcfg, 0))

    path = os.path.join(MHP, "MHP_HRNet_w32_trainable_softmax_pose2dloss_PoseFormer_v1.yaml")
    model = build_model(load_config(path))
    assert (model.num_frames, model.depth, tuple(model.temporal_pos.shape)) == (9, 4, (1, 9, 672))
    jm = jax_build_model(jax_load_config(path))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 9, 64, 64, 3)),
                                            False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    assert set(from_jax_variables(zeros, model)) == set(model.state_dict())


def test_c20_check_reads_the_shapes_alone():
    """The step's C20 check looks at the maps' and the targets' batches, not
    at the model: equal batches or one target pass, others raise."""
    maps = torch.zeros(6, 4, 4, 21)
    TS.check_map_batch(maps, {"target_heatmaps": torch.zeros(6, 4, 4, 21)})
    TS.check_map_batch(maps, {"target_heatmaps": torch.zeros(1, 4, 4, 21),
                              "pose2d": torch.zeros(1, 21, 2)})
    TS.check_map_batch(maps, {})
    for key, shape in (("target_heatmaps", (2, 4, 4, 21)), ("pose2d", (2, 21, 2))):
        with pytest.raises(ValueError, match="C20"):
            TS.check_map_batch(maps, {key: torch.zeros(shape)})
