"""The port's PredRNN and HRNet-embedding TCN (``models/temporal.py``)
against the JAX package's: the forwards, the TCN's layers as the frame count
allows them, ROADMAP C19 (every 2D entry point fails in JAX and raises in
the port), the initial distributions, the bridge and the registry's models
at the config defaults (no shipped YAML names them).

tiny_cfg's HRNet (64 px, 16x16 maps) as the softmax backbone, two ST-LSTM
cells of 8 channels, a TCN of 16 / 32 channels; weights from
``tests/torch_zoo_parity.py`` with the BN running statistics of the test
frames.  Float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu.config import POSE_HIGH_RESOLUTION_NET_EXTRA
from hrnet_hand_pose_estimation_tpu.config import load_config as jax_load_config
from hrnet_hand_pose_estimation_tpu.core.evaluator import Evaluator2D as JaxEvaluator2D
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu.models import temporal as jax_temporal
from hrnet_hand_pose_estimation_tpu.models.hrnet import hrnet_from_cfg as jax_hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.config import load_config
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer
from hrnet_hand_pose_estimation_tpu_torch.models import build_model, temporal
from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables, init_variables
from torch_train_parity import make_batch
from torch_zoo_parity import batch_statistics, jax_variables, rel_gap, zoo_cfgs

torch.set_num_threads(1)
B = 2
PREDRNN = dict(num_hidden=(8, 8), num_joints=21)
TCN = dict(embedding_size=16, tcn_channels=32, filter_widths=(3, 3), num_joints=21)


def frames(t, seed=1):
    return np.random.default_rng(seed).normal(size=(B, t, 64, 64, 3)).astype(np.float32)


def pair(tiny_cfg, kind, t):
    """(JAX net, its variables, the port net with them, frames) at T = t."""
    jcfg, pcfg = zoo_cfgs(tiny_cfg, "pose_hrnet_softmax")
    x = frames(t)
    if kind == "predrnn":
        jm = jax_temporal.HRNetPredRNN(backbone=jax_hrnet_from_cfg(jcfg, head="softmax"),
                                       **PREDRNN)
        model = temporal.HRNetPredRNN(hrnet_from_cfg(pcfg, head="softmax"), **PREDRNN)
    else:
        jm = jax_temporal.HRNetEmbTCN(backbone=jax_hrnet_from_cfg(jcfg, head="softmax"), **TCN)
        model = temporal.HRNetEmbTCN(hrnet_from_cfg(pcfg, head="softmax"), seq_len=t, **TCN)
    variables = batch_statistics(jm, jax_variables(jm, 0, x[:1], False), x)
    model.load_state_dict(from_jax_variables(variables, model))
    return jm, variables, model.eval(), x


def test_predrnn_matches_jax(tiny_cfg):
    """HRNet_PredRNN at T = 4: the refined maps (B, T, h, w, K) within 1e-4 of
    their largest value of JAX's (channel LayerNorms, the zig-zag memory,
    states from zeros), the backbone's maps within 1e-5, the argmax decode of
    the refined maps equal to JAX's; the cells' LayerNorm runs over the
    channels alone (eps 1e-6)."""
    jm, variables, model, x = pair(tiny_cfg, "predrnn", 4)
    refined, hm, pose = jax.jit(jm.apply, static_argnums=2)(variables, x, False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert isinstance(got, tuple) and len(got) == 3
    assert got[0].shape == (B, 4, 16, 16, 21) and got[2].shape == (B, 4, 21, 2)
    assert float(np.asarray(refined).std()) > 0.01
    assert rel_gap(got[0], refined) <= 1e-4
    np.testing.assert_allclose(got[1].numpy(), np.asarray(hm), rtol=0, atol=1e-5)
    assert np.mean(got[2].numpy() == np.asarray(pose)) >= 0.99
    assert model.predrnn.cell0.conv_x_ln.normalized_shape == (56,)
    assert model.predrnn.cell0.conv_x.bias is None and model.predrnn.cell0.conv_o.bias is not None


@pytest.mark.parametrize("t,layers", [(5, ((3, 1),)), (9, ((3, 1), (3, 3)))])
def test_tcn_matches_jax(tiny_cfg, t, layers):
    """HRNet_Emb_TCN: the convs JAX runs (at T = 5 only ``tcn0``; at T = 9
    also ``tcn1`` at dilation 3), the (B, K, 2) pose within 1e-4 of its
    largest value of JAX's; a sequence of another length raises."""
    jm, variables, model, x = pair(tiny_cfg, "tcn", t)
    assert model.layers == layers
    assert sorted(k for k in variables["params"] if k.startswith("tcn")) == sorted(
        f"tcn{s}{i}" for i in range(len(layers)) for s in ("", "_ln"))
    want = jax.jit(jm.apply, static_argnums=2)(variables, x, False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (B, 21, 2) and float(np.asarray(want).std()) > 0.01
    assert rel_gap(got, want) <= 1e-4
    with pytest.raises(ValueError, match="frames"):
        model(torch.from_numpy(x[:, :3]))


@pytest.mark.parametrize("name", ["HRNet_PredRNN", "HRNet_Emb_TCN"])
def test_entry_points_raise_c19_where_jax_fails(tiny_cfg, name):
    """JAX's train step, eval step, forward function and Evaluator2D read the
    output's ``.heatmaps`` and fail; the port's raise NotImplementedError
    naming C19, and so does ``Trainer`` (PredRNN with two 8-channel cells)."""
    jcfg, pcfg = zoo_cfgs(tiny_cfg, name, DATASET__SEQ_IDX=[-1, 0, 1], MODEL__N_HIDDEN=[8, 8])
    jm = jax_build_model(jcfg)
    x = frames(3)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), x[:1], False))
    variables = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), dict(shapes))
    batch = {k: jnp.asarray(v) for k, v in dict(make_batch(4), images=x).items()}
    tx = jax_ts.make_optimizer(jcfg, 1000)
    state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
    for run in (lambda: jax_ts.make_train_step(jcfg, jm, tx)(state, batch),
                lambda: jax_ts.make_eval_step(jcfg, jm)(state, batch),
                lambda: jax_ts.make_forward_fn(jcfg, jm)(variables, batch["images"]),
                lambda: JaxEvaluator2D(jcfg, jm, variables).forward(variables, batch["images"])):
        with pytest.raises(AttributeError, match="heatmaps"):
            run()
    port = build_model(pcfg)
    pstate, ptx = TS.create_train_state(pcfg, port, device="cpu")
    for make in (lambda: TS.make_train_step(pcfg, port, ptx),
                 lambda: TS.make_eval_step(pcfg, port), lambda: TS.make_forward_fn(pcfg, port),
                 lambda: Evaluator2D(pcfg, port, None, device="cpu"),
                 lambda: Trainer(pcfg, port, {}, device="cpu")):
        with pytest.raises(NotImplementedError, match="C19"):
            make()


@pytest.mark.parametrize("name", ["HRNet_PredRNN", "HRNet_Emb_TCN"])
def test_init_weights_bridge_and_defaults(tiny_cfg, name):
    """``create_train_state`` gives flax's distributions (lecun-normal convs
    and dense layers, LayerNorm 1 and 0, the backbone's convs normal(0.001));
    ``init_variables`` makes a full state of the registry's net; at the
    config defaults (w32, T = 5, 4 x 64 hidden, a 512 / 1024 TCN) the
    registry's net has exactly the JAX model's parameters and BN statistics
    by name and shape."""
    _, pcfg = zoo_cfgs(tiny_cfg, name)
    fresh = build_model(pcfg)
    TS.create_train_state(pcfg, fresh, device="cpu")
    with torch.no_grad():
        assert float(fresh.backbone.conv1.weight.std()) < 0.002
        if name == "HRNet_PredRNN":
            conv = fresh.predrnn.cell0.conv_x
            assert (fresh.predrnn.cell0.conv_x_ln.weight == 1).all()
        else:
            conv = fresh.tcn0
            assert (fresh.tcn_ln0.weight == 1).all() and not fresh.embed.bias.any()
        fan_in = conv.weight[0].numel()
        assert 0.8 < float(conv.weight.std()) * fan_in ** 0.5 < 1.2
    build_model(pcfg).load_state_dict(init_variables(pcfg, 0))

    opts = ["MODEL.NAME", name]
    cfg = load_config(opts=opts, freeze=False)
    cfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
    model = build_model(cfg.freeze())
    jcfg = jax_load_config(opts=opts, freeze=False)
    jcfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
    jm = jax_build_model(jcfg.freeze())
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 5, 64, 64, 3)),
                                            False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    assert set(from_jax_variables(zeros, model)) == set(model.state_dict())
    if name == "HRNet_Emb_TCN":
        assert model.layers == ((3, 1),) and model.embed.in_features == 480
