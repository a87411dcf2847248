"""The port's stacked hourglass (``models/hourglass.py``) against the JAX
package's ``HGFilter``: depth 1 and 2, one and two stacks, the three stems
(``conv64``, ``ave_pool``, ``no_down``), batch and group norm; the bridge,
``hourglass_from_cfg``, ``init_variables``, and ROADMAP C22 (JAX's 2D
entry points fail on HGFilter's tuple; the port's raise).

64 px inputs, B = 2, float32; weights from ``tests/torch_zoo_parity.py``
with the BN running statistics of one train-mode forward of the test
images.  Limit: every output map and ``normx`` within 1e-4 of JAX's
largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu.core.evaluator import Evaluator2D as JaxEvaluator2D
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu.models import hourglass as jax_hg
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.hourglass import GN_EPS, HGFilter
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import (_tree_kind, from_jax_variables,
                                                                init_variables)
from torch_train_parity import make_batch
from torch_zoo_parity import batch_statistics, jax_variables, rel_gap, zoo_cfgs

torch.set_num_threads(1)
B = 2
CASES = [  # (num_stacks, depth, down_type, norm)
    (1, 1, "conv64", "batch"),
    (2, 2, "conv64", "group"),
    (2, 1, "ave_pool", "batch"),
    (1, 2, "no_down", "group"),
]


def images(seed=1):
    return np.random.default_rng(seed).normal(size=(B, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("stacks,depth,down,norm", CASES)
def test_hgfilter_matches_jax(stacks, depth, down, norm):
    """Each stack's tanh'd maps and ``normx`` within 1e-4 of JAX's largest
    value; the map size follows the stem (/4, /4 after the pool, /2)."""
    kw = dict(num_stacks=stacks, depth=depth, num_joints=21, norm=norm, down_type=down)
    jm = jax_hg.HGFilter(**kw, dtype=jnp.float32)
    x = images()
    variables = jax_variables(jm, stacks * 10 + depth, x[:1], False)
    if norm == "batch":
        variables = batch_statistics(jm, variables, x)
    outs, normx = jax.jit(jm.apply, static_argnums=2)(variables, x, False)
    model = HGFilter(**kw).eval()
    assert _tree_kind(variables["params"]) == "hourglass"
    model.load_state_dict(from_jax_variables(variables, model))
    with torch.no_grad():
        got, got_normx = model(torch.from_numpy(x))
    side = {"conv64": 16, "ave_pool": 16, "no_down": 32}[down]
    assert len(got) == stacks and got[0].shape == (B, side, side, 21)
    assert got_normx.shape == np.asarray(normx).shape == (B, side, side, 128)
    for g, w in zip(got, outs):
        assert float(np.asarray(w).std()) > 0.05
        assert rel_gap(g, w) <= 1e-4
    assert rel_gap(got_normx, normx) <= 1e-4
    if norm == "group":
        assert model.bn1.norm.eps == GN_EPS == 1e-6 and model.bn1.norm.num_groups == 32
        quarter = model.conv2.conv3.in_channels             # 16 or 32
        assert model.conv2.bn3.norm.num_groups == min(32, quarter)


def test_registry_bridge_and_init(tiny_cfg):
    """``hourglass_from_cfg`` reads NUM_STACKS, DEPTH and LAST_CHANNELS; the
    registry's net at those settings has exactly JAX's parameters and BN
    statistics by name and shape, takes ``init_variables``'s state, and its
    bf16 forward (tanh maps in [-1, 1]) stays within 0.25 of float32, 0.02 on
    the mean; ``create_train_state`` gives
    flax's lecun-normal convs."""
    jcfg, pcfg = zoo_cfgs(tiny_cfg, "HourGlass")
    for cfg in (jcfg, pcfg):
        cfg.defrost()
        cfg.MODEL.EXTRA.merge_from_mapping({"NUM_STACKS": 3, "DEPTH": 1, "LAST_CHANNELS": 14})
        cfg.freeze()
    model = build_model(pcfg)
    assert isinstance(model, HGFilter) and model.num_stacks == 3 and model.l2.out_channels == 14
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    assert set(from_jax_variables(zeros, model)) == set(model.state_dict())
    state = init_variables(pcfg, 0)
    model.load_state_dict(state)
    x = torch.from_numpy(images(2))
    with torch.no_grad():
        ref = model(x)[0][-1]
        with torch.autocast("cpu", dtype=torch.bfloat16):
            low = model(x)[0][-1]
    gap = (low - ref).abs()
    assert float(ref.std()) > 0.05 and float(gap.max()) < 0.25 and float(gap.mean()) < 0.02
    fresh = build_model(pcfg)
    TS.init_train_weights(fresh, 0)
    fan_in = fresh.m0.b1_1.conv1.weight[0].numel()
    assert 0.8 < float(fresh.m0.b1_1.conv1.weight.std()) * fan_in ** 0.5 < 1.2


def test_c22_jax_fails_and_the_port_raises(tiny_cfg):
    """JAX's train step, eval step, forward function and Evaluator2D read
    ``.heatmaps`` of HGFilter's tuple and fail (AttributeError); the port's
    raise NotImplementedError naming C22, and so does ``Trainer``."""
    jcfg, pcfg = zoo_cfgs(tiny_cfg, "HourGlass")
    jm = jax_build_model(jcfg)
    x = images(3)
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
        with pytest.raises(NotImplementedError, match="C22"):
            make()
