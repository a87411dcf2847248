"""The BN statistics levers through the tiny HRNet's train-mode forward and
loss against the JAX package's (tests/test_bn_levers.py's
test_train_step_with_levers on the port), and through the port's train
step.

JAX's side is its train-mode apply (``mutable=['batch_stats']``, jitted)
and its ``LossComputer2D`` on variables filled by leaf from ``eval_shape``
shapes (``torch_zoo_parity.jax_variables``), float32; the port gets the
same variables through the bridge.  What a step adds to the forward
(autograd, the optimizer, the guard) does not read the levers: the port's
step runs once with them, its statistics against its forward's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.core.loss_computer import LossComputer2D as JaxLoss
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu.models import layers as JL
from hrnet_hand_pose_estimation_tpu.ops.decode import decode_heatmaps as jax_decode
from hrnet_hand_pose_estimation_tpu_torch.core.loss_computer import LossComputer2D
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models import layers as L
from hrnet_hand_pose_estimation_tpu_torch.ops.decode import decode_heatmaps
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as port_ts
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from torch_train_parity import configs, make_batch, tensors
from torch_zoo_parity import jax_variables

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset_levers():
    yield
    L.set_bn_levers()
    JL.set_bn_levers()
    assert not L.bn_levers_active() and not JL.bn_levers_active()


@pytest.fixture(scope="module")
def shared(tiny_cfg):
    jcfg, pcfg = configs(tiny_cfg, TPU__COMPUTE_DTYPE="float32")
    jm = jax_build_model(jcfg)
    batch = make_batch(3, b=4)
    variables = jax_variables(jm, 0, jnp.asarray(batch["images"][:1]), False)
    return jcfg, pcfg, jm, variables, batch


def jax_forward(jcfg, jm, variables, batch):
    """JAX's train-mode forward and loss dict: (loss dict, {BN path: stats})."""
    out, mut = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(batch["images"]))
    _, losses = JaxLoss(jcfg)(heatmaps_pred=out.heatmaps,
                              heatmaps_gt=jnp.asarray(batch["target_heatmaps"]),
                              pose2d_pred=jax_decode(out.heatmaps, True),
                              pose2d_gt=jnp.asarray(batch["pose2d"]),
                              visibility=jnp.asarray(batch["visibility"]))
    stats = from_jax_variables({"params": variables["params"],
                                "batch_stats": jax.device_get(mut["batch_stats"])})
    return {k: float(v) for k, v in losses.items()}, stats


def port_forward(pcfg, variables, batch):
    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(variables, model))
    model.train()
    b = tensors(batch)
    with torch.no_grad():
        heatmaps = model(b["images"]).heatmaps
        _, losses = LossComputer2D(pcfg)(heatmaps_pred=heatmaps,
                                         heatmaps_gt=b["target_heatmaps"],
                                         pose2d_pred=decode_heatmaps(heatmaps, True),
                                         pose2d_gt=b["pose2d"], visibility=b["visibility"])
    return {k: float(v) for k, v in losses.items()}, model.state_dict()


# (levers, loss rtol, statistics atol).  With the levers off the float32
# forward's statistics part from JAX's by up to 9.7e-6 on these weights
# (filled at gain 1.4, which the stage-4 fuse layers amplify; measured);
# the subsample parts by the same 9.5e-6, and both are held to 2e-5.  For
# bf16 reductions: JAX's 0.05 on the statistics, the bf16 step's 3e-2 on
# the losses.
CASES = {"off": (dict(), 1e-5, 2e-5), "subsample": (dict(stat_samples=2), 1e-5, 2e-5),
         "bf16": (dict(stat_dtype="bfloat16"), 3e-2, 0.05),
         "both": (dict(stat_samples=2, stat_dtype="bfloat16"), 3e-2, 0.05)}


@pytest.mark.parametrize("case", list(CASES))
def test_train_forward_with_levers_matches_jax(shared, case):
    """The loss dict and every BN running statistic after the train-mode
    forward (B=4) against JAX's with the same levers (none: the float32
    witness), the head's
    (``last_layer.1``: JAX's ConvBN ``head_cb`` in training, which takes
    the levers) and the stem's included."""
    jcfg, pcfg, jm, variables, batch = shared
    levers, loss_rtol, stat_atol = CASES[case]
    JL.set_bn_levers(**levers)
    L.set_bn_levers(**levers)
    jl, ref = jax_forward(jcfg, jm, variables, batch)
    pl, own = port_forward(pcfg, variables, batch)
    assert set(jl) == set(pl)
    for key, v in jl.items():
        np.testing.assert_allclose(pl[key], v, rtol=loss_rtol, err_msg=key)
    keys = [k for k in own if k.endswith(("running_mean", "running_var"))]
    assert "last_layer.1.running_mean" in keys and "bn1.running_var" in keys
    gap = max(float((own[k] - ref[k]).abs().max()) for k in keys)
    print(f"{case}: largest running-statistic gap to JAX {gap:.3g}")
    for name in keys:
        np.testing.assert_allclose(own[name].numpy(), ref[name].numpy(), rtol=1e-5,
                                   atol=stat_atol, err_msg=name)


def test_port_step_with_subsample(shared):
    """The port's train step with stat_samples=2 at B=4: finite losses, the
    same state tree, and the running statistics its own train-mode forward
    gives, which differ from the full batch's."""
    jcfg, pcfg, jm, variables, batch = shared
    L.set_bn_levers(stat_samples=2)
    _, fwd = port_forward(pcfg, variables, batch)
    model = build_model(pcfg)
    state, tx = port_ts.create_train_state(pcfg, model, device="cpu")
    sd = state.state_dict()
    init = from_jax_variables(variables, model)
    sd["params"] = {k: init[k] for k in sd["params"]}
    sd["batch_stats"] = {k: init[k] for k in sd["batch_stats"]}
    state.load_state_dict(sd)
    state, losses = port_ts.make_train_step(pcfg, model, tx)(state, tensors(batch))
    assert all(torch.isfinite(v).all() for v in losses.values())
    own = state.state_dict()["batch_stats"]
    assert set(own) == set(sd["batch_stats"])
    L.set_bn_levers()
    _, full = port_forward(pcfg, variables, batch)
    keys = [k for k in own if k.endswith(("running_mean", "running_var"))]
    for name in keys:
        torch.testing.assert_close(own[name], fwd[name], rtol=1e-6, atol=1e-7)
    moved = [k for k in keys if not torch.allclose(full[k], own[k], rtol=1e-3, atol=1e-6)]
    print(f"{len(moved)} of {len(keys)} running statistics differ from the full batch's")
    assert len(moved) > len(keys) // 2 and "last_layer.1.running_mean" in moved
