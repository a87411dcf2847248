"""The port's train step against the JAX package's: the other optimizers,
the bone and joint-angle losses, the frozen temperature, and the gradients
in float64.

- sgd with nesterov and ``multi_step``, started with the schedule's count
  one step before a boundary, with the bone and joint-angle losses on:
  the second step must use the LR JAX gives after the boundary.  The
  angle loss's gradients on the random poses of a fresh net reach 1e5, so
  the LR is 1e-7 (at 1e-3 the first step blows the second one up and the
  guard skips it on both sides).
- adamw with ``TRAINABLE_SOFTMAX=False``: the temperature has a zero
  gradient, stays in the optimizer, and decays as optax decays it.
- the gradients of the train loss, with the model computed in float64 on
  both sides, at atol 1e-5 max|g| (``torch_train_parity.float64_grads``).

Each float32 step is held as in ``test_torch_train_step.py``.  The bone and
joint-angle losses divide by bone lengths of decoded poses that a fresh net
puts near the map's centre; a 1e-7 difference in the decoded poses moves
them by up to 3e-4 relative, so within the step they are held to the JAX
loss functions on the port's own decoded poses (rtol 1e-5), and
``test_torch_losses.py`` holds the functions themselves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_parity import (JaxTrainer, compare_step, configs, float64_grads, make_batch,
                                max_abs)

import hrnet_hand_pose_estimation_tpu.core.losses as jax_losses

torch.set_num_threads(1)

SGD = dict(TPU__COMPUTE_DTYPE="float32", TRAIN__OPTIMIZER="sgd", TRAIN__NESTEROV=True,
           TRAIN__LR=1e-7, TRAIN__LR_STEP=[1], LOSS__WITH_BONE_LOSS=True,
           LOSS__WITH_JOINTANGLE_LOSS=True)
STEPS_PER_EPOCH = 3          # LR_STEP [1]: the boundary at count 3


def before_boundary(trainer):
    """The schedule's count at 2: the next step is the last before the
    boundary, the one after it the first past it."""
    opt = list(trainer.state.opt_state)
    opt[-1] = opt[-1]._replace(count=jnp.asarray(2, jnp.int32))
    trainer.state = trainer.state.replace(opt_state=tuple(opt))


@pytest.fixture(scope="module")
def sgd_steps(tiny_cfg):
    jcfg, pcfg = configs(tiny_cfg, **SGD)
    trainer = JaxTrainer(jcfg, make_batch(0), STEPS_PER_EPOCH)
    before_boundary(trainer)
    return [compare_step(jcfg, pcfg, trainer, None, STEPS_PER_EPOCH) for _ in range(2)]


def held_step(r, k, exact_keys):
    jl, pl = r["loss_values"]
    for key in exact_keys:
        np.testing.assert_allclose(pl[key], jl[key], rtol=1e-5, err_msg=f"step {k} {key}")
    assert r["params_same_grads"] <= 1e-3, r["params_same_grads"]
    assert r["moments_same_grads"][0] == 0.0, r["moments_same_grads"]
    ref, own = r["jax_state"], r["port_state"]
    for name, v in ref["batch_stats"].items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(own["batch_stats"][name].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("k", [0, 1])
def test_sgd_nesterov_across_a_boundary_matches_jax(sgd_steps, k):
    r = sgd_steps[k]
    held_step(r, k, ("heatmap_loss", "pose2d_loss", "temperature", "nonfinite_grads"))
    assert r["counts"] == {"sched_count": (3 + k, 3 + k)}
    np.testing.assert_allclose(r["lr"], 1e-7 * (0.1 if k else 1.0), rtol=1e-6)
    # the bone and joint-angle terms on the port's decoded poses
    jl, pl = r["loss_values"]
    for key in ("bone_loss", "jointangle_loss"):
        print(f"step {k} {key}: port {pl[key]:.7g}, JAX {jl[key]:.7g}, "
              f"rel {abs(pl[key] - jl[key]) / abs(jl[key]):.3g}")
    rel_pred = jax_losses.scale_pose(jnp.asarray(r["pose2d_pred"]))
    rel_gt = jax_losses.scale_pose(jnp.asarray(make_batch(0)["pose2d"]))
    np.testing.assert_allclose(pl["bone_loss"], float(jax_losses.bone_length_loss(rel_pred, rel_gt)),
                               rtol=1e-5)
    np.testing.assert_allclose(pl["jointangle_loss"],
                               float(jax_losses.joint_angle_loss(rel_pred)), rtol=1e-5)
    total = (pl["heatmap_loss"] + pl["pose2d_loss"] + pl["bone_loss"] + pl["jointangle_loss"])
    np.testing.assert_allclose(pl["total_loss"], total, rtol=1e-6)


def test_adamw_decays_the_frozen_temperature_as_jax(tiny_cfg):
    jcfg, pcfg = configs(tiny_cfg, TPU__COMPUTE_DTYPE="float32", TRAIN__OPTIMIZER="adamw",
                         TRAIN__WD=0.1, MODEL__TRAINABLE_SOFTMAX=False)
    trainer = JaxTrainer(jcfg, make_batch(0))
    temps = []
    for k in range(2):
        r = compare_step(jcfg, pcfg, trainer, None)
        held_step(r, k, r["loss_values"][0].keys())
        assert r["counts"] == {"count": (k + 1, k + 1), "sched_count": (k + 1, k + 1)}
        want = r["jax_state"]["params"]["trainable_temp"]
        got = r["port_state"]["params"]["trainable_temp"]
        assert torch.equal(got, want), (got, want)
        temps.append(float(got))
    lr, wd = np.float32(1e-3), np.float32(0.1)
    assert temps[0] == np.float32(1.0) - lr * wd * np.float32(1.0)
    assert temps[1] < temps[0] < 1.0


def test_float64_gradients_match_jax(tiny_cfg):
    """Gradients of the default train loss at the JAX initial state, model
    in float64 on both sides: atol 1e-5 max|g| per leaf."""
    jcfg, pcfg = configs(tiny_cfg, TPU__COMPUTE_DTYPE="float32")
    batch = make_batch(0)
    trainer = JaxTrainer(jcfg, batch)
    jgrads, pgrads, _ = float64_grads(jcfg, pcfg, trainer.host_state(), batch)
    gmax = max(float(g.abs().max()) for g in jgrads.values())
    assert set(jgrads) == set(pgrads)
    gap, where = max_abs(jgrads, pgrads)
    print(f"float64 gradient gap {gap / gmax:.3g} max|g| at {where}")
    for name, g in jgrads.items():
        np.testing.assert_allclose(pgrads[name].numpy(), g.numpy().astype(np.float64), rtol=0,
                                   atol=1e-5 * gmax, err_msg=name)
