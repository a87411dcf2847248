"""The port's 2D train step against the JAX package's, on tiny_cfg.

Adam with the default losses, in float32 and in bfloat16, two consecutive
steps from the JAX ``create_train_state`` carried across by
``from_jax_train_state``; the optimizer, the LR schedules and the anomaly
guard.  The oracle runs op by op (see ``torch_train_parity.py``).

What each float32 step is held to, and why:
- the loss dict at rtol 1e-5;
- the update: given the JAX step's gradients and BN statistics, the port's
  guarded update gives JAX's parameters at atol 1e-3 LR and its optimizer
  moments and counts exactly;
- the BN running statistics after the port's own step at atol 1e-6 +
  rtol 1e-5;
- the gradients themselves are compared in float64
  (``test_torch_train_step_opts.py``): in float32 a ReLU input within
  rounding of 0 can fall on the other side in the two implementations and
  move everything below it by up to 2.4e-3 of max|g| (measured on this
  batch; JAX's own jitted and op-by-op gradients differ by 8e-6).  For the
  same reason the parameters after the port's own Adam step differ by up to
  2 LR where a gradient is at rounding level (the final conv's bias, whose
  gradient the spatial softmax makes exactly 0 in exact arithmetic), and
  are only reported.
"""

import jax
import numpy as np
import pytest
import torch

from torch_train_parity import (JaxTrainer, compare_step, configs, make_batch, port_state,
                                tensors)

import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as port_ts
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_train_state

torch.set_num_threads(1)


def two_steps(jcfg, pcfg, steps_per_epoch=1000, setup=None):
    batch = make_batch(0)
    trainer = JaxTrainer(jcfg, batch, steps_per_epoch)
    if setup is not None:
        setup(trainer)
    return [compare_step(jcfg, pcfg, trainer, None, steps_per_epoch) for _ in range(2)]


@pytest.fixture(scope="module")
def adam_f32(tiny_cfg):
    jcfg, pcfg = configs(tiny_cfg, TPU__COMPUTE_DTYPE="float32")
    return two_steps(jcfg, pcfg)


@pytest.mark.parametrize("k", [0, 1])
def test_adam_float32_step_matches_jax(adam_f32, k):
    r = adam_f32[k]
    jl, pl = r["loss_values"]
    assert set(jl) == set(pl) == {"heatmap_loss", "pose2d_loss", "total_loss", "temperature",
                                  "nonfinite_grads"}
    for key, v in jl.items():
        np.testing.assert_allclose(pl[key], v, rtol=1e-5, err_msg=key)
    assert r["params_same_grads"] <= 1e-3, r["params_same_grads"]
    assert r["moments_same_grads"][0] == 0.0, r["moments_same_grads"]
    assert r["counts"] == {"count": (k + 1, k + 1), "sched_count": (k + 1, k + 1)}
    ref, own = r["jax_state"], r["port_state"]
    for name, v in ref["batch_stats"].items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(own["batch_stats"][name].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    # reported, not held (module docstring): the float32 gradient gap and
    # the parameters after the port's own Adam step
    print(f"step {k}: grad gap {r['grad']:.3g} max|g| at {r['grad_at']}, own-step params "
          f"{r['params_own_grads']:.3g} LR, stats {r['stats']}")


def test_bfloat16_step_matches_jax(tiny_cfg):
    """The default compute dtype: the loss dict at rtol 3e-2, two steps."""
    jcfg, pcfg = configs(tiny_cfg)
    assert str(pcfg.TPU.COMPUTE_DTYPE) == "bfloat16"
    for k, r in enumerate(two_steps(jcfg, pcfg)):
        jl, pl = r["loss_values"]
        for key, v in jl.items():
            np.testing.assert_allclose(pl[key], v, rtol=3e-2, err_msg=f"step {k} {key}")
        print(f"bf16 step {k}: loss gaps {r['loss']}")


def test_anomaly_guard_skips_nonfinite_step(tiny_cfg):
    """A NaN pixel leaves the parameters, the optimizer state (counts
    included) and the BN statistics bit-identical and sets
    ``nonfinite_grads``; the next clean step trains at the LR JAX's schedule
    gives for that count."""
    jcfg, pcfg = configs(tiny_cfg, TPU__COMPUTE_DTYPE="float32", TRAIN__LR_STEP=[1])
    model = build_model(pcfg)
    state, tx = port_ts.create_train_state(pcfg, model, steps_per_epoch=2, device="cpu")
    step = port_ts.make_train_step(pcfg, model, tx)
    good = tensors(make_batch(3))
    state, losses = step(state, good)
    assert losses["nonfinite_grads"].item() == 0.0
    bad = dict(good, images=good["images"].clone())
    bad["images"][0, 0, 0, 0] = float("nan")
    before = state.state_dict()
    state, losses = step(state, bad)
    after = state.state_dict()
    assert losses["nonfinite_grads"].item() == 1.0
    assert int(after["step"]) == int(before["step"]) + 1
    for section in ("params", "batch_stats"):
        for name, v in before[section].items():
            assert torch.equal(v, after[section][name]), name
    for key, v in before["opt_state"].items():
        vals = v.items() if isinstance(v, dict) else [(key, v)]
        for name, t in vals:
            got = after["opt_state"][key][name] if isinstance(v, dict) else after["opt_state"][key]
            assert torch.equal(t, got), (key, name)
    # the clean step after it: schedule count 1 (the skip did not advance
    # it), so with 2 steps per epoch and LR_STEP [1] the LR is still the base
    count = int(after["opt_state"]["sched_count"])
    assert count == 1
    jax_lr = float(jax_ts.make_lr_schedule(jcfg, 2)(count))
    port_lr = float(tx.schedule(torch.tensor(count, dtype=torch.int32)))
    assert port_lr == jax_lr == np.float32(pcfg.TRAIN.LR)
    p0 = state.params.clone()
    state, losses = step(state, good)
    assert losses["nonfinite_grads"].item() == 0.0 and not torch.equal(p0, state.params)
    assert int(state.opt_state["sched_count"]) == 2
    assert float(tx.schedule(state.opt_state["sched_count"])) == float(
        jax_ts.make_lr_schedule(jcfg, 2)(2)) == np.float32(pcfg.TRAIN.LR) * np.float32(0.1)


@pytest.mark.parametrize("kind,lr_step", [("multi_step", [3, 5]), ("multi_step", [1, 1, 4]),
                                          ("warmup", None), ("warmup_linear", None)])
def test_lr_schedule_matches_optax(tiny_cfg, kind, lr_step):
    """The LR at each count equals the JAX package's schedule (optax);
    multi_step scales once count >= boundary: {3, 5} gives 1, 1, 1, 0.1,
    0.1, 0.01 (times the base)."""
    opts = dict(TRAIN__LR_SCHEDULE=kind, TRAIN__WARMUP_EPOCHS=2)
    if lr_step:
        opts["TRAIN__LR_STEP"] = lr_step
    jcfg, pcfg = configs(tiny_cfg, **opts)
    jsched = jax_ts.make_lr_schedule(jcfg, 1)
    psched = port_ts.make_lr_schedule(pcfg, 1)
    got = [float(psched(torch.tensor(c, dtype=torch.int32))) for c in range(8)]
    want = [float(jsched(np.int32(c))) for c in range(8)]
    assert got == want
    if lr_step == [3, 5]:
        base = float(np.float32(pcfg.TRAIN.LR))
        np.testing.assert_allclose(np.array(got[:6]) / base, [1, 1, 1, 0.1, 0.1, 0.01],
                                   rtol=1e-6)


@pytest.mark.parametrize("name,opts", [
    ("adam", {}), ("adamw", {"TRAIN__WD": 0.05}),
    ("sgd", {"TRAIN__NESTEROV": False}), ("sgd", {"TRAIN__NESTEROV": True})])
def test_optimizer_matches_optax(tiny_cfg, name, opts):
    """Three updates of the flat optimizer against optax's on the same
    gradients, with gradients at 1e-9 (where eps matters), 1e-3 and 1.

    Adam's bias correction ``1 - b2**count`` cancels: XLA:CPU's ``pow``
    and ``powf`` differ by an ulp of ``0.999**3``, which becomes 2e-5 of
    ``1 - 0.999**3`` (0.0029969215 in JAX, 0.0029969811 here; the float64
    value is 0.0029969614), hence rtol 5e-5 on the updates; counts 1 and 2
    agree to the bit."""
    jcfg, pcfg = configs(tiny_cfg, TRAIN__OPTIMIZER=name, **opts)
    rng = np.random.default_rng(7)
    params = rng.normal(size=257).astype(np.float32)
    jtx = jax_ts.make_optimizer(jcfg, 1000)
    ptx = port_ts.make_optimizer(pcfg, 1000)
    jstate = jtx.init(jax.numpy.asarray(params))
    pstate = ptx.init(torch.from_numpy(params))
    p_j, p_p = jax.numpy.asarray(params), torch.from_numpy(params.copy())
    for _ in range(3):
        g = rng.normal(size=257).astype(np.float32) * rng.choice([1e-9, 1e-3, 1.0], size=257)
        with jax.disable_jit():
            upd_j, jstate = jtx.update(jax.numpy.asarray(g), jstate, p_j)
        upd_p, pstate = ptx.update(torch.from_numpy(g), pstate, p_p)
        np.testing.assert_allclose(upd_p.numpy(), np.asarray(upd_j), rtol=5e-5,
                                   atol=1e-6 * float(pcfg.TRAIN.LR))
        p_j = p_j + upd_j
        p_p = p_p + upd_p
    leaves = {"adam": ("count", "mu", "nu"), "adamw": ("count", "mu", "nu"),
              "sgd": ("trace",)}[name]
    node = jstate[0]
    for leaf in leaves:
        # a moment is a sum of terms of both signs: compare at the terms' scale
        want = np.asarray(getattr(node, leaf))
        np.testing.assert_allclose(pstate[leaf].numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=leaf)
    assert int(pstate["sched_count"]) == int(jstate[-1].count) == 3


def test_from_jax_train_state_is_strict(tiny_cfg):
    jcfg, pcfg = configs(tiny_cfg, TPU__COMPUTE_DTYPE="float32")
    trainer = JaxTrainer(jcfg, make_batch(0))
    host = trainer.host_state()
    model, state, _ = port_state(pcfg, host)
    payload = state.state_dict()
    assert int(payload["step"]) == 0 and int(payload["opt_state"]["count"]) == 0
    class Unknown(tuple):
        _fields = ("velocity",)

    with pytest.raises(KeyError, match="no place"):
        from_jax_train_state(host.replace(opt_state=(Unknown((1,)),)), model)
    params = dict(host.params)
    params["stray"] = {"kernel": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(KeyError):
        from_jax_train_state(host.replace(params=params), model)
    sd = state.state_dict()
    del sd["opt_state"]["nu"]
    with pytest.raises(KeyError, match="optimizer state"):
        state.load_state_dict(sd)
