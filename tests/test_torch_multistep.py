"""The port's make_train_multistep and the Trainer's K steps a call, against
sequential port steps (tests/test_torch_multistep_jax.py holds the call
against the JAX package's make_train_multistep:
tests/test_engine_fixes.py::test_train_multistep_matches_sequential_steps
on the port).

Float32 compute and sgd with momentum 0.9 at a constant 1e-2, as that test
runs them (adam's update is ~sign(grad) * LR, so any rounding difference at
a near-zero gradient moves a parameter by 2 LR; sgd is linear in the
gradient).  JAX's weights are its init's distributions (kernels normal(std
0.001), BN 1 / 0, temperature 1) filled from ``eval_shape`` shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer
from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import DataLoader
from hrnet_hand_pose_estimation_tpu_torch.data.synthetic import SyntheticDataset
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_train_state
from torch_train_parity import configs, make_batch, tensors

torch.set_num_threads(1)
K = 3


def sgd_cfgs(tiny_cfg, **extra):
    jcfg, pcfg = configs(tiny_cfg, TPU__COMPUTE_DTYPE="float32", TRAIN__OPTIMIZER="sgd",
                         TRAIN__LR=1e-2, TRAIN__MOMENTUM=0.9, TRAIN__NESTEROV=False, **extra)
    for cfg in (jcfg, pcfg):
        cfg.defrost()
        cfg.TRAIN.LR_STEP = []          # a constant LR, as optax.sgd(1e-2)
        cfg.freeze()
    return jcfg, pcfg


def jax_init_like(jm, images):
    """JAX's init distributions on eval_shape shapes, from a numpy seed."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), images, False))
    rng = np.random.default_rng(0)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            return jnp.asarray(rng.normal(0.0, 0.001, s.shape), s.dtype)
        if leaf in ("scale", "var", "trainable_temp"):
            return jnp.ones(s.shape, s.dtype)
        return jnp.zeros(s.shape, s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def setup(tiny_cfg):
    jcfg, pcfg = sgd_cfgs(tiny_cfg)
    jm = jax_build_model(jcfg)
    batches = [make_batch(seed) for seed in range(K)]
    v = jax_init_like(jm, jnp.asarray(batches[0]["images"][:1]))
    # optax.sgd(1e-2, momentum=0.9) as the JAX package's make_optimizer
    # builds it: a schedule (constant here), whose count the port keeps too
    tx = jax_ts.make_optimizer(jcfg)
    jstate = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                               batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))
    return jcfg, pcfg, jm, tx, jstate, batches


def port_state(pcfg, jstate):
    model = build_model(pcfg)
    state, tx = TS.create_train_state(pcfg, model, device="cpu")
    state.load_state_dict(from_jax_train_state(jax.device_get(jstate), model))
    return model, state, tx


def stacked(batches):
    return {k: torch.stack([tensors(b)[k] for b in batches]) for k in batches[0]}


def test_multistep_matches_sequential_port_steps(setup):
    """K=3 in one call against three calls of the step, from the same
    state: every loss, parameter, BN statistic and optimizer value bit for
    bit (measured: identical; the call is the same steps in order)."""
    _, pcfg, _, _, jstate, batches = setup
    model, state, tx = port_state(pcfg, jstate)
    step = TS.make_train_step(pcfg, model, tx)
    seq = []
    for b in batches:
        state, losses = step(state, tensors(b))
        seq.append({k: v.clone() for k, v in losses.items()})
    want = state.state_dict()

    model, state, tx = port_state(pcfg, jstate)
    state, losses_k = TS.make_train_multistep(pcfg, model, tx)(state, stacked(batches))
    assert set(losses_k) == set(seq[0]) and all(v.shape[0] == K for v in losses_k.values())
    for k, v in losses_k.items():
        assert torch.equal(v, torch.stack([s[k] for s in seq])), k
    got = state.state_dict()
    assert int(got["step"]) == K
    for section in ("params", "batch_stats"):
        for name, val in want[section].items():
            assert torch.equal(got[section][name], val), name
    for key, val in want["opt_state"].items():
        vals = val.values() if isinstance(val, dict) else [val]
        gots = got["opt_state"][key].values() if isinstance(val, dict) else [got["opt_state"][key]]
        assert all(torch.equal(a, b) for a, b in zip(vals, gots)), key
    with pytest.raises(ValueError, match="steps axis"):
        bad = stacked(batches)
        bad["pose2d"] = bad["pose2d"][:2]
        TS.make_train_multistep(pcfg, model, tx)(state, bad)


def test_trainer_two_steps_a_call(tiny_cfg, tmp_path):
    """STEPS_PER_DISPATCH=2 over 5 batches: 2 calls of the multistep and 1
    leftover step, 5 global steps, and the epoch's averages those of the
    same epoch at one step a call (the same steps in order; the sums group
    two steps before the batch weight, so rtol 1e-6)."""
    avgs, counts = {}, {}
    for k in (1, 2):
        _, cfg = sgd_cfgs(tiny_cfg, OUTPUT_DIR=str(tmp_path / str(k)), WORKERS=0,
                          PRINT_FREQ=1, TPU__STEPS_PER_DISPATCH=k)
        loaders = {"s": DataLoader(SyntheticDataset(cfg, length=10), 2, num_workers=0)}
        trainer = Trainer(cfg, build_model(cfg), loaders, output_dir=str(tmp_path / str(k)),
                          device="cpu")
        calls = {"multi": 0, "single": 0}
        for attr, key in (("train_multistep", "multi"), ("train_step", "single")):
            fn = getattr(trainer, attr)
            if fn is not None:
                def counted(*a, fn=fn, key=key):
                    calls[key] += 1
                    return fn(*a)
                setattr(trainer, attr, counted)
        avgs[k] = trainer.train_epoch(1)
        counts[k] = (calls, trainer.train_global_steps, int(trainer.state.step))
    assert counts[1] == ({"multi": 0, "single": 5}, 5, 5)
    assert counts[2] == ({"multi": 2, "single": 1}, 5, 5)
    assert set(avgs[1]) == set(avgs[2])
    for key, v in avgs[1].items():
        assert avgs[2][key] == pytest.approx(v, rel=1e-6), key


def test_train_steps_after_an_inference_mode_forward(tiny_cfg):
    """A forward under ``torch.inference_mode`` (serving, calibration) and
    then train steps in the same process: the upsample's cached matrices
    are made outside inference mode, so the training forward can save them
    for its backward (the order of the trained-weights gate: a serving
    check, then training)."""
    from hrnet_hand_pose_estimation_tpu_torch.ops import upsample

    upsample._device_matrix.cache_clear()
    _, pcfg = sgd_cfgs(tiny_cfg)
    model = build_model(pcfg)
    with torch.inference_mode():
        model.eval()(tensors(make_batch(0))["images"])
    state, tx = TS.create_train_state(pcfg, model, device="cpu")
    state, losses = TS.make_train_multistep(pcfg, model, tx)(
        state, stacked([make_batch(s) for s in range(2)]))
    assert torch.isfinite(losses["total_loss"]).all() and int(state.step) == 2
