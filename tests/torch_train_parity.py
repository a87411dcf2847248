"""Shared harness of the port's train-step parity tests (not a test module).

The oracle is the JAX package's ``make_train_step`` run op by op
(``jax.disable_jit``): jitted, XLA fuses the heatmap loss's two reductions
into one single-accumulator sum over B*H*W*K values, which is off the
float64 value by 1.7e-5 relative on tiny_cfg, more than the 1e-5 the loss
is held to; op by op it is within 3e-7.  Its ``apply_guarded_update`` is
wrapped while the step runs, so the harness also reads the step's gradients
and new BN statistics.  Each step of the port starts from the JAX state of
the same step, carried across by ``from_jax_train_state``.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import torch

import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu.ops.targets import gaussian_targets as jax_gaussian_targets
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as port_ts
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_train_state


def configs(tiny_cfg, **overrides):
    """(JAX cfg, port cfg) of tiny_cfg with dotted ``overrides``
    (``TRAIN__LR=0.1`` sets TRAIN.LR)."""
    cfg = tiny_cfg.clone()
    cfg.defrost()
    opts = []
    for key, val in overrides.items():
        opts += [key.replace("__", "."), val]
    cfg.merge_from_list(opts)
    cfg.freeze()
    return cfg, config_from_dict(cfg.to_dict())


def make_batch(seed: int, b: int = 2) -> Dict[str, np.ndarray]:
    """A seeded tiny_cfg batch whose targets come from JAX ``gaussian_targets``."""
    rng = np.random.default_rng(seed)
    pose = rng.uniform(2, 14, size=(b, 21, 2)).astype(np.float32)
    vis = np.ones((b, 21), np.float32)
    return {"images": rng.normal(size=(b, 64, 64, 3)).astype(np.float32),
            "pose2d": pose, "visibility": vis,
            "target_heatmaps": np.asarray(jax_gaussian_targets(jnp.asarray(pose),
                                                               jnp.asarray(vis), 16, 2.0))}


@contextmanager
def _recording(log: List):
    real = jax_ts.apply_guarded_update

    def rec(cfg, tx, state, grads, new_stats, loss_dict):
        log.append((grads, new_stats))
        return real(cfg, tx, state, grads, new_stats, loss_dict)

    jax_ts.apply_guarded_update = rec
    try:
        yield
    finally:
        jax_ts.apply_guarded_update = real


def recorded(monkeypatch, module, log: List) -> None:
    """Wrap ``module.apply_guarded_update`` (a JAX step module's own
    reference, e.g. ``core.train_variants``'s) so it logs (grads, new BN
    statistics) of each step."""
    real = module.apply_guarded_update

    def rec(cfg, tx, state, grads, new_stats, loss_dict):
        log.append((grads, new_stats))
        return real(cfg, tx, state, grads, new_stats, loss_dict)

    monkeypatch.setattr(module, "apply_guarded_update", rec)


class JaxTrainer:
    """JAX ``create_train_state`` + ``make_train_step``, run op by op."""

    def __init__(self, cfg, batch, steps_per_epoch: int = 1000):
        self.model = jax_build_model(cfg)
        self.batch = {k: jnp.asarray(v) for k, v in batch.items()}
        self.state, self.tx = jax_ts.create_train_state(
            cfg, self.model, jax.random.key(0), self.batch, steps_per_epoch=steps_per_epoch)
        self.step_fn = jax_ts.make_train_step(cfg, self.model, self.tx)

    def step(self, batch=None):
        """One step; returns (loss dict, grads, new BN stats) as numpy trees."""
        log: List = []
        with jax.disable_jit(), _recording(log):
            self.state, losses = self.step_fn(self.state, self.batch if batch is None else
                                              {k: jnp.asarray(v) for k, v in batch.items()})
        grads, stats = log[-1]
        return ({k: float(v) for k, v in losses.items()}, jax.device_get(grads),
                jax.device_get(stats))

    def host_state(self):
        return jax.device_get(self.state)


def port_state(cfg, jax_state, steps_per_epoch: int = 1000):
    """A port model, optimizer and state carrying ``jax_state``."""
    model = build_model(cfg)
    state, tx = port_ts.create_train_state(cfg, model, steps_per_epoch, device="cpu")
    state.load_state_dict(from_jax_train_state(jax_state, model))
    return model, state, tx


def tensors(batch) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def named_grads(jax_state, grads, model) -> Dict[str, torch.Tensor]:
    """JAX gradients (a params-shaped tree) by port parameter name."""
    return from_jax_train_state(jax_state.replace(params=grads), model)["params"]


def max_abs(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor], keys=None) -> tuple:
    """(largest |a - b| over the keys, the key where it is)."""
    keys = a.keys() if keys is None else keys
    return max((float((a[k].double() - b[k].double()).abs().max()), k) for k in keys)


def compare_step(jcfg, pcfg, trainer: JaxTrainer, batch, steps_per_epoch: int = 1000) -> Dict:
    """One step on both sides from the same state.  Returns the measured gaps:

    - ``loss``: {key: relative gap} of the loss dicts;
    - ``grad``: largest gradient gap over max|g| (all leaves);
    - ``stats``: largest running mean / variance gap;
    - ``params_same_grads``: largest parameter gap over the LR when the
      port's guarded update gets the JAX gradients and BN statistics;
    - ``moments_same_grads``: largest optimizer-moment gap, same inputs;
    - ``counts``: (JAX, port) optimizer and schedule counts after the step;
    - ``params_own_grads``: largest parameter gap over the LR after the
      port's whole step (its own gradients);
    - ``lr``: the step's LR (JAX's schedule at the count the step used).
    """
    before = trainer.host_state()
    opt_before = from_jax_train_state(before, build_model(pcfg))["opt_state"]
    sched = jax_ts.make_lr_schedule(jcfg, steps_per_epoch)
    lr = float(sched(int(opt_before["sched_count"])))
    jl, jgrads, jstats = trainer.step(batch)
    after = trainer.host_state()

    # the port's decoded poses of the step's forward (train mode), on a
    # throw-away copy of the state
    model, state, tx = port_state(pcfg, before, steps_per_epoch)
    with torch.no_grad(), port_ts.compute_autocast(pcfg, torch.device("cpu")):
        heatmaps = model(tensors(trainer.batch if batch is None else batch)["images"]).heatmaps
    pose2d_pred = port_ts.decode_heatmaps(heatmaps.float(), bool(pcfg.MODEL.HEATMAP_SOFTMAX))

    model, state, tx = port_state(pcfg, before, steps_per_epoch)
    step = port_ts.make_train_step(pcfg, model, tx)
    state, pl = step(state, tensors(trainer.batch if batch is None else batch))
    own = state.state_dict()
    ref = from_jax_train_state(after, model)
    grads = named_grads(before, jgrads, model)
    gmax = max(float(g.abs().max()) for g in grads.values())
    port_grads = dict(zip(state.param_names, [p.grad.clone() for _, p in
                                               model.named_parameters()]))
    stat_keys = [k for k in ref["batch_stats"] if not k.endswith("num_batches_tracked")]
    out = {
        "loss": {k: abs(pl[k].item() - v) / max(abs(v), 1e-30) for k, v in jl.items()},
        "loss_values": (jl, {k: v.item() for k, v in pl.items()}),
        "grad": max_abs(grads, port_grads)[0] / gmax,
        "grad_at": max_abs(grads, port_grads)[1],
        "stats": max_abs(ref["batch_stats"], own["batch_stats"], stat_keys),
        "params_own_grads": max_abs(ref["params"], own["params"])[0] / lr,
        "lr": lr,
        "pose2d_pred": pose2d_pred.numpy(),
    }

    # the guarded update alone, fed the JAX gradients and BN statistics
    model, state, tx = port_state(pcfg, before, steps_per_epoch)
    stats_before = (state.stats.clone(), state.counts.clone())
    sd = state.state_dict()
    sd["batch_stats"].update(from_jax_train_state(before.replace(batch_stats=jstats),
                                                  model)["batch_stats"])
    state.load_state_dict(sd)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.grad.copy_(grads[name])
    state, _ = port_ts.apply_guarded_update(pcfg, tx, state, {}, stats_before)
    upd = state.state_dict()
    moments = [k for k, v in ref["opt_state"].items() if isinstance(v, dict)]
    out["params_same_grads"] = max_abs(ref["params"], upd["params"])[0] / lr
    out["moments_same_grads"] = max(max_abs(ref["opt_state"][k], upd["opt_state"][k])
                                    for k in moments)
    out["counts"] = {k: (int(ref["opt_state"][k]), int(upd["opt_state"][k]))
                     for k in ref["opt_state"] if k not in moments}
    out["port_state"], out["jax_state"] = upd, ref
    return out


def float64_grads(jcfg, pcfg, jax_state, batch) -> tuple:
    """Gradients of the train loss at ``jax_state`` with the model computed
    in float64 on both sides (the losses, the softmax and the head
    upsample cast to float32 on both, as the JAX package does): (JAX grads
    by port name, port grads, port loss dict).  In float32 a ReLU whose
    pre-activation lies within rounding of 0 can take the other side on the
    two implementations and move the gradients below it by 1e-3 of max|g|;
    float64 takes that away, so the gradients compare the algorithm."""
    from hrnet_hand_pose_estimation_tpu.core.loss_computer import LossComputer2D as JaxLoss
    from hrnet_hand_pose_estimation_tpu.ops.decode import decode_heatmaps as jax_decode
    from hrnet_hand_pose_estimation_tpu_torch.core.loss_computer import LossComputer2D
    from hrnet_hand_pose_estimation_tpu_torch.ops.decode import decode_heatmaps

    jcfg64 = jcfg.clone()
    jcfg64.defrost()
    jcfg64.TPU.COMPUTE_DTYPE = "float64"
    jcfg64.freeze()
    with jax.enable_x64(True):
        model = jax_build_model(jcfg64)
        loss = JaxLoss(jcfg64)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(params):
            out, _ = model.apply({"params": params, "batch_stats": jax_state.batch_stats},
                                 jb["images"], True, mutable=["batch_stats"])
            total, _ = loss(heatmaps_pred=out.heatmaps, heatmaps_gt=jb["target_heatmaps"],
                            pose2d_pred=jax_decode(out.heatmaps, True), pose2d_gt=jb["pose2d"],
                            visibility=jb["visibility"])
            return total

        jgrads = jax.device_get(jax.jit(jax.grad(loss_fn))(jax_state.params))
    pmodel = build_model(pcfg)
    payload = from_jax_train_state(jax_state, pmodel)
    pmodel.load_state_dict({**payload["params"], **payload["batch_stats"]})
    pmodel.double().train()
    tb = tensors(batch)
    out = pmodel(tb["images"].double())
    total, losses = LossComputer2D(pcfg)(out.heatmaps, tb["target_heatmaps"],
                                         decode_heatmaps(out.heatmaps), tb["pose2d"],
                                         tb["visibility"])
    total.backward()
    return (named_grads(jax_state, jgrads, pmodel),
            {n: p.grad for n, p in pmodel.named_parameters()}, losses)
