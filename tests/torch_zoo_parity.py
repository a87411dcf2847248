"""Shared harness of the model-zoo parity tests (not a test module).

JAX variables are built from ``jax.eval_shape`` of a module's init (no init
is run) and filled from a numpy seed, leaf by leaf: He-scaled kernels (gain
1.4), BN scales and variances in [0.5, 1.5), small random biases and means,
Swin's position biases of std 0.02, the RVT's keypoint tokens and the
hamburger's bases uniform in [0, 1), the temperature 1.  ``from_jax_variables``
carries them into the port.
"""

from __future__ import annotations

import jax
import numpy as np

from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict


def _fill(tree, rng, path=()):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict) or hasattr(val, "items"):
            out[key] = _fill(dict(val), rng, path + (key,))
            continue
        shape = val.shape
        if key == "kernel":
            if len(shape) == 3:            # attention DenseGeneral: fan-in of the input axes
                fan_in = np.prod(shape[:-1]) if path[-1] == "out" else shape[0]
            else:
                fan_in = np.prod(shape[:-1])
            arr = rng.standard_normal(shape) * 1.4 / np.sqrt(fan_in)
        elif key in ("scale", "var"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif key == "trainable_temp":
            arr = np.ones(shape)
        elif key in ("keypoint_tokens", "w"):
            arr = rng.uniform(0.0, 1.0, shape)
        elif key == "rel_pos_bias":
            arr = 0.02 * rng.standard_normal(shape)
        else:
            arr = 0.05 * rng.standard_normal(shape)
        out[key] = np.asarray(arr, np.float32)
    return out


def jax_variables(model, seed: int, *args):
    """A variable tree (every collection) of ``model.init``'s shapes, filled from ``seed``."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), *args))
    rng = np.random.default_rng(seed)
    return {coll: _fill(dict(tree), rng, (coll,)) for coll, tree in dict(shapes).items()}


def zoo_cfgs(tiny_cfg, name: str, **overrides):
    """(JAX cfg, port cfg): tiny_cfg (64 px, 16 px maps, the tiny HRNet
    stages) as MODEL.NAME ``name`` in float32, with dotted ``overrides``
    (``MODEL__R=8`` sets MODEL.R)."""
    cfg = tiny_cfg.clone()
    cfg.defrost()
    opts = ["MODEL.NAME", name, "TPU.COMPUTE_DTYPE", "float32"]
    for key, val in overrides.items():
        opts += [key.replace("__", "."), val]
    cfg.merge_from_list(opts)
    cfg.freeze()
    return cfg, config_from_dict(cfg.to_dict())


def rel_gap(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def jax_train_step(jcfg, jax_model, monkeypatch):
    """(JAX's jitted ``make_train_step``, its optimizer), the step made with
    ``apply_guarded_update`` patched so that it also returns its gradients
    and new BN statistics (``_grads``, ``_stats``).  ``monkeypatch`` must
    stay in force until the step's first call has traced it; a step of one
    module's tests can then be shared by them (one compile)."""
    import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts

    real = jax_ts.apply_guarded_update

    def returning(cfg, tx, state, grads, new_stats, loss_dict):
        state, losses = real(cfg, tx, state, grads, new_stats, loss_dict)
        return state, dict(losses, _grads=grads, _stats=new_stats)

    monkeypatch.setattr(jax_ts, "apply_guarded_update", returning)
    tx = jax_ts.make_optimizer(jcfg, 1000)
    return jax_ts.make_train_step(jcfg, jax_model, tx), tx


def step_parity(jcfg, pcfg, jax_model, variables, batch, monkeypatch=None, model=None,
                jax_step=None):
    """One train step of the JAX package's jitted ``make_train_step`` and of
    the port's ``pick_train_step`` from the same variables and batch, on
    ``model`` (by default the registry's model of ``pcfg``).

    The JAX step is jitted (op by op, its first step compiles every
    primitive alone: ~45 s for a ResNet-18); ``jax_step`` is one made by
    ``jax_train_step`` earlier (else one is made here, with
    ``monkeypatch``), which returns its gradients and new BN statistics too.
    Returns {"loss": {key: relative gap}, "grad": (largest gradient gap over
    max|g|, where), "stats": largest running-statistic gap (0 without BN),
    "model": the port model after its step, "grads" / "jax_grads": the
    gradients by the port's names}.
    """
    import jax.numpy as jnp
    import torch

    import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
    from hrnet_hand_pose_estimation_tpu_torch.core.train_variants import pick_train_step
    from hrnet_hand_pose_estimation_tpu_torch.models import build_model
    from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as port_ts
    from hrnet_hand_pose_estimation_tpu_torch.utils.weights import (from_jax_train_state,
                                                                    from_jax_variables)

    jstep, tx = jax_step or jax_train_step(jcfg, jax_model, monkeypatch)
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables.get("batch_stats", {}))
    state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                              opt_state=tx.init(params))
    before = jax.device_get(state)
    _, out = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
    out = jax.device_get(out)
    jgrads, jstats = out.pop("_grads"), out.pop("_stats")

    model = build_model(pcfg) if model is None else model
    pstate, ptx = port_ts.create_train_state(pcfg, model, device="cpu")
    pstate.load_state_dict(from_jax_train_state(before, model))
    pstate, pl = pick_train_step(pcfg, model, ptx)(
        pstate, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    want = from_jax_variables({"params": jgrads})
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(want) == set(got)
    gmax = max(float(g.abs().max()) for g in want.values())
    grad = max((float((got[n].double() - want[n].double()).abs().max()) / gmax, n) for n in want)
    stat_gap = 0.0
    if jstats:
        wstats = from_jax_variables({"params": jgrads, "batch_stats": jstats})
        buffers = dict(model.named_buffers())
        stat_gap = max(float((buffers[k] - v).abs().max()) for k, v in wstats.items()
                       if k.endswith(("running_mean", "running_var")))
    assert set(pl) == set(out), (sorted(pl), sorted(out))
    loss = {k: abs(float(pl[k]) - float(v)) / max(abs(float(v)), 1e-30) for k, v in out.items()}
    return {"loss": loss, "grad": grad, "stats": stat_gap, "model": model, "grads": got,
            "jax_grads": want}


def train_grads(jax_model, variables, port_model, images, float64: bool = False):
    """The gradients of ``sum(heatmaps * r)`` (r a seeded random tensor) in
    train mode, BN on its batch statistics, on both sides: (port grads by
    name, JAX grads by port name, max|g|).  With ``float64`` both models run
    in float64 (JAX under ``enable_x64``)."""
    import jax.numpy as jnp
    import torch

    from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables

    dtype = np.float64 if float64 else np.float32
    with jax.enable_x64(float64):
        jm = jax_model.clone(dtype=jnp.float64 if float64 else jnp.float32)
        cast = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)
        x = jnp.asarray(images, dtype)
        out_shape = jm.apply(cast, x, True, mutable=["batch_stats"])[0].heatmaps.shape
        r = np.random.default_rng(11).normal(size=out_shape)

        def loss(p):
            out, _ = jm.apply(dict(cast, params=p), x, True, mutable=["batch_stats"])
            return jnp.sum(out.heatmaps.astype(dtype) * jnp.asarray(r, dtype))

        jgrads = jax.device_get(jax.jit(jax.grad(loss))(cast["params"]))
    want = from_jax_variables({"params": jax.tree.map(np.asarray, jgrads)})
    port = port_model.to(torch.float64 if float64 else torch.float32).train()
    port.zero_grad(set_to_none=True)
    out = port(torch.from_numpy(np.asarray(images, dtype)))
    (out.heatmaps.to(torch.float64) * torch.from_numpy(r)).sum().backward()
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).double()
           for n, p in port.named_parameters()}
    gmax = max(float(g.abs().max()) for g in want.values())
    return got, want, gmax


def sub_state(params, kind: str):
    """A submodule's flax params -> the port state_dict of that submodule,
    named as in a SwinPose (``kind`` 'swin') or an RVT ('rvt')."""
    from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables

    marker = {"swin": {"patch_embed": {}, "embed_norm": {}},
              "rvt": {"keypoint_tokens": np.zeros((1, 1), np.float32)}}[kind]
    sd = from_jax_variables({"params": dict(marker, sub=params)})
    return {k[len("sub."):]: v for k, v in sd.items() if k.startswith("sub.")}


def batch_statistics(jax_model, variables, images):
    """``variables`` with every BN's running statistics set to the batch
    statistics of one train-mode forward of ``images``, as
    ``utils/weights.init_variables`` sets the port's: each layer then sees
    normalized activations, as in a trained net, so the logits keep the
    scale of a trained head's.  (flax's update is ``0.9 old + 0.1 batch``,
    solved here for the batch's.)"""
    import jax.numpy as jnp

    old = variables["batch_stats"]
    _, upd = jax.jit(lambda v, x: jax_model.apply(v, x, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(images))
    new = jax.tree.map(lambda n, o: np.asarray((np.asarray(n, np.float64) - 0.9 * o) / 0.1,
                                               np.float32), upd["batch_stats"], old)
    return dict(variables, batch_stats=new)
