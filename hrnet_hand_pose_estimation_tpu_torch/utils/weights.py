"""Weights for the port: from the JAX variable tree, or made from a seed.

``from_jax_variables`` maps the JAX package's PoseHRNet ``{"params",
"batch_stats"}`` tree (numpy leaves) onto the port's ``state_dict``.  It
keeps its own copy of the name rules of the JAX package's
``utils/torch_convert.py`` (reference torch name -> flax path), inverted:
flax path -> torch name, HWIO kernels -> OIHW weights, and BN
``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``.

``from_jax_train_state`` maps a JAX ``TrainState`` (parameters, BN
statistics, the optax state and the step) onto the port's
``parallel/train_step.TrainState.state_dict()`` payload.

``init_variables`` makes a random state for a config from a numpy seed, for
runs on a machine without JAX (the card's).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

# flax path (joined by "/", without the leaf) -> torch module name.  The
# inverse of the JAX package's _HRNET_RULES (utils/torch_convert.py:24-65).
_RULES = (
    (r"^backbone/stem([12])/conv$", lambda m: f"conv{m[1]}"),
    (r"^backbone/stem([12])/bn$", lambda m: f"bn{m[1]}"),
    (r"^backbone/layer1/block(\d+)/cb(\d)/conv$", lambda m: f"layer1.{m[1]}.conv{m[2]}"),
    (r"^backbone/layer1/block(\d+)/cb(\d)/bn$", lambda m: f"layer1.{m[1]}.bn{m[2]}"),
    (r"^backbone/layer1/block(\d+)/downsample/(conv|bn)$",
     lambda m: f"layer1.{m[1]}.downsample.{_SUB[m[2]]}"),
    (r"^backbone/transition(\d)_(\d+)/(conv|bn)$",
     lambda m: f"transition{m[1]}.{m[2]}.{_SUB[m[3]]}"),
    (r"^backbone/transition(\d)_(\d+)_(\d+)/(conv|bn)$",
     lambda m: f"transition{m[1]}.{m[2]}.{m[3]}.{_SUB[m[4]]}"),
    (r"^backbone/stage(\d)_m(\d+)/branch(\d+)/block(\d+)/cb(\d)/conv$",
     lambda m: f"stage{m[1]}.{m[2]}.branches.{m[3]}.{m[4]}.conv{m[5]}"),
    (r"^backbone/stage(\d)_m(\d+)/branch(\d+)/block(\d+)/cb(\d)/bn$",
     lambda m: f"stage{m[1]}.{m[2]}.branches.{m[3]}.{m[4]}.bn{m[5]}"),
    (r"^backbone/stage(\d)_m(\d+)/branch(\d+)/block(\d+)/downsample/(conv|bn)$",
     lambda m: f"stage{m[1]}.{m[2]}.branches.{m[3]}.{m[4]}.downsample.{_SUB[m[5]]}"),
    (r"^backbone/stage(\d)_m(\d+)/fuse(\d+)_(\d+)/(conv|bn)$",
     lambda m: f"stage{m[1]}.{m[2]}.fuse_layers.{m[3]}.{m[4]}.{_SUB[m[5]]}"),
    (r"^backbone/stage(\d)_m(\d+)/fuse(\d+)_(\d+)_(\d+)/(conv|bn)$",
     lambda m: f"stage{m[1]}.{m[2]}.fuse_layers.{m[3]}.{m[4]}.{m[5]}.{_SUB[m[6]]}"),
    (r"^head_cb/conv$", lambda m: "last_layer.0"),
    (r"^head_cb/bn$", lambda m: "last_layer.1"),
    (r"^final_conv$", lambda m: "last_layer.3"),
)
_SUB = {"conv": "0", "bn": "1"}

# (collection, leaf) -> torch field
_FIELD = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _torch_name(path: str) -> Optional[str]:
    for pattern, build in _RULES:
        m = re.match(pattern, path)
        if m:
            return build(m)
    return None


def _leaves(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def from_jax_variables(variables: Mapping, model: Optional[nn.Module] = None
                       ) -> Dict[str, torch.Tensor]:
    """JAX PoseHRNet variables (numpy leaves) -> the port's state_dict.

    Raises ``KeyError`` on any leaf it cannot place.  With ``model``, it
    also raises on any key of ``model.state_dict()`` left unfilled and on a
    shape that differs.  BN ``num_batches_tracked`` counters are set to 0.
    """
    out: Dict[str, torch.Tensor] = {}
    unplaced = []
    for coll in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(coll, {})):
            arr = np.asarray(leaf, dtype=np.float32)
            if coll == "params" and path == ("trainable_temp",):
                out["trainable_temp"] = torch.from_numpy(arr.copy())
                continue
            name = _torch_name("/".join(path[:-1]))
            field = _FIELD.get((coll, path[-1]))
            if name is None or field is None:
                unplaced.append(f"{coll}/{'/'.join(path)}")
                continue
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)           # HWIO -> OIHW
            out[f"{name}.{field}"] = torch.from_numpy(np.array(arr, order="C"))
    unknown = set(variables) - {"params", "batch_stats"}
    unplaced += sorted(unknown)
    if unplaced:
        raise KeyError(f"JAX leaves with no place in the port: {unplaced[:10]}"
                       f" (+{max(0, len(unplaced) - 10)} more)")
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    if model is not None:
        want = model.state_dict()
        missing = sorted(set(want) - set(out))
        extra = sorted(set(out) - set(want))
        if missing or extra:
            raise KeyError(f"port keys left unfilled: {missing[:10]}; "
                           f"keys the port does not have: {extra[:10]}")
        for key, val in want.items():
            if tuple(val.shape) != tuple(out[key].shape):
                raise ValueError(f"{key}: port shape {tuple(val.shape)}, "
                                 f"JAX gives {tuple(out[key].shape)}")
    return out


def _param_tree(tree: Mapping, names, what: str) -> Dict[str, torch.Tensor]:
    """A tree shaped like the JAX params (an optimizer moment) -> {port
    parameter name: tensor}; raises unless it covers exactly ``names``."""
    out = from_jax_variables({"params": tree})
    if set(out) != set(names):
        missing, extra = sorted(set(names) - set(out)), sorted(set(out) - set(names))
        raise KeyError(f"{what}: port parameters left unfilled {missing[:5]}, "
                       f"leaves with no port parameter {extra[:5]}")
    return out


def from_jax_train_state(state, model: nn.Module) -> Dict:
    """A JAX ``TrainState`` (numpy leaves, e.g. after ``jax.device_get``) ->
    the payload of the port's ``TrainState.load_state_dict``.

    Carries the parameters and BN statistics (``from_jax_variables``,
    strict), the step, and the optax state of ``make_optimizer``'s chains,
    read by field name (no optax import): ``ScaleByAdamState`` -> count, mu,
    nu; ``TraceState`` -> trace; ``ScaleByScheduleState`` -> the schedule's
    count; ``EmptyState`` (adamw's weight decay) carries nothing.  Raises on
    any other optimizer state and on a leaf it cannot place.
    """
    get = (lambda key: state[key]) if isinstance(state, Mapping) else (
        lambda key: getattr(state, key))
    variables = {"params": get("params"), "batch_stats": get("batch_stats")}
    sd = from_jax_variables(variables, model)
    names = [n for n, _ in model.named_parameters()]
    params = {n: sd[n] for n in names}
    opt: Dict = {}
    for node in get("opt_state"):
        fields = tuple(getattr(node, "_fields", ("?",)))
        if fields == ():
            continue
        if set(fields) == {"count", "mu", "nu"}:
            opt["count"] = torch.tensor(int(np.asarray(node.count)), dtype=torch.int32)
            opt["mu"] = _param_tree(node.mu, names, "adam mu")
            opt["nu"] = _param_tree(node.nu, names, "adam nu")
        elif fields == ("trace",):
            opt["trace"] = _param_tree(node.trace, names, "sgd trace")
        elif fields == ("count",):
            opt["sched_count"] = torch.tensor(int(np.asarray(node.count)), dtype=torch.int32)
        else:
            raise KeyError(f"optimizer state {type(node).__name__}{fields} has no place "
                           "in the port")
    return {"step": torch.tensor(int(np.asarray(get("step"))), dtype=torch.int32),
            "params": params,
            "batch_stats": {k: v for k, v in sd.items() if k not in params},
            "opt_state": opt}


# the BNs that close a residual branch of stages 2-4 (basic-block bn2) or
# feed another resolution (fuse layers): damped by init_variables
_DAMPED_BN = re.compile(r"branches\.\d+\.\d+\.bn2$|fuse_layers\.")


@torch.no_grad()
def init_variables(cfg, seed: int = 0, device="cpu", damp: bool = True
                   ) -> Dict[str, torch.Tensor]:
    """A random PoseHRNet state_dict for ``cfg`` from a numpy seed.

    Convs are He-scaled normals and BN affine parameters random around 1 and
    0.  With ``damp``, the BNs that close a residual branch in stages 2-4 or
    feed a fuse layer scale by 0.03-0.1 instead: at full w32 depth an
    undamped random HRNet is chaotic, so a one-ulp change of layer1's bf16
    output moves the decoded joints by pixels (``chip_conditioning.py``
    measures it).  Layer1 and the head are never damped.  The BN running
    statistics are then set to the statistics of one forward of two random
    images (made from the same seed) on ``device``, so every layer sees
    normalized activations as in a trained net, and the statistics sit well
    away from 0 and 1, which exercises BN folding.  Returns CPU tensors.
    """
    from ..models.hrnet import hrnet_from_cfg

    rng = np.random.default_rng(seed)
    model = hrnet_from_cfg(cfg, head="softmax")
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
            std = np.sqrt(2.0 / fan_in)
            mod.weight.copy_(torch.from_numpy(
                rng.normal(0.0, std, mod.weight.shape).astype(np.float32)))
            if mod.bias is not None:
                mod.bias.copy_(torch.from_numpy(
                    rng.normal(0.0, 0.1, mod.bias.shape).astype(np.float32)))
        elif isinstance(mod, nn.BatchNorm2d):
            lo, hi = (0.03, 0.1) if damp and _DAMPED_BN.search(name) else (0.5, 1.5)
            mod.weight.copy_(torch.from_numpy(
                rng.uniform(lo, hi, mod.weight.shape).astype(np.float32)))
            mod.bias.copy_(torch.from_numpy(
                rng.normal(0.0, 0.1, mod.bias.shape).astype(np.float32)))
    h, w = (int(s) for s in cfg.MODEL.IMAGE_SIZE[::-1])
    images = torch.from_numpy(rng.normal(size=(2, h, w, 3)).astype(np.float32))
    model = model.to(device)
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.train()
            mod.momentum = 1.0       # running stats := this batch's stats
    model(images.to(device))
    model.eval()
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.num_batches_tracked.zero_()
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}
