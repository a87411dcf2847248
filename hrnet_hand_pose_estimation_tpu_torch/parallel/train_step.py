"""2D train and eval steps, the optimizer, and the anomaly guard.

Port of the JAX package's ``parallel/train_step.py`` (``TrainState``,
``make_lr_schedule``, ``make_optimizer``, ``create_train_state``,
``apply_guarded_update``, ``make_train_step``, ``make_eval_step``,
``make_forward_fn``) for one device:

    state, tx = create_train_state(cfg, model, steps_per_epoch, device="cuda")
    step = make_train_step(cfg, model, tx)
    state, losses = step(state, batch)      # losses: 0-d device tensors

Layout.  The parameters live in the model, as views of one flat float32
buffer (``TrainState.params``); their ``.grad`` are views of a second one
(``TrainState.grads``), so autograd accumulates straight into it (the same
trick as DDP's ``gradient_as_bucket_view``: never ``zero_grad(set_to_none)``
such a model).  The BN running statistics are views of a third
(``TrainState.stats``, with ``num_batches_tracked`` in ``TrainState.counts``).
The optimizer is functional and mirrors optax's state and arithmetic on
those flat buffers, so an update is a handful of elementwise kernels, and
the guard selects whole buffers with ``torch.where(finite, new, old)``: the
decision stays on the device, with no host sync per step.

Precision.  Parameters, optimizer state and BN statistics are float32
(``TPU.PARAM_DTYPE``); the forward runs under ``torch.autocast`` in
``TPU.COMPUTE_DTYPE`` (bfloat16 by default), as flax's ``dtype=bf16,
param_dtype=f32`` modules do.  Where activations are rounded to the compute
dtype: at the output of every conv (with its bias, rounded once; flax rounds
the conv, then adds the bias in bf16), at the output of every BN (which
computes its statistics and its normalisation in float32,
``models/layers.BatchNorm``), and in the ReLUs, residual adds, the concat
and the nearest upsamples, which run in the compute dtype; the bilinear head
upsample computes in float32 and rounds its output; the logits go to
float32 before the softmax.  Decoding and the losses run in float32 outside
autocast.  The backward runs on autograd (cuDNN's convs on the card): the
JAX package has no backward kernel of its own.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.loss_computer import LossComputer2D
from ..models.layers import BatchNorm
from ..ops.decode import decode_heatmaps
from ..ops.flip import flip_back, shift_heatmap

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_STAT_FIELDS = ("running_mean", "running_var")


def compute_dtype(cfg) -> torch.dtype:
    name = str(cfg.TPU.COMPUTE_DTYPE)
    if name not in DTYPES:
        raise ValueError(f"TPU.COMPUTE_DTYPE {name!r}: want one of {sorted(DTYPES)}")
    return DTYPES[name]


def _check_cfg(cfg) -> None:
    if str(cfg.TPU.PARAM_DTYPE) != "float32":
        raise NotImplementedError(f"TPU.PARAM_DTYPE {cfg.TPU.PARAM_DTYPE!r}: the port trains "
                                  "float32 parameters only")
    if int(cfg.TPU.BN_STAT_SAMPLES) or str(cfg.TPU.BN_STAT_DTYPE):
        raise NotImplementedError("TPU.BN_STAT_SAMPLES / TPU.BN_STAT_DTYPE (the BN statistics "
                                  "levers) are not ported yet")


# -- learning rate and optimizer -------------------------------------------

def make_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """LR at the optimizer's own update count (an int32 0-d tensor, from 0),
    as a float32 0-d tensor on the count's device (reference
    tools/train.py:300-318):

    - 'multi_step': MultiStepLR over the epochs LR_STEP with factor
      LR_FACTOR; the LR is scaled once ``count >= boundary`` (optax's
      ``piecewise_constant_schedule``);
    - 'warmup' / 'warmup_linear': linear warmup over WARMUP_EPOCHS, then
      constant (lib/utils/utils.py:95-105).
    """
    base = float(cfg.TRAIN.LR)
    kind = str(cfg.TRAIN.LR_SCHEDULE)
    if kind == "multi_step":
        boundaries = sorted({int(e) * steps_per_epoch: float(cfg.TRAIN.LR_FACTOR)
                             for e in cfg.TRAIN.LR_STEP}.items())

        def multi_step(count: torch.Tensor) -> torch.Tensor:
            lr = torch.full((), base, dtype=torch.float32, device=count.device)
            for boundary, scale in boundaries:
                lr = torch.where(count >= boundary, scale * lr, lr)
            return lr

        return multi_step
    if kind in ("warmup", "warmup_linear"):
        warm = max(int(cfg.TRAIN.WARMUP_EPOCHS) * steps_per_epoch, 1)

        def warmup(count: torch.Tensor) -> torch.Tensor:
            frac = (count + 1).to(torch.float32) / warm
            return base * torch.clamp(frac, max=1.0)

        return warmup
    raise ValueError(f"unknown LR schedule {kind!r}")


_INT32_MAX = 2 ** 31 - 1


def _increment(count: torch.Tensor) -> torch.Tensor:
    """optax's ``safe_increment``: +1, saturating at the int32 maximum."""
    return torch.where(count < _INT32_MAX, count + 1, count)


class Optimizer:
    """optax's ``adam``, ``adamw`` and ``sgd`` on flat float32 buffers.

    State (a dict of tensors on the parameters' device), as optax keeps it:
    adam/adamw ``count`` (int32), ``mu``, ``nu``; sgd ``trace``; every kind
    ``sched_count`` (int32), the LR schedule's own count.  ``update`` is
    pure: it returns the updates and the new state, with the arithmetic in
    optax's order and float32 (so a state carried over from JAX continues
    the same trajectory).
    """

    def __init__(self, kind: str, schedule: Callable, weight_decay: float = 0.0,
                 momentum: float = 0.9, nesterov: bool = False,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if kind not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {kind!r}")
        self.kind = kind
        self.schedule = schedule
        self.weight_decay = float(weight_decay)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)

    def init(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        zero = torch.zeros((), dtype=torch.int32, device=params.device)
        if self.kind == "sgd":
            return {"trace": torch.zeros_like(params), "sched_count": zero}
        return {"count": zero, "mu": torch.zeros_like(params), "nu": torch.zeros_like(params),
                "sched_count": zero.clone()}

    def update(self, grads: torch.Tensor, state: Dict[str, torch.Tensor],
               params: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        new: Dict[str, torch.Tensor] = {}
        if self.kind == "sgd":
            # optax.trace: t' = g + decay * t; nesterov: g + decay * t'
            trace = grads + self.momentum * state["trace"]
            u = grads + self.momentum * trace if self.nesterov else trace
            new["trace"] = trace
        else:
            # optax.scale_by_adam: EMA of g and g^2, bias-corrected at count + 1
            b1, b2 = self.b1, self.b2
            mu = (1 - b1) * grads + b1 * state["mu"]
            nu = (1 - b2) * (grads * grads) + b2 * state["nu"]
            count = _increment(state["count"])
            n = count.to(torch.float32)
            one = torch.ones((), dtype=torch.float32, device=n.device)
            mu_hat = mu / (1 - torch.pow(b1 * one, n))
            nu_hat = nu / (1 - torch.pow(b2 * one, n))
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            if self.kind == "adamw":
                # optax.add_decayed_weights, unmasked: every parameter decays
                u = u + self.weight_decay * params
            new.update(count=count, mu=mu, nu=nu)
        # optax.scale_by_learning_rate: -lr(count) * u, then count + 1
        lr = self.schedule(state["sched_count"])
        new["sched_count"] = _increment(state["sched_count"])
        return -lr * u, new


def make_optimizer(cfg, steps_per_epoch: int = 1000) -> Optimizer:
    """Optimizer factory (reference lib/utils/utils.py:71-92 get_optimizer)."""
    name = str(cfg.TRAIN.OPTIMIZER).lower()
    return Optimizer(name, make_lr_schedule(cfg, steps_per_epoch),
                     weight_decay=float(cfg.TRAIN.WD) if name == "adamw" else 0.0,
                     momentum=float(cfg.TRAIN.MOMENTUM), nesterov=bool(cfg.TRAIN.NESTEROV))


# -- train state ------------------------------------------------------------

def _flatten(tensors: List[torch.Tensor], dtype: torch.dtype, device) -> Tuple[torch.Tensor,
                                                                              List[torch.Tensor]]:
    """One contiguous buffer holding ``tensors`` and a view of it per tensor."""
    sizes = [t.numel() for t in tensors]
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    views, off = [], 0
    for t, n in zip(tensors, sizes):
        view = flat[off:off + n].view(t.shape)
        view.copy_(t.detach())
        views.append(view)
        off += n
    return flat, views


def _split(flat: torch.Tensor, names: List[str], shapes) -> Dict[str, torch.Tensor]:
    """Views of ``flat`` by name, laid out as ``_flatten`` laid them."""
    out, off = {}, 0
    for name, shape in zip(names, shapes):
        n = int(np.prod(shape, dtype=np.int64))
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


def _bn_modules(model: nn.Module) -> List[Tuple[str, nn.BatchNorm2d]]:
    mods = [(n, m) for n, m in model.named_modules() if isinstance(m, nn.BatchNorm2d)]
    for name, mod in mods:
        if not isinstance(mod, BatchNorm):
            raise TypeError(f"{name}: the train step needs models.layers.BatchNorm (flax's "
                            f"train-mode statistics), got {type(mod).__name__}")
    return mods


class TrainState:
    """Step, parameters, BN statistics and optimizer state of one model.

    ``model`` holds the parameters and BN statistics; ``params``,
    ``grads``, ``stats`` (running means and variances) and ``counts``
    (``num_batches_tracked``) are the flat buffers they are views of (see
    the module docstring).  ``step`` counts train steps, skipped ones
    included, as the JAX ``TrainState.step`` does.
    """

    def __init__(self, model: nn.Module, tx: Optimizer):
        device = next(model.parameters()).device
        self.model = model
        named = list(model.named_parameters())
        for name, p in named:
            if p.dtype != torch.float32:
                raise ValueError(f"{name}: float32 parameters only, got {p.dtype}")
        self.param_names = [n for n, _ in named]
        self.params, views = _flatten([p for _, p in named], torch.float32, device)
        self.grads = torch.zeros_like(self.params)
        grads = _split(self.grads, self.param_names, [p.shape for _, p in named]).values()
        for (_, p), view, grad in zip(named, views, grads):
            p.data = view
            p.grad = grad
        bns = _bn_modules(model)
        self.stat_names = [f"{n}.{f}" for n, _ in bns for f in _STAT_FIELDS]
        self.count_names = [f"{n}.num_batches_tracked" for n, _ in bns]
        self.stats, stat_views = _flatten([getattr(m, f) for _, m in bns for f in _STAT_FIELDS],
                                          torch.float32, device)
        self.counts, count_views = _flatten([m.num_batches_tracked for _, m in bns],
                                            torch.int64, device)
        views = iter(stat_views)
        for (_, m), cview in zip(bns, count_views):
            for f in _STAT_FIELDS:
                m._buffers[f] = next(views)
            m._buffers["num_batches_tracked"] = cview
        self.opt_state = tx.init(self.params)
        self.step = torch.zeros((), dtype=torch.int32, device=device)

    def _param_shapes(self):
        return [p.shape for _, p in self.model.named_parameters()]

    def state_dict(self) -> Dict:
        """{"step", "params", "batch_stats", "opt_state"} with per-name
        tensors (moments by parameter name), cloned to the CPU."""
        cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}
        shapes = self._param_shapes()
        opt = {}
        for key, val in self.opt_state.items():
            opt[key] = (cpu(_split(val, self.param_names, shapes)) if val.dim()
                        else val.detach().cpu().clone())
        buffers = dict(self.model.named_buffers())
        return {"step": self.step.detach().cpu().clone(),
                "params": cpu(dict(self.model.named_parameters())),
                "batch_stats": cpu({n: buffers[n] for n in self.stat_names + self.count_names}),
                "opt_state": opt}

    @torch.no_grad()
    def load_state_dict(self, payload: Dict) -> None:
        """Copy a ``state_dict()`` payload in place; raises on a key or shape
        that does not match this state (optimizer kind included)."""
        shapes = self._param_shapes()

        def fill(flat, names, shapes_, src, what):
            if set(src) != set(names):
                missing, extra = sorted(set(names) - set(src)), sorted(set(src) - set(names))
                raise KeyError(f"{what}: missing {missing[:5]}, unexpected {extra[:5]}")
            for name, view in _split(flat, names, shapes_).items():
                if tuple(src[name].shape) != tuple(view.shape):
                    raise ValueError(f"{what} {name}: want {tuple(view.shape)}, "
                                     f"got {tuple(src[name].shape)}")
                view.copy_(src[name])

        fill(self.params, self.param_names, shapes, payload["params"], "params")
        stats = payload["batch_stats"]
        buffers = dict(self.model.named_buffers())
        fill(self.stats, self.stat_names, [buffers[n].shape for n in self.stat_names],
             {n: stats[n] for n in stats if not n.endswith("num_batches_tracked")}, "batch_stats")
        fill(self.counts, self.count_names, [()] * len(self.count_names),
             {n: stats[n] for n in stats if n.endswith("num_batches_tracked")}, "batch_stats")
        opt = payload["opt_state"]
        if set(opt) != set(self.opt_state):
            raise KeyError(f"optimizer state {sorted(opt)}; this optimizer keeps "
                           f"{sorted(self.opt_state)}")
        for key, val in self.opt_state.items():
            if val.dim():
                fill(val, self.param_names, shapes, opt[key], f"opt_state/{key}")
            else:
                val.copy_(torch.as_tensor(opt[key]))
        self.step.copy_(torch.as_tensor(payload["step"]))


@torch.no_grad()
def init_train_weights(model: nn.Module, seed: int) -> None:
    """The JAX package's initial distributions, from a ``torch.Generator``
    seeded with ``seed`` (the numbers are not JAX's): conv kernels
    normal(std 0.001) (models/layers.py conv_init), conv biases 0, BN scale
    1 and bias 0, running mean 0 and variance 1, the temperature 1."""
    gen = torch.Generator().manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            mod.weight.copy_(torch.normal(0.0, 0.001, mod.weight.shape, generator=gen))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
            mod.num_batches_tracked.zero_()
    if hasattr(model, "trainable_temp"):
        model.trainable_temp.fill_(1.0)


def create_train_state(cfg, model: nn.Module, steps_per_epoch: int = 1000,
                       device="cuda") -> Tuple[TrainState, Optimizer]:
    """Initialise ``model`` (seed ``TPU.SEED``), move it to ``device`` in
    train mode, and build its optimizer and state."""
    _check_cfg(cfg)
    init_train_weights(model, int(cfg.TPU.SEED))
    model.to(device).train()
    tx = make_optimizer(cfg, steps_per_epoch)
    return TrainState(model, tx), tx


# -- the guarded update and the steps --------------------------------------

@torch.no_grad()
def apply_guarded_update(cfg, tx: Optimizer, state: TrainState,
                         loss_dict: Dict[str, torch.Tensor],
                         stats_before: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Optimizer update from ``state.grads`` with the TPU.DETECT_ANOMALY guard.

    Guard (the reference trains under set_detect_anomaly(True),
    tools/train.py:335): the probe is the float32 sum of every gradient; when
    it is not finite the step is skipped whole -- parameters, optimizer state
    (counts included, so the LR schedule does not advance) and the BN
    statistics (``stats_before``, taken before the forward) stay
    bit-identical -- and ``loss_dict['nonfinite_grads']`` is 1 (else 0).
    ``state.step`` advances either way.
    """
    detect = bool(cfg.TPU.DETECT_ANOMALY)
    grads, params = state.grads, state.params
    if detect:
        finite = torch.isfinite(grads.sum(dtype=torch.float32))
        grads = torch.where(finite, grads, torch.zeros((), dtype=grads.dtype,
                                                       device=grads.device))
        loss_dict = dict(loss_dict)
        loss_dict["nonfinite_grads"] = 1.0 - finite.to(torch.float32)
    updates, new_opt = tx.update(grads, state.opt_state, params)
    if detect:
        params.copy_(torch.where(finite, params + updates, params))
        new_opt = {k: torch.where(finite, v, state.opt_state[k]) for k, v in new_opt.items()}
        if stats_before is not None:
            state.stats.copy_(torch.where(finite, state.stats, stats_before[0]))
            state.counts.copy_(torch.where(finite, state.counts, stats_before[1]))
    else:
        params.add_(updates)
    state.opt_state = new_opt
    state.step = state.step + 1
    return state, loss_dict


def compute_autocast(cfg, device: torch.device):
    """``torch.autocast`` in ``TPU.COMPUTE_DTYPE`` on ``device`` (off for float32)."""
    dtype = compute_dtype(cfg)
    return torch.autocast(device.type, dtype=dtype, enabled=dtype != torch.float32)


def make_train_step(cfg, model: nn.Module, tx: Optimizer) -> Callable:
    """The 2D train step: ``step(state, batch) -> (state, losses)``.

    batch: {'images': (B,H,W,3), 'target_heatmaps': (B,h,w,K), 'pose2d':
    (B,K,2) in heatmap px, 'visibility': (B,K)}, tensors on the model's
    device.  ``state.model`` must be ``model``.  The losses are 0-d device
    tensors: the loss dict of ``LossComputer2D``, the temperature (softmax
    heads) and ``nonfinite_grads`` (with the guard).
    """
    _check_cfg(cfg)
    loss_computer = LossComputer2D(cfg)
    use_softmax = bool(cfg.MODEL.HEATMAP_SOFTMAX)
    detect = bool(cfg.TPU.DETECT_ANOMALY)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.model is not model:
            raise ValueError("the state belongs to another model")
        model.train()
        images = batch["images"]
        stats_before = (state.stats.clone(), state.counts.clone()) if detect else None
        with torch.enable_grad():
            with compute_autocast(cfg, images.device):
                out = model(images)
            pose2d_pred = decode_heatmaps(out.heatmaps, use_softmax)
            total, loss_dict = loss_computer(
                heatmaps_pred=out.heatmaps, heatmaps_gt=batch.get("target_heatmaps"),
                pose2d_pred=pose2d_pred, pose2d_gt=batch.get("pose2d"),
                visibility=batch.get("visibility"))
            state.grads.zero_()
            total.backward()
        if out.temperature is not None:
            # a copy: the parameter itself changes in the update below
            loss_dict["temperature"] = out.temperature.detach().clone()
        loss_dict = {k: v.detach() for k, v in loss_dict.items()}
        return apply_guarded_update(cfg, tx, state, loss_dict, stats_before)

    return step


def make_eval_step(cfg, model: nn.Module) -> Callable:
    """Eval step (reference core/function.py:681-701): the forward with the
    running BN statistics, optional flip-test TTA, and the decode.
    ``step(state, batch) -> {'heatmaps', 'pose2d_pred'}``."""
    if str(cfg.MODEL.NAME) == "CPM":
        raise NotImplementedError("the CPM eval step is not ported yet")
    use_softmax = bool(cfg.MODEL.HEATMAP_SOFTMAX)
    flip_test = bool(cfg.TEST.FLIP_TEST)
    shift = bool(cfg.TEST.SHIFT_HEATMAP)

    @torch.no_grad()
    def step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state belongs to another model")
        images = batch["images"]
        was_training = model.training
        model.eval()
        try:
            with compute_autocast(cfg, images.device):
                heatmaps = model(images).heatmaps
                flipped = model(images.flip(2)).heatmaps if flip_test else None
        finally:
            model.train(was_training)
        if flipped is not None:
            hm_f = flip_back(flipped)
            if shift:
                hm_f = shift_heatmap(hm_f)
            heatmaps = 0.5 * (heatmaps + hm_f)
        return {"heatmaps": heatmaps, "pose2d_pred": decode_heatmaps(heatmaps, use_softmax)}

    return step


def make_forward_fn(cfg, model: nn.Module) -> Callable:
    """Plain inference forward: ``fwd(images) -> (heatmaps, pose2d)`` with
    the model's weights and running statistics."""
    use_softmax = bool(cfg.MODEL.HEATMAP_SOFTMAX)

    @torch.no_grad()
    def fwd(images: torch.Tensor):
        was_training = model.training
        model.eval()
        try:
            with compute_autocast(cfg, images.device):
                heatmaps = model(images).heatmaps
        finally:
            model.train(was_training)
        return heatmaps, decode_heatmaps(heatmaps, use_softmax)

    return fwd
