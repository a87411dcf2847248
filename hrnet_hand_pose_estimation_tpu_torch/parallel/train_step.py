"""2D train and eval steps, the optimizer, and the anomaly guard.

Port of the JAX package's ``parallel/train_step.py`` (``TrainState``,
``make_lr_schedule``, ``make_optimizer``, ``create_train_state``,
``apply_guarded_update``, ``make_train_step``, ``make_train_multistep``,
``make_eval_step``, ``make_forward_fn``) for one device, or one rank of a
data-parallel process group:

    state, tx = create_train_state(cfg, model, steps_per_epoch, device="cuda")
    step = make_train_step(cfg, model, tx)
    state, losses = step(state, batch)      # losses: 0-d device tensors

Data parallel.  When a process group of several ranks is up
(``parallel/distributed.py``) as the step is made, each rank steps on its
slice of the global batch and the step is JAX's SPMD step on the global
batch: the BN statistics are summed over the ranks in the forward
(``models/layers.synced_batch_stats``, and their gradient in the
backward), every loss is this rank's share over the global denominators
(``LossComputer2D(count_sum=...)``), and one ``all_reduce`` of the flat
gradient buffer after the backward sums the shares' gradients, XLA's psum,
before the anomaly guard, so every rank takes the same skip decision.  The
reported losses are summed too: the global ones, equal on every rank.
Under a data x model grid of ranks (``distributed.init_grid``) the sums run
over the data group, and each rank keeps only its shard of the wide
weights JAX splits over its 'model' axis (``state_shardings``,
``parallel/tensor_parallel.py``): the flat buffers hold the shards, so the
optimizer's moments are shard-shaped, and the anomaly guard's finite flag
is reduced over the world.  This was chosen over wrapping the model in ``DistributedDataParallel``:
the gradients already live in one flat buffer, so one collective does
what DDP's buckets do, and DDP's loss convention (the mean of per-rank
losses) is not JAX's global normalisation.

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

from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.loss_computer import LossComputer2D
from ..models.layers import BatchNorm, synced_batch_stats
from ..ops.decode import decode_heatmaps
from ..ops.flip import flip_back, shift_heatmap
from . import distributed
from . import tensor_parallel as tp

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_STAT_FIELDS = ("running_mean", "running_var")


def compute_dtype(cfg) -> torch.dtype:
    name = str(cfg.TPU.COMPUTE_DTYPE)
    if name not in DTYPES:
        raise ValueError(f"TPU.COMPUTE_DTYPE {name!r}: want one of {sorted(DTYPES)}")
    return DTYPES[name]


# Models whose JAX 2D steps fail, by the step that fails: the port raises
# where JAX does (ROADMAP C16, C17, C19, C21, C22).
_HAMBURGER = ("pose_hrnet_hamburger has no {what}: JAX's create_train_state keeps only the "
              "params and batch_stats collections, and the model reads its ham_bases "
              "collection (ScopeCollectionNotFound, ROADMAP C16); evaluate it with Evaluator2D, "
              "make_forward_fn or the tools")
_RVT = ("my_pose_transformer has no {what}: the model returns a bare (B, K, 2) array, and the "
        "JAX package's {what} reads its heatmaps (AttributeError, ROADMAP C17); call the "
        "model itself")
_PREDRNN = ("HRNet_PredRNN has no {what}: the model returns a tuple (refined maps, maps, poses), "
            "and the JAX package's {what} reads its heatmaps (AttributeError, ROADMAP C19); "
            "call the model itself")
_TCN = ("HRNet_Emb_TCN has no {what}: the model returns a bare (B, K, 2) array, and the JAX "
        "package's {what} reads its heatmaps (AttributeError, ROADMAP C19); call the model "
        "itself")
_FTL = ("FTL has no {what}: the net takes (images, extrinsics, intrinsics), and the JAX "
        "package's create_train_state calls model.init(rng, images, False), which raises "
        "TypeError (missing 'intrinsics', ROADMAP C21), so its tools.train fails before its first "
        "step; its 2D steps and Evaluator2D pass images alone, and Evaluator3D builds only the "
        "alg / ransac / vol nets; call the model itself")
_HOURGLASS = ("HourGlass has no {what}: HGFilter returns a tuple (outputs, normx), and the JAX "
              "package's {what} reads its heatmaps (AttributeError, ROADMAP C22); call the model "
              "itself")
_EVERY = {"my_pose_transformer": _RVT, "HRNet_PredRNN": _PREDRNN, "HRNet_Emb_TCN": _TCN,
          "FTL": _FTL, "HourGlass": _HOURGLASS}
_NO_STEP = {
    "train state": {"FTL": _FTL},
    "train step": dict(_EVERY, pose_hrnet_hamburger=_HAMBURGER),
    "eval step": dict(_EVERY, pose_hrnet_hamburger=_HAMBURGER),
    "forward function": _EVERY,
    "2D evaluator": _EVERY,
}


def refuse_unsupported(cfg, what: str) -> None:
    """Raise ``NotImplementedError`` where the JAX package's ``what`` ('train
    state', 'train step', 'eval step', 'forward function', '2D evaluator')
    fails on MODEL.NAME."""
    msg = _NO_STEP[what].get(str(cfg.MODEL.NAME))
    if msg is not None:
        raise NotImplementedError(msg.format(what=what))


def check_map_batch(heatmaps: torch.Tensor, batch: Dict) -> None:
    """Raise ``ValueError`` (ROADMAP C20) when the model's maps neither match
    the batch of the targets nor broadcast against one target: PoseFormer's
    backbone gives (B*F, h, w, K) per-frame maps against (B, h, w, K)
    targets, which JAX's loss broadcasts only at B = 1 (every frame toward
    the centre frame's pose) and fails on otherwise."""
    for key in ("target_heatmaps", "pose2d"):
        target = batch.get(key)
        if target is not None and target.shape[0] not in (1, heatmaps.shape[0]):
            raise ValueError(
                f"the model gives {heatmaps.shape[0]} maps against {target.shape[0]} {key} "
                "(ROADMAP C20: the JAX package's 2D train step trains the maps the model "
                "returns, which for pose_hrnet_transformer are its backbone's, one a frame; "
                "they broadcast against the targets only at one sequence a batch, and the "
                "refined pose enters no loss)")


def check_frame_targets(batch: Dict) -> None:
    """Raise ``ValueError`` (ROADMAP C23) when the 2D targets carry a frame
    axis: ``MHPSeqDataset`` (MHP_seq) folds its views into frames and gives
    (B, F*V, K, 2) poses and (B, F*V, h, w, K) maps, against which the JAX
    package's 2D step and Evaluator2D fail at every batch size (PoseAggr's
    (B, K, 2) decode meets them in the pose loss; PoseFormer already fails at
    init, its embedding built for len(SEQ_IDX) frames)."""
    pose2d = batch.get("pose2d")
    maps = batch.get("target_heatmaps", batch.get("heatmaps"))
    if (pose2d is not None and np.ndim(pose2d) == 4) or (maps is not None and np.ndim(maps) == 5):
        shape = tuple(np.shape(pose2d if pose2d is not None else maps))
        raise ValueError(
            f"2D targets of shape {shape} carry a frame axis (ROADMAP C23: MHP_seq folds views "
            "into frames, (B, F*V, ...), and the JAX package's 2D train step and Evaluator2D "
            "fail on them at every batch size; the 2D paths take one target per sample)")


def check_map_size(cfg, heatmaps: torch.Tensor, targets: Optional[torch.Tensor]) -> None:
    """Raise ``ValueError`` (ROADMAP C18) when the model's maps and the
    targets (or MODEL.HEATMAP_SIZE without targets) differ in size: a Swin
    of PATCH_SIZE 2 at 256 gives 128 x 128 maps against HEATMAP_SIZE 64, on
    which JAX's step fails in the heatmap loss (or, with the pose loss
    alone, compares coordinates of two scales).  Nothing is resized."""
    want = (tuple(targets.shape[1:3]) if targets is not None
            else (int(cfg.MODEL.HEATMAP_SIZE[1]), int(cfg.MODEL.HEATMAP_SIZE[0])))
    got = tuple(heatmaps.shape[1:3])
    if got != want:
        raise ValueError(f"{cfg.MODEL.NAME} gives {got[0]} x {got[1]} maps against "
                         f"{want[0]} x {want[1]} targets (ROADMAP C18: MODEL.IMAGE_SIZE / "
                         "MODEL.PATCH_SIZE must be MODEL.HEATMAP_SIZE for swin_transformer)")


def _check_cfg(cfg) -> None:
    if str(cfg.TPU.PARAM_DTYPE) != "float32":
        raise NotImplementedError(f"TPU.PARAM_DTYPE {cfg.TPU.PARAM_DTYPE!r}: the port trains "
                                  "float32 parameters only")


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
RMSPROP_DECAY = 0.9         # optax.rmsprop's default decay (torch.optim.RMSprop's alpha is 0.99)


def _increment(count: torch.Tensor) -> torch.Tensor:
    """optax's ``safe_increment``: +1, saturating at the int32 maximum."""
    return torch.where(count < _INT32_MAX, count + 1, count)


class Optimizer:
    """optax's ``adam``, ``adamw``, ``sgd`` and ``rmsprop`` on flat float32 buffers.

    State (a dict of tensors on the parameters' device), as optax keeps it:
    adam/adamw ``count`` (int32), ``mu``, ``nu``; sgd ``trace``; rmsprop
    ``nu``; every kind ``sched_count`` (int32), the LR schedule's own count.
    ``update`` is pure: it returns the updates and the new state, with the
    arithmetic in optax's order and float32 (so a state carried over from
    JAX continues the same trajectory).

    ``lr_scale`` (adam only), a float32 vector over the flat parameters,
    makes one adam of optax's ``multi_transform`` of adams whose schedules
    are the base one times a constant per group, with ``set_to_zero`` where
    the scale is 0: the update is ``-(sched(count) * scale) * u`` (each
    group's ``scale_by_learning_rate``), and the gradient of a 0-scale
    element is dropped before the moments, so its moments stay 0 as the
    frozen group keeps none and its update is 0.  rmsprop is optax's
    ``rmsprop`` (decay 0.9, eps 1e-8 inside the square root, nu from 0):
    ``nu = 0.1 g^2 + 0.9 nu``, ``u = g * rsqrt(nu + eps)``.
    """

    def __init__(self, kind: str, schedule: Callable, weight_decay: float = 0.0,
                 momentum: float = 0.9, nesterov: bool = False,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 lr_scale: Optional[torch.Tensor] = None):
        if kind not in ("adam", "adamw", "sgd", "rmsprop"):
            raise ValueError(f"unknown optimizer {kind!r}")
        if lr_scale is not None and kind != "adam":
            raise ValueError(f"lr_scale is for adam, not {kind!r}")
        self.kind = kind
        self.schedule = schedule
        self.weight_decay = float(weight_decay)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.lr_scale = None if lr_scale is None else lr_scale.to(torch.float32)

    def init(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        zero = torch.zeros((), dtype=torch.int32, device=params.device)
        if self.lr_scale is not None:
            if self.lr_scale.shape != params.shape:
                raise ValueError(f"lr_scale {tuple(self.lr_scale.shape)} for parameters "
                                 f"{tuple(params.shape)}")
            self.lr_scale = self.lr_scale.to(params.device)
        if self.kind == "sgd":
            return {"trace": torch.zeros_like(params), "sched_count": zero}
        if self.kind == "rmsprop":
            return {"nu": torch.zeros_like(params), "sched_count": zero}
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
        elif self.kind == "rmsprop":
            # optax.scale_by_rms (eps_in_sqrt): EMA of g^2, then g * rsqrt(nu + eps)
            nu = (1 - RMSPROP_DECAY) * (grads * grads) + RMSPROP_DECAY * state["nu"]
            u = torch.rsqrt(nu + self.eps) * grads
            new["nu"] = nu
        else:
            if self.lr_scale is not None:
                # the frozen group (scale 0) keeps no moments: its gradient is dropped
                grads = torch.where(self.lr_scale == 0, torch.zeros((), dtype=grads.dtype,
                                                                     device=grads.device), grads)
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
        if self.lr_scale is not None:
            lr = lr * self.lr_scale
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
        # a split model (tensor_parallel) holds its shards; names are the unsplit model's
        self.param_names = [tp.public_name(n) for n, _ in named]
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
        tensors (moments by parameter name), cloned to the CPU.  A split
        model's shards are gathered whole (a collective: every rank of the
        model group calls it)."""
        cpu = lambda d: {k: tp.gather_full(self.model, k, v).detach().cpu().clone()
                         for k, v in d.items()}
        shapes = self._param_shapes()
        opt = {}
        for key, val in self.opt_state.items():
            opt[key] = (cpu(_split(val, self.param_names, shapes)) if val.dim()
                        else val.detach().cpu().clone())
        buffers = dict(self.model.named_buffers())
        return {"step": self.step.detach().cpu().clone(),
                "params": cpu(_split(self.params, self.param_names, shapes)),
                "batch_stats": cpu({n: buffers[n] for n in self.stat_names + self.count_names}),
                "opt_state": opt}

    @torch.no_grad()
    def load_state_dict(self, payload: Dict) -> None:
        """Copy a ``state_dict()`` payload in place; raises on a key or shape
        that does not match this state (optimizer kind included).  A split
        model takes its shard of each whole leaf."""
        shapes = self._param_shapes()

        def fill(flat, names, shapes_, src, what):
            if set(src) != set(names):
                missing, extra = sorted(set(names) - set(src)), sorted(set(src) - set(names))
                raise KeyError(f"{what}: missing {missing[:5]}, unexpected {extra[:5]}")
            for name, view in _split(flat, names, shapes_).items():
                val = tp.local_slice(self.model, name, torch.as_tensor(src[name]))
                if tuple(val.shape) != tuple(view.shape):
                    raise ValueError(f"{what} {name}: want {tuple(view.shape)}, "
                                     f"got {tuple(src[name].shape)}")
                view.copy_(val)

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
    1 and bias 0, running mean 0 and variance 1, every temperature 1.  A
    module with its own ``init_train_weights(generator)`` makes its own:
    flax's default ``lecun_normal`` for CPM's convs, the fusion net's pair
    FCs, and the zoo's ``models.layers.LecunConv2d``, ``Dense`` and
    transposed convs (where the JAX module has no ``conv_init``), LayerNorm
    scale 1 and bias 0, Swin's ``truncated_normal(0.02)`` position biases,
    the RVT's ``uniform(1.0)`` keypoint tokens, PoseFormer's zero position
    embeddings and ``normal(0.02)`` frame weights, PoseAggr's
    ``normal(0.001)`` deform kernels.  Modules are visited parent first, so
    a module's own init touches only its own parameters."""
    gen = torch.Generator().manual_seed(int(seed))
    for mod in model.modules():
        if hasattr(mod, "init_train_weights"):
            mod.init_train_weights(gen)
        elif isinstance(mod, nn.Conv2d):
            mod.weight.copy_(torch.normal(0.0, 0.001, mod.weight.shape, generator=gen))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
            mod.num_batches_tracked.zero_()
    for mod in model.modules():
        if isinstance(getattr(mod, "trainable_temp", None), nn.Parameter):
            mod.trainable_temp.fill_(1.0)


def create_train_state(cfg, model: nn.Module, steps_per_epoch: int = 1000,
                       device="cuda") -> Tuple[TrainState, Optimizer]:
    """Initialise ``model`` (seed ``TPU.SEED``), move it to ``device`` in
    train mode, and build its optimizer and state.  Under a grid of ranks
    with a model axis (``distributed.init_grid``) every rank builds the
    whole model from the seed and keeps its model rank's shard of each
    split leaf (``state_shardings``)."""
    _check_cfg(cfg)
    refuse_unsupported(cfg, "train state")
    init_train_weights(model, int(cfg.TPU.SEED))
    model.to(device).train()
    size = distributed.model_size()
    if size > 1:
        from .mesh import param_shardings

        tp.shard_for_rank(model, param_shardings(size, model), distributed.model_rank(), size,
                          distributed.model_group())
    tx = make_optimizer(cfg, steps_per_epoch)
    return TrainState(model, tx), tx


def state_shardings(mesh, state: TrainState) -> Dict:
    """Where each part of ``state`` splits over the 'model' axis (the JAX
    package's ``state_shardings``): {"step": None, "params": {name: dim or
    None} (``mesh.param_shardings``), "batch_stats": {name: None},
    "opt_state": {key: the params' map for a moment shaped like the
    parameters, None for a count}}.  Moments follow their parameters by
    name, never by shape; the step counter and the BN statistics are
    replicated.  ``mesh`` is a ``Mesh`` or a model size."""
    from .mesh import param_shardings

    params = param_shardings(mesh, state.model)
    return {"step": None, "params": params,
            "batch_stats": {n: None for n in state.stat_names + state.count_names},
            "opt_state": {k: (dict(params) if v.dim() else None)
                          for k, v in state.opt_state.items()}}


# -- the guarded update and the steps --------------------------------------

@torch.no_grad()
def apply_guarded_update(cfg, tx: Optimizer, state: TrainState,
                         loss_dict: Dict[str, torch.Tensor],
                         stats_before: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Optimizer update from ``state.grads`` with the TPU.DETECT_ANOMALY guard.

    Guard (the reference trains under set_detect_anomaly(True),
    tools/train.py:335): the probe is the float32 sum of every gradient (of
    every rank's shards, under a model axis); when it is not finite the
    step is skipped whole -- parameters, optimizer state
    (counts included, so the LR schedule does not advance) and the BN
    statistics (``stats_before``, taken before the forward) stay
    bit-identical -- and ``loss_dict['nonfinite_grads']`` is 1 (else 0).
    ``state.step`` advances either way.
    """
    detect = bool(cfg.TPU.DETECT_ANOMALY)
    grads, params = state.grads, state.params
    if detect:
        finite = torch.isfinite(grads.sum(dtype=torch.float32))
        if distributed.model_size() > 1:
            # the ranks hold different shards: one skip decision for all
            bad = distributed.sum_((~finite).to(torch.float32).reshape(1))
            finite = bad[0] == 0
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

    batch: {'images': (B,H,W,3), or (B,T,H,W,3) frames for a temporal
    model, 'target_heatmaps': (B,h,w,K), 'pose2d': (B,K,2) in heatmap px,
    'visibility': (B,K)}, tensors on the model's device.  ``state.model``
    must be ``model``.  PoseFormer (``pose_hrnet_transformer``) trains as
    JAX's step does, its backbone's per-frame maps against the targets; maps
    that neither match the targets' batch nor meet one target raise
    (ROADMAP C20).  The losses are 0-d device
    tensors: the loss dict of ``LossComputer2D``, the temperature (softmax
    heads) and ``nonfinite_grads`` (with the guard).  Under a process group
    of several ranks the step is data-parallel (see the module docstring).
    """
    _check_cfg(cfg)
    refuse_unsupported(cfg, "train step")
    ranks = distributed.data_size()
    loss_computer = LossComputer2D(cfg, count_sum=count_sum(ranks))
    use_softmax = bool(cfg.MODEL.HEATMAP_SOFTMAX)
    detect = bool(cfg.TPU.DETECT_ANOMALY)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.model is not model:
            raise ValueError("the state belongs to another model")
        check_frame_targets(batch)
        model.train()
        images = batch["images"]
        # frames may give per-frame maps, refused after the forward (C20); the
        # BN statistics that forward moved are put back then
        frames = images.dim() == 5
        stats_before = ((state.stats.clone(), state.counts.clone()) if detect or frames
                        else None)
        with torch.enable_grad():
            with compute_autocast(cfg, images.device), global_batch_stats(ranks):
                out = model(images)
            try:
                check_map_batch(out.heatmaps, batch)
            except ValueError:
                state.stats.copy_(stats_before[0])
                state.counts.copy_(stats_before[1])
                raise
            check_map_size(cfg, out.heatmaps, batch.get("target_heatmaps"))
            pose2d_pred = decode_heatmaps(out.heatmaps, use_softmax)
            total, loss_dict = loss_computer(
                heatmaps_pred=out.heatmaps, heatmaps_gt=batch.get("target_heatmaps"),
                pose2d_pred=pose2d_pred, pose2d_gt=batch.get("pose2d"),
                visibility=batch.get("visibility"))
            state.grads.zero_()
            total.backward()
        loss_dict = reduce_step(ranks, state.grads, {k: v.detach() for k, v in loss_dict.items()})
        if out.temperature is not None:
            # a copy: the parameter itself changes in the update below
            loss_dict["temperature"] = out.temperature.detach().clone()
        return apply_guarded_update(cfg, tx, state, loss_dict, stats_before)

    return step


def global_losses(shares: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The data ranks' loss shares summed in one collective over the data
    group: the global losses."""
    total = distributed.sum_(torch.stack([v.float() for v in shares.values()]),
                             distributed.data_group())
    return dict(zip(shares, total.unbind()))


def broadcast_state(state: TrainState) -> None:
    """Data rank 0's parameters (its shards, under a model axis) and BN
    statistics on every rank of its data group; nothing for one process."""
    if distributed.data_size() > 1:
        group = distributed.data_group()
        src = distributed.group_rank0(group)
        for buf in (state.params, state.stats, state.counts):
            if buf.numel():
                distributed.broadcast_(buf, src, group)


def _over_data(fn: Callable) -> Callable:
    """``fn`` (a sum over the world) over this rank's data group instead;
    ``fn`` itself without a model axis, where the data group is the world."""
    group = distributed.data_group()
    return fn if group is None else (lambda x: fn(x, group))


def count_sum(ranks: int):
    """The loss denominators' sum over ``ranks`` data ranks
    (``distributed.sum_counts`` over the data group); None for one."""
    return _over_data(distributed.sum_counts) if ranks > 1 else None


def global_batch_stats(ranks: int):
    """A data-parallel forward's context over ``ranks`` data ranks: the BN
    statistics of the global batch (``synced_batch_stats`` over the data
    group, with this rank's place in the batch, its data rank); nothing for
    one."""
    if ranks > 1:
        return synced_batch_stats(_over_data(distributed.all_reduce_sum),
                                  rank=distributed.data_rank())
    return nullcontext()


def reduce_step(ranks: int, grads: torch.Tensor, shares: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """After a data-parallel backward over ``ranks`` data ranks: ``grads``
    summed over the data group in place (XLA's psum of the gradient) and
    the global losses of the ranks' ``shares``; the shares as they are for
    one data rank."""
    if ranks == 1:
        return shares
    distributed.sum_(grads, distributed.data_group())
    return global_losses(shares)


def make_train_multistep(cfg, model: nn.Module, tx: Optimizer) -> Callable:
    """K train steps per call: ``fn(state, batches) -> (state, losses)``.

    ``batches`` is a train-step batch dict whose every tensor carries a
    leading steps axis (K, B, ...); the K steps of ``make_train_step`` run
    in order (optimizer, BN statistics and the anomaly guard included), and
    each loss comes back stacked (K,) as a device tensor, with no host sync
    (the JAX package's ``lax.scan`` over its step).  Used by the Trainer
    when ``TPU.STEPS_PER_DISPATCH`` > 1.
    """
    step = make_train_step(cfg, model, tx)

    def multi(state: TrainState, batches: Dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        k = {v.shape[0] for v in batches.values()}
        if len(k) != 1:
            raise ValueError(f"batches disagree on the steps axis: {sorted(k)}")
        per_step = []
        for i in range(k.pop()):
            state, losses = step(state, {name: v[i] for name, v in batches.items()})
            per_step.append(losses)
        return state, {name: torch.stack([torch.as_tensor(l[name]) for l in per_step])
                       for name in per_step[0]}

    return multi


def make_cpm_eval_step(cfg, model: nn.Module) -> Callable:
    """CPM's eval step (reference function.py:639-644, JAX
    parallel/train_step.py:308-321): the last stage's belief map without the
    background channel, no flip TTA, decoded by ``decode_heatmaps`` with
    HEATMAP_SOFTMAX.  ``step(state, batch)`` reads 'images' and 'centermaps'."""
    use_softmax = bool(cfg.MODEL.HEATMAP_SOFTMAX)

    @torch.no_grad()
    def step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state belongs to another model")
        images = batch["images"]
        was_training = model.training
        model.eval()
        try:
            with compute_autocast(cfg, images.device):
                heatmaps = model(images, batch["centermaps"])[-1][..., 1:]
        finally:
            model.train(was_training)
        return {"heatmaps": heatmaps, "pose2d_pred": decode_heatmaps(heatmaps, use_softmax)}

    return step


def make_eval_step(cfg, model: nn.Module) -> Callable:
    """Eval step (reference core/function.py:681-701): the forward with the
    running BN statistics, optional flip-test TTA, and the decode.
    ``step(state, batch) -> {'heatmaps', 'pose2d_pred'}``.  CPM's is
    ``make_cpm_eval_step``.  Temporal models take (B, T, H, W, 3) frames;
    PoseFormer's heatmaps and poses are its backbone's per frame, (B*F, ...),
    as JAX's step returns them (ROADMAP C20).  With TEST.FLIP_TEST the images'
    axis 2 flips, as JAX's ``[:, :, ::-1, :]`` does: a frame's H for frames
    (C20; every shipped temporal YAML sets FLIP_TEST false).  The fusion net
    has none: the JAX step reads
    ``out.heatmaps``, which its ``MultiViewOutput`` lacks, so it fails when
    called; the port's step raises then too (ROADMAP C13)."""
    name = str(cfg.MODEL.NAME)
    if name == "CPM":
        return make_cpm_eval_step(cfg, model)
    if name == "multiview_pose_hrnet":
        def no_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
            raise NotImplementedError(
                "multiview_pose_hrnet has no eval step: the JAX package's make_eval_step reads "
                "out.heatmaps, which MultiViewOutput lacks (ROADMAP C13); train it with "
                "WITHOUT_EVAL")

        return no_step
    refuse_unsupported(cfg, "eval step")
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
    refuse_unsupported(cfg, "forward function")
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
