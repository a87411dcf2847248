"""Tensor parallelism over the 'model' axis: JAX's output-channel split of the wide weights.

The JAX package splits every parameter leaf whose last dim (the output
channels of a flax kernel) is at least 256 and divides by the model axis
over that axis (``parallel/mesh.py:51-69``); XLA then computes each
output-channel shard where its weights live.  ``parallel/mesh.param_shardings``
names the same leaves on the port's parameters, and this module splits them
in two realisations of one rule:

- over a ``Mesh`` in one process (the evaluators): ``row_replicas`` gives
  each data row a copy of the model on the row's first device in which
  shard j of every split weight lives on the row's model device j.  A split
  module computes ``y_j = conv(x, W_j)`` on device j and concatenates the
  shards on the first device, where the rest of the net runs;
- across ranks (training, ``shard_for_rank``): a rank keeps only its shard.
  Before a split module the input passes ``_ToModel`` (identity forward,
  the input gradient summed over the model group in the backward: the sum
  over shards of ``W_j^T dy_j``); after it ``_FromModel`` all-gathers the
  shards along the channel dim (the backward keeps this rank's slice of
  the output gradient).

A split module is one of ``nn.Conv1d/2d/3d``, ``nn.ConvTranspose1d/2d/3d``
or ``nn.Linear`` (subclasses included), and keeps its name: its class is
swapped for a subclass whose forward splits, its ``weight`` holds the shard
and its bias stays whole (JAX replicates one-dim leaves) and is added after
the gather.  A grouped conv splits when the model size divides its groups
(each shard reads its groups' input channels).  Any other split leaf (the
fusion net's ``pair_fc``, PoseFormer's position embeddings, a grouped
transposed conv) is stored in shards and gathered before use, through a
``torch.nn.utils.parametrize`` parametrization: its parameter is then
named ``<module>.parametrizations.<leaf>.original``, and ``public_name``
gives back the leaf's name.

The forward sums nothing across shards, so a split net computes the
unsplit net's numbers up to the convolution algorithm chosen for half the
output channels; the backward's input gradient and the data-axis sums
change order.
"""

from __future__ import annotations

import copy
import re
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.conv import _ConvNd, _ConvTransposeNd
from torch.nn.utils import parametrize

_PARAMETRIZED = re.compile(r"(^|\.)parametrizations\.([^.]+)\.original$")


def public_name(raw: str) -> str:
    """A parameter's name as the unsplit model names it (a gathered leaf's
    ``parametrizations.<leaf>.original`` back to ``<leaf>``)."""
    return _PARAMETRIZED.sub(r"\1\2", raw)


# -- collectives over the model group ---------------------------------------

class _ToModel(torch.autograd.Function):
    """Before a split module: identity forward; the backward sums the
    shards' input gradients over the model group (in float32)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        total = grad.float().contiguous()
        dist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _FromModel(torch.autograd.Function):
    """After a split module: the shards all-gathered along ``dim`` over the
    model group; the backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, dim: int, group, rank: int, size: int) -> torch.Tensor:
        ctx.dim, ctx.rank, ctx.size = dim, rank, size
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        per = grad.shape[ctx.dim] // ctx.size
        return grad.narrow(ctx.dim, ctx.rank * per, per).contiguous(), None, None, None, None


def _gather(y: torch.Tensor, dim: int, plan: "RankPlan") -> torch.Tensor:
    return _FromModel.apply(y, dim, plan.group, plan.rank, plan.size)


# -- the plans: where the shards of a row live ------------------------------

class RankPlan:
    """This rank's place in its model group."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, int(rank), int(size)


class MeshPlan:
    """A data row's devices, model index j holding shard j."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = tuple(torch.device(d) for d in devices)
        self.size = len(self.devices)


class TPInfo:
    """What a split model remembers: {public name: split dim or None}, and
    its plan."""

    def __init__(self, split: Dict[str, Optional[int]], plan):
        self.split, self.plan = dict(split), plan


def info(model: nn.Module) -> Optional[TPInfo]:
    """The split of ``model`` (None for an unsplit model)."""
    return model.__dict__.get("_tp_info")


# -- split modules ----------------------------------------------------------

def _out_dim(mod: nn.Module) -> int:
    """The channel dim of the module's output."""
    return -1 if isinstance(mod, nn.Linear) else 1


def _weight_dim(mod: nn.Module) -> int:
    """The output-channel dim of the module's weight."""
    return 1 if isinstance(mod, _ConvTransposeNd) else 0


def _computes_split(mod: nn.Module, leaf: str, dim: int, size: int) -> bool:
    if leaf != "weight" or not isinstance(mod, (_ConvNd, nn.Linear)):
        return False
    if dim != _weight_dim(mod):
        return False
    if isinstance(mod, _ConvTransposeNd):
        return mod.groups == 1
    return isinstance(mod, nn.Linear) or mod.groups == 1 or mod.groups % size == 0


def _apply(mod: nn.Module, x: torch.Tensor, w: torch.Tensor, output_size=None) -> torch.Tensor:
    """The module's op on ``x`` with weight ``w`` and no bias (a shard's
    groups: the model size divides the module's)."""
    if isinstance(mod, nn.Linear):
        return F.linear(x, w)
    nsd = w.dim() - 2
    groups = (mod.groups if mod.groups == 1
              else mod.groups * w.shape[_weight_dim(mod)] // mod._tp_full)
    if isinstance(mod, _ConvTransposeNd):
        pad = mod._output_padding(x, output_size, mod.stride, mod.padding, mod.kernel_size, nsd,
                                  mod.dilation)
        fn = (F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d)[nsd - 1]
        return fn(x, w, None, mod.stride, mod.padding, pad, groups, mod.dilation)
    fn = (F.conv1d, F.conv2d, F.conv3d)[nsd - 1]
    padding = mod.padding
    if mod.padding_mode != "zeros":
        x = F.pad(x, mod._reversed_padding_repeated_twice, mode=mod.padding_mode)
        padding = 0
    return fn(x, w, None, mod.stride, padding, mod.dilation, groups)


def _add_bias(mod: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """The whole bias after the gather, in the output's dtype (flax adds
    its bias to the rounded conv)."""
    if mod.bias is None:
        return y
    b = mod.bias.to(y.dtype)
    if not isinstance(mod, nn.Linear):
        b = b.view((1, -1) + (1,) * (y.dim() - 2))
    return y + b


def _input_slice(mod: nn.Module, x: torch.Tensor, j: int, size: int) -> torch.Tensor:
    """Shard j's input channels: all of them, or its groups' for a grouped conv."""
    if isinstance(mod, nn.Linear) or mod.groups == 1:
        return x
    per = x.shape[1] // size
    return x.narrow(1, j * per, per)


class _Split:
    """Mixed in before a conv's or a Linear's class: its forward splits
    over the model axis by the module's plan (``_tp_plan``)."""

    def forward(self, x: torch.Tensor, output_size=None) -> torch.Tensor:
        plan = self._tp_plan
        if isinstance(plan, RankPlan):
            x = _input_slice(self, _ToModel.apply(x, plan.group), plan.rank, plan.size)
            y = _gather(_apply(self, x, self.weight, output_size), _out_dim(self), plan)
            return _add_bias(self, y)
        home = x.device
        outs = []
        for j, (dev, w) in enumerate(zip(plan.devices, [self.weight] + self._tp_shards)):
            xj = _input_slice(self, x if dev == home else x.to(dev), j, plan.size)
            outs.append(_apply(self, xj, w, output_size).to(home))
        return _add_bias(self, torch.cat(outs, _out_dim(self)))


_SPLIT_CLASSES: Dict[type, type] = {}


def _split_class(cls: type) -> type:
    if cls not in _SPLIT_CLASSES:
        _SPLIT_CLASSES[cls] = type(f"Split{cls.__name__}", (_Split, cls), {})
    return _SPLIT_CLASSES[cls]


def shards_of(model: nn.Module, name: str) -> List[torch.Tensor]:
    """The shards of split parameter ``name`` (public) of a row replica, in
    model order; a rank's model has its own only."""
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner)
    if isinstance(mod, _Split):
        return [mod.weight] + list(getattr(mod, "_tp_shards", []))
    p = mod.parametrizations[leaf]
    return [p.original] + list(getattr(p[0], "others", []))


# -- gathered leaves ---------------------------------------------------------

class _MeshGather(nn.Module):
    """A leaf stored in shards on a row's devices, joined on the first."""

    def __init__(self, dim: int, others: List[torch.Tensor]):
        super().__init__()
        self.dim, self.others = dim, others

    def forward(self, first: torch.Tensor) -> torch.Tensor:
        return torch.cat([first] + [o.to(first.device) for o in self.others], self.dim)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return full.narrow(self.dim, 0, full.shape[self.dim] // (len(self.others) + 1)).clone()


class _RankGather(nn.Module):
    """A leaf stored in shards over the model group, all-gathered (and its
    gradient sliced back) at every use."""

    def __init__(self, dim: int, plan: RankPlan):
        super().__init__()
        self.dim, self.plan = dim, plan

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return _gather(shard, self.dim, self.plan)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        per = full.shape[self.dim] // self.plan.size
        return full.narrow(self.dim, self.plan.rank * per, per).clone()


# -- splitting a model -------------------------------------------------------

def _split_model(model: nn.Module, split: Dict[str, Optional[int]], plan) -> nn.Module:
    """Split the leaves ``split`` names in place, under ``plan``."""
    size = plan.size
    for name, dim in split.items():
        if dim is None:
            continue
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        full = getattr(mod, leaf).detach()
        per = full.shape[dim] // size
        pieces = list(full.split(per, dim))
        if _computes_split(mod, leaf, dim, size):
            mod._tp_full = full.shape[dim]
            mod.__class__ = _split_class(type(mod))
            mod._tp_plan = plan
            if isinstance(plan, RankPlan):
                mod.weight = nn.Parameter(pieces[plan.rank].clone())
            else:
                mod.weight = nn.Parameter(pieces[0].clone())
                mod._tp_shards = [p.to(d) for p, d in zip(pieces[1:], plan.devices[1:])]
            continue
        if isinstance(plan, RankPlan):
            gather = _RankGather(dim, plan)
        else:
            gather = _MeshGather(dim, [p.to(d) for p, d in zip(pieces[1:], plan.devices[1:])])
        parametrize.register_parametrization(mod, leaf, gather, unsafe=True)
    model.__dict__["_tp_info"] = TPInfo(split, plan)
    return model


def shard_for_rank(model: nn.Module, split: Dict[str, Optional[int]], rank: int, size: int,
                   group) -> nn.Module:
    """Keep this model rank's shard of every leaf ``split`` names
    (``parallel/mesh.param_shardings``), in place: rank ``rank`` of a model
    group ``group`` of ``size`` ranks.  Every rank must hold the same full
    model first."""
    if size == 1:
        return model
    return _split_model(model, split, RankPlan(group, rank, size))


def row_replicas(mesh, model: nn.Module) -> List[nn.Module]:
    """One copy of ``model`` a data row of ``mesh``, on the row's first
    device, with shard j of every split leaf on the row's model device j
    (``model`` itself is left whole).  A mesh without a model axis gives
    ``parallel/mesh.replicate``'s replicas."""
    from .mesh import param_shardings, replicate

    if mesh.model_size == 1:
        return replicate(mesh, model)
    split = param_shardings(mesh, model)
    reps = []
    for row in mesh.rows():
        rep = copy.deepcopy(model).to(row[0])
        reps.append(_split_model(rep, split, MeshPlan(row)))
    return reps


def position_bytes(replica: nn.Module) -> List[int]:
    """The parameter bytes a row replica holds at each model position:
    position 0 has the whole leaves and shard 0, position j shard j."""
    tp = info(replica)
    size = tp.plan.size if tp is not None else 1
    out = [0] * size
    for raw, p in replica.named_parameters():
        out[0] += p.numel() * p.element_size()
    if tp is not None:
        for name, dim in tp.split.items():
            if dim is not None:
                for j, s in enumerate(shards_of(replica, name)[1:], start=1):
                    out[j] += s.numel() * s.element_size()
    return out


def gather_full(model: nn.Module, name: str, shard: torch.Tensor) -> torch.Tensor:
    """The whole leaf ``name`` from this rank's ``shard`` of it (a parameter
    or a moment shaped like it), gathered over the model group: a
    collective for a split leaf of a rank's model; ``shard`` itself
    otherwise."""
    tp = info(model)
    dim = tp.split.get(name) if tp is not None else None
    if dim is None or not isinstance(tp.plan, RankPlan):
        return shard
    with torch.no_grad():
        return _gather(shard.detach(), dim, tp.plan)


def local_slice(model: nn.Module, name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the whole leaf ``name`` (a parameter or a
    moment shaped like it); ``full`` itself where the leaf is not split."""
    tp = info(model)
    dim = tp.split.get(name) if tp is not None else None
    if dim is None or not isinstance(tp.plan, RankPlan) or full.dim() <= dim:
        return full
    per = full.shape[dim] // tp.plan.size
    return full.narrow(dim, tp.plan.rank * per, per)
