"""Device meshes for data- and tensor-parallel serving and evaluation in one process.

The counterpart of the JAX package's ``parallel/mesh.py:25-92``.  JAX runs
one SPMD program over a ``jax.sharding.Mesh``; here a ``Mesh`` is a list
of devices laid out along named axes, row-major over its shape, and a
data-parallel function runs each data row's share of the batch on that
row's replica of the weights:

    mesh = make_mesh()                                   # every visible card
    replicas = replicate(mesh, weights)                  # once, one a data row
    out = run_sharded(mesh, fn, replicas, images)        # fn(replica, chunk)

``shard_batch`` splits axis 0 over the 'data' axis (a batch that does not
divide raises ``ValueError``, as ``shard_map`` does): every device of a data
row gets the row's chunk, as JAX's ``P('data')`` places it.  ``gather``
joins the rows' results on the first device.  A device may appear more than
once (two replicas on one card: ``make_mesh(devices=["cuda:0",
"cuda:0"])``); the chunks then run one after the other on it.

A 'model' axis larger than 1 is JAX's tensor parallelism: ``param_shardings``
names the wide kernels that split their output channels over it (JAX's rule
on the JAX layout, read through the weight bridge), and
``parallel/tensor_parallel.row_replicas`` builds each data row's model with
shard j of every split weight on the row's model device j.  The split sums
nothing across shards in the forward, so it changes no number beyond the
convolution algorithms' own choice per shape.

Training across processes is ``parallel/distributed.py``'s, not a mesh's.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


class Mesh(NamedTuple):
    """Devices laid out along named axes, row-major over ``shape``."""

    devices: Tuple[torch.device, ...]
    axes: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def data_size(self) -> int:
        return self.size // self.model_size

    @property
    def model_size(self) -> int:
        return self.shape[self.axes.index("model")] if "model" in self.axes else 1

    def rows(self) -> List[Tuple[torch.device, ...]]:
        """The devices of each data row, in model order (other axes than
        'data' and 'model' are of size 1)."""
        m = self.model_size
        return [self.devices[i * m:(i + 1) * m] for i in range(self.data_size)]


def make_mesh(axes: Sequence[str] = ("data",), shape: Sequence[int] = (),
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device).

    ``shape`` pins the axis sizes; an empty shape puts every device on the
    first axis: ``make_mesh(("data", "model"), (4, 2), ["cpu"] * 8)`` is
    JAX's (4, 2) mesh.  Raises ``ValueError`` when the shape does not cover
    the devices, there is no 'data' axis, 'model' comes before 'data', or
    another axis is larger than 1."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("make_mesh: no CUDA device is visible; pass devices= "
                             "(e.g. ['cpu', 'cpu'])")
    devices = tuple(torch.device(d) for d in devices)
    devices = tuple(torch.device("cuda", torch.cuda.current_device())
                    if d.type == "cuda" and d.index is None else d for d in devices)
    axes = tuple(str(a) for a in axes)
    n = len(devices)
    if not shape:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    if "data" not in axes:
        raise ValueError(f"a mesh needs a 'data' axis, got {axes}")
    if "model" in axes and axes.index("model") < axes.index("data"):
        raise ValueError(f"the mesh lays devices data-major: put 'data' before 'model', "
                         f"got {axes}")
    other = [a for a, s in zip(axes, shape) if a not in ("data", "model") and s > 1]
    if other:
        raise ValueError(f"mesh axes {other} larger than 1: a mesh splits over 'data' and "
                         "'model' only")
    return Mesh(devices, axes, shape)


def replicated(mesh: Mesh) -> None:
    """A leaf on every device whole: no split dim (JAX's ``P()``)."""
    return None


def batch_sharding(mesh: Mesh) -> int:
    """Axis 0 split over the 'data' axis (JAX's ``P('data')``): the dim
    ``shard_batch`` splits."""
    return 0


def param_shardings(mesh, model: nn.Module, min_shard_dim: int = 256) -> Dict[str, Optional[int]]:
    """{parameter name: the dim it splits on over the 'model' axis, or None}.

    JAX's rule (its ``param_shardings``): a leaf of two dims or more whose
    last dim is at least ``min_shard_dim`` and divides by the model size
    splits that dim; every other leaf is replicated, and all are with a
    model size of 1.  The rule reads the JAX layout of each leaf and the
    port dim its last axis becomes off the weight bridge
    (``utils/weights.jax_last_axis``): dim 0 of a conv's or a Linear's
    weight, dim 1 of a transposed conv's, the last of a leaf the bridge
    keeps as it is (PoseAggr's HWIO deform kernels).  ``mesh`` is a
    ``Mesh`` or a model size."""
    from ..models.transformers import MultiHead
    from ..utils.weights import jax_last_axis
    from .tensor_parallel import info, public_name

    size = mesh.model_size if isinstance(mesh, Mesh) else int(mesh)
    tp = info(model)
    if tp is not None:
        if tp.plan.size != size:
            raise ValueError(f"the model is split over {tp.plan.size}, not {size}")
        return dict(tp.split)
    mods = dict(model.named_modules())
    out: Dict[str, Optional[int]] = {}
    for raw, param in model.named_parameters():
        name = public_name(raw)
        owner = name.rpartition(".")[0]
        parent = mods.get(owner.rpartition(".")[0]) if owner else None
        heads = parent.num_heads if isinstance(parent, MultiHead) else 0
        ndim, last, dim = jax_last_axis(name, param.shape, heads)
        split = size > 1 and ndim >= 2 and last >= min_shard_dim and last % size == 0
        if split and dim is None:
            raise NotImplementedError(
                f"{name}: JAX splits its last axis ({last}) over 'model', which the port's "
                "Linear folds into a wider dim (an attention head_dim of at least "
                f"{min_shard_dim})")
        out[name] = dim if split else None
    return out


def _to(tree, device: torch.device):
    """``tree`` on ``device``: tensors by ``.to``, modules copied unless
    already there; tuples (named ones too), lists and dicts walked; other
    values shared."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, nn.Module):
        param = next(tree.parameters(), None)
        if param is not None and param.device == device:
            return tree
        return copy.deepcopy(tree).to(device)
    if isinstance(tree, dict):
        return type(tree)((k, _to(v, device)) for k, v in tree.items())
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    if isinstance(tree, tuple):
        items = [_to(v, device) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        if type(tree) is tuple:
            return tuple(items)
        out = tuple.__new__(type(tree), items)          # a tuple subclass with attributes
        out.__dict__.update(tree.__dict__)
        return out
    return tree


def replicate(mesh: Mesh, tree) -> List:
    """One replica of ``tree`` per data row, on the row's first device (the
    same object where it already lives there).  A model with split weights
    takes ``parallel/tensor_parallel.row_replicas`` instead."""
    return [_to(tree, row[0]) for row in mesh.rows()]


def data_mesh(mesh: Mesh) -> Mesh:
    """The data-only mesh of ``mesh``'s rows' first devices: a path that
    replicates its weights over 'model' (JAX's ``shard_map`` with ``P()``
    weights) runs once a data row."""
    heads = tuple(row[0] for row in mesh.rows())
    return Mesh(heads, ("data",), (len(heads),))


def shard_batch(mesh: Mesh, batch) -> List:
    """Split ``batch`` (a tensor, or a dict of them; other values go whole
    to every shard) along axis 0 into one chunk per data row; every device
    of a row gets the row's chunk, on that device (JAX's ``P('data')``), so
    the list has one entry a mesh device, in the mesh's order.  Raises
    ``ValueError`` when the batch does not divide."""
    rows = mesh.rows()
    n = len(rows)

    def split(x):
        if not isinstance(x, torch.Tensor):
            return [x] * mesh.size
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not divide over the {n} devices "
                             "of the mesh's 'data' axis")
        per = x.shape[0] // n
        return [x[i * per:(i + 1) * per].to(d) for i, row in enumerate(rows) for d in row]

    if isinstance(batch, dict):
        parts = {k: split(v) for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(mesh.size)]
    return split(batch)


def row_chunks(mesh: Mesh, batch) -> List:
    """``shard_batch``'s chunk of each data row, on the row's first device."""
    return shard_batch(mesh, batch)[::mesh.model_size]


def gather(mesh: Mesh, parts: Sequence):
    """Concatenate the data rows' results along axis 0 on the first device;
    tuples are gathered element by element, and None stays None."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return tuple(gather(mesh, [p[i] for p in parts]) for i in range(len(first)))
    home = mesh.devices[0]
    return torch.cat([p.to(home) for p in parts])


def run_sharded(mesh: Mesh, fn: Callable, replicas: Sequence, *batched):
    """``fn(replica, *chunks)`` for each data row with its replica and its
    chunk of every ``batched`` tensor, on the row's first device, then
    ``gather``.  The calls are issued one row after the other; on distinct
    cards their kernels overlap."""
    chunks = [row_chunks(mesh, b) for b in batched]
    return gather(mesh, [fn(rep, *(c[i] for c in chunks)) for i, rep in enumerate(replicas)])


def check_home(mesh: Mesh, device) -> torch.device:
    """The mesh's first device, which must be of ``device``'s type: a
    mesh-sharded entry point gathers its results there."""
    device = torch.device(device)
    home = mesh.devices[0]
    if home.type != device.type or (device.index is not None and home != device):
        raise ValueError(f"the mesh's first device {home} is not the entry point's device "
                         f"{device}")
    return home
