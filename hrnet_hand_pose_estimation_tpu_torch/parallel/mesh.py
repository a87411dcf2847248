"""Device meshes for data-parallel serving and evaluation in one process.

The counterpart of the JAX package's ``parallel/mesh.py:25-92``.  JAX runs
one SPMD program over a ``jax.sharding.Mesh``; here a ``Mesh`` is a list
of devices laid out along named axes, and a data-parallel function runs
each device's share of the batch on that device's replica of the weights:

    mesh = make_mesh()                                   # every visible card
    replicas = replicate(mesh, weights)                  # once
    out = run_sharded(mesh, fn, replicas, images)        # fn(replica, chunk)

``shard_batch`` splits axis 0 over the 'data' axis (a batch that does not
divide raises ``ValueError``, as ``shard_map`` does), ``gather`` joins the
results on the first device.  A device may appear more than once (two
replicas on one card: ``make_mesh(devices=["cuda:0", "cuda:0"])``); the
chunks then run one after the other on it.  A 'model' axis larger than 1,
JAX's tensor parallelism of the wide head kernels (``param_shardings``,
which changes no number), is not ported (ROADMAP A11).

Training across processes is ``parallel/distributed.py``'s, not a mesh's.
"""

from __future__ import annotations

import copy
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

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


def make_mesh(axes: Sequence[str] = ("data",), shape: Sequence[int] = (),
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device).

    ``shape`` pins the axis sizes; an empty shape puts every device on the
    first axis.  Raises ``ValueError`` when the shape does not cover the
    devices or there is no 'data' axis, and ``NotImplementedError`` for a
    'model' axis larger than 1."""
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
    if "model" in axes and shape[axes.index("model")] > 1:
        raise NotImplementedError(
            f"a 'model' mesh axis of {shape[axes.index('model')]}: the JAX package's tensor "
            "parallelism of the wide head kernels is not ported (ROADMAP A11)")
    return Mesh(devices, axes, shape)


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
    """One replica of ``tree`` per mesh device (the same object where it
    already lives on that device)."""
    return [_to(tree, d) for d in mesh.devices]


def shard_batch(mesh: Mesh, batch) -> List:
    """Split ``batch`` (a tensor, or a dict of them; other values go whole
    to every shard) along axis 0 into one chunk per 'data' device, each on
    its device.  Raises ``ValueError`` when the batch does not divide."""
    devices = mesh.devices
    n = len(devices)

    def split(x):
        if not isinstance(x, torch.Tensor):
            return [x] * n
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not divide over the {n} devices "
                             "of the mesh's 'data' axis")
        per = x.shape[0] // n
        return [x[i * per:(i + 1) * per].to(d) for i, d in enumerate(devices)]

    if isinstance(batch, dict):
        parts = {k: split(v) for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return split(batch)


def gather(mesh: Mesh, parts: Sequence):
    """Concatenate per-device results along axis 0 on the first device;
    tuples are gathered element by element, and None stays None."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return tuple(gather(mesh, [p[i] for p in parts]) for i in range(len(first)))
    home = mesh.devices[0]
    return torch.cat([p.to(home) for p in parts])


def run_sharded(mesh: Mesh, fn: Callable, replicas: Sequence, *batched):
    """``fn(replica, *chunks)`` for each 'data' device with its replica and
    its chunk of every ``batched`` tensor, then ``gather``.  The calls are
    issued one device after the other; on distinct cards their kernels
    overlap."""
    chunks = [shard_batch(mesh, b) for b in batched]
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
