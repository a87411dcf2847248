"""Process groups for data-parallel training, one process per GPU.

The JAX package trains one SPMD program over a mesh of every local device
(``core/trainer.py:65``), with XLA inserting the cross-device sums; a
multi-host run starts one JAX process per host.  Here each rank plays the
part of one JAX process: it reads its contiguous slice of the global
batch order (``data/pipeline.host_local_slice``), and the train step sums
what XLA sums -- the BN batch statistics (``models/layers.synced_batch_stats``),
the loss denominators (``sum_counts``) and the gradients (one
``all_reduce`` of the flat gradient buffer) -- so every rank takes JAX's
step on the global batch.

    init_process_group("nccl")          # torchrun's RANK / WORLD_SIZE / MASTER_*
    init_process_group("gloo", rank=r, world_size=2, init_method="tcp://localhost:29500")

The backend is always the caller's: 'nccl' for ranks on CUDA devices,
'gloo' where the caller asks for it (ranks on the CPU, or ranks sharing
one card).  Without a process group, ``world_size()`` is 1 and nothing
here communicates.

A grid of data x model ranks (``init_grid``, from ``TPU.MESH_AXES`` /
``MESH_SHAPE``) lays the ranks out data-major, as JAX's row-major
``Mesh``: rank r is data rank ``r // model_size()`` and model rank
``r % model_size()``.  The ranks of one model index form a data group (they
read different rows and sum their gradients and statistics), the ranks of
one data index a model group (they read the same rows and hold the shards
of the split weights, ``parallel/tensor_parallel.py``).  Without a grid
every rank is a data rank and the data group is the world.

    init_process_group("gloo", rank=r, world_size=4, init_method=...)
    init_grid(("data", "model"), (2, 2))
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def init_process_group(backend: str, rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None) -> None:
    """Join the default process group with ``backend`` ('nccl' or 'gloo').
    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``, ``init_method`` to 'env://' (``MASTER_ADDR`` /
    ``MASTER_PORT``); a missing value raises ``ValueError``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
    if rank is None or world_size is None:
        missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
        if missing:
            raise ValueError(f"init_process_group: pass rank and world_size, or launch with "
                             f"torchrun (no {', '.join(missing)} in the environment)")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            rank=int(rank), world_size=int(world_size))


def destroy_process_group() -> None:
    _GRID.clear()
    if is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if is_initialized() else 0


# the grid of the process group (``init_grid``); empty: every rank a data rank
_GRID: Dict[str, object] = {}


def grid_shape(axes: Sequence[str] = ("data",), shape: Sequence[int] = (),
               world: Optional[int] = None) -> Tuple[int, int]:
    """(data size, model size) of ``TPU.MESH_AXES`` / ``MESH_SHAPE`` over
    ``world`` ranks (the process group's by default): an empty shape puts
    every rank on the first axis.  Raises ``ValueError`` when the shape does
    not cover the world, or names an axis other than 'data' and 'model'."""
    world = world_size() if world is None else int(world)
    axes = tuple(str(a) for a in axes)
    shape = tuple(int(s) for s in shape) or (world,) + (1,) * (len(axes) - 1)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    if "data" not in axes or set(axes) - {"data", "model"}:
        raise ValueError(f"a grid of ranks takes the axes 'data' and 'model', got {axes}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not cover the {world} ranks of the world")
    if "model" in axes and axes.index("model") < axes.index("data"):
        raise ValueError(f"the grid lays ranks data-major: put 'data' before 'model', got {axes}")
    sizes = dict(zip(axes, shape))
    return sizes["data"], sizes.get("model", 1)


def init_grid(axes: Sequence[str] = ("data",), shape: Sequence[int] = ()) -> Tuple[int, int]:
    """Lay the process group's ranks out as a data x model grid
    (``grid_shape``) and build its groups; every rank calls it, with the
    same arguments.  Returns (data size, model size)."""
    data, model = grid_shape(axes, shape)
    if (data, model) == (data_size(), model_size()):
        return data, model
    _GRID.clear()
    if model > 1:
        me = rank()
        data_groups = [dist.new_group([i * model + j for i in range(data)])
                       for j in range(model)]
        model_groups = [dist.new_group([i * model + j for j in range(model)])
                        for i in range(data)]
        _GRID.update(data=data, model=model, data_group=data_groups[me % model],
                     model_group=model_groups[me // model])
    return data, model


def model_size() -> int:
    """Ranks of a model group: the model axis; 1 without a grid."""
    return int(_GRID.get("model", 1))


def data_size() -> int:
    """Ranks of a data group: the data axis; the world without a grid."""
    return world_size() // model_size()


def model_rank() -> int:
    """This rank's index on the model axis."""
    return rank() % model_size()


def data_rank() -> int:
    """This rank's index on the data axis: its slice of the global batch."""
    return rank() // model_size()


def data_group():
    """The ranks of this rank's model index (None: the world)."""
    return _GRID.get("data_group")


def model_group():
    """The ranks of this rank's data index (None without a model axis)."""
    return _GRID.get("model_group")


def group_rank0(group) -> int:
    """The global rank of ``group``'s first rank (0 for the world)."""
    return 0 if group is None else dist.get_global_rank(group, 0)


def local_device(device="cuda") -> torch.device:
    """The device of this rank: 'cuda' is this rank's card, torchrun's
    ``LOCAL_RANK`` (0 without it); any other device as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group``, forward and backward: each rank's
    loss reaches every rank's input through the sum, so the input's
    gradient is the sum of the ranks' gradients of the output."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group=None) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (the world by default),
    differentiable (``_AllReduceSum``)."""
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def sum_counts(count: torch.Tensor, group=None) -> torch.Tensor:
    """A count (a loss denominator) summed over the ranks of ``group``, out
    of the graph."""
    out = count.detach().clone()
    dist.all_reduce(out, group=group)
    return out


@torch.no_grad()
def sum_(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` over the ranks of ``group`` in place (the gradients,
    the losses)."""
    dist.all_reduce(tensor, group=group)
    return tensor


@torch.no_grad()
def broadcast_(tensor: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Global rank ``src``'s ``tensor`` on every rank of ``group``, in place."""
    dist.broadcast(tensor, src, group=group)
    return tensor
