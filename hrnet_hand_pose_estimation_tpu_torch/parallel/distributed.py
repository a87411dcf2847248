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
"""

from __future__ import annotations

import os
from typing import Optional

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


def local_device(device="cuda") -> torch.device:
    """The device of this rank: 'cuda' is this rank's card, torchrun's
    ``LOCAL_RANK`` (0 without it); any other device as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, forward and backward: each rank's loss reaches
    every rank's input through the sum, so the input's gradient is the sum
    of the ranks' gradients of the output."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (``_AllReduceSum``)."""
    return _AllReduceSum.apply(x)


@torch.no_grad()
def sum_counts(count: torch.Tensor) -> torch.Tensor:
    """A count (a loss denominator) summed over the ranks, out of the graph."""
    out = count.detach().clone()
    dist.all_reduce(out)
    return out


@torch.no_grad()
def sum_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the ranks in place (the gradients, the losses)."""
    dist.all_reduce(tensor)
    return tensor


@torch.no_grad()
def broadcast_(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` on every rank, in place."""
    dist.broadcast(tensor, src)
    return tensor
