"""Shared CLI plumbing for the port's tools (port of the JAX package's
``tools/_common.py``): the common flags, the config, the weights, and the
process group of a data-parallel training tool."""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch


def base_parser(description: str) -> argparse.ArgumentParser:
    """Common flags mirroring the reference tools (tools/train.py:57-92);
    the JAX tools' ``--platform ''|cpu|tpu`` is ``--device cuda|cpu`` here."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg", required=True, help="experiment YAML")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="dotted config overrides: KEY VALUE [KEY VALUE ...]")
    p.add_argument("--model_path", default="", help="checkpoint to load")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (cpu for smoke runs)")
    p.add_argument("--batch_size", type=int, default=0)
    return p


def load_cfg(args):
    from ..config import load_config

    return load_config(args.cfg, opts=args.opts)


def load_weights(cfg, model, model_path: str = "", device="cpu") -> Dict[str, torch.Tensor]:
    """The flat state_dict the tools run on: ``model_path`` (a port snapshot
    or checkpoint, or a reference ``.pth``) through
    ``parallel/checkpoint.load_pretrained``, else seeded random weights
    (``utils/weights.init_variables(cfg, 0)``, the smoke mode), without the
    temperature for a plain head.  Loaded into ``model`` strictly."""
    from ..parallel.checkpoint import join_state_dict, load_pretrained
    from ..utils.weights import init_variables

    if model_path:
        state = join_state_dict(load_pretrained(model_path))
    else:
        state = init_variables(cfg, 0, device=device)
        if getattr(model, "head", None) == "plain":
            state.pop("trainable_temp", None)
    model.load_state_dict(state)
    return state


def tool_mesh(cfg, device="cuda"):
    """The mesh of ``TPU.MESH_AXES`` / ``MESH_SHAPE`` (the JAX tools'
    ``make_mesh``: ``[data, model]`` / ``[4, 2]`` splits the batch over four
    data rows and the wide weights over two model devices a row), over every
    visible card for ``device`` 'cuda' and over ``device`` alone otherwise;
    None for a mesh of one device.  A shape that does not cover the devices
    raises ``ValueError``.  On one named device (the CPU, 'cuda:0') a shape
    puts that many mesh positions on it, as JAX's host devices do on the
    CPU: ``--device cpu TPU.MESH_AXES "['data', 'model']" TPU.MESH_SHAPE
    "[4, 2]"``."""
    from ..parallel.mesh import make_mesh

    device = torch.device(device)
    shape = tuple(int(s) for s in cfg.TPU.MESH_SHAPE)
    devices = (None if device.type == "cuda" and device.index is None
               else [device] * max(int(np.prod(shape)), 1))
    mesh = make_mesh(tuple(cfg.TPU.MESH_AXES), shape, devices)
    return None if mesh.size == 1 else mesh


def add_dist_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """``--dist_backend`` of the training tools."""
    p.add_argument("--dist_backend", default="nccl", choices=["nccl", "gloo"],
                   help="process-group backend when launched by torchrun")
    return p


def start_ranks(args) -> torch.device:
    """The device of this process.  Launched by torchrun (``WORLD_SIZE`` in
    the environment, 1 included): this rank's card (``LOCAL_RANK``, made
    current) or the CPU, and the default process group joined with
    ``args.dist_backend`` (nccl for ranks on cards; gloo for ranks on the
    CPU, or asked for); the caller ends it with
    ``parallel.distributed.destroy_process_group``."""
    from ..parallel import distributed

    device = torch.device(args.device)
    if "WORLD_SIZE" in os.environ:
        if args.dist_backend == "nccl" and device.type != "cuda":
            raise ValueError("--dist_backend nccl runs ranks on cards; with --device cpu pass "
                             "--dist_backend gloo")
        device = distributed.local_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        distributed.init_process_group(args.dist_backend)
    return device
