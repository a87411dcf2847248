"""Shared CLI plumbing for the port's tools (port of the JAX package's
``tools/_common.py``): the common flags, the config, and the weights."""

from __future__ import annotations

import argparse
from typing import Dict

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
            state.pop("trainable_temp")
    model.load_state_dict(state)
    return state
