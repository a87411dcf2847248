"""Inference-time BatchNorm folding over a port state dict.

Port of the JAX package's ``utils/fold_bn.py``: the eval-mode BN that
follows a conv is folded into the conv's kernel (and bias, where the conv
has one), and the BN becomes the identity plus the folded bias (weight 1,
running mean 0, running variance 1 - eps, bias ``bias - mean * inv``), so
an eval forward of the folded state equals the unfolded one.  Exact for
eval only; do not train the folded state.

Pairs are found by the reference names: ``<p>.conv<n>`` with ``<p>.bn<n>``
(the residual blocks, the HRNet stem) and ``<p>.<i>`` with ``<p>.<i+1>``
in a ``Sequential`` (``ConvBN``, the transitions and fuse layers, the heads,
V2V's blocks), where the first is a ``Conv2d`` or ``Conv3d`` whose output
channels are the BN's.  That covers every ConvBN the JAX package folds;
transposed convs (SimpleBaseline's and V2V's upsampling), whose weights are
(in, out, ...), are left as they are.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..models.layers import BN_EPS


def _partner(name: str) -> Optional[str]:
    """The reference name of the conv before the BN called ``name``."""
    parent, _, leaf = name.rpartition(".")
    prefix = f"{parent}." if parent else ""
    if leaf.startswith("bn") and leaf[2:].isdigit():
        return f"{prefix}conv{leaf[2:]}"
    if leaf.isdigit() and int(leaf) > 0:
        return f"{prefix}{int(leaf) - 1}"
    return None


def conv_bn_pairs(model: nn.Module) -> Dict[str, str]:
    """{BN module name: conv module name} of every conv-BN pair of ``model``."""
    modules = dict(model.named_modules())
    pairs = {}
    for name, mod in modules.items():
        if not isinstance(mod, nn.modules.batchnorm._BatchNorm):
            continue
        conv = modules.get(_partner(name) or "")
        if (isinstance(conv, (nn.Conv2d, nn.Conv3d))
                and conv.out_channels == mod.num_features):
            pairs[name] = _partner(name)
    return pairs


@torch.no_grad()
def fold_batchnorm(model: nn.Module, state: Optional[Mapping[str, torch.Tensor]] = None,
                   eps: float = BN_EPS) -> Dict[str, torch.Tensor]:
    """A folded copy of ``state`` (``model``'s own state dict by default),
    with the pairs of ``conv_bn_pairs(model)`` folded in float32."""
    state = {k: v.clone() for k, v in (state if state is not None
                                        else model.state_dict()).items()}
    for bn, conv in conv_bn_pairs(model).items():
        inv = state[f"{bn}.weight"].float() / torch.sqrt(state[f"{bn}.running_var"].float() + eps)
        shape: Tuple[int, ...] = (-1,) + (1,) * (state[f"{conv}.weight"].dim() - 1)
        state[f"{conv}.weight"] = state[f"{conv}.weight"].float() * inv.view(shape)
        if f"{conv}.bias" in state:
            state[f"{conv}.bias"] = state[f"{conv}.bias"].float() * inv
        state[f"{bn}.bias"] = state[f"{bn}.bias"].float() - state[f"{bn}.running_mean"].float() * inv
        state[f"{bn}.weight"] = torch.ones_like(state[f"{bn}.weight"])
        state[f"{bn}.running_mean"] = torch.zeros_like(state[f"{bn}.running_mean"])
        state[f"{bn}.running_var"] = torch.full_like(state[f"{bn}.running_var"], 1.0 - eps)
    return state
