"""Model summaries: parameter counts and FLOPs.

Port of the JAX package's ``utils/summary.py`` (reference
lib/utils/utils.py:117-233).  The JAX package asks XLA's cost analysis of
the compiled forward for its FLOPs; the port counts one forward with
``utils/profiling.flops_of`` (torch's FLOP counter: every matmul and
convolution of the graph, 2 FLOPs per multiply-add).
"""

from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn

from .profiling import flops_of


def count_params(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Elements of a module's parameters, or of every tensor of a state dict."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params.values()
    return sum(int(p.numel()) for p in tensors)


@torch.no_grad()
def model_summary(model: nn.Module, cfg, batch: int = 1) -> str:
    """One line: parameters (in millions) at the input size, and the GFLOPs
    of a forward of ``batch`` images on the model's device (eval mode, so no
    BN statistic moves).  A model with ``example_inputs(batch, h, w,
    device)`` (CPM, the fusion net) is given those inputs."""
    h, w = int(cfg.MODEL.IMAGE_SIZE[1]), int(cfg.MODEL.IMAGE_SIZE[0])
    n_params = count_params(model)
    line = f"Model {type(model).__name__}: {n_params / 1e6:.2f}M params @ {h}x{w}"
    first = next(model.parameters(), None)
    if first is None:
        return line
    device = first.device
    was_training = model.training
    model.eval()
    try:
        inputs = (model.example_inputs(batch, h, w, device) if hasattr(model, "example_inputs")
                  else (torch.zeros((batch, h, w, 3), dtype=torch.float32, device=device),))
        flops = flops_of(model, *inputs)
    finally:
        model.train(was_training)
    return line + f", {flops / 1e9:.2f} GFLOPs/batch (torch FLOP counter)"
