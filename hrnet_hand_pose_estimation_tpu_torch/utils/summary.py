"""Model summaries: parameter counts and conv FLOPs.

Port of the JAX package's ``utils/summary.py`` (reference
lib/utils/utils.py:117-233).  The JAX package takes FLOPs from XLA's cost
analysis of the compiled forward; the port counts the convolutions' products
(2 FLOPs per multiply-add) from their output shapes in one forward, as
``chip_smoke.conv_flops`` does.
"""

from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn


def count_params(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Elements of a module's parameters, or of every tensor of a state dict."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params.values()
    return sum(int(p.numel()) for p in tensors)


@torch.no_grad()
def model_summary(model: nn.Module, cfg, batch: int = 1) -> str:
    """One line: parameters (in millions) at the input size, and the conv
    GFLOPs of a forward of ``batch`` images on the model's device (eval
    mode, so no BN statistic moves).  A model with ``example_inputs(batch,
    h, w, device)`` (CPM, the fusion net) is given those inputs."""
    h, w = int(cfg.MODEL.IMAGE_SIZE[1]), int(cfg.MODEL.IMAGE_SIZE[0])
    n_params = count_params(model)
    line = f"Model {type(model).__name__}: {n_params / 1e6:.2f}M params @ {h}x{w}"
    total = [0]

    def hook(mod, inp, out):
        total[0] += 2 * out.numel() * (mod.weight.shape[1] * mod.weight.shape[2]
                                       * mod.weight.shape[3])

    convs = [m for m in model.modules() if isinstance(m, nn.Conv2d)]
    if not convs:
        return line
    device = convs[0].weight.device
    handles = [m.register_forward_hook(hook) for m in convs]
    was_training = model.training
    model.eval()
    try:
        inputs = (model.example_inputs(batch, h, w, device) if hasattr(model, "example_inputs")
                  else (torch.zeros((batch, h, w, 3), dtype=torch.float32, device=device),))
        model(*inputs)
    finally:
        model.train(was_training)
        for handle in handles:
            handle.remove()
    return line + f", {total[0] / 1e9:.2f} GFLOPs/batch (conv products)"
