"""Loss scaling and compute-dtype casts (the reference's fp16 stack).

Port of the JAX package's ``parallel/precision.py`` (reference
lib/fp16_utils/: ``DynamicLossScaler``, loss_scaler.py:45-81;
``FP16_Optimizer``'s skipped step; ``network_to_half``), on dicts of
tensors.  The overflow decision stays on the device: nothing here reads a
value back to the host.  The port's own training needs none of it (bf16
compute under autocast, float32 parameters); it is kept for precision
experiments.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class LossScaleState(NamedTuple):
    scale: torch.Tensor            # float32, the current loss scale
    growth_counter: torch.Tensor   # int32, overflow-free steps in a row


class DynamicLossScaler:
    """Overflow backoff (reference loss_scaler.py:45-81): halve the scale
    on an overflow, double it after ``scale_window`` clean steps."""

    def __init__(self, init_scale: float = 2.0 ** 15, scale_factor: float = 2.0,
                 scale_window: int = 1000):
        self.init_scale = init_scale
        self.factor = scale_factor
        self.window = scale_window

    def init(self, device="cpu") -> LossScaleState:
        return LossScaleState(torch.tensor(self.init_scale, dtype=torch.float32, device=device),
                              torch.zeros((), dtype=torch.int32, device=device))

    def scale_loss(self, loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
        return loss * state.scale

    def unscale_and_update(self, grads: Tree, state: LossScaleState
                           ) -> Tuple[Tree, LossScaleState, torch.Tensor]:
        """Unscale the gradients, detect inf / nan, adjust the scale.
        Returns (grads, new state, overflow): a 0-d bool tensor, on which
        the caller skips the optimizer step (FP16_Optimizer)."""
        inv = 1.0 / state.scale
        grads = {k: g * inv for k, g in grads.items()}
        finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
        overflow = ~finite
        scale = torch.where(overflow, state.scale / self.factor, state.scale)
        counter = torch.where(overflow, torch.zeros_like(state.growth_counter),
                              state.growth_counter + 1)
        grow = counter >= self.window
        scale = torch.where(grow, scale * self.factor, scale)
        counter = torch.where(grow, torch.zeros_like(counter), counter)
        return grads, LossScaleState(scale, counter), overflow


def apply_updates_unless_overflow(params: Tree, updates: Tree, overflow: torch.Tensor) -> Tree:
    """``params + updates``, or ``params`` unchanged on an overflow
    (reference FP16_Optimizer.step)."""
    return {k: p + torch.where(overflow, torch.zeros_like(updates[k]), updates[k])
            for k, p in params.items()}


def cast_to_compute(tree: Tree, dtype: torch.dtype = torch.bfloat16) -> Tree:
    """network_to_half: floating tensors to the compute dtype, the rest as
    they are."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tree.items()}
