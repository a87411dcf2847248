"""Float32 products at full precision (the JAX package's ``Precision.HIGHEST``).

On a card, ``torch.backends.cuda.matmul.allow_tf32`` lets cuBLAS round
float32 operands to TF32 (10 mantissa bits).  The modules whose JAX
counterparts ask for ``precision=HIGHEST`` (the fusion net's aggregation,
the hamburger's matrix decomposition, the deformable conv) run their
products here with TF32 off, in the forward and in autograd's backward.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def no_tf32():
    """TF32 off for cuBLAS float32 matmuls and cuDNN float32 convs inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class _BatchedMatMul(torch.autograd.Function):
    """(B, n, k) @ (B, k, m) with TF32 off in both passes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with no_tf32():
            return torch.bmm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with no_tf32():
            if ctx.needs_input_grad[0]:
                ga = torch.bmm(g, b.transpose(1, 2))
            if ctx.needs_input_grad[1]:
                gb = torch.bmm(a.transpose(1, 2), g)
        return ga, gb


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched float32 product at full precision, differentiable."""
    return _BatchedMatMul.apply(a, b)
