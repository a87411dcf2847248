"""Spatial softmax + soft-argmax decode on the card.

Port of the TPU kernel ``ops/pallas/decode_kernel.py::fused_softmax_decode``
of the JAX package (B4).  ``fused_softmax_decode`` launches
``csrc/softmax_decode.cu`` for tensors on the card and runs the plain
PyTorch twin ``softmax_decode_reference`` for tensors on the CPU.  Both map
(B, H, W, K) logits (float32 or bfloat16, NHWK as the model emits them) and
a temperature T to (B, K, 2) float32 ``[u, v]`` heatmap pixels:

    soft_argmax(spatial_softmax(logits, T))

The kernel reads the logits once in place and never writes the
probabilities; it divides once at the end, where the twin normalises the
probabilities first, so the two differ by float32 rounding (1e-4 px in the
checks).  ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from . import _build

MAX_JOINTS = 1024          # the kernel's limit on K (csrc/softmax_decode.cu kMaxK)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _validate(logits: torch.Tensor, temperature) -> None:
    if logits.dim() != 4:
        raise ValueError(f"logits must be (B, H, W, K), got {tuple(logits.shape)}")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if min(logits.shape) < 1:
        raise ValueError(f"logits must not be empty, got {tuple(logits.shape)}")
    if logits.shape[3] > MAX_JOINTS:
        raise ValueError(f"at most {MAX_JOINTS} joints, got {logits.shape[3]}")
    if isinstance(temperature, torch.Tensor):
        if temperature.numel() != 1:
            raise ValueError(f"temperature must be a scalar, got {tuple(temperature.shape)}")
        if temperature.device != logits.device:
            raise ValueError(f"temperature on {temperature.device}, logits on {logits.device}")


def softmax_decode_reference(logits: torch.Tensor, temperature: torch.Tensor | float = 1.0
                             ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: ``soft_argmax(spatial_softmax(logits, T))``
    as the JAX package's ``ops/decode.py`` computes it (the softmax's
    probabilities, then the two expectations)."""
    from ..decode import soft_argmax, spatial_softmax

    _validate(logits, temperature)
    if isinstance(temperature, torch.Tensor):
        temperature = temperature.reshape(()).float()
    return soft_argmax(spatial_softmax(logits, temperature))


def fused_softmax_decode(logits: torch.Tensor, temperature: torch.Tensor | float = 1.0
                         ) -> torch.Tensor:
    """(B, H, W, K) float32/bfloat16 logits and a scalar temperature (a float,
    or a one-element tensor on the logits' device, read there by the kernel
    without a host sync) -> (B, K, 2) float32 ``[u, v]``.

    CUDA tensors run the kernel (one launch) and CPU tensors the plain twin;
    any other device, dtype or shape raises.
    """
    _validate(logits, temperature)
    dev = logits.device
    if dev.type == "cpu":
        return softmax_decode_reference(logits, temperature)
    if dev.type != "cuda":
        raise ValueError(f"fused_softmax_decode runs on cuda or cpu, not {dev}")
    b, h, w, k = logits.shape
    logits = logits.contiguous()
    if isinstance(temperature, torch.Tensor):
        temp = temperature.reshape(()).to(torch.float32).contiguous()
        temp_ptr, temp_value = temp.data_ptr(), 0.0
    else:
        temp_ptr, temp_value = None, float(temperature)
    out = torch.empty((b, k, 2), dtype=torch.float32, device=dev)
    err = _build.lib().hrnet_fused_softmax_decode(
        logits.data_ptr(), temp_ptr, temp_value, out.data_ptr(), b, h, w, k,
        _DTYPES[logits.dtype], _build.stream_ptr(dev))
    _build.check(err, "hrnet_fused_softmax_decode")
    fused_softmax_decode.launches += 1
    return out


fused_softmax_decode.launches = 0
