"""Spatial softmax + soft-argmax decode on the card.

Port of the TPU kernel ``ops/pallas/decode_kernel.py::fused_softmax_decode``
of the JAX package (B4).  ``fused_softmax_decode`` launches
``csrc/softmax_decode.cu`` for tensors on the card and runs the plain
PyTorch twin ``softmax_decode_reference`` for tensors on the CPU.  Both map
(B, H, W, K) logits (float32 or bfloat16, NHWK as the model emits them) and
a temperature T to (B, K, 2) float32 ``[u, v]`` heatmap pixels:

    soft_argmax(spatial_softmax(logits, T))

The kernel reads the logits once in place and never writes the
probabilities: it splits each sample's plane into ``decode_plan``'s S pixel
ranges, one block of a thread-block cluster each, and merges their softmax
states (max, sum e, sum e*u, sum e*v) with one rescale each before it
divides once.  ``softmax_decode_split_reference`` repeats that order of
operations in plain PyTorch.  The twin normalises the probabilities first,
so kernel and twin differ by float32 rounding (1e-4 px in the checks).
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

MAX_JOINTS = 1024          # the kernel's limit on K (csrc/softmax_decode.cu kMaxK)
MAX_SPLITS = 8             # blocks per sample: the portable cluster size (kMaxSplit)
PIECE_BYTES = 32768        # a piece: logits and their pixels' (u, v) in shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class DecodePlan(NamedTuple):
    """The one launch of ``csrc/softmax_decode.cu`` for one call."""

    splits: int            # S: blocks (one cluster) per sample, each a range of pixels
    range_px: int          # pixels per range: ceil(H*W / S), the last range shorter
    piece_px: int          # pixels a block reads into shared memory at once
    smem: int              # dynamic shared memory bytes


def decode_plan(b: int, h: int, w: int, k: int, itemsize: int) -> DecodePlan:
    """S = 8 ranges per plane (at most H*W): 256 blocks at B=32 and 1024 at
    B=128, which the card holds at once (8 blocks of 256 threads per SM),
    each a range of 512 pixels of a 64x64 plane, read in pieces of at most
    32 KB with the pixels' (u, v)."""
    hw = h * w
    splits = min(MAX_SPLITS, hw)
    piece = max(1, PIECE_BYTES // (k * itemsize + 8))       # logits and (u, v) of a pixel
    smem = -(-k * 16 // 128) * 128 + -(-piece * 8 // 16) * 16 + piece * k * itemsize + 16
    return DecodePlan(splits, -(-hw // splits), piece, smem)


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


def softmax_decode_split_reference(logits: torch.Tensor, temperature: torch.Tensor | float = 1.0,
                                   splits: int = 1, piece_px: int | None = None) -> torch.Tensor:
    """The kernel's order of operations in plain PyTorch, for the tests:
    each sample's H*W pixels split into ``splits`` ranges of ceil(H*W /
    splits) (the last shorter), each read in pieces of ``piece_px`` pixels;
    per piece and joint the max m, then sum e, sum e*u, sum e*v with e =
    exp(x - m) (0 for x = -inf), merged into the range's state by one
    rescale, the ranges merged in order the same way, one division.  In
    float64, so that a comparison shows the split's own error and not
    float32's; no path calls it."""
    _validate(logits, temperature)
    b, h, w, k = logits.shape
    hw = h * w
    if isinstance(temperature, torch.Tensor):
        temperature = temperature.reshape(()).float()
    x = logits.reshape(b, hw, k).double() * temperature
    p = torch.arange(hw, device=x.device)
    u, v = (p % w).double(), (p // w).double()
    rng = -(-hw // splits)
    piece_px = piece_px or rng

    def empty():
        inf = torch.full((b, k), -float("inf"), dtype=torch.float64, device=x.device)
        return [inf, torch.zeros_like(inf), torch.zeros_like(inf), torch.zeros_like(inf)]

    def merge(state, m, s, su, sv):
        skip = (m == -float("inf")) & (s == 0)
        grow = m > state[0]
        f = torch.where(grow, torch.exp(state[0] - m), torch.exp(m - state[0]))
        new = [torch.where(grow, m, state[0]),
               torch.where(grow, state[1] * f + s, state[1] + s * f),
               torch.where(grow, state[2] * f + su, state[2] + su * f),
               torch.where(grow, state[3] * f + sv, state[3] + sv * f)]
        return [torch.where(skip, old, n) for old, n in zip(state, new)]

    total = empty()
    for r0 in range(0, hw, rng):
        state = empty()
        for p0 in range(r0, min(hw, r0 + rng), piece_px):
            sl = slice(p0, min(hw, r0 + rng, p0 + piece_px))
            xs = x[:, sl]
            m = xs.amax(dim=1)
            e = torch.where(xs == -float("inf"), torch.zeros_like(xs), torch.exp(xs - m[:, None]))
            state = merge(state, m, e.sum(dim=1), (e * u[sl, None]).sum(dim=1),
                          (e * v[sl, None]).sum(dim=1))
        total = merge(total, *state)
    return torch.stack([total[2] / total[1], total[3] / total[1]], dim=-1)


def fused_softmax_decode(logits: torch.Tensor, temperature: torch.Tensor | float = 1.0
                         ) -> torch.Tensor:
    """(B, H, W, K) float32/bfloat16 logits and a scalar temperature (a float,
    or a one-element tensor on the logits' device, read there by the kernel
    without a host sync) -> (B, K, 2) float32 ``[u, v]``.

    CUDA tensors run the kernel (one launch, plan ``decode_plan``) and CPU
    tensors the plain twin; any other device, dtype or shape raises.
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
    plan = decode_plan(b, h, w, k, logits.element_size())
    out = torch.empty((b, k, 2), dtype=torch.float32, device=dev)
    err = _build.lib().hrnet_fused_softmax_decode(
        logits.data_ptr(), temp_ptr, temp_value, out.data_ptr(), b, h, w, k,
        _DTYPES[logits.dtype], plan.splits, plan.piece_px, plan.smem, _build.stream_ptr(dev))
    _build.check(err, "hrnet_fused_softmax_decode")
    fused_softmax_decode.launches += 1
    return out


fused_softmax_decode.launches = 0
