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

The decode is differentiable (``SoftmaxDecode``, a ``torch.autograd.Function``):
where autograd needs a gradient of the logits or of a tensor temperature,
the forward launch also writes each plane's softmax state (m, s), and the
backward launches the second kernel of ``csrc/softmax_decode.cu``, counted
in ``launches_bwd``; on the CPU the backward is its plain twin
``softmax_decode_backward_reference``.  The JAX package differentiates its
plain decode instead (its Pallas kernel has no VJP); the port's 3D nets
decode their training forward through the kernel, so the backward is a
kernel too.  A forward that needs no gradient launches exactly as before,
without the state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

MAX_JOINTS = 1024          # the kernel's limit on K (csrc/softmax_decode.cu kMaxK)
MAX_SPLITS = 8             # blocks per sample: the portable cluster size (kMaxSplit)
PIECE_BYTES = 32768        # a piece: logits and their pixels' (u, v) in shared memory
BWD_THREADS = 256          # the backward's block (csrc/softmax_decode.cu kBwdThreads)
BWD_MAX_BLOCKS = 1024      # its grid's cap (kBwdMaxBlocks)
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


def decode_bwd_blocks(n: int, itemsize: int) -> int:
    """The backward's grid for ``n`` logits: one 16-byte group per thread
    (8 bfloat16 or 4 float32), at most 1024 blocks, which then stride.  It
    depends on ``n`` only, so the dT partials are summed in the same order
    on any card."""
    groups = -(-n // (16 // itemsize))
    return max(1, min(BWD_MAX_BLOCKS, -(-groups // BWD_THREADS)))


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
    _validate(logits, temperature)
    return _plain(logits, temperature)


def _plain(logits: torch.Tensor, temperature) -> torch.Tensor:
    """``softmax_decode_reference`` without the checks, in float32 (float64
    for float64 logits, which ``gradcheck`` of the backward twin passes)."""
    b, h, w, k = logits.shape
    dt = torch.promote_types(logits.dtype, torch.float32)
    if isinstance(temperature, torch.Tensor):
        temperature = temperature.reshape(()).to(dt)
    p = torch.softmax((logits.to(dt) * temperature).reshape(b, h * w, k), dim=1)
    p = p.reshape(b, h, w, k)
    us = torch.arange(w, dtype=dt, device=p.device)
    vs = torch.arange(h, dtype=dt, device=p.device)
    return torch.stack([torch.einsum("bhwk,w->bk", p, us),
                        torch.einsum("bhwk,h->bk", p, vs)], dim=-1)


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


def softmax_decode_stats_reference(logits: torch.Tensor, temperature: torch.Tensor | float = 1.0
                                   ) -> torch.Tensor:
    """Each plane's softmax state (B, K, 2): m = max of T * logits over the
    H*W pixels and s = sum exp(T * logits - m), in float32 (float64 for
    float64 logits), as the forward launch writes it for the backward."""
    b, h, w, k = logits.shape
    dt = torch.promote_types(logits.dtype, torch.float32)
    if isinstance(temperature, torch.Tensor):
        temperature = temperature.reshape(()).to(dt)
    z = logits.to(dt).reshape(b, h * w, k) * temperature
    m = z.amax(dim=1)
    s = torch.exp(z - m[:, None]).sum(dim=1)
    return torch.stack([m, s], dim=-1)


def softmax_decode_backward_reference(logits: torch.Tensor, temperature: torch.Tensor | float,
                                      stats: torch.Tensor, grad: torch.Tensor):
    """The backward kernel's plain twin: with p = exp(T x - m) / s from the
    forward's state ``stats`` (B, K, 2), (E_u, E_v) the expectations of p and
    ``grad`` (B, K, 2) the upstream gradient of the decoded ``[u, v]``:

        g_z = p (g_u (u - E_u) + g_v (v - E_v)),  dx = T g_z,  dT = sum x g_z

    Returns (dx in the logits' dtype, dT a 0-d tensor).  In float32 (float64
    for float64 inputs, for ``gradcheck``)."""
    b, h, w, k = logits.shape
    dt = torch.promote_types(logits.dtype, torch.float32)
    x = logits.to(dt)
    if isinstance(temperature, torch.Tensor):
        temperature = temperature.reshape(()).to(dt)
    st = stats.to(dt)
    m, s = st[..., 0][:, None, None, :], st[..., 1][:, None, None, :]
    p = torch.exp(x * temperature - m) / s
    u = torch.arange(w, dtype=dt, device=x.device)[None, None, :, None]
    v = torch.arange(h, dtype=dt, device=x.device)[None, :, None, None]
    eu = (p * u).sum(dim=(1, 2))[:, None, None, :]
    ev = (p * v).sum(dim=(1, 2))[:, None, None, :]
    g = grad.to(dt)
    gz = p * (g[..., 0][:, None, None, :] * (u - eu) + g[..., 1][:, None, None, :] * (v - ev))
    return (temperature * gz).to(logits.dtype), (x * gz).sum()


def _launch_forward(logits: torch.Tensor, temperature, stats: torch.Tensor | None
                    ) -> torch.Tensor:
    b, h, w, k = logits.shape
    dev = logits.device
    temp_ptr, temp_value = _temp_arg(temperature)
    plan = decode_plan(b, h, w, k, logits.element_size())
    out = torch.empty((b, k, 2), dtype=torch.float32, device=dev)
    err = _build.lib().hrnet_fused_softmax_decode(
        logits.data_ptr(), temp_ptr, temp_value, out.data_ptr(),
        None if stats is None else stats.data_ptr(), b, h, w, k, _DTYPES[logits.dtype],
        plan.splits, plan.piece_px, plan.smem, _build.stream_ptr(dev))
    _build.check(err, "hrnet_fused_softmax_decode")
    fused_softmax_decode.launches += 1
    return out


def _temp_arg(temperature):
    """(device pointer or None, value) of the temperature for a launch."""
    if isinstance(temperature, torch.Tensor):
        return temperature.data_ptr(), 0.0
    return None, float(temperature)


def _launch_backward(logits, temperature, stats, coords, grad, want_dtemp: bool):
    b, h, w, k = logits.shape
    dev = logits.device
    temp_ptr, temp_value = _temp_arg(temperature)
    if logits.data_ptr() % 16:
        logits = logits.clone()             # the kernel reads 16-byte groups
    dx = torch.empty_like(logits)
    blocks = decode_bwd_blocks(logits.numel(), logits.element_size())
    dtemp = partials = counter = None
    if want_dtemp:
        dtemp = torch.empty((), dtype=torch.float32, device=dev)
        partials = torch.empty(blocks, dtype=torch.float32, device=dev)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.lib().hrnet_softmax_decode_bwd(
        logits.data_ptr(), temp_ptr, temp_value, stats.data_ptr(), coords.data_ptr(),
        grad.data_ptr(), dx.data_ptr(), ptr(partials), ptr(counter), ptr(dtemp), b, h, w, k,
        _DTYPES[logits.dtype], blocks, _build.stream_ptr(dev))
    _build.check(err, "hrnet_softmax_decode_bwd")
    fused_softmax_decode.launches_bwd += 1
    return dx, dtemp


class SoftmaxDecode(torch.autograd.Function):
    """``softmax_decode`` with its gradient: ``apply(logits, temp_tensor,
    temp_value)``, the temperature a one-element tensor (``temp_value``
    ignored) or None (``temp_value`` used).  On the card both passes
    launch the kernels; on the CPU both run the plain twins."""

    @staticmethod
    def forward(ctx, logits, temp_tensor, temp_value):
        temperature = temp_value if temp_tensor is None else temp_tensor.reshape(())
        if logits.device.type == "cuda":
            stats = torch.empty((logits.shape[0], logits.shape[3], 2), dtype=torch.float32,
                                device=logits.device)
            out = _launch_forward(logits, temperature, stats)
        else:
            out = _plain(logits, temperature)
            stats = softmax_decode_stats_reference(logits, temperature)
        ctx.save_for_backward(logits, temp_tensor, stats, out)
        ctx.temp_value = temp_value
        return out

    @staticmethod
    def backward(ctx, grad):
        logits, temp_tensor, stats, out = ctx.saved_tensors
        temperature = ctx.temp_value if temp_tensor is None else temp_tensor.reshape(())
        want_dtemp = temp_tensor is not None and ctx.needs_input_grad[1]
        grad = grad.to(stats.dtype).contiguous()
        if logits.device.type == "cuda":
            dx, dtemp = _launch_backward(logits, temperature, stats, out, grad, want_dtemp)
        else:
            dx, dtemp = softmax_decode_backward_reference(logits, temperature, stats, grad)
        if not ctx.needs_input_grad[0]:
            dx = None
        dtemp = dtemp.reshape(temp_tensor.shape).to(temp_tensor.dtype) if want_dtemp else None
        return dx, dtemp, None


def fused_softmax_decode(logits: torch.Tensor, temperature: torch.Tensor | float = 1.0
                         ) -> torch.Tensor:
    """(B, H, W, K) float32/bfloat16 logits and a scalar temperature (a float,
    or a one-element tensor on the logits' device, read there by the kernel
    without a host sync) -> (B, K, 2) float32 ``[u, v]``.

    CUDA tensors run the kernel (one launch, plan ``decode_plan``) and CPU
    tensors the plain twin; any other device, dtype or shape raises.  Where
    autograd wants a gradient of the logits or of the temperature tensor,
    the call goes through ``SoftmaxDecode``, whose backward is one launch of
    the backward kernel on the card (``launches_bwd``).
    """
    _validate(logits, temperature)
    dev = logits.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_softmax_decode runs on cuda or cpu, not {dev}")
    temp_tensor = None
    if isinstance(temperature, torch.Tensor):
        temp_tensor = temperature.reshape(()).to(torch.float32).contiguous()
    wants_grad = torch.is_grad_enabled() and (
        logits.requires_grad or (temp_tensor is not None and temp_tensor.requires_grad))
    if wants_grad:
        return SoftmaxDecode.apply(logits.contiguous(), temp_tensor,
                                   0.0 if temp_tensor is not None else float(temperature))
    if dev.type == "cpu":
        return softmax_decode_reference(logits, temperature)
    return _launch_forward(logits.contiguous(),
                           temperature if temp_tensor is None else temp_tensor, None)


fused_softmax_decode.launches = 0
fused_softmax_decode.launches_bwd = 0
