"""HRNet's W8A8 block chains: layer1's bottleneck chain and a stage branch's
BasicBlock chain.

Ports of the TPU kernels ``ops/pallas/int8_chain.py::fused_bottleneck_chain_int8``
and ``::fused_basic_chain_int8`` of the JAX package.  Each wrapper launches its
CUDA kernel once per block for a tensor on the card (``csrc/int8_chain.cu``,
``csrc/basic_int8.cu``) and runs its plain PyTorch twin for a tensor on the
CPU.  A bottleneck computes, per block (the JAX package's
``_bottleneck_int8_body``),

    xq  = clip(round(x * inv1))
    t1  = clip(round(relu(float(xq @ kq1) * a1 + c1)))
    t2  = clip(round(relu(float(conv3x3(t1) @ kq2) * a2 + c2)))
    y   = bf16(relu(float(t2 @ kq3) * a3 + c3 + shortcut))

with the shortcut ``float(xq @ kqs) * as_ + cs`` on block 0 and the block's
bf16 input in f32 on the others.  A BasicBlock (``_basic_int8_body``) computes

    xq  = clip(round(x * inv1))
    t   = clip(round(relu(float(conv3x3(xq) @ kq1) * a1 + c1)))
    y   = bf16(relu(float(conv3x3(t) @ kq2) * a2 + c2 + float(x)))

with zero padding on xq and on t.  Rounding is half to even, the clip
+-127, every ``acc * a + c`` rounds the product and then the sum, and the
integer sums are exact (the twins sum in float64).

``prepare_layer1_int8`` and ``prepare_branch_int8`` fold and quantize a
PoseHRNet state_dict with a calibration record into the JAX package's flat
layouts.  layer1, per block: inv1 (1, 1) f32, kq1 (Cin, Cm) int8, a1, c1
(Cm,) f32, kq2 (9 Cm, Cm) int8 (rows ky, kx, ci), a2, c2, kq3 (Cm, Cout)
int8, a3, c3 (Cout,) f32, and for a projection shortcut kqs (Cin, Cout)
int8, as_, cs.  A branch, per block: inv1 (1, 1), kq1 (9C, C) int8, a1, c1
(C,), kq2 (9C, C) int8, a2, c2 (C,).
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

_BOT_NAMES = ("inv1", "kq1", "a1", "c1", "kq2", "a2", "c2", "kq3", "a3", "c3")
_SC_NAMES = ("kqs", "as_", "cs")


def _quantized(state: Mapping[str, torch.Tensor], conv: str, bn: str):
    """(kq, wscale, bias) of a BN-folded conv of a state_dict, kq int8 in the
    JAX package's (Cin, Cout) or (3*3*Cin, Cout) layout (rows ky, kx, ci)."""
    from ...core.quant_infer import fold_site, quantize_weight

    kernel, bias = fold_site(state, conv, bn)
    kq, wscale = quantize_weight(kernel)                   # OIHW, scales per O
    kq = kq.transpose(2, 3, 1, 0)                          # -> HWIO
    return kq.reshape(-1, kq.shape[-1]), wscale, bias


def prepare_layer1_int8(state: Mapping[str, torch.Tensor], amax: Mapping[str, float],
                        prefix: str = "layer1"
                        ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[bool, ...]]:
    """Fold + quantize the bottleneck chain at ``prefix`` of a PoseHRNet
    state_dict into the kernel's flat layout: (params_flat, shortcut_flags).

    ``amax`` holds the calibration records of the ``layer1/block{b}/cb*``
    sites.  The scales are folded in the JAX package's order and types
    (float32 numpy arithmetic on the float64 site scales), so the flat
    params equal ``prepare_layer1_int8`` of the JAX package.
    """
    from ...core.quant_infer import site_scale

    flat, flags = [], []
    b = 0
    dev = state[f"{prefix}.0.conv1.weight"].device
    while f"{prefix}.{b}.conv1.weight" in state:
        blk = f"{prefix}.{b}"
        sa1, sa2, sa3 = (site_scale(amax, f"layer1/block{b}/cb{n}") for n in (1, 2, 3))
        kq1, ws1, b1 = _quantized(state, f"{blk}.conv1", f"{blk}.bn1")
        kq2, ws2, b2 = _quantized(state, f"{blk}.conv2", f"{blk}.bn2")
        kq3, ws3, b3 = _quantized(state, f"{blk}.conv3", f"{blk}.bn3")
        arrays = [
            np.full((1, 1), 1.0 / sa1, np.float32),       # inv1
            kq1, sa1 * ws1 / sa2, b1 / sa2,               # a1, c1
            kq2, sa2 * ws2 / sa3, b2 / sa3,               # a2, c2
            kq3, sa3 * ws3, b3,                           # a3, c3
        ]
        has_sc = f"{blk}.downsample.0.weight" in state
        if has_sc:
            kqs, wss, bs = _quantized(state, f"{blk}.downsample.0", f"{blk}.downsample.1")
            # the projection shares the block input, so cb1's scale sa1
            arrays += [kqs, sa1 * wss, bs]
        flat += [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        flags.append(has_sc)
        b += 1
    if not flags:
        raise KeyError(f"no bottleneck blocks under {prefix!r}")
    return tuple(flat), tuple(flags)


def prepare_branch_int8(state: Mapping[str, torch.Tensor], amax: Mapping[str, float],
                        mod: str, branch: int, n_blocks: int) -> Tuple[torch.Tensor, ...]:
    """Fold + quantize one stage branch chain of a PoseHRNet state_dict into
    ``fused_basic_chain_int8``'s flat layout, 7 tensors per block.

    ``mod`` and the calibration sites are the JAX package's names
    (``stage3_m1``; ``{mod}/branch{branch}/block{b}/cb{1,2}``), mapped to the
    port's modules by ``core/quant_infer.site_modules``.  The scales fold in
    the JAX package's order and types, as in ``prepare_layer1_int8``.
    """
    from ...core.quant_infer import site_modules, site_scale

    dev = state[site_modules(f"{mod}/branch{branch}/block0/cb1")[0] + ".weight"].device
    flat = []
    for b in range(n_blocks):
        base = f"{mod}/branch{branch}/block{b}"
        sa1, sa2 = (site_scale(amax, f"{base}/cb{n}") for n in (1, 2))
        kq1, ws1, b1 = _quantized(state, *site_modules(f"{base}/cb1"))
        kq2, ws2, b2 = _quantized(state, *site_modules(f"{base}/cb2"))
        arrays = [
            np.full((1, 1), 1.0 / sa1, np.float32),       # inv1
            kq1, sa1 * ws1 / sa2, b1 / sa2,               # a1, c1 (folded with cb2's 1/sa2)
            kq2, sa2 * ws2, b2,                           # a2, c2 (plain dequant)
        ]
        flat += [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
    return tuple(flat)


def _split(params_flat: Sequence[torch.Tensor], flags: Sequence[bool]):
    out, idx = [], 0
    for has_sc in flags:
        names = _BOT_NAMES + (_SC_NAMES if has_sc else ())
        out.append(dict(zip(names, params_flat[idx:idx + len(names)])))
        idx += len(names)
    if idx != len(params_flat):
        raise ValueError(f"params_flat has {len(params_flat)} tensors, the flags "
                         f"{tuple(flags)} take {idx}")
    return out


def _validate(x: torch.Tensor, blocks) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    cin = x.shape[3]
    for i, p in enumerate(blocks):
        cm, cout = p["kq1"].shape[-1], p["kq3"].shape[-1]
        want = {"inv1": (1, 1), "kq1": (cin, cm), "a1": (cm,), "c1": (cm,),
                "kq2": (9 * cm, cm), "a2": (cm,), "c2": (cm,),
                "kq3": (cm, cout), "a3": (cout,), "c3": (cout,)}
        if "kqs" in p:
            want.update(kqs=(cin, cout), as_=(cout,), cs=(cout,))
        elif cin != cout:
            raise ValueError(f"block {i}: identity shortcut needs Cin == Cout, "
                             f"got {cin} -> {cout}")
        for name, shape in want.items():
            t = p[name]
            dtype = torch.int8 if name.startswith("kq") else torch.float32
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"block {i} {name}: want {shape} {dtype}, got "
                                 f"{tuple(t.shape)} {t.dtype}")
            if t.device != x.device:
                raise ValueError(f"block {i} {name} on {t.device}, x on {x.device}")
        cin = cout


def _quant(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """clip(round(x * inv)) in f32 (values of int8); round half to even."""
    return torch.clamp(torch.round(x * inv), -127, 127)


def _requant(acc: torch.Tensor, a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """clip(round(relu(float(acc) * a + c))): product and sum rounded apart."""
    return torch.clamp(torch.round(torch.relu(acc.float() * a + c)), -127, 127)



def _conv3x3(q: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """Exact int8 3x3 conv, zero padding: q (B, H, W, C) holding int8 values,
    kq (9C, Cout) int8 with rows (ky, kx, ci) -> (B*H*W, Cout) float64 sums."""
    b, h, w, c = q.shape
    cols = F.unfold(q.double().permute(0, 3, 1, 2), 3, padding=1)
    # unfold's rows are (ci, ky, kx); kq's are (ky, kx, ci)
    k = kq.double().reshape(3, 3, c, -1).permute(2, 0, 1, 3).reshape(9 * c, -1)
    return (cols.transpose(1, 2) @ k).reshape(b * h * w, -1)


def bottleneck_chain_int8_reference(x: torch.Tensor, params_flat: Sequence[torch.Tensor],
                                    shortcut_flags: Sequence[bool]) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (B, H, W, Cin) bf16 -> (B, H, W, Cout) bf16.

    The int8 products are summed in float64, exact for these sizes (f32 is
    not past 2^24), then rounded to f32 as JAX converts its int32 sums.
    """
    y = x
    for p in _split(params_flat, shortcut_flags):
        b, h, w, cin = y.shape
        flat = y.reshape(-1, cin).float()
        xq = _quant(flat, p["inv1"][0, 0]).double()
        t1 = _requant(xq @ p["kq1"].double(), p["a1"], p["c1"])
        t2 = _requant(_conv3x3(t1.reshape(b, h, w, -1), p["kq2"]), p["a2"], p["c2"])
        out = (t2.double() @ p["kq3"].double()).float() * p["a3"] + p["c3"]
        if "kqs" in p:
            sc = (xq @ p["kqs"].double()).float() * p["as_"] + p["cs"]
        else:
            sc = flat
        y = torch.relu(out + sc).to(torch.bfloat16).reshape(b, h, w, -1)
    return y


def fused_bottleneck_chain_int8(x: torch.Tensor, params_flat: Sequence[torch.Tensor],
                                shortcut_flags: Sequence[bool] = (True, False, False, False)
                                ) -> torch.Tensor:
    """x: (B, H, W, Cin) bf16 -> (B, H, W, Cout) bf16 through the W8A8 chain.

    A CUDA tensor runs the kernel (one launch per block) and a CPU tensor
    the plain twin; any other device raises.  ``launches`` counts the
    kernel's launches (4 for layer1's chain of 4 blocks).
    """
    blocks = _split(params_flat, shortcut_flags)
    _validate(x, blocks)
    if x.device.type == "cpu":
        return bottleneck_chain_int8_reference(x, params_flat, shortcut_flags)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck_chain_int8 runs on cuda or cpu, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    for p in blocks:
        for name, t in p.items():
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    for c in [x.shape[3]] + [d for p in blocks for d in (p["kq1"].shape[1], p["kq3"].shape[1])]:
        if c % 32:
            raise ValueError(f"the kernel needs channel counts % 32 == 0, got {c}")

    lib = _build.lib()
    stream = _build.stream_ptr(x.device)
    b, h, w, _ = x.shape
    y = x
    for p in blocks:
        cin, cm = p["kq1"].shape
        cout = p["kq3"].shape[1]
        out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device=x.device)
        sc = [p[n].data_ptr() for n in _SC_NAMES] if "kqs" in p else [None] * 3
        err = lib.hrnet_bottleneck_int8_block(
            y.data_ptr(), out.data_ptr(), *(p[n].data_ptr() for n in _BOT_NAMES), *sc,
            b, h, w, cin, cm, cout, stream)
        _build.check(err, "hrnet_bottleneck_int8_block")
        fused_bottleneck_chain_int8.launches += 1
        y = out
    return y


fused_bottleneck_chain_int8.launches = 0


# --------------------------------------------------------------------------
# the BasicBlock chain of a stage branch (TPU kernel fused_basic_chain_int8)
# --------------------------------------------------------------------------

_BASIC_NAMES = ("inv1", "kq1", "a1", "c1", "kq2", "a2", "c2")


def _split_basic(params_flat: Sequence[torch.Tensor], n_blocks: int):
    if len(params_flat) != 7 * n_blocks:
        raise ValueError(f"params_flat has {len(params_flat)} tensors, {n_blocks} blocks "
                         f"take {7 * n_blocks}")
    return [dict(zip(_BASIC_NAMES, params_flat[7 * i:7 * i + 7])) for i in range(n_blocks)]


def _validate_basic(x: torch.Tensor, blocks) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    c = x.shape[3]
    want = {"inv1": (1, 1), "kq1": (9 * c, c), "a1": (c,), "c1": (c,), "kq2": (9 * c, c),
            "a2": (c,), "c2": (c,)}
    for i, p in enumerate(blocks):
        for name, shape in want.items():
            t = p[name]
            dtype = torch.int8 if name.startswith("kq") else torch.float32
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"block {i} {name}: want {shape} {dtype}, got "
                                 f"{tuple(t.shape)} {t.dtype}")
            if t.device != x.device:
                raise ValueError(f"block {i} {name} on {t.device}, x on {x.device}")


def basic_chain_int8_reference(x: torch.Tensor, params_flat: Sequence[torch.Tensor],
                               n_blocks: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (B, H, W, C) bf16 -> (B, H, W, C) bf16."""
    y = x
    for p in _split_basic(params_flat, n_blocks):
        b, h, w, c = y.shape
        flat = y.reshape(-1, c).float()
        xq = _quant(flat, p["inv1"][0, 0]).reshape(b, h, w, c)
        t = _requant(_conv3x3(xq, p["kq1"]), p["a1"], p["c1"])
        out = _conv3x3(t.reshape(b, h, w, c), p["kq2"]).float() * p["a2"] + p["c2"]
        y = torch.relu(out + flat).to(torch.bfloat16).reshape(b, h, w, c)
    return y


def fused_basic_chain_int8(x: torch.Tensor, params_flat: Sequence[torch.Tensor],
                           n_blocks: int, samples_per_block: int = 1) -> torch.Tensor:
    """x: (B, H, W, C) bf16 -> (B, H, W, C) bf16 through a chain of
    ``n_blocks`` W8A8 BasicBlocks (params from ``prepare_branch_int8``).

    A CUDA tensor runs the kernel (one launch per block; C % 16 == 0) and a
    CPU tensor the plain twin; any other device raises.  ``samples_per_block``
    is the JAX signature's TPU grid option and changes nothing here.
    ``launches`` counts the kernel's launches.
    """
    blocks = _split_basic(params_flat, n_blocks)
    _validate_basic(x, blocks)
    if x.device.type == "cpu":
        return basic_chain_int8_reference(x, params_flat, n_blocks)
    if x.device.type != "cuda":
        raise ValueError(f"fused_basic_chain_int8 runs on cuda or cpu, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    for p in blocks:
        for name, t in p.items():
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    b, h, w, c = x.shape
    if c % 16:
        raise ValueError(f"the kernel needs C % 16 == 0, got {c}")

    lib = _build.lib()
    stream = _build.stream_ptr(x.device)
    y = x
    for p in blocks:
        out = torch.empty_like(y)
        err = lib.hrnet_basic_int8_block(y.data_ptr(), out.data_ptr(),
                                         *(p[n].data_ptr() for n in _BASIC_NAMES),
                                         b, h, w, c, stream)
        _build.check(err, "hrnet_basic_int8_block")
        fused_basic_chain_int8.launches += 1
        y = out
    return y


fused_basic_chain_int8.launches = 0
