"""HRNet layer1 as a chain of W8A8 bottleneck blocks.

Port of the TPU kernel ``ops/pallas/int8_chain.py::fused_bottleneck_chain_int8``
of the JAX package.  ``fused_bottleneck_chain_int8`` launches the CUDA kernel
of ``csrc/int8_chain.cu`` once per block for a tensor on the card, and runs
the plain PyTorch twin ``bottleneck_chain_int8_reference`` for a tensor on
the CPU.  Both compute, per block (the JAX package's ``_bottleneck_int8_body``),

    xq  = clip(round(x * inv1))
    t1  = clip(round(relu(float(xq @ kq1) * a1 + c1)))
    t2  = clip(round(relu(float(conv3x3(t1) @ kq2) * a2 + c2)))
    y   = bf16(relu(float(t2 @ kq3) * a3 + c3 + shortcut))

with the shortcut ``float(xq @ kqs) * as_ + cs`` on block 0 and the block's
bf16 input in f32 on the others.  Rounding is half to even, the clip
+-127, and the integer sums exact (the twin sums in float64).

``prepare_layer1_int8`` folds and quantizes layer1 from a PoseHRNet
state_dict and a calibration record into the JAX package's flat layout,
per block: inv1 (1, 1) f32, kq1 (Cin, Cm) int8, a1, c1 (Cm,) f32,
kq2 (9 Cm, Cm) int8 (rows ky, kx, ci), a2, c2, kq3 (Cm, Cout) int8, a3, c3
(Cout,) f32, and for a projection shortcut kqs (Cin, Cout) int8, as_, cs.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

_BOT_NAMES = ("inv1", "kq1", "a1", "c1", "kq2", "a2", "c2", "kq3", "a3", "c3")
_SC_NAMES = ("kqs", "as_", "cs")


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
    from ...core.quant_infer import fold_site, quantize_weight, site_scale

    def quantized(conv: str, bn: str):
        """(kq, wscale, bias) of a folded site, kq in the JAX package's
        (Cin, Cout) or (3*3*Cin, Cout) layout."""
        kernel, bias = fold_site(state, conv, bn)
        kq, wscale = quantize_weight(kernel)               # OIHW, scales per O
        kq = kq.transpose(2, 3, 1, 0)                      # -> HWIO
        return kq.reshape(-1, kq.shape[-1]), wscale, bias

    flat, flags = [], []
    b = 0
    dev = state[f"{prefix}.0.conv1.weight"].device
    while f"{prefix}.{b}.conv1.weight" in state:
        blk = f"{prefix}.{b}"
        sa1, sa2, sa3 = (site_scale(amax, f"layer1/block{b}/cb{n}") for n in (1, 2, 3))
        kq1, ws1, b1 = quantized(f"{blk}.conv1", f"{blk}.bn1")
        kq2, ws2, b2 = quantized(f"{blk}.conv2", f"{blk}.bn2")
        kq3, ws3, b3 = quantized(f"{blk}.conv3", f"{blk}.bn3")
        arrays = [
            np.full((1, 1), 1.0 / sa1, np.float32),       # inv1
            kq1, sa1 * ws1 / sa2, b1 / sa2,               # a1, c1
            kq2, sa2 * ws2 / sa3, b2 / sa3,               # a2, c2
            kq3, sa3 * ws3, b3,                           # a3, c3
        ]
        has_sc = f"{blk}.downsample.0.weight" in state
        if has_sc:
            kqs, wss, bs = quantized(f"{blk}.downsample.0", f"{blk}.downsample.1")
            # the projection shares the block input, so cb1's scale sa1
            arrays += [kqs, sa1 * wss, bs]
        flat += [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        flags.append(has_sc)
        b += 1
    if not flags:
        raise KeyError(f"no bottleneck blocks under {prefix!r}")
    return tuple(flat), tuple(flags)


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
        cm = t1.shape[-1]
        cols = F.unfold(t1.double().reshape(b, h, w, cm).permute(0, 3, 1, 2), 3, padding=1)
        # unfold's rows are (ci, ky, kx); kq2's are (ky, kx, ci)
        k2 = p["kq2"].double().reshape(3, 3, cm, cm).permute(2, 0, 1, 3).reshape(9 * cm, cm)
        acc2 = (cols.transpose(1, 2) @ k2).reshape(-1, cm)
        t2 = _requant(acc2, p["a2"], p["c2"])
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
