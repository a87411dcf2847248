"""HRNet layer1 as a chain of fused, BN-folded bottleneck blocks.

Port of the TPU kernel ``ops/pallas/fused_bottleneck.py::fused_bottleneck_chain``
of the JAX package.  ``fused_bottleneck_chain`` launches the CUDA kernel of
``csrc/fused_bottleneck.cu`` once per block for a tensor on the card, and
runs the plain PyTorch twin ``layer1_reference`` for a tensor on the CPU.
Both compute, per block,

    y = relu(conv1x1_3(relu(conv3x3_2(relu(conv1x1_1(x))))) + shortcut(x))

with bf16 activations, f32 accumulation and the two intermediates rounded to
bf16, as the TPU kernel does.  ``fold_layer1_params`` folds eval-mode BN
into the convs (the JAX package's ``models/hrnet.py::_pallas_layer1_apply``).

Weight layout per block, in ``params_flat`` order: w1 (Cin, Cm) bf16,
b1 (Cm,) f32, w2 (3, 3, Cm, Cm) bf16, b2, w3 (Cm, Cout) bf16, b3, and for a
projection shortcut ws (Cin, Cout) bf16, bs (Cout,) f32.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...models.layers import fold_bn
from . import _build

_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


def fold_conv_bn(state: Mapping[str, torch.Tensor], conv: str, bn: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BN into a conv of a state_dict: (HWIO kernel, bias),
    float32.  ``conv``/``bn`` are key prefixes (``layer1.0.conv1``, ``layer1.0.bn1``)."""
    kernel, bias = fold_bn(state[f"{conv}.weight"], state.get(f"{conv}.bias"),
                           *(state[f"{bn}.{f}"] for f in
                             ("weight", "bias", "running_mean", "running_var")))
    return kernel.permute(2, 3, 1, 0), bias


def fold_layer1_params(state: Mapping[str, torch.Tensor], prefix: str = "layer1"
                       ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[bool, ...]]:
    """BN-folded kernel params of the bottleneck chain at ``prefix`` in a
    PoseHRNet state_dict: (params_flat, shortcut_flags)."""
    flat, flags = [], []
    b = 0
    while f"{prefix}.{b}.conv1.weight" in state:
        blk = f"{prefix}.{b}"
        for n in (1, 2, 3):
            k, bias = fold_conv_bn(state, f"{blk}.conv{n}", f"{blk}.bn{n}")
            flat += [(k if n == 2 else k[0, 0]).to(torch.bfloat16).contiguous(),
                     bias.contiguous()]
        has_sc = f"{blk}.downsample.0.weight" in state
        if has_sc:
            k, bias = fold_conv_bn(state, f"{blk}.downsample.0", f"{blk}.downsample.1")
            flat += [k[0, 0].to(torch.bfloat16).contiguous(), bias.contiguous()]
        flags.append(has_sc)
        b += 1
    if not flags:
        raise KeyError(f"no bottleneck blocks under {prefix!r}")
    return tuple(flat), tuple(flags)


def _split(params_flat: Sequence[torch.Tensor], flags: Sequence[bool]):
    out, idx = [], 0
    for has_sc in flags:
        names = _NAMES + (("ws", "bs") if has_sc else ())
        out.append(dict(zip(names, params_flat[idx:idx + len(names)])))
        idx += len(names)
    if idx != len(params_flat):
        raise ValueError(f"params_flat has {len(params_flat)} tensors, the flags "
                         f"{tuple(flags)} take {idx}")
    return out


def _validate(x: torch.Tensor, blocks) -> None:
    """Check types, shapes and devices of the input and every block."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    cin = x.shape[3]
    for i, p in enumerate(blocks):
        cm = p["w1"].shape[-1]
        cout = p["w3"].shape[-1]
        want = {"w1": (cin, cm), "b1": (cm,), "w2": (3, 3, cm, cm), "b2": (cm,),
                "w3": (cm, cout), "b3": (cout,)}
        if "ws" in p:
            want.update(ws=(cin, cout), bs=(cout,))
        elif cin != cout:
            raise ValueError(f"block {i}: identity shortcut needs Cin == Cout, "
                             f"got {cin} -> {cout}")
        for name, shape in want.items():
            t = p[name]
            dtype = torch.bfloat16 if name.startswith("w") else torch.float32
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"block {i} {name}: want {shape} {dtype}, got "
                                 f"{tuple(t.shape)} {t.dtype}")
            if t.device != x.device:
                raise ValueError(f"block {i} {name} on {t.device}, x on {x.device}")
        cin = cout


def layer1_reference(x: torch.Tensor, params_flat: Sequence[torch.Tensor],
                     shortcut_flags: Sequence[bool]) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (B, H, W, Cin) bf16 -> (B, H, W, Cout) bf16.

    Float32 products of the bf16 operands, rounded to bf16 where the kernel
    rounds.  On a card, disable TF32 (``torch.backends.cudnn.allow_tf32``)
    for a float32 reference.
    """
    y = x
    for p in _split(params_flat, shortcut_flags):
        xf = y.float()
        h1 = torch.relu(xf @ p["w1"].float() + p["b1"]).to(torch.bfloat16)
        h2 = F.conv2d(h1.float().permute(0, 3, 1, 2), p["w2"].float().permute(3, 2, 0, 1),
                      padding=1).permute(0, 2, 3, 1)
        h2 = torch.relu(h2 + p["b2"]).to(torch.bfloat16)
        out = h2.float() @ p["w3"].float() + p["b3"]
        sc = xf @ p["ws"].float() + p["bs"] if "ws" in p else xf
        y = torch.relu(out + sc).to(torch.bfloat16)
    return y


def fused_bottleneck_chain(x: torch.Tensor, params_flat: Sequence[torch.Tensor],
                           shortcut_flags: Sequence[bool] = (True, False, False, False)
                           ) -> torch.Tensor:
    """x: (B, H, W, Cin) bf16 -> (B, H, W, Cout) bf16 through the folded chain.

    A CUDA tensor runs the kernel (one launch per block) and a CPU tensor
    the plain twin; any other device raises.  ``launches`` counts the
    kernel's launches (4 for layer1's chain of 4 blocks).
    """
    blocks = _split(params_flat, shortcut_flags)
    _validate(x, blocks)
    if x.device.type == "cpu":
        return layer1_reference(x, params_flat, shortcut_flags)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck_chain runs on cuda or cpu, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    for p in blocks:
        for name, t in p.items():
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    for c in [x.shape[3]] + [d for p in blocks for d in (p["w1"].shape[1], p["w3"].shape[1])]:
        if c % 16:
            raise ValueError(f"the kernel needs channel counts % 16 == 0, got {c}")

    lib = _build.lib()
    stream = _build.stream_ptr(x.device)
    b, h, w, _ = x.shape
    y = x
    for p in blocks:
        cin, cm = p["w1"].shape
        out = torch.empty((b, h, w, p["w3"].shape[1]), dtype=torch.bfloat16, device=x.device)
        ws, bs = (p["ws"].data_ptr(), p["bs"].data_ptr()) if "ws" in p else (None, None)
        err = lib.hrnet_bottleneck_block(
            y.data_ptr(), out.data_ptr(), p["w1"].data_ptr(), p["b1"].data_ptr(),
            p["w2"].data_ptr(), p["b2"].data_ptr(), p["w3"].data_ptr(), p["b3"].data_ptr(),
            ws, bs, b, h, w, cin, cm, p["w3"].shape[1], stream)
        _build.check(err, "hrnet_bottleneck_block")
        fused_bottleneck_chain.launches += 1
        y = out
    return y


fused_bottleneck_chain.launches = 0
