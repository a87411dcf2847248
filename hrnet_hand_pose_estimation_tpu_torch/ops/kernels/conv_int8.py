"""W8A8 convolution of one int8 site of the HRNet trunk.

The counterpart of the JAX package's ``core/quant_infer.py::_conv_int8``,
which XLA runs as an int8 convolution with int32 sums (no Pallas kernel):

    xq  = clip(round(x / sa), -127, 127)                 (x bf16 -> f32)
    acc = conv(xq, kq)                                   int32, exact, zero padding (k-1)//2
    y   = bf16(relu?(float(acc) * scale + bias))         scale = sa * wscale (f32)

``conv_int8`` launches the CUDA kernel of ``csrc/conv_int8.cu`` for a
tensor on the card (PyTorch has no int8 convolution there) and runs the
plain twin ``conv_int8_reference`` for a tensor on the CPU.  ``SiteQ`` holds
one site's prepared parameters (``core/quant_infer.prepare_quant_params``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build


class SiteQ(NamedTuple):
    """One int8 site: BN-folded weights quantized per output channel."""

    kq: torch.Tensor       # (Cout, KH, KW, Cin) int8
    wscale: torch.Tensor   # (Cout,) f32
    sa: torch.Tensor       # () f32 activation scale, on the device of the weights
    scale: torch.Tensor    # (Cout,) f32: sa * wscale, one f32 product
    bias: torch.Tensor     # (Cout,) f32


def _validate(x: torch.Tensor, q: SiteQ, stride: int) -> None:
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be (B, H, W, C) bfloat16, got {tuple(x.shape)} {x.dtype}")
    cout, kh, kw, cin = q.kq.shape
    if q.kq.dtype != torch.int8 or kh != kw or kh % 2 == 0:
        raise ValueError(f"kq must be (Cout, k, k, Cin) int8 with odd k, got "
                         f"{tuple(q.kq.shape)} {q.kq.dtype}")
    if x.shape[3] != cin:
        raise ValueError(f"x has {x.shape[3]} channels, kq takes {cin}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    for name in ("wscale", "scale", "bias"):
        t = getattr(q, name)
        if tuple(t.shape) != (cout,) or t.dtype != torch.float32:
            raise ValueError(f"{name}: want ({cout},) float32, got {tuple(t.shape)} {t.dtype}")
    if q.sa.shape != () or q.sa.dtype != torch.float32:
        raise ValueError("sa must be a 0-dim float32 tensor")
    for name, t in q._asdict().items():
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")


def conv_int8_reference(x: torch.Tensor, q: SiteQ, stride: int = 1,
                        relu: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (B, H, W, Cin) bf16 -> (B, Ho, Wo, Cout) bf16.

    Quantizes in f32 (a true division by the 0-dim tensor ``sa``; PyTorch
    would turn a division by a Python number into a multiply on the card),
    sums the int8 products in float64 (exact: a 3x3 over 256 channels
    reaches 127^2 * 2304 ~ 3.7e7 > 2^24), and runs the same f32 epilogue.
    """
    cout, k, _, cin = q.kq.shape
    b, h, w, _ = x.shape
    pad = (k - 1) // 2
    xq = torch.clamp(torch.round(x.float() / q.sa), -127, 127)
    cols = F.unfold(xq.double().permute(0, 3, 1, 2), k, padding=pad, stride=stride)
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    acc = q.kq.permute(0, 3, 1, 2).reshape(cout, -1).double() @ cols     # (B, Cout, L)
    y = acc.float() * q.scale[:, None] + q.bias[:, None]
    if relu:
        y = torch.relu(y)
    return y.to(torch.bfloat16).reshape(b, cout, ho, wo).permute(0, 2, 3, 1).contiguous()


def conv_int8(x: torch.Tensor, q: SiteQ, stride: int = 1, relu: bool = True) -> torch.Tensor:
    """x: (B, H, W, Cin) bf16 -> (B, Ho, Wo, Cout) bf16 through the site's W8A8 conv.

    A CUDA tensor runs the kernel (one launch) and a CPU tensor the plain
    twin; any other device raises.  ``launches`` counts the kernel's launches.
    """
    _validate(x, q, stride)
    if x.device.type == "cpu":
        return conv_int8_reference(x, q, stride, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv_int8 runs on cuda or cpu, not {x.device}")
    cout, k, _, cin = q.kq.shape
    if cin % 32 or cout % 8:
        raise ValueError(f"the kernel needs Cin % 32 == 0 and Cout % 8 == 0, got {cin}, {cout}")
    if not (x.is_contiguous() and all(t.is_contiguous() for t in q)):
        raise ValueError("x and the site's tensors must be contiguous")
    b, h, w, _ = x.shape
    pad = (k - 1) // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    out = torch.empty((b, ho, wo, cout), dtype=torch.bfloat16, device=x.device)
    err = _build.lib().hrnet_conv_int8(
        x.data_ptr(), out.data_ptr(), q.kq.data_ptr(), q.scale.data_ptr(), q.bias.data_ptr(),
        q.sa.data_ptr(), b, h, w, cin, ho, wo, cout, k, k, stride, pad, int(relu),
        _build.stream_ptr(x.device))
    _build.check(err, "hrnet_conv_int8")
    conv_int8.launches += 1
    return out


conv_int8.launches = 0
