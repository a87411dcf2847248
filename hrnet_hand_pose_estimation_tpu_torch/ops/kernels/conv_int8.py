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
``conv_int8_plan`` makes the kernel's launch plan (tile, warp grid, weight
ring depth, shared memory, grid); the C entry checks it and launches it.
The kernel takes any Cin and Cout: it reads the weights at a channel pitch
of Cin rounded up to 16 (``pad_kq``, done once by
``core/quant_infer.prepare_quant_params``), stages x's channels into that
pitch with zeros past Cin and masks the channels past Cout.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

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


# the kernel's instances: (pixels, channels) of a block -> (WM warps along the
# pixels, MT m16 tiles per warp, NT n8 tiles per warp); 8 / WM warps along the
# channels, so WM * MT * 16 pixels and (8 / WM) * NT * 8 channels
CONV_INT8_TILES = {(512, 32): (8, 4, 4), (256, 32): (8, 2, 4), (256, 64): (4, 4, 4),
                   (128, 32): (8, 1, 4), (128, 64): (4, 2, 4), (128, 128): (4, 2, 8),
                   (64, 32): (4, 1, 2), (64, 64): (4, 1, 4), (64, 128): (2, 2, 4)}


def pad_kq(kq: torch.Tensor) -> torch.Tensor:
    """kq (Cout, k, k, Cin) as the kernel reads it: ``kq`` itself where
    Cin % 16 == 0, else a view ``[..., :Cin]`` of zero-padded storage whose
    channel pitch is Cin rounded up to 16, so that every 16-byte copy of a
    weight slab is aligned.  The view has kq's shape and values."""
    cin = kq.shape[3]
    if cin % 16 == 0:
        return kq
    return F.pad(kq, (0, -cin % 16)).contiguous()[..., :cin]


def _kernel_kq(kq: torch.Tensor) -> torch.Tensor:
    """kq as the kernel takes it: a dense (Cout, k, k, Cinp) layout seen
    through ``[..., :Cin]``, Cinp = Cin rounded up to 16 (``pad_kq``'s,
    made here when kq is not already in it)."""
    cout, k, _, cin = kq.shape
    cinp = -(-cin // 16) * 16
    if kq.stride() != (k * k * cinp, k * cinp, cinp, 1):
        kq = pad_kq(kq.contiguous())
    return kq


class ConvInt8Plan(NamedTuple):
    """One launch of ``csrc/conv_int8.cu``: block (b, tile) x channel block."""

    tr: int                 # output rows of a tile
    tw: int                 # output columns of a tile
    hr: int                 # halo rows: (tr - 1) * stride + k
    hc: int                 # halo columns: (tw - 1) * stride + k
    ldh: int                # halo bytes per pixel: an odd multiple of 16, >= cinp + 16
    kb: int                 # input channels of one tap per weight slab (32 or 64)
    wm: int                 # warps along the tile's pixels
    mt: int                 # m16 tiles per warp
    nt: int                 # n8 tiles per warp
    nb: int                 # output channels per block
    stages: int             # weight slabs in the shared-memory ring
    smem: int               # dynamic shared memory bytes
    grid: Tuple[int, int]   # (B * tiles, channel blocks)
    cinp: int               # the weights' channel pitch: Cin rounded up to 16


@functools.lru_cache(maxsize=1024)
def conv_int8_plan(b: int, h: int, w: int, cin: int, cout: int, k: int,
                   stride: int) -> ConvInt8Plan:
    """The kernel's plan for x (b, h, w, cin) and a (cout, k, k, cin) site.

    A tile is about 512 output pixels for at most 32 output channels, 256
    for at most 64, else 128 (eight, four or two rows at Wo = 64, the whole
    image at 8 x 8) for at most 128: the fewer channels, the more pixels
    each weight slab serves.  The ring holds up to four weight slabs of 64
    input channels (32 where cinp % 64 != 0), cinp = Cin rounded up to 16.
    Raises ValueError on a shape the kernel does not take."""
    cinp = -(-cin // 16) * 16
    if not 0 < cin <= 2048 or cout <= 0:
        raise ValueError(f"the kernel takes 0 < Cin <= 2048 (a 16-byte column per thread) "
                         f"and Cout > 0, got {cin}, {cout}")
    if k % 2 == 0 or k < 1 or stride not in (1, 2):
        raise ValueError(f"the kernel takes odd k and stride 1 or 2, got k={k}, stride={stride}")
    pad = (k - 1) // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    if b < 1 or ho < 1 or wo < 1:
        raise ValueError(f"empty output for x {(b, h, w, cin)}, k={k}, stride={stride}")
    n_blocks = -(-cout // 128)
    ncap = next(n for n in (32, 64, 128) if n >= -(-cout // n_blocks))
    ldh = cinp + (16 if cinp % 32 == 0 else 32)
    kb = 64 if cinp % 64 == 0 else 32
    stages = max(2, min(4, k * k * -(-cinp // kb)))
    tw = min(wo, 64)
    tr = min(ho, max(1, {32: 512, 64: 256, 128: 128}[ncap] // tw))
    while True:
        mcap = next(m for m in (64, 128, 256, 512) if m >= tr * tw)
        wm, mt, nt = CONV_INT8_TILES[(mcap, ncap)]
        hr, hc = (tr - 1) * stride + k, (tw - 1) * stride + k
        smem = -(-hr * hc * ldh // 128) * 128 + stages * ncap * (kb + 16)
        if smem <= _build.SMEM_LIMIT:
            break
        if tr == 1 and tw == 1:
            raise ValueError(f"no tile of the kernel fits Cin {cinp} in shared memory")
        tr, tw = (tr // 2, tw) if tr > 1 else (tr, tw // 2)
    grid = (b * -(-ho // tr) * -(-wo // tw), -(-cout // ncap))
    return ConvInt8Plan(tr, tw, hr, hc, ldh, kb, wm, mt, nt, ncap, stages, smem, grid, cinp)


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
    b, h, w, _ = x.shape
    plan = conv_int8_plan(b, h, w, cin, cout, k, stride)
    kq = _kernel_kq(q.kq)
    if not (x.is_contiguous() and all(t.is_contiguous() for t in q[1:])):
        raise ValueError("x and the site's tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, kq)):
        raise ValueError("the kernel reads x and kq in 16-byte vectors: both must be "
                         "16-byte aligned")
    pad = (k - 1) // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    out = torch.empty((b, ho, wo, cout), dtype=torch.bfloat16, device=x.device)
    err = _build.lib().hrnet_conv_int8(
        x.data_ptr(), out.data_ptr(), kq.data_ptr(), q.scale.data_ptr(), q.bias.data_ptr(),
        q.sa.data_ptr(), b, h, w, cin, plan.cinp, ho, wo, cout, k, k, stride, pad, int(relu),
        plan.tr, plan.tw, plan.hr, plan.hc, plan.ldh, plan.kb, plan.wm, plan.mt, plan.nt, plan.nb,
        plan.stages, plan.smem, _build.stream_ptr(x.device))
    _build.check(err, "hrnet_conv_int8")
    conv_int8.launches += 1
    return out


conv_int8.launches = 0
