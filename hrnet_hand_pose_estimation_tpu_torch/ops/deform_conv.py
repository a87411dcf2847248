"""Deformable convolution (v1/v2), in PyTorch.

Port of the JAX package's ``ops/deform_conv.py`` (the reference's
deformable-conv C++/CUDA extension, lib/deformable_conv): bilinearly sample
the input at every kernel tap's offset-shifted position
(``ops/volumetric.bilinear_sample_nhwc``) and contract the samples with the
taps' weights in float32 at full precision (``ops/precision.bmm_f32``: TF32
off on the card, as JAX's ``Precision.HIGHEST``).  JAX loops over the taps,
one gather and one product each, and XLA compiles the loop; run eagerly,
that is ~30 launches a tap, so the port samples every tap in one gather and
contracts (tap, group, channel) in one product.  Autograd differentiates the
gathers and the bilinear weights, offsets included.

The JAX package reaches no Pallas kernel here, so on the card these are
PyTorch's own gather and cuBLAS kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .precision import bmm_f32, no_tf32
from .volumetric import bilinear_sample_nhwc


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                  stride: int = 1, padding: int = 1, dilation: int = 1,
                  deformable_groups: int = 1) -> torch.Tensor:
    """x: (B, H, W, Cin); offsets: (B, Ho, Wo, G*2*kh*kw) ordered (group, tap
    row-major, (dy, dx)), the extension's layout; weight: (kh, kw, Cin, Cout)
    HWIO; mask: (B, Ho, Wo, G*kh*kw) for the modulated variant.
    ``deformable_groups`` splits the input channels into G groups, each
    sampled with its own offset field (PoseAggr uses G = num_joints).
    Returns (B, Ho, Wo, Cout) float32."""
    b, h, w, cin = x.shape
    kh, kw, _, cout = weight.shape
    g = deformable_groups
    cg = cin // g
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    n = ho * wo

    taps = kh * kw
    dev = x.device
    base_y = torch.arange(ho, dtype=torch.float32, device=dev) * stride - padding
    base_x = torch.arange(wo, dtype=torch.float32, device=dev) * stride - padding
    # each tap's grid, (taps, Ho, Wo): the tap's row (column) offset added to
    # the output grid first, as JAX adds it, so the sample positions round alike
    ti = torch.arange(kh, dtype=torch.float32, device=dev).repeat_interleave(kw) * dilation
    tj = torch.arange(kw, dtype=torch.float32, device=dev).repeat(kh) * dilation
    grid_y = base_y[None, :, None] + ti[:, None, None]
    grid_x = base_x[None, None, :] + tj[:, None, None]

    # (B, Ho, Wo, G, taps, 2) -> (B, G, taps, Ho, Wo) sample positions
    off = offsets.float().reshape(b, ho, wo, g, taps, 2).permute(0, 3, 4, 1, 2, 5)
    py = grid_y + off[..., 0]
    px = grid_x + off[..., 1]
    # group-major batch fold: every (sample, group) pair samples independently,
    # all taps in one gather
    xg = x.reshape(b, h, w, g, cg).permute(0, 3, 1, 2, 4).reshape(b * g, h, w, cg)
    coords = torch.stack([px, py], dim=-1).reshape(b * g, taps * n, 2)
    sampled = bilinear_sample_nhwc(xg, coords).reshape(b, g, taps, n, cg)
    if mask is not None:
        sampled = sampled * mask.reshape(b, ho, wo, g, taps).permute(0, 3, 4, 1, 2).reshape(
            b, g, taps, n, 1)
    # "bgtnc,tgco->bno": one product over (tap, group, channel)
    lhs = sampled.float().permute(0, 3, 2, 1, 4).reshape(1, b * n, taps * cin)
    out = bmm_f32(lhs, weight.float().reshape(1, taps * cin, cout))
    out = out.reshape(b, ho, wo, cout)
    if bias is not None:
        out = out + bias
    return out


def plain_conv2d_reference(x: torch.Tensor, weight: torch.Tensor,
                           bias: Optional[torch.Tensor] = None, stride: int = 1,
                           padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """An ordinary float32 conv with the same layouts (NHWC in and out, HWIO
    weight), TF32 off: the zero-offset oracle."""
    with no_tf32():
        out = F.conv2d(x.float().permute(0, 3, 1, 2), weight.float().permute(3, 2, 0, 1),
                       stride=stride, padding=padding, dilation=dilation)
    out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias
    return out
