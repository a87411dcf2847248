"""Heatmap -> keypoint decoding, in PyTorch.

Port of the JAX package's ``ops/decode.py``.  Heatmaps are NHWK
``(batch, height, width, joints)``; coordinates are ``(batch, joints, 2)``
ordered ``[u, v]`` = [column, row] in heatmap pixels.

``softmax_decode`` is the decode of a softmax head's logits: on a CUDA
tensor it launches the hand-written kernel (``ops/kernels/softmax_decode.py``),
on a CPU tensor it runs the kernel's plain twin,
``soft_argmax(spatial_softmax(logits, T))``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels.softmax_decode import fused_softmax_decode


def spatial_softmax(logits: torch.Tensor, temperature: torch.Tensor | float = 1.0) -> torch.Tensor:
    """Softmax over the H*W plane per joint (reference pose_hrnet_softmax.py:520-528).

    ``temperature`` multiplies the logits before the softmax, in float32
    (float64 for float64 logits).
    """
    b, h, w, k = logits.shape
    x = (logits.to(torch.promote_types(logits.dtype, torch.float32)) * temperature).reshape(
        b, h * w, k)
    return torch.softmax(x, dim=1).reshape(b, h, w, k)


def soft_argmax(probs: torch.Tensor) -> torch.Tensor:
    """Spatial expectation of per-joint probability maps.

    probs: (B, H, W, K), each plane summing to 1 over H*W.
    returns: (B, K, 2) [u, v] float32.
    """
    _, h, w, _ = probs.shape
    p = probs.float()
    us = torch.arange(w, dtype=torch.float32, device=p.device)
    vs = torch.arange(h, dtype=torch.float32, device=p.device)
    eu = torch.einsum("bhwk,w->bk", p, us)
    ev = torch.einsum("bhwk,h->bk", p, vs)
    return torch.stack([eu, ev], dim=-1)


def hard_argmax(heatmaps: torch.Tensor) -> torch.Tensor:
    """Flat argmax decode (reference heatmap_decoding.py:103-107), dividing
    by the width as the JAX package does; the first maximum wins a tie.

    returns: (B, K, 2) [u, v] float32.
    """
    b, h, w, k = heatmaps.shape
    idx = torch.argmax(heatmaps.reshape(b, h * w, k), dim=1)
    return torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)


def decode_heatmaps(heatmaps: torch.Tensor, use_softmax: bool = True) -> torch.Tensor:
    """``get_final_preds`` (reference heatmap_decoding.py:87-107): the spatial
    expectation of probability maps with ``use_softmax``, else the argmax."""
    if use_softmax:
        return soft_argmax(heatmaps)
    return hard_argmax(heatmaps)


def softmax_decode(logits: torch.Tensor, temperature: torch.Tensor | float = 1.0) -> torch.Tensor:
    """``soft_argmax(spatial_softmax(logits, temperature))`` of (B, H, W, K)
    float32/bfloat16 logits -> (B, K, 2) float32: the kernel on a card, its
    plain twin on the CPU; any other device raises."""
    return fused_softmax_decode(logits, temperature)


def heatmap_maxvals(heatmaps: torch.Tensor) -> torch.Tensor:
    """Per-joint peak activation, (B, K, 1)."""
    return heatmaps.amax(dim=(1, 2))[..., None]


def get_max_preds_with_maxvals(heatmaps: torch.Tensor):
    """Upstream-style argmax decode returning (preds, maxvals); predictions
    with non-positive peaks are zeroed (reference lib/core/inference.py:18-52)."""
    preds = hard_argmax(heatmaps)
    maxvals = heatmap_maxvals(heatmaps)
    return preds * (maxvals > 0.0).float(), maxvals


def _stencil(heatmaps: torch.Tensor, coords: torch.Tensor):
    """(hms, px, py, at): the float32 maps, the integer peak, and
    ``at(dy, dx)`` -> the (B, K) values at the peak shifted by (dy, dx),
    clamped to the map."""
    b, h, w, k = heatmaps.shape
    hms = heatmaps.float()
    px = coords[..., 0].to(torch.int64)
    py = coords[..., 1].to(torch.int64)
    bidx = torch.arange(b, device=hms.device)[:, None]
    kidx = torch.arange(k, device=hms.device)[None, :]

    def at(dy: int, dx: int) -> torch.Tensor:
        yy = torch.clamp(py + dy, 0, h - 1)
        xx = torch.clamp(px + dx, 0, w - 1)
        return hms[bidx, yy, xx, kidx]

    return hms, px, py, at


def quarter_offset_refine(heatmaps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Upstream post-processing: shift each argmax prediction 0.25 px toward
    the larger neighbouring activation (reference lib/core/inference.py:59-77).

    heatmaps: (B, H, W, K); coords: (B, K, 2) integer argmax positions.
    """
    _, h, w, _ = heatmaps.shape
    _, px, py, at = _stencil(heatmaps, coords)
    sign_x = torch.sign(at(0, 1) - at(0, -1))
    sign_y = torch.sign(at(1, 0) - at(-1, 0))
    inside = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    offset = torch.stack([sign_x, sign_y], dim=-1) * 0.25
    return coords + torch.where(inside[..., None], offset, torch.zeros_like(offset))


def taylor_refine(heatmaps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Batched 2nd-order Taylor sub-pixel refinement (reference
    heatmap_decoding.py:23-52): the finite-difference stencil around each
    integer peak and the 2x2 Newton step in closed form.
    heatmaps: (B, H, W, K); coords: (B, K, 2) [u, v].
    """
    _, h, w, _ = heatmaps.shape
    _, px, py, at = _stencil(heatmaps, coords)
    dx = 0.5 * (at(0, 1) - at(0, -1))
    dy = 0.5 * (at(1, 0) - at(-1, 0))
    dxx = 0.25 * (at(0, 2) - 2.0 * at(0, 0) + at(0, -2))
    dyy = 0.25 * (at(2, 0) - 2.0 * at(0, 0) + at(-2, 0))
    dxy = 0.25 * (at(1, 1) - at(-1, 1) - at(1, -1) + at(-1, -1))

    det = dxx * dyy - dxy * dxy
    inside = (px > 1) & (px < w - 2) & (py > 1) & (py < h - 2) & (det != 0.0)
    safe_det = torch.where(det == 0.0, torch.ones_like(det), det)
    # -H^{-1} g for H = [[dxx, dxy], [dxy, dyy]]
    off_x = -(dyy * dx - dxy * dy) / safe_det
    off_y = -(-dxy * dx + dxx * dy) / safe_det
    offset = torch.stack([off_x, off_y], dim=-1)
    return coords + torch.where(inside[..., None], offset, torch.zeros_like(offset))


def gaussian_modulate(heatmaps: torch.Tensor, kernel: int) -> torch.Tensor:
    """Heatmap distribution modulation (reference heatmap_decoding.py:55-84),
    batched: a separable Gaussian blur with zero padding (two depthwise
    convs), then each joint rescaled so its peak matches its pre-blur peak."""
    sigma = (kernel - 1) // 3
    half = (kernel - 1) // 2
    xs = torch.arange(kernel, dtype=torch.float32, device=heatmaps.device) - half
    g1d = torch.exp(-(xs ** 2) / (2.0 * float(sigma) ** 2))
    g1d = g1d / g1d.sum()

    hms = heatmaps.float()
    orig_max = hms.amax(dim=(1, 2), keepdim=True)
    k = hms.shape[3]
    x = hms.permute(0, 3, 1, 2)                                    # (B, K, H, W)
    x = F.conv2d(x, g1d.view(1, 1, kernel, 1).expand(k, 1, kernel, 1), padding=(half, 0),
                 groups=k)
    x = F.conv2d(x, g1d.view(1, 1, 1, kernel).expand(k, 1, 1, kernel), padding=(0, half),
                 groups=k)
    out = x.permute(0, 2, 3, 1)
    new_max = out.amax(dim=(1, 2), keepdim=True)
    return out * orig_max / torch.clamp(new_max, min=1e-12)
