"""Heatmap -> keypoint decoding, in PyTorch.

Port of the JAX package's ``ops/decode.py:24-77``.  Heatmaps are NHWK
``(batch, height, width, joints)``; coordinates are ``(batch, joints, 2)``
ordered ``[u, v]`` = [column, row] in heatmap pixels.
"""

from __future__ import annotations

import torch


def spatial_softmax(logits: torch.Tensor, temperature: torch.Tensor | float = 1.0) -> torch.Tensor:
    """Softmax over the H*W plane per joint (reference pose_hrnet_softmax.py:520-528).

    ``temperature`` multiplies the logits before the softmax.
    """
    b, h, w, k = logits.shape
    x = (logits.float() * temperature).reshape(b, h * w, k)
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
