"""Gaussian heatmap targets on the card.

Port of the TPU kernel ``ops/pallas/decode_kernel.py::fused_gaussian_targets``
of the JAX package (B5).  ``fused_gaussian_targets`` launches
``csrc/gaussian_targets.cu`` for tensors on the card and runs the plain
PyTorch twin ``gaussian_targets_reference`` for tensors on the CPU.  Both
compute, per sample b, joint k and output pixel (y, x):

    out[b, y, x, k] = exp(-(dx^2 + dy^2) / (2 sigma^2))   inside the window
                      0                                    elsewhere

with ``dx = x - trunc(u)``, ``dy = y - trunc(v)`` from the truncated centre,
the window ``|dx|, |dy| <= int(3 sigma + 1)``, and a joint valid iff its
visibility is > 0 and ``0 <= trunc(u), trunc(v) < res`` (so -0.5 truncates
to 0 and is in range).  The JAX package's ``ops/targets.gaussian_targets``
takes the product of two exps; the kernel, like the TPU one, takes the exp
of the sum: they differ by an ulp or so (atol 1e-6 in the tests).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build


def window(sigma: float) -> tuple[int, float]:
    """(win, 2 sigma^2): the window half-width, computed on the host as the
    JAX package does, and the divisor as a float32 value."""
    return int(3 * sigma + 1), float(np.float32(2.0 * float(sigma) ** 2))


def _validate(joints: torch.Tensor, visibility: torch.Tensor, output_res: int) -> None:
    if joints.dim() != 3 or joints.shape[2] != 2:
        raise ValueError(f"joints must be (B, K, 2), got {tuple(joints.shape)}")
    if tuple(visibility.shape) != tuple(joints.shape[:2]):
        raise ValueError(f"visibility must be (B, K) = {tuple(joints.shape[:2])}, "
                         f"got {tuple(visibility.shape)}")
    for name, t in (("joints", joints), ("visibility", visibility)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if visibility.device != joints.device:
        raise ValueError(f"visibility on {visibility.device}, joints on {joints.device}")
    if int(output_res) < 1:
        raise ValueError(f"output_res must be >= 1, got {output_res}")


def gaussian_targets_reference(joints: torch.Tensor, visibility: torch.Tensor,
                               output_res: int, sigma: float = 2.0) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (B, K, 2) f32 joints [u, v] in
    heatmap pixels and (B, K) f32 visibility -> (B, res, res, K) f32."""
    _validate(joints, visibility, output_res)
    res = int(output_res)
    win, sig2 = window(sigma)
    tx = torch.trunc(joints[..., 0])                               # (B, K)
    ty = torch.trunc(joints[..., 1])
    valid = (visibility > 0) & (tx >= 0) & (ty >= 0) & (tx < res) & (ty < res)
    px = torch.arange(res, dtype=torch.float32, device=joints.device)
    dx = px[None, None, :, None] - tx[:, None, None, :]            # (B, 1, W, K)
    dy = px[None, :, None, None] - ty[:, None, None, :]            # (B, H, 1, K)
    g = torch.exp(-(dx * dx + dy * dy) / sig2)
    mask = (dx.abs() <= win) & (dy.abs() <= win) & valid[:, None, None, :]
    return torch.where(mask, g, torch.zeros((), dtype=torch.float32, device=g.device))


def fused_gaussian_targets(joints: torch.Tensor, visibility: torch.Tensor,
                           output_res: int, sigma: float = 2.0) -> torch.Tensor:
    """(B, K, 2) f32 joints + (B, K) f32 visibility -> (B, res, res, K) f32.

    CUDA tensors run the kernel (one launch) and CPU tensors the plain twin;
    any other device, dtype or shape raises.  ``launches`` counts the
    kernel's launches.
    """
    _validate(joints, visibility, output_res)
    dev = joints.device
    if dev.type == "cpu":
        return gaussian_targets_reference(joints, visibility, output_res, sigma)
    if dev.type != "cuda":
        raise ValueError(f"fused_gaussian_targets runs on cuda or cpu, not {dev}")
    b, k, _ = joints.shape
    res = int(output_res)
    win, sig2 = window(sigma)
    joints = joints.contiguous()
    visibility = visibility.contiguous()
    out = torch.empty((b, res, res, k), dtype=torch.float32, device=dev)
    err = _build.lib().hrnet_gaussian_targets(
        joints.data_ptr(), visibility.data_ptr(), out.data_ptr(), b, k, res, win, sig2,
        _build.stream_ptr(dev))
    _build.check(err, "hrnet_gaussian_targets")
    fused_gaussian_targets.launches += 1
    return out


fused_gaussian_targets.launches = 0
