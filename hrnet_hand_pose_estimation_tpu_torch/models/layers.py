"""Shared conv/norm building blocks of the HRNet family, in PyTorch.

Port of the JAX package's ``models/layers.py`` (ConvBN, BasicBlock,
Bottleneck, ResLayer).  Modules carry the reference torch names
(``conv1``/``bn1``, ``downsample.0``/``downsample.1``), so a reference
``state_dict`` loads by name and ``utils/weights.py`` maps the JAX variable
tree onto it.  Tensors inside the modules are NCHW (any memory format);
the public model functions keep NHWC at their boundaries.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# torch nn.BatchNorm2d defaults: eps 1e-5, momentum 0.1 (== flax decay 0.9).
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode forward has flax's semantics.

    flax's ``nn.BatchNorm(use_running_average=False)`` normalises with the
    *biased* batch variance and updates the running variance with it too;
    ``nn.BatchNorm2d`` updates it with the unbiased one (a factor N/(N-1):
    14 % on a 2x2 branch at batch 2).  Here the train forward normalises
    with the batch statistics, computed in float32 (``native_batch_norm``
    accumulates in float32 for bf16 inputs, as flax promotes them), returns
    the input's dtype, and sets ``running = (1 - momentum) * running +
    momentum * batch`` with the biased variance (flax's decay 0.9 = 1 -
    momentum).  It writes the running statistics during the forward, as
    torch's BN does; the train step's anomaly guard puts them back when the
    step is skipped.  The eval forward, the parameters and the state-dict
    names are ``nn.BatchNorm2d``'s.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True,
                                                  0.0, self.eps)
        with torch.no_grad():
            var = torch.clamp(invstd.reciprocal().square() - self.eps, min=0.0)
            decay = 1.0 - self.momentum
            self.running_mean.copy_(decay * self.running_mean + (1.0 - decay) * mean)
            self.running_var.copy_(decay * self.running_var + (1.0 - decay) * var)
            self.num_batches_tracked.add_(1)
        return y


def batch_norm(features: int) -> BatchNorm:
    return BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)


def fold_bn(weight: torch.Tensor, conv_bias: Optional[torch.Tensor], bn_weight: torch.Tensor,
            bn_bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor):
    """Fold eval-mode BN into the conv before it: (OIHW kernel', bias'), float32."""
    inv = bn_weight.float() / torch.sqrt(var.float() + BN_EPS)
    kernel = weight.float() * inv[:, None, None, None]
    bias = bn_bias.float() - mean.float() * inv
    if conv_bias is not None:
        bias = bias + conv_bias.float() * inv
    return kernel, bias


class ConvBN(nn.Sequential):
    """Conv (no bias unless asked) + BatchNorm, optionally ReLU.

    A ``Sequential`` so that its children are named ``0`` (conv), ``1`` (bn)
    and ``2`` (relu), as in the reference's transition and fuse layers.
    """

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, use_bias: bool = False):
        pad = (kernel - 1) // 2
        layers = [nn.Conv2d(in_features, features, kernel, stride, pad, bias=use_bias),
                  batch_norm(features)]
        if relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class BasicBlock(nn.Module):
    """2x (3x3 conv+BN) residual block, expansion 1 (reference pose_hrnet.py:28-57)."""

    expansion = 1

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 use_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, stride, 1, bias=False)
        self.bn1 = batch_norm(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = batch_norm(features)
        self.downsample = (ConvBN(in_features, features, 1, stride, relu=False)
                           if use_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1(x4) residual block, expansion 4 (reference pose_hrnet.py:60-98)."""

    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 use_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 1, 1, 0, bias=False)
        self.bn1 = batch_norm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = batch_norm(features)
        self.conv3 = nn.Conv2d(features, features * 4, 1, 1, 0, bias=False)
        self.bn3 = batch_norm(features * 4)
        self.downsample = (ConvBN(in_features, features * 4, 1, stride, relu=False)
                           if use_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}
BLOCK_EXPANSION = {"BASIC": 1, "BOTTLENECK": 4}


class ResLayer(nn.Sequential):
    """Sequential stack of residual blocks (reference _make_layer :398-415);
    children are named ``0``, ``1``, ... as in the reference."""

    def __init__(self, block: str, in_features: int, features: int,
                 num_blocks: int, stride: int = 1):
        block_cls = BLOCKS[block]
        out = features * BLOCK_EXPANSION[block]
        needs_ds = stride != 1 or in_features != out
        blocks = [block_cls(in_features, features, stride, needs_ds)]
        blocks += [block_cls(out, features) for _ in range(1, num_blocks)]
        super().__init__(*blocks)
