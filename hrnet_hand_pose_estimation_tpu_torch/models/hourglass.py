"""Stacked hourglass filter bank, in PyTorch.

Port of the JAX package's ``models/hourglass.py`` (reference
lib/models/HourGlass.py:33-226, HGFilter):

- ``HGNorm``: BN, or GroupNorm with min(32, C) groups and flax's epsilon
  1e-6 (torch's default is 1e-5);
- ``HGConvBlock``: the pre-activation residual block whose output
  concatenates three conv stages (out/2 + out/4 + out/4 channels), with a
  1x1 ``downsample`` projection where the widths differ;
- ``HourGlass``: the recursive U of the given depth, 2x2 average pooling
  down and bilinear align-corners upsampling up (the JAX package's
  documented divergence from the reference's bicubic, kept);
- ``HGFilter``: the ``conv64`` / ``ave_pool`` / ``no_down`` stems,
  NUM_STACKS hourglasses with their heads (``tanh`` outputs where the
  reference's ``use_sigmoid`` branch applies Tanh) and the ``bl{i}`` /
  ``al{i}`` re-injection.  It returns ``(outputs, normx)``: the per-stack
  (B, h, w, K) float32 maps and the stem's features, NHWC.

Module names are the flax paths (``m0.b1_2.conv1``, ``top_m_0``,
``conv_last0``, ``bn_end0.norm``, ``bl0``, ``al0``), which are the
reference's ``add_module`` names with the norms one level down
(``HGNorm.norm``).  The convs train from flax's default initialisation
(``LecunConv2d``).  NCHW inside, NHWC at the interface; parameters float32,
the compute dtype from ``torch.autocast``.

The output is a tuple, which the JAX package's train and eval steps, its
forward function and ``Evaluator2D`` cannot read (ROADMAP C22): the port's
raise.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.upsample import upsample_bilinear_align_corners
from .layers import LecunConv2d, batch_norm

GN_EPS = 1e-6          # flax's nn.GroupNorm default


class HGNorm(nn.Module):
    """BN or GroupNorm(min(groups, C)) under the name ``norm``."""

    def __init__(self, channels: int, norm: str = "batch", groups: int = 32):
        super().__init__()
        # any norm but "batch" is a GroupNorm, as in the JAX package
        self.norm = (batch_norm(channels) if norm == "batch"
                     else nn.GroupNorm(min(groups, channels), channels, eps=GN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)

    @torch.no_grad()
    def init_train_weights(self, gen: torch.Generator) -> None:
        """flax's GroupNorm starts at scale 1, bias 0 (a BN is reset as every BN)."""
        if isinstance(self.norm, nn.GroupNorm):
            self.norm.weight.fill_(1.0)
            self.norm.bias.zero_()


class HGConvBlock(nn.Module):
    """Pre-activation residual block with a concat trunk (reference :34-77)."""

    def __init__(self, in_planes: int, out_planes: int, norm: str = "batch"):
        super().__init__()
        half, quarter = out_planes // 2, out_planes // 4
        self.bn1 = HGNorm(in_planes, norm)
        self.conv1 = LecunConv2d(in_planes, half, 3, 1, 1, bias=False)
        self.bn2 = HGNorm(half, norm)
        self.conv2 = LecunConv2d(half, quarter, 3, 1, 1, bias=False)
        self.bn3 = HGNorm(quarter, norm)
        self.conv3 = LecunConv2d(quarter, quarter, 3, 1, 1, bias=False)
        if in_planes != out_planes:
            self.bn4 = HGNorm(in_planes, norm)
            self.downsample = LecunConv2d(in_planes, out_planes, 1, bias=False)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.conv1(torch.relu(self.bn1(x)))
        y2 = self.conv2(torch.relu(self.bn2(y1)))
        y3 = self.conv3(torch.relu(self.bn3(y2)))
        residual = x
        if self.downsample is not None:
            residual = self.downsample(torch.relu(self.bn4(x)))
        return torch.cat([y1, y2, y3], dim=1) + residual


class HourGlass(nn.Module):
    """Recursive U-shaped module (reference :79-121): at each level
    ``b1_{l}`` on the input, ``b2_{l}`` after a 2x2 average pool, the next
    level (``b2_plus_1`` at the bottom), ``b3_{l}``, a 2x bilinear
    align-corners upsample, and the sum."""

    def __init__(self, depth: int, features: int, norm: str = "batch"):
        super().__init__()
        self.depth = depth
        for lvl in range(depth, 0, -1):
            names = [f"b1_{lvl}", f"b2_{lvl}", f"b3_{lvl}"] + ([f"b2_plus_{lvl}"]
                                                                if lvl == 1 else [])
            for name in names:
                self.add_module(name, HGConvBlock(features, features, norm))

    def _level(self, lvl: int, x: torch.Tensor) -> torch.Tensor:
        up1 = getattr(self, f"b1_{lvl}")(x)
        low1 = getattr(self, f"b2_{lvl}")(F.avg_pool2d(x, 2, 2))
        low2 = self._level(lvl - 1, low1) if lvl > 1 else self.b2_plus_1(low1)
        low3 = getattr(self, f"b3_{lvl}")(low2)
        h, w = low3.shape[2:]
        up2 = upsample_bilinear_align_corners(low3.permute(0, 2, 3, 1), (2 * h, 2 * w))
        return up1 + up2.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._level(self.depth, x)


class HGFilter(nn.Module):
    """Stacked hourglass with intermediate supervision (reference :124-221)."""

    def __init__(self, num_stacks: int = 2, depth: int = 2, num_joints: int = 21,
                 norm: str = "batch", down_type: str = "conv64", use_sigmoid: bool = True):
        super().__init__()
        self.num_stacks = num_stacks
        self.down_type = down_type
        self.use_sigmoid = use_sigmoid
        self.conv1 = LecunConv2d(3, 64, 7, 2, 3)
        self.bn1 = HGNorm(64, norm)
        if down_type == "conv64":
            self.conv2 = HGConvBlock(64, 64, norm)
            self.down_conv2 = LecunConv2d(64, 128, 3, 2, 1)
        elif down_type in ("ave_pool", "no_down"):
            self.conv2 = HGConvBlock(64, 128, norm)
        else:
            raise ValueError(f"unknown down_type {down_type!r}")
        self.conv3 = HGConvBlock(128, 128, norm)
        self.conv4 = HGConvBlock(128, 256, norm)
        for i in range(num_stacks):
            self.add_module(f"m{i}", HourGlass(depth, 256, norm))
            self.add_module(f"top_m_{i}", HGConvBlock(256, 256, norm))
            self.add_module(f"conv_last{i}", LecunConv2d(256, 256, 1))
            self.add_module(f"bn_end{i}", HGNorm(256, norm))
            self.add_module(f"l{i}", LecunConv2d(256, num_joints, 1))
            if i < num_stacks - 1:
                self.add_module(f"bl{i}", LecunConv2d(256, 256, 1))
                self.add_module(f"al{i}", LecunConv2d(num_joints, 256, 1))

    def forward(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """x: (B, H, W, 3) NHWC -> ([(B, H/4, W/4, K) float32 per stack],
        normx NHWC); ``ave_pool`` halves once more, ``no_down`` keeps H/2."""
        x = x.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.conv2(x)
        if self.down_type == "conv64":
            x = self.down_conv2(x)
        elif self.down_type == "ave_pool":
            x = F.avg_pool2d(x, 2, 2)
        normx = x
        x = self.conv4(self.conv3(x))

        outputs = []
        previous = x
        for i in range(self.num_stacks):
            hg = getattr(self, f"m{i}")(previous)
            ll = getattr(self, f"top_m_{i}")(hg)
            ll = torch.relu(getattr(self, f"bn_end{i}")(getattr(self, f"conv_last{i}")(ll)))
            tmp_out = getattr(self, f"l{i}")(ll)
            out = torch.tanh(tmp_out) if self.use_sigmoid else tmp_out
            # float32 out (float64 for a float64 model)
            out = out.to(torch.promote_types(out.dtype, torch.float32))
            outputs.append(out.permute(0, 2, 3, 1))
            if i < self.num_stacks - 1:
                bl, al = getattr(self, f"bl{i}"), getattr(self, f"al{i}")
                previous = previous + bl(ll) + al(tmp_out)
        return outputs, normx.permute(0, 2, 3, 1)


def hourglass_from_cfg(cfg) -> HGFilter:
    """HGFilter from MODEL.EXTRA's NUM_STACKS (2), DEPTH (2) and
    LAST_CHANNELS (MODEL.NUM_JOINTS), in eval mode (JAX
    ``hourglass_from_cfg``, ``models/hourglass.py:159``)."""
    extra = cfg.MODEL.EXTRA
    return HGFilter(num_stacks=int(extra.get("NUM_STACKS", 2)),
                    depth=int(extra.get("DEPTH", 2)),
                    num_joints=int(extra.get("LAST_CHANNELS", cfg.MODEL.NUM_JOINTS))).eval()
