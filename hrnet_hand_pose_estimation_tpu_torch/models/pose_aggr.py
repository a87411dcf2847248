"""Temporal pose aggregation with deformable warping (PoseAggr), in PyTorch.

Port of the JAX package's ``models/pose_aggr.py`` (reference
lib/models/pose_hrnet_PoseAggr.py:287-738): a plain-head HRNet gives each
frame's heatmap logits; offsets come from the differences between the
centre frame's logits and every frame's, through a shared 20-BasicBlock
chain (``offset_feats``, in bfloat16 whatever ``TPU.COMPUTE_DTYPE`` says:
the JAX module's default dtype, which the registry does not set), then five
dilated 3x3 offset heads (MODEL.DILATION_RATES) drive five grouped
deformable convolutions (``ops/deform_conv.py``, one offset field per
joint) that warp every frame toward the centre.  The warps average, the
frames fuse with the fixed weights 0.1 / 0.25 / 0.3 / 0.25 / 0.1 at T = 5
(the normalised distance rule otherwise), and the spatial softmax at the
temperature ends it.

With MODEL.HEATMAP_SOFTMAX the model has ``head = "softmax"`` and
``forward_logits``, so ``core/evaluator.Evaluator2D`` decodes its fused
logits with ``ops.decode.softmax_decode`` (B4 on a card), the JAX package's
``soft_argmax(spatial_softmax(fused, T))``.  ``offset_feats`` keeps the
reference's torch names (``offset_feats.0.conv1``); the offset heads and
the deform kernels are named by their flax paths (``offsets1``,
``deform_kernel1``, (3, 3, K, K) HWIO).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.decode import spatial_softmax
from ..ops.deform_conv import deform_conv2d
from .hrnet import HRNetOutput, PoseHRNet
from .layers import ResLayer


def fusion_weights(t: int, device=None) -> torch.Tensor:
    """The frames' fixed fusion weights (reference :636-642), built on
    ``device``: 0.1, 0.25, 0.3, 0.25, 0.1 at five frames; else 0.3 at the
    centre, 0.25 at +-1, 0.1 beyond, normalised to sum 1."""
    dist = (torch.arange(t, device=device) - t // 2).abs()
    w = torch.where(dist == 0, 0.3, torch.where(dist == 1, 0.25, 0.1))
    return w if t == 5 else w / w.sum()


class PoseAggrNet(nn.Module):
    """Centre-frame refinement from deformably warped frame heatmaps.
    ``backbone`` is a plain-head ``PoseHRNet`` (logits); frames (B, T, H, W,
    3) NHWC, the centre frame T // 2 the reference.  ``offset_dtype`` is the
    offset chain's compute dtype (JAX's ``dtype``)."""

    def __init__(self, backbone: PoseHRNet, seq_len: int = 5, num_joints: int = 21,
                 dilation_rates: Sequence[int] = (3, 6, 12, 18, 24), inner_channels: int = 128,
                 offset_blocks: int = 20, heatmap_softmax: bool = True,
                 trainable_softmax: bool = False, offset_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        k = num_joints
        self.backbone = backbone
        self.seq_len = seq_len
        self.num_joints = k
        self.dilation_rates = tuple(int(d) for d in dilation_rates)
        self.offset_dtype = offset_dtype
        self.heatmap_softmax = heatmap_softmax
        self.trainable_softmax = trainable_softmax
        self.offset_feats = ResLayer("BASIC", k, inner_channels, offset_blocks)
        for i, d in enumerate(self.dilation_rates, 1):
            self.add_module(f"offsets{i}", nn.Conv2d(inner_channels, k * 2 * 9, 3, 1, d,
                                                     dilation=d, bias=False))
            self.register_parameter(f"deform_kernel{i}", nn.Parameter(torch.zeros(3, 3, k, k)))
        if heatmap_softmax:
            self.head = "softmax"
            self.trainable_temp = nn.Parameter(torch.ones(()))

    @torch.no_grad()
    def init_train_weights(self, gen: torch.Generator) -> None:
        """flax's ``normal(0.001)`` deform kernels; the offset heads, being
        ``nn.Conv2d``s, get the same from the train state's init."""
        for i in range(1, len(self.dilation_rates) + 1):
            kernel = getattr(self, f"deform_kernel{i}")
            kernel.copy_(torch.normal(0.0, 0.001, kernel.shape, generator=gen))

    def _fused(self, frames: torch.Tensor) -> torch.Tensor:
        """frames -> the fused centre-frame logits (B, h, w, K), float32."""
        b, t = frames.shape[:2]
        k = self.num_joints
        hm = self.backbone(frames.reshape(b * t, *frames.shape[2:])).heatmaps   # (BT, h, w, K)
        h, w = hm.shape[1:3]
        ref = hm.reshape(b, t, h, w, k)[:, t // 2]
        # differences against the tiled centre frame (:600-605)
        diff = (ref.repeat_interleave(t, dim=0) - hm).to(self.offset_dtype)
        kind = frames.device.type
        with torch.autocast(kind, dtype=self.offset_dtype,
                            enabled=self.offset_dtype != torch.float32):
            feats = self.offset_feats(diff.permute(0, 3, 1, 2))
        with torch.autocast(kind, enabled=False):
            feats = feats.float()
            warped = 0.0
            for i, d in enumerate(self.dilation_rates, 1):
                off = getattr(self, f"offsets{i}")(feats).permute(0, 2, 3, 1)
                warped = warped + deform_conv2d(hm, off, getattr(self, f"deform_kernel{i}"),
                                                padding=d, dilation=d, deformable_groups=k)
            warped = (warped / len(self.dilation_rates)).reshape(b, t, h, w, k)
            weights = fusion_weights(t, warped.device)
            return (warped * weights[None, :, None, None, None]).sum(dim=1)

    def _temperature(self) -> torch.Tensor:
        return self.trainable_temp if self.trainable_softmax else self.trainable_temp.detach()

    def forward_logits(self, frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the fused logits, the temperature): ``forward(frames).heatmaps ==
        spatial_softmax(*forward_logits(frames))``.  Needs MODEL.HEATMAP_SOFTMAX."""
        return self._fused(frames), self._temperature()

    def forward(self, frames: torch.Tensor) -> HRNetOutput:
        fused = self._fused(frames)
        if not self.heatmap_softmax:
            return HRNetOutput(fused, fused, None, None)
        temp = self._temperature()
        return HRNetOutput(spatial_softmax(fused, temp), fused, temp, None)
