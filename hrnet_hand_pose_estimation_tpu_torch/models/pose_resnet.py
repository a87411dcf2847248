"""SimpleBaseline: a ResNet backbone and a deconv head, in PyTorch.

Port of the JAX package's ``models/pose_resnet.py`` (reference
lib/models/pose_resnet.py:103-271): a torchvision-style ResNet feature
extractor, NUM_DECONV_LAYERS transposed convs with BN and ReLU, and a final
conv to K heatmap logits.

The modules carry the reference torch names (``conv1``, ``bn1``,
``layerN.i.convK`` / ``bnK`` / ``downsample.{0,1}``,
``deconv_layers.{3i, 3i+1}``, ``final_layer``), the names the JAX package's
``utils/torch_convert._resolve_pose_resnet`` reads, so a reference
checkpoint loads by name.

flax's ``ConvTranspose(4, strides 2, padding (2, 2))`` (``transpose_kernel``
off) runs a plain conv over the stride-dilated input padded by 2; torch's
``ConvTranspose2d(k=4, s=2, p=1)`` is the same map with its kernel flipped
in space and its in/out axes swapped (``utils/weights.py`` converts).

The model returns raw logits and no temperature: with HEATMAP_SOFTMAX the
JAX package decodes them by ``soft_argmax`` of the logits themselves, which
is not kernel B4's function, so the model has no ``head == "softmax"`` for
the evaluator to find.  NHWC at the interface; parameters float32, the
compute dtype from ``torch.autocast``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .hrnet import HRNetOutput
from .layers import BLOCK_EXPANSION, LecunConv2d, ResLayer, batch_norm, lecun_normal_

RESNET_SPECS = {
    18: ("BASIC", (2, 2, 2, 2)),
    34: ("BASIC", (3, 4, 6, 3)),
    50: ("BOTTLENECK", (3, 4, 6, 3)),
    101: ("BOTTLENECK", (3, 4, 23, 3)),
    152: ("BOTTLENECK", (3, 8, 36, 3)),
}


class DeconvLayer(nn.ConvTranspose2d):
    """``ConvTranspose2d(k=4, s=2, p=1)``, no bias: twice the input's size;
    trained from flax's default ``ConvTranspose`` init (lecun normal over the
    kernel's 16 * in_channels window)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 4, 2, 1, bias=False)

    @torch.no_grad()
    def init_train_weights(self, gen: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[0] * 16, gen)


class ResNetBackbone(nn.Module):
    """The ResNet feature extractor (JAX ``ResNetBackbone``): NCHW image
    in, (B, 512 * expansion, H/32, W/32) NCHW features out."""

    def __init__(self, num_layers: int = 50):
        super().__init__()
        block, layers = RESNET_SPECS[num_layers]
        self.conv1 = LecunConv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = batch_norm(64)
        in_ch = 64
        for i, (planes, n, stride) in enumerate(zip((64, 128, 256, 512), layers, (1, 2, 2, 2))):
            self.add_module(f"layer{i + 1}", ResLayer(block, in_ch, planes, n, stride))
            in_ch = planes * BLOCK_EXPANSION[block]
        self.out_channels = in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)        # flax's max_pool pads with -inf, as torch
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x


class PoseResNet(ResNetBackbone):
    """Backbone + deconv head -> heatmap logits (reference pose_resnet.py:168-229).
    The backbone's modules sit at the top level, as in the reference."""

    def __init__(self, num_layers: int = 50, num_joints: int = 21, num_deconv_layers: int = 3,
                 deconv_filters: Sequence[int] = (256, 256, 256), final_conv_kernel: int = 1):
        super().__init__(num_layers)
        layers, in_ch = [], self.out_channels
        for i in range(num_deconv_layers):
            layers += [DeconvLayer(in_ch, deconv_filters[i]), batch_norm(deconv_filters[i]),
                       nn.ReLU()]
            in_ch = deconv_filters[i]
        self.deconv_layers = nn.Sequential(*layers)
        pad = 1 if final_conv_kernel == 3 else 0
        self.final_layer = LecunConv2d(in_ch, num_joints, final_conv_kernel, 1, pad)

    def forward(self, x: torch.Tensor) -> HRNetOutput:
        """x: (B, H, W, 3) NHWC -> HRNetOutput(float32 NHWK logits, NHWC
        backbone features, None, None)."""
        feat = super().forward(x.to(self.conv1.weight.dtype).permute(0, 3, 1, 2))
        hm = self.final_layer(self.deconv_layers(feat))
        return HRNetOutput(hm.float().permute(0, 2, 3, 1), feat.permute(0, 2, 3, 1), None, None)


def pose_resnet_from_cfg(cfg) -> PoseResNet:
    """PoseResNet from MODEL.EXTRA's NUM_LAYERS, NUM_DECONV_LAYERS,
    NUM_DECONV_FILTERS and FINAL_CONV_KERNEL, in eval mode."""
    extra = cfg.MODEL.EXTRA
    filters: Tuple[int, ...] = tuple(int(f) for f in extra.get("NUM_DECONV_FILTERS",
                                                              [256, 256, 256]))
    return PoseResNet(num_layers=int(extra.get("NUM_LAYERS", 50)),
                      num_joints=int(cfg.MODEL.NUM_JOINTS),
                      num_deconv_layers=int(extra.get("NUM_DECONV_LAYERS", 3)),
                      deconv_filters=filters,
                      final_conv_kernel=int(extra.get("FINAL_CONV_KERNEL", 1))).eval()
