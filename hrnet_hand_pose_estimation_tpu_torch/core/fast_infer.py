"""bf16 serving fast path: layer1 and the head through the port's CUDA kernels.

Port of the JAX package's ``core/fast_infer.py`` (defaults only): the stem
and stages 2-4 run as PyTorch bf16 convs with BN folded in, layer1 runs
through ``ops/kernels/fused_bottleneck.fused_bottleneck_chain`` and the head,
softmax and soft-argmax through ``ops/kernels/fused_head_decode.fused_head_decode_v2``.

    weights = precast_variables(cfg, state_dict)      # once, on the card
    infer = make_fast_infer(cfg)
    coords = infer(weights, images)   # (B, 256, 256, 3) -> (B, K, 2) [u, v]

``images`` are normalized float images in NHWC, as the JAX path takes them.
"""

from __future__ import annotations

import copy
from typing import Mapping, NamedTuple, Sequence, Tuple

import torch
from torch import nn

from ..models.hrnet import PoseHRNet, hrnet_from_cfg
from ..models.layers import BasicBlock, Bottleneck, ConvBN, fold_bn
from ..ops.kernels.fused_bottleneck import fold_layer1_params, fused_bottleneck_chain
from ..ops.kernels.fused_head_decode import HeadParams, fused_head_decode_v2, prepare_head_params


class ServingWeights(NamedTuple):
    """What ``make_fast_infer``'s function runs on, made by ``precast_variables``."""

    model: PoseHRNet       # BN folded into the convs, cast, channels_last; layer1 and head unused
    layer1: Tuple[Tuple[torch.Tensor, ...], Tuple[bool, ...]]   # fused_bottleneck_chain params
    head: HeadParams


def _fold_cb(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> nn.Conv2d:
    """The conv with eval-mode BN folded in (weight and bias, float32)."""
    kernel, bias = fold_bn(conv.weight, conv.bias, bn.weight, bn.bias,
                           bn.running_mean, bn.running_var)
    folded = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size,
                       conv.stride, conv.padding, bias=True)
    with torch.no_grad():
        folded.weight.copy_(kernel)
        folded.bias.copy_(bias)
    return folded


def _fold_model(model: PoseHRNet) -> PoseHRNet:
    """A copy of ``model`` whose stem, transition, branch and fuse convs
    carry their BN, each BN replaced by the identity."""
    model = copy.deepcopy(model)
    pairs = [(model, "conv1", "bn1"), (model, "conv2", "bn2")]
    for module in model.modules():
        if isinstance(module, (BasicBlock, Bottleneck)):
            n = 3 if isinstance(module, Bottleneck) else 2
            pairs += [(module, f"conv{i}", f"bn{i}") for i in range(1, n + 1)]
        elif isinstance(module, ConvBN):
            pairs.append((module, "0", "1"))
    for parent, conv, bn in pairs:
        setattr(parent, conv, _fold_cb(getattr(parent, conv), getattr(parent, bn)))
        setattr(parent, bn, nn.Identity())
    return model


def precast_variables(cfg, state: Mapping[str, torch.Tensor], device="cuda") -> ServingWeights:
    """One-time serving weights from a PoseHRNet state_dict: the stem and
    stage convs BN-folded and cast to bf16 in channels_last, layer1
    folded into the chain kernel's params, and the head folded into
    ``HeadParams`` (with the folds taken in float32 before any cast, as in
    the JAX package)."""
    device = torch.device(device)
    model = hrnet_from_cfg(cfg, head="softmax")
    model.load_state_dict(state)
    state = {k: v.to(device) for k, v in model.state_dict().items()}
    layer1 = fold_layer1_params(state)
    head = prepare_head_params(state)
    # w_head stays float32: the int8 serving path folds its input scales
    # into it before the bf16 cast (core/quant_infer.py)
    head = head._replace(w_final=head.w_final.to(torch.bfloat16))
    served = _fold_model(model).to(device=device, dtype=torch.bfloat16,
                                   memory_format=torch.channels_last).eval()
    return ServingWeights(served, layer1, head)


def make_fast_infer(cfg, device="cuda"):
    """The serving function ``infer(weights, images) -> (B, K, 2)`` on ``device``.

    ``weights`` come from ``precast_variables`` on the same device.  On a
    card both kernels launch; on the CPU their plain twins run.
    """
    device = torch.device(device)
    image_hw = tuple(int(s) for s in cfg.MODEL.IMAGE_SIZE)[::-1]   # (W, H) -> (H, W)
    num_joints = int(cfg.MODEL.NUM_JOINTS)

    def layer1(weights: ServingWeights):
        def run(x: torch.Tensor) -> torch.Tensor:      # NCHW channels_last <-> NHWC views
            y = fused_bottleneck_chain(x.permute(0, 2, 3, 1).contiguous(), *weights.layer1)
            return y.permute(0, 3, 1, 2)
        return run

    @torch.inference_mode()
    def infer(weights: ServingWeights, images: torch.Tensor) -> torch.Tensor:
        if images.dim() != 4 or tuple(images.shape[1:]) != image_hw + (3,):
            raise ValueError(f"images must be (B, {image_hw[0]}, {image_hw[1]}, 3), "
                             f"got {tuple(images.shape)}")
        if weights.head.w_final.shape[1] != num_joints:
            raise ValueError("weights were not made for this config's joints")
        x = images.to(device=device, dtype=torch.bfloat16).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        xs: Sequence[torch.Tensor] = weights.model.forward_backbone(x, layer1=layer1(weights))
        xs = [t.permute(0, 2, 3, 1).contiguous() for t in xs]
        return fused_head_decode_v2(xs, weights.head)

    return infer
