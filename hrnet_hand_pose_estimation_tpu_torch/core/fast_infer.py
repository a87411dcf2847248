"""bf16 serving fast path: layer1, the head and optionally the stem and the
stage 2-4 branch chains through the port's CUDA kernels.

Port of the JAX package's ``core/fast_infer.py``.  By default the stem and
stages 2-4 run as PyTorch bf16 convs with BN folded in, layer1 runs through
``ops/kernels/fused_bottleneck.fused_bottleneck_chain`` and the head,
softmax and soft-argmax through ``ops/kernels/fused_head_decode.fused_head_decode_v2``.
The options are the JAX package's, with its defaults and precedence:

- ``pallas_branches=True``: every stage 2-4 BasicBlock branch chain through
  ``fused_basic_chain``;
- ``fuse_stem_layer1=True``: the stem and layer1 through ``fused_stem_layer1``
  on the space-to-depth image;
- else ``s2d_stem=True``: the stem as two space-to-depth 2x2 convs (no kernel);
- ``pallas_layer1=False``: layer1 as the folded bf16 ResLayer.

    weights = precast_variables(cfg, state_dict)      # once, on the card
    infer = make_fast_infer(cfg)
    coords = infer(weights, images)   # (B, 256, 256, 3) -> (B, K, 2) [u, v]

``images`` are normalized float images in NHWC, as the JAX path takes them.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.hrnet import HRModule, PoseHRNet, hrnet_from_cfg
from ..models.layers import BasicBlock, Bottleneck, ConvBN, fold_bn
from ..ops.kernels.fused_bottleneck import (BASIC_WIDTHS, fold_branch_params, fold_conv_bn,
                                            fold_layer1_params, fused_basic_chain,
                                            fused_bottleneck_chain, fused_stem_layer1,
                                            pad_basic_params, prepare_stem_params)
from ..ops.kernels.fused_head_decode import HeadParams, fused_head_decode_v2, prepare_head_params
from ..ops.s2d import s2d_kernel, space_to_depth


class ServingWeights(NamedTuple):
    """What ``make_fast_infer``'s function runs on, made by ``precast_variables``."""

    model: PoseHRNet       # BN folded into the convs, cast, channels_last; layer1 and head unused
    layer1: Tuple[Tuple[torch.Tensor, ...], Tuple[bool, ...]]   # fused_bottleneck_chain params
    head: HeadParams
    stem_s2d: Tuple[torch.Tensor, ...]    # (k1, b1, k2, b2) bf16: _s2d_stem_apply's
    stem_flat: Tuple[torch.Tensor, ...]   # fused_stem_layer1's (prepare_stem_params)
    # ResLayer name -> fused_basic_chain params (on a card, at the kernel's width)
    branches: Dict[str, Tuple[torch.Tensor, ...]]


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


def prepare_s2d_stem(state: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The folded stem convs rewritten for the space-to-depth input, float32:
    (k1 (64, 12, 2, 2), b1, k2 (64, 256, 2, 2), b2), OIHW."""
    out = []
    for n in (1, 2):
        k, b = fold_conv_bn(state, f"conv{n}", f"bn{n}")
        out += [s2d_kernel(k.permute(3, 2, 0, 1)), b]
    return tuple(out)


def _s2d_stem_apply(stem: Sequence[torch.Tensor], images: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Both stem convs as space-to-depth 2x2 dense convs (JAX
    ``core/fast_infer._s2d_stem_apply``): NHWC images -> NCHW stem output.

    Each conv is padded by one row and column at the top and left only and
    rounds as JAX's: the conv to ``dtype``, then the bias added in ``dtype``."""
    k1, b1, k2, b2 = stem
    x = space_to_depth(images.to(dtype))
    for i, (k, b) in enumerate(((k1, b1), (k2, b2))):
        x = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (1, 0, 1, 0)), k.to(dtype))
        x = torch.relu(x + b.to(dtype)[:, None, None])
        if i == 0:
            x = space_to_depth(x.permute(0, 2, 3, 1))
    return x


def _branch_names(model: PoseHRNet):
    """Module names of the BasicBlock branch chains the branch hook runs."""
    for name, module in model.named_modules():
        if isinstance(module, HRModule) and module.block == "BASIC":
            for i in range(module.num_branches):
                if module.in_channels[i] == module.out_channels[i]:
                    yield f"{name}.branches.{i}"


def precast_variables(cfg, state: Mapping[str, torch.Tensor], device="cuda") -> ServingWeights:
    """One-time serving weights from a PoseHRNet state_dict: the stem and
    stage convs BN-folded and cast to bf16 in channels_last, layer1
    folded into the chain kernel's params, the head folded into
    ``HeadParams``, the stem folded for the space-to-depth paths and every
    BasicBlock branch chain for ``fused_basic_chain`` (with the folds taken
    in float32 before any cast, as in the JAX package).  On a card the
    branch chains are zero-padded once to a width their kernel takes
    (``pad_basic_params``: 8 -> 16, 18 -> 32, 40 -> 48, 72 -> 96, ...); on
    the CPU they keep the model's width.

    A state without ``trainable_temp`` is a plain-head model; it serves
    with softmax temperature 1, as the JAX package serves it.  Any other
    missing or unexpected key raises."""
    device = torch.device(device)
    model = hrnet_from_cfg(cfg, head="softmax" if "trainable_temp" in state else "plain")
    model.load_state_dict(state)
    state = {k: v.to(device) for k, v in model.state_dict().items()}
    layer1 = fold_layer1_params(state)
    head = prepare_head_params(state)
    # w_head stays float32: the int8 serving path folds its input scales
    # into it before the bf16 cast (core/quant_infer.py)
    head = head._replace(w_final=head.w_final.to(torch.bfloat16))
    stem_s2d = tuple(t.to(torch.bfloat16) for t in prepare_s2d_stem(state))
    branches = {name: fold_branch_params(state, name) for name in _branch_names(model)}
    if device.type == "cuda":
        branches = {name: pad_basic_params(p) if p[0].shape[-1] <= BASIC_WIDTHS[-1] else p
                    for name, p in branches.items()}
    served = _fold_model(model).to(device=device, dtype=torch.bfloat16,
                                   memory_format=torch.channels_last).eval()
    return ServingWeights(served, layer1, head, stem_s2d, prepare_stem_params(state), branches)


def _nhwc_fn(fn):
    """An NHWC -> NHWC function applied to NCHW channels_last tensors."""
    return lambda x: fn(x.permute(0, 2, 3, 1).contiguous()).permute(0, 3, 1, 2)


def make_fast_infer(cfg, pallas_layer1: bool = True, pallas_branches: bool = False,
                    s2d_stem: bool = False, fuse_stem_layer1: bool = False, device="cuda"):
    """The serving function ``infer(weights, images) -> (B, K, 2)`` on ``device``.

    ``weights`` come from ``precast_variables`` on the same device.  The
    options and their precedence are the JAX package's: ``fuse_stem_layer1``
    replaces the stem and layer1 (whatever ``pallas_layer1``), else
    ``s2d_stem`` the stem; ``pallas_layer1`` runs layer1 as the chain
    kernel, else as the folded ResLayer; ``pallas_branches`` runs the
    BasicBlock branch chains as ``fused_basic_chain``.  On a card every
    kernel of the configuration launches; on the CPU their plain twins run.
    """
    device = torch.device(device)
    image_hw = tuple(int(s) for s in cfg.MODEL.IMAGE_SIZE)[::-1]   # (W, H) -> (H, W)
    num_joints = int(cfg.MODEL.NUM_JOINTS)

    def parts(weights: ServingWeights):
        """(stem, layer1, branch) hooks of forward_backbone for this configuration."""
        stem = layer1 = branch = None
        if fuse_stem_layer1:
            stem = _nhwc_fn(lambda x: fused_stem_layer1(space_to_depth(x), weights.stem_flat,
                                                        *weights.layer1))
            layer1 = nn.Identity()
        else:
            if s2d_stem:
                stem = lambda x: _s2d_stem_apply(weights.stem_s2d, x.permute(0, 2, 3, 1))
            if pallas_layer1:
                layer1 = _nhwc_fn(lambda x: fused_bottleneck_chain(x, *weights.layer1))
        if pallas_branches:
            def branch(name: str, x: torch.Tensor) -> torch.Tensor:
                params = weights.branches[name]
                return _nhwc_fn(lambda t: fused_basic_chain(t, params, len(params) // 4))(x)
        return stem, layer1, branch

    @torch.inference_mode()
    def infer(weights: ServingWeights, images: torch.Tensor) -> torch.Tensor:
        if images.dim() != 4 or tuple(images.shape[1:]) != image_hw + (3,):
            raise ValueError(f"images must be (B, {image_hw[0]}, {image_hw[1]}, 3), "
                             f"got {tuple(images.shape)}")
        if weights.head.w_final.shape[1] != num_joints:
            raise ValueError("weights were not made for this config's joints")
        x = images.to(device=device, dtype=torch.bfloat16).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        stem, layer1, branch = parts(weights)
        xs: Sequence[torch.Tensor] = weights.model.forward_backbone(
            x, layer1=layer1, stem=stem, branch=branch)
        xs = [t.permute(0, 2, 3, 1).contiguous() for t in xs]
        return fused_head_decode_v2(xs, weights.head)

    return infer
