"""HRNet backbone + pose heads, in PyTorch.

Port of the JAX package's ``models/hrnet.py`` (StageCfg, HRModule, the
backbone, PoseHRNet with the plain and softmax heads).  The modules carry
the reference torch names (``conv1``, ``layer1.0.conv1``,
``transition1.1.0.0``, ``stage2.0.fuse_layers.1.0.0.0``, ``last_layer.3``,
``trainable_temp``), so a reference checkpoint loads by name and
``utils/weights.from_jax_variables`` maps the JAX tree onto them.

``PoseHRNet.forward`` takes and returns NHWC tensors like the JAX model;
inside, tensors are NCHW (channels_last memory on the serving path).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.decode import spatial_softmax
from ..ops.upsample import upsample_bilinear_align_corners, upsample_nearest
from .layers import BLOCK_EXPANSION, ConvBN, ResLayer, batch_norm


class StageCfg(NamedTuple):
    """Static description of one HRNet stage (MODEL.EXTRA.STAGEn in configs)."""

    num_modules: int
    num_branches: int
    block: str
    num_blocks: Tuple[int, ...]
    num_channels: Tuple[int, ...]

    @classmethod
    def from_cfg(cls, node) -> "StageCfg":
        return cls(
            num_modules=int(node["NUM_MODULES"]),
            num_branches=int(node["NUM_BRANCHES"]),
            block=str(node["BLOCK"]),
            num_blocks=tuple(int(b) for b in node["NUM_BLOCKS"]),
            num_channels=tuple(int(c) for c in node["NUM_CHANNELS"]),
        )

    @property
    def out_channels(self) -> Tuple[int, ...]:
        exp = BLOCK_EXPANSION[self.block]
        return tuple(c * exp for c in self.num_channels)


def _nchw(fn: Callable, x: torch.Tensor, *args) -> torch.Tensor:
    """Apply an NHWC op to an NCHW tensor."""
    return fn(x.permute(0, 2, 3, 1), *args).permute(0, 3, 1, 2)


# A branch hook: (module name of the branch's ResLayer, e.g.
# "stage3.1.branches.2", the NCHW input) -> the branch's NCHW output.
BranchHook = Callable[[str, torch.Tensor], torch.Tensor]


class HRModule(nn.Module):
    """One HighResolutionModule: per-branch residual blocks + exchange fusion
    (reference pose_hrnet.py:101-266)."""

    def __init__(self, stage: StageCfg, in_channels: Sequence[int]):
        super().__init__()
        s = stage
        out_ch = s.out_channels
        self.num_branches = s.num_branches
        self.block = s.block
        self.in_channels = tuple(in_channels)
        self.out_channels = out_ch
        self.branches = nn.ModuleList(
            ResLayer(s.block, in_channels[i], s.num_channels[i], s.num_blocks[i])
            for i in range(s.num_branches))
        self.fuse_layers = None
        if s.num_branches == 1:
            return
        fuse = nn.ModuleList()
        for i in range(s.num_branches):
            row = nn.ModuleList()
            for j in range(s.num_branches):
                if j > i:
                    # 1x1 conv + BN, nearest-upsampled 2^(j-i) in forward
                    row.append(ConvBN(out_ch[j], out_ch[i], 1, 1, relu=False))
                elif j == i:
                    row.append(None)
                else:
                    # chain of stride-2 3x3 convs; ReLU on all but the last
                    chain = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        chain.append(ConvBN(out_ch[j], out_ch[i] if last else out_ch[j],
                                            3, 2, relu=not last))
                    row.append(nn.Sequential(*chain))
            fuse.append(row)
        self.fuse_layers = fuse

    def forward(self, xs: List[torch.Tensor], branch: Optional[BranchHook] = None,
                name: str = "") -> List[torch.Tensor]:
        """``branch`` runs each branch that is a plain BasicBlock chain
        (eval mode, BASIC blocks, in == out channels: the JAX package's
        condition for its fused branch kernel) in place of the ResLayer;
        ``name`` is this module's name, which prefixes the branch's."""
        hook = branch is not None and not self.training and self.block == "BASIC"
        ys = [branch(f"{name}.branches.{i}", x)
              if hook and self.in_channels[i] == self.out_channels[i] else layer(x)
              for i, (layer, x) in enumerate(zip(self.branches, xs))]
        if self.fuse_layers is None:
            return ys
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                if j == i:
                    contrib = ys[j]
                elif j > i:
                    contrib = _nchw(upsample_nearest, layer(ys[j]), 2 ** (j - i))
                else:
                    contrib = layer(ys[j])
                acc = contrib if acc is None else acc + contrib
            fused.append(torch.relu(acc))
        return fused


def _transition(pre_ch: Sequence[int], stage: StageCfg) -> nn.ModuleList:
    """Add/convert branches between stages (reference :357-396): existing
    branches get a 3x3 ConvBNReLU only when channel counts differ; each new
    branch is a stride-2 3x3 ConvBNReLU chain from the coarsest branch."""
    out_ch = stage.out_channels
    layers = nn.ModuleList()
    for i in range(stage.num_branches):
        if i < len(pre_ch):
            layers.append(ConvBN(pre_ch[i], out_ch[i], 3, 1, relu=True)
                          if out_ch[i] != pre_ch[i] else None)
        else:
            chain = []
            for j in range(i + 1 - len(pre_ch)):
                ch = out_ch[i] if j == i - len(pre_ch) else pre_ch[-1]
                chain.append(ConvBN(pre_ch[-1], ch, 3, 2, relu=True))
            layers.append(nn.Sequential(*chain))
    return layers


def _apply_transition(layers: nn.ModuleList, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    outs = []
    for i, layer in enumerate(layers):
        if i < len(xs):
            outs.append(xs[i] if layer is None else layer(xs[i]))
        else:
            outs.append(layer(xs[-1]))
    return outs


class HRNetOutput(NamedTuple):
    """Forward outputs, as the JAX model's.

    - heatmaps: (B, H, W, K) probabilities (softmax head) or logits (plain)
    - features: (B, H, W, 480) concat of the upsampled branches
    - temperature: scalar softmax temperature (softmax head) or None
    """

    heatmaps: torch.Tensor
    features: torch.Tensor
    temperature: Optional[torch.Tensor] = None


class PoseHRNet(nn.Module):
    """HRNet + heatmap head.

    ``head``:
      - 'plain':   raw heatmap logits (reference pose_hrnet.py)
      - 'softmax': spatial softmax with (optionally trainable) temperature
                   (reference pose_hrnet_softmax.py)
    """

    def __init__(self, stage2: StageCfg, stage3: StageCfg, stage4: StageCfg,
                 num_joints: int = 21, head: str = "softmax",
                 trainable_softmax: bool = False, final_conv_kernel: int = 1):
        super().__init__()
        if head not in ("plain", "softmax"):
            raise ValueError(f"unknown head {head!r}")
        self.head = head
        # stem: two stride-2 3x3 convs -> 1/4 resolution (reference :285-291)
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = batch_norm(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = batch_norm(64)
        # layer1: 4 bottlenecks -> 256ch (reference :292)
        self.layer1 = ResLayer("BOTTLENECK", 64, 64, 4)

        pre = (256,)
        for idx, stage in ((1, stage2), (2, stage3), (3, stage4)):
            self.add_module(f"transition{idx}", _transition(pre, stage))
            self.add_module(f"stage{idx + 1}", nn.Sequential(*[
                HRModule(stage, stage.out_channels) for _ in range(stage.num_modules)]))
            pre = stage.out_channels

        # last_layer: 1x1 conv + BN + ReLU + final conv (reference :335-350)
        total = sum(pre)
        pad = 1 if final_conv_kernel == 3 else 0
        self.last_layer = nn.Sequential(
            nn.Conv2d(total, total, 1, 1, 0, bias=True),
            batch_norm(total),
            nn.ReLU(),
            nn.Conv2d(total, num_joints, final_conv_kernel, 1, pad, bias=True),
        )
        if head == "softmax":
            # always a parameter, as in the JAX model: when it is frozen the
            # forward stops its gradient, so the optimizer still holds it
            # with a zero gradient (and adamw decays it, as optax does)
            self.trainable_softmax = trainable_softmax
            self.trainable_temp = nn.Parameter(torch.ones(()))

    def forward_backbone(self, x: torch.Tensor,
                         layer1: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                         stem: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                         branch: Optional[BranchHook] = None) -> List[torch.Tensor]:
        """NCHW image -> the four NCHW branch tensors.  The serving paths
        replace parts with kernels: ``stem`` the two stem convs, ``layer1``
        the bottleneck chain, ``branch`` the stage 2-4 BasicBlock branch
        chains (see ``HRModule.forward``)."""
        if stem is None:
            x = torch.relu(self.bn1(self.conv1(x)))
            x = torch.relu(self.bn2(self.conv2(x)))
        else:
            x = stem(x)
        x = (layer1 or self.layer1)(x)
        xs = [x]
        for idx in (1, 2, 3):
            xs = _apply_transition(getattr(self, f"transition{idx}"), xs)
            for m, module in enumerate(getattr(self, f"stage{idx + 1}")):
                xs = module(xs, branch=branch, name=f"stage{idx + 1}.{m}")
        return xs

    def _logits(self, x: torch.Tensor, layer1=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(y, features): the head's NHWK logits, in the dtype the last conv
        gives, and the concat of the upsampled branches."""
        dtype = self.conv1.weight.dtype
        xs = self.forward_backbone(x.to(dtype).permute(0, 3, 1, 2), layer1=layer1)
        xs = [t.permute(0, 2, 3, 1) for t in xs]
        h, w = xs[0].shape[1:3]
        # bilinear(align_corners) upsample branches 1..3 and concat -> 480ch
        feats = [xs[0]] + [upsample_bilinear_align_corners(t, (h, w)) for t in xs[1:]]
        features = torch.cat(feats, dim=-1)
        y = self.last_layer(features.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return y, features

    def _temperature(self) -> Optional[torch.Tensor]:
        if self.head == "plain":
            return None
        return self.trainable_temp if self.trainable_softmax else self.trainable_temp.detach()

    def forward_logits(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: (B, H, W, 3) NHWC image -> (y, temperature): the head's NHWK
        logits before the spatial softmax, computed as ``forward`` computes
        them, and the softmax temperature (None for the plain head).  For the
        softmax head ``forward(x).heatmaps == spatial_softmax(y, temperature)``;
        the 2D evaluator decodes ``y`` with ``ops.decode.softmax_decode``."""
        y, _ = self._logits(x)
        return y, self._temperature()

    def forward(self, x: torch.Tensor,
                layer1: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> HRNetOutput:
        """x: (B, H, W, 3) NHWC image -> HRNetOutput with NHWC maps.
        ``layer1`` is passed on to ``forward_backbone``."""
        y, features = self._logits(x, layer1)
        temp = self._temperature()
        if temp is None:
            return HRNetOutput(y.float(), features, None)
        return HRNetOutput(spatial_softmax(y, temp), features, temp)


def hrnet_from_cfg(cfg, head: str = "softmax", **overrides) -> PoseHRNet:
    """Build a PoseHRNet from a loaded config (MODEL.EXTRA.STAGE2/3/4), in
    eval mode (the train step puts it in train mode)."""
    extra = cfg.MODEL.EXTRA
    kwargs = dict(
        stage2=StageCfg.from_cfg(extra["STAGE2"]),
        stage3=StageCfg.from_cfg(extra["STAGE3"]),
        stage4=StageCfg.from_cfg(extra["STAGE4"]),
        num_joints=int(cfg.MODEL.NUM_JOINTS),
        head=head,
        trainable_softmax=bool(cfg.MODEL.TRAINABLE_SOFTMAX),
        final_conv_kernel=int(extra.get("FINAL_CONV_KERNEL", 1)),
    )
    kwargs.update(overrides)
    return PoseHRNet(**kwargs).eval()
