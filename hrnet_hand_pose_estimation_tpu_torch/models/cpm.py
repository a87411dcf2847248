"""Convolutional Pose Machine, in PyTorch.

Port of the JAX package's ``models/cpm.py`` (reference lib/models/CPM.py
and CPM_volumetric.py):

- ``CPM``: stage 1 is a 7-conv trunk; stages 2..6 share a pooled feature
  trunk and refine the previous stage's belief maps concatenated with the
  centre map pooled to belief resolution.  NHWC image and centre map in,
  the list of six (B, H/8, W/8, K+1) float32 belief maps out (channel 0 is
  the background);
- ``CPMTrunk``: the shared trunk, 3 x (9x9 conv, ReLU, 3/2/1 max-pool);
- ``CPMRefine``: one refinement stage;
- ``CPMVolumetric``: the CPM backbone of the ``vol_CPM`` triangulation net:
  ``forward_head`` gives the last stage's joint logits and a second
  trunk's features.

The convs carry the reference torch names (``conv{1..7}_stage1``, the
shared trunk ``conv{1,2,3}_stage2``, stage 2's feature conv
``conv4_stage2``, ``conv1_stage{3..6}``, ``Mconv{1..5}_stage{2..6}``), the
names the JAX package's ``utils/torch_convert._resolve_cpm`` reads, so a
reference checkpoint loads by name.  Parameters are float32; under
``torch.autocast`` the convs, pools and concats run in the compute dtype,
as the JAX module's ``dtype=bf16, param_dtype=f32`` (the centre map is cast
to it before its pool); the belief maps come out in float32.  No BN: the
train and eval forwards are the same.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.targets import gaussian_centermap
from .hrnet import HRNetOutput
from .layers import compute_dtype, lecun_normal_

STAGES = (2, 3, 4, 5, 6)


class Conv(nn.Conv2d):
    """A k x k same-padded conv with a bias (flax ``nn.Conv`` with
    ``padding=k // 2``); trained from flax's default initialisation."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int):
        super().__init__(in_channels, out_channels, kernel, 1, kernel // 2, bias=True)

    @torch.no_grad()
    def init_train_weights(self, gen: torch.Generator) -> None:
        """flax's ``lecun_normal``: a normal of std sqrt(1 / fan_in) / 0.8796
        truncated at two of its std; the bias 0."""
        lecun_normal_(self.weight, self.weight[0].numel(), gen)
        self.bias.zero_()


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """torch's MaxPool2d(3, 2, 1), flax's max_pool with (1, 1) padding."""
    return F.max_pool2d(x, 3, 2, 1)


def _trunk(convs: Sequence[nn.Conv2d], x: torch.Tensor) -> torch.Tensor:
    for conv in convs:
        x = _maxpool(torch.relu(conv(x)))
    return x


class CPMTrunk(nn.Module):
    """3 x (9x9 conv + ReLU + max-pool) trunk (reference _middle, CPM.py:83-89);
    NCHW in and out.  ``CPMVolumetric``'s ``feat_trunk``; ``CPM`` runs the
    same function on its ``conv{1,2,3}_stage2``."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1 = Conv(in_channels, 128, 9)
        self.conv2 = Conv(128, 128, 9)
        self.conv3 = Conv(128, 128, 9)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _trunk((self.conv1, self.conv2, self.conv3), x)


class CPMRefine:
    """One refinement stage (reference _stage{2..6}, CPM.py:91-135) over the
    convs ``CPM`` registers under the reference names: the 5x5 feature conv
    of the trunk, concat with the previous belief and the pooled centre map,
    three 11x11 and one 1x1 conv with ReLU, and the 1x1 output conv."""

    def __init__(self, conv_feat: nn.Conv2d, mconvs: Sequence[nn.Conv2d]):
        self.conv_feat = conv_feat
        self.mconvs = tuple(mconvs)

    def __call__(self, trunk: torch.Tensor, prev_belief: torch.Tensor,
                 center: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv_feat(trunk))
        x = torch.cat([x, prev_belief.to(x.dtype), center.to(x.dtype)], dim=1)
        for conv in self.mconvs[:-1]:
            x = torch.relu(conv(x))
        return self.mconvs[-1](x)


class CPM(nn.Module):
    """6-stage pose machine: ``forward(image, centermap)`` -> the six belief maps."""

    def __init__(self, num_joints: int = 21):
        super().__init__()
        self.num_joints = num_joints
        k1 = num_joints + 1
        # stage 1 (reference _stage1, CPM.py:71-81)
        for i, (cin, cout, k) in enumerate(((3, 128, 9), (128, 128, 9), (128, 128, 9),
                                            (128, 32, 5), (32, 512, 9), (512, 512, 1),
                                            (512, k1, 1)), 1):
            self.add_module(f"conv{i}_stage1", Conv(cin, cout, k))
        # the shared trunk, then stages 2..6
        for i in (1, 2, 3):
            self.add_module(f"conv{i}_stage2", Conv(3 if i == 1 else 128, 128, 9))
        for s in STAGES:
            self.add_module(self._feat_name(s), Conv(128, 32, 5))
            for i, (cin, cout, k) in enumerate(((32 + k1 + 1, 128, 11), (128, 128, 11),
                                                (128, 128, 11), (128, 128, 1), (128, k1, 1)), 1):
                self.add_module(f"Mconv{i}_stage{s}", Conv(cin, cout, k))
        # the centre map pooled to belief resolution (reference pool_center:
        # avg 9/8/1, padding counted as flax's avg_pool counts it)
        self.pool_center = nn.AvgPool2d(9, 8, 1, count_include_pad=True)

    @staticmethod
    def _feat_name(stage: int) -> str:
        return "conv4_stage2" if stage == 2 else f"conv1_stage{stage}"

    def refine(self, stage: int) -> CPMRefine:
        return CPMRefine(getattr(self, self._feat_name(stage)),
                         [getattr(self, f"Mconv{i}_stage{stage}") for i in range(1, 6)])

    def example_inputs(self, batch: int, h: int, w: int, device) -> Tuple[torch.Tensor, ...]:
        """Zero images and centre maps of a forward (``utils/summary.py``)."""
        return (torch.zeros((batch, h, w, 3), device=device),
                torch.zeros((batch, h, w, 1), device=device))

    def forward(self, image: torch.Tensor, centermap: torch.Tensor) -> List[torch.Tensor]:
        """image (B, H, W, 3), centermap (B, H, W, 1) NHWC -> six (B, H/8, W/8,
        K+1) float32 belief maps, stage 1 first."""
        x = image.to(self.conv1_stage1.weight.dtype).permute(0, 3, 1, 2)
        center = self.pool_center(centermap.permute(0, 3, 1, 2).to(compute_dtype(x)))
        y = x
        for i in range(1, 7):
            y = torch.relu(getattr(self, f"conv{i}_stage1")(y))
            if i <= 3:
                y = _maxpool(y)
        belief = self.conv7_stage1(y)
        trunk = _trunk((self.conv1_stage2, self.conv2_stage2, self.conv3_stage2), x)
        beliefs = [belief.float()]
        for s in STAGES:
            belief = self.refine(s)(trunk, belief, center)
            beliefs.append(belief.float())
        return [b.permute(0, 2, 3, 1) for b in beliefs]


class CPMVolumetric(nn.Module):
    """CPM backbone of the volumetric triangulation net (reference
    CPM_volumetric.py:44-226, JAX ``models/cpm.py:75-98``): the last stage's
    belief maps without the background channel are the joint logits
    (temperature 1), and a second trunk, ``feat_trunk``, gives the features
    the net unprojects (128 channels, float32).  No confidences.  The centre
    map, when none is given, is a sigma-``center_sigma`` Gaussian at the
    image centre (``ops.targets.gaussian_centermap``)."""

    def __init__(self, num_joints: int = 21, center_sigma: float = 3.0):
        super().__init__()
        self.num_joints = num_joints
        self.center_sigma = center_sigma
        self.cpm = CPM(num_joints)
        self.feat_trunk = CPMTrunk()

    @property
    def feature_channels(self) -> int:
        return self.feat_trunk.conv3.out_channels

    def forward_head(self, image: torch.Tensor, centermap: Optional[torch.Tensor] = None
                     ) -> HRNetOutput:
        """(B, H, W, 3) -> HRNetOutput with the float32 joint logits as
        ``heatmaps``, the features, the temperature 1.0 and no confidences:
        the interface ``models/triangulation.backbone_2d`` decodes (with
        ``ops.decode.softmax_decode``, i.e. kernel B4 on the card; JAX's
        module returns the spatial softmax of these logits)."""
        if centermap is None:
            b, h = image.shape[0], image.shape[1]
            center = torch.full((b, 2), (h - 1) / 2.0, dtype=torch.float32, device=image.device)
            centermap = gaussian_centermap(center, h, self.center_sigma)
        logits = self.cpm(image, centermap)[-1][..., 1:]
        x = image.to(self.feat_trunk.conv1.weight.dtype).permute(0, 3, 1, 2)
        features = self.feat_trunk(x).float().permute(0, 2, 3, 1)
        return HRNetOutput(logits, features, 1.0, None)
