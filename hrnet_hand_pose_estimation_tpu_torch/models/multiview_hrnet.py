"""Cross-view fusion pose net ('MHP_mv' 2D path), in PyTorch.

Port of the JAX package's ``models/multiview_hrnet.py`` (reference
lib/models/multiview_pose_hrnet.py:15-126):

- ``Aggregation``: for each target view, every other view's heatmap planes
  go through that ordered pair's dense (HW x HW) mixing and are summed with
  the fixed weights [0.4, 0.2, 0.2, 0.2].  The V*(V-1) pair FCs are one
  (P, HW, HW) parameter, ``aggregation.pair_fc``, in the JAX pair order
  (for target i, the sources j != i in order).  The reference's per-pair
  ``ChannelWiseFC`` modules have no resolver in the JAX package's
  ``utils/torch_convert.py``, so the stacked name is the port's own.  The
  mixing is a plain float32 matmul (JAX's ``precision=HIGHEST``): autocast
  off and TF32 off in its forward and backward;
- ``MultiViewPoseNet``: the softmax HRNet on every view (views folded into
  the batch), then the aggregation.

The backbone is trained whole: the JAX 2D ``Trainer`` builds a plain
optimizer, whatever the JAX module's docstring says of freezing.
``MultiViewOutput`` carries, beside JAX's two fields, the backbone's
logits and temperature: the train step decodes the raw heatmaps from them
with ``ops.decode.softmax_decode`` (kernel B4 on the card).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.decode import spatial_softmax
from ..ops.precision import no_tf32
from .hrnet import PoseHRNet
from .layers import lecun_normal_

WEIGHTS = (0.4, 0.2, 0.2, 0.2)


class MultiViewOutput(NamedTuple):
    fused_heatmaps: torch.Tensor                  # (B, V, h, w, K) float32
    raw_heatmaps: torch.Tensor                    # (B, V, h, w, K) probabilities
    logits: Optional[torch.Tensor] = None         # (B, V, h, w, K) before the softmax
    temperature: Optional[torch.Tensor] = None    # the backbone's softmax temperature


class _Float32MatMul(torch.autograd.Function):
    """(..., N) @ (N, M) in float32 with TF32 off in both passes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with no_tf32():
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with no_tf32():
            if ctx.needs_input_grad[0]:
                ga = g @ b.t()
            if ctx.needs_input_grad[1]:
                gb = a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return ga, gb


class Aggregation(nn.Module):
    """Learned cross-view heatmap mixing (reference :32-72) of ``n_views``
    views of ``hm_size`` x ``hm_size`` maps."""

    def __init__(self, n_views: int = 4, hm_size: int = 64,
                 weights: Sequence[float] = WEIGHTS):
        super().__init__()
        if n_views > len(weights):
            raise ValueError(f"{n_views} views need {n_views} fusion weights, got {weights}")
        self.n_views = n_views
        self.hm_size = hm_size
        self.weights = tuple(float(w) for w in weights)
        hw = hm_size * hm_size
        self.pair_fc = nn.Parameter(torch.zeros(n_views * (n_views - 1), hw, hw))

    @torch.no_grad()
    def init_train_weights(self, gen: torch.Generator) -> None:
        """flax's ``lecun_normal`` on the (P, HW, HW) tensor: fan_in = HW * P."""
        lecun_normal_(self.pair_fc, self.pair_fc.shape[1] * self.pair_fc.shape[0], gen)

    def forward(self, heatmaps: torch.Tensor) -> torch.Tensor:
        """(B, V, h, w, K) -> fused (B, V, h, w, K) float32."""
        b, v, h, w, k = heatmaps.shape
        if (v, h, w) != (self.n_views, self.hm_size, self.hm_size):
            raise ValueError(f"Aggregation of {self.n_views} views of {self.hm_size}^2 maps got "
                             f"{tuple(heatmaps.shape)}")
        with torch.autocast(heatmaps.device.type, enabled=False):
            planes = heatmaps.float().permute(0, 1, 4, 2, 3).reshape(b, v, k, h * w)
            # read once: split over a 'model' axis, each read gathers the shards
            pair_fc = self.pair_fc
            outputs, idx = [], 0
            for i in range(v):
                acc = planes[:, i] * self.weights[0]
                wi = 1
                for j in range(v):
                    if j == i:
                        continue
                    warped = _Float32MatMul.apply(planes[:, j], pair_fc[idx])
                    acc = acc + warped * self.weights[wi]
                    idx += 1
                    wi += 1
                outputs.append(acc)
            fused = torch.stack(outputs, dim=1).reshape(b, v, k, h, w)
        return fused.permute(0, 1, 3, 4, 2)


class MultiViewPoseNet(nn.Module):
    """Backbone per view + aggregation (reference :74-126)."""

    def __init__(self, backbone: PoseHRNet, n_views: int = 4, hm_size: int = 64,
                 aggre: bool = True):
        super().__init__()
        if backbone.head != "softmax":
            raise ValueError("the fusion net's backbone has the softmax head")
        self.backbone = backbone
        self.n_views = n_views
        self.aggregation = Aggregation(n_views, hm_size) if aggre else None

    def example_inputs(self, batch: int, h: int, w: int, device) -> Tuple[torch.Tensor]:
        """Zero views of a forward (``utils/summary.py``)."""
        return (torch.zeros((batch, self.n_views, h, w, 3), device=device),)

    def forward(self, views: torch.Tensor) -> MultiViewOutput:
        """views: (B, V, H, W, 3) NHWC -> MultiViewOutput."""
        b, v = views.shape[:2]
        out = self.backbone.forward_head(views.reshape(b * v, *views.shape[2:]))
        logits = out.heatmaps.reshape(b, v, *out.heatmaps.shape[1:])
        with torch.autocast(views.device.type, enabled=False):
            raw = spatial_softmax(out.heatmaps, out.temperature)
        raw = raw.reshape(b, v, *raw.shape[1:])
        fused = raw if self.aggregation is None else self.aggregation(raw)
        return MultiViewOutput(fused, raw, logits, out.temperature)
