"""The transformer pose models of the JAX package's ``models/transformers.py``,
in PyTorch: the temporal PoseFormer and the RVT pooling transformer.

``PoseTransformer`` (reference lib/models/pose_hrnet_transformer.py:87-245):
per-frame HRNet decodes -> spatial attention over the joints of each frame
-> temporal attention over the frames -> a learned weighted mean over the
frames and a head refining the centre frame's pose.  The backbone's logits
are computed once: their spatial softmax is the output's ``heatmaps``, and
with ``use_softmax`` the decode is ``ops.decode.softmax_decode`` of the
logits (B4 on a card: one launch a forward), the JAX package's
``soft_argmax(spatial_softmax(logits, T))``; without it the argmax of the
probabilities, as JAX decodes them.

``ViTBlock``, ``ConvHeadPooling`` and ``PoolingTransformer`` (reference
lib/models/my_pose_transformer.py:190-370): ResNet features -> a patch
embedding plus K keypoint tokens -> PiT-style stages of pre-norm attention
blocks with conv-head pooling between them -> a per-token head regressing
(u, v) in heatmap coordinates.  The JAX module completes the reference's
unrunnable forward the same way; the port follows it.

``MultiHead`` holds flax ``nn.MultiHeadDotProductAttention``'s four
``DenseGeneral`` layers as ``nn.Linear``s named ``query``, ``key``,
``value`` and ``out``: a flax (in, heads, head_dim) kernel is the weight
(heads * head_dim, in) transposed, and the out kernel (heads, head_dim,
out) the weight (out, heads * head_dim) transposed (``utils/weights.py``).
flax's ``nn.gelu`` is the tanh approximation and its LayerNorm's eps is 1e-6.

The JAX registry passes neither model a dtype, so both run in float32 there
(the RVT's ResNet included; PoseFormer's backbone runs at
``TPU.COMPUTE_DTYPE``): the port runs them in float32 with autocast off
inside, whatever the caller's.  The RVT's output is a bare (B, K, 2) tensor
with no heatmaps, so the JAX 2D steps, evaluator and forward function fail
on it (ROADMAP C17) and the port's raise.  PoseFormer's output carries the
backbone's per-frame heatmaps, which JAX's generic steps train and decode
(ROADMAP C20).  Its modules are named by their flax paths
(``spatial_block0.attn``, ``frame_weights``), the backbone's by the
reference's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.decode import hard_argmax, softmax_decode, spatial_softmax
from .hrnet import PoseHRNet
from .layers import Dense, LayerNorm, LecunConv2d
from .pose_resnet import ResNetBackbone


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Pad an NCHW tensor as flax's default ``padding='SAME'`` does before a
    ``kernel`` x ``kernel`` conv of ``stride``: the total ``max((ceil(n / s)
    - 1) * s + k - n, 0)`` split low = total // 2, high = the rest."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class MultiHead(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (self-attention, no mask, no
    dropout): q, k, v projections with biases, the query scaled by
    head_dim^-0.5, a softmax over the keys, the out projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query, self.key, self.value, self.out = (Dense(dim, dim) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        split = lambda t: t.reshape(b, n, h, c // h).transpose(1, 2)       # (B, h, n, d)
        q = split(self.query(x)) / math.sqrt(c // h)
        attn = torch.softmax(q @ split(self.key(x)).transpose(-2, -1), dim=-1)
        out = (attn @ split(self.value(x))).transpose(1, 2).reshape(b, n, c)
        return self.out(out)


class ViTBlock(nn.Module):
    """Pre-norm MSA + MLP block (the reference's timm-style Block)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 2.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = MultiHead(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.fc1 = Dense(dim, int(dim * mlp_ratio))
        self.fc2 = Dense(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))


class PoseTransformerOutput(NamedTuple):
    pose2d_refined: torch.Tensor         # (B, K, 2) the centre frame's refined pose
    heatmaps: torch.Tensor               # (B*F, h, w, K) per-frame probabilities
    temperature: Optional[torch.Tensor]


class PoseTransformer(nn.Module):
    """Temporal pose refinement (reference pose_hrnet_transformer.py:87-245).
    ``backbone`` is a softmax-head ``PoseHRNet``; frames (B, F, H, W, 3)
    NHWC with F = ``num_frames``."""

    def __init__(self, backbone: PoseHRNet, num_frames: int = 5, num_joints: int = 21,
                 embed_dim_ratio: int = 32, depth: int = 4, num_heads: int = 8,
                 use_softmax: bool = True):
        super().__init__()
        self.backbone = backbone
        self.num_frames = num_frames
        self.num_joints = num_joints
        self.depth = depth
        self.use_softmax = use_softmax
        d, k = embed_dim_ratio, num_joints
        self.spatial_embed = Dense(2, d)
        self.spatial_pos = nn.Parameter(torch.zeros(1, k, d))
        self.temporal_pos = nn.Parameter(torch.zeros(1, num_frames, k * d))
        for i in range(depth):
            self.add_module(f"spatial_block{i}", ViTBlock(d, num_heads))
        self.spatial_norm = LayerNorm(d)
        for i in range(depth):
            self.add_module(f"temporal_block{i}", ViTBlock(k * d, num_heads))
        self.temporal_norm = LayerNorm(k * d)
        self.frame_weights = nn.Parameter(torch.zeros(num_frames, 1))
        self.head_norm = LayerNorm(k * d)
        self.head = Dense(k * d, k * 2)

    @torch.no_grad()
    def init_train_weights(self, gen: torch.Generator) -> None:
        """flax's initialisers: zero position embeddings, ``normal(0.02)``
        frame weights; the layers make their own."""
        self.spatial_pos.zero_()
        self.temporal_pos.zero_()
        self.frame_weights.normal_(0.0, 0.02, generator=gen)

    def forward(self, frames: torch.Tensor) -> PoseTransformerOutput:
        b, f = frames.shape[:2]
        k = self.num_joints
        logits, temp = self.backbone.forward_logits(frames.reshape(b * f, *frames.shape[2:]))
        with torch.autocast(frames.device.type, enabled=False):
            heatmaps = spatial_softmax(logits, temp)
            pose2d = softmax_decode(logits, temp) if self.use_softmax else hard_argmax(heatmaps)
            x = self.spatial_embed(pose2d) + self.spatial_pos                  # (BF, K, d)
            for i in range(self.depth):
                x = getattr(self, f"spatial_block{i}")(x)
            x = self.spatial_norm(x).reshape(b, f, -1) + self.temporal_pos      # (B, F, K d)
            for i in range(self.depth):
                x = getattr(self, f"temporal_block{i}")(x)
            x = self.temporal_norm(x)
            pooled = (x * self.frame_weights[None]).sum(dim=1)                   # "bfd,fo->bd"
            y = self.head(self.head_norm(pooled))
        return PoseTransformerOutput(y.reshape(b, k, 2), heatmaps, temp)


class ConvHeadPooling(nn.Module):
    """PiT stage pooling: a grouped (depthwise where the widths match) 3x3
    stride-2 conv on the patch grid, a dense layer on the keypoint tokens."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.pool = LecunConv2d(in_dim, out_dim, 3, 2, 1, groups=in_dim)
        self.token_proj = Dense(in_dim, out_dim)

    def forward(self, patches: torch.Tensor, tokens: torch.Tensor, hw: Tuple[int, int]):
        h, w = hw
        b, _, c = patches.shape
        grid = self.pool(patches.transpose(1, 2).reshape(b, c, h, w))
        nh, nw = grid.shape[2:]
        return grid.flatten(2).transpose(1, 2), self.token_proj(tokens), (nh, nw)


def resnet_feature_size(n: int) -> int:
    """The side of a ResNet's stride-32 features for an input side ``n``
    (five ceil halvings: the stem conv, the max-pool, layers 2-4)."""
    for _ in range(5):
        n = (n + 1) // 2
    return n


class PoolingTransformer(nn.Module):
    """RVT: ResNet features + keypoint-token PiT (reference :190-370).
    ``image_size`` (H, W) fixes the patch embedding's kernel, min(patch_size,
    the feature map's height), as the JAX module takes it from its input."""

    def __init__(self, num_joints: int = 21, backbone_layers: int = 50, patch_size: int = 2,
                 base_dims: Sequence[int] = (48, 48), depths: Sequence[int] = (2, 2),
                 num_heads: Sequence[int] = (3, 6), heatmap_size: int = 64,
                 image_size: Tuple[int, int] = (256, 256)):
        super().__init__()
        self.num_joints = num_joints
        self.heatmap_size = heatmap_size
        self.backbone = ResNetBackbone(backbone_layers)
        dims = [d * h for d, h in zip(base_dims, num_heads)]
        self.patch = min(patch_size, resnet_feature_size(image_size[0]))
        self.patch_embed = LecunConv2d(self.backbone.out_channels, dims[0], self.patch,
                                       self.patch)
        self.keypoint_tokens = nn.Parameter(torch.zeros(num_joints, dims[0]))
        self.depths = tuple(depths)
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            for blk in range(depth):
                self.add_module(f"stage{stage}_block{blk}", ViTBlock(dims[stage], heads))
            if stage < len(depths) - 1:
                self.add_module(f"pool{stage}", ConvHeadPooling(dims[stage], dims[stage + 1]))
        self.norm = LayerNorm(dims[-1])
        self.head = Dense(dims[-1], 2)

    @torch.no_grad()
    def init_train_weights(self, gen: torch.Generator) -> None:
        """flax's ``uniform(1.0)`` for the keypoint tokens; the layers make
        their own."""
        self.keypoint_tokens.uniform_(0.0, 1.0, generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) NHWC -> (B, K, 2) float32 poses in heatmap coordinates."""
        dtype = self.keypoint_tokens.dtype
        with torch.autocast(x.device.type, enabled=False):
            feats = self.backbone(x.to(dtype).permute(0, 3, 1, 2))
            patches = self.patch_embed(same_pad(feats, self.patch, self.patch))
            b, _, h, w = patches.shape
            seq = patches.flatten(2).transpose(1, 2)
            tokens = self.keypoint_tokens[None].expand(b, -1, -1)
            hw = (h, w)
            k = self.num_joints
            for stage, depth in enumerate(self.depths):
                cat = torch.cat([tokens, seq], dim=1)
                for blk in range(depth):
                    cat = getattr(self, f"stage{stage}_block{blk}")(cat)
                tokens, seq = cat[:, :k], cat[:, k:]
                if stage < len(self.depths) - 1:
                    seq, tokens, hw = getattr(self, f"pool{stage}")(seq, tokens, hw)
            uv = self.head(self.norm(tokens))
            return torch.sigmoid(uv) * self.heatmap_size


def pooling_transformer_from_cfg(cfg) -> PoolingTransformer:
    """The registry's ``my_pose_transformer`` (JAX ``models/zoo.py:116-133``):
    the ResNet depth from the digits of a MODEL.BACKBONE_NAME naming a
    resnet (else 50), the stages from EMB_DIM, DEPTHS and NUM_HEADS cut to
    EMB_DIM's length; in eval mode."""
    layers = 50
    name = str(cfg.MODEL.BACKBONE_NAME).lower()
    if "resnet" in name:
        digits = "".join(c for c in name if c.isdigit())
        layers = int(digits) if digits else 50
    n = len(cfg.MODEL.EMB_DIM)
    return PoolingTransformer(
        num_joints=int(cfg.MODEL.NUM_JOINTS), backbone_layers=layers,
        patch_size=int(cfg.MODEL.PATCH_SIZE),
        base_dims=tuple(int(d) for d in cfg.MODEL.EMB_DIM),
        depths=tuple(int(d) for d in cfg.MODEL.DEPTHS)[:n],
        num_heads=tuple(int(h) for h in cfg.MODEL.NUM_HEADS)[:n],
        heatmap_size=int(cfg.MODEL.HEATMAP_SIZE[0]),
        image_size=(int(cfg.MODEL.IMAGE_SIZE[1]), int(cfg.MODEL.IMAGE_SIZE[0]))).eval()
