"""Swin Transformer pose model, in PyTorch.

Port of the JAX package's ``models/swin.py`` (reference
lib/models/swin_transformer.py:72-837, SwinPose): a patch embedding,
window attention with a relative position bias, shifted windows by
``torch.roll``, patch merging between stages, and a 1x1 head to K heatmap
logits with the spatial softmax of the HRNet heads.

Precision, as the JAX module's (``dtype`` = the compute dtype, here
autocast's): the LayerNorms compute in float32 and hand float32 on, which is
rounded to the compute dtype where JAX casts it (before the windows, after
the embedding); the attention scores q kᵀ are float32 (JAX's
``preferred_element_type``), so the port computes them from float32 copies
of q and k outside autocast (a bf16 product would round them); the softmax
runs in float32 and is rounded to the compute dtype before its product
with v.

Only stage 0 is read: the head takes ``feats[0]``, so stages 1-3 and the
patch merges feed no output (XLA drops them under jit; their gradients are
zero).  The port keeps their parameters, so the bridge and checkpoints carry
them, and does not compute them.  The window size of a stage is ``min(8, h,
w)`` of its map and the shift is dropped when that covers the map, so the
model is built for an ``image_size``.  ``swin_from_cfg`` ignores
BACKBONE_NAME, ABSOLUTE_POSITION_ENCODING and the window key, as JAX's does.

The module names mirror the flax tree (``stage{s}_block{b}.attn.qkv``,
``merge_norm{s}``, ...): the reference's Swin has no resolver in the JAX
package's ``utils/torch_convert.py``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.decode import spatial_softmax
from .hrnet import HRNetOutput
from .layers import Dense, LayerNorm, LecunConv2d, compute_dtype
from .transformers import same_pad

WINDOW_SIZE = 8


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2 bias table (JAX ``models/swin.py:42-47``)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def shift_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """(nW, ws*ws, ws*ws) float32: -100 between the positions of a shifted
    window that come from different regions of the three-slice image mask,
    0 elsewhere (JAX ``models/swin.py:113-122``)."""
    img_mask = torch.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = window_partition(img_mask, ws).reshape(-1, ws * ws)
    return torch.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0)


class WindowAttention(nn.Module):
    """Windowed MSA with a relative position bias (reference :189-271)."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.rel_pos_bias = nn.Parameter(torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("rel_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1).astype(np.int64)), persistent=False)

    @torch.no_grad()
    def init_train_weights(self, gen: torch.Generator) -> None:
        """flax's ``truncated_normal(0.02)``: a normal of std 0.02 cut at +-0.04."""
        nn.init.trunc_normal_(self.rel_pos_bias, 0.0, 0.02, -0.04, 0.04, generator=gen)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (nW, n, C) windows in the compute dtype; mask (nM, n, n) or None."""
        nw, n, c = x.shape
        h = self.num_heads
        d = c // h
        q, k, v = self.qkv(x).reshape(nw, n, 3, h, d).permute(2, 0, 3, 1, 4)  # (nW, h, n, d)
        bias = self.rel_pos_bias[self.rel_index].reshape(n, n, h).permute(2, 0, 1)
        with torch.autocast(x.device.type, enabled=False):
            acc = torch.promote_types(q.dtype, torch.float32)
            attn = q.to(acc) @ k.to(acc).transpose(-2, -1)
            attn = attn * (d ** -0.5) + bias[None]
            if mask is not None:
                nm = mask.shape[0]
                attn = (attn.reshape(nw // nm, nm, h, n, n) + mask[None, :, None]).reshape(
                    nw, h, n, n)
            attn = torch.softmax(attn, dim=-1).to(v.dtype)
            out = (attn @ v).transpose(1, 2).reshape(nw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    """W-MSA / SW-MSA block (reference :272-376) on a (h, w) map."""

    def __init__(self, dim: int, num_heads: int, resolution: Tuple[int, int],
                 window_size: int = WINDOW_SIZE, shift: int = 0, mlp_ratio: float = 4.0,
                 ff_type: str = "mlp"):
        super().__init__()
        h, w = resolution
        self.resolution = (h, w)
        self.ws = min(window_size, h, w)
        self.shift = shift if self.ws < min(h, w) else 0
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, self.ws, num_heads)
        self.norm2 = LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.fc1 = Dense(dim, hidden)
        # the locality-enhanced FFN ('le_ff'): a depthwise 3x3 between the dense layers
        self.dwconv = (LecunConv2d(hidden, hidden, 3, 1, 1, groups=hidden)
                       if ff_type == "le_ff" else None)
        self.fc2 = Dense(hidden, dim)
        self.register_buffer("attn_mask", shift_mask(h, w, self.ws, self.shift)
                             if self.shift else None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) in the compute dtype -> the same."""
        b, h, w, c = x.shape
        if (h, w) != self.resolution:
            raise ValueError(f"a Swin block built for {self.resolution} maps got {(h, w)}")
        ws, shift = self.ws, self.shift
        y = self.norm1(x)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = self.attn(window_partition(y.to(x.dtype), ws), self.attn_mask)
        y = window_reverse(y, ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        z = F.gelu(self.fc1(self.norm2(x)), approximate="tanh")
        if self.dwconv is not None:
            z = F.gelu(self.dwconv(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1), approximate="tanh")
        return x + self.fc2(z)


class SwinPose(nn.Module):
    """Patch embed + 4 stages + heatmap head (reference :569-837).

    ``head`` is 'softmax' (HEATMAP_SOFTMAX: probabilities at a temperature,
    a ``trainable_temp`` parameter frozen unless ``trainable_softmax``) or
    'plain' (float32 logits)."""

    def __init__(self, num_joints: int = 21, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = WINDOW_SIZE, ff_type: str = "mlp",
                 heatmap_softmax: bool = True, trainable_softmax: bool = False,
                 image_size: Tuple[int, int] = (256, 256)):
        super().__init__()
        self.patch_size = patch_size
        self.patch_embed = LecunConv2d(3, embed_dim, patch_size, patch_size)
        self.embed_norm = LayerNorm(embed_dim)
        h, w = (math.ceil(s / patch_size) for s in image_size)
        dim = embed_dim
        self.stage0 = []
        for s, (depth, heads) in enumerate(zip(depths, num_heads)):
            for blk in range(depth):
                name = f"stage{s}_block{blk}"
                self.add_module(name, SwinBlock(dim, heads, (h, w), window_size,
                                                0 if blk % 2 == 0 else window_size // 2,
                                                ff_type=ff_type))
                if s == 0:
                    self.stage0.append(name)
            if s < len(depths) - 1:
                # patch merging (reference :377-400); feeds stages 1-3 only
                self.add_module(f"merge_norm{s}", LayerNorm(4 * dim))
                self.add_module(f"merge{s}", Dense(4 * dim, 2 * dim, bias=False))
                dim, h, w = 2 * dim, h // 2, w // 2
        self.final_conv = LecunConv2d(embed_dim, num_joints, 1)
        self.head = "softmax" if heatmap_softmax else "plain"
        if heatmap_softmax:
            self.trainable_softmax = trainable_softmax
            self.trainable_temp = nn.Parameter(torch.ones(()))

    def _logits(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) NHWC -> (NHWK logits, stage-0 NHWC features), both in
        the compute dtype."""
        x = x.to(self.patch_embed.weight.dtype).permute(0, 3, 1, 2)
        dtype = compute_dtype(x)
        p = self.patch_size
        x = self.patch_embed(same_pad(x, p, p)).permute(0, 2, 3, 1)
        x = self.embed_norm(x).to(dtype)
        for name in self.stage0:
            x = getattr(self, name)(x)
        y = self.final_conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return y, x

    def _temperature(self) -> Optional[torch.Tensor]:
        if self.head == "plain":
            return None
        return self.trainable_temp if self.trainable_softmax else self.trainable_temp.detach()

    def forward_logits(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: (B, H, W, 3) -> (the head's NHWK logits, the temperature or
        None): ``forward(x).heatmaps == spatial_softmax(y, temperature)``;
        ``core/evaluator.Evaluator2D`` decodes them with kernel B4."""
        y, _ = self._logits(x)
        return y, self._temperature()

    def forward(self, x: torch.Tensor) -> HRNetOutput:
        y, feat = self._logits(x)
        temp = self._temperature()
        if temp is None:
            return HRNetOutput(y.float(), feat, None, None)
        return HRNetOutput(spatial_softmax(y, temp), feat, temp, None)


def swin_from_cfg(cfg) -> SwinPose:
    """SwinPose from MODEL.PATCH_SIZE, EMB_DIM[0], DEPTHS, NUM_HEADS,
    FF_TYPE, HEATMAP_SOFTMAX, TRAINABLE_SOFTMAX and IMAGE_SIZE, in eval mode."""
    m = cfg.MODEL
    return SwinPose(num_joints=int(m.NUM_JOINTS), patch_size=int(m.PATCH_SIZE),
                    embed_dim=int(m.EMB_DIM[0]) if m.EMB_DIM else 96,
                    depths=tuple(int(d) for d in m.DEPTHS),
                    num_heads=tuple(int(h) for h in m.NUM_HEADS),
                    ff_type=str(m.FF_TYPE), heatmap_softmax=bool(m.HEATMAP_SOFTMAX),
                    trainable_softmax=bool(m.TRAINABLE_SOFTMAX),
                    image_size=(int(m.IMAGE_SIZE[1]), int(m.IMAGE_SIZE[0]))).eval()
