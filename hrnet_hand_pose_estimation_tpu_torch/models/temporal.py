"""Temporal models: PredRNN (ST-LSTM) and the HRNet-embedding TCN, in PyTorch.

Port of the JAX package's ``models/temporal.py``:

- ``STLSTMCell``, ``PredRNN``, ``HRNetPredRNN`` (reference
  lib/models/predrnn.py:7-236 and SpatioTemporalLSTMCell.py): stacked
  spatio-temporal LSTM cells over per-frame heatmaps, the memory M flowing
  zig-zag through the cells and across frames, states from zeros, the
  frames unrolled;
- ``HRNetEmbTCN`` (reference lib/models/hrnet_emb_model.py:186-236): the
  global average of each frame's HRNet features -> an embedding -> dilated
  VALID temporal convs -> the mean over time -> the centre frame's pose.

flax's ``nn.LayerNorm`` on an NHWC conv output normalises over the channel
axis only (eps 1e-6, float32); the port's does the same.  The JAX registry
passes no dtype, so PredRNN and the TCN run in float32 there: the port runs
them in float32 with autocast off, the backbone at the caller's autocast.
Module names are the flax paths (``predrnn.cell0.conv_x``,
``predrnn.cell0.conv_x_ln``, ``tcn0``, ``tcn_ln0``), the backbone's the
reference's.

Neither model returns heatmaps the 2D steps can read (a tuple; a bare
(B, K, 2) pose), so JAX's train and eval steps, forward function and
``Evaluator2D`` fail on them (ROADMAP C19) and the port's raise.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.decode import hard_argmax
from .hrnet import PoseHRNet
from .layers import Dense, LayerNorm, LecunConv1d, LecunConv2d


def _channel_norm(norm: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A LayerNorm over the channel axis of an NCHW tensor."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class STLSTMCell(nn.Module):
    """Spatio-temporal LSTM cell (reference SpatioTemporalLSTMCell.py:7-59): a
    ConvLSTM with an extra spatio-temporal memory M.  NCHW tensors."""

    def __init__(self, in_channels: int, hidden: int, filter_size: int = 5,
                 layer_norm: bool = True):
        super().__init__()
        k, pad = filter_size, filter_size // 2
        self.hidden = hidden
        self.layer_norm = layer_norm
        for name, cin, width in (("conv_x", in_channels, 7), ("conv_h", hidden, 4),
                                 ("conv_m", hidden, 3)):
            self.add_module(name, LecunConv2d(cin, width * hidden, k, 1, pad,
                                              bias=not layer_norm))
            if layer_norm:
                self.add_module(f"{name}_ln", LayerNorm(width * hidden))
        self.conv_o = LecunConv2d(2 * hidden, hidden, k, 1, pad)
        self.conv_last = LecunConv2d(2 * hidden, hidden, 1)

    def _gates(self, name: str, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        y = getattr(self, name)(x)
        if self.layer_norm:
            y = _channel_norm(getattr(self, f"{name}_ln"), y)
        return torch.split(y, self.hidden, dim=1)

    def forward(self, x, h, c, m):
        ix, fx, gx, ixp, fxp, gxp, ox = self._gates("conv_x", x)
        ih, fh, gh, oh = self._gates("conv_h", h)
        im, fm, gm = self._gates("conv_m", m)
        c_new = torch.sigmoid(fx + fh) * c + torch.sigmoid(ix + ih) * torch.tanh(gx + gh)
        m_new = torch.sigmoid(fxp + fm) * m + torch.sigmoid(ixp + im) * torch.tanh(gxp + gm)
        mem = torch.cat([c_new, m_new], dim=1)
        o_t = torch.sigmoid(ox + oh + self.conv_o(mem))
        return o_t * torch.tanh(self.conv_last(mem)), c_new, m_new


class PredRNN(nn.Module):
    """Stacked ST-LSTM over frame features (reference predrnn.py:61-123)."""

    def __init__(self, in_channels: int, num_hidden: Sequence[int] = (64, 64, 64, 64),
                 out_channels: int = 21, filter_size: int = 5, layer_norm: bool = True):
        super().__init__()
        self.num_hidden = tuple(num_hidden)
        for i, n in enumerate(self.num_hidden):
            cin = in_channels if i == 0 else self.num_hidden[i - 1]
            self.add_module(f"cell{i}", STLSTMCell(cin, n, filter_size, layer_norm))
        self.head = LecunConv2d(self.num_hidden[-1], out_channels, 1)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T, H, W, C) -> (B, T, H, W, out_channels)."""
        b, t, h, w, _ = frames.shape
        zeros = lambda n: frames.new_zeros(b, n, h, w)
        hs = [zeros(n) for n in self.num_hidden]
        cs = [zeros(n) for n in self.num_hidden]
        m = zeros(self.num_hidden[-1])
        outs = []
        for step in range(t):
            x = frames[:, step].permute(0, 3, 1, 2)
            for i in range(len(self.num_hidden)):
                inp = x if i == 0 else hs[i - 1]
                hs[i], cs[i], m = getattr(self, f"cell{i}")(inp, hs[i], cs[i], m)
            outs.append(self.head(hs[-1]).permute(0, 2, 3, 1))
        return torch.stack(outs, dim=1)


class HRNetPredRNN(nn.Module):
    """HRNet heatmaps refined by PredRNN (reference predrnn.py:186-236).
    Returns the tuple (refined (B, T, h, w, K), the backbone's maps (B, T, h,
    w, K), the argmax decode of ``refined`` (B, T, K, 2)), as JAX's does
    whatever MODEL.HEATMAP_SOFTMAX says."""

    def __init__(self, backbone: PoseHRNet, num_hidden: Sequence[int] = (64, 64, 64, 64),
                 num_joints: int = 21):
        super().__init__()
        self.backbone = backbone
        self.num_joints = num_joints
        self.predrnn = PredRNN(num_joints, num_hidden, num_joints)

    def forward(self, frames: torch.Tensor):
        b, t = frames.shape[:2]
        out = self.backbone(frames.reshape(b * t, *frames.shape[2:]))
        hm = out.heatmaps.reshape(b, t, *out.heatmaps.shape[1:])
        with torch.autocast(frames.device.type, enabled=False):
            refined = self.predrnn(hm.to(torch.promote_types(hm.dtype, torch.float32)))
        pose2d = hard_argmax(refined.reshape(b * t, *refined.shape[2:]))
        return refined, hm, pose2d.reshape(b, t, self.num_joints, 2)


def tcn_layers(seq_len: int, filter_widths: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """(filter width, dilation) of each temporal conv the TCN runs on
    ``seq_len`` frames: dilations 1, w0, w0 w1, ..., stopping at the first
    whose span dilation * (width - 1) reaches the frames left (JAX creates
    no parameters past it)."""
    layers, t, dilation = [], seq_len, 1
    for fw in filter_widths:
        span = dilation * (fw - 1)
        if t <= span:
            break
        layers.append((int(fw), dilation))
        t -= span
        dilation *= fw
    return tuple(layers)


class HRNetEmbTCN(nn.Module):
    """HRNet embeddings -> dilated temporal convs -> the centre frame's pose
    (reference hrnet_emb_model.py:186-236).  Built for ``seq_len`` frames:
    the convs that run depend on it."""

    def __init__(self, backbone: PoseHRNet, seq_len: int = 5, embedding_size: int = 512,
                 tcn_channels: int = 1024, filter_widths: Sequence[int] = (3, 3),
                 num_joints: int = 21):
        super().__init__()
        self.backbone = backbone
        self.seq_len = seq_len
        self.num_joints = num_joints
        self.embed = Dense(backbone.last_layer[0].in_channels, embedding_size)
        self.layers = tcn_layers(seq_len, filter_widths)
        cin = embedding_size
        for i, (fw, dilation) in enumerate(self.layers):
            self.add_module(f"tcn{i}", LecunConv1d(cin, tcn_channels, fw, dilation=dilation))
            self.add_module(f"tcn_ln{i}", LayerNorm(tcn_channels))
            cin = tcn_channels
        self.head = Dense(cin, num_joints * 2)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T, H, W, 3) -> (B, K, 2) float32."""
        b, t = frames.shape[:2]
        if t != self.seq_len:
            raise ValueError(f"HRNetEmbTCN was built for {self.seq_len} frames, got {t}")
        out = self.backbone(frames.reshape(b * t, *frames.shape[2:]))
        with torch.autocast(frames.device.type, enabled=False):
            feats = out.features.to(torch.promote_types(out.features.dtype, torch.float32))
            emb = self.embed(feats.mean(dim=(1, 2)))                            # GAP
            x = emb.reshape(b, t, -1)
            for i in range(len(self.layers)):
                y = getattr(self, f"tcn{i}")(x.transpose(1, 2)).transpose(1, 2)
                x = torch.relu(getattr(self, f"tcn_ln{i}")(y))
            uv = self.head(x.mean(dim=1))
        return uv.reshape(b, self.num_joints, 2)
