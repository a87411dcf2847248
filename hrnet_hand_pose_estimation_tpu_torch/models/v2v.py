"""V2V-PoseNet 3D hourglass over feature volumes, in PyTorch.

Port of the JAX package's ``models/v2v.py`` (reference lib/models/v2v.py:7-180):
a 7^3 stem, a 5-level max-pool encoder / transposed-conv decoder with
residual skip paths, and a 1^3 output conv.  The modules carry the
reference torch names (``front_layers.0.block.0``,
``encoder_decoder.encoder_res1.res_branch.0``,
``encoder_decoder.decoder_upsample5.block.0``, ``output_layer``), the names
the JAX package's ``utils/torch_convert.convert_v2v_state_dict`` reads.

``V2VModel.forward`` takes and returns NDHWC volumes like the JAX model;
inside they are NCDHW views (channels_last_3d memory) on cuDNN's 3D convs,
transposed convs and pools, which the JAX package leaves to XLA (no Pallas
kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import batch_norm3d


class Basic3DBlock(nn.Module):
    """Conv3d + BN + ReLU (reference v2v.py:7-17)."""

    def __init__(self, in_planes: int, out_planes: int, kernel: int):
        super().__init__()
        pad = (kernel - 1) // 2
        self.block = nn.Sequential(nn.Conv3d(in_planes, out_planes, kernel, 1, pad),
                                   batch_norm3d(out_planes), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class Res3DBlock(nn.Module):
    """Two 3^3 convs + BN with a (projected) skip (reference v2v.py:20-42)."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.res_branch = nn.Sequential(
            nn.Conv3d(in_planes, out_planes, 3, 1, 1), batch_norm3d(out_planes), nn.ReLU(),
            nn.Conv3d(out_planes, out_planes, 3, 1, 1), batch_norm3d(out_planes))
        self.skip_con = (nn.Sequential() if in_planes == out_planes else nn.Sequential(
            nn.Conv3d(in_planes, out_planes, 1, 1, 0), batch_norm3d(out_planes)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.res_branch(x) + self.skip_con(x))


class Upsample3DBlock(nn.Module):
    """ConvTranspose3d(k=2, s=2) + BN + ReLU (reference v2v.py:55-67)."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.block = nn.Sequential(nn.ConvTranspose3d(in_planes, out_planes, 2, 2, 0),
                                   batch_norm3d(out_planes), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


# (encoder out, skip) channels of levels 1..5 and (decoder res, upsample) of 5..1
_ENC = (64, 128, 128, 128, 128)
_SKIP = (32, 64, 128, 128, 128)
_DEC_RES = (128, 128, 128, 128, 64)
_DEC_UP = (128, 128, 128, 64, 32)


class EncoderDecoder(nn.Module):
    """The 5-level hourglass (reference v2v.py:69-141)."""

    def __init__(self):
        super().__init__()
        cin = 32
        for i in range(5):
            self.add_module(f"skip_res{i + 1}", Res3DBlock(cin, _SKIP[i]))
            self.add_module(f"encoder_res{i + 1}", Res3DBlock(cin, _ENC[i]))
            cin = _ENC[i]
        self.mid_res = Res3DBlock(cin, 128)
        cin = 128
        for i in range(5):
            level = 5 - i
            self.add_module(f"decoder_res{level}", Res3DBlock(cin, _DEC_RES[i]))
            self.add_module(f"decoder_upsample{level}", Upsample3DBlock(_DEC_RES[i], _DEC_UP[i]))
            cin = _DEC_UP[i]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(1, 6):
            skips.append(getattr(self, f"skip_res{i}")(x))
            x = getattr(self, f"encoder_res{i}")(F.max_pool3d(x, 2, 2))
        x = self.mid_res(x)
        for level in range(5, 0, -1):
            x = getattr(self, f"decoder_res{level}")(x)
            x = getattr(self, f"decoder_upsample{level}")(x) + skips[level - 1]
        return x


class V2VModel(nn.Module):
    """Full V2V net: front -> hourglass -> back -> 1^3 output conv
    (reference v2v.py:143-169).  forward: (B, X, Y, Z, C_in) ->
    (B, X, Y, Z, out_channels) float32; each side divisible by 32."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.front_layers = nn.Sequential(Basic3DBlock(in_channels, 16, 7), Res3DBlock(16, 32),
                                          Res3DBlock(32, 32), Res3DBlock(32, 32))
        self.encoder_decoder = EncoderDecoder()
        self.back_layers = nn.Sequential(Res3DBlock(32, 32), Basic3DBlock(32, 32, 1),
                                         Basic3DBlock(32, 32, 1))
        self.output_layer = nn.Conv3d(32, out_channels, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if any(s % 32 for s in x.shape[1:4]):
            raise ValueError(f"V2V pools five times: each side must divide by 32, got "
                             f"{tuple(x.shape[1:4])}")
        y = x.permute(0, 4, 1, 2, 3)                       # NCDHW view, channels_last_3d
        y = self.output_layer(self.back_layers(self.encoder_decoder(self.front_layers(y))))
        return y.permute(0, 2, 3, 4, 1).float()
