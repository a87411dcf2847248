"""Feature-Transform-Layer multiview net, in PyTorch.

Port of the JAX package's ``models/ftl.py`` (reference
lib/models/FTL_encoder_decoder.py:83-213): a frozen HRNet encoder gives
480-channel features; an encoder head compresses them to 240 channels on an
18x18 plane (at 256 px) whose values group into homogeneous image
coordinates (..., 3); each view's features move to a canonical world frame
by K^-1, R^-1 and t (the FTL), the views fuse by 1x1 convs, the result is
redistributed per view, and a transposed-conv decoder gives 64x64 logits.
The 2D keypoints are the softmax decode of those logits at temperature 1
(``ops.decode.softmax_decode``: on the card one launch of the hand-written
kernel a forward, and one of its backward kernel when the forward is
differentiated; JAX computes ``decode_heatmaps(spatial_softmax(logits))``,
the same function), and the 3D keypoints the SII DLT of the decoded 2D
ones.

Module names are the flax paths (``encoder_head.conv0``,
``fuse_after_ftl.bn1``, ``channel_expansion.conv0``, ``deconv1``..``3``,
``final_layer``); the backbone's are the reference's.  The JAX registry
builds the net's own convs in bfloat16 whatever TPU.COMPUTE_DTYPE says (its
default ``dtype``), so ``dtype`` here is bfloat16 by default too: the
convs run under an autocast in ``dtype``, and the geometry (the inverses,
the frame changes, the decode, SII) in float32 outside any autocast, as in
JAX.  A float64 model on the CPU (a reference run) computes all of it in
float64.

The net takes (images, extrinsics, intrinsics), which the JAX package's
``create_train_state`` and 2D steps do not give it: JAX's tools cannot train
or evaluate it (ROADMAP C21), and the port's raise.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops.decode import softmax_decode, spatial_softmax
from ..ops.geometry import compose_projection, triangulate_sii
from .hrnet import PoseHRNet
from .layers import batch_norm
from .triangulation import Triangulation3DOutput, _fold_views


def conv_transpose_torch(in_channels: int, features: int, kernel: int, stride: int,
                         padding: int, output_padding: int) -> nn.ConvTranspose2d:
    """The JAX package's ``conv_transpose_torch`` (``models/ftl.py:32``):
    torch's own ``ConvTranspose2d``, out = (in - 1) * stride - 2 * padding +
    kernel + output_padding, with a bias (flax's default)."""
    return nn.ConvTranspose2d(in_channels, features, kernel, stride, padding=padding,
                              output_padding=output_padding)


class ConvBlock(nn.Module):
    """conv (with bias) + BN + ReLU, per stage (the reference's conv_block;
    JAX ``ConvBlock``, ``models/ftl.py:43``).  NCHW."""

    def __init__(self, in_channels: int, channels: Sequence[int], kernels: Sequence[int],
                 strides: Sequence[int], paddings: Sequence[int]):
        super().__init__()
        self.depth = len(channels)
        for i, (c, k, s, p) in enumerate(zip(channels, kernels, strides, paddings)):
            self.add_module(f"conv{i}", nn.Conv2d(in_channels, c, k, s, p))
            self.add_module(f"bn{i}", batch_norm(c))
            in_channels = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x


def _decode(logits: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """The 2D keypoints of the logits at temperature 1: ``softmax_decode``
    (B4 on the card, its twin on the CPU).  Float64 logits on the CPU (a
    reference run; the kernel takes float32 and bfloat16) decode by the
    twin's formula in float64, the spatial expectation of ``probs``."""
    if logits.dtype == torch.float64 and logits.device.type == "cpu":
        _, h, w, _ = probs.shape
        us = torch.arange(w, dtype=probs.dtype)
        vs = torch.arange(h, dtype=probs.dtype)
        return torch.stack([torch.einsum("bhwk,w->bk", probs, us),
                            torch.einsum("bhwk,h->bk", probs, vs)], dim=-1)
    return softmax_decode(logits, 1.0)


class FTLMultiviewNet(nn.Module):
    """Frozen HRNet encoder + the feature transform layer + a transposed-conv
    decoder + SII triangulation (reference FTL_encoder_decoder.py:83-213)."""

    def __init__(self, backbone: PoseHRNet, num_joints: int = 21, num_views: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = backbone
        self.num_joints = num_joints
        self.num_views = num_views
        self.dtype = dtype
        features = backbone.last_layer[0].in_channels         # 480 at w32
        self.encoder_head = ConvBlock(features, (480, 240), (3, 3), (2, 2), (2, 2))
        self.fuse_after_ftl = ConvBlock(num_views * 240, (240, 240), (1, 1), (1, 1), (0, 0))
        self.channel_expansion = ConvBlock(240, (480,), (1,), (1,), (0,))
        self.deconv1 = conv_transpose_torch(480, 256, 3, 2, 2, 0)
        self.deconv2 = conv_transpose_torch(256, 256, 3, 2, 2, 1)
        self.deconv3 = conv_transpose_torch(256, 256, 3, 1, 1, 0)
        self.final_layer = nn.Conv2d(256, num_joints, 1)

    def _convs(self, kind: str):
        """An autocast in ``dtype`` (off for float32) for the net's own convs."""
        return torch.autocast(kind, dtype=self.dtype, enabled=self.dtype != torch.float32)

    def forward(self, images: torch.Tensor, extrinsics: torch.Tensor,
                intrinsics: torch.Tensor) -> Triangulation3DOutput:
        """images (B, V, H, W, 3); extrinsics (B, V, 3, 4); intrinsics (B, 3, 3)
        -> keypoints_3d (B, K, 3), keypoints_2d (B, V, K, 2) in heatmap
        pixels, heatmaps (B, V, h, w, K) probabilities."""
        flat, b, v = _fold_views(images)
        kind = images.device.type
        if v != self.num_views:
            raise ValueError(f"FTL built for {self.num_views} views, got {v}")
        if self.training:
            # JAX's train-mode forward runs the backbone's head too, and so
            # moves that head's BN statistics
            _, feats = self.backbone._logits(flat)
        else:
            feats = self.backbone.forward_features(flat)
        feats = feats.detach()                        # frozen encoder (:106-107)
        geo = torch.promote_types(feats.dtype, torch.float32)

        # encoder head: 2x stride-2 conv -> (BV, 18, 18, 240) (:111-114)
        with self._convs(kind):
            feats = self.encoder_head(feats.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        hw = feats.shape[1]
        if (hw * hw) % 3:
            raise ValueError(f"a {hw}x{hw} plane does not split into homogeneous triplets")
        n = 240 * (hw * hw // 3)

        def triplets_to_nhwc(x: torch.Tensor) -> torch.Tensor:
            # (B, [V,] 240*(hw*hw//3), 3) -> (..., hw, hw, 240), the inverse
            # of the channel-major triplet packing below
            lead = x.shape[:-2]
            return x.reshape(*lead, 240, hw * hw).transpose(-1, -2).reshape(*lead, hw, hw, 240)

        with torch.autocast(kind, enabled=False):
            # spatial positions group into homogeneous triplets, channel-major
            # (reference :117: view(b, v, 240, -1, 3) on NCHW maps)
            f = feats.to(geo).reshape(b, v, hw * hw, 240).transpose(2, 3).reshape(b, v, n, 3)
            K = intrinsics.to(geo)                                      # (B, 3, 3)
            R = extrinsics[..., :3].to(geo)                             # (B, V, 3, 3)
            t = extrinsics[..., 3].to(geo)                              # (B, V, 3)
            # FTL to the canonical frame: x_world = R^-1 (K^-1 x - t) (:121-127)
            cam = torch.einsum("bij,bvnj->bvni", torch.linalg.inv(K), f)
            world = torch.einsum("bvij,bvnj->bvni", torch.linalg.inv(R), cam - t[:, :, None, :])
            # the views side by side on the channels: (B, hw, hw, V*240)
            fused_in = triplets_to_nhwc(world).permute(0, 2, 3, 1, 4).reshape(b, hw, hw, v * 240)

        # fuse the views with 1x1 convs (:130-136)
        with self._convs(kind):
            fused = self.fuse_after_ftl(fused_in.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

        with torch.autocast(kind, enabled=False):
            # redistribute per view: x_img = K (R x + t) (:139-144)
            g = fused.to(geo).reshape(b, hw * hw, 240).transpose(1, 2).reshape(b, 1, n, 3)
            per_view = torch.einsum("bvij,bvnj->bvni", R, g.expand(b, v, n, 3))
            per_view = torch.einsum("bij,bvnj->bvni", K, per_view + t[:, :, None, :])
            per_view = triplets_to_nhwc(per_view).reshape(b * v, hw, hw, 240)

        # channel expansion + decoder (:147-160)
        with self._convs(kind):
            x = self.channel_expansion(per_view.permute(0, 3, 1, 2))
            x = torch.relu(self.deconv1(x))
            x = torch.relu(self.deconv2(x))
            x = torch.relu(self.deconv3(x))
            logits = self.final_layer(x).permute(0, 2, 3, 1)

        with torch.autocast(kind, enabled=False):
            probs = spatial_softmax(logits)
            kp2d = _decode(logits, probs).reshape(b, v, self.num_joints, 2)
            proj = compose_projection(K[:, None], extrinsics.to(geo))     # (B, V, 3, 4)
            pts = kp2d.to(geo).transpose(1, 2)                           # (B, K, V, 2)
            prj = proj[:, None].expand(b, self.num_joints, v, 3, 4)
            kp3d = triangulate_sii(pts, prj)
        return Triangulation3DOutput(keypoints_3d=kp3d, keypoints_2d=kp2d,
                                     heatmaps=probs.reshape(b, v, *probs.shape[1:]))


def ftl_from_cfg(cfg, dtype: torch.dtype = torch.bfloat16) -> FTLMultiviewNet:
    """The registry's FTL (JAX ``models/zoo.py:62``): the softmax HRNet of
    MODEL.EXTRA as its encoder, DATASET.NUM_VIEWS views, in eval mode."""
    from .hrnet import hrnet_from_cfg

    return FTLMultiviewNet(hrnet_from_cfg(cfg, head="softmax"),
                           num_joints=int(cfg.MODEL.NUM_JOINTS),
                           num_views=int(cfg.DATASET.NUM_VIEWS), dtype=dtype).eval()


def seeded_cameras(batch: int, views: int, image_size: int, seed: int = 0):
    """A seeded, well-conditioned rig for FTL's inputs: ``views`` cameras on
    a ring 2 m from the origin at evenly spaced azimuths (jittered by up to
    10 degrees) and 15-30 degrees of elevation, each looking at the origin;
    one K for every view of a sample (f = 1.2 * image_size, the principal
    point near the centre), as the net's signature asks.  Returns float32
    CPU tensors (extrinsics (B, V, 3, 4) world -> camera, intrinsics (B, 3,
    3))."""
    rng = np.random.default_rng(seed)
    extr = np.zeros((batch, views, 3, 4))
    intr = np.zeros((batch, 3, 3))
    for b in range(batch):
        f = 1.2 * image_size * rng.uniform(0.95, 1.05)
        c = image_size / 2 + rng.uniform(-4, 4, size=2)
        intr[b] = [[f, 0, c[0]], [0, f, c[1]], [0, 0, 1]]
        for v in range(views):
            az = 2 * np.pi * v / views + np.radians(rng.uniform(-10, 10))
            el = np.radians(rng.uniform(15, 30))
            centre = 2.0 * np.array([np.cos(el) * np.cos(az), np.sin(el),
                                     np.cos(el) * np.sin(az)])
            fwd = -centre / np.linalg.norm(centre)
            right = np.cross(fwd, [0.0, 1.0, 0.0])
            right /= np.linalg.norm(right)
            down = np.cross(fwd, right)
            rot = np.stack([right, down, fwd])              # rows: the camera axes
            extr[b, v, :, :3] = rot
            extr[b, v, :, 3] = -rot @ centre
    return (torch.from_numpy(extr.astype(np.float32)), torch.from_numpy(intr.astype(np.float32)))
