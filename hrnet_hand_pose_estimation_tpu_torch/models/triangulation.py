"""Learnable multi-view triangulation networks, in PyTorch.

Port of the JAX package's ``models/triangulation.py`` (reference
lib/models/triangulation.py):

- ``AlgebraicTriangulationNet``: backbone 2D -> rescale to the original
  image -> (confidence-weighted) DLT by eigh;
- ``RANSACTriangulationNet``: backbone 2D -> RANSAC DLT over every view pair;
- ``VolumetricTriangulationNet``: backbone features -> a 1x1 conv to 32
  channels -> a cuboid around the DLT'd middle-finger root (joint 9) ->
  unprojection -> V2V -> 3D soft-argmax;
- ``Discriminator``: the WGAN critic of the 3D GAN trainer.

Views fold into the batch for the backbone.  The backbone stops at its
head's logits (``PoseHRNet.forward_head``); the 2D keypoints of a softmax
decode are ``ops.decode.softmax_decode`` of those logits, which is the
JAX package's ``decode_heatmaps(spatial_softmax(logits, T))``: on the card
the hand-written kernel (one launch per forward), on the CPU its twin.
Decoding and geometry run in float32 outside any autocast; the volumetric
net runs ``process_features`` and V2V in ``dtype`` (bfloat16 by default,
as the JAX net) and the unprojection in the features' dtype.

``vol_CPM`` is the volumetric net on ``models/cpm.CPMVolumetric`` (JAX
``build_triangulation_net``, keyed on ``vol_CPM`` or ``BACKBONE_NAME ==
"CPM_volumetric"``): CPM's last-stage joint logits at temperature 1 and
its 128-channel trunk features.  The reference config keys
``USE_GT_MIDDLEROOT`` and ``SCALE_KEYPOINTS_3D`` are read nowhere in the
JAX package, and the port ignores them too.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.decode import hard_argmax, softmax_decode, spatial_softmax
from ..ops.geometry import triangulate_batch, triangulate_eigh, triangulate_ransac
from ..ops.volumetric import (build_coord_volume, integrate_volumes_with_coordinates,
                              rotate_coord_volume, unproject_heatmaps)
from ..parallel import distributed
from .hrnet import HRNetOutput, PoseHRNet, hrnet_from_cfg
from .v2v import V2VModel


class Triangulation3DOutput(NamedTuple):
    """The nets' common output bundle (the JAX package's, field for field)."""

    keypoints_3d: torch.Tensor                     # (B, K, 3)
    keypoints_2d: torch.Tensor                     # (B, V, K, 2)
    heatmaps: torch.Tensor                         # (B, V, h, w, K) probabilities
    confidences: Optional[torch.Tensor] = None     # (B, V, K) alg / (B, V, 32) vol
    volumes: Optional[torch.Tensor] = None         # (B, S, S, S, K)
    coord_volumes: Optional[torch.Tensor] = None   # (B, S, S, S, 3)
    base_points: Optional[torch.Tensor] = None     # (B, 3)


def _float32(device: torch.device):
    """A region with autocast off: decoding and geometry run in float32."""
    return torch.autocast(device.type, enabled=False)


def _fold_views(images: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """(B, V, ...) -> ((B * V, ...), B, V): the views fold into the batch
    (JAX ``models/triangulation.py:56``)."""
    b, v = images.shape[:2]
    return images.reshape(b * v, *images.shape[2:]), b, v


def backbone_2d(backbone: PoseHRNet, images: torch.Tensor, use_softmax: bool
                ) -> Tuple[HRNetOutput, torch.Tensor, torch.Tensor]:
    """(head outputs, heatmaps (B, V, h, w, K), keypoints (B, V, K, 2) in
    heatmap pixels) of (B, V, H, W, 3) images: the views fold into the batch
    (reference triangulation.py:358-359), the logits are decoded as above."""
    flat, b, v = _fold_views(images)
    out = backbone.forward_head(flat)
    with _float32(images.device):
        probs = spatial_softmax(out.heatmaps, out.temperature)
        kp = (softmax_decode(out.heatmaps, out.temperature) if use_softmax
              else hard_argmax(probs))
    k = probs.shape[-1]
    return out, probs.reshape(b, v, *probs.shape[1:]), kp.reshape(b, v, k, 2)


class AlgebraicTriangulationNet(nn.Module):
    """Backbone 2D detections + differentiable DLT (reference :183-276)."""

    def __init__(self, backbone: PoseHRNet, use_softmax: bool = True,
                 use_confidences: bool = False, orig_img_size: Tuple[int, int] = (640, 480)):
        super().__init__()
        self.backbone = backbone
        self.use_softmax = use_softmax
        self.use_confidences = use_confidences
        self.orig_img_size = orig_img_size            # (W, H), reference :217

    def forward(self, images: torch.Tensor, proj_matrices: torch.Tensor
                ) -> Triangulation3DOutput:
        b, v = images.shape[:2]
        out, hm, kp2d = backbone_2d(self.backbone, images, self.use_softmax)
        with _float32(images.device):
            conf = None
            if self.use_confidences:
                conf = out.confidences.float().reshape(b, v, -1)
                # normalised across views + eps (reference :233)
                conf = conf / conf.sum(1, keepdim=True) + 1e-5
            # heatmap coords -> the original image (reference :244-247)
            w0, h0 = self.orig_img_size
            h = hm.shape[2]
            kp2d_full = kp2d * torch.tensor([w0 / h, h0 / h], device=kp2d.device)
            kp3d = triangulate_batch(kp2d_full, proj_matrices.float(), method="eigh",
                                     confidences=conf)
        return Triangulation3DOutput(keypoints_3d=kp3d, keypoints_2d=kp2d_full, heatmaps=hm,
                                     confidences=conf)


class RANSACTriangulationNet(nn.Module):
    """Backbone 2D detections + RANSAC triangulation (reference :46-180)."""

    def __init__(self, backbone: PoseHRNet, use_softmax: bool = True,
                 orig_img_size: Tuple[int, int] = (640, 480), reproj_eps: float = 40.0):
        super().__init__()
        self.backbone = backbone
        self.use_softmax = use_softmax
        self.orig_img_size = orig_img_size
        self.reproj_eps = reproj_eps

    def forward(self, images: torch.Tensor, proj_matrices: torch.Tensor
                ) -> Triangulation3DOutput:
        b, v = images.shape[:2]
        _, hm, kp2d = backbone_2d(self.backbone, images, self.use_softmax)
        with _float32(images.device):
            w0, h0 = self.orig_img_size
            h, k = hm.shape[2], hm.shape[-1]
            kp2d_full = kp2d * torch.tensor([w0 / h, h0 / h], device=kp2d.device)
            pts = kp2d_full.transpose(1, 2)                              # (B, K, V, 2)
            prj = proj_matrices.float()[:, None].expand(b, k, v, 3, 4)
            kp3d, _ = triangulate_ransac(pts, prj, reproj_eps=self.reproj_eps)
        return Triangulation3DOutput(keypoints_3d=kp3d, keypoints_2d=kp2d_full, heatmaps=hm)


class VolumetricTriangulationNet(nn.Module):
    """Volumetric triangulation (reference :277-470).

    Call with heatmap-scale projection matrices (K rescaled by the caller,
    as the reference's function3D.py:88-93).  In training mode the cuboid
    turns about the y axis by a uniform random angle drawn from
    ``generator`` (a ``torch.Generator`` on the images' device, required
    then); in eval mode it does not turn.
    """

    def __init__(self, backbone: PoseHRNet, features: int, num_joints: int = 21,
                 volume_size: int = 64, cuboid_size: float = 500.0,
                 aggregation: str = "softmax", volume_softmax: bool = True,
                 volume_multiplier: float = 1.0, use_softmax_decode: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = backbone
        self.num_joints = num_joints
        self.volume_size = volume_size
        self.cuboid_size = cuboid_size
        self.aggregation = aggregation
        self.volume_softmax = volume_softmax
        self.volume_multiplier = volume_multiplier
        self.use_softmax_decode = use_softmax_decode
        self.dtype = dtype
        # the backbone's features -> 32 channels (reference :345-347)
        self.process_features = nn.Sequential(nn.Conv2d(features, 32, 1))
        self.volume_net = V2VModel(32, num_joints)

    def _compute(self, device: torch.device):
        """Autocast in ``dtype`` for process_features and V2V (off at float32)."""
        return torch.autocast(device.type, dtype=self.dtype,
                              enabled=self.dtype != torch.float32)

    def forward(self, images: torch.Tensor, proj_matrices: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Triangulation3DOutput:
        b, v = images.shape[:2]
        dev = images.device
        out, hm, kp2d = backbone_2d(self.backbone, images, self.use_softmax_decode)
        proj = proj_matrices.float()
        with _float32(dev):
            vol_conf = None
            if out.confidences is not None:
                vol_conf = out.confidences.float().reshape(b, v, -1)
                if self.aggregation == "conf_norm":
                    vol_conf = vol_conf / vol_conf.sum(1, keepdim=True)
            # base point: the DLT of the middle-finger root (joint 9) across
            # views (reference :369-370), in heatmap-scale coordinates
            base = triangulate_eigh(kp2d[:, :, 9], proj)                   # (B, 3)
            # the cuboid around it, turned about y in training (:407-456)
            coord_volumes = build_coord_volume(base, self.cuboid_size, self.volume_size)
            if self.training:
                theta = cuboid_angles(b, generator, dev)
            else:
                theta = torch.zeros(b, device=dev)
            coord_volumes = rotate_coord_volume(coord_volumes, theta, (0, 1, 0), center=base)
        with self._compute(dev):
            feats = self.process_features(out.features.to(self.dtype).permute(0, 3, 1, 2))
        feats = feats.permute(0, 2, 3, 1)
        with _float32(dev):
            volumes = unproject_heatmaps(feats.reshape(b, v, *feats.shape[1:]), proj,
                                         coord_volumes, aggregation=self.aggregation,
                                         vol_confidences=vol_conf)
        with self._compute(dev):
            volumes = self.volume_net(volumes.to(self.dtype))
        with _float32(dev):
            kp3d, volumes = integrate_volumes_with_coordinates(
                volumes * self.volume_multiplier, coord_volumes, softmax=self.volume_softmax)
        return Triangulation3DOutput(
            keypoints_3d=kp3d, keypoints_2d=kp2d, heatmaps=hm, confidences=vol_conf,
            volumes=volumes, coord_volumes=coord_volumes, base_points=base)


def cuboid_angles(b: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The training-time cuboid turns of this rank's ``b`` samples: the
    global batch's angles, uniform in [0, 2 pi), drawn at once from
    ``generator`` (seeded alike on every rank), and this rank's slice of
    them (``parallel/distributed.py``; all of them for one process), so
    N ranks turn their cuboids as one process does the global batch, as
    JAX's one ``jax.random.uniform`` over the sharded batch does."""
    if generator is None:
        raise ValueError("training needs a torch.Generator for the cuboid's turn")
    rank = distributed.rank()
    u = torch.rand(distributed.world_size() * b, generator=generator, device=device)
    return u[rank * b:(rank + 1) * b] * (2.0 * math.pi)


class Discriminator(nn.Module):
    """WGAN critic over [pose3d | KCS Gram] features (reference
    triangulation.py:20-44, JAX :196-208): three dense layers, ReLU between,
    a scalar score.  ``in_features`` is the feature width (21*3 + 20*20 for
    ``core.trainer3d_gan.critic_features``); JAX's Dense kernels (in, out)
    load as the Linear weights (out, in)."""

    def __init__(self, in_features: int, hidden: int = 100):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.fc3 = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).float()
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.fc3(x)


def build_triangulation_net(cfg, kind: Optional[str] = None,
                            dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """The net named by ``kind`` or ``MODEL.TRIANGULATION_MODEL_NAME``
    ('alg', 'ransac', 'vol', 'vol_CPM'; reference tools/train3D.py:152-158),
    in eval mode.  ``dtype`` is the volumetric net's process_features and
    V2V compute type (the JAX net's default, bfloat16)."""
    kind = kind or str(cfg.MODEL.TRIANGULATION_MODEL_NAME)
    if kind not in ("alg", "ransac", "vol", "vol_CPM"):
        raise ValueError(f"unknown triangulation model {kind!r}")
    uses_cpm = kind == "vol_CPM" or str(cfg.MODEL.BACKBONE_NAME) == "CPM_volumetric"
    if uses_cpm and kind in ("alg", "ransac"):
        # the JAX package builds this net with no backbone, which fails at its
        # first forward (ROADMAP C14)
        raise ValueError(f"the {kind!r} net has no CPM backbone: BACKBONE_NAME "
                         "'CPM_volumetric' goes with TRIANGULATION_MODEL_NAME 'vol_CPM'")
    if uses_cpm:
        from .cpm import CPMVolumetric

        backbone = CPMVolumetric(num_joints=int(cfg.MODEL.NUM_JOINTS))
        features = backbone.feature_channels
    else:
        backbone = hrnet_from_cfg(
            cfg, head="softmax",
            vol_confidences=bool(cfg.MODEL.VOL_CONFIDENCES) and kind == "vol",
            alg_confidences=bool(cfg.MODEL.ALG_CONFIDENCES) and kind == "alg")
        features = backbone.last_layer[0].in_channels
    use_softmax = bool(cfg.MODEL.HEATMAP_SOFTMAX)
    if kind == "alg":
        net = AlgebraicTriangulationNet(backbone, use_softmax=use_softmax,
                                        use_confidences=bool(cfg.MODEL.ALG_CONFIDENCES))
    elif kind == "ransac":
        net = RANSACTriangulationNet(backbone, use_softmax=use_softmax)
    else:
        net = VolumetricTriangulationNet(
            backbone, features=features,
            num_joints=int(cfg.MODEL.NUM_JOINTS), volume_size=int(cfg.MODEL.VOLUME_SIZE),
            cuboid_size=float(cfg.MODEL.CUBOID_SIZE),
            aggregation=str(cfg.MODEL.VOLUME_AGGREGATION_METHOD),
            volume_softmax=bool(cfg.MODEL.VOLUME_SOFTMAX),
            volume_multiplier=float(cfg.MODEL.VOLUME_MULTIPLIER),
            use_softmax_decode=use_softmax, dtype=dtype)
    return net.eval()
