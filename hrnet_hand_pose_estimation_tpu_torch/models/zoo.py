"""Model registrations (port of the JAX package's ``models/zoo.py:15-26``).

Names match the reference's ``MODEL.NAME`` strings.  The port registers the
models it has so far: the HRNet with the plain and the softmax head, the
volumetric backbone (the softmax head with its confidence heads), the
softmax head with its temperature always trainable, the Convolutional Pose
Machine (``CPM``, JAX ``models/zoo.py:53-58``), the cross-view fusion net
(``multiview_pose_hrnet``, JAX ``:176-186``), the single-image zoo, the
temporal family (``pose_hrnet_transformer``, ``pose_hrnet_PoseAggr``,
``HRNet_PredRNN``, ``HRNet_Emb_TCN``, JAX ``:99-173``; their frame count is
``len(DATASET.SEQ_IDX)``), FTL (``DATASET.NUM_VIEWS`` views, JAX ``:62``),
the stacked ``HourGlass`` (JAX ``:82``), and the 3D triangulation nets
under the reference's ``MODEL.TRIANGULATION_MODEL_NAME`` keys (JAX
``:190-217``; ``vol_CPM`` is the CPM-backed volumetric net).
"""

from __future__ import annotations

from .hrnet import hrnet_from_cfg
from .registry import register


@register("pose_hrnet")
def _pose_hrnet(cfg):
    """Plain HRNet emitting raw heatmap logits (reference lib/models/pose_hrnet.py:603)."""
    return hrnet_from_cfg(cfg, head="plain")


@register("pose_hrnet_softmax")
def _pose_hrnet_softmax(cfg):
    """HRNet + spatial-softmax head with (optionally trainable) temperature
    (reference lib/models/pose_hrnet_softmax.py:563)."""
    return hrnet_from_cfg(cfg, head="softmax")


@register("pose_hrnet_volumetric")
def _pose_hrnet_volumetric(cfg):
    """Softmax HRNet + confidence heads; backbone of the triangulation nets
    (reference lib/models/pose_hrnet_volumetric.py:675)."""
    return hrnet_from_cfg(
        cfg, head="softmax",
        vol_confidences=bool(cfg.MODEL.VOL_CONFIDENCES),
        alg_confidences=bool(cfg.MODEL.ALG_CONFIDENCES),
    )


@register("pose_hrnet_trainable_softmax")
def _pose_hrnet_trainable_softmax(cfg):
    """Softmax head with the temperature trainable whatever
    MODEL.TRAINABLE_SOFTMAX says (JAX package models/zoo.py:40-44; the
    shipped training configs name it)."""
    return hrnet_from_cfg(cfg, head="softmax", trainable_softmax=True)


@register("CPM")
def _cpm(cfg):
    """Convolutional Pose Machine (reference lib/models/CPM.py:171)."""
    from .cpm import CPM

    return CPM(num_joints=int(cfg.MODEL.NUM_JOINTS)).eval()


@register("pose_resnet")
def _pose_resnet(cfg):
    """SimpleBaseline deconv-head ResNet (reference lib/models/pose_resnet.py:271)."""
    from .pose_resnet import pose_resnet_from_cfg

    return pose_resnet_from_cfg(cfg)


@register("swin_transformer")
def _swin(cfg):
    """Swin backbone + pose head (reference lib/models/swin_transformer.py:569-837)."""
    from .swin import swin_from_cfg

    return swin_from_cfg(cfg)


@register("pose_hrnet_hamburger")
def _hamburger(cfg):
    """HRNet + matrix-decomposition context head
    (reference lib/models/pose_hrnet_hamburger.py:17-88)."""
    from .hamburger import hamburger_from_cfg

    return hamburger_from_cfg(cfg)


@register("my_pose_transformer")
def _my_pose_transformer(cfg):
    """RVT pooling transformer (reference my_pose_transformer.py:190-370)."""
    from .transformers import pooling_transformer_from_cfg

    return pooling_transformer_from_cfg(cfg)


@register("pose_hrnet_transformer")
def _pose_hrnet_transformer(cfg):
    """Temporal PoseFormer refinement (reference pose_hrnet_transformer.py:87-245)."""
    from .transformers import PoseTransformer

    return PoseTransformer(hrnet_from_cfg(cfg, head="softmax"),
                           num_frames=len(list(cfg.DATASET.SEQ_IDX)),
                           num_joints=int(cfg.MODEL.NUM_JOINTS),
                           use_softmax=bool(cfg.MODEL.HEATMAP_SOFTMAX)).eval()


@register("pose_hrnet_PoseAggr")
def _pose_aggr(cfg):
    """Deformable temporal aggregation (reference pose_hrnet_PoseAggr.py:287-738)
    on a logits backbone: the softmax comes after the aggregation."""
    from .pose_aggr import PoseAggrNet

    return PoseAggrNet(hrnet_from_cfg(cfg, head="plain"),
                       seq_len=len(list(cfg.DATASET.SEQ_IDX)),
                       num_joints=int(cfg.MODEL.NUM_JOINTS),
                       dilation_rates=tuple(int(d) for d in cfg.MODEL.DILATION_RATES),
                       heatmap_softmax=bool(cfg.MODEL.HEATMAP_SOFTMAX),
                       trainable_softmax=bool(cfg.MODEL.TRAINABLE_SOFTMAX)).eval()


@register("HRNet_PredRNN")
def _predrnn(cfg):
    """HRNet + PredRNN temporal refinement (reference predrnn.py:186-236)."""
    from .temporal import HRNetPredRNN

    return HRNetPredRNN(hrnet_from_cfg(cfg, head="softmax"),
                        num_hidden=tuple(int(n) for n in cfg.MODEL.N_HIDDEN),
                        num_joints=int(cfg.MODEL.NUM_JOINTS)).eval()


@register("HRNet_Emb_TCN")
def _tcn(cfg):
    """HRNet embeddings + temporal convs (reference hrnet_emb_model.py:186-236)."""
    from .temporal import HRNetEmbTCN

    return HRNetEmbTCN(hrnet_from_cfg(cfg, head="softmax"),
                       seq_len=len(list(cfg.DATASET.SEQ_IDX)),
                       embedding_size=int(cfg.MODEL.EMBEDDING_SIZE),
                       tcn_channels=int(cfg.MODEL.TCN_CHANNELS),
                       filter_widths=tuple(int(f) for f in cfg.MODEL.FILTER_WIDTHS),
                       num_joints=int(cfg.MODEL.NUM_JOINTS)).eval()


@register("multiview_pose_hrnet")
def _multiview_pose_hrnet(cfg):
    """Cross-view fusion net (reference lib/models/multiview_pose_hrnet.py:74)."""
    from .multiview_hrnet import MultiViewPoseNet

    return MultiViewPoseNet(hrnet_from_cfg(cfg, head="softmax"),
                            n_views=int(cfg.DATASET.NUM_VIEWS),
                            hm_size=int(cfg.MODEL.HEATMAP_SIZE[0]),
                            aggre=bool(cfg.MODEL.AGGRE)).eval()


# 3D triangulation nets, keyed like the reference tools/train3D.py:152-158
def _triangulation(kind: str):
    def build(cfg):
        from .triangulation import build_triangulation_net

        return build_triangulation_net(cfg, kind)

    build.__doc__ = f"The {kind!r} triangulation net (models/triangulation.py)."
    return build


for _kind in ("alg", "ransac", "vol", "vol_CPM"):
    register(_kind)(_triangulation(_kind))


@register("FTL")
def _ftl(cfg):
    """Feature-transform-layer multiview net (reference FTL_encoder_decoder.py:83),
    its own convs in bfloat16 as the JAX registry builds them."""
    from .ftl import ftl_from_cfg

    return ftl_from_cfg(cfg)


@register("HourGlass")
def _hourglass(cfg):
    """Stacked hourglass filter bank (reference lib/models/HourGlass.py:124-226)."""
    from .hourglass import hourglass_from_cfg

    return hourglass_from_cfg(cfg)
