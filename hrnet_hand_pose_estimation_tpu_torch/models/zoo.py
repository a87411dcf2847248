"""Model registrations (port of the JAX package's ``models/zoo.py:15-26``).

Names match the reference's ``MODEL.NAME`` strings.  The port registers the
models it has so far: the HRNet with the plain and the softmax head, and
the softmax head with its temperature always trainable.
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


@register("pose_hrnet_trainable_softmax")
def _pose_hrnet_trainable_softmax(cfg):
    """Softmax head with the temperature trainable whatever
    MODEL.TRAINABLE_SOFTMAX says (JAX package models/zoo.py:40-44; the
    shipped training configs name it)."""
    return hrnet_from_cfg(cfg, head="softmax", trainable_softmax=True)
