"""Model-specific 2D train steps: CPM and the multi-view fusion net.

Port of the JAX package's ``core/train_variants.py``.  The reference's
train loop dispatches on MODEL.NAME inside train_helper
(lib/core/function.py:29-34 for CPM's centre maps) and trains the 'MHP_mv'
fusion net on its raw AND its fused heatmaps (:195-276).  Each variant is
its own step builder with ``make_train_step``'s signature, ``step(state,
batch) -> (state, losses)``, and ``pick_train_step`` routes by model name.

The fusion step decodes the raw heatmaps from the backbone's logits with
``ops.decode.softmax_decode``: on the card one launch of kernel B4 forward
and, through autograd, one of its backward per step.  The fused heatmaps are
a linear mix of probabilities, not a softmax, so they are decoded by the
plain ``soft_argmax``, as in JAX.

Both steps are data-parallel under a process group of several ranks, as
``make_train_step`` (JAX runs them inside the 2D Trainer's mesh): the BN
statistics of the global batch, each loss this rank's share over the
global denominators, the gradients summed in one all-reduce, the losses
reported global.  The fusion net folds views within a sample, so a rank's
slice of the batch holds whole samples.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from ..ops.decode import decode_heatmaps, softmax_decode
from ..parallel import distributed
from ..parallel.train_step import (Optimizer, TrainState, _check_cfg, apply_guarded_update,
                                   compute_autocast, count_sum, global_batch_stats,
                                   make_train_step, reduce_step)
from . import losses as L
from .loss_computer import LossComputer2D


def _begin(model: nn.Module, state: TrainState, detect: bool):
    if state.model is not model:
        raise ValueError("the state belongs to another model")
    model.train()
    return (state.stats.clone(), state.counts.clone()) if detect else None


def make_train_step_cpm(cfg, model: nn.Module, tx: Optimizer) -> Callable:
    """CPM: image + centre map in; the LAST stage's (K+1)-channel belief map
    is held to the (K+1)-channel target, background included (reference
    function.py:29-34), by ``heatmap_loss``.  A K-channel target gets its
    background channel ``1 - max`` on the fly.  batch: 'images',
    'centermaps', 'target_heatmaps'.  Losses: 'total_loss' (and
    'nonfinite_grads' with the guard)."""
    _check_cfg(cfg)
    detect = bool(cfg.TPU.DETECT_ANOMALY)
    ranks = distributed.data_size()
    counts = count_sum(ranks)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        stats_before = _begin(model, state, detect)
        images = batch["images"]
        with torch.enable_grad():
            with compute_autocast(cfg, images.device), global_batch_stats(ranks):
                pred = model(images, batch["centermaps"])[-1]
            gt = batch["target_heatmaps"]
            if gt.shape[-1] == pred.shape[-1] - 1:
                gt = torch.cat([1.0 - gt.amax(dim=-1, keepdim=True), gt], dim=-1)
            if gt.shape[1:] != pred.shape[1:]:
                # CPM's maps are the input / 8; the JAX step fails here too (ROADMAP C14)
                raise ValueError(f"CPM belief maps {tuple(pred.shape[1:])} and targets "
                                 f"{tuple(gt.shape[1:])} differ: MODEL.HEATMAP_SIZE must be "
                                 "MODEL.IMAGE_SIZE / 8 for CPM")
            total = L.heatmap_loss(pred, gt, count_sum=counts)
            state.grads.zero_()
            total.backward()
        losses = reduce_step(ranks, state.grads, {"total_loss": total.detach()})
        return apply_guarded_update(cfg, tx, state, losses, stats_before)

    return step


def make_train_step_mv(cfg, model: nn.Module, tx: Optimizer) -> Callable:
    """The fusion net: the raw and the fused heatmaps both supervised by
    ``LossComputer2D`` (reference function.py:195-276).  batch: 'images'
    (B, V, H, W, 3), 'target_heatmaps' (B, V, h, w, K), 'pose2d' (B, V, K, 2)
    in heatmap pixels, 'visibility' (B, V, K).  Losses: 'total_loss',
    'raw_loss', 'fused_loss' (and 'nonfinite_grads' with the guard).

    With HEATMAP_SOFTMAX the raw keypoints are ``softmax_decode`` of the
    backbone's logits and temperature (JAX: ``soft_argmax`` of their
    spatial softmax); without it both branches take the argmax."""
    _check_cfg(cfg)
    ranks = distributed.data_size()
    loss_computer = LossComputer2D(cfg, count_sum=count_sum(ranks))
    use_softmax = bool(cfg.MODEL.HEATMAP_SOFTMAX)
    detect = bool(cfg.TPU.DETECT_ANOMALY)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        stats_before = _begin(model, state, detect)
        images = batch["images"]
        b, v = images.shape[:2]
        flat = lambda t: t.reshape(b * v, *t.shape[2:])
        with torch.enable_grad():
            with compute_autocast(cfg, images.device), global_batch_stats(ranks):
                out = model(images)
            with torch.autocast(images.device.type, enabled=False):
                raw, fused = flat(out.raw_heatmaps), flat(out.fused_heatmaps)
                pose_raw = (softmax_decode(flat(out.logits), out.temperature) if use_softmax
                            else decode_heatmaps(raw, False))
                targets = dict(heatmaps_gt=flat(batch["target_heatmaps"]),
                               pose2d_gt=batch["pose2d"].reshape(b * v, -1, 2),
                               visibility=batch["visibility"].reshape(b * v, -1))
                t_raw, _ = loss_computer(heatmaps_pred=raw, pose2d_pred=pose_raw, **targets)
                t_fused, _ = loss_computer(heatmaps_pred=fused,
                                           pose2d_pred=decode_heatmaps(fused, use_softmax),
                                           **targets)
                total = t_raw + t_fused
            state.grads.zero_()
            total.backward()
        losses = reduce_step(ranks, state.grads,
                             {"total_loss": total.detach(), "raw_loss": t_raw.detach(),
                              "fused_loss": t_fused.detach()})
        return apply_guarded_update(cfg, tx, state, losses, stats_before)

    return step


def pick_train_step(cfg, model: nn.Module, tx: Optimizer) -> Callable:
    """Route by MODEL.NAME like the reference's train_helper dispatch."""
    name = str(cfg.MODEL.NAME)
    if name == "CPM":
        return make_train_step_cpm(cfg, model, tx)
    if name == "multiview_pose_hrnet":
        return make_train_step_mv(cfg, model, tx)
    return make_train_step(cfg, model, tx)
