"""3D multi-view training and validation engine.

Port of the JAX package's ``core/trainer3d.py`` (reference
lib/core/function3D.py:18-513 and tools/train3D.py) on one device, or on
each rank of a data-parallel process group:

- the nets: 'alg' and 'ransac' triangulate at the original image scale
  (their ``pose2d`` ground truth scaled up to it, function3D.py:69-74),
  'vol' takes projections with K rescaled to the heatmap (:88-93);
- the losses: ``LossComputer3D`` (pose3d, volumetric CE, KCS and the 2D
  terms);
- freezing: the backbone is frozen below stage4 and its head, and the
  softmax temperature is frozen, with their own learning rates for
  ``process_features`` and ``volume_net`` (triangulation.py:329-343,
  tools/train3D.py:190-197): JAX's ``optax.multi_transform`` over path
  labels is one adam here with a per-element LR scale (``Optimizer``'s
  ``lr_scale``), the labels JAX's rule read on the port's module names.

The frozen layers still run their BNs in train mode and update the running
statistics, as JAX's ``model.apply(..., True, mutable=["batch_stats"])``
does.  The step is ``step(state, batch, generator)``: the volumetric net's
cuboid turns by an angle drawn from ``generator`` (a ``torch.Generator`` on
the device), where JAX draws it from its ``aug`` key.  The 2D keypoints of
the softmax nets come from ``ops.decode.softmax_decode``, i.e. one launch
of kernel B4 forward and one of its backward per step on the card.

Data parallel, as the 2D step (``parallel/train_step``): under a process
group of several ranks each rank steps on its slice of the global batch
and the step is JAX's on the global batch, sharded over its mesh -- the BN
statistics summed over the ranks, every loss this rank's numerator over
the global denominator (``LossComputer3D(count_sum=...)``), one all-reduce
of the flat gradient buffer, the losses reported global; the cuboid turns
are the global batch's draw, sliced (``models/triangulation.cuboid_angles``).
``Trainer3D`` starts every rank from rank 0's weights, sums the
validation error over the ranks, and writes its files on rank 0 alone.
It is data-parallel only, as JAX's (``core/trainer3d.py:180`` builds
``make_mesh(("data",))`` whatever ``TPU.MESH_AXES`` says): it lays out no
grid, so under a world of several ranks every rank is a data rank, and no
weight splits over a 'model' axis (the GAN trainer likewise).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..data.pipeline import device_prefetch
from ..models.triangulation import VolumetricTriangulationNet
from ..parallel import distributed
from ..parallel.checkpoint import CheckpointManager
from ..parallel.train_step import (Optimizer, TrainState, _check_cfg, apply_guarded_update,
                                   broadcast_state, compute_autocast, count_sum,
                                   global_batch_stats, init_train_weights, make_lr_schedule,
                                   reduce_step)
from ..utils.logging_utils import ScalarWriter, create_logger
from .evaluator3d import build_projections
from .loss_computer import LossComputer3D
from .metrics import AverageMeter

# JAX labels a backbone path 'main' when it holds stage4, head_cb,
# final_conv or confidence_head (core/trainer3d.py:41-72).  The port's
# backbone modules whose JAX paths do (utils/weights.py's _RULES): stage4.*
# (stage4_m*), last_layer.* (head_cb, final_conv) and the confidence heads
# (confidence_head).  transition3.* comes from transition3_k, which lacks
# "stage4", and trainable_temp is frozen by name.  vol_CPM's CPMVolumetric:
# JAX's rule reads "stage4" in its path backbone/cpm/stage4/..., CPM's
# fourth refinement stage (the port's cpm.conv1_stage4, cpm.Mconv*_stage4),
# which so trains; the rest of the CPM and feat_trunk are frozen.
_MAIN_MODULES = ("stage4", "last_layer", "vol_confidences", "alg_confidences")


def _backbone_label(rest: str) -> str:
    head, _, sub = rest.partition(".")
    if head == "cpm":
        return "main" if sub.split(".")[0].endswith("_stage4") else "frozen"
    return "main" if head in _MAIN_MODULES else "frozen"


def freeze_labels(model: nn.Module) -> Dict[str, str]:
    """{parameter name: 'main' | 'process' | 'volume' | 'frozen'} of a
    triangulation net, JAX's labels of the flax paths the port's parameters
    come from: ``process_features.*`` 'process', ``volume_net.*`` 'volume',
    ``backbone.{stage4,last_layer,vol_confidences,alg_confidences}.*``
    'main', the rest of the backbone 'frozen' (``transition3`` and the
    temperature too); of a CPM backbone, ``cpm.*_stage4.*`` 'main' and the
    rest 'frozen'."""
    out = {}
    for name, _ in model.named_parameters():
        top, _, rest = name.partition(".")
        if top == "process_features":
            out[name] = "process"
        elif top == "volume_net":
            out[name] = "volume"
        elif top == "backbone":
            out[name] = _backbone_label(rest)
        else:
            raise KeyError(f"{name}: not a parameter of a triangulation net")
    return out


def make_optimizer_3d(cfg, model: nn.Module, steps_per_epoch: int = 1000) -> Optimizer:
    """optax's ``multi_transform`` of tools/train3D.py:190-197 on the flat
    buffer: adam at the schedule for 'main', at the schedule times
    PROCESS_FEATURE_LR / LR and VOLUME_NET_LR / LR for 'process' and
    'volume', nothing for 'frozen' (JAX core/trainer3d.py:75-89)."""
    if str(cfg.TRAIN.OPTIMIZER).lower() != "adam":
        raise NotImplementedError(f"TRAIN.OPTIMIZER {cfg.TRAIN.OPTIMIZER!r}: the 3D trainer "
                                  "runs adam, as the JAX package's")
    lr = float(cfg.TRAIN.LR)
    ratio = {"main": 1.0, "process": float(cfg.TRAIN.PROCESS_FEATURE_LR) / lr,
             "volume": float(cfg.TRAIN.VOLUME_NET_LR) / lr, "frozen": 0.0}
    labels = freeze_labels(model)
    scale = torch.cat([torch.full((p.numel(),), ratio[labels[n]], dtype=torch.float32)
                       for n, p in model.named_parameters()])
    return Optimizer("adam", make_lr_schedule(cfg, steps_per_epoch), lr_scale=scale)


def _step_inputs(cfg, batch: Dict, orig_size) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(projections, pose2d ground truth at the net's scale, its (B, V, K)
    visibility)."""
    kind = str(cfg.MODEL.TRIANGULATION_MODEL_NAME)
    proj = build_projections(cfg, batch["intrinsic_matrix"], batch["extrinsic_matrices"],
                             orig_size, kind)
    pose2d_gt = batch["pose2d"].float()
    if kind in ("alg", "ransac"):
        # GT to the original image scale (function3D.py:69-71)
        hm = float(cfg.MODEL.HEATMAP_SIZE[0])
        ow, oh = orig_size
        pose2d_gt = pose2d_gt * torch.tensor([ow / hm, oh / hm], device=pose2d_gt.device)
    vis = batch["visibility"]
    return proj, pose2d_gt, (vis[..., 0] if vis.dim() == 4 else vis)


def forward_3d(cfg, model: nn.Module, images: torch.Tensor, proj: torch.Tensor,
               generator: Optional[torch.Generator]):
    """The net's forward under ``TPU.COMPUTE_DTYPE`` autocast; the volumetric
    net turns its cuboid by an angle from ``generator`` in train mode."""
    with compute_autocast(cfg, images.device):
        if isinstance(model, VolumetricTriangulationNet):
            return model(images, proj, generator)
        return model(images, proj)


def make_train_step_3d(cfg, model: nn.Module, tx: Optimizer, orig_size) -> Callable:
    """The 3D train step: ``step(state, batch, generator) -> (state, losses)``
    (JAX core/trainer3d.py:105-157).

    batch: {'images': (B, V, H, W, 3), 'pose2d': (B, V, K, 2) heatmap px,
    'pose3d': (B, K, 3) mm, 'visibility', 'extrinsic_matrices' (B, V, 3, 4),
    'intrinsic_matrix' (B, 3, 3), optionally 'heatmaps'}, on the model's
    device.  The update goes through ``apply_guarded_update``.  Under a
    process group of several ranks the step is data-parallel (see the
    module docstring).
    """
    _check_cfg(cfg)
    ranks = distributed.world_size()
    loss_computer = LossComputer3D(cfg, count_sum=count_sum(ranks))
    detect = bool(cfg.TPU.DETECT_ANOMALY)

    def step(state: TrainState, batch: Dict, generator: Optional[torch.Generator]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.model is not model:
            raise ValueError("the state belongs to another model")
        model.train()
        proj, pose2d_gt, vis2d = _step_inputs(cfg, batch, orig_size)
        stats_before = (state.stats.clone(), state.counts.clone()) if detect else None
        with torch.enable_grad():
            with global_batch_stats(ranks):
                out = forward_3d(cfg, model, batch["images"], proj, generator)
            pose3d_gt = batch["pose3d"].float()
            kwargs = dict(pose3d_pred=out.keypoints_3d, pose3d_gt=pose3d_gt,
                          validity=torch.ones_like(pose3d_gt[..., :1]))
            if out.volumes is not None:
                kwargs.update(coord_volumes=out.coord_volumes, volumes_pred=out.volumes)
            k = pose3d_gt.shape[1]
            if loss_computer.loss2d.with_pose2d:
                kwargs.update(pose2d_pred=out.keypoints_2d.reshape(-1, k, 2),
                              pose2d_gt=pose2d_gt.reshape(-1, k, 2),
                              visibility=vis2d.reshape(-1, k))
            if loss_computer.loss2d.with_heatmap and "heatmaps" in batch:
                kwargs.update(heatmaps_pred=out.heatmaps.reshape(-1, *out.heatmaps.shape[2:]),
                              heatmaps_gt=batch["heatmaps"].reshape(
                                  -1, *batch["heatmaps"].shape[2:]))
            total, loss_dict = loss_computer(**kwargs)
            state.grads.zero_()
            total.backward()
        loss_dict = reduce_step(ranks, state.grads,
                                {key: val.detach() for key, val in loss_dict.items()})
        return apply_guarded_update(cfg, tx, state, loss_dict, stats_before)

    return step


def make_eval_step_3d(cfg, model: nn.Module, orig_size) -> Callable:
    """``step(state, batch) -> {'keypoints_3d', 'keypoints_2d'}``: the forward
    in eval mode with the running statistics (JAX core/trainer3d.py:160-168)."""

    @torch.no_grad()
    def step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state belongs to another model")
        proj, _, _ = _step_inputs(cfg, batch, orig_size)
        was_training = model.training
        model.eval()
        try:
            out = forward_3d(cfg, model, batch["images"], proj, None)
        finally:
            model.train(was_training)
        return {"keypoints_3d": out.keypoints_3d, "keypoints_2d": out.keypoints_2d}

    return step


def batch_for_step(batch: Dict) -> Dict:
    """Select and rename the loader's tensors the steps read."""
    out = {"images": batch["imgs"]}
    for key in ("pose2d", "pose3d", "visibility", "extrinsic_matrices", "intrinsic_matrix",
                "heatmaps"):
        if key in batch:
            out[key] = batch[key]
    return out


class Trainer3D:
    """Epoch orchestration for the 3D nets on one device or one rank
    (tools/train3D.py:342-429): train epochs, EPE3D validation, a
    checkpoint each epoch and a best-model snapshot, AUTO_RESUME.  Across
    ranks the loaders give each its slice, every rank starts from rank 0's
    weights and reads the checkpoints on AUTO_RESUME, EPE3D is the global
    batches' (equal on every rank, and so is the best-model choice), and
    rank 0 alone writes logs, scalars and checkpoints."""

    def __init__(self, cfg, model: nn.Module, train_loaders, val_loaders=None,
                 output_dir: Optional[str] = None, device="cuda"):
        _check_cfg(cfg)
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.train_loaders = train_loaders
        self.val_loaders = val_loaders or {}
        self.ranks = distributed.world_size()
        self.main = distributed.rank() == 0          # the rank that writes
        self.logger, default_out, tb_dir = create_logger(cfg, "train3d", write=self.main)
        self.output_dir = output_dir or default_out
        self.writer = ScalarWriter(tb_dir if self.main else None)
        self.ckpt = CheckpointManager(os.path.join(self.output_dir, "checkpoints"),
                                      create=self.main)
        self.generator = torch.Generator(device=self.device).manual_seed(int(cfg.TPU.SEED))

        loader = next(iter(train_loaders.values()))
        self.orig_size = tuple(getattr(loader.dataset, "orig_img_size", (640, 480)))
        steps_per_epoch = max(sum(len(l) for l in train_loaders.values()), 1)
        init_train_weights(model, int(cfg.TPU.SEED))
        model.to(self.device).train()
        self.tx = make_optimizer_3d(cfg, model, steps_per_epoch)
        self.state = TrainState(model, self.tx)
        self.train_step = make_train_step_3d(cfg, model, self.tx, self.orig_size)
        self.eval_step = make_eval_step_3d(cfg, model, self.orig_size)
        self.begin_epoch = int(cfg.TRAIN.BEGIN_EPOCH)
        self.best_loss = float("inf")

        if cfg.AUTO_RESUME:
            restored = self.ckpt.restore(self.state)
            if restored is not None:
                self.begin_epoch = int(restored["meta"]["epoch"]) + 1
                self.best_loss = float(restored["meta"].get("best_loss", float("inf")))
                self.logger.info("AUTO_RESUME from epoch %d", self.begin_epoch)
        broadcast_state(self.state)

    def _batches(self, loader):
        return device_prefetch(iter(loader), self.device, depth=int(self.cfg.TPU.PREFETCH))

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        meter = AverageMeter()
        t0 = time.time()
        n = 0
        print_freq = max(int(self.cfg.PRINT_FREQ), 1)
        for name, loader in self.train_loaders.items():
            loader.set_epoch(epoch)
            for i, batch in enumerate(self._batches(loader)):
                self.state, losses = self.train_step(self.state, batch_for_step(batch),
                                                     self.generator)
                bs = batch["imgs"].shape[0] * self.ranks      # the global batch
                n += bs
                if i % print_freq == 0:
                    host = {k: float(v) for k, v in losses.items()}
                    meter.update(host, n=bs)
                    self.logger.info("Epoch[%d] %s[%d/%d] %.1f samples/s %s", epoch, name, i,
                                     len(loader), n / max(time.time() - t0, 1e-9),
                                     " ".join(f"{k}={v:.4f}" for k, v in host.items()))
        return meter.averages()

    def validate(self, epoch: int) -> Dict[str, float]:
        err_sum, count = 0.0, 0
        for loader in self.val_loaders.values():
            for batch in self._batches(loader):
                out = self.eval_step(self.state, batch_for_step(batch))
                err = torch.linalg.vector_norm(out["keypoints_3d"].float()
                                               - batch["pose3d"].float(), dim=2)
                err_sum += float(err.sum())
                count += err.numel()
        if self.ranks > 1:
            # the global batches' error, equal on every rank
            err_sum, count = distributed.sum_(torch.tensor(
                [err_sum, count], dtype=torch.float64, device=self.device)).tolist()
        epe3d = err_sum / max(count, 1)
        self.logger.info("Validate3D[%d] EPE3D=%.3f mm", epoch, epe3d)
        self.writer.add_scalar("val/epe3d_mm", epe3d, epoch)
        return {"total_loss": epe3d, "epe3d_mm": epe3d}

    def fit(self) -> TrainState:
        for epoch in range(self.begin_epoch, int(self.cfg.TRAIN.END_EPOCH)):
            self.train_epoch(epoch)
            val = {} if self.cfg.WITHOUT_EVAL else self.validate(epoch)
            total = val.get("total_loss", float("inf"))
            if total < self.best_loss:
                self.best_loss = total
                if self.main:
                    self.ckpt.save_best(self.state)
            if self.main:
                self.ckpt.save(epoch, self.state, extra={"best_loss": self.best_loss})
        self.writer.close()
        return self.state
