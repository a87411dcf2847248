"""2D training and validation engine.

Port of the JAX package's ``core/trainer.py:56-301`` (reference
lib/core/function.py:24-162 and :635-788, tools/train.py:335-405) on one
device:

- iterates the {name: loader} dict of training sets each epoch, with the
  batches copied to the device ahead of the step (``data/pipeline.py``);
- accumulates the epoch's loss averages on the device and syncs with the
  host only every ``PRINT_FREQ`` steps, to log them;
- skips the batches of a dataset that flags ``exception``;
- validates with the eval step and ``LossComputer2D``;
- saves a checkpoint every epoch and a best-model snapshot at the lowest
  validation total, and resumes from the newest checkpoint with
  ``AUTO_RESUME``.

Warm starts: ``MODEL.PRETRAINED`` copies a reference ``.pth`` trunk by name
(the port's module names are the reference's), filtered by
``MODEL.EXTRA.PRETRAINED_LAYERS`` and shape-checked; ``MODEL.HRNET_PRETRAINED``
loads a port snapshot or checkpoint.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch

from ..data.pipeline import device_prefetch
from ..parallel.checkpoint import (CheckpointManager, load_pretrained, load_torch_checkpoint,
                                   merge_pretrained, split_state_dict)
from ..parallel.train_step import (TrainState, create_train_state, make_eval_step,
                                   make_train_step)
from ..utils.logging_utils import ScalarWriter, create_logger
from .loss_computer import LossComputer2D
from .metrics import AverageMeter


def _batch_for_step(batch: Dict) -> Dict:
    """Select and rename the tensors the steps read."""
    out = {"images": batch["imgs"]}
    if "heatmaps" in batch:
        out["target_heatmaps"] = batch["heatmaps"]
    if "pose2d" in batch:
        out["pose2d"] = batch["pose2d"]
    if "visibility" in batch:
        vis = batch["visibility"]
        out["visibility"] = vis[..., 0] if vis.dim() == out["images"].dim() - 1 else vis
    return out


def pick_train_step(cfg, model, tx):
    """Route by MODEL.NAME like the reference's train_helper dispatch; the
    CPM and multiview steps are not ported yet."""
    name = str(cfg.MODEL.NAME)
    if name in ("CPM", "multiview_pose_hrnet"):
        raise NotImplementedError(f"the {name} train step is not ported yet")
    return make_train_step(cfg, model, tx)


class Trainer:
    """End-to-end 2D trainer on one device: epochs, logging, eval, checkpoints."""

    def __init__(self, cfg, model, train_loaders, val_loaders=None,
                 output_dir: Optional[str] = None, device="cuda"):
        if int(cfg.TPU.STEPS_PER_DISPATCH) > 1:
            raise NotImplementedError("TPU.STEPS_PER_DISPATCH > 1 (make_train_multistep) is "
                                      "not ported yet")
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.train_loaders = train_loaders
        self.val_loaders = val_loaders or {}
        self.logger, default_out, tb_dir = create_logger(cfg, "train")
        self.output_dir = output_dir or default_out
        self.writer = ScalarWriter(tb_dir)
        self.ckpt = CheckpointManager(os.path.join(self.output_dir, "checkpoints"))

        steps_per_epoch = max(sum(len(l) for l in train_loaders.values()), 1)
        self.state, self.tx = create_train_state(cfg, model, steps_per_epoch, device=self.device)
        if cfg.MODEL.PRETRAINED and "hrnet" in str(cfg.MODEL.NAME).lower():
            self._warm_start(str(cfg.MODEL.PRETRAINED))
        if cfg.MODEL.HRNET_PRETRAINED:
            pre = load_pretrained(str(cfg.MODEL.HRNET_PRETRAINED))
            sd = self.state.state_dict()
            sd["params"] = pre["params"]
            sd["batch_stats"] = pre["batch_stats"] or sd["batch_stats"]
            self.state.load_state_dict(sd)
            self.logger.info("loaded pretrained weights from %s", cfg.MODEL.HRNET_PRETRAINED)

        self.train_step = pick_train_step(cfg, model, self.tx)
        self.eval_step = make_eval_step(cfg, model)
        self.begin_epoch = int(cfg.TRAIN.BEGIN_EPOCH)
        self.best_loss = float("inf")
        self.train_global_steps = 0

        if cfg.AUTO_RESUME:
            restored = self.ckpt.restore(self.state)
            if restored is not None:
                meta = restored["meta"]
                self.begin_epoch = int(meta["epoch"]) + 1
                self.best_loss = float(meta.get("best_loss", float("inf")))
                self.train_global_steps = int(meta.get("train_global_steps", 0))
                self.logger.info("AUTO_RESUME from epoch %d", self.begin_epoch)

    def _warm_start(self, path: str) -> None:
        """Partial, layer-filtered, shape-checked trunk warm start (reference
        init_weights via MODEL.PRETRAINED, pose_hrnet.py:560-585)."""
        layers = tuple(self.cfg.MODEL.EXTRA.get("PRETRAINED_LAYERS", ["*"]))
        if path.endswith((".pth", ".tar", ".pt")):
            src = {k: v for k, v in load_torch_checkpoint(path).items()
                   if "*" in layers or k.split(".")[0] in layers}
            pre = split_state_dict(src)
        else:
            pre = load_pretrained(path)
        sd = self.state.state_dict()
        sd["params"], copied, skipped = merge_pretrained(sd["params"], pre["params"])
        sd["batch_stats"], copied_s, _ = merge_pretrained(sd["batch_stats"], pre["batch_stats"])
        self.state.load_state_dict(sd)
        if skipped:
            self.logger.info("pretrained trunk: %d entries not in the pose trunk (expected for "
                             "classification checkpoints)", len(skipped))
        self.logger.info("warm-started %d param + %d stat tensors from %s",
                         len(copied), len(copied_s), path)

    # ------------------------------------------------------------ epochs
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        t_start = time.time()
        n_samples = 0
        # the epoch averages take every step (reference AverageMeter,
        # function.py:1272-1316), summed on the device; only the PRINT_FREQ
        # log lines sync with the host
        accum: Optional[Dict[str, torch.Tensor]] = None
        accum_n = 0
        print_freq = max(int(cfg.PRINT_FREQ), 1)
        last_log = self.train_global_steps - print_freq  # log the first step
        for name, loader in self.train_loaders.items():
            loader.set_epoch(epoch)
            for i, batch in enumerate(device_prefetch(iter(loader), self.device,
                                                      depth=int(cfg.TPU.PREFETCH))):
                if getattr(loader.dataset, "exception", False):
                    continue  # the reference skips flagged samples (function.py:188-190)
                step_batch = _batch_for_step(batch)
                self.state, losses = self.train_step(self.state, step_batch)
                bs = step_batch["images"].shape[0]
                n_samples += bs
                self.train_global_steps += 1
                accum = ({k: v * bs for k, v in losses.items()} if accum is None else
                         {k: accum[k] + v * bs for k, v in losses.items()})
                accum_n += bs
                if self.train_global_steps - last_log >= print_freq:
                    last_log = self.train_global_steps
                    host = {k: float(v) for k, v in losses.items()}
                    speed = n_samples / max(time.time() - t_start, 1e-9)
                    self.logger.info("Epoch[%d] %s[%d/%d] speed %.1f samples/s %s", epoch, name,
                                     i, len(loader), speed,
                                     " ".join(f"{k}={v:.5f}" for k, v in host.items()))
                    for k, v in host.items():
                        self.writer.add_scalar(f"train/{k}", v, self.train_global_steps)
        meter = AverageMeter()
        if accum is not None and accum_n:
            meter.update({k: float(v) / accum_n for k, v in accum.items()}, n=accum_n)
        return meter.averages()

    def validate(self, epoch: int) -> Dict[str, float]:
        loss_computer = LossComputer2D(self.cfg)
        meter = AverageMeter()
        for loader in self.val_loaders.values():
            for batch in device_prefetch(iter(loader), self.device, depth=2):
                step_batch = _batch_for_step(batch)
                out = self.eval_step(self.state, step_batch)
                _, loss_dict = loss_computer(
                    heatmaps_pred=out["heatmaps"], heatmaps_gt=step_batch.get("target_heatmaps"),
                    pose2d_pred=out["pose2d_pred"], pose2d_gt=step_batch.get("pose2d"),
                    visibility=step_batch.get("visibility"))
                meter.update({k: float(v) for k, v in loss_dict.items()},
                             n=step_batch["images"].shape[0])
        avgs = meter.averages()
        for k, v in avgs.items():
            self.writer.add_scalar(f"val/{k}", v, epoch)
        if avgs:
            self.logger.info("Validate[%d] %s", epoch,
                             " ".join(f"{k}={v:.5f}" for k, v in avgs.items()))
        return avgs

    def fit(self) -> TrainState:
        cfg = self.cfg
        for epoch in range(self.begin_epoch, int(cfg.TRAIN.END_EPOCH)):
            self.train_epoch(epoch)
            val = {} if cfg.WITHOUT_EVAL else self.validate(epoch)
            total = val.get("total_loss", float("inf"))
            if total < self.best_loss:
                self.best_loss = total
                self.ckpt.save_best(self.state)
                self.logger.info("new best model (val total %.5f)", total)
            self.ckpt.save(epoch, self.state, extra={
                "best_loss": self.best_loss,
                "train_global_steps": self.train_global_steps,
                "valid_global_steps": epoch,
            })
        self.writer.close()
        return self.state
