"""2D training and validation engine.

Port of the JAX package's ``core/trainer.py:56-301`` (reference
lib/core/function.py:24-162 and :635-788, tools/train.py:335-405) on one
device, or on each rank of a data-parallel process group:

- iterates the {name: loader} dict of training sets each epoch, with the
  batches copied to the device ahead of the step (``data/pipeline.py``);
- accumulates the epoch's loss averages on the device and syncs with the
  host only every ``PRINT_FREQ`` steps, to log them;
- runs ``TPU.STEPS_PER_DISPATCH`` steps a call (``make_train_multistep``,
  the leftover batches one step each) and arms the BN statistics levers
  ``TPU.BN_STAT_SAMPLES`` / ``BN_STAT_DTYPE``;
- skips the batches of a dataset that flags ``exception``;
- validates with the eval step and ``LossComputer2D``, dumping the first
  validation batch of each epoch as images with ``DEBUG.DEBUG``;
- saves a checkpoint every epoch and a best-model snapshot at the lowest
  validation total, and resumes from the newest checkpoint with
  ``AUTO_RESUME``.

Data parallel: when a process group of several ranks is up
(``parallel/distributed.py``, one rank a GPU), the loaders give each rank
its slice of the global batch order, the train step is JAX's step on the
global batch (``parallel/train_step``: synced BN statistics, global loss
denominators, summed gradients), the epoch and validation averages are
the global batches' losses, equal on every rank, and rank 0 alone writes
logs, TensorBoard scalars, checkpoints and best-model snapshots; every
rank reads them on ``AUTO_RESUME``.  The ranks start from rank 0's
weights.  The CPM and fusion steps are data-parallel alike, and the BN
statistics levers take the global batch's subsample
(``models/layers.StatBatchNorm``).

The ranks form the grid ``TPU.MESH_AXES`` / ``MESH_SHAPE`` over the
process group's world (``distributed.init_grid``, the JAX trainer's
``make_mesh``; a shape that does not cover the world raises
``ValueError``).  With a 'model' axis larger than 1 each rank keeps its
shard of the wide weights (``parallel/tensor_parallel.py``), the data
ranks of one model index sum their gradients and statistics, and a
checkpoint holds the gathered whole state -- parameters, moments, BN
statistics -- so it loads into a one-process ``Trainer``, and a resume
under the grid splits it again.  The CPM and fusion steps split alike
(the fusion net's ``pair_fc`` is gathered at its use).

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
from ..models.layers import set_bn_levers
from ..parallel import distributed
from ..parallel.train_step import (TrainState, broadcast_state, count_sum, create_train_state,
                                   global_losses, make_eval_step, make_train_multistep)
from ..utils.logging_utils import ScalarWriter, create_logger
from .loss_computer import LossComputer2D
from .metrics import AverageMeter
from .train_variants import pick_train_step

_ONE_STEP_MODELS = ("CPM", "multiview_pose_hrnet")


def _batch_for_step(batch: Dict) -> Dict:
    """Select and rename the tensors the steps read."""
    out = {"images": batch["imgs"]}
    if "heatmaps" in batch:
        out["target_heatmaps"] = batch["heatmaps"]
    if "pose2d" in batch:
        out["pose2d"] = batch["pose2d"]
    if "centermaps" in batch:  # CPM (reference function.py:29-34)
        out["centermaps"] = batch["centermaps"]
    if "visibility" in batch:
        vis = batch["visibility"]
        out["visibility"] = vis[..., 0] if vis.dim() == out["images"].dim() - 1 else vis
    return out


class Trainer:
    """End-to-end 2D trainer on one device or one rank: epochs, logging,
    eval, checkpoints."""

    def __init__(self, cfg, model, train_loaders, val_loaders=None,
                 output_dir: Optional[str] = None, device="cuda"):
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.train_loaders = train_loaders
        self.val_loaders = val_loaders or {}
        distributed.init_grid(tuple(cfg.TPU.MESH_AXES), tuple(cfg.TPU.MESH_SHAPE))
        self.ranks = distributed.data_size()        # the global batch is ranks x the local
        self.main = distributed.rank() == 0          # the rank that writes
        self.logger, default_out, tb_dir = create_logger(cfg, "train", write=self.main)
        self.output_dir = output_dir or default_out
        self.writer = ScalarWriter(tb_dir if self.main else None)
        self.ckpt = CheckpointManager(os.path.join(self.output_dir, "checkpoints"),
                                      create=self.main)

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

        # the train-mode BN statistics levers (process-wide, as in JAX; off
        # by default); evaluation uses the running statistics, untouched
        if int(cfg.TPU.BN_STAT_SAMPLES) or str(cfg.TPU.BN_STAT_DTYPE):
            set_bn_levers(int(cfg.TPU.BN_STAT_SAMPLES), str(cfg.TPU.BN_STAT_DTYPE) or None)
            self.logger.info("BN statistics levers active: stat_samples=%s stat_dtype=%s",
                             cfg.TPU.BN_STAT_SAMPLES, cfg.TPU.BN_STAT_DTYPE or "float32")
        self.train_step = pick_train_step(cfg, model, self.tx)
        # K train steps a call (the 2D step only; CPM and the fusion net keep
        # one step a call, as in JAX)
        self.steps_per_dispatch = (int(cfg.TPU.STEPS_PER_DISPATCH)
                                   if str(cfg.MODEL.NAME) not in _ONE_STEP_MODELS else 1)
        self.train_multistep = (make_train_multistep(cfg, model, self.tx)
                                if self.steps_per_dispatch > 1 else None)
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
        broadcast_state(self.state)     # every rank from rank 0's weights and statistics

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
        k_dispatch = self.steps_per_dispatch
        pending: list = []
        # log every ~PRINT_FREQ steps (a plain ``i % PRINT_FREQ`` would never
        # fire with K steps a call when PRINT_FREQ is no multiple of K)
        print_freq = max(int(cfg.PRINT_FREQ), 1)
        last_log = self.train_global_steps - print_freq  # log the first step

        def add(weighted, n):
            nonlocal accum, accum_n
            accum = weighted if accum is None else {k: accum[k] + v for k, v in weighted.items()}
            accum_n += n

        for name, loader in self.train_loaders.items():
            loader.set_epoch(epoch)
            for i, batch in enumerate(device_prefetch(iter(loader), self.device,
                                                      depth=int(cfg.TPU.PREFETCH))):
                if getattr(loader.dataset, "exception", False):
                    continue  # the reference skips flagged samples (function.py:188-190)
                step_batch = _batch_for_step(batch)
                bs = step_batch["images"].shape[0] * self.ranks      # the global batch
                if self.train_multistep is not None:
                    pending.append(step_batch)
                    if len(pending) < k_dispatch:
                        continue
                    stacked = {k: torch.stack([b[k] for b in pending]) for k in pending[0]}
                    pending = []
                    self.state, losses_k = self.train_multistep(self.state, stacked)
                    n_samples += bs * k_dispatch
                    self.train_global_steps += k_dispatch
                    add({k: v.sum(dim=0) * bs for k, v in losses_k.items()}, bs * k_dispatch)
                    losses = {k: v[-1] for k, v in losses_k.items()}
                else:
                    self.state, losses = self.train_step(self.state, step_batch)
                    n_samples += bs
                    self.train_global_steps += 1
                    add({k: v * bs for k, v in losses.items()}, bs)
                if self.train_global_steps - last_log >= print_freq:
                    last_log = self.train_global_steps
                    host = {k: float(v) for k, v in losses.items()}
                    speed = n_samples / max(time.time() - t_start, 1e-9)
                    self.logger.info("Epoch[%d] %s[%d/%d] speed %.1f samples/s %s", epoch, name,
                                     i, len(loader), speed,
                                     " ".join(f"{k}={v:.5f}" for k, v in host.items()))
                    for k, v in host.items():
                        self.writer.add_scalar(f"train/{k}", v, self.train_global_steps)
        # the leftover batches (< K at the epoch's end) take one step each
        for step_batch in pending:
            self.state, losses = self.train_step(self.state, step_batch)
            bs = step_batch["images"].shape[0] * self.ranks
            n_samples += bs
            self.train_global_steps += 1
            add({k: v * bs for k, v in losses.items()}, bs)
        meter = AverageMeter()
        if accum is not None and accum_n:
            meter.update({k: float(v) / accum_n for k, v in accum.items()}, n=accum_n)
        return meter.averages()

    def validate(self, epoch: int) -> Dict[str, float]:
        # each rank's loss shares over the global batch, summed: the global
        # batch's losses, as JAX's validate computes them
        sync = self.ranks > 1
        loss_computer = LossComputer2D(self.cfg, count_sum=count_sum(self.ranks))
        meter = AverageMeter()
        debug_dumped = not self.main
        for name, loader in self.val_loaders.items():
            for batch in device_prefetch(iter(loader), self.device, depth=2):
                step_batch = _batch_for_step(batch)
                out = self.eval_step(self.state, step_batch)
                if self.cfg.DEBUG.DEBUG and not debug_dumped:
                    # the first val batch of each epoch as image grids under the
                    # run dir (reference utils/vis.py:193-240, JAX core/trainer.py:248-263)
                    from ..utils.vis import save_debug_images

                    hm_scale = step_batch["images"].shape[1] / out["heatmaps"].shape[1]
                    pose2d = step_batch.get("pose2d")
                    save_debug_images(
                        self.cfg, step_batch["images"],
                        None if pose2d is None else pose2d * hm_scale,
                        out["pose2d_pred"] * hm_scale, step_batch.get("target_heatmaps"),
                        out["heatmaps"],
                        prefix=os.path.join(self.output_dir, f"debug_e{epoch}_{name}"))
                    debug_dumped = True
                hm_gt = step_batch.get("target_heatmaps")
                if hm_gt is not None and hm_gt.shape[-1] == out["heatmaps"].shape[-1] + 1:
                    hm_gt = hm_gt[..., 1:]   # drop CPM's background channel
                _, loss_dict = loss_computer(
                    heatmaps_pred=out["heatmaps"], heatmaps_gt=hm_gt,
                    pose2d_pred=out["pose2d_pred"], pose2d_gt=step_batch.get("pose2d"),
                    visibility=step_batch.get("visibility"))
                if sync:
                    loss_dict = global_losses(loss_dict)
                meter.update({k: float(v) for k, v in loss_dict.items()},
                             n=step_batch["images"].shape[0] * self.ranks)
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
            # under a model axis every rank gathers the shards with the others
            gather = self.main or distributed.model_size() > 1
            payload = self.state.state_dict() if gather else None
            if total < self.best_loss:
                self.best_loss = total
                if self.main:
                    self.ckpt.save_best(payload)
                self.logger.info("new best model (val total %.5f)", total)
            if self.main:
                self.ckpt.save(epoch, payload, extra={
                    "best_loss": self.best_loss,
                    "train_global_steps": self.train_global_steps,
                    "valid_global_steps": epoch,
                })
        self.writer.close()
        return self.state
