"""2D evaluation engine: full-test-set EPE / PCK / AUC with artifact output.

Port of the JAX package's ``core/evaluator.py`` (reference
tools/evaluate_2D.py:149-296), on one device:

- batch forward over the eval loader and decode.  With
  ``MODEL.HEATMAP_SOFTMAX`` and a softmax head the forward stops at the
  head's logits (``PoseHRNet.forward_logits``) and ``ops.decode.softmax_decode``
  decodes them: the hand-written kernel on a card, computing exactly the
  JAX package's ``soft_argmax(spatial_softmax(y, T))``.  Otherwise the maps
  are decoded as the JAX package decodes them: ``soft_argmax`` of the raw
  maps (a plain head with ``HEATMAP_SOFTMAX``), or the argmax;
- rescale heatmap-space predictions to the original image, as the reader
  declares (``dataset.rescale``): crop_size/hm + corner, else orig_size/hm;
- visibility-masked per-joint EPE + PCK over thresholds 1..49 px;
- artifacts ``mse2d_each_joint.txt`` + ``PCK2d.txt`` in
  ``eval2D_results_<EXP_NAME>/``, in the JAX package's formats;
- wall-clock fps with the reference's 20-batch warm-up skip.

``serving='int8'`` evaluates the port's int8 W8A8 serving path instead
(``core/quant_infer``), calibrated on the first eval batch or loaded from
a saved record.  Multi-GPU evaluation (``mesh=``) is ROADMAP A11.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..ops.decode import decode_heatmaps, softmax_decode
from ..parallel.checkpoint import join_state_dict
from ..parallel.train_step import compute_autocast
from .metrics import PoseMetricState, default_thresholds_2d, pck_at, pck_auc


class Evaluator2D:
    def __init__(self, cfg, model, variables: Optional[Mapping] = None, mesh=None,
                 serving: str = "std", calib_path: str = "", device="cuda"):
        """``model`` is a port model (``models.build_model``); ``variables``
        its weights, a state_dict or {"params", "batch_stats"} (loaded
        strictly into ``model``; None or empty keeps the model's own).
        ``serving='int8'`` evaluates the calibrated W8A8 serving path; it
        calibrates on the first eval batch unless ``calib_path`` names a
        saved record (tools/calibrate.py)."""
        if mesh is not None:
            raise NotImplementedError("multi-GPU evaluation (mesh=) is not ported yet "
                                      "(ROADMAP A11)")
        if serving not in ("std", "int8"):
            raise ValueError(f"unknown serving mode: {serving!r}")
        if serving == "int8" and not cfg.MODEL.HEATMAP_SOFTMAX:
            # the int8 serving path decodes via the fused softmax soft-argmax
            # head; on a non-softmax config its metrics would measure the
            # decode swap, not quantization
            raise ValueError(
                "serving='int8' requires a softmax-decode config "
                "(MODEL.HEATMAP_SOFTMAX: true)")
        self.cfg = cfg
        self.device = torch.device(device)
        if variables:
            model.load_state_dict(join_state_dict(variables))
        self.model = model.to(self.device).eval()
        self.serving = serving
        self.calib_path = calib_path
        self._qfn = None
        self._qparams = None
        self._weights = None
        self.use_softmax = bool(cfg.MODEL.HEATMAP_SOFTMAX)
        # B4 decodes logits, so it serves only a head that has them
        self.decode_logits = self.use_softmax and getattr(model, "head", None) == "softmax"
        self.thresholds = default_thresholds_2d()

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """The standard forward: (B, H, W, 3) images on the device ->
        (B, K, 2) coordinates in heatmap pixels, on the device."""
        with compute_autocast(self.cfg, self.device):
            if self.decode_logits:
                logits, temperature = self.model.forward_logits(images)
            else:
                heatmaps = self.model(images).heatmaps
        if self.decode_logits:
            return softmax_decode(logits, temperature)
        return decode_heatmaps(heatmaps, self.use_softmax)

    def _build_serving(self, calib_images: torch.Tensor) -> None:
        """Calibrate + build the int8 serving forward on first use (or load
        a saved calibration record when ``calib_path`` was given)."""
        from .fast_infer import precast_variables
        from .quant_infer import (calibrate, load_calibration, make_quant_infer,
                                  prepare_serving_qparams)

        state = self.model.state_dict()
        self._weights = precast_variables(self.cfg, state, device=self.device)
        if self.calib_path:
            amax = load_calibration(self.calib_path, self.cfg)
        else:
            amax = calibrate(self.cfg, self._weights, [calib_images])
        self._qparams = prepare_serving_qparams(self.cfg, state, amax)
        self._qfn = make_quant_infer(self.cfg, device=self.device)

    def _put_images(self, images) -> torch.Tensor:
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        return images.to(self.device)

    def run(self, loader, dataset_name: str = "", output_dir: Optional[str] = None
            ) -> Dict[str, float]:
        # dataset_name is informational only (kept for CLI compatibility);
        # the rescale dispatch is declared by the reader (``dataset.rescale``)
        cfg = self.cfg
        hm_size = float(cfg.MODEL.HEATMAP_SIZE[0])
        n_joints = int(cfg.DATASET.NUM_JOINTS)
        metrics = PoseMetricState.create(n_joints, self.thresholds)

        # fps warm-up: the reference skips the first 20 batches
        # (evaluate_2D.py:229-231); shrink the skip when the loader is
        # shorter so small eval sets still report a (noisier) fps
        try:
            n_batches = len(loader)
        except TypeError:
            n_batches = None
        warmup = 21 if (n_batches is None or n_batches > 30) else \
            max(min(1, n_batches - 1), 0)

        infer_time = [0, 0.0]
        for i, batch in enumerate(loader):
            images = self._put_images(batch["imgs"])
            if self.serving == "int8" and self._qfn is None:
                self._build_serving(images)
            t0 = time.time()
            if self._qfn is not None:
                pose2d_pred = self._qfn(self._weights, self._qparams, images)
            else:
                pose2d_pred = self.forward(images)
            pose2d_pred = pose2d_pred.cpu().numpy()        # waits for the device
            if i >= warmup:
                infer_time[0] += 1
                infer_time[1] += time.time() - t0

            pose2d_gt = np.asarray(batch["pose2d"], np.float32)
            vis = np.asarray(batch["visibility"], np.float32)
            if vis.ndim == 3:
                vis = vis[..., 0]

            # rescale to the original image (reference :235-245); the mode
            # is DECLARED by the reader (``dataset.rescale``), not inferred
            # from batch keys
            rescale = getattr(getattr(loader, "dataset", None), "rescale", "orig_size")
            if rescale == "crop_corner" and "corner" in batch:
                crop = np.asarray(batch["crop_size"], np.float32).reshape(-1, 1, 1)
                corner = np.asarray(batch["corner"], np.float32)[:, None, :]
                pose2d_pred = pose2d_pred * crop / hm_size + corner
                pose2d_gt = pose2d_gt * crop / hm_size + corner
            else:
                ow, oh = getattr(loader.dataset, "orig_img_size", (hm_size, hm_size))
                pose2d_pred = pose2d_pred * np.asarray([ow / hm_size, oh / hm_size])
                pose2d_gt = pose2d_gt * np.asarray([ow / hm_size, oh / hm_size])

            # float32 accumulation, as the JAX package (its arrays are float32)
            metrics = metrics.update(
                torch.from_numpy(np.asarray(pose2d_pred, np.float32)),
                torch.from_numpy(np.asarray(pose2d_gt, np.float32)),
                torch.from_numpy(vis), self.thresholds)

        epe = metrics.epe_per_joint()
        pck = metrics.pck_curve()
        fps = infer_time[0] * loader.batch_size / infer_time[1] if infer_time[1] else 0.0
        th = self.thresholds.numpy()
        results = {
            "EPE_px": float(epe.mean()),
            "PCK_AUC_30": pck_auc(pck, th),               # reference plot slice (misc.py:281)
            "PCK_AUC_full": pck_auc(pck, th, end=None),
            "PCK@20px": pck_at(pck, th, 20.0),
            "fps": fps,
        }

        if output_dir:
            result_dir = os.path.join(output_dir, f"eval2D_results_{cfg.EXP_NAME}")
            os.makedirs(result_dir, exist_ok=True)
            np.savetxt(os.path.join(result_dir, "mse2d_each_joint.txt"), epe, fmt="%.4f")
            np.savetxt(os.path.join(result_dir, "PCK2d.txt"), np.stack((th, pck)))
        return results
