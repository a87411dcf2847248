"""3D multi-view evaluation: 2D px + 3D mm EPE / PCK / AUC with artifacts.

Port of the JAX package's ``core/evaluator3d.py`` (reference
tools/evaluate_3D.py:143-420), on one device:

- mode 'model': a triangulation net (``models/triangulation``) gives the 2D
  and 3D keypoints; the volumetric net gets heatmap-scale projections
  (``update_after_resize``, reference :324-360), alg and ransac the
  original ones (:310-319);
- mode 'dlt': the plain 2D backbone (``models.build_model``) per view,
  forwarded and decoded as ``Evaluator2D.forward`` does (a softmax head's
  logits by ``ops.decode.softmax_decode``, the hand-written kernel on a
  card), then the shifted-inverse-iteration DLT (:293-303);
- 2D EPE / PCK (px, thresholds 1..49) and 3D EPE / PCK (mm, 1..50) + AUC;
- artifacts ``eval3D_results_<EXP>/{mse2d,mse3d}_each_joint.txt`` +
  ``PCK{2,3}d.txt`` in the JAX package's formats;
- ``views`` selects a subset of the view axis.

The forward runs under ``TPU.COMPUTE_DTYPE`` autocast, as the 2D
evaluator's; decoding and geometry run in float32.

``mesh`` (``parallel/mesh.make_mesh``) evaluates data-parallel, as the JAX
package's evaluator on a mesh (its ``:60-80``): one replica of the net per
data row, the images (B, V, H, W, 3) and projections (B, V, 3, 4) split
along B over the 'data' axis (a batch that does not divide raises
``ValueError``), the keypoints gathered on the mesh's first device, which
must be ``device``; the dlt mode's triangulation runs there.  With a
'model' axis the replicas are the rows' split nets
(``parallel/tensor_parallel.row_replicas``), as JAX puts the net's
variables on ``param_shardings`` (its ``:60-88``).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..ops.geometry import compose_projection, triangulate_batch, update_after_resize
from ..parallel.checkpoint import join_state_dict
from ..parallel.train_step import compute_autocast
from .evaluator import Evaluator2D
from .metrics import (PoseMetricState, default_thresholds_2d, default_thresholds_3d, pck_at,
                      pck_auc)


def build_projections(cfg, intrinsic: torch.Tensor, extrinsics: torch.Tensor, orig_size,
                      kind: str) -> torch.Tensor:
    """P = K' [R|t] per view, (B, V, 3, 4) float32 from (B, 3, 3) intrinsics
    and (B, V, 3, 4) extrinsics: K rescaled from the original image
    ``orig_size`` (W, H) to the heatmap for the volumetric net (``kind``
    containing 'vol'; reference function3D.py:88-93), kept at the original
    scale for alg and ransac (JAX ``core/trainer3d.py:92-102``)."""
    hm = int(cfg.MODEL.HEATMAP_SIZE[0])
    K = intrinsic.float()
    if "vol" in kind:
        K = update_after_resize(K, (orig_size[1], orig_size[0]), (hm, hm))
    return compose_projection(K[:, None], extrinsics.float())


class Evaluator3D:
    def __init__(self, cfg, model, variables: Optional[Mapping] = None, mode: str = "model",
                 mesh=None, device="cuda"):
        """``model``: a triangulation net (mode 'model') or a 2D port model
        (mode 'dlt'); ``variables`` its weights (a state_dict or {"params",
        "batch_stats"}, loaded strictly; None or empty keeps the model's
        own)."""
        if mode not in ("model", "dlt"):
            raise ValueError(f"unknown 3D evaluation mode {mode!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import check_home

            self.device = check_home(mesh, device)
        if variables:
            model.load_state_dict(join_state_dict(variables))
        self.model = model.to(self.device).eval()
        self._replicas = None
        # the dlt mode's per-view forward and decode are the 2D evaluator's
        self._2d = Evaluator2D(cfg, self.model, device=self.device) if mode == "dlt" else None
        self.mode = mode
        self.kind = str(cfg.MODEL.TRIANGULATION_MODEL_NAME)
        self.th2d = default_thresholds_2d()
        self.th3d = default_thresholds_3d()

    @torch.no_grad()
    def forward(self, images: torch.Tensor, proj: torch.Tensor):
        """(B, V, H, W, 3) images and (B, V, 3, 4) projections on the device
        -> (2D keypoints (B, V, K, 2), 3D keypoints (B, K, 3) or None in
        mode 'dlt'), on the device; with a mesh, over the mesh's replicas."""
        if self.mesh is None:
            return self.forward_with(self.model, images, proj)
        from ..parallel.mesh import run_sharded
        from ..parallel.tensor_parallel import row_replicas

        if self._replicas is None:
            self._replicas = row_replicas(self.mesh, self.model)
        return run_sharded(self.mesh, self.forward_with, self._replicas, images, proj)

    @torch.no_grad()
    def forward_with(self, model, images: torch.Tensor, proj: torch.Tensor):
        """``forward`` through ``model`` (this evaluator's net or a replica
        of it) on the device of ``images``."""
        if self.mode == "model":
            with compute_autocast(self.cfg, images.device):
                out = model(images, proj)
            return out.keypoints_2d, out.keypoints_3d
        b, v = images.shape[:2]
        kp2d = self._2d.forward_with(model, images.reshape(b * v, *images.shape[2:]))
        return kp2d.reshape(b, v, -1, 2), None

    def projections(self, batch: Mapping, orig_size) -> torch.Tensor:
        """(B, V, 3, 4) float32 projections on the device (``build_projections``;
        the dlt mode keeps K at the original scale)."""
        K = torch.as_tensor(np.asarray(batch["intrinsic_matrix"], np.float32), device=self.device)
        E = torch.as_tensor(np.asarray(batch["extrinsic_matrices"], np.float32),
                            device=self.device)
        return build_projections(self.cfg, K, E, orig_size,
                                 self.kind if self.mode == "model" else "dlt")

    def run(self, loader, views: Optional[Sequence[int]] = None,
            output_dir: Optional[str] = None) -> Dict[str, float]:
        cfg = self.cfg
        hm = float(cfg.MODEL.HEATMAP_SIZE[0])
        n_joints = int(cfg.DATASET.NUM_JOINTS)
        orig_size = tuple(getattr(loader.dataset, "orig_img_size", (640, 480)))
        ow, oh = orig_size
        m2d = PoseMetricState.create(n_joints, self.th2d)
        m3d = PoseMetricState.create(n_joints, self.th3d)
        scale = np.asarray([ow / hm, oh / hm], np.float32)

        for batch in loader:
            images = np.asarray(batch["imgs"], np.float32)
            if views is not None:
                sel = np.asarray(views)
                images = images[:, sel]
                batch = dict(batch)
                for key in ("extrinsic_matrices", "pose2d", "visibility"):
                    batch[key] = np.asarray(batch[key])[:, sel]
            proj = self.projections(batch, orig_size)
            kp2d, kp3d = self.forward(torch.from_numpy(np.ascontiguousarray(images)).to(
                self.device), proj)
            kp2d = kp2d.float().cpu().numpy()
            b, v = kp2d.shape[:2]

            if self.mode == "dlt":
                kp2d_full = kp2d * scale
                kp3d = triangulate_batch(torch.from_numpy(kp2d_full).to(self.device), proj,
                                         method="sii")
            elif "vol" in self.kind:
                kp2d_full = kp2d * scale     # vol keeps heatmap coords (:324-360)
            else:
                kp2d_full = kp2d             # alg / ransac already at the original scale
            kp3d = kp3d.float().cpu()

            gt2d = np.asarray(batch["pose2d"], np.float32) * scale
            vis = np.asarray(batch["visibility"], np.float32)
            vis = vis[..., 0] if vis.ndim == 4 else vis
            pred2d = np.ascontiguousarray(kp2d_full.reshape(b * v, -1, 2))
            m2d = m2d.update(torch.from_numpy(pred2d), torch.from_numpy(gt2d.reshape(b * v, -1, 2)),
                             torch.from_numpy(vis.reshape(b * v, -1)), self.th2d)
            m3d = m3d.update(kp3d, torch.from_numpy(np.asarray(batch["pose3d"], np.float32)),
                             torch.ones(b, n_joints), self.th3d)

        pck2d, pck3d = m2d.pck_curve(), m3d.pck_curve()
        th2d, th3d = self.th2d.numpy(), self.th3d.numpy()
        results = {
            "EPE2D_px": m2d.epe_mean(),
            "EPE3D_mm": m3d.epe_mean(),
            "PCK3D_AUC": pck_auc(pck3d, th3d, end=None),
            "PCK3D@20mm": pck_at(pck3d, th3d, 20.0),
            "PCK2D_AUC_30": pck_auc(pck2d, th2d),
        }
        if output_dir:
            d = os.path.join(output_dir, f"eval3D_results_{cfg.EXP_NAME}")
            os.makedirs(d, exist_ok=True)
            np.savetxt(os.path.join(d, "mse2d_each_joint.txt"), m2d.epe_per_joint(), fmt="%.4f")
            np.savetxt(os.path.join(d, "mse3d_each_joint.txt"), m3d.epe_per_joint(), fmt="%.4f")
            np.savetxt(os.path.join(d, "PCK2d.txt"), np.stack((th2d, pck2d)))
            np.savetxt(os.path.join(d, "PCK3d.txt"), np.stack((th3d, pck3d)))
        return results
