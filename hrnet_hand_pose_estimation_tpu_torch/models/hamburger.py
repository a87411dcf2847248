"""Hamburger matrix-decomposition context head on HRNet, in PyTorch.

Port of the JAX package's ``models/hamburger.py`` (reference
lib/models/hamburger/{ham.py,burger.py}, pose_hrnet_hamburger.py:17-88):

- ``nmf_update``, ``vq_update``, ``cd_update``: one step of the three
  decompositions of X (B, D, N) into bases W (B, D, R) and codes H (B, R, N);
- ``NMFHam``: the low-rank context: the fixed bases ``bases`` (1, D, R),
  a buffer (JAX's ``ham_bases/w`` variable, drawn there by
  ``jax.random.uniform(key(0))``; here from a numpy seed), TRAIN_STEPS
  updates in train mode and EVAL_STEPS in eval mode, of which only the last
  is differentiated (the reference's one-step gradient: the first steps - 1
  run under ``torch.no_grad()``), then the reconstruction W H;
- ``Hamburger``: the bread-ham-bread sandwich (1x1 conv down to 512, the
  ham, 1x1 conv + BN back, the skip, ReLU);
- ``PoseHRNetHamburger``: the port's ``PoseHRNet`` with the hamburger
  between the concatenated features and the head.  The trunk keeps its
  reference names (a PoseHRNet trunk loads), and the head's ``head_cb`` and
  ``final_conv`` are ``last_layer.{0,1,3}``.

Precision: JAX runs the decomposition in float32 at ``Precision.HIGHEST``;
the port runs the ham outside autocast with TF32 off for its products, in
the forward and in the backward (``ops/precision.bmm_f32``).

The YAMLs' DUAL_HAM, ZERO_HAM, CHEESE_FACTOR and INV_T are not read (INV_T
stays 100), as in JAX.  JAX's 2D train and eval steps fail on this model
(its ``ham_bases`` collection is not in the train state, ROADMAP C16), so
the port's raise; ``Evaluator2D``, ``make_forward_fn`` and the tools run it,
decoding its softmax head's logits with kernel B4 on the card.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.precision import bmm_f32
from .hrnet import PoseHRNet, StageCfg
from .layers import ConvBN


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)


def nmf_update(x: torch.Tensor, w: torch.Tensor, h: torch.Tensor, eps: float = 1e-6):
    """One multiplicative NMF update (reference ham.py NMF2D steps).

    x: (B, D, N) non-negative; w: (B, D, R); h: (B, R, N).  JAX's
    three-operand einsums are two products here, in the order that keeps the
    intermediate small (R x R where D x N is larger): (WᵀW)H and W(HHᵀ).
    """
    # H <- H * (Wᵀ X) / ((WᵀW) H)
    wtx = bmm_f32(_t(w), x)
    wtwh = bmm_f32(bmm_f32(_t(w), w), h)
    h = h * wtx / (wtwh + eps)
    # W <- W * (X Hᵀ) / (W (H Hᵀ))
    xht = bmm_f32(x, _t(h))
    whht = bmm_f32(w, bmm_f32(h, _t(h)))
    w = w * xht / (whht + eps)
    return w, h


def vq_update(x: torch.Tensor, w: torch.Tensor, inv_t: float = 100.0):
    """One soft vector-quantisation EM step (reference ham.py VQ2D): E, the
    columns of X soft-assigned to the bases by negative squared distance at
    temperature INV_T over its mean; M, the bases become the
    assignment-weighted means.  -> (w, h (B, R, N))."""
    d2 = ((w * w).sum(dim=1)[:, :, None] - 2.0 * bmm_f32(_t(w), x)
          + (x * x).sum(dim=1)[:, None, :])
    h = torch.softmax(-inv_t * d2 / torch.clamp(d2.mean(), min=1e-12), dim=1)
    w = bmm_f32(x, _t(h)) / torch.clamp(h.sum(dim=2)[:, None, :], min=1e-6)
    return w, h


def _unit_columns(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-6)


def cd_update(x: torch.Tensor, w: torch.Tensor, inv_t: float = 100.0):
    """One concept-decomposition step (reference ham.py CD2D): cosine
    soft assignment, then re-normalised weighted means."""
    h = torch.softmax(inv_t * bmm_f32(_t(_unit_columns(w)), _unit_columns(x)), dim=1)
    return _unit_columns(bmm_f32(x, _t(h))), h


class NMFHam(nn.Module):
    """Low-rank matrix-decomposition context (reference ham.py:14-271) of
    ``channels`` = D features with ``rank`` = R bases; ``ham_type`` 'NMF',
    'VQ' or 'CD'.  NCHW in and out, in the input's dtype."""

    def __init__(self, channels: int, rank: int = 64, train_steps: int = 6, eval_steps: int = 7,
                 ham_type: str = "NMF", inv_t: float = 100.0):
        super().__init__()
        if ham_type not in ("NMF", "VQ", "CD"):
            raise ValueError(f"unknown HAM_TYPE {ham_type!r}")
        self.rank, self.ham_type, self.inv_t = rank, ham_type, float(inv_t)
        self.train_steps, self.eval_steps = train_steps, eval_steps
        # fixed random bases (reference RAND_INIT), drawn from a fixed seed as
        # JAX draws them from key(0); not trained
        self.register_buffer("bases", torch.from_numpy(np.random.default_rng(0).uniform(
            size=(1, channels, rank)).astype(np.float32)))

    def _update(self, x, w, h):
        if self.ham_type == "NMF":
            return nmf_update(x, w, h)
        if self.ham_type == "VQ":
            return vq_update(x, w, self.inv_t)
        return cd_update(x, w, self.inv_t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, hh, ww = x.shape
        n = hh * ww
        with torch.autocast(x.device.type, enabled=False):
            flat = x.to(self.bases.dtype).reshape(b, d, n)
            if self.ham_type == "NMF":
                flat = torch.relu(flat)          # NMF needs non-negative data
            w = self.bases.expand(b, d, self.rank)
            h = torch.full((b, self.rank, n), 1.0 / self.rank, dtype=flat.dtype,
                           device=flat.device)
            steps = self.train_steps if self.training else self.eval_steps
            # the one-step gradient: only the final update is differentiated
            with torch.no_grad():
                for _ in range(steps - 1):
                    w, h = self._update(flat, w, h)
            w, h = self._update(flat, w, h)
            recon = bmm_f32(w, h)
        return recon.reshape(b, d, hh, ww).to(x.dtype)


class Hamburger(nn.Module):
    """Bread-ham-bread sandwich, V2-style (reference burger.py:18-208); NCHW."""

    def __init__(self, in_channels: int, channels: int = 512, rank: int = 64,
                 train_steps: int = 6, eval_steps: int = 7, ham_type: str = "NMF"):
        super().__init__()
        self.lower_bread = nn.Conv2d(in_channels, channels, 1, bias=False)
        self.ham = NMFHam(channels, rank, train_steps, eval_steps, ham_type)
        self.upper_bread = ConvBN(channels, in_channels, 1, 1, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x + self.upper_bread(self.ham(self.lower_bread(x))))


class PoseHRNetHamburger(PoseHRNet):
    """HRNet + hamburger context before the final head
    (reference pose_hrnet_hamburger.py:17-88)."""

    def __init__(self, stage2: StageCfg, stage3: StageCfg, stage4: StageCfg,
                 num_joints: int = 21, rank: int = 64, train_steps: int = 6,
                 eval_steps: int = 7, ham_type: str = "NMF", trainable_softmax: bool = False,
                 heatmap_softmax: bool = True):
        super().__init__(stage2, stage3, stage4, num_joints,
                         head="softmax" if heatmap_softmax else "plain",
                         trainable_softmax=trainable_softmax)
        total = sum(stage4.out_channels)
        self.hamburger = Hamburger(total, 512, rank, train_steps, eval_steps, ham_type)

    def _context(self, features: torch.Tensor) -> torch.Tensor:
        return self.hamburger(features)


def hamburger_from_cfg(cfg) -> PoseHRNetHamburger:
    """PoseHRNetHamburger from MODEL.EXTRA's stages, R, TRAIN_STEPS,
    EVAL_STEPS, HAM_TYPE, TRAINABLE_SOFTMAX and HEATMAP_SOFTMAX, in eval mode."""
    extra = cfg.MODEL.EXTRA
    return PoseHRNetHamburger(
        stage2=StageCfg.from_cfg(extra["STAGE2"]), stage3=StageCfg.from_cfg(extra["STAGE3"]),
        stage4=StageCfg.from_cfg(extra["STAGE4"]), num_joints=int(cfg.MODEL.NUM_JOINTS),
        rank=int(cfg.MODEL.R), train_steps=int(cfg.MODEL.TRAIN_STEPS),
        eval_steps=int(cfg.MODEL.EVAL_STEPS), ham_type=str(cfg.MODEL.HAM_TYPE),
        trainable_softmax=bool(cfg.MODEL.TRAINABLE_SOFTMAX),
        heatmap_softmax=bool(cfg.MODEL.HEATMAP_SOFTMAX)).eval()
