"""The reference train step, and the data of the train cells.

One step, in float32 with TF32 off: the train-mode forward
(``model.Walk``), the spatial softmax of the logits times the
temperature (trained where the configuration's model trains it), the losses of the configuration (heatmap: the squared error
summed over each map, averaged over samples and joints; pose2d: the
Euclidean error of the soft-argmax joints, summed where visible, over the
visible count; weighted by LOSS.*_FACTOR), autograd, and adam as optax
computes it (``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
both bias-corrected at the step count, ``p -= lr * mu_hat / (sqrt(nu_hat)
+ eps)``; the configuration's ``adam`` takes no weight decay).  Each
segment of the forward (stem, layer1, each transition, each HR module, the
head) is recomputed in the backward instead of kept, so a full batch fits
beside nothing else; the BN running statistics move once, in the forward.

The data: images uniform random uint8, normalized; joints uniform inside
the heatmap in heatmap pixels; visibility 1 with probability 0.9; targets
the sigma-2 Gaussians of the data loaders (centre at the truncated
coordinate, exactly 0 outside ``|d| <= int(3 sigma + 1)``, none for an
invisible joint or one off the map).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .model import BN_MOMENTUM, Walk, softmax_decode, state_shapes
from .serve import fp8_cast, normalize
from .weights import tf32_off

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def param_names(model_cfg: Mapping) -> List[str]:
    return [n for n in state_shapes(model_cfg) if n.rsplit(".", 1)[-1] not in BUFFERS]


def stat_names(model_cfg: Mapping) -> List[str]:
    """The BN running means and variances (not the counts)."""
    return [n for n in state_shapes(model_cfg) if n.rsplit(".", 1)[-1] in BUFFERS[:2]]


def gaussian_targets(joints: torch.Tensor, vis: torch.Tensor, res: int,
                     sigma: float) -> torch.Tensor:
    """(B, K, 2) [u, v] heatmap pixels, (B, K) visibility -> (B, res, res, K)."""
    x = torch.trunc(joints[..., 0]).long()
    y = torch.trunc(joints[..., 1]).long()
    valid = (vis > 0) & (x >= 0) & (y >= 0) & (x < res) & (y < res)
    px = torch.arange(res, device=joints.device)
    dx = px[None, :, None] - x[:, None, :]                      # (B, res, K)
    dy = px[None, :, None] - y[:, None, :]
    win = int(3 * sigma + 1)
    sig2 = 2.0 * sigma ** 2
    gx = torch.exp(-(dx.float() ** 2) / sig2) * (dx.abs() <= win)
    gy = torch.exp(-(dy.float() ** 2) / sig2) * (dy.abs() <= win)
    return gy[:, :, None, :] * gx[:, None, :, :] * valid[:, None, None, :].float()


def make_batches(model_cfg: Mapping, batch: int, count: int, gen: torch.Generator, device,
                 mean, std, sigma: float) -> List[Dict[str, torch.Tensor]]:
    side = int(model_cfg["IMAGE_SIZE"][0])
    res = int(model_cfg["HEATMAP_SIZE"][0])
    k = int(model_cfg["NUM_JOINTS"])
    out = []
    for _ in range(count):
        raw = torch.randint(0, 256, (batch, side, side, 3), dtype=torch.uint8, device=device,
                            generator=gen)
        joints = torch.rand((batch, k, 2), device=device, generator=gen) * res
        vis = (torch.rand((batch, k), device=device, generator=gen) < 0.9).float()
        out.append({"images": normalize(raw, mean, std), "pose2d": joints, "visibility": vis,
                    "target_heatmaps": gaussian_targets(joints, vis, res, sigma)})
    return out


def losses(probs: torch.Tensor, coords: torch.Tensor, batch: Dict[str, torch.Tensor],
           rows: slice) -> Tuple[torch.Tensor, torch.Tensor]:
    """(heatmap loss, pose2d loss) of (B, K, h, w) probabilities and (B, K, 2) joints."""
    tgt = batch["target_heatmaps"][rows].permute(0, 3, 1, 2)
    hm = ((probs - tgt) ** 2).sum(dim=(2, 3)).mean()
    vis = batch["visibility"][rows]
    d = torch.sqrt(((coords - batch["pose2d"][rows]) ** 2).sum(dim=-1))
    p2d = (d * vis).sum() / torch.clamp(vis.sum(), min=1.0)
    return hm, p2d


class FP8(torch.autograd.Function):
    """A conv operand computed in float8, as fp8 training computes it: e4m3
    in the forward, the gradient that comes back e5m2, each at a
    per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return fp8_cast(x)

    @staticmethod
    def backward(ctx, grad):
        return fp8_cast(grad, torch.float8_e5m2)


class Reference:
    """Steps of the reference from a state dict (copied, float32) on its device.

    ``fp8`` computes every conv's input, weight and output in float8
    (``FP8``: the control; where autocast rounds the forward to bf16, it
    rounds to float8);
    ``rows`` takes only those rows of each batch (a fault: half a batch);
    ``momentum`` moves the BN running statistics (a fault where it is not
    the configuration's)."""

    def __init__(self, state: Mapping[str, torch.Tensor], cfg_file: Mapping,
                 fp8: bool = False, rows: Optional[slice] = None,
                 momentum: float = BN_MOMENTUM):
        exp = cfg_file["experiment"]
        self.mc = exp["MODEL"]
        self.loss_cfg = exp["LOSS"]
        self.lr = float(exp["TRAIN"]["LR"])
        self.names = param_names(self.mc)
        self.state = {k: v.detach().clone() for k, v in state.items()}
        for n in self.names:
            self.state[n] = self.state[n].float().requires_grad_(True)
        self.mu = {n: torch.zeros_like(self.state[n]) for n in self.names}
        self.nu = {n: torch.zeros_like(self.state[n]) for n in self.names}
        self.count = 0
        self.cast: Optional[Callable] = FP8.apply if fp8 else None
        self.rows = rows or slice(None)
        self.momentum = momentum
        # the model named pose_hrnet_trainable_softmax trains its temperature
        # whatever MODEL.TRAINABLE_SOFTMAX says
        self.train_temp = (self.mc["NAME"] == "pose_hrnet_trainable_softmax"
                           or bool(self.mc.get("TRAINABLE_SOFTMAX", False)))

    def step(self, batch: Dict[str, torch.Tensor]) -> Tuple[float, Dict[str, torch.Tensor]]:
        """One step; returns (total loss, {param: gradient})."""
        walk = Walk(self.mc, "train", state=self.state, cast=self.cast, momentum=self.momentum,
                    cast_outputs=self.cast is not None)
        with tf32_off():
            xs = [batch["images"][self.rows].permute(0, 3, 1, 2).float().contiguous()]
            for _, fn in walk.segments():
                xs = list(checkpoint(lambda *t, fn=fn: tuple(fn(list(t))), *xs,
                                     use_reentrant=False))
            temp = self.state["trainable_temp"]
            probs, coords = softmax_decode(xs[0], temp if self.train_temp else temp.detach())
            hm, p2d = losses(probs, coords, batch, self.rows)
            total = (float(self.loss_cfg["HEATMAP_LOSS_FACTOR"]) * hm
                     + float(self.loss_cfg["POSE2D_LOSS_FACTOR"]) * p2d)
            walk.record_stats = False
            params = [self.state[n] for n in self.names]
            grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(p))
                 for n, p, g in zip(self.names, params, grads)}
        self.count += 1
        c1 = 1.0 - ADAM_B1 ** self.count
        c2 = 1.0 - ADAM_B2 ** self.count
        with torch.no_grad():
            for n in self.names:
                g = grads[n]
                self.mu[n].mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
                self.nu[n].mul_(ADAM_B2).add_((1 - ADAM_B2) * g * g)
                u = (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + ADAM_EPS)
                self.state[n].sub_(self.lr * u)
        return float(total.detach()), grads
