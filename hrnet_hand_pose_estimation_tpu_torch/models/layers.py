"""Shared conv/norm building blocks of the HRNet family, in PyTorch.

Port of the JAX package's ``models/layers.py`` (ConvBN, BasicBlock,
Bottleneck, ResLayer).  Modules carry the reference torch names
(``conv1``/``bn1``, ``downsample.0``/``downsample.1``), so a reference
``state_dict`` loads by name and ``utils/weights.py`` maps the JAX variable
tree onto it.  Tensors inside the modules are NCHW (any memory format);
the public model functions keep NHWC at their boundaries.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

# torch nn.BatchNorm2d defaults: eps 1e-5, momentum 0.1 (== flax decay 0.9).
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode forward has flax's semantics.

    flax's ``nn.BatchNorm(use_running_average=False)`` normalises with the
    *biased* batch variance and updates the running variance with it too;
    ``nn.BatchNorm2d`` updates it with the unbiased one (a factor N/(N-1):
    14 % on a 2x2 branch at batch 2).  Here the train forward normalises
    with the batch statistics, computed in float32 (``native_batch_norm``
    accumulates in float32 for bf16 inputs, as flax promotes them), returns
    the input's dtype, and sets ``running = (1 - momentum) * running +
    momentum * batch`` with the biased variance (flax's decay 0.9 = 1 -
    momentum).  It writes the running statistics during the forward, as
    torch's BN does; the train step's anomaly guard puts them back when the
    step is skipped.  The eval forward, the parameters and the state-dict
    names are ``nn.BatchNorm2d``'s.

    Inside ``synced_batch_stats`` (a data-parallel train step), the train
    forward takes its statistics over the global batch instead
    (``_synced_forward``).
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if _BN_SYNC["sum"] is not None:
            return self._synced_forward(x, _BN_SYNC["sum"])
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True,
                                                  0.0, self.eps)
        with torch.no_grad():
            var = torch.clamp(invstd.reciprocal().square() - self.eps, min=0.0)
            decay = 1.0 - self.momentum
            self.running_mean.copy_(decay * self.running_mean + (1.0 - decay) * mean)
            self.running_var.copy_(decay * self.running_var + (1.0 - decay) * var)
            self.num_batches_tracked.add_(1)
        return y

    def _synced_forward(self, x: torch.Tensor, total: Callable) -> torch.Tensor:
        """flax's train-mode BN over the global batch of a data-parallel
        step, as XLA computes it on a sharded batch: each rank's float32
        sum, sum of squares and count summed over the ranks by ``total``
        (differentiable: ``parallel/distributed.all_reduce_sum``), mean =
        S1 / N, var = max(S2 / N - mean^2, 0) (flax's fast variance), ``y =
        (x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32,
        returned in x's dtype; the running averages move toward the global
        (biased) statistics, equal on every rank."""
        xf = x.float()
        dims = [0] + list(range(2, x.dim()))
        c = x.shape[1]
        count = torch.full((1,), float(x.numel() // c), dtype=torch.float32, device=x.device)
        sums = total(torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]))
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            decay = 1.0 - self.momentum
            self.running_mean.copy_(decay * self.running_mean + (1.0 - decay) * mean)
            self.running_var.copy_(decay * self.running_var + (1.0 - decay) * var)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


# The data-parallel train step's cross-rank sum for the BN statistics and
# this rank's place in the global batch (``synced_batch_stats``); the sum is
# None outside such a step.
_BN_SYNC: Dict[str, object] = {"sum": None, "rank": 0}


@contextmanager
def synced_batch_stats(total: Callable[[torch.Tensor], torch.Tensor],
                       rank: int = 0) -> Iterator[None]:
    """Within the block, every ``BatchNorm`` in training takes its
    statistics over the global batch, summing its per-rank sums with
    ``total`` (``parallel/distributed.all_reduce_sum``).  The backward of
    that sum runs later, outside the block, as autograd records it.
    ``rank``: this rank's slice is the ``rank``-th of equal contiguous
    slices of the global batch (``data/pipeline.host_local_slice``), so a
    BN input of n rows holds the global rows [rank * n, (rank + 1) * n)
    (views and frames fold into the batch sample-major); the statistics
    levers' subsample reads it."""
    prev = dict(_BN_SYNC)
    _BN_SYNC.update(sum=total, rank=int(rank))
    try:
        yield
    finally:
        _BN_SYNC.update(prev)


# Train-mode BN statistics levers (the JAX package's ``models/layers.py``
# ``set_bn_levers``): process-wide, off by default.  They reach only the BNs
# built by ``stat_batch_norm`` -- those of ``ConvBN``, the residual blocks,
# the HRNet stem, head and confidence head, as the JAX package's
# ``layers.batch_norm`` reaches only its ConvBN's -- and only in training.
_BN_LEVERS: Dict[str, object] = {"stat_samples": 0, "stat_dtype": None}
_STAT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def set_bn_levers(stat_samples: int = 0, stat_dtype: Optional[str] = None) -> None:
    """``stat_samples=n`` takes the batch statistics over the first n
    samples only (the running averages follow the subsample);
    ``stat_dtype='bfloat16'`` reduces the mean and the mean square in bf16.
    With no arguments both are off."""
    if stat_dtype is not None and stat_dtype not in _STAT_DTYPES:
        raise ValueError(f"stat_dtype {stat_dtype!r}: want one of {sorted(_STAT_DTYPES)}")
    _BN_LEVERS["stat_samples"] = int(stat_samples)
    _BN_LEVERS["stat_dtype"] = stat_dtype


def bn_levers_active() -> bool:
    return bool(_BN_LEVERS["stat_samples"] or _BN_LEVERS["stat_dtype"])


def _mean(x: torch.Tensor, dims, dtype: torch.dtype) -> torch.Tensor:
    """jnp.mean of ``dtype`` values: summed in float32, rounded to ``dtype``."""
    return x.float().mean(dims).to(dtype)


class StatBatchNorm(BatchNorm):
    """``BatchNorm`` that takes the statistics levers in training (the JAX
    package's ``StatBatchNorm``, built in place of flax's BatchNorm when a
    lever is on).  With the levers off every forward is ``BatchNorm``'s.
    With one on: statistics over ``x[:stat_samples]`` (all of x for 0) in
    the statistics dtype, ``var = max(E[x^2] - mean^2, 0)``, both rounded
    to float32; ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias`` in
    float32, returned in x's dtype; the running averages move by flax's
    decay toward the (biased) subsample statistics.

    Inside ``synced_batch_stats`` the subsample is the global batch's first
    ``stat_samples`` rows, as JAX's on a sharded batch: this rank adds the
    float32 sums and count of its rows below that index (none on a later
    rank, which still joins the sum), and the summed moments are rounded
    to the statistics dtype once (``_synced_moments``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or not bn_levers_active():
            return super().forward(x)
        n = int(_BN_LEVERS["stat_samples"])
        dtype = _STAT_DTYPES[_BN_LEVERS["stat_dtype"] or "float32"]
        dims = [0] + list(range(2, x.dim()))
        if _BN_SYNC["sum"] is not None:
            mean, var = self._synced_moments(x, n, dtype, dims)
        else:
            xs = (x[:n] if n else x).to(dtype)
            mean = _mean(xs, dims, dtype)
            var = torch.clamp(_mean(xs * xs, dims, dtype) - mean * mean, min=0.0)
        mean, var = mean.float(), var.float()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            decay = 1.0 - self.momentum
            self.running_mean.copy_(decay * self.running_mean + (1.0 - decay) * mean)
            self.running_var.copy_(decay * self.running_var + (1.0 - decay) * var)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)

    @staticmethod
    def _synced_moments(x: torch.Tensor, n: int, dtype: torch.dtype, dims):
        """(mean, var) in ``dtype`` of the global batch's rows below ``n``
        (all rows for 0): this rank's rows [rank * m, (rank + 1) * m) of
        them, their float32 sum, sum of squares (each square in ``dtype``,
        as ``_mean(xs * xs)``) and count summed over the ranks
        (differentiable), then each moment S / N rounded to ``dtype``."""
        rows = x.shape[0]
        take = rows if not n else min(max(n - int(_BN_SYNC["rank"]) * rows, 0), rows)
        xs = x[:take].to(dtype)
        c = x.shape[1]
        count = torch.full((1,), float(take * (x.numel() // (rows * c))), dtype=torch.float32,
                           device=x.device)
        sums = _BN_SYNC["sum"](torch.cat([xs.float().sum(dims), (xs * xs).float().sum(dims),
                                          count]))
        total = sums[2 * c]
        mean = (sums[:c] / total).to(dtype)
        var = torch.clamp((sums[c:2 * c] / total).to(dtype) - mean * mean, min=0.0)
        return mean, var


class BatchNorm3d(BatchNorm):
    """``BatchNorm`` over NCDHW volumes (V2V's BatchNorm3d, flax semantics
    in training as ``BatchNorm``)."""

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() != 5:
            raise ValueError(f"expected a 5D (N, C, D, H, W) input, got {x.dim()}D")


def batch_norm(features: int) -> BatchNorm:
    return BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)


def stat_batch_norm(features: int) -> StatBatchNorm:
    """A BN that takes the statistics levers: the JAX package's ConvBN BNs."""
    return StatBatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)


def batch_norm3d(features: int) -> BatchNorm3d:
    return BatchNorm3d(features, eps=BN_EPS, momentum=BN_MOMENTUM)


def fold_bn(weight: torch.Tensor, conv_bias: Optional[torch.Tensor], bn_weight: torch.Tensor,
            bn_bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor):
    """Fold eval-mode BN into the conv before it: (OIHW kernel', bias'), float32.

    The square root is taken in float64 and rounded once to float32: the
    correctly rounded root, as XLA and numpy take it.  The CPU's vectorised
    float32 ``torch.sqrt`` is within 0.5001 ulp and misses it at some
    values, which moved a folded bf16 weight by one ulp against the JAX
    package's fold."""
    std = torch.sqrt((var.float() + BN_EPS).double()).float()
    inv = bn_weight.float() / std
    kernel = weight.float() * inv[:, None, None, None]
    bias = bn_bias.float() - mean.float() * inv
    if conv_bias is not None:
        bias = bias + conv_bias.float() * inv
    return kernel, bias


class ConvBN(nn.Sequential):
    """Conv (no bias unless asked) + BatchNorm, optionally ReLU.

    A ``Sequential`` so that its children are named ``0`` (conv), ``1`` (bn)
    and ``2`` (relu), as in the reference's transition and fuse layers.
    """

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, use_bias: bool = False):
        pad = (kernel - 1) // 2
        layers = [nn.Conv2d(in_features, features, kernel, stride, pad, bias=use_bias),
                  stat_batch_norm(features)]
        if relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class BasicBlock(nn.Module):
    """2x (3x3 conv+BN) residual block, expansion 1 (reference pose_hrnet.py:28-57)."""

    expansion = 1

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 use_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, stride, 1, bias=False)
        self.bn1 = stat_batch_norm(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = stat_batch_norm(features)
        self.downsample = (ConvBN(in_features, features, 1, stride, relu=False)
                           if use_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1(x4) residual block, expansion 4 (reference pose_hrnet.py:60-98)."""

    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 use_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 1, 1, 0, bias=False)
        self.bn1 = stat_batch_norm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = stat_batch_norm(features)
        self.conv3 = nn.Conv2d(features, features * 4, 1, 1, 0, bias=False)
        self.bn3 = stat_batch_norm(features * 4)
        self.downsample = (ConvBN(in_features, features * 4, 1, stride, relu=False)
                           if use_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}
BLOCK_EXPANSION = {"BASIC": 1, "BOTTLENECK": 4}


class ResLayer(nn.Sequential):
    """Sequential stack of residual blocks (reference _make_layer :398-415);
    children are named ``0``, ``1``, ... as in the reference."""

    def __init__(self, block: str, in_features: int, features: int,
                 num_blocks: int, stride: int = 1):
        block_cls = BLOCKS[block]
        out = features * BLOCK_EXPANSION[block]
        needs_ds = stride != 1 or in_features != out
        blocks = [block_cls(in_features, features, stride, needs_ds)]
        blocks += [block_cls(out, features) for _ in range(1, num_blocks)]
        super().__init__(*blocks)


# -- flax's default layers, for the modules the JAX package builds without
# conv_init (the model zoo: SimpleBaseline, Swin, the RVT transformer) ------

LECUN_TRUNC_STD = 0.87962566103423978    # std of a unit normal truncated at +-2


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal of std sqrt(1 / fan_in) / 0.8796
    truncated at two of its std."""
    std = (1.0 / fan_in) ** 0.5 / LECUN_TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a module computes in: autocast's where it is on, else x's
    (flax's ``dtype``)."""
    kind = x.device.type
    return torch.get_autocast_dtype(kind) if torch.is_autocast_enabled(kind) else x.dtype


class LecunConv2d(nn.Conv2d):
    """``nn.Conv2d`` trained from flax's default ``nn.Conv`` initialisation:
    a lecun-normal kernel (fan_in = the kernel's input window), a zero bias."""

    @torch.no_grad()
    def init_train_weights(self, gen: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), gen)
        if self.bias is not None:
            self.bias.zero_()


class LecunConv1d(nn.Conv1d):
    """``nn.Conv1d`` trained from flax's default ``nn.Conv`` initialisation."""

    init_train_weights = LecunConv2d.init_train_weights


class Dense(nn.Linear):
    """``nn.Linear`` trained from flax's ``nn.Dense`` initialisation (lecun
    normal kernel, zero bias).  A flax (in, out) kernel is its weight
    transposed."""

    @torch.no_grad()
    def init_train_weights(self, gen: torch.Generator) -> None:
        lecun_normal_(self.weight, self.in_features, gen)
        if self.bias is not None:
            self.bias.zero_()


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm(dtype=float32)``: eps 1e-6 (torch's default is
    1e-5), computed in float32 outside autocast whatever the input's dtype,
    float32 out; scale 1 and bias 0 at the start of training."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            return F.layer_norm(x.to(torch.promote_types(x.dtype, self.weight.dtype)),
                                self.normalized_shape, self.weight, self.bias, self.eps)

    @torch.no_grad()
    def init_train_weights(self, gen: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
