"""Plain float32 HRNet with the softmax heatmap head and soft-argmax decode.

HRNet as Sun et al. describe it ("Deep High-Resolution Representation
Learning for Human Pose Estimation", arXiv:1902.09212): a stem of two
stride-2 3x3 convs, layer1 of four bottlenecks, then stages 2-4 whose
modules run BasicBlock branches and fuse every branch into every other (1x1
conv and nearest upsample from a coarser branch, chains of stride-2 3x3
convs from a finer one, summed, then ReLU).  The head upsamples the three
coarser branches bilinearly (align corners) to the finest, concatenates
them, and applies a 1x1 conv + BN + ReLU and a final 1x1 conv; the logits
times the temperature go through a softmax over the map, and the decode is
the expectation of the pixel coordinates under it ([u, v], heatmap pixels).

Everything here is plain PyTorch over a dict of tensors keyed by the module
names of the original implementation (``conv1.weight``,
``layer1.0.downsample.0.weight``, ``stage3.1.fuse_layers.2.0.1.1.running_var``,
``last_layer.3.bias``, ``trainable_temp``), so one state dict serves the
program under test and this reference.  It imports nothing of the program.

Two walks:

- ``Walk(mode="eval")`` on BN-folded convs (``fold``), optionally with a
  fake-quantized conv per site (``Quant``) or a cast of every conv's
  operands (``cast``), and optionally recording each conv input's absolute
  maximum (calibration);
- ``Walk(mode="train")`` on the raw state with train-mode BN: batch
  statistics with the biased variance, running averages moved by
  ``BN_MOMENTUM`` toward them while ``record_stats`` is on.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class Stage(NamedTuple):
    modules: int
    branches: int
    blocks: Tuple[int, ...]
    channels: Tuple[int, ...]

    @property
    def out(self) -> Tuple[int, ...]:
        return self.channels          # BasicBlock stages: expansion 1


def stages(model_cfg: Mapping) -> Tuple[Stage, Stage, Stage]:
    """Stages 2-4 from a configuration's MODEL mapping (``MODEL.EXTRA.STAGEn``)."""
    out = []
    for n in (2, 3, 4):
        s = model_cfg["EXTRA"][f"STAGE{n}"]
        if s["BLOCK"] != "BASIC":
            raise ValueError(f"STAGE{n}: the reference builds BASIC stages, got {s['BLOCK']}")
        out.append(Stage(int(s["NUM_MODULES"]), int(s["NUM_BRANCHES"]),
                         tuple(int(b) for b in s["NUM_BLOCKS"]),
                         tuple(int(c) for c in s["NUM_CHANNELS"])))
    return tuple(out)


# ---------------------------------------------------------------------------
# the convs, in order, with the BN after each
# ---------------------------------------------------------------------------

class ConvSpec(NamedTuple):
    conv: str           # module name of the conv ("layer1.0.conv2")
    bn: Optional[str]   # module name of its BN, None for the final conv
    cin: int
    cout: int
    k: int
    stride: int
    bias: bool          # the conv has a bias of its own
    hw_in: int          # input side at the configured image size


def conv_specs(model_cfg: Mapping) -> List[ConvSpec]:
    """Every conv of the network in forward order, with its shapes at the
    configuration's image size (square)."""
    size = int(model_cfg["IMAGE_SIZE"][0])
    joints = int(model_cfg["NUM_JOINTS"])
    fk = int(model_cfg["EXTRA"].get("FINAL_CONV_KERNEL", 1))
    specs = [ConvSpec("conv1", "bn1", 3, 64, 3, 2, False, size),
             ConvSpec("conv2", "bn2", 64, 64, 3, 2, False, size // 2)]
    hw = size // 4
    cin = 64
    for b in range(4):
        p = f"layer1.{b}"
        specs += [ConvSpec(f"{p}.conv1", f"{p}.bn1", cin, 64, 1, 1, False, hw),
                  ConvSpec(f"{p}.conv2", f"{p}.bn2", 64, 64, 3, 1, False, hw),
                  ConvSpec(f"{p}.conv3", f"{p}.bn3", 64, 256, 1, 1, False, hw)]
        if b == 0:
            specs.append(ConvSpec(f"{p}.downsample.0", f"{p}.downsample.1", cin, 256, 1, 1,
                                  False, hw))
        cin = 256
    pre = (256,)
    for n, st in enumerate(stages(model_cfg), start=2):
        t = f"transition{n - 1}"
        for i in range(st.branches):
            if i < len(pre):
                if st.out[i] != pre[i]:
                    specs.append(ConvSpec(f"{t}.{i}.0", f"{t}.{i}.1", pre[i], st.out[i], 3, 1,
                                          False, hw >> i))
            else:
                for j in range(i + 1 - len(pre)):
                    ch = st.out[i] if j == i - len(pre) else pre[-1]
                    specs.append(ConvSpec(f"{t}.{i}.{j}.0", f"{t}.{i}.{j}.1", pre[-1], ch, 3, 2,
                                          False, hw >> (len(pre) - 1 + j)))
        for m in range(st.modules):
            mod = f"stage{n}.{m}"
            for i in range(st.branches):
                c = st.out[i]
                for b in range(st.blocks[i]):
                    p = f"{mod}.branches.{i}.{b}"
                    specs += [ConvSpec(f"{p}.conv1", f"{p}.bn1", c, c, 3, 1, False, hw >> i),
                              ConvSpec(f"{p}.conv2", f"{p}.bn2", c, c, 3, 1, False, hw >> i)]
            if st.branches == 1:
                continue
            for i in range(st.branches):
                for j in range(st.branches):
                    f = f"{mod}.fuse_layers.{i}.{j}"
                    if j > i:
                        specs.append(ConvSpec(f"{f}.0", f"{f}.1", st.out[j], st.out[i], 1, 1,
                                              False, hw >> j))
                    elif j < i:
                        for k in range(i - j):
                            last = k == i - j - 1
                            specs.append(ConvSpec(f"{f}.{k}.0", f"{f}.{k}.1", st.out[j],
                                                  st.out[i] if last else st.out[j], 3, 2,
                                                  False, hw >> (j + k)))
        pre = st.out
    total = sum(pre)
    specs += [ConvSpec("last_layer.0", "last_layer.1", total, total, 1, 1, True, hw),
              ConvSpec("last_layer.3", None, total, joints, fk, 1, True, hw)]
    return specs


def state_shapes(model_cfg: Mapping) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every tensor of the state dict (parameters and BN
    buffers, ``num_batches_tracked`` as a 0-d tensor, ``trainable_temp``)."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    for s in conv_specs(model_cfg):
        shapes[f"{s.conv}.weight"] = (s.cout, s.cin, s.k, s.k)
        if s.bias:
            shapes[f"{s.conv}.bias"] = (s.cout,)
        if s.bn is not None:
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{s.bn}.{leaf}"] = (s.cout,)
            shapes[f"{s.bn}.num_batches_tracked"] = ()
    shapes["trainable_temp"] = ()
    return shapes


# ---------------------------------------------------------------------------
# BN folding and the fake-quantized conv
# ---------------------------------------------------------------------------

def fold(state: Mapping[str, torch.Tensor], model_cfg: Mapping
         ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """conv name -> (weight, bias) of every conv with its eval-mode BN folded
    in, float32: w * g / sqrt(var + eps), beta - mean * g / sqrt(var + eps)
    (+ the conv's own bias times the same factor)."""
    out = {}
    for s in conv_specs(model_cfg):
        w = state[f"{s.conv}.weight"].float()
        b = state[f"{s.conv}.bias"].float() if s.bias else torch.zeros(
            s.cout, dtype=torch.float32, device=w.device)
        if s.bn is not None:
            inv = state[f"{s.bn}.weight"].float() / torch.sqrt(
                state[f"{s.bn}.running_var"].float() + BN_EPS)
            w = w * inv[:, None, None, None]
            b = state[f"{s.bn}.bias"].float() + (b - state[f"{s.bn}.running_mean"].float()) * inv
        out[s.conv] = (w, b)
    return out


def fake_quant(x: torch.Tensor, scale, qmax: int) -> torch.Tensor:
    """Symmetric uniform quantization to the integers [-qmax, qmax] at
    ``scale`` (a number or a tensor broadcast against x), back in float32;
    rounding half to even."""
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


class Quant(NamedTuple):
    """The W{n}A{n} sites of a fake-quantized walk: conv name -> (weight
    quantized per output channel, activation scale per tensor), at ``qmax``
    (127 for int8, 7 for int4)."""

    sites: Dict[str, Tuple[torch.Tensor, float]]
    qmax: int


def make_quant(folded: Mapping[str, Tuple[torch.Tensor, torch.Tensor]],
               amax: Mapping[str, float], sites: Sequence[str], qmax: int) -> Quant:
    """Per-channel symmetric weights (``max|w[c]| / qmax``) and per-tensor
    activation scales (``amax / qmax``) of ``sites`` from a calibration."""
    out = {}
    for name in sites:
        w = folded[name][0]
        ws = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12) / qmax
        out[name] = (fake_quant(w, ws[:, None, None, None], qmax),
                     max(float(amax[name]), 1e-12) / qmax)
    return Quant(out, qmax)


def trunk_sites(model_cfg: Mapping) -> List[str]:
    """The convs the int8 serving configuration runs in W8A8: every conv of
    the trunk but the first (stem2, layer1 and everything of stages 2-4)."""
    return [s.conv for s in conv_specs(model_cfg)
            if s.conv != "conv1" and not s.conv.startswith("last_layer")]


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

def interp_matrix(src: int, dst: int, device) -> torch.Tensor:
    """(dst, src) float32 matrix of the align-corners linear resize."""
    if src == 1:
        return torch.ones((dst, 1), dtype=torch.float32, device=device)
    pos = torch.arange(dst, dtype=torch.float64) * (src - 1) / (dst - 1)
    lo = torch.clamp(torch.floor(pos).long(), max=src - 2)
    frac = pos - lo
    m = torch.zeros((dst, src), dtype=torch.float64)
    m[torch.arange(dst), lo] = 1.0 - frac
    m[torch.arange(dst), lo + 1] += frac
    return m.to(device=device, dtype=torch.float32)


def upsample_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear align-corners resize of NCHW x to (size, size), as two
    separable matrix products."""
    h, w = x.shape[2:]
    if (h, w) == (size, size):
        return x
    mh = interp_matrix(h, size, x.device)
    mw = interp_matrix(w, size, x.device)
    y = torch.einsum("Hh,bchw->bcHw", mh, x)
    return torch.einsum("Ww,bcHw->bcHW", mw, y)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


class Walk:
    """One forward of the network (see the module docstring).

    mode 'eval':  ``folded`` (``fold``) convs; ``quant`` fake-quantizes its
                  sites; ``cast`` (a function of a tensor) is applied to each
                  conv's input and weight; ``amax`` (a dict) records the
                  largest |input| of every conv.
    mode 'train': ``state`` convs (``cast`` as in 'eval', and on each
                  conv's output too with ``cast_outputs``) and train-mode BN
                  over the batch; the running statistics of ``state`` move
                  by ``momentum`` toward the batch's while ``record_stats``
                  is true.
    """

    def __init__(self, model_cfg: Mapping, mode: str,
                 folded: Optional[Mapping[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
                 state: Optional[Dict[str, torch.Tensor]] = None,
                 quant: Optional[Quant] = None, cast: Optional[Callable] = None,
                 amax: Optional[Dict[str, torch.Tensor]] = None,
                 momentum: float = BN_MOMENTUM, cast_outputs: bool = False):
        if mode not in ("eval", "train"):
            raise ValueError(f"unknown mode {mode!r}")
        self.cfg = model_cfg
        self.mode = mode
        self.folded = folded
        self.state = state
        self.quant = quant
        self.cast = cast
        self.amax = amax
        self.record_stats = True
        self.momentum = momentum
        self.cast_outputs = cast_outputs
        self.specs = {s.conv: s for s in conv_specs(model_cfg)}

    # -- one conv (+ BN) (+ ReLU) -----------------------------------------
    def conv(self, name: str, x: torch.Tensor, relu: bool) -> torch.Tensor:
        s = self.specs[name]
        pad = (s.k - 1) // 2
        if self.mode == "train":
            b = self.state[f"{name}.bias"] if s.bias else None
            w = self.state[f"{name}.weight"]
            if self.cast is not None:
                x, w = self.cast(x), self.cast(w)
            y = F.conv2d(x, w, b, s.stride, pad)
            if self.cast is not None and self.cast_outputs:
                y = self.cast(y)
            if s.bn is not None:
                y = self.batch_norm(s.bn, y)
        else:
            if self.amax is not None:
                m = x.detach().abs().amax()
                self.amax[name] = torch.maximum(self.amax[name], m) if name in self.amax else m
            w, b = self.folded[name]
            if self.quant is not None and name in self.quant.sites:
                w, sa = self.quant.sites[name]
                x = fake_quant(x, sa, self.quant.qmax)
            elif self.cast is not None:
                x, w = self.cast(x), self.cast(w)
            y = F.conv2d(x, w, b, s.stride, pad)
        return torch.relu(y) if relu else y

    def batch_norm(self, bn: str, y: torch.Tensor) -> torch.Tensor:
        st = self.state
        out = F.batch_norm(y, None, None, st[f"{bn}.weight"], st[f"{bn}.bias"], True, 0.0,
                           BN_EPS)
        if self.record_stats:
            with torch.no_grad():
                mean = y.mean(dim=(0, 2, 3))
                var = y.var(dim=(0, 2, 3), unbiased=False)
                for leaf, v in (("running_mean", mean), ("running_var", var)):
                    st[f"{bn}.{leaf}"].mul_(1.0 - self.momentum).add_(self.momentum * v)
                st[f"{bn}.num_batches_tracked"].add_(1)
        return out

    # -- the network ------------------------------------------------------
    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv("conv2", self.conv("conv1", x, True), True)

    def layer1(self, x: torch.Tensor) -> torch.Tensor:
        for b in range(4):
            p = f"layer1.{b}"
            y = self.conv(f"{p}.conv1", x, True)
            y = self.conv(f"{p}.conv2", y, True)
            y = self.conv(f"{p}.conv3", y, False)
            if b == 0:
                x = self.conv(f"{p}.downsample.0", x, False)
            x = torch.relu(y + x)
        return x

    def transition(self, n: int, xs: List[torch.Tensor], pre: Sequence[int],
                   st: Stage) -> List[torch.Tensor]:
        t, outs = f"transition{n - 1}", []
        for i in range(st.branches):
            if i < len(pre):
                outs.append(self.conv(f"{t}.{i}.0", xs[i], True) if st.out[i] != pre[i]
                            else xs[i])
            else:
                y = xs[-1]
                for j in range(i + 1 - len(pre)):
                    y = self.conv(f"{t}.{i}.{j}.0", y, True)
                outs.append(y)
        return outs

    def module(self, mod: str, xs: List[torch.Tensor], st: Stage) -> List[torch.Tensor]:
        ys = []
        for i in range(st.branches):
            x = xs[i]
            for b in range(st.blocks[i]):
                p = f"{mod}.branches.{i}.{b}"
                y = self.conv(f"{p}.conv1", x, True)
                y = self.conv(f"{p}.conv2", y, False)
                x = torch.relu(y + x)
            ys.append(x)
        if st.branches == 1:
            return ys
        fused = []
        for i in range(st.branches):
            acc = None
            for j in range(st.branches):
                f = f"{mod}.fuse_layers.{i}.{j}"
                if j == i:
                    c = ys[j]
                elif j > i:
                    c = upsample_nearest(self.conv(f"{f}.0", ys[j], False), 2 ** (j - i))
                else:
                    c = ys[j]
                    for k in range(i - j):
                        c = self.conv(f"{f}.{k}.0", c, k != i - j - 1)
                acc = c if acc is None else acc + c
            fused.append(torch.relu(acc))
        return fused

    def head_logits(self, xs: List[torch.Tensor]) -> torch.Tensor:
        size = xs[0].shape[-1]
        feats = torch.cat([xs[0]] + [upsample_bilinear(t, size) for t in xs[1:]], dim=1)
        return self.conv("last_layer.3", self.conv("last_layer.0", feats, True), False)

    def segments(self) -> List[Tuple[str, Callable]]:
        """The forward as a list of (name, function of the list of branch
        tensors): the unit of recomputation of the train reference."""
        segs: List[Tuple[str, Callable]] = [
            ("stem", lambda xs: [self.stem(xs[0])]),
            ("layer1", lambda xs: [self.layer1(xs[0])])]
        pre = (256,)
        for n, st in enumerate(stages(self.cfg), start=2):
            segs.append((f"transition{n - 1}",
                         lambda xs, n=n, pre=pre, st=st: self.transition(n, xs, pre, st)))
            for m in range(st.modules):
                segs.append((f"stage{n}.{m}",
                             lambda xs, n=n, m=m, st=st: self.module(f"stage{n}.{m}", xs, st)))
            pre = st.out
        segs.append(("head", lambda xs: [self.head_logits(xs)]))
        return segs

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW float32 image -> (B, K, h, w) head logits."""
        xs = [x]
        for _, fn in self.segments():
            xs = fn(xs)
        return xs[0]


def softmax_decode(logits: torch.Tensor, temperature) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K, h, w) logits -> (probabilities (B, K, h, w), coords (B, K, 2) [u, v]):
    the softmax over each map of logits * temperature and its expected
    pixel coordinates."""
    b, k, h, w = logits.shape
    p = torch.softmax((logits * temperature).reshape(b, k, h * w), dim=-1).reshape(b, k, h, w)
    us = torch.arange(w, dtype=p.dtype, device=p.device)
    vs = torch.arange(h, dtype=p.dtype, device=p.device)
    u = (p.sum(dim=2) * us).sum(dim=-1)
    v = (p.sum(dim=3) * vs).sum(dim=-1)
    return p, torch.stack([u, v], dim=-1)


def nchw(images_nhwc: torch.Tensor) -> torch.Tensor:
    return images_nhwc.permute(0, 3, 1, 2).float().contiguous()
