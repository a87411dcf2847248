"""Seeded, conditioned weights of the reference HRNet, made on the device.

A random full-depth HRNet is chaotic in bfloat16: a one-ulp change early on
moves the decoded joints by pixels.  So the BNs that close a residual
branch of stages 2-4 (each BasicBlock's ``bn2``) or feed another resolution
(every fuse layer's BN) get scales in [0.03, 0.1]; every other BN scale is
in [0.5, 1.5] and every BN shift a normal of std 0.1.  Convs are He-scaled
normals (std sqrt(2 / fan_in)), conv biases normals of std 0.1, the softmax
temperature 1.  The running statistics are then the batch statistics of
one train-mode forward of the reference over two random normal images, so
each layer sees normalized activations, as in a trained net, and the
statistics sit away from 0 and 1.

All of it comes from one ``torch.Generator`` on ``device`` in a few large
calls, in float32, so the same seed gives the same state on the same card.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

from .model import Walk, conv_specs, state_shapes

DAMPED_BN = re.compile(r"branches\.\d+\.\d+\.bn2$|fuse_layers\.")


def tf32_off():
    """A context that turns TF32 off for matmuls and cuDNN convs, and puts
    the settings back on exit."""
    class _Ctx:
        def __enter__(self):
            self.saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        def __exit__(self, *exc):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
            return False
    return _Ctx()


@torch.no_grad()
def make_state(model_cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict (float32, ``num_batches_tracked`` int64) for a
    configuration's MODEL mapping, from ``seed``, on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    shapes = state_shapes(model_cfg)
    specs = conv_specs(model_cfg)
    state: Dict[str, torch.Tensor] = {}

    def numel(shape):
        n = 1
        for d in shape:
            n *= d
        return n

    # conv weights: one normal draw, He-scaled per conv
    weights = [f"{s.conv}.weight" for s in specs]
    flat = torch.empty(sum(numel(shapes[n]) for n in weights), device=device).normal_(
        generator=gen)
    off = 0
    for name, s in zip(weights, specs):
        n = numel(shapes[name])
        state[name] = flat[off:off + n].view(shapes[name]) * (2.0 / (s.cin * s.k * s.k)) ** 0.5
        off += n
    # conv biases and BN shifts: one normal draw, std 0.1
    shifts = [f"{s.conv}.bias" for s in specs if s.bias] + [f"{s.bn}.bias" for s in specs
                                                              if s.bn is not None]
    flat = torch.empty(sum(numel(shapes[n]) for n in shifts), device=device).normal_(
        generator=gen)
    off = 0
    for name in shifts:
        n = numel(shapes[name])
        state[name] = flat[off:off + n].view(shapes[name]) * 0.1
        off += n
    # BN scales: one uniform draw, mapped to each BN's range
    bns = [s.bn for s in specs if s.bn is not None]
    flat = torch.rand(sum(numel(shapes[f"{b}.weight"]) for b in bns), device=device,
                      generator=gen)
    off = 0
    for bn in bns:
        n = numel(shapes[f"{bn}.weight"])
        lo, hi = (0.03, 0.1) if DAMPED_BN.search(bn) else (0.5, 1.5)
        state[f"{bn}.weight"] = lo + (hi - lo) * flat[off:off + n]
        state[f"{bn}.running_mean"] = torch.zeros(n, device=device)
        state[f"{bn}.running_var"] = torch.ones(n, device=device)
        state[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
        off += n
    state["trainable_temp"] = torch.ones((), device=device)
    state = {k: v.contiguous() for k, v in state.items()}
    if set(state) != set(shapes):
        raise RuntimeError("weight maker and state layout disagree: "
                           f"{sorted(set(state) ^ set(shapes))[:5]}")

    # running statistics := the batch statistics of one forward of two images
    size = int(model_cfg["IMAGE_SIZE"][0])
    images = torch.empty((2, 3, size, size), device=device).normal_(generator=gen)
    walk = Walk(model_cfg, "train", state=state, momentum=1.0)
    with tf32_off():
        walk.logits(images)
    for bn in bns:
        state[f"{bn}.num_batches_tracked"].zero_()
    return state
