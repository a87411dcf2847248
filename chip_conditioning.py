#!/usr/bin/env python3
"""How far rounding moves the decoded joints of a random full-depth HRNet.

On one card, for the model of ``chip_smoke.py`` (pose_hrnet_w32, softmax
head, 256x256) made by ``init_variables`` with and without ``damp``, at
batch 32 and seeds 0-2, prints the max and mean |d| px of the decoded
joints between:

- ``kernel``: the serving path (both kernels) and the plain-twin path, the
  comparison ``chip_smoke.py`` gates;
- ``witness``: the same forward with cuDNN's bf16 layer1, and the plain
  path: rounding alone;
- ``padding_fault``: a layer1 that zero-pads the 3x3's input side (so the
  intermediate's border holds relu(b1), not 0), and the plain path: what a
  kernel with that known fault would show;
- ``f32_after_layer1``: the kernel's and the twin's bf16 layer1 (and the
  fault's), each followed by the float32 model: a layer1 change with no
  bf16 rounding after it;
- ``vs_f32``: the serving path and the float32 model.

    python3 chip_conditioning.py

One JSON line per (damp, seed), then the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import make_fast_infer, precast_variables
from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.ops.decode import soft_argmax
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import _build
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import (
    _split, fused_bottleneck_chain, layer1_reference)
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import init_variables


def padding_fault(x, params_flat, flags):
    """``layer1_reference`` with the 3x3's zero padding moved to the input
    of the first 1x1, so the border of the intermediate is relu(b1)."""
    y = x
    for p in _split(params_flat, flags):
        xf = y.float()
        h1 = torch.relu(F.pad(xf, (0, 0, 1, 1, 1, 1)) @ p["w1"].float() + p["b1"])
        h2 = F.conv2d(h1.to(torch.bfloat16).float().permute(0, 3, 1, 2),
                      p["w2"].float().permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
        h2 = torch.relu(h2 + p["b2"]).to(torch.bfloat16)
        sc = xf @ p["ws"].float() + p["bs"] if "ws" in p else xf
        y = torch.relu(h2.float() @ p["w3"].float() + p["b3"] + sc).to(torch.bfloat16)
    return y


def gap(a, b):
    d = (a - b).abs()
    return {"max": round(d.max().item(), 4), "mean": round(d.mean().item(), 4)}


@torch.inference_mode()
def measure(cfg, state, images, dev):
    weights = precast_variables(cfg, state, device=dev)
    got = make_fast_infer(cfg, device=dev)(weights, images)
    plain = cs.twin_forward(weights, images, layer1=cs.nchw(layer1_reference, weights))
    model = hrnet_from_cfg(cfg).to(dev)
    model.load_state_dict(state)

    def f32_after(layer1_nhwc):
        def layer1(t):
            y = layer1_nhwc(t.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous(), *weights.layer1)
            return y.permute(0, 3, 1, 2).float()
        return soft_argmax(model(images, layer1=layer1).heatmaps)

    f32_twin = f32_after(layer1_reference)
    return {
        "spread": round(got.std(dim=(0, 1)).min().item(), 4),
        "kernel": gap(got, plain),
        "witness": gap(cs.twin_forward(weights, images, layer1=weights.model.layer1), plain),
        "padding_fault": gap(cs.twin_forward(weights, images, layer1=cs.nchw(padding_fault, weights)),
                             plain),
        "f32_after_layer1": {"kernel": gap(f32_after(fused_bottleneck_chain), f32_twin),
                             "padding_fault": gap(f32_after(padding_fault), f32_twin)},
        "vs_f32": gap(got, soft_argmax(model(images).heatmaps)),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_conditioning: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    cfg = cs.flagship_cfg()
    images = torch.from_numpy(np.random.default_rng(0).normal(
        size=(cs.CHECK_BATCH, 256, 256, 3)).astype(np.float32)).to(dev)
    for damp in (True, False):
        for seed in (0, 1, 2):
            state = init_variables(cfg, seed=seed, device=dev, damp=damp)
            print(json.dumps({"damp": damp, "seed": seed, **measure(cfg, state, images, dev)}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
