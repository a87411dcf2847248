#!/usr/bin/env python3
"""Times one checkout of the PyTorch port on one NVIDIA card, for comparing
two commits on the same card in one call.

    python3 chip_ab.py <root> <label>             # the three serving steps and eight kernels
    python3 chip_ab.py <root> <label> --profile   # per-kernel device time of the int8 step

``<root>`` is a directory holding ``hrnet_hand_pose_estimation_tpu_torch``
(this checkout, or a parent commit unpacked with ``git archive``); its
kernels build into ``<root>/build/kernels``.  Run the two roots in turns in
one call (parent, change, change, parent): two calls may land on two cards.

On pose_hrnet_w32 softmax at 256x256, random weights from seed 0, B=128,
CUDA events after warm-up, it prints one line
``AB {"label", "step_default", "step_new", "step_int8", "head", "layer1",
"stem_layer1", "layer1_int8", "branch_int8", "head_v1", "decode_b32",
"decode_b128", "targets_b32", "targets_b128", "targets_device_b32",
"targets_device_b128"}`` in ms: the default bf16 step, the bf16 step with
``pallas_branches=True, fuse_stem_layer1=True``, the int8 step on uint8
images, and ``fused_head_decode_v2``, ``fused_bottleneck_chain``,
``fused_stem_layer1`` and ``fused_bottleneck_chain_int8`` alone on the
serving paths' inputs, ``fused_basic_chain_int8`` summed over the int8
path's 26 branch inputs (params from ``prepare_branch_int8``),
``fused_head_decode`` (v1) on the default bf16 path's branch tensors, and
the device time per call (``torch.profiler``, 20 calls) of
``fused_softmax_decode`` on bf16 64x64x21 logits at B=32 and B=128, and
``fused_gaussian_targets`` (64x64x21, sigma 2, seeded joints) per call
(CUDA events, 50 calls) and in device time at B=32 and B=128.  With
``--profile`` it prints ``AB2 <label> total <ms>`` and the 14 largest
per-kernel device times of one int8 step (``torch.profiler``, 3 steps).
Exits non-zero without a card.
"""

import json
import sys

from chip_timing import device_busy  # this checkout's, before <root> goes first on sys.path

if len(sys.argv) < 3:
    sys.exit(__doc__)
root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_ab: torch.cuda.is_available() is false; this needs an NVIDIA card")

import hrnet_hand_pose_estimation_tpu_torch as P  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.config import (  # noqa: E402
    POSE_HIGH_RESOLUTION_NET_EXTRA, load_config)
from hrnet_hand_pose_estimation_tpu_torch.core import quant_infer as Q  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import (  # noqa: E402
    make_fast_infer, precast_variables)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import (  # noqa: E402
    fused_bottleneck_chain, fused_stem_layer1)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_head_decode import (  # noqa: E402
    fused_head_decode, fused_head_decode_v2)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.int8_chain import (  # noqa: E402
    fused_basic_chain_int8, fused_bottleneck_chain_int8)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.gaussian_targets import (  # noqa: E402
    fused_gaussian_targets)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.softmax_decode import (  # noqa: E402
    fused_softmax_decode)
from hrnet_hand_pose_estimation_tpu_torch.ops.s2d import space_to_depth  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import init_variables  # noqa: E402

if not P.__file__.startswith(root):
    sys.exit(f"chip_ab: imported the port from {P.__file__}, not from {root}")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")


def time_ms(fn, iters=10, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


cfg = load_config(opts=["MODEL.NAME", "pose_hrnet_softmax", "MODEL.TRAINABLE_SOFTMAX", True,
                        "MODEL.HEATMAP_SOFTMAX", True], freeze=False)
cfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
cfg = cfg.freeze()
state = init_variables(cfg, seed=0, device=dev)
weights = precast_variables(cfg, state, device=dev)
big = torch.from_numpy(np.random.default_rng(1).normal(
    size=(128, 256, 256, 3)).astype(np.float32)).to(dev)
u8 = torch.from_numpy(np.random.default_rng(2).integers(
    0, 256, size=(128, 256, 256, 3)).astype(np.uint8)).to(dev)
norm = (Q.IMAGENET_MEAN, Q.IMAGENET_STD)
mean = torch.tensor(norm[0], device=dev) * 255.0
inv_std = 1.0 / (torch.tensor(norm[1], device=dev) * 255.0)
amax = Q.calibrate(cfg, weights, [(u8[:32].float() - mean) * inv_std])
qparams = Q.prepare_serving_qparams(cfg, {k: v.to(dev) for k, v in state.items()}, amax)
quant = Q.make_quant_infer(cfg, device=dev, input_norm=norm)

if "--profile" in sys.argv:
    for _ in range(2):
        quant(weights, qparams, u8)
    _, total, kernels = device_busy(lambda: quant(weights, qparams, u8), 3)
    per = {}
    for key, ms in kernels:
        per[key[:60]] = per.get(key[:60], 0.0) + ms
    top = sorted(per.items(), key=lambda kv: -kv[1])[:14]
    print(f"AB2 {label} total {total:.3f} "
          + json.dumps([(k, round(v, 3)) for k, v in top]), flush=True)
    sys.exit(0)


def recorded(owner, name, call):
    """Run ``call`` with ``owner.name`` wrapped to record its positional
    arguments: the list of every call's arguments."""
    real, seen = getattr(owner, name), []

    def rec(*args):
        seen.append(args)
        return real(*args)

    setattr(owner, name, rec)
    try:
        call()
    finally:
        setattr(owner, name, real)
    return seen


def int8_kernel_inputs():
    """The int8 path's layer1 chain input and its 26 branch chains, each
    with the B6 params prepared from the same calibration record."""
    from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.int8_chain import prepare_branch_int8

    step = lambda: quant(weights, qparams, u8)
    (x0, chain, flags), = recorded(Q, "fused_bottleneck_chain_int8", step)
    dstate = {k: v.to(dev) for k, v in state.items()}
    branches = [(Q._nhwc(x), prepare_branch_int8(dstate, amax, mod, i, n), n)
                for _, x, mod, i, n in recorded(Q._Walk, "branch", step)]
    return (x0, chain, flags), branches


fast = make_fast_infer(cfg, device=dev)
new = make_fast_infer(cfg, device=dev, pallas_branches=True, fuse_stem_layer1=True)
with torch.inference_mode():
    xin = big.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    xs = [t.permute(0, 2, 3, 1).contiguous() for t in weights.model.forward_backbone(xin)]
    m = weights.model
    x1 = torch.relu(m.conv2(torch.relu(m.conv1(xin)))).permute(0, 2, 3, 1).contiguous()
    x_s2d = space_to_depth(big.to(torch.bfloat16))
    l1_int8, branches = int8_kernel_inputs()
    temp = torch.tensor(1.7, device=dev)
    logits = {b: (torch.randn(b, 64, 64, 21, device=dev) * 3).to(torch.bfloat16) for b in (32, 128)}
    joints = {b: torch.from_numpy(np.random.default_rng(b).uniform(
        2, 62, size=(b, 21, 2)).astype(np.float32)).to(dev) for b in (32, 128)}
    vis = {b: torch.ones(b, 21, device=dev) for b in (32, 128)}
    out = dict(label=label,
               step_default=time_ms(lambda: fast(weights, big)),
               step_new=time_ms(lambda: new(weights, big)),
               step_int8=time_ms(lambda: quant(weights, qparams, u8)),
               head=time_ms(lambda: fused_head_decode_v2(xs, weights.head)),
               layer1=time_ms(lambda: fused_bottleneck_chain(x1, *weights.layer1)),
               stem_layer1=time_ms(lambda: fused_stem_layer1(x_s2d, weights.stem_flat,
                                                             *weights.layer1)),
               layer1_int8=time_ms(lambda: fused_bottleneck_chain_int8(*l1_int8)),
               branch_int8=sum(time_ms(lambda: fused_basic_chain_int8(*c), iters=5)
                               for c in branches),
               head_v1=time_ms(lambda: fused_head_decode(xs, weights.head)),
               **{f"decode_b{b}": device_busy(lambda: fused_softmax_decode(x, temp), 20)[1] or None
                  for b, x in logits.items()},
               **{f"targets_b{b}": time_ms(lambda: fused_gaussian_targets(j, vis[b], 64, 2.0),
                                           iters=50, warmup=5)
                  for b, j in joints.items()},
               **{f"targets_device_b{b}": device_busy(
                   lambda: fused_gaussian_targets(j, vis[b], 64, 2.0), 20)[1] or None
                  for b, j in joints.items()})
print("AB " + json.dumps(out), flush=True)
