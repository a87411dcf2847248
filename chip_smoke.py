#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

Drives the port's serving paths for pose_hrnet_w32 with the softmax head
at 256x256 (random weights from a numpy seed): the bf16 path
(``core/fast_infer.make_fast_infer``) with its defaults and with
``pallas_branches=True, fuse_stem_layer1=True`` (and once with
``s2d_stem=True``), and the shipped int8 W8A8 path (``core/quant_infer``:
calibrate, ``prepare_serving_qparams``, ``make_quant_infer`` on raw uint8
images).  It builds the hand-written CUDA kernels with nvcc, holds each
kernel against its plain PyTorch twin at the inputs its path gives it,
checks at batch 32 that each path went through its kernels and agrees with
the same forward through the twins, and times the paths at batch 128.

Then the 2D training path (``parallel/train_step``, ``core/trainer``) with
the training settings of
experiments/FreiHand/Frei_HRNet_w32_trainable_softmax_hm-pose2dloss_v1.yaml:
the Gaussian-targets kernel against its twin, 10 bf16 steps at B=32 on one
batch whose targets the kernel makes on the card (the loss must fall), a
NaN-pixel step the anomaly guard must skip bit for bit, one float32 step on
the card against the same step on the CPU, the step's time and breakdown,
and one ``Trainer.fit`` epoch with a resume.

Then the 2D evaluation path (``core/evaluator.Evaluator2D``) of the same
flagship model on the synthetic test set at 256/64, B=32: the softmax-decode
kernel against its twin, the standard evaluation (one decode launch per
batch) against the same evaluation decoded by the twin, the int8 serving
evaluation, the evaluation tool's artifacts, and the inference tool's
three serving functions.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them.  Prints one line
per phase with its wall seconds, a ``{"kernels": [...]}`` line, the card's
name and power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from hrnet_hand_pose_estimation_tpu_torch.config import (POSE_HIGH_RESOLUTION_NET_EXTRA,
                                                         load_config)
from hrnet_hand_pose_estimation_tpu_torch.core import evaluator as EV
from hrnet_hand_pose_estimation_tpu_torch.core import fast_infer as FI
from hrnet_hand_pose_estimation_tpu_torch.core import quant_infer as Q
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import (make_fast_infer,
                                                                  precast_variables)
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer
from hrnet_hand_pose_estimation_tpu_torch.data.build import make_test_dataloader
from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import DataLoader
from hrnet_hand_pose_estimation_tpu_torch.data.synthetic import SyntheticDataset
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.ops.decode import soft_argmax
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import _build
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.conv_int8 import (SiteQ, conv_int8,
                                                                        conv_int8_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import (
    basic_chain_reference, fused_basic_chain, fused_bottleneck_chain, fused_stem_layer1,
    layer1_reference, stem_layer1_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_head_decode import (
    fused_head_decode_v2, head_decode_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.gaussian_targets import (
    fused_gaussian_targets, gaussian_targets_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.int8_chain import (
    bottleneck_chain_int8_reference, fused_bottleneck_chain_int8)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.softmax_decode import (
    fused_softmax_decode, softmax_decode_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.s2d import space_to_depth
from hrnet_hand_pose_estimation_tpu_torch.ops.targets import gaussian_targets
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.tools import evaluate_2d as tool_eval
from hrnet_hand_pose_estimation_tpu_torch.tools.inference import make_serving_fn
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import init_variables

CHECK_BATCH = 32
TIME_BATCH = 128            # bench.py's batch
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12
NORM = (Q.IMAGENET_MEAN, Q.IMAGENET_STD)

T0 = time.perf_counter()


@contextmanager
def phase(name: str):
    t = time.perf_counter()
    yield
    print(f"[{name}] {time.perf_counter() - t:.2f} s (elapsed {time.perf_counter() - T0:.2f} s)",
          flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call on the card, by CUDA events after warm-up."""
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


def device_busy(fn, steps: int = 3) -> tuple[float, float, list]:
    """(wall ms/step, kernel ms/step, [(kernel, ms/step), ...] largest first)
    from torch.profiler over ``steps`` calls after a synchronize: the device
    time of every CUDA kernel, summed (one stream: kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / steps
    per = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                 # CPU ops: their kernels are listed themselves
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = e.self_cuda_time_total
        per[e.key] = per.get(e.key, 0.0) + dt / 1e3 / steps
    top = sorted(per.items(), key=lambda kv: -kv[1])
    return wall, sum(per.values()), top


def bound(flops_bf16: float, flops_f32: float, nbytes: float,
          ops_int8: float = 0.0) -> tuple[float, str]:
    """Least time (ms) for the work: the larger of bytes over the memory rate
    and operations over the peak rate of their type."""
    t_ops = flops_bf16 / PEAK_BF16 + flops_f32 / PEAK_F32 + ops_int8 / PEAK_INT8
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def layer1_flops(x, params, flags):
    b, h, w, _ = x.shape
    flops, i = 0, 0
    for has_sc in flags:
        w1, w2, w3 = params[i], params[i + 2], params[i + 4]
        cin, cm = w1.shape
        cout = w3.shape[1]
        flops += 2 * b * h * w * (cin * cm + 9 * cm * cm + cm * cout + (cin * cout if has_sc else 0))
        i += 8 if has_sc else 6
    return flops


def layer1_work(x, params, flags, out):
    return bound(layer1_flops(x, params, flags), 0, nbytes([x, out, *params]))


def head_work(xs, head, out):
    b, h0, w0, _ = xs[0].shape
    n, k = head.w_final.shape
    hw = h0 * w0
    mm = 2 * b * (sum(x.shape[1] * x.shape[2] * x.shape[3] for x in xs) * n + hw * n * k)
    # the 2x2-tap upsample as 6 FMAs per branch and output, counted at the
    # tensor-core rate (the TPU kernel runs its W-mix as a matmul)
    interp = 2 * b * hw * n * 6 * (len(xs) - 1)
    softmax = 6 * b * k * hw                          # max, exp, 3 sums, subtract
    weights = [head.w_head.to(torch.bfloat16), head.b_head, head.w_final.to(torch.bfloat16),
               head.b_final]
    return bound(mm + interp, softmax, nbytes([*xs, out, *weights]))


def flagship_cfg():
    """pose_hrnet_w32 with the softmax head at 256x256 (config/defaults.py
    POSE_HIGH_RESOLUTION_NET_EXTRA)."""
    cfg = load_config(opts=["MODEL.NAME", "pose_hrnet_softmax",
                            "MODEL.TRAINABLE_SOFTMAX", True,
                            "MODEL.HEATMAP_SOFTMAX", True], freeze=False)
    cfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
    return cfg.freeze()


def to_input(images):
    """NHWC float images -> NCHW channels_last bf16, as the serving path casts them."""
    return images.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def stem(model, x):
    """The served model's stem (BN folded: bn1/bn2 are identities)."""
    return torch.relu(model.conv2(torch.relu(model.conv1(x))))


def kernel_inputs(weights, images):
    """The layer1 input (B, 64, 64, 64) and the four head branches, NHWC
    bf16, as the serving path makes them (backbone through cuDNN convs)."""
    x = to_input(images)
    xs = weights.model.forward_backbone(x)
    return (stem(weights.model, x).permute(0, 2, 3, 1).contiguous(),
            [t.permute(0, 2, 3, 1).contiguous() for t in xs])


def nchw(layer1_nhwc, weights):
    """An NHWC layer1 function of the chain params, as forward_backbone calls it."""
    return lambda t: layer1_nhwc(t.permute(0, 2, 3, 1).contiguous(),
                                 *weights.layer1).permute(0, 3, 1, 2)


def twin_forward(weights, images, **parts):
    """The serving forward with ``parts`` (forward_backbone's NCHW hooks:
    ``layer1``, ``stem``, ``branch``) and the head kernel's plain twin."""
    with torch.inference_mode():
        xs = weights.model.forward_backbone(to_input(images), **parts)
        return head_decode_reference([t.permute(0, 2, 3, 1).contiguous() for t in xs],
                                     weights.head)


# -- make_fast_infer(pallas_branches=True, fuse_stem_layer1=True) ------------

NEW_CONFIG = dict(pallas_branches=True, fuse_stem_layer1=True)


def new_parts(weights, twin: bool):
    """forward_backbone's hooks in NEW_CONFIG, as make_fast_infer builds them,
    through the kernels or through their plain twins."""
    stem_fn = stem_layer1_reference if twin else fused_stem_layer1
    chain_fn = basic_chain_reference if twin else fused_basic_chain
    nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()

    def stem(t):
        return stem_fn(space_to_depth(nhwc(t)), weights.stem_flat, *weights.layer1).permute(0, 3, 1, 2)

    def branch(name, t):
        params = weights.branches[name]
        return chain_fn(nhwc(t), params, len(params) // 4).permute(0, 3, 1, 2)

    return dict(stem=stem, layer1=torch.nn.Identity(), branch=branch)


def record_branches(infer, weights, images):
    """One forward of ``infer`` with every fused_basic_chain call recorded by
    shape class: {(H, W, C): [count, x NHWC, params, ResLayer name]}."""
    classes, real = {}, FI.fused_basic_chain
    names = {id(p): n for n, p in weights.branches.items()}

    def rec(x, params, n_blocks):
        key = tuple(x.shape[1:])
        if key in classes:
            classes[key][0] += 1
        else:
            classes[key] = [1, x, params, names[id(params)]]
        return real(x, params, n_blocks)

    FI.fused_basic_chain = rec
    try:
        infer(weights, images)
    finally:
        FI.fused_basic_chain = real
    return classes


def basic_chain_work(x, params):
    """Bound of a BasicBlock chain: two 3x3 convs per block; x, the output
    and the weights once."""
    b, h, w, c = x.shape
    flops = (len(params) // 4) * 2 * 2 * b * h * w * 9 * c * c
    return bound(flops, 0, 2 * nbytes([x]) + nbytes(params))


def stem_layer1_work(x_s2d, stem_flat, params, flags):
    """Bound of the s2d stem1 (K = 48), stem2 (K = 576) and layer1; x_s2d,
    the output and the weights once."""
    b, hs, ws, _ = x_s2d.shape
    y2 = torch.empty((b, hs // 2, ws // 2, 64), dtype=torch.bfloat16, device="meta")
    out = torch.empty((b, hs // 2, ws // 2, 256), dtype=torch.bfloat16, device="meta")
    flops = 2 * b * hs * ws * 48 * 64 + 2 * b * (hs // 2) * (ws // 2) * 576 * 64
    return bound(flops + layer1_flops(y2, params, flags), 0,
                 nbytes([x_s2d, out, *stem_flat, *params]))


def new_config_phases(cfg, weights, smi, kernels, images, default_plain):
    """make_fast_infer(**NEW_CONFIG): the branch-chain and stem + layer1
    kernels against their twins at the path's B=32 inputs, the path's
    launches and its decode gate at B=32, the s2d_stem path once, and the
    B=128 step with its breakdown.  Appends two entries to ``kernels``."""
    dev = images.device
    infer = make_fast_infer(cfg, device=dev, **NEW_CONFIG)
    model = weights.model
    params, flags = weights.layer1
    with phase("new-config kernel checks"), torch.inference_mode():
        classes = record_branches(infer, weights, images)
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
        t_ops = t_bytes = worst = 0.0
        for (h, w, c), (count, x, p, name) in sorted(classes.items(), reverse=True):
            got = fused_basic_chain(x, p, len(p) // 4)
            want = basic_chain_reference(x, p, len(p) // 4)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            limit = 0.02 * max(1.0, want.float().abs().max().item())
            if not err <= limit:
                raise AssertionError(f"fused_basic_chain {h}x{w}x{c}: |kernel - plain| "
                                     f"{err} > {limit}")
            worst = max(worst, err)
            layer = model.get_submodule(name)
            x_nchw = x.permute(0, 3, 1, 2)
            ms = time_ms(lambda: fused_basic_chain(x, p, len(p) // 4), 10)
            plain = time_ms(lambda: basic_chain_reference(x, p, len(p) // 4), 2, warmup=1)
            lib = time_ms(lambda: layer(x_nchw), 10)
            b_ms, b_by = basic_chain_work(x, p)
            t_ops, t_bytes = (t_ops + count * b_ms, t_bytes) if b_by == "operations" else (
                t_ops, t_bytes + count * b_ms)
            for key, val in (("ms", ms), ("plain_ms", plain), ("bound_ms", b_ms),
                             ("library_ms", lib)):
                tot[key] += count * val
            print(f"fused_basic_chain {h}x{w}x{c}, {len(p) // 4} blocks, x{count} chains: "
                  f"max|kernel - plain| {err:.4g} (limit {limit:.4g}); {ms:.4f} ms, plain "
                  f"{plain:.3f} ms, cuDNN bf16 ResLayer {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        chain_entry = dict(
            name="fused_basic_chain", route="cuda",
            source="hrnet_hand_pose_estimation_tpu_torch/csrc/basic_chain.cu",
            replaces="hrnet_hand_pose_estimation_tpu/ops/pallas/fused_bottleneck.py:319",
            max_abs_err=worst, bound_by="operations" if t_ops >= t_bytes else "bytes",
            shape_classes=len(classes), **tot)

        x_s2d = space_to_depth(images.to(torch.bfloat16))
        got = fused_stem_layer1(x_s2d, weights.stem_flat, params, flags)
        want = stem_layer1_reference(x_s2d, weights.stem_flat, params, flags)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        limit = 0.02 * max(1.0, want.float().abs().max().item())
        print(f"stem + layer1: max|kernel - plain| = {err:.5f} (limit {limit:.5f})")
        if not err <= limit:
            raise AssertionError(f"fused_stem_layer1 disagrees with its plain twin: {err} > {limit}")
        xin = to_input(images)
        b_ms, b_by = stem_layer1_work(x_s2d, weights.stem_flat, params, flags)
        stem_entry = dict(
            name="fused_stem_layer1", route="cuda",
            source="hrnet_hand_pose_estimation_tpu_torch/csrc/stem_layer1.cu",
            layer1_source="hrnet_hand_pose_estimation_tpu_torch/csrc/fused_bottleneck.cu",
            replaces="hrnet_hand_pose_estimation_tpu/ops/pallas/fused_bottleneck.py:235",
            max_abs_err=err,
            ms=time_ms(lambda: fused_stem_layer1(x_s2d, weights.stem_flat, params, flags), 10),
            plain_ms=time_ms(lambda: stem_layer1_reference(x_s2d, weights.stem_flat, params,
                                                           flags), 2, warmup=1),
            bound_ms=b_ms, bound_by=b_by,
            # yardstick: cuDNN's bf16 stem and layer1 (the folded served model's)
            library_ms=time_ms(lambda: model.layer1(stem(model, xin)), 10))
        for kern in (chain_entry, stem_entry):
            print(f"{kern['name']} at B={CHECK_BATCH}: {kern['ms']:.3f} ms, plain "
                  f"{kern['plain_ms']:.3f} ms, library {kern['library_ms']:.3f} ms, bound "
                  f"{kern['bound_ms']:.4f} ms ({kern['bound_by']}) on {smi}")

    with phase("new-config main path"):
        zero_counters()
        coords = infer(weights, images)
        torch.cuda.synchronize()
        launches = counters()
        print(f"make_fast_infer({NEW_CONFIG}): CUDA launches on the main path: {launches}")
        # one launch per BasicBlock of every stage 2-4 branch (104 for w32)
        n_blocks = sum(int(cfg.MODEL.EXTRA[f"STAGE{n}"]["NUM_MODULES"])
                       * sum(int(b) for b in cfg.MODEL.EXTRA[f"STAGE{n}"]["NUM_BLOCKS"])
                       for n in (2, 3, 4))
        want = {"conv_int8": 0, "fused_bottleneck_chain_int8": 0, "fused_head_decode_v2": 3,
                "fused_bottleneck_chain": 0, "fused_basic_chain": n_blocks,
                "fused_stem_layer1": 1 + len(flags), "fused_gaussian_targets": 0,
                "fused_softmax_decode": 0}
        if launches != want:
            raise AssertionError(f"launches {launches}, want {want}")
        chain_entry["launches"] = launches["fused_basic_chain"]
        stem_entry["launches"] = launches["fused_stem_layer1"]
        if coords.shape != (CHECK_BATCH, 21, 2) or not torch.isfinite(coords).all():
            raise AssertionError(f"bad output: shape {tuple(coords.shape)}")
        # the twin path runs the same forward through the four kernels'
        # twins; the witness is the default configuration's twin forward
        # (cuDNN stem and branch chains): how far a legitimate change of
        # rounding moves the decode
        plain = twin_forward(weights, images, **new_parts(weights, twin=True))
        diff = (coords - plain).abs()
        witness = (default_plain - plain).abs()
        limit = max(0.25, witness.max().item())
        spread = coords.std(dim=(0, 1)).min().item()
        print(f"new configuration vs its plain-twin path: max |d| = {diff.max().item():.4f} px "
              f"(limit {limit:.4f}), mean {diff.mean().item():.5f} px (limit: witness mean "
              f"{witness.mean().item():.4f}); witness (default configuration's twins) vs plain: "
              f"max {witness.max().item():.4f} px; spread {spread:.3f} px (> 1)")
        if not diff.max().item() <= limit:
            raise AssertionError("new configuration disagrees with its plain path")
        if not diff.mean().item() <= witness.mean().item():
            raise AssertionError(f"new configuration farther from its plain path than the "
                                 f"witness: {diff.mean()} > {witness.mean()}")
        if not spread > 1.0:
            raise AssertionError(f"coordinates barely spread ({spread} px)")
        s2d = make_fast_infer(cfg, device=dev, s2d_stem=True)(weights, images)
        torch.cuda.synchronize()
        if s2d.shape != (CHECK_BATCH, 21, 2) or not torch.isfinite(s2d).all():
            raise AssertionError(f"s2d_stem path: bad output, shape {tuple(s2d.shape)}")
        print(f"s2d_stem path: shape {tuple(s2d.shape)}, finite; vs the default path max "
              f"|d| {(s2d - default_plain).abs().max().item():.4f} px (information)")

    with phase("new-config timing"), torch.inference_mode():
        big = torch.from_numpy(np.random.default_rng(1).normal(
            size=(TIME_BATCH, 256, 256, 3)).astype(np.float32)).to(dev)
        step_ms = time_ms(lambda: infer(weights, big), 10, warmup=3)
        print(f"make_fast_infer({NEW_CONFIG}) B={TIME_BATCH}: {step_ms:.3f} ms/step, "
              f"{TIME_BATCH / step_ms * 1e3:.1f} images/s on {smi}")
        classes = record_branches(infer, weights, big)
        parts = new_parts(weights, twin=False)
        xin = to_input(big)
        x_s2d = space_to_depth(big.to(torch.bfloat16))
        stem_ms = time_ms(lambda: parts["stem"](xin), 10)
        branches_ms = sum(count * time_ms(lambda: parts["branch"](name, x.permute(0, 3, 1, 2)), 5)
                          for count, x, _, name in classes.values())
        backbone_ms = time_ms(lambda: model.forward_backbone(xin, **parts), 5)
        xs = [t.permute(0, 2, 3, 1).contiguous() for t in model.forward_backbone(xin, **parts)]
        head_ms = time_ms(lambda: fused_head_decode_v2(xs, weights.head), 10)
        split = {"input cast": time_ms(lambda: to_input(big), 10),
                 "stem + layer1 kernel as served (s2d, 5 launches)": stem_ms,
                 f"branch chains (fused_basic_chain, {chain_entry['launches']} launches, "
                 "summed)": branches_ms,
                 "rest of stages 2-4 (cuDNN transitions and fuse convs, adds)":
                     backbone_ms - stem_ms - branches_ms,
                 "head as served": head_ms}
        print(f"new-config step breakdown B={TIME_BATCH} (ms, CUDA events, parts timed alone): "
              + json.dumps({k: round(v, 3) for k, v in split.items()})
              + f"; sum {sum(split.values()):.3f}")
        chain_entry["ms_b128"] = sum(count * time_ms(lambda: fused_basic_chain(x, p, len(p) // 4), 5)
                                     for count, x, p, _ in classes.values())
        chain_entry["bound_ms_b128"] = sum(count * basic_chain_work(x, p)[0]
                                           for count, x, p, _ in classes.values())
        chain_entry["library_ms_b128"] = sum(
            count * time_ms(lambda: model.get_submodule(name)(x.permute(0, 3, 1, 2)), 5)
            for count, x, _, name in classes.values())
        stem_entry["ms_b128"] = time_ms(
            lambda: fused_stem_layer1(x_s2d, weights.stem_flat, params, flags), 10)
        stem_entry["bound_ms_b128"] = stem_layer1_work(x_s2d, weights.stem_flat, params, flags)[0]
        stem_entry["library_ms_b128"] = time_ms(lambda: model.layer1(stem(model, xin)), 10)
        for kern in (chain_entry, stem_entry):
            print(f"{kern['name']} at B={TIME_BATCH}: {kern['ms_b128']:.3f} ms, library "
                  f"{kern['library_ms_b128']:.3f} ms, bound {kern['bound_ms_b128']:.4f} ms on {smi}")
        del classes
    kernels += [chain_entry, stem_entry]
    return infer


# -- the int8 path --------------------------------------------------------

_KERNELS = {"conv_int8": conv_int8_reference,
            "fused_bottleneck_chain_int8": bottleneck_chain_int8_reference,
            "fused_head_decode_v2": head_decode_reference,
            "fused_bottleneck_chain": layer1_reference}


@contextmanager
def twins():
    """make_quant_infer's functions run through the plain twins of every kernel."""
    saved = {n: getattr(Q, n) for n in _KERNELS}
    for n, twin in _KERNELS.items():
        setattr(Q, n, twin)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(Q, n, fn)


COUNTED = (conv_int8, fused_bottleneck_chain_int8, fused_head_decode_v2, fused_bottleneck_chain,
           fused_basic_chain, fused_stem_layer1, fused_gaussian_targets, fused_softmax_decode)


def zero_counters():
    for fn in COUNTED:
        fn.launches = 0


def counters():
    return {fn.__name__: fn.launches for fn in COUNTED}


def uint8_images(seed: int, batch: int, device):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, size=(batch, 256, 256, 3)).astype(np.uint8)).to(device)


def normalize(u8):
    """As make_quant_infer's input_norm: f32 mean*255 and 1/(std*255)."""
    mean = torch.tensor(NORM[0], dtype=torch.float32, device=u8.device) * 255.0
    inv_std = 1.0 / (torch.tensor(NORM[1], dtype=torch.float32, device=u8.device) * 255.0)
    return (u8.float() - mean) * inv_std


def record_sites(infer, weights, qparams, images):
    """One forward with every conv_int8 call recorded by exact shape class:
    {(k, stride, relu, Cin, Cout, H, W): [count, x, q]} (first input kept)."""
    classes = {}
    real = Q.conv_int8

    def rec(x, q, stride=1, relu=True):
        cout, k, _, cin = q.kq.shape
        key = (k, stride, relu, cin, cout, x.shape[1], x.shape[2])
        if key in classes:
            classes[key][0] += 1
        else:
            classes[key] = [1, x, q]
        return real(x, q, stride=stride, relu=relu)

    Q.conv_int8 = rec
    try:
        infer(weights, qparams, images)
    finally:
        Q.conv_int8 = real
    return classes


def conv_work(x, q, stride):
    b, h, w, cin = x.shape
    cout, k, _, _ = q.kq.shape
    pad = (k - 1) // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    ops = 2 * b * ho * wo * cout * k * k * cin
    return bound(0, 0, x.numel() * 2 + b * ho * wo * cout * 2 + q.kq.numel() + 12 * cout,
                 ops_int8=ops)


def int_mm_ms(x, q, stride):
    """torch._int_mm on the im2col matrix of the site, where its shape rules
    allow (None where they do not): a yardstick, used nowhere in the port."""
    cout, k, _, cin = q.kq.shape
    xq = torch.clamp(torch.round(x.float() / q.sa), -127, 127).to(torch.bfloat16)
    cols = torch.nn.functional.unfold(xq.permute(0, 3, 1, 2), k, padding=(k - 1) // 2,
                                      stride=stride)
    a = cols.transpose(1, 2).reshape(-1, cols.shape[1]).to(torch.int8).contiguous()
    b = q.kq.permute(0, 3, 1, 2).reshape(cout, -1).t()
    del cols, xq
    for mat in (b.contiguous(), b):          # row-major, then column-major
        try:
            torch._int_mm(a, mat)
            return time_ms(lambda: torch._int_mm(a, mat), 5)
        except RuntimeError:
            continue
    return None


def check_conv_classes(classes):
    """conv_int8 vs its twin once per shape class of the main path, with
    times; returns the kernels-line entry (sums over every site)."""
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, int_mm_ms=0.0)
    t_ops = t_bytes = 0.0
    worst, equal, total, int_mm_missing = 0.0, 0, 0, 0
    for (k, stride, relu, cin, cout, h, w), (count, x, q) in sorted(classes.items()):
        got = conv_int8(x, q, stride=stride, relu=relu)
        want = conv_int8_reference(x, q, stride=stride, relu=relu)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        limit = 0.01 * want.float().abs().max().item()
        eq = (got == want).sum().item()
        equal, total = equal + eq, total + got.numel()
        if not err <= limit:
            raise AssertionError(f"conv_int8 {k}x{k}/s{stride} {cin}->{cout} at {h}x{w}: "
                                 f"|kernel - plain| {err} > {limit}")
        worst = max(worst, err)
        w_bf16 = ((q.kq.permute(0, 3, 1, 2).float() * q.wscale[:, None, None, None])
                  .to(torch.bfloat16).contiguous(memory_format=torch.channels_last))
        bias = q.bias.to(torch.bfloat16)
        x_nchw = x.permute(0, 3, 1, 2)
        ms = time_ms(lambda: conv_int8(x, q, stride=stride, relu=relu), 10)
        plain = time_ms(lambda: conv_int8_reference(x, q, stride=stride, relu=relu), 1,
                        warmup=0)
        lib = time_ms(lambda: torch.nn.functional.conv2d(x_nchw, w_bf16, bias, stride,
                                                         (k - 1) // 2), 10)
        imm = int_mm_ms(x, q, stride)
        b_ms, b_by = conv_work(x, q, stride)
        if b_by == "operations":
            t_ops += count * b_ms
        else:
            t_bytes += count * b_ms
        for key, val in (("ms", ms), ("plain_ms", plain), ("bound_ms", b_ms),
                         ("library_ms", lib)):
            tot[key] += count * val
        if imm is None:
            int_mm_missing += count
        else:
            tot["int_mm_ms"] += count * imm
        print(f"conv_int8 {k}x{k}/s{stride} relu={relu} {cin}->{cout} at {h}x{w} x{count}: "
              f"max|kernel - plain| {err:.3g} (limit {limit:.3g}), bit-equal "
              f"{eq / got.numel():.6f}; {ms:.4f} ms, plain {plain:.3f} ms, cuDNN bf16 "
              f"{lib:.4f} ms, _int_mm {imm if imm is None else round(imm, 4)} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
    print(f"conv_int8 bit-equal share over all classes: {equal / total:.6f} (predicted >= 0.999); "
          f"_int_mm could not take {int_mm_missing} sites")
    return dict(name="conv_int8", route="cuda",
                source="hrnet_hand_pose_estimation_tpu_torch/csrc/conv_int8.cu",
                replaces="hrnet_hand_pose_estimation_tpu/core/quant_infer.py:78 (XLA int8 "
                         "conv, no pallas_call)",
                max_abs_err=worst, bit_equal=equal / total,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                int_mm_sites_missing=int_mm_missing, **tot)


def check_conv_w48(dev):
    """conv_int8 at a w48 branch site (3x3, 48 -> 48 at 64x64, B=32): Cin % 32
    == 16 takes a 16-channel last K slice.  Bit-equal to its twin or raises."""
    rng = np.random.default_rng(48)
    kq, wscale = Q.quantize_weight(rng.normal(size=(48, 48, 3, 3)).astype(np.float32) * 0.1)
    sa = torch.tensor(0.05, device=dev)
    wscale = torch.from_numpy(wscale).to(dev)
    q = SiteQ(kq=torch.from_numpy(np.ascontiguousarray(kq.transpose(0, 2, 3, 1))).to(dev),
              wscale=wscale, sa=sa, scale=sa * wscale,
              bias=torch.from_numpy(rng.normal(size=48).astype(np.float32) * 0.3).to(dev))
    x = torch.from_numpy(np.abs(rng.normal(size=(CHECK_BATCH, 64, 64, 48))).astype(
        np.float32) * 3).to(dev, torch.bfloat16)
    got = conv_int8(x, q)
    want = conv_int8_reference(x, q)
    torch.cuda.synchronize()
    equal = torch.equal(got, want)
    print(f"conv_int8 3x3 48->48 at 64x64 (a w48 branch site): bit-equal to its twin: {equal}; "
          f"max |out| {want.float().abs().max().item():.3f}")
    if not equal:
        raise AssertionError("conv_int8 at Cin 48 differs from its twin")
    return equal


def chain_work(x, params, flags):
    b, h, w, _ = x.shape
    ops, i = 0, 0
    for has_sc in flags:
        cin, cm = params[i + 1].shape
        cout = params[i + 7].shape[1]
        ops += 2 * b * h * w * (cin * cm + 9 * cm * cm + cm * cout + (cin * cout if has_sc else 0))
        i += 13 if has_sc else 10
    cout = params[-1].shape[0]
    return bound(0, 0, x.numel() * 2 + b * h * w * cout * 2 + nbytes(params), ops_int8=ops)


def head_int8_inputs(xs, scales):
    return [torch.clamp(torch.round(t.float() / sa), -127, 127).to(torch.int8)
            for t, sa in zip(xs, scales)]


def quant_forward_gate(label, infer, weights, qparams, witness_qparams, images, sites):
    """The int8 main path at B=32 with counters zeroed just before it: the
    launches, and the decode against the same forward through the twins,
    gated relative to the witness (twins with the walk's per-site int8
    layer1).  Returns (coords, launches)."""
    zero_counters()
    coords = infer(weights, qparams, images)
    torch.cuda.synchronize()
    launches = counters()
    print(f"{label}: CUDA launches on the main path: {launches}")
    want = {"conv_int8": sites, "fused_bottleneck_chain_int8": 4, "fused_head_decode_v2": 3,
            "fused_bottleneck_chain": 0, "fused_basic_chain": 0, "fused_stem_layer1": 0,
            "fused_gaussian_targets": 0, "fused_softmax_decode": 0}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    if coords.shape != (images.shape[0], 21, 2) or not torch.isfinite(coords).all():
        raise AssertionError(f"{label}: bad output, shape {tuple(coords.shape)}")
    with twins():
        plain = infer(weights, qparams, images)
        witness = (infer(weights, witness_qparams, images) - plain).abs()
    diff = (coords - plain).abs()
    limit = max(0.25, witness.max().item())
    spread = coords.std(dim=(0, 1)).min().item()
    print(f"{label}: kernel path vs plain-twin path max |d| = {diff.max().item():.4f} px "
          f"(limit {limit:.4f}), mean {diff.mean().item():.5f} px (limit: witness mean "
          f"{witness.mean().item():.4f}); witness (per-site int8 layer1) vs plain max "
          f"{witness.max().item():.4f} px; spread {spread:.3f} px (> 1)")
    if not diff.max().item() <= limit:
        raise AssertionError(f"{label}: kernel path disagrees with the plain path")
    if not diff.mean().item() <= witness.mean().item():
        raise AssertionError(f"{label}: kernel path farther from the plain path than the "
                             f"witness: {diff.mean()} > {witness.mean()}")
    if not spread > 1.0:
        raise AssertionError(f"{label}: coordinates barely spread ({spread} px)")
    return coords, launches


def int8_phases(cfg, state, weights, smi, kernels, new_infer):
    """Calibrate, prepare, check the int8 kernels, gate the int8 main path
    at B=32 and time it at B=128, then profile the bf16 paths (the default
    and ``new_infer``) and the int8 path.  Appends to ``kernels``."""
    dev = weights.model.conv1.weight.device
    infer = Q.make_quant_infer(cfg, device=dev, input_norm=NORM)
    with phase("int8 weights"):
        dstate = {k: v.to(dev) for k, v in state.items()}
        amax = Q.calibrate(cfg, weights, [normalize(uint8_images(10, CHECK_BATCH, dev))])
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "calibration.json")
            Q.save_calibration(path, amax, cfg)
            loaded = Q.load_calibration(path, cfg)
        if loaded != amax:
            raise AssertionError("calibration record did not round-trip")
        qparams = Q.prepare_serving_qparams(cfg, dstate, loaded)
        sites = sum(not k.startswith("_") for k in qparams)
        print(f"int8 qparams: {sites} int8 sites + {sorted(k for k in qparams if k[0] == '_')} "
              f"(calibration: {len(amax)} records)")
        n_sites = len(Q.quant_sites(cfg, "exchange", stem2=True))     # 291 for w32
        if sites != n_sites or Q.LAYER1_CHAIN_KEY not in qparams:
            raise AssertionError(f"want {n_sites} sites and the chain key, got {sites}")
        qparams_head = Q.prepare_serving_qparams(cfg, dstate, loaded, int8_head=True)
        witness = Q.prepare_serving_qparams(cfg, dstate, loaded, scope="wide",
                                            layer1_chain=False)
        witness_head = Q.prepare_serving_qparams(cfg, dstate, loaded, scope="wide",
                                                 layer1_chain=False, int8_head=True)
        images = uint8_images(11, CHECK_BATCH, dev)

    with phase("int8 kernel checks"), torch.inference_mode():
        classes = record_sites(infer, weights, qparams, images)
        conv_entry = check_conv_classes(classes)
        conv_entry["cin48_bit_equal"] = check_conv_w48(dev)
        rest = {k: v for k, v in qparams.items() if k != Q.LAYER1_CHAIN_KEY}
        model = weights.model
        x0 = Q._nhwc(Q._stem(model, Q._to_input(normalize(images).to(torch.bfloat16), dev),
                             rest))
        chain, flags = qparams[Q.LAYER1_CHAIN_KEY], weights.layer1[1]
        got = fused_bottleneck_chain_int8(x0, chain, flags)
        want = bottleneck_chain_int8_reference(x0, chain, flags)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        limit = 0.02 * max(1.0, want.float().abs().max().item())
        share = (got == want).float().mean().item()
        print(f"int8 layer1 chain: max|kernel - plain| = {err:.5f} (limit {limit:.5f}), "
              f"bit-equal {share:.6f}")
        if not err <= limit:
            raise AssertionError(f"int8 chain disagrees with its plain twin: {err} > {limit}")
        b_ms, b_by = chain_work(x0, chain, flags)
        x0_nchw = x0.permute(0, 3, 1, 2)
        chain_entry = dict(
            name="fused_bottleneck_chain_int8", route="cuda",
            source="hrnet_hand_pose_estimation_tpu_torch/csrc/int8_chain.cu",
            replaces="hrnet_hand_pose_estimation_tpu/ops/pallas/int8_chain.py:138",
            max_abs_err=err, bit_equal=share,
            ms=time_ms(lambda: fused_bottleneck_chain_int8(x0, chain, flags), 10),
            plain_ms=time_ms(lambda: bottleneck_chain_int8_reference(x0, chain, flags), 2,
                             warmup=1),
            bound_ms=b_ms, bound_by=b_by,
            # yardstick: the folded layer1 as cuDNN bf16 channels_last convs
            library_ms=time_ms(lambda: model.layer1(x0_nchw), 10))

        xs, _ = Q.apply_stages(cfg, model, got.permute(0, 3, 1, 2), mode="quant", qparams=rest)
        scales = qparams_head[Q.HEAD_SCALES_KEY]
        xq = head_int8_inputs([Q._nhwc(t) for t in xs], scales)
        got = fused_head_decode_v2(xq, weights.head, input_scales=scales)
        want = head_decode_reference(xq, weights.head, input_scales=scales)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"head decode, int8 inputs: max|kernel - plain| = {err:.5f} px (limit 0.1)")
        if not err <= 0.1:
            raise AssertionError(f"int8-input head disagrees with its plain twin: {err} px")
        b_ms, b_by = head_work(xq, weights.head, got)
        head_entry = dict(
            name="fused_head_decode_v2[int8]", route="cuda",
            source="hrnet_hand_pose_estimation_tpu_torch/csrc/fused_head_decode.cu",
            replaces="hrnet_hand_pose_estimation_tpu/ops/pallas/fused_head_decode.py:276",
            max_abs_err=err,
            ms=time_ms(lambda: fused_head_decode_v2(xq, weights.head, input_scales=scales), 10),
            plain_ms=time_ms(lambda: head_decode_reference(xq, weights.head,
                                                           input_scales=scales), 2, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        for kern in (conv_entry, chain_entry, head_entry):
            print(f"{kern['name']} at B={CHECK_BATCH}: {kern['ms']:.3f} ms, plain "
                  f"{kern['plain_ms']:.3f} ms, library {kern['library_ms']} ms, bound "
                  f"{kern['bound_ms']:.4f} ms ({kern['bound_by']}) on {smi}")
        del classes

    with phase("int8 main path"):
        coords, launches = quant_forward_gate("int8 path", infer, weights, qparams, witness,
                                              images, n_sites)
        conv_entry["launches"] = launches["conv_int8"]
        chain_entry["launches"] = launches["fused_bottleneck_chain_int8"]
        _, launches = quant_forward_gate("int8 path, int8 head", infer, weights, qparams_head,
                                         witness_head, images, n_sites)
        head_entry["launches"] = launches["fused_head_decode_v2"]
        xf = normalize(images)
        bf16_path = make_fast_infer(cfg, device=dev)(weights, xf)
        model32 = hrnet_from_cfg(cfg).to(dev)
        model32.load_state_dict(state)
        with torch.inference_mode():
            ref = soft_argmax(model32(xf).heatmaps)
        del model32
        for name, other in (("bf16 path", bf16_path), ("float32 model", ref)):
            d = (coords - other).abs()
            print(f"int8 path vs the {name} (information): max |d| = {d.max().item():.4f} px, "
                  f"mean {d.mean().item():.4f} px")

    with phase("int8 timing"), torch.inference_mode():
        big = uint8_images(12, TIME_BATCH, dev)
        step_ms = time_ms(lambda: infer(weights, qparams, big), 10, warmup=3)
        head_step_ms = time_ms(lambda: infer(weights, qparams_head, big), 10, warmup=2)
        print(f"int8 path B={TIME_BATCH}, uint8 in: {step_ms:.3f} ms/step, "
              f"{TIME_BATCH / step_ms * 1e3:.1f} images/s; with the int8 head "
              f"{head_step_ms:.3f} ms/step, {TIME_BATCH / head_step_ms * 1e3:.1f} images/s "
              f"on {smi}")
        stem_in = lambda: Q._stem(model, Q._to_input(normalize(big).to(torch.bfloat16), dev),
                                  rest)
        x0 = Q._nhwc(stem_in())
        l1 = fused_bottleneck_chain_int8(x0, chain, flags).permute(0, 3, 1, 2)
        xs, _ = Q.apply_stages(cfg, model, l1, mode="quant", qparams=rest)
        classes = record_sites(infer, weights, qparams, big)
        stem_ms = time_ms(stem_in, 10)
        l1_ms = time_ms(lambda: fused_bottleneck_chain_int8(x0, chain, flags), 10)
        stages_ms = time_ms(lambda: Q.apply_stages(cfg, model, l1, mode="quant",
                                                   qparams=rest), 5)
        sites_ms = stem2_ms = 0.0
        for (k, stride, relu, cin, cout, h, w), (count, x, q) in classes.items():
            t = count * time_ms(lambda: conv_int8(x, q, stride=stride, relu=relu), 10)
            sites_ms += t
            if cin == 64 and h == 128:       # stem2, inside the stem's time
                stem2_ms += t
        head_ms = time_ms(lambda: fused_head_decode_v2([Q._nhwc(t) for t in xs],
                                                       weights.head), 10)
        xq = head_int8_inputs([Q._nhwc(t) for t in xs], scales)
        head8_ms = time_ms(lambda: fused_head_decode_v2(xq, weights.head,
                                                        input_scales=scales), 10)
        split = {"stem (uint8 normalize, stem1 bf16, stem2 int8)": stem_ms,
                 "layer1 int8 chain": l1_ms,
                 "stage int8 sites (conv_int8, summed)": sites_ms - stem2_ms,
                 "stage bf16 adds, upsamples, quantize copies": stages_ms - (sites_ms - stem2_ms),
                 "head as served": head_ms}
        print(f"int8 step breakdown B={TIME_BATCH} (ms, CUDA events, parts timed alone): "
              + json.dumps({k: round(v, 3) for k, v in split.items()})
              + f"; sum {sum(split.values()):.3f}; int8-input head kernel {head8_ms:.3f} ms")
        conv_entry["ms_b128"], chain_entry["ms_b128"] = sites_ms, l1_ms
        head_entry["ms_b128"] = head8_ms
        conv_entry["bound_ms_b128"] = sum(c * conv_work(x, q, k[1])[0]
                                          for k, (c, x, q) in classes.items())
        chain_entry["bound_ms_b128"] = chain_work(x0, chain, flags)[0]
        head_entry["bound_ms_b128"] = head_work(xq, weights.head, torch.empty(
            TIME_BATCH, 21, 2, device=dev))[0]
        chain_entry["library_ms_b128"] = time_ms(lambda: model.layer1(x0.permute(0, 3, 1, 2)),
                                                 10)
    with phase("profile"), torch.inference_mode():
        bf16_infer, big_f32 = make_fast_infer(cfg, device=dev), normalize(big)
        for label, fn in (("bf16 path", lambda: bf16_infer(weights, big_f32)),
                          (f"bf16 path {NEW_CONFIG}", lambda: new_infer(weights, big_f32)),
                          ("int8 path", lambda: infer(weights, qparams, big))):
            wall, busy, top = device_busy(fn)
            print(f"{label} B={TIME_BATCH} under torch.profiler: {wall:.3f} ms/step wall, "
                  f"{busy:.3f} ms/step of kernels, device busy {busy / wall:.1%} on {smi}")
            for key, ms in top[:6]:
                print(f"    {ms:8.3f} ms/step  {key[:100]}")
    kernels += [head_entry, chain_entry, conv_entry]


# -- the 2D training path ---------------------------------------------------

TRAIN_BATCH = 32            # IMAGES_PER_GPU of the FreiHand training config
TRAIN_STEPS = 10


def train_cfg(**extra):
    """The training settings of
    experiments/FreiHand/Frei_HRNet_w32_trainable_softmax_hm-pose2dloss_v1.yaml,
    set in code (the card's machine may lack PyYAML): pose_hrnet_w32 with
    the trainable-softmax head at 256x256, heatmap loss + 0.1 * pose2d loss,
    adam at LR 1e-3, sigma 2, B=32, bf16 compute.  ``extra`` overrides
    dotted keys (``TRAIN__OPTIMIZER="sgd"``)."""
    opts = ["MODEL.NAME", "pose_hrnet_trainable_softmax", "MODEL.HEATMAP_SOFTMAX", True,
            "MODEL.IMAGE_SIZE", [256, 256], "MODEL.HEATMAP_SIZE", [64, 64], "MODEL.SIGMA", 2,
            "LOSS.WITH_HEATMAP_LOSS", True, "LOSS.HEATMAP_LOSS_FACTOR", 1.0,
            "LOSS.WITH_POSE2D_LOSS", True, "LOSS.POSE2D_LOSS_FACTOR", 0.1,
            "TRAIN.OPTIMIZER", "adam", "TRAIN.LR", 0.001, "TRAIN.LR_FACTOR", 0.5,
            "TRAIN.LR_STEP", [25, 55, 80], "TRAIN.IMAGES_PER_GPU", TRAIN_BATCH,
            "TRAIN.BEGIN_EPOCH", 1, "TRAIN.END_EPOCH", 91, "DATASET.SIGMA", 2]
    cfg = load_config(opts=opts, freeze=False)
    cfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
    if extra:
        cfg.merge_from_list([x for key, val in extra.items()
                             for x in (key.replace("__", "."), val)])
    return cfg


def train_batch(seed: int, batch: int, device, image: int = 256, res: int = 64):
    """A seeded numpy batch on the card: images, joints in heatmap pixels
    (one joint per sample invisible), visibility; no targets yet."""
    rng = np.random.default_rng(seed)
    vis = np.ones((batch, 21), np.float32)
    vis[np.arange(batch), rng.integers(0, 21, batch)] = 0.0
    host = {"images": rng.normal(size=(batch, image, image, 3)).astype(np.float32),
            "pose2d": rng.uniform(2, res - 2, size=(batch, 21, 2)).astype(np.float32),
            "visibility": vis}
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def ragged_joints(device):
    """B=3 joints at the edges of the semantics: -0.5 (valid: truncates to
    0), exactly res, beyond res, negative, invisible."""
    rng = np.random.default_rng(5)
    joints = rng.uniform(0, 64, size=(3, 21, 2)).astype(np.float32)
    joints[0, 0] = (-0.5, -0.5)
    joints[0, 1] = (64.0, 10.0)
    joints[1, 2] = (70.0, 80.0)
    joints[1, 3] = (-3.0, 5.0)
    joints[2, 4] = (63.99, 0.0)
    vis = np.ones((3, 21), np.float32)
    vis[2, 5] = 0.0
    return torch.from_numpy(joints).to(device), torch.from_numpy(vis).to(device)


def targets_work(out):
    """Bound of the targets kernel: the output written once (the joints are
    bytes-negligible but counted); ~16 float32 operations per element inside
    a window (an exp and its argument), counted on this run's data."""
    b, h, w, k = out.shape
    inside = int((out > 0).sum().item())
    return bound(0, 16 * inside, out.numel() * 4 + b * k * 12)


def conv_flops(model, images) -> float:
    """FLOPs of one forward (2 per multiply-add of every conv), counted with
    forward hooks at the run's shapes."""
    total = [0]

    def hook(mod, inp, out):
        k = mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
        total[0] += 2 * out.numel() * k

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            model(images)
    finally:
        for h in handles:
            h.remove()
    return float(total[0])


def state_tensors(state):
    """Every tensor the guard must leave bit-identical, cloned."""
    out = {"params": state.params.clone(), "stats": state.stats.clone(),
           "counts": state.counts.clone()}
    out.update({f"opt/{k}": v.clone() for k, v in state.opt_state.items()})
    return out


def train_phases(smi, kernels):
    """The 2D training path: the targets kernel against its twin, the
    flagship's train steps with targets made by the kernel, the guard, the
    float32 step on the card against the CPU, timing, and the Trainer."""
    dev = torch.device("cuda")
    sigma, res = 2.0, 64
    with phase("train kernel checks"):
        worst = 0.0
        for label, (joints, vis) in (
                ("B=32", (lambda b: (b["pose2d"], b["visibility"]))(train_batch(20, 32, dev))),
                ("B=128", (lambda b: (b["pose2d"], b["visibility"]))(train_batch(21, 128, dev))),
                ("ragged B=3", ragged_joints(dev))):
            for sig in ((1.0, 1.5, 2.0) if label.startswith("ragged") else (sigma,)):
                got = fused_gaussian_targets(joints, vis, res, sig)
                want = gaussian_targets_reference(joints, vis, res, sig)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                print(f"gaussian targets {label} sigma {sig}: max|kernel - plain| {err:.3g} "
                      f"(limit 1e-6), nonzero {(want > 0).float().mean().item():.4f}")
                if not err <= 1e-6:
                    raise AssertionError(f"targets kernel disagrees with its twin: {err}")
                worst = max(worst, err)
        entry = dict(name="fused_gaussian_targets", route="cuda",
                     source="hrnet_hand_pose_estimation_tpu_torch/csrc/gaussian_targets.cu",
                     replaces="hrnet_hand_pose_estimation_tpu/ops/pallas/decode_kernel.py:123",
                     max_abs_err=worst, library_ms=None)
        for b, seed in ((32, 20), (128, 21)):
            tb = train_batch(seed, b, dev)
            j, v = tb["pose2d"], tb["visibility"]
            out = fused_gaussian_targets(j, v, res, sigma)
            ms = time_ms(lambda: fused_gaussian_targets(j, v, res, sigma), 50, warmup=5)
            plain = time_ms(lambda: gaussian_targets_reference(j, v, res, sigma), 10)
            b_ms, b_by = targets_work(out)
            suffix = "" if b == 32 else f"_b{b}"
            entry.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain,
                          f"bound_ms{suffix}": b_ms})
            entry["bound_by"] = b_by
            print(f"fused_gaussian_targets B={b} (64x64x21, sigma 2): {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}); no single PyTorch call "
                  f"computes it, on {smi}")
            del tb, out

    cfg = train_cfg()
    cfg.freeze()
    model = build_model(cfg)
    with phase("train main path"):
        state, tx = TS.create_train_state(cfg, model, steps_per_epoch=1000, device=dev)
        step = TS.make_train_step(cfg, model, tx)
        batch = train_batch(0, TRAIN_BATCH, dev)
        start = state.params.clone()
        zero_counters()
        batch["target_heatmaps"] = gaussian_targets(batch["pose2d"], batch["visibility"], res,
                                                    sigma)
        history = []
        for _ in range(TRAIN_STEPS):
            state, losses = step(state, batch)
            history.append(losses)
        torch.cuda.synchronize()
        launches = counters()
        want = {fn.__name__: 0 for fn in COUNTED}
        want["fused_gaussian_targets"] = 1
        print(f"train path ({TRAIN_STEPS} steps, targets made once on the card): CUDA launches "
              f"{launches}")
        if launches != want:
            raise AssertionError(f"train path launches {launches}, want {want}")
        entry["launches"] = launches["fused_gaussian_targets"]
        host = [{k: v.item() for k, v in h.items()} for h in history]
        totals = [h["total_loss"] for h in host]
        print("train losses: " + " ".join(f"{t:.5f}" for t in totals)
              + f"; heatmap {host[0]['heatmap_loss']:.5f} -> {host[-1]['heatmap_loss']:.5f}, "
              f"pose2d {host[0]['pose2d_loss']:.5f} -> {host[-1]['pose2d_loss']:.5f}, "
              f"temperature {host[-1]['temperature']:.6f}")
        if not all(np.isfinite(v) for h in host for v in h.values()):
            raise AssertionError("a train loss is not finite")
        if any(h["nonfinite_grads"] for h in host):
            raise AssertionError("the guard skipped a clean step")
        if not totals[-1] < totals[0]:
            raise AssertionError(f"the total loss did not fall: {totals[0]} -> {totals[-1]}")
        moved = (state.params - start).abs().max().item()
        if not moved > 0:
            raise AssertionError("the parameters did not move")
        print(f"parameters moved by up to {moved:.4g}; step counter {int(state.step)}")

        bad = dict(batch)
        bad["images"] = batch["images"].clone()
        bad["images"][0, 0, 0, 0] = float("nan")
        before = state_tensors(state)
        state, losses = step(state, bad)
        after = state_tensors(state)
        same = {k: torch.equal(before[k], after[k]) for k in before}
        flag = losses["nonfinite_grads"].item()
        print(f"NaN pixel step: nonfinite_grads {flag}, bit-identical {same}, step "
              f"{int(state.step)}")
        if flag != 1.0 or not all(same.values()) or int(state.step) != TRAIN_STEPS + 1:
            raise AssertionError("the anomaly guard did not skip the poisoned step")

    with phase("train timing"):
        step_ms = time_ms(lambda: step(state, batch), 5, warmup=2)
        torch.cuda.reset_peak_memory_stats()
        step(state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        fwd_flops = conv_flops(model, batch["images"])
        # the backward takes about twice the forward's products (inputs and weights)
        step_bound, _ = bound(3 * fwd_flops, 0, 0)
        targets_ms = time_ms(lambda: gaussian_targets(batch["pose2d"], batch["visibility"],
                                                      res, sigma), 20)
        loss_computer = TS.LossComputer2D(cfg)

        def forward_loss():
            with TS.compute_autocast(cfg, dev):
                out = model(batch["images"])
            total, _ = loss_computer(out.heatmaps, batch["target_heatmaps"],
                                     TS.decode_heatmaps(out.heatmaps), batch["pose2d"],
                                     batch["visibility"])
            return total

        def forward_backward():
            state.grads.zero_()
            forward_loss().backward()

        fl_ms = time_ms(forward_loss, 3)
        fb_ms = time_ms(forward_backward, 3)
        upd_ms = time_ms(lambda: TS.apply_guarded_update(cfg, tx, state, {},
                                                         (state.stats.clone(),
                                                          state.counts.clone())), 10)
        split = {"targets kernel": targets_ms, "forward + loss (bf16 autocast)": fl_ms,
                 "backward (autograd, cuDNN)": fb_ms - fl_ms, "guarded update": upd_ms}
        print(f"train step B={TRAIN_BATCH} bf16: {step_ms:.3f} ms/step, "
              f"{TRAIN_BATCH / step_ms * 1e3:.1f} images/s, peak memory {peak:.2f} GiB, "
              f"{fwd_flops / TRAIN_BATCH / 1e9:.2f} GFLOP/image forward (conv products), "
              f"bound {step_bound:.3f} ms (3x forward at bf16 peak) on {smi}")
        print(f"train step breakdown B={TRAIN_BATCH} (ms, CUDA events, parts timed alone): "
              + json.dumps({k: round(v, 3) for k, v in split.items()})
              + f"; sum {sum(split.values()):.3f}")
        wall, busy, top = device_busy(lambda: step(state, batch), steps=1)
        print(f"train step B={TRAIN_BATCH} under torch.profiler: {wall:.3f} ms/step wall, "
              f"{busy:.3f} ms/step of kernels, device busy {busy / wall:.1%} on {smi}")
        for key, ms in top[:8]:
            print(f"    {ms:8.3f} ms/step  {key[:100]}")
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(state, batch)
            torch.cuda.synchronize()
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        launches = sum(e.count for e in ops if e.key.startswith("cudaLaunchKernel"))
        print(f"train step host side under torch.profiler: {launches} kernel launches; self "
              f"CPU ms and calls by op: " + "; ".join(
                  f"{e.key} {e.self_cpu_time_total / 1e3:.2f} x{e.count}" for e in ops[:12]))
        del batch, state, model, step
    kernels.append(entry)

    with phase("train parity (float32, card vs CPU)"):
        small = dict(MODEL__EXTRA__STAGE2__NUM_BLOCKS=[1, 1],
                     MODEL__EXTRA__STAGE3__NUM_MODULES=1, MODEL__EXTRA__STAGE3__NUM_BLOCKS=[1, 1, 1],
                     MODEL__EXTRA__STAGE4__NUM_MODULES=1,
                     MODEL__EXTRA__STAGE4__NUM_BLOCKS=[1, 1, 1, 1])
        pcfg = train_cfg(TPU__COMPUTE_DTYPE="float32", TRAIN__OPTIMIZER="sgd", **small)
        pcfg.freeze()
        pbatch = train_batch(30, 4, "cpu")
        pbatch["target_heatmaps"] = gaussian_targets(pbatch["pose2d"], pbatch["visibility"],
                                                     res, sigma)
        def one_step(where, tf32=False):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                m = build_model(pcfg)
                st, ptx = TS.create_train_state(pcfg, m, steps_per_epoch=1000, device=where)
                st, losses = TS.make_train_step(pcfg, m, ptx)(
                    st, {k: v.to(where) for k, v in pbatch.items()})
                return losses["total_loss"].item(), st.params.cpu(), st.grads.cpu()
            finally:
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

        cpu = one_step("cpu")
        lr = float(pcfg.TRAIN.LR)
        gmax = cpu[2].abs().max().item()
        # sgd's first step is -LR * g: the parameters differ by LR times the
        # gradients' difference, whose scale is max|g|
        scale = lr * max(1.0, gmax)

        def gaps(card):
            dp = (card[1] - cpu[1]).abs()
            return (abs(card[0] - cpu[0]) / abs(cpu[0]), dp.max().item() / scale,
                    dp.mean().item() / scale, int((dp > 1e-3 * lr).sum()))

        rel, dmax, dmean, over = gaps(one_step("cuda"))
        t_rel, t_max, t_mean, t_over = gaps(one_step("cuda", tf32=True))
        # a ReLU input within rounding of 0 can take the other side on the
        # card and on the CPU and move a few parameters far more than the
        # rest: the max is reported, the mean is held (TF32 moves it 10x)
        print(f"float32 step, reduced depth w32 @256, B=4, sgd, TF32 off: loss rel {rel:.3g} "
              f"(limit 1e-4); params mean|d| {dmean:.3g} (limit 2e-5), max|d| {dmax:.3g}, "
              f"in units of LR max(1, max|g| = {gmax:.4g}); {over} of {cpu[1].numel()} "
              f"parameters over 1e-3 LR.  With TF32 on (information): loss rel {t_rel:.3g}, "
              f"params mean {t_mean:.3g}, max {t_max:.3g}, {t_over} over 1e-3 LR")
        if not (rel <= 1e-4 and dmean <= 2e-5):
            raise AssertionError(f"card and CPU float32 steps differ: loss {rel}, params "
                                 f"mean {dmean}")

    with phase("trainer"), tempfile.TemporaryDirectory() as tmp:
        tcfg = train_cfg(OUTPUT_DIR=tmp, PRINT_FREQ=1, TRAIN__END_EPOCH=2)
        tcfg.freeze()
        loaders = {"synthetic": DataLoader(SyntheticDataset(tcfg, length=64), TRAIN_BATCH,
                                           num_workers=4)}
        vals = {"synthetic": DataLoader(SyntheticDataset(tcfg, "validation", length=32),
                                        TRAIN_BATCH, shuffle=False, num_workers=4)}
        trainer = Trainer(tcfg, build_model(tcfg), loaders, vals, output_dir=tmp, device=dev)
        trainer.fit()
        epochs = trainer.ckpt.epochs()
        fitted = trainer.state.state_dict()
        print(f"Trainer.fit: 1 epoch of {len(loaders['synthetic'])} steps at B={TRAIN_BATCH}, "
              f"checkpoints {epochs}, best validation total {trainer.best_loss:.5f}")
        rcfg = train_cfg(OUTPUT_DIR=tmp, TRAIN__END_EPOCH=2, AUTO_RESUME=True)
        rcfg.freeze()
        resumed = Trainer(rcfg, build_model(rcfg), loaders, vals, output_dir=tmp, device=dev)
        again = resumed.state.state_dict()
        same = all(torch.equal(fitted[s][k], again[s][k]) for s in ("params", "batch_stats")
                   for k in fitted[s])
        print(f"AUTO_RESUME: begins at epoch {resumed.begin_epoch}, state bit-identical {same}")
        if epochs != [1] or resumed.begin_epoch != 2 or not same:
            raise AssertionError("the Trainer did not checkpoint and resume")
        del trainer, resumed


# -- 2D evaluation and the tools -------------------------------------------

EVAL_BATCH = 32
EVAL_BATCHES = 4


def eval_cfg(out_dir: str):
    """The flagship (pose_hrnet_w32 softmax @256, bf16 compute) evaluated on
    the synthetic test set at 256/64, B=32."""
    cfg = load_config(opts=["MODEL.NAME", "pose_hrnet_softmax", "MODEL.TRAINABLE_SOFTMAX", True,
                            "MODEL.HEATMAP_SOFTMAX", True, "DATASET.DATASET", ["Synthetic_kpt"],
                            "DATASET.TEST_DATASET", ["Synthetic_kpt"],
                            "TEST.IMAGES_PER_GPU", EVAL_BATCH, "WORKERS", 4,
                            "EXP_NAME", "chip_smoke_eval", "OUTPUT_DIR", out_dir], freeze=False)
    cfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
    return cfg.freeze()


@contextmanager
def patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def decode_work(x, out):
    """Bound of the softmax decode: the logits read once and the output
    written once; ~10 float32 operations per logit (the temperature
    product, the max, one exp and three FMAs, counted at the f32 rate)."""
    return bound(0, 10 * x.numel(), nbytes([x, out]) + 4)


def decode_cases(dev):
    """(label, logits, temperature) of the B4 checks."""
    rng = np.random.default_rng(40)
    t25 = torch.tensor(2.5, device=dev)
    cases = []
    for shape in ((32, 64, 64, 21), (128, 64, 64, 21), (3, 64, 64, 21), (2, 48, 64, 21)):
        x = torch.from_numpy((rng.normal(size=shape) * 3).astype(np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            for temp in (1.0, t25):
                cases.append((f"{shape} {str(dtype)[6:]} T {float(temp)}", x.to(dtype), temp))
    return cases


def eval_phases(smi, kernels):
    """The softmax-decode kernel against its twin and timed; the flagship's
    standard 2D evaluation (the kernel once per batch) against the same
    evaluation decoded by the twin; the int8 serving evaluation; the
    evaluation tool and the inference tool's serving functions."""
    dev = torch.device("cuda")
    with phase("eval kernel checks"):
        worst = 0.0
        for label, x, temp in decode_cases(dev):
            got = fused_softmax_decode(x, temp)
            want = softmax_decode_reference(x, temp)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            if not err <= 1e-4:
                raise AssertionError(f"softmax decode {label}: kernel vs twin {err} px > 1e-4")
        flat = fused_softmax_decode(torch.zeros(2, 64, 64, 21, device=dev), 2.5)
        peak = torch.from_numpy(np.random.default_rng(41).normal(
            size=(2, 64, 64, 21)).astype(np.float32)).to(dev)
        peak[1, 10, 37, 4] = 1e4
        top = fused_softmax_decode(peak, torch.tensor(2.5, device=dev))[1, 4].tolist()
        print(f"softmax decode: {len(decode_cases(dev))} cases (B 32/128/3 and 2x48x64, f32 "
              f"and bf16, T 1.0 and 2.5 on the card), max|kernel - twin| {worst:.3g} px "
              f"(limit 1e-4); flat plane -> {flat[0, 0].tolist()}, one logit of 1e4 at "
              f"(37, 10) -> {top}")
        if not (flat == 31.5).all() or top != [37.0, 10.0]:
            raise AssertionError("softmax decode: flat or peaked plane decoded wrongly")
        entry = dict(name="fused_softmax_decode", route="cuda",
                     source="hrnet_hand_pose_estimation_tpu_torch/csrc/softmax_decode.cu",
                     replaces="hrnet_hand_pose_estimation_tpu/ops/pallas/decode_kernel.py:69",
                     max_abs_err=worst, library_ms=None)
        temp = torch.tensor(1.7, device=dev)
        for b in (EVAL_BATCH, TIME_BATCH):
            base = torch.randn(b, 64, 64, 21, device=dev) * 3
            for dtype in (torch.bfloat16, torch.float32):
                x = base.to(dtype)
                ms = time_ms(lambda: fused_softmax_decode(x, temp), 50, warmup=5)
                plain = time_ms(lambda: softmax_decode_reference(x, temp), 20, warmup=3)
                # the kernel's own device time: back-to-back calls above are
                # paced by the wrapper's host work when that is longer
                _, kernel_ms, _ = device_busy(lambda: fused_softmax_decode(x, temp), steps=20)
                b_ms, b_by = decode_work(x, torch.empty(b, 21, 2, device=dev))
                # the eval path's logits are bf16 at B=32: the unsuffixed keys
                suffix = ("" if dtype == torch.bfloat16 else "_f32") + (
                    "" if b == EVAL_BATCH else f"_b{b}")
                entry.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain,
                              f"bound_ms{suffix}": b_ms, f"device_ms{suffix}": kernel_ms})
                entry["bound_by"] = b_by
                print(f"fused_softmax_decode B={b} (64x64x21 {str(dtype)[6:]}): {ms:.4f} ms per "
                      f"call, {kernel_ms:.4f} ms of kernel (torch.profiler), plain {plain:.4f} "
                      f"ms, bound {b_ms:.4f} ms ({b_by}); no single PyTorch call computes it, "
                      f"on {smi}")

    with tempfile.TemporaryDirectory() as tmp:
        cfg = eval_cfg(tmp)
        state = init_variables(cfg, seed=0, device=dev)
        loader = make_test_dataloader(cfg)["Synthetic_kpt"]
        # the registry's synthetic set holds 64 samples; the smoke evaluates 128
        loader.dataset.length = EVAL_BATCH * EVAL_BATCHES
        with phase("eval main path"):
            model = build_model(cfg)
            ev = Evaluator2D(cfg, model, state, device=dev)
            zero_counters()
            results = ev.run(loader, "Synthetic", tmp)
            torch.cuda.synchronize()
            launches = counters()
            want = {fn.__name__: 0 for fn in COUNTED}
            want["fused_softmax_decode"] = len(loader)
            print(f"Evaluator2D std, {len(loader)} batches of {EVAL_BATCH}: CUDA launches "
                  f"{launches}; results {json.dumps(results)}")
            if launches != want:
                raise AssertionError(f"eval path launches {launches}, want {want}")
            entry["launches"] = launches["fused_softmax_decode"]
            if not all(np.isfinite(v) for v in results.values()) or not results["fps"] > 0:
                raise AssertionError(f"eval results not finite: {results}")
            out = Path(tmp) / "eval2D_results_chip_smoke_eval"
            shapes = (np.loadtxt(out / "mse2d_each_joint.txt").shape,
                      np.loadtxt(out / "PCK2d.txt").shape)
            if shapes != ((21,), (2, 49)):
                raise AssertionError(f"eval artifacts of shapes {shapes}")
            worst = 0.0
            spread = []
            with torch.no_grad():
                for batch in loader:
                    images = torch.from_numpy(batch["imgs"]).to(dev)
                    with TS.compute_autocast(cfg, dev):
                        logits, temp = ev.model.forward_logits(images)
                    got = fused_softmax_decode(logits, temp)
                    want_xy = softmax_decode_reference(logits, temp)
                    worst = max(worst, (got - want_xy).abs().max().item())
                    spread.append(got.std(dim=(0, 1)).min().item())
            with patched(EV, "softmax_decode", softmax_decode_reference):
                twin = Evaluator2D(cfg, model, None, device=dev).run(loader, "Synthetic")
            gaps = {k: abs(results[k] - twin[k]) for k in ("EPE_px", "PCK_AUC_30",
                                                            "PCK_AUC_full")}
            print(f"eval decode, kernel vs twin on the same logits ({logits.dtype}): max "
                  f"{worst:.3g} px (limit 1e-4); coordinate spread >= {min(spread):.3f} px; "
                  f"results decoded by the twin {json.dumps(twin)}; gaps {json.dumps(gaps)} "
                  f"(limit 1e-3)")
            if not worst <= 1e-4 or not all(g <= 1e-3 for g in gaps.values()):
                raise AssertionError(f"eval decode disagrees with its twin: {worst}, {gaps}")

            zero_counters()
            ev8 = Evaluator2D(cfg, model, None, serving="int8", device=dev)
            results8 = ev8.run(loader, "Synthetic")
            torch.cuda.synchronize()
            launches8 = counters()
            print(f"Evaluator2D int8: CUDA launches {launches8}; results {json.dumps(results8)}")
            if not (launches8["conv_int8"] and launches8["fused_bottleneck_chain_int8"]
                    and launches8["fused_head_decode_v2"]) or launches8["fused_softmax_decode"]:
                raise AssertionError(f"int8 eval launches {launches8}")
            if not all(np.isfinite(v) for v in results8.values()):
                raise AssertionError(f"int8 eval results not finite: {results8}")

        with phase("eval timing"):
            batch = next(iter(loader))
            images = torch.from_numpy(batch["imgs"]).to(dev)
            step = time_ms(lambda: ev.forward(images).cpu(), 5, warmup=2)

            def logits_only():
                with torch.no_grad(), TS.compute_autocast(cfg, dev):
                    return ev.model.forward_logits(images)

            trunk = time_ms(logits_only, 5, warmup=1)
            logits, temp = logits_only()
            decode = time_ms(lambda: fused_softmax_decode(logits, temp), 20)
            print(f"Evaluator2D std batch B={EVAL_BATCH}: {step:.3f} ms (forward to the .cpu() "
                  f"of the decode, CUDA events), {EVAL_BATCH / step * 1e3:.1f} images/s; "
                  f"forward_logits {trunk:.3f} ms, decode kernel {decode:.4f} ms "
                  f"({decode / step:.2%} of the batch); the evaluator reported "
                  f"{results['fps']:.1f} fps over {len(loader) - 1} timed batches on {smi}")
        del ev, ev8

        with phase("tools"):
            tcfg = eval_cfg(tmp)
            res = tool_eval.evaluate(tcfg, state=state, out=tmp, device=dev)
            out = Path(tmp) / "eval2D_results_chip_smoke_eval"
            lines = (out / "mse2d_each_joint.txt").read_text().splitlines()
            pck = np.loadtxt(out / "PCK2d.txt")
            print(f"tools.evaluate_2d.evaluate: {json.dumps(res)}; mse2d_each_joint.txt "
                  f"{len(lines)} lines, PCK2d.txt {pck.shape}")
            if len(lines) != 21 or pck.shape != (2, 49):
                raise AssertionError("evaluate_2d artifacts have the wrong shapes")
            frames = batch["imgs"]
            images = torch.from_numpy(frames).to(dev)
            kernels_of = {"std": (), "fast": ("fused_bottleneck_chain", "fused_head_decode_v2"),
                          "int8": ("conv_int8", "fused_bottleneck_chain_int8",
                                   "fused_head_decode_v2")}
            for mode, used in kernels_of.items():
                fwd = make_serving_fn(tcfg, state, mode, list(frames), device=dev)
                zero_counters()
                _, pose = fwd(images)
                torch.cuda.synchronize()
                launched = {k: v for k, v in counters().items() if v}
                print(f"tools.inference.make_serving_fn({mode!r}): {tuple(pose.shape)}, "
                      f"launches {launched}")
                if tuple(pose.shape) != (EVAL_BATCH, 21, 2) or not torch.isfinite(pose).all():
                    raise AssertionError(f"serving fn {mode} gave a bad output")
                if set(launched) != set(used):
                    raise AssertionError(f"serving fn {mode} launched {launched}, want {used}")
    kernels.append(entry)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 plain twins and references
    torch.backends.cudnn.allow_tf32 = False

    with phase("device"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        name = torch.cuda.get_device_name(0)
        print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    with phase("build"):
        t = time.perf_counter()
        _build.build(verbose=True)
        _build.lib()
        print(f"kernels built and loaded in {time.perf_counter() - t:.2f} s")

    with phase("weights"):
        cfg = flagship_cfg()                # checked and timed: the whole model
        state = init_variables(cfg, seed=0, device=dev)
        weights = precast_variables(cfg, state, device=dev)
        infer = make_fast_infer(cfg, device=dev)
        rng = np.random.default_rng(0)
        images = torch.from_numpy(
            rng.normal(size=(CHECK_BATCH, 256, 256, 3)).astype(np.float32)).to(dev)

    kernels = []
    with phase("kernel checks"), torch.inference_mode():
        x1, xs = kernel_inputs(weights, images)
        params, flags = weights.layer1
        got = fused_bottleneck_chain(x1, params, flags)
        want = layer1_reference(x1, params, flags)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        limit = 0.02 * max(1.0, want.float().abs().max().item())
        print(f"layer1 chain: max|kernel - plain| = {err:.5f} (limit {limit:.5f})")
        if not err <= limit:
            raise AssertionError(f"layer1 kernel disagrees with its plain twin: {err} > {limit}")
        x_nchw = x1.permute(0, 3, 1, 2)
        bound_ms, bound_by = layer1_work(x1, params, flags, got)
        kernels.append(dict(
            name="fused_bottleneck_chain", route="cuda",
            source="hrnet_hand_pose_estimation_tpu_torch/csrc/fused_bottleneck.cu",
            replaces="hrnet_hand_pose_estimation_tpu/ops/pallas/fused_bottleneck.py:127",
            max_abs_err=err,
            ms=time_ms(lambda: fused_bottleneck_chain(x1, params, flags), 10),
            plain_ms=time_ms(lambda: layer1_reference(x1, params, flags), 2, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by,
            # yardstick: the same folded chain as cuDNN bf16 channels_last convs
            library_ms=time_ms(lambda: weights.model.layer1(x_nchw), 10)))

        got = fused_head_decode_v2(xs, weights.head)
        want = head_decode_reference(xs, weights.head)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"head decode: max|kernel - plain| = {err:.5f} px (limit 0.05)")
        if not err <= 0.05:
            raise AssertionError(f"head kernel disagrees with its plain twin: {err} px")
        bound_ms, bound_by = head_work(xs, weights.head, got)
        kernels.append(dict(
            name="fused_head_decode_v2", route="cuda",
            source="hrnet_hand_pose_estimation_tpu_torch/csrc/fused_head_decode.cu",
            replaces="hrnet_hand_pose_estimation_tpu/ops/pallas/fused_head_decode.py:276",
            max_abs_err=err,
            ms=time_ms(lambda: fused_head_decode_v2(xs, weights.head), 10),
            plain_ms=time_ms(lambda: head_decode_reference(xs, weights.head), 2, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        for kern in kernels:
            print(f"{kern['name']} at B={CHECK_BATCH}: {kern['ms']:.3f} ms, plain "
                  f"{kern['plain_ms']:.3f} ms, library {kern['library_ms']} ms, bound "
                  f"{kern['bound_ms']:.4f} ms ({kern['bound_by']}) on {smi}")

    with phase("main path"):
        fused_bottleneck_chain.launches = 0
        fused_head_decode_v2.launches = 0
        coords = infer(weights, images)
        torch.cuda.synchronize()
        launches = {"fused_bottleneck_chain": fused_bottleneck_chain.launches,
                    "fused_head_decode_v2": fused_head_decode_v2.launches}
        print(f"CUDA launches on the main path: {launches}")
        for kern in kernels:
            kern["launches"] = launches[kern["name"]]
            if kern["launches"] < 1:
                raise AssertionError(f"the main path never launched {kern['name']}")
        if coords.shape != (CHECK_BATCH, 21, 2) or not torch.isfinite(coords).all():
            raise AssertionError(f"bad output: shape {tuple(coords.shape)}")
        if not ((coords >= 0) & (coords <= 63)).all():
            raise AssertionError("decoded coordinates outside the 64x64 heatmap")
        # The plain path runs both twins.  The witness runs cuDNN's bf16
        # layer1 (another right bf16 layer1, rounding its residual sum once
        # more) with the head twin: how far rounding alone moves the decode.
        plain = twin_forward(weights, images, layer1=nchw(layer1_reference, weights))
        diff = (coords - plain).abs()
        witness = (twin_forward(weights, images, layer1=weights.model.layer1) - plain).abs()
        limit = max(0.25, witness.max().item())
        spread = coords.std(dim=(0, 1)).min().item()
        print(f"kernel path vs plain-twin path: max |d| = {diff.max().item():.4f} px "
              f"(limit {limit:.4f} = max(0.25, witness)), mean {diff.mean().item():.4f} px "
              f"(limit: witness mean); witness cuDNN layer1 vs plain: max "
              f"{witness.max().item():.4f} px, mean {witness.mean().item():.4f} px; "
              f"coordinate spread (std over samples and joints) = {spread:.3f} px (> 1)")
        if not diff.max().item() <= limit:
            raise AssertionError(f"kernel path disagrees with the plain path: {diff.max()} px")
        if not diff.mean().item() <= witness.mean().item():
            raise AssertionError(f"kernel path farther from the plain path than cuDNN's "
                                 f"layer1: mean {diff.mean()} > {witness.mean()} px")
        if not spread > 1.0:
            raise AssertionError(f"coordinates barely spread ({spread} px): vacuous check")
        model = hrnet_from_cfg(cfg).to(dev)
        model.load_state_dict(state)
        with torch.inference_mode():
            ref = soft_argmax(model(images).heatmaps)
        mean_err = (coords - ref).abs().mean().item()
        print(f"bf16 serving path vs the float32 model: mean |d| = {mean_err:.4f} px, "
              f"max {(coords - ref).abs().max().item():.4f} px (mean limit 0.5)")
        if not mean_err <= 0.5:
            raise AssertionError(f"serving path far from the float32 model: {mean_err} px")
        del model

    with phase("timing"):
        big = torch.from_numpy(np.random.default_rng(1).normal(
            size=(TIME_BATCH, 256, 256, 3)).astype(np.float32)).to(dev)
        step_ms = time_ms(lambda: infer(weights, big), 10, warmup=3)
        print(f"main path B={TIME_BATCH}: {step_ms:.3f} ms/step, "
              f"{TIME_BATCH / step_ms * 1e3:.1f} images/s on {smi}")
        with torch.inference_mode():
            x1, xs = kernel_inputs(weights, big)
            params, flags = weights.layer1
            timed = {"fused_bottleneck_chain": lambda: fused_bottleneck_chain(x1, params, flags),
                     "fused_head_decode_v2": lambda: fused_head_decode_v2(xs, weights.head)}
            work = {"fused_bottleneck_chain": layer1_work(x1, params, flags, x1.new_empty(
                        x1.shape[:3] + (256,))),
                    "fused_head_decode_v2": head_work(xs, weights.head, torch.empty(
                        TIME_BATCH, 21, 2, device=dev))}
            for kern in kernels:
                kern[f"ms_b{TIME_BATCH}"] = time_ms(timed[kern["name"]], 10)
                kern[f"bound_ms_b{TIME_BATCH}"] = work[kern["name"]][0]
                print(f"{kern['name']} at B={TIME_BATCH}: {kern[f'ms_b{TIME_BATCH}']:.3f} ms, "
                      f"bound {work[kern['name']][0]:.4f} ms on {smi}")
            lib_ms = time_ms(lambda: weights.model.layer1(x1.permute(0, 3, 1, 2)), 10)
            print(f"cuDNN layer1 at B={TIME_BATCH}: {lib_ms:.3f} ms on {smi}")
            # where the step goes; layer1 and the head as the serving path
            # calls them, with their NCHW <-> NHWC layout changes
            model = weights.model
            xin = to_input(big)
            x0 = stem(model, xin)
            xs_nchw = model.forward_backbone(xin)
            kernel_l1 = nchw(fused_bottleneck_chain, weights)
            copies = sum(not t.permute(0, 2, 3, 1).is_contiguous() for t in [x0, *xs_nchw])
            print(f"kernel inputs that need a layout copy on the serving path: {copies} of 5")
            prep_ms = time_ms(lambda: to_input(big), 10)
            stem_ms = time_ms(lambda: stem(model, xin), 10)
            l1_ms = time_ms(lambda: kernel_l1(x0), 10)
            backbone_ms = time_ms(lambda: model.forward_backbone(xin, layer1=kernel_l1), 10)
            head_ms = time_ms(lambda: fused_head_decode_v2(
                [t.permute(0, 2, 3, 1).contiguous() for t in xs_nchw], weights.head), 10)
            split = {"input cast": prep_ms, "stem": stem_ms, "layer1 as served": l1_ms,
                     "stages 2-4 (cuDNN)": backbone_ms - stem_ms - l1_ms,
                     "head as served": head_ms}
            print(f"step breakdown B={TIME_BATCH} (ms, CUDA events, parts timed alone): "
                  + json.dumps({k: round(v, 3) for k, v in split.items()}))

    new_infer = new_config_phases(cfg, weights, smi, kernels, images, plain)
    int8_phases(cfg, state, weights, smi, kernels, new_infer)
    del weights, state, new_infer
    train_phases(smi, kernels)
    eval_phases(smi, kernels)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
