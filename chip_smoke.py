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
from hrnet_hand_pose_estimation_tpu_torch.core import fast_infer as FI
from hrnet_hand_pose_estimation_tpu_torch.core import quant_infer as Q
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import (make_fast_infer,
                                                                  precast_variables)
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
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.int8_chain import (
    bottleneck_chain_int8_reference, fused_bottleneck_chain_int8)
from hrnet_hand_pose_estimation_tpu_torch.ops.s2d import space_to_depth
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
                "fused_stem_layer1": 1 + len(flags)}
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
           fused_basic_chain, fused_stem_layer1)


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
            "fused_bottleneck_chain": 0, "fused_basic_chain": 0, "fused_stem_layer1": 0}
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

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
