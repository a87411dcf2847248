#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

Drives the port's bf16 serving path (``core/fast_infer.make_fast_infer``) for
pose_hrnet_w32 with the softmax head at 256x256 (random weights from a
numpy seed), builds the hand-written CUDA kernels of that path with nvcc,
holds each kernel against its plain PyTorch twin, checks at batch 32 that
the serving path went through both kernels and agrees with the same
forward through the twins, and times the same model at batch 128.

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
import time
from contextlib import contextmanager

import numpy as np
import torch

from hrnet_hand_pose_estimation_tpu_torch.config import (POSE_HIGH_RESOLUTION_NET_EXTRA,
                                                         load_config)
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import (make_fast_infer,
                                                                  precast_variables)
from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.ops.decode import soft_argmax
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import _build
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import (
    fused_bottleneck_chain, layer1_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_head_decode import (
    fused_head_decode_v2, head_decode_reference)
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import init_variables

CHECK_BATCH = 32
TIME_BATCH = 128            # bench.py's batch
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

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


def bound(flops_bf16: float, flops_f32: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) for the work: the larger of bytes over the memory rate
    and operations over the peak rate of their type."""
    t_ops = flops_bf16 / PEAK_BF16 + flops_f32 / PEAK_F32
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def layer1_work(x, params, flags, out):
    b, h, w, _ = x.shape
    flops, i = 0, 0
    for has_sc in flags:
        w1, w2, w3 = params[i], params[i + 2], params[i + 4]
        cin, cm = w1.shape
        cout = w3.shape[1]
        flops += 2 * b * h * w * (cin * cm + 9 * cm * cm + cm * cout + (cin * cout if has_sc else 0))
        i += 8 if has_sc else 6
    return bound(flops, 0, nbytes([x, out, *params]))


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


def twin_forward(weights, images, layer1):
    """The serving forward with ``layer1`` (NCHW -> NCHW) in place of the
    chain kernel and the head kernel's plain twin."""
    with torch.inference_mode():
        xs = weights.model.forward_backbone(to_input(images), layer1=layer1)
        return head_decode_reference([t.permute(0, 2, 3, 1).contiguous() for t in xs],
                                     weights.head)


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
        plain = twin_forward(weights, images, nchw(layer1_reference, weights))
        diff = (coords - plain).abs()
        witness = (twin_forward(weights, images, weights.model.layer1) - plain).abs()
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

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
