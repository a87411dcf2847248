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
the same forward through the twins, and times the paths at batch 128. For
the branch-chain kernel and ``conv_int8`` it also prints each shape class's
time at batch 128 beside cuDNN's and the bound (``per_class`` in the
kernels line); for the bf16 and the int8 layer1 kernels each of their
four launches and for the stem + layer1 path the stem launch alone, at
batch 32 and 128, beside cuDNN's same folded convs, the bound and the four
launches' byte floor.

Before those, the repo's own experiments/synthetic_smoke.yaml (branches
8/16/32/64, a head 120 wide, a 2x2 coarsest map) is served on the card at
B=1 and B=4 through both bf16 configurations and the int8 path, each
against its twin path with the launch counters checked, and the serving
CLIs (tools.inference --serving fast|int8, tools.evaluate_2d --serving
int8) run on it with --device cuda.

Then the last two TPU kernels' own entry points at the flagship's full
width, on the real tensors of the serving paths: the W8A8 BasicBlock branch
chain (``prepare_branch_int8`` + ``fused_basic_chain_int8``) over the 26
branch inputs of the int8 path, against its twin and against the int8
walk's own per-site branches (per shape class at batch 128 beside the
bf16 chain kernel's class time and cuDNN's ResLayers), and the first
version of the fused head
(``fused_head_decode``, one launch) on the four branch tensors of the
default bf16 path at B=32 and B=128, against its twin and beside the second
version and cuBLAS's head GEMM, and at the w18 and smoke model's branch
widths.

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
kernel (each plane split over a cluster) against its twin at B=1, 32 and
128, the standard evaluation (one decode launch per
batch) against the same evaluation decoded by the twin, the int8 serving
evaluation, the evaluation tool's artifacts, and the inference tool's
three serving functions.

Then the multi-view 3D path at the full width of
experiments/LearnableTriangulation/VolTriangulation_v1.yaml
(pose_hrnet_volumetric w32 at 256/64, a 64^3 cube of 500 mm, softmax
aggregation, 4 views, B=4) on the synthetic multi-view set: the vol, alg
and ransac nets and the dlt mode of ``core/evaluator3d.Evaluator3D``, each
forward one softmax-decode launch and within stated limits of the same
forward decoded by the kernel's twin, one ``Evaluator3D.run``, the
evaluate_3d tool, and the time of each net and of its parts.

Then 3D training (``core/trainer3d``, ``core/trainer3d_gan``) with the
MODEL, LOSS and TRAIN sections of VolTriangulation_MHP_v2.yaml (vol, B=2),
AlgTriangulation_MHP_v1.yaml (alg, B=4) and VolTriangulation_MHP_GAN_v1.yaml
(B=2, cut from 8) set in code, 4 views of Synthetic_mv: the softmax
decode's backward kernel against its twin (dx, dT, two runs bit-equal) and
timed at B=8 and B=128; three vol steps, each one forward and one backward
decode launch, the frozen parameters bit-unchanged and every other group
moved, one validation; the vol and alg steps in float32 against the same
steps decoded by the twin (held to a witness, the twin moved by 1e-4 px);
two WGAN batches (critic weights within the clip, the generator's running
statistics moved only by its supervised step); each step's time, peak
memory and the decode's share of it; the train3d tool.

Last, the CPM family and the cross-view fusion net, with sections of their
YAMLs set in code: CPM (experiments/MHP/MHP_CPM_v1.yaml at 256 with
HEATMAP_SIZE 32, since CPM's maps are the input / 8, ROADMAP C14; B=8):
the forward on the card in float32 against the CPU and in bf16 against
float32, train steps at the YAML's LR 1e-3 (reported) and at 1e-5 (the
loss must fall), one eval batch, and tools.train on
experiments/synthetic_cpm_smoke.yaml; the fusion net
(experiments/MHP/MHP_HRNet_w48_fusion_v1.yaml: w48 at 256/64, 4 views,
B=1): three train steps, each one B4 forward and one B4 backward launch,
one float32 step against the same step decoded by B4's twin (held to a
witness), the step's time, peak memory and B4's share; vol_CPM
(VolTriangulation_MHP_CPM_v1.yaml at 256/32 with TRIANGULATION_MODEL_NAME
'vol_CPM', C14; a 64^3 cube, 4 views, B=2 cut from 8): the forward with
the YAML's argmax decode and with the softmax decode (one B4 launch,
against its twin), one Trainer3D step with every parameter JAX's labels
freeze bit-unchanged, and the train3d tool.

Then the single-image model zoo at its shipped RHD YAMLs' widths, their
sections set in code, on Synthetic_kpt at 256/64: Swin
(RHD_SwinTransformer_trainable_softmax_pose2dloss_v1: the float32 forward on
the card against the CPU, bf16 against float32 held to the CPU's own bf16
gap, times at B=32 and B=128, Evaluator2D at B=32 with one B4 launch per
batch against its twin, three train steps at the YAML's LR and a falling
loss over ten, the step's time, peak memory and busy share, tools.train for
an epoch); the hamburger (RHD_HRNet_MatrixDecomp_..._v2: w32, R 512, NMF:
the float32 forward on the card against the CPU, Evaluator2D at B=32
through B4, the ham's time, tools.evaluate_2d, its steps refused, C16);
the RVT (RHD_Resnet50_RVT_v1, float32: the card against the CPU's float64,
the time at B=32, its steps refused, C17); SimpleBaseline (ResNet-50, 3 x
256 deconvs: forward, three train steps, an eval batch, each timed).

Last, the temporal family on seeded frames at 256/64, its YAMLs' sections
set in code (``temporal_phases``): PoseAggr
(MHP_HRNet_w32_trainable_softmax_pose2dloss_PoseAggr_v1: w32, 5 frames,
B=2, the 20-block offset chain in bf16, dilations 3-24: the forward with a
float32 offset chain on the card against the CPU, the registry's net in
bf16 against float32 held to the CPU's own gap, one Evaluator2D batch with
one B4 launch against its twin, the deformable conv's time beside its
bound, three train steps at the YAML's LR, the step's time, peak memory
and busy share, v2's SEQ_IDX through the forward); PoseFormer
(..._PoseFormer_v1: 9 frames, B=1: one B4 launch a forward against its
twin, the float32 refined pose against the CPU's, one C20 train step with
one B4 forward and no backward launch and a zero gradient outside the
backbone, C20 raised at B=2); PredRNN and the TCN at the config defaults
(T=5, B=2: float32 on the card against the CPU, C19 on their entry points).

Last, FTL at experiments/MHP/MHP_HRNet_w32_softmax_pose2dloss_FTL_v1.yaml's
widths (w32 at 256/64, 4 views, B=2, a seeded camera rig): the float32
forward on the card against the CPU's float64 (within 2x the CPU's own
float32 gap), the registry's net (its convs in bf16) against float32 held
to the CPU's own bf16 gap on the same inputs, one B4 launch a forward held
to its twin, the gradient of sum(keypoints_3d) (one B4 backward launch,
none into the frozen backbone, held to the twin-decoded gradient by a
witness), the forward's time, and C21 from tools.train and the entry
points; HourGlass (2 stacks, depth 2, B=8: float32 against the CPU's
float64, bf16 against float32, C22); and the mesh family on the card
against the CPU, each timed: HandMeshNet on w32-wide features, LBS at B=64
on a MANO-sized rig, MeshRenderer at 256 px (1538 faces), nms and soft_nms
on 2000 boxes (beside JAX's greedy loop run op by op), oks_nms on 200
poses, scale_aware_gaussian_targets at B=32.

Last, the dataset readers (``reader_phases``): every format's tree is
written into a temporary directory without cv2 (tests/torch_reader_trees.py,
PNG content also under the .jpg / .jpeg names, decoded by the port's own
PNG decoder), then with the sections of
experiments/RHD/RHD_HRNet_w32_trainable_softmax_hm-pose2dloss_v1.yaml set in
code (w32 at 256/64, B=32): ``Trainer.fit`` for one epoch on RHD_kpt (64
crops of 320x320 frames, 2 steps, finite losses), ``Evaluator2D`` std on
the raw RHD set (32 crops, the crop-corner rescale, one B4 launch a batch,
against the same evaluation decoded by B4's twin) and int8 (conv_int8, B3
and B1 launched); with Frei_HRNet_w32_trainable_softmax_hm-pose2dloss_v1's:
one FreiHand_kpt batch through the train step, FreiHand through
Evaluator2D (against the twin) and ``FreiHandDataset.evaluate``; with
VolTriangulation_MHP_v2's (vol, 4 views of 640x480, B=2): a forward on
MHP_mv against its twin-decoded forward, ``Evaluator3D.run`` (one B4
launch a batch) and three Trainer3D steps (one B4 forward and backward
launch each); then a batch of MHP, MHP_kpt, MHP_CPM_kpt, MHP_CPM_mv,
MHP_seq (refused by the 2D step, C23), HandGraph_kpt, FHA_kpt, STB, COCO
(its evaluation with OKS-NMS on the card) and MPII, each loader's images/s
on the host with its YAML's WORKERS threads.

Then the last A8 and A7 modules (``a8_a7_phases``): make_quant_infer's
``pallas_layer1=False`` on the flagship (no launch of the bf16 chain
kernel, the gap to the kernel's layer1 printed); the trained-weights int8
gate of tools/accuracy_gate_full (the flagship trained 300 steps at B=32,
then the shipped int8 paths of the 'branch' and 'exchange' scopes within
0.1 heatmap px of the f32 walk on train and held-out samples; conv_int8,
B3 and B1 launched, no B2); 8 flagship train steps as two K=4
make_train_multistep calls against 8 single steps, and ms/step at K=1 and
4; train steps with the BN statistics levers beside the baseline; and
perf_latency's p50 / p99 at B=8, 32 and 128, flops_of on the flagship and
tsne_visualization's features on the card against the CPU.
Last, this slice's phases (``a11_phases``): A8's three probes through
their ``run()`` at the JAX tools' shapes (B=128), with fewer repeats:
perf_int8_probe (B7 and B6 held to their twins at its four branch shapes
first), perf_quant_e2e and perf_train_profile; serving over a mesh of two
replicas on cuda:0 (``make_quant_infer(mesh=)`` at B=32 against the
unsharded call and the two halves served apart, each replica launching
the path's kernels), ``Evaluator2D(mesh=)`` std and int8 against without;
two gloo ranks sharing cuda:0 training the flagship at full width for 3
float32 sgd steps at 16 a rank (bit-equal ranks, held to one process on
the global batch of 32 within 4x a witness), and one NCCL rank whose
Trainer fits 2 steps.  The launches of each new path go into each
kernel's ``launches_probe_int8``, ``launches_probe_quant``,
``launches_probe_train``, ``launches_sharded`` and ``launches_ddp``.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them.  Prints one line
per phase with its wall seconds, a ``{"kernels": [...]}`` line, the card's
name and power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises.
"""

from __future__ import annotations

import atexit
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from chip_timing import device_busy
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
from hrnet_hand_pose_estimation_tpu_torch.ops.decode import hard_argmax, soft_argmax
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import _build
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import fused_bottleneck as FB
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.conv_int8 import (SiteQ, conv_int8,
                                                                        conv_int8_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import (
    basic_chain_reference, fused_basic_chain, fused_bottleneck_chain, fused_stem_layer1,
    layer1_reference, stem_layer1_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_head_decode import (
    HeadParams, fused_head_decode, fused_head_decode_v2, head_decode_reference,
    head_decode_v1_reference, head_kernel_attributes, head_plan, head_v1_attributes, head_v1_plan)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.gaussian_targets import (
    fused_gaussian_targets, gaussian_targets_reference, targets_plan)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import int8_chain as I8
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.int8_chain import (
    basic_chain_int8_reference, bottleneck_chain_int8_reference, fused_basic_chain_int8,
    fused_bottleneck_chain_int8, prepare_branch_int8)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.softmax_decode import (
    decode_plan, fused_softmax_decode, softmax_decode_reference)
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
_BACKGROUND = []


def background(cmd, **kw) -> subprocess.Popen:
    """A tool's process started beside this one (``subprocess.Popen``); any
    still running when this script exits is killed then."""
    proc = subprocess.Popen(cmd, **kw)
    _BACKGROUND.append(proc)
    return proc


@atexit.register
def _stop_background():
    for proc in _BACKGROUND:
        if proc.poll() is None:
            proc.kill()


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


def layer1_launches(x1, weights, iters):
    """Each of the layer1 chain's four launches on its real input (the
    chain's own intermediate tensors): [{ms, cudnn_ms, bound_ms, bound_by,
    bytes_ms}], cuDNN timing the same folded block (``model.layer1[i]``);
    bytes_ms is the block's input and output over the memory rate, the
    floor of any design with one launch per block."""
    params, flags = weights.layer1
    blocks = FB._split(params, flags)
    plans = FB._bottleneck_plans(tuple(x1.shape), blocks)
    rows, y = [], x1
    for i, (p, plan) in enumerate(zip(blocks, plans)):
        out = FB._launch_bottleneck(y, p, plan)
        ms = time_ms(lambda: FB._launch_bottleneck(y, p, plan), iters)
        lib = time_ms(lambda: weights.model.layer1[i](y.permute(0, 3, 1, 2)), iters)
        b_ms, b_by = layer1_work(y, tuple(p.values()), ("ws" in p,), out)
        rows.append(dict(block=i, cin=y.shape[3], ms=ms, cudnn_ms=lib, bound_ms=b_ms,
                         bound_by=b_by, bytes_ms=nbytes([y, out]) / PEAK_BYTES * 1e3,
                         plan=plan._asdict()))
        y = out
    return rows


def print_launches(label, rows, smi):
    for r in rows:
        print(f"{label} block {r['block']} (Cin {r['cin']}): {r['ms']:.4f} ms, cuDNN "
              f"{r['cudnn_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"bytes floor {r['bytes_ms']:.4f} ms; plan {r['plan']} on {smi}")
    print(f"{label} summed over {len(rows)} launches: {sum(r['ms'] for r in rows):.4f} ms, "
          f"cuDNN {sum(r['cudnn_ms'] for r in rows):.4f} ms, bound "
          f"{sum(r['bound_ms'] for r in rows):.4f} ms, four-launch bytes floor "
          f"{sum(r['bytes_ms'] for r in rows):.4f} ms on {smi}")


def stem_work(x_s2d, stem_flat, y2):
    """Bound of the s2d stem launch: stem1 (K = 48) and stem2 (K = 576);
    x_s2d, y2 and the weights once."""
    b, hs, ws, _ = x_s2d.shape
    flops = 2 * b * hs * ws * 48 * 64 + 2 * b * (hs // 2) * (ws // 2) * 576 * 64
    return bound(flops, 0, nbytes([x_s2d, y2, *stem_flat]))


def stem_launch(x_s2d, weights, xin, iters):
    """The stem launch alone on the s2d image: {max_abs_err, limit, ms,
    cudnn_ms (the served model's folded stem convs), bound_ms, bound_by}."""
    plan = FB.stem_plan(*x_s2d.shape[:3])
    got = FB._launch_stem(x_s2d, weights.stem_flat, plan)
    want = FB._stem_reference(x_s2d, weights.stem_flat)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    limit = 0.02 * max(1.0, want.float().abs().max().item())
    if not err <= limit:
        raise AssertionError(f"stem kernel disagrees with its plain twin: {err} > {limit}")
    b_ms, b_by = stem_work(x_s2d, weights.stem_flat, got)
    return dict(max_abs_err=err, limit=limit, plan=plan._asdict(),
                ms=time_ms(lambda: FB._launch_stem(x_s2d, weights.stem_flat, plan), iters),
                cudnn_ms=time_ms(lambda: stem(weights.model, xin), iters),
                bound_ms=b_ms, bound_by=b_by)


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


def print_head_plan(xs, head, label):
    """The head kernel's launch plan for these branch tensors and its
    compiled registers and spills."""
    n, k = head.w_final.shape
    plan = head_plan(xs[0].shape[0], tuple(tuple(x.shape[1:3]) for x in xs),
                     tuple(x.shape[3] for x in xs), n, k)
    attrs = head_kernel_attributes(plan, xs[0].dtype == torch.int8)
    print(f"head plan {label}: bands {plan.bands} (one cluster per sample) of {plan.band_rows} "
          f"rows, passes of {plan.pass_rows} rows, staged source rows {plan.src_rows}, chunk "
          f"{plan.chunk} columns, slabs of {plan.slab_rows} rows in {plan.stages} stages, "
          f"{plan.smem} B shared memory, grid {plan.grid}; kernel {attrs['registers']} "
          f"registers, {attrs['local_bytes']} B local (spills) per thread")
    return dict(plan._asdict(), **attrs)


def head_shape_checks(dev):
    """The head kernel against its twin on seeded random inputs at the
    shapes its plan splits differently from the flagship's: w48 and w64
    widths, K = 128, a non-square map, bf16 (<= 0.05 px) and int8 inputs
    (<= 0.1 px).  The final conv's weights are drawn at 0.1 on the 64 x 64
    maps and 0.3 on the small one, as in tests/test_torch_cuda.py."""
    scales = tuple(torch.tensor(v, device=dev) for v in (0.011, 0.023, 0.017, 0.029))
    for widths, hw, k, batch in (((48, 96, 192, 384), (64, 64), 21, 4),
                                 ((64, 128, 256, 512), (64, 64), 21, 4),
                                 ((32, 64, 128, 256), (64, 64), 128, 4),
                                 ((32, 64, 128, 256), (20, 36), 21, 4)):
        rng = np.random.default_rng(sum(widths) + k + hw[1])
        n = sum(widths)
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        head = HeadParams(f32(rng.normal(size=(n, n)) * 0.05), f32(rng.normal(size=n) * 0.1),
                          f32(rng.normal(size=(n, k)) * (0.1 if hw == (64, 64) else 0.3)),
                          f32(rng.normal(size=k) * 0.1), f32(np.float32(1.3)))
        shapes = [hw]
        for _ in range(3):
            shapes.append((-(-shapes[-1][0] // 2), -(-shapes[-1][1] // 2)))
        xs = [f32(rng.normal(size=(batch, *sh, c))).to(torch.bfloat16)
              for sh, c in zip(shapes, widths)]
        xq = [torch.from_numpy(rng.integers(-127, 128, size=t.shape).astype(np.int8)).to(dev)
              for t in xs]
        for inputs, sc, limit in ((xs, None, 0.05), (xq, scales, 0.1)):
            got = fused_head_decode_v2(inputs, head, input_scales=sc)
            want = head_decode_reference(inputs, head, input_scales=sc)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            print(f"head widths {widths} map {hw} K={k} B={batch} "
                  f"{'int8' if sc else 'bf16'}: max|kernel - plain| = {err:.5f} px (limit {limit})")
            if not (want.std().item() > 0.5 and err <= limit):
                raise AssertionError(f"head kernel disagrees with its twin at {widths} {hw} K={k}")


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
        per_class = {}
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
            per_class[(h, w, c)] = {"class": f"{h}x{w}x{c}", "chains": count,
                                    "launches": count * (len(p) // 4), "max_abs_err": err,
                                    "ms_b32": count * ms, "library_ms_b32": count * lib,
                                    "bound_ms_b32": count * b_ms, "bound_by": b_by}
            print(f"fused_basic_chain {h}x{w}x{c}, {len(p) // 4} blocks, x{count} chains: "
                  f"max|kernel - plain| {err:.4g} (limit {limit:.4g}); {ms:.4f} ms, plain "
                  f"{plain:.3f} ms, cuDNN bf16 ResLayer {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        chain_entry = dict(
            name="fused_basic_chain", route="cuda",
            source="hrnet_hand_pose_estimation_tpu_torch/csrc/basic_chain.cu",
            replaces="hrnet_hand_pose_estimation_tpu/ops/pallas/fused_bottleneck.py:319",
            max_abs_err=worst, bound_by="operations" if t_ops >= t_bytes else "bytes",
            shape_classes=len(classes), per_class=per_class, **tot)

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
        stem32 = stem_launch(x_s2d, weights, xin, 10)
        print(f"stem launch alone B={CHECK_BATCH}: max|kernel - plain| {stem32['max_abs_err']:.5f} "
              f"(limit {stem32['limit']:.5f}); {stem32['ms']:.4f} ms, cuDNN folded stem "
              f"{stem32['cudnn_ms']:.4f} ms, bound {stem32['bound_ms']:.4f} ms "
              f"({stem32['bound_by']}) on {smi}")
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
            library_ms=time_ms(lambda: model.layer1(stem(model, xin)), 10),
            stem_launch_b32=stem32)
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
        want = {fn.__name__: 0 for fn in COUNTED}
        want.update(fused_head_decode_v2=1, fused_basic_chain=n_blocks,
                    fused_stem_layer1=1 + len(flags))
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
        for key in ("ms_b128", "bound_ms_b128", "library_ms_b128"):
            chain_entry[key] = 0.0
        for key, (count, x, p, name) in sorted(classes.items(), reverse=True):
            row = chain_entry["per_class"][key]
            row["ms_b128"] = count * time_ms(lambda: fused_basic_chain(x, p, len(p) // 4), 5)
            row["bound_ms_b128"] = count * basic_chain_work(x, p)[0]
            row["library_ms_b128"] = count * time_ms(
                lambda: model.get_submodule(name)(x.permute(0, 3, 1, 2)), 5)
            row["share_b128"] = row["bound_ms_b128"] / row["ms_b128"]
            for k in ("ms_b128", "bound_ms_b128", "library_ms_b128"):
                chain_entry[k] += row[k]
            print(f"fused_basic_chain {row['class']} x{count} chains at B={TIME_BATCH}: "
                  f"{row['ms_b128']:.3f} ms, cuDNN bf16 ResLayers {row['library_ms_b128']:.3f} "
                  f"ms, bound {row['bound_ms_b128']:.4f} ms ({row['bound_by']}), share of the "
                  f"bound {row['share_b128']:.4f} on {smi}")
        chain_entry["per_class"] = list(chain_entry["per_class"].values())
        stem_entry["ms_b128"] = time_ms(
            lambda: fused_stem_layer1(x_s2d, weights.stem_flat, params, flags), 10)
        stem_entry["bound_ms_b128"] = stem_layer1_work(x_s2d, weights.stem_flat, params, flags)[0]
        stem_entry["library_ms_b128"] = time_ms(lambda: model.layer1(stem(model, xin)), 10)
        stem128 = stem_launch(x_s2d, weights, xin, 10)
        stem_entry["stem_launch_b128"] = stem128
        print(f"stem launch alone B={TIME_BATCH}: {stem128['ms']:.4f} ms, cuDNN folded stem "
              f"{stem128['cudnn_ms']:.4f} ms, bound {stem128['bound_ms']:.4f} ms "
              f"({stem128['bound_by']}) on {smi}")
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
           fused_basic_chain, fused_stem_layer1, fused_gaussian_targets, fused_softmax_decode,
           fused_basic_chain_int8, fused_head_decode)


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


def cudnn_conv_ms(x, q, stride):
    """cuDNN's bf16 conv of the site's dequantized weights: a yardstick."""
    k = q.kq.shape[1]
    w_bf16 = ((q.kq.permute(0, 3, 1, 2).float() * q.wscale[:, None, None, None])
              .to(torch.bfloat16).contiguous(memory_format=torch.channels_last))
    bias = q.bias.to(torch.bfloat16)
    x_nchw = x.permute(0, 3, 1, 2)
    return time_ms(lambda: torch.nn.functional.conv2d(x_nchw, w_bf16, bias, stride,
                                                      (k - 1) // 2), 10)


def check_conv_classes(classes):
    """conv_int8 vs its twin once per shape class of the main path, with
    times; returns the kernels-line entry (sums over every site)."""
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, int_mm_ms=0.0)
    t_ops = t_bytes = 0.0
    worst, equal, total, int_mm_missing = 0.0, 0, 0, 0
    per_class = {}
    for cls, (count, x, q) in sorted(classes.items()):
        k, stride, relu, cin, cout, h, w = cls
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
        ms = time_ms(lambda: conv_int8(x, q, stride=stride, relu=relu), 10)
        plain = time_ms(lambda: conv_int8_reference(x, q, stride=stride, relu=relu), 1,
                        warmup=0)
        lib = cudnn_conv_ms(x, q, stride)
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
        per_class[cls] = {"class": f"{k}x{k}/s{stride} relu={relu} {cin}->{cout} at {h}x{w}",
                          "sites": count, "bit_equal": eq / got.numel(), "max_abs_err": err,
                          "ms_b32": count * ms, "library_ms_b32": count * lib,
                          "bound_ms_b32": count * b_ms, "bound_by": b_by}
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
                int_mm_sites_missing=int_mm_missing, per_class=per_class, **tot)


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


def int8_layer1_launches(x0, chain, flags, model, iters):
    """Each of the W8A8 layer1 chain's four launches on its real input (the
    chain's own intermediate tensors), as ``layer1_launches`` for the bf16
    chain: [{ms, cudnn_ms, bound_ms, bound_by, bytes_ms}], cuDNN timing the
    same folded bf16 block (``model.layer1[i]``)."""
    blocks = I8._split(chain, flags)
    plans = I8._int8_bottleneck_plans(tuple(x0.shape), blocks)
    rows, y = [], x0
    for i, (p, plan) in enumerate(zip(blocks, plans)):
        kp = I8._kernel_params(p)
        out = I8._launch_bottleneck_int8(y, kp, plan)
        ms = time_ms(lambda: I8._launch_bottleneck_int8(y, kp, plan), iters)
        lib = time_ms(lambda: model.layer1[i](y.permute(0, 3, 1, 2)), iters)
        b_ms, b_by = chain_work(y, tuple(p.values()), ("kqs" in p,))
        rows.append(dict(block=i, cin=y.shape[3], ms=ms, cudnn_ms=lib, bound_ms=b_ms,
                         bound_by=b_by, bytes_ms=nbytes([y, out]) / PEAK_BYTES * 1e3,
                         plan=plan._asdict()))
        y = out
    return rows


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
    want = {fn.__name__: 0 for fn in COUNTED}
    want.update(conv_int8=sites, fused_bottleneck_chain_int8=4, fused_head_decode_v2=1)
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
    and ``new_infer``) and the int8 path.  Appends to ``kernels``; returns
    (int8 infer, qparams, calibration record, state on the card)."""
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
        if not torch.equal(got, want):   # exact by design: int32 sums, the twin's roundings
            raise AssertionError(f"int8 chain not bit-equal to its plain twin: share {share}")
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
        rows = int8_layer1_launches(x0, chain, flags, model, 10)
        print_launches(f"fused_bottleneck_chain_int8 B={CHECK_BATCH}", rows, smi)
        chain_entry.update(per_launch_b32=rows, bytes_floor_ms=sum(r["bytes_ms"] for r in rows))

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
        for cls, (count, x, q) in sorted(classes.items()):
            k, stride, relu, cin, cout, h, w = cls
            t = count * time_ms(lambda: conv_int8(x, q, stride=stride, relu=relu), 10)
            sites_ms += t
            if cin == 64 and h == 128:       # stem2, inside the stem's time
                stem2_ms += t
            row = conv_entry["per_class"][cls]
            row["ms_b128"], row["bound_ms_b128"] = t, count * conv_work(x, q, stride)[0]
            row["library_ms_b128"] = count * cudnn_conv_ms(x, q, stride)
            row["share_b128"] = row["bound_ms_b128"] / t
            print(f"conv_int8 {row['class']} x{count} at B={TIME_BATCH}: {t:.3f} ms, cuDNN "
                  f"bf16 {row['library_ms_b128']:.3f} ms, bound {row['bound_ms_b128']:.4f} ms "
                  f"({row['bound_by']}), share of the bound {row['share_b128']:.4f}")
        conv_entry["per_class"] = list(conv_entry["per_class"].values())
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
        conv_entry["bound_ms_b128"] = sum(r["bound_ms_b128"] for r in conv_entry["per_class"])
        chain_entry["bound_ms_b128"] = chain_work(x0, chain, flags)[0]
        head_entry["bound_ms_b128"] = head_work(xq, weights.head, torch.empty(
            TIME_BATCH, 21, 2, device=dev))[0]
        chain_entry["library_ms_b128"] = time_ms(lambda: model.layer1(x0.permute(0, 3, 1, 2)),
                                                 10)
        rows = int8_layer1_launches(x0, chain, flags, model, 10)
        print_launches(f"fused_bottleneck_chain_int8 B={TIME_BATCH}", rows, smi)
        chain_entry.update(per_launch_b128=rows,
                           bytes_floor_ms_b128=sum(r["bytes_ms"] for r in rows))
        print(f"fused_bottleneck_chain_int8 at B={TIME_BATCH}: {l1_ms:.3f} ms, cuDNN folded "
              f"layer1 {chain_entry['library_ms_b128']:.3f} ms, bound "
              f"{chain_entry['bound_ms_b128']:.4f} ms, four-launch bytes floor "
              f"{chain_entry['bytes_floor_ms_b128']:.4f} ms on {smi}")
        # the per-site yardsticks at B=128: cuDNN's bf16 conv and torch._int_mm
        conv_entry["library_ms_b128"] = sum(r["library_ms_b128"] for r in conv_entry["per_class"])
        imm = [(c, int_mm_ms(x, q, k[1])) for k, (c, x, q) in classes.items()]
        conv_entry["int_mm_ms_b128"] = sum(c * t for c, t in imm if t is not None)
        conv_entry["int_mm_sites_missing_b128"] = sum(c for c, t in imm if t is None)
        print(f"conv_int8 at B={TIME_BATCH}: {sites_ms:.3f} ms over the {sum(c for c, _ in imm)} "
              f"sites; cuDNN bf16 per site {conv_entry['library_ms_b128']:.3f} ms, _int_mm "
              f"{conv_entry['int_mm_ms_b128']:.3f} ms ({conv_entry['int_mm_sites_missing_b128']} "
              f"sites it cannot take) on {smi}")
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
    return infer, qparams, loaded, dstate


# -- the W8A8 BasicBlock branch chains (B6) ----------------------------------

def record_branch_chains(infer, weights, qparams, images):
    """One int8 forward with every stage branch of the walk recorded in
    order: [(mod, branch, n_blocks, x NHWC, the walk's own output NHWC)]."""
    chains, real = [], Q._Walk.branch

    def rec(walk, x, mod, i, n_blocks):
        y = real(walk, x, mod, i, n_blocks)
        chains.append((mod, i, n_blocks, Q._nhwc(x), Q._nhwc(y)))
        return y

    Q._Walk.branch = rec
    try:
        infer(weights, qparams, images)
    finally:
        Q._Walk.branch = real
    return chains


def branch_int8_work(x, params):
    """Bound of a W8A8 BasicBlock chain: two 3x3 convs per block; x, the
    output and the params once."""
    b, h, w, c = x.shape
    ops = (len(params) // 7) * 2 * 2 * b * h * w * 9 * c * c
    return bound(0, 0, 2 * nbytes([x]) + nbytes(params), ops_int8=ops)


def basic_int8_case(dev, c=48, size=64, n_blocks=2):
    """Random params and input of one w48 branch class (C % 32 == 16), with
    scales that keep the int8 intermediate inside +-127."""
    rng = np.random.default_rng(c)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    i8 = lambda: t(rng.integers(-127, 128, size=(9 * c, c)).astype(np.int8))
    scale = lambda s: t((rng.uniform(0.5, 1.5, size=c) * s / np.sqrt(9 * c)).astype(np.float32))
    bias = lambda s: t((rng.normal(size=c) * s).astype(np.float32))
    params = []
    for _ in range(n_blocks):
        params += [t(np.full((1, 1), 11.3, np.float32)), i8(), scale(0.06), bias(5.0), i8(),
                   scale(1.4e-3), bias(0.3)]
    x = t(np.abs(rng.normal(size=(CHECK_BATCH, size, size, c))).astype(np.float32))
    return x.to(torch.bfloat16), tuple(params), n_blocks


def branch_int8_phases(cfg, weights, smi, kernels, infer, qparams, amax, dstate):
    """B6 on the int8 path's own branch inputs at full width: prepare every
    chain from the calibration record, hold the kernel against its twin
    once per shape class (and one w48 class), run all 26 chains with the
    counters zeroed, gate each against the walk's per-site int8 branch, and
    time them at B=32 and B=128.  Appends one entry to ``kernels``."""
    dev = weights.model.conv1.weight.device
    model = weights.model
    n_chains = sum(int(cfg.MODEL.EXTRA[f"STAGE{n}"]["NUM_MODULES"])
                   * int(cfg.MODEL.EXTRA[f"STAGE{n}"]["NUM_BRANCHES"]) for n in (2, 3, 4))
    rest = {k: v for k, v in qparams.items() if k != Q.LAYER1_CHAIN_KEY}

    def res_layer(mod, i):
        """The folded bf16 ResLayer of a branch: stage3_m1, 2 -> stage3.1.branches.2."""
        return model.get_submodule(f"{mod.replace('_m', '.')}.branches.{i}")

    def walk_branch(mod, i, n, x):
        return Q._Walk(model, "quant", rest).branch(x.permute(0, 3, 1, 2), mod, i, n)

    def totals(chains, params, plain: bool):
        """Times summed over the chains (kernel, cuDNN's ResLayer, the walk's
        per-site branch, and with ``plain`` the twin) and their bound, in all
        and per shape class (``per_class``, keyed by "HxWxC")."""
        keys = ("ms", "bound_ms", "library_ms", "walk_ms") + (("plain_ms",) if plain else ())
        tot = dict.fromkeys(keys, 0.0)
        per_class = {}
        t_ops = t_bytes = 0.0
        for (mod, i, n, x, _), p in zip(chains, params):
            x_nchw = x.permute(0, 3, 1, 2)
            row = dict(ms=time_ms(lambda: fused_basic_chain_int8(x, p, n), 5),
                       library_ms=time_ms(lambda: res_layer(mod, i)(x_nchw), 5),
                       walk_ms=time_ms(lambda: walk_branch(mod, i, n, x), 5))
            if plain:
                row["plain_ms"] = time_ms(lambda: basic_chain_int8_reference(x, p, n), 1,
                                          warmup=0)
            row["bound_ms"], b_by = branch_int8_work(x, p)
            t_ops, t_bytes = (t_ops + row["bound_ms"], t_bytes) if b_by == "operations" else (
                t_ops, t_bytes + row["bound_ms"])
            _, h, w, c = x.shape
            cls = per_class.setdefault(f"{h}x{w}x{c}", dict(
                {"class": f"{h}x{w}x{c}", "chains": 0, "launches": 0, "bound_by": b_by},
                **dict.fromkeys(keys, 0.0)))
            cls["chains"] += 1
            cls["launches"] += n
            for k in keys:
                tot[k] += row[k]
                cls[k] += row[k]
        tot["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        tot["per_class"] = per_class
        return tot

    with phase("int8 branch chains"), torch.inference_mode():
        chains = record_branch_chains(infer, weights, qparams, uint8_images(11, CHECK_BATCH, dev))
        if len(chains) != n_chains:
            raise AssertionError(f"recorded {len(chains)} branch chains, want {n_chains}")
        params = [prepare_branch_int8(dstate, amax, mod, i, n) for mod, i, n, _, _ in chains]
        classes = {}
        for (mod, i, n, x, _), p in zip(chains, params):
            classes.setdefault(tuple(x.shape[1:]), [0, x, p, n])[0] += 1
        worst, equal, total = 0.0, 0, 0
        cases = [(f"{h}x{w}x{c}", x, p, n, count)
                 for (h, w, c), (count, x, p, n) in sorted(classes.items(), reverse=True)]
        cases.append(("64x64x48 (w48, random params)", *basic_int8_case(dev), 0))
        for label, x, p, n, count in cases:
            got = fused_basic_chain_int8(x, p, n)
            want = basic_chain_int8_reference(x, p, n)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            limit = 0.02 * max(1.0, want.float().abs().max().item())
            eq = (got == want).sum().item()
            equal, total = equal + eq, total + got.numel()
            print(f"fused_basic_chain_int8 {label}, {n} blocks, x{count} chains: max|kernel - "
                  f"plain| {err:.4g} (limit {limit:.4g}), bit-equal {eq / got.numel():.6f}")
            if not err <= limit:
                raise AssertionError(f"fused_basic_chain_int8 {label}: |kernel - plain| "
                                     f"{err} > {limit}")
            if not torch.equal(got, want):   # exact by design, as the layer1 chain
                raise AssertionError(f"fused_basic_chain_int8 {label}: not bit-equal to its "
                                     f"plain twin, share {eq / got.numel()}")
            worst = max(worst, err)
        print(f"fused_basic_chain_int8 bit-equal share over the {len(cases)} classes: "
              f"{equal / total:.6f} (predicted 1)")

        zero_counters()
        outs = [fused_basic_chain_int8(x, p, n) for (_, _, n, x, _), p in zip(chains, params)]
        torch.cuda.synchronize()
        launches = counters()
        want = {fn.__name__: 0 for fn in COUNTED}
        want["fused_basic_chain_int8"] = sum(n for _, _, n, _, _ in chains)
        print(f"the {len(chains)} int8 branch chains: CUDA launches {launches}")
        if launches != want:
            raise AssertionError(f"branch chain launches {launches}, want {want}")
        gaps = []
        for (mod, i, n, x, y), out in zip(chains, outs):
            scale = y.float().abs().max().item()
            gap = (out.float() - y.float()).abs().max().item() / max(scale, 1e-6)
            gaps.append(gap)
            if not (gap < 0.05 and scale > 0.1) or not torch.isfinite(out).all():
                raise AssertionError(f"{mod}/branch{i}: chain vs the walk's per-site branch "
                                     f"relative gap {gap} (limit 0.05), walk max {scale} (> 0.1)")
        print(f"chain vs the int8 walk's per-site branch, all {len(chains)} chains: relative max "
              f"gap {max(gaps):.5f} (limit 0.05), mean over chains {np.mean(gaps):.5f}; walk max "
              f"|out| >= {min(y.float().abs().max().item() for *_, y in chains):.3f} (> 0.1)")

        entry = dict(name="fused_basic_chain_int8", route="cuda",
                     source="hrnet_hand_pose_estimation_tpu_torch/csrc/basic_int8.cu",
                     replaces="hrnet_hand_pose_estimation_tpu/ops/pallas/int8_chain.py:206",
                     launches=launches["fused_basic_chain_int8"], max_abs_err=worst,
                     bit_equal=equal / total, walk_max_rel_gap=max(gaps),
                     **totals(chains, params, plain=True))
        del chains, outs, classes, cases

    with phase("int8 branch chains timing"), torch.inference_mode():
        chains = record_branch_chains(infer, weights, qparams, uint8_images(12, TIME_BATCH, dev))
        big = totals(chains, params, plain=False)
        entry.update({f"{k}_b{TIME_BATCH}": v for k, v in big.items()})
        b7 = next(k for k in kernels if k["name"] == "fused_basic_chain")
        for b, suffix in ((CHECK_BATCH, ""), (TIME_BATCH, f"_b{TIME_BATCH}")):
            print(f"fused_basic_chain_int8, {entry['launches']} launches over the {n_chains} chains, "
                  f"B={b}: {entry['ms' + suffix]:.3f} ms summed, bound "
                  f"{entry['bound_ms' + suffix]:.4f} ms ({entry['bound_by' + suffix]}); the int8 "
                  f"walk's per-site branches {entry['walk_ms' + suffix]:.3f} ms, cuDNN bf16 folded "
                  f"ResLayers on the same inputs {entry['library_ms' + suffix]:.3f} ms (on the "
                  f"bf16 path's: {b7['library_ms' + suffix]:.3f} ms); B7 (bf16 chain kernel) "
                  f"{b7['ms' + suffix]:.3f} ms, on {smi}")
        print(f"fused_basic_chain_int8 plain twin at B={CHECK_BATCH}: {entry['plain_ms']:.3f} ms")
        b7_class = {r["class"]: r for r in b7["per_class"]}
        for cls, row in entry[f"per_class_b{TIME_BATCH}"].items():
            print(f"fused_basic_chain_int8 {cls} x{row['chains']} chains at B={TIME_BATCH}: "
                  f"{row['ms']:.3f} ms; B7 (bf16 chain kernel) "
                  f"{b7_class[cls]['ms_b128']:.3f} ms, cuDNN bf16 ResLayers "
                  f"{row['library_ms']:.3f} ms, the int8 walk's per-site branches "
                  f"{row['walk_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                  f"share of the bound {row['bound_ms'] / row['ms']:.4f} on {smi}")
            row["b7_ms"] = b7_class[cls]["ms_b128"]
        for key in ("per_class", f"per_class_b{TIME_BATCH}"):
            entry[key] = list(entry[key].values())
        del chains
    kernels.append(entry)


# -- the first version of the fused head (B9) --------------------------------

def record_head_inputs(infer, weights, images):
    """One bf16 forward of ``infer`` with the four NHWC branch tensors it
    hands the head kernel kept."""
    kept, real = [], FI.fused_head_decode_v2

    def rec(xs, params, input_scales=None):
        kept.append(list(xs))
        return real(xs, params, input_scales)

    FI.fused_head_decode_v2 = rec
    try:
        infer(weights, images)
    finally:
        FI.fused_head_decode_v2 = real
    return kept[0]


def head_v1_work(xs, head, out):
    """Bound of v1: the full-resolution head conv and final conv, the
    four-tap upsample (as FMAs at the tensor-core rate, as ``head_work``),
    the softmax in f32; the branches, the output and the weights once."""
    b, h0, w0, c0 = xs[0].shape
    n, k = head.w_final.shape
    hw = h0 * w0
    ctot = sum(x.shape[3] for x in xs)
    mm = 2 * b * hw * (ctot * n + n * k)
    interp = 2 * b * hw * (ctot - c0) * 4
    weights = [head.w_head.to(torch.bfloat16), head.b_head, head.w_final.to(torch.bfloat16),
               head.b_final]
    return bound(mm + interp, 6 * b * k * hw, nbytes([*xs, out, *weights]))


def head_v1_gemm_ms(xs, head):
    """cuBLAS's time for the head GEMM alone (``torch.matmul`` of the
    B*H0*W0 x Ctot feat by w_head, bf16): a yardstick of the dominant work,
    not a port."""
    b, h0, w0, _ = xs[0].shape
    n = head.w_final.shape[0]
    feat = torch.randn(b * h0 * w0, head.w_head.shape[0], device=xs[0].device).to(torch.bfloat16)
    w = head.w_head.to(torch.bfloat16)
    return time_ms(lambda: torch.matmul(feat, w), 10), 2 * b * h0 * w0 * feat.shape[1] * n


V1_CASES = {"w18": (18, 36, 72, 144), "smoke": (8, 16, 32, 64)}


def head_v1_width_checks(dev):
    """C10: v1 at the w18 and smoke model's branch widths (channels that are
    no multiple of 8, a 16x16 map for the smoke model) on seeded random
    inputs, one launch each, within 0.05 px of the twin.  The final conv's
    weights are drawn at 0.1 on the 64x64 map and 0.3 on the small one, as
    in tests/test_torch_cuda.py."""
    rows = []
    for name, widths in V1_CASES.items():
        rng = np.random.default_rng(len(rows) + 60)
        h0, b, k, n = (16 if name == "smoke" else 64), 4, 21, sum(widths)
        xs = [torch.from_numpy(np.abs(rng.normal(size=(b, h0 >> i, h0 >> i, c))).astype(
            np.float32)).to(dev, torch.bfloat16) for i, c in enumerate(widths)]
        f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        head = HeadParams(f(rng.normal(size=(n, n)) * 0.05), f(rng.normal(size=n) * 0.1),
                          f(rng.normal(size=(n, k)) * (0.3 if name == "smoke" else 0.1)),
                          f(rng.normal(size=k) * 0.1), f(np.float32(1.3)))
        zero_counters()
        got = fused_head_decode(xs, head)
        torch.cuda.synchronize()
        launches = counters()["fused_head_decode"]
        want = head_decode_v1_reference(xs, head)
        err = (got - want).abs().max().item()
        plan = head_v1_plan(b, h0, widths, n, k, tuple(x.shape[1] for x in xs[1:]))
        print(f"head v1 at the {name} widths {widths} on a {h0}x{h0} map, B={b}: {launches} "
              f"launch, max|kernel - plain| {err:.5f} px (limit 0.05), spread "
              f"{want.std().item():.3f} px; padded feat {plan.cp} -> Ctot {plan.ctot}, head "
              f"{n} -> {plan.np}, tiles of {64 * plan.warpgroups} px, cluster {plan.cluster}")
        if launches != 1 or not err <= 0.05 or not want.std().item() > 0.5:
            raise AssertionError(f"head v1 at the {name} widths: {launches} launches, {err} px")
        rows.append(dict(name=name, max_abs_err=err))
    return rows


def head_v1_phases(weights, smi, kernels, infer, images):
    """B9 on the default bf16 path's four branch tensors at B=32 and B=128:
    launches, the plan with its registers and spills, the kernel against its
    twin, v1 beside v2, the w18 and smoke widths (C10), the shapes it must
    refuse, times beside cuBLAS's head GEMM.  Appends one entry to
    ``kernels``."""
    dev = images.device
    head = weights.head
    with phase("head v1"), torch.inference_mode():
        xs = record_head_inputs(infer, weights, images)
        zero_counters()
        got = fused_head_decode(xs, head)
        torch.cuda.synchronize()
        launches = counters()
        want = {fn.__name__: 0 for fn in COUNTED}
        want["fused_head_decode"] = 1
        print(f"fused_head_decode (v1) at B={CHECK_BATCH} on the bf16 path's branches "
              f"{[tuple(x.shape[1:]) for x in xs]}: CUDA launches {launches}")
        if launches != want:
            raise AssertionError(f"head v1 launches {launches}, want {want}")
        n, k = head.w_final.shape
        plan = head_v1_plan(xs[0].shape[0], xs[0].shape[1], tuple(x.shape[3] for x in xs), n, k,
                            tuple(x.shape[1] for x in xs[1:]))
        attrs = head_v1_attributes(plan)
        print(f"head v1 plan: tiles of {64 * plan.warpgroups} px ({plan.tiles} per sample), "
              f"cluster {plan.cluster} x {plan.block_tiles} tiles, feat {plan.ctot} in "
              f"{plan.kblocks} K blocks, head {plan.np} in {plan.chunks} chunks of 96, ring of "
              f"{plan.stages} x 12 KB, staged source rows {plan.src_rows}, {plan.smem} B shared "
              f"memory, grid {plan.grid}; kernel "
              f"{attrs['registers']} registers, {attrs['local_bytes']} B local (spills) per thread")
        plain = head_decode_v1_reference(xs, head)
        d = (got - plain).abs()
        spread = plain.std(dim=(0, 1)).min().item()
        print(f"head v1: max|kernel - plain| {d.max().item():.5f} px (limit 0.05), mean "
              f"{d.mean().item():.6f} px; coordinate spread {spread:.3f} px")
        if got.shape != plain.shape or not d.max().item() <= 0.05:
            raise AssertionError(f"head v1 disagrees with its plain twin: {d.max().item()} px")
        v2 = fused_head_decode_v2(xs, head)
        d2 = (got - v2).abs()
        print(f"head v1 vs v2 on the same tensors (information; they round at other places): "
              f"max {d2.max().item():.5f} px, mean {d2.mean().item():.6f} px")
        try:
            fused_head_decode([xs[0], xs[1][:, :, :-1].contiguous(), xs[2], xs[3]], head)
        except ValueError as e:
            print(f"head v1 refuses a non-square branch: {e}")
        else:
            raise AssertionError("head v1 took a non-square branch")
        widths = head_v1_width_checks(dev)
        b_ms, b_by = head_v1_work(xs, head, got)
        gemm_ms, gemm_flop = head_v1_gemm_ms(xs, head)
        entry = dict(name="fused_head_decode", route="cuda",
                     source="hrnet_hand_pose_estimation_tpu_torch/csrc/head_v1.cu",
                     replaces="hrnet_hand_pose_estimation_tpu/ops/pallas/fused_head_decode.py:109",
                     launches=launches["fused_head_decode"], max_abs_err=d.max().item(),
                     ms=time_ms(lambda: fused_head_decode(xs, head), 10),
                     plain_ms=time_ms(lambda: head_decode_v1_reference(xs, head), 2, warmup=1),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None, cublas_gemm_ms=gemm_ms,
                     v2_ms=time_ms(lambda: fused_head_decode_v2(xs, head), 10), plan=plan._asdict(),
                     widths=widths, **attrs)
        del xs, plain
        big = torch.from_numpy(np.random.default_rng(1).normal(
            size=(TIME_BATCH, 256, 256, 3)).astype(np.float32)).to(dev)
        xs = record_head_inputs(infer, weights, big)
        got = fused_head_decode(xs, head)
        err = (got - head_decode_v1_reference(xs, head)).abs().max().item()
        print(f"head v1 at B={TIME_BATCH}: max|kernel - plain| {err:.5f} px (limit 0.05)")
        if not err <= 0.05:
            raise AssertionError(f"head v1 disagrees with its plain twin at B={TIME_BATCH}: {err}")
        entry[f"max_abs_err_b{TIME_BATCH}"] = err
        entry[f"ms_b{TIME_BATCH}"] = time_ms(lambda: fused_head_decode(xs, head), 10)
        entry[f"bound_ms_b{TIME_BATCH}"] = head_v1_work(xs, head, got)[0]
        entry[f"v2_ms_b{TIME_BATCH}"] = time_ms(lambda: fused_head_decode_v2(xs, head), 10)
        entry[f"cublas_gemm_ms_b{TIME_BATCH}"], gemm_flop_big = head_v1_gemm_ms(xs, head)
        for b, suffix, flop in ((CHECK_BATCH, "", gemm_flop),
                                (TIME_BATCH, f"_b{TIME_BATCH}", gemm_flop_big)):
            ms = entry["ms" + suffix]
            print(f"fused_head_decode (v1), 1 launch per call, B={b}: {ms:.3f} ms, bound "
                  f"{entry['bound_ms' + suffix]:.4f} ms ({b_by}), "
                  f"{entry['bound_ms' + suffix] / ms:.1%} of it; v2 {entry['v2_ms' + suffix]:.3f} "
                  f"ms; cuBLAS's head GEMM alone (information, not a port) "
                  f"{entry['cublas_gemm_ms' + suffix]:.3f} ms "
                  f"({flop / entry['cublas_gemm_ms' + suffix] / 1e9:.0f} TFLOP/s); no single "
                  f"PyTorch call computes v1, on {smi}")
        print(f"head v1 plain twin at B={CHECK_BATCH}: {entry['plain_ms']:.3f} ms")
        del xs, big
    kernels.append(entry)


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


def ragged_shape_joints(device, b, k, res):
    """(b, k) joints on a res map with the same edge cases, for the shapes
    whose rows of res * K floats are no multiple of 4."""
    rng = np.random.default_rng((6, b, k, res))
    joints = rng.uniform(0, res, size=(b, k, 2)).astype(np.float32)
    joints[0, 0] = (-0.5, -0.5)
    joints[0, 1] = (res, 10.0)
    joints[-1, 2] = (res + 6.0, res + 16.0)
    joints[-1, 3] = (-3.0, 5.0)
    joints[-1, 4] = (res - 0.01, 0.0)
    vis = np.ones((b, k), np.float32)
    vis[-1, 5] = 0.0
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
        cases = [("B=32", (lambda b: (b["pose2d"], b["visibility"]))(train_batch(20, 32, dev)),
                  res, (sigma,)),
                 ("B=128", (lambda b: (b["pose2d"], b["visibility"]))(train_batch(21, 128, dev)),
                  res, (sigma,)),
                 ("ragged B=3", ragged_joints(dev), res, (1.0, 1.5, 2.0))]
        # rows of res * K % 4 != 0 floats: every band's scalar head and tail;
        # sigma 30 has no room for the exp table (expf per element)
        for b, k, r in ((1, 17, 63), (3, 17, 63), (3, 21, 63), (32, 17, 64)):
            j, v = ragged_shape_joints(dev, b, k, r)
            cases.append((f"ragged B={b} K={k} res={r}", (j, v), r, (1.5, 2.0, 30.0)))
        for label, (joints, vis), r, sigmas in cases:
            for sig in sigmas:
                plan = targets_plan(joints.shape[0], joints.shape[1], r, sig)
                before = fused_gaussian_targets.launches
                got = fused_gaussian_targets(joints, vis, r, sig)
                want = gaussian_targets_reference(joints, vis, r, sig)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                print(f"gaussian targets {label} sigma {sig}: max|kernel - plain| {err:.3g} "
                      f"(limit 1e-6), zeros alike {torch.equal(got == 0, want == 0)}, nonzero "
                      f"{(want > 0).float().mean().item():.4f}; plan {plan._asdict()}")
                if not (err <= 1e-6 and torch.equal(got == 0, want == 0)
                        and fused_gaussian_targets.launches == before + 1):
                    raise AssertionError(f"targets kernel disagrees with its twin: {err}")
                worst = max(worst, err)
        entry = dict(name="fused_gaussian_targets", route="cuda",
                     source="hrnet_hand_pose_estimation_tpu_torch/csrc/gaussian_targets.cu",
                     replaces="hrnet_hand_pose_estimation_tpu/ops/pallas/decode_kernel.py:123",
                     max_abs_err=worst, library_ms=None)
        for b, seed, was in ((32, 20, 0.0241), (128, 21, 0.0329)):
            tb = train_batch(seed, b, dev)
            j, v = tb["pose2d"], tb["visibility"]
            out = fused_gaussian_targets(j, v, res, sigma)
            ms = time_ms(lambda: fused_gaussian_targets(j, v, res, sigma), 50, warmup=5)
            # the kernel's own device time: back-to-back calls are paced by
            # the wrapper's host work when that is longer
            _, kernel_ms, _ = device_busy(lambda: fused_gaussian_targets(j, v, res, sigma), 20)
            plain = time_ms(lambda: gaussian_targets_reference(j, v, res, sigma), 10)
            b_ms, b_by = targets_work(out)
            plan = targets_plan(b, 21, res, sigma)
            suffix = "" if b == 32 else f"_b{b}"
            entry.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain,
                          f"bound_ms{suffix}": b_ms, f"device_ms{suffix}": kernel_ms or None,
                          f"was_ms{suffix}": was, f"rows{suffix}": plan.rows})
            entry["bound_by"] = b_by
            device = (f"{kernel_ms:.4f} ms of kernel (torch.profiler), {b_ms / kernel_ms:.1%} of "
                      f"the bound" if kernel_ms > 0 else "kernel time not measured (the "
                      "profiler recorded no device event)")
            print(f"fused_gaussian_targets B={b} (64x64x21, sigma 2; bands of {plan.rows} rows, "
                  f"{b * plan.bands} blocks, table {plan.table}): {ms:.4f} ms per call (was "
                  f"{was} before the redesign), {device}, plain {plain:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}); no single PyTorch call computes it, on {smi}")
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
    for shape in ((32, 64, 64, 21), (128, 64, 64, 21), (1, 64, 64, 21), (3, 64, 64, 21),
                  (2, 48, 64, 21)):
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
        print(f"softmax decode: {len(decode_cases(dev))} cases (B 32/128/1/3 and 2x48x64, f32 "
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
        for b in (1, EVAL_BATCH, TIME_BATCH):
            base = torch.randn(b, 64, 64, 21, device=dev) * 3
            for dtype in (torch.bfloat16, torch.float32):
                x = base.to(dtype)
                ms = time_ms(lambda: fused_softmax_decode(x, temp), 50, warmup=5)
                plain = time_ms(lambda: softmax_decode_reference(x, temp), 20, warmup=3)
                # the kernel's own device time: back-to-back calls above are
                # paced by the wrapper's host work when that is longer
                _, kernel_ms, _ = device_busy(lambda: fused_softmax_decode(x, temp), steps=20)
                b_ms, b_by = decode_work(x, torch.empty(b, 21, 2, device=dev))
                plan = decode_plan(b, 64, 64, 21, x.element_size())
                # the eval path's logits are bf16 at B=32: the unsuffixed keys
                suffix = ("" if dtype == torch.bfloat16 else "_f32") + (
                    "" if b == EVAL_BATCH else f"_b{b}")
                entry.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain,
                              f"bound_ms{suffix}": b_ms, f"device_ms{suffix}": kernel_ms or None,
                              f"splits{suffix}": plan.splits})
                entry["bound_by"] = b_by
                device = (f"{kernel_ms:.4f} ms of kernel (torch.profiler)" if kernel_ms > 0 else
                          "kernel time not measured (the profiler recorded no device event)")
                share = f", {b_ms / kernel_ms:.1%} of it" if kernel_ms > 0 else ""
                print(f"fused_softmax_decode B={b} (64x64x21 {str(dtype)[6:]}, S={plan.splits} "
                      f"ranges of {plan.range_px} px per sample): {ms:.4f} ms per call, "
                      f"{device}, plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}){share}; no "
                      f"single PyTorch call computes it, on {smi}")

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


# -- the multi-view 3D inference and evaluation path ------------------------

MV_BATCH = 4                # IMAGES_PER_GPU of VolTriangulation_v1.yaml
MV_VIEWS = 4                # DATASET.NUM_VIEWS (the default)
MV_KINDS = ("vol", "alg", "ransac")
# 3D limits of a forward decoded by B4 against the same forward decoded by
# its twin (<= 1e-4 px apart): (mm, relative).  The vol net's bf16 V2V may
# round a few voxels otherwise: one voxel of its 500 mm / 64 cube (3.5 mm
# measured on an H100); alg and ransac scale heatmap coords to the
# nets' 640x480 default where Synthetic_mv's cameras are 256 px wide (as in
# the JAX package), so their random nets' DLTs land up to ~100 m out, where
# a point moves by |x|^2 / (f baseline) per px of its detections
MV_3D_LIMIT = {"vol": (7.8, 1e-3), "alg": (1.0, 1e-2), "ransac": (1.0, 1e-2),
               "dlt": (1.0, 1e-3)}
VOL_YAML = (Path(__file__).resolve().parent / "experiments" / "LearnableTriangulation"
            / "VolTriangulation_v1.yaml")


def mv_cfg(kind: str, out_dir: str = ""):
    """The MODEL section of experiments/LearnableTriangulation/
    VolTriangulation_v1.yaml set in code (the card's machine may lack
    PyYAML): pose_hrnet_volumetric w32 at 256/64, VOLUME_SIZE 64,
    CUBOID_SIZE 500, softmax aggregation, VOLUME_SOFTMAX, VOL_CONFIDENCES
    on, ALG_CONFIDENCES off; the softmax decode on (HEATMAP_SOFTMAX, as the
    VolTriangulation_MHP_v2..v9 configs set it; v1 leaves the default);
    Synthetic_mv at 256/64 in place of MHP_mv, 4 views, B=4, bf16."""
    cfg = load_config(opts=[
        "MODEL.NAME", "pose_hrnet_volumetric", "MODEL.TRIANGULATION_MODEL_NAME", kind,
        "MODEL.HEATMAP_SOFTMAX", True, "MODEL.VOLUME_SIZE", 64, "MODEL.CUBOID_SIZE", 500.0,
        "MODEL.VOLUME_AGGREGATION_METHOD", "softmax", "MODEL.VOLUME_SOFTMAX", True,
        "MODEL.VOL_CONFIDENCES", True, "MODEL.ALG_CONFIDENCES", False, "MODEL.SIGMA", 2,
        "DATASET.DATASET", ["Synthetic_mv"], "DATASET.TEST_DATASET", ["Synthetic_mv"],
        "DATASET.NUM_VIEWS", MV_VIEWS, "TEST.IMAGES_PER_GPU", MV_BATCH, "WORKERS", 4,
        "EXP_NAME", "chip_smoke_eval3d", "OUTPUT_DIR", out_dir], freeze=False)
    cfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
    return cfg.freeze()


def mv_gate(label, kind, got, twin):
    """(2D max |d| in heatmap px, 3D max |d| mm): a forward decoded by B4
    against the same forward decoded by its twin."""
    kp2d, kp3d = got
    t2d, t3d = twin
    scale = 1.0 if kind in ("vol", "dlt") else torch.tensor([640 / 64, 480 / 64], device=kp2d.device)
    d2 = ((kp2d - t2d) / scale).abs().max().item()
    d3 = (kp3d - t3d).abs()
    mm, rel = MV_3D_LIMIT[kind]
    limit3 = mm + rel * t3d.abs()
    print(f"{label}: B4 vs its twin, 2D max |d| {d2:.3g} heatmap px (limit 1e-3), 3D max |d| "
          f"{d3.max().item():.4g} mm (limit {mm} mm + {rel} |x|); 2D spread "
          f"{kp2d.std().item():.3f}, |3D| up to {t3d.abs().max().item():.4g} mm")
    if not (d2 <= 1e-3 and bool((d3 <= limit3).all())):
        raise AssertionError(f"{label}: B4 and its twin part: 2D {d2}, 3D {d3.max().item()}")
    if not (torch.isfinite(kp2d).all() and torch.isfinite(kp3d).all()):
        raise AssertionError(f"{label}: a keypoint is not finite")


def mv_phases(smi, kernels):
    """The multi-view 3D path at full width: the vol, alg and ransac nets
    and the dlt mode, each forward one B4 launch and within the stated
    limits of the same forward decoded by B4's twin; one Evaluator3D.run;
    the evaluate_3d tool; the time of each net and its parts."""
    from hrnet_hand_pose_estimation_tpu_torch.core.evaluator3d import Evaluator3D
    from hrnet_hand_pose_estimation_tpu_torch.models import triangulation as TRI
    from hrnet_hand_pose_estimation_tpu_torch.ops import geometry as GEO
    from hrnet_hand_pose_estimation_tpu_torch.ops import volumetric as VOL
    from hrnet_hand_pose_estimation_tpu_torch.tools import evaluate_3d as tool_eval3d

    dev = torch.device("cuda")
    b4 = next(k for k in kernels if k["name"] == "fused_softmax_decode")
    b4["launches_3d"] = 0
    evs = {}
    tool_dir = tempfile.TemporaryDirectory()
    tool = None
    if importlib.util.find_spec("yaml") is not None:
        # the evaluate_3d tool's process starts here and runs beside the
        # checks of "3D main path"; "3D tools" reads it
        tool = background(
            [sys.executable, "-m", "hrnet_hand_pose_estimation_tpu_torch.tools.evaluate_3d",
             "--cfg", str(VOL_YAML), "--device", "cuda", "--out", tool_dir.name,
             "DATASET.TEST_DATASET", "['Synthetic_mv']", "MODEL.HEATMAP_SOFTMAX", "True",
             "EXP_NAME", "tool3d"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=Path(__file__).resolve().parent)
    with phase("3D main path"), tempfile.TemporaryDirectory() as tmp:
        loader = make_test_dataloader(mv_cfg("vol", tmp))["Synthetic_mv"]
        batch = next(iter(loader))
        orig = tuple(loader.dataset.orig_img_size)
        images = torch.from_numpy(batch["imgs"]).to(dev)
        print(f"Synthetic_mv batch: images {tuple(images.shape)}, orig size {orig}")
        for kind in MV_KINDS + ("dlt",):
            cfg = mv_cfg("alg" if kind == "dlt" else kind, tmp)
            if kind == "dlt":
                model, state = build_model(cfg), init_variables(cfg, 0, device=dev)
            else:
                model = TRI.build_triangulation_net(cfg)
                state = init_variables(cfg, 0, device=dev, net=kind)
            ev = Evaluator3D(cfg, model, state, mode="dlt" if kind == "dlt" else "model",
                             device=dev)
            proj = ev.projections(batch, orig)
            zero_counters()
            with torch.no_grad():
                kp2d, kp3d = ev.forward(images, proj)
                if kind == "dlt":
                    kp3d = GEO.triangulate_batch(kp2d * torch.tensor(
                        [orig[0] / 64, orig[1] / 64], device=dev), proj, method="sii")
            torch.cuda.synchronize()
            launches = counters()
            want = {fn.__name__: 0 for fn in COUNTED}
            want["fused_softmax_decode"] = 1
            print(f"3D {kind} forward B={MV_BATCH} x {MV_VIEWS} views: kp2d "
                  f"{tuple(kp2d.shape)}, kp3d {tuple(kp3d.shape)}, CUDA launches {launches}")
            if launches != want:
                raise AssertionError(f"3D {kind} forward launches {launches}, want {want}")
            b4["launches_3d"] += launches["fused_softmax_decode"]
            with patched(TRI, "softmax_decode", softmax_decode_reference), patched(
                    EV, "softmax_decode", softmax_decode_reference), torch.no_grad():
                t2d, t3d = ev.forward(images, proj)
                if kind == "dlt":
                    t3d = GEO.triangulate_batch(t2d * torch.tensor(
                        [orig[0] / 64, orig[1] / 64], device=dev), proj, method="sii")
            if counters()["fused_softmax_decode"] != 1:
                raise AssertionError("the twin forward launched B4")
            mv_gate(f"3D {kind}", kind, (kp2d, kp3d), (t2d, t3d))
            evs[kind] = (ev, proj)

        ev, _ = evs["vol"]
        loader.dataset.length = 2 * MV_BATCH
        zero_counters()
        results = ev.run(loader, output_dir=tmp)
        torch.cuda.synchronize()
        launched = counters()["fused_softmax_decode"]
        b4["launches_3d"] += launched
        out = Path(tmp) / "eval3D_results_chip_smoke_eval3d"
        shapes = tuple(np.loadtxt(out / f).shape for f in (
            "mse2d_each_joint.txt", "mse3d_each_joint.txt", "PCK2d.txt", "PCK3d.txt"))
        print(f"Evaluator3D vol, {len(loader)} batches of {MV_BATCH} x {MV_VIEWS} views: B4 "
              f"launches {launched}; results {json.dumps(results)}; artifacts {shapes}")
        if launched != len(loader) or not all(np.isfinite(v) for v in results.values()):
            raise AssertionError(f"Evaluator3D: launches {launched}, results {results}")
        if shapes != ((21,), (21,), (2, 49), (2, 50)):
            raise AssertionError(f"eval3D artifacts of shapes {shapes}")

    with phase("3D tools"), tool_dir as tmp:
        if tool is not None:
            out, err = tool.communicate(timeout=300)
            tail = (out + err).strip().splitlines()[-7:]
            print(f"python -m ...tools.evaluate_3d --cfg {VOL_YAML.name} --device cuda "
                  f"(Synthetic_mv, the softmax decode): rc {tool.returncode}; " + " ".join(
                      line.strip() for line in tail))
            if tool.returncode != 0:
                raise AssertionError(f"evaluate_3d failed:\n{out}\n{err}")
            if np.loadtxt(Path(tmp) / "eval3D_results_tool3d" / "PCK3d.txt").shape != (2, 50):
                raise AssertionError("evaluate_3d wrote no PCK3d.txt")
        else:
            print("no PyYAML on this machine: tools.evaluate_3d.evaluate in process on the "
                  "config built in code")
            res = tool_eval3d.evaluate(mv_cfg("vol", tmp), out=tmp, device=dev)
            print(f"tools.evaluate_3d.evaluate: {json.dumps(res)}")
            if not all(np.isfinite(v) for v in res.values()):
                raise AssertionError(f"evaluate_3d results not finite: {res}")

    with phase("3D timing"), torch.no_grad():
        # each net's batch and its parts, CUDA events; parts on the inputs
        # the forward gives them, in the forward's dtypes
        ev, proj = evs["vol"]
        net = ev.model
        cfg = ev.cfg
        b, v = images.shape[:2]
        flat = images.reshape(b * v, *images.shape[2:])

        def head():
            with TS.compute_autocast(cfg, dev):
                return net.backbone.forward_head(flat)

        out = head()
        logits, temp = out.heatmaps, out.temperature
        k = logits.shape[-1]
        kp2d = fused_softmax_decode(logits, temp).reshape(b, v, k, 2)
        side, cuboid = net.volume_size, net.cuboid_size
        zero = torch.zeros(b, device=dev)

        def cube():
            base = GEO.triangulate_eigh(kp2d[:, :, 9], proj)
            return VOL.rotate_coord_volume(VOL.build_coord_volume(base, cuboid, side), zero,
                                           (0, 1, 0), center=base)

        coords = cube()

        def process():
            with net._compute(dev):
                return net.process_features(out.features.to(net.dtype).permute(0, 3, 1, 2))

        feats = process().permute(0, 2, 3, 1)
        feats = feats.reshape(b, v, *feats.shape[1:])
        vols = VOL.unproject_heatmaps(feats, proj, coords, "softmax")

        def v2v():
            with net._compute(dev):
                return net.volume_net(vols.to(net.dtype))

        vout = v2v()
        full = {}
        for kind, (e, p) in evs.items():
            full[kind] = time_ms(lambda: e.forward(images, p), 5, warmup=2)
        # alg / ransac triangulate at the original image's scale
        pts = (kp2d * torch.tensor([640 / 64, 480 / 64], device=dev)).transpose(1, 2)
        prj = proj[:, None].expand(b, k, v, 3, 4)
        pairs = v * (v - 1) // 2
        parts = {
            f"backbone (forward_head, bf16 autocast, B*V={b * v})": time_ms(head, 5),
            "decode (B4)": time_ms(lambda: fused_softmax_decode(logits, temp), 20),
            f"DLT eigh (alg, {b * k} systems)": time_ms(
                lambda: GEO.triangulate_batch(kp2d, proj, method="eigh"), 20),
            "DLT sii (dlt)": time_ms(lambda: GEO.triangulate_batch(kp2d, proj, method="sii"), 20),
            f"RANSAC ({pairs} pairs + the inliers: {(pairs + 1) * b * k} systems)": time_ms(
                lambda: GEO.triangulate_ransac(pts, prj), 20),
            "base point + cube (vol)": time_ms(cube, 20),
            "process_features (1x1 conv to 32)": time_ms(process, 20),
            f"unprojection ({side}^3 x {v} views x {feats.shape[-1]} ch)": time_ms(
                lambda: VOL.unproject_heatmaps(feats, proj, coords, "softmax"), 5),
            "V2V (cuDNN 3D convs, bf16)": time_ms(v2v, 5),
            "3D soft-argmax": time_ms(lambda: VOL.integrate_volumes_with_coordinates(
                vout, coords), 10),
        }
        torch.cuda.reset_peak_memory_stats()
        ev.forward(images, proj)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"3D forward per batch of {MV_BATCH} x {MV_VIEWS} views at 256/64 (ms, CUDA "
              f"events): " + json.dumps({k: round(t, 3) for k, t in full.items()})
              + f"; vol peak memory {peak:.2f} GiB, on {smi}")
        print("3D parts, vol net's inputs (ms, CUDA events, each timed alone): "
              + json.dumps({k: round(t, 4) for k, t in parts.items()}) + f", on {smi}")
        b4["ms_3d"] = parts["decode (B4)"]
        del evs, ev, net, vols, vout


# -- the 3D training path ---------------------------------------------------

T3_VIEWS = 4
T3_VOL_BATCH = 2            # IMAGES_PER_GPU of VolTriangulation_MHP_v2.yaml
T3_ALG_BATCH = 4            # of AlgTriangulation_MHP_v1.yaml
T3_GAN_BATCH = 2            # VolTriangulation_MHP_GAN_v1.yaml has 8: cut to save chip time
T3_STEPS = 3
# B4's backward against its twin: float32 1e-5 of the largest |dx|; bf16
# one bfloat16 ulp of each element (the two round float32 values a few
# ulps apart) plus the same; dT 1e-4 of sum |x g_z| (a sum over B*H*W*K
# terms that cancel)
B4B_LIMIT = {torch.float32: (0.0, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}
B4B_DT_LIMIT = 1e-4
# the float32 step decoded by B4 against the same step decoded by its twin:
# relative differences of the total loss and of each parameter group's
# gradient (norm-wise), and the share of each group's updated parameters
# that differ by more than 1 % of its largest update (adam's first step
# moves each by +-LR, so a gradient whose sign rounding flips moves its
# parameter by 2 LR), held to 3 times those of a witness step decoded by
# the twin moved by B4's forward limit (1e-4 px, alternating in sign), plus
# 1e-5 (loss) or 1e-3 (gradients).  A group whose witness difference
# exceeds 0.1 fails the phase: there the step is chaotic in the decode (a
# DLT landing far out, MV_3D_LIMIT; a nearest voxel of the VCE loss
# flipping), so its limit would say nothing of B4, and every group that is
# compared must be held
T3_WITNESS_PX, T3_WITNESS_FACTOR, T3_CHAOTIC = 1e-4, 3.0, 0.1
T3_FLOOR = {"loss": 1e-5}
T3_GRAD_FLOOR = 1e-3
SMOKE3D_YAML = Path(__file__).resolve().parent / "experiments" / "synthetic_vol_smoke.yaml"
# B4's forward and backward kernels as torch.profiler names them (substrings)
B4_KERNEL_NAMES = ("softmax_decode_kernel", "softmax_decode_bwd_kernel")


def train3d_cfg(kind: str, out_dir: str, batch: int, gan: bool = False, dtype: str = "bfloat16",
                dataset: str = "Synthetic_mv", data_dir: str = ""):
    """The MODEL, LOSS and TRAIN sections of experiments/LearnableTriangulation/
    VolTriangulation_MHP_v2.yaml (kind 'vol'), AlgTriangulation_MHP_v1.yaml
    ('alg') or VolTriangulation_MHP_GAN_v1.yaml (gan) set in code (the
    card's machine may lack PyYAML): pose_hrnet_volumetric w32 at 256/64;
    vol: VOL_CONFIDENCES, TRAINABLE_SOFTMAX, a 64^3 cube of 500 mm, softmax
    aggregation, losses pose2d 0.1 + pose3d 1.0 + VCE 0.01 (GAN: pose3d +
    VCE 0.01, KCS factor 0.01, N_CRITIC 3, CLIP_VALUE 0.01); alg:
    ALG_CONFIDENCES, pose3d only; adam at LR 1e-4 with PROCESS_FEATURE_LR
    and VOLUME_NET_LR 1e-3.  HEATMAP_SOFTMAX on for both (the alg YAML
    leaves the default, an argmax decode that gives its DLT loss no
    gradient; the backbone it names was trained with the softmax head).
    Synthetic_mv with 4 views in place of MHP_mv, unless ``dataset`` (read
    under ``data_dir``) says otherwise."""
    vol = kind == "vol"
    cfg = load_config(opts=[
        "MODEL.NAME", kind, "MODEL.TRIANGULATION_MODEL_NAME", kind,
        "MODEL.BACKBONE_NAME", "pose_hrnet_volumetric", "MODEL.HEATMAP_SOFTMAX", True,
        "MODEL.TRAINABLE_SOFTMAX", vol, "MODEL.VOLUME_SIZE", 64, "MODEL.CUBOID_SIZE", 500.0,
        "MODEL.VOLUME_AGGREGATION_METHOD", "softmax", "MODEL.VOLUME_SOFTMAX", True,
        "MODEL.VOL_CONFIDENCES", vol, "MODEL.ALG_CONFIDENCES", not vol, "MODEL.SIGMA", 2,
        "MODEL.N_CRITIC", 3, "MODEL.CLIP_VALUE", 0.01,
        "LOSS.WITH_HEATMAP_LOSS", False, "LOSS.WITH_POSE2D_LOSS", vol and not gan,
        "LOSS.POSE2D_LOSS_FACTOR", 0.1, "LOSS.WITH_POSE3D_LOSS", True,
        "LOSS.POSE3D_LOSS_FACTOR", 1.0, "LOSS.WITH_VOLUMETRIC_CE_LOSS", vol,
        "LOSS.VOLUMETRIC_LOSS_FACTOR", 0.01, "LOSS.WITH_KCS_LOSS", gan,
        "LOSS.KCS_LOSS_FACTOR", 0.01,
        "TRAIN.OPTIMIZER", "adam", "TRAIN.LR", 1e-4, "TRAIN.PROCESS_FEATURE_LR", 1e-3,
        "TRAIN.VOLUME_NET_LR", 1e-3, "TRAIN.LR_FACTOR", 0.1, "TRAIN.LR_STEP", [8, 16, 24],
        "TRAIN.IMAGES_PER_GPU", batch, "TEST.IMAGES_PER_GPU", batch,
        "DATASET.DATASET", [dataset], "DATASET.TEST_DATASET", [dataset], "DATA_DIR", data_dir,
        "DATASET.NUM_VIEWS", T3_VIEWS, "WORKERS", 4, "PRINT_FREQ", 1,
        "TPU.COMPUTE_DTYPE", dtype, "EXP_NAME", f"chip_smoke_train3d_{kind}",
        "OUTPUT_DIR", out_dir], freeze=False)
    cfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
    return cfg.freeze()


def t3_batches(cfg, dev, n: int, is_train: bool = True):
    from hrnet_hand_pose_estimation_tpu_torch.core.trainer3d import batch_for_step
    from hrnet_hand_pose_estimation_tpu_torch.data.build import make_dataloader
    from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import to_device

    loader = make_dataloader(cfg, is_train)["Synthetic_mv"]
    it = iter(loader)
    return [batch_for_step(to_device(next(it), dev)) for _ in range(n)]


def t3_model(cfg, kind: str, dev, dtype=torch.bfloat16):
    """The net with ``init_variables(cfg, 0, net=kind)``, in train mode on
    the card, with its optimizer, state and step."""
    from hrnet_hand_pose_estimation_tpu_torch.core import trainer3d as T3
    from hrnet_hand_pose_estimation_tpu_torch.models import triangulation as TRI

    net = TRI.build_triangulation_net(cfg, dtype=dtype)
    net.load_state_dict(init_variables(cfg, 0, device=dev, net=kind))
    net.to(dev).train()
    tx = T3.make_optimizer_3d(cfg, net, 1000)
    state = TS.TrainState(net, tx)
    return net, state, T3.make_train_step_3d(cfg, net, tx, (256, 256))


def snapshot(state):
    return (state.params.clone(), {k: v.clone() for k, v in state.opt_state.items()},
            state.stats.clone(), state.counts.clone(), state.step.clone())


def restore(state, snap):
    params, opt, stats, counts, step = snap
    state.params.copy_(params)
    state.opt_state = {k: v.clone() for k, v in opt.items()}
    state.stats.copy_(stats)
    state.counts.copy_(counts)
    state.step = step.clone()


def group_slices(model, state):
    """{label: [(name, slice of the flat buffers)]} by ``freeze_labels``."""
    from hrnet_hand_pose_estimation_tpu_torch.core.trainer3d import freeze_labels

    return name_groups(model, freeze_labels(model).get)


def name_groups(model, label):
    """{label(name): [(name, slice of the flat buffers)]}."""
    out, off = {}, 0
    for name, p in model.named_parameters():
        out.setdefault(label(name), []).append((name, slice(off, off + p.numel())))
        off += p.numel()
    return out


def step_cost(run, decode_names=()):
    """(ms per step by CUDA events, peak GiB, profiler wall ms, kernel ms,
    {decode kernel: ms per step})."""
    ms = time_ms(run, 5, warmup=2)
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wall, busy, top = device_busy(run, steps=3)
    parts = {k: sum(t for n, t in top if k in n) for k in decode_names}
    return ms, peak, wall, busy, parts


def decode_moved(logits, temperature):
    """The witness decode: the twin's, each coordinate moved by
    ``T3_WITNESS_PX`` with alternating sign."""
    out = softmax_decode_reference(logits, temperature)
    sign = 1.0 - 2.0 * (torch.arange(out.numel(), device=out.device) % 2).to(out.dtype)
    return out + T3_WITNESS_PX * sign.reshape(out.shape)


def grads_vs_twin(label, state, step, batch, gen_state, groups, module=None):
    """One float32 step decoded by B4, by its twin and by the witness
    (``decode_moved``), from the same state and generator state: the B4
    step's total loss and each group's gradient against the twin step's,
    held as ``T3_WITNESS_*`` say.  The decode is ``module.softmax_decode``
    (the triangulation nets' by default); with ``gen_state`` None the step
    is ``step(state, batch)``.  Returns (differences, limits held)."""
    from hrnet_hand_pose_estimation_tpu_torch.models import triangulation as TRI

    module = TRI if module is None else module
    snap = snapshot(state)
    gen = torch.Generator(device=state.params.device)
    runs = {}
    for name, decode, want in (("kernel", module.softmax_decode, (1, 1)),
                               ("twin", softmax_decode_reference, (0, 0)),
                               ("witness", decode_moved, (0, 0))):
        restore(state, snap)
        args = (state, batch)
        if gen_state is not None:
            gen.set_state(gen_state)
            args += (gen,)
        with patched(module, "softmax_decode", decode):
            zero_counters()
            fused_softmax_decode.launches_bwd = 0
            _, losses = step(*args)
            torch.cuda.synchronize()
        launched = (fused_softmax_decode.launches, fused_softmax_decode.launches_bwd)
        if launched != want:
            raise AssertionError(f"{label}: B4 launches {launched} in the {name} step")
        runs[name] = (state.grads.clone(), float(losses["total_loss"]), state.params.clone())
    restore(state, snap)
    gt, lt, pt = runs["twin"]
    moved = pt - snap[0]

    def rel(name):
        """Relative differences from the twin step: the loss, each group's
        gradient (norm-wise) and, as ``<group> params``, the share of its
        parameters whose update differs by more than 1 % of the group's
        largest update."""
        g, loss, prm = runs[name]
        out = {"loss": abs(loss - lt) / abs(lt)}
        for group, items in groups.items():
            if group != "frozen":
                idx = torch.cat([torch.arange(s.start, s.stop, device=g.device)
                                 for _, s in items])
                out[group] = ((g[idx] - gt[idx]).norm() / gt[idx].norm().clamp_min(1e-30)).item()
                step = moved[idx].abs().max()
                out[f"{group} params"] = ((prm[idx] - pt[idx]).abs() > 0.01 * step).float().mean(
                    ).item()
        return out

    got, wit = rel("kernel"), rel("witness")
    fmt = lambda d: json.dumps({k: float(f"{v:.3g}") for k, v in d.items()})
    held = {k: T3_WITNESS_FACTOR * wit[k] + T3_FLOOR.get(k, T3_GRAD_FLOOR) for k in got}
    print(f"{label}: float32 step decoded by B4 vs by its twin, same state and cuboid angle, "
          f"relative differences {fmt(got)}; the witness's (the twin moved by "
          f"{T3_WITNESS_PX} px) {fmt(wit)}; held to {fmt(held)}")
    chaotic = sorted(k for k in groups if k != "frozen" and wit[k] > T3_CHAOTIC)
    if chaotic:
        raise AssertionError(f"{label}: groups {chaotic} are chaotic in the decode (witness "
                             f"gradient > {T3_CHAOTIC}): the check says nothing of them")
    if not all(got[k] <= held[k] for k in held):
        raise AssertionError(f"{label}: B4 step and twin step part: {got}, limits {held}")
    return got, held


def decode_bwd_work(x):
    """Bound of B4's backward: the logits read once and dx written once (the
    (B, K, 2) state, coordinates and gradient are noise); ~12 float32
    operations per logit (the exp, the normalisation, the two
    coordinates' terms, dx and the dT product)."""
    return bound(0, 12 * x.numel(), 2 * nbytes([x]))


def train3d_phases(smi, kernels):
    """B4's backward kernel against its twin and timed; the vol and alg nets'
    3D train step at full width (one B4 forward and one backward launch per
    step, frozen groups unchanged, the step against the twin-decoded step);
    the WGAN trainer; the steps' time; the train3d tool."""
    from hrnet_hand_pose_estimation_tpu_torch.core.trainer3d import Trainer3D
    from hrnet_hand_pose_estimation_tpu_torch.core.trainer3d_gan import TrainerGAN3D
    from hrnet_hand_pose_estimation_tpu_torch.models import triangulation as TRI
    from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import softmax_decode as SD

    dev = torch.device("cuda")
    b4 = next(k for k in kernels if k["name"] == "fused_softmax_decode")
    entry = dict(name="softmax_decode_backward", route="cuda",
                 source="hrnet_hand_pose_estimation_tpu_torch/csrc/softmax_decode.cu",
                 replaces="hrnet_hand_pose_estimation_tpu/ops/pallas/decode_kernel.py:69",
                 note="B4's backward: the TPU kernel has no VJP (JAX differentiates its plain "
                      "decode); the port's 3D train step decodes through B4",
                 library_ms=None, launches=0)
    with phase("3D train kernel checks"):
        gen = torch.Generator(device=dev).manual_seed(7)
        worst_dx, worst_dt = 0.0, 0.0
        # offset 1: the logits a contiguous view one element into a larger
        # buffer, not 16-byte aligned (the wrapper copies them for the kernel)
        for b, h, w, k, dtype, tensor_temp, offset in (
                (8, 64, 64, 21, torch.bfloat16, True, 0),
                (8, 64, 64, 21, torch.float32, True, 0),
                (3, 48, 40, 17, torch.float32, False, 0),
                (3, 48, 40, 17, torch.bfloat16, False, 0),
                (3, 48, 40, 17, torch.bfloat16, True, 1),
                (3, 48, 40, 17, torch.float32, False, 1)):
            x = (torch.randn(b, h, w, k, device=dev, generator=gen) * 3).to(dtype)
            g = torch.randn(b, k, 2, device=dev, generator=gen)
            temp = torch.tensor(1.7, device=dev, requires_grad=True) if tensor_temp else 1.7

            def grads():
                if offset:
                    buf = torch.cat([x.new_zeros(offset), x.flatten()]).requires_grad_(True)
                    xr = buf[offset:].view(x.shape)
                    if xr.data_ptr() % 16 == 0:
                        raise AssertionError("the offset view is 16-byte aligned")
                else:
                    xr = x.clone().requires_grad_(True)
                inputs = (xr, temp) if tensor_temp else (xr,)
                return torch.autograd.grad(fused_softmax_decode(xr, temp), inputs, g)

            got, again = grads(), grads()
            tv = temp.detach() if tensor_temp else temp
            dx_t, dt_t = SD.softmax_decode_backward_reference(
                x, tv, SD.softmax_decode_stats_reference(x, tv), g)
            torch.cuda.synchronize()
            ulp, rel = B4B_LIMIT[dtype]
            err = (got[0].float() - dx_t.float()).abs()
            lim = ulp * dx_t.float().abs() + rel * dx_t.float().abs().max()
            ratio = (err / lim.clamp_min(1e-30)).max().item()
            worst_dx = max(worst_dx, err.max().item())
            equal = all(torch.equal(a, c) for a, c in zip(got, again))
            msg = (f"B4 backward {b}x{h}x{w}x{k} {str(dtype)[6:]} T "
                   f"{'tensor' if tensor_temp else 'float'}"
                   f"{', logits misaligned' if offset else ''}: max|dx - twin| "
                   f"{err.max().item():.3g}"
                   f" ({ratio:.3g} of the limit {ulp:g} |dx| + {rel:g} max|dx|)")
            if tensor_temp:
                scale = (x.float() * (dx_t.float() / 1.7)).abs().sum().item()
                dterr = abs(got[1].item() - dt_t.item()) / scale
                worst_dt = max(worst_dt, dterr)
                msg += (f", dT {got[1].item():.6g} vs {dt_t.item():.6g} ({dterr:.3g} of sum "
                        f"|x g_z|, limit {B4B_DT_LIMIT})")
                if not dterr <= B4B_DT_LIMIT:
                    raise AssertionError(msg)
            print(msg + f"; two runs bit-equal: {equal}")
            if not ratio <= 1.0 or not equal:
                raise AssertionError(msg)
        entry["max_abs_err"] = worst_dx
        entry["dtemp_rel_err"] = worst_dt
        temp = torch.tensor(1.7, device=dev)
        for b in (8, TIME_BATCH):
            x = (torch.randn(b, 64, 64, 21, device=dev, generator=gen) * 3).to(torch.bfloat16)
            g = torch.randn(b, 21, 2, device=dev, generator=gen)
            stats = torch.empty(b, 21, 2, device=dev)
            coords = SD._launch_forward(x, temp, stats)
            call = lambda: SD._launch_backward(x, temp, stats, coords, g, True)
            ms = time_ms(call, 50, warmup=5)
            plain = time_ms(lambda: SD.softmax_decode_backward_reference(x, temp, stats, g), 10)
            _, dev_ms, _ = device_busy(call, steps=20)
            b_ms, b_by = decode_bwd_work(x)
            suffix = "" if b == 8 else f"_b{b}"
            entry.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain, f"bound_ms{suffix}": b_ms,
                          f"device_ms{suffix}": dev_ms or None})
            entry["bound_by"] = b_by
            share = f", bound {b_ms / dev_ms:.1%} of it" if dev_ms > 0 else ""
            print(f"softmax_decode_backward B={b} (64x64x21 bf16, {SD.decode_bwd_blocks(x.numel(), 2)}"
                  f" blocks, with dT): {ms:.4f} ms per call, "
                  + (f"{dev_ms:.4f} ms of kernel (torch.profiler)" if dev_ms > 0 else
                     "kernel time not measured (no device event)")
                  + f", plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}){share}; no single "
                  f"PyTorch call computes it, on {smi}")

    runs = {}
    # the train3d tool's process starts here and runs beside the check
    # phases below; "train3d tool" reads it
    tool_dir = tempfile.TemporaryDirectory()
    tool_overrides = ["MODEL.VOLUME_SIZE", "32", "TRAIN.IMAGES_PER_GPU", "8",
                      "TEST.IMAGES_PER_GPU", "8", "OUTPUT_DIR", tool_dir.name]
    tool = None
    if importlib.util.find_spec("yaml") is not None:
        tool = background([sys.executable, "-m",
                           "hrnet_hand_pose_estimation_tpu_torch.tools.train3d", "--cfg",
                           str(SMOKE3D_YAML), "--device", "cuda", *tool_overrides],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          cwd=Path(__file__).resolve().parent)
    with phase("3D train main path (vol)"), tempfile.TemporaryDirectory() as tmp:
        cfg = train3d_cfg("vol", tmp, T3_VOL_BATCH)
        net = TRI.build_triangulation_net(cfg)
        from hrnet_hand_pose_estimation_tpu_torch.data.build import make_dataloader

        loaders = make_dataloader(cfg, True)
        vals = make_dataloader(cfg, False)
        vals["Synthetic_mv"].dataset.length = 2 * T3_VOL_BATCH
        trainer = Trainer3D(cfg, net, loaders, vals, output_dir=tmp, device=dev)
        net.load_state_dict(init_variables(cfg, 0, device=dev, net="vol"))
        state = trainer.state
        groups = group_slices(net, state)
        batches = t3_batches(cfg, dev, T3_STEPS)
        before = state.params.clone()
        for i, batch in enumerate(batches):
            zero_counters()
            fused_softmax_decode.launches_bwd = 0
            trainer.state, losses = trainer.train_step(state, batch, trainer.generator)
            torch.cuda.synchronize()
            launched = counters()
            want = {fn.__name__: 0 for fn in COUNTED}
            want["fused_softmax_decode"] = 1
            host = {k: round(float(v), 5) for k, v in losses.items()}
            print(f"3D train vol step {i} (B={T3_VOL_BATCH} x {T3_VIEWS} views, bf16): {host}; "
                  f"launches {launched}, B4 backward {fused_softmax_decode.launches_bwd}")
            if launched != want or fused_softmax_decode.launches_bwd != 1:
                raise AssertionError(f"vol step launches {launched}, "
                                     f"backward {fused_softmax_decode.launches_bwd}")
            if not all(np.isfinite(v) for v in host.values()) or host["nonfinite_grads"]:
                raise AssertionError(f"vol step losses {host}")
            entry["launches"] += 1
            b4["launches_train3d"] = b4.get("launches_train3d", 0) + 1
        moved = {}
        for group, items in groups.items():
            moved[group] = sum(not torch.equal(state.params[s], before[s]) for _, s in items)
            if group == "frozen" and moved[group]:
                raise AssertionError(f"{moved[group]} frozen parameters moved")
            if group != "frozen" and not moved[group]:
                raise AssertionError(f"no parameter of group {group} moved")
        print(f"vol after {T3_STEPS} steps: tensors moved per group {json.dumps(moved)} of "
              + json.dumps({g: len(v) for g, v in groups.items()}))
        zero_counters()
        fused_softmax_decode.launches_bwd = 0
        val = trainer.validate(0)
        torch.cuda.synchronize()
        n_val = len(vals["Synthetic_mv"])
        print(f"vol validate: {json.dumps(val)}; {n_val} batches, B4 forward launches "
              f"{fused_softmax_decode.launches}, backward {fused_softmax_decode.launches_bwd}")
        if (fused_softmax_decode.launches, fused_softmax_decode.launches_bwd) != (n_val, 0) \
                or not np.isfinite(val["epe3d_mm"]):
            raise AssertionError(f"vol validate: {val}")
        b4["launches_train3d"] += n_val
        runs["vol"] = (cfg, trainer.train_step, state, batches[0], trainer.generator)
        # the step against the twin-decoded step, float32 (TF32 off, cuDNN deterministic)
        torch.backends.cudnn.deterministic = True
        try:
            cfg32 = train3d_cfg("vol", tmp, T3_VOL_BATCH, dtype="float32")
            net32, st32, step32 = t3_model(cfg32, "vol", dev, torch.float32)
            grads_vs_twin("3D train vol", st32, step32, batches[0],
                          torch.Generator(device=dev).manual_seed(3).get_state(),
                          group_slices(net32, st32))
            del net32, st32, step32
        finally:
            torch.backends.cudnn.deterministic = False
        entry["launches"] += 1          # the kernel step of the comparison
        b4["launches_train3d"] += 1

    with phase("3D train main path (alg)"), tempfile.TemporaryDirectory() as tmp:
        cfg = train3d_cfg("alg", tmp, T3_ALG_BATCH)
        net, state, step = t3_model(cfg, "alg", dev)
        batches = t3_batches(cfg, dev, 1)
        zero_counters()
        fused_softmax_decode.launches_bwd = 0
        _, losses = step(state, batches[0], None)
        torch.cuda.synchronize()
        if (fused_softmax_decode.launches, fused_softmax_decode.launches_bwd) != (1, 1):
            raise AssertionError("alg step: not one B4 forward and one backward launch")
        entry["launches"] += 1
        b4["launches_train3d"] += 1
        named = dict(zip(state.param_names, torch.split(
            state.grads, [p.numel() for p in net.parameters()])))
        norms = {}
        for prefix in ("backbone.stage4.", "backbone.last_layer."):
            g = torch.cat([v for n, v in named.items() if n.startswith(prefix)])
            norms[prefix[:-1]] = g.norm().item()
            if not (torch.isfinite(g).all() and g.abs().max() > 0):
                raise AssertionError(f"alg step: gradient of {prefix} zero or not finite")
        print(f"3D train alg step (B={T3_ALG_BATCH} x {T3_VIEWS} views, bf16, pose3d loss "
              f"only): {json.dumps({k: round(float(v), 4) for k, v in losses.items()})}; "
              f"gradient norms {json.dumps(norms)}")
        runs["alg"] = (cfg, step, state, batches[0], None)
        torch.backends.cudnn.deterministic = True
        try:
            cfg32 = train3d_cfg("alg", tmp, T3_ALG_BATCH, dtype="float32")
            net32, st32, step32 = t3_model(cfg32, "alg", dev, torch.float32)
            grads_vs_twin("3D train alg", st32, step32, batches[0],
                          torch.Generator(device=dev).get_state(),
                          {"stage4 + last_layer": [
                              (n, s) for n, s in group_slices(net32, st32)["main"]
                              if n.startswith(("backbone.stage4.", "backbone.last_layer."))]})
            del net32, st32, step32
        finally:
            torch.backends.cudnn.deterministic = False
        entry["launches"] += 1
        b4["launches_train3d"] += 1

    with phase("3D GAN"), tempfile.TemporaryDirectory() as tmp:
        from hrnet_hand_pose_estimation_tpu_torch.data.build import make_dataloader

        cfg = train3d_cfg("vol", tmp, T3_GAN_BATCH, gan=True)
        net = TRI.build_triangulation_net(cfg)
        trainer = TrainerGAN3D(cfg, net, make_dataloader(cfg, True), {}, output_dir=tmp,
                               device=dev)
        net.load_state_dict(init_variables(cfg, 0, device=dev, net="vol"))
        moved = {"critic": [], "base": [], "adv": []}

        def watched(name, fn, state_of):
            def call(*args):
                st = state_of(args)
                before = st.stats.clone()
                out = fn(*args)
                moved[name].append(not torch.equal(st.stats, before))
                return out
            return call

        trainer._critic_step = watched("critic", trainer._critic_step, lambda a: a[1])
        trainer._base_step = watched("base", trainer._base_step, lambda a: a[0])
        trainer._gen_adv_step = watched("adv", trainer._gen_adv_step, lambda a: a[0])
        from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import to_device

        it = iter(trainer.train_loaders["Synthetic_mv"])
        for i in range(2):
            losses = trainer.train_batch(to_device(next(it), dev))
            host = {k: round(float(v), 5) for k, v in losses.items()}
            print(f"3D GAN batch {i} (vol, B={T3_GAN_BATCH} x {T3_VIEWS} views, N_CRITIC 3): "
                  f"{host}")
            if not all(np.isfinite(v) for v in host.values()):
                raise AssertionError(f"GAN losses {host}")
        top = max(p.detach().abs().max().item() for p in trainer.critic.parameters())
        print(f"critic weights max |w| {top:.6g} (clip 0.01); running statistics moved by the "
              f"critic steps {moved['critic']}, base steps {moved['base']}, adversarial steps "
              f"{moved['adv']}")
        if top > 0.01 or any(moved["critic"]) or any(moved["adv"]) or not all(moved["base"]):
            raise AssertionError("GAN: a critic weight outside the clip, or the running "
                                 "statistics moved outside the base step")
        del trainer, net

    with phase("3D train timing"):
        for kind, (cfg, step, state, batch, gen) in runs.items():
            ms, peak, wall, busy, parts = step_cost(
                lambda: step(state, batch, gen), B4_KERNEL_NAMES)
            fwd, bwd = (parts[k] for k in B4_KERNEL_NAMES)
            bsz = T3_VOL_BATCH if kind == "vol" else T3_ALG_BATCH
            print(f"3D train {kind} step B={bsz} x {T3_VIEWS} views at 256/64 (bf16): {ms:.3f} ms "
                  f"per step (CUDA events), peak memory {peak:.2f} GiB; profiler: wall "
                  f"{wall:.3f} ms, kernels {busy:.3f} ms ({busy / wall:.1%} busy); B4 forward "
                  f"{fwd:.4f} ms + backward {bwd:.4f} ms of kernel per step "
                  f"({(fwd + bwd) / max(busy, 1e-9):.2%} of the device time), on {smi}")
            entry[f"step_ms_{kind}"] = ms
            entry[f"device_ms_in_step_{kind}"] = bwd
            b4[f"device_ms_in_train_step_{kind}"] = fwd
        del runs

    with phase("train3d tool"), tool_dir as tmp:
        if tool is not None:
            log, _ = tool.communicate(timeout=300)
            lines = [ln for ln in log.splitlines() if "Epoch[" in ln or "Validate3D" in ln]
            print(f"python -m ...tools.train3d --cfg {SMOKE3D_YAML.name} --device cuda "
                  f"{' '.join(tool_overrides[:6])}: rc {tool.returncode}; " + " | ".join(
                      ln.split(" ", 2)[-1][:140] for ln in lines[-3:]))
            if tool.returncode != 0 or "Validate3D[0]" not in log:
                raise AssertionError(f"train3d failed:\n{log[-3000:]}")
        else:
            from hrnet_hand_pose_estimation_tpu_torch.tools import train3d as tool_train3d

            print("no PyYAML on this machine: tools.train3d.train in process on "
                  "synthetic_vol_smoke.yaml's tree built in code")
            cfg = load_config(opts=[
                "EXP_NAME", "synthetic_vol_smoke", "MODEL.NAME", "vol",
                "MODEL.TRIANGULATION_MODEL_NAME", "vol", "MODEL.IMAGE_SIZE", [64, 64],
                "MODEL.HEATMAP_SIZE", [16, 16], "MODEL.HEATMAP_SOFTMAX", True,
                "MODEL.VOLUME_SIZE", 32, "MODEL.CUBOID_SIZE", 400.0,
                "MODEL.VOLUME_AGGREGATION_METHOD", "softmax", "DATASET.NUM_VIEWS", 2,
                "DATASET.DATASET", ["Synthetic_mv"], "DATASET.TEST_DATASET", ["Synthetic_mv"],
                "LOSS.WITH_HEATMAP_LOSS", False, "LOSS.WITH_POSE2D_LOSS", True,
                "LOSS.WITH_POSE3D_LOSS", True, "LOSS.WITH_VOLUMETRIC_CE_LOSS", True,
                "TRAIN.IMAGES_PER_GPU", 8, "TEST.IMAGES_PER_GPU", 8, "TRAIN.BEGIN_EPOCH", 0,
                "TRAIN.END_EPOCH", 1, "TRAIN.LR", 1e-3, "TRAIN.LR_STEP", [1], "WORKERS", 2,
                "OUTPUT_DIR", tmp], freeze=False)
            stage = lambda n: dict(NUM_MODULES=1, NUM_BRANCHES=n, BLOCK="BASIC",
                                   NUM_BLOCKS=[1] * n, NUM_CHANNELS=list(SMOKE_WIDTHS[:n]),
                                   FUSE_METHOD="SUM")
            cfg.MODEL.EXTRA.merge_from_mapping(dict(FINAL_CONV_KERNEL=1, STAGE2=stage(2),
                                                    STAGE3=stage(3), STAGE4=stage(4)))
            trainer = tool_train3d.train(cfg.freeze(), dev, output_dir=tmp)
            print(f"tools.train3d.train: {trainer.ckpt.epochs()} epochs checkpointed, "
                  f"best {trainer.best_loss:.4g} mm")
    kernels.append(entry)


# -- A10, first part: CPM, the cross-view fusion net and vol_CPM -------------

# CPM's belief maps are the input / 8: at 256 they are 32x32, where
# MHP_CPM_v1.yaml and VolTriangulation_MHP_CPM_v1.yaml set HEATMAP_SIZE 64,
# on which the JAX package's steps fail (ROADMAP C14).  The card runs 256/32.
CPM_IMAGE, CPM_HM = 256, 32
CPM_BATCH = 8               # MHP_CPM_v1 trains at 1 and v2 at 32 images a card
CPM_STEPS = 10
# the steps that must lower the loss run at LR 1e-5: from a random init,
# adam at the YAML's 1e-3 throws the six-stage CPM's loss from 66 to 1e18
# on its second step and leaves its ReLUs dead (measured on an H100); three
# steps at 1e-3 are reported beside them
CPM_CHECK_LR = 1e-5
CPM_YAML = Path(__file__).resolve().parent / "experiments" / "synthetic_cpm_smoke.yaml"
FUSION_VIEWS, FUSION_BATCH, FUSION_STEPS = 4, 1, 3     # MHP_HRNet_w48_fusion_v1
VOLCPM_BATCH = 2            # VolTriangulation_MHP_CPM_v1.yaml has 8: cut to save chip time
CPM_TOOL_BATCH = 16         # the CPM smoke YAML's 4 a batch cut to 16: 4 steps, not 16
# the card's float32 CPM forward against the CPU's, relative to the largest
# belief; the bf16 forward against the card's float32 one (27 bf16 convs in
# a row, no normalisation: a few % of the largest value)
CPM_F32_LIMIT, CPM_BF16_LIMIT = 1e-4, 0.05


def cpm_cfg(out_dir: str, **extra):
    """The MODEL, LOSS and TRAIN sections of experiments/MHP/MHP_CPM_v1.yaml
    set in code (the card's machine may lack PyYAML): CPM at 256, heatmap
    loss only, adam at LR 1e-3 (LR_FACTOR 0.5 at epochs 8/16/24), no flip
    test; HEATMAP_SIZE 32 (C14), B=8, the synthetic set in place of
    MHP_CPM_kpt, bf16."""
    opts = ["MODEL.NAME", "CPM", "MODEL.NUM_JOINTS", 21, "MODEL.IMAGE_SIZE", [CPM_IMAGE] * 2,
            "MODEL.HEATMAP_SIZE", [CPM_HM] * 2, "MODEL.SIGMA", 2, "MODEL.HEATMAP_SOFTMAX", False,
            "LOSS.WITH_HEATMAP_LOSS", True, "LOSS.HEATMAP_LOSS_FACTOR", 1.0,
            "LOSS.WITH_POSE2D_LOSS", False, "TRAIN.OPTIMIZER", "adam", "TRAIN.LR", 1e-3,
            "TRAIN.LR_FACTOR", 0.5, "TRAIN.LR_STEP", [8, 16, 24], "TRAIN.IMAGES_PER_GPU",
            CPM_BATCH, "TEST.IMAGES_PER_GPU", CPM_BATCH, "TEST.FLIP_TEST", False,
            "DATASET.DATASET", ["Synthetic_kpt"], "DATASET.TEST_DATASET", ["Synthetic_kpt"],
            "WORKERS", 4, "PRINT_FREQ", 1, "EXP_NAME", "chip_smoke_cpm", "OUTPUT_DIR", out_dir]
    for key, val in extra.items():
        opts += [key, val]
    return load_config(opts=opts)


def w48_extra():
    extra = json.loads(json.dumps(POSE_HIGH_RESOLUTION_NET_EXTRA))
    for stage in ("STAGE2", "STAGE3", "STAGE4"):
        extra[stage]["NUM_CHANNELS"] = [c * 3 // 2 for c in extra[stage]["NUM_CHANNELS"]]
    return extra


def fusion_cfg(out_dir: str, dtype: str = "bfloat16"):
    """The MODEL, LOSS and TRAIN sections of experiments/MHP/
    MHP_HRNet_w48_fusion_v1.yaml set in code: multiview_pose_hrnet on the
    w48 HRNet at 256/64, 4 views, the aggregation on, HEATMAP_SOFTMAX and
    TRAINABLE_SOFTMAX on, the pose2d loss (factor 0.1) on the raw and the
    fused maps, adam at LR 1e-3, B=1; Synthetic_mv in place of MHP_mv."""
    cfg = load_config(opts=[
        "MODEL.NAME", "multiview_pose_hrnet", "MODEL.IMAGE_SIZE", [256, 256],
        "MODEL.HEATMAP_SIZE", [64, 64], "MODEL.SIGMA", 2, "MODEL.HEATMAP_SOFTMAX", True,
        "MODEL.TRAINABLE_SOFTMAX", True, "MODEL.AGGRE", True, "DATASET.NUM_VIEWS", FUSION_VIEWS,
        "DATASET.DATASET", ["Synthetic_mv"], "DATASET.TEST_DATASET", ["Synthetic_mv"],
        "LOSS.WITH_HEATMAP_LOSS", False, "LOSS.WITH_POSE2D_LOSS", True,
        "LOSS.POSE2D_LOSS_FACTOR", 0.1, "TRAIN.OPTIMIZER", "adam", "TRAIN.LR", 1e-3,
        "TRAIN.LR_FACTOR", 0.1, "TRAIN.LR_STEP", [20, 40, 50], "TRAIN.IMAGES_PER_GPU",
        FUSION_BATCH, "WORKERS", 4, "TPU.COMPUTE_DTYPE", dtype, "EXP_NAME", "chip_smoke_fusion",
        "OUTPUT_DIR", out_dir], freeze=False)
    cfg.MODEL.EXTRA.merge_from_mapping(w48_extra())
    return cfg.freeze()


def volcpm_cfg(out_dir: str, batch: int, softmax: bool = False, length: int = 0):
    """The MODEL, LOSS and TRAIN sections of experiments/LearnableTriangulation/
    VolTriangulation_MHP_CPM_v1.yaml set in code: the CPM backbone at 256, a
    64^3 cube of 500 mm, softmax aggregation, VOLUME_SOFTMAX, the argmax 2D
    decode (HEATMAP_SOFTMAX off; ``softmax`` turns it on), losses heatmap 0.1
    + pose3d 1.0 + VCE 0.01, adam at LR 1e-4 with PROCESS_FEATURE_LR and
    VOLUME_NET_LR 1e-3.  TRIANGULATION_MODEL_NAME 'vol_CPM' (the YAML leaves
    the default 'alg', C14) and HEATMAP_SIZE 32 (C14); B cut from 8;
    Synthetic_mv with 4 views in place of MHP_CPM_mv, bf16."""
    return load_config(opts=[
        "MODEL.NAME", "vol_CPM", "MODEL.TRIANGULATION_MODEL_NAME", "vol_CPM",
        "MODEL.BACKBONE_NAME", "CPM_volumetric", "MODEL.IMAGE_SIZE", [CPM_IMAGE] * 2,
        "MODEL.HEATMAP_SIZE", [CPM_HM] * 2, "MODEL.SIGMA", 2, "MODEL.HEATMAP_SOFTMAX", softmax,
        "MODEL.TRAINABLE_SOFTMAX", False, "MODEL.CUBOID_SIZE", 500.0, "MODEL.VOLUME_SIZE", 64,
        "MODEL.VOLUME_MULTIPLIER", 1.0, "MODEL.VOLUME_SOFTMAX", True,
        "MODEL.VOLUME_AGGREGATION_METHOD", "softmax", "MODEL.VOL_CONFIDENCES", True,
        "MODEL.ALG_CONFIDENCES", False, "LOSS.WITH_HEATMAP_LOSS", True,
        "LOSS.HEATMAP_LOSS_FACTOR", 0.1, "LOSS.WITH_POSE2D_LOSS", False,
        "LOSS.WITH_POSE3D_LOSS", True, "LOSS.POSE3D_LOSS_FACTOR", 1.0,
        "LOSS.WITH_VOLUMETRIC_CE_LOSS", True, "LOSS.VOLUMETRIC_LOSS_FACTOR", 0.01,
        "TRAIN.OPTIMIZER", "adam", "TRAIN.LR", 1e-4, "TRAIN.PROCESS_FEATURE_LR", 1e-3,
        "TRAIN.VOLUME_NET_LR", 1e-3, "TRAIN.LR_FACTOR", 0.1, "TRAIN.LR_STEP", [8, 16, 24],
        "TRAIN.IMAGES_PER_GPU", batch, "TEST.IMAGES_PER_GPU", batch,
        "TRAIN.BEGIN_EPOCH", 0, "TRAIN.END_EPOCH", 1,
        "DATASET.DATASET", ["Synthetic_mv"], "DATASET.TEST_DATASET", ["Synthetic_mv"],
        "DATASET.NUM_VIEWS", T3_VIEWS, "WORKERS", 4, "PRINT_FREQ", 1,
        "EXP_NAME", "chip_smoke_vol_cpm", "OUTPUT_DIR", out_dir])


def first_batch(cfg, dev, is_train: bool = True):
    """The first batch of the config's first loader, as the 2D steps read it."""
    from hrnet_hand_pose_estimation_tpu_torch.core.trainer import _batch_for_step
    from hrnet_hand_pose_estimation_tpu_torch.data.build import make_dataloader
    from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import to_device

    loader = next(iter(make_dataloader(cfg, is_train).values()))
    return _batch_for_step(to_device(next(iter(loader)), dev))


def volcpm_projections(cfg, batch):
    """The vol net's heatmap-scale projections of a Synthetic_mv batch (its
    images are the original ones, 256 px)."""
    from hrnet_hand_pose_estimation_tpu_torch.core.evaluator3d import build_projections

    return build_projections(cfg, batch["intrinsic_matrix"], batch["extrinsic_matrices"],
                             (CPM_IMAGE, CPM_IMAGE), "vol_CPM")


def cpm_phases(smi, kernels):
    """CPM at 256 (its only width), B=8: the forward on the card against the
    same forward in float32 on the CPU, train steps, one eval batch, the
    train tool on synthetic_cpm_smoke.yaml.  CPM runs no kernel of the port
    (JAX's CPM reaches no Pallas kernel): its counters stay at 0."""
    from hrnet_hand_pose_estimation_tpu_torch.core.train_variants import pick_train_step

    dev = torch.device("cuda")
    none = {fn.__name__: 0 for fn in COUNTED}
    tool_dir = tempfile.TemporaryDirectory()
    tool = None
    if importlib.util.find_spec("yaml") is not None:
        # the train tool's process starts first and runs beside the CPM
        # phases; "CPM train tool" reads it
        tool = background([sys.executable, "-m", "hrnet_hand_pose_estimation_tpu_torch.tools.train",
                           "--cfg", str(CPM_YAML), "--device", "cuda", "TRAIN.IMAGES_PER_GPU",
                           str(CPM_TOOL_BATCH), "TEST.IMAGES_PER_GPU", str(CPM_TOOL_BATCH),
                           "OUTPUT_DIR", tool_dir.name], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          cwd=Path(__file__).resolve().parent)
    with phase("CPM forward"), tempfile.TemporaryDirectory() as tmp:
        cfg = cpm_cfg(tmp)
        state = init_variables(cfg, 0)
        model = build_model(cfg)
        model.load_state_dict(state)
        model.to(dev)
        batch = first_batch(cfg, dev, False)
        x, cm = batch["images"], batch["centermaps"]
        zero_counters()
        with torch.no_grad():
            f32 = model(x, cm)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                low = model(x, cm)
        torch.cuda.synchronize()
        if counters() != none:
            raise AssertionError(f"CPM launched a kernel of the port: {counters()}")
        cpu = build_model(cfg)
        cpu.load_state_dict(state)
        with torch.no_grad():
            want = cpu(x[:2].cpu(), cm[:2].cpu())
        d32 = max((a[:2].cpu() - b).abs().max().item() / b.abs().max().item()
                  for a, b in zip(f32, want))
        scale = f32[-1].abs().max().item()
        d16 = (low[-1] - f32[-1]).abs()
        agree = (hard_argmax(low[-1][..., 1:]) == hard_argmax(f32[-1][..., 1:])).all(-1)
        print(f"CPM forward B={CPM_BATCH} at {CPM_IMAGE} ({CPM_HM}x{CPM_HM}x22 beliefs, six "
              f"stages): float32 on the card vs the CPU (2 samples, TF32 off) max |d| "
              f"{d32:.3g} of the largest belief (limit {CPM_F32_LIMIT}); bf16 vs float32 on "
              f"the card max |d| {d16.max().item() / scale:.4f}, mean "
              f"{d16.mean().item() / scale:.5f} of the largest belief {scale:.4g} (limit "
              f"{CPM_BF16_LIMIT}), argmax joints equal {agree.float().mean().item():.1%}")
        if not (d32 <= CPM_F32_LIMIT and d16.max().item() <= CPM_BF16_LIMIT * scale
                and torch.isfinite(low[-1]).all()):
            raise AssertionError(f"CPM forward: float32 {d32}, bf16 {d16.max().item() / scale}")
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            fwd_ms = time_ms(lambda: model(x, cm), 10)
        print(f"CPM bf16 forward B={CPM_BATCH} at {CPM_IMAGE}: {fwd_ms:.3f} ms (CUDA events), "
              f"{CPM_BATCH / fwd_ms * 1e3:.1f} images/s on {smi}")
        del model, cpu, f32, low, want

    with phase("CPM train"), tempfile.TemporaryDirectory() as tmp:
        batch = first_batch(cpm_cfg(tmp), dev)
        print(f"CPM train batch: images {tuple(batch['images'].shape)}, centre maps "
              f"{tuple(batch['centermaps'].shape)}, targets "
              f"{tuple(batch['target_heatmaps'].shape)}")
        for lr, n in ((1e-3, 3), (CPM_CHECK_LR, CPM_STEPS)):
            cfg = cpm_cfg(tmp, **{"TRAIN.LR": lr})
            model = build_model(cfg)
            state, tx = TS.create_train_state(cfg, model, 1000, device=dev)
            step = pick_train_step(cfg, model, tx)
            losses = []
            zero_counters()
            for _ in range(n):
                state, out = step(state, batch)
                losses.append(out)
            torch.cuda.synchronize()
            host = [float(o["total_loss"]) for o in losses]
            skipped = sum(float(o["nonfinite_grads"]) for o in losses)
            print(f"CPM {n} bf16 steps B={CPM_BATCH} (adam at LR {lr:g} from flax's "
                  f"lecun-normal init, one batch): total loss "
                  f"{[float(f'{v:.5g}') for v in host]}, skipped steps {skipped:.0f}")
            if counters() != none or not all(np.isfinite(host)) or skipped:
                raise AssertionError(f"CPM steps: {host}, skipped {skipped}, {counters()}")
        if not host[-1] < 0.9 * host[0]:
            raise AssertionError(f"CPM loss did not fall at LR {CPM_CHECK_LR}: {host}")
        ms, peak, wall, busy, _ = step_cost(lambda: step(state, batch))
        print(f"CPM train step B={CPM_BATCH} at {CPM_IMAGE} (bf16): {ms:.3f} ms (CUDA events), "
              f"peak memory {peak:.2f} GiB; profiler wall {wall:.3f} ms, kernels {busy:.3f} ms "
              f"({busy / wall:.1%} busy), on {smi}")

        zero_counters()
        out = TS.make_eval_step(cfg, model)(state, first_batch(cfg, dev, False))
        torch.cuda.synchronize()
        hm, pose = out["heatmaps"], out["pose2d_pred"]
        spread = pose.std().item()
        print(f"CPM eval batch: heatmaps {tuple(hm.shape)} {hm.dtype}, pose2d "
              f"{tuple(pose.shape)} in [{pose.min().item():.0f}, {pose.max().item():.0f}], "
              f"spread {spread:.2f} px")
        if (hm.shape != (CPM_BATCH, CPM_HM, CPM_HM, 21) or not torch.isfinite(hm).all()
                or pose.min() < 0 or pose.max() > CPM_HM - 1 or counters() != none
                or not spread > 0.5):
            raise AssertionError("CPM eval batch")
        del model, state, tx, step

    with phase("CPM train tool"), tool_dir as tmp:
        if tool is not None:
            log, _ = tool.communicate(timeout=300)
            lines = [ln for ln in log.splitlines() if "Epoch[" in ln or "Validate[" in ln]
            print(f"python -m ...tools.train --cfg {CPM_YAML.name} --device cuda: rc "
                  f"{tool.returncode}; " + " | ".join(ln.split(" ", 2)[-1][:140]
                                                       for ln in lines[-2:]))
            if tool.returncode != 0 or "Validate[0]" not in log:
                raise AssertionError(f"tools.train on the CPM smoke config failed:\n{log[-3000:]}")
        else:
            from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer
            from hrnet_hand_pose_estimation_tpu_torch.data.build import make_dataloader

            cfg = load_config(opts=[
                "EXP_NAME", "synthetic_cpm_smoke", "WORKERS", 2, "PRINT_FREQ", 2,
                "DATASET.DATASET", ["Synthetic_kpt"], "DATASET.TEST_DATASET", ["Synthetic_kpt"],
                "DATASET.SIGMA", 2, "MODEL.NAME", "CPM", "MODEL.IMAGE_SIZE", [64, 64],
                "MODEL.HEATMAP_SIZE", [8, 8], "MODEL.SIGMA", 2, "MODEL.HEATMAP_SOFTMAX", False,
                "LOSS.WITH_HEATMAP_LOSS", True, "TRAIN.IMAGES_PER_GPU", 4,
                "TRAIN.BEGIN_EPOCH", 0, "TRAIN.END_EPOCH", 1, "TRAIN.OPTIMIZER", "adam",
                "TRAIN.LR", 1e-3, "TRAIN.LR_STEP", [1], "TEST.IMAGES_PER_GPU", 4,
                "OUTPUT_DIR", tmp])
            print("no PyYAML on this machine: the train tool's Trainer in process on "
                  "synthetic_cpm_smoke.yaml's tree built in code")
            trainer = Trainer(cfg, build_model(cfg), make_dataloader(cfg, True),
                              make_dataloader(cfg, False), output_dir=tmp, device=dev)
            trainer.fit()
            print(f"Trainer.fit: {trainer.ckpt.epochs()} epochs checkpointed, best val "
                  f"{trainer.best_loss:.4g}")
            if trainer.ckpt.epochs() != [0] or not np.isfinite(trainer.best_loss):
                raise AssertionError("CPM Trainer.fit")


def fusion_phases(smi, kernels):
    """The fusion net at w48, 256/64, 4 views, B=1: three train steps, each
    one B4 forward and one B4 backward launch (the raw branch's decode); one
    float32 step against the same step decoded by B4's twin, held to a
    witness; the step's time, peak memory and B4's share."""
    from hrnet_hand_pose_estimation_tpu_torch.core import train_variants as TV

    dev = torch.device("cuda")
    b4 = next(k for k in kernels if k["name"] == "fused_softmax_decode")
    b4b = next(k for k in kernels if k["name"] == "softmax_decode_backward")
    b4["launches_fusion"] = b4b["launches_fusion"] = 0
    with phase("fusion train"), tempfile.TemporaryDirectory() as tmp:
        cfg = fusion_cfg(tmp)
        weights = init_variables(cfg, 0, device=dev)
        model = build_model(cfg)
        state, tx = TS.create_train_state(cfg, model, 1000, device=dev)
        model.load_state_dict(weights)
        step = TV.pick_train_step(cfg, model, tx)
        batch = first_batch(cfg, dev)
        n_fc = model.aggregation.pair_fc.numel()
        print(f"fusion net w48: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
              f"parameters, pair_fc {tuple(model.aggregation.pair_fc.shape)} "
              f"({n_fc * 4 / 2 ** 20:.0f} MiB float32); batch images "
              f"{tuple(batch['images'].shape)}, targets {tuple(batch['target_heatmaps'].shape)}")
        want = {fn.__name__: 0 for fn in COUNTED}
        want["fused_softmax_decode"] = 1
        for i in range(FUSION_STEPS):
            zero_counters()
            fused_softmax_decode.launches_bwd = 0
            state, losses = step(state, batch)
            torch.cuda.synchronize()
            host = {k: round(float(v), 5) for k, v in losses.items()}
            print(f"fusion step {i} (B={FUSION_BATCH} x {FUSION_VIEWS} views, bf16): {host}; "
                  f"launches {counters()}, B4 backward {fused_softmax_decode.launches_bwd}")
            if counters() != want or fused_softmax_decode.launches_bwd != 1:
                raise AssertionError(f"fusion step launches {counters()}, backward "
                                     f"{fused_softmax_decode.launches_bwd}")
            if not all(np.isfinite(v) for v in host.values()) or host["nonfinite_grads"]:
                raise AssertionError(f"fusion step losses {host}")
            b4["launches_fusion"] += 1
            b4b["launches_fusion"] += 1
        ms, peak, wall, busy, parts = step_cost(lambda: step(state, batch), B4_KERNEL_NAMES)
        fwd, bwd = (parts[k] for k in B4_KERNEL_NAMES)
        print(f"fusion train step B={FUSION_BATCH} x {FUSION_VIEWS} views, w48 at 256/64 (bf16): "
              f"{ms:.3f} ms per step (CUDA events), peak memory {peak:.2f} GiB; profiler: wall "
              f"{wall:.3f} ms, kernels {busy:.3f} ms ({busy / wall:.1%} busy); B4 forward "
              f"{fwd:.4f} ms + backward {bwd:.4f} ms of kernel per step "
              f"({(fwd + bwd) / max(busy, 1e-9):.2%} of the device time), on {smi}")
        b4["device_ms_in_fusion_step"], b4b["device_ms_in_fusion_step"] = fwd, bwd
        b4b["step_ms_fusion"] = ms
        del model, state, tx, step

    with phase("fusion float32 step vs twin"), tempfile.TemporaryDirectory() as tmp:
        cfg = fusion_cfg(tmp, "float32")
        model = build_model(cfg)
        state, tx = TS.create_train_state(cfg, model, 1000, device=dev)
        model.load_state_dict(weights)
        groups = name_groups(model, lambda n: {"backbone.trainable_temp": "temperature",
                                               "aggregation.pair_fc": "aggregation"}.get(
                                                   n, "backbone"))
        torch.backends.cudnn.deterministic = True
        try:
            grads_vs_twin("fusion step", state, TV.pick_train_step(cfg, model, tx),
                          first_batch(cfg, dev), None, groups, module=TV)
        finally:
            torch.backends.cudnn.deterministic = False
        b4["launches_fusion"] += 1
        b4b["launches_fusion"] += 1
        del model, state, tx, weights


def volcpm_gate(net, images, proj, cfg, out):
    """The softmax-decoded vol_CPM forward against the same forward decoded
    by B4's twin: the 2D keypoints within 1e-3 heatmap px; the 3D ones
    within 3x the witness's distance (the twin moved by ``T3_WITNESS_PX``)
    plus 1 mm.  A random CPM's cube and bf16 V2V move the 3D keypoints by
    tens of mm for a 1e-5 px change of the base detections (measured), so
    MV_3D_LIMIT's one voxel would test the net, not B4."""
    from hrnet_hand_pose_estimation_tpu_torch.models import triangulation as TRI

    runs = {}
    for name, decode in (("twin", softmax_decode_reference), ("witness", decode_moved)):
        with patched(TRI, "softmax_decode", decode), torch.no_grad(), \
                TS.compute_autocast(cfg, images.device):
            runs[name] = net(images, proj)
    twin = runs["twin"]
    d2 = (out.keypoints_2d - twin.keypoints_2d).abs().max().item()
    d3 = (out.keypoints_3d - twin.keypoints_3d).norm(dim=-1).max().item()
    w2 = (runs["witness"].keypoints_2d - twin.keypoints_2d).abs().max().item()
    w3 = (runs["witness"].keypoints_3d - twin.keypoints_3d).norm(dim=-1).max().item()
    limit = T3_WITNESS_FACTOR * w3 + 1.0
    print(f"vol_CPM: B4 vs its twin, 2D max |d| {d2:.3g} heatmap px (limit 1e-3), 3D max "
          f"distance {d3:.4g} mm (limit {limit:.4g} mm = {T3_WITNESS_FACTOR:g} x the witness's "
          f"{w3:.4g} mm + 1; the witness moves the 2D by {w2:.3g} px); |3D| up to "
          f"{twin.keypoints_3d.abs().max().item():.4g} mm")
    if not (d2 <= 1e-3 and d3 <= limit and torch.isfinite(out.keypoints_3d).all()):
        raise AssertionError(f"vol_CPM: B4 and its twin part: 2D {d2}, 3D {d3} mm")


def volcpm_phases(smi, kernels):
    """vol_CPM at VolTriangulation_MHP_CPM_v1's widths (256, a 64^3 cube,
    4 views), B=2: the forward with the YAML's argmax decode (no B4 launch)
    and with the softmax decode (one B4 launch, against its twin); one
    Trainer3D step with every parameter the JAX labels freeze bit-unchanged;
    the train3d tool."""
    from hrnet_hand_pose_estimation_tpu_torch.core.trainer3d import Trainer3D, freeze_labels
    from hrnet_hand_pose_estimation_tpu_torch.data.build import make_dataloader
    from hrnet_hand_pose_estimation_tpu_torch.models import triangulation as TRI
    from hrnet_hand_pose_estimation_tpu_torch.tools import train3d as tool_train3d

    dev = torch.device("cuda")
    b4 = next(k for k in kernels if k["name"] == "fused_softmax_decode")
    b4["launches_vol_cpm"] = 0
    with phase("vol_CPM forward"), tempfile.TemporaryDirectory() as tmp:
        batches = t3_batches(volcpm_cfg(tmp, VOLCPM_BATCH), dev, 1, is_train=False)
        batch = batches[0]
        for softmax in (False, True):
            cfg = volcpm_cfg(tmp, VOLCPM_BATCH, softmax=softmax)
            net = TRI.build_triangulation_net(cfg)
            net.load_state_dict(init_variables(cfg, 0, device=dev, net="vol_CPM"))
            net.to(dev).eval()
            proj = volcpm_projections(cfg, batch)
            zero_counters()
            with torch.no_grad(), TS.compute_autocast(cfg, dev):
                out = net(batch["images"], proj)
            torch.cuda.synchronize()
            want = {fn.__name__: 0 for fn in COUNTED}
            want["fused_softmax_decode"] = int(softmax)
            decode = "softmax" if softmax else "argmax"
            print(f"vol_CPM forward B={VOLCPM_BATCH} x {T3_VIEWS} views ({decode} decode): "
                  f"heatmaps {tuple(out.heatmaps.shape)}, kp3d "
                  f"{tuple(out.keypoints_3d.shape)}, volumes {tuple(out.volumes.shape)}, "
                  f"launches {counters()}")
            if counters() != want or not torch.isfinite(out.keypoints_3d).all():
                raise AssertionError(f"vol_CPM forward: launches {counters()}")
            b4["launches_vol_cpm"] += int(softmax)
            if softmax:
                volcpm_gate(net, batch["images"], proj, cfg, out)
            run = lambda: net(batch["images"], proj)
            with torch.no_grad(), TS.compute_autocast(cfg, dev):
                ms = time_ms(run, 5)
            print(f"vol_CPM forward ({decode}) B={VOLCPM_BATCH} x "
                  f"{T3_VIEWS} views at 256, 64^3 (bf16): {ms:.3f} ms (CUDA events) on {smi}")
            del net

    with phase("vol_CPM Trainer3D step"), tempfile.TemporaryDirectory() as tmp:
        cfg = volcpm_cfg(tmp, VOLCPM_BATCH)
        net = TRI.build_triangulation_net(cfg)
        trainer = Trainer3D(cfg, net, make_dataloader(cfg, True), {}, output_dir=tmp, device=dev)
        net.load_state_dict(init_variables(cfg, 0, device=dev, net="vol_CPM"))
        state = trainer.state
        labels = freeze_labels(net)
        groups = name_groups(net, labels.get)
        before = state.params.clone()
        batch = t3_batches(cfg, dev, 1)[0]
        zero_counters()
        trainer.state, losses = trainer.train_step(state, batch, trainer.generator)
        torch.cuda.synchronize()
        host = {k: round(float(v), 5) for k, v in losses.items()}
        moved = {g: sum(not torch.equal(state.params[s], before[s]) for _, s in items)
                 for g, items in groups.items()}
        print(f"vol_CPM Trainer3D step (B={VOLCPM_BATCH} x {T3_VIEWS} views, bf16): {host}; "
              f"launches {counters()}; tensors moved per group {json.dumps(moved)} of "
              + json.dumps({g: len(v) for g, v in groups.items()})
              + f" (main: CPM's stage 4, {sum(1 for n in labels if labels[n] == 'main')} tensors)")
        if moved["frozen"] or not all(moved[g] for g in ("main", "process", "volume")):
            raise AssertionError(f"vol_CPM step moved {moved}")
        if not all(np.isfinite(v) for v in host.values()) or host["nonfinite_grads"]:
            raise AssertionError(f"vol_CPM step losses {host}")
        ms, peak, wall, busy, _ = step_cost(
            lambda: trainer.train_step(state, batch, trainer.generator))
        print(f"vol_CPM train step B={VOLCPM_BATCH} x {T3_VIEWS} views at 256, 64^3 (bf16): "
              f"{ms:.3f} ms (CUDA events), peak memory {peak:.2f} GiB; profiler wall "
              f"{wall:.3f} ms, kernels {busy:.3f} ms ({busy / wall:.1%} busy), on {smi}")
        del trainer, net, state

    with phase("vol_CPM train3d tool"), tempfile.TemporaryDirectory() as tmp:
        cfg = volcpm_cfg(tmp, VOLCPM_BATCH)
        trainer = tool_train3d.train(cfg, dev, output_dir=tmp)
        print(f"tools.train3d.train on VolTriangulation_MHP_CPM_v1's sections: "
              f"{trainer.ckpt.epochs()} epochs checkpointed, best {trainer.best_loss:.4g} mm")
        if trainer.ckpt.epochs() != [0] or not np.isfinite(trainer.best_loss):
            raise AssertionError("vol_CPM train3d tool")


# -- the single-image model zoo ----------------------------------------------

ZOO_IMAGE, ZOO_HM = 256, 64
SWIN_BATCH = 32             # the forward and eval checks (the YAML evaluates 64 a card)
SWIN_TRAIN_BATCH = 64       # TRAIN.IMAGES_PER_GPU of RHD_SwinTransformer_..._v1.yaml
SWIN_STEPS = 10
# from flax's init: three steps at the YAML's LR are reported, then the
# pose loss must fall below SWIN_FALL of its first value over SWIN_STEPS
# steps on one batch at SWIN_CHECK_LR (the pose loss, a distance in pixels
# from maps that start flat, falls slowly: a few % in 10 steps)
SWIN_CHECK_LR, SWIN_FALL = 1e-3, 0.97
ZOO_BATCH = 32              # hamburger evaluation, RVT timing, pose_resnet
SWIN_YAML = (Path(__file__).resolve().parent / "experiments" / "RHD"
             / "RHD_SwinTransformer_trainable_softmax_pose2dloss_v1.yaml")
# bf16 against float32 on the card: no farther than ZOO_WITNESS_FACTOR x the
# CPU's own bf16 autocast is from its float32 (an independent rounding of
# the same model), the max with a floor of ZOO_FLOOR_PX as for the HRNet
ZOO_WITNESS_FACTOR, ZOO_FLOOR_PX = 2.0, 0.25
# the RVT's float32 forward is ~3e-3 px from the CPU's at full width (its
# sigmoid x 64 magnifies a float32 ResNet-50 + 12 ViT blocks): the card's is
# held to the CPU's float64 forward, within this many times the CPU's own
# float32 distance from it (and 1e-3 px)
RVT_WITNESS_FACTOR = 2.0


def zoo_cfg(name: str, out_dir: str = "", **extra):
    """The MODEL, LOSS and TRAIN sections of the zoo's shipped YAMLs set in
    code (the card's machine may lack PyYAML), on Synthetic_kpt at 256/64,
    bf16 compute, no flip test:

    - swin_transformer: experiments/RHD/RHD_SwinTransformer_trainable_softmax_
      pose2dloss_v1.yaml (embed 96, depths 2-2-6-2, heads 3-6-12-24, patch
      4, the mlp FFN, HEATMAP_SOFTMAX with the temperature frozen, the pose
      loss, adam at LR 1e-3, B=64);
    - pose_hrnet_hamburger: RHD_HRNet_MatrixDecomp_trainable_softmax_
      pose2dloss_v2.yaml (w32, R 512, NMF, 6 train and 6 eval steps, the
      temperature trainable, sgd at LR 0.009; evaluated at B=32, the YAML's
      1 a card is raised);
    - my_pose_transformer: RHD_Resnet50_RVT_v1.yaml (ResNet-50, dims 48 x 16
      heads, depths 10 and 2, patch 4);
    - pose_resnet: no shipped YAML: SimpleBaseline's own defaults (ResNet-50,
      3 x 256 deconvs), the heatmap loss, the argmax decode, adam at 1e-3.
    """
    common = ["MODEL.NAME", name, "MODEL.IMAGE_SIZE", [ZOO_IMAGE] * 2,
              "MODEL.HEATMAP_SIZE", [ZOO_HM] * 2, "MODEL.SIGMA", 2, "DATASET.SIGMA", 2,
              "DATASET.DATASET", ["Synthetic_kpt"], "DATASET.TEST_DATASET", ["Synthetic_kpt"],
              "TEST.FLIP_TEST", False, "TRAIN.BEGIN_EPOCH", 0, "TRAIN.END_EPOCH", 1,
              "WORKERS", 4, "PRINT_FREQ", 1, "DEBUG.DEBUG", False,
              "EXP_NAME", f"chip_smoke_{name}", "OUTPUT_DIR", out_dir]
    pose_loss = ["LOSS.WITH_HEATMAP_LOSS", False, "LOSS.WITH_POSE2D_LOSS", True,
                 "LOSS.POSE2D_LOSS_FACTOR", 1.0]
    model = {
        "swin_transformer": pose_loss + [
            "MODEL.DEPTHS", [2, 2, 6, 2], "MODEL.NUM_HEADS", [3, 6, 12, 24], "MODEL.EMB_DIM", [96],
            "MODEL.PATCH_SIZE", 4, "MODEL.FF_TYPE", "mlp", "MODEL.HEATMAP_SOFTMAX", True,
            "MODEL.TRAINABLE_SOFTMAX", False, "TRAIN.OPTIMIZER", "adam", "TRAIN.LR", 1e-3,
            "TRAIN.LR_FACTOR", 0.5, "TRAIN.LR_STEP", [24, 48, 72],
            "TRAIN.IMAGES_PER_GPU", SWIN_TRAIN_BATCH, "TEST.IMAGES_PER_GPU", SWIN_BATCH],
        "pose_hrnet_hamburger": pose_loss + [
            "MODEL.R", 512, "MODEL.HAM_TYPE", "NMF", "MODEL.TRAIN_STEPS", 6,
            "MODEL.EVAL_STEPS", 6, "MODEL.HEATMAP_SOFTMAX", True, "MODEL.TRAINABLE_SOFTMAX", True,
            "TRAIN.OPTIMIZER", "sgd", "TRAIN.LR", 0.009, "TRAIN.IMAGES_PER_GPU", 1,
            "TEST.IMAGES_PER_GPU", ZOO_BATCH],
        "my_pose_transformer": pose_loss + [
            "MODEL.BACKBONE_NAME", "resnet50", "MODEL.PATCH_SIZE", 4, "MODEL.DEPTHS", [10, 2],
            "MODEL.NUM_HEADS", [16, 16], "MODEL.EMB_DIM", [48, 48],
            "MODEL.HEATMAP_SOFTMAX", True, "MODEL.TRAINABLE_SOFTMAX", True,
            "TRAIN.OPTIMIZER", "sgd", "TRAIN.LR", 0.009, "TRAIN.IMAGES_PER_GPU", 2],
        "pose_resnet": [
            "LOSS.WITH_HEATMAP_LOSS", True, "LOSS.WITH_POSE2D_LOSS", False,
            "MODEL.HEATMAP_SOFTMAX", False, "TRAIN.OPTIMIZER", "adam", "TRAIN.LR", 1e-3,
            "TRAIN.IMAGES_PER_GPU", ZOO_BATCH, "TEST.IMAGES_PER_GPU", ZOO_BATCH],
    }[name]
    for key, val in extra.items():
        model += [key, val]
    cfg = load_config(opts=common + model, freeze=False)
    if name == "pose_hrnet_hamburger":
        cfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
    return cfg.freeze()


def zoo_pair(cfg, dev):
    """(the config's model on the card, the same weights on the CPU), eval
    mode, weights from ``init_variables(cfg, 0)``; and the state."""
    state = init_variables(cfg, 0, device=dev)
    models = []
    for where in (dev, "cpu"):
        model = build_model(cfg)
        model.load_state_dict(state)
        models.append(model.to(where).eval())
    return models[0], models[1], state


def zoo_images(seed: int, batch: int, dev):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(batch, ZOO_IMAGE, ZOO_IMAGE, 3)).astype(np.float32)).to(dev)


def bf16_gate(label, card, cpu, x):
    """The card's bf16 decode against its float32 one at x's batch, held to
    the CPU's own bf16-vs-float32 gap on the first two samples (the
    witness); the float32 decode on the card against the CPU's (TF32 off)
    within 1e-3 px.  Returns the float32 card decode."""
    with torch.no_grad():
        f32 = soft_argmax(card(x).heatmaps)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            low = soft_argmax(card(x).heatmaps)
        want = soft_argmax(cpu(x[:2].cpu()).heatmaps)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            cpu_low = soft_argmax(cpu(x[:2].cpu()).heatmaps)
    torch.cuda.synchronize()
    d32 = (f32[:2].cpu() - want).abs().max().item()
    d16 = (low - f32).abs()
    wit = (cpu_low - want).abs()
    limit = max(ZOO_FLOOR_PX, ZOO_WITNESS_FACTOR * wit.max().item())
    spread = f32.std(dim=(0, 1)).min().item()
    print(f"{label}: float32 card vs CPU (B=2, TF32 off) max {d32:.3g} px (limit 1e-3); bf16 vs "
          f"float32 on the card (B={x.shape[0]}) max {d16.max().item():.4f} px (first two "
          f"samples {d16[:2].max().item():.4f}, limit {limit:.4f}), mean {d16.mean().item():.5f} "
          f"px (limit {ZOO_WITNESS_FACTOR:g} x the witness's {wit.mean().item():.5f}); witness: "
          f"the CPU's bf16 vs float32 max {wit.max().item():.4f} px; coordinate spread "
          f"{spread:.3f} px")
    if not (d32 <= 1e-3 and d16[:2].max().item() <= limit
            and d16.mean().item() <= ZOO_WITNESS_FACTOR * wit.mean().item()
            and torch.isfinite(low).all()):
        raise AssertionError(f"{label}: float32 {d32} px, bf16 {d16.max().item()} px")
    return f32


def zoo_eval(label, cfg, model, dev, tmp, smi):
    """``Evaluator2D`` std over four synthetic batches: one B4 launch per
    batch and no other kernel, finite results; then each batch's logits
    decoded by B4 and by its twin, within 1e-4 px.  Returns (evaluator,
    loader, launches, ms a batch)."""
    loader = make_test_dataloader(cfg)["Synthetic_kpt"]
    loader.dataset.length = loader.batch_size * EVAL_BATCHES
    ev = Evaluator2D(cfg, model, None, device=dev)
    zero_counters()
    results = ev.run(loader, "Synthetic", tmp)
    torch.cuda.synchronize()
    launches = counters()
    want = {fn.__name__: 0 for fn in COUNTED}
    want["fused_softmax_decode"] = len(loader)
    print(f"{label} Evaluator2D std, {len(loader)} batches of {loader.batch_size}: CUDA launches "
          f"{ {k: v for k, v in launches.items() if v} }; results {json.dumps(results)}")
    if launches != want or not all(np.isfinite(v) for v in results.values()):
        raise AssertionError(f"{label} eval: launches {launches}, results {results}")
    worst = 0.0
    with torch.no_grad():
        for batch in loader:
            images = torch.from_numpy(batch["imgs"]).to(dev)
            with TS.compute_autocast(cfg, dev):
                logits, temp = model.forward_logits(images)
            got = fused_softmax_decode(logits, temp)
            worst = max(worst, (got - softmax_decode_reference(logits, temp)).abs().max().item())
    images = torch.from_numpy(next(iter(loader))["imgs"]).to(dev)
    ms = time_ms(lambda: ev.forward(images).cpu(), 5, warmup=2)
    print(f"{label} eval decode, B4 vs its twin on the same {logits.dtype} logits: max "
          f"{worst:.3g} px (limit 1e-4); Evaluator2D batch B={loader.batch_size}: {ms:.3f} ms "
          f"(forward to the .cpu() of the decode, CUDA events), "
          f"{loader.batch_size / ms * 1e3:.1f} images/s on {smi}")
    if not worst <= 1e-4:
        raise AssertionError(f"{label} eval decode: B4 vs twin {worst} px")
    return ev, loader, launches["fused_softmax_decode"], ms


def refused(label, finding, makers):
    """Each maker raises NotImplementedError naming ``finding``."""
    for what, make in makers.items():
        try:
            make()
        except NotImplementedError as err:
            if finding not in str(err):
                raise AssertionError(f"{label} {what} raised without naming {finding}: {err}")
        else:
            raise AssertionError(f"{label} {what} did not raise ({finding})")
    print(f"{label}: {', '.join(makers)} raise NotImplementedError naming {finding}, as the JAX "
          "package's fail")


def zoo_phases(smi, kernels):
    """The single-image zoo at its YAMLs' widths on Synthetic_kpt at 256/64:
    Swin (forward, Evaluator2D through B4, the generic train step,
    tools.train), the hamburger (forward, Evaluator2D through B4, the ham's
    time, tools.evaluate_2d, C16), the RVT (forward, C17) and the
    SimpleBaseline (forward, train steps, eval batch)."""
    b4 = next(k for k in kernels if k["name"] == "fused_softmax_decode")
    swin_phases(smi, b4)
    hamburger_phases(smi, b4)
    rvt_phases(smi)
    pose_resnet_phases(smi)


def swin_phases(smi, b4):
    from hrnet_hand_pose_estimation_tpu_torch.core.train_variants import pick_train_step

    dev = torch.device("cuda")
    none = {fn.__name__: 0 for fn in COUNTED}
    tool_dir = tempfile.TemporaryDirectory()
    tool = None
    if importlib.util.find_spec("yaml") is not None:
        # the train tool's process starts first and runs beside the swin
        # phases; "swin train" reads it
        cmd = [sys.executable, "-m", "hrnet_hand_pose_estimation_tpu_torch.tools.train",
               "--cfg", str(SWIN_YAML), "--device", "cuda", "DATASET.DATASET",
               "['Synthetic_kpt']", "DATASET.TEST_DATASET", "['Synthetic_kpt']",
               "TRAIN.BEGIN_EPOCH", "0", "TRAIN.END_EPOCH", "1", "DEBUG.DEBUG", "False",
               "WORKERS", "4", "PRINT_FREQ", "1", "AUTO_RESUME", "False", "OUTPUT_DIR",
               tool_dir.name]
        tool = background(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          cwd=Path(__file__).resolve().parent)
    with phase("swin forward"), tempfile.TemporaryDirectory() as tmp:
        cfg = zoo_cfg("swin_transformer", tmp)
        card, cpu, _ = zoo_pair(cfg, dev)
        x = zoo_images(50, SWIN_BATCH, dev)
        zero_counters()
        bf16_gate(f"swin forward ({ZOO_HM}x{ZOO_HM} maps)", card, cpu, x)
        if counters() != none:
            raise AssertionError(f"swin forward launched a kernel of the port: {counters()}")
        for b in (SWIN_BATCH, TIME_BATCH):
            xb = x if b == SWIN_BATCH else zoo_images(51, b, dev)
            with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
                ms = time_ms(lambda: card(xb), 10, warmup=2)
            print(f"swin bf16 forward B={b} at {ZOO_IMAGE}: {ms:.3f} ms (CUDA events), "
                  f"{b / ms * 1e3:.1f} images/s on {smi}")
        del cpu

    with phase("swin eval"), tempfile.TemporaryDirectory() as tmp:
        ev, _, launched, _ = zoo_eval("swin", cfg, card, dev, tmp, smi)
        b4["launches_swin"] = launched
        del ev, card

    with phase("swin train"), tempfile.TemporaryDirectory() as tmp, tool_dir:
        batch = first_batch(zoo_cfg("swin_transformer", tmp), dev)
        print(f"swin train batch: images {tuple(batch['images'].shape)}, pose2d "
              f"{tuple(batch['pose2d'].shape)}")
        for lr, n in ((1e-3, 3), (SWIN_CHECK_LR, SWIN_STEPS)):
            cfg = zoo_cfg("swin_transformer", tmp, **{"TRAIN.LR": lr})
            model = build_model(cfg)
            state, tx = TS.create_train_state(cfg, model, 1000, device=dev)
            step = pick_train_step(cfg, model, tx)
            zero_counters()
            losses = []
            for _ in range(n):
                state, out = step(state, batch)
                losses.append(out)
            torch.cuda.synchronize()
            host = [float(o["total_loss"]) for o in losses]
            skipped = sum(float(o["nonfinite_grads"]) for o in losses)
            print(f"swin {n} bf16 steps B={SWIN_TRAIN_BATCH} (adam at LR {lr:g} from flax's "
                  f"initial distributions, one batch): total loss "
                  f"{[float(f'{v:.5g}') for v in host]}, skipped steps {skipped:.0f}")
            if counters() != none or not all(np.isfinite(host)) or skipped:
                raise AssertionError(f"swin steps: {host}, skipped {skipped}, {counters()}")
        if not host[-1] < SWIN_FALL * host[0]:
            raise AssertionError(f"swin loss did not fall at LR {SWIN_CHECK_LR}: {host}")
        ms, peak, wall, busy, _ = step_cost(lambda: step(state, batch))
        print(f"swin train step B={SWIN_TRAIN_BATCH} at {ZOO_IMAGE} (bf16): {ms:.3f} ms (CUDA "
              f"events), peak memory {peak:.2f} GiB; profiler wall {wall:.3f} ms, kernels "
              f"{busy:.3f} ms ({busy / wall:.1%} busy), on {smi}")
        del model, state, tx, step

        if tool is not None:
            log, _ = tool.communicate(timeout=300)
            lines = [ln for ln in log.splitlines() if "Epoch[" in ln or "Validate[" in ln]
            print(f"python -m ...tools.train --cfg {SWIN_YAML.name} --device cuda (Synthetic_kpt "
                  f"by opts): rc {tool.returncode}; " + " | ".join(ln.split(" ", 2)[-1][:140]
                                                                 for ln in lines[-2:]))
            if tool.returncode != 0 or "Validate[0]" not in log:
                raise AssertionError(f"tools.train on the swin YAML failed:\n{log[-3000:]}")
        else:
            from hrnet_hand_pose_estimation_tpu_torch.data.build import make_dataloader

            cfg = zoo_cfg("swin_transformer", tmp)
            print("no PyYAML on this machine: the train tool's Trainer in process on the swin "
                  "YAML's sections built in code")
            trainer = Trainer(cfg, build_model(cfg), make_dataloader(cfg, True),
                              make_dataloader(cfg, False), output_dir=tmp, device=dev)
            trainer.fit()
            print(f"Trainer.fit: {trainer.ckpt.epochs()} epochs checkpointed, best val "
                  f"{trainer.best_loss:.4g}")
            if trainer.ckpt.epochs() != [0] or not np.isfinite(trainer.best_loss):
                raise AssertionError("swin Trainer.fit")



def hamburger_phases(smi, b4):
    dev = torch.device("cuda")
    none = {fn.__name__: 0 for fn in COUNTED}
    with phase("hamburger forward"), tempfile.TemporaryDirectory() as tmp:
        cfg = zoo_cfg("pose_hrnet_hamburger", tmp)
        card, cpu, state = zoo_pair(cfg, dev)
        x = zoo_images(52, 1, dev)
        zero_counters()
        with torch.no_grad():
            got = card(x).heatmaps
            want = cpu(x.cpu()).heatmaps
        torch.cuda.synchronize()
        d32 = (soft_argmax(got).cpu() - soft_argmax(want)).abs().max().item()
        p32 = (got.cpu() - want).abs().max().item()
        print(f"hamburger float32 forward B=1 (w32, R 512, NMF, 6 eval steps): card vs CPU "
              f"(TF32 off) decode max {d32:.3g} px (limit 1e-3), probabilities max {p32:.3g}")
        if counters() != none or not d32 <= 1e-3:
            raise AssertionError(f"hamburger float32 forward: {d32} px, launches {counters()}")
        del cpu
        ev, loader, launched, batch_ms = zoo_eval("hamburger", cfg, card, dev, tmp, smi)
        b4["launches_hamburger"] = launched
        images = torch.from_numpy(next(iter(loader))["imgs"]).to(dev)
        seen = []
        hook = card.hamburger.ham.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
        with torch.no_grad(), TS.compute_autocast(cfg, dev):
            card.forward_logits(images)
            hook.remove()
            ham_in = seen[0]
            ham_ms = time_ms(lambda: card.hamburger.ham(ham_in), 5, warmup=1)
        print(f"hamburger's ham (NMF, R 512, 6 steps, float32, TF32 off) on a B={ZOO_BATCH} "
              f"batch of {tuple(ham_in.shape)}: {ham_ms:.3f} ms (CUDA events), "
              f"{ham_ms / batch_ms:.1%} of the Evaluator2D batch's {batch_ms:.3f} ms, on {smi}")
        res = tool_eval.evaluate(cfg, state=state, out=tmp, device=dev)
        out = Path(tmp) / "eval2D_results_chip_smoke_pose_hrnet_hamburger"
        shapes = (np.loadtxt(out / "mse2d_each_joint.txt").shape,
                  np.loadtxt(out / "PCK2d.txt").shape)
        print(f"tools.evaluate_2d.evaluate on the hamburger: {json.dumps(res)}; artifacts {shapes}")
        if shapes != ((21,), (2, 49)) or not all(np.isfinite(v) for v in res.values()):
            raise AssertionError("hamburger evaluate_2d tool")
        model = build_model(cfg)
        st, tx = TS.create_train_state(cfg, model, device=dev)
        refused("hamburger", "C16", {"make_train_step": lambda: TS.make_train_step(cfg, model, tx),
                                     "make_eval_step": lambda: TS.make_eval_step(cfg, model)})
        del ev, card, model, st, seen, ham_in



def rvt_phases(smi):
    dev = torch.device("cuda")
    none = {fn.__name__: 0 for fn in COUNTED}
    with phase("RVT forward"), tempfile.TemporaryDirectory() as tmp:
        cfg = zoo_cfg("my_pose_transformer", tmp)
        card, cpu, _ = zoo_pair(cfg, dev)
        x = zoo_images(53, 2, dev)
        zero_counters()
        with torch.no_grad():
            got = card(x)
            want = cpu(x.cpu())
            with torch.autocast("cuda", dtype=torch.bfloat16):
                same = card(x)
            exact = cpu.double()(x.cpu().double())
        torch.cuda.synchronize()
        d = (got.cpu() - want).abs().max().item()
        d_exact = (got.cpu().double() - exact).abs().max().item()
        wit = (want.double() - exact).abs().max().item()
        limit = max(1e-3, RVT_WITNESS_FACTOR * wit)
        print(f"RVT forward B=2 (ResNet-50, 2 x 768 wide stages, depths 10 and 2): float32 card vs "
              f"CPU (TF32 off) max {d:.3g} px; card vs the CPU's float64 {d_exact:.3g} px (limit "
              f"{limit:.3g} = max(1e-3, {RVT_WITNESS_FACTOR:g} x the witness: the CPU's float32 "
              f"vs its float64, {wit:.3g} px); poses in [{want.min().item():.2f}, "
              f"{want.max().item():.2f}]; under a bf16 autocast bit-equal: "
              f"{torch.equal(same, got)}")
        if counters() != none or not d_exact <= limit or not torch.equal(same, got):
            raise AssertionError(f"RVT forward: {d_exact} px from float64, launches {counters()}")
        xb = zoo_images(54, ZOO_BATCH, dev)
        with torch.no_grad():
            ms = time_ms(lambda: card(xb), 5, warmup=2)
        print(f"RVT float32 forward B={ZOO_BATCH} at {ZOO_IMAGE}: {ms:.3f} ms (CUDA events), "
              f"{ZOO_BATCH / ms * 1e3:.1f} images/s on {smi}")
        model = build_model(cfg)
        st, tx = TS.create_train_state(cfg, model, device=dev)
        refused("RVT", "C17", {"make_train_step": lambda: TS.make_train_step(cfg, model, tx),
                               "make_eval_step": lambda: TS.make_eval_step(cfg, model),
                               "make_forward_fn": lambda: TS.make_forward_fn(cfg, model),
                               "Evaluator2D": lambda: Evaluator2D(cfg, model, None, device=dev)})
        del card, cpu, model, st



def pose_resnet_phases(smi):
    from hrnet_hand_pose_estimation_tpu_torch.core.train_variants import pick_train_step

    dev = torch.device("cuda")
    none = {fn.__name__: 0 for fn in COUNTED}
    with phase("pose_resnet"), tempfile.TemporaryDirectory() as tmp:
        cfg = zoo_cfg("pose_resnet", tmp)
        model = build_model(cfg)
        model.load_state_dict(init_variables(cfg, 0, device=dev))
        model.to(dev).eval()
        x = zoo_images(55, ZOO_BATCH, dev)
        zero_counters()
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            out = model(x)
            fwd_ms = time_ms(lambda: model(x), 10, warmup=2)
        print(f"pose_resnet bf16 forward B={ZOO_BATCH} at {ZOO_IMAGE} (ResNet-50, 3 x 256 deconvs): "
              f"logits {tuple(out.heatmaps.shape)}, {fwd_ms:.3f} ms (CUDA events), "
              f"{ZOO_BATCH / fwd_ms * 1e3:.1f} images/s on {smi}")
        if out.heatmaps.shape != (ZOO_BATCH, ZOO_HM, ZOO_HM, 21) or not torch.isfinite(
                out.heatmaps).all():
            raise AssertionError("pose_resnet forward")
        batch = first_batch(cfg, dev)
        model = build_model(cfg)
        state, tx = TS.create_train_state(cfg, model, 1000, device=dev)
        step = pick_train_step(cfg, model, tx)
        losses = []
        for _ in range(3):
            state, o = step(state, batch)
            losses.append(o)
        torch.cuda.synchronize()
        host = [float(o["total_loss"]) for o in losses]
        ms, peak, wall, busy, _ = step_cost(lambda: step(state, batch))
        print(f"pose_resnet 3 bf16 train steps B={ZOO_BATCH} (heatmap loss, adam at 1e-3): "
              f"{[float(f'{v:.5g}') for v in host]}; step {ms:.3f} ms (CUDA events), peak memory "
              f"{peak:.2f} GiB, kernels {busy:.3f} of {wall:.3f} ms ({busy / wall:.1%} busy), "
              f"on {smi}")
        if not all(np.isfinite(host)) or sum(float(o["nonfinite_grads"]) for o in losses):
            raise AssertionError(f"pose_resnet steps {host}")
        eval_step = TS.make_eval_step(cfg, model)
        vbatch = first_batch(cfg, dev, False)
        res = eval_step(state, vbatch)
        ev_ms = time_ms(lambda: eval_step(state, vbatch), 5, warmup=1)
        pose = res["pose2d_pred"]
        print(f"pose_resnet eval batch B={ZOO_BATCH} (argmax decode): pose2d {tuple(pose.shape)} "
              f"in [{pose.min().item():.0f}, {pose.max().item():.0f}], {ev_ms:.3f} ms (CUDA "
              f"events) on {smi}")
        if counters() != none or pose.shape != (ZOO_BATCH, 21, 2) or pose.min() < 0 \
                or pose.max() > ZOO_HM - 1:
            raise AssertionError(f"pose_resnet eval batch, launches {counters()}")


# -- the temporal family ----------------------------------------------------

TEMPORAL_BATCH = 2          # TRAIN / TEST.IMAGES_PER_GPU of the PoseAggr YAMLs
TEMPORAL_STEPS = 3
AGGR_SEQ = {"v1": [-2, -1, 0, 1, 2], "v2": [-4, -2, 0, 2, 4]}
FORMER_SEQ = list(range(-4, 5))
# PoseFormer's refined pose on the card against the CPU's (both float32,
# TF32 off; B4 and its twin decode the backbone 1e-5 px apart): 4.05e-6 px
# on an H100 at the YAML's widths, held to five times that
FORMER_LIMIT = 2e-5
# PredRNN's and the TCN's float32 outputs on the card are held to the CPU's
# float64 forward of the same weights and sequence, relative to its largest
# value, within this many times the CPU's own float32 distance from it
RECURRENT_WITNESS_FACTOR = 2.0


def temporal_cfg(name: str, version: str = "v1"):
    """The MODEL, LOSS and TRAIN sections of the temporal YAMLs set in code
    (w32 at 256/64, bf16 compute, no flip test):

    - pose_hrnet_PoseAggr: experiments/MHP/MHP_HRNet_w32_trainable_softmax_
      pose2dloss_PoseAggr_v1.yaml (SEQ_IDX -2..2; ``version`` v2: -4..4 in
      steps of 2), dilations 3-24, the temperature trainable, the pose loss,
      adam at LR 1e-3, B=2;
    - pose_hrnet_transformer: ..._PoseFormer_v1.yaml (SEQ_IDX -4..4, B=1,
      the same loss and optimizer);
    - HRNet_PredRNN, HRNet_Emb_TCN: no shipped YAML, the config defaults
      (SEQ_IDX -2..2, N_HIDDEN 4 x 64, EMBEDDING_SIZE 512, TCN_CHANNELS 1024,
      FILTER_WIDTHS 4 x 3) on the w32 stages, B=2.
    """
    opts = ["MODEL.NAME", name, "MODEL.IMAGE_SIZE", [ZOO_IMAGE] * 2,
            "MODEL.HEATMAP_SIZE", [ZOO_HM] * 2, "MODEL.SIGMA", 2, "TEST.FLIP_TEST", False,
            "EXP_NAME", f"chip_smoke_{name}", "OUTPUT_DIR", ""]
    if name in ("pose_hrnet_PoseAggr", "pose_hrnet_transformer"):
        seq, batch = ((AGGR_SEQ[version], TEMPORAL_BATCH) if name == "pose_hrnet_PoseAggr"
                      else (FORMER_SEQ, 1))
        opts += ["DATASET.SEQ_IDX", seq, "MODEL.HEATMAP_SOFTMAX", True,
                 "MODEL.TRAINABLE_SOFTMAX", True, "MODEL.DILATION_RATES", [3, 6, 12, 18, 24],
                 "LOSS.WITH_HEATMAP_LOSS", False, "LOSS.WITH_POSE2D_LOSS", True,
                 "LOSS.POSE2D_LOSS_FACTOR", 1.0, "TRAIN.OPTIMIZER", "adam", "TRAIN.LR", 1e-3,
                 "TRAIN.LR_FACTOR", 0.5, "TRAIN.LR_STEP", [16, 32, 48], "TRAIN.WD", 1e-4,
                 "TRAIN.IMAGES_PER_GPU", batch, "TEST.IMAGES_PER_GPU", batch]
    cfg = load_config(opts=opts, freeze=False)
    cfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
    return cfg.freeze()


def temporal_frames(seed: int, batch: int, t: int, dev):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(batch, t, ZOO_IMAGE, ZOO_IMAGE, 3)).astype(np.float32)).to(dev)


def temporal_batch(seed: int, frames):
    """A train batch of seeded frames: centre-frame poses in heatmap pixels,
    every joint visible, their Gaussian targets from the plain twin."""
    rng = np.random.default_rng(seed)
    b = frames.shape[0]
    pose = torch.from_numpy(rng.uniform(8, ZOO_HM - 8, size=(b, 21, 2)).astype(
        np.float32)).to(frames.device)
    vis = torch.ones(b, 21, device=frames.device)
    return {"images": frames, "pose2d": pose, "visibility": vis,
            "target_heatmaps": gaussian_targets_reference(pose, vis, ZOO_HM, 2.0)}


def train_steps(label, cfg, model, batch, n):
    """``n`` generic 2D train steps from the train state's init, each with a
    finite loss and no skipped step.  Returns (state, step)."""
    state, tx = TS.create_train_state(cfg, model, 1000, device=batch["images"].device)
    step = TS.make_train_step(cfg, model, tx)
    losses = []
    for _ in range(n):
        state, out = step(state, batch)
        losses.append(out)
    torch.cuda.synchronize()
    host = [float(o["total_loss"]) for o in losses]
    skipped = sum(float(o["nonfinite_grads"]) for o in losses)
    print(f"{label}: {n} bf16 train steps B={batch['images'].shape[0]} (adam at LR "
          f"{float(cfg.TRAIN.LR):g} from the JAX package's initial distributions, one batch): "
          f"total loss {[float(f'{v:.5g}') for v in host]}, skipped {skipped:.0f}")
    if not all(np.isfinite(host)) or skipped:
        raise AssertionError(f"{label} steps: {host}, skipped {skipped}")
    return state, step


def temporal_phases(smi, kernels):
    """The temporal family at its YAMLs' widths (w32 at 256/64, seeded
    frames): PoseAggr (forward, Evaluator2D through B4, the deformable
    conv's time, train steps, v2's frames), PoseFormer (forward through B4,
    the C20 step, C20 at B=2), PredRNN and the TCN (forwards, C19)."""
    b4 = next(k for k in kernels if k["name"] == "fused_softmax_decode")
    pose_aggr_phases(smi, b4)
    pose_former_phases(smi, b4)
    predrnn_tcn_phases(smi)


def pose_aggr_phases(smi, b4):
    from hrnet_hand_pose_estimation_tpu_torch.models import pose_aggr
    from hrnet_hand_pose_estimation_tpu_torch.models.pose_aggr import PoseAggrNet
    from hrnet_hand_pose_estimation_tpu_torch.ops.deform_conv import deform_conv2d

    dev = torch.device("cuda")
    none = {fn.__name__: 0 for fn in COUNTED}
    t = len(AGGR_SEQ["v1"])
    with phase("PoseAggr forward"):
        cfg = temporal_cfg("pose_hrnet_PoseAggr")
        state = init_variables(cfg, 0, device=dev)
        card = build_model(cfg)
        card.load_state_dict(state)
        card.to(dev).eval()
        x = temporal_frames(60, TEMPORAL_BATCH, t, dev)
        # the float32 gate: the offset chain in float32 too, card vs CPU
        nets = []
        for where in (dev, "cpu"):
            net = PoseAggrNet(hrnet_from_cfg(cfg, head="plain"), seq_len=t,
                              dilation_rates=card.dilation_rates, trainable_softmax=True,
                              offset_dtype=torch.float32)
            net.load_state_dict(state)
            nets.append(net.to(where).eval())
        zero_counters()
        with torch.no_grad():
            f32 = soft_argmax(nets[0](x).heatmaps)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                low = soft_argmax(card(x).heatmaps)
            t0 = time.perf_counter()
            want = soft_argmax(nets[1](x[:1].cpu()).heatmaps)
            with torch.autocast("cpu", dtype=torch.bfloat16):
                cpu_low = soft_argmax(card.to("cpu")(x[:1].cpu()).heatmaps)
            cpu_s = time.perf_counter() - t0
        card.to(dev)
        torch.cuda.synchronize()
        d32 = (f32[:1].cpu() - want).abs().max().item()
        d16 = (low - f32).abs()
        wit = (cpu_low - want).abs()
        limit = max(ZOO_FLOOR_PX, ZOO_WITNESS_FACTOR * wit.max().item())
        spread = f32.std(dim=(0, 1)).min().item()
        print(f"PoseAggr forward B={TEMPORAL_BATCH} x {t} frames (w32, 20 offset blocks, "
              f"dilations 3-24): float32 card vs CPU (the offset chain in float32, TF32 off, "
              f"B=1) max {d32:.3g} px (limit 1e-3); the registry's net (bf16 offset chain) "
              f"under a bf16 autocast vs float32 on the card max {d16.max().item():.4f} px "
              f"(limit {limit:.4f}), mean "
              f"{d16.mean().item():.5f} (limit {ZOO_WITNESS_FACTOR:g} x the witness's "
              f"{wit.mean().item():.5f}); witness: the CPU's bf16 vs float32 max "
              f"{wit.max().item():.4f} px; coordinate spread {spread:.3f} px; CPU forwards "
              f"{cpu_s:.1f} s")
        if counters() != none or not (d32 <= 1e-3 and d16.max().item() <= limit
                                      and d16.mean().item() <= ZOO_WITNESS_FACTOR
                                      * max(wit.mean().item(), 1e-6)
                                      and torch.isfinite(low).all()):
            raise AssertionError(f"PoseAggr forward: float32 {d32} px, bf16 "
                                 f"{d16.max().item()} px, launches {counters()}")
        del nets

        # one Evaluator2D batch: B4 decodes the fused logits, one launch
        ev = Evaluator2D(cfg, card, None, device=dev)
        zero_counters()
        coords = ev.forward(x)
        torch.cuda.synchronize()
        launches = counters()
        want = dict(none, fused_softmax_decode=1)
        with torch.no_grad(), TS.compute_autocast(cfg, dev):
            logits, temp = card.forward_logits(x)
        gap = (coords - softmax_decode_reference(logits, temp)).abs().max().item()
        print(f"PoseAggr Evaluator2D batch B={TEMPORAL_BATCH}: CUDA launches "
              f"{ {k: v for k, v in launches.items() if v} }; B4 vs its twin on the same "
              f"{logits.dtype} fused logits max {gap:.3g} px (limit 1e-4)")
        if launches != want or not gap <= 1e-4 or not torch.isfinite(coords).all():
            raise AssertionError(f"PoseAggr eval batch: launches {launches}, B4 vs twin {gap}")
        b4["launches_poseaggr_eval"] = launches["fused_softmax_decode"]
        b4["ms_poseaggr_eval"] = time_ms(lambda: fused_softmax_decode(logits, temp), 20)
        b4["bound_ms_poseaggr_eval"] = decode_work(logits, coords)[0]
        print(f"B4 at PoseAggr's eval batch ({tuple(logits.shape)} {logits.dtype}): "
              f"{b4['ms_poseaggr_eval']:.4f} ms a call (CUDA events), bound "
              f"{b4['bound_ms_poseaggr_eval']:.5f} ms, on {smi}")
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            fwd_ms, peak, wall, busy, _ = step_cost(lambda: card(x))
        ev_ms = time_ms(lambda: ev.forward(x).cpu(), 5, warmup=1)
        print(f"PoseAggr bf16 forward B={TEMPORAL_BATCH} x {t} frames: {fwd_ms:.3f} ms (CUDA "
              f"events), peak memory {peak:.2f} GiB, kernels {busy:.3f} of {wall:.3f} ms "
              f"({busy / wall:.1%} busy); Evaluator2D batch {ev_ms:.3f} ms; on {smi}")

        # the deformable conv alone, at the shapes of this forward
        calls = []

        def recording(*args, **kw):
            calls.append((args, kw))
            return deform_conv2d(*args, **kw)

        with patched(pose_aggr, "deform_conv2d", recording), torch.no_grad(), \
                torch.autocast("cuda", dtype=torch.bfloat16):
            card(x)
        per = [time_ms(lambda: deform_conv2d(*a, **kw), 10, warmup=2) for a, kw in calls]
        hm, off, w = calls[0][0]
        moved = sum(nbytes([a[0], a[1], a[2]]) for a, _ in calls) + len(calls) * nbytes([hm])
        flops = len(calls) * 2 * hm.shape[0] * hm.shape[1] * hm.shape[2] * 9 * w.shape[2] \
            * w.shape[3]
        dc_bound = max(moved / PEAK_BYTES, flops / PEAK_F32) * 1e3
        print(f"deform_conv2d at PoseAggr's shapes (x {tuple(hm.shape)}, offsets "
              f"{tuple(off.shape)}, G=21, five dilations): {sum(per):.3f} ms a forward "
              f"({', '.join(f'{p:.3f}' for p in per)} per call; CUDA events), "
              f"{sum(per) / fwd_ms:.1%} of the forward; bound {dc_bound:.4f} ms (bytes "
              f"{moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP float32) on {smi}")
        del calls, ev, logits

    with phase("PoseAggr train"):
        batch = temporal_batch(61, x)
        model = build_model(cfg)
        zero_counters()
        state, step = train_steps("PoseAggr", cfg, model, batch, TEMPORAL_STEPS)
        if counters() != none:
            raise AssertionError(f"PoseAggr steps launched a kernel of the port: {counters()}")
        ms, peak, wall, busy, _ = step_cost(lambda: step(state, batch))
        print(f"PoseAggr train step B={TEMPORAL_BATCH} x {t} frames (bf16): {ms:.3f} ms (CUDA "
              f"events), peak memory {peak:.2f} GiB, kernels {busy:.3f} of {wall:.3f} ms "
              f"({busy / wall:.1%} busy), on {smi}")
        del model, state, step, batch

        cfg2 = temporal_cfg("pose_hrnet_PoseAggr", "v2")
        v2 = build_model(cfg2)
        v2.load_state_dict(card.state_dict())
        v2.to(dev).eval()
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            out = v2(temporal_frames(62, TEMPORAL_BATCH, len(AGGR_SEQ["v2"]), dev))
        sums = out.heatmaps.float().sum(dim=(1, 2))
        print(f"PoseAggr_v2 (SEQ_IDX {AGGR_SEQ['v2']}) bf16 forward: maps "
              f"{tuple(out.heatmaps.shape)}, plane sums in [{sums.min().item():.5f}, "
              f"{sums.max().item():.5f}]")
        if out.heatmaps.shape != (TEMPORAL_BATCH, ZOO_HM, ZOO_HM, 21) or not (
                (sums - 1).abs().max().item() <= 1e-3):
            raise AssertionError("PoseAggr_v2 forward")
        del v2, card


def pose_former_phases(smi, b4):
    dev = torch.device("cuda")
    none = {fn.__name__: 0 for fn in COUNTED}
    f = len(FORMER_SEQ)
    with phase("PoseFormer forward"):
        cfg = temporal_cfg("pose_hrnet_transformer")
        state = init_variables(cfg, 0, device=dev)
        card, cpu = build_model(cfg), build_model(cfg)
        card.load_state_dict(state)
        cpu.load_state_dict(state)
        card.to(dev).eval()
        x = temporal_frames(63, 1, f, dev)
        zero_counters()
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            out = card(x)
        torch.cuda.synchronize()
        launches = counters()
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            logits, temp = card.backbone.forward_logits(x.reshape(f, *x.shape[2:]))
            got = fused_softmax_decode(logits, temp)
        gap = (got - softmax_decode_reference(logits, temp)).abs().max().item()
        with torch.no_grad():
            f32 = card(x).pose2d_refined
            want = cpu(x.cpu()).pose2d_refined
        d32 = (f32.cpu() - want).abs().max().item()
        print(f"PoseFormer bf16 forward B=1 x {f} frames (w32, ratio 32, depth 4, 8 heads, "
              f"temporal width 672): refined {tuple(out.pose2d_refined.shape)}, maps "
              f"{tuple(out.heatmaps.shape)}; CUDA launches "
              f"{ {k: v for k, v in launches.items() if v} }; B4 vs its twin on the backbone's "
              f"{logits.dtype} logits max {gap:.3g} px (limit 1e-4); the float32 refined pose "
              f"card vs CPU (TF32 off) max {d32:.3g} (limit {FORMER_LIMIT:g})")
        if launches != dict(none, fused_softmax_decode=1) or not gap <= 1e-4 \
                or not d32 <= FORMER_LIMIT or not torch.isfinite(out.pose2d_refined).all():
            raise AssertionError(f"PoseFormer forward: launches {launches}, B4 {gap}, f32 {d32}")
        b4["launches_poseformer_forward"] = launches["fused_softmax_decode"]
        b4["ms_poseformer"] = time_ms(lambda: fused_softmax_decode(logits, temp), 20)
        b4["bound_ms_poseformer"] = decode_work(logits, got)[0]
        print(f"B4 at PoseFormer's backbone ({tuple(logits.shape)} {logits.dtype}): "
              f"{b4['ms_poseformer']:.4f} ms a call (CUDA events), bound "
              f"{b4['bound_ms_poseformer']:.5f} ms, on {smi}")
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            fwd_ms = time_ms(lambda: card(x), 10, warmup=2)
        print(f"PoseFormer bf16 forward B=1 x {f} frames: {fwd_ms:.3f} ms (CUDA events) on {smi}")
        del card, cpu

    with phase("PoseFormer train (C20)"):
        batch = temporal_batch(64, x)
        model = build_model(cfg)
        zero_counters()
        bwd = fused_softmax_decode.launches_bwd
        state, step = train_steps("PoseFormer (C20, B=1)", cfg, model, batch, 1)
        launches, bwd = counters(), fused_softmax_decode.launches_bwd - bwd
        grads = {n: p.grad for n, p in model.named_parameters()}
        moved = [n for n, g in grads.items() if not n.startswith("backbone.") and g.any()]
        trunk = sum(bool(g.any()) for n, g in grads.items() if n.startswith("backbone."))
        print(f"PoseFormer C20 step: CUDA launches {launches['fused_softmax_decode']} B4 "
              f"forward, {bwd} B4 backward; nonzero gradients outside the backbone: {moved} "
              f"(JAX's are zero too: the refined pose enters no loss); backbone tensors with a "
              f"gradient {trunk}")
        if launches != dict(none, fused_softmax_decode=1) or bwd or moved or not trunk:
            raise AssertionError(f"PoseFormer C20 step: {launches}, bwd {bwd}, moved {moved}")
        b4["launches_poseformer_step"] = 1
        b4["launches_bwd_poseformer_step"] = bwd
        ms, peak, wall, busy, _ = step_cost(lambda: step(state, batch))
        print(f"PoseFormer C20 train step B=1 x {f} frames (bf16): {ms:.3f} ms (CUDA events), "
              f"peak memory {peak:.2f} GiB, kernels {busy:.3f} of {wall:.3f} ms "
              f"({busy / wall:.1%} busy), on {smi}")
        two = temporal_batch(65, temporal_frames(66, 2, f, dev))
        try:
            step(state, two)
        except ValueError as err:
            if "C20" not in str(err):
                raise AssertionError(f"PoseFormer B=2 raised without naming C20: {err}")
            print("PoseFormer train step at B=2 raises ValueError naming C20, before the loss")
        else:
            raise AssertionError("PoseFormer train step at B=2 did not raise (C20)")
        del model, state, step, batch, two


def predrnn_tcn_phases(smi):
    dev = torch.device("cuda")
    none = {fn.__name__: 0 for fn in COUNTED}
    for name in ("HRNet_PredRNN", "HRNet_Emb_TCN"):
        with phase(f"{name} forward"):
            cfg = temporal_cfg(name)
            t = len(list(cfg.DATASET.SEQ_IDX))
            state = init_variables(cfg, 0, device=dev)
            card, cpu = build_model(cfg), build_model(cfg)
            card.load_state_dict(state)
            cpu.load_state_dict(state)
            card.to(dev).eval()
            x = temporal_frames(67, TEMPORAL_BATCH, t, dev)
            zero_counters()
            with torch.no_grad():
                got = card(x)
                want = cpu(x[:1].cpu())
                exact = cpu.double()(x[:1].cpu().double())
            torch.cuda.synchronize()
            if name == "HRNet_PredRNN":
                out, ref, ex = got[0][:1].cpu(), want[0], exact[0]
                same = (got[2][:1].cpu() == want[2]).float().mean().item()
                extra = f"; argmax decodes equal {same:.1%}"
            else:
                out, ref, ex, same, extra = got[:1].cpu(), want, exact, 1.0, ""
            scale = ex.abs().max().item()
            rel = (out - ref).abs().max().item() / scale
            rel64 = (out.double() - ex).abs().max().item() / scale
            wit = (ref.double() - ex).abs().max().item() / scale
            limit = RECURRENT_WITNESS_FACTOR * wit
            print(f"{name} float32 forward B={TEMPORAL_BATCH} x {t} frames (the defaults on "
                  f"w32): output {tuple(got[0].shape if isinstance(got, tuple) else got.shape)}; "
                  f"the first sequence, TF32 off, relative to the largest value: card vs CPU "
                  f"{rel:.3g}; card vs the CPU's float64 {rel64:.3g} (limit {limit:.3g} = "
                  f"{RECURRENT_WITNESS_FACTOR:g} x the witness: the CPU's float32 vs its "
                  f"float64, {wit:.3g}){extra}")
            if counters() != none or not (0 < wit and rel64 <= limit) or same < 0.99:
                raise AssertionError(f"{name} forward: {rel64} from float64 (limit {limit}), "
                                     f"decodes {same}, {counters()}")
            with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
                ms = time_ms(lambda: card(x), 5, warmup=2)
            print(f"{name} forward B={TEMPORAL_BATCH} x {t} frames (backbone bf16, the "
                  f"temporal part float32): {ms:.3f} ms (CUDA events) on {smi}")
            model = build_model(cfg)
            st, tx = TS.create_train_state(cfg, model, device=dev)
            refused(name, "C19", {"make_train_step": lambda: TS.make_train_step(cfg, model, tx),
                                  "make_eval_step": lambda: TS.make_eval_step(cfg, model),
                                  "make_forward_fn": lambda: TS.make_forward_fn(cfg, model),
                                  "Evaluator2D": lambda: Evaluator2D(cfg, model, None,
                                                                     device=dev)})
            del card, cpu, model, st


# -- FTL, the stacked hourglass and the mesh family --------------------------

FTL_YAML = (Path(__file__).resolve().parent / "experiments" / "MHP"
            / "MHP_HRNet_w32_softmax_pose2dloss_FTL_v1.yaml")
FTL_BATCH, FTL_VIEWS = 2, 4   # TEST.IMAGES_PER_GPU of the FTL YAML, DATASET.NUM_VIEWS
# the float32 card against the CPU's float64: within this many times the
# CPU's own float32 gap from its float64; the registry's bf16 net against
# float32: within max(ZOO_FLOOR_PX, this many times the CPU's own bf16 gap)
OTHER_WITNESS_FACTOR = 2.0
HG_BATCH = 8
MESH_FEATURES = (8, 64, 64, 480)   # the w32 HRNet's features at 256 px
MESH_LIMIT = 1e-5                  # card vs CPU, float32, relative to the largest value
LBS_BATCH = 64
MANO_SIZE = dict(n_verts=778, n_joints=16, n_shape=10)
MANO_FACES = 1538
RENDER_SIZE = 256
NMS_BOXES, OKS_POSES = 2000, 200
SAT_SHAPE = (32, 21, 64)           # scale_aware_gaussian_targets: B, K, res


def ftl_cfg(out_dir: str = ""):
    """experiments/MHP/MHP_HRNet_w32_softmax_pose2dloss_FTL_v1.yaml's MODEL,
    LOSS and TRAIN sections set in code (the card's machine may lack
    PyYAML): w32 at 256/64, HEATMAP_SOFTMAX, the temperature frozen, the 2D
    and 3D pose losses, adam at 1e-3, 4 views, TEST.IMAGES_PER_GPU 2."""
    cfg = load_config(opts=[
        "MODEL.NAME", "FTL", "MODEL.IMAGE_SIZE", [ZOO_IMAGE] * 2, "MODEL.HEATMAP_SIZE",
        [ZOO_HM] * 2, "MODEL.SIGMA", 2, "MODEL.HEATMAP_SOFTMAX", True,
        "MODEL.TRAINABLE_SOFTMAX", False, "DATASET.NUM_VIEWS", FTL_VIEWS,
        "DATASET.DATASET", ["MHP_mv"], "DATASET.TEST_DATASET", ["MHP_mv"],
        "LOSS.WITH_HEATMAP_LOSS", False, "LOSS.WITH_POSE2D_LOSS", True,
        "LOSS.WITH_POSE3D_LOSS", True, "TRAIN.OPTIMIZER", "adam", "TRAIN.LR", 1e-3,
        "TRAIN.IMAGES_PER_GPU", 1, "TEST.IMAGES_PER_GPU", FTL_BATCH, "TEST.FLIP_TEST", False,
        "DEBUG.DEBUG", False, "EXP_NAME", "chip_smoke_ftl", "OUTPUT_DIR", out_dir], freeze=False)
    cfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
    return cfg.freeze()


def witness_gate(label, what, card, cpu32, cpu64, factor=OTHER_WITNESS_FACTOR):
    """The card's float32 ``card`` (its first samples, on the CPU) against
    the CPU's float64: within ``factor`` times the CPU's own float32 gap.
    Returns (gap, witness)."""
    gap = (card.double() - cpu64).abs().max().item()
    wit = (cpu32.double() - cpu64).abs().max().item()
    ok = 0 < wit and gap <= factor * wit
    print(f"{label} {what}: float32 card vs the CPU's float64 max {gap:.3g} (limit {factor:g} x "
          f"the witness, the CPU's float32 vs its float64: {wit:.3g}){'' if ok else ' FAILED'}")
    if not ok:
        raise AssertionError(f"{label} {what}: {gap} from float64, witness {wit}")
    return gap, wit


def sii64(kp2d, extr, intr):
    """The float64 SII of (B, V, K, 2) detections (C3's rule: each side held
    to the float64 triangulation of its own detections)."""
    from hrnet_hand_pose_estimation_tpu_torch.ops.geometry import (compose_projection,
                                                                    triangulate_sii)

    b, v, k, _ = kp2d.shape
    proj = compose_projection(intr.double()[:, None], extr.double())
    return triangulate_sii(kp2d.double().transpose(1, 2), proj[:, None].expand(b, k, v, 3, 4))


def ftl_phases(smi, kernels):
    """FTL at its YAML's widths: the float32 forward on the card against the
    CPU's float64, the registry's bf16 net against float32, one B4 launch a
    forward held to its twin, the gradient of sum(keypoints_3d) (one B4
    backward launch, none into the backbone, held to the twin-decoded
    gradient by a witness), the forward's time, and C21."""
    from hrnet_hand_pose_estimation_tpu_torch.models import ftl
    from hrnet_hand_pose_estimation_tpu_torch.models.ftl import FTLMultiviewNet, seeded_cameras

    b4 = next(k for k in kernels if k["name"] == "fused_softmax_decode")
    dev = torch.device("cuda")
    none = {fn.__name__: 0 for fn in COUNTED}
    with phase("FTL forward"), tempfile.TemporaryDirectory() as tmp:
        cfg = ftl_cfg(tmp)
        state = init_variables(cfg, 0, device=dev)
        card = build_model(cfg)
        card.load_state_dict(state)
        card.to(dev).eval()
        f32 = FTLMultiviewNet(hrnet_from_cfg(cfg, head="softmax"), num_views=FTL_VIEWS,
                              dtype=torch.float32)
        f32.load_state_dict(state)
        f32.to(dev).eval()
        x = temporal_frames(70, FTL_BATCH, FTL_VIEWS, dev)
        extr, intr = (t.to(dev) for t in seeded_cameras(FTL_BATCH, FTL_VIEWS, ZOO_IMAGE, 70))
        logits = []
        hook = f32.final_layer.register_forward_hook(lambda m, a, out: logits.append(out))
        launches = []
        with torch.no_grad():
            zero_counters()
            out32 = f32(x, extr, intr)
            torch.cuda.synchronize()
            launches.append(counters())
            zero_counters()
            with torch.autocast("cuda", dtype=torch.bfloat16):
                low = card(x, extr, intr)
            torch.cuda.synchronize()
            launches.append(counters())
        hook.remove()
        lg = logits[0].permute(0, 2, 3, 1)
        twin_gap = (fused_softmax_decode(lg, 1.0) - softmax_decode_reference(lg, 1.0)).abs()
        twin_gap = max(twin_gap.max().item(), (out32.keypoints_2d.reshape(-1, 21, 2)
                                               - softmax_decode_reference(lg, 1.0)).abs().max()
                       .item())
        print(f"FTL forwards B={FTL_BATCH} x {FTL_VIEWS} views (w32 at 256/64, seeded 4-camera "
              f"rig): CUDA launches float32 { {k: v for k, v in launches[0].items() if v} }, "
              f"bf16 { {k: v for k, v in launches[1].items() if v} }; the float32 forward's "
              f"keypoints against its logits decoded by B4's twin max {twin_gap:.3g} px (limit "
              f"1e-4)")
        want = dict(none, fused_softmax_decode=1)
        if launches != [want, want] or not twin_gap <= 1e-4:
            raise AssertionError(f"FTL forward: launches {launches}, B4 vs twin {twin_gap}")

        # the CPU's float32 and bf16 forwards of the batch, float64 of the
        # first sample
        t0 = time.perf_counter()
        cpu = FTLMultiviewNet(hrnet_from_cfg(cfg, head="softmax"), num_views=FTL_VIEWS,
                              dtype=torch.float32)
        cpu.load_state_dict(state)
        cpu.eval()
        every = [t.cpu() for t in (x, extr, intr)]
        args = [t[:1] for t in every]
        with torch.no_grad():
            c32_all = cpu(*every)
            c64 = cpu.double()(*(t.double() for t in args))
            cpu.float()
            card.to("cpu")
            with torch.autocast("cpu", dtype=torch.bfloat16):
                c16 = card(*every)
            card.to(dev)
        cpu_s = time.perf_counter() - t0
        c32 = c32_all._replace(**{f: getattr(c32_all, f)[:1] for f in (
            "keypoints_3d", "keypoints_2d", "heatmaps")})
        first = lambda t: t[:1].cpu()                           # noqa: E731
        witness_gate("FTL", "keypoints_2d (px)", first(out32.keypoints_2d), c32.keypoints_2d,
                     c64.keypoints_2d)
        witness_gate("FTL", "heatmaps", first(out32.heatmaps), c32.heatmaps, c64.heatmaps)
        scale = c64.keypoints_3d.abs().max().item()
        gap3 = (first(out32.keypoints_3d).double() - c64.keypoints_3d).abs().max().item()
        wit3 = (c32.keypoints_3d.double() - c64.keypoints_3d).abs().max().item()
        own = (first(out32.keypoints_3d).double()
               - sii64(first(out32.keypoints_2d), *args[1:])).abs().max().item()
        own_wit = (c32.keypoints_3d.double() - sii64(c32.keypoints_2d, *args[1:])).abs().max(
            ).item()
        print(f"FTL keypoints_3d (max |kp3d| {scale:.4g}): float32 card vs the CPU's float64 max "
              f"{gap3:.3g} (the CPU's float32 vs its float64 {wit3:.3g}); each side against the "
              f"float64 SII of its own detections: card {own:.3g}, CPU float32 {own_wit:.3g}")
        if not (gap3 <= OTHER_WITNESS_FACTOR * wit3
                or own <= OTHER_WITNESS_FACTOR * max(own_wit, 1e-6 * scale)):
            raise AssertionError(f"FTL keypoints_3d: {gap3} (witness {wit3}), own SII {own} "
                                 f"(witness {own_wit})")
        # bf16 on the card against its float32, held to the CPU's own bf16
        # gap on the same inputs (max and mean over the batch's 8 views)
        d16 = (low.keypoints_2d - out32.keypoints_2d).abs()
        wit16 = (c16.keypoints_2d - c32_all.keypoints_2d).abs()
        limit = max(ZOO_FLOOR_PX, OTHER_WITNESS_FACTOR * wit16.max().item())
        spread = out32.keypoints_2d.std(dim=(0, 1, 2)).min().item()
        print(f"FTL the registry's net (its convs in bf16, the backbone under a bf16 autocast) vs "
              f"float32 on the card, B={FTL_BATCH} x {FTL_VIEWS} views: max "
              f"{d16.max().item():.4f} px (limit {limit:.4f} = max({ZOO_FLOOR_PX}, "
              f"{OTHER_WITNESS_FACTOR:g} x the CPU's bf16 vs float32 on the same inputs, "
              f"{wit16.max().item():.4f})), mean {d16.mean().item():.4f} px (limit "
              f"{OTHER_WITNESS_FACTOR:g} x the witness's {wit16.mean().item():.4f}); coordinate "
              f"spread {spread:.3f} px; CPU forwards {cpu_s:.1f} s")
        if not (d16.max().item() <= limit
                and d16.mean().item() <= OTHER_WITNESS_FACTOR * wit16.mean().item()
                and torch.isfinite(low.keypoints_3d).all()):
            raise AssertionError(f"FTL bf16: {d16.max().item()} px, limit {limit}")

        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            fwd_ms, peak, wall, busy, parts = step_cost(lambda: card(x, extr, intr),
                                                        B4_KERNEL_NAMES)
        print(f"FTL bf16 forward B={FTL_BATCH} x {FTL_VIEWS} views: {fwd_ms:.3f} ms (CUDA events), "
              f"peak memory {peak:.2f} GiB, kernels {busy:.3f} of {wall:.3f} ms ({busy / wall:.1%} "
              f"busy), B4 {parts[B4_KERNEL_NAMES[0]]:.4f} ms a forward, on {smi}")
        b4["launches_ftl_forward"] = 1
        b4["ms_ftl"] = time_ms(lambda: fused_softmax_decode(lg, 1.0), 20)
        b4["bound_ms_ftl"] = decode_work(lg, out32.keypoints_2d)[0]
        print(f"B4 at FTL's logits ({tuple(lg.shape)} {lg.dtype}): {b4['ms_ftl']:.4f} ms a call "
              f"(CUDA events), bound {b4['bound_ms_ftl']:.5f} ms, on {smi}")
        del card, cpu, logits, lg, low

    with phase("FTL gradient"):
        head = [n for n, _ in f32.named_parameters() if not n.startswith("backbone.")]
        runs = {}
        for name, decode in (("kernel", ftl.softmax_decode), ("twin", softmax_decode_reference),
                             ("witness", lambda lg_, t: decode_moved(lg_, t))):
            f32.zero_grad(set_to_none=True)
            zero_counters()
            fused_softmax_decode.launches_bwd = 0
            with patched(ftl, "softmax_decode", decode):
                f32(x, extr, intr).keypoints_3d.sum().backward()
            torch.cuda.synchronize()
            launched = (fused_softmax_decode.launches, fused_softmax_decode.launches_bwd)
            if launched != ((1, 1) if name == "kernel" else (0, 0)):
                raise AssertionError(f"FTL gradient: B4 launches {launched} in the {name} run")
            grads = dict(f32.named_parameters())
            if any(p.grad is not None for n, p in grads.items() if n.startswith("backbone.")):
                raise AssertionError("FTL gradient reached the frozen backbone")
            runs[name] = torch.cat([grads[n].grad.reshape(-1) for n in head])
        twin = runs["twin"]
        rel = ((runs["kernel"] - twin).norm() / twin.norm()).item()
        wit = ((runs["witness"] - twin).norm() / twin.norm()).item()
        limit = T3_WITNESS_FACTOR * wit + T3_GRAD_FLOOR
        print(f"FTL gradient of sum(keypoints_3d), float32, eval mode: one B4 forward and one B4 "
              f"backward launch, no backbone gradient; the head's gradient ({len(head)} tensors) "
              f"decoded by B4 vs by its twin, relative {rel:.3g} (limit {limit:.3g} = "
              f"{T3_WITNESS_FACTOR:g} x the witness's {wit:.3g} + {T3_GRAD_FLOOR:g}; the witness: "
              f"the twin moved by {T3_WITNESS_PX} px)")
        if not (rel <= limit and torch.isfinite(twin).all() and twin.norm() > 0):
            raise AssertionError(f"FTL gradient: {rel}, limit {limit}")
        b4["launches_ftl_grad"] = 1
        b4["launches_bwd_ftl_grad"] = 1
        del f32, runs

    with phase("FTL C21"), tempfile.TemporaryDirectory() as tmp:
        if importlib.util.find_spec("yaml") is not None:
            cmd = [sys.executable, "-m", "hrnet_hand_pose_estimation_tpu_torch.tools.train",
                   "--cfg", str(FTL_YAML), "--device", "cuda", "OUTPUT_DIR", tmp]
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 cwd=Path(__file__).resolve().parent, timeout=120)
            last = (res.stderr.strip().splitlines() or [""])[-1]
            print(f"python -m ...tools.train --cfg {FTL_YAML.name} --device cuda: rc "
                  f"{res.returncode}; {last[:200]}")
            if res.returncode == 0 or "NotImplementedError" not in last or "C21" not in last:
                raise AssertionError(f"tools.train on the FTL YAML did not raise C21:\n"
                                     f"{res.stderr[-2000:]}")
        else:
            print("no PyYAML on this machine: the train tool's Trainer in process on the FTL "
                  "YAML's tree built in code")
            refused("FTL tools.train", "C21", {"Trainer": lambda: Trainer(
                ftl_cfg(tmp), build_model(ftl_cfg(tmp)), {}, device=dev)})
        model = build_model(cfg)
        refused("FTL", "C21", {
            "create_train_state": lambda: TS.create_train_state(cfg, model, device=dev),
            "make_train_step": lambda: TS.make_train_step(cfg, model, None),
            "make_eval_step": lambda: TS.make_eval_step(cfg, model),
            "Evaluator2D": lambda: Evaluator2D(cfg, model, None, device=dev)})
        del model


def hourglass_cfg():
    """HourGlass (no shipped YAML): NUM_STACKS 2, DEPTH 2, 21 joints, 256 px."""
    cfg = load_config(opts=["MODEL.NAME", "HourGlass", "MODEL.IMAGE_SIZE", [ZOO_IMAGE] * 2,
                            "MODEL.HEATMAP_SIZE", [ZOO_HM] * 2, "MODEL.NUM_JOINTS", 21,
                            "TEST.IMAGES_PER_GPU", HG_BATCH, "OUTPUT_DIR", ""], freeze=False)
    cfg.MODEL.EXTRA.merge_from_mapping({"NUM_STACKS": 2, "DEPTH": 2})
    return cfg.freeze()


def hourglass_phases(smi):
    dev = torch.device("cuda")
    none = {fn.__name__: 0 for fn in COUNTED}
    with phase("HourGlass forward"):
        cfg = hourglass_cfg()
        state = init_variables(cfg, 0, device=dev)
        card, cpu = build_model(cfg), build_model(cfg)
        card.load_state_dict(state)
        cpu.load_state_dict(state)
        card.to(dev).eval()
        x = zoo_images(71, HG_BATCH, dev)
        stack = lambda out: torch.stack(out[0], 0)           # noqa: E731  (S, B, h, w, K)
        zero_counters()
        with torch.no_grad():
            f32 = stack(card(x))
            with torch.autocast("cuda", dtype=torch.bfloat16):
                low = stack(card(x))
            xc = x[:2].cpu()
            c32 = stack(cpu(xc))
            with torch.autocast("cpu", dtype=torch.bfloat16):
                c16 = stack(cpu(xc))
            c64 = stack(cpu.double()(xc.double()))
        torch.cuda.synchronize()
        print(f"HourGlass B={HG_BATCH} (2 stacks, depth 2, conv64 stem, batch norm, 256 px): "
              f"maps {tuple(f32.shape[1:])} per stack, std {f32.std().item():.3f}")
        witness_gate("HourGlass", "maps (tanh)", f32[:, :2].cpu(), c32, c64)
        d16 = (low - f32).abs()
        wit16 = (c16 - c32).abs().max().item()
        limit = OTHER_WITNESS_FACTOR * wit16
        print(f"HourGlass bf16 vs float32 on the card: first two samples max "
              f"{d16[:, :2].max().item():.4f}, all {d16.max().item():.4f}, mean "
              f"{d16.mean().item():.5f} (limit {limit:.4f} = {OTHER_WITNESS_FACTOR:g} x the CPU's "
              f"bf16 vs float32 {wit16:.4f})")
        if counters() != none or not (0 < wit16 and d16[:, :2].max().item() <= limit):
            raise AssertionError(f"HourGlass bf16: {d16.max().item()}, limit {limit}, "
                                 f"{counters()}")
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            ms, peak, wall, busy, _ = step_cost(lambda: card(x))
        print(f"HourGlass bf16 forward B={HG_BATCH}: {ms:.3f} ms (CUDA events), peak memory "
              f"{peak:.2f} GiB, kernels {busy:.3f} of {wall:.3f} ms ({busy / wall:.1%} busy), "
              f"on {smi}")
        model = build_model(cfg)
        TS.create_train_state(cfg, model, device=dev)
        refused("HourGlass", "C22", {
            "make_train_step": lambda: TS.make_train_step(cfg, model, None),
            "make_eval_step": lambda: TS.make_eval_step(cfg, model),
            "make_forward_fn": lambda: TS.make_forward_fn(cfg, model),
            "Evaluator2D": lambda: Evaluator2D(cfg, model, None, device=dev)})
        del card, cpu, model


def rel_max(got, want) -> float:
    """max |got - want| over max |want| (got on the card, want on the CPU)."""
    return ((got.cpu().double() - want.double()).abs().max() / want.double().abs().max()).item()


def seeded_faces(verts: np.ndarray, n_faces: int, rng) -> np.ndarray:
    """Triangles joining a vertex to two of its five nearest neighbours."""
    d = ((verts[:, None] - verts[None]) ** 2).sum(-1)
    near = np.argsort(d, axis=1)[:, 1:6]
    a = rng.integers(0, len(verts), n_faces)
    pick = np.argsort(rng.uniform(size=(n_faces, 5)), axis=1)[:, :2]
    return np.stack([a, near[a, pick[:, 0]], near[a, pick[:, 1]]], 1).astype(np.int32)


def edge_band(verts, faces, f, c, size, near, far, eps=1e-4):
    """(H, W) pixels within ``eps`` (barycentric, float64) of an edge of a
    triangle that covers them: there float32 rounding decides coverage."""
    z = np.maximum(verts[:, 2].astype(np.float64), 1e-6)
    u, v = f * verts[:, 0] / z + c[0], f * verts[:, 1] / z + c[1]
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float64)
    band = np.zeros((size, size), bool)
    for tri in faces:
        (x0, x1, x2), (y0, y1, y2) = u[tri], v[tri]
        den = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        if abs(den) < 1e-8:
            continue
        lo, hi = int(max(min(y0, y1, y2) - 1, 0)), int(min(max(y0, y1, y2) + 2, size))
        le, ri = int(max(min(x0, x1, x2) - 1, 0)), int(min(max(x0, x1, x2) + 2, size))
        if lo >= hi or le >= ri:
            continue
        py, px = ys[lo:hi, le:ri], xs[lo:hi, le:ri]
        l0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) / den
        l1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) / den
        l2 = 1.0 - l0 - l1
        depth = l0 * verts[tri[0], 2] + l1 * verts[tri[1], 2] + l2 * verts[tri[2], 2]
        band[lo:hi, le:ri] |= ((np.abs(np.minimum(np.minimum(l0, l1), l2)) <= eps)
                               & (depth > near) & (depth < far))
    return band


def device_loop_nms(dets, thresh):
    """The JAX package's greedy scan as written there (a loop over the rows
    of the sorted IoU matrix), run on the card op by op: the yardstick for
    the port's host scan."""
    from hrnet_hand_pose_estimation_tpu_torch.ops.nms import iou_matrix

    order = torch.argsort(-dets[:, 4], stable=True)
    ious = iou_matrix(dets[:, :4])[order][:, order]
    n = dets.shape[0]
    idx = torch.arange(n, device=dets.device)
    keep = torch.ones(n, dtype=torch.bool, device=dets.device)
    for i in range(n):
        keep = keep & ~((idx > i) & (ious[i] > thresh) & keep[i])
    out = torch.zeros_like(keep)
    out[order] = keep
    return out


def mesh_phases(smi):
    """The mesh family on the card against the CPU: HandMeshNet on w32-wide
    features, LBS on a MANO-sized rig, MeshRenderer at 256 px, NMS,
    soft-NMS and OKS-NMS, the scale-aware targets; each timed."""
    from hrnet_hand_pose_estimation_tpu_torch.models.mano import lbs, toy_hand_model
    from hrnet_hand_pose_estimation_tpu_torch.models.mesh import build_hand_mesh_net
    from hrnet_hand_pose_estimation_tpu_torch.ops import nms as NMS
    from hrnet_hand_pose_estimation_tpu_torch.ops.targets import scale_aware_gaussian_targets
    from hrnet_hand_pose_estimation_tpu_torch.utils.renderer import MeshRenderer

    dev = torch.device("cuda")
    rng = np.random.default_rng(80)
    with phase("mesh family"):
        # the graph CNN on the bone graph, w32-wide features
        net = build_hand_mesh_net()
        TS.init_train_weights(net, 0)
        with torch.no_grad():
            for p in net.parameters():
                if p.dim() == 1:
                    p.copy_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
        feats = torch.from_numpy(rng.normal(size=MESH_FEATURES).astype(np.float32))
        with torch.no_grad():
            want = net(feats)
            card, feats = net.to(dev), feats.to(dev)
            got = card(feats)
            ms = time_ms(lambda: card(feats), 20)
        gaps = [rel_max(g, w) for g, w in zip(got, want)]
        print(f"HandMeshNet (bone graph, 2 coarsening levels, Chebyshev order 3) on "
              f"{MESH_FEATURES} features: mesh {tuple(got[0].shape)}, pose {tuple(got[1].shape)}; "
              f"card vs CPU (float32, TF32 off) relative {gaps[0]:.3g} / {gaps[1]:.3g} (limit "
              f"{MESH_LIMIT:g}); {ms:.4f} ms a call (CUDA events) on {smi}")
        if not max(gaps) <= MESH_LIMIT:
            raise AssertionError(f"HandMeshNet card vs CPU: {gaps}")

        # LBS on a MANO-sized rig with nonzero pose blendshapes
        rig = toy_hand_model(**MANO_SIZE, seed=81, device="cpu")
        rig = rig._replace(posedirs=torch.from_numpy(rng.normal(
            scale=0.01, size=tuple(rig.posedirs.shape)).astype(np.float32)))
        rig_dev = rig._replace(**{f: getattr(rig, f).to(dev) for f in (
            "v_template", "shapedirs", "posedirs", "j_regressor", "weights")})
        j = MANO_SIZE["n_joints"]
        pose = torch.from_numpy(rng.normal(scale=0.4, size=(LBS_BATCH, j, 3)).astype(np.float32))
        betas = torch.from_numpy(rng.normal(size=(LBS_BATCH, 10)).astype(np.float32))
        transl = torch.from_numpy(rng.normal(size=(LBS_BATCH, 3)).astype(np.float32))
        want = lbs(rig, pose, betas, transl)
        args = [t.to(dev) for t in (pose, betas, transl)]
        got = lbs(rig_dev, *args)
        gaps = [rel_max(g, w) for g, w in zip(got, want)]
        ms = time_ms(lambda: lbs(rig_dev, *args), 20)
        print(f"lbs B={LBS_BATCH} on a MANO-sized rig ({MANO_SIZE}, 135 pose-blendshape columns): "
              f"card vs CPU relative vertices {gaps[0]:.3g}, joints {gaps[1]:.3g} (limit "
              f"{MESH_LIMIT:g}); {ms:.3f} ms a call (CUDA events) on {smi}")
        if not max(gaps) <= MESH_LIMIT:
            raise AssertionError(f"lbs card vs CPU: {gaps}")

        # the renderer: the first posed hand, 1538 seeded faces, 256 px
        verts = want[0][0].numpy() - want[0][0].numpy().mean(0)
        verts = (verts / np.abs(verts).max() * 0.3 + [0.0, 0.0, 0.6]).astype(np.float32)
        faces = seeded_faces(verts, MANO_FACES, rng)
        renders = {}
        for where in ("cpu", "cuda"):
            r = MeshRenderer(faces, img_size=RENDER_SIZE, flength=500.0, device=where)
            renders[where] = r(verts, do_alpha=True)
        near = max(float(verts[:, 2].min()) - 25.0, 0.1)
        far = max(float(verts[:, 2].max()) + 25.0, 25.0)
        band = edge_band(verts, faces, 500.0, (RENDER_SIZE / 2, RENDER_SIZE / 2), RENDER_SIZE,
                         near, far)
        cov_c, cov_g = renders["cpu"][..., 3] > 0, renders["cuda"][..., 3] > 0
        differ = cov_c != cov_g
        col = np.abs(renders["cpu"][..., :3].astype(int) - renders["cuda"][..., :3].astype(int))
        r = MeshRenderer(faces, img_size=RENDER_SIZE, flength=500.0, device="cuda")
        t0 = time.perf_counter()
        for _ in range(3):
            r(verts)
        render_ms = (time.perf_counter() - t0) / 3 * 1e3
        print(f"MeshRenderer {RENDER_SIZE} px, {len(verts)} vertices, {len(faces)} faces: "
              f"coverage {cov_c.mean():.1%}; card vs CPU coverage differs on {differ.sum()} "
              f"pixels ({differ.mean():.3%}, limit 0.5 %), {(differ & ~band).sum()} off the edge "
              f"band (limit 0); colours off the band max {col[~band].max()} / 255 (limit 1); "
              f"{render_ms:.2f} ms a render to a uint8 image on the host (host clock) on {smi}")
        if not (differ.mean() <= 0.005 and not (differ & ~band).any() and col[~band].max() <= 1
                and cov_c.mean() > 0.05):
            raise AssertionError("MeshRenderer card vs CPU")

        # NMS, soft-NMS, OKS-NMS
        n = NMS_BOXES
        centres = rng.uniform(0, 1000, size=(n // 8, 2))[rng.integers(0, n // 8, n)]
        xy = centres + rng.normal(scale=15, size=(n, 2))
        wh = rng.uniform(20, 120, size=(n, 2))
        dets = torch.from_numpy(np.concatenate([xy, xy + wh, rng.uniform(0.01, 1, (n, 1))],
                                               1).astype(np.float32))
        dd = dets.to(dev)
        keep_c, keep_g = NMS.nms(dets, 0.5), NMS.nms(dd, 0.5)
        keep_loop = device_loop_nms(dd, 0.5)
        nms_ms = time_ms(lambda: NMS.nms(dd, 0.5), 5, warmup=1)
        loop_ms = time_ms(lambda: device_loop_nms(dd, 0.5), 1, warmup=1)
        soft = {m: (NMS.soft_nms(dets, method=m), NMS.soft_nms(dd, method=m))
                for m in ("gaussian", "linear")}
        soft_gap = max((g.cpu() - c).abs().max().item() for c, g in soft.values())
        soft_ms = time_ms(lambda: NMS.soft_nms(dd), 1, warmup=1)
        kp = rng.uniform(0, 500, size=(OKS_POSES // 5, 17, 2))[rng.integers(0, OKS_POSES // 5,
                                                                            OKS_POSES)]
        kp = np.concatenate([kp + rng.normal(scale=1.5, size=kp.shape),
                             (rng.uniform(size=(OKS_POSES, 17, 1)) > 0.2)], -1).astype(np.float32)
        sc = rng.uniform(0.1, 1, OKS_POSES).astype(np.float32)
        ar = rng.uniform(2000, 20000, OKS_POSES).astype(np.float32)
        oks = [torch.from_numpy(a) for a in (kp, sc, ar)]
        oks_c = NMS.oks_nms(oks[0], oks[1], oks[2], 0.9)
        oks_g = NMS.oks_nms(*(t.to(dev) for t in oks[:2]), oks[2].to(dev), 0.9)
        print(f"nms on {n} seeded boxes (IoU 0.5): {int(keep_g.sum())} kept, card == CPU "
              f"{bool((keep_g.cpu() == keep_c).all())}, == the device-loop yardstick "
              f"{bool((keep_loop.cpu() == keep_c).all())}; {nms_ms:.3f} ms a call (IoU matrix on "
              f"the card, the scan on the host) vs {loop_ms:.1f} ms for JAX's loop run on the card "
              f"op by op; soft_nms (gaussian, linear) card vs CPU max {soft_gap:.3g} (limit 1e-5), "
              f"{soft_ms:.1f} ms a call; oks_nms on {OKS_POSES} 17-keypoint poses: "
              f"{int(oks_g.sum())} kept, card == CPU {bool((oks_g.cpu() == oks_c).all())}; "
              f"CUDA events, on {smi}")
        if not ((keep_g.cpu() == keep_c).all() and (keep_loop.cpu() == keep_c).all()
                and (oks_g.cpu() == oks_c).all() and soft_gap <= 1e-5
                and 0 < int(keep_c.sum()) < n and 0 < int(oks_c.sum()) < OKS_POSES):
            raise AssertionError("nms / soft_nms / oks_nms card vs CPU")

        # the scale-aware targets
        b, k, res = SAT_SHAPE
        joints = torch.from_numpy(rng.uniform(-2, res + 2, size=(b, k, 2)).astype(np.float32))
        vis = torch.from_numpy((rng.uniform(size=(b, k)) > 0.1).astype(np.float32))
        sig = torch.from_numpy(rng.uniform(1.0, 4.0, size=(b, k)).astype(np.float32))
        want = scale_aware_gaussian_targets(joints, vis, sig, res)
        args = [t.to(dev) for t in (joints, vis, sig)]
        got = scale_aware_gaussian_targets(*args, res)
        gap = (got.cpu() - want).abs().max().item()
        ms = time_ms(lambda: scale_aware_gaussian_targets(*args, res), 20)
        print(f"scale_aware_gaussian_targets B={b}, K={k}, res {res}, sigmas 1-4: card vs CPU max "
              f"{gap:.3g} (limit 1e-6); {ms:.4f} ms a call, bound "
              f"{bound(0, 0, got.numel() * 4 + 3 * b * k * 4)[0]:.4f} ms (the maps written once), "
              f"on {smi}")
        if not gap <= 1e-6:
            raise AssertionError(f"scale_aware_gaussian_targets card vs CPU: {gap}")


# -- C9: the repo's smoke model served on the card --------------------------

SMOKE_YAML = Path(__file__).resolve().parent / "experiments" / "synthetic_smoke.yaml"
SMOKE_WIDTHS = (8, 16, 32, 64)


def smoke_cfg():
    """experiments/synthetic_smoke.yaml through the port's load_config; where
    PyYAML is missing, the same tree built in code.  Returns (cfg, origin)."""
    if importlib.util.find_spec("yaml") is not None:
        return load_config(str(SMOKE_YAML)), f"read from {SMOKE_YAML.name}"
    cfg = load_config(opts=["EXP_NAME", "synthetic_smoke", "MODEL.NAME", "pose_hrnet_softmax",
                            "MODEL.NUM_JOINTS", 21, "MODEL.IMAGE_SIZE", [64, 64],
                            "MODEL.HEATMAP_SIZE", [16, 16], "MODEL.SIGMA", 2,
                            "MODEL.HEATMAP_SOFTMAX", True, "MODEL.TRAINABLE_SOFTMAX", True,
                            "DATASET.DATASET", ["Synthetic_kpt"],
                            "DATASET.TEST_DATASET", ["Synthetic_kpt"], "DATASET.NUM_JOINTS", 21,
                            "DATASET.SIGMA", 2, "TEST.IMAGES_PER_GPU", 4, "WORKERS", 2],
                      freeze=False)
    stage = lambda n: dict(NUM_MODULES=1, NUM_BRANCHES=n, BLOCK="BASIC", NUM_BLOCKS=[1] * n,
                           NUM_CHANNELS=list(SMOKE_WIDTHS[:n]), FUSE_METHOD="SUM")
    cfg.MODEL.EXTRA.merge_from_mapping(dict(FINAL_CONV_KERNEL=1, STAGE2=stage(2),
                                            STAGE3=stage(3), STAGE4=stage(4)))
    return cfg.freeze(), "built in code as synthetic_smoke.yaml's tree (no PyYAML here)"


def smoke_gate(label, coords, plain, batch):
    """The small models' decode gate of the card tests: within 0.25 px of
    the same forward through the twins."""
    diff = (coords - plain).abs()
    print(f"{label}: {tuple(coords.shape)}, vs its plain-twin path max |d| "
          f"{diff.max().item():.5f} px (limit 0.25), mean {diff.mean().item():.5f} px")
    if coords.shape != (batch, 21, 2) or not torch.isfinite(coords).all():
        raise AssertionError(f"{label}: bad output, shape {tuple(coords.shape)}")
    if not diff.max().item() <= 0.25:
        raise AssertionError(f"{label}: kernel path disagrees with its plain path")


def c9_phases(smi):
    """The smoke model (branches 8/16/32/64, a head 120 wide, a 2x2 coarsest
    map at 64x64) served on the card through the bf16 path (defaults and
    NEW_CONFIG) and the int8 path at B=1 and B=4, each against its twin
    path with the launch counters checked; then the serving CLIs on it."""
    dev = torch.device("cuda")
    with phase("C9 smoke model served"):
        cfg, origin = smoke_cfg()
        extra = cfg.MODEL.EXTRA
        print(f"smoke config {origin}: branches {list(extra['STAGE4']['NUM_CHANNELS'])}, "
              f"image {list(cfg.MODEL.IMAGE_SIZE)}")
        state = {k: v.to(dev) for k, v in init_variables(cfg, seed=0, device=dev).items()}
        weights = precast_variables(cfg, state, device=dev)
        print("branch chains served at widths "
              f"{sorted({p[0].shape[-1] for p in weights.branches.values()})} (padded once)")
        n_blocks = sum(len(p) // 4 for p in weights.branches.values())
        n_sites = len(Q.quant_sites(cfg, "exchange", stem2=True))
        size = int(cfg.MODEL.IMAGE_SIZE[0])
        qinfer = Q.make_quant_infer(cfg, device=dev, input_norm=NORM)
        for batch in (1, 4):
            rng = np.random.default_rng(100 + batch)
            images = torch.from_numpy(rng.normal(size=(batch, size, size, 3)).astype(
                np.float32)).to(dev)
            for label, kwargs, parts, want in (
                    ("defaults", {}, dict(layer1=nchw(layer1_reference, weights)),
                     dict(fused_bottleneck_chain=4, fused_head_decode_v2=1)),
                    ("pallas_branches + fuse_stem_layer1", NEW_CONFIG,
                     new_parts(weights, twin=True),
                     dict(fused_basic_chain=n_blocks, fused_stem_layer1=5,
                          fused_head_decode_v2=1))):
                infer = make_fast_infer(cfg, device=dev, **kwargs)
                zero_counters()
                coords = infer(weights, images)
                torch.cuda.synchronize()
                launched = {k: v for k, v in counters().items() if v}
                if launched != want:
                    raise AssertionError(f"smoke {label} B={batch}: launches {launched}, "
                                         f"want {want}")
                smoke_gate(f"smoke bf16 {label} B={batch}, launches {launched}", coords,
                           twin_forward(weights, images, **parts), batch)
            with torch.inference_mode():   # the head alone on the smoke model's branches
                xs = [t.permute(0, 2, 3, 1).contiguous()
                      for t in weights.model.forward_backbone(to_input(images))]
                sc = tuple(torch.tensor(v, device=dev) for v in (0.05, 0.05, 0.05, 0.05))
                for inputs, scales, limit in ((xs, None, 0.05),
                                              (head_int8_inputs(xs, sc), sc, 0.1)):
                    err = (fused_head_decode_v2(inputs, weights.head, input_scales=scales)
                           - head_decode_reference(inputs, weights.head, input_scales=scales)
                           ).abs().max().item()
                    print(f"smoke head alone B={batch} {'int8' if scales else 'bf16'}: "
                          f"max|kernel - plain| = {err:.5f} px (limit {limit})")
                    if not err <= limit:
                        raise AssertionError(f"smoke head disagrees with its twin: {err} px")
            if batch == 1:
                print_head_plan(xs, weights.head, "smoke B=1")
            u8 = torch.from_numpy(rng.integers(0, 256, size=(batch, size, size, 3)).astype(
                np.uint8)).to(dev)
            amax = Q.calibrate(cfg, weights, [normalize(u8)])
            qparams = Q.prepare_serving_qparams(cfg, state, amax)
            zero_counters()
            coords = qinfer(weights, qparams, u8)
            torch.cuda.synchronize()
            launched = {k: v for k, v in counters().items() if v}
            want = dict(conv_int8=n_sites, fused_bottleneck_chain_int8=4, fused_head_decode_v2=1)
            if launched != want:
                raise AssertionError(f"smoke int8 B={batch}: launches {launched}, want {want}")
            with twins():
                plain = qinfer(weights, qparams, u8)
            smoke_gate(f"smoke int8 B={batch}, launches {launched}", coords, plain, batch)

    with phase("C9 tools"), tempfile.TemporaryDirectory() as tmp:
        have = {m: importlib.util.find_spec(m) is not None for m in ("yaml", "cv2")}
        if all(have.values()):
            import cv2

            imgs = Path(tmp) / "imgs"
            imgs.mkdir()
            rng = np.random.default_rng(7)
            for i in range(2):
                cv2.imwrite(str(imgs / f"{i}.png"), rng.integers(0, 256, size=(96, 80, 3),
                                                                 dtype=np.uint8))
            tool = "hrnet_hand_pose_estimation_tpu_torch.tools."
            runs = [[tool + "inference", "--serving", mode, "--image_path", str(imgs),
                     "--out_dir", str(Path(tmp) / mode)] for mode in ("fast", "int8")]
            runs.append([tool + "evaluate_2d", "--serving", "int8", "--out", str(Path(tmp) / "ev")])
            # the three tool processes at once (each takes seconds to reach the card)
            procs = [(args, background(
                [sys.executable, "-m", args[0], "--cfg", str(SMOKE_YAML), "--device", "cuda",
                 *args[1:]], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=Path(__file__).resolve().parent)) for args in runs]
            for args, proc in procs:
                out, err = proc.communicate(timeout=300)
                tail = (out + err).strip().splitlines()[-3:]
                print(f"python -m {args[0]} --cfg {SMOKE_YAML.name} {' '.join(args[1:3])} "
                      f"--device cuda: rc {proc.returncode}; " + " | ".join(tail))
                if proc.returncode != 0:
                    raise AssertionError(f"{args[0]} {args[1:3]} failed:\n{out}\n{err}")
        else:
            # no PyYAML or cv2 on this machine: the tools' own functions on the
            # same config, in this process
            print(f"tools' modules present: {have}; running their serving and evaluation "
                  "functions in process on the config built in code")
            cfg, _ = smoke_cfg()
            state = init_variables(cfg, seed=0, device=dev)
            frames = np.random.default_rng(7).normal(size=(2, 64, 64, 3)).astype(np.float32)
            for mode in ("fast", "int8"):
                fwd = make_serving_fn(cfg, state, mode, list(frames), device=dev)
                _, pose = fwd(torch.from_numpy(frames[:1]).to(dev))
                torch.cuda.synchronize()
                print(f"tools.inference.make_serving_fn({mode!r}) B=1: {tuple(pose.shape)}")
                if tuple(pose.shape) != (1, 21, 2) or not torch.isfinite(pose).all():
                    raise AssertionError(f"serving fn {mode} gave a bad output")
            res = tool_eval.evaluate(cfg, state=state, serving="int8", out=tmp, device=dev)
            print(f"tools.evaluate_2d.evaluate(serving='int8'): {json.dumps(res)}")


# -- the dataset readers ------------------------------------------------------

READER_TRAIN = 32           # RHD_kpt / FreiHand_kpt IMAGES_PER_GPU
READER_3D_BATCH = 2         # VolTriangulation_MHP_v2 IMAGES_PER_GPU
# what the other readers' trees hold where their formats ship PNG; the rest
# ship JPEG, and their trees hold PNG content under the JPEG names
READER_PNG = {"HandGraph_kpt": "PNG, all five filters", "STB": "PNG, Sub rows"}
# the YAML that names each reader and its WORKERS (threads of the port's
# loader); STB, COCO and MPII are named by no YAML: the default, 4
READER_LOADERS = (
    ("MHP", False, "MHP/MHP_HRNet_w32_softmax_hmloss_v1.yaml", 4),
    ("MHP_kpt", True, "MHP/MHP_HRNet_w32_trainable_softmax_pose2dloss_v1.yaml", 8),
    ("MHP_CPM_kpt", True, "MHP/MHP_CPM_v1.yaml", 0),
    ("MHP_CPM_mv", True, "LearnableTriangulation/VolTriangulation_MHP_CPM_v1.yaml", 8),
    ("MHP_seq", True, "MHP/MHP_HRNet_w32_trainable_softmax_pose2dloss_PoseAggr_v1.yaml", 2),
    ("HandGraph_kpt", True, "HandGraph/HG_w32_256x256_adam_lr1e-3.yaml", 4),
    ("FHA_kpt", True, "FHA/FHA_w32_256x256_adam_lr1e-3.yaml", 0),
    ("STB", False, "", 4),
    ("COCO", False, "", 4),
    ("MPII", False, "", 4),
)


def reader_trees():
    """tests/torch_reader_trees.py, loaded by path: the CPU reader tests'
    tree writer (PNG content written with zlib; no cv2, no JAX)."""
    path = Path(__file__).resolve().parent / "tests" / "torch_reader_trees.py"
    spec = importlib.util.spec_from_file_location("torch_reader_trees", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_reader_trees(root: str):
    """Every format's tree under ``root``, the writers run in threads (zlib
    and numpy release the GIL): RHD's 320x320 frames (64 training, 32
    evaluation crops), FreiHand's 224x224 (32 + 32), MHP's 640x480 x 4
    cameras (data_1: 10 frames, data_17: 4), HandGraph's 360x360 RGBA, FHA's
    1920x1080, STB's 640x480, COCO's and MPII's 160x160.  RHD's and
    HandGraph's PNGs cycle the five row filters (the decoder's slow case);
    the others, STB's PNGs and the JPEG formats' PNG content under their
    JPEG names, have Sub rows (cv2.imwrite's default)."""
    from concurrent.futures import ThreadPoolExecutor

    trees = reader_trees()
    jobs = [lambda: trees.write_rhd(root, "training", 2 * READER_TRAIN, seed=0,
                                    filters="mixed"),
            lambda: trees.write_rhd(root, "evaluation", READER_TRAIN, seed=1, filters="mixed"),
            lambda: trees.write_freihand(root, READER_TRAIN, READER_TRAIN),
            lambda: trees.write_mhp(root, {"data_1": 10, "data_17": 4}),
            lambda: trees.write_handgraph(root, 4, 3, filters="mixed"),
            lambda: trees.write_fha(root, "Subject_1", 4),
            lambda: trees.write_stb(root, "B1Counting", 8, set_name="evaluation"),
            lambda: trees.write_coco(root, 8, set_name="evaluation"),
            lambda: trees.write_mpii(root, 8, set_name="evaluation")]
    with ThreadPoolExecutor(max_workers=8) as pool:
        for job in [pool.submit(j) for j in jobs]:
            job.result()
    return trees


def reader_cfg(data_dir: str, out_dir: str, train: str, test: str, **extra):
    """The flagship sections of experiments/RHD/RHD_HRNet_w32_trainable_softmax_
    hm-pose2dloss_v1.yaml set in code (the card's machine may lack PyYAML):
    pose_hrnet_softmax w32 with the trainable softmax at 256/64, heatmap
    loss + 0.1 pose2d loss, adam at LR 1e-3, B=32, one epoch; DEBUG off
    (its image dump needs cv2).  The FreiHand YAML differs in the model name
    (pose_hrnet_trainable_softmax), the augmentation (on) and WORKERS (0)."""
    opts = ["MODEL.NAME", "pose_hrnet_softmax", "MODEL.TRAINABLE_SOFTMAX", True,
            "MODEL.HEATMAP_SOFTMAX", True, "MODEL.IMAGE_SIZE", [256, 256],
            "MODEL.HEATMAP_SIZE", [64, 64], "MODEL.SIGMA", 2, "DATASET.SIGMA", 2,
            "LOSS.WITH_HEATMAP_LOSS", True, "LOSS.HEATMAP_LOSS_FACTOR", 1.0,
            "LOSS.WITH_POSE2D_LOSS", True, "LOSS.POSE2D_LOSS_FACTOR", 0.1,
            "TRAIN.OPTIMIZER", "adam", "TRAIN.LR", 1e-3, "TRAIN.LR_FACTOR", 0.1,
            "TRAIN.LR_STEP", [24, 48, 72], "TRAIN.IMAGES_PER_GPU", READER_TRAIN,
            "TEST.IMAGES_PER_GPU", READER_TRAIN, "TRAIN.BEGIN_EPOCH", 1, "TRAIN.END_EPOCH", 2,
            "DATASET.DATASET", [train], "DATASET.TEST_DATASET", [test], "WORKERS", 4,
            "WITH_DATA_AUG", False, "WITHOUT_EVAL", True, "DEBUG.DEBUG", False,
            "AUTO_RESUME", False, "DATA_DIR", data_dir, "OUTPUT_DIR", out_dir,
            "EXP_NAME", f"chip_smoke_{train}"]
    cfg = load_config(opts=opts, freeze=False)
    cfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
    if extra:
        cfg.merge_from_list([x for key, val in extra.items()
                             for x in (key.replace("__", "."), val)])
    return cfg.freeze()


def loader_rate(loader, min_images: int = 16, min_batches: int = 8):
    """(passes, batches, images, images/s, first batch) of iterating
    ``loader`` on the host in whole passes, until ``min_images`` images and
    ``min_batches`` batches or two passes: the images count every view and
    frame of a sample, and each pass's first batch, which no worker has
    loaded ahead, stays in the clock."""
    t = time.perf_counter()
    passes = n = images = 0
    first = None
    while images < min_images or (n < min_batches and passes < 2):
        for batch in loader:
            first = batch if first is None else first
            images += int(np.prod(np.shape(batch["imgs"])[:-3]))
            n += 1
        passes += 1
    return passes, n, images, images / (time.perf_counter() - t), first


def rate_line(name, loader, workers, decode, smi):
    """The loader's rate as a line, and its first batch."""
    passes, n, imgs, rate, first = loader_rate(loader)
    return (f"{name} loader (WORKERS {workers}; {decode}): {passes} passes, {n} batches, "
            f"{imgs} images, {rate:.1f} images/s on the host on {smi}"), first


def zero_reader_counters():
    zero_counters()
    fused_softmax_decode.launches_bwd = 0


def add_reader_launches(by_name):
    """Adds every counted kernel's launches since zero_reader_counters(),
    B4's backward too, into its entry's launches_readers."""
    for name, n in counters().items():
        by_name[name]["launches_readers"] += n
    by_name["softmax_decode_backward"]["launches_readers"] += fused_softmax_decode.launches_bwd


def decoded_like_twin(label, cfg, model, loader, results, dev):
    """Evaluator2D's results with B4 against the same evaluation decoded by
    its twin (<= 1e-3 apart in every metric: the decode parts by <= 1e-4
    heatmap px, which the crop rescale multiplies by at most 5)."""
    with patched(EV, "softmax_decode", softmax_decode_reference):
        twin = Evaluator2D(cfg, model, None, device=dev).run(loader, label)
    gaps = {k: abs(results[k] - twin[k]) for k in ("EPE_px", "PCK_AUC_30", "PCK_AUC_full")}
    print(f"{label}: decoded by the twin {json.dumps(twin)}; gaps {json.dumps(gaps)} "
          f"(limit 1e-3)")
    if not all(g <= 1e-3 for g in gaps.values()):
        raise AssertionError(f"{label}: B4 and its twin part: {gaps}")


def reader_phases(smi, kernels):
    """The readers on the card: each format's tree written cv2-free, RHD into
    Trainer.fit and Evaluator2D (std through B4 with the crop-corner rescale,
    and int8), FreiHand into a train step, Evaluator2D and its evaluate,
    MHP_mv into Evaluator3D and three Trainer3D steps (vol), and a batch of
    every other reader with its loader's images/s on the host."""
    from hrnet_hand_pose_estimation_tpu_torch.core import trainer3d as T3
    from hrnet_hand_pose_estimation_tpu_torch.core.evaluator3d import Evaluator3D
    from hrnet_hand_pose_estimation_tpu_torch.core.trainer import _batch_for_step
    from hrnet_hand_pose_estimation_tpu_torch.data.build import make_dataloader
    from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import to_device
    from hrnet_hand_pose_estimation_tpu_torch.models import triangulation as TRI
    from hrnet_hand_pose_estimation_tpu_torch.utils.zipreader import IMREAD_UNCHANGED, decode_png

    dev = torch.device("cuda")
    by_name = {k["name"]: k for k in kernels}
    for name in [*counters(), "softmax_decode_backward"]:
        by_name[name]["launches_readers"] = 0
    with tempfile.TemporaryDirectory() as root, tempfile.TemporaryDirectory() as tmp:
        with phase("reader trees"):
            trees = write_reader_trees(root)
            size = sum(f.stat().st_size for f in Path(root).rglob("*") if f.is_file())
            print(f"reader trees (PNG content, also under .jpg / .jpeg names): "
                  f"{sum(1 for _ in Path(root).rglob('*.*'))} files, {size / 2 ** 20:.1f} MiB")
            frame = trees.image(320, 320, 5)
            for filters in ("sub", "mixed"):
                data = trees.png_bytes(frame, filters)
                t = time.perf_counter()
                for _ in range(5):
                    decoded = decode_png(data, IMREAD_UNCHANGED)
                ms = (time.perf_counter() - t) / 5 * 1e3
                if not np.array_equal(decoded, frame[..., ::-1]):
                    raise AssertionError(f"decode_png of a {filters} frame differs")
                print(f"decode_png, a 320x320 RGB frame with {filters} rows: {ms:.2f} ms on the "
                      f"host on {smi}")

        with phase("RHD train"):
            cfg = reader_cfg(root, tmp, "RHD_kpt", "RHD")
            loaders = make_dataloader(cfg, True)
            print(rate_line("RHD_kpt", loaders["RHD_kpt"], 4, "PNG, all five filters; crop, "
                            "warp to 256, targets", smi)[0])
            trainer = Trainer(cfg, build_model(cfg), loaders, None, output_dir=tmp, device=dev)
            epochs = []
            fit_epoch = trainer.train_epoch
            trainer.train_epoch = lambda e: epochs.append(fit_epoch(e)) or epochs[-1]
            zero_reader_counters()
            t = time.perf_counter()
            trainer.fit()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
            add_reader_launches(by_name)
            print(f"Trainer.fit on RHD_kpt: 1 epoch, {trainer.train_global_steps} steps at "
                  f"B={READER_TRAIN} in {sec:.2f} s; epoch averages "
                  f"{json.dumps({k: round(v, 5) for k, v in epochs[0].items()})}; launches "
                  f"{ {k: v for k, v in counters().items() if v} }")
            if trainer.train_global_steps != 2 or not all(np.isfinite(v) for v in
                                                          epochs[0].values()):
                raise AssertionError(f"RHD training: {trainer.train_global_steps} steps, "
                                     f"{epochs}")
            model = trainer.model

        with phase("RHD eval"):
            loader = make_test_dataloader(cfg)["RHD"]
            batch = next(iter(loader))
            crops = np.asarray(batch["crop_size"])
            print(f"raw RHD test set: {len(loader.dataset)} crops of {crops.min():.0f}-"
                  f"{crops.max():.0f} px from 320x320 frames, rescale "
                  f"{loader.dataset.rescale!r}")
            if loader.dataset.rescale != "crop_corner" or crops.min() == crops.max():
                raise AssertionError("RHD's crop-corner rescale is not exercised")
            ev = Evaluator2D(cfg, model, None, device=dev)
            zero_reader_counters()
            results = ev.run(loader, "RHD", tmp)
            torch.cuda.synchronize()
            launches = counters()
            add_reader_launches(by_name)
            want = {fn.__name__: 0 for fn in COUNTED}
            want["fused_softmax_decode"] = len(loader)
            print(f"Evaluator2D std on RHD, {len(loader)} batch of {READER_TRAIN}: launches "
                  f"{launches}; results {json.dumps(results)}")
            if launches != want or not all(np.isfinite(v) for v in results.values()):
                raise AssertionError(f"RHD eval: launches {launches}, results {results}")
            decoded_like_twin("Evaluator2D std on RHD", cfg, model, loader, results, dev)
            zero_reader_counters()
            results8 = Evaluator2D(cfg, model, None, serving="int8", device=dev).run(loader, "RHD")
            torch.cuda.synchronize()
            launches8 = counters()
            add_reader_launches(by_name)
            print(f"Evaluator2D int8 on RHD: launches {launches8}; results {json.dumps(results8)}")
            if not (launches8["conv_int8"] and launches8["fused_bottleneck_chain_int8"]
                    and launches8["fused_head_decode_v2"]) or launches8["fused_softmax_decode"]:
                raise AssertionError(f"RHD int8 eval launches {launches8}")
            if not all(np.isfinite(v) for v in results8.values()):
                raise AssertionError(f"RHD int8 eval results {results8}")
            del trainer, ev, model

        with phase("FreiHand"):
            cfg = reader_cfg(root, tmp, "FreiHand_kpt", "FreiHand", MODEL__NAME=
                             "pose_hrnet_trainable_softmax", WITH_DATA_AUG=True, WORKERS=0,
                             TRAIN__SHUFFLE=False)
            # the tree holds the first 32 samples of each split: one batch each
            loader = make_dataloader(cfg, True)["FreiHand_kpt"]
            loader.dataset.sample_lst = loader.dataset.sample_lst[:READER_TRAIN]
            line, batch = rate_line("FreiHand_kpt", loader, 0, "PNG under .jpg names, Sub rows; "
                                    "augmented", smi)
            print(line)
            batch = _batch_for_step(to_device(batch, dev))
            model = build_model(cfg)
            state, tx = TS.create_train_state(cfg, model, device=dev)
            zero_reader_counters()
            state, losses = TS.make_train_step(cfg, model, tx)(state, batch)
            torch.cuda.synchronize()
            add_reader_launches(by_name)
            host = {k: round(float(v), 5) for k, v in losses.items()}
            print(f"train step on a FreiHand_kpt batch of {READER_TRAIN}: {host}")
            if not all(np.isfinite(v) for v in host.values()) or host.get("nonfinite_grads"):
                raise AssertionError(f"FreiHand step losses {host}")
            test = make_test_dataloader(cfg)["FreiHand"]
            test.dataset.sample_lst = test.dataset.sample_lst[:READER_TRAIN]
            ev = Evaluator2D(cfg, model, None, device=dev)
            zero_reader_counters()
            results = ev.run(test, "FreiHand", tmp)
            torch.cuda.synchronize()
            launched = counters()["fused_softmax_decode"]
            add_reader_launches(by_name)
            print(f"Evaluator2D std on FreiHand: B4 launches {launched}; {json.dumps(results)}")
            if launched != len(test) or not all(np.isfinite(v) for v in results.values()):
                raise AssertionError(f"FreiHand eval: {launched} launches, {results}")
            decoded_like_twin("Evaluator2D std on FreiHand", cfg, model, test, results, dev)
            tb = next(iter(test))
            zero_reader_counters()
            preds = ev.forward(torch.from_numpy(tb["imgs"]).to(dev)).cpu().numpy() * (224 / 64)
            add_reader_launches(by_name)
            res = test.dataset.evaluate(cfg, preds, None, tmp)
            with open(res["res_file"]) as f:
                records = len(json.load(f))
            print(f"FreiHandDataset.evaluate: EPE {res['EPE_px']:.3f} px over {len(preds)} "
                  f"predictions, {records} keypoint records written")
            if records != len(preds) or not np.isfinite(res["EPE_px"]):
                raise AssertionError(f"FreiHandDataset.evaluate: {res}")
            del model, state, ev

        with phase("MHP_mv 3D"):
            cfg = train3d_cfg("vol", tmp, READER_3D_BATCH, dataset="MHP_mv", data_dir=root)
            test = make_test_dataloader(cfg)["MHP_mv"]
            print(rate_line("MHP_mv", test, 4, "4 views of 640x480, PNG under .jpg names, Sub "
                            "rows; the occlusion disc, warps to 256", smi)[0])
            net = TRI.build_triangulation_net(cfg)
            ev = Evaluator3D(cfg, net, init_variables(cfg, 0, device=dev, net="vol"),
                             mode="model", device=dev)
            batch = next(iter(test))
            orig = tuple(test.dataset.orig_img_size)
            images = torch.from_numpy(batch["imgs"]).to(dev)
            proj = ev.projections(batch, orig)
            zero_reader_counters()
            with torch.no_grad():
                got = ev.forward(images, proj)
            torch.cuda.synchronize()
            add_reader_launches(by_name)
            if counters()["fused_softmax_decode"] != 1:
                raise AssertionError(f"MHP_mv vol forward launches {counters()}")
            with patched(TRI, "softmax_decode", softmax_decode_reference), torch.no_grad():
                twin = ev.forward(images, proj)
            mv_gate(f"MHP_mv vol forward B={READER_3D_BATCH} x 4 views, cameras {orig}", "vol",
                    got, twin)
            zero_reader_counters()
            results = ev.run(test)
            torch.cuda.synchronize()
            launched = counters()["fused_softmax_decode"]
            add_reader_launches(by_name)
            print(f"Evaluator3D vol on MHP_mv, {len(test)} batches: B4 launches {launched}; "
                  f"{json.dumps(results)}")
            if launched != len(test) or not all(np.isfinite(v) for v in results.values()):
                raise AssertionError(f"Evaluator3D on MHP_mv: {launched}, {results}")
            trainer = T3.Trainer3D(cfg, net, make_dataloader(cfg, True), None, output_dir=tmp,
                                   device=dev)
            if trainer.orig_size != (640, 480):
                raise AssertionError(f"Trainer3D took the cameras of {trainer.orig_size}")
            it = iter(make_dataloader(cfg, True)["MHP_mv"])
            for i in range(3):
                step_batch = T3.batch_for_step(to_device(next(it), dev))
                zero_reader_counters()
                trainer.state, losses = trainer.train_step(trainer.state, step_batch,
                                                           trainer.generator)
                torch.cuda.synchronize()
                add_reader_launches(by_name)
                host = {k: round(float(v), 5) for k, v in losses.items()}
                fwd, bwd = counters()["fused_softmax_decode"], fused_softmax_decode.launches_bwd
                print(f"Trainer3D vol step {i} on MHP_mv: {host}; B4 forward {fwd}, "
                      f"backward {bwd}")
                if (fwd, bwd) != (1, 1) or not all(np.isfinite(v) for v in host.values()):
                    raise AssertionError(f"MHP_mv vol step: launches {(fwd, bwd)}, {host}")
            del trainer, net, ev

        with phase("other readers"):
            for name, train, yaml, workers in READER_LOADERS:
                cfg = reader_cfg(root, tmp, name if train else "RHD_kpt",
                                 "RHD" if train else name, WORKERS=workers,
                                 TRAIN__IMAGES_PER_GPU=2, TEST__IMAGES_PER_GPU=2,
                                 DATASET__SEQ_IDX=[-2, -1, 0, 1, 2], DATASET__STRIDE=2,
                                 DATASET__NUM_VIEWS=4, DATASET__SIGMA=1)
                loader = make_dataloader(cfg, train)[name]
                decode = READER_PNG.get(name, "PNG under .jpg / .jpeg names, Sub rows; the "
                                        "real JPEGs need cv2")
                line, batch = rate_line(f"{name} ({yaml or 'no YAML'})", loader, workers, decode,
                                        smi)
                print(line)
                batch = to_device(batch, dev)
                shapes = {k: tuple(v.shape) for k, v in batch.items()
                          if isinstance(v, torch.Tensor)}
                print(f"{name}: batch on the card {shapes}")
                if not all(torch.isfinite(v.float()).all() for v in batch.values()
                           if isinstance(v, torch.Tensor)):
                    raise AssertionError(f"{name}: a batch value is not finite")
                if name == "MHP_seq":
                    try:
                        TS.check_frame_targets(_batch_for_step(batch))
                    except ValueError as err:
                        print(f"MHP_seq into the 2D step: {str(err)[:96]}...")
                    else:
                        raise AssertionError("MHP_seq's folded targets were not refused (C23)")
                if name == "COCO":
                    ds = loader.dataset
                    gt = np.stack([s["keypoints"] for s in ds.samples])
                    preds = np.concatenate([gt[:, :, :2] + np.random.default_rng(3).normal(
                        size=gt[:, :, :2].shape) * 2, np.full(gt.shape[:2] + (1,), 0.9)], -1)
                    preds = np.concatenate([preds, preds[:1] + 0.5]).astype(np.float32)
                    ids = [s["image_id"] for s in ds.samples] + [ds.samples[0]["image_id"]]
                    boxes = np.tile(np.array([[80, 80, 0.6, 0.6, 12544, 1.0]], np.float32),
                                    (len(preds), 1))
                    zero_reader_counters()
                    nv, ap = ds.evaluate(preds, boxes, ids, tmp, device=dev)
                    add_reader_launches(by_name)
                    print(f"COCO evaluate, OKS-NMS on the card: {nv['num_results']} of "
                          f"{len(preds)} kept (the duplicate suppressed), OKS-AP {ap:.4f}")
                    if nv["num_results"] != len(ds) or not ap > 0.5:
                        raise AssertionError(f"COCO evaluate: {nv}, AP {ap}")

    readers = {name: by_name[name]["launches_readers"]
               for name in [*counters(), "softmax_decode_backward"]}
    print(f"launches on the reader paths, all runs: {readers}")
    for name in ("fused_softmax_decode", "softmax_decode_backward", "conv_int8",
                 "fused_bottleneck_chain_int8", "fused_head_decode_v2"):
        if not readers[name]:
            raise AssertionError(f"no reader path launched {name}")


# -- A8 and A7: the trained-weights int8 gate, multistep training, the BN
# levers and the tools ------------------------------------------------------

GATE_COUNTED = ("conv_int8", "fused_bottleneck_chain_int8", "fused_head_decode_v2")
LEVER_BATCH = 32            # the flagship's training batch (perf_bn_levers' default)
LEVER_STEPS = 5
MULTI_K = 4
MULTI_STEPS = 8
LATENCY_BATCHES = (8, 32, 128)
LATENCY_ITERS = 20
TSNE_LIMIT = 1e-4           # float32 features, card vs CPU, TF32 off, relative to max |f|


def add_launches(by_name, key):
    """Adds every counted kernel's launches since zero_counters() into its
    entry's ``key``; returns them."""
    now = counters()
    for name, n in now.items():
        by_name[name][key] = by_name[name].get(key, 0) + n
    return now


def c26_phase(smi):
    """make_quant_infer(trunk='f32') on the flagship at B=32 with
    pallas_layer1=False (the walk's folded bf16 layer1 on cuDNN, the gate's
    reference) and True (the bf16 chain kernel B2): B2's launches and the
    gap between the two."""
    dev = torch.device("cuda")
    with phase("C26 layer1"), torch.inference_mode():
        cfg = flagship_cfg()
        weights = precast_variables(cfg, init_variables(cfg, seed=0, device=dev), device=dev)
        images = torch.from_numpy(np.random.default_rng(40).normal(
            size=(CHECK_BATCH, 256, 256, 3)).astype(np.float32)).to(dev)
        out, ms = {}, {}
        for flag, want in ((False, 0), (True, 4)):
            infer = Q.make_quant_infer(cfg, dev, trunk="f32", pallas_layer1=flag)
            zero_counters()
            out[flag] = infer(weights, {}, images)
            torch.cuda.synchronize()
            got = counters()
            print(f"make_quant_infer(trunk='f32', pallas_layer1={flag}) B={CHECK_BATCH}: "
                  f"launches B2 {got['fused_bottleneck_chain']}, B1 {got['fused_head_decode_v2']}")
            if got["fused_bottleneck_chain"] != want or got["fused_head_decode_v2"] != 1:
                raise AssertionError(f"pallas_layer1={flag}: {got}")
            if not torch.isfinite(out[flag]).all():
                raise AssertionError(f"pallas_layer1={flag}: non-finite coordinates")
            ms[flag] = time_ms(lambda: infer(weights, {}, images), 5)
        gap = (out[False] - out[True]).abs()
        print(f"pallas_layer1 False vs True (cuDNN's folded layer1 vs B2, random full-depth "
              f"weights, chaotic in bf16): max {gap.max().item():.4f} px, mean "
              f"{gap.mean().item():.4f} px; {ms[False]:.3f} / {ms[True]:.3f} ms a B="
              f"{CHECK_BATCH} call on {smi}")


def gate_worker(out_path: str) -> None:
    """tools/accuracy_gate_full.run() at its defaults, TF32 off as in this
    script: its results and the kernel launches, saved to ``out_path``."""
    from hrnet_hand_pose_estimation_tpu_torch.tools import accuracy_gate_full as GATE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    zero_counters()
    results = GATE.run(device="cuda")
    torch.cuda.synchronize()
    torch.save({"results": results, "launches": counters()}, out_path)


def start_gate(tmp: str):
    """``gate_worker`` in a process of its own, started (the gate's train loop
    is paced by its host thread, so it runs beside the reader phases)."""
    import torch.multiprocessing as mp

    out = str(Path(tmp) / "gate.pt")
    proc = mp.get_context("spawn").Process(target=gate_worker, args=(out,), daemon=True)
    proc.start()
    return proc, out


def gate_phase(smi, kernels, started=None):
    """tools/accuracy_gate_full.run() at its defaults: the flagship trained
    300 steps at B=32, then the shipped int8 paths of both scopes against
    the TF32-off f32 walk; passes only if its gate passes, with conv_int8,
    B3 and B1 launched and no B2.  ``started`` (``start_gate``'s): the run
    a process began earlier, read here; else it runs here."""
    from hrnet_hand_pose_estimation_tpu_torch.tools import accuracy_gate_full as GATE

    by_name = {k["name"]: k for k in kernels}
    with phase("accuracy gate"):
        if started is None:
            zero_counters()
            results = GATE.run(device="cuda")
            torch.cuda.synchronize()
            got = add_launches(by_name, "launches_gate")
        else:
            proc, out = started
            proc.join(timeout=900)
            if proc.is_alive() or proc.exitcode != 0:
                proc.kill()
                raise AssertionError(f"the gate's process failed: exit code {proc.exitcode}")
            saved = torch.load(out, weights_only=False)
            results, got = saved["results"], saved["launches"]
            for name, n in got.items():
                by_name[name]["launches_gate"] = by_name[name].get("launches_gate", 0) + n
        print(f"launches in the gate: {json.dumps(got)} on {smi}")
        if not results["pass"]:
            raise AssertionError(f"the trained-weights int8 gate failed: {json.dumps(results)}")
        if got["fused_bottleneck_chain"] or not all(got[n] for n in GATE_COUNTED):
            raise AssertionError(f"the gate's paths did not run their kernels: {got}")


def multistep_phase(smi):
    """The flagship at B=32: 8 single steps and two K=4 make_train_multistep
    calls from the same seeded state and batches (gaps printed and held
    within 1e-2 relative: cuDNN's backward need not be deterministic), then
    ms/step at K=1 and K=4 over 8 steps each."""
    from hrnet_hand_pose_estimation_tpu_torch.tools.accuracy_gate_full import flagship_train_cfg
    from hrnet_hand_pose_estimation_tpu_torch.tools.perf_bn_levers import train_batch
    from hrnet_hand_pose_estimation_tpu_torch.tools.perf_multistep_sweep import sweep_rows

    dev = torch.device("cuda")
    with phase("multistep"):
        cfg = flagship_train_cfg()
        batches = [train_batch(cfg, LEVER_BATCH, dev, seed=50 + i) for i in range(MULTI_STEPS)]
        model = build_model(cfg)
        state, tx = TS.create_train_state(cfg, model, device=dev)
        step = TS.make_train_step(cfg, model, tx)
        single = []
        for b in batches:
            state, losses = step(state, b)
            single.append(losses["total_loss"])
        single = torch.stack(single)
        want = state.params.clone()
        del model, state, step
        model = build_model(cfg)
        state, tx = TS.create_train_state(cfg, model, device=dev)
        multi = TS.make_train_multistep(cfg, model, tx)
        calls = []
        for i in range(0, MULTI_STEPS, MULTI_K):
            stacked = {k: torch.stack([b[k] for b in batches[i:i + MULTI_K]]) for k in batches[0]}
            state, losses = multi(state, stacked)
            calls.append(losses["total_loss"])
        calls = torch.cat(calls)
        loss_gap = ((calls - single).abs() / single.abs()).max().item()
        param_gap = (state.params - want).abs().max().item()
        print(f"{MULTI_STEPS} steps as {MULTI_STEPS // MULTI_K} K={MULTI_K} calls vs single "
              f"steps, B={LEVER_BATCH}: losses {[round(v, 4) for v in calls.tolist()]}; largest "
              f"relative loss gap {loss_gap:.3g}, largest parameter gap {param_gap:.3g} "
              f"(LR {float(cfg.TRAIN.LR)}); step {int(state.step)}")
        if int(state.step) != MULTI_STEPS or not torch.isfinite(calls).all():
            raise AssertionError(f"multistep: step {int(state.step)}, losses {calls.tolist()}")
        if not loss_gap <= 1e-2:
            raise AssertionError(f"multistep calls part from single steps: {loss_gap}")
        del model, state, multi, batches
        for row in sweep_rows(cfg, LEVER_BATCH, [1, MULTI_K], steps=MULTI_STEPS, device=dev):
            print(f"K={row['k']}: {row['ms_per_step']:.3f} ms/step at B={LEVER_BATCH} "
                  f"({LEVER_BATCH / row['ms_per_step'] * 1e3:.1f} images/s) on {smi}")


def levers_phase(smi):
    """Train steps of the flagship at B=32 with stat_samples=8, then with
    stat_dtype='bfloat16', beside the baseline (perf_bn_levers' rows): the
    losses finite and falling on the fixed batch."""
    from hrnet_hand_pose_estimation_tpu_torch.models.layers import bn_levers_active
    from hrnet_hand_pose_estimation_tpu_torch.tools.accuracy_gate_full import flagship_train_cfg
    from hrnet_hand_pose_estimation_tpu_torch.tools.perf_bn_levers import lever_rows

    with phase("BN levers"):
        configs = [("baseline (float32 statistics, whole batch)", {}),
                   ("statistics over 8", {"stat_samples": 8}),
                   ("bf16 statistics", {"stat_dtype": "bfloat16"})]
        rows = lever_rows(flagship_train_cfg(), LEVER_BATCH, configs, steps=LEVER_STEPS,
                          warmup=2, device="cuda")
        base = rows[0]["ms_per_step"]
        for row in rows:
            print(f"{row['label']}: {row['ms_per_step']:.3f} ms/step at B={LEVER_BATCH} "
                  f"({row['ms_per_step'] / base:.3f} of the baseline) on {smi}; losses "
                  f"{[round(v, 4) for v in row['losses']]}")
            losses = np.asarray(row["losses"])
            if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
                raise AssertionError(f"{row['label']}: losses {row['losses']}")
        if bn_levers_active():
            raise AssertionError("the levers stayed on after perf_bn_levers")


def a8_tool_phases(smi, kernels):
    """perf_latency at B=8, 32 and 128 (the shipped int8 path, one call a
    request); flops_of on the flagship; tsne_visualization's features on
    the card against the CPU."""
    from hrnet_hand_pose_estimation_tpu_torch.ops.precision import no_tf32
    from hrnet_hand_pose_estimation_tpu_torch.tools.perf_latency import latency_rows
    from hrnet_hand_pose_estimation_tpu_torch.tools.tsne_visualization import embed
    from hrnet_hand_pose_estimation_tpu_torch.utils.profiling import flops_of

    dev = torch.device("cuda")
    by_name = {k["name"]: k for k in kernels}
    with phase("A8 tools"):
        zero_counters()
        rows = latency_rows(flagship_cfg(), LATENCY_BATCHES, LATENCY_ITERS, warmup=10,
                            device=dev)
        got = add_launches(by_name, "launches_latency")
        for row in rows:
            print(f"perf_latency: {json.dumps(row)} on {smi}")
            if not 0 < row["p50_ms"] <= row["p99_ms"]:
                raise AssertionError(f"perf_latency: {row}")
        print(f"launches in perf_latency: {json.dumps(got)}")
        if not all(got[n] for n in GATE_COUNTED) or got["fused_bottleneck_chain"]:
            raise AssertionError(f"perf_latency did not serve through the int8 kernels: {got}")

        cfg = flagship_cfg()
        model = hrnet_from_cfg(cfg).to(dev).eval()
        model.load_state_dict(init_variables(cfg, seed=0, device=dev))
        x = torch.zeros(1, 256, 256, 3, device=dev)
        with torch.no_grad():
            flops = flops_of(model, x)
        convs = conv_flops(model, x)
        print(f"flops_of the flagship forward: {flops / 1e9:.3f} GFLOPs an image (the conv "
              f"products alone {convs / 1e9:.3f})")
        if not convs <= flops <= 1.1 * convs:
            raise AssertionError(f"flops_of {flops} against the convs' {convs}")
        del model

        scfg, _ = smoke_cfg()
        scfg = scfg.clone()
        scfg.defrost()
        scfg.TPU.COMPUTE_DTYPE = "float32"
        scfg.freeze()
        images = torch.from_numpy(np.random.default_rng(41).normal(
            size=(16, 64, 64, 3)).astype(np.float32))
        feats = {}
        for d in (dev, torch.device("cpu")):
            model = build_model(scfg)
            model.load_state_dict(init_variables(scfg, seed=0))
            with no_tf32():
                feats[d.type] = embed(scfg, model.to(d), images.to(d)).cpu()
        err = (feats["cuda"] - feats["cpu"]).abs().max().item()
        scale = feats["cpu"].abs().max().item()
        print(f"tsne features (smoke model, float32, {tuple(feats['cpu'].shape)}): card vs CPU "
              f"max |d| {err:.3g} (limit {TSNE_LIMIT} x {scale:.3g})")
        if not err <= TSNE_LIMIT * scale:
            raise AssertionError(f"tsne features part on the card: {err}")


def a8_a7_phases(smi, kernels, gate=None):
    """The phases of the last A8 and A7 modules, in order; each is also
    callable alone (with ``kernels`` holding an entry ``{"name": n}`` for
    every name of ``counters()``).  ``gate``: ``start_gate``'s process."""
    c26_phase(smi)
    gate_phase(smi, kernels, gate)
    multistep_phase(smi)
    levers_phase(smi)
    a8_tool_phases(smi, kernels)


# -- A8's three probes, then data parallelism (A11, first part) -----------

PROBE_TWIN_BATCH = 8        # the B7 / B6 twin checks at the probe's shapes
PROBE_ITERS = 5
SHARD_LIMIT = 0.25          # px: sharded against unsharded int8 serving at B=32 (C9's limit)
SHARD_EVAL_BATCHES = 2      # Evaluator2D with and without the mesh (EVAL_BATCHES elsewhere)
SHARD_EPE_LIMIT = 0.05      # px of EPE, and 0.005 of each AUC: sharded against plain evaluation
DDP_BATCH = 16              # a rank's batch; the global batch is 32
DDP_STEPS = 2
DDP_LOSS_RTOL = 2e-4        # tests/test_torch_ddp.py's tolerances (JAX's own, scan vs steps)
DDP_PARAM_ATOL = 1e-3
# The ranks sum their BN statistics, losses and gradients in another float32
# order than one process; the witness (one process with native_batch_norm)
# changes one of those orders.  Measured on an H100 over four runs: the
# ranks' gaps 1.0-2.0x the witness's (losses 1.8-2.1e-4 against 0.9-1.4e-4,
# parameters after step 3 1.1-1.2e-2 against 0.9e-2): the limit is 4x the
# witness.
DDP_WITNESS_FACTOR = 4.0


def ddp_cfg(out_dir: str = ""):
    """The flagship at full width (w32 softmax at 256/64, heatmap and pose
    losses) in float32 with sgd (momentum 0.9) at a constant 1e-2: the
    CPU parity test's step, so two ranks and one process can be held
    close."""
    from hrnet_hand_pose_estimation_tpu_torch.tools.accuracy_gate_full import flagship_train_cfg

    cfg = flagship_train_cfg().clone()
    cfg.defrost()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TRAIN.OPTIMIZER, cfg.TRAIN.LR, cfg.TRAIN.MOMENTUM = "sgd", 1e-2, 0.9
    cfg.TRAIN.NESTEROV = False
    cfg.TRAIN.IMAGES_PER_GPU = DDP_BATCH
    cfg.OUTPUT_DIR = out_dir
    return cfg.freeze()


def ddp_batches(cfg, dev):
    """DDP_STEPS seeded global batches of 2 * DDP_BATCH (targets by B5)."""
    from hrnet_hand_pose_estimation_tpu_torch.tools.perf_bn_levers import train_batch

    return [train_batch(cfg, 2 * DDP_BATCH, dev, seed=60 + i) for i in range(DDP_STEPS)]


def ddp_steps(cfg, dev, rank: int, world: int, global_formula: bool = False):
    """DDP_STEPS train steps on this rank's slice of each global batch:
    the losses, ms a step (host clock around a synced step), and the
    parameters after the first and the last step and the final BN
    statistics, on the host.  ``global_formula`` (one process) takes the BN
    statistics as the data-parallel step does (flax's S1 / N, S2 / N over
    the batch, ``synced_batch_stats`` with a one-rank sum) instead of
    ``native_batch_norm``'s."""
    from contextlib import nullcontext

    from hrnet_hand_pose_estimation_tpu_torch.models.layers import synced_batch_stats

    model = build_model(cfg)
    state, tx = TS.create_train_state(cfg, model, device=dev)
    step = TS.make_train_step(cfg, model, tx)
    losses, ms, params = [], [], []
    for batch in ddp_batches(cfg, dev):
        per = batch["images"].shape[0] // world
        mine = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        with synced_batch_stats(lambda x: x) if global_formula else nullcontext():
            state, out = step(state, mine)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
        if not params:
            params.append(state.params.cpu())
    return {"losses": losses, "ms": ms, "params1": params[0], "params": state.params.cpu(),
            "stats": state.stats.cpu(), "counts": state.counts.cpu()}


def ddp_trainer(dev, out_dir: str):
    """Trainer.fit for one epoch of 2 * DDP_BATCH synthetic samples at
    DDP_BATCH a step (the flagship in bf16, adam): its steps and epoch
    averages, and the files it wrote."""
    from hrnet_hand_pose_estimation_tpu_torch.tools.accuracy_gate_full import flagship_train_cfg

    cfg = flagship_train_cfg().clone()
    cfg.defrost()
    cfg.OUTPUT_DIR, cfg.WORKERS, cfg.WITHOUT_EVAL = out_dir, 0, True
    cfg.DATASET.DATASET = ["Synthetic_kpt"]
    cfg.TRAIN.BEGIN_EPOCH, cfg.TRAIN.END_EPOCH = 0, 1
    cfg.freeze()
    loader = DataLoader(SyntheticDataset(cfg, length=2 * DDP_BATCH), DDP_BATCH, num_workers=0)
    trainer = Trainer(cfg, build_model(cfg), {"synthetic": loader}, device=dev)
    averages = []
    epoch = trainer.train_epoch
    trainer.train_epoch = lambda e: averages.append(epoch(e)) or averages[-1]
    trainer.fit()
    return {"steps": trainer.train_global_steps, "averages": averages[0],
            "files": sorted(str(p.relative_to(out_dir)) for p in Path(out_dir).rglob("*")
                            if p.is_file())}


def ddp_rank(rank: int, world: int, port: int, backend: str, mode: str, out_path: str):
    """One rank of the DDP phases, in a process of its own on cuda:0:
    joins a ``backend`` group of ``world`` ranks on localhost, runs
    ``ddp_steps`` ('steps') or ``ddp_trainer`` ('trainer'), and saves the
    result with its kernel launch counts to ``out_path``."""
    from hrnet_hand_pose_estimation_tpu_torch.parallel import distributed

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    distributed.init_process_group(backend, rank=rank, world_size=world,
                                   init_method=f"tcp://localhost:{port}")
    try:
        zero_counters()
        if mode == "steps":
            result = ddp_steps(ddp_cfg(), dev, rank, world)
        else:
            one = distributed.sum_(torch.ones(4, device=dev))      # a collective on the backend
            result = ddp_trainer(dev, str(Path(out_path).parent / f"run{rank}"))
            result["all_reduce"] = one.tolist()
        result["launches"] = counters()
        torch.save(result, out_path)
    finally:
        distributed.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_ranks(world: int, backend: str, mode: str, tmp: str, target=None):
    """``world`` spawned processes of ``target`` (``ddp_rank`` by default),
    started; ``join_ranks`` waits for them."""
    import torch.multiprocessing as mp

    port = free_port()
    ctx = mp.get_context("spawn")
    outs = [str(Path(tmp) / f"{mode}{r}.pt") for r in range(world)]
    # daemons: a rank still running when this script exits is stopped then
    procs = [ctx.Process(target=target or ddp_rank, args=(r, world, port, backend, mode,
                                                          outs[r]), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs, f"DDP {backend} {mode}"


def join_ranks(started):
    """The results of ``start_ranks``' processes, once they end; raises if
    one failed."""
    procs, outs, label = started
    for p in procs:
        p.join(timeout=600)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    if codes != [0] * len(procs):
        raise AssertionError(f"{label}: rank exit codes {codes}")
    return [torch.load(o, weights_only=False) for o in outs]


def probe_twin_checks(smi):
    """B7 and B6 against their twins at each probe shape (B=8): the probe's
    weights, 4 blocks, limit 0.02 * max|out|."""
    from hrnet_hand_pose_estimation_tpu_torch.tools import perf_int8_probe as P

    dev = torch.device("cuda")
    worst = {}
    for h, w, c in P.SHAPES:
        weights, qweights = P.probe_weights(c, P.N_BLOCKS, np.random.default_rng(c), dev)
        x = torch.from_numpy(np.random.default_rng(c + 1).normal(
            size=(PROBE_TWIN_BATCH, h, w, c)).astype(np.float32)).to(dev, torch.bfloat16)
        b7, b6 = P.b7_params(weights), P.b6_params(qweights)
        for name, got, want in (
                ("fused_basic_chain", fused_basic_chain(x, b7, P.N_BLOCKS),
                 basic_chain_reference(x, b7, P.N_BLOCKS)),
                ("fused_basic_chain_int8", fused_basic_chain_int8(x, b6, P.N_BLOCKS),
                 basic_chain_int8_reference(x, b6, P.N_BLOCKS))):
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            limit = 0.02 * max(1.0, want.float().abs().max().item())
            worst[name] = max(worst.get(name, 0.0), err / limit)
            print(f"probe {h}x{w}x{c} B={PROBE_TWIN_BATCH}: {name} vs its twin max |d| "
                  f"{err:.4g} (limit {limit:.4g}); bit-equal share "
                  f"{(got == want).float().mean().item():.4f}")
            if not err <= limit:
                raise AssertionError(f"probe {h}x{w}x{c}: {name} disagrees with its twin: {err}")
    return worst


def probe_phases(smi, kernels):
    """The three A8 probes' ``run()`` at the JAX tools' shapes, with fewer
    repeats: perf_int8_probe (B7 and B6 held to their twins first),
    perf_quant_e2e and perf_train_profile; each one's launches in
    ``launches_probe_*``."""
    from hrnet_hand_pose_estimation_tpu_torch.tools import perf_int8_probe as P
    from hrnet_hand_pose_estimation_tpu_torch.tools import perf_quant_e2e as E
    from hrnet_hand_pose_estimation_tpu_torch.tools import perf_train_profile as T

    by_name = {k["name"]: k for k in kernels}
    with phase("probe: perf_int8_probe"):
        probe_twin_checks(smi)
        zero_counters()
        result = P.run(batch=P.BATCH, iters=PROBE_ITERS, device="cuda")
        got = add_launches(by_name, "launches_probe_int8")
        for row in result["rows"]:
            print(f"perf_int8_probe{P.format_row(row)} on {smi}")
        print(f"perf_int8_probe: {json.dumps(result)}; launches {json.dumps(got)}")
        if not (got["fused_basic_chain"] and got["fused_basic_chain_int8"] and got["conv_int8"]):
            raise AssertionError(f"perf_int8_probe did not run its kernels: {got}")
    with phase("probe: perf_quant_e2e"):
        zero_counters()
        result = E.run(batch=E.BATCH, iters=3, device="cuda")
        got = add_launches(by_name, "launches_probe_quant")
        for line in E.lines(result):
            print(f"perf_quant_e2e: {line} on {smi}")
        print(f"perf_quant_e2e: {json.dumps(result)}; launches {json.dumps(got)}")
        rows = [v for v in result.values() if isinstance(v, dict)]
        if not all(np.isfinite(r["shift_max"]) and r["fps"] > 0 for r in rows):
            raise AssertionError(f"perf_quant_e2e: {result}")
        if not all(got[n] for n in ("conv_int8", "fused_bottleneck_chain_int8",
                                    "fused_head_decode_v2", "fused_bottleneck_chain")):
            raise AssertionError(f"perf_quant_e2e did not run its kernels: {got}")
    with phase("probe: perf_train_profile"):
        zero_counters()
        result = T.run(batch=T.BATCH, iters=1, device="cuda")
        got = add_launches(by_name, "launches_probe_train")
        for line in T.lines(result, T.BATCH):
            print(f"perf_train_profile: {line} on {smi}")
        print(f"perf_train_profile: {json.dumps(result)}; launches {json.dumps(got)}")
        if len(result) != 10 or not all(v > 0 for v in result.values()):
            raise AssertionError(f"perf_train_profile: {result}")
        torch.cuda.empty_cache()


def sharded_phases(smi, kernels):
    """Serving and evaluation over a mesh of two replicas on cuda:0: the
    shipped int8 path at B=32 against the unsharded call and against the
    two halves served apart; Evaluator2D std and int8 with the mesh
    against without; launches in ``launches_sharded``."""
    from hrnet_hand_pose_estimation_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", 0)
    by_name = {k["name"]: k for k in kernels}
    mesh = make_mesh(devices=[dev, dev])
    with phase("sharded serving"), torch.inference_mode():
        cfg = flagship_cfg()
        state = {k: v.to(dev) for k, v in init_variables(cfg, seed=0, device=dev).items()}
        weights = precast_variables(cfg, state, device=dev)
        u8 = uint8_images(70, CHECK_BATCH, dev)
        amax = Q.calibrate(cfg, weights, [normalize(u8[:16])])
        qparams = Q.prepare_serving_qparams(cfg, state, amax)
        plain = Q.make_quant_infer(cfg, dev, input_norm=NORM)
        sharded = Q.make_quant_infer(cfg, dev, input_norm=NORM, mesh=mesh)
        zero_counters()
        want = plain(weights, qparams, u8)
        torch.cuda.synchronize()
        once = counters()
        zero_counters()
        got = sharded(weights, qparams, u8)
        torch.cuda.synchronize()
        launches = add_launches(by_name, "launches_sharded")
        halves = torch.cat([plain(weights, qparams, u8[:16]), plain(weights, qparams, u8[16:])])
        gap = (got - want).abs()
        print(f"make_quant_infer(mesh=[cuda:0, cuda:0]) B={CHECK_BATCH}: launches "
              f"{json.dumps(launches)} (one unsharded call: {json.dumps(once)}); against the "
              f"unsharded call max |d| {gap.max().item():.4g} px, mean "
              f"{gap.mean().item():.4g} px (limit {SHARD_LIMIT}); against the two halves "
              f"served apart: bit-equal {torch.equal(got, halves)}")
        if {k: 2 * v for k, v in once.items()} != launches:
            raise AssertionError(f"the replicas did not each launch the path's kernels: "
                                 f"{launches} against {once} a call")
        if not torch.equal(got, halves) or not gap.max().item() <= SHARD_LIMIT:
            raise AssertionError(f"sharded serving parts from the unsharded: {gap.max()} px")
        ms_plain = time_ms(lambda: plain(weights, qparams, u8), 10)
        ms_sharded = time_ms(lambda: sharded(weights, qparams, u8), 10)
        print(f"int8 serving B={CHECK_BATCH} on one card: unsharded {ms_plain:.3f} ms, two "
              f"replicas on cuda:0 {ms_sharded:.3f} ms ({ms_sharded / ms_plain:.3f}x: the "
              f"overhead of the split on one card, not scaling) on {smi}")
        del weights, state
    with phase("sharded evaluation"), tempfile.TemporaryDirectory() as tmp:
        cfg = eval_cfg(tmp)
        state = init_variables(cfg, seed=0, device=dev)
        for serving in ("std", "int8"):
            results = {}
            for name, m in (("plain", None), ("mesh", mesh)):
                loader = make_test_dataloader(cfg)["Synthetic_kpt"]
                loader.dataset.length = EVAL_BATCH * SHARD_EVAL_BATCHES
                ev = Evaluator2D(cfg, build_model(cfg), state, mesh=m, serving=serving,
                                 device=dev)
                zero_counters()
                results[name] = ev.run(loader, "Synthetic")
                torch.cuda.synchronize()
                if m is not None:
                    launches = add_launches(by_name, "launches_sharded")
            gaps = {k: abs(results["mesh"][k] - results["plain"][k])
                    for k in ("EPE_px", "PCK_AUC_30", "PCK_AUC_full", "PCK@20px")}
            print(f"Evaluator2D {serving} with the mesh: {json.dumps(results['mesh'])}; without: "
                  f"{json.dumps(results['plain'])}; gaps {json.dumps(gaps)} (limits "
                  f"{SHARD_EPE_LIMIT} px of EPE, 0.005 of each AUC and PCK); launches "
                  f"{json.dumps(launches)} on {smi}")
            if not (gaps["EPE_px"] <= SHARD_EPE_LIMIT
                    and all(v <= 0.005 for k, v in gaps.items() if k != "EPE_px")):
                raise AssertionError(f"Evaluator2D {serving}: mesh against plain {gaps}")
            kernel = "fused_softmax_decode" if serving == "std" else "conv_int8"
            if not launches[kernel]:
                raise AssertionError(f"Evaluator2D {serving} with the mesh launched no {kernel}")


def ddp_phases(smi, kernels):
    """The data-parallel training phases.  Every process they need starts
    at once, so that start-ups and one-process references overlap: two gloo
    ranks sharing cuda:0 (``ddpx_rank``: the flagship at full width for
    DDP_STEPS steps at DDP_BATCH a rank, then every mode of DDPX_MODES),
    one rank of an NCCL group of one whose Trainer fits an epoch
    (``ddp_rank``), and the 3D tools under torchrun's environment; this
    process runs the one-process references on the global batches
    meanwhile (their times and the ranks' share the card and the host).
    Then "DDP, gloo", "DDP, NCCL", "DDP 3D / GAN / CPM / fusion / levers,
    gloo" and "DDP 3D, NCCL" check them.  The ranks' launches in
    ``launches_ddp`` (the flagship's steps and the NCCL Trainer) and
    ``launches_ddpx`` (the modes)."""
    dev = torch.device("cuda", 0)
    by_name = {k["name"]: k for k in kernels}
    with tempfile.TemporaryDirectory() as tmp:
        with phase("DDP, gloo"):
            torch.cuda.empty_cache()
            tools = start_nccl_tools(tmp)
            nccl = start_ranks(1, "nccl", "trainer", tmp)
            gloo = start_ranks(2, "gloo", "modes", tmp, target=ddpx_rank)
            # one process on the global batch, with the data-parallel step's
            # BN formula (the reference) and with native BN (the witness: the
            # same step in another float32 order)
            t = time.perf_counter()
            ref, native = (ddp_steps(ddp_cfg(), dev, 0, 1, global_formula=f)
                           for f in (True, False))
            refs = ddpx_references(dev)
            t_refs = time.perf_counter() - t
            ranks = join_ranks(gloo)
            print(f"the one-process references took {t_refs:.1f} s; the gloo ranks ended "
                  f"{time.perf_counter() - t:.1f} s after the processes started")
            ddp_gloo_check([r["steps"] for r in ranks], ref, native, by_name, smi)
        with phase("DDP, NCCL"):
            (r,) = join_ranks(nccl)
            for name, n in r["launches"].items():
                by_name[name]["launches_ddp"] = by_name[name].get("launches_ddp", 0) + n
            print(f"DDP NCCL, world size 1: all_reduce {r['all_reduce']}; Trainer.fit "
                  f"{r['steps']} steps, epoch averages {json.dumps(r['averages'])}; files "
                  f"{r['files']}")
            if r["steps"] != 2 or r["all_reduce"] != [1.0] * 4 or not all(
                    np.isfinite(v) for v in r["averages"].values()):
                raise AssertionError(f"DDP NCCL: {r}")
            if not any(f.endswith("ckpt_0.pt") for f in r["files"]):
                raise AssertionError(f"DDP NCCL: rank 0 wrote no checkpoint: {r['files']}")
        with phase("DDP 3D / GAN / CPM / fusion / levers, gloo"):
            ddpx_check(ranks, refs, by_name, smi)
        with phase("DDP 3D, NCCL"):
            nccl_tools_check(tools)


def ddp_gloo_check(ranks, ref, native, by_name, smi):
    """The flagship's data-parallel steps: the ranks bit-equal, within
    max(floor, DDP_WITNESS_FACTOR x the witness) of one process."""
    for name in ranks[0]["launches"]:
        by_name[name]["launches_ddp"] = by_name[name].get("launches_ddp", 0) + sum(
            r["launches"][name] for r in ranks)
    a, b = ranks
    equal = all(torch.equal(a[k], b[k]) for k in ("params", "stats", "counts"))
    print(f"DDP gloo, 2 ranks on cuda:0 x {DDP_BATCH}, {DDP_STEPS} float32 sgd steps: ranks "
          f"bit-equal {equal}; losses {[round(l['total_loss'], 5) for l in a['losses']]}; "
          f"launches {json.dumps(a['launches'])} a rank")

    def gaps(x, y):
        loss = max(abs(p[k] - q[k]) / abs(q[k]) for p, q in zip(x["losses"], y["losses"])
                   for k in q if q[k])
        return (loss, (x["params1"] - y["params1"]).abs().max().item(),
                (x["params"] - y["params"]).abs().max().item(),
                (x["stats"] - y["stats"]).abs().max().item())

    got, witness = gaps(a, ref), gaps(native, ref)
    limits = (max(DDP_LOSS_RTOL, DDP_WITNESS_FACTOR * witness[0]),
              max(DDP_PARAM_ATOL, DDP_WITNESS_FACTOR * witness[1]),
              max(DDP_PARAM_ATOL, DDP_WITNESS_FACTOR * witness[2]))
    for label, g in (("the ranks", got), ("the witness (one process, native BN)", witness)):
        print(f"  {label} against one process x {2 * DDP_BATCH} with the data-parallel "
              f"step's BN formula: largest relative loss gap {g[0]:.3g}; parameters after "
              f"step 1 {g[1]:.3g}, after step {DDP_STEPS} {g[2]:.3g}; BN statistics "
              f"{g[3]:.3g}")
    print(f"  limits max(losses {DDP_LOSS_RTOL} / parameters {DDP_PARAM_ATOL}, "
          f"{DDP_WITNESS_FACTOR:g} x the witness): {', '.join(f'{v:.3g}' for v in limits)}; "
          f"one process losses {[round(l['total_loss'], 5) for l in ref['losses']]}")
    print(f"DDP gloo ms a step (host clock, synced): ranks {[round(v, 1) for v in a['ms']]}"
          f" / {[round(v, 1) for v in b['ms']]}; one process {[round(v, 1) for v in ref['ms']]}"
          f" (the BN formula), {[round(v, 1) for v in native['ms']]} (native) on {smi} (all "
          f"the DDP phases' processes share one card: the overhead of the collectives, not "
          f"scaling)")
    if not equal or not all(g <= lim for g, lim in zip(got, limits)):
        raise AssertionError("DDP gloo: the ranks part from each other or from one process")
    if not a["launches"]["fused_gaussian_targets"]:
        raise AssertionError("DDP gloo: the ranks made no targets on the card")


def a11_phases(smi, kernels):
    """This slice's phases, in order; each is also callable alone (with
    ``kernels`` holding an entry ``{"name": n}`` for every name of
    ``counters()``)."""
    probe_phases(smi, kernels)
    sharded_phases(smi, kernels)
    ddp_phases(smi, kernels)


# -- A11, second part: every train step across ranks ---------------------------

# Each mode: two gloo ranks sharing cuda:0 against one process on the
# global batch, in float32 with TF32 off.  The reference is the one process
# with the data-parallel step's BN formula, the witness the same process
# with native BN (the same step in another float32 order); the ranks must
# be bit-equal and within max(floor, DDP_WITNESS_FACTOR x the witness).
DDPX_STEPS = 2
DDPX_3D_BATCH = {"alg": 4, "vol": 2, "gan": 2}   # global samples, T3_VIEWS views each
DDPX_FUSION_BATCH = 2                            # one sample of 4 views a rank
DDPX_LEVER_BATCH = 8                             # the flagship's global batch, 4 a rank
# the subsample on rank 0 alone, spanning both ranks, and in bfloat16
DDPX_LEVERS = {"rank0": dict(stat_samples=2), "span": dict(stat_samples=6),
               "span_bf16": dict(stat_samples=6, stat_dtype="bfloat16")}
DDPX_MODES = ("alg", "vol", "gan", "cpm", "fusion", "levers")
DDPX_NCCL_TOOLS = (("train3d", 8), ("train3d_gan", 16))  # batch of Synthetic_mv's 16: 2 and 1 steps


def ddpx_global(cfg, name: str, n: int, offset: int, dev, trainer3d: bool):
    """Samples offset..offset+n-1 of the config's ``name`` set, collated and
    on ``dev``, as the 3D (``trainer3d``) or the 2D Trainer's steps read
    them: the same global batch in every process."""
    from hrnet_hand_pose_estimation_tpu_torch.core import trainer as T2
    from hrnet_hand_pose_estimation_tpu_torch.core import trainer3d as T3
    from hrnet_hand_pose_estimation_tpu_torch.data.build import build_dataset
    from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import default_collate, to_device

    ds = build_dataset(cfg, name, True)
    batch = to_device(default_collate([ds[i] for i in range(offset, offset + n)]), dev)
    return T3.batch_for_step(batch) if trainer3d else T2._batch_for_step(batch)


def ddpx_slice(batch, rank: int, world: int):
    per = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def ddpx_kit(mode: str, dev, rank: int, world: int) -> dict:
    """What a mode builds once in a process: its nets, states, steps and
    this rank's slices of its global batches, with the states' initial
    values (``snapshot``) for ``ddpx_steps`` to start from each time."""
    from hrnet_hand_pose_estimation_tpu_torch.core import trainer3d as T3
    from hrnet_hand_pose_estimation_tpu_torch.core import trainer3d_gan as PG
    from hrnet_hand_pose_estimation_tpu_torch.core.train_variants import pick_train_step
    from hrnet_hand_pose_estimation_tpu_torch.models import triangulation as TRI
    from hrnet_hand_pose_estimation_tpu_torch.tools.perf_bn_levers import train_batch

    kit = {}
    if mode in DDPX_3D_BATCH:
        kind = "alg" if mode == "alg" else "vol"
        cfg = train3d_cfg(kind, "", DDPX_3D_BATCH[mode], gan=mode == "gan", dtype="float32")
        net = TRI.build_triangulation_net(cfg, dtype=torch.float32)
        net.load_state_dict(init_variables(cfg, 0, device=dev, net=kind))
        net.to(dev).train()
        tx = T3.make_optimizer_3d(cfg, net, 1000)
        state = TS.TrainState(net, tx)
        orig = (256, 256)
        kit.update(cfg=cfg, state=state, step=T3.make_train_step_3d(cfg, net, tx, orig))
        n = DDPX_3D_BATCH[mode]
        kit["batches"] = [ddpx_slice(ddpx_global(cfg, "Synthetic_mv", n, i * n, dev, True),
                                     rank, world)
                          for i in range(DDPX_STEPS if mode != "gan" else 1)]
        if mode == "gan":
            critic = TRI.Discriminator(PG.CRITIC_FEATURES)
            PG.init_critic(critic, int(cfg.TPU.SEED) + 2)
            critic.to(dev).train()
            critic_tx = PG.make_critic_optimizer()
            kit.update(cstate=TS.TrainState(critic, critic_tx),
                       critic_step=PG.make_critic_step(cfg, net, critic, critic_tx, orig,
                                                       float(cfg.MODEL.CLIP_VALUE)),
                       adv_step=PG.make_gen_adv_step(cfg, net, critic, tx, orig,
                                                     float(cfg.LOSS.KCS_LOSS_FACTOR)))
    elif mode == "levers":
        cfg = ddp_cfg()
        model = build_model(cfg)
        state, tx = TS.create_train_state(cfg, model, device=dev)
        kit.update(cfg=cfg, state=state, step=TS.make_train_step(cfg, model, tx),
                   batches=[ddpx_slice(train_batch(cfg, DDPX_LEVER_BATCH, dev, seed=80),
                                       rank, world)])
    else:
        if mode == "cpm":
            cfg = cpm_cfg("", **{"TPU.COMPUTE_DTYPE": "float32", "TRAIN.LR": CPM_CHECK_LR})
            name, n = "Synthetic_kpt", CPM_BATCH
        else:
            cfg, name, n = fusion_cfg("", dtype="float32"), "Synthetic_mv", DDPX_FUSION_BATCH
        model = build_model(cfg)
        state, tx = TS.create_train_state(cfg, model, 1000, device=dev)
        kit.update(cfg=cfg, state=state, step=pick_train_step(cfg, model, tx),
                   batches=[ddpx_slice(ddpx_global(cfg, name, n, i * n, dev, False), rank,
                                       world) for i in range(DDPX_STEPS)])
    kit["init"] = {k: snapshot(kit[k]) for k in ("state", "cstate") if k in kit}
    return kit


def ddpx_steps(mode: str, kit: dict, dev, timed):
    """The mode's steps from the kit's initial states: alg / vol DDPX_STEPS
    3D steps; gan one TrainerGAN3D batch (N_CRITIC critic steps on one
    angle, the supervised step, the adversarial step); cpm / fusion
    DDPX_STEPS steps of the 2D Trainer's step; levers one flagship step
    under each of DDPX_LEVERS.  Returns (losses, [states], extra)."""
    from hrnet_hand_pose_estimation_tpu_torch.models import layers as LY
    from hrnet_hand_pose_estimation_tpu_torch.models import triangulation as TRI

    for key, snap in kit["init"].items():
        restore(kit[key], snap)
    state, step, losses = kit["state"], kit["step"], []
    if mode == "levers":
        params = []
        for levers in DDPX_LEVERS.values():
            restore(state, kit["init"]["state"])
            LY.set_bn_levers(**levers)
            try:
                losses.append(timed(lambda: step(state, kit["batches"][0]))[1])
            finally:
                LY.set_bn_levers()
            params.append(snapshot(state))
        return losses, params, {}
    if mode not in DDPX_3D_BATCH:
        for batch in kit["batches"]:
            losses.append(timed(lambda: step(state, batch))[1])
        return losses, [snapshot(state)], {}
    gen = torch.Generator(device=dev).manual_seed(0)
    angles, real = [], TRI.cuboid_angles

    def record(*args):
        out = real(*args)
        angles.append(out.cpu())
        return out

    TRI.cuboid_angles = record
    try:
        extra = {}
        if mode != "gan":
            for batch in kit["batches"]:
                losses.append(timed(lambda: step(state, batch, gen))[1])
        else:
            batch, angle, cstate = kit["batches"][0], gen.get_state(), kit["cstate"]
            for _ in range(int(kit["cfg"].MODEL.N_CRITIC)):
                gen.set_state(angle)
                losses.append({"critic_loss": timed(
                    lambda: kit["critic_step"](cstate, state, batch, gen))[1]})
            losses.append(timed(lambda: step(state, batch, gen))[1])
            losses.append(timed(lambda: kit["adv_step"](state, batch, gen))[1])
            extra["critic"] = cstate.params.cpu()
    finally:
        TRI.cuboid_angles = real
    return losses, [snapshot(state)], dict(extra, angles=angles)


def ddpx_run(mode: str, kit: dict, dev, formula: bool = False):
    """One mode's steps on the kit's batches (one process: with the
    data-parallel step's BN formula when ``formula``): the losses, the
    states' parameters and BN statistics, the ms of each step (host clock
    around a synced step), the vol net's angles and the critic's
    weights."""
    from contextlib import nullcontext

    from hrnet_hand_pose_estimation_tpu_torch.models.layers import synced_batch_stats

    ms = []

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with synced_batch_stats(lambda x: x) if formula else nullcontext():
            out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        return out[0], {k: float(v) for k, v in out[1].items()} if isinstance(out[1], dict) \
            else float(out[1])

    losses, snaps, extra = ddpx_steps(mode, kit, dev, timed)
    return dict(extra, losses=losses, ms=ms,
                params=torch.cat([snap[0].cpu() for snap in snaps]),
                stats=torch.cat([snap[2].cpu() for snap in snaps]))


def ddpx_rank(rank: int, world: int, port: int, backend: str, mode: str, out_path: str):
    """One gloo rank of the A11 phases, in a process of its own on cuda:0:
    ``ddp_steps`` (the "DDP, gloo" phase's), then every mode of DDPX_MODES
    in turn, each with its kernel launch counts (B4's backward as
    ``softmax_decode_backward``)."""
    from hrnet_hand_pose_estimation_tpu_torch.parallel import distributed

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    distributed.init_process_group(backend, rank=rank, world_size=world,
                                   init_method=f"tcp://localhost:{port}")
    try:
        zero_counters()
        result = {"steps": ddp_steps(ddp_cfg(), dev, rank, world)}   # the "DDP, gloo" phase's
        result["steps"]["launches"] = counters()
        for name in DDPX_MODES:
            zero_counters()
            fused_softmax_decode.launches_bwd = 0
            result[name] = ddpx_run(name, ddpx_kit(name, dev, rank, world), dev)
            result[name]["launches"] = dict(
                counters(), softmax_decode_backward=fused_softmax_decode.launches_bwd)
            torch.cuda.empty_cache()
        torch.save(result, out_path)
    finally:
        distributed.destroy_process_group()


def ddpx_losses(run) -> np.ndarray:
    out = []
    for entry in run["losses"]:
        out += list(entry.values()) if isinstance(entry, dict) else [entry]
    return np.array(out, np.float64)


def ddpx_gaps(x, y):
    """(largest relative loss gap, largest parameter gap, largest BN
    statistic gap) of run ``x`` from run ``y``."""
    lx, ly = ddpx_losses(x), ddpx_losses(y)
    nz = ly != 0
    loss = float(np.max(np.abs(lx - ly)[nz] / np.abs(ly[nz]))) if nz.any() else 0.0
    params = (x["params"] - y["params"]).abs().max().item()
    if "critic" in y:
        params = max(params, (x["critic"] - y["critic"]).abs().max().item())
    stats = (x["stats"] - y["stats"]).abs().max().item() if y["stats"].numel() else 0.0
    return loss, params, stats


def ddpx_references(dev) -> dict:
    """{mode: (reference, witness)}: each mode's steps in this process on
    the global batches, with the data-parallel step's BN formula and with
    native BN, from one kit."""
    refs = {}
    for mode in DDPX_MODES:
        kit = ddpx_kit(mode, dev, 0, 1)
        refs[mode] = (ddpx_run(mode, kit, dev, formula=True),
                      ddpx_run(mode, kit, dev, formula=False))
        del kit
        torch.cuda.empty_cache()
    return refs


def ddpx_check(ranks, refs, by_name, smi):
    """Each mode's ranks bit-equal, within max(floor, DDP_WITNESS_FACTOR x
    the witness) of one process, their cuboid angles one process's draw,
    B4 forward and backward run by the 3D, WGAN and fusion modes, B5 by
    the levers'."""
    failed = []
    for mode in DDPX_MODES:
        a, b = ranks[0][mode], ranks[1][mode]
        for r in ranks:
            for name, n in r[mode]["launches"].items():
                if name in by_name:
                    by_name[name]["launches_ddpx"] = by_name[name].get("launches_ddpx", 0) + n
        equal = (a["losses"] == b["losses"] and torch.equal(a["params"], b["params"])
                 and torch.equal(a["stats"], b["stats"])
                 and ("critic" not in a or torch.equal(a["critic"], b["critic"])))
        ref, native = refs[mode]
        got, witness = ddpx_gaps(a, ref), ddpx_gaps(native, ref)
        limits = (max(DDP_LOSS_RTOL, DDP_WITNESS_FACTOR * witness[0]),
                  max(DDP_PARAM_ATOL, DDP_WITNESS_FACTOR * witness[1]))
        launches = a["launches"]
        print(f"DDP {mode}, 2 gloo ranks on cuda:0 (float32): ranks bit-equal {equal}; "
              f"against one process on the global batch (the data-parallel BN formula): "
              f"loss gap {got[0]:.3g}, parameters {got[1]:.3g}, BN statistics {got[2]:.3g}; "
              f"witness (one process, native BN) {witness[0]:.3g} / {witness[1]:.3g} / "
              f"{witness[2]:.3g}; limits {limits[0]:.3g} / {limits[1]:.3g}; a rank's "
              f"launches: B4 forward {launches['fused_softmax_decode']}, backward "
              f"{launches['softmax_decode_backward']}, B5 {launches['fused_gaussian_targets']}")
        print(f"DDP {mode} ms a step (host clock, synced): ranks "
              f"{[round(v, 1) for v in a['ms']]} / {[round(v, 1) for v in b['ms']]}; one "
              f"process {[round(v, 1) for v in native['ms']]} (native BN) on {smi} (all the "
              f"DDP phases' processes share one card: the collectives' cost, not scaling)")
        if a.get("angles"):
            both = [torch.cat([x, y]) for x, y in zip(a["angles"], b["angles"])]
            ok = len(both) == len(ref["angles"]) and all(
                torch.equal(x, z) for x, z in zip(both, ref["angles"]))
            print(f"DDP {mode}: the two ranks' cuboid angles, call by call, "
                  f"{[[round(v, 4) for v in x.tolist()] for x in both]}, are one process's "
                  f"draw on the global batch: {ok}")
            if not ok:
                failed.append(f"{mode} angles")
        if not equal or not (got[0] <= limits[0] and got[1] <= limits[1]):
            failed.append(mode)
        if not (np.isfinite(ddpx_losses(a)).all() and torch.isfinite(a["params"]).all()):
            failed.append(f"{mode} not finite")
    for mode in ("alg", "vol", "gan", "fusion"):
        n = ranks[0][mode]["launches"]
        if not (n["fused_softmax_decode"] and n["softmax_decode_backward"]):
            failed.append(f"{mode} did not run B4 forward and backward: {n}")
    if not ranks[0]["levers"]["launches"]["fused_gaussian_targets"]:
        failed.append("the levers' ranks made no targets with B5")
    if failed:
        raise AssertionError(f"DDP modes failed: {failed}")


def start_nccl_tools(tmp: str) -> dict:
    """tools.train3d and tools.train3d_gan on synthetic_vol_smoke.yaml, each
    in the environment torchrun gives one rank (RANK 0, WORLD_SIZE 1) with
    ``--dist_backend nccl``, started: {tool: (process, output dir, batch)}."""
    procs = {}
    for tool, batch in DDPX_NCCL_TOOLS:
        env = dict(os.environ, RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                   MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
        out = Path(tmp) / tool
        cmd = [sys.executable, "-m", f"hrnet_hand_pose_estimation_tpu_torch.tools.{tool}",
               "--cfg", str(SMOKE3D_YAML), "--device", "cuda", "--dist_backend", "nccl",
               "MODEL.VOLUME_SIZE", "32", "TRAIN.IMAGES_PER_GPU", str(batch),
               "TEST.IMAGES_PER_GPU", "8", "OUTPUT_DIR", str(out)]
        procs[tool] = (background(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True, env=env, cwd=Path(__file__).resolve().parent),
                       out, batch)
    return procs


def nccl_tools_check(procs: dict) -> None:
    """Both tools exit 0 after their steps, with rank 0's log, checkpoint
    and best model written."""
    for tool, (proc, out, batch) in procs.items():
        log, _ = proc.communicate(timeout=600)
        steps = [ln for ln in log.splitlines() if "Epoch[" in ln]
        files = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
        print(f"torchrun's environment (RANK 0, WORLD_SIZE 1), python -m ...tools.{tool} "
              f"--cfg {SMOKE3D_YAML.name} --dist_backend nccl TRAIN.IMAGES_PER_GPU {batch}: "
              f"rc {proc.returncode}; {len(steps)} logged steps; "
              + " | ".join(ln.split(" ", 2)[-1][:120] for ln in log.splitlines()
                           if "rank 0 of 1" in ln or "Validate3D" in ln)
              + f"; rank 0's files {files}")
        if (proc.returncode != 0 or "rank 0 of 1" not in log or "Validate3D[0]" not in log
                or not any(f.endswith("ckpt_0.pt") for f in files)
                or len(steps) != 16 // batch):
            raise AssertionError(f"{tool} under NCCL failed:\n{log[-3000:]}")


# -- A11.2: the 'model' mesh axis -------------------------------------------

# A (2, 2) grid on one card: two data rows of two model positions, each a
# share of cuda:0 (the gloo ranks share it too; NCCL takes one card a rank).
TP_GRID = (2, 2)
TP_BATCH = 4                # a data rank's batch in training; the global batch is 8
TP_STEPS = 2                # every split module all-gathers through the host
TP_EVAL_FLOOR = 1e-3        # px: the grid against the data-only mesh in float32


def tp_meshes(dev):
    from hrnet_hand_pose_estimation_tpu_torch.parallel.mesh import make_mesh

    return (make_mesh(("data", "model"), TP_GRID, [dev] * 4),
            make_mesh(("data",), (TP_GRID[0],), [dev] * TP_GRID[0]))


def tp_steps(cfg, dev, batches, global_formula: bool = False):
    """TP_STEPS train steps on this data rank's slice of each global batch
    (the whole batch without a process group): the losses, ms a step
    (host clock around a synced step), this rank's own flat parameters (its
    shards) and the gathered whole parameters and BN statistics, flat in
    name order.  ``global_formula`` as ``ddp_steps``'s."""
    from contextlib import nullcontext

    from hrnet_hand_pose_estimation_tpu_torch.models.layers import synced_batch_stats
    from hrnet_hand_pose_estimation_tpu_torch.parallel import distributed

    model = build_model(cfg)
    state, tx = TS.create_train_state(cfg, model, device=dev)
    step = TS.make_train_step(cfg, model, tx)
    rank, world = distributed.data_rank(), distributed.data_size()
    losses, ms = [], []
    for batch in batches:
        per = batch["images"].shape[0] // world
        mine = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        with synced_batch_stats(lambda x: x) if global_formula else nullcontext():
            state, out = step(state, mine)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
    whole = state.state_dict()          # gathers the shards (every rank of a model group)
    flat = lambda d: torch.cat([v.flatten().float() for v in d.values()])
    stats = {k: v for k, v in whole["batch_stats"].items()
             if not k.endswith("num_batches_tracked")}
    return {"losses": losses, "ms": ms, "local": state.params.cpu(),
            "params": flat(whole["params"]), "stats": flat(stats), "whole": whole,
            "split": TS.state_shardings(distributed.model_size(), state)["params"]}


def tp_batches(cfg, dev):
    from hrnet_hand_pose_estimation_tpu_torch.tools.perf_bn_levers import train_batch

    return [train_batch(cfg, TP_GRID[0] * TP_BATCH, dev, seed=80 + i) for i in range(TP_STEPS)]


def tp_rank(rank: int, world: int, port: int, backend: str, mode: str, out_path: str):
    """One gloo rank of the (2, 2) grid, in a process of its own on cuda:0:
    the flagship at full width in float32 (``ddp_cfg``), TP_STEPS steps at
    TP_BATCH a data rank, with cuDNN deterministic; then rank 0 writes the
    gathered state as the Trainer's checkpoint and reads it back."""
    from hrnet_hand_pose_estimation_tpu_torch.parallel import distributed
    from hrnet_hand_pose_estimation_tpu_torch.parallel.checkpoint import CheckpointManager

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    distributed.init_process_group(backend, rank=rank, world_size=world,
                                   init_method=f"tcp://localhost:{port}")
    try:
        distributed.init_grid(("data", "model"), TP_GRID)
        zero_counters()
        fused_softmax_decode.launches_bwd = 0
        cfg = ddp_cfg()
        result = tp_steps(cfg, dev, tp_batches(cfg, dev))
        result["launches"] = dict(counters(),
                                  softmax_decode_backward=fused_softmax_decode.launches_bwd)
        result["grid"] = (distributed.data_rank(), distributed.model_rank())
        whole = result.pop("whole")
        if rank == 0:
            ckpt = CheckpointManager(str(Path(out_path).parent / "tp_ckpt"))
            ckpt.save(0, whole)
            saved = torch.load(os.path.join(ckpt.directory, "ckpt_0.pt"), map_location="cpu",
                               weights_only=True)["state"]
            full = build_model(cfg).state_dict()
            result["ckpt_full"] = all(tuple(saved["params"][n].shape) == tuple(full[n].shape)
                                      for n in saved["params"]) and all(
                tuple(saved["opt_state"]["trace"][n].shape) == tuple(full[n].shape)
                for n in saved["params"])
            result["ckpt_n"] = len(saved["params"])
        torch.save(result, out_path)
    finally:
        distributed.destroy_process_group()


def tp_eval_phase(smi, by_name, dev):
    """Evaluator2D over the (2, 2) grid against the data-only (2,) mesh on
    the flagship at 256, float32, TF32 off, cuDNN deterministic."""
    from hrnet_hand_pose_estimation_tpu_torch.parallel import tensor_parallel as TP

    grid, data = tp_meshes(dev)
    with phase("model axis: evaluation"), tempfile.TemporaryDirectory() as tmp:
        cfg = eval_cfg(tmp).clone()
        cfg.defrost()
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.freeze()
        state = init_variables(cfg, seed=0, device=dev)
        images = torch.from_numpy(np.random.default_rng(90).normal(
            size=(EVAL_BATCH, 256, 256, 3)).astype(np.float32)).to(dev)
        evs = {name: Evaluator2D(cfg, build_model(cfg), state, mesh=m, device=dev)
               for name, m in (("plain", None), ("data", data), ("grid", grid))}
        coords, ms = {}, {}
        for name, ev in evs.items():
            coords[name] = ev.forward(images)
            ms[name] = time_ms(lambda: ev.forward(images), 3, warmup=1)
        zero_counters()
        evs["grid"].forward(images)
        torch.cuda.synchronize()
        once = add_launches(by_name, "launches_model_axis")
        gap = (coords["grid"] - coords["data"]).abs().max().item()
        witness = (coords["data"] - coords["plain"]).abs().max().item()
        limit = max(TP_EVAL_FLOOR, DDP_WITNESS_FACTOR * witness)
        rep = evs["grid"]._replicas[0]
        split = {n: d for n, d in TP.info(rep).split.items() if d is not None}
        position = TP.position_bytes(rep)
        whole = sum(p.numel() * p.element_size() for p in evs["plain"].model.parameters())
        results = {}
        for name in ("data", "grid"):
            loader = make_test_dataloader(cfg)["Synthetic_kpt"]
            loader.dataset.length = EVAL_BATCH * SHARD_EVAL_BATCHES
            results[name] = evs[name].run(loader, "Synthetic")
        gaps = {k: abs(results["grid"][k] - results["data"][k])
                for k in ("EPE_px", "PCK_AUC_30", "PCK_AUC_full", "PCK@20px")}
        print(f"Evaluator2D over the {TP_GRID} grid on cuda:0, flagship w32 at 256, float32, "
              f"B={EVAL_BATCH}: {len(split)} split leaves; against the data-only mesh max |d| "
              f"{gap:.4g} px (limit {limit:.4g} = max({TP_EVAL_FLOOR}, "
              f"{DDP_WITNESS_FACTOR:g} x the witness {witness:.4g} px: the data-only mesh "
              f"against no mesh), bit-equal {torch.equal(coords['grid'], coords['data'])}; "
              f"metric gaps {json.dumps(gaps)}; B4 launches a forward "
              f"{once['fused_softmax_decode']} (one a data row)")
        print(f"parameter bytes at each model position of a data row: {position} (whole model "
              f"replicated: {whole}); forward ms (host clock, synced): no mesh "
              f"{ms['plain']:.2f}, data-only mesh {ms['data']:.2f}, grid {ms['grid']:.2f} on "
              f"{smi} (every position shares one card: the split's overhead, not scaling)")
        if len(split) != 40 or position[1] >= whole or position[0] >= whole:
            raise AssertionError(f"the grid's replicas do not hold the flagship's 40 split "
                                 f"leaves as shards: {len(split)}, {position}")
        if once["fused_softmax_decode"] != TP_GRID[0]:
            raise AssertionError(f"B4 did not decode once a data row: {once}")
        if not (gap <= limit and all(v <= 0.005 for k, v in gaps.items() if k != "EPE_px")
                and gaps["EPE_px"] <= SHARD_EPE_LIMIT):
            raise AssertionError(f"the grid parts from the data-only mesh: {gap} px, {gaps}")
        del evs, state


def tp_int8_phase(smi, by_name, dev):
    """make_quant_infer over the (2, 2) grid: the weights replicate over
    'model', so it is the data-only mesh's call bit for bit, with the same
    launches (B3, conv_int8 and B1 once a data row)."""
    grid, data = tp_meshes(dev)
    with phase("model axis: int8 serving"), torch.inference_mode():
        cfg = flagship_cfg()
        state = {k: v.to(dev) for k, v in init_variables(cfg, seed=0, device=dev).items()}
        weights = precast_variables(cfg, state, device=dev)
        u8 = uint8_images(71, CHECK_BATCH, dev)
        amax = Q.calibrate(cfg, weights, [normalize(u8[:16])])
        qparams = Q.prepare_serving_qparams(cfg, state, amax)
        on_data = Q.make_quant_infer(cfg, dev, input_norm=NORM, mesh=data)
        on_grid = Q.make_quant_infer(cfg, dev, input_norm=NORM, mesh=grid)
        zero_counters()
        want = on_data(weights, qparams, u8)
        torch.cuda.synchronize()
        launches_data = counters()
        zero_counters()
        got = on_grid(weights, qparams, u8)
        torch.cuda.synchronize()
        launches = add_launches(by_name, "launches_model_axis")
        print(f"make_quant_infer over the {TP_GRID} grid, B={CHECK_BATCH}: bit-equal to the "
              f"data-only mesh {torch.equal(got, want)}; launches {json.dumps(launches)} "
              f"(data-only mesh: {json.dumps(launches_data)}) on {smi}")
        if not torch.equal(got, want) or launches != launches_data:
            raise AssertionError("int8 serving over the grid is not the data-only mesh's")
        if not all(launches[k] for k in ("fused_bottleneck_chain_int8", "conv_int8",
                                         "fused_head_decode_v2")):
            raise AssertionError(f"int8 serving over the grid skipped a kernel: {launches}")
        del weights, state


def tp_train_check(ranks, ref, native, by_name, smi):
    """The grid's steps against one process on the global batch, within
    max(floor, DDP_WITNESS_FACTOR x the witness); the ranks bit-equal where
    they must be."""
    for r in ranks:
        for name, n in r["launches"].items():
            if name in by_name:
                by_name[name]["launches_model_axis"] = (
                    by_name[name].get("launches_model_axis", 0) + n)
    equal = all(torch.equal(r["params"], ranks[0]["params"])
                and torch.equal(r["stats"], ranks[0]["stats"])
                and r["losses"] == ranks[0]["losses"] for r in ranks)
    by_model = {j: [r for r in ranks if r["grid"][1] == j] for j in range(TP_GRID[1])}
    shards = all(torch.equal(rs[0]["local"], r["local"]) for rs in by_model.values()
                 for r in rs)
    differ = not torch.equal(by_model[0][0]["local"], by_model[1][0]["local"])
    n_split = sum(d is not None for d in ranks[0]["split"].values())
    print(f"grid {TP_GRID} of gloo ranks on cuda:0, {TP_BATCH} a data rank, {TP_STEPS} float32 "
          f"sgd steps of the flagship: gathered states and losses bit-equal on all four "
          f"{equal}; shards bit-equal within a model index {shards}, different across "
          f"{differ}; {n_split} split leaves; this rank's flat buffer "
          f"{ranks[0]['local'].numel()} of {ranks[0]['params'].numel()} parameters; rank 0's "
          f"checkpoint has full shapes {ranks[0].get('ckpt_full')} ({ranks[0].get('ckpt_n')} "
          f"parameters); launches a rank {json.dumps(ranks[0]['launches'])}")

    def gaps(x, y):
        loss = max(abs(p[k] - q[k]) / abs(q[k]) for p, q in zip(x["losses"], y["losses"])
                   for k in q if q[k])
        return (loss, (x["params"] - y["params"]).abs().max().item(),
                (x["stats"] - y["stats"]).abs().max().item())

    got, witness = gaps(ranks[0], ref), gaps(native, ref)
    limits = (max(DDP_LOSS_RTOL, DDP_WITNESS_FACTOR * witness[0]),
              max(DDP_PARAM_ATOL, DDP_WITNESS_FACTOR * witness[1]))
    for label, g in (("the grid", got), ("the witness (one process, native BN)", witness)):
        print(f"  {label} against one process x {TP_GRID[0] * TP_BATCH} with the "
              f"data-parallel step's BN formula: largest relative loss gap {g[0]:.3g}; "
              f"parameters after step {TP_STEPS} {g[1]:.3g}; BN statistics {g[2]:.3g}")
    print(f"  limits: {limits[0]:.3g} (losses), {limits[1]:.3g} (parameters); ms a step: "
          f"grid {[round(v, 1) for v in ranks[0]['ms']]}, one process "
          f"{[round(v, 1) for v in ref['ms']]} on {smi} (four ranks and this process share "
          f"one card, and every split module all-gathers through the host)")
    if not (equal and shards and differ and n_split == 40 and ranks[0].get("ckpt_full")):
        raise AssertionError("the grid's ranks disagree, or its checkpoint is not whole")
    if not (got[0] <= limits[0] and got[1] <= limits[1]):
        raise AssertionError(f"the grid parts from one process: {got} against {limits}")
    if not ranks[0]["launches"]["fused_gaussian_targets"]:
        raise AssertionError("the grid's ranks made no targets on the card")


def tp_phases(smi, kernels):
    """A11.2's phases: the four gloo ranks of the (2, 2) grid start first,
    then this process runs the evaluation and int8 serving phases and the
    one-process references while they train, then "model axis: training,
    gloo" checks them.  Launches in ``launches_model_axis``."""
    dev = torch.device("cuda", 0)
    by_name = {k["name"]: k for k in kernels}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.empty_cache()
        ranks = start_ranks(4, "gloo", "grid", tmp, target=tp_rank)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            tp_eval_phase(smi, by_name, dev)
            tp_int8_phase(smi, by_name, dev)
            with phase("model axis: training, gloo"):
                cfg = ddp_cfg()
                batches = tp_batches(cfg, dev)
                ref, native = (tp_steps(cfg, dev, batches, global_formula=f)
                               for f in (True, False))
                tp_train_check(join_ranks(ranks), ref, native, by_name, smi)
        finally:
            torch.backends.cudnn.deterministic = deterministic


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
        rows = layer1_launches(x1, weights, 10)
        print_launches(f"fused_bottleneck_chain B={CHECK_BATCH}", rows, smi)
        kernels[-1].update(per_launch_b32=rows,
                           bytes_floor_ms=sum(r["bytes_ms"] for r in rows))

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
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            plan=print_head_plan(xs, weights.head, f"B={CHECK_BATCH}")))
        head_shape_checks(dev)
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
            err = (fused_head_decode_v2(xs, weights.head)
                   - head_decode_reference(xs, weights.head)).abs().max().item()
            print(f"head decode B={TIME_BATCH}: max|kernel - plain| = {err:.5f} px (limit 0.05)")
            if not err <= 0.05:
                raise AssertionError(f"head kernel disagrees with its plain twin at B=128: {err}")
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
            b2 = next(k for k in kernels if k["name"] == "fused_bottleneck_chain")
            b2[f"library_ms_b{TIME_BATCH}"] = lib_ms
            print(f"cuDNN layer1 at B={TIME_BATCH}: {lib_ms:.3f} ms on {smi}")
            rows = layer1_launches(x1, weights, 10)
            print_launches(f"fused_bottleneck_chain B={TIME_BATCH}", rows, smi)
            b2.update(per_launch_b128=rows,
                      bytes_floor_ms_b128=sum(r["bytes_ms"] for r in rows))
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

    c9_phases(smi)
    new_infer = new_config_phases(cfg, weights, smi, kernels, images, plain)
    int8_context = int8_phases(cfg, state, weights, smi, kernels, new_infer)
    branch_int8_phases(cfg, weights, smi, kernels, *int8_context)
    del int8_context
    head_v1_phases(weights, smi, kernels, infer, images)
    del weights, state, new_infer
    train_phases(smi, kernels)
    eval_phases(smi, kernels)
    mv_phases(smi, kernels)
    train3d_phases(smi, kernels)
    cpm_phases(smi, kernels)
    fusion_phases(smi, kernels)
    volcpm_phases(smi, kernels)
    zoo_phases(smi, kernels)
    temporal_phases(smi, kernels)
    ftl_phases(smi, kernels)
    hourglass_phases(smi)
    mesh_phases(smi)
    with tempfile.TemporaryDirectory() as tmp:
        gate = start_gate(tmp)          # beside the host-paced reader phases
        reader_phases(smi, kernels)
        a8_a7_phases(smi, kernels, gate)
    a11_phases(smi, kernels)
    tp_phases(smi, kernels)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
