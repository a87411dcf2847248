#!/usr/bin/env python3
"""Where the time of the implicit-GEMM kernels and the heads goes, on one NVIDIA card.

Builds timing-only copies of the port's package under
``build/ablation/<variant>/``, each with one part of ``csrc/conv_int8.cu``,
``csrc/basic_chain.cu``, the W8A8 chains (``csrc/int8_chain.cu``,
``csrc/basic_int8.cu`` and their shared code in ``csrc/conv_mainloop.cuh``)
or the head (``csrc/fused_head_decode.cu``: the branch GEMMs that make y_i,
bands' shared rows recomputed included; the upsample; the x_0 GEMM; the
final conv; the cluster's combine) or the first version of the head
(``csrc/head_v1.cu``: the feat gather, the head wgmma, the final conv, the
cluster's combine) removed or replaced, and times
``conv_int8``, ``fused_basic_chain`` (one BasicBlock),
``fused_basic_chain_int8`` (one BasicBlock), the W8A8 layer1 block (one
64 -> 256 and one 256 -> 256 launch), ``fused_head_decode_v2`` (w32 and
w48 widths on the 64x64 map) and ``fused_head_decode`` (v1, w32 widths at
B=32 and B=128) at the flagship's shape classes in each (CUDA events, a
subprocess per variant; the ``v1_`` variants time v1 alone), and the
softmax decode (``csrc/softmax_decode.cu``) with each plane split into 1,
2, 4 or 8 ranges (every variant; the ``b4_`` variants, and every variant
under ``--b4``, time it alone), and the Gaussian targets
(``csrc/gaussian_targets.cu``) with one part of its design undone (the
``b5_`` variants, and every variant under ``--b5``, time it alone at B=32
and B=128; their outputs stay right). The other variants' outputs are
wrong by design, except ``fdiv``, the former quantization by ``__fdiv_rn``,
whose output hashes must equal ``base``'s. Then it checks on the card that
the kernel's quantization, ``float(double(x) * (1.0 / double(sa)))``, rounds
every finite bf16 x to the same clipped int8 as ``__fdiv_rn(x, sa)`` and to
the same float, for 60,000 scales sa drawn log-uniformly from [1e-4, 1e2]
and the powers of two from 2^-14 to 2^6 and their predecessors.

    python3 chip_ablation.py                  # all variants
    python3 chip_ablation.py base fdiv        # some
    python3 chip_ablation.py --b4 base b4_regs32   # the softmax decode alone
    python3 chip_ablation.py --b5 base b5_no_table b5_scalar b5_one_row   # B5 alone

Prints one JSON line per variant, the check, the card's name and power
limit. Needs one CUDA card and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "hrnet_hand_pose_estimation_tpu_torch"
OUT = ROOT / "build" / "ablation"

# variant -> [(file under the package, old text, new text)]
VARIANTS = {
    "base": [],
    # the former quantization: __fdiv_rn(x, sa) for every x
    "fdiv": [("csrc/conv_int8.cu", "return clip_s8(__double2float_rn(__dmul_rn((double)x, rcp)));",
              "return clip_s8(__fdiv_rn(x, (float)rcp));"),
             ("csrc/conv_int8.cu", "const double rcp = __drcp_rn((double)*a.sa);",
              "const double rcp = (double)*a.sa;")],
    "no_halo": [("csrc/conv_int8.cu", "for (int pix0 = p0; p0 < pstep && pix0 < npx;",
                 "for (int pix0 = p0; p0 < 0 && pix0 < npx;"),
                ("csrc/basic_chain.cu", "for (int r = r0; r < halo_px; r += rstep) {",
                 "for (int r = r0; r < 0; r += rstep) {"),
                ("csrc/conv_mainloop.cuh", "  if (p0 >= pstep) return;", "  if (p0 >= 0) return;")],
    # the W8A8 chains' residual tile (the bf16 block input) not copied in
    "no_residual": [("csrc/basic_int8.cu",
                     "__bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.x + off + n));",
                     "make_float2(0.0f, 0.0f);"),
                    ("csrc/int8_chain.cu",
                     "cp_async16(smem_u32(ys + q * lds + vec * 8), in ? a.x + pix * a.Cin + c0 : a.x, in);",
                     "(void)in;")],
    "no_weights": [("csrc/conv_mainloop.cuh",
                    "    if (jn < J) load(jn, ring + (jn % stages) * stage_bytes);", "")],
    "no_mma": [("csrc/conv_int8.cu", "if (nb0 + n0 + jn * 8 < a.Cout) mma_s8(",
                "if (a.relu == 7) mma_s8("),
               ("csrc/basic_chain.cu", "for (int jn = 0; jn < NT; ++jn) mma_bf16(",
                "for (int jn = 0; jn < NT; ++jn) if (a.H < 0) mma_bf16("),
               ("csrc/conv_mainloop.cuh", "for (int jn = 0; jn < NT; ++jn) mma_s8(",
                "for (int jn = 0; jn < NT; ++jn) if (rowb < 0) mma_s8(")],
    "no_store": [("csrc/conv_int8.cu", "      if (oy >= a.Ho || ox >= a.Wo) continue;",
                  "      if (oy >= a.Ho || ox >= a.Wo || a.relu != 7) continue;"),
                 ("csrc/basic_chain.cu", "          if (gy >= a.H || gx >= a.W) continue;",
                  "          if (gy >= a.H || gx >= a.W || a.H > 0) continue;"),
                 ("csrc/basic_int8.cu", "          if (gy >= a.H || gx >= a.W) continue;",
                  "          if (gy >= a.H || gx >= a.W || a.H > 0) continue;"),
                 ("csrc/int8_chain.cu", "if (pixel(q, pix))", "if (pixel(q, pix) && a.H < 0)")],
    "no_barrier": [("csrc/conv_mainloop.cuh", "    cp_async_wait(stages - 2);\n    __syncthreads();",
                    "    cp_async_wait(stages - 2);")],
    # the head (csrc/fused_head_decode.cu), one part skipped at run time (a.K
    # is never negative, so the code stays and only its work goes)
    "head_no_branch_gemm": [("csrc/fused_head_decode.cu",
                             "for (int kq = 0; kq < nrows; kq += 16) {",
                             "for (int kq = 0; kq < nrows && a.K < 0; kq += 16) {")],
    "head_no_upsample": [("csrc/fused_head_decode.cu",
                          "for (int q = 1; q < 4; ++q) {\n          const int* br = bt + q * kBtFields;\n"
                          "          const unsigned ysq",
                          "for (int q = 1; q < 4 && a.K < 0; ++q) {\n          const int* br = bt + q * "
                          "kBtFields;\n          const unsigned ysq")],
    "head_no_x0_gemm": [("csrc/fused_head_decode.cu", "for (int kq = 0; kq < a.cp[0]; kq += 16) {",
                         "for (int kq = 0; kq < a.cp[0] && a.K < 0; kq += 16) {")],
    "head_no_final": [("csrc/fused_head_decode.cu",
                       "if (jn < ktiles) mma_bf16(logit[sl][jn], ah, bwf[jn]);",
                       "if (jn < ktiles && a.K < 0) mma_bf16(logit[sl][jn], ah, bwf[jn]);")],
    "head_no_combine": [("csrc/fused_head_decode.cu",
                         "  cluster.sync();\n  if (cluster.block_rank() == 0) {",
                         "  if (a.K < 0) {"),
                        ("csrc/fused_head_decode.cu", "  cluster.sync();   // no block leaves",
                         "  // no block leaves")],
    # v1 of the head (csrc/head_v1.cu), one part skipped at run time
    "v1_no_gather": [("csrc/head_v1.cu",
                      "const uint4 raw = *reinterpret_cast<const uint4*>(tap[d] + cb);",
                      "const uint4 raw = make_uint4(0, 0, 0, 0);")],
    "v1_no_head_wgmma": [("csrc/head_v1.cu", "for (int ks = 0; ks < ksteps; ++ks)",
                          "for (int ks = 0; ks < ksteps && a.K < 0; ++ks)")],
    "v1_no_final": [("csrc/head_v1.cu", "for (int kk = 0; kk < 6; ++kk)",
                     "for (int kk = 0; kk < 6 && a.K < 0; ++kk)")],
    "v1_no_combine": [("csrc/head_v1.cu", "  cluster.sync();\n  if (rank == 0) {",
                       "  cluster.sync();\n  if (a.K < 0) {")],
    # cycles of a w32 block's first consumer thread by phase (clock64): the
    # feat build, waits for head slabs, the head GEMM (issue and waits),
    # bias/ReLU and the final conv (its slab waits included), the tile's
    # softmax; rank 0 writes them in place of its sample's coordinates
    "v1_clock": [("csrc/head_v1.cu", "    RingPos rp;                        // the ring position of the next slab",
                  "    RingPos rp;\n    long long cyc[5] = {0, 0, 0, 0, 0}, ck = clock64();\n"
                  "#define PH(i) { const long long n_ = clock64(); cyc[i] += n_ - ck; ck = n_; }"),
                 ("csrc/head_v1.cu", "      bar_sync(1 + wg, 128);", "      bar_sync(1 + wg, 128);\n PH(0)"),
                 ("csrc/head_v1.cu", "          mbar_wait(full_u + 8 * rp.st, rp.ph);\n"
                  "          const int ksteps",
                  "          mbar_wait(full_u + 8 * rp.st, rp.ph);\n PH(1)\n"
                  "          const int ksteps"),
                 ("csrc/head_v1.cu", "          release(rp.st);\n        }\n#pragma unroll",
                  "          release(rp.st);\n PH(2)\n        }\n#pragma unroll"),
                 ("csrc/head_v1.cu", "          release(rp.st);\n        }\n      }",
                  "          release(rp.st);\n        }\n PH(3)\n      }"),
                 ("csrc/head_v1.cu", "            if (g8 == 0) merge_softmax(wpart[k], m, s, su, sv);\n"
                  "          }\n        }\n      }\n    }\n",
                  "            if (g8 == 0) merge_softmax(wpart[k], m, s, su, sv);\n"
                  "          }\n        }\n      }\n PH(4)\n    }\n    if (tid == 0 && rank == 0)\n"
                  "      for (int i = 0; i < 5; ++i) a.out[(size_t)b * a.K * 2 + i] = (float)cyc[i];\n"),
                 ("csrc/head_v1.cu", "  cluster.sync();\n  if (rank == 0) {",
                  "  cluster.sync();\n  if (a.K < 0) {")],
    # per slab of sample 0's first block: when the ring warp issued it, when
    # the first consumer thread asked for it and when it had it (clock64),
    # written in place of the coordinates
    "v1_trace": [("csrc/head_v1.cu",
                  "  __syncthreads();   // the barriers and the tables exist before any copy or wait",
                  "  __syncthreads();\n"
                  "  const long long t0_ = clock64();   // all threads leave the barrier together\n"
                  "  float* tr_ = (b == 0 && rank == 0) ? a.out : nullptr;"),
                 ("csrc/head_v1.cu", "        mbar_expect_tx(fb, bytes);",
                  "        if (tr_ && j < 512) tr_[3 * j] = (float)(clock64() - t0_);\n"
                  "        mbar_expect_tx(fb, bytes);"),
                 ("csrc/head_v1.cu", "    RingPos rp;                        // the ring position of the next slab",
                  "    RingPos rp;\n    int j = 0;"),
                 ("csrc/head_v1.cu", "          mbar_wait(full_u + 8 * rp.st, rp.ph);\n"
                  "          const int ksteps",
                  "          const bool rec_ = tr_ && (tid & 127) == 0 && wg == 0 && j < 512;\n"
                  "          if (rec_) tr_[3 * j + 1] = (float)(clock64() - t0_);\n"
                  "          mbar_wait(full_u + 8 * rp.st, rp.ph);\n"
                  "          if (rec_) tr_[3 * j + 2] = (float)(clock64() - t0_);\n"
                  "          ++j;\n"
                  "          const int ksteps"),
                 ("csrc/head_v1.cu", "          mbar_wait(full_u + 8 * rp.st, rp.ph);\n"
                  "          const unsigned fb",
                  "          const bool rec_ = tr_ && (tid & 127) == 0 && wg == 0 && j < 512;\n"
                  "          if (rec_) tr_[3 * j + 1] = (float)(clock64() - t0_);\n"
                  "          mbar_wait(full_u + 8 * rp.st, rp.ph);\n"
                  "          if (rec_) tr_[3 * j + 2] = (float)(clock64() - t0_);\n"
                  "          ++j;\n"
                  "          const unsigned fb"),
                 ("csrc/head_v1.cu", "  cluster.sync();\n  if (rank == 0) {",
                  "  cluster.sync();\n  if (a.K < 0) {")],
    # B4 (csrc/softmax_decode.cu) with 8 blocks per SM (32 registers a thread)
    "b4_regs32": [("csrc/softmax_decode.cu", "constexpr int kBlocksPerSM = 4;",
                   "constexpr int kBlocksPerSM = 8;")],
    # B5 (csrc/gaussian_targets.cu and its plan), one part of the design
    # undone: expf per element, 4-byte stores, one row per block, bands
    # sized for 1024 blocks, streaming stores (st.global.cs); outputs stay
    # right, so each variant is also checked against its twin
    "b5_no_table": [("ops/kernels/gaussian_targets.py",
                     "table = 8 * joints + lut <= SMEM_LIMIT", "table = False")],
    "b5_scalar": [("csrc/gaussian_targets.cu", "  *reinterpret_cast<float4*>(p) = v;",
                   "  p[0] = v.x;\n  p[1] = v.y;\n  p[2] = v.z;\n  p[3] = v.w;")],
    "b5_one_row": [("ops/kernels/gaussian_targets.py", "MAX_ROWS = 16", "MAX_ROWS = 1")],
    "b5_min1024": [("ops/kernels/gaussian_targets.py", "MIN_BLOCKS = 512", "MIN_BLOCKS = 1024")],
    "b5_cs": [("csrc/gaussian_targets.cu", "  *reinterpret_cast<float4*>(p) = v;",
               "  __stcs(reinterpret_cast<float4*>(p), v);")],
}

CHECK_CU = r'''
#include "common.cuh"
namespace {
__global__ void quant_check(const float* sas, unsigned long long* bad) {
  const float sa = sas[blockIdx.y];
  const double rcp = __drcp_rn((double)sa);
  unsigned long long clipped = 0, raw = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < 65536; i += gridDim.x * blockDim.x) {
    const float x = __uint_as_float((unsigned)i << 16);     // every bf16 bit pattern
    if (!isfinite(x)) continue;
    const float want = __fdiv_rn(x, sa);
    const float got = __double2float_rn(__dmul_rn((double)x, rcp));
    clipped += hrnet::clip_s8(want) != hrnet::clip_s8(got);
    raw += __float_as_uint(want) != __float_as_uint(got);
  }
  atomicAdd(bad, clipped);
  atomicAdd(bad + 1, raw);
}
}
extern "C" int hrnet_quant_check(const void* sas, int n, void* bad, void* stream) {
  quant_check<<<dim3(64, n), 256, 0, (cudaStream_t)stream>>>((const float*)sas,
                                                              (unsigned long long*)bad);
  return (int)cudaGetLastError();
}
'''

CLASSES_INT8 = [(3, 1, 32, 32, 64), (3, 1, 64, 64, 32), (3, 1, 128, 128, 16), (3, 1, 256, 256, 8),
                (3, 1, 256, 32, 64), (3, 2, 32, 64, 64), (1, 1, 64, 32, 32)]
CLASSES_B7 = [(64, 32), (32, 64), (16, 128), (8, 256)]
INT8_L1_BLOCKS = [(64, True), (256, False)]      # (Cin, projection) of layer1's W8A8 blocks


def decode_splits(dev) -> dict:
    """B4's device time per call (torch.profiler, 20 calls) on bf16
    64x64x21 logits at B=32 and B=128 with each plane split into S = 1, 2,
    4 and 8 ranges (``decode_plan`` takes 8)."""
    import torch

    from chip_timing import device_busy
    from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import _build
    from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.softmax_decode import decode_plan

    res = {}
    for b in (32, 128):
        x = (torch.randn(b, 64, 64, 21, device=dev) * 3).to(torch.bfloat16)
        out = torch.empty(b, 21, 2, device=dev)
        plan = decode_plan(b, 64, 64, 21, 2)
        for splits in (1, 2, 4, 8):
            def call():
                _build.check(_build.lib().hrnet_fused_softmax_decode(
                    x.data_ptr(), None, 1.7, out.data_ptr(), None, b, 64, 64, 21, 1, splits,
                    plan.piece_px, plan.smem, torch.cuda.current_stream().cuda_stream), "decode")
            res[f"fused_softmax_decode B={b} bf16 S={splits} device"] = round(
                device_busy(call, 20)[1], 5)
    return res


def targets_times(dev) -> dict:
    """B5 at the train step's shape (64x64x21, sigma 2) on seeded joints at
    B=32 and B=128: ms per call (CUDA events, 50 calls), device ms
    (torch.profiler, 20 calls), the plan, and max|kernel - twin|."""
    import numpy as np
    import torch

    from chip_timing import device_busy
    from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.gaussian_targets import (
        fused_gaussian_targets, gaussian_targets_reference, targets_plan)

    res = {}
    for b in (32, 128):
        rng = np.random.default_rng(b)
        j = torch.from_numpy(rng.uniform(2, 62, size=(b, 21, 2)).astype(np.float32)).to(dev)
        v = torch.ones(b, 21, device=dev)
        call = lambda: fused_gaussian_targets(j, v, 64, 2.0)
        err = (call() - gaussian_targets_reference(j, v, 64, 2.0)).abs().max().item()
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            call()
        end.record()
        torch.cuda.synchronize()
        res[f"fused_gaussian_targets B={b}"] = dict(
            ms=round(start.elapsed_time(end) / 50, 5), device_ms=round(device_busy(call, 20)[1], 5),
            plan=targets_plan(b, 21, 64, 2.0)._asdict(), max_abs_err=err)
    return res


def make(name):
    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / PKG, dst / PKG, ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in VARIANTS[name]:
        path = dst / PKG / fname
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: {fname} no longer holds {old!r}")
        path.write_text(text.replace(old, new))
    if name == "base":
        (dst / PKG / "csrc" / "quant_check.cu").write_text(CHECK_CU)
    return dst


def time_variant(where: str, only: str) -> None:
    """Runs in a subprocess with the variant's copy first on sys.path."""
    import numpy as np
    import torch

    sys.path.insert(0, where)
    from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import _build
    from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.conv_int8 import SiteQ, conv_int8
    from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import fused_basic_chain

    if not str(_build.CSRC).startswith(where):
        raise SystemExit(f"imported the package from {_build.CSRC}, not from {where}")
    dev, rng = torch.device("cuda"), np.random.default_rng(0)
    v1_only = Path(where).name.startswith("v1_")
    if only == "--b4" or Path(where).name.startswith("b4_"):
        print(json.dumps({Path(where).name: decode_splits(dev)}), flush=True)
        return
    if only == "--b5" or Path(where).name.startswith("b5_"):
        print(json.dumps({Path(where).name: targets_times(dev)}), flush=True)
        return

    def ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    res = {}
    from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import fused_head_decode as HD

    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    widths, k = (32, 64, 128, 256), 21
    n = sum(widths)
    head = HD.HeadParams(f32(rng.normal(size=(n, n)) * 0.05), f32(rng.normal(size=n) * 0.1),
                         f32(rng.normal(size=(n, k)) * 0.1), f32(rng.normal(size=k) * 0.1),
                         f32(np.float32(1.3)))
    for b in (32, 128):
        xs = [torch.from_numpy(np.abs(rng.normal(size=(b, 64 >> i, 64 >> i, c))).astype(
            np.float32)).to(dev, torch.bfloat16) for i, c in enumerate(widths)]
        res[f"fused_head_decode (v1) B={b} {widths} 64x64"] = round(
            ms(lambda: HD.fused_head_decode(xs, head)), 4)
    if Path(where).name == "v1_clock":
        out = HD.fused_head_decode(xs, head)
        cyc = out.reshape(out.shape[0], -1)[:, :5].double().mean(0).tolist()
        res["cycles of a w32 B=128 block's first consumer thread"] = dict(zip(
            ("feat build", "slab waits", "head GEMM", "bias/ReLU + final conv", "tile softmax"),
            [round(c) for c in cyc]))
    if Path(where).name == "v1_trace":
        tr = HD.fused_head_decode(xs, head).reshape(-1)[:1536].double().reshape(512, 3)
        n = 4 * 5 * 9                                    # slabs of a w32 block
        issue, req, got = tr[:n, 0], tr[:n, 1], tr[:n, 2]
        late = issue > req
        res["slab trace, sample 0's first block"] = dict(
            slabs=n, wait_cycles=round((got - req).sum().item()),
            issued_after_asked=int(late.sum()),
            wait_cycles_when_issued_late=round((got - req)[late].sum().item()),
            copy_latency_mean=round((got - issue)[late].mean().item()) if late.any() else None,
            lead_cycles_median=round((req - issue)[~late].median().item()) if (~late).any()
            else None)
    if v1_only:
        print(json.dumps({Path(where).name: res}), flush=True)
        return
    res.update(decode_splits(dev))
    for k, stride, cin, cout, h in CLASSES_INT8:
        x = torch.relu(torch.from_numpy(rng.normal(size=(128, h, h, cin)).astype(np.float32))
                       ).to(dev, torch.bfloat16)          # half zeros, as after a ReLU
        kq = torch.from_numpy(rng.integers(-127, 128, size=(cout, k, k, cin)).astype(np.int8)).to(dev)
        ws, sa = torch.full((cout,), 1e-3, device=dev), torch.tensor(0.0137, device=dev)
        q = SiteQ(kq, ws, sa, sa * ws, torch.zeros(cout, device=dev))
        key = f"conv_int8 {k}x{k}/s{stride} {cin}->{cout} at {h}x{h}"
        res[key] = round(ms(lambda: conv_int8(x, q, stride=stride, relu=True)), 4)
        y = conv_int8(x, q, stride=stride, relu=False)
        res[key + " hash"] = hashlib.sha1(y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:12]
    for h, c in CLASSES_B7:
        x = torch.relu(torch.from_numpy(rng.normal(size=(128, h, h, c)).astype(np.float32))
                       ).to(dev, torch.bfloat16)
        p = []
        for _ in range(2):
            p += [torch.from_numpy(rng.normal(size=(3, 3, c, c)).astype(np.float32) * 0.02).to(
                dev, torch.bfloat16), torch.zeros(c, device=dev)]
        res[f"fused_basic_chain 1 block {h}x{h}x{c}"] = round(ms(lambda: fused_basic_chain(x, p, 1)), 4)
    from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import int8_chain as I8

    i8 = lambda *shape: torch.from_numpy(rng.integers(-127, 128, size=shape).astype(np.int8)).to(dev)
    for h, c in CLASSES_B7:
        x = torch.relu(torch.from_numpy(rng.normal(size=(128, h, h, c)).astype(np.float32))
                       ).to(dev, torch.bfloat16)
        p = (f32(np.full((1, 1), 11.3)), i8(9 * c, c), f32(np.full(c, 3e-3 / np.sqrt(9 * c))),
             f32(np.zeros(c)), i8(9 * c, c), f32(np.full(c, 1e-4 / np.sqrt(9 * c))), f32(np.zeros(c)))
        res[f"fused_basic_chain_int8 1 block {h}x{h}x{c}"] = round(
            ms(lambda: I8.fused_basic_chain_int8(x, p, 1)), 4)
    for cin, proj in INT8_L1_BLOCKS:
        x = torch.relu(torch.from_numpy(rng.normal(size=(128, 64, 64, cin)).astype(np.float32))
                       ).to(dev, torch.bfloat16)
        p = dict(inv1=f32(np.full((1, 1), 9.7)), kq1=i8(cin, 64), a1=f32(np.full(64, 1e-3)),
                 c1=f32(np.zeros(64)), kq2=i8(576, 64), a2=f32(np.full(64, 1e-3)),
                 c2=f32(np.zeros(64)), kq3=i8(64, 256), a3=f32(np.full(256, 1e-4)),
                 c3=f32(np.zeros(256)))
        if proj:
            p.update(kqs=i8(cin, 256), as_=f32(np.full(256, 1e-4)), cs=f32(np.zeros(256)))
        kp = I8._kernel_params(p)
        plan = I8.int8_bottleneck_plan(128, 64, 64, cin, 64, 256, proj)
        res[f"int8 layer1 block {cin}->256 at 64x64"] = round(
            ms(lambda: I8._launch_bottleneck_int8(x, kp, plan)), 4)
    for widths, k in (((32, 64, 128, 256), 21), ((48, 96, 192, 384), 21)):
        n = sum(widths)
        xs = [torch.from_numpy(rng.normal(size=(128, 64 >> i, 64 >> i, c)).astype(np.float32)).to(
            dev, torch.bfloat16) for i, c in enumerate(widths)]
        head = HD.HeadParams(f32(rng.normal(size=(n, n)) * 0.05), f32(rng.normal(size=n) * 0.1),
                             f32(rng.normal(size=(n, k)) * 0.3), f32(rng.normal(size=k) * 0.1),
                             f32(np.float32(1.3)))
        res[f"fused_head_decode_v2 B=128 {widths} 64x64"] = round(
            ms(lambda: HD.fused_head_decode_v2(xs, head)), 4)
    if (Path(where) / PKG / "csrc" / "quant_check.cu").exists():
        fn = _build.lib().hrnet_quant_check
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        r = np.random.default_rng(5)
        pw = np.ldexp(1.0, np.arange(-14, 7))
        sas = np.concatenate([np.exp(r.uniform(np.log(1e-4), np.log(1e2), 60000)), pw,
                              np.nextafter(pw.astype(np.float32), np.float32(0))]).astype(np.float32)
        bad = torch.zeros(2, dtype=torch.int64, device=dev)
        for i in range(0, len(sas), 30000):
            chunk = torch.from_numpy(sas[i:i + 30000]).to(dev)
            if fn(chunk.data_ptr(), chunk.numel(), bad.data_ptr(),
                  torch.cuda.current_stream().cuda_stream):
                raise SystemExit("quant_check did not launch")
        torch.cuda.synchronize()
        res["quantization check"] = (f"{len(sas)} scales x every finite bf16: "
                                     f"{int(bad[0])} clipped int8 and {int(bad[1])} f32 quotients "
                                     f"differ from __fdiv_rn")
    print(json.dumps({Path(where).name: res}), flush=True)


def main(names) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ablation.py needs a CUDA card", file=sys.stderr)
        return 1
    only = [n for n in names if n in ("--b4", "--b5")][:1]
    names = [n for n in names if n not in ("--b4", "--b5")] or list(VARIANTS)
    dirs = [make(n) for n in names]
    build = "from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import _build; _build.build()"
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=d) for d in dirs]
    if any(p.wait() for p in procs):
        return 1
    for d in dirs:
        if subprocess.call([sys.executable, __file__, "--time", str(d), *only]):
            return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        time_variant(sys.argv[2], (sys.argv[3:] or [""])[0])
    else:
        sys.exit(main(sys.argv[1:]))
