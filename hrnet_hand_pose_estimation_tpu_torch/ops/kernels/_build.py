"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain
C interface, ``build/kernels/libhrnet_kernels.so`` beside the package,
loaded with ``ctypes``.  No PyTorch header is
included, so the build takes seconds, not minutes.  The build runs at the
first use of a kernel and again only when a source or a flag changes: a
stamp file beside the library holds the hash of both.

Each C entry point returns ``cudaGetLastError()`` after its launches; the
wrappers call :func:`check` on it, so a launch the card refuses raises at
once instead of leaving the output unwritten.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
LIB_NAME = "libhrnet_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# what the implicit-GEMM kernels' launch plans must respect (csrc/common.cuh
# kWarps, csrc/conv_mainloop.cuh kSmemLimit): warps per block, and the most
# dynamic shared memory one block may take on an H100
WARPS = 8
SMEM_LIMIT = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point: (argtypes), all returning cudaError_t as int
SIGNATURES = {
    # x, out, w1, b1, w2, b2, w3, b3, ws, bs, B, H, W, Cin, Cm, Cout, then the plan:
    # TH, TW, KS, stages, smem; stream
    "hrnet_bottleneck_block": (_P,) * 10 + (_I,) * 11 + (_P,),
    # x0, x1, x2, x3, w0, w1, w2, w3, b_head, w_final, b_final, temp, taps, out,
    # B, H0, W0, C0, h1, w1, h2, w2, h3, w3, C1, C2, C3, Np, K, L, in_int8, then the plan:
    # bands, RB, RP, UR, KW, SR1, SR2, SR3, slab_rows, stages, smem; stream
    "hrnet_head_fused": (_P,) * 14 + (_I,) * 28 + (_P,),
    # in_int8, whole, out (3 ints: registers, local bytes, static shared bytes)
    "hrnet_head_fused_attributes": (_I, _I, _P),
    # x0, x1, x2, x3, wstream, b_head, b_final, temp, taps, out, B, H0, s1, s2, s3,
    # C0, C1, C2, C3 (padded to multiples of 8), ctot, Np, K, then the plan: wgs,
    # cluster, tiles, stages, SR1, SR2, SR3, smem; stream
    "hrnet_head_v1": (_P,) * 10 + (_I,) * 20 + (_P,),
    # joint_groups, out (3 ints: registers, local bytes, static shared bytes)
    "hrnet_head_v1_attributes": (_I, _P),
    # x, out, w, scale, bias, sa, B, H, W, Cin, Cinp, Ho, Wo, Cout, KH, KW, stride, pad,
    # relu, then the plan: TR, TW, HR, HC, ldh, KB, WM, MT, NT, NB, stages, smem; stream
    "hrnet_conv_int8": (_P,) * 6 + (_I,) * 25 + (_P,),
    # x, out, inv1, kq1, a1, c1, kq2, a2, c2, kq3, a3, c3, kqs, as, cs (kq's N-major),
    # B, H, W, Cin, Cm, Cout, then the plan: TH, TW, stages, smem; stream
    "hrnet_bottleneck_int8_block": (_P,) * 15 + (_I,) * 10 + (_P,),
    # x, out, w1, b1, w2, b2, B, H, W, C, then the plan: TH, TW, WM, MT, NT, KS,
    # stages, smem; stream
    "hrnet_basic_block": (_P,) * 6 + (_I,) * 12 + (_P,),
    # x, out, inv1, kq1, a1, c1, kq2, a2, c2 (kq's N-major), B, H, W, C, then the plan:
    # TH, TW, WM, MT, NT, KB, stages, smem; stream
    "hrnet_basic_int8_block": (_P,) * 9 + (_I,) * 12 + (_P,),
    # x_s2d, y, ws1, bs1, ws2, bs2, B, Hs, Ws, then the plan: TH, TW, stages, smem; stream
    "hrnet_stem_s2d": (_P,) * 6 + (_I,) * 7 + (_P,),
    # joints, vis, out, B, K, res, win, sig2, then the plan: rows, table, smem; stream
    "hrnet_gaussian_targets": (_P,) * 3 + (_I,) * 4 + (_F,) + (_I,) * 3 + (_P,),
    # logits, temp (or null), temp_value, out, stats (or null), B, H, W, K, is_bf16,
    # then the plan: splits, piece, smem; stream
    "hrnet_fused_softmax_decode": (_P, _P, _F, _P, _P) + (_I,) * 8 + (_P,),
    # logits, temp (or null), temp_value, stats, coords, grad, dx, partials, counter,
    # dtemp (the last three null without dT), B, H, W, K, is_bf16, vector, blocks; stream
    "hrnet_softmax_decode_bwd": (_P, _P, _F) + (_P,) * 7 + (_I,) * 6 + (_P,),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels cannot be built")


def sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library on disk matches the sources.
    Returns the library's path; raises if nvcc is missing or fails."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if lib_path.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, LIB_NAME)
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in sources()]
        cmds = [[nvcc, *(("-Xptxas=-v",) if verbose else ()), *NVCC_FLAGS, "-c", "-o", obj,
                 str(src)] for src, obj in zip(sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        cmds.append([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs])
        outs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in zip(cmds, procs)]
        if all(rc == 0 for _, _, rc in outs):
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            outs.append((cmds[-1], link.stdout + link.stderr, link.returncode))
        for cmd, out, rc in outs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
            if verbose:
                print(out, end="", flush=True)
        os.replace(tmp, lib_path)      # atomic: concurrent builders never see half a file
    stamp.write_text(digest)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            handle.hrnet_error_string.argtypes = [ctypes.c_int]
            handle.hrnet_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib().hrnet_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
