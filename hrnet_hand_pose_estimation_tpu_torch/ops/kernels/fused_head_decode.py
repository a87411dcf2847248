"""HRNet head + spatial softmax + soft-argmax, fused.

Port of the TPU kernel ``ops/pallas/fused_head_decode.py::fused_head_decode_v2``
of the JAX package, with its int8-input mode.  ``fused_head_decode_v2`` runs
the one launch of ``csrc/fused_head_decode.cu`` (a thread-block cluster of
row bands per sample, plan ``head_plan``) for tensors on the card and the
plain PyTorch twin ``head_decode_reference`` for tensors on the CPU.  Both
compute the head with the 1x1 conv commuted ahead of the upsample, as the
TPU kernel:

    acc    = x0 @ W0 + sum_i up_i(bf16(x_i @ W_i))      (W_i: rows of w_head)
    y      = bf16(relu(acc + b_head))
    logits = (y @ w_final + b_final) * temp
    coords = soft_argmax(spatial_softmax(logits))       -> (B, K, 2) [u, v]

where ``up_i`` is the separable align-corners bilinear upsample with its
W-mix weights rounded to bf16 and its H-mix taps in f32.

With ``input_scales`` (the int8 serving path's ``HEAD_SCALES_KEY``), the
branches are int8 ``(B, h, w, C_i)`` with ``x_i ~= sa_i * xq_i``: the scale
folds into the weight slice in f32 before the bf16 cast,
``W_i = bf16(w_head[rows_i] * sa_i)``, and the int8 values enter the
products as bf16 (exact for |v| <= 127), as in the TPU kernel.

``fused_head_decode`` is the port of the first version of that TPU kernel,
``ops/pallas/fused_head_decode.py::fused_head_decode`` (v1), which upsamples
first and convolves at full resolution: ``csrc/head_v1.cu`` on the card,
the plain twin ``head_decode_v1_reference`` on the CPU.  Both compute

    up_i   = bf16(x_i @ bf16(M_i))        M_i = kron_interp(h_i, h0), f32 sums
    feat   = concat(x0, up_1, up_2, up_3)                   (bf16)
    y      = bf16(relu(feat @ w_head + b_head))
    logits = (y @ w_final + b_final) * temp
    coords = soft_argmax(spatial_softmax(logits))       -> (B, K, 2) [u, v]

on square maps; the twin multiplies the dense Kronecker matrices, the
kernel gathers each upsampled pixel's (at most four) nonzero taps.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from functools import lru_cache
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..upsample import align_corners_matrix, kron_interp
from . import _build
from .fused_bottleneck import fold_conv_bn


class HeadParams(NamedTuple):
    """Folded head weights.  ``w_head``/``w_final`` are float32, or
    ``w_final`` bfloat16 once cast for serving; the kernel and its twin use
    them in bf16.  The int8-input mode needs ``w_head`` in float32: the
    scales fold into it before the cast."""

    w_head: torch.Tensor    # (C, C) folded head conv, (in, out)
    b_head: torch.Tensor    # (C,) f32
    w_final: torch.Tensor   # (C, K), (in, out)
    b_final: torch.Tensor   # (K,) f32
    temp: torch.Tensor      # () f32 softmax temperature


def prepare_head_params(state: Mapping[str, torch.Tensor]) -> HeadParams:
    """Fold ``last_layer``'s BN into its 1x1 conv and pack the final conv,
    from a PoseHRNet state_dict (unfolded).  A head without
    ``trainable_temp`` gets temperature 1."""
    k, b_head = fold_conv_bn(state, "last_layer.0", "last_layer.1")
    w_final = state["last_layer.3.weight"].float()
    if w_final.shape[2:] != (1, 1):
        raise ValueError("the fused head needs FINAL_CONV_KERNEL == 1")
    temp = state.get("trainable_temp", torch.ones((), device=w_final.device))
    return HeadParams(k[0, 0].contiguous(), b_head.contiguous(),
                      w_final[:, :, 0, 0].t().contiguous(),
                      state["last_layer.3.bias"].float().contiguous(),
                      temp.float().reshape(()))


def _offsets(xs: Sequence[torch.Tensor]) -> list[int]:
    return np.cumsum([0] + [x.shape[3] for x in xs]).tolist()


def _validate(xs: Sequence[torch.Tensor], params: HeadParams,
              input_scales: Optional[Sequence] = None) -> None:
    if len(xs) != 4:
        raise ValueError(f"the head takes 4 branch tensors, got {len(xs)}")
    want_dtype = torch.bfloat16 if input_scales is None else torch.int8
    if input_scales is not None:
        if len(input_scales) != 4:
            raise ValueError(f"input_scales: want 4 scales, got {len(input_scales)}")
        if params.w_head.dtype != torch.float32:
            raise ValueError("int8 inputs need w_head in float32 (the scales fold into it)")
    b = xs[0].shape[0]
    for i, x in enumerate(xs):
        if x.dim() != 4 or x.shape[0] != b:
            raise ValueError(f"branch {i}: want (B={b}, h, w, C), got {tuple(x.shape)}")
        if x.dtype != want_dtype:
            raise ValueError(f"branch {i} must be {want_dtype}, got {x.dtype}")
        if x.device != xs[0].device:
            raise ValueError(f"branch {i} on {x.device}, branch 0 on {xs[0].device}")
        if i and min(x.shape[1:3]) < 2:
            raise ValueError(f"branch {i}: the upsample needs h, w >= 2")
    _validate_params(xs, params)


def _validate_params(xs: Sequence[torch.Tensor], params: HeadParams) -> None:
    c = _offsets(xs)[-1]
    n, k = params.w_final.shape
    want = {"w_head": (c, n), "b_head": (n,), "w_final": (n, k), "b_final": (k,), "temp": ()}
    for name, shape in want.items():
        t = getattr(params, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: want shape {shape}, got {tuple(t.shape)}")
        if t.device != xs[0].device:
            raise ValueError(f"{name} on {t.device}, inputs on {xs[0].device}")
    for name in ("b_head", "b_final", "temp"):
        if getattr(params, name).dtype != torch.float32:
            raise ValueError(f"{name} must be float32")


def branch_weights(xs: Sequence[torch.Tensor], params: HeadParams,
                   input_scales: Optional[Sequence] = None) -> list[torch.Tensor]:
    """The four bf16 row slices of ``w_head`` the branches multiply, each
    scaled by its branch's int8 scale in f32 first when ``input_scales``
    is given (as the TPU kernel's wrapper does)."""
    offs = _offsets(xs)
    slices = [params.w_head[offs[i]:offs[i + 1]] for i in range(4)]
    if input_scales is not None:
        slices = [w.float() * torch.as_tensor(sa, dtype=torch.float32, device=w.device)
                  for w, sa in zip(slices, input_scales)]
    return [w.to(torch.bfloat16).contiguous() for w in slices]


def head_logits_reference(xs: Sequence[torch.Tensor], params: HeadParams,
                          input_scales: Optional[Sequence] = None) -> torch.Tensor:
    """The twin's head: 4 NHWC bf16 branches (or int8 ones with
    ``input_scales``) -> logits (B, H0, W0, K) f32, before the softmax."""
    _, h0, w0, _ = xs[0].shape
    w_slices = [w.float() for w in branch_weights(xs, params, input_scales)]
    acc = xs[0].float() @ w_slices[0]
    for i, x in enumerate(xs[1:], start=1):
        h, w = x.shape[1:3]
        y = (x.float() @ w_slices[i]).to(torch.bfloat16).float()
        uw = torch.from_numpy(align_corners_matrix(w, w0).copy()).to(x.device)
        uh = torch.from_numpy(align_corners_matrix(h, h0).copy()).to(x.device)
        t = torch.einsum("Ww,bhwn->bhWn", uw.to(torch.bfloat16).float(), y)
        acc = acc + torch.einsum("Hh,bhWn->bHWn", uh, t)
    y = torch.relu(acc + params.b_head).to(torch.bfloat16).float()
    return (y @ params.w_final.to(torch.bfloat16).float() + params.b_final) * params.temp


def head_decode_reference(xs: Sequence[torch.Tensor], params: HeadParams,
                          input_scales: Optional[Sequence] = None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: 4 NHWC bf16 branches (or int8 ones
    with ``input_scales``) -> (B, K, 2) f32.

    On a card, disable TF32 (``torch.backends.cuda.matmul.allow_tf32``)
    for a float32 reference.
    """
    return soft_argmax_reference(head_logits_reference(xs, params, input_scales))


def soft_argmax_reference(logits: torch.Tensor) -> torch.Tensor:
    """The twin's decode: logits (B, H0, W0, K) -> (B, K, 2) [u, v], the
    expectation of the column and the row under the spatial softmax, in
    the logits' dtype."""
    b, h0, w0, k = logits.shape
    p = torch.softmax(logits.reshape(b, h0 * w0, k), dim=1)
    idx = torch.arange(h0 * w0, device=p.device)
    u = torch.einsum("bpk,p->bk", p, (idx % w0).to(p.dtype))
    v = torch.einsum("bpk,p->bk", p, (idx // w0).to(p.dtype))
    return torch.stack([u, v], dim=-1)


def band_decode_reference(logits: torch.Tensor, bands: int) -> torch.Tensor:
    """The kernel's softmax decode by row bands, in plain PyTorch: logits
    (B, H0, W0, K) -> (B, K, 2).  The rows split into bands of
    ceil(H0 / bands) rows (the last one shorter, as ``head_plan`` splits
    them); each band forms per joint its max m, sum e, sum e*u and sum e*v
    with e = exp(l - m), and the bands combine rescaled by exp(m - M), in
    the logits' dtype.  For the tests; no path calls it."""
    b, h0, w0, k = logits.shape
    rb = -(-h0 // bands)
    u = torch.arange(w0, dtype=logits.dtype, device=logits.device)
    parts = []
    for y0 in range(0, h0, rb):
        band = logits[:, y0:y0 + rb]                                 # (B, R, W0, K)
        v = torch.arange(y0, y0 + band.shape[1], dtype=logits.dtype, device=logits.device)
        m = band.amax(dim=(1, 2))                                    # (B, K)
        e = torch.exp(band - m[:, None, None, :])
        parts.append((m, e.sum(dim=(1, 2)), (e * u[None, None, :, None]).sum(dim=(1, 2)),
                      (e * v[None, :, None, None]).sum(dim=(1, 2))))
    big = torch.stack([p[0] for p in parts]).amax(dim=0)
    s = su = sv = 0.0
    for m, se, seu, sev in parts:
        f = torch.exp(m - big)
        s, su, sv = s + se * f, su + seu * f, sv + sev * f
    return torch.stack([su / s, sv / s], dim=-1)


MAX_JOINTS = 128        # the TPU kernel pads K to one 128-lane row
CHUNK = 32              # head columns per chunk (csrc kNC)
JOINT_GROUP = 32        # joints per walk of the head (kJG): K > 32 walks it again
MAX_BANDS = 8           # blocks per sample: the portable cluster size
PASS_TILES = 32         # m16 head tiles per pass: 8 warps x 4 slots (kMT)
SLAB_ROWS = 128         # weight rows per ring stage where a whole branch does not fit
BRANCH_TILES = 12       # m16 tiles of one branch GEMM per pass: 8 warps x 6 / 4 n8 tiles
PAD_ROWS = 32           # zero rows past each y_i buffer (kPadRows)


class HeadPlan(NamedTuple):
    """The one launch of ``csrc/fused_head_decode.cu`` for one call."""

    cp: Tuple[int, ...]     # each branch's weight rows: C_i rounded up to 16
    np: int                 # the head width the kernel runs at: N rounded up to 32
    joint_groups: int       # walks of the head: ceil(K / 32)
    bands: int              # blocks per sample, one cluster; block r owns rows r*band_rows ..
    band_rows: int          # output rows per band (the last band may have fewer)
    pass_rows: int          # output rows per pass: one staging of the branch rows
    unit_rows: int          # consecutive rows of one column group a warp takes as a unit
    src_rows: Tuple[int, int, int]   # rows of branches 1-3 staged per pass, at most
    kw: int                 # k16 steps of the W-mix window (source columns of 16 outputs)
    chunk: int              # head columns per chunk
    slab_rows: int          # weight rows per ring stage: a whole branch's or 128, >= cp_0 + 32
    stages: int             # depth of the weight ring (2-6 slabs)
    smem: int               # dynamic shared memory bytes
    grid: Tuple[int, int]   # (bands, B)
    cluster: Tuple[int, int, int]   # (bands, 1, 1)


def _take(nbytes: int) -> int:
    return -(-nbytes // 128) * 128


def _head_smem(pass_rows: int, w0: int, cp: Tuple[int, ...], src_rows, src_widths, slab_rows: int,
               stages: int, np_: int, groups: int, kw: int, joint_groups: int) -> int:
    """Shared memory of a plan, as ``csrc/fused_head_decode.cu::head_layout``
    lays it out (each part rounded up to 128 bytes)."""
    px = [-(-(s * w) // 16) * 16 for s, w in zip(src_rows, src_widths)]
    return (_take(2 * pass_rows * w0 * (cp[0] + 8))
            + sum(_take(2 * p * (c + 8)) for p, c in zip(px, cp[1:]))
            + sum(_take(2 * (p + PAD_ROWS) * (CHUNK + 8)) for p in px)
            + _take(2 * stages * slab_rows * CHUNK) + _take(4 * np_)
            + _take(16 * 3 * pass_rows) + _take(16 * 3 * groups * kw * 32) + _take(4 * 3 * groups)
            + _take(4 * 4 * 8 + 8 * 4) + _take(8 * stages)
            + _take(4 * (8 * JOINT_GROUP * 3 + JOINT_GROUP))
            + _take(16 * joint_groups * JOINT_GROUP))


def band_passes(h0: int, bands: int, band_rows: int, pass_rows: int) -> list:
    """The (first row, rows) of every pass of every band, as the kernel walks them."""
    return [(y, min(pass_rows, min(h0, r * band_rows + band_rows) - y))
            for r in range(bands) for y in range(r * band_rows, min(h0, (r + 1) * band_rows),
                                                  pass_rows)]


def _unit_rows(groups: int, pass_rows: int) -> int:
    """Rows of one column group a warp takes together (4, 2 or 1): the most
    that still gives all 8 warps a unit and at most 4 m16 tiles each.  A
    unit's rows share source rows, whose W-mix it computes once."""
    for ur in (4, 2):
        units = groups * -(-pass_rows // ur)
        if units >= 8 and -(-units // 8) * ur <= 4:
            return ur
    return 1


@lru_cache(maxsize=64)
def head_plan(b: int, shapes: Tuple[Tuple[int, int], ...], widths: Tuple[int, ...], n: int,
              k: int) -> HeadPlan:
    """The kernel's plan for branches of spatial ``shapes`` and channel
    ``widths``, head width ``n`` and ``k`` joints: any widths, any B*h*w,
    K up to 128 (the TPU kernel's limit).  The passes take as many rows as
    fit 32 m16 tiles, 12 m16 tiles of each branch and the shared memory, the
    bands (at most 8) as many passes as the rows need; then the largest
    weight slab and the deepest ring that fit.  Raises ValueError on what
    the kernel does not take."""
    if not 0 < k <= MAX_JOINTS:
        raise ValueError(f"the head takes 1 <= K <= {MAX_JOINTS} joints, got {k}")
    if b < 1 or n < 1 or min(widths) < 1 or any(min(hw) < 1 for hw in shapes):
        raise ValueError(f"empty head input: B {b}, shapes {shapes}, widths {widths}, N {n}")
    if any(min(hw) < 2 for hw in shapes[1:]):
        raise ValueError("the upsample needs h, w >= 2 on branches 1-3")
    h0, w0 = shapes[0]
    groups = -(-w0 // 16)
    if groups > PASS_TILES:
        raise ValueError(f"the head kernel takes maps up to {16 * PASS_TILES} columns, got {w0}")
    cp = tuple(-(-c // 16) * 16 for c in widths)
    np_ = -(-n // CHUNK) * CHUNK
    joint_groups = -(-k // JOINT_GROUP)
    taps = _tap_table(tuple(shapes[1:]), h0, w0)
    row_lo = taps[:, 0, 0, :h0].astype(np.int64)
    col_lo = taps[:, 1, 0, :w0].astype(np.int64)
    kw = max(-(-(int(col_lo[i, min(x + 15, w0 - 1)]) + 2 - int(col_lo[i, x])) // 16)
             for i in range(3) for x in range(0, w0, 16))
    if kw > 2:
        raise ValueError(f"the W-mix window of 16 output columns spans more than 32 source "
                         f"columns on branches {shapes[1:]} at width {w0}")
    # slabs of a whole branch where the ring fits them (fewer barriers, and
    # the branch GEMMs' accumulators live within one slab), else 128 rows
    slabs = sorted({max(r, cp[0] + CHUNK) for r in (max(cp[1:]), SLAB_ROWS)}, reverse=True)
    src_widths = [w for _, w in shapes[1:]]
    for rp in range(min(h0, PASS_TILES // groups), 0, -1):
        bands = min(MAX_BANDS, -(-h0 // rp))
        band_rows = -(-h0 // bands)
        bands = -(-h0 // band_rows)
        pass_rows = -(-band_rows // -(-band_rows // rp))     # equal passes within a band
        src_rows = [2, 2, 2]
        for y, rows in band_passes(h0, bands, band_rows, pass_rows):
            for i in range(3):
                src_rows[i] = max(src_rows[i], int(row_lo[i, y + rows - 1]) + 2 - int(row_lo[i, y]))
        if any(-(-(s * w) // 16) > BRANCH_TILES for s, w in zip(src_rows, src_widths)):
            continue
        unit_rows = _unit_rows(groups, pass_rows)
        for slab_rows in slabs:
            for stages in (6, 5, 4, 3, 2):
                smem = _head_smem(pass_rows, w0, cp, src_rows, src_widths, slab_rows, stages,
                                  np_, groups, kw, joint_groups)
                if smem <= _build.SMEM_LIMIT:
                    return HeadPlan(cp, np_, joint_groups, bands, band_rows, pass_rows,
                                    unit_rows, tuple(src_rows), kw, CHUNK, slab_rows, stages,
                                    smem, (bands, b), (bands, 1, 1))
    raise ValueError(f"the head kernel's pass of one row does not fit branches {widths} on "
                     f"maps {shapes} in shared memory")


def _pad2(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """w zero-padded to (rows, cols), contiguous."""
    return torch.nn.functional.pad(w, (0, cols - w.shape[1], 0, rows - w.shape[0])).contiguous()


def _swizzle(t: torch.Tensor) -> torch.Tensor:
    """t (..., R, 4, 8): rows of four 16-byte pieces.  Row r's piece u takes
    piece u ^ ((r >> 1) & 3), as the kernel's ``slab_addr`` reads it back
    (the 8 rows of an ldmatrix phase then fall on 8 bank groups)."""
    rows = torch.arange(t.shape[-3], device=t.device)
    idx = torch.arange(4, device=t.device)[None, :] ^ ((rows[:, None] >> 1) & 3)
    return torch.gather(t, -2, idx[:, :, None].expand(t.shape[-3:]).expand(t.shape)).contiguous()


def slab_layout(w: torch.Tensor, joint_groups: int = 0) -> torch.Tensor:
    """The kernel's weight layout: w (R, 32n) -> (n, R, 32), each chunk of
    32 columns contiguous so that a slab of rows is one bulk copy; with
    ``joint_groups`` g, w_final (32n, 32g) -> (g, n, 32, 32), a chunk's 32
    rows of a joint group.  Rows swizzled by ``_swizzle``."""
    r, c = w.shape
    if joint_groups:
        t = w.reshape(r // CHUNK, CHUNK, joint_groups, 4, 8).permute(2, 0, 1, 3, 4)
    else:
        t = w.reshape(r, c // CHUNK, 4, 8).permute(1, 0, 2, 3)
    return _swizzle(t).reshape(*t.shape[:-2], CHUNK)


@lru_cache(maxsize=16)
def _tap_table(shapes: Tuple[Tuple[int, int], ...], h0: int, w0: int) -> np.ndarray:
    """(3 branches, 2 axes {rows, cols}, 3 fields {lo, a, b}, L) f32: the two
    taps of every output row/column.  Row taps are f32 and column weights
    bf16-rounded, as in the TPU kernel (f32 H-mix, bf16 W-mix matrix)."""
    size = max(h0, w0)
    taps = np.zeros((3, 2, 3, size), np.float32)
    for i, (h, w) in enumerate(shapes):
        for axis, (src, dst) in enumerate(((h, h0), (w, w0))):
            m = align_corners_matrix(src, dst)
            if axis == 1:
                m = torch.from_numpy(m.copy()).to(torch.bfloat16).float().numpy()
            lo = np.minimum(np.argmax(m > 0, axis=1), src - 2)
            rows = np.arange(dst)
            taps[i, axis, 0, :dst] = lo
            taps[i, axis, 1, :dst] = m[rows, lo]
            taps[i, axis, 2, :dst] = m[rows, lo + 1]
    taps.flags.writeable = False
    return taps


@lru_cache(maxsize=16)
def _taps(shapes: Tuple[Tuple[int, int], ...], h0: int, w0: int, device: str) -> torch.Tensor:
    """``_tap_table`` on ``device``."""
    return torch.from_numpy(_tap_table(shapes, h0, w0).copy()).to(device)


_WEIGHTS: "OrderedDict[tuple, tuple]" = OrderedDict()
_WEIGHTS_LOCK = threading.Lock()


def _cached(srcs: Sequence[torch.Tensor], key: tuple, make):
    """``make()``, made once per parameter tensors ``srcs`` and ``key`` and
    kept for the next calls (a serving loop calls with the same ones): an
    entry holds weak references and is used only while they still name the
    same tensors at the same ``_version``, so new or modified parameters are
    laid out anew.  Inference tensors have no version counter: they are laid
    out per call."""
    if any(t.is_inference() for t in srcs):
        return make()
    key = (key, tuple((id(t), t._version) for t in srcs))
    with _WEIGHTS_LOCK:
        hit = _WEIGHTS.get(key)
        if hit is not None and all(r() is t for r, t in zip(hit[0], srcs)):
            _WEIGHTS.move_to_end(key)
            return hit[1]
    value = make()
    with _WEIGHTS_LOCK:
        _WEIGHTS[key] = ([weakref.ref(t) for t in srcs], value)
        while len(_WEIGHTS) > 8:
            _WEIGHTS.popitem(last=False)
    return value


def _kernel_weights(xs: Sequence[torch.Tensor], params: HeadParams,
                    input_scales: Optional[Sequence], plan: HeadPlan) -> tuple:
    """The weights at the kernel's pitches (rows C_i rounded up to 16,
    columns N rounded up to 32, the final conv's K columns up to 32 per
    joint group) in ``slab_layout``, and b_head padded: (w_0..w_3, w_final,
    b_head), made once per parameter tensors (``_cached``)."""
    srcs = [params.w_head, params.b_head, params.w_final]
    srcs += [sa for sa in (input_scales or ()) if isinstance(sa, torch.Tensor)]
    key = ("v2", tuple(x.shape[3] for x in xs), plan.cp, plan.np, plan.joint_groups,
           None if input_scales is None else
           tuple(None if isinstance(sa, torch.Tensor) else float(sa) for sa in input_scales))

    def make():
        np_, n = plan.np, params.w_final.shape[0]
        w_slices = [slab_layout(_pad2(w, cp, np_)) for w, cp in
                    zip(branch_weights(xs, params, input_scales), plan.cp)]
        w_final = slab_layout(_pad2(params.w_final.to(torch.bfloat16), np_,
                                    plan.joint_groups * JOINT_GROUP), plan.joint_groups)
        b_head = torch.nn.functional.pad(params.b_head, (0, np_ - n)).contiguous()
        return w_slices, w_final, b_head

    return _cached(srcs, key, make)


def fused_head_decode_v2(xs: Sequence[torch.Tensor], params: HeadParams,
                         input_scales: Optional[Sequence] = None) -> torch.Tensor:
    """xs: 4 NHWC bf16 branch tensors (B, h0/2^i, w0/2^i, C_i) -> (B, K, 2) f32;
    with ``input_scales`` (4 scales, float or 0-dim float32 tensors) the
    branches are int8 and ``x_i ~= sa_i * xs[i]``.

    CUDA tensors run the kernel (one launch, plan ``head_plan``: any widths,
    any B*h*w, K <= 128) and CPU tensors the plain twin; any other device
    raises.  ``launches`` counts the kernel's launches (1 per call).
    """
    _validate(xs, params, input_scales)
    dev = xs[0].device
    if dev.type == "cpu":
        return head_decode_reference(xs, params, input_scales)
    if dev.type != "cuda":
        raise ValueError(f"fused_head_decode_v2 runs on cuda or cpu, not {dev}")
    b, h0, w0, c0 = xs[0].shape
    n, k = params.w_final.shape
    plan = head_plan(b, tuple((int(x.shape[1]), int(x.shape[2])) for x in xs),
                     tuple(int(x.shape[3]) for x in xs), int(n), int(k))
    for i, x in enumerate(xs):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"branch {i} must be contiguous NHWC and 16-byte aligned")

    w_slices, w_final, b_head = _kernel_weights(xs, params, input_scales, plan)
    b_final = params.b_final.contiguous()
    temp = params.temp.contiguous()
    shapes = tuple((x.shape[1], x.shape[2]) for x in xs[1:])
    taps = _taps(shapes, h0, w0, str(dev))
    out = torch.empty((b, k, 2), dtype=torch.float32, device=dev)

    err = _build.lib().hrnet_head_fused(
        *(x.data_ptr() for x in xs), *(w.data_ptr() for w in w_slices), b_head.data_ptr(),
        w_final.data_ptr(), b_final.data_ptr(), temp.data_ptr(), taps.data_ptr(), out.data_ptr(),
        b, h0, w0, c0, *(d for hw in shapes for d in hw), *(x.shape[3] for x in xs[1:]), plan.np, k,
        taps.shape[-1], int(input_scales is not None), plan.bands, plan.band_rows,
        plan.pass_rows, plan.unit_rows, plan.kw, *plan.src_rows, plan.slab_rows, plan.stages,
        plan.smem,
        _build.stream_ptr(dev))
    _build.check(err, "hrnet_head_fused")
    fused_head_decode_v2.launches += 1
    return out


def head_kernel_attributes(plan: HeadPlan, int8_inputs: bool = False) -> dict:
    """The registers per thread, local (spill) bytes per thread and static
    shared bytes (``cudaFuncGetAttributes``) of the kernel instance that
    runs ``plan``: slabs that hold whole branches, or not."""
    import ctypes

    vals = (ctypes.c_int * 3)()
    whole = int(plan.slab_rows >= max(plan.cp[1:]))
    _build.check(_build.lib().hrnet_head_fused_attributes(int(int8_inputs), whole, vals),
                 "hrnet_head_fused_attributes")
    return dict(registers=vals[0], local_bytes=vals[1], static_smem=vals[2])


fused_head_decode_v2.launches = 0


# --------------------------------------------------------------------------
# v1: upsample first, then the head at full resolution (TPU kernel
# fused_head_decode)
# --------------------------------------------------------------------------

def _validate_v1(xs: Sequence[torch.Tensor], params: HeadParams) -> None:
    """What the TPU kernel takes: four square branches, K <= 128."""
    if len(xs) != 4:
        raise ValueError(f"the head takes 4 branch tensors, got {len(xs)}")
    b = xs[0].shape[0]
    for i, x in enumerate(xs):
        if x.dim() != 4 or x.shape[0] != b:
            raise ValueError(f"branch {i}: want (B={b}, h, w, C), got {tuple(x.shape)}")
        if x.shape[1] != x.shape[2]:
            raise ValueError(f"branch {i}: v1 needs square maps, got {tuple(x.shape[1:3])}")
        if not x.is_floating_point():
            raise ValueError(f"branch {i} must be floating point, got {x.dtype}")
        if x.device != xs[0].device:
            raise ValueError(f"branch {i} on {x.device}, branch 0 on {xs[0].device}")
    _validate_params(xs, params)
    k = params.w_final.shape[1]
    if k > MAX_JOINTS:
        raise ValueError(f"v1 takes K <= {MAX_JOINTS} joints, got {k}")


@lru_cache(maxsize=16)
def _kron_bf16(src: int, dst: int, device: str) -> torch.Tensor:
    """``kron_interp(src, dst)`` rounded to bf16, held as float32 on ``device``."""
    m = torch.from_numpy(kron_interp(src, dst).copy())
    return m.to(torch.bfloat16).float().to(device)


def head_decode_v1_reference(xs: Sequence[torch.Tensor], params: HeadParams) -> torch.Tensor:
    """Plain PyTorch twin of v1: 4 square NHWC branches (any float dtype,
    cast to bf16) -> (B, K, 2) f32, with the dense Kronecker matrices.

    On a card, disable TF32 (``torch.backends.cuda.matmul.allow_tf32``)
    for a float32 reference.
    """
    b, h0, w0, _ = xs[0].shape
    dev = xs[0].device
    feats = [xs[0].to(torch.bfloat16).float().reshape(b, h0 * w0, -1)]
    for x in xs[1:]:
        s = x.shape[1]
        m = _kron_bf16(s, h0, str(dev))                        # (s*s, h0*h0)
        xf = x.to(torch.bfloat16).float().reshape(b, s * s, -1)
        feats.append((m.t() @ xf).to(torch.bfloat16).float())  # (B, h0*w0, C_i)
    feat = torch.cat(feats, dim=-1)
    y = torch.relu(feat @ params.w_head.to(torch.bfloat16).float() + params.b_head)
    y = y.to(torch.bfloat16).float()
    logits = (y @ params.w_final.to(torch.bfloat16).float() + params.b_final) * params.temp
    e = torch.exp(logits - logits.amax(dim=1, keepdim=True))  # (B, HW, K)
    s = e.sum(dim=1)
    idx = torch.arange(h0 * w0, device=dev)
    u = (e * (idx % w0).float()[:, None]).sum(dim=1) / s
    v = (e * (idx // w0).float()[:, None]).sum(dim=1) / s
    return torch.stack([u, v], dim=-1)


@lru_cache(maxsize=16)
def _taps_v1(sizes: Tuple[int, ...], dst: int, device: str) -> torch.Tensor:
    """(3 branches, 4 fields {lo, hi, wa, wb}, dst) f32: output coordinate d
    of branch i samples source coordinates lo and hi with weights wa and wb,
    the nonzero entries of row d of ``align_corners_matrix(s_i, dst)`` (hi =
    lo and wb = 0 for a 1-pixel map).  A kron_interp entry is the float32
    product of a row tap and a column tap."""
    taps = np.zeros((3, 4, dst), np.float32)
    for i, src in enumerate(sizes):
        m = align_corners_matrix(src, dst)
        rows = np.arange(dst)
        lo = np.minimum(np.argmax(m > 0, axis=1), max(src - 2, 0))
        hi = np.minimum(lo + 1, src - 1)
        taps[i] = lo, hi, m[rows, lo], np.where(hi > lo, m[rows, hi], 0.0)
    return torch.from_numpy(taps).to(device)


V1_CHUNK = 96                # head columns per chunk: the head wgmma's N (csrc kNC)
V1_SLAB = V1_CHUNK * 128     # bytes of one ring stage: 96 rows of 64 bf16 (kSlab)
V1_KBLOCK = 64 * 128         # bytes of one K block of 64 feat rows (kKBlock)
V1_WARPS = 8                 # consumer warps: two warpgroups of 64 rows


class HeadV1Plan(NamedTuple):
    """The one launch of ``csrc/head_v1.cu`` for one call."""

    cp: Tuple[int, ...]     # each branch's channels as the kernel reads them: C_i rounded up to 8
    ctot: int               # feat width the head GEMM runs at: sum(cp) rounded up to 16
    np: int                 # head width the kernel runs at: N rounded up to 96
    joint_groups: int       # groups of 32 joints: ceil(K / 32)
    kblocks: int            # 64-column K blocks of feat
    chunks: int             # 96-column chunks of the head
    warpgroups: int         # consumer warpgroups with rows: a tile is 64 * warpgroups pixels
    tiles: int              # tiles per sample
    cluster: int            # blocks per sample, one thread-block cluster
    block_tiles: int        # tiles each block walks (the last ones may lie past the map)
    stages: int             # depth of the weight ring
    src_rows: Tuple[int, int, int]   # source rows of branches 1-3 a tile stages, at most
    smem: int               # dynamic shared memory bytes
    grid: Tuple[int, int]   # (cluster, B)


def _v1_smem(warpgroups: int, kblocks: int, stages: int, h0: int, np_: int,
             joint_groups: int, stage_bytes: int) -> int:
    """Shared memory of a v1 plan, as ``csrc/head_v1.cu::v1_layout`` lays it
    out (each part rounded up to 128 bytes, 1024 bytes to align the base)."""
    return (1024 + _take(warpgroups * kblocks * V1_KBLOCK) + _take(stages * V1_SLAB)
            + _take(stage_bytes) + _take(48 * h0) + _take(4 * np_)
            + _take(4 * JOINT_GROUP * joint_groups)
            + _take(16 * V1_WARPS * JOINT_GROUP * joint_groups)
            + _take(16 * JOINT_GROUP * joint_groups) + 2 * _take(8 * stages) + _take(16))


def _v1_staging(sizes: Tuple[int, ...], h0: int, cp: Tuple[int, ...], tile_px: int):
    """(bytes, source rows of branches 1-3 at most) a tile of ``tile_px``
    pixels stages: per branch, the source rows from the lower row tap of its
    first image row to the upper one of its last."""
    taps = _taps_v1(tuple(sizes), h0, "cpu").numpy()
    hw = h0 * h0
    rows = [1, 1, 1]
    for p0 in range(0, hw, tile_px):
        y0, y1 = p0 // h0, (min(hw, p0 + tile_px) - 1) // h0
        for i in range(3):
            rows[i] = max(rows[i], int(taps[i, 1, y1]) - int(taps[i, 0, y0]) + 1)
    nbytes = sum(_take(2 * r * s * c) for r, s, c in zip(rows, sizes, cp[1:]))
    return nbytes, tuple(rows)


@lru_cache(maxsize=64)
def head_v1_plan(b: int, h0: int, widths: Tuple[int, ...], n: int, k: int,
                 sizes: Tuple[int, ...]) -> HeadV1Plan:
    """The v1 kernel's plan for a square ``h0`` map, branch ``widths``, head
    width ``n``, ``k`` joints and square branches 1-3 of ``sizes``: tiles of
    128 pixels (two warpgroups) with
    the deepest ring of 3-6 slabs that fits beside the tile's staged rows,
    else tiles of 64 pixels with the deepest ring of 2-6 slabs that fits; a
    cluster of the most blocks (a power of two, at most 8) that the tiles
    fill, each block streaming its own weight slabs.
    Raises ValueError where K > 128 or a 64-row feat tile does not fit in
    shared memory."""
    if not 0 < k <= MAX_JOINTS:
        raise ValueError(f"v1 takes K <= {MAX_JOINTS} joints, got {k}")
    if b < 1 or h0 < 1 or n < 1 or min(widths) < 1:
        raise ValueError(f"empty head input: B {b}, map {h0}, widths {widths}, N {n}")
    cp = tuple(-(-c // 8) * 8 for c in widths)
    ctot = -(-sum(cp) // 16) * 16
    np_ = -(-n // V1_CHUNK) * V1_CHUNK
    joint_groups = -(-k // JOINT_GROUP)
    kblocks = -(-ctot // 64)
    for warpgroups, depths in ((2, (6, 5, 4, 3)), (1, (6, 5, 4, 3, 2))):
        stage_bytes, src_rows = _v1_staging(sizes, h0, cp, 64 * warpgroups)
        for stages in depths:
            smem = _v1_smem(warpgroups, kblocks, stages, h0, np_, joint_groups, stage_bytes)
            if smem <= _build.SMEM_LIMIT:
                tiles = -(-h0 * h0 // (64 * warpgroups))
                cluster = 1 << (min(MAX_BANDS, tiles).bit_length() - 1)
                return HeadV1Plan(cp, ctot, np_, joint_groups, kblocks, np_ // V1_CHUNK,
                                  warpgroups, tiles, cluster, -(-tiles // cluster), stages,
                                  src_rows, smem, (cluster, b))
    raise ValueError(f"v1's feat tile of 64 rows x {ctot} columns does not fit in shared memory "
                     f"(branch widths {widths})")


def _swizzle128(t: torch.Tensor) -> torch.Tensor:
    """t (..., R, 8, 8): rows of eight 16-byte pieces.  Row r's piece q
    takes piece q ^ (r % 8): the 128-byte swizzle in which wgmma reads a
    K-major operand."""
    rows = torch.arange(t.shape[-3], device=t.device)
    idx = torch.arange(8, device=t.device)[None, :] ^ (rows[:, None] % 8)
    return torch.gather(t, -2, idx[:, :, None].expand(t.shape[-3:]).expand(t.shape)).contiguous()


def v1_weight_stream(params: HeadParams, widths: Tuple[int, ...], plan: HeadV1Plan) -> torch.Tensor:
    """The v1 kernel's weights as the slabs it streams, (chunks, kblocks +
    joint_groups, 6144) bf16: per 96-column chunk c of the head, the
    kblocks slabs of w_head^T (96 head columns x 64 feat rows, K-major,
    ``_swizzle128``), then per group of 32 joints the chunk's rows of
    w_final^T (32 joints x the chunk's 96 head columns as two K blocks of
    64, the second half empty; 8 KB of the 12 KB slab).  Branch i's rows of
    w_head sit at feat column cp_0 + .. + cp_{i-1}; every padding row and
    column is zero."""
    n, k = params.w_final.shape
    dev, bf16 = params.w_head.device, torch.bfloat16
    offs, feat = np.cumsum([0, *widths]), np.cumsum([0, *plan.cp])
    wh = torch.zeros((plan.np, plan.kblocks * 64), dtype=bf16, device=dev)
    for i in range(4):
        wh[:n, feat[i]:feat[i] + widths[i]] = params.w_head[offs[i]:offs[i + 1]].t().to(bf16)
    heads = _swizzle128(wh.reshape(plan.chunks, V1_CHUNK, plan.kblocks, 8, 8).permute(0, 2, 1, 3, 4))
    wf = torch.zeros((plan.joint_groups * JOINT_GROUP, plan.chunks, 128), dtype=bf16, device=dev)
    wf[:k, :, :V1_CHUNK] = _pad2(params.w_final.t().to(bf16), k, plan.np).reshape(
        k, plan.chunks, V1_CHUNK)
    finals = _swizzle128(wf.reshape(plan.joint_groups, JOINT_GROUP, plan.chunks, 2, 8, 8)
                         .permute(2, 0, 3, 1, 4, 5))
    finals = finals.reshape(plan.chunks, plan.joint_groups, -1)
    finals = torch.nn.functional.pad(finals, (0, V1_SLAB // 2 - finals.shape[-1]))
    return torch.cat([heads.reshape(plan.chunks, plan.kblocks, -1), finals], dim=1).contiguous()


def fused_head_decode(xs: Sequence[torch.Tensor], params: HeadParams) -> torch.Tensor:
    """v1 of the fused head: xs 4 square NHWC branch tensors (B, s_i, s_i,
    C_i) of any float dtype (cast to bf16) -> (B, K, 2) f32.

    CUDA tensors run the kernel (one launch, plan ``head_v1_plan``: any
    widths whose 64-row feat tile fits, K <= 128) and CPU tensors the plain
    twin; any other device raises.  ``launches`` counts the kernel's
    launches (1 per call).
    """
    _validate_v1(xs, params)
    dev = xs[0].device
    if dev.type == "cpu":
        return head_decode_v1_reference(xs, params)
    if dev.type != "cuda":
        raise ValueError(f"fused_head_decode runs on cuda or cpu, not {dev}")
    b, h0 = xs[0].shape[:2]
    n, k = params.w_final.shape
    widths = tuple(int(x.shape[3]) for x in xs)
    sizes = tuple(int(x.shape[1]) for x in xs[1:])
    plan = head_v1_plan(int(b), int(h0), widths, int(n), int(k), sizes)
    # channels padded with zeros to multiples of 8: whole 16-byte rows to copy
    xs = [x.to(torch.bfloat16) for x in xs]
    xs = [(x if x.shape[3] == cp else torch.nn.functional.pad(x, (0, cp - x.shape[3]))).contiguous()
          for x, cp in zip(xs, plan.cp)]
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError("the kernel needs 16-byte aligned branches")
    wstream, b_head = _cached(
        [params.w_head, params.b_head, params.w_final], ("v1", widths, plan.np, plan.ctot),
        lambda: (v1_weight_stream(params, widths, plan),
                 torch.nn.functional.pad(params.b_head, (0, plan.np - n)).contiguous()))
    b_final, temp = params.b_final.contiguous(), params.temp.contiguous()
    taps = _taps_v1(sizes, int(h0), str(dev))
    out = torch.empty((b, k, 2), dtype=torch.float32, device=dev)
    err = _build.lib().hrnet_head_v1(
        *(x.data_ptr() for x in xs), wstream.data_ptr(), b_head.data_ptr(), b_final.data_ptr(),
        temp.data_ptr(), taps.data_ptr(), out.data_ptr(), b, h0, *sizes, *plan.cp, plan.ctot,
        plan.np, k, plan.warpgroups, plan.cluster, plan.block_tiles, plan.stages,
        *plan.src_rows, plan.smem, _build.stream_ptr(dev))
    _build.check(err, "hrnet_head_v1")
    fused_head_decode.launches += 1
    return out


def head_v1_attributes(plan: HeadV1Plan) -> dict:
    """The registers per thread, local (spill) bytes per thread and static
    shared bytes (``cudaFuncGetAttributes``) of the v1 kernel instance that
    runs ``plan`` (one per number of joint groups)."""
    import ctypes

    vals = (ctypes.c_int * 3)()
    _build.check(_build.lib().hrnet_head_v1_attributes(plan.joint_groups, vals),
                 "hrnet_head_v1_attributes")
    return dict(registers=vals[0], local_bytes=vals[1], static_smem=vals[2])


fused_head_decode.launches = 0
