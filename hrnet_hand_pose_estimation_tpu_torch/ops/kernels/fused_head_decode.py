"""HRNet head + spatial softmax + soft-argmax, fused.

Port of the TPU kernel ``ops/pallas/fused_head_decode.py::fused_head_decode_v2``
of the JAX package, with its int8-input mode.  ``fused_head_decode_v2`` runs
the three launches of ``csrc/fused_head_decode.cu`` for tensors on the card
and the plain PyTorch twin ``head_decode_reference`` for tensors on the CPU.  Both compute the
head with the 1x1 conv commuted ahead of the upsample, as the TPU kernel:

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


def head_decode_reference(xs: Sequence[torch.Tensor], params: HeadParams,
                          input_scales: Optional[Sequence] = None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: 4 NHWC bf16 branches (or int8 ones
    with ``input_scales``) -> (B, K, 2) f32.

    On a card, disable TF32 (``torch.backends.cuda.matmul.allow_tf32``)
    for a float32 reference.
    """
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
    logits = (y @ params.w_final.to(torch.bfloat16).float() + params.b_final) * params.temp
    b, _, _, k = logits.shape
    p = torch.softmax(logits.reshape(b, h0 * w0, k), dim=1)
    idx = torch.arange(h0 * w0, device=p.device)
    u = torch.einsum("bpk,p->bk", p, (idx % w0).float())
    v = torch.einsum("bpk,p->bk", p, (idx // w0).float())
    return torch.stack([u, v], dim=-1)


MAX_JOINTS = 128        # the TPU kernel pads K to one 128-lane row


class HeadPlan(NamedTuple):
    """The three launches of ``csrc/fused_head_decode.cu`` for one call."""

    cp: Tuple[int, ...]     # each branch's weight rows: C_i rounded up to 16
    np: int                 # the head width the kernels run at: N rounded up to 16
    conv_blocks: int        # (a): 64-row blocks of branches 1-3, each over all np columns
    conv_smem: int          # (a)'s dynamic shared memory bytes
    logits_grid: Tuple[int, int]   # (b): (64-pixel blocks, B)
    logits_smem: int        # (b)'s dynamic shared memory bytes


def head_plan(b: int, shapes: Tuple[Tuple[int, int], ...], widths: Tuple[int, ...], n: int,
              k: int) -> HeadPlan:
    """The kernels' plan for branches of spatial ``shapes`` and channel
    ``widths``, head width ``n`` and ``k`` joints: any widths, any B*h*w,
    K up to 128 (the TPU kernel's limit).  Raises ValueError on what they
    do not take."""
    if not 0 < k <= MAX_JOINTS:
        raise ValueError(f"the head takes 1 <= K <= {MAX_JOINTS} joints, got {k}")
    if b < 1 or n < 1 or min(widths) < 1 or any(min(hw) < 1 for hw in shapes):
        raise ValueError(f"empty head input: B {b}, shapes {shapes}, widths {widths}, N {n}")
    if any(min(hw) < 2 for hw in shapes[1:]):
        raise ValueError("the upsample needs h, w >= 2 on branches 1-3")
    cp = tuple(-(-c // 16) * 16 for c in widths)
    np_ = -(-n // 16) * 16
    smem = 2 * (64 * (cp[0] + 16) + 64 * (np_ + 16) + np_ * 32) + 8 * 256 * 4
    conv_smem = 2 * 64 * (max(cp[1:]) + 16) + 8 * 256 * 4
    if max(smem, conv_smem) > _build.SMEM_LIMIT:
        raise ValueError(f"the head kernel's tiles do not fit a head {n} wide on branches "
                         f"{widths} in shared memory")
    rows = sum(-(-(b * h * w) // 64) for h, w in shapes[1:])
    h0, w0 = shapes[0]
    return HeadPlan(cp, np_, rows, conv_smem, (-(-(h0 * w0) // 64), b), smem)


def _pad2(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """w zero-padded to (rows, cols), contiguous and 32-byte aligned (WMMA
    reads it in tiles from global memory)."""
    w = torch.nn.functional.pad(w, (0, cols - w.shape[1], 0, rows - w.shape[0])).contiguous()
    return w.clone() if w.data_ptr() % 32 else w


@lru_cache(maxsize=16)
def _taps(shapes: Tuple[Tuple[int, int], ...], h0: int, w0: int, device: str) -> torch.Tensor:
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
    return torch.from_numpy(taps).to(device)


def fused_head_decode_v2(xs: Sequence[torch.Tensor], params: HeadParams,
                         input_scales: Optional[Sequence] = None) -> torch.Tensor:
    """xs: 4 NHWC bf16 branch tensors (B, h0/2^i, w0/2^i, C_i) -> (B, K, 2) f32;
    with ``input_scales`` (4 scales, float or 0-dim float32 tensors) the
    branches are int8 and ``x_i ~= sa_i * xs[i]``.

    CUDA tensors run the kernel (three launches, plan ``head_plan``: any
    widths, any B*h*w, K <= 128) and CPU tensors the plain twin; any other
    device raises.  ``launches`` counts the kernel's launches (3 per call).
    """
    _validate(xs, params, input_scales)
    dev = xs[0].device
    if dev.type == "cpu":
        return head_decode_reference(xs, params, input_scales)
    if dev.type != "cuda":
        raise ValueError(f"fused_head_decode_v2 runs on cuda or cpu, not {dev}")
    b, h0, w0, c0 = xs[0].shape
    n, k = params.w_final.shape
    plan = head_plan(b, tuple((x.shape[1], x.shape[2]) for x in xs),
                     tuple(x.shape[3] for x in xs), n, k)
    for i, x in enumerate(xs):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"branch {i} must be contiguous NHWC and 16-byte aligned")

    # the weights at the kernels' pitches: rows C_i and columns N rounded up to 16
    np_ = plan.np
    w_slices = [_pad2(w, cp, np_) for w, cp in
                zip(branch_weights(xs, params, input_scales), plan.cp)]
    in_int8 = int(input_scales is not None)
    w_final = _pad2(params.w_final.to(torch.bfloat16), np_, k)
    b_head = torch.nn.functional.pad(params.b_head, (0, np_ - n)).contiguous()
    b_final = params.b_final.contiguous()
    temp = params.temp.contiguous()
    shapes = tuple((x.shape[1], x.shape[2]) for x in xs[1:])
    taps = _taps(shapes, h0, w0, str(dev))
    ys = [torch.empty((b * h * w, np_), dtype=torch.bfloat16, device=dev) for h, w in shapes]
    logits = torch.empty((b, k, h0 * w0), dtype=torch.float32, device=dev)
    out = torch.empty((b, k, 2), dtype=torch.float32, device=dev)

    lib = _build.lib()
    stream = _build.stream_ptr(dev)
    err = lib.hrnet_head_branch_conv(
        *(x.data_ptr() for x in xs[1:]), *(w.data_ptr() for w in w_slices[1:]),
        *(y.data_ptr() for y in ys), *(b * h * w for h, w in shapes),
        *(x.shape[3] for x in xs[1:]), np_, in_int8, stream)
    _build.check(err, "hrnet_head_branch_conv")
    fused_head_decode_v2.launches += 1
    err = lib.hrnet_head_logits(
        xs[0].data_ptr(), w_slices[0].data_ptr(), *(y.data_ptr() for y in ys),
        taps.data_ptr(), b_head.data_ptr(), w_final.data_ptr(), b_final.data_ptr(),
        temp.data_ptr(), logits.data_ptr(), b, h0, w0, c0,
        *(d for hw in shapes for d in hw), np_, k, taps.shape[-1], in_int8, stream)
    _build.check(err, "hrnet_head_logits")
    fused_head_decode_v2.launches += 1
    err = lib.hrnet_softmax_decode(logits.data_ptr(), out.data_ptr(), b, k, h0, w0, stream)
    _build.check(err, "hrnet_softmax_decode")
    fused_head_decode_v2.launches += 1
    return out


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


def fused_head_decode(xs: Sequence[torch.Tensor], params: HeadParams) -> torch.Tensor:
    """v1 of the fused head: xs 4 square NHWC branch tensors (B, s_i, s_i,
    C_i) of any float dtype (cast to bf16) -> (B, K, 2) f32.

    CUDA tensors run the kernel (two launches: the head with its gathered
    upsample to logits, then the softmax decode) and CPU tensors the plain
    twin; any other device raises.  ``launches`` counts the kernel's
    launches (2 per call).
    """
    _validate_v1(xs, params)
    dev = xs[0].device
    if dev.type == "cpu":
        return head_decode_v1_reference(xs, params)
    if dev.type != "cuda":
        raise ValueError(f"fused_head_decode runs on cuda or cpu, not {dev}")
    b, h0, w0, _ = xs[0].shape
    c = _offsets(xs)[-1]
    n, k = params.w_final.shape
    if any(x.shape[3] % 8 for x in xs) or c % 16 or n % 16:
        raise ValueError(f"the kernel needs every C_i % 8 == 0, their sum % 16 == 0 and head "
                         f"width % 16 == 0, got {[x.shape[3] for x in xs]}, {n}")
    xs = [x.to(torch.bfloat16).contiguous() for x in xs]
    kp = (k + 15) // 16 * 16
    w_head = params.w_head.to(torch.bfloat16).contiguous()
    w_final = torch.zeros((n, kp), dtype=torch.bfloat16, device=dev)
    w_final[:, :k] = params.w_final
    b_head, b_final = params.b_head.contiguous(), params.b_final.contiguous()
    temp = params.temp.contiguous()
    # 16-byte vector loads of the branches, 32-byte WMMA tiles of w_head
    if any(x.data_ptr() % 16 for x in xs) or w_head.data_ptr() % 32:
        raise ValueError("the kernel needs 16-byte aligned branches and a 32-byte aligned w_head")
    taps = _taps_v1(tuple(x.shape[1] for x in xs[1:]), h0, str(dev))
    logits = torch.empty((b, k, h0 * w0), dtype=torch.float32, device=dev)
    out = torch.empty((b, k, 2), dtype=torch.float32, device=dev)

    lib = _build.lib()
    stream = _build.stream_ptr(dev)
    err = lib.hrnet_head_v1_logits(
        *(x.data_ptr() for x in xs), taps.data_ptr(), w_head.data_ptr(), b_head.data_ptr(),
        w_final.data_ptr(), b_final.data_ptr(), temp.data_ptr(), logits.data_ptr(),
        b, h0, *(x.shape[1] for x in xs[1:]), *(x.shape[3] for x in xs), n, k, kp, stream)
    _build.check(err, "hrnet_head_v1_logits")
    fused_head_decode.launches += 1
    err = lib.hrnet_softmax_decode(logits.data_ptr(), out.data_ptr(), b, k, h0, w0, stream)
    _build.check(err, "hrnet_softmax_decode")
    fused_head_decode.launches += 1
    return out


fused_head_decode.launches = 0
