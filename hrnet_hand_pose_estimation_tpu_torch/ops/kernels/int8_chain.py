"""HRNet's W8A8 block chains: layer1's bottleneck chain and a stage branch's
BasicBlock chain.

Ports of the TPU kernels ``ops/pallas/int8_chain.py::fused_bottleneck_chain_int8``
and ``::fused_basic_chain_int8`` of the JAX package.  Each wrapper launches its
CUDA kernel once per block for a tensor on the card (``csrc/int8_chain.cu``,
``csrc/basic_int8.cu``) and runs its plain PyTorch twin for a tensor on the
CPU.  A bottleneck computes, per block (the JAX package's
``_bottleneck_int8_body``),

    xq  = clip(round(x * inv1))
    t1  = clip(round(relu(float(xq @ kq1) * a1 + c1)))
    t2  = clip(round(relu(float(conv3x3(t1) @ kq2) * a2 + c2)))
    y   = bf16(relu(float(t2 @ kq3) * a3 + c3 + shortcut))

with the shortcut ``float(xq @ kqs) * as_ + cs`` on block 0 and the block's
bf16 input in f32 on the others.  A BasicBlock (``_basic_int8_body``) computes

    xq  = clip(round(x * inv1))
    t   = clip(round(relu(float(conv3x3(xq) @ kq1) * a1 + c1)))
    y   = bf16(relu(float(conv3x3(t) @ kq2) * a2 + c2 + float(x)))

with zero padding on xq and on t.  Rounding is half to even, the clip
+-127, every ``acc * a + c`` rounds the product and then the sum, and the
integer sums are exact (the twins sum in float64).

``prepare_layer1_int8`` and ``prepare_branch_int8`` fold and quantize a
PoseHRNet state_dict with a calibration record into the JAX package's flat
layouts.  layer1, per block: inv1 (1, 1) f32, kq1 (Cin, Cm) int8, a1, c1
(Cm,) f32, kq2 (9 Cm, Cm) int8 (rows ky, kx, ci), a2, c2, kq3 (Cm, Cout)
int8, a3, c3 (Cout,) f32, and for a projection shortcut kqs (Cin, Cout)
int8, as_, cs.  A branch, per block: inv1 (1, 1), kq1 (9C, C) int8, a1, c1
(C,), kq2 (9C, C) int8, a2, c2 (C,).  Each kq is stored N-major: a (K, N)
view ``.t()`` of contiguous (N, K) storage, which is how the kernels read
it (``ldmatrix`` cannot transpose int8); its shape and values are the JAX
package's.  The wrappers also take a plain contiguous (K, N) kq and copy it
to N-major per call.

``int8_bottleneck_plan`` and ``basic_int8_plan`` make the kernels' launch
plans (tile, warp grid, slab width, weight ring depth, shared memory,
grid); the C entries check them.  A shape a plan does not take raises
ValueError before any launch.
"""

from __future__ import annotations

import functools
from typing import Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

_BOT_NAMES = ("inv1", "kq1", "a1", "c1", "kq2", "a2", "c2", "kq3", "a3", "c3")
_SC_NAMES = ("kqs", "as_", "cs")


def _n_major(kq: np.ndarray, device) -> torch.Tensor:
    """kq (K, N) int8 as the kernels read it: the (K, N) view ``.t()`` of
    N-major (N, K) contiguous storage, with kq's shape and values."""
    return torch.from_numpy(np.ascontiguousarray(kq.T)).to(device).t()


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == np.int8 and a.ndim == 2:
        return _n_major(a, device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _quantized(state: Mapping[str, torch.Tensor], conv: str, bn: str):
    """(kq, wscale, bias) of a BN-folded conv of a state_dict, kq int8 in the
    JAX package's (Cin, Cout) or (3*3*Cin, Cout) layout (rows ky, kx, ci)."""
    from ...core.quant_infer import fold_site, quantize_weight

    kernel, bias = fold_site(state, conv, bn)
    kq, wscale = quantize_weight(kernel)                   # OIHW, scales per O
    kq = kq.transpose(2, 3, 1, 0)                          # -> HWIO
    return kq.reshape(-1, kq.shape[-1]), wscale, bias


def prepare_layer1_int8(state: Mapping[str, torch.Tensor], amax: Mapping[str, float],
                        prefix: str = "layer1"
                        ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[bool, ...]]:
    """Fold + quantize the bottleneck chain at ``prefix`` of a PoseHRNet
    state_dict into the kernel's flat layout: (params_flat, shortcut_flags).

    ``amax`` holds the calibration records of the ``layer1/block{b}/cb*``
    sites.  The scales are folded in the JAX package's order and types
    (float32 numpy arithmetic on the float64 site scales), so the flat
    params equal ``prepare_layer1_int8`` of the JAX package.  Each kq is an
    N-major view (``_n_major``).
    """
    from ...core.quant_infer import site_scale

    flat, flags = [], []
    b = 0
    dev = state[f"{prefix}.0.conv1.weight"].device
    while f"{prefix}.{b}.conv1.weight" in state:
        blk = f"{prefix}.{b}"
        sa1, sa2, sa3 = (site_scale(amax, f"layer1/block{b}/cb{n}") for n in (1, 2, 3))
        kq1, ws1, b1 = _quantized(state, f"{blk}.conv1", f"{blk}.bn1")
        kq2, ws2, b2 = _quantized(state, f"{blk}.conv2", f"{blk}.bn2")
        kq3, ws3, b3 = _quantized(state, f"{blk}.conv3", f"{blk}.bn3")
        arrays = [
            np.full((1, 1), 1.0 / sa1, np.float32),       # inv1
            kq1, sa1 * ws1 / sa2, b1 / sa2,               # a1, c1
            kq2, sa2 * ws2 / sa3, b2 / sa3,               # a2, c2
            kq3, sa3 * ws3, b3,                           # a3, c3
        ]
        has_sc = f"{blk}.downsample.0.weight" in state
        if has_sc:
            kqs, wss, bs = _quantized(state, f"{blk}.downsample.0", f"{blk}.downsample.1")
            # the projection shares the block input, so cb1's scale sa1
            arrays += [kqs, sa1 * wss, bs]
        flat += [_to_device(a, dev) for a in arrays]
        flags.append(has_sc)
        b += 1
    if not flags:
        raise KeyError(f"no bottleneck blocks under {prefix!r}")
    return tuple(flat), tuple(flags)


def prepare_branch_int8(state: Mapping[str, torch.Tensor], amax: Mapping[str, float],
                        mod: str, branch: int, n_blocks: int) -> Tuple[torch.Tensor, ...]:
    """Fold + quantize one stage branch chain of a PoseHRNet state_dict into
    ``fused_basic_chain_int8``'s flat layout, 7 tensors per block.

    ``mod`` and the calibration sites are the JAX package's names
    (``stage3_m1``; ``{mod}/branch{branch}/block{b}/cb{1,2}``), mapped to the
    port's modules by ``core/quant_infer.site_modules``.  The scales fold in
    the JAX package's order and types, as in ``prepare_layer1_int8``, and
    each kq is an N-major view.
    """
    from ...core.quant_infer import site_modules, site_scale

    dev = state[site_modules(f"{mod}/branch{branch}/block0/cb1")[0] + ".weight"].device
    flat = []
    for b in range(n_blocks):
        base = f"{mod}/branch{branch}/block{b}"
        sa1, sa2 = (site_scale(amax, f"{base}/cb{n}") for n in (1, 2))
        kq1, ws1, b1 = _quantized(state, *site_modules(f"{base}/cb1"))
        kq2, ws2, b2 = _quantized(state, *site_modules(f"{base}/cb2"))
        arrays = [
            np.full((1, 1), 1.0 / sa1, np.float32),       # inv1
            kq1, sa1 * ws1 / sa2, b1 / sa2,               # a1, c1 (folded with cb2's 1/sa2)
            kq2, sa2 * ws2, b2,                           # a2, c2 (plain dequant)
        ]
        flat += [_to_device(a, dev) for a in arrays]
    return tuple(flat)


def _split(params_flat: Sequence[torch.Tensor], flags: Sequence[bool]):
    out, idx = [], 0
    for has_sc in flags:
        names = _BOT_NAMES + (_SC_NAMES if has_sc else ())
        out.append(dict(zip(names, params_flat[idx:idx + len(names)])))
        idx += len(names)
    if idx != len(params_flat):
        raise ValueError(f"params_flat has {len(params_flat)} tensors, the flags "
                         f"{tuple(flags)} take {idx}")
    return out


def _validate(x: torch.Tensor, blocks) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    cin = x.shape[3]
    for i, p in enumerate(blocks):
        cm, cout = p["kq1"].shape[-1], p["kq3"].shape[-1]
        want = {"inv1": (1, 1), "kq1": (cin, cm), "a1": (cm,), "c1": (cm,),
                "kq2": (9 * cm, cm), "a2": (cm,), "c2": (cm,),
                "kq3": (cm, cout), "a3": (cout,), "c3": (cout,)}
        if "kqs" in p:
            want.update(kqs=(cin, cout), as_=(cout,), cs=(cout,))
        elif cin != cout:
            raise ValueError(f"block {i}: identity shortcut needs Cin == Cout, "
                             f"got {cin} -> {cout}")
        for name, shape in want.items():
            t = p[name]
            dtype = torch.int8 if name.startswith("kq") else torch.float32
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"block {i} {name}: want {shape} {dtype}, got "
                                 f"{tuple(t.shape)} {t.dtype}")
            if t.device != x.device:
                raise ValueError(f"block {i} {name} on {t.device}, x on {x.device}")
        cin = cout


def _quant(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """clip(round(x * inv)) in f32 (values of int8); round half to even."""
    return torch.clamp(torch.round(x * inv), -127, 127)


def _requant(acc: torch.Tensor, a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """clip(round(relu(float(acc) * a + c))): product and sum rounded apart."""
    return torch.clamp(torch.round(torch.relu(acc.float() * a + c)), -127, 127)



def _conv3x3(q: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """Exact int8 3x3 conv, zero padding: q (B, H, W, C) holding int8 values,
    kq (9C, Cout) int8 with rows (ky, kx, ci) -> (B*H*W, Cout) float64 sums."""
    b, h, w, c = q.shape
    cols = F.unfold(q.double().permute(0, 3, 1, 2), 3, padding=1)
    # unfold's rows are (ci, ky, kx); kq's are (ky, kx, ci)
    k = kq.double().reshape(3, 3, c, -1).permute(2, 0, 1, 3).reshape(9 * c, -1)
    return (cols.transpose(1, 2) @ k).reshape(b * h * w, -1)


def bottleneck_chain_int8_reference(x: torch.Tensor, params_flat: Sequence[torch.Tensor],
                                    shortcut_flags: Sequence[bool]) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (B, H, W, Cin) bf16 -> (B, H, W, Cout) bf16.

    The int8 products are summed in float64, exact for these sizes (f32 is
    not past 2^24), then rounded to f32 as JAX converts its int32 sums.
    """
    y = x
    for p in _split(params_flat, shortcut_flags):
        b, h, w, cin = y.shape
        flat = y.reshape(-1, cin).float()
        xq = _quant(flat, p["inv1"][0, 0]).double()
        t1 = _requant(xq @ p["kq1"].double(), p["a1"], p["c1"])
        t2 = _requant(_conv3x3(t1.reshape(b, h, w, -1), p["kq2"]), p["a2"], p["c2"])
        out = (t2.double() @ p["kq3"].double()).float() * p["a3"] + p["c3"]
        if "kqs" in p:
            sc = (xq @ p["kqs"].double()).float() * p["as_"] + p["cs"]
        else:
            sc = flat
        y = torch.relu(out + sc).to(torch.bfloat16).reshape(b, h, w, -1)
    return y


def pitch_s8(n: int) -> int:
    """Bytes per shared-memory row of n int8 values (n % 16 == 0): an odd
    multiple of 16 with at least 16 bytes past n (``csrc/conv_mainloop.cuh``)."""
    return n + (16 if n % 32 == 0 else 32)


def _kernel_kq(kq: torch.Tensor) -> torch.Tensor:
    """The N-major (N, K) contiguous storage of kq (K, N), as the kernels
    read it: kq's own storage where kq is such a view (``_n_major``), else
    a copy made here."""
    kt = kq.t()
    return kt if kt.is_contiguous() else kt.contiguous()


def _kernel_params(p: Mapping[str, torch.Tensor]) -> dict:
    """A block's params as its kernel takes them: every kq N-major."""
    return {n: _kernel_kq(t) if n.startswith("kq") else t for n, t in p.items()}


def _check_cuda(name: str, x: torch.Tensor, blocks) -> None:
    """What the kernels need of a CUDA input: contiguous tensors (the kq's
    as ``_kernel_params`` gives them), 16-byte aligned (16-byte vectors of
    x and the weights, pairs of the scales)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    tensors = [x] + [t for p in blocks for t in p.values()]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: x and every scale must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} reads x and the weights in 16-byte vectors and the scales "
                         f"in pairs: every tensor must be 16-byte aligned")


class Int8BottleneckPlan(NamedTuple):
    """One launch of ``csrc/int8_chain.cu``: block (tile, sample)."""

    th: int                 # output rows of a tile
    tw: int                 # output columns of a tile
    stages: int             # weight slabs in the shared-memory ring
    smem: int               # dynamic shared memory bytes
    grid: Tuple[int, int]   # (tiles, B)


# what the kernel is built for: layer1's block widths, conv1's pixels (4
# warps x 3 m16 tiles) and conv2/conv3's (4 warps x 2 m16 tiles); bytes per
# t1 / t2 row and per weight slab row (64 bytes of K + 16)
INT8_CIN, INT8_CM, INT8_COUT = (64, 256), 64, 256
INT8_HALO, INT8_TILE, INT8_LDT, INT8_SLAB_ROW = 192, 128, 80, 80
# the most dynamic shared memory a block may take for two to share an SM:
# 2 * (smem + 1 KB reserved per block) <= 228 KB
TWO_BLOCKS_SMEM = 115712


@functools.lru_cache(maxsize=1024)
def int8_bottleneck_plan(b: int, h: int, w: int, cin: int, cm: int, cout: int,
                         proj: bool) -> Int8BottleneckPlan:
    """The kernel's plan for one W8A8 bottleneck block on x (b, h, w, cin).

    A tile is up to 16 columns and as many rows as conv2's 128 pixels and
    conv1's 192-pixel halo allow (8 x 16 on a 10 x 18 halo at 64 x 64), all
    channels.  Shared memory holds the quantized x halo (rows of
    ``pitch_s8(Cin)`` bytes; with the identity, y's staging rows lie over
    it), t1 on the halo and t2 on the tile (rows of 80 bytes), with the
    projection y's staging rows (tile pixels x 72 bf16), and the deepest
    ring of 4, 3 or 2 weight slabs (64 rows with a projection, 128 without,
    of 80 bytes) within TWO_BLOCKS_SMEM, so that two blocks share an SM.
    Takes layer1's blocks only (Cin 64 or 256, Cm 64, Cout 256); raises
    ValueError on any other shape."""
    if cin not in INT8_CIN or cm != INT8_CM or cout != INT8_COUT:
        raise ValueError(f"the kernel takes layer1's blocks: Cin in {INT8_CIN}, Cm {INT8_CM}, "
                         f"Cout {INT8_COUT}; got Cin {cin}, Cm {cm}, Cout {cout}")
    if not proj and cin != cout:
        raise ValueError(f"an identity shortcut needs Cin == Cout, got {cin} -> {cout}")
    if b < 1 or h < 1 or w < 1:
        raise ValueError(f"empty input {(b, h, w, cin)}")
    tw = min(w, 16)
    th = min(h, INT8_TILE // tw)
    while (th + 2) * (tw + 2) > INT8_HALO:
        th -= 1
    halo, tile = (th + 2) * (tw + 2), th * tw
    fixed = halo * pitch_s8(cin) + (halo + tile) * INT8_LDT + (tile * 72 * 2 if proj else 0)
    stage = (64 if proj else 128) * INT8_SLAB_ROW
    grid = (-(-h // th) * -(-w // tw), b)
    for stages in (4, 3, 2):
        if fixed + stages * stage <= TWO_BLOCKS_SMEM:
            return Int8BottleneckPlan(th, tw, stages, fixed + stages * stage, grid)
    raise ValueError(f"no tile of the kernel fits two blocks per SM at {h}x{w}")


def _int8_bottleneck_plans(shape, blocks) -> list:
    """Every block's plan, made before the first launch (a shape the kernel
    does not take raises ValueError with nothing launched)."""
    b, h, w, cin = shape
    plans = []
    for p in blocks:
        cm, cout = p["kq3"].shape
        plans.append(int8_bottleneck_plan(b, h, w, cin, cm, cout, "kqs" in p))
        cin = cout
    return plans


def _launch_bottleneck_int8(y: torch.Tensor, kp, plan: Int8BottleneckPlan) -> torch.Tensor:
    """One launch of the W8A8 block kernel on PyTorch's stream; ``kp`` the
    block's params as ``_kernel_params`` gives them (kq's N-major)."""
    b, h, w, cin = y.shape
    cm, cout = kp["kq1"].shape[0], kp["kq3"].shape[0]
    out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device=y.device)
    sc = [kp[n].data_ptr() for n in _SC_NAMES] if "kqs" in kp else [None] * 3
    err = _build.lib().hrnet_bottleneck_int8_block(
        y.data_ptr(), out.data_ptr(), *(kp[n].data_ptr() for n in _BOT_NAMES), *sc,
        b, h, w, cin, cm, cout, plan.th, plan.tw, plan.stages, plan.smem,
        _build.stream_ptr(y.device))
    _build.check(err, "hrnet_bottleneck_int8_block")
    return out


def fused_bottleneck_chain_int8(x: torch.Tensor, params_flat: Sequence[torch.Tensor],
                                shortcut_flags: Sequence[bool] = (True, False, False, False)
                                ) -> torch.Tensor:
    """x: (B, H, W, Cin) bf16 -> (B, H, W, Cout) bf16 through the W8A8 chain.

    A CUDA tensor runs the kernel (one launch per block, with the plan of
    ``int8_bottleneck_plan``) and a CPU tensor the plain twin; any other
    device raises.  The kq's may be N-major views (``prepare_layer1_int8``)
    or plain (K, N) tensors, copied to N-major per call.  ``launches``
    counts the kernel's launches (4 for layer1's chain of 4 blocks).
    """
    blocks = _split(params_flat, shortcut_flags)
    _validate(x, blocks)
    if x.device.type == "cpu":
        return bottleneck_chain_int8_reference(x, params_flat, shortcut_flags)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck_chain_int8 runs on cuda or cpu, not {x.device}")
    plans = _int8_bottleneck_plans(tuple(x.shape), blocks)
    kblocks = [_kernel_params(p) for p in blocks]
    _check_cuda("fused_bottleneck_chain_int8", x, kblocks)
    y = x
    for kp, plan in zip(kblocks, plans):
        y = _launch_bottleneck_int8(y, kp, plan)
        fused_bottleneck_chain_int8.launches += 1
    return y


fused_bottleneck_chain_int8.launches = 0


# --------------------------------------------------------------------------
# the BasicBlock chain of a stage branch (TPU kernel fused_basic_chain_int8)
# --------------------------------------------------------------------------

_BASIC_NAMES = ("inv1", "kq1", "a1", "c1", "kq2", "a2", "c2")


def _split_basic(params_flat: Sequence[torch.Tensor], n_blocks: int):
    if len(params_flat) != 7 * n_blocks:
        raise ValueError(f"params_flat has {len(params_flat)} tensors, {n_blocks} blocks "
                         f"take {7 * n_blocks}")
    return [dict(zip(_BASIC_NAMES, params_flat[7 * i:7 * i + 7])) for i in range(n_blocks)]


def _validate_basic(x: torch.Tensor, blocks) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    c = x.shape[3]
    want = {"inv1": (1, 1), "kq1": (9 * c, c), "a1": (c,), "c1": (c,), "kq2": (9 * c, c),
            "a2": (c,), "c2": (c,)}
    for i, p in enumerate(blocks):
        for name, shape in want.items():
            t = p[name]
            dtype = torch.int8 if name.startswith("kq") else torch.float32
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"block {i} {name}: want {shape} {dtype}, got "
                                 f"{tuple(t.shape)} {t.dtype}")
            if t.device != x.device:
                raise ValueError(f"block {i} {name} on {t.device}, x on {x.device}")


def basic_chain_int8_reference(x: torch.Tensor, params_flat: Sequence[torch.Tensor],
                               n_blocks: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (B, H, W, C) bf16 -> (B, H, W, C) bf16."""
    y = x
    for p in _split_basic(params_flat, n_blocks):
        b, h, w, c = y.shape
        flat = y.reshape(-1, c).float()
        xq = _quant(flat, p["inv1"][0, 0]).reshape(b, h, w, c)
        t = _requant(_conv3x3(xq, p["kq1"]), p["a1"], p["c1"])
        out = _conv3x3(t.reshape(b, h, w, c), p["kq2"]).float() * p["a2"] + p["c2"]
        y = torch.relu(out + flat).to(torch.bfloat16).reshape(b, h, w, c)
    return y


class BasicInt8Plan(NamedTuple):
    """One launch of ``csrc/basic_int8.cu``: block (tile, sample)."""

    th: int                 # output rows of a tile
    tw: int                 # output columns of a tile
    wm: int                 # warps along the pixels (8 / wm along the channels)
    mt: int                 # m16 tiles per warp: wm * mt * 16 >= (th + 2) * (tw + 2)
    nt: int                 # n8 tiles per warp: (8 / wm) * nt * 8 == cp
    kb: int                 # bytes (input channels of one tap) per weight slab: 32 or 64
    stages: int             # weight slabs in the shared-memory ring
    smem: int               # dynamic shared memory bytes
    grid: Tuple[int, int]   # (tiles, B)
    cp: int                 # the width the kernel runs at (basic_int8_width(C))


# the kernel's instances: NT (n8 tiles per warp) -> the MT (m16 tiles per
# warp) it is built for; NT in order of preference
BASIC_INT8_TILES = {4: (2, 4, 6, 8), 6: (2, 4), 8: (4,), 2: (8,)}
# the channel widths those instances take: C = 8 * NT * (1, 2, 4 or 8 warps)
BASIC_INT8_WIDTHS = tuple(sorted({8 * nt * wn for nt in BASIC_INT8_TILES for wn in (1, 2, 4, 8)}))


def basic_int8_width(c: int) -> int:
    """The least width >= c the kernel takes (16, 32, 48, 64, 96, 128, 192,
    256, 384 or 512) for a chain of C % 16 == 0 channels: every w32 and w48
    width is its own; any other runs zero-padded to it.  Raises ValueError
    for C % 16 != 0 or C > 512."""
    if c <= 0 or c % 16:
        raise ValueError(f"the kernel needs C % 16 == 0, got {c}")
    for cp in BASIC_INT8_WIDTHS:
        if cp >= c:
            return cp
    raise ValueError(f"the kernel takes C % 16 == 0 up to {BASIC_INT8_WIDTHS[-1]}, got {c}")


@functools.lru_cache(maxsize=1024)
def basic_int8_plan(b: int, h: int, w: int, c: int) -> BasicInt8Plan:
    """The kernel's plan for one W8A8 BasicBlock on x (b, h, w, c), run at
    width ``cp = basic_int8_width(c)``.

    A tile is up to 16 rows x 32 columns, all cp channels: the most pixels
    (so the fewest passes over the weights) whose conv1 ring fits the
    kernel's warp tiles, i.e. 16 rows at 32 channels, 8 at 64 and 128, the
    whole image at 8 x 8.  Shared memory holds the (th+4) x (tw+4) quantized
    halo and conv1's (th+2) x (tw+2) ring t, each pixel ``pitch_s8(cp)``
    bytes, and a ring of 4 (else 3, 2) weight slabs of cp rows x KB + 16
    bytes, KB = 64 where cp % 64 == 0, else 32 (the last slab of each tap
    then holds 16 channels where cp % 32 == 16).  Raises ValueError on a
    shape the kernel does not take."""
    if b < 1 or h < 1 or w < 1:
        raise ValueError(f"empty input {(b, h, w, c)}")
    cp = basic_int8_width(c)
    nt = next(nt for nt in BASIC_INT8_TILES
              if cp % (nt * 8) == 0 and cp // (nt * 8) in (1, 2, 4, 8))
    wm, kb = _build.WARPS // (cp // (nt * 8)), 64 if cp % 64 == 0 else 32
    for tw in sorted({min(w, 32), min(w, 16), min(w, 8)}, reverse=True):
        for th in sorted({min(h, 16), min(h, 8), min(h, 4), min(h, 2), 1}, reverse=True):
            ring_tiles = -(-(th + 2) * (tw + 2) // 16)      # conv1's m16 tiles
            mts = [m for m in BASIC_INT8_TILES[nt] if m * wm >= ring_tiles]
            if not mts:
                continue
            for stages in (4, 3, 2):
                smem = (pitch_s8(cp) * ((th + 4) * (tw + 4) + (th + 2) * (tw + 2))
                        + stages * cp * (kb + 16))
                if smem <= _build.SMEM_LIMIT:
                    return BasicInt8Plan(th, tw, wm, mts[0], nt, kb, stages, smem,
                                         (-(-h // th) * -(-w // tw), b), cp)
    raise ValueError(f"no tile of the kernel fits C = {cp} at {h}x{w}")


def _pad_basic_int8(p: Mapping[str, torch.Tensor], cp: int) -> dict:
    """A block's params zero-padded from C to cp channels: zero input
    channels add exact zeros, and a padded output channel has zero weights,
    scale and offset, so its t and y stay relu(0) = 0."""
    c = p["a1"].shape[0]
    if c == cp:
        return dict(p)
    d = cp - c
    out = {n: F.pad(p[n], (0, d)) for n in ("a1", "c1", "a2", "c2")}
    for n in ("kq1", "kq2"):      # rows (tap, input channel) x output channels
        out[n] = F.pad(p[n].reshape(9, c, c), (0, d, 0, d)).reshape(9 * cp, cp)
    return dict(out, inv1=p["inv1"])


def _launch_basic_int8(y: torch.Tensor, kp, plan: BasicInt8Plan) -> torch.Tensor:
    """One launch of the W8A8 BasicBlock kernel on PyTorch's stream; ``kp``
    the block's params at width plan.cp as ``_kernel_params`` gives them."""
    b, h, w, _ = y.shape
    out = torch.empty_like(y)
    err = _build.lib().hrnet_basic_int8_block(
        y.data_ptr(), out.data_ptr(), *(kp[n].data_ptr() for n in _BASIC_NAMES),
        b, h, w, plan.cp, plan.th, plan.tw, plan.wm, plan.mt, plan.nt, plan.kb, plan.stages,
        plan.smem, _build.stream_ptr(y.device))
    _build.check(err, "hrnet_basic_int8_block")
    return out


def fused_basic_chain_int8(x: torch.Tensor, params_flat: Sequence[torch.Tensor],
                           n_blocks: int, samples_per_block: int = 1) -> torch.Tensor:
    """x: (B, H, W, C) bf16 -> (B, H, W, C) bf16 through a chain of
    ``n_blocks`` W8A8 BasicBlocks (params from ``prepare_branch_int8``).

    A CUDA tensor runs the kernel (one launch per block, with the plan of
    ``basic_int8_plan``; C % 16 == 0, at a width the kernel does not take
    x and the params zero-padded to ``basic_int8_width(C)`` per call) and a
    CPU tensor the plain twin; any other device raises.  The kq's may be
    N-major views (``prepare_branch_int8``) or plain (9C, C) tensors,
    copied to N-major per call.  ``samples_per_block`` is the JAX
    signature's TPU grid option and changes nothing here.  ``launches``
    counts the kernel's launches.
    """
    blocks = _split_basic(params_flat, n_blocks)
    _validate_basic(x, blocks)
    if x.device.type == "cpu":
        return basic_chain_int8_reference(x, params_flat, n_blocks)
    if x.device.type != "cuda":
        raise ValueError(f"fused_basic_chain_int8 runs on cuda or cpu, not {x.device}")
    b, h, w, c = x.shape
    plan = basic_int8_plan(b, h, w, c)
    kblocks = [_kernel_params(_pad_basic_int8(p, plan.cp)) for p in blocks]
    xp = x if plan.cp == c else F.pad(x, (0, plan.cp - c)).contiguous()
    _check_cuda("fused_basic_chain_int8", xp, kblocks)
    y = xp
    for kp in kblocks:
        y = _launch_basic_int8(y, kp, plan)
        fused_basic_chain_int8.launches += 1
    return y if plan.cp == c else y[..., :c].contiguous()


fused_basic_chain_int8.launches = 0
