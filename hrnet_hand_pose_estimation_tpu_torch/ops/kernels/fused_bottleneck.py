"""HRNet's fused residual chains: layer1, the stem + layer1, and the
BasicBlock branch chains of stages 2-4, all BN-folded.

Ports of the TPU kernels of the JAX package's ``ops/pallas/fused_bottleneck.py``.
Each wrapper launches its CUDA kernel for a tensor on the card and runs its
plain PyTorch twin for a tensor on the CPU.  Activations are bf16,
accumulation f32, and intermediates are rounded to bf16 where the TPU kernel
rounds them.

- ``fused_bottleneck_chain`` (``fused_bottleneck_chain``, ``csrc/fused_bottleneck.cu``,
  one launch per block; twin ``layer1_reference``), per block
  ``y = relu(conv1x1_3(relu(conv3x3_2(relu(conv1x1_1(x))))) + shortcut(x))``.
  ``fold_layer1_params`` folds eval-mode BN into the convs (the JAX
  package's ``models/hrnet.py::_pallas_layer1_apply``).  Weight layout per
  block, in ``params_flat`` order: w1 (Cin, Cm) bf16, b1 (Cm,) f32,
  w2 (3, 3, Cm, Cm) bf16, b2, w3 (Cm, Cout) bf16, b3, and for a projection
  shortcut ws (Cin, Cout) bf16, bs (Cout,) f32.
- ``fused_stem_layer1`` (``fused_stem_layer1``, ``csrc/stem_layer1.cu`` then
  the layer1 kernel; twin ``stem_layer1_reference``): the space-to-depth
  stem1, the 3x3/s2 stem2 and the layer1 chain.  ``prepare_stem_params``
  folds the stem.  ``bottleneck_plan`` and ``stem_plan`` make the two
  kernels' launch plans (tile, weight ring depth, shared memory, grid).
- ``fused_basic_chain`` (``fused_basic_chain``, ``csrc/basic_chain.cu``, one
  launch per block; twin ``basic_chain_reference``), per block
  ``y = relu((conv3x3_2(relu(conv3x3_1(x) + b1)) + b2) + x)``.
  ``fold_branch_params`` folds a branch (the JAX package's
  ``models/hrnet.py::_pallas_basic_branch_apply``): per block w1 (3, 3, C, C)
  bf16 HWIO, b1 (C,) f32, w2, b2.  ``basic_chain_plan`` makes the kernel's
  launch plan (tile, warp grid, weight ring depth, shared memory, grid) at
  ``basic_chain_width(C)``, the least width its instances take: a chain of
  any other C <= 512 runs zero-padded to it (``pad_basic_params``).
"""

from __future__ import annotations

import functools
from typing import Mapping, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...models.layers import fold_bn
from ..s2d import s2d_kernel
from . import _build

_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


def fold_conv_bn(state: Mapping[str, torch.Tensor], conv: str, bn: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BN into a conv of a state_dict: (HWIO kernel, bias),
    float32.  ``conv``/``bn`` are key prefixes (``layer1.0.conv1``, ``layer1.0.bn1``)."""
    kernel, bias = fold_bn(state[f"{conv}.weight"], state.get(f"{conv}.bias"),
                           *(state[f"{bn}.{f}"] for f in
                             ("weight", "bias", "running_mean", "running_var")))
    return kernel.permute(2, 3, 1, 0), bias


def fold_layer1_params(state: Mapping[str, torch.Tensor], prefix: str = "layer1"
                       ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[bool, ...]]:
    """BN-folded kernel params of the bottleneck chain at ``prefix`` in a
    PoseHRNet state_dict: (params_flat, shortcut_flags)."""
    flat, flags = [], []
    b = 0
    while f"{prefix}.{b}.conv1.weight" in state:
        blk = f"{prefix}.{b}"
        for n in (1, 2, 3):
            k, bias = fold_conv_bn(state, f"{blk}.conv{n}", f"{blk}.bn{n}")
            flat += [(k if n == 2 else k[0, 0]).to(torch.bfloat16).contiguous(),
                     bias.contiguous()]
        has_sc = f"{blk}.downsample.0.weight" in state
        if has_sc:
            k, bias = fold_conv_bn(state, f"{blk}.downsample.0", f"{blk}.downsample.1")
            flat += [k[0, 0].to(torch.bfloat16).contiguous(), bias.contiguous()]
        flags.append(has_sc)
        b += 1
    if not flags:
        raise KeyError(f"no bottleneck blocks under {prefix!r}")
    return tuple(flat), tuple(flags)


def _split(params_flat: Sequence[torch.Tensor], flags: Sequence[bool]):
    out, idx = [], 0
    for has_sc in flags:
        names = _NAMES + (("ws", "bs") if has_sc else ())
        out.append(dict(zip(names, params_flat[idx:idx + len(names)])))
        idx += len(names)
    if idx != len(params_flat):
        raise ValueError(f"params_flat has {len(params_flat)} tensors, the flags "
                         f"{tuple(flags)} take {idx}")
    return out


def _validate(x: torch.Tensor, blocks) -> None:
    """Check types, shapes and devices of the input and every block."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    cin = x.shape[3]
    for i, p in enumerate(blocks):
        cm = p["w1"].shape[-1]
        cout = p["w3"].shape[-1]
        want = {"w1": (cin, cm), "b1": (cm,), "w2": (3, 3, cm, cm), "b2": (cm,),
                "w3": (cm, cout), "b3": (cout,)}
        if "ws" in p:
            want.update(ws=(cin, cout), bs=(cout,))
        elif cin != cout:
            raise ValueError(f"block {i}: identity shortcut needs Cin == Cout, "
                             f"got {cin} -> {cout}")
        for name, shape in want.items():
            t = p[name]
            dtype = torch.bfloat16 if name.startswith("w") else torch.float32
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"block {i} {name}: want {shape} {dtype}, got "
                                 f"{tuple(t.shape)} {t.dtype}")
            if t.device != x.device:
                raise ValueError(f"block {i} {name} on {t.device}, x on {x.device}")
        cin = cout


def layer1_reference(x: torch.Tensor, params_flat: Sequence[torch.Tensor],
                     shortcut_flags: Sequence[bool]) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (B, H, W, Cin) bf16 -> (B, H, W, Cout) bf16.

    Float32 products of the bf16 operands, rounded to bf16 where the kernel
    rounds.  On a card, disable TF32 (``torch.backends.cudnn.allow_tf32``)
    for a float32 reference.
    """
    y = x
    for p in _split(params_flat, shortcut_flags):
        xf = y.float()
        h1 = torch.relu(xf @ p["w1"].float() + p["b1"]).to(torch.bfloat16)
        h2 = F.conv2d(h1.float().permute(0, 3, 1, 2), p["w2"].float().permute(3, 2, 0, 1),
                      padding=1).permute(0, 2, 3, 1)
        h2 = torch.relu(h2 + p["b2"]).to(torch.bfloat16)
        out = h2.float() @ p["w3"].float() + p["b3"]
        sc = xf @ p["ws"].float() + p["bs"] if "ws" in p else xf
        y = torch.relu(out + sc).to(torch.bfloat16)
    return y


class BottleneckPlan(NamedTuple):
    """One launch of ``csrc/fused_bottleneck.cu``: block (tile, sample)."""

    th: int                 # output rows of a tile
    tw: int                 # output columns of a tile
    ks: int                 # K rows per weight slab
    stages: int             # weight slabs in the shared-memory ring
    smem: int               # dynamic shared memory bytes
    grid: Tuple[int, int]   # (tiles, B)


# what the kernel is built for: the bottleneck width, output channels per
# conv3 pass, conv1's pixels (4 warps x 3 m16 tiles) and conv2/conv3's
# (4 warps x 2 m16 tiles)
BOTTLENECK_CM, BOTTLENECK_NCHUNK, BOTTLENECK_HALO, BOTTLENECK_TILE = 64, 128, 192, 128


@functools.lru_cache(maxsize=1024)
def bottleneck_plan(b: int, h: int, w: int, cin: int, cm: int, cout: int) -> BottleneckPlan:
    """The kernel's plan for one bottleneck block on x (b, h, w, cin).

    A tile is up to 16 columns and as many rows as conv2's 128 pixels and
    conv1's 192-pixel halo allow (8 x 16 on a 10 x 18 halo; 16 x 8 at
    8 columns), all channels.  Shared memory holds the x halo (rows of
    Cin + 8 bf16), t1 on the halo and t2 on the tile (rows of Cm + 8) and a
    ring of 4 (else 3, 2) weight slabs of KS rows x 136 bf16.  Raises
    ValueError on a shape the kernel does not take (layer1's 64 -> 256 and
    256 -> 256 blocks are taken)."""
    if cm != BOTTLENECK_CM or cout <= 0 or cout % BOTTLENECK_NCHUNK:
        raise ValueError(f"the kernel takes Cm = {BOTTLENECK_CM} and Cout % "
                         f"{BOTTLENECK_NCHUNK} == 0, got Cm {cm}, Cout {cout}")
    if cin <= 0 or cin % 32 or cin > 2048:
        raise ValueError(f"the kernel takes Cin % 32 == 0 up to 2048, got {cin}")
    if b < 1 or h < 1 or w < 1:
        raise ValueError(f"empty input {(b, h, w, cin)}")
    ks = 64 if cin % 64 == 0 else 32
    tw = min(w, 16)
    th = min(h, BOTTLENECK_TILE // tw)
    while (th + 2) * (tw + 2) > BOTTLENECK_HALO:
        th -= 1
    halo = (th + 2) * (tw + 2)
    for stages in (4, 3, 2):
        smem = 2 * (halo * (cin + 8) + halo * (cm + 8) + th * tw * (cm + 8)
                    + stages * ks * (BOTTLENECK_NCHUNK + 8))
        if smem <= _build.SMEM_LIMIT:
            return BottleneckPlan(th, tw, ks, stages, smem, (-(-h // th) * -(-w // tw), b))
    raise ValueError(f"no tile of the kernel fits Cin = {cin} in shared memory")


def fused_bottleneck_chain(x: torch.Tensor, params_flat: Sequence[torch.Tensor],
                           shortcut_flags: Sequence[bool] = (True, False, False, False)
                           ) -> torch.Tensor:
    """x: (B, H, W, Cin) bf16 -> (B, H, W, Cout) bf16 through the folded chain.

    A CUDA tensor runs the kernel (one launch per block, with the plan of
    ``bottleneck_plan``) and a CPU tensor the plain twin; any other device
    raises.  ``launches`` counts the kernel's launches (4 for layer1's
    chain of 4 blocks).
    """
    blocks = _split(params_flat, shortcut_flags)
    _validate(x, blocks)
    if x.device.type == "cpu":
        return layer1_reference(x, params_flat, shortcut_flags)
    _check_cuda("fused_bottleneck_chain", x, params_flat)
    plans = _bottleneck_plans(x.shape, blocks)
    y = x
    for p, plan in zip(blocks, plans):
        y = _launch_bottleneck(y, p, plan)
        fused_bottleneck_chain.launches += 1
    return y


fused_bottleneck_chain.launches = 0


def _check_cuda(name: str, x: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    """What every kernel of this module needs of a CUDA input: contiguous
    tensors, 16-byte aligned (the kernels read them in 16-byte vectors)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if not x.is_contiguous() or not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: x and every weight must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, *tensors)):
        raise ValueError(f"{name} reads x and the weights in 16-byte vectors and the biases "
                         f"in pairs: every tensor must be 16-byte aligned")


def _bottleneck_plans(shape, blocks) -> list:
    """Every block's plan, made before the first launch (a shape the kernel
    does not take raises ValueError with nothing launched)."""
    b, h, w, cin = shape
    plans = []
    for p in blocks:
        cm, cout = p["w3"].shape
        plans.append(bottleneck_plan(b, h, w, cin, cm, cout))
        cin = cout
    return plans


def _launch_bottleneck(y: torch.Tensor, p, plan: BottleneckPlan) -> torch.Tensor:
    """One launch of the layer1 block kernel on PyTorch's stream."""
    b, h, w, _ = y.shape
    cin, cm = p["w1"].shape
    out = torch.empty((b, h, w, p["w3"].shape[1]), dtype=torch.bfloat16, device=y.device)
    ws, bs = (p["ws"].data_ptr(), p["bs"].data_ptr()) if "ws" in p else (None, None)
    err = _build.lib().hrnet_bottleneck_block(
        y.data_ptr(), out.data_ptr(), p["w1"].data_ptr(), p["b1"].data_ptr(),
        p["w2"].data_ptr(), p["b2"].data_ptr(), p["w3"].data_ptr(), p["b3"].data_ptr(),
        ws, bs, b, h, w, cin, cm, p["w3"].shape[1], plan.th, plan.tw, plan.ks, plan.stages,
        plan.smem, _build.stream_ptr(y.device))
    _build.check(err, "hrnet_bottleneck_block")
    return out


# --------------------------------------------------------------------------
# stem + layer1 (TPU kernel fused_stem_layer1)
# --------------------------------------------------------------------------

def prepare_stem_params(state: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The folded stem as ``fused_stem_layer1`` takes it, from a PoseHRNet
    state_dict (unfolded, folded here in float32): ws1 (4, 12, 64) bf16, the
    space-to-depth stem1 kernel as one (12, 64) slab per 2x2 tap (tap
    di*2 + dj); bs1 (64,) f32; ws2 (576, 64) bf16, stem2's (3, 3, 64, 64)
    HWIO kernel with rows (kh*3 + kw)*64 + cin; bs2 (64,) f32."""
    k1, b1 = fold_conv_bn(state, "conv1", "bn1")
    k2, b2 = fold_conv_bn(state, "conv2", "bn2")
    ws1 = s2d_kernel(k1.permute(3, 2, 0, 1)).permute(2, 3, 1, 0).reshape(4, -1, k1.shape[3])
    return (ws1.to(torch.bfloat16).contiguous(), b1.contiguous(),
            k2.reshape(-1, k2.shape[3]).to(torch.bfloat16).contiguous(), b2.contiguous())


def _validate_stem(x: torch.Tensor, stem_flat: Sequence[torch.Tensor]) -> None:
    if x.dim() != 4 or x.dtype != torch.bfloat16 or x.shape[3] != 12:
        raise ValueError(f"x_s2d must be (B, H/2, W/2, 12) bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"x_s2d needs even height and width, got {tuple(x.shape[1:3])}")
    if len(stem_flat) != 4:
        raise ValueError(f"stem_flat holds (ws1, bs1, ws2, bs2), got {len(stem_flat)} tensors")
    want = ((4, 12, 64), (64,), (576, 64), (64,))
    for name, t, shape in zip(("ws1", "bs1", "ws2", "bs2"), stem_flat, want):
        dtype = torch.bfloat16 if name.startswith("w") else torch.float32
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")


def _stem_reference(x_s2d: torch.Tensor, stem_flat: Sequence[torch.Tensor]) -> torch.Tensor:
    """The stem of ``stem_layer1_reference``: (B, H/2, W/2, 12) -> (B, H/4, W/4, 64) bf16.

    y1 = bf16(relu(2x2 conv of the s2d input, padded at the top and left, + bs1));
    y2 = bf16(relu(3x3/s2 conv of y1, zero-padded, + bs2)); f32 sums."""
    ws1, bs1, ws2, bs2 = stem_flat
    x = F.pad(x_s2d.float().permute(0, 3, 1, 2), (1, 0, 1, 0))
    w1 = ws1.float().reshape(2, 2, 12, -1).permute(3, 2, 0, 1)
    y1 = torch.relu(F.conv2d(x, w1) + bs1[:, None, None]).to(torch.bfloat16)
    w2 = ws2.float().reshape(3, 3, 64, -1).permute(3, 2, 0, 1)
    y2 = F.conv2d(y1.float(), w2, stride=2, padding=1)
    y2 = torch.relu(y2 + bs2[:, None, None]).to(torch.bfloat16)
    return y2.permute(0, 2, 3, 1).contiguous()


def stem_layer1_reference(x_s2d: torch.Tensor, stem_flat: Sequence[torch.Tensor],
                          params_flat: Sequence[torch.Tensor],
                          shortcut_flags: Sequence[bool] = (True, False, False, False)
                          ) -> torch.Tensor:
    """Plain PyTorch twin of ``fused_stem_layer1``: the stem, each conv
    rounded once to bf16, then ``layer1_reference``."""
    return layer1_reference(_stem_reference(x_s2d, stem_flat), params_flat, shortcut_flags)


class StemPlan(NamedTuple):
    """One launch of ``csrc/stem_layer1.cu``: block (y2 tile, sample)."""

    th: int                 # y2 rows of a tile
    tw: int                 # y2 columns of a tile
    stages: int             # ws2 slabs (one per tap) in the shared-memory ring
    smem: int               # dynamic shared memory bytes
    grid: Tuple[int, int]   # (tiles, B)


@functools.lru_cache(maxsize=256)
def stem_plan(b: int, hs: int, ws: int) -> StemPlan:
    """The stem kernel's plan for x_s2d (b, hs, ws, 12): a y2 tile of up to
    8 x 16 pixels (stem2's 4 x 2 warps of m16 tiles), its (2th+2) x (2tw+2)
    x_s2d window (rows of 24 bf16), ws1 (64 K rows), its (2th+1) x (2tw+1)
    y1 window and a ring of 4 (else 3, 2) ws2 slabs (rows of 72 bf16).
    Raises ValueError on a shape the kernel does not take."""
    if b < 1 or hs < 2 or ws < 2 or hs % 2 or ws % 2:
        raise ValueError(f"the stem kernel takes B >= 1 and even H/2, W/2 >= 2, got "
                         f"{(b, hs, ws)}")
    th, tw = min(hs // 2, 8), min(ws // 2, 16)
    for stages in (4, 3, 2):
        smem = 2 * ((2 * th + 2) * (2 * tw + 2) * 24 + 64 * 72
                    + (2 * th + 1) * (2 * tw + 1) * 72 + stages * 64 * 72)
        if smem <= _build.SMEM_LIMIT:
            return StemPlan(th, tw, stages, smem, (-(-(hs // 2) // th) * -(-(ws // 2) // tw), b))
    raise ValueError("no tile of the stem kernel fits in shared memory")


def _launch_stem(x_s2d: torch.Tensor, stem_flat: Sequence[torch.Tensor],
                 plan: StemPlan) -> torch.Tensor:
    """One launch of the stem kernel on PyTorch's stream: the stem of
    ``_stem_reference``, (B, H/2, W/2, 12) -> (B, H/4, W/4, 64) bf16."""
    b, hs, ws, _ = x_s2d.shape
    y = torch.empty((b, hs // 2, ws // 2, 64), dtype=torch.bfloat16, device=x_s2d.device)
    err = _build.lib().hrnet_stem_s2d(
        x_s2d.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in stem_flat), b, hs, ws,
        plan.th, plan.tw, plan.stages, plan.smem, _build.stream_ptr(x_s2d.device))
    _build.check(err, "hrnet_stem_s2d")
    return y


def fused_stem_layer1(x_s2d: torch.Tensor, stem_flat: Sequence[torch.Tensor],
                      params_flat: Sequence[torch.Tensor],
                      shortcut_flags: Sequence[bool] = (True, False, False, False)
                      ) -> torch.Tensor:
    """x_s2d: (B, H/2, W/2, 12) bf16 space-to-depth image -> (B, H/4, W/4, Cout) bf16.

    ``stem_flat`` from ``prepare_stem_params``, ``params_flat`` and
    ``shortcut_flags`` the layer1 chain's (``fold_layer1_params``).  A CUDA
    tensor runs the stem kernel (plan ``stem_plan``) and then the layer1
    block kernel once per block, and counts each launch in ``launches`` (5
    for layer1's 4 blocks); a CPU tensor runs the plain twin; any other
    device raises.
    """
    _validate_stem(x_s2d, stem_flat)
    blocks = _split(params_flat, shortcut_flags)
    b, hs, ws, _ = x_s2d.shape
    _validate(x_s2d.new_empty((0, hs // 2, ws // 2, 64)), blocks)
    if x_s2d.device.type == "cpu":
        return stem_layer1_reference(x_s2d, stem_flat, params_flat, shortcut_flags)
    _check_cuda("fused_stem_layer1", x_s2d, [*stem_flat, *params_flat])
    plan = stem_plan(b, hs, ws)
    plans = _bottleneck_plans((b, hs // 2, ws // 2, 64), blocks)
    y = _launch_stem(x_s2d, stem_flat, plan)
    fused_stem_layer1.launches += 1
    for p, bplan in zip(blocks, plans):
        y = _launch_bottleneck(y, p, bplan)
        fused_stem_layer1.launches += 1
    return y


fused_stem_layer1.launches = 0


# --------------------------------------------------------------------------
# BasicBlock branch chains (TPU kernel fused_basic_chain)
# --------------------------------------------------------------------------

def fold_branch_params(state: Mapping[str, torch.Tensor], prefix: str
                       ) -> Tuple[torch.Tensor, ...]:
    """BN-folded kernel params of the BasicBlock chain at ``prefix``
    (``stage3.1.branches.2``) of a PoseHRNet state_dict: per block
    (w1 (3, 3, C, C) bf16 HWIO, b1 (C,) f32, w2, b2), folded in float32 before
    the cast.  The chain has ``len(result) // 4`` blocks."""
    flat = []
    b = 0
    while f"{prefix}.{b}.conv1.weight" in state:
        blk = f"{prefix}.{b}"
        if f"{blk}.downsample.0.weight" in state:
            raise ValueError(f"{blk} has a projection shortcut: not a plain BasicBlock chain")
        for n in (1, 2):
            k, bias = fold_conv_bn(state, f"{blk}.conv{n}", f"{blk}.bn{n}")
            flat += [k.to(torch.bfloat16).contiguous(), bias.contiguous()]
        b += 1
    if not b:
        raise KeyError(f"no BasicBlocks under {prefix!r}")
    return tuple(flat)


class PaddedChain(tuple):
    """A BasicBlock chain's params zero-padded to a wider width
    (``pad_basic_params``); ``c`` is the chain's own width, the channels of
    the x it takes."""

    def __new__(cls, tensors, c: int):
        self = super().__new__(cls, tensors)
        self.c = c
        return self


def _validate_basic(x: torch.Tensor, params_flat: Sequence[torch.Tensor], n_blocks: int) -> None:
    """x (B, H, W, C) bf16 and ``n_blocks`` blocks of params of width C, or
    a ``PaddedChain`` of a chain of C channels."""
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be (B, H, W, C) bfloat16, got {tuple(x.shape)} {x.dtype}")
    if len(params_flat) != 4 * n_blocks or not n_blocks:
        raise ValueError(f"params_flat has {len(params_flat)} tensors, {n_blocks} blocks "
                         f"take {4 * n_blocks}")
    c = x.shape[3]
    if isinstance(params_flat, PaddedChain) and params_flat.c == c:
        c = params_flat[0].shape[-1]
    for i, t in enumerate(params_flat):
        shape, dtype = ((3, 3, c, c), torch.bfloat16) if i % 2 == 0 else ((c,), torch.float32)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"block {i // 4} tensor {i % 4}: want {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"block {i // 4} tensor {i % 4} on {t.device}, x on {x.device}")


def _conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 NHWC 3x3 conv, zero padding 1, of an HWIO kernel -> float32 NCHW."""
    return F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1)


def _pad_channels(x: torch.Tensor, c: int) -> torch.Tensor:
    """x (..., C) zero-padded to (..., c) channels (x itself when C == c)."""
    return x if x.shape[-1] == c else F.pad(x, (0, c - x.shape[-1])).contiguous()


def basic_chain_reference(x: torch.Tensor, params_flat: Sequence[torch.Tensor],
                          n_blocks: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (B, H, W, C) bf16 -> (B, H, W, C) bf16.

    Per block, as the TPU kernel rounds: h = bf16(relu(conv1(x) + b1)), then
    y = bf16(relu((conv2(h) + b2) + float(x))), each conv summed in float32.
    Params padded to Cp > C (``pad_basic_params``) run on x zero-padded to
    Cp, and the first C channels come back: the padded channels stay 0.
    On a card, disable TF32 (``torch.backends.cudnn.allow_tf32``) for a
    float32 reference."""
    c = x.shape[3]
    y = _pad_channels(x, params_flat[0].shape[-1])
    for b in range(n_blocks):
        w1, b1, w2, b2 = params_flat[4 * b:4 * b + 4]
        h = torch.relu(_conv3x3(y, w1) + b1[:, None, None]).to(torch.bfloat16)
        out = (_conv3x3(h.permute(0, 2, 3, 1), w2) + b2[:, None, None]
               + y.float().permute(0, 3, 1, 2))
        y = torch.relu(out).to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
    return y if y.shape[3] == c else y[..., :c].contiguous()


# the kernel's instances: NT (n8 tiles per warp) -> the MT (m16 tiles per
# warp) it is built for; NT in order of preference
BASIC_TILES = {4: (2, 4, 6, 8), 6: (2, 4), 8: (4,), 2: (8,)}
# the channel widths those instances take: C = 8 * NT * (1, 2, 4 or 8 warps)
BASIC_WIDTHS = tuple(sorted({8 * nt * wn for nt in BASIC_TILES for wn in (1, 2, 4, 8)}))


def basic_chain_width(c: int) -> int:
    """The least width >= c the BasicBlock kernel takes (16, 32, 48, 64, 96,
    128, 192, 256, 384 or 512): a chain of C channels runs there with its
    params and x zero-padded.  Raises ValueError past 512."""
    for cp in BASIC_WIDTHS:
        if cp >= c > 0:
            return cp
    raise ValueError(f"the BasicBlock kernel takes C <= {BASIC_WIDTHS[-1]}, got C = {c}")


def pad_basic_params(params_flat: Sequence[torch.Tensor], c: int = 0) -> Sequence[torch.Tensor]:
    """A chain's params zero-padded to width ``c`` (default: the kernel's,
    ``basic_chain_width``), as a ``PaddedChain`` that still takes x of the
    chain's own width: zero input channels add exact zeros, and a padded
    output channel has zero weights and bias, so relu(0 + 0 + 0) keeps it
    0 through every block.  The params themselves when no padding is
    needed."""
    c0 = getattr(params_flat, "c", params_flat[0].shape[-1])
    cp = params_flat[0].shape[-1]
    c = c or basic_chain_width(cp)
    if c == cp:
        return params_flat
    d = c - cp
    return PaddedChain(((F.pad(t, (0, d, 0, d)) if t.dim() == 4 else F.pad(t, (0, d))).contiguous()
                        for t in params_flat), c0)


class BasicChainPlan(NamedTuple):
    """One launch of ``csrc/basic_chain.cu``: block (tile, sample)."""

    th: int                 # output rows of a tile
    tw: int                 # output columns of a tile
    wm: int                 # warps along the pixels (8 / wm along the channels)
    mt: int                 # m16 tiles per warp: wm * mt * 16 >= (th + 2) * (tw + 2)
    nt: int                 # n8 tiles per warp: (8 / wm) * nt * 8 == cp
    ks: int                 # K rows (input channels of one tap) per weight slab
    stages: int             # weight slabs in the shared-memory ring
    smem: int               # dynamic shared memory bytes
    grid: Tuple[int, int]   # (tiles, B)
    cp: int                 # the width the kernel runs at (basic_chain_width(C))


@functools.lru_cache(maxsize=1024)
def basic_chain_plan(b: int, h: int, w: int, c: int) -> BasicChainPlan:
    """The kernel's plan for one BasicBlock on x (b, h, w, c), run at width
    ``cp = basic_chain_width(c)``.

    A tile is up to 16 rows x 32 columns, all cp channels: the most pixels
    (so the fewest passes over the weights) whose conv1 ring fits the
    kernel's warp tiles, i.e. 16 rows at 32 channels, 8 at 64 and 128, the
    whole image at 8 x 8, narrower where shared memory runs out.  Shared
    memory holds the (th+4) x (tw+4) input halo, conv1's (th+2) x (tw+2)
    ring t and a ring of 4 (else 3, 2) weight slabs, each pixel or K row
    cp + 8 bf16.  Raises ValueError on a shape the kernel does not take."""
    if b < 1 or h < 1 or w < 1:
        raise ValueError(f"empty input {(b, h, w, c)}")
    cp = basic_chain_width(c)
    nt = next(nt for nt in BASIC_TILES if cp % (nt * 8) == 0 and cp // (nt * 8) in (1, 2, 4, 8))
    wm, ks = _build.WARPS // (cp // (nt * 8)), 32 if cp % 32 == 0 else 16
    for tw in sorted({min(w, 32), min(w, 16), min(w, 8)}, reverse=True):
        for th in sorted({min(h, 16), min(h, 8), min(h, 4), min(h, 2), 1}, reverse=True):
            ring_tiles = -(-(th + 2) * (tw + 2) // 16)      # conv1's m16 tiles
            mts = [m for m in BASIC_TILES[nt] if m * wm >= ring_tiles]
            if not mts:
                continue
            for stages in (4, 3, 2):
                smem = 2 * (cp + 8) * ((th + 4) * (tw + 4) + (th + 2) * (tw + 2) + stages * ks)
                if smem <= _build.SMEM_LIMIT:
                    return BasicChainPlan(th, tw, wm, mts[0], nt, ks, stages, smem,
                                          (-(-h // th) * -(-w // tw), b), cp)
    raise ValueError(f"no tile of the kernel fits C = {cp} at {h}x{w}")


def fused_basic_chain(x: torch.Tensor, params_flat: Sequence[torch.Tensor],
                      n_blocks: int) -> torch.Tensor:
    """x: (B, H, W, C) bf16 -> (B, H, W, C) bf16 through ``n_blocks`` folded
    BasicBlocks (params from ``fold_branch_params``, of width C or padded
    by ``pad_basic_params``).

    A CUDA tensor runs the kernel (one launch per block, each counted in
    ``launches``) at the plan's width: x and, unless ``pad_basic_params``
    did it once, the params are zero-padded to it, and the first C channels
    of the result come back.  A CPU tensor runs the plain twin; any other
    device raises.
    """
    _validate_basic(x, params_flat, n_blocks)
    if x.device.type == "cpu":
        return basic_chain_reference(x, params_flat, n_blocks)
    b, h, w, c = x.shape
    plan = basic_chain_plan(b, h, w, params_flat[0].shape[-1])
    params_flat = pad_basic_params(params_flat, plan.cp)
    xp = _pad_channels(x, plan.cp)
    _check_cuda("fused_basic_chain", xp, params_flat)
    lib, stream = _build.lib(), _build.stream_ptr(x.device)
    y = xp
    for i in range(n_blocks):
        out = torch.empty_like(xp)
        err = lib.hrnet_basic_block(y.data_ptr(), out.data_ptr(),
                                    *(t.data_ptr() for t in params_flat[4 * i:4 * i + 4]),
                                    b, h, w, plan.cp, plan.th, plan.tw, plan.wm, plan.mt, plan.nt,
                                    plan.ks, plan.stages, plan.smem, stream)
        _build.check(err, "hrnet_basic_block")
        fused_basic_chain.launches += 1
        y = out
    return y if plan.cp == c else y[..., :c].contiguous()


fused_basic_chain.launches = 0
