"""int8 W8A8 serving path of the HRNet trunk, in PyTorch.

Port of the JAX package's ``core/quant_infer.py``.  The shipped serving
configuration (``prepare_serving_qparams``) runs:

- the stem's first conv in bf16 and stem2 in W8A8;
- layer1 as the W8A8 bottleneck chain (``ops/kernels/int8_chain.py``);
- stages 2-4 with every conv of the 'exchange' scope (branch, transition
  and exchange-fusion convs) in W8A8 (``ops/kernels/conv_int8.py``);
- the head, softmax and soft-argmax as one kernel
  (``ops/kernels/fused_head_decode.py``), optionally on int8 branch inputs;
- raw uint8 images normalized on the device (``input_norm=``).

The scheme: BN-folded weights quantized symmetric per output channel
(``wscale[c] = max|k'[c]| / 127``), activations symmetric per tensor with
calibrated scales (``sa = amax / 127``), int8 x int8 -> int32 sums, and an f32
dequant + bias (+ ReLU) epilogue.  Site names are the JAX package's, so one
calibration record (``save_calibration``) serves both packages.

Usage:
    weights = precast_variables(cfg, state)               # core/fast_infer.py
    amax = calibrate(cfg, weights, [batch1, batch2, ...])   # normalized images
    qparams = prepare_serving_qparams(cfg, state, amax)
    infer = make_quant_infer(cfg, input_norm=(IMAGENET_MEAN, IMAGENET_STD))
    coords = infer(weights, qparams, images_uint8)          # (B, K, 2) [u, v]
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.hrnet import PoseHRNet, StageCfg, _nchw
from ..ops.kernels.conv_int8 import SiteQ, conv_int8, pad_kq
from ..ops.kernels.fused_bottleneck import fold_conv_bn, fused_bottleneck_chain
from ..ops.kernels.fused_head_decode import fused_head_decode_v2
from ..ops.kernels.int8_chain import fused_bottleneck_chain_int8, prepare_layer1_int8
from ..ops.upsample import upsample_nearest
from ..utils.weights import _torch_name

Params = Dict[str, object]

CALIBRATION_VERSION = 1
LAYER1_CHAIN_KEY = "_layer1_chain"
HEAD_SCALES_KEY = "_head_scales"

# ImageNet normalization (reference lib/dataset/*: transforms.Normalize)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# --------------------------------------------------------------------------
# the quantization scheme and the calibration record
# --------------------------------------------------------------------------

def quantize_weight(kernel) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 weights of an OIHW kernel:
    (kq OIHW int8, wscale (O,) float32).  Element for element the JAX
    package's scheme on the HWIO transpose: float32 arithmetic, round half
    to even (``np.round``), clip to +-127."""
    kernel = np.asarray(kernel, np.float32)
    wmax = np.abs(kernel).reshape(kernel.shape[0], -1).max(axis=1)
    wscale = np.maximum(wmax, 1e-12) / 127.0
    shape = (-1,) + (1,) * (kernel.ndim - 1)
    kq = np.clip(np.round(kernel / wscale.reshape(shape)), -127, 127).astype(np.int8)
    return kq, wscale


def site_scale(amax: Mapping[str, float], site: str) -> float:
    """Symmetric per-tensor activation scale from a calibration record."""
    if site not in amax:
        raise KeyError(f"no calibration record for {site}")
    return max(float(amax[site]), 1e-12) / 127.0


def save_calibration(path: str, amax: Mapping[str, float], cfg=None) -> None:
    """Write a calibration record ({site: amax}) as JSON, in the JAX
    package's format: ``cfg`` stamps the model name and image size."""
    rec = {
        "version": CALIBRATION_VERSION,
        "model": str(cfg.MODEL.NAME) if cfg is not None else "",
        "image_size": ([int(v) for v in cfg.MODEL.IMAGE_SIZE] if cfg is not None else None),
        "amax": {k: float(v) for k, v in sorted(amax.items())},
    }
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def load_calibration(path: str, cfg=None) -> Dict[str, float]:
    """Read a record written by ``save_calibration`` (of either package);
    checks the version and, given ``cfg``, the model and image-size stamps."""
    with open(path) as f:
        rec = json.load(f)
    if rec.get("version") != CALIBRATION_VERSION:
        raise ValueError(f"calibration record {path}: version {rec.get('version')!r}, "
                         f"expected {CALIBRATION_VERSION}")
    if cfg is not None and rec.get("model") and rec["model"] != str(cfg.MODEL.NAME):
        raise ValueError(f"calibration record {path} was made for model {rec['model']!r}, "
                         f"config builds {str(cfg.MODEL.NAME)!r}")
    if cfg is not None and rec.get("image_size"):
        want = [int(v) for v in cfg.MODEL.IMAGE_SIZE]
        if [int(v) for v in rec["image_size"]] != want:
            raise ValueError(f"calibration record {path} was made at image size "
                             f"{rec['image_size']}, config uses {want} (activation maxima "
                             f"are resolution-dependent; recalibrate)")
    return {k: float(v) for k, v in rec["amax"].items()}


# --------------------------------------------------------------------------
# sites
# --------------------------------------------------------------------------

def stage_cfgs(cfg) -> Tuple[StageCfg, StageCfg, StageCfg]:
    extra = cfg.MODEL.EXTRA
    return tuple(StageCfg.from_cfg(extra[f"STAGE{n}"]) for n in (2, 3, 4))


def quant_sites(cfg, scope: str = "branch", stem2: bool = False) -> List[str]:
    """The int8 sites, by the JAX package's names, in its order.

    'branch': the stage 2-4 BasicBlock convs; 'exchange': also the
    transition and exchange-fusion convs (everything but stem, layer1 and
    head; the shipped scope, layer1 being the W8A8 chain); 'wide': also
    the layer1 convs, for the per-site layer1 walk.  ``stem2`` adds stem2.
    """
    if scope not in ("branch", "exchange", "wide"):
        raise ValueError(f"unknown scope {scope!r}")
    sites = ["stem2"] if stem2 else []
    cfgs = stage_cfgs(cfg)
    names = ("stage2", "stage3", "stage4")
    for sname, stage in zip(names, cfgs):
        for m in range(stage.num_modules):
            for i in range(stage.num_branches):
                for b in range(stage.num_blocks[i]):
                    sites += [f"{sname}_m{m}/branch{i}/block{b}/cb{n}" for n in (1, 2)]
    if scope == "wide":
        for b in range(4):
            sites += [f"layer1/block{b}/cb{n}" for n in (1, 2, 3)]
            if b == 0:
                sites.append("layer1/block0/downsample")
    if scope in ("wide", "exchange"):
        pre = [(256,), cfgs[0].out_channels, cfgs[1].out_channels]
        for t, stage in enumerate(cfgs):
            name = f"transition{t + 1}"
            for i in range(stage.num_branches):
                if i < len(pre[t]):
                    if stage.out_channels[i] != pre[t][i]:
                        sites.append(f"{name}_{i}")
                else:
                    sites += [f"{name}_{i}_{j}" for j in range(i + 1 - len(pre[t]))]
        for sname, stage in zip(names, cfgs):
            if stage.num_branches == 1:
                continue
            for m in range(stage.num_modules):
                for i in range(stage.num_branches):
                    for j in range(stage.num_branches):
                        if j > i:
                            sites.append(f"{sname}_m{m}/fuse{i}_{j}")
                        elif j < i:
                            sites += [f"{sname}_m{m}/fuse{i}_{j}_{k}" for k in range(i - j)]
    return sites


def site_modules(site: str) -> Tuple[str, str]:
    """The port's (conv, bn) module names of a JAX site name, by the name
    rules of ``utils/weights.py``: ``stage2_m0/branch0/block0/cb1`` ->
    (``stage2.0.branches.0.0.conv1``, ``...bn1``), ``stage3_m1/fuse2_0_1`` ->
    ``stage3.1.fuse_layers.2.0.1.{0,1}``, ``transition2_2_0`` ->
    ``transition2.2.0.{0,1}``, ``stem2`` -> (``conv2``, ``bn2``)."""
    conv, bn = (_torch_name(f"backbone/{site}/{leaf}") for leaf in ("conv", "bn"))
    if conv is None or bn is None:
        raise KeyError(f"no port module for site {site!r}")
    return conv, bn


def fold_site(state: Mapping[str, torch.Tensor], conv: str, bn: str
              ) -> Tuple[np.ndarray, np.ndarray]:
    """BN folded into a conv of a state_dict: (OIHW kernel, bias), float32 numpy."""
    kernel, bias = fold_conv_bn(state, conv, bn)                     # HWIO
    return kernel.permute(3, 2, 0, 1).cpu().numpy(), bias.cpu().numpy()


# --------------------------------------------------------------------------
# offline preparation
# --------------------------------------------------------------------------

def prepare_quant_params(cfg, state: Mapping[str, torch.Tensor], amax: Mapping[str, float],
                         scope: str = "branch", stem2: bool = False) -> Dict[str, SiteQ]:
    """Offline weight quantization of a PoseHRNet state_dict (unfolded):
    {site: SiteQ} on the state's device, for the sites of ``quant_sites``.
    Each kq is laid out as ``conv_int8``'s kernel reads it (``pad_kq``:
    a channel pitch of Cin rounded up to 16, zeros past Cin)."""
    dev = state["conv1.weight"].device
    out = {}
    for site in quant_sites(cfg, scope, stem2=stem2):
        kernel, bias = fold_site(state, *site_modules(site))
        kq, wscale = quantize_weight(kernel)
        sa = np.float32(site_scale(amax, site))
        out[site] = SiteQ(
            kq=pad_kq(torch.from_numpy(np.ascontiguousarray(kq.transpose(0, 2, 3, 1))).to(dev)),
            wscale=torch.from_numpy(wscale).to(dev),
            sa=torch.tensor(sa, dtype=torch.float32, device=dev),
            scale=torch.from_numpy(sa * wscale).to(dev),        # one f32 product
            bias=torch.from_numpy(np.asarray(bias, np.float32)).to(dev))
    return out


def prepare_head_input_scales(amax: Mapping[str, float], device="cpu"
                              ) -> Tuple[torch.Tensor, ...]:
    """Per-branch int8 scales of the head's four inputs (records
    ``head_in{i}``), as 0-dim float32 tensors on ``device``."""
    return tuple(torch.tensor(max(float(amax[f"head_in{i}"]), 1e-12) / 127.0,
                              dtype=torch.float32, device=device) for i in range(4))


def prepare_serving_qparams(cfg, state: Mapping[str, torch.Tensor], amax: Mapping[str, float],
                            scope: str = "exchange", stem2: bool = True,
                            layer1_chain: bool = True, int8_head: bool = False) -> Params:
    """THE shipped serving configuration, as in the JAX package: the int8
    trunk of ``scope`` + W8A8 stem2 + the W8A8 layer1 chain
    (``LAYER1_CHAIN_KEY``) + optionally int8 head inputs (``HEAD_SCALES_KEY``)."""
    qparams: Params = dict(prepare_quant_params(cfg, state, amax, scope=scope, stem2=stem2))
    if layer1_chain:
        qparams[LAYER1_CHAIN_KEY] = prepare_layer1_int8(state, amax)[0]
    if int8_head:
        qparams[HEAD_SCALES_KEY] = prepare_head_input_scales(amax, state["conv1.weight"].device)
    return qparams


def layer1_topology(state: Mapping[str, torch.Tensor]) -> Tuple[bool, ...]:
    """Per-block projection-shortcut flags of layer1, from the state's keys."""
    flags, b = [], 0
    while f"layer1.{b}.conv1.weight" in state:
        flags.append(f"layer1.{b}.downsample.0.weight" in state)
        b += 1
    return tuple(flags)


# --------------------------------------------------------------------------
# the stage walk (mirrors the backbone, site by site)
# --------------------------------------------------------------------------

def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _conv(conv: torch.nn.Conv2d, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """A folded non-int8 site as the JAX walk's ``_conv_bf16`` runs it: the
    convolution rounded to the activations' dtype, then the bias added in
    that dtype (two roundings, where a conv with its bias would round once)."""
    y = F.conv2d(x, conv.weight, None, conv.stride, conv.padding)
    y = y + conv.bias.to(y.dtype)[:, None, None]
    return torch.relu(y) if relu else y


class _Walk:
    """One pass over (layer1 and) stages 2-4 of a BN-folded PoseHRNet
    (``core/fast_infer._fold_model``), on NCHW tensors.

    mode 'f32'       -- every conv as the folded model's own (in its dtype)
    mode 'calibrate' -- like 'f32', recording each site's input amax
    mode 'quant'     -- sites in ``qparams`` through ``conv_int8``, the rest
                        as 'f32'
    The additions keep the JAX walk's order and dtype: residual sums and
    fuse contributions are added in the activations' dtype (bf16 when
    served), j = 0..n-1, the nearest upsample after the 1x1 fuse conv.
    """

    def __init__(self, model: PoseHRNet, mode: str, qparams: Optional[Params] = None):
        if mode not in ("f32", "calibrate", "quant"):
            raise ValueError(f"unknown walk mode {mode!r}")
        self.model = model
        self.mode = mode
        self.q = qparams or {}
        self.amax: Dict[str, torch.Tensor] = {}

    def conv(self, x: torch.Tensor, site: str, stride: int = 1, relu: bool = True):
        if self.mode == "calibrate":
            m = x.detach().abs().max().float()
            self.amax[site] = torch.maximum(self.amax[site], m) if site in self.amax else m
        if self.mode == "quant" and site in self.q:
            return conv_int8(_nhwc(x), self.q[site], stride=stride, relu=relu).permute(0, 3, 1, 2)
        return _conv(self.model.get_submodule(site_modules(site)[0]), x, relu)

    def layer1(self, x):
        for b in range(len(self.model.layer1)):
            base = f"layer1/block{b}"
            y = self.conv(x, f"{base}/cb1")
            y = self.conv(y, f"{base}/cb2")
            y = self.conv(y, f"{base}/cb3", relu=False)
            if self.model.layer1[b].downsample is not None:
                x = self.conv(x, f"{base}/downsample", relu=False)
            x = torch.relu(y + x)
        return x

    def branch(self, x, mod: str, i: int, n_blocks: int):
        for b in range(n_blocks):
            base = f"{mod}/branch{i}/block{b}"
            y = self.conv(x, f"{base}/cb1")
            y = self.conv(y, f"{base}/cb2", relu=False)
            x = torch.relu(y + x)
        return x

    def hr_module(self, xs: List[torch.Tensor], mod: str, stage: StageCfg):
        ys = [self.branch(xs[i], mod, i, stage.num_blocks[i]) for i in range(stage.num_branches)]
        if stage.num_branches == 1:
            return ys
        fused = []
        for i in range(stage.num_branches):
            acc = None
            for j in range(stage.num_branches):
                if j == i:
                    contrib = ys[j]
                elif j > i:
                    contrib = self.conv(ys[j], f"{mod}/fuse{i}_{j}", relu=False)
                    contrib = _nchw(upsample_nearest, contrib, 2 ** (j - i))
                else:
                    contrib = ys[j]
                    for k in range(i - j):
                        contrib = self.conv(contrib, f"{mod}/fuse{i}_{j}_{k}", stride=2,
                                            relu=k != i - j - 1)
                acc = contrib if acc is None else acc + contrib
            fused.append(torch.relu(acc))
        return fused

    def transition(self, xs, pre_ch, stage: StageCfg, name: str):
        outs = []
        for i in range(stage.num_branches):
            if i < len(pre_ch):
                if stage.out_channels[i] != pre_ch[i]:
                    outs.append(self.conv(xs[i], f"{name}_{i}"))
                else:
                    outs.append(xs[i])
            else:
                y = xs[-1]
                for j in range(i + 1 - len(pre_ch)):
                    y = self.conv(y, f"{name}_{i}_{j}", stride=2)
                outs.append(y)
        return outs

    def stages(self, x, cfgs: Sequence[StageCfg]):
        xs, pre = [x], (256,)
        for n, stage in enumerate(cfgs, start=2):
            xs = self.transition(xs, pre, stage, f"transition{n - 1}")
            for m in range(stage.num_modules):
                xs = self.hr_module(xs, f"stage{n}_m{m}", stage)
            pre = stage.out_channels
        return xs


def apply_trunk(cfg, model: PoseHRNet, x: torch.Tensor, mode: str = "f32",
                qparams: Optional[Params] = None, include_layer1: bool = False):
    """The walk over (layer1 +) stages 2-4 of a folded model, NCHW in and
    out.  ``include_layer1`` takes ``x`` as the stem output, else as the
    layer1 output.  Returns (xs, {site: amax tensor})."""
    walk = _Walk(model, mode, qparams)
    if include_layer1:
        x = walk.layer1(x)
    return walk.stages(x, stage_cfgs(cfg)), walk.amax


def apply_stages(cfg, model: PoseHRNet, x: torch.Tensor, mode: str = "f32",
                 qparams: Optional[Params] = None):
    """Stages 2-4 of the walk on the layer1 output; returns (xs, amax)."""
    return apply_trunk(cfg, model, x, mode=mode, qparams=qparams, include_layer1=False)


def _stem(model: PoseHRNet, x: torch.Tensor, qparams: Optional[Params] = None):
    """The two stride-2 stem convs of a folded model: stem1 as the model's
    conv (C_in = 3), stem2 in W8A8 when ``qparams`` holds 'stem2'."""
    x = _conv(model.conv1, x)
    if qparams and "stem2" in qparams:
        return conv_int8(_nhwc(x), qparams["stem2"], stride=2, relu=True).permute(0, 3, 1, 2)
    return _conv(model.conv2, x)


def _stem_layer1(weights, x: torch.Tensor, qparams: Optional[Params] = None):
    """Stem + layer1 as the bf16 serving path runs layer1: the bf16 chain
    kernel (``ops/kernels/fused_bottleneck.py``)."""
    x = _stem(weights.model, x, qparams)
    return fused_bottleneck_chain(_nhwc(x), *weights.layer1).permute(0, 3, 1, 2)


def _to_input(images: torch.Tensor, device) -> torch.Tensor:
    """NHWC images -> NCHW channels_last bf16 on ``device``."""
    x = images.to(device=device, dtype=torch.bfloat16).permute(0, 3, 1, 2)
    return x.contiguous(memory_format=torch.channels_last)


@torch.inference_mode()
def calibrate(cfg, weights, batches: Iterable) -> Dict[str, float]:
    """Per-site input maxima over calibration batches.

    ``weights`` are the bf16 serving weights (``core/fast_infer.precast_variables``);
    ``batches`` normalized float images (B, H, W, 3).  Runs the folded bf16
    walk with its own layer1 (not the chain), so every site of every scope
    gets a record, plus 'stem2' (stem2's input) and 'head_in0..3' (the four
    stage-4 outputs).  Returns {site: amax} as floats.
    """
    model = weights.model
    device = model.conv1.weight.device
    amax: Dict[str, float] = {}
    for images in batches:
        x = _conv(model.conv1, _to_input(torch.as_tensor(images), device))
        stem2 = x.abs().max().float()
        x = _conv(model.conv2, x)
        xs, batch = apply_trunk(cfg, model, x, mode="calibrate", include_layer1=True)
        batch["stem2"] = stem2
        for i, xi in enumerate(xs):
            batch[f"head_in{i}"] = xi.abs().max().float()
        values = torch.stack(list(batch.values())).tolist()
        for site, m in zip(batch, values):
            amax[site] = max(amax.get(site, 0.0), m)
    return amax


def make_quant_infer(cfg, device="cuda", trunk: str = "quant", input_norm=None,
                     pallas_layer1: bool = True, mesh=None):
    """The int8 serving function ``infer(weights, qparams, images) -> (B, K, 2)``
    on ``device``.

    ``weights`` come from ``core/fast_infer.precast_variables`` and
    ``qparams`` from ``prepare_serving_qparams``, both on ``device``.  The
    keys of ``qparams`` route layer1: ``LAYER1_CHAIN_KEY`` -> the W8A8 chain
    kernel; ``layer1/*`` sites -> the walk's per-site int8 layer1; neither
    -> the bf16 chain kernel, or with ``pallas_layer1=False`` the walk's
    folded bf16 layer1 (the conv rounded, then the bias, as ``calibrate``
    and the JAX package's ``pallas_layer1=False`` run it; cuDNN on a card).
    ``HEAD_SCALES_KEY`` feeds the head int8 inputs.  ``trunk='f32'`` runs
    the same walk unquantized.

    ``input_norm=(mean, std)`` makes the entry take raw uint8 images
    (B, H, W, 3) and normalize them on the device: ``mean * 255`` and
    ``1 / (std * 255)`` in f32, ``(x - mean) * inv_std``, cast to bf16.
    Without it, ``images`` are normalized float images.  On a card every
    kernel launches; on the CPU their plain twins run.

    ``mesh`` (``parallel/mesh.make_mesh``) serves data-parallel, as the JAX
    package's ``shard_map`` over the 'data' axis (its ``:619-628``): the
    first call with a pair of ``weights`` and ``qparams`` makes one replica
    of each per mesh device (the same objects on a device they already
    live on), every call splits the batch along axis 0 (``ValueError``
    when it does not divide), runs each chunk through every kernel of the
    path on its device, and gathers the (B, K, 2) result on the mesh's
    first device, which must be ``device``.  A 'model' axis replicates the
    weights over it, as JAX's ``shard_map`` does with its ``P()`` weights:
    each data row runs once, on its first device
    (``parallel/mesh.data_mesh``), so the result equals the data-only
    mesh's.
    """
    if trunk not in ("f32", "quant"):
        raise ValueError(f"trunk must be 'f32' or 'quant', got {trunk!r}")
    if mesh is not None:
        from ..parallel.mesh import check_home, data_mesh, replicate, run_sharded

        check_home(mesh, device)
        mesh = data_mesh(mesh)
        per_device = [make_quant_infer(cfg, d, trunk, input_norm, pallas_layer1)
                      for d in mesh.devices]
        made: List = []          # [(weights, qparams), replicas]: the pair they were made of

        def sharded(weights, qparams: Params, images: torch.Tensor) -> torch.Tensor:
            if not made or made[0][0] is not weights or made[0][1] is not qparams:
                made[:] = [(weights, qparams), list(zip(replicate(mesh, weights),
                                                        replicate(mesh, qparams)))]
            replicas = [(fn, w, q) for fn, (w, q) in zip(per_device, made[1])]
            return run_sharded(mesh, lambda r, x: r[0](r[1], r[2], x), replicas, images)

        return sharded
    device = torch.device(device)
    image_hw = tuple(int(s) for s in cfg.MODEL.IMAGE_SIZE)[::-1]     # (W, H) -> (H, W)
    if input_norm is not None:
        mean = torch.tensor(input_norm[0], dtype=torch.float32) * 255.0
        inv_std = 1.0 / (torch.tensor(input_norm[1], dtype=torch.float32) * 255.0)
        mean, inv_std = mean.to(device), inv_std.to(device)

    @torch.inference_mode()
    def infer(weights, qparams: Params, images: torch.Tensor) -> torch.Tensor:
        if images.dim() != 4 or tuple(images.shape[1:]) != image_hw + (3,):
            raise ValueError(f"images must be (B, {image_hw[0]}, {image_hw[1]}, 3), "
                             f"got {tuple(images.shape)}")
        if input_norm is not None:
            if images.dtype != torch.uint8:
                raise ValueError(f"input_norm takes uint8 images, got {images.dtype}")
            images = ((images.to(device).float() - mean) * inv_std).to(torch.bfloat16)
        x = _to_input(images, device)
        model = weights.model
        head_scales = qparams.get(HEAD_SCALES_KEY)
        q = {k: v for k, v in qparams.items() if k != HEAD_SCALES_KEY}
        if LAYER1_CHAIN_KEY in q:
            rest = {k: v for k, v in q.items() if k != LAYER1_CHAIN_KEY}
            x = _stem(model, x, rest)
            x = fused_bottleneck_chain_int8(_nhwc(x), q[LAYER1_CHAIN_KEY], weights.layer1[1])
            xs, _ = apply_stages(cfg, model, x.permute(0, 3, 1, 2), mode=trunk, qparams=rest)
        elif not pallas_layer1 or any(k.startswith("layer1/") for k in q):
            x = _stem(model, x, q)
            xs, _ = apply_trunk(cfg, model, x, mode=trunk, qparams=q, include_layer1=True)
        else:
            x = _stem_layer1(weights, x, q)
            xs, _ = apply_stages(cfg, model, x, mode=trunk, qparams=q)
        xs = [_nhwc(t) for t in xs]
        if head_scales is None:
            return fused_head_decode_v2(xs, weights.head)
        # int8 head inputs: x / sa, a true division by a tensor on the device
        xs = [torch.clamp(torch.round(t.float() / sa), -127, 127).to(torch.int8)
              for t, sa in zip(xs, head_scales)]
        return fused_head_decode_v2(xs, weights.head, input_scales=head_scales)

    return infer
