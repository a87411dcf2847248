"""Weights for the port: from the JAX variable tree, or made from a seed.

``from_jax_variables`` maps the JAX package's PoseHRNet ``{"params",
"batch_stats"}`` tree (numpy leaves), a triangulation net's (the PoseHRNet,
or ``vol_CPM``'s CPMVolumetric, under ``backbone``, with
``process_features`` and the V2V ``volume_net``), a CPM's, the fusion
net's (the PoseHRNet under ``backbone`` and ``aggregation/pair_fc``), a
PoseHRNetHamburger's (with its ``ham_bases`` collection), a PoseResNet's, a
SwinPose's, an RVT PoolingTransformer's, a temporal model's (PoseAggrNet,
PoseTransformer, HRNetPredRNN, HRNetEmbTCN), an FTLMultiviewNet's, an
HGFilter's or a HandMeshNet's onto the port's ``state_dict``.
It keeps its own copy of the name rules of the JAX package's
``utils/torch_convert.py`` (reference torch name -> flax path), inverted:
flax path -> torch name, HWIO / DHWIO kernels -> OIHW / OIDHW weights, a
transposed conv's kernel flipped in space back to torch's (I, O, [D,] H,
W), a 1D conv's (W, I, O) kernel -> (O, I, W), Dense (in, out) -> Linear
(out, in), an attention ``DenseGeneral``'s
(in, heads, head_dim) or (heads, head_dim, out) kernel -> Linear, LayerNorm
``scale`` -> ``weight``, and BN ``scale/bias/mean/var`` ->
``weight/bias/running_mean/running_var``.  Swin's, the RVT's and the
temporal models' own parts have no reference names: their port names are
the flax paths (PoseAggr's ``offset_feats`` chain keeps the reference's
``_make_layer`` names, as the HRNet's layer1 does), and so have FTL's (its
backbone is the HRNet, under ``backbone``), HGFilter's (the reference's
``add_module`` names, the norms under ``.norm``) and HandMeshNet's
(``cheb{l}.w`` / ``.b`` kept as they are).

``from_jax_train_state`` maps a JAX ``TrainState`` (parameters, BN
statistics, the optax state, the 3D trainer's per-group one included, and
the step) onto the port's
``parallel/train_step.TrainState.state_dict()`` payload.

``init_variables`` makes a random state for a config (or for one of its
triangulation nets) from a numpy seed, for runs on a machine without JAX
(the card's).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

# flax path (joined by "/", without the leaf) -> torch module name.  The
# inverse of the JAX package's _HRNET_RULES (utils/torch_convert.py:24-65).
_RULES = (
    (r"^backbone/stem([12])/conv$", lambda m: f"conv{m[1]}"),
    (r"^backbone/stem([12])/bn$", lambda m: f"bn{m[1]}"),
    (r"^backbone/layer1/block(\d+)/cb(\d)/conv$", lambda m: f"layer1.{m[1]}.conv{m[2]}"),
    (r"^backbone/layer1/block(\d+)/cb(\d)/bn$", lambda m: f"layer1.{m[1]}.bn{m[2]}"),
    (r"^backbone/layer1/block(\d+)/downsample/(conv|bn)$",
     lambda m: f"layer1.{m[1]}.downsample.{_SUB[m[2]]}"),
    (r"^backbone/transition(\d)_(\d+)/(conv|bn)$",
     lambda m: f"transition{m[1]}.{m[2]}.{_SUB[m[3]]}"),
    (r"^backbone/transition(\d)_(\d+)_(\d+)/(conv|bn)$",
     lambda m: f"transition{m[1]}.{m[2]}.{m[3]}.{_SUB[m[4]]}"),
    (r"^backbone/stage(\d)_m(\d+)/branch(\d+)/block(\d+)/cb(\d)/conv$",
     lambda m: f"stage{m[1]}.{m[2]}.branches.{m[3]}.{m[4]}.conv{m[5]}"),
    (r"^backbone/stage(\d)_m(\d+)/branch(\d+)/block(\d+)/cb(\d)/bn$",
     lambda m: f"stage{m[1]}.{m[2]}.branches.{m[3]}.{m[4]}.bn{m[5]}"),
    (r"^backbone/stage(\d)_m(\d+)/branch(\d+)/block(\d+)/downsample/(conv|bn)$",
     lambda m: f"stage{m[1]}.{m[2]}.branches.{m[3]}.{m[4]}.downsample.{_SUB[m[5]]}"),
    (r"^backbone/stage(\d)_m(\d+)/fuse(\d+)_(\d+)/(conv|bn)$",
     lambda m: f"stage{m[1]}.{m[2]}.fuse_layers.{m[3]}.{m[4]}.{_SUB[m[5]]}"),
    (r"^backbone/stage(\d)_m(\d+)/fuse(\d+)_(\d+)_(\d+)/(conv|bn)$",
     lambda m: f"stage{m[1]}.{m[2]}.fuse_layers.{m[3]}.{m[4]}.{m[5]}.{_SUB[m[6]]}"),
    (r"^head_cb/conv$", lambda m: "last_layer.0"),
    (r"^head_cb/bn$", lambda m: "last_layer.1"),
    (r"^final_conv$", lambda m: "last_layer.3"),
    # the volumetric backbone's confidence head; {conf} is vol_ or alg_confidences
    (r"^confidence_head/cb([12])/(conv|bn)$",
     lambda m: "{conf}.features." + str(4 * (int(m[1]) - 1) + (m[2] == "bn"))),
    (r"^confidence_head/fc([123])$", lambda m: "{conf}.head." + str(2 * (int(m[1]) - 1))),
    # PoseHRNetHamburger's context module (its trunk and head are the HRNet's)
    (r"^hamburger/lower_bread$", lambda m: "hamburger.lower_bread"),
    (r"^hamburger/upper_bread/(conv|bn)$", lambda m: f"hamburger.upper_bread.{_SUB[m[1]]}"),
)
_SUB = {"conv": "0", "bn": "1"}

# V2V (the JAX package's models/v2v.py tree -> the reference torch names;
# the inverse of torch_convert._resolve_v2v / _resolve_res3d)
_RES3D = {"conv1": "res_branch.0", "bn1": "res_branch.1", "conv2": "res_branch.3",
          "bn2": "res_branch.4", "skip_conv": "skip_con.0", "skip_bn": "skip_con.1"}
_V2V_RULES = (
    (r"^front1/(conv|bn)$", lambda m: f"front_layers.0.block.{_SUB[m[1]]}"),
    (r"^front([234])/(\w+)$", lambda m: f"front_layers.{int(m[1]) - 1}.{_RES3D[m[2]]}"),
    (r"^(enc|skip|dec_res)(\d)/(\w+)$",
     lambda m: f"encoder_decoder.{_LEVEL[m[1]]}{m[2]}.{_RES3D[m[3]]}"),
    (r"^mid/(\w+)$", lambda m: f"encoder_decoder.mid_res.{_RES3D[m[1]]}"),
    (r"^dec_up(\d)/(deconv|bn)$",
     lambda m: f"encoder_decoder.decoder_upsample{m[1]}.block.{0 if m[2] == 'deconv' else 1}"),
    (r"^back1/(\w+)$", lambda m: f"back_layers.0.{_RES3D[m[1]]}"),
    (r"^back([23])/(conv|bn)$", lambda m: f"back_layers.{int(m[1]) - 1}.block.{_SUB[m[2]]}"),
    (r"^out$", lambda m: "output_layer"),
)
_LEVEL = {"enc": "encoder_res", "skip": "skip_res", "dec_res": "decoder_res"}

# CPM (the JAX package's models/cpm.py tree -> the reference torch names;
# the inverse of torch_convert._resolve_cpm)
_CPM_RULES = (
    (r"^s1_conv([1-7])$", lambda m: f"conv{m[1]}_stage1"),
    (r"^trunk/conv([123])$", lambda m: f"conv{m[1]}_stage2"),
    (r"^stage2/conv_feat$", lambda m: "conv4_stage2"),
    (r"^stage([3-6])/conv_feat$", lambda m: f"conv1_stage{m[1]}"),
    (r"^stage([2-6])/mconv([1-5])$", lambda m: f"Mconv{m[2]}_stage{m[1]}"),
)
# PoseResNet (the JAX package's models/pose_resnet.py tree -> the reference
# torch names; the inverse of torch_convert._resolve_pose_resnet).  The RVT's
# ResNet is the same tree under its own ``backbone``.
_RESNET_RULES = (
    (r"^backbone/(conv1|bn1)$", lambda m: m[1]),
    (r"^backbone/layer(\d)/block(\d+)/cb(\d)/conv$", lambda m: f"layer{m[1]}.{m[2]}.conv{m[3]}"),
    (r"^backbone/layer(\d)/block(\d+)/cb(\d)/bn$", lambda m: f"layer{m[1]}.{m[2]}.bn{m[3]}"),
    (r"^backbone/layer(\d)/block(\d+)/downsample/(conv|bn)$",
     lambda m: f"layer{m[1]}.{m[2]}.downsample.{_SUB[m[3]]}"),
)
_POSE_RESNET_RULES = _RESNET_RULES + (
    (r"^deconv(\d+)$", lambda m: f"deconv_layers.{3 * int(m[1])}"),
    (r"^deconv_bn(\d+)$", lambda m: f"deconv_layers.{3 * int(m[1]) + 1}"),
    (r"^final_layer$", lambda m: "final_layer"),
)
# PoseAggr's offset chain (a JAX ResLayer under offset_feats)
_OFFSET_RULES = (
    (r"^offset_feats/block(\d+)/cb(\d)/(conv|bn)$", lambda m: f"offset_feats.{m[1]}.{m[3]}{m[2]}"),
    (r"^offset_feats/block(\d+)/downsample/(conv|bn)$",
     lambda m: f"offset_feats.{m[1]}.downsample.{_SUB[m[2]]}"),
)
# the temporal models' own top-level modules (the rest is their backbone)
_TEMPORAL_KEYS = ("offset_feats", "spatial_embed", "predrnn", "embed")
# flax parameters that are leaves of their own, kept as they are: the
# temperature, the fusion net's stacked pair FCs, Swin's relative position
# bias tables, the RVT's keypoint tokens, PoseFormer's position embeddings
# and frame weights, PoseAggr's deform kernels (HWIO, as the port keeps them)
_OWN_LEAF = re.compile(r"^(trainable_temp|pair_fc|rel_pos_bias|keypoint_tokens|spatial_pos"
                       r"|temporal_pos|frame_weights|deform_kernel\d+)$")
# the hamburger's fixed bases: the ham_bases collection -> a buffer
_HAM_BASES = (("hamburger", "ham", "w"), "hamburger.ham.bases")

# (collection, leaf) -> torch field
_FIELD = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _match(rules, path: str) -> Optional[str]:
    for pattern, build in rules:
        m = re.match(pattern, path)
        if m:
            try:
                return build(m)
            except KeyError:          # a V2V leaf module name with no place
                return None
    return None


def _cpm_name(path: str) -> Optional[str]:
    """flax path inside a CPMVolumetric (``cpm/...``, ``feat_trunk/convN``)
    -> the port's module name."""
    if path.startswith("cpm/"):
        name = _match(_CPM_RULES, path[len("cpm/"):])
        return None if name is None else "cpm." + name
    m = re.match(r"^feat_trunk/(conv[123])$", path)
    return f"feat_trunk.{m[1]}" if m else None


def _torch_name(path: str, net: bool = False, conf: str = "vol_confidences",
                cpm: bool = False) -> Optional[str]:
    """flax module path -> the port's module name.  ``net``: the tree of a
    triangulation net or of the fusion net (its backbone under
    ``backbone``); ``cpm``: a CPM's tree, or with ``net`` a CPMVolumetric
    backbone."""
    if net:
        if path == "process_features":
            return "process_features.0"
        if path.startswith("volume_net/"):
            name = _match(_V2V_RULES, path[len("volume_net/"):])
            return None if name is None else "volume_net." + name
        if not path.startswith("backbone/"):
            return None
        rest = path[len("backbone/"):]
        name = _cpm_name(rest) if cpm else _torch_name(rest, conf=conf)
        return None if name is None else "backbone." + name
    if cpm:
        return _match(_CPM_RULES, path)
    name = _match(_RULES, path)
    return None if name is None else name.format(conf=conf)


def _zoo_name(path: str, kind: str) -> Optional[str]:
    """flax module path of a PoseResNet, SwinPose, RVT, temporal model,
    FTL, HGFilter or HandMeshNet -> the port's name."""
    if kind == "pose_resnet":
        return _match(_POSE_RESNET_RULES, path)
    if kind == "rvt" and path.startswith("backbone/"):
        name = _match(_RESNET_RULES, path)
        return None if name is None else "backbone." + name
    if kind in ("temporal", "ftl"):
        if path.startswith("backbone/"):
            name = _torch_name(path[len("backbone/"):])
            return None if name is None else "backbone." + name
        if path.startswith("offset_feats/"):
            return _match(_OFFSET_RULES, path)
    return path.replace("/", ".")


# the trees whose names _zoo_name gives
_ZOO_KINDS = ("swin", "rvt", "pose_resnet", "temporal", "ftl", "hourglass", "mesh")


def _tree_kind(params: Mapping) -> str:
    """Which model a JAX params tree (or an optimizer moment shaped like
    one) belongs to."""
    if "patch_embed" in params and "embed_norm" in params:
        return "swin"
    # FTL has a top-level final_layer: routed before pose_resnet's rule
    if "encoder_head" in params and "fuse_after_ftl" in params:
        return "ftl"
    if "conv4" in params and "m0" in params:
        return "hourglass"
    if "lift" in params and "pose_head" in params:
        return "mesh"
    if any(k in params for k in _TEMPORAL_KEYS):
        return "temporal"
    if "keypoint_tokens" in params:
        return "rvt"
    if "final_layer" in params:
        return "pose_resnet"
    if ("volume_net" in params or "process_features" in params
            or "backbone" in params.get("backbone", {}) or "aggregation" in params):
        return "net"
    if any(re.match(r"^(s1_conv\d|trunk|stage\d)$", k) for k in params):
        return "cpm"
    return "hrnet"


def _weight(arr: np.ndarray, name: str) -> np.ndarray:
    """A flax kernel -> the torch weight of module ``name``."""
    if arr.ndim == 2:                                      # Dense (in, out) -> (out, in)
        return arr.T
    if arr.ndim == 3 and re.search(r"(^|\.)tcn\d+$", name):   # Conv1d (W, I, O) -> (O, I, W)
        return arr.transpose(2, 1, 0)
    if arr.ndim == 3:
        # an attention DenseGeneral: (in, heads, head_dim), or (heads,
        # head_dim, out) for the out projection -> Linear (out, in)
        if name.endswith(".out"):
            return arr.reshape(-1, arr.shape[-1]).T
        return arr.reshape(arr.shape[0], -1).T
    if arr.ndim == 4 and ("deconv_layers" in name or re.fullmatch(r"deconv\d+", name)):
        # flax's ConvTranspose (transpose_kernel off) is a plain conv over the
        # dilated input: torch's kernel flipped in space, (I, O, H, W)
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    if arr.ndim == 4:                                      # HWIO -> OIHW
        return arr.transpose(3, 2, 0, 1)
    if "decoder_upsample" in name:
        # flax's ConvTranspose runs a regular conv on the dilated input, so
        # its kernel is torch's flipped in space (torch_convert.py:77-84)
        return arr[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
    return arr.transpose(4, 3, 0, 1, 2)                    # DHWIO -> OIDHW


_PROBE = (2, 3, 5, 7, 11)      # distinct sizes: each axis found again after _weight


def jax_last_axis(name: str, shape, heads: int = 0) -> Tuple[int, int, Optional[int]]:
    """The JAX leaf of the port parameter ``name`` of ``shape``: (its number
    of dims, the size of its last axis, the port dim that axis becomes).

    A kernel (``name`` ending in '.weight', two dims or more) is read off
    ``_weight``'s own conversion, run on a probe of distinct sizes: HWIO /
    DHWIO -> dim 0, a transposed conv's (I, O, ...) -> dim 1, Dense ->
    Linear's dim 0.  ``heads`` > 0 marks a flax attention ``DenseGeneral``
    (the port's ``MultiHead``): a three-dim kernel, whose (heads, head_dim,
    out) out projection lands on dim 0, while the (in, heads, head_dim)
    projections and their (heads, head_dim) biases fold head_dim into
    Linear's out dim (port dim None).  Every other leaf is copied as it is
    (PoseAggr's HWIO deform kernels, the fusion net's ``pair_fc``): its last
    dim."""
    shape = tuple(int(s) for s in shape)
    attention = heads and not name.endswith(".out.weight") and not name.endswith(".out.bias")
    if attention and name.endswith(".bias"):
        return 2, shape[0] // heads, None
    if len(shape) < 2 or not name.endswith(".weight"):
        return len(shape), (shape[-1] if shape else 1), (len(shape) - 1 if shape else None)
    ndim = 3 if heads else len(shape)
    probe = _weight(np.zeros(_PROBE[:ndim]), name[:-len(".weight")]).shape
    last = _PROBE[ndim - 1]
    if last in probe:
        return ndim, shape[probe.index(last)], probe.index(last)
    return ndim, shape[0] // heads, None


def _leaves(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def from_jax_variables(variables: Mapping, model: Optional[nn.Module] = None
                       ) -> Dict[str, torch.Tensor]:
    """JAX PoseHRNet, triangulation-net, CPM, fusion-net, PoseHRNetHamburger,
    PoseResNet, SwinPose, RVT, temporal-model, FTL, HGFilter or HandMeshNet
    variables (numpy leaves) -> the port's state_dict.

    Raises ``KeyError`` on any leaf it cannot place.  With ``model``, it
    also raises on any key of ``model.state_dict()`` left unfilled and on a
    shape that differs, and places the JAX ``confidence_head`` where the
    model has it (``alg_confidences`` or else ``vol_confidences``).  BN
    ``num_batches_tracked`` counters are set to 0.
    """
    out: Dict[str, torch.Tensor] = {}
    unplaced = []
    params = variables.get("params", {})
    kind = _tree_kind(params)
    net = kind == "net"
    cpm = "cpm" in params.get("backbone", {}) if net else kind == "cpm"
    conf = "vol_confidences"
    if model is not None and any(".alg_confidences." in "." + k for k in model.state_dict()):
        conf = "alg_confidences"
    for coll in ("params", "batch_stats", "ham_bases"):
        for path, leaf in _leaves(variables.get(coll, {})):
            arr = np.asarray(leaf, dtype=np.float32)
            if coll == "ham_bases" and path == _HAM_BASES[0]:
                out[_HAM_BASES[1]] = torch.from_numpy(arr.copy())
                continue
            if coll == "params" and (_OWN_LEAF.match(path[-1])
                                     or (kind == "mesh" and path[-1] in ("w", "b"))):
                out[".".join(path)] = torch.from_numpy(arr.copy())
                continue
            module = "/".join(path[:-1])
            name = (_zoo_name(module, kind) if kind in _ZOO_KINDS
                    else _torch_name(module, net, conf, cpm))
            field = _FIELD.get((coll, path[-1]))
            if name is None or field is None or coll == "ham_bases":
                unplaced.append(f"{coll}/{'/'.join(path)}")
                continue
            if path[-1] == "kernel":
                arr = _weight(arr, name)
            elif arr.ndim == 2:           # an attention DenseGeneral's (heads, head_dim) bias
                arr = arr.reshape(-1)
            out[f"{name}.{field}"] = torch.from_numpy(np.array(arr, order="C"))
    unknown = set(variables) - {"params", "batch_stats", "ham_bases"}
    unplaced += sorted(unknown)
    if unplaced:
        raise KeyError(f"JAX leaves with no place in the port: {unplaced[:10]}"
                       f" (+{max(0, len(unplaced) - 10)} more)")
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    if model is not None:
        want = model.state_dict()
        missing = sorted(set(want) - set(out))
        extra = sorted(set(out) - set(want))
        if missing or extra:
            raise KeyError(f"port keys left unfilled: {missing[:10]}; "
                           f"keys the port does not have: {extra[:10]}")
        for key, val in want.items():
            if tuple(val.shape) != tuple(out[key].shape):
                raise ValueError(f"{key}: port shape {tuple(val.shape)}, "
                                 f"JAX gives {tuple(out[key].shape)}")
    return out


def _is_masked(leaf) -> bool:
    """optax's ``MaskedNode``, the place of a leaf outside a masked group."""
    return type(leaf).__name__ == "MaskedNode"


def _unmasked(tree: Mapping) -> Dict:
    """``tree`` without its ``MaskedNode`` leaves."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            sub = _unmasked(val)
            if sub:
                out[key] = sub
        elif not _is_masked(val):
            out[key] = val
    return out


def _param_tree(tree: Mapping, names, what: str, partial: bool = False
                ) -> Dict[str, torch.Tensor]:
    """A tree shaped like the JAX params (an optimizer moment) -> {port
    parameter name: tensor}; raises unless it covers exactly ``names`` (a
    subset of them with ``partial``: a masked group's moment)."""
    out = from_jax_variables({"params": _unmasked(tree)})
    missing = sorted(set(names) - set(out)) if not partial else []
    extra = sorted(set(out) - set(names))
    if missing or extra:
        raise KeyError(f"{what}: port parameters left unfilled {missing[:5]}, "
                       f"leaves with no port parameter {extra[:5]}")
    return out


def _read_nodes(nodes, names, opt: Dict, what: str, partial: bool = False) -> None:
    """The fields of one optax chain's states into the port's ``opt``."""
    for node in nodes:
        fields = tuple(getattr(node, "_fields", ("?",)))
        if fields == ():
            continue
        if set(fields) == {"count", "mu", "nu"}:
            opt["count"] = torch.tensor(int(np.asarray(node.count)), dtype=torch.int32)
            opt.setdefault("mu", {}).update(_param_tree(node.mu, names, f"{what} adam mu",
                                                        partial))
            opt.setdefault("nu", {}).update(_param_tree(node.nu, names, f"{what} adam nu",
                                                        partial))
        elif fields == ("trace",):
            opt["trace"] = _param_tree(node.trace, names, "sgd trace")
        elif fields == ("count",):
            opt["sched_count"] = torch.tensor(int(np.asarray(node.count)), dtype=torch.int32)
        else:
            raise KeyError(f"optimizer state {type(node).__name__}{fields} has no place "
                           "in the port")


def from_jax_train_state(state, model: nn.Module) -> Dict:
    """A JAX ``TrainState`` (numpy leaves, e.g. after ``jax.device_get``) ->
    the payload of the port's ``TrainState.load_state_dict``.

    Carries the parameters and BN statistics (``from_jax_variables``,
    strict), the step, and the optax state, read by field name (no optax
    import): ``make_optimizer``'s chains (``ScaleByAdamState`` -> count, mu,
    nu; ``TraceState`` -> trace; ``ScaleByScheduleState`` -> the schedule's
    count; ``EmptyState``, adamw's weight decay, carries nothing) and the 3D
    trainer's ``multi_transform`` (``inner_states`` per label, each a
    ``MaskedState`` around an adam chain or ``set_to_zero``'s empty state):
    the groups' moments fill one flat adam's, the frozen group's are 0.
    Raises on any other optimizer state and on a leaf it cannot place.
    """
    get = (lambda key: state[key]) if isinstance(state, Mapping) else (
        lambda key: getattr(state, key))
    variables = {"params": get("params"), "batch_stats": get("batch_stats")}
    sd = from_jax_variables(variables, model)
    names = [n for n, _ in model.named_parameters()]
    params = {n: sd[n] for n in names}
    opt: Dict = {}
    opt_state = get("opt_state")
    if hasattr(opt_state, "inner_states"):
        counts = set()
        for label, masked in opt_state.inner_states.items():
            inner = masked.inner_state
            group: Dict = {}
            _read_nodes([inner] if hasattr(inner, "_fields") else list(inner), names, group,
                        f"group {label!r}", partial=True)
            counts.add((int(group.get("count", -1)), int(group.get("sched_count", -1))))
            for key in ("mu", "nu"):
                opt.setdefault(key, {}).update(group.get(key, {}))
            for key in ("count", "sched_count"):
                if key in group:
                    opt[key] = group[key]
        counts.discard((-1, -1))
        if len(counts) > 1:
            raise ValueError(f"the groups' counts differ: {sorted(counts)}")
        for key in ("mu", "nu"):
            for n in names:
                opt[key].setdefault(n, torch.zeros_like(params[n]))
    else:
        _read_nodes(opt_state, names, opt, "optimizer")
    return {"step": torch.tensor(int(np.asarray(get("step"))), dtype=torch.int32),
            "params": params,
            "batch_stats": {k: v for k, v in sd.items() if k not in params},
            "opt_state": opt}


def discriminator_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``Discriminator``'s params ({fc1, fc2, fc3}: Dense kernel (in,
    out), bias) -> the port's ``models.triangulation.Discriminator``
    state_dict (Linear weight (out, in))."""
    out = {}
    for name in ("fc1", "fc2", "fc3"):
        layer = params[name]
        out[f"{name}.weight"] = torch.from_numpy(np.array(np.asarray(layer["kernel"],
                                                                     np.float32).T))
        out[f"{name}.bias"] = torch.from_numpy(np.array(layer["bias"], np.float32))
    if set(params) != {"fc1", "fc2", "fc3"}:
        raise KeyError(f"Discriminator params {sorted(params)}: want fc1, fc2, fc3")
    return out


# the single-image models of the zoo whose state init_variables makes whole
ZOO_MODELS = ("pose_resnet", "swin_transformer", "pose_hrnet_hamburger", "my_pose_transformer")
# the temporal models: (B, T, H, W, 3) frames in, T = len(DATASET.SEQ_IDX)
TEMPORAL_MODELS = ("pose_hrnet_PoseAggr", "pose_hrnet_transformer", "HRNet_PredRNN",
                   "HRNet_Emb_TCN")

# the BNs that close a residual branch of stages 2-4 (basic-block bn2) or
# feed another resolution (fuse layers): damped by init_variables
_DAMPED_BN = re.compile(r"branches\.\d+\.\d+\.bn2$|fuse_layers\.")


@torch.no_grad()
def init_variables(cfg, seed: int = 0, device="cpu", damp: bool = True,
                   net: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """A random PoseHRNet state_dict for ``cfg`` from a numpy seed (with the
    confidence head of ``pose_hrnet_volumetric`` where the config names it;
    the model's own where MODEL.NAME names a model of the zoo: ``CPM``,
    ``multiview_pose_hrnet``, ``pose_resnet``, ``swin_transformer``,
    ``pose_hrnet_hamburger``, ``my_pose_transformer``, a temporal model,
    ``FTL`` or ``HourGlass``),
    or with ``net`` ('alg', 'ransac', 'vol', 'vol_CPM') the state_dict of
    that triangulation net
    (``models.triangulation.build_triangulation_net``).

    Convs, transposed convs, linear layers, PoseAggr's deform kernels and
    PoseFormer's frame weights are He-scaled normals (a transposed conv's
    fan-in counts the inputs one output sees), BN, LayerNorm and GroupNorm
    affine parameters random around 1 and 0, Swin's relative position biases and
    PoseFormer's position embeddings normals of std 0.02, the RVT's keypoint
    tokens and the hamburger's bases uniform in [0, 1).  With ``damp``, the
    BNs that close a residual branch in stages 2-4 or feed a fuse layer
    scale by 0.03-0.1 instead: at full w32 depth an undamped random HRNet is
    chaotic, so a one-ulp change of layer1's bf16 output moves the decoded
    joints by pixels (``chip_conditioning.py`` measures it).  Layer1 and the
    head are never damped.  The BN running statistics are then set to the
    statistics of one forward of two random images (made from the same seed;
    for a temporal model two random sequences of its frames, for FTL two
    random samples of its views through ``models.ftl.seeded_cameras``, after
    which FTL's final conv, the end of a decoder without BN, is scaled so its
    logits vary by 2 a plane) on ``device``,
    so every layer sees normalized activations as in a trained net, and the
    statistics sit well away from 0 and 1, which exercises BN folding; a
    net's V2V statistics to those of one forward of a random non-negative
    volume of its ``VOLUME_SIZE``.  CPM has no BN. The fusion net's pair FCs
    are normals of std 1 / sqrt(HW).  Returns CPU tensors.
    """
    from ..models.hrnet import hrnet_from_cfg
    from ..models.multiview_hrnet import Aggregation
    from ..models.registry import build_model
    from ..models.triangulation import build_triangulation_net

    rng = np.random.default_rng(seed)
    name = str(cfg.MODEL.NAME)
    if net is not None:
        model = build_triangulation_net(cfg, net, dtype=torch.float32)
        backbone = model.backbone
    elif name in ("CPM", "multiview_pose_hrnet"):
        model = build_model(cfg)
        backbone = getattr(model, "backbone", model)
    elif name in ZOO_MODELS:
        model = backbone = build_model(cfg)
    elif name in TEMPORAL_MODELS or name == "HourGlass":
        model = build_model(cfg)
        backbone = model
    elif name == "FTL":
        from ..models.ftl import ftl_from_cfg

        # the same state as the registry's net (whose convs run in bf16),
        # its BN statistics taken in float32
        model = backbone = ftl_from_cfg(cfg, dtype=torch.float32)
    else:
        conf = {}
        if str(cfg.MODEL.NAME) == "pose_hrnet_volumetric":
            conf = dict(vol_confidences=bool(cfg.MODEL.VOL_CONFIDENCES),
                        alg_confidences=bool(cfg.MODEL.ALG_CONFIDENCES))
        model = backbone = hrnet_from_cfg(cfg, head="softmax", **conf)
    for mod_name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                            nn.ConvTranspose3d, nn.Linear)):
            # He-scaled; an output of a transposed conv sees (kernel / stride)
            # inputs per axis (each input once where stride = kernel)
            fan_in = (mod.weight.shape[0] * int(np.prod([k // s for k, s in zip(
                mod.kernel_size, mod.stride)]))
                if isinstance(mod, (nn.ConvTranspose2d, nn.ConvTranspose3d))
                else mod.weight[0].numel())
            mod.weight.copy_(torch.from_numpy(
                rng.normal(0.0, np.sqrt(2.0 / fan_in), mod.weight.shape).astype(np.float32)))
            if mod.bias is not None:
                mod.bias.copy_(torch.from_numpy(
                    rng.normal(0.0, 0.1, mod.bias.shape).astype(np.float32)))
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, mod.weight.shape).astype(np.float32)))
            mod.bias.copy_(torch.from_numpy(
                rng.normal(0.0, 0.1, mod.bias.shape).astype(np.float32)))
        elif isinstance(mod, nn.BatchNorm2d):
            lo, hi = (0.03, 0.1) if damp and _DAMPED_BN.search(mod_name) else (0.5, 1.5)
            mod.weight.copy_(torch.from_numpy(
                rng.uniform(lo, hi, mod.weight.shape).astype(np.float32)))
            mod.bias.copy_(torch.from_numpy(
                rng.normal(0.0, 0.1, mod.bias.shape).astype(np.float32)))
    for mod in model.modules():
        if isinstance(mod, Aggregation):
            mod.pair_fc.copy_(torch.from_numpy(rng.normal(
                0.0, 1.0 / np.sqrt(mod.pair_fc.shape[-1]), mod.pair_fc.shape).astype(np.float32)))
    for pname, tensor in list(model.named_parameters()) + list(model.named_buffers()):
        leaf = pname.rsplit(".", 1)[-1]
        if leaf in ("rel_pos_bias", "spatial_pos", "temporal_pos"):
            tensor.copy_(torch.from_numpy(rng.normal(0.0, 0.02, tensor.shape).astype(np.float32)))
        elif leaf.startswith("deform_kernel") or leaf == "frame_weights":
            fan_in = int(np.prod(tensor.shape[:-1]))
            tensor.copy_(torch.from_numpy(
                rng.normal(0.0, np.sqrt(2.0 / fan_in), tensor.shape).astype(np.float32)))
        elif leaf in ("keypoint_tokens", "bases"):
            tensor.copy_(torch.from_numpy(rng.uniform(0.0, 1.0, tensor.shape).astype(np.float32)))
    h, w = (int(s) for s in cfg.MODEL.IMAGE_SIZE[::-1])
    frames = ((len(list(cfg.DATASET.SEQ_IDX)),) if name in TEMPORAL_MODELS
              else (int(cfg.DATASET.NUM_VIEWS),) if name == "FTL" else ())
    images = torch.from_numpy(rng.normal(size=(2, *frames, h, w, 3)).astype(np.float32))
    model = model.to(device)
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.train()
            mod.momentum = 1.0       # running stats := this batch's stats
    if name == "FTL" and net is None:
        from ..models.ftl import seeded_cameras

        extr, intr = seeded_cameras(2, frames[0], w, seed)
        seen = []
        hook = model.final_layer.register_forward_hook(lambda m, a, out: seen.append(out))
        model(images.to(device), extr.to(device), intr.to(device))
        hook.remove()
        # FTL's decoder has no BN: its final conv is scaled so the logits
        # vary by 2 a plane on these inputs, as a trained head's do
        gain = 2.0 / float(seen[0].std(dim=(2, 3)).mean())
        model.final_layer.weight.mul_(gain)
        model.final_layer.bias.mul_(gain)
    elif any(isinstance(m, nn.BatchNorm2d) for m in backbone.modules()):
        backbone(images.to(device))
    if net in ("vol", "vol_CPM"):
        s = int(cfg.MODEL.VOLUME_SIZE)
        model.volume_net(torch.from_numpy(np.abs(rng.normal(size=(1, s, s, s, 32))).astype(
            np.float32)).to(device))
    model.eval()
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.num_batches_tracked.zero_()
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}
