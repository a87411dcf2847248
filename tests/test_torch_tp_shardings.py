"""The port's split map over a 'model' axis (``parallel/mesh.param_shardings``,
``parallel/train_step.state_shardings``) against the JAX package's, and the
mesh and grid shapes both refuse.

Every case works on shapes alone: JAX's variables come from
``jax.eval_shape`` of the model's init, and its ``param_shardings`` on a
(data, model) mesh of the host devices marks the leaves it splits.  Each
JAX leaf is filled with 1 + its index along its last axis where JAX splits
it and with zeros elsewhere, and the weight bridge (``from_jax_variables``)
carries it into the port: a split leaf lands on the one port tensor whose
values run along one dim, the dim the port must split.  The port's map
must name the same tensors with the same dims.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import hrnet_hand_pose_estimation_tpu.parallel.mesh as jax_mesh
import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu.config import load_config as jax_load_config
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu.models.triangulation import (
    build_triangulation_net as jax_build_net)
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict, load_config
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.triangulation import build_triangulation_net
from hrnet_hand_pose_estimation_tpu_torch.parallel import distributed
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.parallel.mesh import make_mesh, param_shardings
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from torch_zoo_parity import zoo_cfgs

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(REPO, "experiments")
YAMLS = {
    "w32": "RHD/RHD_w32_256x256_adam_lr1e-3.yaml",
    "w48": "RHD/RHD_HRNet_w48_trainable_softmax_hm-pose2dloss_v1.yaml",
    "swin": "RHD/RHD_SwinTransformer_trainable_softmax_pose2dloss_v1.yaml",
    "pose_aggr": "MHP/MHP_HRNet_w32_trainable_softmax_pose2dloss_PoseAggr_v1.yaml",
    "pose_former": "MHP/MHP_HRNet_w32_trainable_softmax_pose2dloss_PoseFormer_v1.yaml",
    "vol": "LearnableTriangulation/VolTriangulation_v1.yaml",
}
# SimpleBaseline at its published widths: ResNet-50, three 256-wide deconvs
SIMPLE_BASELINE = {"NUM_LAYERS": 50, "NUM_DECONV_LAYERS": 3, "NUM_DECONV_FILTERS": [256] * 3}
_CACHE = {}


def _init_shapes(jm, *args):
    return jax.eval_shape(lambda: jm.init({"params": jax.random.key(0),
                                           "aug": jax.random.key(1)}, *args))


def models(name, tiny_cfg):
    """(JAX variable shapes, port model) of case ``name``, built once."""
    if name in _CACHE:
        return _CACHE[name]
    if name == "tiny":
        jcfg, pcfg = tiny_cfg, config_from_dict(tiny_cfg.to_dict())
    elif name == "simple_baseline":
        jcfg, pcfg = zoo_cfgs(tiny_cfg, "pose_resnet")
        for cfg in (jcfg, pcfg):
            cfg.defrost()
            cfg.MODEL.EXTRA.merge_from_mapping(SIMPLE_BASELINE)
            cfg.freeze()
    else:
        path = os.path.join(EXP, YAMLS[name])
        jcfg, pcfg = jax_load_config(path), load_config(path)
    h, w = (int(s) for s in jcfg.MODEL.IMAGE_SIZE[::-1])
    if name == "vol":
        jm = jax_build_net(jcfg, "vol")
        proj = jnp.tile(jnp.eye(3, 4), (1, 2, 1, 1))
        shapes = _init_shapes(jm, jnp.zeros((1, 2, h, w, 3)), proj, False)
        port = build_triangulation_net(pcfg, "vol")
    else:
        frames = {"pose_aggr": 5, "pose_former": 9}.get(name)
        images = jnp.zeros((1, h, w, 3) if frames is None else (1, frames, 64, 64, 3))
        jm = jax_build_model(jcfg)
        shapes = _init_shapes(jm, images, False)
        port = build_model(pcfg)
    _CACHE[name] = (dict(shapes), port)
    return _CACHE[name]


def jax_split_map(shapes, model_size):
    """{port name: port dim} of the leaves JAX splits over a model axis of
    ``model_size``, carried through the bridge."""
    devices = jax.devices()[:model_size * (8 // model_size)]
    mesh = Mesh(np.array(devices).reshape(-1, model_size), ("data", "model"))
    specs = jax_mesh.param_shardings(mesh, shapes["params"])
    split = jax.tree.map(lambda s: "model" in tuple(s.spec), specs)

    def fill(s, is_split):
        if not is_split:
            return np.zeros(s.shape, np.float32)
        return np.broadcast_to(1.0 + np.arange(s.shape[-1], dtype=np.float32), s.shape).copy()

    tagged = {coll: (jax.tree.map(fill, tree, split) if coll == "params"
                     else jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree))
              for coll, tree in shapes.items()}
    out = {}
    for name, val in from_jax_variables(tagged).items():
        if not val.abs().sum():
            continue
        dims = [d for d in range(val.dim()) if val.shape[d] > 1
                and not torch.equal(val, val.narrow(d, 0, 1).expand_as(val))]
        assert len(dims) == 1, (name, dims)
        ramp = 1.0 + torch.arange(val.shape[dims[0]], dtype=torch.float32)
        assert torch.equal(val.movedim(dims[0], -1)[(0,) * (val.dim() - 1)], ramp), name
        out[name] = dims[0]
    n_split = sum(jax.tree.leaves(split))
    assert len(out) == n_split
    return out


CASES = ["tiny", "w32", "w48", "simple_baseline", "swin", "vol", "pose_aggr", "pose_former"]


@pytest.mark.parametrize("model_size", [2, 3, 4])
@pytest.mark.parametrize("name", CASES)
def test_split_map_matches_jax(tiny_cfg, name, model_size):
    """The port's ``param_shardings`` names JAX's split leaves, each with the
    port-side dim the bridge's conversion gives it, and no other."""
    shapes, port = models(name, tiny_cfg)
    want = jax_split_map(shapes, model_size)
    got = param_shardings(model_size, port)
    assert set(got) == {n for n, _ in port.named_parameters()}
    assert {n: d for n, d in got.items() if d is not None} == want
    if name == "tiny":
        # layer1's 256-wide convs, which 3 does not divide
        assert all(n.startswith("layer1.") for n in want) and bool(want) == (model_size != 3)
    if name == "w32" and model_size != 3:
        params = dict(port.named_parameters())
        assert len(want) == 40 and len(got) == 921
        assert sum(params[n].numel() for n in want) == 16_311_296
        assert "last_layer.0.weight" in want                          # the head's 480 -> 480


def test_split_map_reaches_every_layout(tiny_cfg):
    """Across the cases the split dims cover the bridge's layouts: a conv's
    and a Linear's dim 0, a transposed conv's dim 1 (SimpleBaseline's
    deconvs), and a leaf kept in JAX's layout on its last dim (PoseFormer's
    temporal position embedding).  V2V's 3D kernels are at most 128 wide
    at the YAML's widths: none splits, in JAX as in the port."""
    seen = {}
    for name in ("simple_baseline", "vol", "pose_former", "swin"):
        shapes, port = models(name, tiny_cfg)
        for n, d in param_shardings(2, port).items():
            if d is not None:
                seen.setdefault((dict(port.named_parameters())[n].dim(), d), n)
    assert {(4, 0), (4, 1), (3, 2), (2, 0)} <= set(seen), sorted(seen)
    assert not any(d == 5 for d, _ in seen)


class _Twins(torch.nn.Module):
    """A conv whose weight splits and a transposed conv of the same port
    shape (256, 64, 1, 1) whose weight does not (its JAX kernel's last dim
    is 64)."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(64, 256, 1, bias=False)
        self.deconv1 = torch.nn.ConvTranspose2d(256, 64, 1, bias=False)


def test_state_shardings_follow_the_params(tiny_cfg):
    """The counterpart of tests/test_engine_fixes.py's state_shardings check:
    adam's moments split as their parameters do, by name, so a replicated
    leaf of a split leaf's shape keeps replicated moments; the step counter,
    the optimizer counts and the BN statistics are replicated; the tiny
    HRNet's moments split on the leaves JAX's ``state_shardings`` splits on
    its (4, 2) mesh."""
    twins = _Twins()
    assert twins.conv.weight.shape == twins.deconv1.weight.shape
    tx = TS.Optimizer("adam", lambda count: torch.ones(()))
    sh = TS.state_shardings(2, TS.TrainState(twins, tx))
    assert sh["params"] == {"conv.weight": 0, "deconv1.weight": None}
    assert sh["opt_state"]["mu"] == sh["opt_state"]["nu"] == sh["params"]

    pcfg = config_from_dict(tiny_cfg.to_dict())
    pcfg.defrost()
    pcfg.TRAIN.OPTIMIZER = "adam"
    pcfg.freeze()
    state, _ = TS.create_train_state(pcfg, build_model(pcfg), device="cpu")
    sh = TS.state_shardings(2, state)
    assert sh["step"] is None and set(sh["batch_stats"].values()) == {None}
    assert sh["opt_state"]["count"] is None and sh["opt_state"]["sched_count"] is None
    assert sh["opt_state"]["mu"] == sh["opt_state"]["nu"] == sh["params"]
    split = {n for n, d in sh["params"].items() if d is not None}
    shapes, _ = models("tiny", tiny_cfg)
    jstate = jax.eval_shape(lambda: jax_ts.TrainState(
        step=jnp.zeros((), jnp.int32), params=shapes["params"],
        batch_stats=shapes["batch_stats"],
        opt_state=jax_ts.make_optimizer(tiny_cfg).init(shapes["params"])))
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    jsh = jax_ts.state_shardings(mesh, jstate)
    mu_split = [("model" in tuple(s.spec)) for s in jax.tree.leaves(jsh.opt_state[0].mu)]
    assert sum(mu_split) == len(split) == 5
    assert jsh.step.spec == jax.sharding.PartitionSpec()


def test_mesh_and_grid_refuse_uncovered_shapes():
    """``make_mesh`` accepts a model axis and refuses a shape that does not
    cover its devices; ``distributed.grid_shape`` (the Trainer's grid and
    ``tool_mesh``'s rule) refuses one that does not cover the world."""
    mesh = make_mesh(("data", "model"), (4, 2), ["cpu"] * 8)
    assert (mesh.data_size, mesh.model_size) == (4, 2)
    assert [len(r) for r in mesh.rows()] == [2] * 4
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(("data", "model"), (2, 2), ["cpu"] * 8)
    with pytest.raises(ValueError, match="data-major"):
        make_mesh(("model", "data"), (2, 4), ["cpu"] * 8)
    assert distributed.grid_shape(("data", "model"), (2, 2), world=4) == (2, 2)
    assert distributed.grid_shape(("data",), (), world=4) == (4, 1)
    with pytest.raises(ValueError, match="does not cover"):
        distributed.grid_shape(("data", "model"), (2, 2), world=2)
    with pytest.raises(ValueError, match="'data' and 'model'"):
        distributed.grid_shape(("data", "x"), (2, 2), world=4)
