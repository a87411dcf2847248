"""The port's 'model' mesh axis in one process (``parallel/tensor_parallel.row_replicas``)
against the JAX package's on its (4, 2) mesh of CPU host devices.

- ``Evaluator2D`` on ``make_mesh(("data", "model"), (4, 2), ["cpu"] * 8)``:
  every metric as close to JAX's evaluator on its (4, 2) mesh as the
  unsplit evaluators are to each other (tests/test_torch_evaluator.py,
  float32: 1e-5 relative), and to the port's data-only (4,) mesh within
  1e-6; the logits (the maps B4 decodes) and the coordinates of a row's
  split model against the unsplit model's; each shard's shape and device;
- ``Evaluator3D`` on the same mesh with the tiny alg net (model mode),
  within tests/test_torch_sharding3d.py's limits of JAX's on its (4, 2)
  mesh and 1e-6 of the port's data-only mesh;
- ``make_quant_infer(mesh=(4, 2))`` replicates over 'model' as JAX's
  ``shard_map`` does: bit-equal to the port's data-only mesh.

The tiny config keeps layer1's 256-wide convs, which JAX splits at a
model size of 2 (tests/test_torch_tp_shardings.py).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from hrnet_hand_pose_estimation_tpu.core.evaluator import Evaluator2D as JaxEvaluator2D
from hrnet_hand_pose_estimation_tpu.core.evaluator3d import Evaluator3D as JaxEvaluator3D
from hrnet_hand_pose_estimation_tpu.data.build import make_dataloader as jax_make_dataloader
from hrnet_hand_pose_estimation_tpu.data.build import make_test_dataloader as jax_loaders
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core import quant_infer as Q
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator3d import Evaluator3D
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import precast_variables
from hrnet_hand_pose_estimation_tpu_torch.data.build import make_test_dataloader
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.triangulation import build_triangulation_net
from hrnet_hand_pose_estimation_tpu_torch.parallel import tensor_parallel as TP
from hrnet_hand_pose_estimation_tpu_torch.parallel.mesh import make_mesh, param_shardings
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from test_torch_evaluator import RESULT_KEYS, eval_cfg
from test_torch_evaluator3d import KEYS_2D, KEYS_3D, eval3d_cfg, jax_side
from test_torch_quant_infer import NORM, normalized
from test_torch_sharding import variables  # noqa: F401 (fixture)
from tests.test_torch_triangulation import jax_eigh64  # noqa: F401 (fixture)
from torch_tp_toy import COMPUTED, SPLIT, Toy, toy_input

torch.set_num_threads(1)
CPU8 = ["cpu"] * 8


def grid():
    return make_mesh(("data", "model"), (4, 2), CPU8)


def data_only():
    return make_mesh(("data",), (4,), ["cpu"] * 4)


def jax_grid():
    return JaxMesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))


def test_row_replicas_hold_the_shards(tiny_cfg, variables):
    """Each data row's model keeps shard j of every split weight on its
    model device j (half the output channels each), its bias whole; the
    other leaves whole on the row's first device; the unsplit model stays
    whole.  A row's logits and decoded coordinates equal the unsplit
    model's (float32)."""
    cfg = config_from_dict(eval_cfg(tiny_cfg, TPU__COMPUTE_DTYPE="float32").to_dict())
    model = build_model(cfg)
    model.load_state_dict(from_jax_variables(variables))
    model.eval()
    mesh = grid()
    split = {n: d for n, d in param_shardings(mesh, model).items() if d is not None}
    reps = TP.row_replicas(mesh, model)
    assert len(reps) == 4 and len(split) == 5
    full = dict(model.named_parameters())
    for rep, row in zip(reps, mesh.rows()):
        for name, dim in split.items():
            # a conv of the split computes its shards (not a gathered weight)
            assert isinstance(rep.get_submodule(name.rpartition(".")[0]), TP._Split), name
            shards = TP.shards_of(rep, name)
            assert [s.device for s in shards] == list(row)
            assert [s.shape[dim] for s in shards] == [full[name].shape[dim] // 2] * 2
            assert torch.equal(torch.cat(shards, dim), full[name])
        assert TP.position_bytes(rep)[1] == sum(full[n].numel() * 2 for n in split)
    assert all(p.shape == full[n].shape for n, p in model.named_parameters())
    images = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        want, temp = model.forward_logits(images)
        got, temp_r = reps[1].forward_logits(images)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    ev = Evaluator2D(cfg, model, mesh=mesh, device="cpu")
    batch = images.repeat(2, 1, 1, 1)
    np.testing.assert_allclose(ev.forward(batch).numpy(),
                               Evaluator2D(cfg, model, device="cpu").forward(batch).numpy(),
                               atol=1e-5)


def test_evaluator2d_grid_matches_data_mesh_and_jax(tiny_cfg, variables):
    """Evaluator2D (std, float32) on the (4, 2) grid: every metric within
    1e-6 relative of the port's data-only (4,) mesh and within 1e-5 of
    JAX's evaluator on its (4, 2) mesh, which splits the same leaves."""
    jcfg = eval_cfg(tiny_cfg, TPU__COMPUTE_DTYPE="float32")
    cfg = config_from_dict(jcfg.to_dict())
    results = {}
    for name, mesh in (("data", data_only()), ("grid", grid())):
        ev = Evaluator2D(cfg, build_model(cfg), from_jax_variables(variables), mesh=mesh,
                         device="cpu")
        results[name] = ev.run(make_test_dataloader(cfg)["Synthetic_kpt"], "Synthetic")
    assert len(ev._replicas) == 4
    jax_ev = JaxEvaluator2D(jcfg, jax_build_model(jcfg), variables, mesh=jax_grid())
    want = jax_ev.run(jax_make_dataloader(jcfg, is_train=False, n_devices=1)["Synthetic_kpt"],
                      "Synthetic")
    for key in RESULT_KEYS:
        assert results["grid"][key] == pytest.approx(results["data"][key], rel=1e-6), key
        assert results["grid"][key] == pytest.approx(want[key], rel=1e-5), key


def test_evaluator3d_grid_matches_data_mesh_and_jax(tiny_cfg, jax_eigh64):
    """Evaluator3D (the tiny alg net, model mode) on the (4, 2) grid: within
    1e-6 relative of the port's data-only mesh, the 2D metrics within 1e-4
    and the 3D within 1e-3 relative of JAX's evaluator on its (4, 2) mesh."""
    jcfg = eval3d_cfg(tiny_cfg, "alg").clone()
    jcfg.defrost()
    jcfg.TEST.IMAGES_PER_GPU = 4
    jcfg.freeze()
    jloader = next(iter(jax_loaders(jcfg, n_devices=1).values()))
    jloader.dataset.length = 4
    jmodel, variables = jax_side(jcfg, "model", "alg", jloader)
    want = JaxEvaluator3D(jcfg, jmodel, variables, mode="model", mesh=jax_grid()).run(jloader)

    cfg = config_from_dict(jcfg.to_dict())
    got = {}
    for name, mesh in (("data", data_only()), ("grid", grid())):
        loader = make_test_dataloader(cfg)["Synthetic_mv"]
        loader.dataset.length = 4
        model = build_triangulation_net(cfg, "alg", dtype=torch.float32)
        ev = Evaluator3D(cfg, model, from_jax_variables(variables, model), mode="model",
                         mesh=mesh, device="cpu")
        got[name] = ev.run(loader)
    assert sum(d is not None for d in param_shardings(2, model).values()) == 5
    for key, val in got["data"].items():
        assert got["grid"][key] == pytest.approx(val, rel=1e-6, abs=1e-9), key
    for key in KEYS_2D:
        assert got["grid"][key] == pytest.approx(want[key], rel=1e-4), key
    for key in KEYS_3D:
        assert got["grid"][key] == pytest.approx(want[key], rel=1e-3, abs=1e-6), key


def test_quant_infer_grid_equals_data_mesh(tiny_cfg, variables):
    """``make_quant_infer`` on the (4, 2) grid replicates the weights over
    'model' and runs once a data row: bit-equal to the data-only (4,)
    mesh, and within 1e-5 px of no mesh."""
    u8 = np.random.default_rng(7).integers(0, 256, size=(8, 64, 64, 3)).astype(np.uint8)
    cfg = config_from_dict(tiny_cfg.to_dict())
    state = from_jax_variables(variables)
    weights = precast_variables(cfg, state, device="cpu")
    amax = Q.calibrate(cfg, weights, [torch.from_numpy(normalized(u8))])
    qp = Q.prepare_serving_qparams(cfg, state, amax)
    images = torch.from_numpy(u8)
    on_grid = Q.make_quant_infer(cfg, device="cpu", input_norm=NORM, mesh=grid())(
        weights, qp, images)
    on_data = Q.make_quant_infer(cfg, device="cpu", input_norm=NORM, mesh=data_only())(
        weights, qp, images)
    plain = Q.make_quant_infer(cfg, device="cpu", input_norm=NORM)(weights, qp, images)
    assert on_grid.shape == (8, 21, 2) and torch.equal(on_grid, on_data)
    np.testing.assert_allclose(on_grid.numpy(), plain.numpy(), atol=1e-5)


def test_row_replica_splits_every_kind():
    """tests/torch_tp_toy.py's net on a (1, 2) CPU mesh: a conv with a bias,
    a depthwise conv (its groups with their input channels), a transposed
    conv and a Linear compute their shards; the kept leaf lives in shards
    and is joined at its use, under its own name; the row's output within
    1e-6 of the unsplit net's."""
    toy = Toy()
    mesh = make_mesh(("data", "model"), (1, 2), ["cpu", "cpu"])
    assert {n: d for n, d in param_shardings(mesh, toy).items() if d is not None} == SPLIT
    (rep,) = TP.row_replicas(mesh, toy)
    assert all(isinstance(rep.get_submodule(m), TP._Split) for m in COMPUTED)
    assert sorted(TP.public_name(n) for n, _ in rep.named_parameters()) == sorted(
        n for n, _ in toy.named_parameters())
    assert [s.shape for s in TP.shards_of(rep, "pos")] == [(1, 4, 256)] * 2
    x = toy_input()
    with torch.no_grad():
        np.testing.assert_allclose(rep(x).numpy(), toy(x).numpy(), rtol=0, atol=1e-6)
