"""The port's data parallelism in one process (``parallel/mesh.py``) and
its per-rank loader slices, against the JAX package's.

- ``make_mesh`` / ``shard_batch`` refuse what JAX refuses: a shape that
  does not cover the devices, a batch that does not divide the 'data' axis
  (``shard_map``'s error); a 'model' axis is taken (tests/test_torch_tp_eval.py);
- ``make_quant_infer(mesh=two CPU replicas)`` against the port without a
  mesh and against JAX's ``make_quant_infer(mesh=Mesh(devices[:2]))``
  (built directly: JAX's ``make_mesh`` takes all 8 of conftest's host
  devices);
- ``Evaluator2D(mesh=)`` against the port without a mesh and against
  JAX's evaluator on a 2-device mesh, std and int8;
- ``DataLoader``'s per-rank slices against JAX's ``host_local_slice`` with
  ``jax.process_index`` / ``process_count`` patched (tests/test_data.py:114).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from hrnet_hand_pose_estimation_tpu.core import quant_infer as JQ
from hrnet_hand_pose_estimation_tpu.core.evaluator import Evaluator2D as JaxEvaluator2D
from hrnet_hand_pose_estimation_tpu.data import pipeline as jax_pipeline
from hrnet_hand_pose_estimation_tpu.data.build import make_dataloader as jax_make_dataloader
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core import quant_infer as Q
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import precast_variables
from hrnet_hand_pose_estimation_tpu_torch.data.build import make_test_dataloader
from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import DataLoader, host_local_slice
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.conv_int8 import conv_int8
from hrnet_hand_pose_estimation_tpu_torch.parallel import distributed
from hrnet_hand_pose_estimation_tpu_torch.parallel.mesh import (gather, make_mesh, replicate,
                                                                shard_batch)
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from test_torch_evaluator import RESULT_KEYS, eval_cfg
from test_torch_quant_infer import NORM, normalized

torch.set_num_threads(1)
CPU2 = ["cpu", "cpu"]


def jax_mesh2():
    return JaxMesh(np.array(jax.devices()[:2]), ("data",))


@pytest.fixture(scope="module")
def variables(tiny_cfg):
    """tests/test_quant_infer.py's activated recipe filled by leaf from
    ``eval_shape`` (its eager init costs ~35 s here): kernels He-scaled
    normals at gain 1.0 (at 1.4 these draws are chaotic in bf16, and the
    two frameworks' roundings part the int8 decode by 1.6 px; the C26
    precedent, tests/test_torch_accuracy_gate.py), BN scales 1 + 0.2 N(0, 1), biases 0.05 N(0, 1),
    running statistics 0 and 1, temperature 2."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jax_build_model(tiny_cfg).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), False))

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0.0, 1.0 / np.sqrt(fan_in), s.shape).astype(np.float32)
        if leaf == "scale":
            return (1.0 + 0.2 * rng.standard_normal(s.shape)).astype(np.float32)
        if leaf == "bias":
            return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)
        if leaf == "trainable_temp":
            return np.full(s.shape, 2.0, np.float32)
        return (np.ones if leaf == "var" else np.zeros)(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_make_mesh_and_shard_batch_refuse_what_jax_refuses():
    mesh = make_mesh(devices=CPU2)
    assert mesh.size == 2 and mesh.shape == (2,) and mesh.axes == ("data",)
    assert make_mesh(("data", "model"), (2, 1), CPU2).shape == (2, 1)
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(("data",), (4,), CPU2)
    assert make_mesh(("data", "model"), (1, 2), CPU2).model_size == 2
    with pytest.raises(ValueError, match="'data' axis"):
        make_mesh(("batch",), (), CPU2)
    x = torch.arange(12.0).reshape(6, 2)
    parts = shard_batch(mesh, {"x": x, "name": "a"})
    assert [p["x"].shape[0] for p in parts] == [3, 3] and parts[1]["name"] == "a"
    assert torch.equal(gather(mesh, [p["x"] for p in parts]), x)
    assert gather(mesh, [(p["x"], None) for p in parts])[1] is None
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(mesh, torch.zeros(5, 2))
    # JAX's shard_map refuses the same batch
    sharded = jax.jit(jax.shard_map(lambda a: a * 2, mesh=jax_mesh2(),
                                    in_specs=jax.sharding.PartitionSpec("data"),
                                    out_specs=jax.sharding.PartitionSpec("data")))
    with pytest.raises(ValueError):
        sharded(jnp.zeros((5, 2)))
    model = torch.nn.Linear(2, 2)
    reps = replicate(mesh, {"m": model, "t": (x, 3)})
    assert reps[0]["m"] is model and reps[1]["t"][0] is x and reps[1]["t"][1] == 3


def test_quant_infer_mesh_matches_no_mesh_and_jax(tiny_cfg, variables):
    """The shipped int8 path (uint8 in) on two CPU replicas: within 1e-5 px
    of the port without a mesh (the same twins on half the batch; the CPU's
    convs round by batch size, measured 9.5e-7 px), within the slice's 0.05
    px of JAX's shard_map over a 2-device mesh (tests/test_torch_quant_infer.py's
    tolerance)."""
    v = variables
    u8 = np.random.default_rng(7).integers(0, 256, size=(4, 64, 64, 3)).astype(np.uint8)
    amax = JQ.calibrate(tiny_cfg, v, [normalized(u8)])
    want = np.asarray(JQ.make_quant_infer(tiny_cfg, interpret=True, pallas_layer1=False,
                                          input_norm=NORM, mesh=jax_mesh2())(
        v, JQ.prepare_serving_qparams(tiny_cfg, v, amax), jnp.asarray(u8)))

    cfg = config_from_dict(tiny_cfg.to_dict())
    state = from_jax_variables(v)
    weights = precast_variables(cfg, state, device="cpu")
    qp = Q.prepare_serving_qparams(cfg, state, amax)
    images = torch.from_numpy(u8)
    plain = Q.make_quant_infer(cfg, device="cpu", input_norm=NORM)(weights, qp, images)
    sharded = Q.make_quant_infer(cfg, device="cpu", input_norm=NORM, mesh=make_mesh(devices=CPU2))
    got = sharded(weights, qp, images)
    assert got.shape == (4, 21, 2)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)
    assert torch.equal(sharded(weights, qp, images), got)          # the replicas, reused
    assert want.std() > 0.2
    np.testing.assert_allclose(got.numpy(), want, atol=0.05)
    with pytest.raises(ValueError, match="does not divide"):
        sharded(weights, qp, images[:3])


@pytest.mark.parametrize("serving", ["std", "int8"])
def test_evaluator2d_mesh_matches_no_mesh_and_jax(tiny_cfg, variables, serving):
    """Evaluator2D over two CPU replicas: every metric within 1e-6
    relative of the port's without a mesh, and as close to JAX's evaluator
    on a 2-device mesh as the unsharded evaluators are to each other
    (tests/test_torch_evaluator.py: float32 std to 1e-5 relative; int8, bf16
    convs, 0.25 px of EPE and 0.02 of the AUCs)."""
    jcfg = eval_cfg(tiny_cfg, **({"TPU__COMPUTE_DTYPE": "float32"} if serving == "std" else {}))
    cfg = config_from_dict(jcfg.to_dict())
    results = {}
    for name, mesh in (("plain", None), ("mesh", make_mesh(devices=CPU2))):
        ev = Evaluator2D(cfg, build_model(cfg), from_jax_variables(variables), mesh=mesh,
                         serving=serving, device="cpu")
        before = conv_int8.launches
        results[name] = ev.run(make_test_dataloader(cfg)["Synthetic_kpt"], "Synthetic")
        assert conv_int8.launches == before                 # the CPU runs the twins
    jax_ev = JaxEvaluator2D(jcfg, jax_build_model(jcfg), variables, mesh=jax_mesh2(),
                            serving=serving)
    want = jax_ev.run(jax_make_dataloader(jcfg, is_train=False, n_devices=1)["Synthetic_kpt"],
                      "Synthetic")
    for key in RESULT_KEYS:
        assert results["mesh"][key] == pytest.approx(results["plain"][key], rel=1e-6), key
    if serving == "std":
        for key in RESULT_KEYS:
            assert results["mesh"][key] == pytest.approx(want[key], rel=1e-5), key
    else:
        assert abs(results["mesh"]["EPE_px"] - want["EPE_px"]) <= 0.25
        for key in ("PCK_AUC_30", "PCK_AUC_full"):
            assert abs(results["mesh"][key] - want[key]) <= 0.02, key


@pytest.mark.parametrize("n,world", [(64, 2), (66, 4), (10, 3)])
def test_loader_slices_match_jax_host_local_slice(monkeypatch, n, world):
    """Each rank's epoch order is JAX's host_local_slice of the same seeded
    global order (the port's rank / world size and JAX's process index /
    count patched, as tests/test_data.py patches JAX's), the ranks' slices are disjoint and cover the first world * (n //
    world) of that order, and len() is the rank's."""
    class Numbers:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"i": np.asarray(i)}

    order = np.arange(n)
    np.random.default_rng((5, 3)).shuffle(order)
    seen = []
    for r in range(world):
        loader = DataLoader(Numbers(), batch_size=2, num_workers=0, seed=5)
        loader.set_epoch(3)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(distributed, "rank", lambda r=r: r)
        monkeypatch.setattr(distributed, "world_size", lambda: world)
        jloader = jax_pipeline.DataLoader(Numbers(), batch_size=2, num_workers=0, seed=5)
        jloader.set_epoch(3)
        got = loader._index_order()
        np.testing.assert_array_equal(got, jloader._index_order())
        np.testing.assert_array_equal(got, host_local_slice(order, r, world))
        assert len(loader) == len(jloader) == (n // world) // 2
        assert [int(i) for b in loader for i in b["i"]] == got[:len(loader) * 2].tolist()
        seen += got.tolist()
    per = n // world
    assert sorted(seen) == sorted(order[:world * per].tolist())
    monkeypatch.undo()
    single = DataLoader(Numbers(), batch_size=2, num_workers=0, seed=5)
    single.set_epoch(3)
    np.testing.assert_array_equal(single._index_order(), order)
