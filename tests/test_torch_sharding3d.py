"""``Evaluator3D(mesh=)`` over two CPU replicas against the port without a
mesh and against the JAX package's evaluator on a 2-device mesh
(``Mesh(devices[:2])``, built directly), in model mode (the alg net) and
dlt mode, on tests/test_torch_evaluator3d.py's set-up (Synthetic_mv, 4
samples of 2 views, float32, JAX's eigh in float64) and limits."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from hrnet_hand_pose_estimation_tpu.core.evaluator3d import Evaluator3D as JaxEvaluator3D
from hrnet_hand_pose_estimation_tpu.data.build import make_test_dataloader as jax_loaders
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator3d import Evaluator3D
from hrnet_hand_pose_estimation_tpu_torch.data.build import make_test_dataloader
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.triangulation import build_triangulation_net
from hrnet_hand_pose_estimation_tpu_torch.parallel.mesh import make_mesh
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from test_torch_evaluator3d import KEYS_2D, KEYS_3D, eval3d_cfg, jax_side
from tests.test_torch_triangulation import jax_eigh64  # noqa: F401 (fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["model", "dlt"])
def test_evaluator3d_mesh_matches_no_mesh_and_jax(tiny_cfg, jax_eigh64, mode):
    """Every metric within 1e-6 relative of the port without a mesh; the 2D
    metrics within 1e-4 and the 3D within 1e-3 relative of JAX's evaluator
    on its mesh (tests/test_torch_evaluator3d.py's limits)."""
    jcfg = eval3d_cfg(tiny_cfg, "alg")
    jloader = next(iter(jax_loaders(jcfg, n_devices=1).values()))
    jloader.dataset.length = 4
    jmodel, variables = jax_side(jcfg, mode, "alg", jloader)
    want = JaxEvaluator3D(jcfg, jmodel, variables, mode=mode,
                          mesh=JaxMesh(np.array(jax.devices()[:2]), ("data",))).run(jloader)

    cfg = config_from_dict(jcfg.to_dict())
    got = {}
    for name, mesh in (("plain", None), ("mesh", make_mesh(devices=["cpu", "cpu"]))):
        loader = make_test_dataloader(cfg)["Synthetic_mv"]
        loader.dataset.length = 4
        model = (build_model(cfg) if mode == "dlt"
                 else build_triangulation_net(cfg, "alg", dtype=torch.float32))
        ev = Evaluator3D(cfg, model, from_jax_variables(variables, model), mode=mode, mesh=mesh,
                         device="cpu")
        got[name] = ev.run(loader)
    assert set(got["mesh"]) == set(want)
    for key, val in got["plain"].items():
        assert got["mesh"][key] == pytest.approx(val, rel=1e-6, abs=1e-9), key
    for key in KEYS_2D:
        assert got["mesh"][key] == pytest.approx(want[key], rel=1e-4), key
    for key in KEYS_3D:
        assert got["mesh"][key] == pytest.approx(want[key], rel=1e-3, abs=1e-6), key
