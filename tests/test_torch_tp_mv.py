"""The fusion-net step on a data x model grid of ranks: four gloo CPU
ranks as a (2, 2) grid (tests/torch_ddp_cases_child.py, through
``pick_train_step``) against the JAX package's ``make_train_step_mv`` on
its (2, 2) mesh of host devices, the state on ``state_shardings``.

The case, settings and limits are tests/test_torch_ddp_variants.py's: the
tiny fusion net over 2 views, float32, adam at 1e-6, a global batch of 2
samples x 2 views, 2 steps; losses rtol 1e-5, BN statistics rtol 1e-5 +
atol 1e-5, the temperature's and ``pair_fc``'s gradients (adam's first
moment) at 1e-3 of their largest.  The backbone's layer1 convs compute
their shards; ``pair_fc`` (P, HW, HW) with HW = 256 splits on its last dim,
is stored in shards and all-gathered at its use.

JAX's own step parts with itself between its (2,) and its (2, 2) mesh:
its second step's BN statistics move by 5.40 times the limit (measured,
the first step's by 0.11; the losses by 1.3e-4).  So the grid is held to
JAX's (2, 2) steps at the limits on everything but the second step's BN
statistics, and its whole run to the port's own run on two data ranks
(the same case, started beside it): the losses bit-equal, the kept
gradients and statistics at the same limits (they part by float32 steps:
the model group sums the input gradients in another order).  That two-rank run meets JAX's (2,)
mesh at every limit (tests/test_torch_ddp_variants.py).
"""

import pytest
import torch

from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.parallel.mesh import param_shardings
from tests.test_torch_ddp_variants import mv_case, mv_ratio, run_cases
from tests.test_torch_tp_cpm import GRID, grid_agrees
from tests.torch_ddp_cases import allclose_ratio, loss_ratio, tensor_ratio

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tiny_cfg, tmp_path_factory):
    return run_cases(tiny_cfg, tmp_path_factory.mktemp("tp_mv"), ("mv",), GRID,
                     also=tmp_path_factory.mktemp("tp_mv_data"))


def test_mv_splits(tiny_cfg):
    split = {n: d for n, d in param_shardings(2, build_model(mv_case(tiny_cfg)[1])).items()
             if d is not None}
    assert split["aggregation.pair_fc"] == 2
    assert any(n.startswith("backbone.layer1.") for n in split)


def test_grid_matches_jax_spmd_step(runs):
    """Every rank against JAX's (2, 2) steps: the first step whole, the
    second's losses; and against the port's two data ranks, whole."""
    ranks, ref, data_only = runs
    for r in ranks:
        run = r["mv"]["global"]
        first = mv_ratio({"steps": run["steps"][:1]}, ref["mv"][:1])
        second = loss_ratio(run["steps"][1]["losses"], ref["mv"][1]["losses"], 1e-5)
        print(f"mv on the grid: step 1 at {first:.3g}, step 2's losses at {second:.3g} of "
              f"the limits")
        assert first <= 1.0 and second <= 1.0
        for got, want in zip(run["steps"], data_only[0]["mv"]["global"]["steps"]):
            assert got["losses"] == want["losses"]
            assert allclose_ratio(got["batch_stats"], want["batch_stats"], 1e-5, 1e-5) <= 1.0
            assert tensor_ratio(got["mu"], want["mu"], 1e-3) <= 1.0


def test_grid_ranks_agree(runs):
    grid_agrees(runs[0], "mv")
