"""The CPM step on a data x model grid of ranks: four gloo CPU ranks as a
(2, 2) grid (run by tests/torch_ddp_cases_child.py, through the 2D
Trainer's ``pick_train_step``) against the JAX package's
``make_train_step_cpm`` on its (2, 2) mesh of host devices, the state on
``state_shardings`` (the fusion net: tests/test_torch_tp_mv.py).

The case, settings and limit are tests/test_torch_ddp_cpm.py's: CPM at
64/8, float32, adam at an LR of 1e-6, a global batch of 4, 2 steps, the
loss at rtol 1e-5.  CPM's 512-wide convs split over the model axis and
compute their shards.  Ranks of one model index end bit-equal, and every
rank's losses are rank 0's.
"""

import pytest
import torch

from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.parallel.mesh import param_shardings
from tests.test_torch_ddp_variants import cpm_case, run_cases
from tests.torch_ddp_cases import bit_equal, loss_ratio

torch.set_num_threads(1)
GRID = (2, 2)


@pytest.fixture(scope="module")
def runs(tiny_cfg, tmp_path_factory):
    return run_cases(tiny_cfg, tmp_path_factory.mktemp("tp_cpm"), ("cpm",), GRID)


def grid_agrees(ranks, name: str) -> None:
    """Ranks 0 and 2 (model index 0) and 1 and 3 (model index 1) end with
    bit-equal states (their digests), the two model indices with different
    ones; every rank's losses and kept sections are rank 0's."""
    steps = [r[name]["global"]["steps"] for r in ranks]
    digests = [[s["digest"] for s in run] for run in steps]
    assert digests[0] == digests[2] and digests[1] == digests[3]
    assert digests[0] != digests[1]
    strip = lambda run: [{k: v for k, v in s.items() if k != "digest"} for s in run]
    for run in steps[1:]:
        assert bit_equal(strip(run), strip(steps[0]))


def test_cpm_splits(tiny_cfg):
    split = {n for n, d in param_shardings(2, build_model(cpm_case(tiny_cfg)[1])).items()
             if d is not None}
    assert split and all(n.endswith(".weight") for n in split)


def test_grid_matches_jax_spmd_step(runs):
    ranks, ref = runs[:2]
    for r in ranks:
        got = max(loss_ratio(g["losses"], w["losses"], 1e-5)
                  for g, w in zip(r["cpm"]["global"]["steps"], ref["cpm"]))
        print(f"cpm on the grid: at {got:.3g} of its limit")
        assert got <= 1.0


def test_grid_ranks_agree(runs):
    grid_agrees(runs[0], "cpm")
