"""The port's data-parallel CPM step: two gloo CPU ranks (run by the
JAX-free tests/torch_ddp_cases_child.py, through the 2D Trainer's
``pick_train_step``) against the JAX package's ``make_train_step_cpm``,
jitted with the state replicated and the batch sharded over
``Mesh(devices[:2], ('data',))`` (tests/test_torch_ddp_variants.py's
harness).

The net and settings are tests/test_torch_cpm.py's (CPM at 64/8, float32,
adam), a global batch of 4, 2 a rank, 2 steps at an LR of 1e-6, held at
that file's limit: the loss at rtol 1e-5.  The ranks are bit-equal.  CPM
has no BN and its one loss divides by B*K, equal on every rank, so both
per-rank witnesses would be its data-parallel run bit for bit: none is
run.
"""

import pytest
import torch

from tests.test_torch_ddp_variants import run_cases
from tests.torch_ddp_cases import bit_equal, loss_ratio

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tiny_cfg, tmp_path_factory):
    return run_cases(tiny_cfg, tmp_path_factory.mktemp("ddp_cpm"), ("cpm",))


def test_two_ranks_match_jax_spmd_step(runs):
    ranks, ref = runs
    for r in ranks:
        got = max(loss_ratio(g["losses"], w["losses"], 1e-5)
                  for g, w in zip(r["cpm"]["global"]["steps"], ref["cpm"]))
        print(f"cpm: rank run at {got:.3g} of its limit")
        assert got <= 1.0


def test_two_ranks_are_bit_equal(runs):
    """The ranks' losses and states (gradients, parameters, optimizer
    state: their digests) are bit-equal, and the steps moved them."""
    a, b = (r["cpm"]["global"] for r in runs[0])
    assert bit_equal(a, b)
    assert len({step["digest"] for step in a["steps"]}) == len(a["steps"]) == 2
