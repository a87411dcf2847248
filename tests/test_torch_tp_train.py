"""The port's 2D training on a data x model grid of ranks: four gloo CPU
ranks as a (2, 2) grid (run by the JAX-free tests/torch_tp_child.py)
against the JAX package's SPMD step on its (4, 2) mesh of host devices
(``make_train_step`` with the state on ``state_shardings``), both the
step on the global batch.

The setup is tests/test_torch_ddp.py's: tiny_cfg in float32 with sgd
(momentum 0.9) at a constant 1e-2, JAX's init distributions filled from
``eval_shape``, two global batches of 4 whose visibility differs between
the data ranks' halves.  The tiny config keeps layer1's five 256-wide
convs, which both split over the model axis.  Held at tests/test_torch_ddp.py's
limits, losses rtol 2e-4 and parameters atol 1e-3, which were set from the
port's one-process step against JAX's one-device step (1.35e-5 on the
losses, 1.3e-4 on the parameters): on the CPU the grid's step is the
two-rank data-parallel step's bit for bit, so the limits measure the same
gap.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_train_state
from test_torch_ddp import global_batch
from test_torch_multistep import setup  # noqa: F401 (fixture)
from tests.torch_ddp_cases import bit_equal, free_port
from torch_tp_toy import SPLIT

torch.set_num_threads(1)
CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tp_child.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, GRID = 4, (2, 2)
LOSS_RTOL, PARAM_ATOL = 2e-4, 1e-3


def spawn(payload, work):
    """Write ``payload`` to ``work/input.pt`` and start the four ranks."""
    import subprocess
    import sys

    torch.save(dict(payload, grid=GRID), os.path.join(work, "input.pt"))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    return [subprocess.Popen([sys.executable, CHILD, str(r), str(WORLD), str(port), str(work)],
                             env=env) for r in range(WORLD)]


def collect(procs, work, timeout: int = 400):
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0] * WORLD, f"rank exit codes {codes}"
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def jax_grid():
    return Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The ranks' runs, started first, and JAX's SPMD steps on its (4, 2)
    mesh while they run."""
    jcfg, pcfg, jm, tx, jstate, _ = setup
    batches = [global_batch(s) for s in range(2)]
    init = from_jax_train_state(jax.device_get(jstate), build_model(pcfg))
    work = tmp_path_factory.mktemp("tp_train")
    procs = spawn({"cfg": pcfg.to_dict(), "state": init, "batches": batches,
                   "cases": ["plain", "multi", "poison", "toy"]}, work)

    mesh = jax_grid()
    step = jax_ts.make_train_step(jcfg, jm, tx, mesh)
    shardings = jax_ts.state_shardings(mesh, jstate)
    state = jax.device_put(jax.tree.map(jnp.copy, jstate), shardings)
    assert any("model" in tuple(s.spec) for s in jax.tree.leaves(shardings.params))
    data = NamedSharding(mesh, PartitionSpec("data"))
    jlosses = []
    for b in batches:
        state, out = step(state, {k: jax.device_put(jnp.asarray(v), data) for k, v in b.items()})
        jlosses.append({k: float(v) for k, v in out.items()})
    want = from_jax_train_state(jax.device_get(state), build_model(pcfg))
    return jlosses, want, init, collect(procs, work)


def test_grid_matches_jax_spmd_step(runs):
    """Every rank's two steps against JAX's on its (4, 2) mesh: every loss
    within rtol 2e-4, every gathered parameter within atol 1e-3, the BN
    running statistics within 1e-4."""
    jlosses, want, _, ranks = runs
    for run in (r["plain"] for r in ranks):
        assert [set(s) for s in run["losses"]] == [set(s) for s in jlosses]
        for got, step in zip(run["losses"], jlosses):
            for key, ref in step.items():
                np.testing.assert_allclose(got[key], ref, rtol=LOSS_RTOL, atol=1e-7, err_msg=key)
        for name, val in want["params"].items():
            assert run["state"]["params"][name].shape == val.shape
            np.testing.assert_allclose(run["state"]["params"][name].numpy(), val.numpy(),
                                       atol=PARAM_ATOL, err_msg=name)
        for name, val in want["batch_stats"].items():
            if not name.endswith("num_batches_tracked"):
                np.testing.assert_allclose(run["state"]["batch_stats"][name].numpy(),
                                           val.numpy(), atol=1e-4, err_msg=name)
        assert int(run["state"]["step"]) == len(jlosses)
    gap = max(float((ranks[0]["plain"]["state"]["params"][n] - v).abs().max())
              for n, v in want["params"].items())
    print(f"grid: largest parameter gap to JAX {gap:.3g}")


def test_grid_ranks_agree_and_hold_shards(runs):
    """The gathered states and the losses are bit-equal on all four ranks
    (the replicated leaves are the ranks' own); ranks of one model index
    hold bit-equal shards, the two model indices different ones; each rank's
    flat buffers hold its shards, so the sgd trace is shard-shaped, and the
    step counter and BN statistics are replicated."""
    _, want, _, ranks = runs
    runs_ = [r["plain"] for r in ranks]
    for other in runs_[1:]:
        assert other["losses"] == runs_[0]["losses"]
        assert bit_equal(other["state"], runs_[0]["state"])
    assert torch.equal(runs_[0]["local"], runs_[2]["local"])
    assert torch.equal(runs_[1]["local"], runs_[3]["local"])
    assert not torch.equal(runs_[0]["local"], runs_[1]["local"])
    sh = runs_[0]["shardings"]
    split = {n: d for n, d in sh["params"].items() if d is not None}
    assert len(split) == 5 and sh["opt_state"]["trace"] == sh["params"]
    assert sh["step"] is None and set(sh["batch_stats"].values()) == {None}
    full = sum(v.numel() for v in want["params"].values())
    halves = sum(want["params"][n].numel() // 2 for n in split)
    for run in runs_:
        assert run["local"].numel() == run["local_opt"]["trace"].numel() == full - halves
        for name, dim in split.items():
            assert run["state"]["opt_state"]["trace"][name].shape == want["params"][name].shape


def test_grid_multistep(runs):
    """``make_train_multistep`` (K = 2) on the grid is the grid's two steps
    bit for bit (losses stacked), so it meets JAX's two steps as they do."""
    for r in runs[3]:
        assert r["multi"]["losses"] == r["plain"]["losses"]
        assert bit_equal(r["multi"]["state"], r["plain"]["state"])


def test_nonfinite_shard_skips_on_every_rank(runs):
    """A NaN gradient in one shard of the last rank (and, after the data
    group's sum, of its data-group partner) skips the step on all four
    ranks: each reports nonfinite_grads 1 and keeps its parameters, BN
    statistics and optimizer state bit for bit; the step counter moves."""
    _, _, init, ranks = runs
    for r in ranks:
        run = r["poison"]
        assert run["losses"][0]["nonfinite_grads"] == 1.0
        assert bit_equal(run["state"]["params"], init["params"])
        assert bit_equal(run["state"]["batch_stats"], init["batch_stats"])
        assert all(not v.abs().sum() for v in run["state"]["opt_state"]["trace"].values())
        assert int(run["state"]["step"]) == 1


def test_split_kinds_across_ranks(runs):
    """tests/torch_tp_toy.py's net split over each rank's model group (a
    conv with a bias, a depthwise conv, a transposed conv and a Linear
    compute their shards; a kept leaf is all-gathered at its use): the
    output within 1e-6 of the unsplit net's, every gathered gradient within
    1e-5 of its largest magnitude, under the unsplit net's names."""
    for r in runs[3]:
        toy = r["toy"]
        assert {n: d for n, d in toy["split"].items() if d is not None} == SPLIT
        assert toy["names"] and all(toy["computed"])
        assert toy["out_gap"] <= 1e-6 and toy["grad_gap"] <= 1e-5, toy
