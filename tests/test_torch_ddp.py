"""The port's data-parallel 2D training (two gloo CPU ranks, run by the
JAX-free tests/torch_ddp_child.py) against the JAX package's SPMD step on
the global batch (``make_train_step(mesh=Mesh(devices[:2]))``), and the
Trainer across the two ranks.

The setup is tests/test_torch_multistep.py's: tiny_cfg in float32 with sgd
(momentum 0.9) at a constant 1e-2, JAX's init distributions filled from
``eval_shape``.  Two global batches of 4, 2 a rank, whose visibility masks
differ between the ranks' halves, so the pose loss's global denominator
is not the mean of the ranks' own.  Held at tests/test_torch_multistep_jax.py's
tolerances: losses rtol 2e-4, parameters atol 1e-3.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu.ops.targets import gaussian_targets as jax_gaussian_targets
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_train_state
from test_torch_multistep import setup  # noqa: F401 (fixture)

torch.set_num_threads(1)
CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_ddp_child.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LOSS_RTOL, PARAM_ATOL = 2e-4, 1e-3


def global_batch(seed: int, b: int = 4):
    """A seeded global batch; the second half hides some joints, so the two
    ranks' visible counts differ (42 and 24)."""
    rng = np.random.default_rng(100 + seed)
    pose = rng.uniform(2, 14, size=(b, 21, 2)).astype(np.float32)
    vis = np.ones((b, 21), np.float32)
    vis[b // 2:, ::3] = 0.0
    vis[b - 1, 1::4] = 0.0
    return {"images": rng.normal(size=(b, 64, 64, 3)).astype(np.float32),
            "pose2d": pose, "visibility": vis,
            "target_heatmaps": np.asarray(jax_gaussian_targets(jnp.asarray(pose),
                                                               jnp.asarray(vis), 16, 2.0))}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ddp(setup, tmp_path_factory):
    """The two ranks' runs, started first, and the JAX SPMD steps on the
    global batches while they run."""
    jcfg, pcfg, jm, tx, jstate, _ = setup
    batches = [global_batch(s) for s in range(2)]
    model = build_model(pcfg)
    init = from_jax_train_state(jax.device_get(jstate), model)
    tcfg = pcfg.clone()
    tcfg.defrost()
    tcfg.WORKERS, tcfg.PRINT_FREQ = 0, 1
    tcfg.TRAIN.BEGIN_EPOCH, tcfg.TRAIN.END_EPOCH = 0, 1
    tcfg.freeze()
    work = tmp_path_factory.mktemp("ddp")
    torch.save({"cfg": pcfg.to_dict(), "state": init, "batches": batches,
                "trainer_cfg": tcfg.to_dict()}, work / "input.pt")
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, CHILD, str(r), str(WORLD), str(port), str(work)],
                              env=env) for r in range(WORLD)]

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    step = jax_ts.make_train_step(jcfg, jm, tx, mesh)
    # placed as the step's outputs are, so the second step reuses the first's program
    state = jax.device_put(jax.tree.map(jnp.copy, jstate), jax_ts.state_shardings(mesh, jstate))
    data = NamedSharding(mesh, PartitionSpec("data"))
    jlosses = []
    for b in batches:
        state, out = step(state, {k: jax.device_put(jnp.asarray(v), data) for k, v in b.items()})
        jlosses.append({k: float(v) for k, v in out.items()})
    want = from_jax_train_state(jax.device_get(state), model)
    assert [p.wait(timeout=240) for p in procs] == [0] * WORLD
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return jlosses, want, ranks, work


def gaps(run, jlosses, want):
    """(largest relative loss gap, largest parameter gap) of a rank's run
    against JAX's steps."""
    loss = max(abs(got[k] - ref) / abs(ref) for got, step in zip(run["losses"], jlosses)
               for k, ref in step.items() if ref)
    param = max(float((run["state"]["params"][n] - v).abs().max())
                for n, v in want["params"].items())
    return loss, param


def test_two_ranks_match_jax_spmd_step(ddp):
    """Both ranks' data-parallel steps against JAX's step on the global
    batch: every loss within rtol 2e-4, every parameter within atol 1e-3,
    the BN running statistics within 1e-4."""
    jlosses, want, ranks, _ = ddp
    for run in (r["global"] for r in ranks):
        assert [set(s) for s in run["losses"]] == [set(s) for s in jlosses]
        for got, step in zip(run["losses"], jlosses):
            for key, ref in step.items():
                np.testing.assert_allclose(got[key], ref, rtol=LOSS_RTOL, atol=1e-7, err_msg=key)
        for name, val in want["params"].items():
            np.testing.assert_allclose(run["state"]["params"][name].numpy(), val.numpy(),
                                       atol=PARAM_ATOL, err_msg=name)
        for name, val in want["batch_stats"].items():
            if not name.endswith("num_batches_tracked"):
                np.testing.assert_allclose(run["state"]["batch_stats"][name].numpy(),
                                           val.numpy(), atol=1e-4, err_msg=name)
        assert int(run["state"]["step"]) == len(jlosses)
    print("global: largest loss / parameter gap to JAX %.3g / %.3g" % gaps(ranks[0]["global"],
                                                                            jlosses, want))


def test_two_ranks_are_bit_equal(ddp):
    """The ranks' parameters, BN statistics and optimizer state are
    bit-equal, and so are their reported (global) losses."""
    _, _, (r0, r1), _ = ddp
    a, b = r0["global"], r1["global"]
    assert a["losses"] == b["losses"]
    for section in ("params", "batch_stats"):
        for name, val in a["state"][section].items():
            assert torch.equal(val, b["state"][section][name]), name
    for key, val in a["state"]["opt_state"].items():
        vals = val.values() if isinstance(val, dict) else [val]
        other = b["state"]["opt_state"][key]
        others = other.values() if isinstance(other, dict) else [other]
        assert all(torch.equal(x, y) for x, y in zip(vals, others)), key


@pytest.mark.parametrize("witness", ["local_bn", "local_loss"])
def test_witnesses_miss_the_tolerance(ddp, witness):
    """The same run with per-rank BN statistics, or with per-rank loss
    normalisation (the mean of the ranks' ratios), lands outside the
    tolerance the global run meets: the parity test can fail."""
    jlosses, want, ranks, _ = ddp
    loss_gap, param_gap = gaps(ranks[0][witness], jlosses, want)
    print(f"{witness}: largest loss gap {loss_gap:.3g}, parameter gap {param_gap:.3g}")
    assert loss_gap > LOSS_RTOL or param_gap > PARAM_ATOL


def test_trainer_two_ranks(ddp):
    """A 2-rank Trainer fits an epoch of 8 samples at 2 a rank: 2 steps a
    rank over disjoint index slices of one seeded order, equal weights and
    validation totals on both ranks, and only rank 0 writes (its log,
    checkpoint and best-model snapshot; rank 1's output directory is not
    even created)."""
    _, _, (r0, r1), work = ddp
    a, b = r0["trainer"], r1["trainer"]
    assert a["len"] == b["len"] == 2 and a["steps"] == b["steps"] == 2
    assert sorted(a["indices"] + b["indices"]) == list(range(8))
    assert torch.equal(a["params"], b["params"]) and a["best_loss"] == b["best_loss"]
    written = [f for _, _, fs in os.walk(work / "trainer_r0") for f in fs]
    assert any(f.endswith(".log") for f in written)
    assert {"best.pt", "ckpt_0.pt"} <= set(written)
    assert not (work / "trainer_r1").exists()
