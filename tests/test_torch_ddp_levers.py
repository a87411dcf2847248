"""The BN statistics levers (``TPU.BN_STAT_SAMPLES`` / ``BN_STAT_DTYPE``)
in the port's data-parallel 2D step: two gloo CPU ranks (run by the
JAX-free tests/torch_ddp_cases_child.py) against the JAX package under
``set_bn_levers``, whose ``StatBatchNorm`` takes ``x[:stat_samples]`` of
the global batch.

The setup is tests/test_torch_ddp.py's: tiny_cfg in float32 with sgd
(momentum 0.9) at a constant 1e-2, a global batch of 4 (2 a rank) whose
visibility differs between the ranks' halves.  One step a lever setting:
the subsample of 1 row (on rank 0 alone: rank 1 adds no row and still
joins every sum), of 3 rows (spanning both ranks), and of 3 rows with
bfloat16 statistics (the summed float32 moments rounded once).

What the levers change is the step's train-mode forward: its losses and
new running statistics are held against JAX's train-mode forward and
loss (tests/test_torch_bn_levers_step.py's reference: the apply jitted,
here with the batch sharded over ``Mesh(devices[:2], ('data',))``; the
losses op by op), at that file's limits: losses rtol 1e-5 (3e-2 in
bfloat16), statistics rtol 1e-5 + atol 2e-5 (0.05 in bfloat16).  The
parameters are held within 1e-3 (tests/test_torch_ddp.py's limit) of the
port's own one-process step on the global batch: with a subsample's
statistics the first layers' gradients are ill-conditioned, and one
process alone parts from JAX's jitted step by 9e-4 with a 1-row
subsample and by 8e-3 with bfloat16 statistics (a statistic's rounding
flips), where the ranks part from one process by 2e-7 to 6e-5 and the
witnesses by 7e-3 to 0.14 (measured).  The ranks are bit-equal, and the
per-rank-statistics and per-rank-denominator witnesses miss the limits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from hrnet_hand_pose_estimation_tpu.core.loss_computer import LossComputer2D as JaxLoss
from hrnet_hand_pose_estimation_tpu.models import layers as JL
from hrnet_hand_pose_estimation_tpu.ops.decode import decode_heatmaps as jax_decode
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models import layers as L
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import (from_jax_train_state,
                                                                from_jax_variables)
from test_torch_ddp import global_batch
from test_torch_multistep import setup  # noqa: F401 (fixture)
from tests.torch_ddp_cases import (WITNESSES, WORLD, allclose_ratio, bit_equal, collect,
                                   loss_ratio, spawn, stats_only)
from torch_train_parity import tensors

torch.set_num_threads(1)
# name: (set_bn_levers keywords, loss rtol, statistics atol)
LEVERS = {"rank0": (dict(stat_samples=1), 1e-5, 2e-5),
          "span": (dict(stat_samples=3), 1e-5, 2e-5),
          "span_bf16": (dict(stat_samples=3, stat_dtype="bfloat16"), 3e-2, 0.05)}
PARAM_ATOL = 1e-3


def one_process(pcfg, init, batch, levers):
    """The port's step with ``levers`` on the global batch in this process
    (no group): its parameters."""
    L.set_bn_levers(**levers)
    try:
        model = build_model(pcfg)
        state, tx = TS.create_train_state(pcfg, model, device="cpu")
        sd = state.state_dict()
        sd["params"], sd["batch_stats"] = init["params"], init["batch_stats"]
        state.load_state_dict(sd)
        state, _ = TS.make_train_step(pcfg, model, tx)(state, tensors(batch))
        return state.state_dict()["params"]
    finally:
        L.set_bn_levers()


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The ranks' runs (started first), then JAX's train-mode forward on
    the sharded batch under each lever setting, and the port's one-process
    steps."""
    jcfg, pcfg, jm, _, jstate, _ = setup
    batch = global_batch(7)
    init = from_jax_train_state(jax.device_get(jstate), build_model(pcfg))
    cases = [dict(name=name, kind="step2d", cfg=pcfg.to_dict(), params=init["params"],
                  batch_stats=init["batch_stats"], keep={"params": None, "batch_stats": None},
                  batches=[batch], levers=levers, modes=["global", *WITNESSES])
             for name, (levers, _, _) in LEVERS.items()]
    work = tmp_path_factory.mktemp("ddp_levers")
    procs = spawn(cases, work)

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    data, rep = NamedSharding(mesh, PartitionSpec("data")), NamedSharding(mesh, PartitionSpec())
    images = jax.device_put(jnp.asarray(batch["images"]), data)
    variables = jax.device_put({"params": jstate.params, "batch_stats": jstate.batch_stats}, rep)
    ref = {}
    try:
        for name, (levers, _, _) in LEVERS.items():
            JL.set_bn_levers(**levers)
            out, mut = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(
                variables, images)
            _, losses = JaxLoss(jcfg)(heatmaps_pred=out.heatmaps,
                                      heatmaps_gt=jnp.asarray(batch["target_heatmaps"]),
                                      pose2d_pred=jax_decode(out.heatmaps, True),
                                      pose2d_gt=jnp.asarray(batch["pose2d"]),
                                      visibility=jnp.asarray(batch["visibility"]))
            ref[name] = {"losses": {k: float(v) for k, v in losses.items()},
                         "batch_stats": from_jax_variables({
                             "params": jax.device_get(jstate.params),
                             "batch_stats": jax.device_get(mut["batch_stats"])})}
    finally:
        JL.set_bn_levers()
    for name, (levers, _, _) in LEVERS.items():
        ref[name]["one_process"] = one_process(pcfg, init, batch, levers)
    return collect(procs, work), ref


def param_gap(got, want) -> float:
    return max(float((got[n] - v).abs().max()) for n, v in want.items())


def ratio(name, run, ref) -> float:
    """Losses and running statistics against JAX's at the levers' limits;
    parameters within 1e-3 of the port's one-process step's."""
    _, loss_rtol, stat_atol = LEVERS[name]
    got, want = run["steps"][0], ref[name]
    losses = {k: got["losses"][k] for k in want["losses"]}
    return max(loss_ratio(losses, want["losses"], loss_rtol, 1e-7),
               allclose_ratio(got["batch_stats"], stats_only(want["batch_stats"]), 1e-5,
                              stat_atol),
               param_gap(got["params"], want["one_process"]) / PARAM_ATOL)


@pytest.mark.parametrize("name", list(LEVERS))
def test_two_ranks_match_jax_spmd_step(runs, name):
    """Both ranks' step with the lever against JAX's on the global batch:
    the loss dict, every parameter and every running statistic (the
    head's and the stem's BNs take the levers too)."""
    ranks, ref = runs
    assert "last_layer.1.running_mean" in ref[name]["batch_stats"]
    for r in ranks:
        got = ratio(name, r[name]["global"], ref)
        print(f"{name}: rank run at {got:.3g} of its limit")
        assert got <= 1.0


@pytest.mark.parametrize("name", list(LEVERS))
def test_two_ranks_are_bit_equal(runs, name):
    """Losses and states (gradients, parameters, running statistics, though
    rank 1 holds no row of a 1-row subsample, optimizer state: their
    digests) are bit-equal."""
    a, b = (r[name]["global"] for r in runs[0])
    assert bit_equal(a, b)


@pytest.mark.parametrize("name,witness", [(n, w) for n in LEVERS for w in WITNESSES])
def test_witnesses_miss_the_limits(runs, name, witness):
    """Per-rank subsample statistics (each rank's own first rows) or per-rank
    loss denominators land outside the limits the data-parallel step meets."""
    ranks, ref = runs
    got = ratio(name, ranks[0][name][witness], ref)
    print(f"{name} {witness}: at {got:.3g} of the limit")
    assert got > 1.0
