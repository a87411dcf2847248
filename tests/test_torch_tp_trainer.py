"""The BN statistics levers and the ``Trainer`` on a data x model grid of
ranks: four gloo CPU ranks as a (2, 2) grid (tests/torch_tp_child.py).

- The levers: one step with ``stat_samples=1``, whose one row lies on data
  rank 0 alone, held as tests/test_torch_ddp_levers.py holds two data
  ranks: the losses and the running statistics against JAX's train-mode
  forward on the global batch, sharded over its (4, 2) mesh with the
  variables on ``param_shardings`` (losses rtol 1e-5, statistics rtol 1e-5
  + atol 2e-5), the parameters within 1e-3 of the port's one-process step
  with the same lever; the four ranks bit-equal.
- The ``Trainer`` under ``TPU.MESH_AXES [data, model]`` / ``MESH_SHAPE [2,
  2]``: one epoch, then a second ``Trainer`` that resumes from rank 0's
  checkpoint for another.  The checkpoint holds the whole state (full
  shapes, moments included); it loads into a one-process ``Trainer`` bit
  for bit equal to the ranks' gathered state, and the resume carries on
  from the epoch and step it saved.
"""

import os

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import hrnet_hand_pose_estimation_tpu.parallel.mesh as jax_mesh
from hrnet_hand_pose_estimation_tpu.core.loss_computer import LossComputer2D as JaxLoss
from hrnet_hand_pose_estimation_tpu.models import layers as JL
from hrnet_hand_pose_estimation_tpu.ops.decode import decode_heatmaps as jax_decode
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer
from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import DataLoader
from hrnet_hand_pose_estimation_tpu_torch.data.synthetic import SyntheticDataset
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import (from_jax_train_state,
                                                                from_jax_variables)
from test_torch_ddp import global_batch
from test_torch_ddp_levers import one_process
from test_torch_multistep import setup  # noqa: F401 (fixture)
from test_torch_tp_train import collect, jax_grid, spawn
from tests.torch_ddp_cases import allclose_ratio, bit_equal, loss_ratio, stats_only

torch.set_num_threads(1)
LEVERS = dict(stat_samples=1)
PARAM_ATOL = 1e-3


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The ranks' lever step and Trainer runs (started first), then JAX's
    train-mode forward with the lever on its (4, 2) mesh and the port's
    one-process lever step."""
    jcfg, pcfg, jm, _, jstate, _ = setup
    batch = global_batch(7)
    init = from_jax_train_state(jax.device_get(jstate), build_model(pcfg))
    work = tmp_path_factory.mktemp("tp_trainer")
    tcfg = pcfg.clone()
    tcfg.defrost()
    tcfg.WORKERS, tcfg.PRINT_FREQ, tcfg.AUTO_RESUME = 0, 1, True
    tcfg.OUTPUT_DIR = str(work / "trainer")
    tcfg.TRAIN.BEGIN_EPOCH = 0
    tcfg.TPU.MESH_AXES, tcfg.TPU.MESH_SHAPE = ["data", "model"], [2, 2]
    tcfg.freeze()
    procs = spawn({"cfg": pcfg.to_dict(), "state": init, "lever_batch": batch,
                   "levers": LEVERS, "trainer_cfg": tcfg.to_dict(),
                   "cases": ["levers", "trainer"]}, work)

    mesh = jax_grid()
    data = NamedSharding(mesh, PartitionSpec("data"))
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    variables = jax.device_put(variables, {
        "params": jax_mesh.param_shardings(mesh, jstate.params),
        "batch_stats": jax.tree.map(lambda _: jax_mesh.replicated(mesh), jstate.batch_stats)})
    JL.set_bn_levers(**LEVERS)
    try:
        out, mut = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(
            variables, jax.device_put(jnp.asarray(batch["images"]), data))
        _, losses = JaxLoss(jcfg)(heatmaps_pred=out.heatmaps,
                                  heatmaps_gt=jnp.asarray(batch["target_heatmaps"]),
                                  pose2d_pred=jax_decode(out.heatmaps, True),
                                  pose2d_gt=jnp.asarray(batch["pose2d"]),
                                  visibility=jnp.asarray(batch["visibility"]))
    finally:
        JL.set_bn_levers()
    ref = {"losses": {k: float(v) for k, v in losses.items()},
           "batch_stats": from_jax_variables({"params": jax.device_get(jstate.params),
                                              "batch_stats": jax.device_get(mut["batch_stats"])}),
           "one_process": one_process(pcfg, init, batch, LEVERS)}
    return collect(procs, work), ref, tcfg, work


def test_levers_on_one_data_rank_match_jax(runs):
    """Every rank's lever step: the losses and the running statistics
    against JAX's at the levers' limits, the gathered parameters within
    1e-3 of the port's one-process step; the ranks bit-equal."""
    ranks, ref, _, _ = runs
    for r in ranks:
        got = r["levers"]
        losses = {k: got["losses"][0][k] for k in ref["losses"]}
        assert loss_ratio(losses, ref["losses"], 1e-5, 1e-7) <= 1.0
        assert allclose_ratio(got["state"]["batch_stats"], stats_only(ref["batch_stats"]),
                              1e-5, 2e-5) <= 1.0
        gap = max(float((got["state"]["params"][n] - v).abs().max())
                  for n, v in ref["one_process"].items())
        print(f"levers: parameter gap to one process {gap:.3g}")
        assert gap <= PARAM_ATOL
        assert got["losses"] == ranks[0]["levers"]["losses"]
        assert bit_equal(got["state"], ranks[0]["levers"]["state"])


def test_trainer_checkpoint_is_whole_and_resumes(runs):
    """The grid's Trainer: 2 steps an epoch (8 samples, a global batch of
    4), the data ranks reading disjoint halves and the model ranks of a
    data row the same; rank 0's checkpoint holds full shapes; the resumed
    run starts at epoch 1 with 2 steps done and ends at 4; every rank
    gathers the same state."""
    ranks, _, tcfg, work = runs
    first = [r["trainer"]["first"] for r in ranks]
    resumed = [r["trainer"]["resumed"] for r in ranks]
    assert [f["begin"] for f in first] == [0] * 4 and [f["steps"] for f in first] == [2] * 4
    assert [f["begin"] for f in resumed] == [1] * 4 and [f["steps"] for f in resumed] == [4] * 4
    assert first[0]["indices"] == first[1]["indices"] != first[2]["indices"]
    assert sorted(first[0]["indices"] + first[2]["indices"]) == list(range(8))
    for runs_ in (first, resumed):
        assert all(bit_equal(run["state"], runs_[0]["state"]) for run in runs_[1:])
    ckpts = [os.path.join(dp, f) for dp, _, fs in os.walk(work / "trainer") for f in fs
             if f.startswith("ckpt_")]
    assert sorted(os.path.basename(c) for c in ckpts) == ["ckpt_0.pt", "ckpt_1.pt"]
    saved = torch.load(sorted(ckpts)[0], map_location="cpu", weights_only=True)["state"]
    full = build_model(config_from_dict(tcfg.to_dict())).state_dict()
    for name, val in saved["params"].items():
        assert val.shape == full[name].shape, name
    for name, val in saved["opt_state"]["trace"].items():
        assert val.shape == full[name].shape, name
    assert bit_equal(saved, first[0]["state"])


def test_grid_checkpoint_loads_into_one_process_trainer(runs):
    """A one-process ``Trainer`` (no grid) with ``AUTO_RESUME`` on the
    grid's output directory takes its newest checkpoint: its state equals
    the ranks' gathered state bit for bit, and it would begin at epoch 2."""
    ranks, _, tcfg, _ = runs
    cfg = tcfg.clone()
    cfg.defrost()
    cfg.TPU.MESH_AXES, cfg.TPU.MESH_SHAPE = ["data"], []
    cfg.TRAIN.END_EPOCH = 2
    cfg.freeze()
    cfg = config_from_dict(cfg.to_dict())
    loader = DataLoader(SyntheticDataset(cfg, length=8), 2, shuffle=True, num_workers=0)
    trainer = Trainer(cfg, build_model(cfg), {"s": loader}, device="cpu")
    assert trainer.begin_epoch == 2 and trainer.train_global_steps == 4
    assert bit_equal(trainer.state.state_dict(), ranks[0]["trainer"]["resumed"]["state"])
