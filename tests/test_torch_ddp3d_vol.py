"""The port's data-parallel vol step and 3D trainers: two gloo CPU ranks
(run by the JAX-free tests/torch_ddp_cases_child.py).

- vol: one step against the port's own one-process step on the global
  batch (2 samples x 2 views, V2V at 32^3, float32): V2V's train-mode
  gradient at this batch is ill-conditioned against JAX (ROADMAP C3), so
  the limit is 4x a float32 witness, the same one-process step with the
  data-parallel BN formula.  The cuboid angles the two ranks draw are one
  process's draw on the global batch.  The pose2d loss's visibility
  differs between the ranks' halves.  The ranks are bit-equal, and the
  witnesses (per-rank BN statistics; per-rank loss denominators) miss
  the limit.
- Trainer3D and TrainerGAN3D for one epoch of Synthetic_mv over the two
  ranks: rank 0 alone writes, EPE3D is equal on both.
"""

import math
import os

import numpy as np
import pytest
import torch

from tests.test_torch_ddp3d import WITNESS_FACTOR, batches3d, one_process
from tests.torch3d_parity import ORIG_SIZE, nets, train_cfg
from tests.torch_ddp_cases import (WITNESSES, bit_equal, collect, spawn, stats_only,
                                   tensor_ratio)

torch.set_num_threads(1)
CLIP, GAN_FACTOR, N_CRITIC = 0.01, 0.01, 2      # the trainer's WGAN


def trainer_cfg(tiny_cfg, gan: bool):
    """The alg net on Synthetic_mv (16 samples, 2 views), 2 a rank, one epoch."""
    extra = dict(DATASET__DATASET=["Synthetic_mv"], DATASET__TEST_DATASET=["Synthetic_mv"],
                 DATASET__NUM_VIEWS=2, TRAIN__IMAGES_PER_GPU=2, TEST__IMAGES_PER_GPU=4,
                 WORKERS=0, PRINT_FREQ=1, TRAIN__BEGIN_EPOCH=0, TRAIN__END_EPOCH=1,
                 LOSS__WITH_POSE2D_LOSS=True)
    if gan:
        extra.update(MODEL__N_CRITIC=N_CRITIC, MODEL__CLIP_VALUE=CLIP,
                     LOSS__KCS_LOSS_FACTOR=GAN_FACTOR, LOSS__WITH_KCS_LOSS=True)
    return train_cfg(tiny_cfg, "alg", **extra)[1]


@pytest.fixture(scope="module")
def runs(tiny_cfg, tmp_path_factory):
    """The ranks' runs (started first), then the port's one-process vol
    steps (the reference and its witness)."""
    vcfg_j, vcfg = train_cfg(tiny_cfg, "vol")
    _, _, vmodel = nets(vcfg_j, "vol", seed=13, b=2)
    batches = batches3d("vol", 2, (201,))
    cases = [
        dict(name="vol", kind="step3d", cfg=vcfg.to_dict(), model=vmodel.state_dict(),
             batches=batches, orig_size=ORIG_SIZE["vol"], modes=["global", *WITNESSES]),
        dict(name="trainer3d", kind="trainer3d", cfg=trainer_cfg(tiny_cfg, False).to_dict()),
        dict(name="trainer_gan", kind="trainer3d", gan=True,
             cfg=trainer_cfg(tiny_cfg, True).to_dict()),
    ]
    work = tmp_path_factory.mktemp("ddp3d_vol")
    procs = spawn(cases, work)
    ref = {"native": one_process("vol", vcfg, vmodel.state_dict(), batches, False),
           "formula": one_process("vol", vcfg, vmodel.state_dict(), batches, True)}
    return collect(procs, work), ref, work


def vol_gaps(run, ref):
    """(largest relative loss gap, parameter gap, BN-statistic gap) over the steps."""
    loss = max(abs(g["losses"][k] - w["losses"][k]) / abs(w["losses"][k])
               for g, w in zip(run["steps"], ref["steps"])
               for k in w["losses"] if w["losses"][k])
    param = max(float((g["state"]["params"][n] - v).abs().max())
                for g, w in zip(run["steps"], ref["steps"]) for n, v in w["state"]["params"].items())
    stats = max(tensor_ratio(stats_only(g["state"]["batch_stats"]),
                             stats_only(w["state"]["batch_stats"]), 0.0, 1.0)
                for g, w in zip(run["steps"], ref["steps"]))
    return loss, param, stats


def vol_ratio(run, ref) -> float:
    limits = [WITNESS_FACTOR * w for w in vol_gaps(ref["formula"], ref["native"])]
    return max(g / lim for g, lim in zip(vol_gaps(run, ref["native"]), limits))


def test_two_ranks_match_one_process(runs):
    """Both ranks' data-parallel vol step within 4x the witness of the
    port's one-process step on the global batch."""
    ranks, ref, _ = runs
    for r in ranks:
        got = vol_ratio(r["vol"]["global"], ref)
        print(f"vol: rank run at {got:.3g} of its limit")
        assert got <= 1.0


@pytest.mark.parametrize("case", ["vol", "trainer3d", "trainer_gan"])
def test_two_ranks_are_bit_equal(runs, case):
    """The ranks' losses, parameters, BN statistics and optimizer states
    (the trainers' critic's too) are bit-equal."""
    a, b = (r[case]["global"] for r in runs[0])
    own = ("indices", "files", "angles")     # each rank's own, checked apart
    assert bit_equal({k: v for k, v in a.items() if k not in own},
                     {k: v for k, v in b.items() if k not in own})


@pytest.mark.parametrize("witness", WITNESSES)
def test_witnesses_miss_the_limits(runs, witness):
    """The same step with per-rank BN statistics, or per-rank loss
    denominators, lands outside the limit the data-parallel step meets."""
    ranks, ref, _ = runs
    got = vol_ratio(ranks[0]["vol"][witness], ref)
    print(f"vol {witness}: at {got:.3g} of the limit")
    assert got > 1.0


def test_vol_angles_are_one_process_draw(runs):
    """Each rank's cuboid angles are its slice of the global batch's draw:
    together, the angles one process draws on the global batch."""
    ranks, ref, _ = runs
    want = ref["native"]["angles"]
    got = [torch.cat([r["vol"]["global"]["angles"][i] for r in ranks]) for i in range(len(want))]
    assert len(got) == 1 and want[0].shape == (2,)
    assert ranks[0]["vol"]["global"]["angles"][0].shape == (1,)
    assert torch.equal(got[0], want[0]) and got[0][0] != got[0][1]
    assert bool(((got[0] >= 0) & (got[0] < 2 * math.pi)).all())


@pytest.mark.parametrize("case", ["trainer3d", "trainer_gan"])
def test_trainer_two_ranks(runs, case):
    """Trainer3D and TrainerGAN3D fit one epoch of Synthetic_mv (16 samples,
    2 a rank a step) over disjoint slices of one seeded order: EPE3D (and
    so the best-model choice) equal on both ranks and finite, the weights
    moved alike, and only rank 0 wrote its log, checkpoint and best model
    (rank 1's output directory is not even created)."""
    (a, b), work = [r[case]["global"] for r in runs[0]], runs[2]
    assert a["len"] == b["len"] == 4
    assert sorted(a["indices"] + b["indices"]) == list(range(16))
    assert len(a["val"]) == 1 and a["val"] == b["val"] and np.isfinite(a["val"][0]["epe3d_mm"])
    assert a["best_loss"] == b["best_loss"] == a["val"][0]["total_loss"]
    assert not torch.equal(a["params"], a["init"])
    assert torch.equal(a["params"], b["params"]) and torch.equal(a["stats"], b["stats"])
    assert any(f.endswith(".log") for f in a["files"])
    assert {"best.pt", "ckpt_0.pt"} <= {os.path.basename(f) for f in a["files"]}
    assert b["files"] is None and not (work / f"{case}_r1").exists()
