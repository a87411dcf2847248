"""One gloo rank of the port's data-parallel 3D, WGAN, CPM, fusion and
BN-lever training, for tests/test_torch_ddp{3d,3d_vol,_gan,_cpm,_variants,
_levers}.py (JAX-free, in the manner of tests/torch_ddp_child.py).

Usage: torch_ddp_cases_child.py <rank> <world_size> <port> <workdir>

Reads ``workdir/input.pt``: {"cases": [case, ...], optionally "grid": (data,
model), a grid of ranks with a 'model' axis}.  A case is a dict:
"name"; "kind" ('step3d', 'gan', 'step2d' or 'trainer3d'); "cfg" (the
port config as a dict); "model" (the net's initial state_dict) or
"params" and "batch_stats" (a 2D state's, by name) with "keep" (the
sections of each step's state to return besides its digest); "batches"
(global batches, numpy dicts); "modes" (any of 'global', the
data-parallel steps as shipped; 'local_bn', the same with per-rank BN
statistics; 'local_loss', the same with per-rank loss denominators, the
mean of the ranks' ratios);
"levers" (``set_bn_levers`` keywords) and, for 'gan', the critic's
state_dict "critic" and "n_critic".  Joins a gloo group of ``world_size``
CPU ranks on ``tcp://localhost:<port>``, runs every case and mode from the
same initial state on this rank's slice of each global batch, and writes
``workdir/rank<r>.pt``: {case name: {mode: result}}.
"""

import hashlib
import os
import sys
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.core import trainer3d as PT3  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.core import trainer3d_gan as PG  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.core.train_variants import pick_train_step  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.data.build import make_dataloader  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.models import build_model  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.models import layers as L  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.models import triangulation as PTri  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.parallel import distributed  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.parallel.train_step import TrainState  # noqa: E402

torch.set_num_threads(1)
rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
distributed.init_process_group("gloo", rank=rank, world_size=world,
                               init_method=f"tcp://localhost:{port}")
assert "jax" not in sys.modules
payload = torch.load(os.path.join(workdir, "input.pt"), weights_only=False)
if "grid" in payload:
    distributed.init_grid(("data", "model"), payload["grid"])


def mine(batch):
    """This rank's contiguous slice of a global batch (its data rank's), as
    torch tensors."""
    data, n = distributed.data_rank(), distributed.data_size()
    per = len(next(iter(batch.values()))) // n
    return {k: torch.from_numpy(np.ascontiguousarray(v[data * per:(data + 1) * per]))
            for k, v in batch.items()}


def net3d(case, cfg):
    model = PTri.build_triangulation_net(cfg, dtype=torch.float32)
    model.load_state_dict(case["model"])
    model.train()
    tx = PT3.make_optimizer_3d(cfg, model, 1000)
    return model, TrainState(model, tx), tx


def step3d(case, cfg):
    """The 3D steps; each step's losses and state, and the cuboid angles
    the vol net drew on this rank."""
    model, state, tx = net3d(case, cfg)
    step = PT3.make_train_step_3d(cfg, model, tx, tuple(case["orig_size"]))
    gen = torch.Generator().manual_seed(int(case.get("seed", 0)))
    angles, real = [], PTri.cuboid_angles

    def record(*args):
        out = real(*args)
        angles.append(out.clone())
        return out

    PTri.cuboid_angles = record
    try:
        out = []
        for batch in case["batches"]:
            state, losses = step(state, mine(batch), gen)
            out.append({"losses": {k: float(v) for k, v in losses.items()},
                        "state": state.state_dict()})
    finally:
        PTri.cuboid_angles = real
    return {"steps": out, "angles": angles}


def gan(case, cfg):
    """n_critic WGAN critic steps on one batch, then the generator's
    adversarial step against the updated critic, from the initial
    generator (the supervised step between them in ``TrainerGAN3D`` is the
    'step3d' kind)."""
    model, state, tx = net3d(case, cfg)
    orig = tuple(case["orig_size"])
    critic = PTri.Discriminator(PG.CRITIC_FEATURES)
    critic.load_state_dict(case["critic"])
    critic_tx = PG.make_critic_optimizer()
    cstate = TrainState(critic, critic_tx)
    critic_step = PG.make_critic_step(cfg, model, critic, critic_tx, orig, float(case["clip"]))
    adv_step = PG.make_gen_adv_step(cfg, model, critic, tx, orig, float(case["gan_factor"]))
    gen = torch.Generator().manual_seed(0)
    sb = mine(case["batches"][0])
    before = (state.params.clone(), state.stats.clone())
    closs = []
    for _ in range(int(case["n_critic"])):
        cstate, loss = critic_step(cstate, state, sb, gen)
        closs.append(float(loss))
    kept = torch.equal(state.params, before[0]) and torch.equal(state.stats, before[1])
    after_critic = cstate.state_dict()
    state, adv = adv_step(state, sb, gen)
    return {"critic_loss": closs, "critic": after_critic, "generator_kept": kept,
            "adv_loss": float(adv["adv_loss"]), "gen": state.state_dict(),
            "gen_stats_kept": torch.equal(state.stats, before[1])}


def digest(state: TrainState) -> str:
    """A SHA-256 of every buffer of ``state`` (parameters, gradients, BN
    statistics and counts, optimizer state, step): equal digests are
    bit-equal states."""
    h = hashlib.sha256()
    bufs = [state.params, state.grads, state.stats, state.counts, state.step]
    bufs += [state.opt_state[k] for k in sorted(state.opt_state)]
    for buf in bufs:
        h.update(buf.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def kept(state: TrainState, keep) -> dict:
    """The sections of ``state.state_dict()`` named in ``keep`` ({section:
    None for all of it, or a list of names}; 'mu' is adam's first moment)."""
    sd = state.state_dict()
    sections = dict(sd, mu=sd["opt_state"].get("mu", {}))
    return {sec: (dict(sections[sec]) if names is None
                  else {n: sections[sec][n] for n in names})
            for sec, names in keep.items()}


def step2d(case, cfg):
    """The 2D Trainer's step of the case's model (``pick_train_step``: CPM,
    the fusion net, or the 2D step), with the case's BN levers, from the
    case's "params" and "batch_stats"; each step's losses, its state's
    digest and the sections of it in "keep"."""
    L.set_bn_levers(**case.get("levers", {}))
    try:
        model = build_model(cfg)
        state, tx = TS.create_train_state(cfg, model, device="cpu")
        sd = state.state_dict()
        sd["params"], sd["batch_stats"] = case["params"], case["batch_stats"]
        state.load_state_dict(sd)
        step = pick_train_step(cfg, model, tx)
        out = []
        for batch in case["batches"]:
            state, losses = step(state, mine(batch))
            out.append({"losses": {k: float(v) for k, v in losses.items()},
                        "digest": digest(state), **kept(state, case.get("keep", {}))})
        return {"steps": out}
    finally:
        L.set_bn_levers()


def trainer3d(case, cfg):
    """Trainer3D (and TrainerGAN3D with "gan") for the case's epochs of
    Synthetic_mv, each rank with its own OUTPUT_DIR: EPE3D, the final
    weights, the files written."""
    out_dir = Path(workdir) / f"{case['name']}_r{rank}"
    cfg = cfg.clone()
    cfg.defrost()
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.freeze()
    model = PTri.build_triangulation_net(cfg, dtype=torch.float32)
    cls = PG.TrainerGAN3D if case.get("gan") else PT3.Trainer3D
    trainer = cls(cfg, model, make_dataloader(cfg, True), make_dataloader(cfg, False),
                  device="cpu")
    init = trainer.state.params.clone()
    vals = []
    real = trainer.validate
    trainer.validate = lambda epoch: vals.append(real(epoch)) or vals[-1]
    trainer.fit()
    loader = next(iter(trainer.train_loaders.values()))
    files = sorted(str(p.relative_to(out_dir)) for p in out_dir.rglob("*") if p.is_file()) \
        if out_dir.exists() else None
    return {"val": vals, "best_loss": trainer.best_loss, "init": init,
            "params": trainer.state.params.clone(), "stats": trainer.state.stats.clone(),
            "critic": (trainer.critic_state.params.clone() if case.get("gan") else None),
            "len": len(loader), "indices": loader._index_order().tolist(), "files": files}


RUNS = {"step3d": step3d, "gan": gan, "step2d": step2d, "trainer3d": trainer3d}


def run(case, mode: str):
    real_sync, real_counts = TS.synced_batch_stats, distributed.sum_counts
    if mode == "local_bn":
        TS.synced_batch_stats = lambda total, rank=0: nullcontext()
    elif mode == "local_loss":
        distributed.sum_counts = lambda count: count * world
    try:
        return RUNS[case["kind"]](case, config_from_dict(case["cfg"]))
    finally:
        TS.synced_batch_stats, distributed.sum_counts = real_sync, real_counts


result = {case["name"]: {mode: run(case, mode) for mode in case.get("modes", ["global"])}
          for case in payload["cases"]}
torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
distributed.destroy_process_group()
