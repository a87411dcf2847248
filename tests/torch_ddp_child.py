"""One gloo rank of the port's data-parallel 2D training, for
tests/test_torch_ddp.py (JAX-free, in the manner of tests/multihost_child.py).

Usage: torch_ddp_child.py <rank> <world_size> <port> <workdir>

Reads ``workdir/input.pt``: {"cfg": the port config as a dict, "state":
the initial train state (``TrainState.state_dict()`` layout), "batches":
global batches as numpy dicts, "trainer_cfg": a config dict for the
Trainer run}.  Joins a gloo group of ``world_size`` CPU ranks on
``tcp://localhost:<port>`` and runs, from the same initial state, the
global batches' steps on this rank's slice of each:

- "global": the data-parallel step as shipped;
- "local_bn": the same with per-rank BN statistics (a witness);
- "local_loss": the same with per-rank loss normalisation, the mean of
  the ranks' ratios instead of the global ratio (a witness);

then ``Trainer.fit`` for one epoch of a synthetic set, each rank with its
own OUTPUT_DIR.  Writes ``workdir/rank<r>.pt`` with each run's losses and
final state.
"""

import os
import sys
from contextlib import nullcontext

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import DataLoader  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.models import build_model  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.parallel import distributed  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS  # noqa: E402

torch.set_num_threads(1)
rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
distributed.init_process_group("gloo", rank=rank, world_size=world,
                               init_method=f"tcp://localhost:{port}")
assert "jax" not in sys.modules
payload = torch.load(os.path.join(workdir, "input.pt"), weights_only=False)
cfg = config_from_dict(payload["cfg"])


def run(mode: str):
    real_sync, real_counts = TS.synced_batch_stats, distributed.sum_counts
    if mode == "local_bn":
        TS.synced_batch_stats = lambda total, rank=0: nullcontext()
    elif mode == "local_loss":
        distributed.sum_counts = lambda count: count * world
    try:
        model = build_model(cfg)
        state, tx = TS.create_train_state(cfg, model, device="cpu")
        state.load_state_dict(payload["state"])
        step = TS.make_train_step(cfg, model, tx)
        losses = []
        for batch in payload["batches"]:
            per = len(batch["images"]) // world
            mine = {k: torch.from_numpy(np.ascontiguousarray(v[rank * per:(rank + 1) * per]))
                    for k, v in batch.items()}
            state, out = step(state, mine)
            losses.append({k: float(v) for k, v in out.items()})
        return {"losses": losses, "state": state.state_dict()}
    finally:
        TS.synced_batch_stats, distributed.sum_counts = real_sync, real_counts


result = {mode: run(mode) for mode in ("global", "local_bn", "local_loss")}

tcfg = config_from_dict(payload["trainer_cfg"])
tcfg.defrost()
tcfg.OUTPUT_DIR = os.path.join(workdir, f"trainer_r{rank}")
tcfg.freeze()
loader = DataLoader(SyntheticDataset(tcfg, length=8), 2, shuffle=True, num_workers=0)
trainer = Trainer(tcfg, build_model(tcfg), {"s": loader},
                  {"v": DataLoader(SyntheticDataset(tcfg, length=4), 2, shuffle=False,
                                   num_workers=0)}, device="cpu")
trainer.fit()
result["trainer"] = {"len": len(loader), "steps": trainer.train_global_steps,
                     "best_loss": trainer.best_loss,
                     "params": trainer.state.params.clone(),
                     "indices": loader._index_order().tolist()}
torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
distributed.destroy_process_group()
