"""One gloo rank of a data x model grid of the port's 2D training, for
tests/test_torch_tp_train.py and tests/test_torch_tp_trainer.py (JAX-free,
in the manner of tests/torch_ddp_child.py).

Usage: torch_tp_child.py <rank> <world_size> <port> <workdir>

Reads ``workdir/input.pt``: {"cfg": the port config as a dict, "grid":
(data, model), "state": the initial train state (``TrainState.state_dict()``
layout, whole leaves), "batches": global batches as numpy dicts,
"lever_batch", "levers" (``set_bn_levers`` keywords), "trainer_cfg",
"cases": the runs to make}.  Joins a gloo group of ``world_size`` CPU ranks
on ``tcp://localhost:<port>``, lays it out as the grid, and runs from the
same initial state, each on its data rank's slice of every global batch:

- "plain": ``make_train_step`` over the batches;
- "multi": ``make_train_multistep`` over the same batches stacked (K = 2);
- "levers": one step of the lever batch with the BN statistics levers;
- "poison": one step of the first batch with the gradient of one split
  weight made NaN on the last rank alone;
- "trainer": ``Trainer.fit`` for one epoch of a synthetic set (rank 0
  writes into ``workdir/trainer``), then a second ``Trainer`` that resumes
  from its checkpoint (``AUTO_RESUME``) for one more epoch;
- "toy": tests/torch_tp_toy.py's net split over the rank's model group,
  its output and gathered gradients against the unsplit net's.

Writes ``workdir/rank<r>.pt``: per run the losses, the gathered state and
this rank's own flat parameter buffer (its shards).
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import DataLoader  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.models import build_model  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.models import layers as L  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.parallel import distributed  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.parallel import tensor_parallel as TP  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS  # noqa: E402
from hrnet_hand_pose_estimation_tpu_torch.parallel.mesh import param_shardings  # noqa: E402
from torch_tp_toy import COMPUTED, Toy, toy_input  # noqa: E402

torch.set_num_threads(1)
rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
distributed.init_process_group("gloo", rank=rank, world_size=world,
                               init_method=f"tcp://localhost:{port}")
assert "jax" not in sys.modules
payload = torch.load(os.path.join(workdir, "input.pt"), weights_only=False)
cfg = config_from_dict(payload["cfg"])
data, model_size = distributed.init_grid(("data", "model"), payload["grid"])
assert (distributed.data_rank(), distributed.model_rank()) == divmod(rank, model_size)


def mine(batch):
    """This data rank's slice of a global batch."""
    per = len(batch["images"]) // data
    d = distributed.data_rank()
    return {k: torch.from_numpy(np.ascontiguousarray(v[d * per:(d + 1) * per]))
            for k, v in batch.items()}


def fresh():
    model = build_model(cfg)
    state, tx = TS.create_train_state(cfg, model, device="cpu")
    state.load_state_dict(payload["state"])
    return model, state, tx


def result(state, losses):
    return {"losses": losses, "state": state.state_dict(), "local": state.params.clone(),
            "local_opt": {k: v.clone() for k, v in state.opt_state.items()},
            "shardings": TS.state_shardings(model_size, state)}


def run_steps(batches, levers=None, poison=False):
    L.set_bn_levers(**(levers or {}))
    try:
        model, state, tx = fresh()
        if poison and rank == world - 1:
            weight = model.get_submodule("layer1.0.conv3").weight
            weight.register_hook(lambda g: g * float("nan"))
        step = TS.make_train_step(cfg, model, tx)
        losses = []
        for batch in batches:
            state, out = step(state, mine(batch))
            losses.append({k: float(v) for k, v in out.items()})
        return result(state, losses)
    finally:
        L.set_bn_levers()


def run_multi(batches):
    model, state, tx = fresh()
    parts = [mine(b) for b in batches]
    stacked = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
    state, out = TS.make_train_multistep(cfg, model, tx)(state, stacked)
    return result(state, [{k: float(v[i]) for k, v in out.items()} for i in range(len(parts))])


def run_trainer():
    tcfg = config_from_dict(payload["trainer_cfg"])
    out = {}
    for run, end in (("first", 1), ("resumed", 2)):
        tcfg.defrost()
        tcfg.TRAIN.END_EPOCH = end
        tcfg.freeze()
        loader = DataLoader(SyntheticDataset(tcfg, length=8), 2, shuffle=True, num_workers=0)
        trainer = Trainer(tcfg, build_model(tcfg), {"s": loader},
                          {"v": DataLoader(SyntheticDataset(tcfg, length=4), 2, shuffle=False,
                                           num_workers=0)}, device="cpu")
        begin = trainer.begin_epoch
        trainer.fit()
        dist.barrier()                   # rank 0's checkpoint is on disk
        out[run] = {"begin": begin, "steps": trainer.train_global_steps,
                    "indices": loader._index_order().tolist(),
                    "state": trainer.state.state_dict(), "local": trainer.state.params.clone()}
    return out


def run_toy():
    """The toy's forward and backward, unsplit and split over the model group."""
    x = toy_input()
    ref = Toy()
    (ref(x) ** 2).sum().backward()
    toy = Toy()
    split = param_shardings(model_size, toy)
    TP.shard_for_rank(toy, split, distributed.model_rank(), model_size,
                      distributed.model_group())
    out = toy(x)
    (out ** 2).sum().backward()
    want = {n: p.grad for n, p in ref.named_parameters()}
    grads = {TP.public_name(n): TP.gather_full(toy, TP.public_name(n), p.grad)
             for n, p in toy.named_parameters()}
    return {"split": split, "out_gap": float((out - ref(x)).abs().max()),
            "grad_gap": max(float((grads[n] - g).abs().max() / g.abs().max())
                            for n, g in want.items()),
            "names": sorted(grads) == sorted(want),
            "computed": [isinstance(toy.get_submodule(m), TP._Split) for m in COMPUTED]}


runs = {"plain": lambda: run_steps(payload["batches"]),
        "multi": lambda: run_multi(payload["batches"]),
        "levers": lambda: run_steps([payload.get("lever_batch")], levers=payload.get("levers")),
        "poison": lambda: run_steps(payload["batches"][:1], poison=True),
        "trainer": run_trainer,
        "toy": run_toy}
out = {name: runs[name]() for name in payload["cases"]}
torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
distributed.destroy_process_group()
