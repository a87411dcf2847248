"""Sweep TPU.STEPS_PER_DISPATCH (K): ms per train step at K steps a call.

Port of the JAX package's ``tools/perf_multistep_sweep.py``: the
flagship's train step (``tools/perf_bn_levers``'s configuration and seeded
batches) through ``parallel/train_step.make_train_multistep`` at each K,
from a fresh seeded state, a warm-up call, then ``--steps`` steps
(steps / K calls, at least one) timed with CUDA events (the host clock on
the CPU), so every K times the same number of steps.  The port's K steps run
in order in one call, with no host sync inside; what K can save is the
host's per-call work, which this measures.  One JSON line per K.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.perf_multistep_sweep \\
        [--ks 1,2,4,8] [--batch 32] [--steps 8] [--device cpu] [--cfg <exp.yaml>]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Sequence

import torch

from .perf_bn_levers import timed, train_batch


def sweep_rows(cfg, batch: int, ks: Sequence[int], steps: int = 8,
               device="cuda") -> List[Dict[str, object]]:
    from ..models import build_model
    from ..parallel.train_step import create_train_state, make_train_multistep

    rows = []
    for k in ks:
        data = train_batch(cfg, batch, device, steps=k)
        model = build_model(cfg)
        state, tx = create_train_state(cfg, model, device=device)
        multi = make_train_multistep(cfg, model, tx)
        losses = []

        def one():
            nonlocal state
            state, out = multi(state, data)
            losses.append(out["total_loss"])

        one()
        calls = max(1, steps // k)
        ms = timed(device, one, calls) / k
        rows.append({"k": k, "batch": batch, "calls": calls, "ms_per_step": ms,
                     "losses": [float(v) for v in torch.cat(losses).cpu()]})
        del model, state, multi
    return rows


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", default="", help="experiment YAML (default: the flagship)")
    p.add_argument("--ks", default="1,2,4,8")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    from .accuracy_gate_full import flagship_train_cfg

    if args.cfg:
        from ..config import load_config

        cfg = load_config(args.cfg)
    else:
        cfg = flagship_train_cfg()
    for row in sweep_rows(cfg, args.batch, [int(s) for s in args.ks.split(",")],
                          args.steps, args.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
