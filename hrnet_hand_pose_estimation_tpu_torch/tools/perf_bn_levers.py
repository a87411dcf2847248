"""Time the train step with the train-mode BN statistics levers.

Port of the JAX package's ``tools/perf_bn_levers.py``: the flagship's train
step (pose_hrnet_w32 softmax at 256x256, adam, bf16 compute) from a seeded
state on one seeded batch, with each lever of ``models/layers.set_bn_levers``
against the baseline (float32 statistics over the whole batch):

  - bf16 statistics      (``stat_dtype='bfloat16'``)
  - statistics over B/4  (``stat_samples=B // 4``)
  - statistics over B/8
  - bf16 over B/4

Each row: ms per step (CUDA events on a card, the host clock on the CPU,
after warm-up steps) and the total loss of every step, which must stay
finite and fall on the fixed batch.  One JSON line per row.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.perf_bn_levers \\
        [--batch 32] [--steps 10] [--device cpu] [--cfg <exp.yaml>]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


def lever_configs(batch: int) -> List[Tuple[str, Dict[str, object]]]:
    return [("baseline (float32 statistics, whole batch)", {}),
            ("bf16 statistics", {"stat_dtype": "bfloat16"}),
            (f"statistics over {batch // 4}", {"stat_samples": batch // 4}),
            (f"statistics over {batch // 8}", {"stat_samples": batch // 8}),
            (f"bf16 over {batch // 4}", {"stat_samples": batch // 4, "stat_dtype": "bfloat16"})]


def train_batch(cfg, batch: int, device="cuda", seed: int = 0, steps: int = 0) -> Dict:
    """A seeded batch on ``device``: normal images, joints in heatmap px,
    all visible, Gaussian targets (``ops/targets.gaussian_targets``: the
    targets kernel on a card).  ``steps`` > 0 stacks that many batches on a
    leading steps axis."""
    from ..ops.targets import gaussian_targets

    if steps:
        parts = [train_batch(cfg, batch, device, seed + i) for i in range(steps)]
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
    h, w = int(cfg.MODEL.IMAGE_SIZE[1]), int(cfg.MODEL.IMAGE_SIZE[0])
    res = int(cfg.MODEL.HEATMAP_SIZE[0])
    k = int(cfg.MODEL.NUM_JOINTS)
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(size=(batch, h, w, 3)).astype(np.float32)).to(device)
    pose = torch.from_numpy(rng.uniform(2, res - 2, size=(batch, k, 2)).astype(np.float32)
                            ).to(device)
    vis = torch.ones(batch, k, device=device)
    return {"images": images, "pose2d": pose, "visibility": vis,
            "target_heatmaps": gaussian_targets(pose, vis, res, float(cfg.MODEL.SIGMA))}


def timed(device, fn: Callable[[], object], iters: int) -> float:
    """ms per call of ``fn`` over ``iters`` calls: CUDA events on a card,
    the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def lever_rows(cfg, batch: int, configs: Sequence[Tuple[str, Dict[str, object]]],
               steps: int = 10, warmup: int = 2, device="cuda") -> List[Dict[str, object]]:
    """One row per (label, levers): ms per train step and the total losses
    of its warm-up and timed steps, from the same seeded state and batch."""
    from ..models import build_model
    from ..models.layers import set_bn_levers
    from ..parallel.train_step import create_train_state, make_train_step

    data = train_batch(cfg, batch, device)
    rows = []
    for label, levers in configs:
        set_bn_levers(**levers)
        try:
            model = build_model(cfg)
            state, tx = create_train_state(cfg, model, device=device)
            step = make_train_step(cfg, model, tx)
            losses = []

            def one():
                nonlocal state
                state, out = step(state, data)
                losses.append(out["total_loss"])

            for _ in range(warmup):
                one()
            ms = timed(device, one, steps)
        finally:
            set_bn_levers()
        rows.append({"label": label, "levers": levers, "batch": batch, "ms_per_step": ms,
                     "losses": [float(v) for v in torch.stack(losses).cpu()]})
        del model, state, step
    return rows


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", default="", help="experiment YAML (default: the flagship)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    from .accuracy_gate_full import flagship_train_cfg

    if args.cfg:
        from ..config import load_config

        cfg = load_config(args.cfg)
    else:
        cfg = flagship_train_cfg()
    for row in lever_rows(cfg, args.batch, lever_configs(args.batch), args.steps, args.warmup,
                          args.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
