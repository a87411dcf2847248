"""Per-request serving latency of the shipped int8 path at several batch
sizes.

Port of the JAX package's ``tools/perf_latency.py``: the reference's
evaluation prints fps only (reference tools/evaluate_2D.py:280); a server
cares about the tail at the batch its load balancer forms.  Each request is
one call of the shipped configuration (``prepare_serving_qparams``:
exchange-scope int8 trunk, the W8A8 layer1 chain, W8A8 stem2, the fused
head; raw uint8 images normalised on the device) on images already on the
device, with the decoded coordinates copied to the host (the copy cannot
finish before the device does).  There is no relay here, so no round-trip
floor is measured or subtracted.  One JSON line per batch size: p50, p99
and mean ms per request and the fps at that batch.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.perf_latency \\
        [--cfg <exp.yaml>] [--batches 8,32,128] [--iters 200] [--device cpu]

Without --cfg it serves the flagship, pose_hrnet_w32 with the softmax head
at 256x256, on seeded random weights (``utils/weights.init_variables``).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Sequence

import numpy as np
import torch


def shipped_infer(cfg, device="cuda", seed: int = 0):
    """(infer, weights, qparams) of the shipped int8 configuration on
    seeded weights, calibrated on 16 seeded normalised images."""
    from ..core.fast_infer import precast_variables
    from ..core.quant_infer import (IMAGENET_MEAN, IMAGENET_STD, calibrate, make_quant_infer,
                                    prepare_serving_qparams)
    from ..utils.weights import init_variables

    dev = torch.device(device)
    h, w = int(cfg.MODEL.IMAGE_SIZE[1]), int(cfg.MODEL.IMAGE_SIZE[0])
    state = {k: v.to(dev) for k, v in init_variables(cfg, seed, device=dev).items()}
    weights = precast_variables(cfg, state, device=dev)
    calib = np.random.default_rng(seed).normal(size=(16, h, w, 3)).astype(np.float32)
    amax = calibrate(cfg, weights, [torch.from_numpy(calib)])
    qparams = prepare_serving_qparams(cfg, state, amax, scope="exchange")
    infer = make_quant_infer(cfg, dev, input_norm=(IMAGENET_MEAN, IMAGENET_STD))
    return infer, weights, qparams


def latency_rows(cfg, batches: Sequence[int], iters: int, warmup: int = 20,
                 device="cuda", seed: int = 0) -> List[Dict[str, object]]:
    """One row per batch size: per-request latency percentiles in ms."""
    infer, weights, qparams = shipped_infer(cfg, device, seed)
    h, w = int(cfg.MODEL.IMAGE_SIZE[1]), int(cfg.MODEL.IMAGE_SIZE[0])
    rng = np.random.default_rng(seed + 1)
    rows = []
    for b in batches:
        images = torch.from_numpy(rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8)
                                  ).to(device)
        lat = []
        for i in range(warmup + iters):
            t0 = time.perf_counter()
            out = infer(weights, qparams, images).cpu()       # the copy waits for the card
            if i >= warmup:
                lat.append((time.perf_counter() - t0) * 1e3)
        if tuple(out.shape) != (b, int(cfg.MODEL.NUM_JOINTS), 2):
            raise AssertionError(f"served {tuple(out.shape)} at batch {b}")
        lat = np.asarray(lat)
        p50, p99 = np.percentile(lat, [50, 99])
        rows.append({"metric": "serving_latency", "batch": b, "iters": iters,
                     "p50_ms": float(p50), "p99_ms": float(p99), "mean_ms": float(lat.mean()),
                     "fps_at_batch": float(b / (lat.mean() / 1e3)),
                     "device": (torch.cuda.get_device_name(0) if torch.device(device).type
                                == "cuda" else "cpu")})
    return rows


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", default="", help="experiment YAML (default: the flagship)")
    p.add_argument("--batches", default="8,32,128")
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.cfg:
        from ..config import load_config

        cfg = load_config(args.cfg)
    else:
        from .accuracy_gate_full import flagship_train_cfg

        cfg = flagship_train_cfg()
    for row in latency_rows(cfg, [int(s) for s in args.batches.split(",")], args.iters,
                            args.warmup, args.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
