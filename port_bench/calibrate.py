"""Readings that the limits of ``port_bench/limits/<cell>.json`` are set
from, in one process on the card:

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds 2] [--faults]

For each of ``--seeds``: the cell's set-up and a short window of the
program, then its compared numbers against the reference (the lower
readings).  For each of ``--control-seeds``: the control, the reference one
precision down in the program's place, against the reference (the upper
readings); with ``--faults`` also the faults a train cell reads by running
them.  One JSON line per reading on standard output.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from port_bench import run as bench  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--faults", action="store_true")
    args = p.parse_args(argv)
    bench.setup_environment()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = bench.Cell(bench.load_manifest(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        t0 = time.time()
        kind = cell.kind(seed, device)
        kind.setup()
        kind.window(args.seconds)
        failed = kind.failed()
        kind.release()
        torch.cuda.empty_cache()
        print(json.dumps({"cell": cell.name, "seed": seed, "reading": "program",
                          "failed": failed, "numbers": kind.check(),
                          "seconds": time.time() - t0}), flush=True)
        del kind
        gc.collect()
        torch.cuda.empty_cache()
    for seed in controls:
        t0 = time.time()
        kind = cell.kind(seed, device)
        kind.make_inputs()
        print(json.dumps({"cell": cell.name, "seed": seed, "reading": "control",
                          "numbers": kind.control(), "seconds": time.time() - t0}), flush=True)
        if args.faults and hasattr(kind, "faults"):
            for name, numbers in kind.faults().items():
                print(json.dumps({"cell": cell.name, "seed": seed, "reading": f"fault {name}",
                                  "numbers": numbers}), flush=True)
        del kind
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
