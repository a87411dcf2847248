"""A tiny cell for the CPU tests: the w32 configuration at a quarter of its
widths and a 64x64 image, with small batches; the program runs its kernels'
plain twins."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import torch

from port_bench import run as bench

ROOT = Path(__file__).resolve().parents[2]
TRAFFIC = ROOT / "port_bench" / "traffic"


def tiny_config(width: int = 8, side: int = 64) -> dict:
    cfg = json.loads((ROOT / "port_bench/configs/hrnet_w32_256.json").read_text())
    cfg = copy.deepcopy(cfg)
    model = cfg["experiment"]["MODEL"]
    model["IMAGE_SIZE"] = [side, side]
    model["HEATMAP_SIZE"] = [side // 4, side // 4]
    for n in (2, 3, 4):
        stage = model["EXTRA"][f"STAGE{n}"]
        stage["NUM_CHANNELS"] = [width * 2 ** i for i in range(len(stage["NUM_CHANNELS"]))]
        stage["NUM_BLOCKS"] = [1] * len(stage["NUM_BLOCKS"])
        stage["NUM_MODULES"] = 1
    return cfg


def tiny_traffic(mix: str, batch: int = 4) -> dict:
    traffic = json.loads((TRAFFIC / f"{mix}.json").read_text())
    traffic.update(batch=batch, warmup=1, trace_units=2, distinct_batches=2)
    if "calibration_images" in traffic:
        traffic["calibration_images"] = 2
    if traffic["kind"] == "train":
        traffic["compared"] = 2
    return traffic


def tiny_cell(cell: str, mix: str, batch: int = 4, side: int = 64) -> "bench.Cell":
    """The manifest's cell with its configuration and traffic made tiny."""
    c = bench.Cell(bench.load_manifest(), cell)
    c.config = tiny_config(side=side)
    c.traffic = tiny_traffic(mix, batch)
    return c


def run_tiny(cell: "bench.Cell", seed: int, limits: dict, seconds: float = 0.5,
             trace: bool = False, plant=None) -> dict:
    """One run of ``cell`` on the CPU; ``plant(kind)`` may break the timed
    path before set-up."""
    torch.set_num_threads(2)
    kind = cell.kind(seed, torch.device("cpu"))
    if plant is not None:
        plant(kind)
    return bench.execute(cell, kind, seconds, trace, torch.device("cpu"), limits, 0.0)
