"""The benchmark of ``hrnet_hand_pose_estimation_tpu_torch`` on NVIDIA cards.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell is looked up by name in
``BENCHMARK.json``; its configuration file, its traffic mix
(``port_bench/traffic/<mix>.json``, whose ``kind`` names the generator in
``port_bench/kinds``), its limits (``port_bench/limits/<cell>.json``) and,
with ``--trace 1``, each per-layer metric's reader
(``port_bench/metrics/<metric>.py``) are found by name; an unknown name
fails the run.

A run: set-up (weights from the seed, inputs, the program's derived state,
warm-up), the measured window of ``--seconds``, with ``--trace 1`` a traced
window of the mix's ``trace_units`` after it, then the comparison of what
the timed path produced with the plain reference in ``port_bench/reference``.
The last lines of standard error give each compared number beside its
limit; the last line of standard output is the result as one JSON object,
which also lists the seconds of each part of set-up (``setup_phases``).
Exit codes: 0 a result was printed (``correct`` may be false); 2 no card,
or fewer cards than the cell needs; 3 the JAX package or JAX was loaded;
1 any other failure.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
CACHE = ROOT / "build" / "port_bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "hrnet_hand_pose_estimation_tpu")
GIB = 1024 ** 3


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


class BenchError(Exception):
    pass


class ForbiddenModules(Exception):
    pass


def load_manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise BenchError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise BenchError(f"unknown {what} {name!r}; known: {[e['name'] for e in entries]}")


def read_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise BenchError(f"no {what} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """A cell of the manifest with its configuration, traffic and limits."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT):
        self.manifest = manifest
        self.spec = find(manifest["workloads"], name, "workload")
        self.name = name
        entry = find(manifest["configs"], self.spec["config"], "configuration")
        self.config = read_json(root / entry["file"], "configuration")
        self.traffic = read_json(BENCH / "traffic" / f"{self.spec['traffic']}.json", "traffic")
        self.limits_path = BENCH / "limits" / f"{name}.json"
        self.chips = int(self.spec["chips"])
        self.end_to_end = [m for m in manifest["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in manifest["per_layer"] if applies(m, name)
                          and any(e["name"] == m["moves"] for e in self.end_to_end)]

    def limits(self) -> dict:
        return read_json(self.limits_path, "limits")

    def kind(self, seed: int, device):
        from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict

        name = self.traffic["kind"]
        if not (BENCH / "kinds" / f"{name}.py").is_file():
            raise BenchError(f"unknown traffic kind {name!r} (no port_bench/kinds/{name}.py)")
        kind = importlib.import_module(f"port_bench.kinds.{name}").Kind
        cfg = config_from_dict(self.config["experiment"], list(self.config["overrides"]))
        return kind(self.config, self.traffic, seed, device, cfg)


def reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise BenchError(f"no reader for per-layer metric {metric!r} ({path.name})")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class ReadContext:
    """What a per-layer reader reads: the trace, the host spans, the counts."""

    def __init__(self, cell: Cell, kind, summary, host_ms):
        self.model_cfg = cell.config["experiment"]["MODEL"]
        self.traffic = cell.traffic
        self.summary = summary
        self.items_per_unit = kind.per_unit_items()
        self.host_ms = host_ms


def compare(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of every compared number; a number with
    no limit, or a limit with no number, is listed with a null."""
    out = {}
    for name in sorted(set(numbers) | set(limits)):
        out[name] = {"value": numbers.get(name), "limit": limits.get(name)}
    return out


def passes(checks: dict) -> bool:
    return all(c["value"] is not None and c["limit"] is not None
               and c["value"] <= c["limit"] for c in checks.values())


def execute(cell: Cell, kind, seconds: float, trace: bool, device, limits: dict,
            t_process: float, marks=()) -> dict:
    """Set-up, window, traced window and comparison of one run; returns the
    result object.  Raises BenchError where a forbidden module is loaded.
    ``marks``: (name, wall-clock time) of the steps from the process's
    start to here, listed in ``setup_phases``."""
    import torch

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    t_setup = time.time()
    kind.setup()
    sync()
    setup_s = time.time() - t_process
    phases, t = {}, t_process
    for name, at in list(marks) + [("kind", t_setup)]:
        phases[name], t = at - t, at
    phases.update(kind.phases)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    values = kind.window(float(seconds))
    sync()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    values["peak_mem_gib"] = peak / GIB
    values["setup_s"] = setup_s
    result_device = {"platform": "gpu" if cuda else "cpu",
                     "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                     "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    metrics = {}
    if trace:
        from port_bench.trace import SPAN_PREFIX, traced

        span = lambda name: torch.profiler.record_function(SPAN_PREFIX + name)
        summary = traced(lambda n: kind.traced_units(n, span),
                         int(cell.traffic["trace_units"]), device)
        ctx = ReadContext(cell, kind, summary, list(kind.window_host_ms))
        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result_device["busy_s"] = summary.busy_s()
        result_device["window_s"] = summary.window_s
        breakdown = {"device_ops": summary.top_ops(), "idle_gaps": summary.idle_gaps()}
    else:
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise BenchError(f"cell {cell.name} reports no {m['name']}")
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    attempted, failed = kind.attempted(), kind.failed()
    kind.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = compare(kind.check(), limits)
    checks["failed_units"] = {"value": failed, "limit": 0}
    result = {"correct": bool(passes(checks) and attempted > 0), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_phases"] = phases
    result["checks"] = checks
    return result


def run(args) -> int:
    t_process = process_start()
    marks = [("python", time.time())]
    import torch

    marks.append(("import_torch", time.time()))
    cell = Cell(load_manifest(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    limits = cell.limits()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros((), device=device)
    marks.append(("cuda_init", time.time()))
    try:
        result = execute(cell, cell.kind(args.seed, device), args.seconds, bool(args.trace),
                         device, limits, t_process, marks)
    except ForbiddenModules as exc:
        print(f"forbidden modules loaded in this process: {exc.args[0]}", file=sys.stderr)
        return 3
    print("setup phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                           result["setup_phases"].items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def setup_environment() -> None:
    """Caches inside the checkout, at fixed paths; the first run builds."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.setswitchinterval(0.001)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    args = parse(argv)
    setup_environment()
    try:
        return run(args)
    except BenchError as exc:
        print(f"port_bench: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
