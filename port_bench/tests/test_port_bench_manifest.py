"""The manifest and the harness's look-ups: every cell, configuration,
traffic mix, limit file and per-layer reader is found by its name, an
unknown name is refused, and BENCHMARK.json keeps to the benchmark's
contract."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from port_bench import run as bench
from port_bench.tests.tiny import ROOT

MANIFEST = bench.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
PER_LAYER = [m["name"] for m in MANIFEST["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    c = bench.Cell(MANIFEST, cell)
    assert c.config["name"] == c.spec["config"]
    assert (bench.BENCH / "kinds" / f"{c.traffic['kind']}.py").is_file()
    assert isinstance(c.limits(), dict) and c.limits()
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", PER_LAYER)
def test_reader_found_by_name(metric):
    assert callable(bench.reader(metric))


@pytest.mark.parametrize("what", ["workload", "reader"])
def test_unknown_name_refused(what):
    with pytest.raises(bench.BenchError):
        if what == "workload":
            bench.Cell(MANIFEST, "no_such_cell")
        else:
            bench.reader("no_such_metric")


def test_unknown_traffic_kind_refused():
    c = bench.Cell(MANIFEST, CELLS[0])
    c.traffic = dict(c.traffic, kind="no_such_kind")
    with pytest.raises(bench.BenchError):
        c.kind(0, "cpu")


def test_manifest_keeps_the_contract():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["command"] == ["python3", "port_bench/run.py"] and m["paths"] == ["port_bench"]
    assert 1 <= m["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in m[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in m[k]}) == len(m[k])
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    configs = {c["name"] for c in m["configs"]}
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(m["workloads"])
    assert {w["config"] for w in m["workloads"]} == configs
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert set(p) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(p["unit"]) and p["moves"] in e2e
        assert "\n" not in p["layer"] and len(p["layer"]) <= 200
        moved = e2e[p["moves"]]
        for cell in p["workloads"]:
            assert cell in CELLS and bench.applies(moved, cell)
    for cell in CELLS:
        reported = [e for e in m["end_to_end"] if bench.applies(e, cell)]
        assert len(reported) >= 2
        assert any(bench.applies(p, cell) for p in m["per_layer"])


def test_no_card_means_no_result(tmp_path):
    """On a machine without a card the command exits non-zero and prints no
    result line."""
    proc = subprocess.run([sys.executable, str(ROOT / "port_bench/run.py"), "--workload",
                           CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert not proc.stdout.strip()
