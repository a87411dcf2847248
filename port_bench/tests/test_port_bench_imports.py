"""What the benchmark loads: a run loads neither JAX nor the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the program either."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from port_bench.tests.tiny import ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "hrnet_hand_pose_estimation_tpu"}
PORT = "hrnet_hand_pose_estimation_tpu_torch"


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell,mix", [("w32_int8_serve_b256", "serve_int8_b256"),
                                      ("w32_bf16_serve_b256", "serve_bf16_b256"),
                                      ("w32_train_b256", "train_b256")])
def test_a_run_loads_no_jax(cell, mix):
    names = loaded_after(
        "from port_bench.tests.tiny import tiny_cell, run_tiny\n"
        "from port_bench import run as bench, calibrate\n"
        f"c = tiny_cell({cell!r}, {mix!r}, batch=2)\n"
        "run_tiny(c, 1, {}, seconds=0.05, trace=True)\n"
        "[bench.reader(m['name']) for m in c.per_layer]\n")
    assert PORT in names
    assert not names & JAX_SIDE


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after("import port_bench.reference.model, port_bench.reference.weights, "
                         "port_bench.reference.counts, port_bench.reference.serve, "
                         "port_bench.reference.train")
    assert PORT not in names
    assert not names & JAX_SIDE


def test_the_reference_sources_name_no_program():
    for path in (ROOT / "port_bench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "hrnet_hand_pose_estimation_tpu" not in text, path.name
        assert "import jax" not in text and "from jax" not in text, path.name
