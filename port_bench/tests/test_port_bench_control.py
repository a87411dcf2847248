"""The comparison that decides ``correct`` fails where it must.

- The control (the reference one precision down in the program's place:
  int4 for the int8 cells, float8 e4m3 for the bf16 and train cells) fails
  the cell's limits, on the CPU at the cell's widths and a small batch, and
  on a card at the cell's own size (``cuda`` marker).
- A run whose timed path is broken underneath comes out not correct: the
  harness's look for a card skipped, the rest of a run driven on the CPU at
  a tiny size with the cell's limits, once for each fault the cell can
  have, and for a serving answer wrong in a few rows, for a train step
  that leaves the BN statistics unmoved.  The cells run on one card, so no exchange between cards can be
  left out.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from port_bench import run as bench
from port_bench.tests.tiny import run_tiny, tiny_cell, tiny_traffic

SERVE = [("w32_int8_serve_b256", "serve_int8_b256"), ("w48_int8_serve_b128", "serve_int8_b128"),
         ("w32_bf16_serve_b256", "serve_bf16_b256")]
TRAIN = [("w32_train_b256", "train_b256")]
MANIFEST = bench.load_manifest()
CELLS = {w["name"] for w in MANIFEST["workloads"]}
SERVE = [c for c in SERVE if c[0] in CELLS]
TRAIN = [c for c in TRAIN if c[0] in CELLS]


def limits(cell: str) -> dict:
    return bench.Cell(MANIFEST, cell).limits()


def fails(numbers: dict, cell: str) -> bool:
    return not bench.passes(bench.compare(numbers, limits(cell)))


# -- the control ---------------------------------------------------------------

@pytest.mark.parametrize("cell,mix", SERVE)
def test_serving_control_fails_at_the_cells_widths(cell, mix):
    torch.set_num_threads(4)
    c = bench.Cell(MANIFEST, cell)
    c.traffic = dict(tiny_traffic(mix, batch=2), distinct_batches=1)
    kind = c.kind(2 ** 32 + 17, torch.device("cpu"))
    kind.make_inputs()
    assert fails(kind.control(), cell)


@pytest.mark.parametrize("cell,mix", TRAIN)
def test_train_control_fails(cell, mix):
    torch.set_num_threads(4)
    c = tiny_cell(cell, mix, batch=8)
    kind = c.kind(2 ** 32 + 19, torch.device("cpu"))
    kind.make_inputs()
    assert fails(kind.control(), cell)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c, _ in SERVE + TRAIN])
def test_control_fails_on_a_card_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    c = bench.Cell(MANIFEST, cell)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        kind = c.kind(seed, torch.device("cuda", 0))
        kind.make_inputs()
        assert fails(kind.control(), cell), seed
        del kind
        torch.cuda.empty_cache()


# -- faults planted under a run ------------------------------------------------------

def times_four(kind):
    """An answer altered where it is produced: the first batch's coordinates
    in image pixels (4x the heatmap's)."""
    kind.wrong = lambda coords, i: coords * 4.0 if i == 0 else coords


def half_batch(kind):
    """Half of each batch left out: the second half's answers never written."""
    def wrong(coords, i):
        out = coords.clone()
        out[coords.shape[0] // 2:] = 0.0
        return out
    kind.wrong = wrong


def block_of_rows(kind):
    """An answer altered where it is produced in a few rows alone: a sixteenth
    of each batch (one row at least) 20 heatmap pixels off."""
    def wrong(coords, i):
        out = coords.clone()
        out[:max(1, coords.shape[0] // 16)] += 20.0
        return out
    kind.wrong = wrong


def unchanged_state(kind):
    """A step that returns its state unchanged (losses still computed)."""
    def fault(step):
        def broken(state, batch):
            saved = (state.params.clone(), {k: v.clone() for k, v in state.opt_state.items()},
                     state.stats.clone())
            state, out = step(state, batch)
            state.params.copy_(saved[0])
            state.opt_state = saved[1]
            state.stats.copy_(saved[2])
            return state, out
        return broken
    kind.fault = fault


def unchanged_stats(kind):
    """A step that moves the parameters and leaves the BN statistics as they were."""
    def fault(step):
        def broken(state, batch):
            saved = state.stats.clone()
            state, out = step(state, batch)
            state.stats.copy_(saved)
            return state, out
        return broken
    kind.fault = fault


def half_train_batch(kind):
    """Half of each batch left out, the mean taken over the rest."""
    def fault(step):
        def broken(state, batch):
            half = batch["images"].shape[0] // 2
            return step(state, {k: v[:half] for k, v in batch.items()})
        return broken
    kind.fault = fault


@pytest.mark.parametrize("cell,mix", SERVE)
def test_a_sound_tiny_serving_run_is_correct(cell, mix):
    assert run_tiny(tiny_cell(cell, mix, side=128), 2 ** 40 + 3, limits(cell))["correct"]


@pytest.mark.parametrize("fault", [times_four, half_batch, block_of_rows])
@pytest.mark.parametrize("cell,mix", SERVE)
def test_a_broken_serving_path_is_not_correct(cell, mix, fault):
    result = run_tiny(tiny_cell(cell, mix, side=128), 2 ** 40 + 3, limits(cell), plant=fault)
    assert not result["correct"]


@pytest.mark.parametrize("fault", [unchanged_state, unchanged_stats, half_train_batch])
@pytest.mark.parametrize("cell,mix", TRAIN)
def test_a_broken_train_step_is_not_correct(cell, mix, fault):
    result = run_tiny(tiny_cell(cell, mix, batch=8), 2 ** 40 + 5, limits(cell), plant=fault)
    assert not result["correct"]


@pytest.mark.parametrize("cell,mix", SERVE)
def test_a_few_wrong_rows_fail_at_the_cells_batch(cell, mix):
    """A sixteenth of one answer's rows off by 8x the answer's limit, the
    rest exact: the answer's mean stays at half its limit, the worst
    image's does not pass."""
    c = bench.Cell(MANIFEST, cell)
    b, k = int(c.traffic["batch"]), int(c.config["experiment"]["MODEL"]["NUM_JOINTS"])
    lim = limits(cell)
    off = 8.0 * lim["worst_answer_gap_px"]
    expect = torch.rand((b, k, 2), generator=torch.Generator().manual_seed(b)) * 64
    coords = expect.numpy().copy()
    coords[:b // 16] += off
    numbers = c.kind(1, torch.device("cpu")).numbers([(0, coords)], [expect])
    assert np.isclose(numbers["worst_answer_gap_px"], off / 16, rtol=1e-5)
    assert numbers["worst_answer_gap_px"] <= lim["worst_answer_gap_px"]
    assert np.isclose(numbers["worst_image_gap_px"], off, rtol=1e-5)
    assert fails(numbers, cell)


def test_a_missing_answer_is_not_correct():
    """An answer that never comes counts as failed."""
    cell, mix = SERVE[0]

    def lost(kind):
        original = copy.copy(kind.run_batches)

        def run_batches(*args, **kw):
            out = original(*args, **kw)
            if kw.get("seconds") is not None and kind.records:
                kind.records[0].coords = None
            return out
        kind.run_batches = run_batches

    result = run_tiny(tiny_cell(cell, mix), 2 ** 40 + 7, limits(cell), plant=lost)
    assert not result["correct"] and result["failed"] >= 1
