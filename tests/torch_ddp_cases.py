"""Shared harness of the port's data-parallel parity tests (not a test
module): two gloo CPU ranks of ``tests/torch_ddp_cases_child.py`` run a
list of cases while the test process computes the references, then the
ranks' results are read back and measured.

A check is a ratio, the largest gap over its limit: the data-parallel run
must stay at or under 1 and each witness (per-rank BN statistics or
per-rank loss denominators) must go over it, so the check can fail.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Dict, List

import numpy as np
import torch

CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_ddp_cases_child.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
WITNESSES = ("local_bn", "local_loss")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(cases: List[Dict], work, grid=None) -> List[subprocess.Popen]:
    """Write the cases to ``work/input.pt`` and start the ranks: WORLD of
    them, or a ``grid`` (data, model) of them."""
    world = WORLD if grid is None else grid[0] * grid[1]
    torch.save({"cases": cases} if grid is None else {"cases": cases, "grid": tuple(grid)},
               os.path.join(work, "input.pt"))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    return [subprocess.Popen([sys.executable, CHILD, str(r), str(world), str(port), str(work)],
                             env=env) for r in range(world)]


def collect(procs: List[subprocess.Popen], work, timeout: int = 300) -> List[Dict]:
    """Wait for the ranks; their results, rank by rank."""
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0] * len(procs), f"rank exit codes {codes}"
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def bit_equal(a, b) -> bool:
    """Nested dicts / lists of tensors and numbers, equal bit for bit."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(bit_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(bit_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a == b


def _ratio(gap: float, limit: float) -> float:
    """gap / limit; a zero limit (a zero reference) admits no gap."""
    return gap / limit if limit else (0.0 if gap == 0 else float("inf"))


def loss_ratio(got: Dict[str, float], want: Dict[str, float], rtol: float,
               atol: float = 0.0) -> float:
    """The largest |got - want| / (rtol |want| + atol) over the losses."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    return max(_ratio(abs(got[k] - want[k]), rtol * abs(want[k]) + atol) for k in want)


def tensor_ratio(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], rtol: float,
                 atol: float = 0.0) -> float:
    """The largest max|got - want| / (rtol max|want| + atol) over the tensors
    (each tensor's own scale)."""
    worst = 0.0
    for name, w in want.items():
        g = got[name].reshape(w.shape).float()
        gap = float((g - w.float()).abs().max()) if w.numel() else 0.0
        scale = float(w.abs().max()) if w.numel() else 0.0
        worst = max(worst, _ratio(gap, rtol * scale + atol))
    return worst


def allclose_ratio(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], rtol: float,
                   atol: float) -> float:
    """The largest |got - want| / (atol + rtol |want|), element by element
    (``assert_allclose``'s test), over the tensors."""
    return max(float(((got[k].reshape(w.shape).float() - w.float()).abs()
                      / (atol + rtol * w.float().abs())).max()) for k, w in want.items())


def stats_only(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The BN running means and variances of a state dict or its batch_stats."""
    return {k: v for k, v in tensors.items() if k.endswith(("running_mean", "running_var"))}


def split_visibility(vis: np.ndarray) -> np.ndarray:
    """``vis`` with joints hidden in the second half of the batch only, so
    the ranks' visible counts differ and the global denominator is not the
    mean of the ranks' own."""
    vis = vis.copy()
    b = vis.shape[0]
    vis[b // 2:, ..., ::3] = 0.0
    vis[b - 1, ..., 1::4] = 0.0
    return vis
