"""Training traffic: the program's 2D train step called back to back on
device-resident batches.

A mix file (``traffic/<mix>.json``, ``"kind": "train"``) gives ``batch``,
``distinct_batches`` (made from the seed at set-up, cycled), ``compared``
(the first steps, run in set-up on distinct batches, that the reference
follows) and ``trace_units`` (steps in the traced window).

Set-up builds one train state (``parallel/train_step.create_train_state``
on the registry's model), loads the seeded weights into it, and drives it
through the compared steps with the step the window calls; that same state
goes on into the window.  The window issues steps until its seconds have
passed and ends with a synchronize.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ..reference.model import BN_MOMENTUM
from ..reference.train import Reference, make_batches, param_names, stat_names
from ..reference.weights import make_state
from . import Phases
from .serve import IMAGENET_MEAN, IMAGENET_STD, _null

SALT_DATA = 0x7A1


def leaf_norms(flat: torch.Tensor, names: List[str], shapes) -> Dict[str, float]:
    """Per-parameter norms of a flat buffer laid out as the train state
    lays its parameters (``TrainState``: one view per parameter, in order)."""
    sizes = [int(np.prod(s)) for s in shapes]
    return dict(zip(names, torch.stack([v.norm() for v in flat.split(sizes)]).tolist()))


class TrainKind:
    end_to_end = ("train_images_per_s", "peak_mem_gib")

    def __init__(self, cfg_file: Dict, traffic: Dict, seed: int, device, cfg_node):
        self.file = cfg_file
        self.mc = cfg_file["experiment"]["MODEL"]
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.cfg = cfg_node
        self.batch = int(traffic["batch"])
        self.fault = None                 # set by tests: plants a fault in the step

    def setup(self) -> None:
        from hrnet_hand_pose_estimation_tpu_torch.models.registry import build_model
        from hrnet_hand_pose_estimation_tpu_torch.parallel.train_step import (
            create_train_state, make_train_step)

        t, dev = self.traffic, self.device
        self.phases = Phases()
        self.make_inputs()
        self.phases.mark("inputs")
        model = build_model(self.cfg)
        self.state, tx = create_train_state(self.cfg, model, device=dev)
        with torch.no_grad():
            for name, tensor in list(model.named_parameters()) + list(model.named_buffers()):
                tensor.copy_(self.initial[name])
        step = make_train_step(self.cfg, model, tx)
        self.step = step if self.fault is None else self.fault(step)
        names = [n for n, _ in model.named_parameters()]
        if names != list(self.state.param_names):
            raise RuntimeError("the train state's parameter order is not the model's")
        shapes = [tuple(p.shape) for _, p in model.named_parameters()]
        self.phases.mark("state")
        # the compared steps: each on its own batch, through the window's call
        self.losses: List[torch.Tensor] = []
        self.flags: List[torch.Tensor] = []
        for i in range(int(t["compared"])):
            self.state, out = self.step(self.state, self.batches[i % len(self.batches)])
            self.losses.append(out["total_loss"])
            self.flags.append(out.get("nonfinite_grads", torch.zeros((), device=dev)))
            if i == 0:
                # the first gradient as adam got it: mu = (1 - b1) g after one step
                self.grad1 = {n: v / 0.1 for n, v in leaf_norms(
                    self.state.opt_state["mu"], names, shapes).items()}
        self.change = self.moved(self.state.params, names)
        stats = list(self.state.stat_names)
        if sorted(stats) != sorted(stat_names(self.mc)):
            raise RuntimeError("the train state's BN statistics are not the reference's")
        self.stats_change = self.moved(self.state.stats, stats)
        self.phases.mark("compared_steps")
        self.window_losses: List[torch.Tensor] = []

    def moved(self, flat: torch.Tensor, names: List[str]) -> Dict[str, float]:
        """Per leaf, the norm of its change from the initial state dict; ``flat``
        lays the leaves ``names`` out one after another."""
        start = torch.cat([self.initial[n].reshape(-1).float() for n in names])
        return leaf_norms(flat.detach() - start, names, [self.initial[n].shape for n in names])

    def make_inputs(self) -> None:
        """The seeded initial state dict and batches (the benchmark's)."""
        dev = self.device
        self.initial = make_state(self.mc, self.seed, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed((self.seed ^ SALT_DATA) % (2 ** 63))
        self.batches = make_batches(self.mc, self.batch, int(self.traffic["distinct_batches"]),
                                    gen, dev, IMAGENET_MEAN, IMAGENET_STD,
                                    float(self.mc["SIGMA"]))

    def run_steps(self, count=None, seconds=None, span=None) -> float:
        """Steps back to back; returns the seconds from the first hand-off to
        the synchronize after the last step."""
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        t_stop = t0 + seconds if seconds is not None else None
        i = 0
        self.host_ms = []
        while True:
            if count is not None and i >= count:
                break
            if t_stop is not None and time.perf_counter() >= t_stop:
                break
            batch = self.batches[(i + int(self.traffic["compared"])) % len(self.batches)]
            t_hand = time.perf_counter()
            with span("step") if span else _null():
                self.state, out = self.step(self.state, batch)
            self.host_ms.append((time.perf_counter() - t_hand) * 1e3)
            self.flags.append(out.get("nonfinite_grads", torch.zeros((), device=self.device)))
            self.window_losses.append(out["total_loss"])
            i += 1
        if cuda:
            torch.cuda.synchronize(self.device)
        self.units = i
        return time.perf_counter() - t0

    def window(self, seconds: float) -> Dict[str, float]:
        elapsed = self.run_steps(seconds=seconds)
        self.window_units = self.units
        self.window_host_ms = list(self.host_ms)
        return {"train_images_per_s": self.units * self.batch / elapsed}

    def traced_units(self, units: int, span) -> None:
        self.run_steps(count=units, span=span)

    def attempted(self) -> int:
        return self.window_units

    def failed(self) -> int:
        flags = torch.stack(self.flags).float() if self.flags else torch.zeros(1)
        finite = torch.isfinite(torch.stack(self.window_losses)) if self.window_losses else None
        bad = int(flags.sum().item())
        if finite is not None:
            bad += int((~finite).sum().item())
        return bad

    def per_unit_items(self) -> int:
        return self.batch

    def release(self) -> None:
        for name in ("state", "step"):
            if hasattr(self, name):
                delattr(self, name)

    @staticmethod
    def numbers_from(losses: List[float], grad1: Dict[str, float], change: Dict[str, float],
                     stats: Dict[str, float], ref_losses: List[float],
                     ref_grad1: Dict[str, float], ref_change: Dict[str, float],
                     ref_stats: Dict[str, float]) -> Dict[str, float]:
        """loss_gap: the largest |program - reference| / |reference| over the
        compared steps' total losses.  Per parameter, the gap of the norm of
        the program's first gradient to the reference's, over the larger of
        the reference's norm of that parameter and the median parameter's:
        grad_gap is the largest, grad_gap_median the median.  change_gap: the
        largest such gap of the parameters' change over the compared steps,
        over the parameters whose first reference gradient is at least a
        thousandth of the median parameter's.  stats_gap: the largest such
        gap of the BN running means' and variances' change over the
        compared steps, stats_gap_median the median."""
        names = list(ref_grad1)
        g_med = float(np.median([ref_grad1[n] for n in names]))
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, ref_losses))
        grad = [abs(grad1[n] - ref_grad1[n]) / max(ref_grad1[n], g_med, 1e-30) for n in names]
        kept = [n for n in names if ref_grad1[n] >= 1e-3 * g_med]
        stats_gaps = TrainKind.gaps(stats, ref_stats, list(ref_stats))
        return {"loss_gap": loss_gap, "grad_gap": max(grad),
                "grad_gap_median": float(np.median(grad)),
                "change_gap": max(TrainKind.gaps(change, ref_change, kept)),
                "stats_gap": max(stats_gaps), "stats_gap_median": float(np.median(stats_gaps))}

    @staticmethod
    def gaps(norms: Dict[str, float], ref: Dict[str, float], names: List[str]) -> List[float]:
        """Per leaf of ``names``, |norm - reference's| over the larger of the
        reference's norm of that leaf and the median leaf's."""
        med = float(np.median([ref[n] for n in ref]))
        return [abs(norms[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names]

    def reference_run(self, control: bool = False, rows=None, momentum: float = BN_MOMENTUM):
        """(losses, first-gradient norms, change norms, BN-statistics change
        norms) of the reference over the compared steps; ``control``,
        ``rows`` and ``momentum`` as ``Reference`` takes them."""
        steps = int(self.traffic["compared"])
        ref = Reference(self.initial, self.file, fp8=control, rows=rows, momentum=momentum)
        losses = []
        grad1 = {}
        for i in range(steps):
            loss, grads = ref.step(self.batches[i % len(self.batches)])
            losses.append(loss)
            if i == 0:
                grad1 = {n: float(g.norm()) for n, g in grads.items()}
            del grads
        change = {n: float((ref.state[n].detach() - self.initial[n].float()).norm())
                  for n in param_names(self.mc) + stat_names(self.mc)}
        stats = {n: change.pop(n) for n in stat_names(self.mc)}
        return losses, grad1, change, stats

    def control(self) -> Dict[str, float]:
        """The numbers of the control: the reference with float8 e4m3 conv
        operands in the forward, in the program's place."""
        return self.numbers_from(*self.reference_run(control=True), *self.reference_run())

    def faults(self) -> Dict[str, Dict[str, float]]:
        """The numbers of the faults read by running them, planted in the
        reference put in the program's place: half of each batch left out
        (the mean over the rest); the BN statistics moved at half the
        configuration's momentum.  Parameters left unchanged read 1 in
        change_gap, BN statistics left unchanged 1 in stats_gap, by the
        measure itself."""
        half = slice(0, self.batch // 2)
        ref = self.reference_run()
        return {"half_batch": self.numbers_from(*self.reference_run(rows=half), *ref),
                "half_momentum": self.numbers_from(
                    *self.reference_run(momentum=BN_MOMENTUM / 2), *ref)}

    def check(self) -> Dict[str, float]:
        losses = [float(v) for v in self.losses]
        return self.numbers_from(losses, self.grad1, self.change, self.stats_change,
                                 *self.reference_run())


Kind = TrainKind
