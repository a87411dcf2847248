"""Serving traffic: one client, closed loop, batches of images handed to a
serving entry of the program as host tensors, coordinates brought back to
the host.

A mix file (``traffic/<mix>.json``, ``"kind": "serve"``) gives:

- ``entry``: ``"int8"`` (``core/quant_infer.make_quant_infer`` on uint8
  images, normalized on the device) or ``"bf16"``
  (``core/fast_infer.make_fast_infer`` on normalized bfloat16 images);
- ``entry_options``: the entry's options (int8: those of
  ``prepare_serving_qparams``; bf16: those of ``make_fast_infer``);
- ``batch``, ``distinct_batches`` (made from the seed and cycled),
  ``in_flight`` (the most batches handed and not yet back), ``warmup``
  (batches run in set-up), ``trace_units`` (batches in the traced window),
  ``calibration_images`` (int8: the first images of batch 0, normalized as
  floats, calibrate both sides).

The images are uniform random uint8 from the seed, in pinned host memory;
the bf16 entry gets them normalized and rounded to bfloat16, and the
reference gets the same values.  Each batch's latency runs from handing it
to the entry to its coordinates on the host; a waiter thread takes the
completion time as each batch's event fires.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..reference.serve import FloatReference, Int8Reference, normalize
from ..reference.weights import make_state
from . import Phases

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SALT_IMAGES = 0x5E12E


class Done:
    """One batch handed to the entry: which distinct batch, when it was
    handed, when the entry returned, when its coordinates were on the host."""

    def __init__(self, source: int, t_hand: float, t_back: float):
        self.source = source
        self.t_hand, self.t_back = t_hand, t_back
        self.t_done: Optional[float] = None
        self.coords: Optional[np.ndarray] = None


class ServeKind:
    end_to_end = ("serve_images_per_s", "serve_batch_p95_ms", "peak_mem_gib")

    def __init__(self, cfg_file: Dict, traffic: Dict, seed: int, device, model_cfg_node):
        self.mc = cfg_file["experiment"]["MODEL"]
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.cfg = model_cfg_node
        self.batch = int(traffic["batch"])
        self.entry = traffic["entry"]
        if self.entry not in ("int8", "bf16"):
            raise ValueError(f"unknown serving entry {self.entry!r}")
        self.records: List[Done] = []
        self.wrong = None                 # set by tests: plants a fault in the answers

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        self.phases = Phases()
        self.make_inputs()
        self.phases.mark("inputs")
        self._make_entry()
        self.phases.mark("entry")
        # pinned landing buffers for the coordinates, one per batch in flight
        k = int(self.mc["NUM_JOINTS"])
        pin = self.device.type == "cuda"
        self.slots = [torch.empty((self.batch, k, 2), dtype=torch.float32, pin_memory=pin)
                      for _ in range(int(self.traffic["in_flight"]))]
        self.run_batches(int(self.traffic["warmup"]), keep=False)
        self.phases.mark("warmup")

    def make_inputs(self) -> None:
        """The seeded state dict and images (the benchmark's, handed to both sides)."""
        t = self.traffic
        dev = self.device
        side = int(self.mc["IMAGE_SIZE"][0])
        self.state = make_state(self.mc, self.seed, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed((self.seed ^ SALT_IMAGES) % (2 ** 63))
        raw = torch.randint(0, 256, (int(t["distinct_batches"]), self.batch, side, side, 3),
                            dtype=torch.uint8, device=dev, generator=gen)
        pin = dev.type == "cuda"
        if self.entry == "int8":
            host = raw
        else:
            host = normalize(raw, IMAGENET_MEAN, IMAGENET_STD).to(torch.bfloat16)
        self.images = [torch.empty(h.shape, dtype=h.dtype, pin_memory=pin).copy_(h)
                       for h in host]
        self.calibration = None
        if self.entry == "int8":
            n = int(t["calibration_images"])
            self.calibration = normalize(raw[0, :n], IMAGENET_MEAN, IMAGENET_STD)
        del raw, host

    def _make_entry(self) -> None:
        opts = dict(self.traffic.get("entry_options", {}))
        dev = self.device
        if self.entry == "int8":
            from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import precast_variables
            from hrnet_hand_pose_estimation_tpu_torch.core.quant_infer import (
                calibrate, make_quant_infer, prepare_serving_qparams)

            self.weights = precast_variables(self.cfg, self.state, dev)
            amax = calibrate(self.cfg, self.weights, [self.calibration])
            self.qparams = prepare_serving_qparams(self.cfg, self.state, amax, **opts)
            infer = make_quant_infer(self.cfg, dev, input_norm=(IMAGENET_MEAN, IMAGENET_STD))
            self.call = lambda images: infer(self.weights, self.qparams, images)
        else:
            from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import (
                make_fast_infer, precast_variables)

            self.weights = precast_variables(self.cfg, self.state, dev)
            infer = make_fast_infer(self.cfg, device=dev, **opts)
            self.call = lambda images: infer(self.weights, images)

    # -- the closed loop --------------------------------------------------------
    def run_batches(self, count: Optional[int] = None, seconds: Optional[float] = None,
                    keep: bool = True, span=None) -> Tuple[float, float]:
        """Hand ``count`` batches, or batches until ``seconds`` have passed,
        to the entry, at most ``in_flight`` outstanding; wait for all of
        them.  Returns (t_start, t_end) of the handing period."""
        cuda = self.device.type == "cuda"
        slots = self.slots
        free = threading.Semaphore(len(slots))
        inbox: "queue.Queue" = queue.Queue()
        done: List[Done] = []
        errors: List[BaseException] = []

        def waiter():
            while True:
                item = inbox.get()
                if item is None:
                    return
                rec, event, slot = item
                try:
                    if event is not None:
                        event.synchronize()
                    rec.t_done = time.perf_counter()
                    rec.coords = slot.numpy().copy()
                except BaseException as exc:      # reported after the loop
                    errors.append(exc)
                finally:
                    done.append(rec)
                    free.release()

        thread = threading.Thread(target=waiter, name="bench-waiter", daemon=True)
        thread.start()
        n_src = len(self.images)
        t0 = time.perf_counter()
        t_stop = t0 + seconds if seconds is not None else None
        i = 0
        try:
            while True:
                if count is not None and i >= count:
                    break
                if t_stop is not None and time.perf_counter() >= t_stop:
                    break
                free.acquire()
                slot = slots[i % len(slots)]
                src = i % n_src
                t_hand = time.perf_counter()
                with span("entry") if span else _null():
                    coords = self.call(self.images[src])
                t_back = time.perf_counter()
                if self.wrong is not None:
                    coords = self.wrong(coords, i)
                slot.copy_(coords, non_blocking=cuda)
                event = None
                if cuda:
                    event = torch.cuda.Event()
                    event.record()
                inbox.put((Done(src, t_hand, t_back),
                           event, slot))
                i += 1
        finally:
            t1 = time.perf_counter()
            inbox.put(None)
            thread.join()
        if errors:
            raise errors[0]
        if keep:
            self.records.extend(sorted(done, key=lambda r: r.t_hand))
        return t0, t1

    def window(self, seconds: float) -> Dict[str, float]:
        """The measured window; returns the end-to-end metrics' values."""
        t0, _ = self.run_batches(seconds=seconds)
        t_end = t0 + seconds
        recs = self.window_records = list(self.records)
        served = sum(1 for r in recs if r.t_done is not None and r.t_done <= t_end)
        lat = np.array([r.t_done - r.t_hand for r in recs]) * 1e3
        self.window_host_ms = [(r.t_back - r.t_hand) * 1e3 for r in recs]
        return {"serve_images_per_s": served * self.batch / seconds,
                "serve_batch_p95_ms": float(np.percentile(lat, 95)) if lat.size else float("nan")}

    def traced_units(self, units: int, span) -> None:
        self.run_batches(count=units, span=span)

    def attempted(self) -> int:
        return len(self.window_records)

    def failed(self) -> int:
        return sum(1 for r in self.window_records if r.coords is None)

    def per_unit_items(self) -> int:
        return self.batch

    # -- the comparison ---------------------------------------------------------
    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        for name in ("weights", "qparams", "call"):
            if hasattr(self, name):
                delattr(self, name)

    def reference(self, control: bool = False):
        """The reference's answers (one per distinct batch), float32 on the device."""
        mc = self.mc
        if self.entry == "int8":
            ref = Int8Reference(self.state, mc, self.calibration, qmax=7 if control else 127)
            mean, std = IMAGENET_MEAN, IMAGENET_STD
            return [ref(normalize(im.to(self.device), mean, std)) for im in self.images]
        ref = FloatReference(self.state, mc, fp8=control)
        return [ref(im.to(self.device).float()) for im in self.images]

    def numbers(self, answers: List[Tuple[int, np.ndarray]], expect) -> Dict[str, float]:
        """Gaps, in heatmap pixels, of every answer (one batch's coordinates)
        to the reference's coordinates of the same images:
        worst_answer_gap_px, the largest mean |u or v| gap of one answer;
        worst_image_gap_px, the largest mean |u or v| gap of one image of
        any answer, so that a few wrong rows do not hide in a batch's mean.
        An answer that is not finite reads infinite in both."""
        expect = [e.cpu().numpy().astype(np.float64) for e in expect]
        worst = worst_image = 0.0
        for src, coords in answers:
            gap = np.abs(coords.astype(np.float64) - expect[src])
            if not np.all(np.isfinite(gap)):
                worst = worst_image = float("inf")
                continue
            worst = max(worst, float(gap.mean()))
            worst_image = max(worst_image, float(gap.mean(axis=(1, 2)).max()))
        return {"worst_answer_gap_px": worst, "worst_image_gap_px": worst_image}

    def control(self) -> Dict[str, float]:
        """The numbers of the control: the reference one precision down (int8
        entry: int4 weights and activations; bf16 entry: float8 e4m3) in the
        program's place, one answer per distinct batch."""
        ctrl = self.reference(control=True)
        return self.numbers([(i, c.cpu().numpy()) for i, c in enumerate(ctrl)],
                            self.reference())

    def check(self) -> Dict[str, float]:
        answers = [(r.source, r.coords) for r in self.records if r.coords is not None]
        return self.numbers(answers, self.reference())


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


Kind = ServeKind
