"""Full-size decode-level int8 accuracy gate on the flagship model.

Port of the JAX package's ``tools/accuracy_gate_full.py``: train
pose_hrnet_w32 (softmax head, 256x256) for a few hundred steps on one batch
of synthetic hands on the device (the trained regime: random full-depth
nets are chaotic in bf16), then require the shipped serving configuration
(exchange-scope int8 trunk + the W8A8 layer1 chain + W8A8 stem2 + the fused
head, and raw uint8 input normalised on the device) to decode within 0.1
heatmap px of the unquantized walk (``make_quant_infer(trunk='f32',
pallas_layer1=False)``: the folded bf16 walk with its own layer1, TF32
off) on the train batch and on held-out samples.

Per serving scope (GATE_SCOPES, default "branch,exchange"):
  [A] the int8 path on pre-normalised float input against the walk
      (``shift_int8[_<scope>]_{train,held-out}``);
  [B] the shipped path on raw uint8 against the walk on the same pixels
      normalised on the host (``shift_uint8[_<scope>]_held-out``).
The gate passes when every shift is under 0.1 px, the trained walk decodes
the train batch within 1.5 px of its joints on average, and its decode
varies across samples (std > 0.5 px).  The exit code is 0 only then.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.accuracy_gate_full
    GATE_STEPS=500 GATE_BATCH=64 python -m hrnet_hand_pose_estimation_tpu_torch.tools.accuracy_gate_full
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

STEPS = int(os.environ.get("GATE_STEPS", "300"))
BATCH = int(os.environ.get("GATE_BATCH", "32"))
HELD = 16
SCOPES = tuple(s.strip() for s in os.environ.get("GATE_SCOPES", "branch,exchange").split(","))
SHIFT_LIMIT = 0.1
ERR_LIMIT = 1.5
SPREAD_MIN = 0.5
LR = 1.5e-3

Data = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def flagship_train_cfg():
    """pose_hrnet_w32 with the trainable-softmax head at 256x256, heatmap
    and pose2d losses, adam at a constant 1.5e-3 (optax.adam(1.5e-3))."""
    from ..config import POSE_HIGH_RESOLUTION_NET_EXTRA, load_config

    cfg = load_config(freeze=False)
    cfg.MODEL.NAME = "pose_hrnet_softmax"
    cfg.MODEL.HEATMAP_SOFTMAX = True
    cfg.MODEL.TRAINABLE_SOFTMAX = True
    cfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
    cfg.LOSS.WITH_HEATMAP_LOSS = True
    cfg.LOSS.WITH_POSE2D_LOSS = True
    cfg.TRAIN.OPTIMIZER = "adam"
    cfg.TRAIN.LR = LR
    cfg.TRAIN.LR_SCHEDULE = "multi_step"
    cfg.TRAIN.LR_STEP = []              # no boundary: a constant LR
    return cfg.freeze()


def batches(seed: int, n: int, img: int = 256, hm: int = 64) -> Data:
    """n synthetic samples in both input forms: raw uint8 pixels and the
    same pixels normalised on the host (the reference ToTensor +
    Normalize), with their joints in heatmap px and Gaussian targets."""
    from ..data.synthetic import render_blob_image, synthetic_pose
    from ..data.transforms import normalize_image
    from ..ops.targets import gaussian_targets_np

    u8s, xfs, poses, hms = [], [], [], []
    for idx in range(n):
        rng = np.random.default_rng((seed, idx))
        pose3d = synthetic_pose(rng, size=img * 0.35)
        center = rng.uniform(0.35, 0.65, size=2) * img
        pose2d_img = pose3d[:, :2] + center
        u8 = render_blob_image(pose2d_img, img, rng)
        u8s.append(u8)
        xfs.append(normalize_image(u8))
        pose_hm = pose2d_img * hm / img
        poses.append(pose_hm.astype(np.float32))
        hms.append(gaussian_targets_np(pose_hm, np.ones(21, np.float32), hm, 2.0))
    return (np.stack(u8s), np.stack(xfs).astype(np.float32),
            np.stack(poses), np.stack(hms).astype(np.float32))


def train(cfg, steps: int, data: Data, device="cuda"):
    """``steps`` train steps on one batch from a seeded init; returns the
    TrainState."""
    from ..models import build_model
    from ..parallel.train_step import create_train_state, make_train_step

    dev = torch.device(device)
    _, xf, pose, hm = data
    batch = {"images": torch.from_numpy(xf).to(dev),
             "target_heatmaps": torch.from_numpy(hm).to(dev),
             "pose2d": torch.from_numpy(pose).to(dev),
             "visibility": torch.ones(xf.shape[0], 21, device=dev)}
    model = build_model(cfg)
    state, tx = create_train_state(cfg, model, device=dev)
    step = make_train_step(cfg, model, tx)
    t0 = time.perf_counter()
    state, losses = step(state, batch)
    print(f"first train step in {time.perf_counter() - t0:.1f} s "
          f"(loss {float(losses['total_loss']):.3f})", flush=True)
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state, losses = step(state, batch)
    total = float(losses["total_loss"])      # waits for the last step
    secs = time.perf_counter() - t0
    print(f"trained {steps} steps at B={xf.shape[0]} in {secs:.1f} s "
          f"({secs / max(steps - 1, 1) * 1e3:.1f} ms/step; final loss {total:.3f})", flush=True)
    return state


def trained_state(state, device="cuda") -> Dict[str, torch.Tensor]:
    """The flat state dict (parameters and BN statistics) of a TrainState."""
    payload = state.state_dict()
    return {k: v.to(device) for k, v in {**payload["params"], **payload["batch_stats"]}.items()}


def gate(cfg, state: Mapping[str, torch.Tensor], xs: Mapping[str, Data], device="cuda",
         scopes: Sequence[str] = SCOPES) -> Dict[str, object]:
    """The decode gate of a trained state dict on ``xs = {'train': data,
    'held-out': data}`` (``batches()``'s tuples).  Returns the JAX tool's
    keys: ``train_decode_err_px``, the shifts and ``pass``."""
    from ..core.fast_infer import precast_variables
    from ..core.quant_infer import (IMAGENET_MEAN, IMAGENET_STD, calibrate, make_quant_infer,
                                    prepare_serving_qparams)
    from ..ops.precision import no_tf32

    dev = torch.device(device)
    state = {k: v.to(dev) for k, v in state.items()}
    weights = precast_variables(cfg, state, device=dev)
    _, xf_train, pose_train, _ = xs["train"]
    u8_held, xf_held, _, _ = xs["held-out"]
    x_train = torch.from_numpy(xf_train[:HELD]).to(dev)
    inputs = (("train", x_train, None),
              ("held-out", torch.from_numpy(xf_held).to(dev), torch.from_numpy(u8_held).to(dev)))

    ref_fn = make_quant_infer(cfg, dev, trunk="f32", pallas_layer1=False)

    def reference(x):
        with no_tf32():
            return ref_fn(weights, {}, x).cpu().numpy()

    refs = {name: reference(x) for name, x, _ in inputs}
    err = float(np.abs(refs["train"] - pose_train[:HELD]).mean())
    print(f"trained decode err vs GT: {err:.3f} hm px", flush=True)

    amax = calibrate(cfg, weights, [x_train])
    q_fn = make_quant_infer(cfg, dev)
    u8_fn = make_quant_infer(cfg, dev, input_norm=(IMAGENET_MEAN, IMAGENET_STD))
    results: Dict[str, object] = {"train_decode_err_px": err}
    for scope in scopes:
        qparams = prepare_serving_qparams(cfg, state, amax, scope=scope)
        tag = "" if scope == "branch" else f"_{scope}"
        for name, x, u8 in inputs:
            shift = float(np.abs(q_fn(weights, qparams, x).cpu().numpy() - refs[name]).max())
            results[f"shift_int8{tag}_{name}"] = shift
            print(f"[A:{scope}] int8 serving vs f32 walk ({name}): max decode shift "
                  f"{shift:.4f} px", flush=True)
            if u8 is not None:
                shift = float(np.abs(u8_fn(weights, qparams, u8).cpu().numpy()
                                     - refs[name]).max())
                results[f"shift_uint8{tag}_{name}"] = shift
                print(f"[B:{scope}] uint8 path vs f32 walk ({name}): max decode shift "
                      f"{shift:.4f} px", flush=True)
    spread = float(refs["train"].std(axis=0).max())
    failed = [f"{k} {v:.4f} >= {SHIFT_LIMIT}" for k, v in results.items()
              if k.startswith("shift_") and not v < SHIFT_LIMIT]
    if not err < ERR_LIMIT:
        failed.append(f"did not train to localise (mean err {err:.2f} px >= {ERR_LIMIT})")
    if not spread > SPREAD_MIN:
        failed.append(f"degenerate decode (largest std over samples {spread:.3f} px)")
    for reason in failed:
        print(f"gate failed: {reason}", flush=True)
    results["pass"] = not failed
    return results


def run(device="cuda", steps: int = STEPS, batch: int = BATCH,
        scopes: Sequence[str] = SCOPES) -> Dict[str, object]:
    """Train the flagship and gate it; prints and returns the JSON record."""
    cfg = flagship_train_cfg()
    data = {"train": batches(0, batch), "held-out": batches(1, HELD)}
    state = train(cfg, steps, data["train"], device)
    results = {"steps": steps, "batch": batch,
               **gate(cfg, trained_state(state, device), data, device, scopes)}
    print(json.dumps(results), flush=True)
    return results


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    sys.exit(0 if run(args.device)["pass"] else 1)


if __name__ == "__main__":
    main()
