"""The frozen yardstick on the CPU: the plain reference against the
program's float32 forward from one state dict, its state layout, its
weight maker, and the frozen operation count against ``FlopCounterMode``."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference import counts
from port_bench.reference.model import Walk, fold, nchw, softmax_decode, state_shapes
from port_bench.reference.train import Reference, make_batches
from port_bench.reference.weights import make_state
from port_bench.tests.tiny import ROOT, tiny_config

CONFIGS = {n: json.loads((ROOT / f"port_bench/configs/{n}.json").read_text())
           for n in ("hrnet_w32_256", "hrnet_w48_256")}


def program_model(cfg_file):
    from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
    from hrnet_hand_pose_estimation_tpu_torch.models.registry import build_model

    return build_model(config_from_dict(cfg_file["experiment"]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_layout_is_the_programs(name):
    sd = program_model(CONFIGS[name]).state_dict()
    shapes = state_shapes(CONFIGS[name]["experiment"]["MODEL"])
    assert set(sd) == set(shapes)
    assert all(tuple(sd[k].shape) == shapes[k] for k in shapes)


@pytest.mark.parametrize("width", [8, 12])
def test_reference_forward_matches_the_programs_float32_forward(width):
    from hrnet_hand_pose_estimation_tpu_torch.ops.decode import soft_argmax

    cfg = tiny_config(width=width)
    mc = cfg["experiment"]["MODEL"]
    state = make_state(mc, 2 ** 31 + width, "cpu")
    model = program_model(cfg)
    model.load_state_dict(state)
    model.eval()
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(width))
    with torch.no_grad():
        out = model(x)
        logits = Walk(mc, "eval", folded=fold(state, mc)).logits(nchw(x))
        probs, coords = softmax_decode(logits, state["trainable_temp"])
    assert torch.allclose(out.heatmaps.permute(0, 3, 1, 2), probs, atol=1e-6)
    assert (soft_argmax(out.heatmaps) - coords).abs().max() < 1e-4


def test_reference_train_step_matches_the_programs_float32_step():
    """One float32 step of the program's train step and of the reference,
    from one state and one batch: the losses, the first gradients, the
    parameters moved by a clear gradient and the BN statistics agree."""
    from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
    from hrnet_hand_pose_estimation_tpu_torch.models.registry import build_model
    from hrnet_hand_pose_estimation_tpu_torch.parallel.train_step import (create_train_state,
                                                                           make_train_step)

    cfg_file = tiny_config()
    cfg_file["overrides"] = ["TPU.COMPUTE_DTYPE", "float32"]
    mc = cfg_file["experiment"]["MODEL"]
    state = make_state(mc, 5, "cpu")
    batch = make_batches(mc, 2, 1, torch.Generator().manual_seed(6), "cpu",
                         (0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 2.0)[0]
    cfg = config_from_dict(cfg_file["experiment"], cfg_file["overrides"])
    model = build_model(cfg)
    ts, tx = create_train_state(cfg, model, device="cpu")
    with torch.no_grad():
        for n, t in list(model.named_parameters()) + list(model.named_buffers()):
            t.copy_(state[n])
    ts, out = make_train_step(cfg, model, tx)(ts, batch)
    ref = Reference(state, cfg_file)
    loss, grads = ref.step(batch)
    assert abs(float(out["total_loss"]) - loss) <= 1e-5 * abs(loss)
    # the first gradient as adam got it (mu = 0.1 g after one step); the
    # parameters moved by lr * g / (|g| + eps), which an element's
    # rounding-sized gradient may turn either way
    mu = ts.state_dict()["opt_state"]["mu"]
    params = dict(model.named_parameters())
    # a bias under a train-mode BN has a gradient of rounding size
    scale = float(np.median([float(grads[n].abs().max()) for n in ref.names]))
    for n in ref.names:
        g = grads[n]
        assert torch.allclose(mu[n] / 0.1, g, rtol=1e-3, atol=1e-3 * scale), n
        moved = (params[n] - ref.state[n]).detach().abs()
        clear = g.abs() > 1e-3 * scale
        assert float((moved * clear).max()) <= 1e-6 and float(moved.max()) <= 2.1e-3, n
    buffers = dict(model.named_buffers())
    for n in state:
        if n.endswith("running_var") or n.endswith("running_mean"):
            assert torch.allclose(buffers[n], ref.state[n], rtol=1e-4, atol=1e-6), n


def test_weight_maker_is_seeded_and_conditioned():
    mc = tiny_config()["experiment"]["MODEL"]
    a, b, c = (make_state(mc, s, "cpu") for s in (2 ** 33 + 1, 2 ** 33 + 1, 2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    damped = a["stage2.0.branches.0.0.bn2.weight"]
    assert 0.03 <= float(damped.min()) and float(damped.max()) <= 0.1
    plain = a["layer1.0.bn1.weight"]
    assert 0.5 <= float(plain.min()) and float(plain.max()) <= 1.5
    assert float(a["layer1.0.bn1.running_var"].min()) > 0
    assert int(a["bn1.num_batches_tracked"]) == 0


@pytest.mark.parametrize("name,gflop", [("hrnet_w32_256", 22.65), ("hrnet_w48_256", 46.83)])
def test_frozen_count_matches_flop_counter(name, gflop):
    mc = CONFIGS[name]["experiment"]["MODEL"]
    state = {k: torch.zeros(v) for k, v in state_shapes(mc).items()}
    for k in state:
        if k.endswith("running_var"):
            state[k] += 1.0
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        Walk(mc, "eval", folded=fold(state, mc)).logits(torch.zeros(1, 3, 256, 256))
    assert counter.get_total_flops() == counts.forward_flops(mc)
    assert round(counts.forward_flops(mc) / 1e9, 2) == gflop


def test_kernel_bounds_are_positive_and_below_the_whole_step():
    for cfg in CONFIGS.values():
        mc = cfg["experiment"]["MODEL"]
        b = counts.kernel_bounds(mc, 128)
        whole = counts.forward_work(mc, True).scaled(128).ops_s
        assert all(v > 0 for v in b.values())
        assert b["conv_int8"] + b["int8_chain"] < 10 * whole
        assert np.isclose(counts.train_step_flops(mc, 2), 6 * counts.forward_flops(mc))


def test_stem_launch_is_counted_at_its_own_sides():
    """The stem launch of ``stem_layer1`` by hand at w32, B=256: conv1
    (3 -> 64, 3x3, stride 2) and conv2 (64 -> 64, 3x3, stride 2) take a
    256x256x3 bf16 input to a 64x64x64 bf16 output."""
    mc = CONFIGS["hrnet_w32_256"]["experiment"]["MODEL"]
    specs = {s.conv: s for s in counts.conv_specs(mc)}
    b = 256
    ops = 2.0 * b * 128 * 128 * 64 * 3 * 9 + 2.0 * b * 64 * 64 * 64 * 64 * 9
    nbytes = (b * 256 * 256 * 3 * 2 + b * 64 * 64 * 64 * 2
              + (64 * 3 * 9 + 64 * 64 * 9) * 2 + 2 * 2 * 64 * 4)
    stem = counts._block_launch([specs["conv1"], specs["conv2"]], b, False)
    assert stem.bf16 == ops and stem.nbytes == nbytes
    assert np.isclose(stem.bound_s, max(ops / 989e12, nbytes / 3.35e12))
    layer1 = sum(counts._block_launch([s for n, s in specs.items()
                                       if n.startswith(f"layer1.{i}.")], b, False).bound_s
                 for i in range(4))
    assert np.isclose(counts.kernel_bounds(mc, b)["stem_layer1"], stem.bound_s + layer1)
