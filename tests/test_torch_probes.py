"""The port's A8 probes against the JAX package's tools, on the CPU.

- ``tools/perf_int8_probe``: the port's plain ``basic_chain_bf16``,
  ``basic_chain_int8`` and ``basic_chain_int8_folded`` against the JAX
  tool's functions (loaded by path; the tool points JAX's compilation cache
  elsewhere at import, which is put back) on the same seeded weights at a
  small shape.  The int8 chains are held to JAX's functions run op by op
  (``jax.disable_jit``; jitted, XLA:CPU contracts ``acc * s + b`` into an
  FMA, ROADMAP C3): bit-equal.  The kernels' routes (their CPU twins) are
  held to the plain chains they stand for;
- ``tools/perf_train_profile``: every section runs on the tiny config,
  under the JAX tool's labels; the cut backbones' float32 forward equals
  JAX's cut ``HRNetBackbone`` (``num_modules=0`` for the stages cut)
  through the weight bridge.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.models.hrnet import HRNetBackbone, StageCfg
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import fused_basic_chain
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.int8_chain import fused_basic_chain_int8
from hrnet_hand_pose_estimation_tpu_torch.tools import perf_int8_probe as P
from hrnet_hand_pose_estimation_tpu_torch.tools import perf_train_profile as T
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX tool as a module; JAX's cache settings restored after its import."""
    saved = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                 "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        "jax_perf_int8_probe", os.path.join(REPO, "tools", "perf_int8_probe.py"))
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for key, val in saved.items():
            jax.config.update(key, val)
    return module


@pytest.fixture(scope="module")
def chain_case():
    """Two blocks at 8x8x16, B=2: the probe's weights, port and JAX forms."""
    weights, qweights = P.probe_weights(16, 2, np.random.default_rng(3))
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 8, 8, 16)).astype(
        np.float32)).to(torch.bfloat16)
    jw = tuple(tuple(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in blk)
               for blk in weights)
    jq = tuple(tuple((jnp.asarray(k.numpy()), jnp.asarray(s.numpy()), jnp.asarray(b.numpy()),
                      jnp.float32(a.item())) for k, s, b, a in blk) for blk in qweights)
    return x, weights, qweights, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), jw, jq


def f32(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32)) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


def test_probe_weights_are_the_jax_tools(jax_probe):
    """The JAX tool's recipe (:106-119) on the same numpy stream."""
    assert P.SHAPES == ((64, 64, 32), (32, 32, 64), (16, 16, 128), (8, 8, 256))
    assert P.BATCH == jax_probe.BATCH == 128 and P.ACT_SCALE == 3.0 / 127
    rng = np.random.default_rng(0)
    _, qweights = P.probe_weights(8, 1, np.random.default_rng(0))
    k = rng.normal(size=(3, 3, 8, 8)).astype(np.float32) * 0.05
    ws = np.abs(k).reshape(-1, 8).max(0) / 127.0
    kq, s, _, a = qweights[0][0]
    np.testing.assert_array_equal(kq.numpy(), np.clip(np.round(k / ws), -127, 127))
    np.testing.assert_array_equal(s.numpy(), ws.astype(np.float32))
    assert a.item() == np.float32(3.0 / 127)


def test_bf16_chain_matches_jax(jax_probe, chain_case):
    """bf16 convs round each sum once on both sides, summed in other orders:
    within 2 bf16 ulps of the output's largest value (measured below)."""
    x, weights, _, jx, jw, _ = chain_case
    want = f32(jax.jit(jax_probe.basic_chain_bf16)(jx, jw))
    got = f32(P.basic_chain_bf16(x, weights))
    gap, scale = np.abs(got - want).max(), np.abs(want).max()
    print(f"bf16 chain: max |port - JAX| {gap:.4g} of {scale:.4g}")
    assert scale > 1.0 and gap <= 2 * 2.0 ** -7 * scale


@pytest.mark.parametrize("name", ["basic_chain_int8", "basic_chain_int8_folded"])
def test_int8_chains_match_jax_op_by_op(jax_probe, chain_case, name):
    x, _, qweights, jx, _, jq = chain_case
    with jax.disable_jit():
        want = f32(getattr(jax_probe, name)(jx, jq))
    got = f32(getattr(P, name)(x, qweights))
    assert np.abs(want).max() > 1.0
    np.testing.assert_array_equal(got, want)


def test_kernel_routes_stand_for_the_chains(chain_case):
    """The routes the probe times, as their CPU twins run them: B7 and the
    conv_int8 chains within 0.02 of the output's largest value of the plain
    chains they stand for, B6 of the folded chain (B6's conv1 epilogue is
    the fold; it adds the residual in float32 before rounding)."""
    x, weights, qweights, _, _, _ = chain_case
    before = (fused_basic_chain.launches, fused_basic_chain_int8.launches)
    pairs = {
        "B7": (fused_basic_chain(x, P.b7_params(weights), 2), P.basic_chain_bf16(x, weights)),
        "conv_int8": (P.int8_chain_conv_int8(x, P.conv_int8_sites(qweights)),
                      P.basic_chain_int8(x, qweights)),
        "conv_int8 folded": (P.int8_chain_conv_int8(x, P.conv_int8_sites(qweights, True)),
                             P.basic_chain_int8_folded(x, qweights)),
        "B6": (fused_basic_chain_int8(x, P.b6_params(qweights), 2),
               P.basic_chain_int8_folded(x, qweights)),
    }
    assert (fused_basic_chain.launches, fused_basic_chain_int8.launches) == before
    for label, (got, want) in pairs.items():
        gap, scale = (got.float() - want.float()).abs().max().item(), want.float().abs().max()
        print(f"{label}: max |route - chain| {gap:.4g} of {scale:.4g}")
        assert gap <= 0.02 * scale, label


def test_int8_probe_run_rows():
    result = P.run(batch=1, iters=1, device="cpu", shapes=((8, 8, 16),))
    (row,) = result["rows"]
    assert row["shape"] == "8x8x16" and row["blocks"] == 4
    for key in ("bf16", "int8", "int8-folded", "bf16 (B7)", "int8 (B6)"):
        assert row[key] > 0, key
    assert row["speedup"] == pytest.approx(row["bf16"] / row["int8"])
    assert "int8-folded" in P.format_row(row)


def test_train_profile_sections_run(tiny_cfg):
    cfg = config_from_dict(tiny_cfg.to_dict())
    result = T.run(cfg, batch=2, iters=1, chunk=2, device="cpu")
    assert list(result) == [
        "fwd+bwd through stem+l1+stage2", "fwd+bwd through +stage3", "fwd+bwd through +stage4",
        "fwd+bwd full model + head + loss suite", "fwd+bwd, EVAL-mode BN (no stat updates)",
        "full train step [adam]", "full train step [sgd]",
        "full train step [adam, DETECT_ANOMALY=0]", "minimal raw step (grad+adam only)",
        "full train step [adam, x2/dispatch]"]
    assert all(v > 0 for v in result.values())
    assert len(list(T.lines(result, 2))) == len(result)


@pytest.mark.parametrize("n_stages", [2, 3, 4])
def test_cut_backbone_matches_jax(tiny_cfg, n_stages):
    """backbone_upto's float32 eval forward against JAX's HRNetBackbone cut
    the same way (the JAX tool's backbone_upto), weights filled from
    eval_shape and carried across: within 1e-4 of the largest output."""
    extra = tiny_cfg.MODEL.EXTRA
    stages = [StageCfg.from_cfg(extra[f"STAGE{i}"]) for i in (2, 3, 4)]
    for i in range(n_stages - 1, 3):
        stages[i] = stages[i]._replace(num_modules=0)
    jnet = HRNetBackbone(*stages, dtype=jnp.float32)
    x = np.random.default_rng(5).normal(size=(2, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.key(0), jnp.asarray(x), False))
    rng = np.random.default_rng(6)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            return rng.normal(0.0, 1.0 / np.sqrt(np.prod(s.shape[:-1])), s.shape).astype(
                np.float32)
        if leaf in ("scale", "var"):
            return (1.0 + 0.2 * np.abs(rng.standard_normal(s.shape))).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    want = jax.jit(lambda v, x: jnet.apply(v, x, False))(v, jnp.asarray(x))

    cfg = config_from_dict(tiny_cfg.to_dict())
    net = T.backbone_upto(cfg, n_stages)
    state = from_jax_variables({"params": {"backbone": v["params"]},
                                "batch_stats": {"backbone": v["batch_stats"]}})
    missing, unexpected = net.load_state_dict(state, strict=False)
    assert not unexpected and all(k.startswith(("last_layer.", "trainable_temp"))
                                  for k in missing)
    with torch.no_grad():
        got = T.backbone_outputs(net.eval(), torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max())
