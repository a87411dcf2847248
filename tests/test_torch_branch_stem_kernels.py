"""The port's BasicBlock branch chain, stem + layer1 and space-to-depth stem
against the JAX package's Pallas kernels and XLA compositions.

On the CPU each wrapper runs its plain PyTorch twin; the JAX side runs the
Pallas kernel in interpret mode, as tests/test_pallas_kernels.py does.  The
CUDA kernels themselves are held against their twins on a card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hrnet_hand_pose_estimation_tpu.core import fast_infer as jax_fi
from hrnet_hand_pose_estimation_tpu.models.hrnet import HRNetBackbone, StageCfg
from hrnet_hand_pose_estimation_tpu.models.hrnet import hrnet_from_cfg as jax_hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu.ops.pallas import fused_bottleneck as jax_fb
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import (_s2d_stem_apply,
                                                                  prepare_s2d_stem,
                                                                  precast_variables)
from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import (
    basic_chain_reference, fold_branch_params, fold_layer1_params, fused_basic_chain,
    fused_stem_layer1, prepare_stem_params, stem_layer1_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.s2d import s2d_kernel, space_to_depth
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)


def bf16_np(a):
    """numpy float32 holding bf16-representable values."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def to_port(flat):
    return tuple(torch.from_numpy(a).to(torch.bfloat16 if a.ndim > 1 else torch.float32)
                 for a in flat)


def to_jax(flat):
    return tuple(jnp.asarray(a).astype(jnp.bfloat16 if a.ndim > 1 else jnp.float32)
                 for a in flat)


def basic_case(rng):
    """The weights of tests/test_pallas_kernels.py::test_fused_basic_chain_parity:
    C=16, 3 blocks, weights 0.05 * N(0, 1), x N(0, 1)."""
    def mk(shape, scale=0.05, bf16=True):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return bf16_np(a) if bf16 else a

    c, flat = 16, []
    for _ in range(3):
        flat += [mk((3, 3, c, c)), mk((c,), bf16=False), mk((3, 3, c, c)), mk((c,), bf16=False)]
    return mk((2, 8, 8, c), scale=1.0), flat


def test_basic_chain_twin_matches_pallas_and_reference(rng):
    x, flat = basic_case(rng)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = np.asarray(jax_fb.fused_basic_chain(xj, to_jax(flat), 3, interpret=True), np.float32)
    ref = np.asarray(jax_fb.basic_chain_reference(xj, to_jax(flat), 3), np.float32)
    before = fused_basic_chain.launches
    got = fused_basic_chain(torch.from_numpy(x).to(torch.bfloat16), to_port(flat), 3)
    assert fused_basic_chain.launches == before            # the CPU runs the twin
    got = got.float().numpy()
    assert got.shape == (2, 8, 8, 16) and np.abs(got).max() > 0.5
    print(f"basic chain twin: max |twin - pallas| {np.abs(got - pallas).max():.4g}, "
          f"max |twin - reference| {np.abs(got - ref).max():.4g}")
    np.testing.assert_allclose(got, pallas, atol=0.02)      # bf16 rounding
    np.testing.assert_allclose(got, ref, atol=0.02)


def test_basic_chain_twin_rounds_like_the_tpu_kernel(rng):
    """The second conv adds its bias and the residual in float32 before one
    rounding: the twin equals that arithmetic written out, and differs from
    the conv -> bf16 -> + x in bf16 order of a cuDNN-style block."""
    x, flat = basic_case(rng)
    xt, p = torch.from_numpy(x).to(torch.bfloat16), to_port(flat[:4])
    got = basic_chain_reference(xt, p, 1)
    w1, b1, w2, b2 = (t.float() for t in p)
    conv = lambda a, w: F.conv2d(a.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                 padding=1).permute(0, 2, 3, 1)
    h = torch.relu(conv(xt.float(), w1) + b1).to(torch.bfloat16).float()
    want = torch.relu((conv(h, w2) + b2) + xt.float()).to(torch.bfloat16)
    assert torch.equal(got, want)
    twice = torch.relu((conv(h, w2) + b2).to(torch.bfloat16) + xt).to(torch.bfloat16)
    assert not torch.equal(got, twice)


def activated_tiny(tiny_cfg, rng, scale=0.05):
    """A JAX tiny model's variables with random weights (numpy leaves)."""
    model = jax_hrnet_from_cfg(tiny_cfg, head="softmax", dtype=jnp.bfloat16)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    v = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.asarray(x), False))
    v = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32) if a.ndim > 1 else
        (np.abs(rng.normal(size=a.shape)) * scale + 0.5).astype(np.float32), v)
    return v, x


def assert_fold_equal(got, want, state, bns):
    """Folded params: bf16 weights equal to the bit; each f32 bias
    b - mean * inv within 1e-6 of the size of its two terms (the terms
    nearly cancel, so a one-ulp difference in mean * inv is a large share
    of the result: rtol 1e-6 on the terms, not on their difference)."""
    bns = iter(bns)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert tuple(g.shape) == w.shape
        if g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(g.float().numpy(), w)
            continue
        bn = next(bns)
        inv = state[f"{bn}.weight"] / torch.sqrt(state[f"{bn}.running_var"] + 1e-5)
        terms = (state[f"{bn}.bias"].abs() + (state[f"{bn}.running_mean"] * inv).abs()).numpy()
        assert np.all(np.abs(g.numpy() - w) <= 1e-6 * terms)


def test_fold_branch_params_matches_jax_fold(tiny_cfg, rng, monkeypatch):
    """fold_branch_params == the fold of JAX's _pallas_basic_branch_apply,
    captured from a backbone forward with pallas_branches=True (see
    assert_fold_equal)."""
    v, x = activated_tiny(tiny_cfg, rng)
    captured = []

    def capture(xb, flat, n_blocks):
        captured.append((flat, n_blocks))
        return xb

    monkeypatch.setattr(jax_fb, "fused_basic_chain", capture)
    extra = tiny_cfg.MODEL.EXTRA
    backbone = HRNetBackbone(*(StageCfg.from_cfg(extra[f"STAGE{n}"]) for n in (2, 3, 4)),
                             dtype=jnp.bfloat16, pallas_layer1=False, pallas_branches=True)
    backbone.apply({"params": v["params"]["backbone"],
                    "batch_stats": v["batch_stats"]["backbone"]}, jnp.asarray(x), False)
    cfg = config_from_dict(tiny_cfg.to_dict())
    state = from_jax_variables(v)
    names = [f"stage{n}.0.branches.{i}" for n in (2, 3, 4) for i in range(n)]
    assert len(captured) == len(names) == 9
    weights = precast_variables(cfg, state, device="cpu")
    assert sorted(weights.branches) == sorted(names)
    for name, (flat, n_blocks) in zip(names, captured):
        got = fold_branch_params(state, name)
        assert len(got) == 4 * n_blocks == len(flat)
        assert all(torch.equal(g, kept) for g, kept in zip(got, weights.branches[name]))
        assert_fold_equal(got, flat, state,
                          [f"{name}.{b}.bn{n}" for b in range(n_blocks) for n in (1, 2)])
    with pytest.raises(KeyError, match="no BasicBlocks"):
        fold_branch_params(state, "stage2.0.branches.7")


def stem_layer1_case(rng, cm=16, cout=32):
    def mk(shape, scale, bf16=True):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return bf16_np(a) if bf16 else a

    stem = [mk((4, 12, 64), 0.3), mk((64,), 0.1, False), mk((576, 64), 0.06),
            mk((64,), 0.1, False)]
    flags, flat, c = (True, False), [], 64
    for has_sc in flags:
        flat += [mk((c, cm), 0.1), mk((cm,), 0.1, False), mk((3, 3, cm, cm), 0.1),
                 mk((cm,), 0.1, False), mk((cm, cout), 0.1), mk((cout,), 0.1, False)]
        if has_sc:
            flat += [mk((c, cout), 0.1), mk((cout,), 0.1, False)]
        c = cout
    return mk((2, 32, 32, 12), 1.0), stem, flat, flags


def test_stem_layer1_twin_matches_pallas(rng):
    x, stem, flat, flags = stem_layer1_case(rng)
    pallas = np.asarray(jax_fb.fused_stem_layer1(
        jnp.asarray(x).astype(jnp.bfloat16), to_jax(stem), to_jax(flat), flags,
        out_channels=32, interpret=True), np.float32)
    before = fused_stem_layer1.launches
    got = fused_stem_layer1(torch.from_numpy(x).to(torch.bfloat16), to_port(stem),
                            to_port(flat), flags)
    assert fused_stem_layer1.launches == before
    got = got.float().numpy()
    assert got.shape == pallas.shape == (2, 16, 16, 32) and np.abs(pallas).max() > 1.0
    err, limit = np.abs(got - pallas).max(), 0.02 * np.abs(pallas).max()
    print(f"stem + layer1 twin: max |twin - pallas| {err:.4g} (limit {limit:.4g})")
    assert err <= limit


@pytest.mark.parametrize("seed", [0, 16, 36, 54])
def test_stem_params_match_jax_fold(tiny_cfg, seed, monkeypatch):
    """prepare_stem_params, fold_layer1_params and space_to_depth equal what
    JAX's _fused_stem_layer1_apply hands its kernel (see assert_fold_equal),
    on weights from the case's own seed.  Seeds 16, 36 and 54 draw a
    variance whose float32 root the CPU's vectorised ``torch.sqrt`` rounds
    the wrong way; the fold takes it in float64 (``models.layers.fold_bn``)."""
    v, x = activated_tiny(tiny_cfg, np.random.default_rng(seed))
    captured = []
    monkeypatch.setattr(jax_fb, "fused_stem_layer1",
                        lambda *args, **kwargs: captured.append(args))
    jax_fi._fused_stem_layer1_apply(v, jnp.asarray(x))
    (x_s2d, stem_flat, flat, flags), = captured
    state = from_jax_variables(v)
    got_x = space_to_depth(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(got_x.float().numpy(), np.asarray(x_s2d.astype(jnp.float32)))
    got_flat, got_flags = fold_layer1_params(state)
    assert got_flags == flags
    bns = ["bn1", "bn2"] + [f"layer1.{b}.{bn}" for b, sc in enumerate(flags)
                            for bn in ("bn1", "bn2", "bn3") + (("downsample.1",) if sc else ())]
    assert_fold_equal(prepare_stem_params(state) + got_flat, tuple(stem_flat) + tuple(flat),
                      state, bns)


def test_s2d_kernel_and_space_to_depth_match_jax(rng):
    k = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)               # HWIO
    want = np.asarray(jax_fi._s2d_kernel(jnp.asarray(k)))               # (2, 2, 20, 7)
    got = s2d_kernel(torch.from_numpy(k).permute(3, 2, 0, 1))           # OIHW
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)
    x = rng.normal(size=(2, 6, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_fi._space_to_depth(jnp.asarray(x))))


def stem_state(tiny_cfg, rng):
    """tests/test_pallas_kernels.py::test_s2d_stem_exact_rewrite's recipe on
    the tiny model: weights 0.5 * N(0, 1), 1-D leaves 0.5 + |0.5 * N(0, 1)|."""
    return activated_tiny(tiny_cfg, rng, scale=0.5)


def test_s2d_stem_matches_jax_and_the_strided_stem(tiny_cfg, rng):
    """The port's s2d stem in float32 == JAX's _s2d_stem_apply and == the
    model's two stride-2 convs, at tests/test_pallas_kernels.py's
    tolerances, edges included: a stem padded at the wrong side is O(1) off."""
    v, x = stem_state(tiny_cfg, rng)
    want = np.asarray(jax_fi._s2d_stem_apply(v, jnp.asarray(x), jnp.float32))
    state = from_jax_variables(v)
    stem = prepare_s2d_stem(state)
    got = _s2d_stem_apply(stem, torch.from_numpy(x), torch.float32).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 16, 16, 64) and np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-5)

    model = hrnet_from_cfg(config_from_dict(tiny_cfg.to_dict()))
    model.load_state_dict(state)
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        strided = torch.relu(model.bn2(model.conv2(torch.relu(model.bn1(model.conv1(xt))))))
    np.testing.assert_allclose(got, strided.permute(0, 2, 3, 1).numpy(), atol=2e-4, rtol=1e-5)

    # the same rewrite padded at the bottom and right instead
    k1, b1, k2, b2 = stem
    y = space_to_depth(torch.from_numpy(x))
    for i, (k, b) in enumerate(((k1, b1), (k2, b2))):
        y = torch.relu(F.conv2d(F.pad(y.permute(0, 3, 1, 2), (0, 1, 0, 1)), k) + b[:, None, None])
        if i == 0:
            y = space_to_depth(y.permute(0, 2, 3, 1))
    wrong = np.abs(y.permute(0, 2, 3, 1).detach().numpy() - want).max()
    assert wrong > 1.0, wrong


def test_new_wrappers_reject_bad_inputs(rng):
    x, flat = basic_case(rng)
    xt, params = torch.from_numpy(x).to(torch.bfloat16), to_port(flat)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_basic_chain(xt.float(), params, 3)
    with pytest.raises(ValueError, match="take"):
        fused_basic_chain(xt, params[:-1], 3)
    with pytest.raises(ValueError, match="block 0"):
        fused_basic_chain(xt[..., :8], params, 3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_basic_chain(xt.to("meta"), tuple(p.to("meta") for p in params), 3)

    xs, stem, flat, flags = stem_layer1_case(rng)
    xs, stem, flat = torch.from_numpy(xs).to(torch.bfloat16), to_port(stem), to_port(flat)
    with pytest.raises(ValueError, match="12"):
        fused_stem_layer1(xs[..., :9], stem, flat, flags)
    with pytest.raises(ValueError, match="even"):
        fused_stem_layer1(xs[:, :31], stem, flat, flags)
    with pytest.raises(ValueError, match="ws2"):
        fused_stem_layer1(xs, stem[:2] + (stem[2][:-1], stem[3]), flat, flags)
    with pytest.raises(ValueError, match="w1"):
        fused_stem_layer1(xs, stem, (flat[0][:-1],) + flat[1:], flags)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_stem_layer1(xs.to("meta"), tuple(p.to("meta") for p in stem),
                          tuple(p.to("meta") for p in flat), flags)
