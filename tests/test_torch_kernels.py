"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch twin; the JAX side runs the
Pallas kernel in interpret mode, as tests/test_pallas_kernels.py does.
The CUDA kernels themselves are held against their twins on a card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.ops.pallas import fused_bottleneck as jax_fb
from hrnet_hand_pose_estimation_tpu.ops.pallas import fused_head_decode as jax_fh
from hrnet_hand_pose_estimation_tpu.utils.torch_convert import convert_hrnet_state_dict
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import _build
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import (
    fold_layer1_params, fused_bottleneck_chain, layer1_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_head_decode import (
    HeadParams, fused_head_decode_v2, head_decode_reference, prepare_head_params)
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import init_variables

torch.set_num_threads(1)


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a, np.float32))
    return out if dtype is None else out.to(dtype)


def layer1_case(rng, cin=16, cm=8, cout=32, flags=(True, False), hw=16, batch=2):
    """Random folded chain params as numpy f32 (bf16-representable)."""
    def mk(shape, scale=0.05, bf16=True):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)) if bf16 else a

    flat, c = [], cin
    for has_sc in flags:
        flat += [mk((c, cm)), mk((cm,), bf16=False), mk((3, 3, cm, cm)), mk((cm,), bf16=False),
                 mk((cm, cout)), mk((cout,), bf16=False)]
        if has_sc:
            flat += [mk((c, cout)), mk((cout,), bf16=False)]
        c = cout
    x = mk((batch, hw, hw, cin), scale=1.0)
    return x, flat, flags


def to_port(flat):
    return tuple(t(a, torch.bfloat16 if a.ndim > 1 else None) for a in flat)


def to_jax(flat):
    return tuple(jnp.asarray(a).astype(jnp.bfloat16 if a.ndim > 1 else jnp.float32) for a in flat)


def test_layer1_twin_matches_pallas_and_reference(rng):
    x, flat, flags = layer1_case(rng)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = np.asarray(jax_fb.fused_bottleneck_chain(xj, to_jax(flat), flags, out_channels=32,
                                                      interpret=True), np.float32)
    ref = np.asarray(jax_fb.layer1_reference(xj, to_jax(flat), flags), np.float32)
    got = fused_bottleneck_chain(t(x, torch.bfloat16), to_port(flat), flags).float().numpy()
    assert got.shape == (2, 16, 16, 32) and np.abs(got).max() > 0.5
    np.testing.assert_allclose(got, pallas, atol=0.02)      # bf16 rounding
    np.testing.assert_allclose(got, ref, atol=0.02)


def test_layer1_fold_matches_unfolded_model(tiny_cfg):
    """fold_layer1_params + the chain == the model's eval-mode layer1 (f32),
    up to bf16 rounding of weights and activations."""
    cfg = config_from_dict(tiny_cfg.to_dict())
    state = init_variables(cfg, seed=2)
    model = hrnet_from_cfg(cfg)
    model.load_state_dict(state)
    x = torch.relu(torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 64, 16, 16)).astype(np.float32)))
    x = x.to(torch.bfloat16).float()
    with torch.no_grad():
        want = model.layer1(x).permute(0, 2, 3, 1)
    params, flags = fold_layer1_params(state)
    assert flags == (True, False, False, False)
    got = fused_bottleneck_chain(x.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous(),
                                 params, flags).float()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 0.03 * scale


def head_case(rng, widths=(8, 16, 32, 64), size=16, batch=2, k=21):
    xs = [rng.normal(size=(batch, size >> i, size >> i, c)).astype(np.float32)
          for i, c in enumerate(widths)]
    xs = [np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)) for x in xs]
    c = sum(widths)
    params = dict(w_head=rng.normal(size=(c, c)) * 0.1, b_head=rng.normal(size=(c,)) * 0.1,
                  w_final=rng.normal(size=(c, k)) * 0.1, b_final=rng.normal(size=(k,)) * 0.1,
                  temp=np.float32(1.3))
    return xs, {n: np.asarray(v, np.float32) for n, v in params.items()}


def test_head_twin_matches_pallas_v2(rng):
    xs, p = head_case(rng)
    want = np.asarray(jax_fh.fused_head_decode_v2(
        [jnp.asarray(x).astype(jnp.bfloat16) for x in xs],
        jax_fh.HeadParams(**{n: jnp.asarray(v) for n, v in p.items()}), interpret=True))
    got = fused_head_decode_v2([t(x, torch.bfloat16) for x in xs],
                               HeadParams(**{n: t(v) for n, v in p.items()})).numpy()
    assert got.shape == (2, 21, 2) and got.std() > 0.5
    np.testing.assert_allclose(got, want, atol=0.05)


def test_prepare_head_params_matches_jax(tiny_cfg):
    state = init_variables(config_from_dict(tiny_cfg.to_dict()), seed=5)
    variables = convert_hrnet_state_dict({k: v.numpy() for k, v in state.items()})
    want = jax_fh.prepare_head_params(variables)
    got = prepare_head_params(state)
    for name in HeadParams._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6)


def test_wrappers_on_cpu_run_the_twins_and_count_nothing(rng):
    x, flat, flags = layer1_case(rng)
    before = fused_bottleneck_chain.launches
    xp = t(x, torch.bfloat16)
    assert torch.equal(fused_bottleneck_chain(xp, to_port(flat), flags),
                       layer1_reference(xp, to_port(flat), flags))
    assert fused_bottleneck_chain.launches == before

    xs, p = head_case(rng)
    xs = [t(a, torch.bfloat16) for a in xs]
    params = HeadParams(**{n: t(v) for n, v in p.items()})
    before = fused_head_decode_v2.launches
    assert torch.equal(fused_head_decode_v2(xs, params), head_decode_reference(xs, params))
    assert fused_head_decode_v2.launches == before


def test_wrappers_reject_bad_inputs(rng):
    x, flat, flags = layer1_case(rng)
    params = to_port(flat)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_bottleneck_chain(t(x), params, flags)
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        fused_bottleneck_chain(t(x[0], torch.bfloat16), params, flags)
    with pytest.raises(ValueError, match="w1"):
        fused_bottleneck_chain(t(x[..., :8], torch.bfloat16), params, flags)
    with pytest.raises(ValueError, match="take"):
        fused_bottleneck_chain(t(x, torch.bfloat16), params[:-1], flags)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_bottleneck_chain(t(x, torch.bfloat16).to("meta"),
                               tuple(p.to("meta") for p in params), flags)

    xs, p = head_case(rng)
    head = HeadParams(**{n: t(v) for n, v in p.items()})
    good = [t(a, torch.bfloat16) for a in xs]
    with pytest.raises(ValueError, match="bfloat16"):
        fused_head_decode_v2([t(xs[0])] + good[1:], head)
    with pytest.raises(ValueError, match="4 branch"):
        fused_head_decode_v2(good[:3], head)
    with pytest.raises(ValueError, match="w_head"):
        fused_head_decode_v2(good, head._replace(w_head=head.w_head[:, :-1]))


def test_build_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert _build.sources() and len(_build.source_hash()) == 64
