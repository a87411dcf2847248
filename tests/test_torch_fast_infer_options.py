"""The port's serving configurations beyond the defaults against the JAX
package's: make_fast_infer with pallas_branches, s2d_stem and
fuse_stem_layer1, and both serving paths on a plain-head model.

The JAX side runs its Pallas kernels in interpret mode.  Its layer1 and
branch kernels are called without an ``interpret`` argument from the
backbone (models/hrnet.py), so the tests hand the backbone interpret-mode
versions of them, as tests/test_pallas_kernels.py runs every Pallas kernel
on the CPU; nothing in the JAX package changes.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.core import quant_infer as JQ
from hrnet_hand_pose_estimation_tpu.core.fast_infer import make_fast_infer as jax_make_fast_infer
from hrnet_hand_pose_estimation_tpu.models.hrnet import hrnet_from_cfg as jax_hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu.ops.pallas import fused_bottleneck as jax_fb
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core import quant_infer as Q
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import make_fast_infer, precast_variables
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import (
    fused_basic_chain, fused_bottleneck_chain, fused_stem_layer1, pad_basic_params)
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from tests.test_quant_infer import _activated_variables

torch.set_num_threads(1)
NORM = (JQ.IMAGENET_MEAN, JQ.IMAGENET_STD)


@pytest.fixture
def interpret_kernels(monkeypatch):
    """The JAX backbone's layer1 and branch kernels in interpret mode."""
    monkeypatch.setattr(jax_fb, "fused_bottleneck_chain",
                        partial(jax_fb.fused_bottleneck_chain, interpret=True))
    monkeypatch.setattr(jax_fb, "fused_basic_chain",
                        partial(jax_fb.fused_basic_chain, interpret=True))


def activated(cfg, head, **recipe):
    """tests/test_quant_infer.py's _activated_variables on the tiny model
    (numpy leaves) and four images."""
    rng = np.random.default_rng(0)
    model = jax_hrnet_from_cfg(cfg, head=head)
    x = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    return jax.tree.map(np.asarray, _activated_variables(model, jnp.asarray(x), rng, **recipe)), x


# The gain-1.4 weights of the quant slice test are chaotic in bf16: there
# JAX's XLA stages (conv, then BN, each rounded) and the port's folded
# stages differ by pixels even in the default configuration; at gain 0.7
# and temperature 8 (the recipe of that test's layer1_chain=False case) the
# four configurations below agree to about 0.01 px.
MILD = dict(gain=0.7, temp=8.0)


CONFIGS = {
    "pallas_branches": dict(pallas_branches=True),
    "s2d_stem": dict(s2d_stem=True),
    "fuse_stem_layer1": dict(fuse_stem_layer1=True),
    "branches_and_fused_stem": dict(pallas_branches=True, fuse_stem_layer1=True),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_configuration_matches_jax_fast_infer(tiny_cfg, interpret_kernels, name):
    """The port's make_fast_infer on the CPU (every kernel as its twin) ==
    JAX's make_fast_infer with the same options and its default
    pallas_layer1=True, on the same variables, within 0.05 px."""
    kwargs = CONFIGS[name]
    v, x = activated(tiny_cfg, "softmax", **MILD)
    want = np.asarray(jax_make_fast_infer(tiny_cfg, interpret=True, **kwargs)(v, jnp.asarray(x)))
    cfg = config_from_dict(tiny_cfg.to_dict())
    weights = precast_variables(cfg, from_jax_variables(v), device="cpu")
    counts = [fn.launches for fn in (fused_basic_chain, fused_bottleneck_chain, fused_stem_layer1)]
    got = make_fast_infer(cfg, device="cpu", **kwargs)(weights, torch.from_numpy(x)).numpy()
    assert counts == [fn.launches for fn in (fused_basic_chain, fused_bottleneck_chain,
                                             fused_stem_layer1)]
    assert got.shape == want.shape == (4, 21, 2) and want.std() > 0.15
    print(f"{name}: max |port - JAX| {np.abs(got - want).max():.4g} px")
    np.testing.assert_allclose(got, want, atol=0.05)


@pytest.mark.parametrize("name", ["pallas_branches", "branches_and_fused_stem"])
def test_padded_branches_match_jax_fast_infer(tiny_cfg, interpret_kernels, name):
    """The branch chains as a card serves them, zero-padded once to widths
    their kernel takes (``pad_basic_params``, as ``precast_variables`` does
    on a card: the tiny model's 8 -> 16), through their twins on the CPU ==
    JAX's make_fast_infer within 0.05 px."""
    kwargs = CONFIGS[name]
    v, x = activated(tiny_cfg, "softmax", **MILD)
    want = np.asarray(jax_make_fast_infer(tiny_cfg, interpret=True, **kwargs)(v, jnp.asarray(x)))
    cfg = config_from_dict(tiny_cfg.to_dict())
    weights = precast_variables(cfg, from_jax_variables(v), device="cpu")
    padded = {n: pad_basic_params(p) for n, p in weights.branches.items()}
    assert sorted({p[0].shape[-1] for p in padded.values()}) == [16, 32, 64]
    got = make_fast_infer(cfg, device="cpu", **kwargs)(
        weights._replace(branches=padded), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 21, 2) and want.std() > 0.15
    np.testing.assert_allclose(got, want, atol=0.05)


def test_configurations_route_through_their_kernels(tiny_cfg, monkeypatch):
    """Which kernel wrapper each configuration calls, and how often (the
    wrappers run their twins on the CPU, so the calls are counted here)."""
    from hrnet_hand_pose_estimation_tpu_torch.core import fast_infer as FI
    from hrnet_hand_pose_estimation_tpu_torch.utils.weights import init_variables

    cfg = config_from_dict(tiny_cfg.to_dict())
    weights = precast_variables(cfg, init_variables(cfg, seed=1), device="cpu")
    calls = {}
    for name in ("fused_basic_chain", "fused_bottleneck_chain", "fused_stem_layer1"):
        real = getattr(FI, name)
        monkeypatch.setattr(FI, name, lambda *a, _n=name, _f=real, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _f(*a, **k))[1])
    x = torch.zeros(2, 64, 64, 3)
    for kwargs, want in [
            (dict(), {"fused_bottleneck_chain": 1}),
            (dict(pallas_layer1=False), {}),
            (dict(s2d_stem=True), {"fused_bottleneck_chain": 1}),
            (dict(s2d_stem=True, pallas_layer1=False), {}),
            (dict(fuse_stem_layer1=True, pallas_layer1=False), {"fused_stem_layer1": 1}),
            (dict(fuse_stem_layer1=True, s2d_stem=True), {"fused_stem_layer1": 1}),
            (dict(pallas_branches=True), {"fused_basic_chain": 9, "fused_bottleneck_chain": 1})]:
        calls.clear()
        out = make_fast_infer(cfg, device="cpu", **kwargs)(weights, x)
        assert out.shape == (2, 21, 2) and calls == want, (kwargs, calls)


def plain_head_cfg(tiny_cfg):
    cfg = tiny_cfg.clone()
    cfg.defrost()
    cfg.MODEL.NAME = "pose_hrnet"
    cfg.MODEL.HEATMAP_SOFTMAX = True
    return cfg.freeze()


def test_plain_head_serves_through_fast_infer(tiny_cfg):
    """A plain-head state (no trainable_temp) serves with temperature 1, as
    JAX's prepare_head_params serves it, within 0.05 px of JAX."""
    jcfg = plain_head_cfg(tiny_cfg)
    # temperature 1 leaves the gain-0.7 heatmaps nearly flat; gain 1.0
    # spreads the decode (checked below) and stays out of the chaotic range
    v, x = activated(jcfg, "plain", gain=1.0)
    assert "trainable_temp" not in v["params"]
    want = np.asarray(jax_make_fast_infer(jcfg, pallas_layer1=False, interpret=True)(
        v, jnp.asarray(x)))
    cfg = config_from_dict(jcfg.to_dict())
    state = from_jax_variables(v)
    weights = precast_variables(cfg, state, device="cpu")
    assert weights.model.head == "plain" and weights.head.temp.item() == 1.0
    got = make_fast_infer(cfg, device="cpu")(weights, torch.from_numpy(x)).numpy()
    assert got.shape == (4, 21, 2) and want.std() > 0.2
    print(f"plain head, bf16 path: max |port - JAX| {np.abs(got - want).max():.4g} px, "
          f"spread {want.std():.3g}")
    np.testing.assert_allclose(got, want, atol=0.05)


def test_plain_head_serves_through_quant_infer(tiny_cfg):
    """The int8 serving path on a plain-head state against JAX's, as
    tests/test_torch_quant_infer.py holds the softmax head."""
    jcfg = plain_head_cfg(tiny_cfg)
    v, _ = activated(jcfg, "plain")
    u8 = np.random.default_rng(7).integers(0, 256, size=(4, 64, 64, 3)).astype(np.uint8)
    mean, std = (np.asarray(a, np.float32) for a in NORM)
    amax = JQ.calibrate(jcfg, v, [(u8.astype(np.float32) / 255.0 - mean) / std])
    qparams = JQ.prepare_serving_qparams(jcfg, v, amax)
    want = np.asarray(JQ.make_quant_infer(jcfg, interpret=True, pallas_layer1=False,
                                          input_norm=NORM)(v, qparams, jnp.asarray(u8)))
    cfg = config_from_dict(jcfg.to_dict())
    state = from_jax_variables(v)
    weights = precast_variables(cfg, state, device="cpu")
    qp = Q.prepare_serving_qparams(cfg, state, amax)
    got = Q.make_quant_infer(cfg, device="cpu", input_norm=NORM)(weights, qp,
                                                                 torch.from_numpy(u8))
    assert got.shape == (4, 21, 2) and want.std() > 0.2
    print(f"plain head, int8 path: max |port - JAX| {np.abs(got.numpy() - want).max():.4g} px, "
          f"spread {want.std():.3g}")
    np.testing.assert_allclose(got.numpy(), want, atol=0.05)


def test_precast_still_refuses_a_broken_trunk(tiny_cfg):
    """Only trainable_temp may be absent: a state missing a trunk key, or
    carrying one the model does not have, still raises."""
    from hrnet_hand_pose_estimation_tpu_torch.utils.weights import init_variables

    cfg = config_from_dict(tiny_cfg.to_dict())
    state = init_variables(cfg, seed=2)
    for broken in ({k: v for k, v in state.items() if k != "stage3.0.branches.1.0.conv2.weight"},
                   {**state, "stage2.0.branches.0.0.conv3.weight": torch.zeros(1)},
                   {k: v for k, v in state.items()
                    if k not in ("trainable_temp", "last_layer.1.running_var")}):
        with pytest.raises(RuntimeError, match="state_dict"):
            precast_variables(cfg, broken, device="cpu")
