"""The port's W8A8 BasicBlock branch chain (ops/kernels/int8_chain.py:
prepare_branch_int8, basic_chain_int8_reference, fused_basic_chain_int8)
against the JAX package's (ops/pallas/int8_chain.py).

On the CPU the wrapper runs its plain PyTorch twin; the JAX side runs its
reference op by op and its Pallas kernel in interpret mode, as
tests/test_int8_chain.py does.  Weights cross through
``utils/weights.from_jax_variables``; the random-but-active weights and the
calibration record are the recipe of tests/test_quant_infer.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.core import quant_infer as JQ
from hrnet_hand_pose_estimation_tpu.models.hrnet import hrnet_from_cfg as jax_hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu.ops.pallas import int8_chain as jax_chain
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core import quant_infer as Q
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import precast_variables
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.int8_chain import (
    _BASIC_NAMES, _pad_basic_int8, _split_basic, basic_chain_int8_reference, basic_int8_width,
    fused_basic_chain_int8, prepare_branch_int8)
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from tests.test_quant_infer import _activated_variables

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def no_grad():
    """Autograd off for this module only (a module-level switch would
    also turn it off for every other test file a worker imports)."""
    with torch.no_grad():
        yield


def chain_case(rng, c, n_blocks, batch, h, w):
    """Random params in the kernel's flat layout, built as
    tests/test_int8_chain.py builds them, and a bf16 input."""
    flat = []
    for _ in range(n_blocks):
        flat += [np.full((1, 1), 11.3, np.float32),
                 rng.integers(-127, 128, size=(9 * c, c)).astype(np.int8),
                 (np.abs(rng.normal(size=c)) * 1e-3 + 1e-4).astype(np.float32),
                 (rng.normal(size=c) * 0.5).astype(np.float32),
                 rng.integers(-127, 128, size=(9 * c, c)).astype(np.int8),
                 (np.abs(rng.normal(size=c)) * 1e-3 + 1e-4).astype(np.float32),
                 (rng.normal(size=c) * 0.02).astype(np.float32)]
    x = jnp.asarray(rng.normal(size=(batch, h, w, c)).astype(np.float32)).astype(jnp.bfloat16)
    return flat, x


def to_torch_bf16(x) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))).to(torch.bfloat16)


# (C, n_blocks, B, H, W): JAX's own case, a w32 width on a non-square map,
# and a w48 width (C % 32 == 16) at B=3
@pytest.mark.parametrize("c,n_blocks,batch,h,w", [(16, 3, 2, 8, 8), (32, 4, 2, 8, 16),
                                                  (48, 2, 3, 4, 4)])
def test_twin_matches_jax_reference_and_kernel(c, n_blocks, batch, h, w):
    rng = np.random.default_rng(c + n_blocks)
    flat, x = chain_case(rng, c, n_blocks, batch, h, w)
    jflat = tuple(jnp.asarray(a) for a in flat)
    with jax.disable_jit():
        want_r = np.asarray(jax_chain.basic_chain_int8_reference(x, jflat, n_blocks), np.float32)
    want_k = np.asarray(jax_chain.fused_basic_chain_int8(x, jflat, n_blocks, interpret=True),
                        np.float32)
    params = tuple(torch.from_numpy(a) for a in flat)
    xt = to_torch_bf16(x)
    before = fused_basic_chain_int8.launches
    got = fused_basic_chain_int8(xt, params, n_blocks)
    assert fused_basic_chain_int8.launches == before      # the CPU runs the twin
    assert torch.equal(got, basic_chain_int8_reference(xt, params, n_blocks))
    assert got.dtype == torch.bfloat16 and got.shape == (batch, h, w, c)
    assert np.abs(want_r).max() > 1.0
    np.testing.assert_allclose(got.float().numpy(), want_r, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), want_k, atol=1e-5)
    # samples_per_block is the TPU grid's option: same result
    assert torch.equal(fused_basic_chain_int8(xt, params, n_blocks, samples_per_block=2), got)


# widths the kernel does not take run zero-padded to the next one it does
@pytest.mark.parametrize("c,cp", [(80, 96), (112, 128), (144, 192), (160, 192)])
def test_padded_params_give_the_same_chain(c, cp):
    """_pad_basic_int8 (the wrapper's padding on the card) is exact: the
    twin on x and params zero-padded to cp gives the unpadded chain's bits
    in the first C channels and exact zeros in the rest."""
    assert basic_int8_width(c) == cp
    rng = np.random.default_rng(c)
    flat, x = chain_case(rng, c, 2, 2, 5, 6)
    params = tuple(torch.from_numpy(a) for a in flat)
    xt = to_torch_bf16(x)
    padded = tuple(_pad_basic_int8(p, cp)[n] for p in _split_basic(params, 2)
                   for n in _BASIC_NAMES)
    got = basic_chain_int8_reference(torch.nn.functional.pad(xt, (0, cp - c)), padded, 2)
    want = basic_chain_int8_reference(xt, params, 2)
    assert want.float().abs().max().item() > 1.0
    assert torch.equal(got[..., :c], want) and not got[..., c:].any()


@pytest.fixture(scope="module")
def activated(tiny_cfg):
    """tiny_cfg with the activated weights of tests/test_quant_infer.py in
    both packages and one calibration record made by the JAX package."""
    rng = np.random.default_rng(3)
    model = jax_hrnet_from_cfg(tiny_cfg, head="softmax")
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    v = jax.tree.map(np.asarray, _activated_variables(model, jnp.asarray(x), rng))
    amax = JQ.calibrate(tiny_cfg, v, [x])
    return tiny_cfg, config_from_dict(tiny_cfg.to_dict()), v, from_jax_variables(v), x, amax


def chains(cfg):
    """(module, branch, n_blocks) of every branch chain of the stages."""
    out = []
    for n, stage in enumerate(Q.stage_cfgs(cfg), start=2):
        for m in range(stage.num_modules):
            out += [(f"stage{n}_m{m}", i, stage.num_blocks[i]) for i in range(stage.num_branches)]
    return out


def test_prepare_branch_int8_equals_jax_for_every_chain(activated):
    tiny_cfg, cfg, v, state, _, amax = activated
    found = chains(cfg)
    assert len(found) == 9          # 2 + 3 + 4 branches, one module each
    for mod, i, n_blocks in found:
        want = jax_chain.prepare_branch_int8(v, amax, mod, i, n_blocks)
        got = prepare_branch_int8(state, amax, mod, i, n_blocks)
        assert len(got) == len(want) == 7 * n_blocks
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape, (mod, i)
            if w.dtype == np.int8:
                assert g.dtype == torch.int8
                np.testing.assert_array_equal(g.numpy(), w)
            else:
                assert g.dtype == torch.float32 and w.dtype == np.float32
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)


def test_branch_int8_kq_are_n_major_views(activated):
    """prepare_branch_int8 keeps the JAX shapes and values (above) but stores
    each kq as the (9C, C) view of N-major (C, 9C) storage, as the kernel
    reads it; the twin and the wrapper give the same bits from the views
    and from plain copies."""
    _, cfg, _, state, _, amax = activated
    for mod, i, n_blocks in chains(cfg):
        flat = prepare_branch_int8(state, amax, mod, i, n_blocks)
        for t in flat[1::7] + flat[4::7]:
            assert t.dtype == torch.int8 and not t.is_contiguous() and t.t().is_contiguous()
    mod, i, n_blocks = chains(cfg)[0]
    flat = prepare_branch_int8(state, amax, mod, i, n_blocks)
    plain = tuple(t.contiguous() for t in flat)
    c = flat[2].shape[0]
    rng = np.random.default_rng(c)
    x = torch.from_numpy(np.abs(rng.normal(size=(2, 6, 7, c))).astype(np.float32)).to(
        torch.bfloat16)
    want = basic_chain_int8_reference(x, plain, n_blocks)
    assert want.float().abs().max().item() > 0.1
    assert torch.equal(basic_chain_int8_reference(x, flat, n_blocks), want)
    assert torch.equal(fused_basic_chain_int8(x, flat, n_blocks), want)


def test_chain_matches_the_walk_and_jax_on_the_slice(activated):
    """The slice: the port's chain on the port walk's transition output vs
    the port's per-site int8 walk over the same branch (JAX's gate in
    tests/test_int8_chain.py), and vs JAX's reference on JAX's params."""
    tiny_cfg, cfg, v, state, x, amax = activated
    weights = precast_variables(cfg, state, device="cpu")
    qparams = Q.prepare_quant_params(cfg, state, amax, scope="branch")
    walk = Q._Walk(weights.model, "quant", qparams)
    x1 = Q._stem_layer1(weights, Q._to_input(torch.from_numpy(x), "cpu"))
    s2 = Q.stage_cfgs(cfg)[0]
    xin = walk.transition([x1], (256,), s2, "transition1")[0]        # NCHW bf16
    n_blocks = s2.num_blocks[0]
    flat = prepare_branch_int8(state, amax, "stage2_m0", 0, n_blocks)
    xt = Q._nhwc(xin)
    got = fused_basic_chain_int8(xt, flat, n_blocks).float()
    want = Q._nhwc(walk.branch(xin, "stage2_m0", 0, n_blocks)).float()
    scale = max(want.abs().max().item(), 1e-6)
    assert (got - want).abs().max().item() / scale < 0.05
    assert want.abs().max().item() > 0.1

    jflat = jax_chain.prepare_branch_int8(v, amax, "stage2_m0", 0, n_blocks)
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    with jax.disable_jit():
        want_j = np.asarray(jax_chain.basic_chain_int8_reference(xj, jflat, n_blocks),
                            np.float32)
    np.testing.assert_allclose(got.numpy(), want_j, atol=1e-5)


def test_bad_inputs_raise(activated):
    _, _, _, state, _, amax = activated
    flat = prepare_branch_int8(state, amax, "stage3_m0", 1, 1)
    x = torch.zeros(1, 8, 8, 16, dtype=torch.bfloat16)
    assert fused_basic_chain_int8(x, flat, 1).shape == x.shape
    with pytest.raises(ValueError, match="bfloat16"):
        fused_basic_chain_int8(x.float(), flat, 1)
    with pytest.raises(ValueError, match="kq1"):
        fused_basic_chain_int8(x[..., :8], flat, 1)
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        fused_basic_chain_int8(x[0], flat, 1)
    with pytest.raises(ValueError, match="take 14"):
        fused_basic_chain_int8(x, flat, 2)
    with pytest.raises(ValueError, match="take 7"):
        fused_basic_chain_int8(x, flat[:-1], 1)
    with pytest.raises(ValueError, match="int8"):
        fused_basic_chain_int8(x, (flat[0], flat[1].float()) + flat[2:], 1)
    with pytest.raises(ValueError, match="on meta"):
        fused_basic_chain_int8(x, (flat[0].to("meta"),) + flat[1:], 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_basic_chain_int8(x.to("meta"), tuple(t.to("meta") for t in flat), 1)
