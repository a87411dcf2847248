"""The port's softmax decode (kernel B4's plain twin, ``ops.decode.softmax_decode``)
and the decode refiners against the JAX package's, on the same numpy inputs.

The twin is held to the JAX Pallas kernel ``fused_softmax_decode`` run in
interpret mode, at that kernel's own cases and tolerances
(tests/test_pallas_kernels.py:16-29); the kernel itself is held to the twin
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.ops import decode as JD
from hrnet_hand_pose_estimation_tpu.ops.pallas.decode_kernel import (
    fused_softmax_decode as jax_fused_softmax_decode)
from hrnet_hand_pose_estimation_tpu_torch.ops import decode as D
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.softmax_decode import (
    MAX_SPLITS, PIECE_BYTES, decode_plan, fused_softmax_decode, softmax_decode_reference,
    softmax_decode_split_reference)

torch.set_num_threads(1)


@pytest.fixture
def rng():
    """A fresh generator per test: drawing from conftest's shared ``rng``
    would shift the data of other test files in the same worker."""
    return np.random.default_rng(0)


@pytest.mark.parametrize("temp", [1.0, 2.5])
def test_twin_matches_pallas_kernel(rng, temp):
    """(3, 16, 16, 21) f32 at T 1.0 and 2.5: atol 1e-4 px, as the JAX test."""
    logits = (rng.normal(size=(3, 16, 16, 21)) * 3.0).astype(np.float32)
    want = np.asarray(jax_fused_softmax_decode(jnp.asarray(logits), temp, interpret=True))
    got = softmax_decode_reference(torch.from_numpy(logits), temp)
    assert got.shape == (3, 21, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_twin_matches_pallas_kernel_bf16(rng):
    """bf16 (2, 8, 8, 4): atol 0.05 px, as the JAX test."""
    logits = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    want = np.asarray(jax_fused_softmax_decode(jnp.asarray(logits).astype(jnp.bfloat16), 1.0,
                                               interpret=True))
    got = softmax_decode_reference(torch.from_numpy(logits).to(torch.bfloat16), 1.0)
    np.testing.assert_allclose(got.numpy(), want, atol=0.05)


@pytest.mark.parametrize("shape", [(5, 16, 16, 21), (2, 12, 16, 21), (1, 7, 5, 3)])
def test_twin_ragged_nonsquare_tensor_temperature(rng, shape):
    """A ragged B (the TPU kernel pads B to 8), non-square planes (u is the
    column, v the row) and T as a 0-d tensor: atol 1e-4 px."""
    logits = (rng.normal(size=shape) * 3.0).astype(np.float32)
    want = np.asarray(jax_fused_softmax_decode(jnp.asarray(logits), 1.7, interpret=True))
    got = softmax_decode_reference(torch.from_numpy(logits), torch.tensor(1.7))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert (got[..., 0] <= shape[2] - 1).all() and (got[..., 1] <= shape[1] - 1).all()


def test_softmax_decode_on_cpu_is_the_twin(rng):
    """``ops.decode.softmax_decode`` on a CPU tensor runs the twin, with no
    launch, and equals soft_argmax(spatial_softmax(...)) bit for bit."""
    logits = torch.from_numpy((rng.normal(size=(4, 16, 16, 21)) * 2.0).astype(np.float32))
    temp = torch.tensor(1.3)
    before = fused_softmax_decode.launches
    got = D.softmax_decode(logits, temp)
    assert fused_softmax_decode.launches == before
    assert torch.equal(got, D.soft_argmax(D.spatial_softmax(logits, temp)))


def test_flat_and_peaked_planes_decode_exactly():
    flat = torch.zeros(2, 16, 12, 3)
    np.testing.assert_array_equal(D.softmax_decode(flat).numpy()[..., 0], 5.5)
    np.testing.assert_array_equal(D.softmax_decode(flat).numpy()[..., 1], 7.5)
    peak = torch.zeros(1, 16, 16, 2)
    peak[0, 3, 11, 1] = 1e4
    out = D.softmax_decode(peak, 2.5)
    assert out[0, 1].tolist() == [11.0, 3.0]


def test_wrapper_refuses_bad_input():
    with pytest.raises(ValueError, match="B, H, W, K"):
        fused_softmax_decode(torch.zeros(4, 4, 4))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_softmax_decode(torch.zeros(1, 4, 4, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="scalar"):
        fused_softmax_decode(torch.zeros(1, 4, 4, 2), torch.ones(2))
    with pytest.raises(ValueError, match="joints"):
        fused_softmax_decode(torch.zeros(1, 2, 2, 1025))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_softmax_decode(torch.zeros(1, 4, 4, 2, device="meta"))


@pytest.mark.parametrize("batch", [1, 3, 32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_plan_fills_the_card(batch, dtype):
    """B4's split at the eval path's 64x64x21 planes: 8 ranges of 512 pixels
    (S * B >= 264 blocks from B=33 on), a bf16 range in one 32 KB piece, an
    f32 range in two, and the shared memory the kernel lays out (the
    states, one piece with its pixels' (u, v), 16 bytes of alignment)."""
    size = torch.empty((), dtype=dtype).element_size()
    plan = decode_plan(batch, 64, 64, 21, size)
    assert plan.splits == MAX_SPLITS and plan.range_px == 512
    assert plan.piece_px * (21 * size + 8) <= PIECE_BYTES
    assert -(-plan.range_px // plan.piece_px) == size // 2
    assert plan.smem == 384 + -(-plan.piece_px * 8 // 16) * 16 + plan.piece_px * 21 * size + 16
    assert decode_plan(batch, 1, 3, 21, size).splits <= 3          # never more ranges than pixels


def twin64(logits, temp):
    """The twin's formula, softmax then expectations, in float64."""
    b, h, w, k = logits.shape
    t = temp.double() if isinstance(temp, torch.Tensor) else temp
    p = torch.softmax(logits.double().reshape(b, h * w, k) * t, dim=1)
    idx = torch.arange(h * w)
    return torch.stack([(p * (idx % w).double()[:, None]).sum(1),
                        (p * (idx // w).double()[:, None]).sum(1)], dim=-1)


@pytest.mark.parametrize("splits", list(range(1, 17)))
def test_split_reference_matches_the_twin(splits):
    """The kernel's order of operations (ranges, pieces, one rescale per
    merge) against the twin on ragged batches and non-square planes, with
    pieces of the whole range and of 5 pixels, T as a float and a tensor:
    1e-5 px of the twin's formula in float64 and 1e-4 px of the float32
    twin (float32's own rounding; the kernel's tolerance)."""
    for shape in ((5, 16, 16, 21), (2, 12, 16, 21), (1, 7, 5, 3), (3, 9, 13, 21)):
        rng = np.random.default_rng(sum(shape))
        x = torch.from_numpy((rng.normal(size=shape) * 3).astype(np.float32))
        for temp in (1.0, torch.tensor(2.5)):
            for piece in (None, 5):
                got = softmax_decode_split_reference(x, temp, splits, piece)
                assert got.shape == (shape[0], shape[3], 2)
                assert (got - twin64(x, temp)).abs().max().item() <= 1e-5
                assert (got.float() - softmax_decode_reference(x, temp)).abs().max().item() <= 1e-4


@pytest.mark.parametrize("splits,piece", [(1, None), (3, None), (8, 7), (16, 1)])
def test_split_reference_exact_planes(splits, piece):
    """Flat planes decode to exactly the centre and a single peak to exactly
    its pixel, however the plane is split; -inf adds nothing, an all -inf
    plane is NaN, as the plain softmax gives."""
    flat = torch.zeros(2, 16, 12, 3)
    got = softmax_decode_split_reference(flat, 2.5, splits, piece)
    assert (got[..., 0] == 5.5).all() and (got[..., 1] == 7.5).all()
    peak = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 16, 16, 4)).astype(np.float32))
    peak[1, 3, 11, 2] = 1e4
    assert softmax_decode_split_reference(peak, 2.5, splits, piece)[1, 2].tolist() == [11.0, 3.0]
    x = peak.clone()
    x[0, :, :8, 1] = -float("inf")
    x[0, :, :, 3] = -float("inf")
    got = softmax_decode_split_reference(x, 1.0, splits, piece)
    want = softmax_decode_reference(x, 1.0)
    assert (got[0, 1].float() - want[0, 1]).abs().max().item() <= 1e-4
    assert torch.isnan(got[0, 3]).all() and torch.isnan(want[0, 3]).all()


def _peaky_maps(rng, shape=(3, 16, 16, 21)):
    """Smooth maps with one interior peak per joint, so the refiners' stencils
    are well conditioned, plus a few joints with non-positive peaks."""
    b, h, w, k = shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    cx = rng.uniform(2, w - 3, size=(b, k))
    cy = rng.uniform(2, h - 3, size=(b, k))
    maps = np.exp(-((xs[None, :, :, None] - cx[:, None, None, :]) ** 2
                    + (ys[None, :, :, None] - cy[:, None, None, :]) ** 2) / 4.5)
    maps = maps + 0.01 * rng.normal(size=shape)
    maps[0, :, :, 0] -= 2.0
    return maps.astype(np.float32)


def test_refiners_match_jax(rng):
    """heatmap_maxvals, get_max_preds_with_maxvals, quarter_offset_refine,
    taylor_refine and gaussian_modulate against JAX's ops/decode.py:80-179
    on the same maps: the integer decodes exactly, the refiners to 1e-5."""
    maps = _peaky_maps(rng)
    jm, tm = jnp.asarray(maps), torch.from_numpy(maps)

    np.testing.assert_array_equal(D.heatmap_maxvals(tm).numpy(), np.asarray(JD.heatmap_maxvals(jm)))
    jp, jv = JD.get_max_preds_with_maxvals(jm)
    tp, tv = D.get_max_preds_with_maxvals(tm)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (tp[0, 0] == 0).all()             # the non-positive peak is zeroed

    coords = np.array(JD.hard_argmax(jm))
    coords[1, :3] = [[0, 0], [15, 15], [1, 14]]     # edge peaks: no refinement
    jc, tc = jnp.asarray(coords), torch.from_numpy(coords)
    np.testing.assert_allclose(D.quarter_offset_refine(tm, tc).numpy(),
                               np.asarray(JD.quarter_offset_refine(jm, jc)), atol=1e-6)
    np.testing.assert_allclose(D.taylor_refine(tm, tc).numpy(),
                               np.asarray(JD.taylor_refine(jm, jc)), atol=1e-5)
    for kernel in (3, 5, 11):
        np.testing.assert_allclose(D.gaussian_modulate(tm, kernel).numpy(),
                                   np.asarray(JD.gaussian_modulate(jm, kernel)),
                                   atol=1e-5, rtol=1e-5)
