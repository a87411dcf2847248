"""The port's Gaussian targets (kernel B5's twin), decoders and flips
against the JAX package's.

``gaussian_targets_reference`` (the plain twin of ``csrc/gaussian_targets.cu``)
is held to the JAX ``ops/targets.gaussian_targets`` and to the Pallas
``fused_gaussian_targets`` in interpret mode at atol 1e-6 (the JAX
package's own tolerance between those two): the product of two exps and
the exp of a sum differ by an ulp or so.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.ops import decode as jax_decode
from hrnet_hand_pose_estimation_tpu.ops import flip as jax_flip
from hrnet_hand_pose_estimation_tpu.ops.pallas.decode_kernel import (
    fused_gaussian_targets as pallas_targets)
from hrnet_hand_pose_estimation_tpu.ops.targets import gaussian_targets as jax_targets
from hrnet_hand_pose_estimation_tpu.ops.targets import gaussian_targets_np as jax_targets_np
from hrnet_hand_pose_estimation_tpu_torch.ops import decode, flip
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.gaussian_targets import (
    MIN_BLOCKS, SMEM_LIMIT, TargetsPlan, exp_table, fused_gaussian_targets,
    gaussian_targets_reference, targets_plan, window)
from hrnet_hand_pose_estimation_tpu_torch.ops.targets import gaussian_targets, gaussian_targets_np

torch.set_num_threads(1)


def edge_joints(res, seed=0, b=3, k=21):
    """Joints across the map plus the edge cases: -0.5 (valid, truncates to
    0), -0.99 (valid), exactly res (out), beyond res, negative (out); one
    invisible joint per sample."""
    rng = np.random.default_rng(seed)
    joints = rng.uniform(0, res, size=(b, k, 2)).astype(np.float32)
    joints[0, 0] = (-0.5, -0.5)
    joints[0, 1] = (res, 3.0)
    joints[1, 2] = (res + 2.5, res * 0.5)
    joints[1, 3] = (-1.5, 4.0)
    joints[2, 4] = (res - 0.01, -0.99)
    joints[2, 5] = (0.0, res - 1.0)
    vis = np.ones((b, k), np.float32)
    vis[np.arange(b), np.arange(b) + 7] = 0.0
    return joints, vis


@pytest.mark.parametrize("res", [16, 64])
@pytest.mark.parametrize("sigma,win", [(1.0, 4), (1.5, 5), (2.0, 7)])
def test_twin_matches_jax_and_pallas(res, sigma, win):
    joints, vis = edge_joints(res, seed=res)
    got = gaussian_targets_reference(torch.from_numpy(joints), torch.from_numpy(vis), res,
                                     sigma).numpy()
    want = np.asarray(jax_targets(jnp.asarray(joints), jnp.asarray(vis), res, sigma))
    pallas = np.asarray(pallas_targets(jnp.asarray(joints), jnp.asarray(vis), res, sigma,
                                       interpret=True))
    assert window(sigma)[0] == win
    assert got.shape == want.shape == (3, res, res, 21)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-6, rtol=0)
    # exactly 0 outside the windows and for the invalid joints
    np.testing.assert_array_equal(got == 0, want == 0)
    assert got[0, 0, 0, 0] == 1.0                    # -0.5 truncates to 0: in range
    assert not got[0, ..., 1].any() and not got[1, ..., 2].any() and not got[1, ..., 3].any()
    assert not got[0, ..., 7].any()                  # invisible
    assert got[2, 0, res - 1, 4] == 1.0              # (res - 0.01, -0.99) -> (res - 1, 0)


def test_band_plan():
    """B5's plan: bands of a power of two rows, at most 16, as wide as keeps
    MIN_BLOCKS blocks; the exp table when it fits beside the joints."""
    assert targets_plan(32, 21, 64) == TargetsPlan(4, 16, True, 8 * 21 + 99 * 4)
    assert targets_plan(128, 21, 64) == TargetsPlan(16, 4, True, 8 * 21 + 99 * 4)
    assert targets_plan(3, 17, 63) == TargetsPlan(1, 63, True, 8 * 17 + 99 * 4)
    assert targets_plan(64, 17, 63, 1.5) == TargetsPlan(8, 8, True, 8 * 17 + 51 * 4)
    for b in (1, 2, 7, 32, 33, 100, 128, 4096):
        for res in (1, 2, 16, 63, 64, 256):
            plan = targets_plan(b, 21, res)
            assert plan.rows & (plan.rows - 1) == 0 and 1 <= plan.rows <= min(16, res)
            assert plan.bands == -(-res // plan.rows)
            if plan.rows > 1:                       # no wider band while it keeps the grid
                assert b * plan.bands >= MIN_BLOCKS
            if plan.rows < 16 and 2 * plan.rows <= res:  # the widest such band
                assert b * -(-res // (2 * plan.rows)) < MIN_BLOCKS
    wide = targets_plan(32, 21, 64, sigma=30.0)      # win 91: 16,563 exp values
    assert not wide.table and wide.smem == 8 * 21
    assert targets_plan(32, 4096, 64).smem <= SMEM_LIMIT


@pytest.mark.parametrize("sigma", [1.0, 1.5, 2.0, 3.0, 7.3])
def test_exp_table_gives_the_twins_floats(sigma):
    """B5 reads lut[dx^2 + dy^2] where the twin evaluates exp(-(dx^2 +
    dy^2) / 2 sigma^2): the same float32 expression, so the table lookup
    reproduces every output of the twin bit for bit (ragged K, a map of odd
    width, invalid joints)."""
    res, k = 63, 17
    joints, vis = edge_joints(res, seed=int(sigma * 10), b=3, k=k)
    j, v = torch.from_numpy(joints), torch.from_numpy(vis)
    want = gaussian_targets_reference(j, v, res, sigma)
    win, _ = window(sigma)
    lut = exp_table(sigma)
    assert lut.shape == (2 * win * win + 1,)
    tx, ty = torch.trunc(j[..., 0]), torch.trunc(j[..., 1])
    valid = (v > 0) & (tx >= 0) & (ty >= 0) & (tx < res) & (ty < res)
    px = torch.arange(res)
    dx = (px[None, None, :, None] - tx.long()[:, None, None, :]).expand(3, res, res, k)
    dy = (px[None, :, None, None] - ty.long()[:, None, None, :]).expand(3, res, res, k)
    inside = (dx.abs() <= win) & (dy.abs() <= win) & valid[:, None, None, :]
    got = torch.where(inside, lut[torch.where(inside, dx * dx + dy * dy, 0)], 0.0)
    assert torch.equal(got, want) and (want > 0).any()


def test_numpy_targets_equal_jax():
    for res, sigma in ((16, 1.0), (64, 2.0), (64, 1.5)):
        joints, vis = edge_joints(res, seed=3)
        np.testing.assert_array_equal(gaussian_targets_np(joints, vis, res, sigma),
                                      jax_targets_np(joints, vis, res, sigma))
        np.testing.assert_array_equal(gaussian_targets_np(joints[1], vis[1], res, sigma),
                                      jax_targets_np(joints[1], vis[1], res, sigma))


def test_wrapper_on_cpu_runs_the_twin_and_validates():
    joints, vis = edge_joints(16)
    j, v = torch.from_numpy(joints), torch.from_numpy(vis)
    before = fused_gaussian_targets.launches
    got = fused_gaussian_targets(j, v, 16, 2.0)
    assert fused_gaussian_targets.launches == before
    assert torch.equal(got, gaussian_targets_reference(j, v, 16, 2.0))
    # the public entry casts like the JAX one does
    assert torch.equal(gaussian_targets(j.double(), v > 0, 16, 2.0), got)
    with pytest.raises(ValueError, match="float32"):
        fused_gaussian_targets(j.double(), v, 16)
    with pytest.raises(ValueError, match=r"\(B, K, 2\)"):
        fused_gaussian_targets(j[..., :1], v, 16)
    with pytest.raises(ValueError, match="visibility"):
        fused_gaussian_targets(j, v[:, :5], 16)
    with pytest.raises(ValueError, match="output_res"):
        fused_gaussian_targets(j, v, 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_gaussian_targets(j.to("meta"), v.to("meta"), 16)


def test_hard_argmax_and_decode_match_jax():
    rng = np.random.default_rng(101)
    hm = rng.normal(size=(2, 12, 16, 5)).astype(np.float32)
    hm[0, 3, 7, 0] = hm[0, 9, 2, 0] = hm[0].max() + 1.0     # a tie: the first wins
    got = decode.hard_argmax(torch.from_numpy(hm)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_decode.hard_argmax(jnp.asarray(hm))))
    assert tuple(got[0, 0]) == (7.0, 3.0)
    probs = np.exp(hm) / np.exp(hm).sum(axis=(1, 2), keepdims=True)
    for use_softmax, arr in ((True, probs), (False, hm)):
        np.testing.assert_allclose(
            decode.decode_heatmaps(torch.from_numpy(arr), use_softmax).numpy(),
            np.asarray(jax_decode.decode_heatmaps(jnp.asarray(arr), use_softmax)),
            rtol=1e-6, atol=1e-5)


def test_flip_utilities_match_jax():
    rng = np.random.default_rng(102)
    hm = rng.normal(size=(2, 6, 8, 4)).astype(np.float32)
    pairs = ((0, 3),)
    for parts in ((), pairs):
        np.testing.assert_array_equal(flip.flip_back(torch.from_numpy(hm), parts).numpy(),
                                      np.asarray(jax_flip.flip_back(jnp.asarray(hm), parts)))
    np.testing.assert_array_equal(flip.shift_heatmap(torch.from_numpy(hm)).numpy(),
                                  np.asarray(jax_flip.shift_heatmap(jnp.asarray(hm))))
    joints = rng.uniform(0, 8, size=(4, 2)).astype(np.float32)
    vis = (rng.uniform(size=(4, 2)) > 0.3).astype(np.float32)
    for parts in ((), pairs):
        got = flip.fliplr_joints(torch.from_numpy(joints), torch.from_numpy(vis), 8, parts)
        want = jax_flip.fliplr_joints(jnp.asarray(joints), jnp.asarray(vis), 8, parts)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
