"""The port's NMS (``ops/nms.py``) and ``scale_aware_gaussian_targets``
(``ops/targets.py``) against the JAX package's, on seeded boxes, poses and
joints.  Limits: ``iou_matrix`` and ``oks_matrix`` within 1e-6, the keep
masks of ``nms`` and ``oks_nms`` equal to JAX's (tied scores included),
``soft_nms`` (both methods) within 1e-6, the targets within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.ops import nms as jax_nms
from hrnet_hand_pose_estimation_tpu.ops import targets as jax_targets
from hrnet_hand_pose_estimation_tpu_torch.ops import nms
from hrnet_hand_pose_estimation_tpu_torch.ops.targets import scale_aware_gaussian_targets

torch.set_num_threads(1)


def boxes(n, seed, ties=False):
    """(N, 5) [x1, y1, x2, y2, score]: clustered boxes that overlap; with
    ``ties`` the scores take five values only."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 200, size=(max(n // 8, 1), 2))[rng.integers(0, max(n // 8, 1), n)]
    xy = centres + rng.normal(scale=8, size=(n, 2))
    wh = rng.uniform(10, 60, size=(n, 2))
    scores = (rng.integers(1, 6, n) / 5.0) if ties else rng.uniform(0.01, 1.0, n)
    return np.concatenate([xy, xy + wh, scores[:, None]], 1).astype(np.float32)


def poses(n, seed, k=17):
    """(N, K, 3) keypoints with visibility, (N,) scores and areas: jittered
    copies of a few people, so that OKS is high within a group."""
    rng = np.random.default_rng(seed)
    people = rng.uniform(0, 200, size=(max(n // 5, 1), k, 2))[rng.integers(0, max(n // 5, 1), n)]
    kp = people + rng.normal(scale=1, size=(n, k, 2))
    vis = (rng.uniform(size=(n, k)) > 0.2).astype(np.float32)
    return (np.concatenate([kp, vis[..., None]], -1).astype(np.float32),
            rng.uniform(0.1, 1.0, n).astype(np.float32),
            rng.uniform(500, 5000, n).astype(np.float32))


@pytest.mark.parametrize("n", [1, 37, 300])
def test_iou_matrix(n):
    d = boxes(n, n)
    got = nms.iou_matrix(torch.from_numpy(d[:, :4])).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_nms.iou_matrix(jnp.asarray(d[:, :4]))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.diag(got), 1.0, atol=1e-6)


@pytest.mark.parametrize("n,thresh,ties", [(37, 0.3, False), (300, 0.5, False),
                                           (300, 0.3, True), (64, 0.7, True)])
def test_nms_keep_mask_equal(n, thresh, ties):
    d = boxes(n, n + 1, ties)
    got = nms.nms(torch.from_numpy(d), thresh)
    want = np.asarray(jax_nms.nms(jnp.asarray(d), thresh))
    assert got.dtype == torch.bool and 0 < int(got.sum()) < n
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_soft_nms(method):
    d = boxes(120, 5)
    got = nms.soft_nms(torch.from_numpy(d), sigma=0.5, score_thresh=0.001, method=method)
    want = np.asarray(jax_nms.soft_nms(jnp.asarray(d), 0.5, 0.001, method))
    assert got.shape == (120, 5)
    np.testing.assert_array_equal(got[:, :4].numpy(), d[:, :4])
    assert (want[:, 4] < d[:, 4]).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k,ties", [(17, False), (21, False), (17, True)])
def test_oks(k, ties):
    """oks_matrix (COCO's 17 sigmas, or 0.05 for another K) within 1e-6;
    the OKS-NMS keep mask equal to JAX's, tied scores included."""
    kp, scores, areas = poses(150, k, k)
    if ties:
        scores = np.round(scores * 3) / 3
    args = (torch.from_numpy(kp), torch.from_numpy(areas))
    got = nms.oks_matrix(*args).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_nms.oks_matrix(jnp.asarray(kp),
                                                                  jnp.asarray(areas))),
                               rtol=0, atol=1e-6)
    keep = nms.oks_nms(args[0], torch.from_numpy(scores), args[1], 0.9)
    want = np.asarray(jax_nms.oks_nms(jnp.asarray(kp), jnp.asarray(scores),
                                      jnp.asarray(areas), 0.9))
    assert 0 < int(keep.sum()) < 150
    np.testing.assert_array_equal(keep.numpy(), want)
    assert nms.COCO_SIGMAS == jax_nms.COCO_SIGMAS


def test_scale_aware_gaussian_targets():
    """Per-joint sigmas from 0.5 to 4 (windows of 2 to 13 px), joints out of
    range, at the border and invisible; B = 4, K = 21, 32 px maps."""
    rng = np.random.default_rng(6)
    joints = rng.uniform(-3, 35, size=(4, 21, 2)).astype(np.float32)
    joints[0, 0] = [-0.5, 31.9]
    vis = (rng.uniform(size=(4, 21)) > 0.2).astype(np.float32)
    sigmas = rng.uniform(0.5, 4.0, size=(4, 21)).astype(np.float32)
    got = scale_aware_gaussian_targets(*(torch.from_numpy(a) for a in (joints, vis, sigmas)), 32)
    want = np.asarray(jax_targets.scale_aware_gaussian_targets(
        jnp.asarray(joints), jnp.asarray(vis), jnp.asarray(sigmas), 32))
    assert got.shape == (4, 32, 32, 21) and got.dtype == torch.float32
    assert float(want.max()) == 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
