"""The port's evaluation metrics (core/metrics.py) against the JAX package's,
on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.core import metrics as JM
from hrnet_hand_pose_estimation_tpu_torch.core import metrics as M

torch.set_num_threads(1)


@pytest.fixture
def rng():
    """A fresh generator per test: drawing from conftest's shared ``rng``
    would shift the data of other test files in the same worker."""
    return np.random.default_rng(0)


def _batch(rng, b=6, k=21, d=2, scale=20.0):
    pred = rng.normal(size=(b, k, d)).astype(np.float32) * scale
    gt = rng.normal(size=(b, k, d)).astype(np.float32) * scale
    vis = (rng.uniform(size=(b, k)) > 0.25).astype(np.float32)
    return pred, gt, vis


def test_thresholds_match_jax():
    np.testing.assert_array_equal(M.default_thresholds_2d().numpy(),
                                  np.asarray(JM.default_thresholds_2d()))
    np.testing.assert_array_equal(M.default_thresholds_3d().numpy(),
                                  np.asarray(JM.default_thresholds_3d()))
    assert M.default_thresholds_2d().dtype == torch.float32


@pytest.mark.parametrize("dims", [2, 3])
def test_state_update_merge_and_results_match_jax(rng, dims):
    """Two batches accumulated, and the same two merged from separate states:
    EPE per joint and the PCK curve equal JAX's to float32 rounding (1e-6
    relative; the PCK counts are exact)."""
    th_j = JM.default_thresholds_2d() if dims == 2 else JM.default_thresholds_3d()
    th_t = M.default_thresholds_2d() if dims == 2 else M.default_thresholds_3d()
    batches = [_batch(rng, d=dims) for _ in range(2)]

    js = JM.PoseMetricState.create(21, th_j)
    ts = M.PoseMetricState.create(21, th_t)
    parts_j, parts_t = [], []
    for pred, gt, vis in batches:
        js = js.update(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(vis), th_j)
        ts = ts.update(torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(vis), th_t)
        parts_j.append(JM.PoseMetricState.create(21, th_j).update(
            jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(vis), th_j))
        parts_t.append(M.PoseMetricState.create(21, th_t).update(
            torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(vis), th_t))
    merged_t = parts_t[0].merge(parts_t[1])
    merged_j = parts_j[0].merge(parts_j[1])

    for got, want in ((ts, js), (merged_t, merged_j)):
        assert all(t.dtype == torch.float32 for t in got)
        np.testing.assert_array_equal(got.vis_sum.numpy(), np.asarray(want.vis_sum))
        np.testing.assert_array_equal(got.pck_sum.numpy(), np.asarray(want.pck_sum))
        np.testing.assert_allclose(got.epe_per_joint(), want.epe_per_joint(), rtol=1e-6)
        np.testing.assert_allclose(got.pck_curve(), want.pck_curve(), rtol=1e-6)
        assert got.epe_mean() == pytest.approx(want.epe_mean(), rel=1e-6)


def test_invisible_joints_are_ignored():
    th = M.default_thresholds_2d()
    pred = torch.zeros(1, 2, 2)
    gt = torch.tensor([[[3.0, 4.0], [100.0, 0.0]]])
    st = M.PoseMetricState.create(2, th).update(pred, gt, torch.tensor([[1.0, 0.0]]), th)
    np.testing.assert_allclose(st.epe_per_joint(), [5.0, 0.0])
    curve = st.pck_curve()
    assert curve[4] == 0.0 and curve[5] == 1.0      # 5 < 6 but not < 5


@pytest.mark.parametrize("end", [30, None])
def test_auc_and_pck_at_match_jax(rng, end):
    th = np.asarray(JM.default_thresholds_2d())
    pck = np.sort(rng.uniform(size=th.shape)).astype(np.float32)
    assert M.pck_auc(pck, th, end=end) == JM.pck_auc(pck, th, end=end)
    assert M.pck_auc(pck, th, start=3, end=end) == JM.pck_auc(pck, th, start=3, end=end)
    for value in (1.0, 20.0, 20.4, 49.0):
        assert M.pck_at(pck, th, value) == JM.pck_at(pck, th, value)
    # a perfect curve integrates to 1 over either slice
    assert M.pck_auc(np.ones_like(pck), th, end=end) == pytest.approx(1.0)
