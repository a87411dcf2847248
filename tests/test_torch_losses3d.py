"""The port's 3D losses and ``LossComputer3D`` against the JAX package's.

Seeded numpy inputs through both, float32: values within 1e-5 relative,
gradients (``jax.grad`` / autograd) within 1e-5 of their largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.core import losses as JL
from hrnet_hand_pose_estimation_tpu.core.loss_computer import LossComputer3D as JaxLC3
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core import losses as PL
from hrnet_hand_pose_estimation_tpu_torch.core.loss_computer import LossComputer3D

torch.set_num_threads(1)


def poses(seed, b=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-100, 100, size=(b, 21, 3)).astype(np.float32),
            rng.uniform(-100, 100, size=(b, 21, 3)).astype(np.float32))


def volumes(seed, b=2, s=6, k=21):
    rng = np.random.default_rng(seed)
    axis = np.linspace(-150, 150, s, dtype=np.float32)
    grid = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1)
    coords = np.broadcast_to(grid, (b, s, s, s, 3)) + rng.normal(size=(b, 1, 1, 1, 3)).astype(
        np.float32)
    logits = rng.normal(size=(b, s * s * s, k)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    gt = rng.uniform(-140, 140, size=(b, k, 3)).astype(np.float32)
    val = (rng.uniform(size=(b, k, 1)) > 0.2).astype(np.float32)
    return (np.ascontiguousarray(coords, np.float32), probs.reshape(b, s, s, s, k), gt, val)


def both(jax_fn, torch_fn, args, argnum):
    """(JAX value, JAX grad of argument ``argnum``, port value, port grad)."""
    jv, jg = jax.value_and_grad(lambda *a: jax_fn(*a), argnums=argnum)(
        *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a).clone() for a in args]
    targs[argnum].requires_grad_(True)
    pv = torch_fn(*targs)
    (pg,) = torch.autograd.grad(pv, (targs[argnum],))
    return float(jv), np.asarray(jg), float(pv.detach()), pg.numpy()


def assert_match(jv, jg, pv, pg):
    np.testing.assert_allclose(pv, jv, rtol=1e-5)
    np.testing.assert_allclose(pg, jg, rtol=0, atol=1e-5 * np.abs(jg).max())
    assert np.abs(jg).max() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_joints_3d_mse_loss(seed):
    pred, gt = poses(seed)
    assert_match(*both(JL.joints_3d_mse_loss, PL.joints_3d_mse_loss, (pred, gt), 0))


@pytest.mark.parametrize("seed", [0, 1])
def test_kcs_loss(seed):
    pred, gt = poses(seed + 10)
    assert_match(*both(JL.kcs_loss, PL.kcs_loss, (pred * 0.01, gt * 0.01), 0))


@pytest.mark.parametrize("seed", [0, 1])
def test_volumetric_ce_loss(seed):
    coords, probs, gt, val = volumes(seed)
    assert_match(*both(JL.volumetric_ce_loss, PL.volumetric_ce_loss, (coords, probs, gt, val), 1))


def test_volumetric_ce_takes_the_first_of_equidistant_voxels():
    """A ground truth halfway between two voxel centres: JAX's argmin and the
    port's both take the first index."""
    coords = np.zeros((1, 2, 1, 1, 3), np.float32)
    coords[0, 1, 0, 0, 0] = 10.0
    probs = np.array([0.2, 0.8], np.float32).reshape(1, 2, 1, 1, 1)
    gt = np.array([[[5.0, 0.0, 0.0]]], np.float32)
    val = np.ones((1, 1), np.float32)
    want = float(JL.volumetric_ce_loss(*map(jnp.asarray, (coords, probs, gt, val))))
    got = float(PL.volumetric_ce_loss(*map(torch.from_numpy, (coords, probs, gt, val))))
    assert got == pytest.approx(-np.log(0.2 + 1e-6), rel=1e-6) and got == pytest.approx(want)


def lc_cfg(tiny_cfg, **flags):
    cfg = tiny_cfg.clone()
    cfg.defrost()
    cfg.LOSS.WITH_HEATMAP_LOSS = False
    cfg.LOSS.POSE2D_LOSS_FACTOR = 0.1
    cfg.LOSS.VOLUMETRIC_LOSS_FACTOR = 0.01
    cfg.LOSS.KCS_LOSS_FACTOR = 0.05
    for key, val in flags.items():
        setattr(cfg.LOSS, key, val)
    cfg.freeze()
    return cfg, config_from_dict(cfg.to_dict())


@pytest.mark.parametrize("flags", [
    dict(WITH_POSE2D_LOSS=True, WITH_POSE3D_LOSS=True, WITH_VOLUMETRIC_CE_LOSS=True),
    dict(WITH_POSE2D_LOSS=False, WITH_POSE3D_LOSS=True, WITH_KCS_LOSS=True),
    dict(WITH_POSE2D_LOSS=True, WITH_POSE3D_LOSS=False, WITH_BONE_LOSS=True),
])
def test_loss_computer_3d(tiny_cfg, flags):
    """Every term, the total and the gradient of the predicted 3D pose."""
    jcfg, pcfg = lc_cfg(tiny_cfg, **flags)
    coords, probs, gt3, val = volumes(3, b=2)
    rng = np.random.default_rng(4)
    pred3 = (gt3 + rng.normal(size=gt3.shape) * 20).astype(np.float32)
    pred2 = rng.uniform(0, 16, size=(4, 21, 2)).astype(np.float32)
    gt2 = rng.uniform(0, 16, size=(4, 21, 2)).astype(np.float32)
    vis = (rng.uniform(size=(4, 21)) > 0.1).astype(np.float32)
    loss2d = ({} if not (flags.get("WITH_POSE2D_LOSS") or flags.get("WITH_BONE_LOSS")) else
              dict(pose2d_pred=pred2, pose2d_gt=gt2, visibility=vis))

    def jax_total(p3):
        kw = {k: jnp.asarray(v) for k, v in loss2d.items()}
        return JaxLC3(jcfg)(pose3d_pred=p3, pose3d_gt=jnp.asarray(gt3),
                            coord_volumes=jnp.asarray(coords), volumes_pred=jnp.asarray(probs),
                            validity=jnp.asarray(val), **kw)

    (jt, jd), jg = jax.value_and_grad(jax_total, has_aux=True)(jnp.asarray(pred3))
    p3 = torch.from_numpy(pred3).requires_grad_(True)
    pt, pd = LossComputer3D(pcfg)(pose3d_pred=p3, pose3d_gt=torch.from_numpy(gt3),
                                  coord_volumes=torch.from_numpy(coords),
                                  volumes_pred=torch.from_numpy(probs),
                                  validity=torch.from_numpy(val),
                                  **{k: torch.from_numpy(v) for k, v in loss2d.items()})
    assert set(pd) == set(jd)
    for key in jd:
        np.testing.assert_allclose(float(pd[key]), float(jd[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(pt), float(jt), rtol=1e-5)
    if flags.get("WITH_POSE3D_LOSS") or flags.get("WITH_KCS_LOSS"):
        (pg,) = torch.autograd.grad(pt, (p3,))
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(jg)).max())
