"""The port's 2D losses, loss computer, legend tables and train-mode
BatchNorm against the JAX package's (and flax's), values and gradients."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.core import losses as JL
from hrnet_hand_pose_estimation_tpu.core.loss_computer import LossComputer2D as JaxLoss
from hrnet_hand_pose_estimation_tpu.data import legends as jax_legends
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core import losses as PL
from hrnet_hand_pose_estimation_tpu_torch.core.loss_computer import LossComputer2D
from hrnet_hand_pose_estimation_tpu_torch.data import legends
from hrnet_hand_pose_estimation_tpu_torch.models.layers import BatchNorm

torch.set_num_threads(1)


def both(jax_fn, port_fn, *arrays, grad_args=(0,)):
    """(JAX value, port value, JAX grads, port grads) of a scalar loss."""
    jargs = [None if a is None else jnp.asarray(a) for a in arrays]
    jv, jg = jax.value_and_grad(lambda *xs: jax_fn(*xs), argnums=grad_args)(*jargs)
    targs = [None if a is None else torch.tensor(a, requires_grad=i in grad_args)
             for i, a in enumerate(arrays)]
    pv = port_fn(*targs)
    pv.backward()
    return float(jv), pv.item(), [np.asarray(g) for g in jg], [targs[i].grad.numpy()
                                                               for i in grad_args]


def check(jax_fn, port_fn, *arrays, grad_args=(0,)):
    jv, pv, jg, pg = both(jax_fn, port_fn, *arrays, grad_args=grad_args)
    np.testing.assert_allclose(pv, jv, rtol=1e-5)
    for a, b in zip(pg, jg):
        # NaN where both take a power's derivative at 0 (the smooth loss's
        # masked joints): the same on both sides
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7 * np.nanmax(np.abs(b)))


def poses(rng, b=3, d=2, spread=8.0):
    """Hand-like poses: fingers from a wrist, plus noise."""
    base = np.zeros((21, d), np.float32)
    for f in range(5):
        direction = np.zeros(d, np.float32)
        direction[0], direction[1] = np.sin(-0.6 + 0.3 * f), -np.cos(-0.6 + 0.3 * f)
        for j in range(4):
            base[1 + 4 * f + j] = direction * (j + 1) * spread / 4
    return (base[None] + rng.normal(size=(b, 21, d)) * 0.7 + 20).astype(np.float32)


@pytest.mark.parametrize("mode", ["l2", "l1"])
def test_heatmap_loss(mode):
    rng = np.random.default_rng(201)
    pred = rng.uniform(size=(2, 8, 8, 21)).astype(np.float32)
    gt = rng.uniform(size=(2, 8, 8, 21)).astype(np.float32)
    check(lambda p, g: JL.heatmap_loss(p, g, mode), lambda p, g: PL.heatmap_loss(p, g, mode),
          pred, gt)


@pytest.mark.parametrize("name", ["joints_mse_loss", "joints_mse_smooth_loss",
                                  "joints_mae_loss"])
@pytest.mark.parametrize("with_vis", [False, True])
def test_joint_losses(name, with_vis):
    rng = np.random.default_rng(202)
    pred = poses(rng) + rng.normal(size=(3, 21, 2)).astype(np.float32) * 30
    gt = poses(rng)
    vis = (rng.uniform(size=(3, 21)) > 0.3).astype(np.float32) if with_vis else None
    check(getattr(JL, name), getattr(PL, name), pred, gt, vis)


def test_mae_loss_with_per_coordinate_visibility():
    rng = np.random.default_rng(203)
    pred, gt = poses(rng), poses(rng)
    vis = (rng.uniform(size=(3, 21, 2)) > 0.3).astype(np.float32)
    check(JL.joints_mae_loss, PL.joints_mae_loss, pred, gt, vis)


@pytest.mark.parametrize("topk", [1, 8])
@pytest.mark.parametrize("weight_shape", [None, (2, 21), (2, 21, 1)])
def test_ohkm_loss(topk, weight_shape):
    rng = np.random.default_rng(204)
    out = rng.uniform(size=(2, 8, 8, 21)).astype(np.float32)
    target = rng.uniform(size=(2, 8, 8, 21)).astype(np.float32)
    tw = None if weight_shape is None else rng.uniform(size=weight_shape).astype(np.float32)
    check(lambda o, t, w: JL.joints_ohkm_mse_loss(o, t, w, topk),
          lambda o, t, w: PL.joints_ohkm_mse_loss(o, t, w, topk), out, target, tw)


def test_bone_loss_through_scale_pose():
    rng = np.random.default_rng(205)
    pred, gt = poses(rng), poses(rng)
    check(lambda p, g: JL.bone_length_loss(JL.scale_pose(p), JL.scale_pose(g)),
          lambda p, g: PL.bone_length_loss(PL.scale_pose(p), PL.scale_pose(g)), pred, gt,
          grad_args=(0, 1))


@pytest.mark.parametrize("d", [2, 3])
def test_joint_angle_loss_through_scale_pose(d):
    rng = np.random.default_rng(206)
    # bent fingers, so that both the rotation and coplanarity terms bite
    pred = poses(rng, d=d) + rng.normal(size=(3, 21, d)).astype(np.float32) * 2.0
    check(lambda p: JL.joint_angle_loss(JL.scale_pose(p)),
          lambda p: PL.joint_angle_loss(PL.scale_pose(p)), pred)
    jv, _, _, _ = both(lambda p: JL.joint_angle_loss(JL.scale_pose(p)),
                       lambda p: PL.joint_angle_loss(PL.scale_pose(p)), pred)
    assert jv != 0.0


def test_loss_computer_with_every_2d_term(tiny_cfg):
    rng = np.random.default_rng(207)
    cfg = tiny_cfg.clone()
    cfg.defrost()
    cfg.merge_from_list(["LOSS.WITH_BONE_LOSS", True, "LOSS.WITH_JOINTANGLE_LOSS", True,
                         "LOSS.HEATMAP_LOSS_FACTOR", 0.5, "LOSS.POSE2D_LOSS_FACTOR", 0.1,
                         "LOSS.BONE_LOSS_FACTOR", 2.0, "LOSS.JOINTANGLE_LOSS_FACTOR", 0.3])
    cfg.freeze()
    hm = rng.uniform(size=(3, 16, 16, 21)).astype(np.float32)
    hm_gt = rng.uniform(size=(3, 16, 16, 21)).astype(np.float32)
    pred = poses(rng) + rng.normal(size=(3, 21, 2)).astype(np.float32)
    gt = poses(rng)
    vis = (rng.uniform(size=(3, 21)) > 0.2).astype(np.float32)
    for ohkm in (False, True):
        c = cfg.clone()
        c.defrost()
        c.LOSS.USE_OHKM = ohkm
        c.freeze()
        jl = JaxLoss(c)
        _, jd = jl(heatmaps_pred=jnp.asarray(hm), heatmaps_gt=jnp.asarray(hm_gt),
                   pose2d_pred=jnp.asarray(pred), pose2d_gt=jnp.asarray(gt),
                   visibility=jnp.asarray(vis))
        jgrad = jax.grad(lambda h, p: jl(heatmaps_pred=h, heatmaps_gt=jnp.asarray(hm_gt),
                                         pose2d_pred=p, pose2d_gt=jnp.asarray(gt),
                                         visibility=jnp.asarray(vis))[0],
                         argnums=(0, 1))(jnp.asarray(hm), jnp.asarray(pred))
        th, tp = torch.tensor(hm, requires_grad=True), torch.tensor(pred, requires_grad=True)
        total, pd = LossComputer2D(config_from_dict(c.to_dict()))(
            th, torch.from_numpy(hm_gt), tp, torch.from_numpy(gt), torch.from_numpy(vis))
        total.backward()
        assert set(pd) == set(jd) == {"heatmap_loss", "pose2d_loss", "bone_loss",
                                      "jointangle_loss", "total_loss"}
        for key, v in jd.items():
            np.testing.assert_allclose(pd[key].item(), float(v), rtol=1e-5, err_msg=key)
        for got, want in zip((th.grad, tp.grad), jgrad):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-7 * np.abs(want).max())


def test_legend_tables_equal_jax():
    np.testing.assert_array_equal(legends.KC_MATRIX, jax_legends.KC_MATRIX)
    np.testing.assert_array_equal(legends.BONE_PARENTS_REF, jax_legends.BONE_PARENTS_REF)


@pytest.mark.parametrize("shape", [(2, 3, 3, 4), (2, 2, 2, 8), (4, 8, 8, 5)])
def test_train_batchnorm_matches_flax(shape):
    """One train-mode forward: output, running mean and running variance
    (flax updates it with the biased batch variance) at atol 1e-6.  A
    plain ``nn.BatchNorm2d`` updates it with the unbiased one and differs."""
    rng = np.random.default_rng(208)
    x = rng.normal(0.3, 1.2, size=shape).astype(np.float32)      # NHWC
    c = shape[-1]
    scale = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    mean0 = rng.normal(size=c).astype(np.float32) * 0.1
    var0 = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.float32)
    y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                       "batch_stats": {"mean": mean0, "var": var0}}, jnp.asarray(x),
                      mutable=["batch_stats"])
    port = BatchNorm(c, eps=1e-5, momentum=0.1).train()
    plain = torch.nn.BatchNorm2d(c, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        for m in (port, plain):
            m.weight.copy_(torch.from_numpy(scale))
            m.bias.copy_(torch.from_numpy(bias))
            m.running_mean.copy_(torch.from_numpy(mean0))
            m.running_var.copy_(torch.from_numpy(var0))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        out = port(xt).permute(0, 2, 3, 1).numpy()
        plain(xt)
    # native_batch_norm sums the variance otherwise than flax's E[x^2] -
    # E[x]^2: outputs up to ~4 differ by a few ulps, hence the rtol
    np.testing.assert_allclose(out, np.asarray(y), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               atol=1e-6)
    assert int(port.num_batches_tracked) == 1
    n = shape[0] * shape[1] * shape[2]
    # the unbiased update is off by 0.1 * var / (N - 1)
    gap = np.abs(plain.running_var.numpy() - np.asarray(upd["batch_stats"]["var"])).max()
    assert gap > 0.05 / (n - 1), gap
    np.testing.assert_allclose(
        plain.running_var.numpy() - var0 * 0.9,
        (np.asarray(upd["batch_stats"]["var"]) - var0 * 0.9) * n / (n - 1), rtol=1e-4)
    # eval mode is nn.BatchNorm2d's: the running statistics, nothing updated
    port.eval()
    with torch.no_grad():
        before = port.running_var.clone()
        want = torch.nn.functional.batch_norm(xt, port.running_mean, port.running_var,
                                              port.weight, port.bias, False, 0.1, 1e-5)
        assert torch.equal(port(xt), want)
    assert torch.equal(before, port.running_var)
