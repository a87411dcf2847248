"""The port's train-mode BN statistics levers (``models/layers.set_bn_levers``,
``StatBatchNorm``) against the JAX package's (tests/test_bn_levers.py on
the port): levers off bit for bit today's ``BatchNorm``; a subsample's
statistics; bf16 reductions; the Trainer arming them from the config; the
same BNs marked as in JAX.  The train-mode forward and the step with the
levers are in tests/test_torch_bn_levers_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from hrnet_hand_pose_estimation_tpu.models import layers as JL
from hrnet_hand_pose_estimation_tpu_torch.models import layers as L
from torch_train_parity import configs


torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset_levers():
    """The levers are process-wide in both packages, and xdist runs a whole
    file in one worker: every test leaves them off."""
    yield
    L.set_bn_levers()
    JL.set_bn_levers()
    assert not L.bn_levers_active() and not JL.bn_levers_active()


def port_bn(features, seed=0, cls=L.StatBatchNorm):
    gen = torch.Generator().manual_seed(seed)
    bn = cls(features, eps=L.BN_EPS, momentum=L.BN_MOMENTUM)
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.2 * torch.randn(features, generator=gen))
        bn.bias.copy_(0.1 * torch.randn(features, generator=gen))
        bn.running_mean.copy_(0.3 * torch.randn(features, generator=gen))
        bn.running_var.copy_(1.0 + torch.rand(features, generator=gen))
    return bn.train()


def jax_bn(bn, x_nhwc, **levers):
    """JAX's StatBatchNorm with ``bn``'s parameters and statistics on NHWC x:
    (y NHWC, {'mean', 'var'})."""
    mod = JL.StatBatchNorm(dtype=jnp.float32, **levers)
    v = {"params": {"scale": bn.weight.detach().numpy(), "bias": bn.bias.detach().numpy()},
         "batch_stats": {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}}
    y, mut = mod.apply(v, jnp.asarray(x_nhwc), mutable=["batch_stats"])
    return np.asarray(y), jax.tree.map(np.asarray, mut["batch_stats"])


def port_apply(bn, x_nhwc):
    y = bn(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return (y.detach().permute(0, 2, 3, 1).numpy(),
            {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()})


def test_levers_off_is_batchnorm_bit_for_bit():
    """Levers off: StatBatchNorm's train forward, gradient and running
    statistics are BatchNorm's bit for bit, and JAX's default (flax's
    BatchNorm) within its test's 1e-5."""
    x = np.random.default_rng(0).normal(1.5, 2.0, size=(8, 6, 6, 16)).astype(np.float32)
    stat, plain = port_bn(16), port_bn(16, cls=L.BatchNorm)
    outs = []
    for bn in (stat, plain):
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
        y = bn(xt)
        (y * y.detach().flip(0)).sum().backward()
        outs.append((y.detach(), xt.grad, bn.running_mean.clone(), bn.running_var.clone(),
                     bn.weight.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    y_ref, st_ref = jax_bn(port_bn(16), x)
    y_got, st_got = port_apply(port_bn(16), x)
    np.testing.assert_allclose(y_got, y_ref, atol=1e-5)
    np.testing.assert_allclose(st_got["mean"], st_ref["mean"], atol=1e-6)
    np.testing.assert_allclose(st_got["var"], st_ref["var"], atol=1e-5)


def test_subsample_uses_first_n():
    """stat_samples=2: statistics of x[:2] only, against JAX's StatBatchNorm
    (1e-6 on the statistics, 1e-6 relative on y) and the numpy formula."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(0.0, 1.0, size=(2, 4, 4, 8)),
                        rng.normal(50.0, 9.0, size=(6, 4, 4, 8))]).astype(np.float32)
    y_ref, st_ref = jax_bn(port_bn(8), x, stat_samples=2)
    L.set_bn_levers(stat_samples=2)
    bn = port_bn(8)
    mean0, var0 = bn.running_mean.clone().numpy(), bn.running_var.clone().numpy()
    y_got, st_got = port_apply(bn, x)
    for k in ("mean", "var"):
        np.testing.assert_allclose(st_got[k], st_ref[k], rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(y_got, y_ref, rtol=1e-6, atol=1e-6)
    head = x[:2].reshape(-1, 8).astype(np.float64)
    decay = 1.0 - L.BN_MOMENTUM
    np.testing.assert_allclose(st_got["mean"], decay * mean0 + (1 - decay) * head.mean(0),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st_got["var"], decay * var0 + (1 - decay) * head.var(0),
                               rtol=1e-3)


def test_bf16_statistics_close():
    """stat_dtype='bfloat16': within JAX's 0.05 of the float32 statistics'
    output, and of JAX's own bf16 StatBatchNorm."""
    x = np.random.default_rng(2).normal(0.5, 1.0, size=(16, 8, 8, 8)).astype(np.float32)
    y32, _ = port_apply(port_bn(8), x)
    y_ref, st_ref = jax_bn(port_bn(8), x, stat_dtype="bfloat16")
    L.set_bn_levers(stat_dtype="bfloat16")
    y16, st16 = port_apply(port_bn(8), x)
    assert np.abs(y16 - y32).max() < 0.05
    gap = float(np.abs(y16 - y_ref).max())
    print(f"bf16 statistics: port vs JAX max |dy| {gap:.3g}, vs float32 "
          f"{float(np.abs(y16 - y32).max()):.3g}")
    assert gap < 0.05
    for k in ("mean", "var"):
        np.testing.assert_allclose(st16[k], st_ref[k], atol=0.05, err_msg=k)
    with pytest.raises(ValueError, match="stat_dtype"):
        L.set_bn_levers(stat_dtype="float16")


def jax_bn_kinds(model, *args):
    """{class name: count} of the BNs a JAX model calls in a train-mode apply."""
    kinds = {}

    def count(next_fun, args_, kwargs, context):
        name = type(context.module).__name__
        if context.method_name == "__call__" and name in ("BatchNorm", "StatBatchNorm"):
            kinds[name] = kinds.get(name, 0) + 1
        return next_fun(*args_, **kwargs)

    v = jax.eval_shape(lambda: model.init(jax.random.key(0), *args, False))
    v = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), v)
    with fnn.intercept_methods(count):
        jax.eval_shape(lambda: model.apply(v, *args, True, mutable=["batch_stats"]))
    return kinds


def port_bn_kinds(model):
    kinds = {}
    for m in model.modules():
        if isinstance(m, L.BatchNorm):
            name = "StatBatchNorm" if isinstance(m, L.StatBatchNorm) else "BatchNorm"
            kinds[name] = kinds.get(name, 0) + 1
    return kinds


def test_the_same_bns_take_the_levers(tiny_cfg):
    """With a lever on, the JAX package builds StatBatchNorm for its ConvBN
    BNs (HRNet: stem, blocks, transitions, fuse layers, the train-mode head;
    SimpleBaseline: its ResNet blocks) and flax's BatchNorm for the rest
    (SimpleBaseline's stem and deconv BNs): the port marks as many of each.
    A plain BatchNorm keeps the full batch's statistics under the levers."""
    from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
    from hrnet_hand_pose_estimation_tpu.models.pose_resnet import PoseResNet as JaxPoseResNet
    from hrnet_hand_pose_estimation_tpu_torch.models import build_model
    from hrnet_hand_pose_estimation_tpu_torch.models.pose_resnet import PoseResNet
    from torch_train_parity import configs as cfgs

    JL.set_bn_levers(stat_samples=2)
    x = jnp.zeros((2, 64, 64, 3), jnp.float32)
    _, pcfg = cfgs(tiny_cfg)
    widths = dict(num_layers=18, num_joints=21, num_deconv_layers=3, deconv_filters=(16, 16, 16))
    for jax_model, port_model in ((jax_build_model(tiny_cfg), build_model(pcfg)),
                                  (JaxPoseResNet(**widths), PoseResNet(**widths))):
        want, got = jax_bn_kinds(jax_model, x), port_bn_kinds(port_model)
        print(type(port_model).__name__, "JAX", want, "port", got)
        assert got == want
    x = np.random.default_rng(4).normal(size=(4, 5, 5, 8)).astype(np.float32)
    want = port_apply(port_bn(8, cls=L.BatchNorm), x)
    L.set_bn_levers(stat_samples=2, stat_dtype="bfloat16")
    got = port_apply(port_bn(8, cls=L.BatchNorm), x)
    for a, b in zip((want[0], *want[1].values()), (got[0], *got[1].values())):
        assert np.array_equal(a, b)


def test_trainer_arms_the_config_levers(tiny_cfg, tmp_path):
    """TPU.BN_STAT_SAMPLES / BN_STAT_DTYPE reach the Trainer (JAX's
    test_trainer_applies_config_bn_levers): the levers are on after it is
    built and an epoch trains to finite losses."""
    from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer
    from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import DataLoader
    from hrnet_hand_pose_estimation_tpu_torch.data.synthetic import SyntheticDataset
    from hrnet_hand_pose_estimation_tpu_torch.models import build_model

    _, cfg = configs(tiny_cfg, OUTPUT_DIR=str(tmp_path), WORKERS=0, TPU__BN_STAT_SAMPLES=4,
                     TPU__BN_STAT_DTYPE="bfloat16", TRAIN__IMAGES_PER_GPU=8)
    loaders = {"s": DataLoader(SyntheticDataset(cfg, length=16), 8, num_workers=0)}
    trainer = Trainer(cfg, build_model(cfg), loaders, output_dir=str(tmp_path), device="cpu")
    assert L._BN_LEVERS == {"stat_samples": 4, "stat_dtype": "bfloat16"}
    avgs = trainer.train_epoch(1)
    assert trainer.train_global_steps == 2 and np.isfinite(avgs["total_loss"])
