"""The port's int8 serving slice (core/quant_infer.make_quant_infer with
prepare_serving_qparams and raw uint8 input) against the JAX package's.

Both sides get the same uint8 images and the same calibration record and
build their own qparams; the JAX side runs its Pallas kernels in interpret
mode with the XLA layer1 of ``pallas_layer1=False``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.core import quant_infer as JQ
from hrnet_hand_pose_estimation_tpu.models.hrnet import hrnet_from_cfg as jax_hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core import quant_infer as Q
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import precast_variables
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.conv_int8 import conv_int8
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.int8_chain import (
    fused_bottleneck_chain_int8)
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from tests.test_quant_infer import _activated_variables

torch.set_num_threads(1)
NORM = (JQ.IMAGENET_MEAN, JQ.IMAGENET_STD)


def normalized(u8):
    mean, std = (np.asarray(v, np.float32) for v in NORM)
    return (u8.astype(np.float32) / 255.0 - mean) / std


# The bf16 layer1 case (layer1_chain=False) gets milder weights: there the
# port runs its bf16 chain kernel, which rounds each conv once with its
# bias (as the TPU kernel does), while the JAX path that runs on the CPU
# rounds the conv and then the bias; on the gain-1.4 weights, which are
# chaotic in bf16, that moves the decode 11 px (5 px against the TPU
# kernel in interpret mode), at gain 1.0 0.11 px.  Every other case runs
# the same arithmetic on both sides and holds at gain 1.4.
CASES = {
    "default": (dict(), dict()),
    "int8_head": (dict(int8_head=True), dict()),
    "layer1_chain_off": (dict(layer1_chain=False), dict(gain=0.7, temp=8.0)),
    "wide_int8_layer1": (dict(scope="wide", layer1_chain=False), dict()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_slice_matches_jax_quant_infer(tiny_cfg, case):
    kwargs, recipe = CASES[case]
    rng = np.random.default_rng(0)
    model = jax_hrnet_from_cfg(tiny_cfg, head="softmax")
    x = jnp.asarray(rng.normal(size=(4, 64, 64, 3)).astype(np.float32))
    v = jax.tree.map(np.asarray, _activated_variables(model, x, rng, **recipe))
    u8 = np.random.default_rng(7).integers(0, 256, size=(4, 64, 64, 3)).astype(np.uint8)
    amax = JQ.calibrate(tiny_cfg, v, [normalized(u8)])

    qparams = JQ.prepare_serving_qparams(tiny_cfg, v, amax, **kwargs)
    want = np.asarray(JQ.make_quant_infer(tiny_cfg, interpret=True, pallas_layer1=False,
                                          input_norm=NORM)(v, qparams, jnp.asarray(u8)))

    cfg = config_from_dict(tiny_cfg.to_dict())
    state = from_jax_variables(v)
    weights = precast_variables(cfg, state, device="cpu")
    qp = Q.prepare_serving_qparams(cfg, state, amax, **kwargs)
    assert sorted(qp) == sorted(qparams)
    before = (conv_int8.launches, fused_bottleneck_chain_int8.launches)
    got = Q.make_quant_infer(cfg, device="cpu", input_norm=NORM)(weights, qp,
                                                                 torch.from_numpy(u8))
    assert (conv_int8.launches, fused_bottleneck_chain_int8.launches) == before
    assert got.shape == (4, 21, 2) and got.dtype == torch.float32
    assert want.std() > 0.2
    np.testing.assert_allclose(got.numpy(), want, atol=0.05)


def test_entry_checks_and_f32_trunk(tiny_cfg):
    from hrnet_hand_pose_estimation_tpu_torch.utils.weights import init_variables

    cfg = config_from_dict(tiny_cfg.to_dict())
    state = init_variables(cfg, seed=1)
    weights = precast_variables(cfg, state, device="cpu")
    u8 = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, size=(2, 64, 64, 3)).astype(np.uint8))
    amax = Q.calibrate(cfg, weights, [torch.from_numpy(normalized(u8.numpy()))])
    qp = Q.prepare_serving_qparams(cfg, state, amax)
    assert len(qp) == len(Q.quant_sites(cfg, "exchange", stem2=True)) + 1
    quant = Q.make_quant_infer(cfg, device="cpu", input_norm=NORM)(weights, qp, u8)
    f32 = Q.make_quant_infer(cfg, device="cpu", trunk="f32", input_norm=NORM)(weights, qp, u8)
    assert torch.isfinite(quant).all() and torch.isfinite(f32).all()
    with pytest.raises(ValueError, match="uint8"):
        Q.make_quant_infer(cfg, device="cpu", input_norm=NORM)(weights, qp, u8.float())
    with pytest.raises(ValueError, match="images must be"):
        Q.make_quant_infer(cfg, device="cpu")(weights, qp, torch.zeros(2, 32, 32, 3))
    with pytest.raises(ValueError, match="trunk"):
        Q.make_quant_infer(cfg, device="cpu", trunk="int4")


@pytest.mark.slow
def test_int8_decode_gate_trained(tiny_cfg):
    """tests/test_quant_infer.py::test_int8_trunk_decode_gate_trained on the
    port: train the tiny model in JAX exactly as that test does, carry the
    weights across, and hold the port's int8 serving paths within 0.1 px
    of the port's unquantized walk (trunk='f32') on train and held-out
    batches.  Random nets are chaotic in bf16; trained ones are not."""
    import optax

    from hrnet_hand_pose_estimation_tpu.data.pipeline import default_collate
    from hrnet_hand_pose_estimation_tpu.data.synthetic import SyntheticDataset
    from hrnet_hand_pose_estimation_tpu.models import build_model
    from hrnet_hand_pose_estimation_tpu.parallel.train_step import TrainState, make_train_step

    jcfg = tiny_cfg.clone()
    jcfg.LOSS.WITH_POSE2D_LOSS = True
    jcfg = jcfg.freeze()
    model = build_model(jcfg)
    ds = SyntheticDataset(length=16, img_size=64, hm_size=16)
    batch_np = default_collate([ds[i] for i in range(16)])
    batch = {
        "images": jnp.asarray(batch_np["imgs"]),
        "target_heatmaps": jnp.asarray(batch_np["heatmaps"]),
        "pose2d": jnp.asarray(batch_np["pose2d"]),
        "visibility": jnp.ones((16, 21), jnp.float32),
    }
    variables = jax.jit(model.init, static_argnums=(2,))(
        jax.random.key(0), batch["images"][:1], False)
    tx = optax.adam(1.5e-3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    step = make_train_step(jcfg, model, tx)
    for _ in range(400):
        state, _ = step(state, batch)
    trained = jax.tree.map(np.asarray, {"params": state.params,
                                        "batch_stats": state.batch_stats})

    cfg = config_from_dict(tiny_cfg.to_dict())
    port_state = from_jax_variables(trained)
    weights = precast_variables(cfg, port_state, device="cpu")
    x_train = torch.from_numpy(np.asarray(batch_np["imgs"]))
    ds_held = SyntheticDataset(length=8, img_size=64, hm_size=16, seed=1)
    x_held = torch.from_numpy(np.asarray(default_collate([ds_held[i] for i in range(8)])["imgs"]))

    ref_fn = Q.make_quant_infer(cfg, device="cpu", trunk="f32")
    q_fn = Q.make_quant_infer(cfg, device="cpu")
    err = (ref_fn(weights, {}, x_train).numpy() - np.asarray(batch_np["pose2d"])).__abs__().mean()
    assert err < 1.5, f"did not train to localise: mean decode err {err:.2f} px"

    amax = Q.calibrate(cfg, weights, [x_train])
    configs = {
        "branch": Q.prepare_quant_params(cfg, port_state, amax),
        "shipped": Q.prepare_serving_qparams(cfg, port_state, amax),
        "shipped_int8_head": Q.prepare_serving_qparams(cfg, port_state, amax, int8_head=True),
        "wide_int8_layer1": Q.prepare_serving_qparams(cfg, port_state, amax, scope="wide",
                                                      layer1_chain=False),
    }
    for x in (x_train, x_held):
        ref = ref_fn(weights, {}, x)
        for name, qparams in configs.items():
            shift = (q_fn(weights, qparams, x) - ref).abs().max().item()
            assert shift < 0.1, f"{name}: int8 decode shift {shift:.4f} px >= 0.1 px"
    assert ref_fn(weights, {}, x_train).std(dim=0).max().item() > 0.5
