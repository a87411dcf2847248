"""The port's Swin pose model (``models/swin.py``) against the JAX
package's: the window helpers and the shift mask, window attention, the
block with and without shift and with both FFNs, the whole model in float32
and bfloat16, the B4 decode of its logits, one train step, the unread
stages' zero gradients, the PATCH_SIZE 2 configs (ROADMAP C18) and the
bridge.

Tiny widths (embed 16, depths 2-2-2-2, heads 2) at 64x64 with patch 4
(16x16 maps, windows of 8, so stage 0's second block is shifted and stage
1's is not), B = 2; weights from ``tests/torch_zoo_parity.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from hrnet_hand_pose_estimation_tpu.models import swin as jax_swin
from hrnet_hand_pose_estimation_tpu.ops.decode import soft_argmax as jax_soft_argmax
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
from hrnet_hand_pose_estimation_tpu_torch.models import build_model, swin
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import (from_jax_train_state,
                                                                from_jax_variables,
                                                                init_variables)
from torch_train_parity import make_batch
from torch_zoo_parity import jax_variables, rel_gap, step_parity, sub_state, zoo_cfgs

torch.set_num_threads(1)
B = 2
WIDTHS = dict(num_joints=21, patch_size=4, embed_dim=16, depths=(2, 2, 2, 2),
              num_heads=(2, 2, 2, 2))
CFG = dict(MODEL__PATCH_SIZE=4, MODEL__EMB_DIM=[16], MODEL__DEPTHS=[2, 2, 2, 2],
           MODEL__NUM_HEADS=[2, 2, 2, 2], MODEL__FF_TYPE="mlp", MODEL__TRAINABLE_SOFTMAX=True)


def images(seed=1, b=B, size=64):
    return np.random.default_rng(seed).normal(size=(b, size, size, 3)).astype(np.float32)


def port_swin(variables, **kw):
    model = swin.SwinPose(**dict(WIDTHS, **kw), image_size=(64, 64)).eval()
    model.load_state_dict(from_jax_variables(variables, model))
    return model


@pytest.fixture(scope="module")
def shared():
    """(JAX SwinPose float32 with a trainable temperature, its variables
    (temperature 1.7), the port model with them, images)."""
    jm = jax_swin.SwinPose(**WIDTHS, trainable_softmax=True, dtype=jnp.float32)
    x = images()
    variables = jax_variables(jm, 0, x[:1], False)
    variables["params"]["trainable_temp"] = np.float32(1.7)
    return jm, variables, port_swin(variables, trainable_softmax=True), x


def test_window_helpers_and_mask_are_bit_equal():
    """``window_partition`` / ``window_reverse`` / ``relative_position_index``
    equal JAX's, and the shifted block's -100 mask equals the one JAX's
    block hands its attention (read through ``nn.intercept_methods``)."""
    x = np.random.default_rng(0).normal(size=(2, 16, 24, 5)).astype(np.float32)
    got = swin.window_partition(torch.from_numpy(x), 8)
    want = np.asarray(jax_swin.window_partition(jnp.asarray(x), 8))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(swin.window_reverse(got, 8, 16, 24).numpy(), x)
    np.testing.assert_array_equal(np.asarray(jax_swin.window_reverse(jnp.asarray(want), 8, 16, 24)),
                                  x)
    for ws in (2, 4, 7, 8):
        np.testing.assert_array_equal(swin.relative_position_index(ws),
                                      jax_swin.relative_position_index(ws))
    seen = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, jax_swin.WindowAttention):
            seen.append(args[1] if len(args) > 1 else kwargs.get("mask"))
        return next_fun(*args, **kwargs)

    block = jax_swin.SwinBlock(8, 2, 8, shift=4, dtype=jnp.float32)
    y = jnp.zeros((1, 24, 16, 8))
    with fnn.intercept_methods(interceptor):
        block.init(jax.random.key(0), y)
    mask = swin.shift_mask(24, 16, 8, 4).numpy()
    assert mask.shape == (6, 64, 64) and (mask == -100).any()
    np.testing.assert_array_equal(mask, np.asarray(seen[-1]))


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_jax(masked):
    """Float32 window attention with its position bias (and the shift mask):
    1e-4 of the largest output."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 16, 12)).astype(np.float32)
    mask = swin.shift_mask(8, 8, 4, 2).numpy() if masked else None
    jm = jax_swin.WindowAttention(12, 4, 3, dtype=jnp.float32)
    variables = jax_variables(jm, 5, x, mask)
    want = jm.apply(variables, x, mask)
    port = swin.WindowAttention(12, 4, 3)
    port.load_state_dict(sub_state(variables["params"], "swin"))
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    assert rel_gap(got, want) <= 1e-4


@pytest.mark.parametrize("shift,ff_type", [(0, "mlp"), (4, "mlp"), (0, "le_ff"), (4, "le_ff")])
def test_block_matches_jax(shift, ff_type):
    """One float32 block on a 16x16 map (windows of 8), with and without the
    shift, with the plain and the locality FFN: 1e-4 of the largest output."""
    x = np.random.default_rng(6).normal(size=(2, 16, 16, 16)).astype(np.float32)
    jm = jax_swin.SwinBlock(16, 2, 8, shift=shift, ff_type=ff_type, dtype=jnp.float32)
    variables = jax_variables(jm, 7, x)
    want = jm.apply(variables, x)
    port = swin.SwinBlock(16, 2, (16, 16), 8, shift, ff_type=ff_type)
    port.load_state_dict(sub_state(variables["params"], "swin"))
    assert (port.attn_mask is not None) == bool(shift)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert rel_gap(got, want) <= 1e-4


@pytest.mark.parametrize("softmax", [True, False])
def test_model_forward_matches_jax(shared, softmax):
    """The whole model in float32: probabilities within 1e-5, logits (the
    plain head) and the stage-0 features within 1e-4 of their largest
    value, the soft-argmax decode of the probabilities within 1e-4 px; the
    temperature JAX's."""
    jm, variables, model, x = shared
    if not softmax:
        jm = jm.clone(heatmap_softmax=False)
        variables = {"params": {k: v for k, v in variables["params"].items()
                                if k != "trainable_temp"}}
        model = port_swin(variables, heatmap_softmax=False)
    want = jax.jit(jm.apply, static_argnums=2)(variables, x, False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.heatmaps.shape == (B, 16, 16, 21) and got.heatmaps.dtype == torch.float32
    if softmax:
        np.testing.assert_allclose(got.heatmaps.numpy(), np.asarray(want.heatmaps), rtol=0,
                                   atol=1e-5)
        assert float(got.temperature.detach()) == float(want.temperature) == np.float32(1.7)
        np.testing.assert_allclose(got.heatmaps.sum(dim=(1, 2)).numpy(), 1.0, atol=1e-5)
    else:
        assert model.head == "plain" and got.temperature is None
        assert rel_gap(got.heatmaps, want.heatmaps) <= 1e-4
    assert rel_gap(got.features, want.features) <= 1e-4
    decoded = TS.decode_heatmaps(got.heatmaps, True).numpy()
    jax_decoded = np.asarray(jax_soft_argmax(want.heatmaps))
    if softmax:
        np.testing.assert_allclose(decoded, jax_decoded, rtol=0, atol=1e-4)
    else:       # weighted sums of raw logits, not coordinates: 1e-4 of the largest
        assert rel_gap(decoded, jax_decoded) <= 1e-4


def test_bf16_forward_tracks_jax(shared):
    """bfloat16 autocast against JAX's ``dtype=bf16``: the probabilities no
    farther from JAX's bf16 ones than twice JAX's bf16 probabilities are
    from its float32 ones, in max and in mean."""
    jm, variables, model, x = shared
    f32 = np.asarray(jax.jit(jm.apply, static_argnums=2)(variables, x, False).heatmaps)
    jbf = np.asarray(jax.jit(jm.clone(dtype=jnp.bfloat16).apply, static_argnums=2)(
        variables, x, False).heatmaps)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = model(torch.from_numpy(x)).heatmaps.numpy()
    d_port, d_wit = np.abs(got - jbf), np.abs(jbf - f32)
    assert d_wit.max() > 0
    assert d_port.max() <= 2 * d_wit.max() and d_port.mean() <= 2 * d_wit.mean()


def test_evaluator_decodes_the_logits_as_jax(tiny_cfg, shared):
    """``Evaluator2D`` takes the softmax head's logits (``forward_logits``)
    and decodes them with ``softmax_decode`` (B4's twin on the CPU): within
    1e-4 px of JAX's ``make_forward_fn`` decode."""
    from hrnet_hand_pose_estimation_tpu.parallel.train_step import make_forward_fn

    jm, variables, model, x = shared
    jcfg, pcfg = zoo_cfgs(tiny_cfg, "swin_transformer", **CFG)
    _, want = make_forward_fn(jcfg, jm)(variables, jnp.asarray(x))
    ev = Evaluator2D(pcfg, model, None, device="cpu")
    assert ev.decode_logits
    np.testing.assert_allclose(ev.forward(torch.from_numpy(x)).numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)


def test_train_step_matches_jax_and_unread_stages_stay_still(tiny_cfg, shared, monkeypatch):
    """One float32 adam step (the YAML's pose loss; the temperature
    trainable) against JAX's jitted step from the same variables: the
    losses at rtol 1e-5, the gradients within 1e-3 of max|g|.  The stages
    the head does not read (1-3 and the merges) get zero gradients on both
    sides."""
    jm, variables, _, x = shared
    jcfg, pcfg = zoo_cfgs(tiny_cfg, "swin_transformer", TRAIN__OPTIMIZER="adam",
                          TRAIN__LR=1e-3, LOSS__WITH_HEATMAP_LOSS=False, **CFG)
    gaps = step_parity(jcfg, pcfg, jm, variables, dict(make_batch(4), images=x), monkeypatch)
    assert all(g <= 1e-5 for g in gaps["loss"].values()), gaps["loss"]
    assert gaps["grad"][0] <= 1e-3, gaps["grad"]
    unread = [n for n in gaps["jax_grads"] if n.startswith(("stage1", "stage2", "stage3",
                                                              "merge"))]
    assert len(unread) == 3 * 2 * 13 + 3 * 3
    for name in unread:
        assert not gaps["jax_grads"][name].any() and not gaps["grads"][name].any(), name
    moving = [n for n in gaps["grads"] if n not in unread]
    assert all(gaps["grads"][n].any() for n in moving)


def test_patch_size_2_raises_c18(tiny_cfg):
    """PATCH_SIZE 2 gives maps twice HEATMAP_SIZE (the RHD_HRNet_Swin*
    configs): JAX's step fails in the heatmap loss, the port's step raises
    ValueError naming C18 before the loss."""
    jcfg, pcfg = zoo_cfgs(tiny_cfg, "swin_transformer", **dict(CFG, MODEL__PATCH_SIZE=2))
    batch = make_batch(4)
    from torch_train_parity import JaxTrainer

    with pytest.raises(TypeError, match="incompatible shapes"):
        trainer = JaxTrainer(jcfg, batch)
        jax.jit(trainer.step_fn)(trainer.state, trainer.batch)
    model = build_model(pcfg)
    state, tx = TS.create_train_state(pcfg, model, device="cpu")
    step = TS.make_train_step(pcfg, model, tx)
    with pytest.raises(ValueError, match="C18"):
        step(state, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert model(torch.zeros(1, 64, 64, 3)).heatmaps.shape == (1, 32, 32, 21)


def test_bridge_is_strict_and_carries_the_train_state(tiny_cfg, shared):
    """The strict bridge fills every key of the registry's model and
    refuses a stray leaf; a JAX adam ``TrainState`` (no BN) loads into the
    port's ``TrainState``; ``init_variables`` makes a full state; the
    module names are the flax paths."""
    import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts

    jm, variables, _, x = shared
    _, pcfg = zoo_cfgs(tiny_cfg, "swin_transformer", **CFG)
    model = build_model(pcfg)
    sd = from_jax_variables(variables, model)
    assert set(sd) == set(model.state_dict())
    assert "stage0_block1.attn.rel_pos_bias" in sd and "merge2.weight" in sd
    bad = {"params": dict(variables["params"], stray={"kernel": np.zeros((2, 2), np.float32)})}
    with pytest.raises(KeyError):
        from_jax_variables(bad, model)
    jcfg, _ = zoo_cfgs(tiny_cfg, "swin_transformer", TRAIN__OPTIMIZER="adam", **CFG)
    tx = jax_ts.make_optimizer(jcfg, 10)
    jstate = jax_ts.TrainState(step=jnp.asarray(3, jnp.int32), params=variables["params"],
                               batch_stats={}, opt_state=tx.init(variables["params"]))
    state, _ = TS.create_train_state(pcfg, model, device="cpu")
    assert state.stats.numel() == 0 and state.counts.numel() == 0
    state.load_state_dict(from_jax_train_state(jax.device_get(jstate), model))
    assert int(state.step) == 3
    build_model(pcfg).load_state_dict(init_variables(pcfg, 0))


def test_init_train_weights_are_flax_s(tiny_cfg):
    """``create_train_state`` gives the flax initial distributions: Dense and
    the convs lecun normal (truncated at 2 std), zero biases, LayerNorm 1
    and 0, the position biases truncated_normal(0.02)."""
    _, pcfg = zoo_cfgs(tiny_cfg, "swin_transformer", **CFG)
    model = build_model(pcfg)
    TS.create_train_state(pcfg, model, device="cpu")
    fc1 = model.stage0_block0.fc1.weight.detach()
    std = (1.0 / 16) ** 0.5
    assert 0.8 * std < float(fc1.std()) < 1.2 * std and float(fc1.abs().max()) <= 2 * std / 0.8796
    assert not model.stage0_block0.fc1.bias.any() and not model.final_conv.bias.any()
    assert (model.embed_norm.weight == 1).all() and not model.embed_norm.bias.any()
    rpb = model.stage0_block0.attn.rel_pos_bias
    assert float(rpb.abs().max()) <= 0.04 and rpb.std() > 0.01
    assert float(model.trainable_temp) == 1.0
