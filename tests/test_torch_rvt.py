"""The port's RVT pooling transformer (``models/transformers.py``) against
the JAX package's: flax ``MultiHeadDotProductAttention`` mapped onto four
Linears, the ViT block, the conv-head pooling, the whole model in float32
with autocast off inside it, its initial distributions, and ROADMAP C17.

A ResNet-18 backbone at 128x128 (4x4 features, 2x2 patches of 2, pooled to
1x1), two stages of dims 8 x 2 heads, one block each, B = 2; weights from
``tests/torch_zoo_parity.py`` with the BN running statistics of the images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu.core.evaluator import Evaluator2D as JaxEvaluator2D
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu.models import transformers as jax_tf
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer
from hrnet_hand_pose_estimation_tpu_torch.models import build_model, transformers
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables, init_variables
from torch_train_parity import make_batch
from torch_zoo_parity import batch_statistics, jax_variables, rel_gap, sub_state, zoo_cfgs

torch.set_num_threads(1)
B = 2
CFG = dict(MODEL__IMAGE_SIZE=[128, 128], MODEL__HEATMAP_SIZE=[32, 32], MODEL__PATCH_SIZE=2,
           MODEL__EMB_DIM=[8, 8], MODEL__DEPTHS=[1, 1, 6], MODEL__NUM_HEADS=[2, 2, 9],
           MODEL__BACKBONE_NAME="resnet18")


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def shared(tiny_cfg):
    """(JAX cfg, port cfg, JAX model, variables, the port model with them, images)."""
    jcfg, pcfg = zoo_cfgs(tiny_cfg, "my_pose_transformer", **CFG)
    jm = jax_build_model(jcfg)
    x = np.random.default_rng(1).normal(size=(B, 128, 128, 3)).astype(np.float32)
    variables = batch_statistics(jm, jax_variables(jm, 0, x[:1], False), x)
    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(variables, model))
    return jcfg, pcfg, jm, variables, model, x


def test_attention_mapping_matches_flax():
    """flax ``MultiHeadDotProductAttention`` (query/key/value (in, heads,
    head_dim) kernels with (heads, head_dim) biases, out (heads, head_dim,
    out)) against ``MultiHead``'s Linears with the bridge's reshapes, float32:
    1e-5 of the largest output."""
    x = np.random.default_rng(2).normal(size=(2, 7, 12)).astype(np.float32)
    jm = fnn.MultiHeadDotProductAttention(num_heads=3, dtype=jnp.float32)
    variables = jax_variables(jm, 3, x, x)
    want = jm.apply(variables, x, x)
    port = transformers.MultiHead(12, 3)
    port.load_state_dict(sub_state(variables["params"], "rvt"))
    with torch.no_grad():
        got = port(t(x))
    assert rel_gap(got, want) <= 1e-5


def test_vit_block_and_pooling_match_jax():
    """A ViT block (pre-norm, eps 1e-6, tanh GELU) and the conv-head
    pooling (depthwise 3x3 stride 2, dense tokens), float32: 1e-4 of the
    largest output."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    jb = jax_tf.ViTBlock(16, 2)
    variables = jax_variables(jb, 5, x)
    port = transformers.ViTBlock(16, 2)
    port.load_state_dict(sub_state(variables["params"], "rvt"))
    with torch.no_grad():
        assert rel_gap(port(t(x)), jb.apply(variables, x)) <= 1e-4
    patches = rng.normal(size=(2, 25, 16)).astype(np.float32)
    tokens = rng.normal(size=(2, 3, 16)).astype(np.float32)
    jp = jax_tf.ConvHeadPooling(32)
    variables = jax_variables(jp, 6, patches, tokens, (5, 5))
    seq, tok, hw = jp.apply(variables, patches, tokens, (5, 5))
    port = transformers.ConvHeadPooling(16, 32)
    port.load_state_dict(sub_state(variables["params"], "rvt"))
    with torch.no_grad():
        pseq, ptok, phw = port(t(patches), t(tokens), (5, 5))
    assert phw == tuple(hw) == (3, 3)
    assert rel_gap(pseq, seq) <= 1e-4 and rel_gap(ptok, tok) <= 1e-4


def test_model_matches_jax_in_float32_whatever_the_autocast(shared, pcfg_model64):
    """The whole model: (B, K, 2) poses in heatmap coordinates.  Through the
    sigmoid (x 32) a float32 run is ~2e-4 px from float64 on either side
    (JAX's jitted and eager float32 runs part by 5.5e-5 px), so the 1e-4 px
    limit is held in float64 on both sides (JAX's LayerNorms compute in
    float32 even then); in float32 the port stays within twice JAX's own
    float32 distance from float64.  Under a bfloat16 autocast the port's
    output is its float32 output, bit for bit (the JAX registry passes no
    dtype: the model is float32)."""
    _, _, jm, variables, model, x = shared
    want = np.asarray(jax.jit(jm.apply, static_argnums=2)(variables, x, False))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        want64 = np.asarray(jax.jit(jm.clone(dtype=jnp.float64).apply, static_argnums=2)(
            v64, jnp.asarray(x, jnp.float64), False))
    with torch.no_grad():
        got = model(t(x))
        with torch.autocast("cpu", dtype=torch.bfloat16):
            low = model(t(x))
        got64 = pcfg_model64(torch.from_numpy(x).double()).numpy()
    assert got.shape == (B, 21, 2) and got.dtype == torch.float32
    assert 0 < want.min() and want.max() < 32 and want.std() > 0.1
    np.testing.assert_allclose(got64, want64, rtol=0, atol=1e-4)
    gap, witness = np.abs(got.numpy() - want).max(), np.abs(want - want64).max()
    print(f"float32: port vs JAX {gap:.3g} px, JAX vs its float64 {witness:.3g} px")
    assert np.abs(got.numpy() - want64).max() <= 2 * witness
    assert torch.equal(low, got)


@pytest.fixture
def pcfg_model64(shared):
    _, pcfg, _, variables, _, _ = shared
    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(variables, model))
    return model.double()


def test_steps_raise_c17_where_jax_fails(shared):
    """JAX's train step, eval step, forward function and Evaluator2D read
    ``.heatmaps`` of the model's bare array and fail; the port's raise
    NotImplementedError naming C17, and so does ``Trainer``."""
    jcfg, pcfg, jm, variables, model, x = shared
    batch = {k: jnp.asarray(v) for k, v in make_batch(4).items()}
    batch["images"] = jnp.asarray(x)
    tx = jax_ts.make_optimizer(jcfg, 1000)
    state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
    for run in (lambda: jax_ts.make_train_step(jcfg, jm, tx)(state, batch),
                lambda: jax_ts.make_eval_step(jcfg, jm)(state, batch),
                lambda: jax_ts.make_forward_fn(jcfg, jm)(variables, batch["images"]),
                lambda: JaxEvaluator2D(jcfg, jm, variables).forward(variables, batch["images"])):
        with pytest.raises(AttributeError, match="heatmaps"):
            run()
    port = build_model(pcfg)
    pstate, ptx = TS.create_train_state(pcfg, port, device="cpu")
    for make in (lambda: TS.make_train_step(pcfg, port, ptx),
                 lambda: TS.make_eval_step(pcfg, port), lambda: TS.make_forward_fn(pcfg, port),
                 lambda: Evaluator2D(pcfg, port, None, device="cpu"),
                 lambda: Trainer(pcfg, port, {}, device="cpu")):
        with pytest.raises(NotImplementedError, match="C17"):
            make()


def test_init_weights_and_bridge(shared):
    """``create_train_state`` gives flax's distributions (keypoint tokens
    uniform in [0, 1), LayerNorm 1 and 0, Dense and convs lecun normal,
    the ResNet's ConvBN convs normal(0.001)); the strict bridge fills every
    key; ``init_variables`` makes a full state of the registry's model."""
    _, pcfg, _, variables, model, _ = shared
    fresh = build_model(pcfg)
    TS.create_train_state(pcfg, fresh, device="cpu")
    with torch.no_grad():
        tokens = fresh.keypoint_tokens
        assert 0 <= float(tokens.min()) and float(tokens.max()) < 1 and tokens.std() > 0.2
        assert (fresh.norm.weight == 1).all() and not fresh.norm.bias.any()
        q = fresh.stage0_block0.attn.query.weight
        assert 0.8 * 16 ** -0.5 < float(q.std()) < 1.2 * 16 ** -0.5
        assert float(fresh.backbone.layer1[0].conv1.weight.std()) < 0.002
        assert 0.8 * 147 ** -0.5 < float(fresh.backbone.conv1.weight.std()) < 1.2 * 147 ** -0.5
    assert set(from_jax_variables(variables, model)) == set(model.state_dict())
    assert fresh.patch == 2 and tuple(fresh.patch_embed.weight.shape) == (16, 512, 2, 2)
    build_model(pcfg).load_state_dict(init_variables(pcfg, 0))
