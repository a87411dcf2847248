"""The port's first version of the fused head (ops/kernels/fused_head_decode.py:
fused_head_decode, head_decode_v1_reference; ops/upsample.kron_interp)
against the JAX package's ``ops/pallas/fused_head_decode.fused_head_decode``.

On the CPU the wrapper runs its plain PyTorch twin; the JAX side runs its
Pallas kernel in interpret mode, as tests/test_pallas_kernels.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.models.hrnet import hrnet_from_cfg as jax_hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu.ops.decode import soft_argmax, spatial_softmax
from hrnet_hand_pose_estimation_tpu.ops.pallas import fused_head_decode as jax_fh
from hrnet_hand_pose_estimation_tpu.ops.upsample import upsample_bilinear_align_corners
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_head_decode import (
    HeadParams, fused_head_decode, head_decode_v1_reference, prepare_head_params)
from hrnet_hand_pose_estimation_tpu_torch.ops.upsample import kron_interp
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

JAX_SHAPES = [(16, 8), (8, 16), (4, 32), (2, 64)]     # tests/test_pallas_kernels.py
W32_SHAPES = [(16, 32), (8, 64), (4, 128), (2, 256)]  # w32 widths on a 64x64 image


def branches(rng, shapes, batch=2):
    return [rng.normal(size=(batch, s, s, c)).astype(np.float32) for s, c in shapes]


def port_v1(xs, params: HeadParams):
    before = fused_head_decode.launches
    xt = [torch.from_numpy(x) for x in xs]
    got = fused_head_decode(xt, params)
    assert fused_head_decode.launches == before           # the CPU runs the twin
    assert torch.equal(got, head_decode_v1_reference(xt, params))
    return got.numpy()


def test_v1_matches_pallas_v1_and_the_f32_head():
    rng = np.random.default_rng(0)
    xs = branches(rng, JAX_SHAPES)
    p = dict(w_head=rng.normal(size=(120, 120)) * 0.1, b_head=rng.normal(size=(120,)) * 0.1,
             w_final=rng.normal(size=(120, 21)) * 0.1, b_final=rng.normal(size=(21,)) * 0.1,
             temp=np.float32(1.3))
    p = {k: np.asarray(a, np.float32) for k, a in p.items()}
    jp = jax_fh.HeadParams(**{k: jnp.asarray(a) for k, a in p.items()})
    want = np.asarray(jax_fh.fused_head_decode([jnp.asarray(x) for x in xs], jp, interpret=True))
    got = port_v1(xs, HeadParams(**{k: torch.from_numpy(a) for k, a in p.items()}))
    assert got.shape == (2, 21, 2) and want.std() > 0.5
    np.testing.assert_allclose(got, want, atol=0.01)

    # the f32 upsample + einsum head of tests/test_pallas_kernels.py
    feats = [jnp.asarray(xs[0])] + [upsample_bilinear_align_corners(jnp.asarray(t), (16, 16))
                                    for t in xs[1:]]
    y = jax.nn.relu(jnp.einsum("bhwc,cd->bhwd", jnp.concatenate(feats, -1), jp.w_head)
                    + jp.b_head)
    logits = jnp.einsum("bhwd,dk->bhwk", y, jp.w_final) + jp.b_final
    ref = np.asarray(soft_argmax(spatial_softmax(logits, 1.3)))
    np.testing.assert_allclose(got, ref, atol=0.05)


def w32_like_variables(tiny_cfg, head: str, seed: int):
    """A seeded tiny-depth model at the w32 widths (480-wide head), with
    its head weights, BN statistics and temperature drawn from numpy at
    scales that spread the decoded coordinates (the init's are near 0)."""
    cfg = tiny_cfg.clone()
    cfg.defrost()
    for n in (2, 3, 4):
        cfg.MODEL.EXTRA[f"STAGE{n}"]["NUM_CHANNELS"] = [32, 64, 128, 256][:n]
    model = jax_hrnet_from_cfg(cfg, head=head)
    v = model.init(jax.random.key(seed), jnp.zeros((1, 64, 64, 3)), False)
    v = jax.tree.map(np.array, v)
    rng = np.random.default_rng(seed)
    for name, scale in (("head_cb", 0.05), ("final_conv", 0.2)):
        leaf = v["params"][name]["conv"] if name == "head_cb" else v["params"][name]
        leaf["kernel"] = (rng.normal(size=leaf["kernel"].shape) * scale).astype(np.float32)
        leaf["bias"] = (rng.normal(size=leaf["bias"].shape) * 0.1).astype(np.float32)
    st = v["batch_stats"]["head_cb"]["bn"]
    st["mean"] = (rng.normal(size=st["mean"].shape) * 0.1).astype(np.float32)
    st["var"] = rng.uniform(0.5, 2.0, size=st["var"].shape).astype(np.float32)
    if head != "plain":
        v["params"]["trainable_temp"] = np.asarray(1.5, np.float32)
    return v


@pytest.mark.parametrize("head", ["softmax", "plain"])
def test_v1_on_w32_widths_matches_jax(tiny_cfg, head):
    v = w32_like_variables(tiny_cfg, head, seed=4)
    jp = jax_fh.prepare_head_params(v)
    params = prepare_head_params(from_jax_variables(v))
    assert params.w_head.shape == (480, 480) and float(params.temp) == float(jp.temp)
    assert float(params.temp) == (1.0 if head == "plain" else 1.5)
    rng = np.random.default_rng(5)
    xs = [np.abs(x) for x in branches(rng, W32_SHAPES)]
    want = np.asarray(jax_fh.fused_head_decode([jnp.asarray(x) for x in xs], jp, interpret=True))
    got = port_v1(xs, params)
    assert got.shape == (2, 21, 2) and want.std() > 0.5
    np.testing.assert_allclose(got, want, atol=0.01)


@pytest.mark.parametrize("src,dst", [(2, 16), (4, 16), (8, 64), (32, 64)])
def test_kron_interp_bit_equal_to_jax(src, dst):
    got, want = kron_interp(src, dst), jax_fh._kron_interp(src, dst)
    assert got.dtype == want.dtype == np.float32 and got.shape == (src * src, dst * dst)
    np.testing.assert_array_equal(got, want)
    assert not got.flags.writeable


def test_v1_refuses_what_the_tpu_kernel_cannot_take():
    rng = np.random.default_rng(6)
    xs = [torch.from_numpy(x) for x in branches(rng, JAX_SHAPES)]
    params = HeadParams(torch.zeros(120, 120), torch.zeros(120), torch.zeros(120, 21),
                        torch.zeros(21), torch.tensor(1.0))
    assert fused_head_decode(xs, params).shape == (2, 21, 2)
    with pytest.raises(ValueError, match="square"):
        fused_head_decode([xs[0], xs[1][:, :, :4]] + xs[2:], params)
    with pytest.raises(ValueError, match="square"):
        fused_head_decode([xs[0][:, :8]] + xs[1:], params)
    with pytest.raises(ValueError, match="K <= 128"):
        fused_head_decode(xs, params._replace(w_final=torch.zeros(120, 129),
                                              b_final=torch.zeros(129)))
    with pytest.raises(ValueError, match="4 branch tensors"):
        fused_head_decode(xs[:3], params)
    with pytest.raises(ValueError, match="w_head"):
        fused_head_decode(xs, params._replace(w_head=torch.zeros(100, 120)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_head_decode([x.to("meta") for x in xs],
                          HeadParams(*(t.to("meta") for t in params)))
