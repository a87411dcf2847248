"""The gradient of B4, the softmax decode (``ops/kernels/softmax_decode.py``).

On the CPU ``fused_softmax_decode`` runs ``SoftmaxDecode``'s plain twins:
the forward ``softmax_decode_reference`` with the state (m, s) of
``softmax_decode_stats_reference``, the backward
``softmax_decode_backward_reference``.  Held to ``jax.grad`` of the JAX
package's ``decode_heatmaps(spatial_softmax(x, T))`` (float32, 1e-5 of the
gradient's largest element), to autograd of the plain twin, and to
``gradcheck`` in float64.  The kernel itself is held to the backward twin
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.ops.decode import decode_heatmaps, spatial_softmax
from hrnet_hand_pose_estimation_tpu_torch.ops.decode import softmax_decode
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import softmax_decode as M

torch.set_num_threads(1)

SHAPES = [(2, 16, 16, 21), (3, 12, 10, 5), (1, 1, 7, 3)]


def inputs(shape, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    g = rng.normal(size=(shape[0], shape[3], 2)).astype(np.float32)
    return x, g


def jax_grads(x, temp, g):
    def f(xx, tt):
        return jnp.sum(decode_heatmaps(spatial_softmax(xx, tt), True) * g)

    dx, dt = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.float32(temp))
    return np.asarray(dx), float(dt)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("temp", [1.0, 2.5])
def test_backward_twin_matches_jax_grad(shape, temp):
    x, g = inputs(shape, seed=sum(shape))
    want_dx, want_dt = jax_grads(x, temp, g)
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.tensor(temp, requires_grad=True)
    out = softmax_decode(xt, tt)
    assert out.shape == (shape[0], shape[3], 2)
    dx, dt = torch.autograd.grad(out, (xt, tt), torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=0,
                               atol=1e-5 * np.abs(want_dx).max())
    # dT sums x * g_z over every pixel: relative to the sum of |x * g_z|
    gz = want_dx / temp
    np.testing.assert_allclose(float(dt), want_dt, rtol=0, atol=1e-5 * np.abs(x * gz).sum())


def test_backward_twin_matches_autograd_of_the_plain_decode():
    x, g = inputs((2, 9, 11, 4), seed=5)
    xa = torch.from_numpy(x).requires_grad_(True)
    ta = torch.tensor(1.7, requires_grad=True)
    want = torch.autograd.grad(M.softmax_decode_reference(xa, ta), (xa, ta), torch.from_numpy(g))
    stats = M.softmax_decode_stats_reference(torch.from_numpy(x), 1.7)
    got = M.softmax_decode_backward_reference(torch.from_numpy(x), torch.tensor(1.7), stats,
                                              torch.from_numpy(g))
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0,
                               atol=1e-5 * float(want[0].abs().max()))
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-4)


def test_gradcheck_float64():
    """The backward twin is the derivative of the forward twin (float64)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 5, 4, 3)) * 2).requires_grad_(True)
    t = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: M.SoftmaxDecode.apply(a, b, 0.0), (x, t))
    # a float temperature: the gradient of the logits alone
    assert torch.autograd.gradcheck(lambda a: M.SoftmaxDecode.apply(a, None, 0.7), (x,))


def test_stats_are_the_plane_max_and_sum():
    x, _ = inputs((2, 6, 5, 3), seed=8)
    stats = M.softmax_decode_stats_reference(torch.from_numpy(x), 1.5).numpy()
    z = x.reshape(2, 30, 3) * 1.5
    np.testing.assert_allclose(stats[..., 0], z.max(axis=1), rtol=1e-6)
    np.testing.assert_allclose(stats[..., 1], np.exp(z - z.max(axis=1, keepdims=True)).sum(1),
                               rtol=1e-5)


def test_gradient_paths_and_counters():
    """No gradient wanted: the plain twin, no autograd node.  A detached
    tensor temperature gets no gradient, a float none either; bfloat16
    logits get a bfloat16 gradient.  The CPU launches nothing."""
    launches = (M.fused_softmax_decode.launches, M.fused_softmax_decode.launches_bwd)
    x, g = inputs((2, 8, 8, 5), seed=9)
    xt = torch.from_numpy(x)
    assert softmax_decode(xt, 1.5).grad_fn is None
    with torch.no_grad():
        assert softmax_decode(xt.requires_grad_(True), 1.5).grad_fn is None
    temp = torch.tensor(1.5)
    out = softmax_decode(xt, temp)
    assert out.grad_fn is not None and not temp.requires_grad
    (dx,) = torch.autograd.grad(out, (xt,), torch.from_numpy(g))
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    (db,) = torch.autograd.grad(softmax_decode(xb, 1.5), (xb,), torch.from_numpy(g))
    assert db.dtype == torch.bfloat16 and dx.dtype == torch.float32
    assert (M.fused_softmax_decode.launches, M.fused_softmax_decode.launches_bwd) == launches


@pytest.mark.parametrize("bad,match", [
    (torch.zeros(2, 4, 4), "B, H, W, K"),
    (torch.zeros(1, 4, 4, 3, dtype=torch.float64), "float32 or bfloat16"),
    (torch.zeros(1, 4, 4, 1025), "at most"),
])
def test_refuses_what_the_forward_refuses_with_grad(bad, match):
    with pytest.raises(ValueError, match=match):
        softmax_decode(bad.requires_grad_(True), torch.tensor(1.0, requires_grad=True))
    with pytest.raises(ValueError, match="scalar"):
        softmax_decode(torch.zeros(1, 4, 4, 3, requires_grad=True),
                       torch.ones(2, requires_grad=True))


def test_backward_blocks_depend_on_the_size_only():
    assert M.decode_bwd_blocks(8 * 64 * 64 * 21, 2) == 336
    assert M.decode_bwd_blocks(128 * 64 * 64 * 21, 2) == M.BWD_MAX_BLOCKS
    assert M.decode_bwd_blocks(1, 4) == 1
