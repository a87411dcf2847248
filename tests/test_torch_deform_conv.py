"""The port's deformable convolution (``ops/deform_conv.py``) against the JAX
package's: zero offsets give the plain convolution, random offsets with one
offset field per channel group match JAX's forward, modulated or not, and
the gradients with respect to the input, the offsets and the weight match
``jax.grad``'s.  Float32 throughout; limits relative to the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.ops import deform_conv as jax_dc
from hrnet_hand_pose_estimation_tpu_torch.ops import deform_conv as dc
from torch_zoo_parity import rel_gap

torch.set_num_threads(1)


def case(seed, b=2, h=9, w=11, cin=6, cout=5, g=6, dilation=2, padding=2, scale=2.0):
    """(x, offsets, weight, mask) of a grouped deformable conv, numpy float32."""
    rng = np.random.default_rng(seed)
    ho = h + 2 * padding - 2 * dilation
    wo = w + 2 * padding - 2 * dilation
    f32 = lambda a: np.asarray(a, np.float32)
    return (f32(rng.normal(size=(b, h, w, cin))),
            f32(scale * rng.normal(size=(b, ho, wo, g * 18))),
            f32(rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)),
            f32(rng.uniform(0, 1, size=(b, ho, wo, g * 9))))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("padding,dilation,g", [(1, 1, 1), (2, 2, 3), (3, 3, 6)])
def test_zero_offsets_give_the_plain_conv(padding, dilation, g):
    """Zero offsets: the port's deformable conv equals its plain conv and
    JAX's plain conv within 1e-5 of the largest output."""
    x, off, wt, _ = case(1, padding=padding, dilation=dilation, g=g)
    zero = np.zeros_like(off)
    got = dc.deform_conv2d(t(x), t(zero), t(wt), padding=padding, dilation=dilation,
                           deformable_groups=g)
    plain = dc.plain_conv2d_reference(t(x), t(wt), padding=padding, dilation=dilation)
    want = jax_dc.plain_conv2d_reference(jnp.asarray(x), jnp.asarray(wt), padding=padding,
                                         dilation=dilation)
    assert got.shape == plain.shape == want.shape
    assert rel_gap(got, plain) <= 1e-5 and rel_gap(plain, want) <= 1e-5


@pytest.mark.parametrize("modulated", [False, True])
def test_random_offsets_match_jax(modulated):
    """Offsets of std 2 px (samples outside the map included), G = Cin = 6
    groups, dilation 2, a bias, with and without the v2 mask: within 1e-5 of
    the largest output of JAX's."""
    x, off, wt, mask = case(2)
    bias = np.linspace(-1, 1, 5).astype(np.float32)
    kw = dict(padding=2, dilation=2, deformable_groups=6)
    m = mask if modulated else None
    got = dc.deform_conv2d(t(x), t(off), t(wt), t(bias), None if m is None else t(m), **kw)
    want = jax_dc.deform_conv2d(jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt),
                                jnp.asarray(bias), None if m is None else jnp.asarray(m), **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 9, 11, 5)
    assert rel_gap(got, want) <= 1e-5


def test_gradients_match_jax():
    """The gradients of sum(out * r) with respect to x, the offsets and the
    weight (G = 3, dilation 2): within 1e-4 of each one's largest value of
    ``jax.grad``'s."""
    x, off, wt, _ = case(3, g=3)
    r = np.random.default_rng(4).normal(size=(2, 9, 11, 5)).astype(np.float32)
    kw = dict(padding=2, dilation=2, deformable_groups=3)

    def loss(x_, off_, wt_):
        return jnp.sum(jax_dc.deform_conv2d(x_, off_, wt_, **kw) * r)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jnp.asarray(x), jnp.asarray(off),
                                                        jnp.asarray(wt))
    leaves = [t(a).requires_grad_() for a in (x, off, wt)]
    (dc.deform_conv2d(*leaves, **kw) * t(r)).sum().backward()
    for name, leaf, w_ in zip(("x", "offsets", "weight"), leaves, want):
        assert float(np.abs(np.asarray(w_)).max()) > 0, name
        assert rel_gap(leaf.grad, w_) <= 1e-4, name
