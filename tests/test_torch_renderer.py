"""The port's z-buffer renderer (``utils/renderer.py``) against the JAX
package's, on seeded meshes: ``rasterize`` (coverage and colours),
``vertex_normals`` and the shading, ``MeshRenderer`` (plain, on an image,
with alpha, rotated), ``get_alpha``, ``append_alpha`` and ``draw_text``.

Limits: the coverage masks are equal except on at most 0.5 % of the
pixels, each of them on a triangle edge (a pixel whose smallest barycentric
in a triangle that covers it is within 1e-4 of 0, in float64: there float32
rounding decides the ``>= 0`` test, differently in XLA and in PyTorch);
the colours within 1/255 everywhere else.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.utils import renderer as jax_renderer
from hrnet_hand_pose_estimation_tpu_torch.utils import renderer

torch.set_num_threads(1)
EDGE_EPS = 1e-4


def seeded_mesh(n_verts, n_faces, seed, depth=8.0, spread=0.5):
    """Vertices in a blob ``depth`` in front of the camera; each face joins
    a vertex to two of its five nearest neighbours (small triangles that
    overlap in depth, as a hand mesh's do)."""
    rng = np.random.default_rng(seed)
    verts = rng.normal(scale=spread, size=(n_verts, 3)).astype(np.float32)
    verts[:, 2] += depth
    d = ((verts[:, None] - verts[None]) ** 2).sum(-1)
    near = np.argsort(d, axis=1)[:, 1:6]
    a = rng.integers(0, n_verts, n_faces)
    pick = np.stack([rng.choice(5, 2, replace=False) for _ in range(n_faces)])
    faces = np.stack([a, near[a, pick[:, 0]], near[a, pick[:, 1]]], 1).astype(np.int32)
    return verts, faces


def edge_band(verts, faces, f, c, h, w, near, far):
    """(H, W) bool: pixels within EDGE_EPS of an edge of a triangle that
    covers them (barycentrics in float64), in the depth range."""
    z = np.maximum(verts[:, 2].astype(np.float64), 1e-6)
    u = f[0] * verts[:, 0] / z + c[0]
    v = f[1] * verts[:, 1] / z + c[1]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    band = np.zeros((h, w), bool)
    for tri in faces:
        (x0, x1, x2), (y0, y1, y2) = u[tri], v[tri]
        den = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        if abs(den) < 1e-8:
            continue
        l0 = ((x2 - x1) * (ys - y1) - (y2 - y1) * (xs - x1)) / den
        l1 = ((x0 - x2) * (ys - y2) - (y0 - y2) * (xs - x2)) / den
        l2 = 1.0 - l0 - l1
        lmin = np.minimum(np.minimum(l0, l1), l2)
        depth = l0 * verts[tri[0], 2] + l1 * verts[tri[1], 2] + l2 * verts[tri[2], 2]
        band |= (np.abs(lmin) <= EDGE_EPS) & (depth > near) & (depth < far)
    return band


def check_coverage(got, want, band, what):
    """Two (H, W) coverage masks: equal off the edge band, at most 0.5 %
    of the pixels apart; the mesh covers a tenth of the image or more."""
    differ = got != want
    assert differ.mean() <= 0.005 and not (differ & ~band).any(), what
    assert want.mean() > 0.1, f"{what}: the mesh covers too little"


@pytest.mark.parametrize("size,n_faces,chunk", [(48, 160, 64), (64, 300, 32)])
def test_rasterize_matches_jax(size, n_faces, chunk):
    """``rasterize`` of a shaded seeded mesh on a black background, square
    and not (H != W), chunk sizes that do not divide the faces."""
    verts, faces = seeded_mesh(n_faces // 2, n_faces, size)
    h, w = size, size + 8
    f, c = np.array([150.0, 160.0], np.float32), np.array([w / 2, h / 2], np.float32)
    vc = np.asarray(jax_renderer.shade_vertices(jnp.asarray(verts), jnp.asarray(faces),
                                                renderer.colors["light_blue"]))
    got_vc = renderer.shade_vertices(torch.from_numpy(verts), torch.from_numpy(faces),
                                     renderer.colors["light_blue"]).numpy()
    np.testing.assert_allclose(got_vc, vc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        renderer.vertex_normals(torch.from_numpy(verts), torch.from_numpy(faces)).numpy(),
        np.asarray(jax_renderer.vertex_normals(jnp.asarray(verts), jnp.asarray(faces))),
        rtol=0, atol=1e-5)
    bg = np.zeros((h, w, 3), np.float32)
    band = edge_band(verts, faces, f, c, h, w, 0.1, 100.0)
    renders = []
    for colours in (np.ones_like(vc), vc):          # coverage, then the shaded colours
        want = jax_renderer.rasterize(jnp.asarray(verts), jnp.asarray(faces),
                                      jnp.asarray(colours), jnp.asarray(f), jnp.asarray(c),
                                      jnp.asarray(bg), near=0.1, far=100.0, height=h,
                                      width=w, chunk=chunk)
        got = renderer.rasterize(*(torch.from_numpy(a) for a in (verts, faces, colours, f, c,
                                                                  bg)),
                                 near=0.1, far=100.0, height=h, width=w, chunk=chunk)
        assert got.shape == (h, w, 3) and got.dtype == torch.float32
        renders.append((got.numpy(), np.asarray(want)))
    (cov_g, cov_w), (col_g, col_w) = renders
    check_coverage(cov_g[..., 0] > 0.5, cov_w[..., 0] > 0.5, band, "rasterize")
    assert np.abs(col_g - col_w)[~band].max() <= 1 / 255


def test_mesh_renderer_matches_jax():
    """``MeshRenderer`` at 64 px: the uint8 render, over an image, with the
    alpha rules and rotated about y; ``get_alpha``, ``append_alpha`` and
    ``draw_text`` as JAX's."""
    verts, faces = seeded_mesh(120, 240, 7, depth=10.0, spread=0.25)
    kw = dict(img_size=64, flength=500.0)
    jr = jax_renderer.MeshRenderer(faces, **kw)
    pr = renderer.MeshRenderer(faces, **kw, device="cpu")
    near = max(float(verts[:, 2].min()) - 25.0, 0.1)
    far = max(float(verts[:, 2].max()) + 25.0, 25.0)
    band = edge_band(verts, faces, (500.0, 500.0), (32.0, 32.0), 64, 64, near, far)
    got, want = pr(verts), jr(verts)
    assert got.dtype == np.uint8 and got.shape == (64, 64, 3)
    assert np.abs(got.astype(int) - want.astype(int))[~band].max() <= 1

    img = np.random.default_rng(8).integers(0, 256, size=(64, 64, 3)).astype(np.uint8)
    got, want = pr(verts, img=img, do_alpha=True, color_id=1), jr(verts, img=img,
                                                                  do_alpha=True, color_id=1)
    assert got.shape == (64, 64, 4) and (got[..., 3] == 255).all()
    assert np.abs(got.astype(int) - want.astype(int))[~band].max() <= 1

    got, want = pr(verts, do_alpha=True), jr(verts, do_alpha=True)
    assert got.shape == (64, 64, 4)
    check_coverage(got[..., 3] > 0, want[..., 3] > 0, band, "MeshRenderer alpha")

    rot_v = (verts - verts.mean(0)) @ np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]]) + verts.mean(0)
    band_r = edge_band(rot_v.astype(np.float32), faces, (500.0, 500.0), (32.0, 32.0), 64, 64,
                       max(float(rot_v[:, 2].min()) - 25.0, 0.1),
                       max(float(rot_v[:, 2].max()) + 25.0, 25.0))
    got, want = pr.rotated(verts, 90), jr.rotated(verts, 90)
    assert got.shape == (64, 64, 4)
    assert np.abs(got.astype(int) - want.astype(int))[~band_r].max() <= 1

    im = np.random.default_rng(9).uniform(size=(20, 30, 3)).astype(np.float32)
    np.testing.assert_array_equal(renderer.get_alpha(im, bgval=im[0, 0, 0]),
                                  jax_renderer.get_alpha(im, bgval=im[0, 0, 0]))
    u8 = (im * 255).astype(np.uint8)
    for a in (im, u8):
        np.testing.assert_array_equal(renderer.append_alpha(a), jax_renderer.append_alpha(a))
        np.testing.assert_array_equal(renderer.draw_text(a, {"b": 1.5, "a": 0.25}),
                                      jax_renderer.draw_text(a, {"b": 1.5, "a": 0.25}))
    assert renderer.append_alpha(u8)[..., 3].min() == 255
