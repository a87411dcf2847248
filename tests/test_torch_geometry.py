"""The port's cameras, multi-view geometry and volumetric ops against the
JAX package's, on seeded numpy inputs.

Limits are the JAX package's own (tests/test_geometry.py): projections
rtol 1e-4 / atol 1e-2 px, the homogeneous round trip 1e-6, the bilinear
sampler 1e-5, the unprojection 1e-4, probability sums 1e-5; recovered 3D
points 0.5 mm of the truth (5 mm for the two-step SII), RANSAC and the
weighted DLT 2 mm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.ops import cameras as JC
from hrnet_hand_pose_estimation_tpu.ops import geometry as JG
from hrnet_hand_pose_estimation_tpu.ops import volumetric as JV
from hrnet_hand_pose_estimation_tpu_torch.ops import cameras as C
from hrnet_hand_pose_estimation_tpu_torch.ops import geometry as G
from hrnet_hand_pose_estimation_tpu_torch.ops import volumetric as V

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def cameras(n_views=4, seed=0):
    """A calibrated ring of cameras 600 mm out looking at the origin, with
    the MHP intrinsics (JAX tests/test_geometry.py)."""
    rng = np.random.default_rng(seed)
    K = np.array([[614.878, 0, 313.219], [0, 615.479, 231.288], [0, 0, 1]], np.float32)
    projs = []
    for i in range(n_views):
        angle = 2 * np.pi * i / n_views + rng.uniform(-0.1, 0.1)
        c, s = np.cos(angle), np.sin(angle)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        projs.append(K @ np.concatenate([R, [[0.0], [0.0], [600.0]]], axis=1))
    return np.stack(projs).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(1)
    projs = cameras()
    pts3d = rng.uniform(-80, 80, size=(2, 21, 3)).astype(np.float32)
    hom = np.concatenate([pts3d, np.ones_like(pts3d[..., :1])], -1)
    img = np.einsum("vij,bkj->bvki", projs, hom)
    pts2d = (img[..., :2] / img[..., 2:3]).astype(np.float32)
    return np.broadcast_to(projs[None], (2, 4, 3, 4)).copy(), pts3d, pts2d


# -------------------------------------------------------------- cameras
def test_camera_frames_and_radial_projection_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-100, 100, size=(3, 21, 3)).astype(np.float32)
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(3)]).astype(np.float32)
    T = rng.uniform(-50, 50, size=(3, 3)).astype(np.float32)
    T[:, 2] -= 700.0                          # the points lie in front of the cameras
    cam = C.world_to_camera_frame(t(pts), t(R), t(T)).numpy()
    np.testing.assert_allclose(cam, np.asarray(JC.world_to_camera_frame(j(pts), j(R), j(T))),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(C.camera_to_world_frame(t(cam), t(R), t(T)).numpy(), pts,
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(C.camera_to_world_frame(t(cam), t(R), t(T)).numpy(),
                               np.asarray(JC.camera_to_world_frame(j(cam), j(R), j(T))),
                               rtol=1e-5, atol=1e-3)
    f = rng.uniform(500, 700, size=(3, 2)).astype(np.float32)
    c = rng.uniform(200, 400, size=(3, 2)).astype(np.float32)
    k = (rng.normal(size=(3, 3)) * 0.05).astype(np.float32)
    p = (rng.normal(size=(3, 2)) * 0.01).astype(np.float32)
    uv, z = C.project_point_radial(t(pts), t(R), t(T), t(f), t(c), t(k), t(p))
    juv, jz = JC.project_point_radial(j(pts), j(R), j(T), j(f), j(c), j(k), j(p))
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-3)


# -------------------------------------------------------------- basics
def test_homogeneous_helpers_and_bounded_divide():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    back = G.homogeneous_to_euclidean(G.euclidean_to_homogeneous(t(pts)))
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-6)
    # w = 0 -> +eps, |w| < eps keeps its sign, |w| >= eps and NaN untouched
    hom = np.array([[1.0, 2.0, 0.0], [1.0, 2.0, -1e-9], [1.0, 2.0, 3e-7], [1.0, 2.0, 0.5],
                    [1.0, 2.0, -0.5], [1.0, 2.0, np.nan]], np.float32)
    got = G.homogeneous_to_euclidean(t(hom), eps=1e-6).numpy()
    want = np.asarray(JG.homogeneous_to_euclidean(j(hom), eps=1e-6))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 1e6 and got[1, 0] == -1e6 and np.isnan(got[5]).all()


def test_projection_resize_and_compose_match_jax(scene):
    projs, pts3d, pts2d = scene
    b, v, k = 2, 4, 21
    pt = np.broadcast_to(pts3d[:, None], (b, v, k, 3))
    got = G.project_points(t(projs), t(pt)).numpy()
    np.testing.assert_allclose(got, pts2d, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(got, np.asarray(JG.project_points(j(projs), j(pt))),
                               rtol=1e-4, atol=1e-2)
    K = np.array([[[600.0, 0, 320], [0, 610.0, 240], [0, 0, 1]]], np.float32)
    K2 = G.update_after_resize(t(K), (480, 640), (64, 64)).numpy()
    np.testing.assert_allclose(K2, np.asarray(JG.update_after_resize(j(K), (480, 640), (64, 64))),
                               rtol=1e-6)
    assert K2[0, 0, 0] == pytest.approx(600 * 64 / 640) and K2[0, 2, 2] == 1.0
    rng = np.random.default_rng(4)
    E = rng.normal(size=(2, 3, 3, 4)).astype(np.float32)
    Ks = rng.normal(size=(2, 1, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(G.compose_projection(t(Ks), t(E)).numpy(),
                               np.asarray(JG.compose_projection(j(Ks), j(E))), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(G._dlt_system(t(pts2d[:, :, 0]), t(projs)).numpy(),
                               np.asarray(JG._dlt_system(j(pts2d[:, :, 0]), j(projs))),
                               rtol=1e-6)


@pytest.mark.parametrize("method,tol", [("eigh", 0.5), ("svd", 0.5), ("sii", 5.0)])
def test_triangulate_recovers_3d_as_jax(scene, method, tol):
    projs, pts3d, pts2d = scene
    got = G.triangulate_batch(t(pts2d), t(projs), method=method).numpy()
    want = np.asarray(JG.triangulate_batch(j(pts2d), j(projs), method=method))
    assert np.abs(got - pts3d).max() < tol
    assert np.abs(want - pts3d).max() < tol
    # the same iteration in the same precision: SII and SVD agree closely;
    # eigh solves in float64 where JAX solves in float32
    np.testing.assert_allclose(got, want, atol={"eigh": 0.5, "svd": 0.01, "sii": 0.01}[method])


def test_weighted_eigh_downweights_a_bad_view(scene):
    projs, pts3d, pts2d = scene
    noisy = pts2d.copy()
    noisy[:, 0] += 250.0
    w = np.ones((2, 4, 21), np.float32)
    w[:, 0] = 1e-4
    got = G.triangulate_batch(t(noisy), t(projs), "eigh", confidences=t(w)).numpy()
    want = np.asarray(JG.triangulate_batch(j(noisy), j(projs), "eigh", confidences=j(w)))
    assert np.abs(got - pts3d).max() < 2.0 and np.abs(want - pts3d).max() < 2.0
    np.testing.assert_allclose(got, want, atol=1.0)


def test_ransac_with_an_outlier_view(scene):
    projs, pts3d, pts2d = scene
    noisy = pts2d.copy()
    noisy[:, 1] += 300.0
    pts, prj = noisy.swapaxes(1, 2), np.broadcast_to(projs[:, None], (2, 21, 4, 3, 4))
    got, inl = G.triangulate_ransac(t(pts), t(prj))
    want, jinl = JG.triangulate_ransac(j(pts), j(prj))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    assert not inl[..., 1].any() and inl[..., [0, 2, 3]].all()
    assert np.abs(got.numpy() - pts3d).max() < 2.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.5)
    errs = G.reprojection_errors(got, t(pts), t(prj)).numpy()
    np.testing.assert_allclose(errs, np.asarray(JG.reprojection_errors(j(got), j(pts), j(prj))),
                               rtol=1e-4, atol=1e-2)
    assert (errs[..., 1] > 250).all() and (errs[..., [0, 2, 3]] < 0.2).all()


def test_degenerate_system_is_bounded_as_jax():
    """Every view decoding the principal point (an untrained net) on the
    JAX triangulation tests' tilted ring: both DLTs give the same bounded
    point, and every coordinate is finite."""
    hm = 16
    K = np.array([[30.0, 0, (hm - 1) / 2], [0, 30.0, (hm - 1) / 2], [0, 0, 1]], np.float32)
    projs = []
    for i in range(2):
        ang = 2 * np.pi * i / 2 + 0.3
        c, s = np.cos(ang), np.sin(ang)
        ry = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        tx = 0.2 + 0.15 * i
        ct, st = np.cos(tx), np.sin(tx)
        rx = np.array([[1, 0, 0], [0, ct, -st], [0, st, ct]], np.float32)
        projs.append(K @ np.concatenate([rx @ ry, [[0], [0], [900.0]]], 1))
    projs = np.stack(projs)[None].astype(np.float32)
    pts = np.full((1, 2, 21, 2), (hm - 1) / 2, np.float32)
    got = G.triangulate_batch(t(pts), t(projs)).numpy()
    want = np.asarray(JG.triangulate_batch(j(pts), j(projs)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=0.5)


# ----------------------------------------------------------- volumetric
def test_coord_volume_and_rotation_match_jax():
    base = np.array([[10.0, 20.0, 30.0], [-5.0, 0.5, 7.0]], np.float32)
    cv = V.build_coord_volume(t(base), 100.0, 8)
    jcv = JV.build_coord_volume(j(base), 100.0, 8)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(cv.numpy()[0, 0, 0, 0], [-40, -30, -20], atol=1e-5)
    theta = np.array([0.7, -2.1], np.float32)
    np.testing.assert_allclose(V.rotation_matrix((0, 1, 0), t(theta)).numpy(),
                               np.stack([np.asarray(JV.rotation_matrix((0, 1, 0), j(th)))
                                         for th in theta]), atol=1e-6)
    rot = V.rotate_coord_volume(cv, t(theta), (0, 1, 0), center=t(base)).numpy()
    np.testing.assert_allclose(rot, np.asarray(JV.rotate_coord_volume(jcv, j(theta), (0, 1, 0),
                                                                      center=j(base))),
                               atol=1e-4)
    d0 = np.linalg.norm(cv.numpy() - base[:, None, None, None], axis=-1)
    np.testing.assert_allclose(np.linalg.norm(rot - base[:, None, None, None], axis=-1), d0,
                               atol=1e-4)
    np.testing.assert_allclose(V.rotate_coord_volume(cv, t([0.3, 1.0]), (1, 1, 0)).numpy(),
                               np.asarray(JV.rotate_coord_volume(jcv, j([0.3, 1.0]), (1, 1, 0))),
                               atol=1e-4)


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(5)
    imgs = rng.normal(size=(2, 16, 12, 5)).astype(np.float32)
    coords = rng.uniform(-3, 19, size=(2, 40, 2)).astype(np.float32)
    np.testing.assert_allclose(V.bilinear_sample_nhwc(t(imgs), t(coords)).numpy(),
                               np.asarray(JV.bilinear_sample_nhwc(j(imgs), j(coords))),
                               atol=1e-5)


@pytest.mark.parametrize("aggregation", ["sum", "max", "softmax", "conf"])
def test_unproject_matches_jax(aggregation):
    rng = np.random.default_rng(6)
    b, v, hw, c, s = 2, 3, 8, 4, 6
    feats = rng.normal(size=(b, v, hw, hw, c)).astype(np.float32)
    projs = np.stack([cameras(v, seed=i) for i in range(b)])
    scale = np.diag([hw / 640.0, hw / 480.0, 1.0]).astype(np.float32)
    projs = np.einsum("ij,bvjk->bvik", scale, projs).astype(np.float32)
    # one camera behind the volume's far corner: voxels of depth <= 0 zeroed
    projs[1, 2, 2, 3] = -50.0
    cv = np.asarray(JV.build_coord_volume(jnp.zeros((b, 3)), 200.0, s))
    conf = rng.uniform(0.1, 1.0, size=(b, v, c)).astype(np.float32)
    got = V.unproject_heatmaps(t(feats), t(projs), t(cv), aggregation, t(conf)).numpy()
    want = np.asarray(JV.unproject_heatmaps(j(feats), j(projs), j(cv), aggregation, j(conf)))
    assert got.shape == (b, s, s, s, c) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("softmax", [True, False])
def test_integrate_volumes_matches_jax(softmax):
    rng = np.random.default_rng(7)
    b, s, k = 2, 8, 3
    base = rng.normal(size=(b, 3)).astype(np.float32) * 20
    cv = np.asarray(JV.build_coord_volume(j(base), 100.0, s))
    vols = (rng.normal(size=(b, s, s, s, k)) * 3).astype(np.float32)
    vols[0, 2, 3, 4, 0] = 50.0
    coords, probs = V.integrate_volumes_with_coordinates(t(vols), t(cv), softmax=softmax)
    jcoords, jprobs = JV.integrate_volumes_with_coordinates(j(vols), j(cv), softmax=softmax)
    np.testing.assert_allclose(coords.numpy(), np.asarray(jcoords), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(probs.double().sum(dim=(1, 2, 3)).numpy(), 1.0, atol=1e-5)
    if softmax:
        np.testing.assert_allclose(coords.numpy()[0, 0], cv[0, 2, 3, 4], atol=0.5)
