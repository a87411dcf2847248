"""The port's triangulation nets, V2V and the volumetric backbone's
confidence head against the JAX package's, on shared weights.

The JAX nets' variables (``model.init``, kernels He-rescaled so the random
nets decode sample-dependent joints) go through ``from_jax_variables`` into
the port.  Both sides compute in float32 (``TPU.COMPUTE_DTYPE`` float32, the
volumetric net's ``dtype`` float32), the JAX side with its eigh solved in
float64 as the port's (``jax_eigh64``); one case runs the volumetric net's
default bfloat16 V2V on both sides against a float32 witness.  V2V at 32^3,
as the JAX package's own tests size it (five poolings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.models.hrnet import \
    GlobalAveragePoolingHead as JaxGAPHead
from hrnet_hand_pose_estimation_tpu.models.triangulation import \
    build_triangulation_net as jax_build_net
from hrnet_hand_pose_estimation_tpu.models.v2v import V2VModel as JaxV2V
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import GlobalAveragePoolingHead
from hrnet_hand_pose_estimation_tpu_torch.models.triangulation import build_triangulation_net
from hrnet_hand_pose_estimation_tpu_torch.models.v2v import V2VModel
from hrnet_hand_pose_estimation_tpu_torch.ops.geometry import triangulate_ransac
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.softmax_decode import fused_softmax_decode
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables, init_variables

torch.set_num_threads(1)
# alg and ransac scale heatmap coords to the nets' default 640x480 image:
# the 2D limits are in heatmap pixels
ORIG_SCALE = np.array([640 / 16, 480 / 16], np.float32)


def net_cfg(tiny_cfg, **extra):
    cfg = tiny_cfg.clone()
    cfg.defrost()
    cfg.MODEL.VOLUME_SIZE = 32          # divisible by 2^5 for V2V
    cfg.MODEL.CUBOID_SIZE = 400.0
    cfg.MODEL.VOL_CONFIDENCES = False
    cfg.MODEL.ALG_CONFIDENCES = False
    cfg.TPU.COMPUTE_DTYPE = "float32"
    for key, val in extra.items():
        cfg.merge_from_list([key.replace("__", "."), val])
    return cfg.freeze()


def proj_matrices(b, v, f, c):
    """Projections of cameras 900 mm out, 0.9 rad apart on a ring and each
    tilted differently about x, with focal ``f`` and principal point ``c``
    at the scale of the keypoints they triangulate: alg and ransac scale
    heatmap coords to a 640x480 image, vol keeps them.  Cameras far from
    opposite keep the DLT of a random net's detections well conditioned."""
    K = np.array([[f, 0, c[0]], [0, f, c[1]], [0, 0, 1]], np.float32)
    projs = []
    for i in range(v):
        ang = 0.3 + 0.9 * i
        cs, sn = np.cos(ang), np.sin(ang)
        ry = np.array([[cs, 0, sn], [0, 1, 0], [-sn, 0, cs]], np.float32)
        tx = 0.2 + 0.15 * i
        ct, st = np.cos(tx), np.sin(tx)
        rx = np.array([[1, 0, 0], [0, ct, -st], [0, st, ct]], np.float32)
        projs.append(K @ np.concatenate([rx @ ry, np.array([[0], [0], [900.0]], np.float32)], 1))
    return np.broadcast_to(np.stack(projs), (b, v, 3, 4)).astype(np.float32).copy()


CAMERAS = {"alg": (600.0, (320.0, 240.0)), "ransac": (600.0, (320.0, 240.0)),
           "vol": (15.0, (7.5, 7.5))}


def init_like(model, rng, *args):
    """A variable tree of ``model.init``'s shapes without running the init
    (``jax.eval_shape``: an eager init of a net with V2V takes ~30 s on the
    CPU): normal kernels, flax's initial values elsewhere; ``activate`` then
    scales them as for an init."""
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.key(0),
                                                "aug": jax.random.key(1)}, *args))
    first = {"scale": np.ones, "var": np.ones, "trainable_temp": np.ones}

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else (
            rng.standard_normal(v.shape).astype(np.float32) if k == "kernel"
            else first.get(k, np.zeros)(v.shape, np.float32)) for k, v in tree.items()}

    return {coll: fill(dict(tree)) for coll, tree in dict(shapes).items()}


def activate(variables, rng, gain=1.4, temp=2.0):
    """He-rescaled kernels, randomised BN and biases, a sharpening softmax
    temperature: numpy leaves."""
    def walk(tree):
        out = {}
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                out[k] = walk(leaf)
                continue
            a = np.asarray(leaf, np.float32)
            if k == "kernel":
                a = a * (gain / np.sqrt(np.prod(a.shape[:-1])) / (a.std() + 1e-12))
            elif k == "scale":
                a = a * (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
            elif k == "bias":
                a = a + (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
            elif k == "mean":
                a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
            elif k == "var":
                a = (1.0 + 0.3 * rng.uniform(size=a.shape)).astype(np.float32)
            elif k == "trainable_temp":
                a = np.float32(temp)
            out[k] = a
        return out

    return {coll: walk(tree) for coll, tree in variables.items()}


def jax_net(cfg, kind, rng, b=2, v=2, dtype=jnp.float32):
    model = jax_build_net(cfg, kind)
    if kind == "vol":
        model = model.clone(dtype=dtype)
    imgs = jnp.asarray(rng.normal(size=(b, v, 64, 64, 3)).astype(np.float32))
    projs = jnp.asarray(proj_matrices(b, v, *CAMERAS[kind]))
    return model, activate(init_like(model, rng, imgs, projs, False), rng), imgs, projs


def port_net(cfg, kind, variables, dtype=torch.float32):
    model = build_triangulation_net(config_from_dict(cfg.to_dict()), kind, dtype=dtype)
    model.load_state_dict(from_jax_variables(variables, model))
    return model


def run_both(cfg, kind, seed, b=2, v=2, dtype=(jnp.float32, torch.float32)):
    rng = np.random.default_rng(seed)
    jm, variables, imgs, projs = jax_net(cfg, kind, rng, b, v, dtype[0])
    want = jm.apply(variables, imgs, projs, False)
    model = port_net(cfg, kind, variables, dtype[1])
    before = fused_softmax_decode.launches
    with torch.no_grad():
        got = model(torch.from_numpy(np.array(imgs)), torch.from_numpy(np.array(projs)))
    assert fused_softmax_decode.launches == before          # the CPU runs the twin
    return got, want, (jm, variables, imgs, projs)


class _Linalg64:
    """``jnp.linalg`` with ``eigh`` solved in float64 by numpy."""

    def __getattr__(self, name):
        return getattr(jnp.linalg, name)

    @staticmethod
    def eigh(a):
        def host(x):
            w, v = np.linalg.eigh(np.asarray(x, np.float64))
            return w.astype(np.float32), v.astype(np.float32)

        out = (jax.ShapeDtypeStruct(a.shape[:-1], jnp.float32),
               jax.ShapeDtypeStruct(a.shape, jnp.float32))
        return jax.pure_callback(host, out, a, vmap_method="expand_dims")


class _Jnp64:
    linalg = _Linalg64()

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def jax_eigh64(monkeypatch):
    """The JAX geometry module's ``jnp.linalg.eigh`` solved in float64 on
    the host, as the port solves its float32 A^T A: on a random net's
    detections, which disagree across views, a float32 eigh (JAX's or
    LAPACK's) is mm to km off the exact DLT (median 8 mm over 400 random
    two-view points of the vol cameras), the float64 one 1e-4 mm.  A
    test-time patch: no file of the JAX package changes."""
    from hrnet_hand_pose_estimation_tpu.ops import geometry as JG

    monkeypatch.setattr(JG, "jnp", _Jnp64())


def test_v2v_matches_jax_with_nonsymmetric_deconv_weights():
    """V2V at 32^3, float32, random weights (the transposed convs' kernels
    are not symmetric in space, so a missing or extra flip shows); the JAX
    package's parameter count."""
    rng = np.random.default_rng(0)
    x = np.abs(rng.normal(size=(1, 32, 32, 32, 32))).astype(np.float32)
    jm = JaxV2V(out_channels=21, dtype=jnp.float32)
    variables = activate(init_like(jm, rng, x, False), rng, gain=1.0)
    deconv = variables["params"]["dec_up5"]["deconv"]["kernel"]
    assert np.abs(deconv - deconv[::-1, ::-1, ::-1]).max() > 0.1
    want = np.asarray(jm.apply(variables, x, False))
    model = V2VModel(32, 21).eval()
    holder = torch.nn.Module()          # the bridge places V2V under a net's volume_net
    holder.volume_net = model
    holder.load_state_dict(from_jax_variables(
        {c: {"volume_net": t} for c, t in variables.items()}, holder))
    assert sum(p.numel() for p in model.parameters()) == 11_944_485
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 32, 32, 32, 21)
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=0)


def test_gap_confidence_head_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 16, 16, 120)).astype(np.float32)
    jm = JaxGAPHead(21, dtype=jnp.float32)
    variables = activate(init_like(jm, rng, x, False), rng)
    want = np.asarray(jm.apply(variables, x, False))
    head = GlobalAveragePoolingHead(120, 21).eval()
    sd = from_jax_variables({c: {"backbone": {"backbone": {}, "confidence_head": t}}
                             for c, t in variables.items()})
    head.load_state_dict({k[len("backbone.vol_confidences."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 21) and 0.01 < want.std()
    np.testing.assert_allclose(got, want, atol=2e-6)


def dlt64(kp2d, projs, weights=None):
    """(the exact DLT in float64 (numpy SVD) of (B, V, K, 2) detections
    with optional (B, V, K) weights, the gap between the two smallest
    eigenvalues of its unit-trace A^T A)."""
    pts = np.swapaxes(np.asarray(kp2d, np.float64), 1, 2)                  # (B, K, V, 2)
    prj = np.asarray(projs, np.float64)[:, None]                           # (B, 1, V, 3, 4)
    a = prj[..., 2:3, :] * pts[..., None] - prj[..., :2, :]                # (B, K, V, 2, 4)
    if weights is not None:
        a = a * np.swapaxes(np.asarray(weights, np.float64), 1, 2)[..., None, None]
    a = a.reshape(*a.shape[:2], -1, 4)
    _, _, vh = np.linalg.svd(a)
    x = vh[..., 3, :]
    ata = np.einsum("...ij,...ik->...jk", a, a)
    lam = np.linalg.eigvalsh(ata / np.trace(ata, axis1=-2, axis2=-1)[..., None, None])
    return x[..., :3] / x[..., 3:], lam[..., 1] - lam[..., 0]


def assert_exact_dlt(kp3d, kp2d, projs, weights=None):
    """3D keypoints within 0.5 mm + 1e-4 of the distance (a point near
    infinity) + 2e-9 mm / gap of the float64 DLT of the same side's
    detections.  The last term is the float32 rounding of A^T A, which
    the port (and JAX's patched eigh) solves from: it grows as the two
    smallest eigenvalues of the unit-trace A^T A close up (a joint whose
    views barely disagree, or one confidence near 0), measured at ≤ 2.2e-10
    mm / gap.  Held per side: the two sides' detections differ by float32
    rounding (checked apart), which such a joint amplifies."""
    ref, gap = dlt64(kp2d, projs, weights)
    err = np.linalg.norm(np.asarray(kp3d, np.float64) - ref, axis=-1)
    limit = 0.5 + 1e-4 * np.linalg.norm(ref, axis=-1) + 2e-9 / gap
    assert (err <= limit).all(), (err.max(), (err / limit).max())


def assert_2d_matches(got, want, scale=1.0):
    """2D keypoints within 1e-3 heatmap px (``scale``: alg and ransac
    report them at the nets' 640x480 default)."""
    np.testing.assert_allclose(got.keypoints_2d.numpy() / scale,
                               np.asarray(want.keypoints_2d) / scale, atol=1e-3)


@pytest.mark.parametrize("confidences", [False, True])
def test_alg_net_matches_jax(tiny_cfg, jax_eigh64, confidences):
    cfg = net_cfg(tiny_cfg, MODEL__ALG_CONFIDENCES=confidences)
    got, want, (_, _, _, projs) = run_both(cfg, "alg", seed=2)
    kp2d = np.asarray(want.keypoints_2d)
    assert np.median(kp2d.std(axis=(0, 1))) > 1.0         # sample- and view-dependent
    assert_2d_matches(got, want, ORIG_SCALE)
    np.testing.assert_allclose(got.heatmaps.numpy(), np.asarray(want.heatmaps), rtol=1e-2,
                               atol=1e-6)
    if confidences:
        # the head reads the backbone's features, 2e-4 apart in float32
        np.testing.assert_allclose(got.confidences.numpy(), np.asarray(want.confidences),
                                   atol=1e-4)
    else:
        assert got.confidences is None and want.confidences is None
    assert_exact_dlt(got.keypoints_3d.numpy(), got.keypoints_2d.numpy(), projs,
                     None if got.confidences is None else got.confidences.numpy())
    assert_exact_dlt(want.keypoints_3d, kp2d, projs,
                     None if want.confidences is None else np.asarray(want.confidences))


@pytest.mark.parametrize("views", [2, 3])
def test_ransac_net_matches_jax(tiny_cfg, jax_eigh64, views):
    """The 2D keypoints against JAX's; each side's 3D keypoints are its
    RANSAC's re-triangulation, held to the float64 DLT of its own
    detections with its own inlier mask (which inliers a hypothesis counts
    turns on reprojection errors that rounding moves)."""
    from hrnet_hand_pose_estimation_tpu.ops.geometry import triangulate_ransac as jax_ransac

    got, want, (_, _, _, projs) = run_both(net_cfg(tiny_cfg), "ransac", seed=3, b=2, v=views)
    assert_2d_matches(got, want, ORIG_SCALE)
    prj = np.broadcast_to(np.asarray(projs)[:, None], (2, 21, views, 3, 4))
    for kp3d, kp2d, ransac in ((got.keypoints_3d.numpy(), got.keypoints_2d.numpy(),
                                lambda p, q: triangulate_ransac(torch.from_numpy(p),
                                                                torch.from_numpy(q))),
                               (np.asarray(want.keypoints_3d), np.asarray(want.keypoints_2d),
                                lambda p, q: jax_ransac(jnp.asarray(p), jnp.asarray(q)))):
        pts = np.ascontiguousarray(np.swapaxes(kp2d, 1, 2))
        rec, inliers = ransac(pts, np.ascontiguousarray(prj))
        np.testing.assert_allclose(kp3d, np.asarray(rec), rtol=1e-5, atol=1e-4)
        assert_exact_dlt(kp3d, kp2d, projs, np.swapaxes(np.asarray(inliers, np.float64), 1, 2))


def jax_vol_from_base(jm, variables, imgs, projs, base):
    """The JAX volumetric net's stages after the base point, run by the JAX
    package's own functions from ``base``: (coord volumes, probability
    volumes, 3D keypoints, confidences)."""
    from hrnet_hand_pose_estimation_tpu.ops import volumetric as JV

    out, inter = jm.apply(variables, imgs, projs, False, capture_intermediates=True,
                          mutable=["intermediates"])
    feats = inter["intermediates"]["process_features"]["__call__"][0]
    b, v = imgs.shape[:2]
    base = jnp.asarray(base)
    coords = JV.rotate_coord_volume(JV.build_coord_volume(base, jm.cuboid_size, jm.volume_size),
                                    jnp.zeros((b,)), (0, 1, 0), center=base)
    vols = JV.unproject_heatmaps(feats.reshape(b, v, *feats.shape[1:]), projs, coords,
                                 aggregation=jm.aggregation, vol_confidences=out.confidences)
    vols = JaxV2V(jm.num_joints, dtype=jm.dtype).apply(
        {c: variables[c]["volume_net"] for c in ("params", "batch_stats")}, vols, False)
    kp3d, probs = JV.integrate_volumes_with_coordinates(vols * jm.volume_multiplier, coords,
                                                        softmax=jm.volume_softmax)
    return np.asarray(coords), np.asarray(probs), np.asarray(kp3d)


@pytest.mark.parametrize("aggregation,confidences", [("softmax", False), ("conf", True)])
def test_vol_net_matches_jax(tiny_cfg, jax_eigh64, aggregation, confidences):
    """float32.  Each side's base point against the float64 DLT of its own
    joint-9 detections; everything after it against the JAX stages run
    from the port's base point (the cube moves with the base, and the
    base with the detections' rounding): the cube to 1e-3 mm, the
    probability volumes to 1 % relative, the 3D keypoints to 0.2 mm (1.5 %
    of this 400 mm / 32 cube's 12.9 mm voxel)."""
    cfg = net_cfg(tiny_cfg, MODEL__VOLUME_AGGREGATION_METHOD=aggregation,
                  MODEL__VOL_CONFIDENCES=confidences)
    got, want, ctx = run_both(cfg, "vol", seed=4)
    projs = ctx[3]
    assert_2d_matches(got, want)
    for side in (got, want):
        kp2d = np.asarray(side.keypoints_2d)[:, :, 9:10]
        assert_exact_dlt(np.asarray(side.base_points)[:, None], kp2d, projs)
    coords, probs, kp3d = jax_vol_from_base(*ctx, got.base_points.numpy())
    np.testing.assert_allclose(got.coord_volumes.numpy(), coords, atol=1e-3)
    # the JAX package's limit for a 32^3 volume (tests/test_triangulation_models.py)
    np.testing.assert_allclose(got.volumes.double().sum(dim=(1, 2, 3)).numpy(), 1.0, atol=1e-4)
    np.testing.assert_allclose(got.volumes.numpy(), probs, rtol=1e-2, atol=1e-7)
    assert kp3d.std(axis=1).min() > 1.0                       # joints spread in the cuboid
    np.testing.assert_allclose(got.keypoints_3d.numpy(), kp3d, atol=0.2)
    if confidences:
        # the head reads the backbone's features, 2e-4 apart in float32
        np.testing.assert_allclose(got.confidences.numpy(), np.asarray(want.confidences),
                                   atol=1e-4)
    else:
        assert got.confidences is None


def test_vol_net_bf16_v2v_matches_jax(tiny_cfg, jax_eigh64):
    """The volumetric net's default bfloat16 process_features and V2V: a
    random V2V amplifies bf16 rounding (its 3D keypoints move by up to ~100
    mm between the frameworks), so each side's bf16 stages are held to the
    port's float32 net on the same weights and base point, as a witness:
    the port's bf16 keypoints no farther from it than twice JAX's bf16
    ones, in median and in max, plus 1 mm."""
    cfg = net_cfg(tiny_cfg)
    got, _, ctx = run_both(cfg, "vol", seed=5, dtype=(jnp.bfloat16, torch.bfloat16))
    _, variables, imgs, projs = ctx
    with torch.no_grad():
        f32 = port_net(cfg, "vol", variables)(torch.from_numpy(np.array(imgs)),
                                              torch.from_numpy(np.array(projs)))
    assert torch.equal(f32.base_points, got.base_points)
    _, _, jax_bf16 = jax_vol_from_base(*ctx, got.base_points.numpy())
    d_port = np.linalg.norm(got.keypoints_3d.numpy() - f32.keypoints_3d.numpy(), axis=-1)
    d_jax = np.linalg.norm(jax_bf16 - f32.keypoints_3d.numpy(), axis=-1)
    assert np.median(d_port) <= 2 * np.median(d_jax) + 1.0
    assert d_port.max() <= 2 * d_jax.max() + 1.0


def test_bridge_is_strict(tiny_cfg):
    cfg = net_cfg(tiny_cfg)
    rng = np.random.default_rng(6)
    _, variables, _, _ = jax_net(cfg, "vol", rng)
    model = build_triangulation_net(config_from_dict(cfg.to_dict()), "vol")
    stray = {c: dict(t) for c, t in variables.items()}
    stray["params"]["volume_net"] = dict(stray["params"]["volume_net"], extra={"kernel": np.ones(3)})
    with pytest.raises(KeyError, match="volume_net/extra"):
        from_jax_variables(stray, model)
    missing = {c: dict(t) for c, t in variables.items()}
    missing["params"] = {k: v for k, v in missing["params"].items() if k != "process_features"}
    with pytest.raises(KeyError, match="process_features"):
        from_jax_variables(missing, model)


def test_registry_and_seeded_weights(tiny_cfg):
    """``pose_hrnet_volumetric`` is registered with its confidence head, and
    ``init_variables`` fills every key of each net and of that model."""
    cfg = config_from_dict(net_cfg(tiny_cfg, MODEL__NAME="pose_hrnet_volumetric",
                                   MODEL__VOL_CONFIDENCES=True).to_dict())
    model = build_model(cfg)
    assert model.confidence_kind == "vol"
    model.load_state_dict(init_variables(cfg, 0))
    for kind in ("alg", "vol"):
        net = build_triangulation_net(cfg, kind)
        net.load_state_dict(init_variables(cfg, 0, net=kind))
    net = build_triangulation_net(cfg, "vol_CPM")
    assert type(net.backbone).__name__ == "CPMVolumetric"
    net.load_state_dict(init_variables(cfg, 0, net="vol_CPM"))
