"""The port's image ops (ops/image.py, ops/volumetric.bilinear_sample_nhwc),
its numpy transform chain (data/transforms.py) and its dataset factory
(data/build.py) against the JAX package's, on the same numpy inputs.

The JAX chain warps with cv2.warpAffine; the port's ``warp_affine`` is
numpy.  Measured against cv2 5.0: bit-equal for the
identity affine of the eval path, and at most 1 gray level apart for the
augmented affines below (one pixel in a few thousand differs), which is
1 / (255 * 0.224) = 0.0175 after normalisation.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.data import build as JB
from hrnet_hand_pose_estimation_tpu.data import transforms as JT
from hrnet_hand_pose_estimation_tpu.ops import image as JI
from hrnet_hand_pose_estimation_tpu.ops.volumetric import bilinear_sample_nhwc as jax_sample
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.data import build as B
from hrnet_hand_pose_estimation_tpu_torch.data import transforms as T
from hrnet_hand_pose_estimation_tpu_torch.ops import image as I
from hrnet_hand_pose_estimation_tpu_torch.ops.volumetric import bilinear_sample_nhwc

torch.set_num_threads(1)


@pytest.fixture
def rng():
    """A fresh generator per test: drawing from conftest's shared ``rng``
    would shift the data of other test files in the same worker."""
    return np.random.default_rng(0)
GRAY = 1.0 / (255.0 * 0.224) + 1e-6     # one gray level after normalisation


@pytest.mark.parametrize("src, dst", [((37, 53), (64, 64)), ((16, 16), (64, 48)),
                                      ((80, 96), (32, 32)), ((64, 64), (48, 40)),
                                      ((30, 70), (64, 20))])
def test_resize_matches_jax(rng, src, dst):
    """Up- and downsampling (JAX antialiases when it shrinks): measured
    1.2e-7, held at 1e-6."""
    x = rng.uniform(0, 1, size=(2, *src, 3)).astype(np.float32)
    want = np.asarray(JI.resize_bilinear(jnp.asarray(x), dst))
    got = I.resize_bilinear(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_normalize_and_preprocess_match_jax(rng):
    u8 = rng.integers(0, 256, size=(2, 50, 70, 3)).astype(np.uint8)
    f = rng.uniform(0, 1, size=(2, 50, 70, 3)).astype(np.float32)
    for x in (u8, f):
        np.testing.assert_allclose(I.normalize(torch.from_numpy(x)).numpy(),
                                   np.asarray(JI.normalize(jnp.asarray(x))), atol=1e-6)
        np.testing.assert_allclose(I.preprocess_for_inference(torch.from_numpy(x), 64).numpy(),
                                   np.asarray(JI.preprocess_for_inference(jnp.asarray(x), 64)),
                                   atol=5e-6)


def test_affine_warp_and_sampler_match_jax(rng):
    """Batched inverse-affine warp (float32 inverse on both sides): 1e-5."""
    mats = np.stack([T.affine_matrix((30, 20), 0.3, (32, 32), 15)[:2],
                     T.affine_matrix((40, 25), 0.25, (32, 32), -30)[:2]]).astype(np.float32)
    x = rng.uniform(0, 1, size=(2, 50, 70, 3)).astype(np.float32)
    want = np.asarray(JI.affine_warp(jnp.asarray(x), jnp.asarray(mats), (32, 32)))
    got = I.affine_warp(torch.from_numpy(x), torch.from_numpy(mats), (32, 32)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    coords = rng.uniform(-2, 72, size=(2, 40, 2)).astype(np.float32)
    np.testing.assert_allclose(
        bilinear_sample_nhwc(torch.from_numpy(x), torch.from_numpy(coords)).numpy(),
        np.asarray(jax_sample(jnp.asarray(x), jnp.asarray(coords))), atol=1e-6)


def test_matrix_helpers_match_jax(rng):
    for args in (((32, 32), 0.32, (64, 64), 0.0), ((40, 30), 0.5, (256, 256), 33.0)):
        np.testing.assert_array_equal(T.affine_matrix(*args), JT.affine_matrix(*args))
    j = rng.uniform(0, 64, size=(21, 2))
    mat = T.affine_matrix((32, 32), 0.4, (16, 16), -20.0)[:2]
    np.testing.assert_array_equal(T.affine_joints(j, mat), JT.affine_joints(j, mat))
    assert T.FLIP_INDEX == JT.FLIP_INDEX
    img = rng.normal(size=(8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(T.denormalize_image(img), JT.denormalize_image(img))


@pytest.mark.parametrize("seed", range(4))
def test_warp_affine_matches_cv2(rng, seed):
    """uint8: the identity bit-equal; random rotations/scales/shifts within
    one gray level (on at most 0.5 % of the pixels); float within 1e-5."""
    g = np.random.default_rng(seed)
    img = g.integers(0, 256, size=(64, 80, 3)).astype(np.uint8)
    ident = T.affine_matrix((40, 32), 64 / 200, (64, 64))[:2]
    np.testing.assert_array_equal(T.warp_affine(img[:, :64], ident, (64, 64)),
                                  cv2.warpAffine(img[:, :64], ident, (64, 64)))
    mat = T.affine_matrix(g.uniform(30, 50, size=2), g.uniform(0.2, 0.5), (48, 48),
                          g.uniform(-45, 45))[:2]
    want = cv2.warpAffine(img, mat, (48, 48)).astype(int)
    got = T.warp_affine(img, mat, (48, 48)).astype(int)
    assert np.abs(got - want).max() <= 1
    assert (got != want).mean() <= 0.005
    f = img.astype(np.float32) / 255.0
    np.testing.assert_allclose(T.warp_affine(f, mat, (48, 48)), cv2.warpAffine(f, mat, (48, 48)),
                               atol=1e-5)


def _port_cfg(jcfg):
    return config_from_dict(jcfg.to_dict())


def _data_cfg(tiny_cfg, **extra):
    cfg = tiny_cfg.clone()
    cfg.DATASET.DATASET = ["Synthetic_kpt"]
    cfg.DATASET.TEST_DATASET = ["Synthetic_kpt"]
    cfg.TRAIN.IMAGES_PER_GPU = 8
    cfg.TEST.IMAGES_PER_GPU = 8
    cfg.WORKERS = 2
    for key, val in extra.items():
        cfg.merge_from_list([key.replace("__", "."), val])
    return cfg.freeze()


def test_eval_transforms_are_the_identity_and_match_jax(tiny_cfg, rng):
    """build_transforms(is_train=False) on a square image: the same image and
    joints as JAX's cv2 chain, bit for bit."""
    jcfg = _data_cfg(tiny_cfg)
    cfg = _port_cfg(jcfg)
    img = rng.integers(0, 256, size=(64, 64, 3)).astype(np.uint8)
    joints = [rng.uniform(0, 64, size=(21, 2)).astype(np.float32)]
    got_img, got_j = T.build_transforms(cfg, is_train=False)(img, joints)
    want_img, want_j = JT.build_transforms(jcfg, is_train=False)(img, joints)
    np.testing.assert_array_equal(got_img, want_img)
    np.testing.assert_array_equal(got_j[0], want_j[0])
    np.testing.assert_array_equal(got_img, T.normalize_image(img))


def test_augmented_transforms_match_jax_within_a_gray_level(tiny_cfg):
    """The training chain with every augmentation on, both sides drawing from
    generators with the same seed: the same joints, images within one gray
    level of JAX's cv2 warp."""
    jcfg = _data_cfg(tiny_cfg, WITH_DATA_AUG=True, DATASET__MAX_ROTATION=40.0,
                     DATASET__MIN_SCALE=0.7, DATASET__MAX_SCALE=1.3,
                     DATASET__MAX_TRANSLATE=20.0, DATASET__FLIP=True,
                     DATASET__SCALE_AWARE_SIGMA=True)
    cfg = _port_cfg(jcfg)
    tr = T.build_transforms(cfg, is_train=True, rng=np.random.default_rng(5))
    jtr = JT.build_transforms(jcfg, is_train=True, rng=np.random.default_rng(5))
    data = np.random.default_rng(9)
    worst = 0.0
    for _ in range(8):
        img = data.integers(0, 256, size=(72, 60, 3)).astype(np.uint8)
        joints = [np.concatenate([data.uniform(0, 60, size=(21, 2)),
                                  np.ones((21, 1)), np.full((21, 1), 2.0)], axis=1)]
        got_img, got_j = tr(img, joints)
        want_img, want_j = jtr(img, joints)
        np.testing.assert_array_equal(got_j[0], want_j[0])
        worst = max(worst, float(np.abs(got_img - want_img).max()))
    assert worst <= GRAY


@pytest.mark.parametrize("is_train", [True, False])
def test_synthetic_batches_match_jax(tiny_cfg, is_train):
    """make_dataloader's Synthetic_kpt batches equal the JAX package's at
    n_devices=1, key by key (train: shuffled by the same seed)."""
    jcfg = _data_cfg(tiny_cfg)
    cfg = _port_cfg(jcfg)
    got = B.make_dataloader(cfg, is_train=is_train)
    want = JB.make_dataloader(jcfg, is_train=is_train, n_devices=1)
    assert list(got) == list(want) == ["Synthetic_kpt"]
    gl, wl = got["Synthetic_kpt"], want["Synthetic_kpt"]
    assert (len(gl), gl.batch_size, gl.shuffle, gl.drop_last) == \
        (len(wl), wl.batch_size, wl.shuffle, wl.drop_last)
    assert gl.dataset.rescale == wl.dataset.rescale == "crop_corner"
    for gb, wb in zip(gl, wl):
        assert sorted(gb) == sorted(wb)
        for key in gb:
            np.testing.assert_array_equal(gb[key], wb[key], err_msg=key)
    test = B.make_test_dataloader(cfg)["Synthetic_kpt"]
    assert not test.shuffle and not test.drop_last


def test_registry_covers_jax_names_and_unported_readers_raise(tiny_cfg, tmp_path):
    """Every name of the JAX registry is registered, and each builds from a
    tiny tree of its format (``tests/torch_reader_trees.py``) and gives an
    item with its images and 2D poses: no reader is missing any more.
    ``FHA`` and ``HandGraph``, which YAMLs name as test sets, are in neither
    registry and raise KeyError in both packages (ROADMAP C25)."""
    import torch_reader_trees

    torch_reader_trees.write_all(tmp_path, "evaluation")
    jcfg = _data_cfg(tiny_cfg, DATA_DIR=str(tmp_path), DATASET__NUM_VIEWS=2,
                     DATASET__SEQ_IDX=[-1, 0, 1], DATASET__STRIDE=1)
    cfg = _port_cfg(jcfg)
    assert sorted(B._DATASETS) == sorted(JB._lazy_registry())
    for name in sorted(B._DATASETS):
        ds = B.build_dataset(cfg, name, is_train=False)
        assert len(ds) > 0, name
        item = ds[0]
        assert item["imgs"].ndim >= 3 and item["pose2d"].shape[-1] == 2, name
        assert type(ds).__name__ == type(JB.build_dataset(jcfg, name, is_train=False)).__name__
    mv = B.build_dataset(cfg, "Synthetic_mv", is_train=True)
    assert len(mv) > 0 and mv[0]["imgs"].shape[0] == int(cfg.DATASET.NUM_VIEWS)
    for name in ("nope", "FHA", "HandGraph"):
        with pytest.raises(KeyError, match="Unknown dataset"):
            B.build_dataset(cfg, name, is_train=True)
        with pytest.raises(KeyError, match="Unknown dataset"):
            JB.build_dataset(jcfg, name, is_train=True)


def test_heatmap_generator_matches_jax(rng):
    joints = np.concatenate([rng.uniform(-2, 18, size=(21, 2)),
                             (rng.uniform(size=(21, 1)) > 0.3)], axis=1).astype(np.float32)
    for sigma in (-1, 1.5):
        got = B.HeatmapGeneratorFn(16, 21, sigma)
        want = JB.HeatmapGeneratorFn(16, 21, sigma)
        assert got.sigma == want.sigma
        np.testing.assert_array_equal(got(joints), want(joints))
        np.testing.assert_array_equal(got(joints[:, :2], joints[:, 2]),
                                      want(joints[:, :2], joints[:, 2]))

