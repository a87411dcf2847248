"""Comparison helpers of the reader tests: a port item or batch against
the JAX package's, key by key."""

from pathlib import Path

import numpy as np

REPO_EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
GRAY = 1.0 / (255.0 * 0.224) + 1e-6     # one gray level after normalisation
IMAGE_KEYS = ("imgs", "orig_imgs")


def assert_items_match(got, want, images: str = "equal", label: str = "") -> None:
    """Same keys, shapes and dtypes; the decoded frames ('orig_imgs')
    bit-equal; the model inputs ('imgs') bit-equal (``images="equal"``) or
    within one gray level (``"gray"``: the numpy warp against cv2's); every
    other array within 1e-6; strings and lists equal."""
    assert sorted(got) == sorted(want), label
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, (str, list)):
            assert g == w, f"{label} {key}"
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, \
            f"{label} {key}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}"
        if w.dtype.kind in "US":
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {key}")
        elif key == "imgs" and images == "gray":
            assert np.abs(g.astype(np.float64) - w).max() <= GRAY, f"{label} {key}"
        elif key in IMAGE_KEYS:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {key}")
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f"{label} {key}")


def port_cfg(jcfg):
    from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict

    return config_from_dict(jcfg.to_dict())


def yaml_cfg(path, data_dir, batch: int = 2, **extra):
    """A shipped YAML for both packages: (JAX cfg, port cfg) with DATA_DIR,
    WORKERS 0, ``batch`` a step and the ``extra`` KEY__SUB=value overrides."""
    from hrnet_hand_pose_estimation_tpu.config import load_config

    jcfg = load_config(str(path), freeze=False)
    jcfg.DATA_DIR = str(data_dir)
    jcfg.WORKERS = 0
    jcfg.TRAIN.IMAGES_PER_GPU = batch
    jcfg.TEST.IMAGES_PER_GPU = batch
    for key, val in extra.items():
        jcfg.merge_from_list([key.replace("__", "."), val])
    jcfg.freeze()
    return jcfg, port_cfg(jcfg)


def first_batches_match(jcfg, cfg, is_train: bool, images: str = "gray") -> dict:
    """make_dataloader of both packages: the same loader names, lengths and
    first batch (JAX at n_devices=1); returns the port's first batches.
    Each package's transform chain draws its augmentation from a generator
    of the same seed (the registries build it with an unseeded one)."""
    from unittest import mock

    from hrnet_hand_pose_estimation_tpu.data import build as JB
    from hrnet_hand_pose_estimation_tpu_torch.data import build as B

    with mock.patch.object(B, "build_transforms", _seeded(B.build_transforms)), \
            mock.patch.object(JB, "build_transforms", _seeded(JB.build_transforms)):
        got = B.make_dataloader(cfg, is_train=is_train)
        want = JB.make_dataloader(jcfg, is_train=is_train, n_devices=1)
    assert list(got) == list(want)
    out = {}
    for name in want:
        assert len(got[name]) == len(want[name]) > 0, name
        gb, wb = next(iter(got[name])), next(iter(want[name]))
        assert_items_match(gb, wb, images, label=name)
        out[name] = gb
    return out


def _seeded(build_transforms):
    def build(cfg, is_train=True, rng=None):
        return build_transforms(cfg, is_train, rng=np.random.default_rng(7))
    return build
