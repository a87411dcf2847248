"""Dataset factory: string names -> loaders, multi-dataset training dict.

Port of the JAX package's ``data/build.py`` (reference
lib/dataset/build.py:32-129).  An explicit registry maps the names the
experiment YAMLs use.  ``make_dataloader`` returns a {name: DataLoader} dict
for joint multi-dataset training like the reference (build.py:66-97).

The batch is ``IMAGES_PER_GPU`` for one device: the JAX package multiplies
it by ``jax.local_device_count()``; multi-GPU data parallelism is ROADMAP
A11.  The port has the synthetic 2D dataset so far: every other registered
name raises ``NotImplementedError`` naming the ROADMAP item that ports its
reader.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ..ops.targets import gaussian_targets_np
from .pipeline import DataLoader
from .synthetic import SyntheticDataset
from .transforms import build_transforms


class HeatmapGeneratorFn:
    """Callable target generator bound to (res, sigma) -- the role of the
    reference HeatmapGenerator instance (target_generators.py:15-53)."""

    def __init__(self, output_res: int, num_joints: int = 21, sigma: float = -1):
        self.output_res = int(output_res)
        self.num_joints = num_joints
        self.sigma = float(sigma) if sigma > 0 else self.output_res / 64 * 2.0

    def __call__(self, joints: np.ndarray, visibility: Optional[np.ndarray] = None):
        if visibility is None:  # the reference packs vis as the 3rd joint column
            visibility = joints[:, 2] if joints.shape[1] > 2 else np.ones(len(joints))
        return gaussian_targets_np(joints[:, :2], visibility, self.output_res, self.sigma)


_DATASETS: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(fn):
        _DATASETS[name] = fn
        return fn
    return deco


def _not_ported(name: str, item: str) -> Callable:
    def build(cfg, subset, hm_gen, transforms):
        raise NotImplementedError(f"dataset {name!r}: its reader is not ported yet "
                                  f"(ROADMAP {item})")
    return build


# keypoint datasets take (cfg, subset, heatmap_generator, transforms); the
# raw eval datasets of the reference's evaluate_2D.py take the same here
register_dataset("Synthetic_kpt")(SyntheticDataset)
register_dataset("Synthetic")(
    lambda cfg, subset, hm, tr: SyntheticDataset(cfg, subset, hm, tr))
for _name in ("RHD_kpt", "RHD_twohands_kpt", "RHD_fullframe_kpt", "Frei_kpt", "FreiHand_kpt",
              "MHP_kpt", "HandGraph_kpt", "FHA_kpt", "MHP_CPM_kpt", "MHP_CPM_mv", "MHP_mv",
              "MHP_seq", "COCO", "MPII", "RHD", "RHD_twohands", "Frei", "FreiHand", "MHP",
              "Panoptic", "Panoptic_kpt", "STB"):
    register_dataset(_name)(_not_ported(_name, "A10"))
# the calibrated multi-view synthetic set belongs to the 3D stack
register_dataset("Synthetic_mv")(_not_ported("Synthetic_mv", "A9"))


def build_dataset(cfg, name: str, is_train: bool):
    """One dataset by name (reference build.py:32-63)."""
    if name not in _DATASETS:
        raise KeyError(f"Unknown dataset {name!r}. Registered: {sorted(_DATASETS)}")
    subset = cfg.DATASET.TRAIN_SET if is_train else cfg.DATASET.TEST_SET
    transforms = build_transforms(cfg, is_train=is_train)
    hm_gen = HeatmapGeneratorFn(int(cfg.MODEL.HEATMAP_SIZE[0]),
                                int(cfg.DATASET.NUM_JOINTS),
                                float(cfg.MODEL.SIGMA))
    return _DATASETS[name](cfg, subset, hm_gen, transforms)


def make_dataloader(cfg, is_train: bool = True) -> Dict[str, DataLoader]:
    """{name: DataLoader} dict for joint multi-dataset training
    (reference build.py:66-97), one device's batch."""
    batch = int(cfg.TRAIN.IMAGES_PER_GPU if is_train else cfg.TEST.IMAGES_PER_GPU)
    names = list(cfg.DATASET.DATASET if is_train else cfg.DATASET.TEST_DATASET)
    loaders = {}
    for name in names:
        ds = build_dataset(cfg, name, is_train)
        loaders[name] = DataLoader(
            ds, batch_size=batch,
            shuffle=bool(cfg.TRAIN.SHUFFLE) and is_train,
            drop_last=is_train,
            num_workers=int(cfg.WORKERS),
            seed=int(cfg.TPU.SEED) if "TPU" in cfg else 0,
        )
    return loaders


def make_test_dataloader(cfg) -> Dict[str, DataLoader]:
    """Test loaders (reference build.py:100-129)."""
    return make_dataloader(cfg, is_train=False)
