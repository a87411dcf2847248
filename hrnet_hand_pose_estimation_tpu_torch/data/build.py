"""Dataset factory: string names -> loaders, multi-dataset training dict.

Port of the JAX package's ``data/build.py`` (reference
lib/dataset/build.py:32-129).  An explicit registry maps the names the
experiment YAMLs use.  ``make_dataloader`` returns a {name: DataLoader} dict
for joint multi-dataset training like the reference (build.py:66-97).

The batch is ``IMAGES_PER_GPU`` for one device: the JAX package multiplies
it by ``jax.local_device_count()``; multi-GPU data parallelism is ROADMAP
A11.  Every name of the JAX package's registry is registered, with the same
reader; ``FHA`` and ``HandGraph``, which some YAMLs name as their test set,
are in neither registry and raise ``KeyError`` (ROADMAP C25).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ..ops.targets import gaussian_targets_np
from .coco_mpii import COCOKeypointsDataset, MPIIDataset
from .fha import FHADatasetKeypoints
from .freihand import FreiHandDataset, FreiHandDatasetKeypoints
from .handgraph import HandGraphDatasetKeypoints
from .mhp import (MHPCPMDataset, MHPCPMMultiViewDataset, MHPDataset, MHPDatasetKeypoints,
                  MHPMultiViewDataset, MHPSeqDataset)
from .pipeline import DataLoader
from .rhd import (RHDDataset, RHDDatasetKeypoints, RHDFullFrameDataset,
                  RHDFullFrameDatasetKeypoints)
from .stb import STBDataset
from .synthetic import SyntheticDataset, SyntheticMultiViewDataset
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


def _raw(cls) -> Callable:
    """The raw evaluation readers take (root, subset, data format, transforms)."""
    def build(cfg, subset, hm_gen, transforms):
        return cls(cfg.DATA_DIR, subset, cfg.DATASET.DATA_FORMAT, transforms)
    return build


def _human_pose(cls) -> Callable:
    def build(cfg, subset, hm_gen, transforms):
        return cls(cfg.DATA_DIR, subset, transforms, int(cfg.MODEL.HEATMAP_SIZE[0]),
                   float(cfg.MODEL.SIGMA))
    return build


_DATASETS.update({
    # keypoint readers take (cfg, subset, heatmap_generator, transforms)
    "RHD_kpt": RHDDatasetKeypoints,
    # the full-frame variant (the reference *_twohands readers' live path)
    "RHD_twohands_kpt": RHDFullFrameDatasetKeypoints,
    "RHD_fullframe_kpt": RHDFullFrameDatasetKeypoints,
    "Frei_kpt": FreiHandDatasetKeypoints,
    "FreiHand_kpt": FreiHandDatasetKeypoints,
    "MHP_kpt": MHPDatasetKeypoints,
    "HandGraph_kpt": HandGraphDatasetKeypoints,
    "FHA_kpt": FHADatasetKeypoints,
    "Synthetic_kpt": SyntheticDataset,
    # CPM variants: (K+1)-channel background targets + centre maps
    "MHP_CPM_kpt": MHPCPMDataset,
    "MHP_CPM_mv": MHPCPMMultiViewDataset,
    # multi-view and sequence readers
    "MHP_mv": MHPMultiViewDataset,
    "MHP_seq": MHPSeqDataset,
    # the calibrated multi-view synthetic set of the 3D stack
    "Synthetic_mv": SyntheticMultiViewDataset,
    # the upstream human-pose sets
    "COCO": _human_pose(COCOKeypointsDataset),
    "MPII": _human_pose(MPIIDataset),
    # raw evaluation readers (the reference's evaluate_2D.py uses the non-kpt class)
    "RHD": _raw(RHDDataset),
    "RHD_twohands": _raw(RHDFullFrameDataset),
    "Frei": _raw(FreiHandDataset),
    "FreiHand": _raw(FreiHandDataset),
    "MHP": _raw(MHPDataset),
    # the reference's PanopticDataset.py is a verbatim copy of the MHP class
    "Panoptic": _raw(MHPDataset),
    "Panoptic_kpt": MHPDatasetKeypoints,
    "STB": _raw(STBDataset),
    "Synthetic": lambda cfg, subset, hm, tr: SyntheticDataset(cfg, subset, hm, tr),
})


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
