"""The 21-joint hand legend: the joint names, each dataset's reordering
into them, and the bone tables the 2D losses and the skeleton overlay use.

The port's own copy of the JAX package's ``data/legends.py`` (numpy only):
the standard joint order and the reorder index tables of the readers
(reference standard_legends.py:4-35), the kinematic-chain incidence matrix,
the anatomical (parent, child) bone pairs, and the reference-faithful bone
chain of ``BoneLengthLoss``.
"""

from __future__ import annotations

import numpy as np

STD_LEGEND = (
    "wrist",
    "thumb palm", "thumb near palm", "thumb near tip", "thumb tip",
    "index palm", "index near palm", "index near tip", "index tip",
    "middle palm", "middle near palm", "middle near tip", "middle tip",
    "ring palm", "ring near palm", "ring near tip", "ring tip",
    "pinky palm", "pinky near palm", "pinky near tip", "pinky tip",
)

NUM_JOINTS = 21

# each dataset's native joint order -> the standard legend
IDX_RHD = np.array([0, 4, 3, 2, 1, 8, 7, 6, 5, 12, 11, 10, 9, 16, 15, 14, 13, 20, 19, 18, 17])
IDX_FREI = np.arange(21)
IDX_HANDGRAPH = IDX_FREI
IDX_FHA = IDX_FREI
IDX_MHP = np.array([20, 17, 16, 18, 19, 1, 0, 2, 3, 5, 4, 6, 7, 13, 12, 14, 15, 9, 8, 10, 11])


def _kc_matrix() -> np.ndarray:
    """20x21 bone incidence matrix (reference standard_legends.py:38-42).

    Row k encodes bone k as child minus parent; fingers chain from the wrist:
    bones {0,4,8,12,16} attach to joint 0, every other bone k links k -> k+1.
    """
    kc = np.zeros((20, 21), dtype=np.float32)
    rows = np.arange(20)
    kc[rows, rows + 1] = 1.0
    finger_roots = rows % 4 == 0
    kc[rows[finger_roots], 0] = -1.0
    kc[rows[~finger_roots], rows[~finger_roots]] = -1.0
    return kc


KC_MATRIX = _kc_matrix()

# (parent, child) joint-index pairs for the 20 bones; anatomical chain (what
# KC_MATRIX encodes): each finger roots at the wrist.
BONE_PARENTS = np.array([0 if j % 4 == 1 else j - 1 for j in range(1, 21)], dtype=np.int32)
BONE_CHILDREN = np.arange(1, 21, dtype=np.int32)

# Reference-faithful chain for BoneLengthLoss: the reference's wrist branch
# (lib/core/loss.py:167, `if joint_idx == finger_idx`) is unreachable, so
# every bone is taken between consecutive joint indices, including the
# cross-finger bones 5-4, 9-8, 13-12 and 17-16.
BONE_PARENTS_REF = np.arange(0, 20, dtype=np.int32)
