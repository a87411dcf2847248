"""The 21-joint hand legend's bone tables, as the 2D losses and the
skeleton overlay use them.

The port's own copy of the JAX package's ``data/legends.py:43-73`` (numpy
only): the kinematic-chain incidence matrix, the anatomical (parent, child)
bone pairs, and the reference-faithful bone chain of ``BoneLengthLoss``.
"""

from __future__ import annotations

import numpy as np


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
