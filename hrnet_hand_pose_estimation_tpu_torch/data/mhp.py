"""CPM helpers of the MHP readers.

Port of the CPM part of the JAX package's ``data/mhp.py:284-316``
(reference MHP_CPMDataset.py:171-227): the hand centre, the sigma-3 centre
map at input resolution and CPM's image normalisation.  The synthetic set
(``data/synthetic.py``) uses the centre map for its CPM samples; the MHP
reader classes come with the dataset readers (ROADMAP A10).
"""

from __future__ import annotations

import numpy as np


def _cpm_center(pose2d: np.ndarray, h: int, w: int) -> np.ndarray:
    """Hand centre as the midpoint of the in-frame coordinate extents
    (falls back to the image centre on an axis with no joint in frame)."""

    def mid(vals, lim):
        hi = vals[vals < lim]
        lo = vals[vals > 0]
        if hi.size == 0 or lo.size == 0:
            return lim / 2.0
        return float(hi.max() + lo.min()) / 2.0

    return np.array([mid(pose2d[:, 0], w), mid(pose2d[:, 1], h)], np.float32)


def _cpm_centermap_np(center: np.ndarray, res: int) -> np.ndarray:
    """(res, res, 1) sigma-3 centre map, clipped to <= 1 and zeroed below 0.0099."""
    g = np.arange(res, dtype=np.float32)
    d2 = (g[None, :] - center[0]) ** 2 + (g[:, None] - center[1]) ** 2
    m = np.exp(-d2 / (2.0 * 3.0 * 3.0))
    m[m > 1] = 1
    m[m < 0.0099] = 0
    return m[..., None].astype(np.float32)


def cpm_normalize(img: np.ndarray) -> np.ndarray:
    """CPM's image normalisation: (x - 128) / 256 on the raw 0-255 image."""
    return (np.asarray(img, np.float32) - 128.0) / 256.0
