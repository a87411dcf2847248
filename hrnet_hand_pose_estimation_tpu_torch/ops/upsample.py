"""Resolution-exchange upsampling for NHWC feature maps, in PyTorch.

Port of the JAX package's ``ops/upsample.py``:
- nearest x2^k inside the fuse layers (reference pose_hrnet.py:206);
- bilinear ``align_corners=True`` in the head (:500-502), as two dense
  interpolation matrices contracted with einsum.  The matrices keep the
  JAX package's ``lo = min(floor(pos), src - 2)`` rule, so the last output
  sample weights ``src - 2`` by 0 and ``src - 1`` by 1.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour integer upsampling for (B, H, W, C)."""
    if factor == 1:
        return x
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


@lru_cache(maxsize=None)
def align_corners_matrix(src: int, dst: int) -> np.ndarray:
    """Dense (dst, src) linear-interpolation matrix with align_corners=True.

    out[i] = sum_j W[i, j] * in[j], where the sample position of output i is
    ``i * (src - 1) / (dst - 1)`` (torch F.interpolate align_corners=True).
    The returned array is read-only: callers share it.
    """
    if src == 1:
        w = np.ones((dst, 1), dtype=np.float32)
    else:
        pos = np.arange(dst, dtype=np.float64) * (src - 1) / (dst - 1)
        lo = np.minimum(np.floor(pos).astype(np.int64), src - 2)
        frac = pos - lo
        w64 = np.zeros((dst, src), dtype=np.float64)
        w64[np.arange(dst), lo] = 1.0 - frac
        w64[np.arange(dst), lo + 1] = frac
        w = w64.astype(np.float32)
    w.flags.writeable = False
    return w


@lru_cache(maxsize=32)
def _device_matrix(src: int, dst: int, device: torch.device) -> torch.Tensor:
    """``align_corners_matrix`` on ``device``, copied there once (a copy
    from pageable host memory per call would wait for the device)."""
    return torch.from_numpy(align_corners_matrix(src, dst).copy()).to(device)


def upsample_bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear align_corners=True resize of (B, H, W, C) to ``out_hw``,
    computed in float32 (also under autocast, as the JAX package computes
    it at HIGHEST precision) and returned in the input's dtype."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    wh = _device_matrix(h, oh, x.device)
    ww = _device_matrix(w, ow, x.device)
    with torch.autocast(x.device.type, enabled=False):
        y = torch.einsum("Hh,bhwc->bHwc", wh, x.float())
        y = torch.einsum("Ww,bHwc->bHWc", ww, y)
    return y.to(x.dtype)
