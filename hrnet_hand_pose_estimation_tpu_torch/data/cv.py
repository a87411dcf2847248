"""The image helpers of the dataset readers, in numpy (the card's machine has
no cv2).

The JAX package's readers call cv2 for these; each function here gives what
that cv2 call gives (``tests/test_torch_readers_image.py`` holds them to
cv2 5.0):

- ``bgr_to_rgb``: ``cv2.cvtColor`` with COLOR_BGR2RGB (or RGB2BGR: the
  swap is its own inverse);
- ``rodrigues``: ``cv2.Rodrigues`` of a rotation vector, in float64;
- ``circle_filled``: ``cv2.circle(img, center, radius, color, -1)``, the
  filled integer circle of OpenCV's ``Circle`` (imgproc/src/drawing.cpp, the
  path of LINE_8 with shift 0), bit for bit, clipped at the borders;
- ``resize``: ``cv2.resize(img, (w, h))`` with INTER_LINEAR for uint8, in
  cv2's fixed-point arithmetic.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

RESIZE_COEF_BITS = 11           # cv2's INTER_RESIZE_COEF_BITS
RESIZE_COEF_SCALE = 1 << RESIZE_COEF_BITS


def bgr_to_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) BGR -> RGB (or back), a new contiguous array."""
    return np.ascontiguousarray(img[..., ::-1])


def rodrigues(rvec) -> np.ndarray:
    """Rotation vector (3,), (3, 1) or (1, 3) -> (3, 3) float64 rotation:
    ``cos t I + (1 - cos t) r r^T + sin t [r]x`` with r the unit axis, as
    cv2.Rodrigues computes it (the identity below machine epsilon)."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = float(np.sqrt(r @ r))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = np.cos(theta), np.sin(theta)
    rx, ry, rz = r / theta
    rrt = np.array([[rx * rx, rx * ry, rx * rz], [rx * ry, ry * ry, ry * rz],
                    [rx * rz, ry * rz, rz * rz]])
    r_x = np.array([[0.0, -rz, ry], [rz, 0.0, -rx], [-ry, rx, 0.0]])
    return c * np.eye(3) + (1.0 - c) * rrt + s * r_x


def circle_half_widths(radius: int) -> np.ndarray:
    """(radius + 1,) half-widths of OpenCV's filled circle by row offset.

    OpenCV's midpoint loop draws, for each (dx, dy) it visits, the spans
    ``cx -+ dx`` on rows ``cy -+ dy`` and ``cx -+ dy`` on rows ``cy -+ dx``.
    Every span is centred on cx, so a row's union is its widest span."""
    hw = np.full(radius + 1, -1, np.int64)
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        hw[dy] = max(hw[dy], dx)
        hw[dx] = max(hw[dx], dy)
        dy += 1
        err += plus
        plus += 2
        mask = int(err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return hw


def circle_filled(img: np.ndarray, center: Sequence[int], radius: int, color) -> np.ndarray:
    """Fill OpenCV's integer circle into ``img`` (H, W[, C]) in place and
    return it."""
    cx, cy = (int(v) for v in center)
    radius = int(radius)
    if radius < 0:
        raise ValueError(f"negative radius {radius}")
    h, w = img.shape[:2]
    hw = circle_half_widths(radius)
    y0, y1 = max(cy - radius, 0), min(cy + radius, h - 1)
    if y0 > y1:
        return img
    ys = np.arange(y0, y1 + 1)
    half = hw[np.abs(ys - cy)]
    xs = np.arange(w)
    mask = np.abs(xs[None, :] - cx) <= half[:, None]
    color = np.asarray(color, img.dtype).reshape(-1)
    img[y0:y1 + 1][mask] = color[:img.shape[2]] if img.ndim == 3 else color[0]
    return img


def _linear_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2's INTER_LINEAR taps along one axis: the first source index, its
    clamped neighbour and the fixed-point weight pair, computed as cv2 does
    (the source position in float32, the weights rounded to 1/2048)."""
    scale = 1.0 / (dst / src)
    pos = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(pos)
    frac = (pos - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    frac[i0 < 0] = 0
    i0[i0 < 0] = 0
    last = i0 >= src - 1
    frac[last] = 0
    i0[last] = src - 1
    w1 = np.rint(frac * np.float32(RESIZE_COEF_SCALE)).astype(np.int64)
    w0 = np.rint((np.float32(1) - frac) * np.float32(RESIZE_COEF_SCALE)).astype(np.int64)
    return i0, np.minimum(i0 + 1, src - 1), np.stack([w0, w1])


def resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` with INTER_LINEAR for a uint8 (H, W[, C])
    image; ``size`` is (width, height) as cv2 takes it.

    The horizontal pass sums the two taps into int32 at weight scale 2048;
    the vertical pass is cv2's vector path: each row sum shifted right by 4,
    the product's high 16 bits, the two added, then ``(s + 2) >> 2``."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize takes uint8 images, not {img.dtype}")
    out_w, out_h = (int(s) for s in size)
    h, w = img.shape[:2]
    x0, x1, ax = _linear_taps(w, out_w)
    y0, y1, ay = _linear_taps(h, out_h)
    src = img.astype(np.int64)
    shape = (1, out_w) + (1,) * (img.ndim - 2)
    rows = src[:, x0] * ax[0].reshape(shape) + src[:, x1] * ax[1].reshape(shape)
    rows >>= 4
    col = (out_h,) + (1,) * (img.ndim - 1)
    top = (rows[y0] * ay[0].reshape(col)) >> 16
    bot = (rows[y1] * ay[1].reshape(col)) >> 16
    return np.clip((top + bot + 2) >> 2, 0, 255).astype(np.uint8)
