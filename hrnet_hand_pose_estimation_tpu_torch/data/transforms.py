"""Host-side image/keypoint transform chain, in numpy.

Port of the JAX package's ``data/transforms.py`` (reference
lib/dataset/transforms/transforms.py:20-175 and build.py:35-80):

- the "no augmentation" path still runs the affine (scale=1, rot=0), which
  is an exact resize to the input size with joints scaled to each output
  size (the ``h = 200 * scale`` convention with scale = short_side/200);
- the flip only flips u coordinates (the reference's joint remap is
  commented out in its source, transforms.py:68);
- images come out float32 NHWC, ImageNet-normalised.

The JAX package warps with ``cv2.warpAffine``; the port's machines may have
no cv2, so ``warp_affine`` is numpy: cv2's geometry (output pixel (x, y)
samples the inverse-mapped source point, pixel centres at integers),
bilinear sampling, ``BORDER_CONSTANT`` 0, and uint8 rounded back to uint8
(half to even, saturated).  The inverse map is taken in float64.  Against
cv2 5.0 it is exact for the identity (the eval path of every square
dataset, whose scale is side/200 and centre side/2) and within one gray
level for augmented affines (``tests/test_torch_image_transforms.py``
measures it).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

# FLIP_CONFIG parity (reference transforms/build.py:15-33): the same table
# for every hand dataset; kept for API completeness, the remap is inert in
# the reference pipeline.
FLIP_INDEX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15, 17, 18, 19, 20]


def affine_matrix(center: Sequence[float], scale: float, res: Tuple[int, int],
                  rot: float = 0.0) -> np.ndarray:
    """3x3 affine with the reference's ``h = 200*scale`` convention
    (transforms.py:98-122).  res is (height, width)."""
    h = 200.0 * scale
    t = np.zeros((3, 3), np.float64)
    t[0, 0] = res[1] / h
    t[1, 1] = res[0] / h
    t[0, 2] = res[1] * (-float(center[0]) / h + 0.5)
    t[1, 2] = res[0] * (-float(center[1]) / h + 0.5)
    t[2, 2] = 1.0
    if rot != 0:
        rot = -rot
        rad = rot * np.pi / 180.0
        sn, cs = np.sin(rad), np.cos(rad)
        rot_mat = np.zeros((3, 3))
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        rot_mat[2, 2] = 1.0
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2
        t_mat[1, 2] = -res[0] / 2
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def affine_joints(joints: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to (..., 2) joints (transforms.py:125-131)."""
    shape = joints.shape
    flat = joints.reshape(-1, 2)
    hom = np.concatenate([flat, np.ones_like(flat[:, :1])], axis=1)
    return (hom @ mat.T).reshape(shape)


def warp_affine(image: np.ndarray, mat: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(image, mat, size)`` with its defaults (INTER_LINEAR,
    BORDER_CONSTANT 0) in numpy: HxWxC uint8/float image, 2x3 forward
    affine ``mat`` (source -> output pixels), ``size`` = (width, height) as
    cv2 takes it.  uint8 in, uint8 out; float in, float32 out."""
    out_w, out_h = (int(s) for s in size)
    full = np.vstack([np.asarray(mat, np.float64).reshape(2, 3), [0.0, 0.0, 1.0]])
    inv = np.linalg.inv(full)[:2]
    ys, xs = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)

    src = image.astype(np.float64)
    h, w = src.shape[:2]
    out = np.zeros((out_h, out_w, src.shape[2]), np.float64)
    for dy, dx, wt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                       (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
        xx = x0 + dx
        yy = y0 + dy
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        vals = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        out += vals * (wt * inside)[..., None]
    if image.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(np.float32)


class HandTransforms:
    """The full chain: affine warp -> optional u-flip -> normalise.

    __call__(image HxWx3 uint8/float, joints list of (K, >=2)) returns
    (float32 input_size x input_size x 3 normalised image, transformed joints
    list) -- joints[i] mapped into output_size[i] coordinates.
    """

    def __init__(
        self,
        input_size: int = 256,
        output_size: Sequence[int] = (64,),
        max_rotation: float = 0.0,
        min_scale: float = 1.0,
        max_scale: float = 1.0,
        scale_type: str = "short",
        max_translate: float = 0.0,
        flip_prob: float = 0.0,
        scale_aware_sigma: bool = False,
        rng: Optional[np.random.Generator] = None,
    ):
        self.input_size = int(input_size)
        self.output_size = [int(s) for s in output_size]
        self.max_rotation = float(max_rotation)
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)
        self.scale_type = scale_type
        self.max_translate = float(max_translate)
        self.flip_prob = float(flip_prob)
        self.scale_aware_sigma = scale_aware_sigma
        self.rng = rng or np.random.default_rng()

    def __call__(self, image: np.ndarray, joints: List[np.ndarray]):
        if not isinstance(joints, list):
            raise TypeError(f"joints must be a list of arrays, got {type(joints).__name__}")
        joints = [j.astype(np.float64).copy() for j in joints]
        height, width = image.shape[:2]
        center = np.array((width / 2.0, height / 2.0))
        if self.scale_type == "long":
            scale = max(height, width) / 200.0
        elif self.scale_type == "short":
            scale = min(height, width) / 200.0
        else:
            raise ValueError(f"unknown scale type {self.scale_type!r}")

        aug_scale = self.rng.random() * (self.max_scale - self.min_scale) + self.min_scale
        scale *= aug_scale
        aug_rot = (self.rng.random() * 2.0 - 1.0) * self.max_rotation
        if self.max_translate > 0:
            lim = int(self.max_translate * scale)
            center[0] += self.rng.integers(-lim, lim)
            center[1] += self.rng.integers(-lim, lim)

        for i, out_size in enumerate(self.output_size):
            mat = affine_matrix(center, scale, (out_size, out_size), aug_rot)[:2]
            joints[i][:, 0:2] = affine_joints(joints[i][:, 0:2], mat)
            if self.scale_aware_sigma and joints[i].shape[1] > 3:
                joints[i][:, 3] = joints[i][:, 3] / aug_scale

        mat_input = affine_matrix(center, scale, (self.input_size, self.input_size), aug_rot)[:2]
        image = warp_affine(np.ascontiguousarray(image), mat_input,
                            (self.input_size, self.input_size))

        if self.flip_prob and self.rng.random() < self.flip_prob:
            image = image[:, ::-1].copy()
            for i, out_size in enumerate(self.output_size):
                joints[i][:, 0] = out_size - joints[i][:, 0] - 1

        image = normalize_image(image)
        return image, joints


def normalize_image(image: np.ndarray) -> np.ndarray:
    """uint8/float HWC -> float32 HWC, /255 + ImageNet normalise
    (reference ToTensor+Normalize, transforms.py:38-51)."""
    img = image.astype(np.float32)
    if image.dtype == np.uint8 or img.max() > 2.0:
        img = img / 255.0
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_image(image: np.ndarray) -> np.ndarray:
    return np.clip((image * IMAGENET_STD + IMAGENET_MEAN) * 255.0, 0, 255).astype(np.uint8)


def build_transforms(cfg, is_train: bool = True,
                     rng: Optional[np.random.Generator] = None) -> HandTransforms:
    """Config-driven chain (reference transforms/build.py:35-80): augmentation
    parameters only apply when training with WITH_DATA_AUG."""
    if is_train and cfg.WITH_DATA_AUG:
        return HandTransforms(
            input_size=int(cfg.MODEL.IMAGE_SIZE[0]),
            output_size=[int(cfg.MODEL.HEATMAP_SIZE[0])],
            max_rotation=float(cfg.DATASET.MAX_ROTATION),
            min_scale=float(cfg.DATASET.MIN_SCALE),
            max_scale=float(cfg.DATASET.MAX_SCALE),
            scale_type=str(cfg.DATASET.SCALE_TYPE),
            max_translate=float(cfg.DATASET.MAX_TRANSLATE),
            flip_prob=float(bool(cfg.DATASET.FLIP)),
            scale_aware_sigma=bool(cfg.DATASET.SCALE_AWARE_SIGMA),
            rng=rng,
        )
    return HandTransforms(
        input_size=int(cfg.MODEL.IMAGE_SIZE[0]),
        output_size=[int(cfg.MODEL.HEATMAP_SIZE[0])],
        scale_type=str(cfg.DATASET.SCALE_TYPE),
        rng=rng,
    )
