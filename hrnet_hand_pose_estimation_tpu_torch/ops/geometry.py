"""Multi-view geometry, in PyTorch: projection and triangulation (DLT by
eigh, shifted inverse iteration or SVD, and RANSAC over view pairs).

Port of the JAX package's ``ops/geometry.py`` (reference lib/utils/misc.py
and triangulation_model_utils/multiview.py).  Everything is batched over
leading axes.  The small products (P X, K [R|t], A^T A) are written out as
float32 multiply-adds instead of matmuls, so that no float32 product on the
card goes through TF32: the JAX package asks for ``Precision.HIGHEST``.

``torch.linalg.eigh`` / ``solve`` / ``svd`` give eigenvectors and singular
vectors up to sign on every backend; the homogeneous divide cancels the
sign, and its bounded form (``eps``) keeps degenerate systems finite exactly
as the JAX package does.  ``triangulate_eigh`` builds A^T A in float32 as
the JAX package does and solves it in float64: the float32 eigensolver,
not A^T A's rounding, is what moves a DLT of inconsistent views by mm.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


# ----------------------------------------------------------------- basics
def euclidean_to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    """(..., M) -> (..., M+1) by appending ones (reference misc.py:39-46)."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def homogeneous_to_euclidean(points: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """(..., M+1) -> (..., M) dividing by the last coordinate (misc.py:29-36).
    With ``eps``, a |w| below it becomes ``-eps`` for w < 0 and ``+eps``
    otherwise (w = 0 included)."""
    w = points[..., -1:]
    if eps:
        bound = torch.where(w < 0, w.new_full((), -eps), w.new_full((), eps))
        w = torch.where(w.abs() < eps, bound, w)
    return points[..., :-1] / w


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., I, J) x (..., J) -> (..., I), as float multiply-adds."""
    return (m * v[..., None, :]).sum(-1)


def project_points(proj: torch.Tensor, points3d: torch.Tensor) -> torch.Tensor:
    """Project world points through P = K[R|t].

    proj: (..., 3, 4); points3d: (..., N, 3) -> (..., N, 2).
    """
    img = _matvec(proj[..., None, :, :], euclidean_to_homogeneous(points3d))
    return homogeneous_to_euclidean(img, eps=1e-12)


def update_after_resize(K: torch.Tensor, image_shape: Tuple[int, int],
                        new_image_shape: Tuple[int, int]) -> torch.Tensor:
    """Rescale intrinsics for a resized image (reference misc.py:16-27).

    K: (..., 3, 3); shapes are (height, width).
    """
    h, w = image_shape
    nh, nw = new_image_shape
    sx, sy = nw / w, nh / h
    scale = torch.tensor([[sx, 1.0, sx], [1.0, sy, sy], [1.0, 1.0, 1.0]], dtype=K.dtype,
                         device=K.device)
    return K * scale


def compose_projection(K: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    """P = K @ [R|t].  K: (..., 3, 3), extrinsics: (..., 3, 4) -> (..., 3, 4)."""
    return (K[..., :, :, None] * extrinsics[..., None, :, :]).sum(-2)


# ------------------------------------------------------------- DLT core
def _dlt_system(points2d: torch.Tensor, projs: torch.Tensor) -> torch.Tensor:
    """The (2V, 4) DLT system per point (reference misc.py:78-79).

    points2d: (..., V, 2); projs: (..., V, 3, 4) -> A: (..., 2V, 4).
    """
    a = projs[..., 2:3, :] * points2d[..., :, None]     # (..., V, 2, 4)
    a = a - projs[..., :2, :]
    return a.reshape(*a.shape[:-3], -1, 4)


def _unit_trace_gram(a: torch.Tensor) -> torch.Tensor:
    """A^T A scaled to unit trace (float32 multiply-adds): the scaling keeps
    f32 eigh and LU well-conditioned at mm / px scales and keeps the
    eigenvectors."""
    ata = (a[..., :, :, None] * a[..., :, None, :]).sum(-3)
    tr = ata.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return ata / torch.clamp(tr, min=1e-30)


def triangulate_eigh(points2d: torch.Tensor, projs: torch.Tensor,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DLT via the symmetric eigendecomposition of A^T A.

    points2d: (..., V, 2); projs: (..., V, 3, 4); optional per-view
    confidence weights (..., V) scale each view's two rows (reference
    triangulation.py:253-264).  Returns (..., 3).
    """
    a = _dlt_system(points2d, projs)
    if weights is not None:
        a = a * weights.repeat_interleave(2, dim=-1)[..., None]
    # the float32 A^T A solved in float64: a float32 eigh (JAX's, LAPACK's)
    # of a random net's inconsistent detections is mm off the exact DLT,
    # the float64 one 1e-4 mm (tests/test_torch_triangulation.py)
    _, vecs = torch.linalg.eigh(_unit_trace_gram(a).double())
    x = vecs[..., :, 0].to(a.dtype)          # the smallest eigenvalue's vector
    # bounded divide: a degenerate system (an untrained model decoding every
    # view to the principal point) would otherwise give coords ~1e11 whose
    # squares overflow f32 downstream
    return homogeneous_to_euclidean(x, eps=1e-6)


def triangulate_sii(points2d: torch.Tensor, projs: torch.Tensor, n_iters: int = 2,
                    shift: float = 0.001, init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shifted-inverse-iteration DLT, reference-faithful (misc.py:64-97):
    ``b <- normalize(solve(AtA / tr + 1e-3 shift I, b))`` from a fixed 0.5
    vector (the reference starts from ``torch.rand``), ``n_iters`` times."""
    a = _dlt_system(points2d, projs)
    ata = _unit_trace_gram(a.to(torch.promote_types(a.dtype, torch.float32)))
    eye = torch.eye(4, dtype=ata.dtype, device=ata.device)
    b_mat = ata + (1e-3 * shift) * eye
    bk = torch.full(ata.shape[:-2] + (4,), 0.5, dtype=ata.dtype, device=ata.device) \
        if init is None else init
    bk = bk / torch.linalg.vector_norm(bk, dim=-1, keepdim=True)
    for _ in range(n_iters):
        bk = torch.linalg.solve(b_mat, bk[..., None])[..., 0]
        bk = bk / torch.linalg.vector_norm(bk, dim=-1, keepdim=True)
    return homogeneous_to_euclidean(-bk, eps=1e-12)


def triangulate_svd(points2d: torch.Tensor, projs: torch.Tensor) -> torch.Tensor:
    """DLT via SVD (reference misc.py:99-121)."""
    a = _dlt_system(points2d, projs)
    _, _, vh = torch.linalg.svd(a.float(), full_matrices=False)
    return homogeneous_to_euclidean(-vh[..., 3, :], eps=1e-12)


def reprojection_errors(point3d: torch.Tensor, points2d: torch.Tensor,
                        projs: torch.Tensor) -> torch.Tensor:
    """Per-view 2D reprojection error (reference multiview.py:190-200).

    point3d: (..., 3); points2d: (..., V, 2); projs: (..., V, 3, 4) -> (..., V).
    """
    img = _matvec(projs, euclidean_to_homogeneous(point3d)[..., None, :])
    uv = homogeneous_to_euclidean(img, eps=1e-12)
    return torch.linalg.vector_norm(uv - points2d, dim=-1)


def triangulate_ransac(points2d: torch.Tensor, projs: torch.Tensor,
                       reproj_eps: float = 40.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC triangulation over view pairs (reference misc.py:178-239).

    points2d: (..., V, 2); projs: (..., V, 3, 4).  Every one of the C(V, 2)
    pairs is a hypothesis (the reference samples 10 random pairs from the
    same set); the one with the most inliers (reprojection error <
    ``reproj_eps``, its own two views always counted) wins, the first on a
    tie, and all views are re-triangulated with its inlier mask as weights.
    Returns (point3d (..., 3), inlier_mask (..., V)).
    """
    v = points2d.shape[-2]
    pairs = torch.tensor([(i, j) for i in range(v) for j in range(i + 1, v)],
                         device=points2d.device)                     # (P, 2)
    lead = points2d.shape[:-2]
    p2 = points2d[..., pairs, :]                                     # (..., P, 2, 2)
    pr = projs[..., pairs, :, :]                                     # (..., P, 2, 3, 4)
    pt3 = triangulate_eigh(p2, pr)                                   # (..., P, 3)
    n_pairs = pairs.shape[0]
    errs = reprojection_errors(
        pt3, points2d[..., None, :, :].expand(*lead, n_pairs, v, 2),
        projs[..., None, :, :, :].expand(*lead, n_pairs, v, 3, 4))   # (..., P, V)
    in_pair = (torch.arange(v, device=points2d.device)[None, :, None]
               == pairs[:, None, :]).any(-1)                         # (P, V)
    inliers = (errs < reproj_eps) | in_pair
    best = torch.argmax(inliers.sum(-1), dim=-1)                     # (...,): the first max
    best_inliers = torch.gather(inliers, -2, best[..., None, None].expand(*lead, 1, v))[..., 0, :]
    point3d = triangulate_eigh(points2d, projs, weights=best_inliers.to(points2d.dtype))
    return point3d, best_inliers


def triangulate_batch(points2d: torch.Tensor, projs: torch.Tensor, method: str = "eigh",
                      confidences: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Triangulate (B, V, K, 2) detections -> (B, K, 3).

    projs: (B, V, 3, 4); confidences: optional (B, V, K).
    """
    b, v, k, _ = points2d.shape
    pts = points2d.transpose(1, 2)                                   # (B, K, V, 2)
    prj = projs[:, None].expand(b, k, v, 3, 4)
    w = None if confidences is None else confidences.transpose(1, 2)
    if method == "eigh":
        return triangulate_eigh(pts, prj, weights=w)
    if method == "sii":
        return triangulate_sii(pts, prj)
    if method == "svd":
        return triangulate_svd(pts, prj)
    if method == "ransac":
        return triangulate_ransac(pts, prj)[0]
    raise ValueError(f"unknown triangulation method {method!r}")
