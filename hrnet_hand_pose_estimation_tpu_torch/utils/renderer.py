"""Mesh renderer for MANO visualisation: a z-buffer rasteriser, in PyTorch.

Port of the JAX package's ``utils/renderer.py`` (the reference's OpenDR
renderer, lib/utils/renderer.py:1-289): ``MeshRenderer(faces, img_size,
flength)`` called with ``(verts, cam=[f, px, py], img=None, do_alpha=...,
color_id=...)`` gives a uint8 image; ``rotated``, ``get_alpha``,
``append_alpha``, ``draw_text``, the colour palette and the three-point
Lambertian rig (back and left lights at full intensity, the right one at
0.7, reference :152-178) as there.

Triangles are rasterised in chunks of ``chunk``: each chunk computes the
barycentric coverage and depth of every pixel at once, a (chunk, H, W)
tensor, and folds into a running z-buffer.  JAX runs the chunks in a
``lax.fori_loop``; here they are a Python loop over device tensors.  A
pixel is covered where its three barycentrics are >= 0; the nearest
triangle wins, the first one on a tie (``argmin``), and an earlier chunk
keeps a pixel against a later one of equal depth.  Colours are
Gouraud-interpolated from per-vertex Lambertian shading.  The renderer runs
on ``device`` (the card unless the caller asks for the CPU); the JAX
package reaches no Pallas kernel here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

colors = {
    # colourblind/print/copy safe (reference :17-21)
    "light_blue": [0.85882353, 0.74117647, 0.65098039],
    "light_pink": [0.9, 0.7, 0.7],
}


# --------------------------------------------------------------- geometry
def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals of a (V, 3) mesh with (T, 3) faces."""
    faces = faces.long()
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0)                 # area-weighted
    vn = torch.zeros_like(verts)
    for i in range(3):
        vn = vn.index_add(0, faces[:, i], fn)
    return vn / torch.clamp(torch.linalg.vector_norm(vn, dim=1, keepdim=True), min=1e-8)


def lambertian_point_light(verts, normals, albedo, light_pos, light_color):
    """OpenDR LambertianPointLight semantics: albedo * colour * max(n.l, 0)."""
    d = light_pos[None] - verts
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True), min=1e-8)
    lam = torch.clamp((d * normals).sum(1, keepdim=True), min=0.0)
    colour = torch.as_tensor(light_color, dtype=verts.dtype, device=verts.device)
    return albedo * colour[None] * lam


def _rotate_y(points: np.ndarray, angle: float) -> np.ndarray:
    ry = np.array([[np.cos(angle), 0.0, np.sin(angle)],
                   [0.0, 1.0, 0.0],
                   [-np.sin(angle), 0.0, np.cos(angle)]])
    return points @ ry


def shade_vertices(verts, faces, color, yrot=math.radians(120)):
    """The three-point lighting rig of the reference's simple_renderer (:152-178)."""
    vn = vertex_normals(verts, faces)
    albedo = torch.as_tensor(color, dtype=torch.float32, device=verts.device)[None].expand(
        verts.shape)
    vc = torch.zeros_like(verts)
    rig = [((-200.0, -100.0, -100.0), (1.0, 1.0, 1.0)),
           ((800.0, 10.0, 300.0), (1.0, 1.0, 1.0)),
           ((-500.0, 500.0, 1000.0), (0.7, 0.7, 0.7))]
    for pos, col in rig:
        lp = torch.from_numpy(_rotate_y(np.asarray(pos, np.float64), yrot).astype(
            np.float32)).to(verts.device)
        vc = vc + lambertian_point_light(verts, vn, albedo, lp, col)
    return torch.clamp(vc, 0.0, 1.0)


# -------------------------------------------------------------- rasteriser
def _edge(ax, ay, bx, by, px, py):
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def rasterize(verts_cam: torch.Tensor, faces: torch.Tensor, vert_colors: torch.Tensor,
              f: torch.Tensor, c: torch.Tensor, background: torch.Tensor,
              near: float = 0.1, far: float = 100.0, height: int = 256, width: int = 256,
              chunk: int = 64) -> torch.Tensor:
    """Pinhole-project and z-buffer rasterise a triangle mesh.

    verts_cam: (V, 3) camera-space vertices (+z forward, y down: the
    reference's ProjectPoints with rt = t = 0, :57-63); faces: (T, 3) ints;
    vert_colors: (V, 3) in [0, 1]; f, c: the focal lengths and the principal
    point, (2,) each; background: (H, W, 3).  Returns (H, W, 3) float32 in
    [0, 1], on the vertices' device.
    """
    dev = verts_cam.device
    faces = faces.long()
    z = torch.clamp(verts_cam[:, 2], min=1e-6)
    u = f[0] * verts_cam[:, 0] / z + c[0]
    v = f[1] * verts_cam[:, 1] / z + c[1]
    proj = torch.stack([u, v, verts_cam[:, 2]], dim=1)           # (V, 3)

    pad = (-faces.shape[0]) % chunk
    # padded with degenerate triangles that never win the depth test
    tri = torch.cat([proj[faces], torch.full((pad, 3, 3), float("inf"), dtype=proj.dtype,
                                             device=dev)])
    col = torch.cat([vert_colors[faces], vert_colors.new_zeros((pad, 3, 3))])
    ys = torch.arange(height, dtype=torch.float32, device=dev)[None, :, None]   # rows = v
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :]    # cols = u

    zbuf = torch.full((height, width), float("inf"), device=dev)
    img = background.to(device=dev, dtype=torch.float32)
    for i in range(tri.shape[0] // chunk):
        tc = tri[i * chunk:(i + 1) * chunk]                          # (c, 3, 3)
        cc = col[i * chunk:(i + 1) * chunk]
        x0, y0, z0 = (tc[:, 0, j][:, None, None] for j in range(3))
        x1, y1, z1 = (tc[:, 1, j][:, None, None] for j in range(3))
        x2, y2, z2 = (tc[:, 2, j][:, None, None] for j in range(3))
        denom = _edge(x0, y0, x1, y1, x2, y2)
        safe = torch.where(denom.abs() < 1e-8, torch.ones_like(denom), denom)
        l0 = _edge(x1, y1, x2, y2, xs, ys) / safe                     # (c, H, W)
        l1 = _edge(x2, y2, x0, y0, xs, ys) / safe
        l2 = 1.0 - l0 - l1
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (denom.abs() >= 1e-8)
        depth = l0 * z0 + l1 * z1 + l2 * z2
        inside = inside & (depth > near) & (depth < far)
        depth = torch.where(inside, depth, torch.full_like(depth, float("inf")))
        best = torch.argmin(depth, dim=0)[None]                       # (1, H, W)
        dmin = torch.gather(depth, 0, best)[0]
        lam = torch.stack([torch.gather(l, 0, best)[0] for l in (l0, l1, l2)], dim=-1)
        cbest = cc[best.reshape(-1)].reshape(height, width, 3, 3)
        shade = (lam[..., :, None] * cbest).sum(2)                    # (H, W, 3)
        win = dmin < zbuf
        zbuf = torch.where(win, dmin, zbuf)
        img = torch.where(win[..., None], shade, img)
    return torch.clamp(img, 0.0, 1.0)


# ------------------------------------------------------------- public API
def get_alpha(imtmp, bgval=1.0):
    """Add an alpha channel that is 0 exactly on background pixels (:182-190)."""
    alpha = (~np.all(imtmp == bgval, axis=2)).astype(imtmp.dtype)
    return np.concatenate([imtmp, alpha[..., None]], axis=2)


def append_alpha(imtmp):
    alpha = np.ones_like(imtmp[:, :, :1])
    if np.issubdtype(imtmp.dtype, np.uint8):
        alpha = alpha * 255
    return np.concatenate([imtmp, alpha], axis=2)


def render_model(verts, faces, w, h, f, c, near=0.5, far=25.0, img=None, do_alpha=False,
                 color_id=None, device="cuda"):
    """The reference's render_model (:202-234): shade, rasterise on
    ``device``, the alpha rules.  Returns a float32 numpy image."""
    if color_id is None:
        color = colors["light_blue"]
    else:
        color = list(colors.values())[color_id % len(colors)]
    verts = torch.as_tensor(np.asarray(verts, np.float32), device=device)
    faces = torch.as_tensor(np.asarray(faces, np.int64), device=device)
    vc = shade_vertices(verts, faces, color)
    if img is not None:
        bg = torch.as_tensor(np.asarray(img, np.float32), device=device)
        bg = bg / 255.0 if float(bg.max()) > 1.0 else bg
    else:
        bg = torch.ones((h, w, 3), dtype=torch.float32, device=device)
    fc = torch.tensor(np.asarray([f, c], np.float32), device=device)
    out = rasterize(verts, faces, vc, fc[0], fc[1], bg, near=near, far=far,
                    height=h, width=w).cpu().numpy()
    if img is None and do_alpha:
        out = get_alpha(out)
    elif img is not None and do_alpha:
        out = append_alpha(out)
    return out


class MeshRenderer:
    """The reference MeshRenderer (:25-113): cam is ``[f, px, py]``, the
    output uint8 (H, W, 3|4); renders on ``device``."""

    def __init__(self, mesh_faces, img_size: int = 256, flength: float = 500.0,
                 device="cuda"):
        self.faces = np.asarray(mesh_faces, np.int32)
        self.w = self.h = img_size
        self.flength = flength
        self.device = device

    def __call__(self, verts, cam=None, img=None, do_alpha=False, far=None, near=None,
                 color_id=0, img_size=None):
        if img is not None:
            h, w = img.shape[:2]
        elif img_size is not None:
            h, w = img_size
        else:
            h, w = self.h, self.w
        if cam is None:
            cam = [self.flength, w / 2.0, h / 2.0]
        verts = np.asarray(verts, np.float32)
        if near is None:
            near = max(float(verts[:, 2].min()) - 25.0, 0.1)
        if far is None:
            far = max(float(verts[:, 2].max()) + 25.0, 25.0)
        imtmp = render_model(verts, self.faces, w, h, f=(cam[0], cam[0]), c=(cam[1], cam[2]),
                             near=near, far=far, img=img, do_alpha=do_alpha,
                             color_id=color_id, device=self.device)
        return (np.asarray(imtmp, np.float32) * 255).astype(np.uint8)

    def rotated(self, verts, deg, cam=None, axis="y", img=None, do_alpha=True, far=None,
                near=None, color_id=0, img_size=None):
        rad = math.radians(deg)
        cs, sn = math.cos(rad), math.sin(rad)
        if axis == "y":
            rot = np.array([[cs, 0, sn], [0, 1, 0], [-sn, 0, cs]])
        elif axis == "x":
            rot = np.array([[1, 0, 0], [0, cs, -sn], [0, sn, cs]])
        else:
            rot = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]])
        center = verts.mean(axis=0)
        new_v = (verts - center) @ rot + center
        return self(new_v, cam, img=img, do_alpha=do_alpha, far=far, near=near,
                    img_size=img_size, color_id=color_id)


def draw_text(input_image, content):
    """Draw 'key: value' lines on an image (reference :265-289)."""
    import cv2

    image = input_image.copy()
    input_is_float = np.issubdtype(image.dtype, np.floating)
    if input_is_float:
        image = (image * 255).astype(np.uint8)
    y = 15
    for key in sorted(content):
        cv2.putText(image, "%s: %.2g" % (key, content[key]), (5, y), 0, 0.45, (0, 0, 0))
        y += 15
    return image.astype(np.float32) / 255.0 if input_is_float else image
