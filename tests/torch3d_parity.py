"""Shared harness of the port's 3D training parity tests (not a test module).

The JAX side is the JAX package's own ``make_train_step_3d`` and
``TrainerGAN3D`` steps on the nets of ``test_torch_triangulation`` (its
activated random variables at tiny_cfg widths, V2V at 32^3), in float32.
Two test-time patches, no file of the JAX package changes:

- ``jax_eigh64_grad``: the JAX geometry module's ``jnp.linalg.eigh`` solved
  in float64 on the host (as the port solves its float32 A^T A; see
  ``test_torch_triangulation.jax_eigh64``), wrapped in ``jax.custom_jvp``
  with the standard eigen-decomposition JVP, since ``pure_callback`` has
  none and the 3D losses differentiate through the DLT;
- ``fixed_theta``: the volumetric net's training-time cuboid turn, drawn
  from JAX's ``aug`` key and from the port's generator, replaced on both
  sides by the same angles.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from tests.test_torch_triangulation import CAMERAS, jax_net, net_cfg, port_net

# projections of the 3D steps: the test nets' cameras, given as K and [R|t]
# at the original image scale (alg and ransac: the nets' default 640x480;
# vol: a 64x64 image whose K the step rescales to the 16x16 heatmap)
ORIG_SIZE = {"alg": (640, 480), "ransac": (640, 480), "vol": (64, 64)}


def cameras(kind: str, b: int, v: int):
    """(intrinsic (B, 3, 3), extrinsics (B, V, 3, 4)) float32 whose
    ``build_projections`` are ``test_torch_triangulation.proj_matrices``."""
    f, c = CAMERAS[kind]
    if kind == "vol":
        f, c = f * 4, (c[0] * 4, c[1] * 4)
    K = np.array([[f, 0, c[0]], [0, f, c[1]], [0, 0, 1]], np.float32)
    exts = []
    for i in range(v):
        ang = 0.3 + 0.9 * i
        cs, sn = np.cos(ang), np.sin(ang)
        ry = np.array([[cs, 0, sn], [0, 1, 0], [-sn, 0, cs]], np.float32)
        tx = 0.2 + 0.15 * i
        ct, st = np.cos(tx), np.sin(tx)
        rx = np.array([[1, 0, 0], [0, ct, -st], [0, st, ct]], np.float32)
        exts.append(np.concatenate([rx @ ry, np.array([[0], [0], [900.0]], np.float32)], 1))
    return (np.broadcast_to(K, (b, 3, 3)).copy(),
            np.broadcast_to(np.stack(exts), (b, v, 3, 4)).astype(np.float32).copy())


def make_batch(kind: str, seed: int, b: int = 2, v: int = 2):
    """A seeded 3D batch (numpy): images, 2D ground truth in heatmap px,
    3D ground truth near the origin, the cameras."""
    rng = np.random.default_rng(seed)
    intr, ext = cameras(kind, b, v)
    return {"images": rng.normal(size=(b, v, 64, 64, 3)).astype(np.float32),
            "pose2d": rng.uniform(2, 14, size=(b, v, 21, 2)).astype(np.float32),
            "pose3d": rng.uniform(-120, 120, size=(b, 21, 3)).astype(np.float32),
            "visibility": np.ones((b, v, 21), np.float32),
            "intrinsic_matrix": intr, "extrinsic_matrices": ext}


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def train_cfg(tiny_cfg, kind: str, **extra):
    """(JAX cfg, port cfg): ``net_cfg`` with the net's name and the 3D train
    settings; ``extra`` dotted overrides (``LOSS__X=1``)."""
    base = dict(MODEL__TRIANGULATION_MODEL_NAME=kind, TRAIN__OPTIMIZER="adam",
                TRAIN__LR=1e-3, TRAIN__PROCESS_FEATURE_LR=3e-3, TRAIN__VOLUME_NET_LR=2e-3,
                LOSS__WITH_HEATMAP_LOSS=False, LOSS__WITH_POSE2D_LOSS=kind == "vol",
                LOSS__POSE2D_LOSS_FACTOR=0.1, LOSS__WITH_POSE3D_LOSS=True,
                LOSS__WITH_VOLUMETRIC_CE_LOSS=kind == "vol", LOSS__VOLUMETRIC_LOSS_FACTOR=0.01)
    base.update(extra)
    cfg = net_cfg(tiny_cfg, **base)
    return cfg, config_from_dict(cfg.to_dict())


def nets(cfg, kind: str, seed: int, b: int = 2, v: int = 2):
    """(JAX net, its variables (numpy), port net in train mode with the same
    weights) in float32."""
    rng = np.random.default_rng(seed)
    jm, variables, _, _ = jax_net(cfg, kind, rng, b, v)
    model = port_net(cfg, kind, variables)
    return jm, variables, model.train()


# ---- eigh with a JVP -----------------------------------------------------

def _host_eigh(x):
    w, v = np.linalg.eigh(np.asarray(x, np.float64))
    return w.astype(np.float32), v.astype(np.float32)


@jax.custom_jvp
def eigh64(a):
    out = (jax.ShapeDtypeStruct(a.shape[:-1], jnp.float32),
           jax.ShapeDtypeStruct(a.shape, jnp.float32))
    return jax.pure_callback(_host_eigh, out, a, vmap_method="expand_dims")


@eigh64.defjvp
def _eigh64_jvp(primals, tangents):
    """dw = diag(V^T dA V), dV = V (F * (V^T dA V)), F_ij = 1 / (w_j - w_i)
    off the diagonal (the rule of JAX's own eigh)."""
    (a,), (da,) = primals, tangents
    w, v = eigh64(a)
    vdv = jnp.einsum("...ji,...jk,...kl->...il", v, da, v)
    eye = jnp.eye(a.shape[-1], dtype=bool)
    gap = w[..., None, :] - w[..., :, None]
    f = jnp.where(eye, 0.0, 1.0 / jnp.where(eye, 1.0, gap))
    return (w, v), (jnp.diagonal(vdv, axis1=-2, axis2=-1), v @ (f * vdv))


class _Linalg64Grad:
    def __getattr__(self, name):
        return getattr(jnp.linalg, name)

    @staticmethod
    def eigh(a):
        return eigh64(a)


class _Jnp64Grad:
    linalg = _Linalg64Grad()

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def jax_eigh64_grad(monkeypatch):
    from hrnet_hand_pose_estimation_tpu.ops import geometry as JG

    monkeypatch.setattr(JG, "jnp", _Jnp64Grad())


# ---- the cuboid's turn ----------------------------------------------------

class _Proxy:
    """A module stand-in: ``overrides`` first, the module's names otherwise."""

    def __init__(self, module, **overrides):
        self._module = module
        self.__dict__.update(overrides)

    def __getattr__(self, name):
        return getattr(self._module, name)


def fixed_theta(monkeypatch, u: np.ndarray):
    """Both nets' cuboid angles := u * 2 pi (u in [0, 1), one per sample):
    the port's ``torch.rand`` draw in models/triangulation.py returns u, JAX's
    ``jax.random.uniform`` the port's angles."""
    from hrnet_hand_pose_estimation_tpu.models import triangulation as JT
    from hrnet_hand_pose_estimation_tpu_torch.models import triangulation as PT

    ut = torch.from_numpy(np.asarray(u, np.float32))
    theta = (ut * (2.0 * math.pi)).numpy()
    monkeypatch.setattr(PT, "torch", _Proxy(torch, rand=lambda *a, **k: ut.clone()))
    monkeypatch.setattr(JT, "jax", _Proxy(jax, random=_Proxy(
        jax.random, uniform=lambda *a, **k: jnp.asarray(theta))))
    return theta


def tree_get(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree
