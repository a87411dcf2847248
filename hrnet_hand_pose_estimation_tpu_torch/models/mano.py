"""Linear-blend-skinning hand model (MANO-style), in PyTorch.

Port of the JAX package's ``models/mano.py`` (the reference's vendored
numpy/chumpy MANO stack, lib/dataset/frei_utils/mano_loader.py:62,
lbs.py:31, verts.py): shape blendshapes, pose blendshapes, joint
regression, the forward-kinematic rigid chain and linear blend skinning,
batched and differentiable by autograd.

The published MANO asset (MANO_RIGHT.pkl) is not in the repository;
``load_mano`` reads it where it is, and ``toy_hand_model`` builds a
synthetic rig of the same structure from a seed (at MANO's size with
``n_verts=778, n_joints=16, n_shape=10``).  The rig's arrays are tensors on
``device`` (the card unless the caller asks for the CPU); its kinematic
parents and faces are numpy arrays, static structure read on the host.
The JAX package reaches no Pallas kernel here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class HandModel(NamedTuple):
    v_template: torch.Tensor    # (V, 3) rest vertices
    shapedirs: torch.Tensor     # (V, 3, n_shape)
    posedirs: torch.Tensor      # (V, 3, (J-1)*9)
    j_regressor: torch.Tensor   # (J, V)
    weights: torch.Tensor       # (V, J) skinning weights
    parents: np.ndarray         # (J,) kinematic parents, -1 for the root
    faces: Optional[np.ndarray] = None


def rodrigues(rvecs: torch.Tensor) -> torch.Tensor:
    """Batched axis-angle -> rotation matrices: (..., 3) -> (..., 3, 3)."""
    theta = torch.clamp(torch.linalg.vector_norm(rvecs, dim=-1, keepdim=True), min=1e-8)
    axis = rvecs / theta
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    k = torch.stack([torch.stack([zero, -z, y], -1),
                     torch.stack([z, zero, -x], -1),
                     torch.stack([-y, x, zero], -1)], -2)
    t = theta[..., None]
    eye = torch.eye(3, dtype=rvecs.dtype, device=rvecs.device)
    return eye + torch.sin(t) * k + (1.0 - torch.cos(t)) * (k @ k)


def lbs(model: HandModel, pose: torch.Tensor, betas: torch.Tensor,
        global_transl: Optional[torch.Tensor] = None):
    """Pose + shape -> (vertices (B, V, 3), joints (B, J, 3)).

    pose: (B, J, 3) axis-angle per joint (joint 0 the global orientation);
    betas: (B, n_shape).  The reference's LBS pipeline (frei_utils/verts.py):
    shape blendshapes -> joint regression -> pose blendshapes -> forward
    kinematics -> skinning.  Products in the inputs' dtype with autocast
    off (TF32 as the caller sets it).
    """
    b = pose.shape[0]
    parents = np.asarray(model.parents)
    n_j = parents.shape[0]
    with torch.autocast(pose.device.type, enabled=False):
        v_shaped = model.v_template + torch.einsum("vcs,bs->bvc", model.shapedirs, betas)
        joints = torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped)

        rots = rodrigues(pose)                                       # (B, J, 3, 3)
        # pose blendshapes from the non-root rotations minus the identity
        eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
        pose_feat = (rots[:, 1:] - eye).reshape(b, -1)
        v_posed = v_shaped + torch.einsum("vcp,bp->bvc", model.posedirs, pose_feat)

        # forward kinematics: the world transform of each joint
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rots.dtype,
                              device=rots.device).expand(b, 1, 4)
        transforms = [None] * n_j
        for j in range(n_j):
            p = int(parents[j])
            offset = joints[:, j] if p < 0 else joints[:, j] - joints[:, p]
            rel_t = torch.cat([torch.cat([rots[:, j], offset[..., None]], -1), bottom], dim=1)
            transforms[j] = rel_t if p < 0 else transforms[p] @ rel_t
        world = torch.stack(transforms, dim=1)                      # (B, J, 4, 4)

        posed_joints = world[..., :3, 3]
        # remove the rest-pose joint location (the standard LBS correction)
        correction = torch.einsum("bjmn,bjn->bjm", world[..., :3, :3], joints)
        skin_t = torch.cat([world[..., :3, :3], (world[..., :3, 3] - correction)[..., None]],
                           -1)                                       # (B, J, 3, 4)

        vert_t = torch.einsum("vj,bjmn->bvmn", model.weights, skin_t)   # (B, V, 3, 4)
        hom = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], -1)
        verts = torch.einsum("bvmn,bvn->bvm", vert_t, hom)

        if global_transl is not None:
            verts = verts + global_transl[:, None]
            posed_joints = posed_joints + global_transl[:, None]
    return verts, posed_joints


def load_mano(path: str, device="cuda") -> HandModel:
    """Read a MANO pickle (chumpy arrays coerced to numpy, a dense or
    ``scipy.sparse`` J_regressor; the kintree root's sentinel > 1e6 becomes
    -1) onto ``device``."""
    import pickle

    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")

    def arr(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float64).astype(np.float32)).to(device)

    kintree = np.asarray(data["kintree_table"])[0]
    parents = np.where(kintree > 1_000_000, -1, kintree).astype(np.int32)
    j_reg = data["J_regressor"]
    return HandModel(
        v_template=arr(data["v_template"]),
        shapedirs=arr(data["shapedirs"]),
        posedirs=arr(np.asarray(data["posedirs"]).reshape(len(data["v_template"]), 3, -1)),
        j_regressor=arr(j_reg.toarray() if hasattr(j_reg, "toarray") else j_reg),
        weights=arr(data["weights"]),
        parents=parents,
        faces=np.asarray(data["f"]) if "f" in data else None,
    )


def toy_hand_model(n_verts: int = 40, n_joints: int = 5, n_shape: int = 3, seed: int = 0,
                   device="cuda") -> HandModel:
    """A synthetic rig with MANO's structure, from a numpy seed: a chain of
    joints along +x with vertices clustered around them (the JAX package's
    ``toy_hand_model``, the same numbers; zero pose blendshapes, as there)."""
    rng = np.random.default_rng(seed)
    joints_rest = np.stack([np.arange(n_joints, dtype=np.float32),
                            np.zeros(n_joints), np.zeros(n_joints)], -1)
    owner = rng.integers(0, n_joints, size=n_verts)
    verts = joints_rest[owner] + rng.normal(scale=0.2, size=(n_verts, 3))
    weights = np.zeros((n_verts, n_joints), np.float32)
    weights[np.arange(n_verts), owner] = 1.0
    j_reg = np.zeros((n_joints, n_verts), np.float32)
    for j in range(n_joints):
        mask = owner == j
        if mask.any():
            j_reg[j, mask] = 1.0 / mask.sum()
    shapedirs = rng.normal(scale=0.01, size=(n_verts, 3, n_shape))

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return HandModel(
        v_template=dev(verts),
        shapedirs=dev(shapedirs),
        posedirs=dev(np.zeros((n_verts, 3, (n_joints - 1) * 9), np.float32)),
        j_regressor=dev(j_reg),
        weights=dev(weights),
        parents=np.arange(-1, n_joints - 1, dtype=np.int32),
    )
