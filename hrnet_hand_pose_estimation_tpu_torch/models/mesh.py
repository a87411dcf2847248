"""Graph-CNN hand mesh network, in PyTorch.

Port of the JAX package's ``models/mesh.py`` (the reference's mesh/shape
family, lib/models/net_hm_feat_mesh.py:211, net_mesh_pose.py:22,
shape_pose_network.py:28; no config or tool of the reference or of the JAX
package wires them): image features -> per-vertex mesh positions by dense
Chebyshev graph convolutions up a coarsened hand graph
(``utils/graph.py``), plus a 3D pose head.

JAX contracts the Chebyshev products at ``Precision.HIGHEST``; the port runs
them in float32 with TF32 off (``ops/precision.bmm_f32``), outside any
autocast.  The graph operators (the Chebyshev bases and the unpooling
matrices) are buffers, not state: a state_dict holds the parameters only,
under the flax names (``lift``, ``cheb{l}.w`` / ``.b``, ``out``,
``pose_head``).  The JAX package reaches no Pallas kernel here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.precision import bmm_f32
from .layers import Dense, lecun_normal_


class ChebConv(nn.Module):
    """Dense Chebyshev graph convolution: y = sum_k T_k(L) x W_k + b."""

    def __init__(self, in_features: int, features: int, basis: np.ndarray):
        super().__init__()
        k = basis.shape[0]
        self.register_buffer("basis", torch.from_numpy(np.asarray(basis, np.float32).copy()),
                             persistent=False)                   # (K, N, N)
        self.w = nn.Parameter(torch.empty(k, in_features, features))
        self.b = nn.Parameter(torch.zeros(features))
        self.init_train_weights(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_train_weights(self, gen: torch.Generator) -> None:
        """flax's ``lecun_normal`` over the (K, in, out) kernel (fan-in K * in), bias 0."""
        lecun_normal_(self.w, self.w.shape[0] * self.w.shape[1], gen)
        self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, C) -> (B, N, out) float32."""
        b, n, c = x.shape
        k = self.basis.shape[0]
        with torch.autocast(x.device.type, enabled=False):
            x = x.to(torch.promote_types(x.dtype, torch.float32))
            basis = self.basis.to(x.dtype).reshape(k * n, n)
            t = bmm_f32(basis.expand(b, k * n, n), x)                  # (B, K*N, C)
            t = t.reshape(b, k, n, c).transpose(1, 2).reshape(b, n, k * c)
            w = self.w.to(x.dtype).reshape(k * c, -1)
            return bmm_f32(t, w.expand(b, *w.shape)) + self.b.to(x.dtype)


class HandMeshNet(nn.Module):
    """Features -> coarse-to-fine graph-CNN mesh vertices + 3D pose head
    (JAX ``HandMeshNet``): the global average of the features, a dense lift
    to the coarsest graph, then per level a ChebConv with a ReLU and a
    dense unpool to the next finer level, a last ChebConv to 3 coordinates,
    and a dense pose head on the average."""

    def __init__(self, bases: Sequence[np.ndarray], unpools: Sequence[np.ndarray],
                 n_vertices: int, num_joints: int = 21, widths: Sequence[int] = (64, 32),
                 in_features: int = 480):
        super().__init__()
        self.n_levels = len(bases)
        self.n_vertices = n_vertices
        self.num_joints = num_joints
        self.widths = tuple(widths)
        self.n_coarse = bases[-1].shape[1]
        self.lift = Dense(in_features, self.n_coarse * self.widths[0])
        width = self.widths[0]
        for lvl in range(self.n_levels - 1, -1, -1):
            out = self.widths[min(self.n_levels - 1 - lvl, len(self.widths) - 1)]
            self.add_module(f"cheb{lvl}", ChebConv(width, out, bases[lvl]))
            width = out
            if lvl > 0:
                self.register_buffer(f"unpool{lvl - 1}", torch.from_numpy(
                    np.asarray(unpools[lvl - 1], np.float32).copy()), persistent=False)
        self.out = ChebConv(width, 3, bases[0])
        self.pose_head = Dense(in_features, num_joints * 3)

    def forward(self, features: torch.Tensor):
        """features (B, H, W, C) -> (mesh (B, V, 3), pose3d (B, K, 3)), float32."""
        with torch.autocast(features.device.type, enabled=False):
            g = features.to(torch.promote_types(features.dtype, torch.float32)).mean(dim=(1, 2))
            x = self.lift(g).reshape(-1, self.n_coarse, self.widths[0])
            # decode coarsest -> finest, widening the resolution each level
            for lvl in range(self.n_levels - 1, -1, -1):
                x = torch.relu(getattr(self, f"cheb{lvl}")(x))
                if lvl > 0:
                    up = getattr(self, f"unpool{lvl - 1}").to(x.dtype)     # (N_fine, N_coarse)
                    x = bmm_f32(up.expand(x.shape[0], *up.shape), x)
            mesh = self.out(x)
            pose = self.pose_head(g)
        return mesh, pose.reshape(-1, self.num_joints, 3)


def hand_edges() -> np.ndarray:
    """Bone-graph edges of the 21-joint hand (the kinematic chain), (20, 2)
    int64: the default graph when no dense MANO mesh is given."""
    from ..data.legends import BONE_CHILDREN, BONE_PARENTS

    return np.stack([BONE_PARENTS, BONE_CHILDREN], axis=1).astype(np.int64)


def build_hand_mesh_net(num_joints: int = 21, cheb_k: int = 3, levels: int = 2,
                        edges: Optional[np.ndarray] = None, n_vertices: Optional[int] = None,
                        in_features: int = 480) -> HandMeshNet:
    """The coarsening pyramid (``utils/graph.py``) and the decoder (JAX
    ``build_hand_mesh_net``): the 21-joint bone graph by default, or a MANO
    mesh's edge list and vertex count.  ``in_features`` is the features'
    width (480 for the w32 HRNet's; flax infers it at init)."""
    from ..utils.graph import (adjacency_from_edges, chebyshev_basis, coarsen_levels,
                               rescaled_laplacian, unpool_matrix)

    n = n_vertices if n_vertices is not None else num_joints
    adj = adjacency_from_edges(n, edges if edges is not None else hand_edges())
    adjs, clusters = coarsen_levels(adj, levels)
    bases = tuple(chebyshev_basis(rescaled_laplacian(a), cheb_k) for a in adjs)
    unpools = tuple(unpool_matrix(cl) for cl in clusters)
    return HandMeshNet(bases=bases, unpools=unpools, n_vertices=n, num_joints=num_joints,
                       in_features=in_features)
