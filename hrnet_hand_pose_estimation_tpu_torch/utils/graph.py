"""Graph Laplacians + greedy coarsening for the mesh graph-CNN (numpy).

The port's own copy of the JAX package's ``utils/graph.py`` (reference
lib/utils/graph_util.py and lib/utils/coarsening.py): numpy at build time
(graphs are static structures), dense operators that ``models/mesh.py``
contracts on the device (a hand mesh is small enough that dense Chebyshev
filtering is one matmul per order).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def adjacency_from_edges(n: int, edges: np.ndarray) -> np.ndarray:
    """Dense symmetric adjacency from an (E, 2) edge list."""
    a = np.zeros((n, n), np.float32)
    a[edges[:, 0], edges[:, 1]] = 1.0
    a[edges[:, 1], edges[:, 0]] = 1.0
    return a


def normalized_laplacian(adj: np.ndarray) -> np.ndarray:
    """L = I - D^-1/2 A D^-1/2 (reference graph_util Laplacian)."""
    d = adj.sum(1)
    dinv = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    return np.eye(adj.shape[0], dtype=np.float32) - (dinv[:, None] * adj * dinv[None, :])


def rescaled_laplacian(adj: np.ndarray) -> np.ndarray:
    """2L/lambda_max - I for Chebyshev filtering."""
    lap = normalized_laplacian(adj)
    lmax = float(np.linalg.eigvalsh(lap).max())
    return (2.0 / max(lmax, 1e-12)) * lap - np.eye(adj.shape[0], dtype=np.float32)


def greedy_coarsen(adj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One level of Graclus-style heavy-edge matching (reference
    coarsening.py): greedily pair each unmatched vertex with its heaviest
    unmatched neighbour.  Returns (coarse_adjacency, cluster assignment)."""
    n = adj.shape[0]
    cluster = -np.ones(n, np.int64)
    order = np.argsort(-adj.sum(1))  # heavy vertices first
    next_id = 0
    for v in order:
        if cluster[v] >= 0:
            continue
        nbrs = np.nonzero((adj[v] > 0) & (cluster < 0))[0]
        nbrs = nbrs[nbrs != v]
        if len(nbrs):
            u = nbrs[np.argmax(adj[v, nbrs])]
            cluster[v] = cluster[u] = next_id
        else:
            cluster[v] = next_id
        next_id += 1
    m = next_id
    pool = np.zeros((m, n), np.float32)
    pool[cluster, np.arange(n)] = 1.0
    coarse = pool @ adj @ pool.T
    np.fill_diagonal(coarse, 0.0)
    return coarse.astype(np.float32), cluster


def coarsen_levels(adj: np.ndarray, levels: int
                   ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Multi-level coarsening: ([adj_0..adj_L], [cluster_0..cluster_{L-1}])."""
    adjs = [adj]
    clusters = []
    cur = adj
    for _ in range(levels):
        cur, cl = greedy_coarsen(cur)
        adjs.append(cur)
        clusters.append(cl)
    return adjs, clusters


def pool_matrix(cluster: np.ndarray) -> np.ndarray:
    """(M, N) average-pooling matrix from a greedy_coarsen cluster assignment
    (dense replacement of the reference coarsening.py
    perm+fake-node maxpool: pooling between graph levels is one matmul)."""
    n = cluster.shape[0]
    m = int(cluster.max()) + 1
    p = np.zeros((m, n), np.float32)
    p[cluster, np.arange(n)] = 1.0
    return p / np.maximum(p.sum(1, keepdims=True), 1.0)


def unpool_matrix(cluster: np.ndarray) -> np.ndarray:
    """(N, M) unpooling matrix: copies each coarse vertex to its children."""
    n = cluster.shape[0]
    m = int(cluster.max()) + 1
    u = np.zeros((n, m), np.float32)
    u[np.arange(n), cluster] = 1.0
    return u


def chebyshev_basis(rescaled_lap: np.ndarray, k: int) -> np.ndarray:
    """Stacked Chebyshev polynomials T_0..T_{k-1} of the rescaled Laplacian,
    (K, N, N) — contract with features by einsum."""
    n = rescaled_lap.shape[0]
    ts = [np.eye(n, dtype=np.float32), rescaled_lap.astype(np.float32)]
    for _ in range(2, k):
        ts.append(2.0 * rescaled_lap @ ts[-1] - ts[-2])
    return np.stack(ts[:k])
