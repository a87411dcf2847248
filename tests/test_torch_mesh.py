"""The port's mesh family against the JAX package's: ``utils/graph.py``
(bit-equal numpy), ``ChebConv`` and ``HandMeshNet`` (``models/mesh.py``,
within 1e-5 of the largest value), ``rodrigues`` and ``lbs``
(``models/mano.py``, within 1e-5) on ``toy_hand_model`` and on a rig of
MANO's size (778 vertices, 16 joints, 10 shape and 135 pose-blendshape
columns, nonzero pose blendshapes), the LBS properties JAX's own test
checks, and ``load_mano`` on pickles written here (a dense and a
``scipy.sparse`` J_regressor, the kintree root sentinel).  Float32.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from hrnet_hand_pose_estimation_tpu.models import mano as jax_mano
from hrnet_hand_pose_estimation_tpu.models import mesh as jax_mesh
from hrnet_hand_pose_estimation_tpu.utils import graph as jax_graph
from hrnet_hand_pose_estimation_tpu_torch.models import mano, mesh
from hrnet_hand_pose_estimation_tpu_torch.utils import graph
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import _tree_kind, from_jax_variables
from torch_zoo_parity import rel_gap

torch.set_num_threads(1)
CPU = "cpu"


def grid_edges(rows, cols):
    """The edges of a triangulated rows x cols grid (a surface patch)."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    e = [np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
         np.stack([idx[:-1].ravel(), idx[1:].ravel()], 1),
         np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], 1)]
    return np.concatenate(e).astype(np.int64)


GRAPHS = {"hand": (21, jax_mesh.hand_edges()),
          "chain": (8, np.array([[i, i + 1] for i in range(7)])),
          "grid": (48, grid_edges(6, 8))}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_bit_equal(name):
    """All eight functions of utils/graph.py give JAX's arrays bit for bit."""
    n, edges = GRAPHS[name]
    adj = graph.adjacency_from_edges(n, edges)
    np.testing.assert_array_equal(adj, jax_graph.adjacency_from_edges(n, edges))
    for fn in ("normalized_laplacian", "rescaled_laplacian"):
        np.testing.assert_array_equal(getattr(graph, fn)(adj), getattr(jax_graph, fn)(adj))
    coarse, cl = graph.greedy_coarsen(adj)
    jcoarse, jcl = jax_graph.greedy_coarsen(adj)
    np.testing.assert_array_equal(coarse, jcoarse)
    np.testing.assert_array_equal(cl, jcl)
    adjs, clusters = graph.coarsen_levels(adj, 2)
    jadjs, jclusters = jax_graph.coarsen_levels(adj, 2)
    for a, b in zip(adjs + clusters, jadjs + jclusters):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(graph.pool_matrix(cl), jax_graph.pool_matrix(cl))
    np.testing.assert_array_equal(graph.unpool_matrix(cl), jax_graph.unpool_matrix(cl))
    lap = graph.rescaled_laplacian(adj)
    np.testing.assert_array_equal(graph.chebyshev_basis(lap, 4),
                                  jax_graph.chebyshev_basis(lap, 4))
    np.testing.assert_array_equal(mesh.hand_edges(), jax_mesh.hand_edges())


def test_chebconv_matches_jax():
    """A ChebConv of order 3 on the grid graph, B = 3, 5 -> 7 channels."""
    n, edges = GRAPHS["grid"]
    basis = graph.chebyshev_basis(graph.rescaled_laplacian(graph.adjacency_from_edges(n, edges)),
                                  3)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, n, 5)).astype(np.float32)
    params = {"w": rng.normal(size=(3, 5, 7)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    want = jax_mesh.ChebConv(7, basis).apply({"params": params}, jnp.asarray(x))
    conv = mesh.ChebConv(5, 7, basis)
    conv.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    assert set(conv.state_dict()) == {"w", "b"}
    got = conv(torch.from_numpy(x))
    assert rel_gap(got.detach(), want) <= 1e-5


@pytest.mark.parametrize("graph_name,levels", [("hand", 2), ("grid", 3)])
def test_hand_mesh_net_matches_jax(graph_name, levels):
    """HandMeshNet (build_hand_mesh_net on the bone graph, and on a 48-vertex
    grid mesh with three coarsening levels): the mesh and the pose within
    1e-5 of the largest value; the bridge places every leaf and fills every
    key."""
    n, edges = GRAPHS[graph_name]
    kw = dict(levels=levels) if graph_name == "hand" else dict(levels=levels, edges=edges,
                                                                 n_vertices=n)
    jnet = jax_mesh.build_hand_mesh_net(**kw)
    feats = np.random.default_rng(1).normal(size=(2, 8, 8, 32)).astype(np.float32)
    variables = jnet.init(jax.random.key(0), jnp.asarray(feats), False)
    variables = jax.tree.map(np.asarray, variables)
    want_mesh, want_pose = jnet.apply(variables, jnp.asarray(feats), False)
    net = mesh.build_hand_mesh_net(in_features=32, **kw)
    assert _tree_kind(variables["params"]) == "mesh"
    net.load_state_dict(from_jax_variables(variables, net))
    with torch.no_grad():
        got_mesh, got_pose = net(torch.from_numpy(feats))
    assert got_mesh.shape == (2, n, 3) and got_pose.shape == (2, 21, 3)
    assert float(np.asarray(want_mesh).std()) > 0
    assert rel_gap(got_mesh, want_mesh) <= 1e-5
    assert rel_gap(got_pose, want_pose) <= 1e-5


def rigs():
    """(toy rig, MANO-sized rig with nonzero pose blendshapes) as (JAX, port) pairs."""
    out = []
    for kw in (dict(), dict(n_verts=778, n_joints=16, n_shape=10, seed=3)):
        j = jax_mano.toy_hand_model(**kw)
        p = mano.toy_hand_model(**kw, device=CPU)
        if kw:
            pd = np.random.default_rng(4).normal(scale=0.01, size=(778, 3, 135)).astype(np.float32)
            j = j._replace(posedirs=jnp.asarray(pd))
            p = p._replace(posedirs=torch.from_numpy(pd))
        out.append((j, p))
    return out


def test_rodrigues_matches_jax():
    r = np.random.default_rng(2).normal(size=(4, 16, 3)).astype(np.float32)
    r[0, 0] = 0.0                                   # the zero rotation
    got = mano.rodrigues(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_mano.rodrigues(jnp.asarray(r))), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got[0, 0], np.eye(3), atol=1e-7)
    np.testing.assert_allclose(got @ got.transpose(0, 1, 3, 2), np.broadcast_to(np.eye(3),
                                                                                got.shape),
                               atol=1e-5)


@pytest.mark.parametrize("which", [0, 1])
def test_lbs_matches_jax(which):
    """Vertices and joints within 1e-5 of the largest value, with shape,
    pose and a global translation, on the toy rig and the MANO-sized one."""
    jrig, prig = rigs()[which]
    j = len(prig.parents)
    s = prig.shapedirs.shape[-1]
    rng = np.random.default_rng(10 + which)
    pose = rng.normal(scale=0.5, size=(3, j, 3)).astype(np.float32)
    betas = rng.normal(size=(3, s)).astype(np.float32)
    transl = rng.normal(size=(3, 3)).astype(np.float32)
    want = jax_mano.lbs(jrig, jnp.asarray(pose), jnp.asarray(betas), jnp.asarray(transl))
    got = mano.lbs(prig, *(torch.from_numpy(a) for a in (pose, betas, transl)))
    assert got[0].shape == (3, prig.v_template.shape[0], 3) and got[1].shape == (3, j, 3)
    for g, w in zip(got, want):
        assert rel_gap(g, w) <= 1e-5


def test_lbs_properties():
    """JAX's own LBS test (tests/test_mesh_and_misc.py::test_lbs_hand_model)
    on the port: the rest pose gives the template, a root rotation turns the
    mesh about the root joint, a mid-chain rotation leaves the ancestors'
    vertices fixed, and shape blendshapes move vertices."""
    m = mano.toy_hand_model(device=CPU)
    b = 2
    pose = torch.zeros(b, 5, 3)
    betas = torch.zeros(b, 3)
    verts, joints = mano.lbs(m, pose, betas)
    np.testing.assert_allclose(verts[0].numpy(), m.v_template.numpy(), atol=1e-4)

    pose_rot = pose.clone()
    pose_rot[:, 0, 2] = np.pi / 2
    verts2, _ = mano.lbs(m, pose_rot, betas)
    j0 = joints[0, 0].numpy()
    v0 = m.v_template.numpy() - j0
    expect = np.stack([-v0[:, 1], v0[:, 0], v0[:, 2]], -1) + j0
    np.testing.assert_allclose(verts2[0].numpy(), expect, atol=1e-4)

    pose_mid = torch.zeros(b, 5, 3)
    pose_mid[:, 2, 2] = 0.7
    verts3, _ = mano.lbs(m, pose_mid, betas)
    moved = (verts3[0] - m.v_template).abs().max(dim=1).values.numpy()
    static = moved[m.weights[:, :2].sum(1).numpy() > 0]
    assert static.max() < 1e-5

    betas4 = betas.clone()
    betas4[:, 0] = 3.0
    verts4, _ = mano.lbs(m, pose, betas4)
    assert float((verts4 - verts).abs().max()) > 1e-3


@pytest.mark.parametrize("sparse", [False, True])
def test_load_mano_matches_jax(tmp_path, sparse):
    """A MANO-structured pickle (the published key names, chumpy-free):
    the root's kintree sentinel becomes -1, a sparse J_regressor is read
    dense, posedirs reshape to (V, 3, P); every field equals JAX's, and the
    rig poses as JAX's."""
    rng = np.random.default_rng(5)
    v, j, s = 60, 6, 4
    j_reg = np.zeros((j, v))
    j_reg[rng.integers(0, j, v), np.arange(v)] = 1.0
    data = {"v_template": rng.normal(size=(v, 3)), "shapedirs": rng.normal(size=(v, 3, s)),
            "posedirs": rng.normal(scale=0.01, size=(v * 3, (j - 1) * 9)),
            "J_regressor": scipy.sparse.csc_matrix(j_reg) if sparse else j_reg,
            "weights": rng.dirichlet(np.ones(j), size=v),
            "kintree_table": np.array([[4294967295, 0, 1, 2, 3, 4], np.arange(j)]),
            "f": rng.integers(0, v, size=(20, 3)).astype(np.uint32)}
    path = tmp_path / "MANO_TEST.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    got = mano.load_mano(str(path), device=CPU)
    want = jax_mano.load_mano(str(path))
    assert got.parents.tolist() == [-1, 0, 1, 2, 3, 4] == np.asarray(want.parents).tolist()
    for field in ("v_template", "shapedirs", "posedirs", "j_regressor", "weights"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    assert got.posedirs.shape == (v, 3, (j - 1) * 9)
    np.testing.assert_array_equal(got.faces, want.faces)
    pose = rng.normal(scale=0.3, size=(2, j, 3)).astype(np.float32)
    betas = rng.normal(size=(2, s)).astype(np.float32)
    wv, wj = jax_mano.lbs(want, jnp.asarray(pose), jnp.asarray(betas))
    gv, gj = mano.lbs(got, torch.from_numpy(pose), torch.from_numpy(betas))
    assert rel_gap(gv, wv) <= 1e-5 and rel_gap(gj, wj) <= 1e-5
