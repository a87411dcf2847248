"""The port's CPM-backed volumetric net (``vol_CPM``: ``models/cpm.
CPMVolumetric`` under ``VolumetricTriangulationNet``) against the JAX
package's, on shared weights, and its training labels.

64x64 images (CPM's maps 8x8, so HEATMAP_SIZE 8), 2 views, B = 2, V2V at
32^3 (its five poolings need a side divisible by 32), float32 on both
sides, the JAX eigh solved in float64 as the port's (``jax_eigh64``).
The JAX variables are ``jax.eval_shape`` shapes filled from a numpy seed
and activated as in ``tests/test_torch_triangulation.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.core import trainer3d as JT3
from hrnet_hand_pose_estimation_tpu.models.cpm import CPMVolumetric as JaxCPMVolumetric
from hrnet_hand_pose_estimation_tpu.models.triangulation import \
    build_triangulation_net as jax_build_net
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core import trainer3d as PT3
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.cpm import CPMVolumetric
from hrnet_hand_pose_estimation_tpu_torch.models.triangulation import build_triangulation_net
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.softmax_decode import fused_softmax_decode
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables, init_variables
from tests.test_torch_triangulation import (activate, assert_exact_dlt, init_like,  # noqa: F401
                                            jax_eigh64, jax_vol_from_base, net_cfg,
                                            proj_matrices)

torch.set_num_threads(1)
B, V = 2, 2
CODES = {"main": 1, "process": 2, "volume": 3, "frozen": 4}


def vol_cpm_cfg(tiny_cfg, **extra):
    return net_cfg(tiny_cfg, MODEL__TRIANGULATION_MODEL_NAME="vol_CPM",
                   MODEL__BACKBONE_NAME="CPM_volumetric", MODEL__HEATMAP_SIZE=[8, 8], **extra)


def jax_vol_cpm(cfg, seed):
    """(JAX net in float32, activated variables, images, projections at the
    8x8 heatmap scale).  The last stage's output conv is scaled by 10: at
    the activated scale CPM's logits vary little, and the maps at
    temperature 1 are near uniform (max 0.1); scaled, they peak (max ~1)."""
    rng = np.random.default_rng(seed)
    jm = jax_build_net(cfg, "vol_CPM")
    jm = jm.clone(dtype=jnp.float32, backbone=JaxCPMVolumetric(dtype=jnp.float32))
    imgs = jnp.asarray(rng.normal(size=(B, V, 64, 64, 3)).astype(np.float32))
    projs = jnp.asarray(proj_matrices(B, V, 7.5, (3.5, 3.5)))
    variables = activate(init_like(jm, rng, imgs, projs, False), rng)
    out_conv = variables["params"]["backbone"]["cpm"]["stage6"]["mconv5"]
    for leaf in ("kernel", "bias"):
        out_conv[leaf] = out_conv[leaf] * np.float32(10.0)
    return jm, variables, imgs, projs


def port_vol_cpm(cfg, variables):
    model = build_triangulation_net(config_from_dict(cfg.to_dict()), "vol_CPM",
                                    dtype=torch.float32)
    model.load_state_dict(from_jax_variables(variables, model))
    return model


@pytest.mark.parametrize("softmax", [True, False])
def test_vol_cpm_forward_matches_jax(tiny_cfg, jax_eigh64, softmax):
    """The CPM's heatmaps (probabilities at temperature 1) at rtol 1e-2 +
    atol 1e-6, the 2D keypoints (B4's twin or the argmax) at 1e-3 heatmap
    px, each side's base point against the float64 DLT of its own joint-9
    detections, and the stages after the base point against JAX's run from
    the port's base point, at the limits of ``test_vol_net_matches_jax``."""
    cfg = vol_cpm_cfg(tiny_cfg, MODEL__HEATMAP_SOFTMAX=softmax)
    jm, variables, imgs, projs = jax_vol_cpm(cfg, seed=21)
    want = jm.apply(variables, imgs, projs, False)
    model = port_vol_cpm(cfg, variables)
    assert isinstance(model.backbone, CPMVolumetric)
    assert model.process_features[0].in_channels == 128
    before = fused_softmax_decode.launches
    with torch.no_grad():
        got = model(torch.from_numpy(np.array(imgs)), torch.from_numpy(np.array(projs)))
    assert fused_softmax_decode.launches == before          # the CPU runs the twin
    assert got.heatmaps.shape == (B, V, 8, 8, 21) and got.confidences is None
    np.testing.assert_allclose(got.heatmaps.numpy(), np.asarray(want.heatmaps), rtol=1e-2,
                               atol=1e-6)
    kp2d = np.asarray(want.keypoints_2d)
    assert kp2d.std(axis=(0, 1)).mean() > 0.1              # sample- and view-dependent
    np.testing.assert_allclose(got.keypoints_2d.numpy(), kp2d, atol=1e-3)
    for side in (got, want):
        assert_exact_dlt(np.asarray(side.base_points)[:, None],
                         np.asarray(side.keypoints_2d)[:, :, 9:10], projs)
    coords, probs, kp3d = jax_vol_from_base(jm, variables, imgs, projs, got.base_points.numpy())
    np.testing.assert_allclose(got.coord_volumes.numpy(), coords, atol=1e-3)
    np.testing.assert_allclose(got.volumes.numpy(), probs, rtol=1e-2, atol=1e-7)
    np.testing.assert_allclose(got.keypoints_3d.numpy(), kp3d, atol=0.2)


def test_vol_cpm_backbone_interface(tiny_cfg):
    """``forward_head`` gives the last stage's joint logits (background
    dropped), the feat_trunk's 128-channel float32 features and the
    temperature 1.0; with no centre map it uses the sigma-3 Gaussian at the
    image centre."""
    from hrnet_hand_pose_estimation_tpu_torch.ops.targets import gaussian_centermap

    backbone = CPMVolumetric(21)
    torch.manual_seed(0)
    x = torch.randn(2, 64, 64, 3)
    with torch.no_grad():
        head = backbone.forward_head(x)
        center = gaussian_centermap(torch.full((2, 2), 31.5), 64)
        beliefs = backbone.cpm(x, center)
    assert head.temperature == 1.0 and head.confidences is None
    assert head.features.shape == (2, 8, 8, 128) and head.features.dtype == torch.float32
    torch.testing.assert_close(head.heatmaps, beliefs[-1][..., 1:])


def test_freeze_labels_match_jax(tiny_cfg):
    """JAX's ``freeze_labels`` of the vol_CPM tree, mapped through the
    bridge, gives the port's labels name for name.  JAX's rule labels a
    backbone path 'main' when it holds "stage4": CPM's fourth refinement
    stage trains, the rest of the CPM and feat_trunk are frozen."""
    cfg = vol_cpm_cfg(tiny_cfg)
    jm, variables, _, _ = jax_vol_cpm(cfg, seed=22)
    labels = JT3.freeze_labels(variables["params"], "vol_CPM")
    coded = jax.tree.map(lambda lab, leaf: np.full(np.shape(leaf), CODES[lab], np.float32),
                         labels, variables["params"])
    want = from_jax_variables({"params": coded})
    got = PT3.freeze_labels(port_vol_cpm(cfg, variables))
    assert set(got) == set(want)
    inverse = {v: k for k, v in CODES.items()}
    for name, label in got.items():
        assert inverse[int(want[name].reshape(-1)[0])] == label, name
    main = sorted(n for n, lab in got.items() if lab == "main")
    assert main == sorted(f"backbone.cpm.{m}_stage4.{f}" for m in
                          ("conv1", "Mconv1", "Mconv2", "Mconv3", "Mconv4", "Mconv5")
                          for f in ("weight", "bias"))
    assert got["backbone.feat_trunk.conv1.weight"] == "frozen"
    assert got["backbone.cpm.conv1_stage2.weight"] == "frozen"


def test_train_step_3d_freezes_the_cpm(tiny_cfg):
    """One ``make_train_step_3d`` step of vol_CPM (float32, seeded weights
    from ``init_variables``, the heatmap, pose3d and volumetric losses):
    every 'frozen' parameter bit-unchanged, every other group moved."""
    from tests.torch3d_parity import make_batch, to_torch

    cfg = config_from_dict(vol_cpm_cfg(
        tiny_cfg, MODEL__NAME="vol_CPM", TRAIN__OPTIMIZER="adam", TRAIN__LR=1e-3,
        LOSS__WITH_HEATMAP_LOSS=True, LOSS__HEATMAP_LOSS_FACTOR=0.1, LOSS__WITH_POSE2D_LOSS=False, LOSS__WITH_POSE3D_LOSS=True,
        LOSS__WITH_VOLUMETRIC_CE_LOSS=True).to_dict())
    model = build_model(cfg)
    model.load_state_dict(init_variables(cfg, 0, net="vol_CPM"))
    model.train()
    tx = PT3.make_optimizer_3d(cfg, model, 1000)
    state = PT3.TrainState(model, tx)
    batch = make_batch("vol", 30, b=1)
    batch["heatmaps"] = np.random.default_rng(1).uniform(size=(1, V, 8, 8, 21)).astype(
        np.float32)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = PT3.make_train_step_3d(cfg, model, tx, (64, 64))
    state, losses = step(state, to_torch(batch), torch.Generator().manual_seed(0))
    assert np.isfinite(float(losses["total_loss"])) and float(losses["nonfinite_grads"]) == 0
    labels = PT3.freeze_labels(model)
    moved = {lab: set() for lab in CODES}
    for name, p in model.named_parameters():
        if not torch.equal(p.detach(), before[name]):
            moved[labels[name]].add(name)
    assert not moved["frozen"]
    for lab in ("main", "process", "volume"):
        assert moved[lab], lab
