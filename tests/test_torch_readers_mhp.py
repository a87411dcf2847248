"""The port's MHP readers against the JAX package's on one tiny MHP tree
(``tests/torch_reader_trees.py``: 640x480 PNG content under the .jpg names,
Python-2-style calibration pickles): single-view, keypoint, multi-view with
the seeded occlusion disc, sequence and the two CPM variants, item by item;
the loaders of shipped YAMLs; ``MHP_mv`` into ``Evaluator3D`` (against
JAX's on the same batches) and a ``Trainer3D`` step; and finding C23.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_reader_trees as trees
from hrnet_hand_pose_estimation_tpu.core.evaluator3d import Evaluator3D as JaxEvaluator3D
from hrnet_hand_pose_estimation_tpu.core.loss_computer import LossComputer2D as JaxLoss2D
from hrnet_hand_pose_estimation_tpu.core.evaluator import Evaluator2D as JaxEvaluator2D
from hrnet_hand_pose_estimation_tpu.data import mhp as JM
from hrnet_hand_pose_estimation_tpu.data.transforms import build_transforms as jax_transforms
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu_torch.core import trainer3d as PT3
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator3d import Evaluator3D
from hrnet_hand_pose_estimation_tpu_torch.core.trainer import _batch_for_step
from hrnet_hand_pose_estimation_tpu_torch.data import mhp as M
from hrnet_hand_pose_estimation_tpu_torch.data.build import make_dataloader, make_test_dataloader
from hrnet_hand_pose_estimation_tpu_torch.data.transforms import build_transforms
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.triangulation import build_triangulation_net
from hrnet_hand_pose_estimation_tpu_torch.parallel.train_step import (TrainState,
                                                                      create_train_state,
                                                                      make_train_step)
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from tests.test_torch_triangulation import activate, init_like, jax_eigh64  # noqa: F401
from torch_reader_parity import (REPO_EXPERIMENTS, assert_items_match, first_batches_match,
                                 port_cfg, yaml_cfg)

torch.set_num_threads(1)
MHP = REPO_EXPERIMENTS / "MHP"
TRI = REPO_EXPERIMENTS / "LearnableTriangulation"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mhp")
    trees.write_mhp(root, {"data_1": 6, "data_2": 2, "data_17": 5})
    return root


def _cfgs(tiny_cfg, root, **extra):
    jcfg = tiny_cfg.clone()
    jcfg.DATA_DIR = str(root)
    jcfg.DATASET.NUM_VIEWS = 3
    jcfg.DATASET.SEQ_IDX = [-1, 0, 1]
    jcfg.DATASET.STRIDE = 2
    for key, val in extra.items():
        jcfg.merge_from_list([key.replace("__", "."), val])
    jcfg.freeze()
    return jcfg, port_cfg(jcfg)


def test_raw_mhp_items_match_jax(root):
    """MHPDataset without a transform, with and without the occlusion disc:
    the decoded frames, the projected joints, visibility and extrinsics
    bit-equal / within 1e-6; the calibration and the 3D poses as JAX reads
    them."""
    for subset in ("training", "evaluation"):
        for occlude in (False, True):
            got = M.MHPDataset(str(root), subset, occlude=occlude)
            want = JM.MHPDataset(str(root), subset, occlude=occlude)
            assert got.frames == want.frames and len(got) == len(want) > 0
            for i in range(0, len(want), 3):
                assert_items_match(got[i], want[i], label=f"{subset}[{i}] occlude {occlude}")
    got, want = M.MHPDataset(str(root), "training"), JM.MHPDataset(str(root), "training")
    for key in want.pose3d:
        np.testing.assert_array_equal(got.pose3d[key], want.pose3d[key])
    rvec = want.rvec["data_1"]["2"]
    np.testing.assert_allclose(M.rodrigues(rvec), JM.rodrigues(rvec), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(M.INTRINSICS, JM.INTRINSICS)
    assert (M.ORIG_SIZE, list(M.TRAIN_DIRS), list(M.EVAL_DIRS), M.OCCLUSION_RADIUS) == \
        (JM.ORIG_SIZE, list(JM.TRAIN_DIRS), list(JM.EVAL_DIRS), JM.OCCLUSION_RADIUS)


def test_occlusion_disc_is_drawn_and_masks_joints(root):
    """The multi-view reader's disc: black where cv2's circle would be, the
    joints inside it invisible (the same frame as JAX's, checked above)."""
    ds = M.MHPDataset(str(root), "training", occlude=True)
    plain = M.MHPDataset(str(root), "training")
    item, ref = ds[1], plain[1]
    dark = (item["orig_imgs"] == 0).all(-1) & (ref["orig_imgs"] != 0).any(-1)
    assert 7000 < dark.sum() <= np.pi * 51 ** 2
    assert 0 < (item["visibility"] == 0).sum() < 21


@pytest.mark.parametrize("train", [False, True])
def test_keypoint_multiview_and_sequence_items_match_jax(tiny_cfg, root, train):
    """MHPDatasetKeypoints, MHPMultiViewDataset and MHPSeqDataset through the
    eval transforms, or the training chain with every augmentation on (both
    sides seeded alike): targets, joints and visibility as JAX's, images
    within one gray level."""
    jcfg, cfg = _cfgs(tiny_cfg, root, WITH_DATA_AUG=True, DATASET__MAX_ROTATION=30.0,
                      DATASET__MIN_SCALE=0.8, DATASET__MAX_SCALE=1.2, DATASET__FLIP=True)
    for name in ("MHPDatasetKeypoints", "MHPMultiViewDataset", "MHPSeqDataset"):
        got = getattr(M, name)(cfg, "training", None,
                               build_transforms(cfg, train, rng=np.random.default_rng(5)))
        want = getattr(JM, name)(jcfg, "training", None,
                                 jax_transforms(jcfg, train, rng=np.random.default_rng(5)))
        assert len(got) == len(want) > 0, name
        if name == "MHPSeqDataset":
            assert got.anchors == want.anchors
        for i in range(min(len(want), 3)):
            assert_items_match(got[i], want[i], "gray", label=f"{name}[{i}]")


def test_cpm_items_match_jax(tiny_cfg, root):
    """MHPCPMDataset and MHPCPMMultiViewDataset: the 640x480 frames resized
    to the model input by ``data/cv.resize`` are cv2.resize's to the bit
    here, so the items are equal (centre maps, (K+1)-channel targets)."""
    jcfg, cfg = _cfgs(tiny_cfg, root, MODEL__IMAGE_SIZE=[64, 64], MODEL__HEATMAP_SIZE=[8, 8])
    for name in ("MHPCPMDataset", "MHPCPMMultiViewDataset"):
        got, want = getattr(M, name)(cfg, "evaluation"), getattr(JM, name)(jcfg, "evaluation")
        for i in range(2):
            assert_items_match(got[i], want[i], label=f"{name}[{i}]")


@pytest.mark.parametrize("yaml, extra", [
    (MHP / "MHP_HRNet_w32_trainable_softmax_hm-pose2dloss_v1.yaml", {}),        # MHP_kpt / MHP
    (MHP / "MHP_CPM_v1.yaml", {}),                                               # MHP_CPM_kpt
    (TRI / "VolTriangulation_MHP_v2.yaml", {}),                                  # MHP_mv
    (TRI / "VolTriangulation_MHP_CPM_v1.yaml", {}),                              # MHP_CPM_mv
    (MHP / "MHP_HRNet_w32_trainable_softmax_pose2dloss_PoseAggr_v1.yaml",       # MHP_seq
     {"DATASET__STRIDE": 1}),
])
def test_mhp_loaders_of_shipped_yamls_match_jax(root, yaml, extra):
    """The first train and test batch of each MHP reader's shipped YAML
    (WORKERS 0, 2 a batch; MHP_seq at stride 1, which the tree's six
    frames hold twice)."""
    jcfg, cfg = yaml_cfg(yaml, root, **extra)
    first_batches_match(jcfg, cfg, True)
    first_batches_match(jcfg, cfg, False)


def test_mhp_mv_feeds_evaluator3d_as_jax(tiny_cfg, root, tmp_path, jax_eigh64):
    """MHP_mv into Evaluator3D's dlt mode on the reader's 640x480 cameras:
    the port's and JAX's evaluators on the same batches of the port's
    loader and the same weights, 2D metrics within 1e-4, 3D within 1e-3."""
    jcfg, cfg = _cfgs(tiny_cfg, root, DATASET__TEST_DATASET=["MHP_mv"], TEST__IMAGES_PER_GPU=2,
                      WORKERS=0, TPU__COMPUTE_DTYPE="float32", EXP_NAME="mhp3d")
    loader = make_test_dataloader(cfg)["MHP_mv"]
    batch = next(iter(loader))
    assert batch["imgs"].shape == (2, 3, 64, 64, 3) and loader.dataset.orig_img_size == [640, 480]
    rng = np.random.default_rng(11)
    jmodel = jax_build_model(jcfg)
    images = jnp.asarray(batch["imgs"])
    variables = activate(init_like(jmodel, rng, images.reshape(-1, *images.shape[2:]), False), rng)
    want = JaxEvaluator3D(jcfg, jmodel, variables, mode="dlt").run(loader)
    got = Evaluator3D(cfg, build_model(cfg), from_jax_variables(variables), mode="dlt",
                      device="cpu").run(loader)
    assert set(got) == set(want) and all(np.isfinite(v) for v in got.values())
    for key in ("EPE2D_px", "PCK2D_AUC_30"):
        assert got[key] == pytest.approx(want[key], rel=1e-4), key
    for key in ("EPE3D_mm", "PCK3D_AUC", "PCK3D@20mm"):
        assert got[key] == pytest.approx(want[key], rel=1e-3, abs=1e-6), key


def test_mhp_mv_feeds_a_trainer3d_step(tiny_cfg, root):
    """One alg Trainer3D step on an MHP_mv batch (640x480 cameras): finite
    losses and moved weights, as on Synthetic_mv."""
    jcfg, cfg = _cfgs(tiny_cfg, root, DATASET__DATASET=["MHP_mv"], TRAIN__IMAGES_PER_GPU=2,
                      WORKERS=0, TPU__COMPUTE_DTYPE="float32", MODEL__TRIANGULATION_MODEL_NAME="alg",
                      MODEL__ALG_CONFIDENCES=False)
    torch.manual_seed(0)
    batch = next(iter(make_dataloader(cfg)["MHP_mv"]))
    model = build_triangulation_net(cfg, "alg", dtype=torch.float32)
    tx = PT3.make_optimizer_3d(cfg, model, 10)
    state = TrainState(model, tx)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = PT3.make_train_step_3d(cfg, model, tx, tuple(M.ORIG_SIZE))
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in PT3.batch_for_step(batch).items()}
    state, losses = step(state, tensors, torch.Generator().manual_seed(0))
    assert losses and all(torch.isfinite(v) for v in losses.values())
    assert any(not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters())


def test_c23_mhp_seq_fails_in_jax_and_the_port_raises(tiny_cfg, root):
    """ROADMAP C23: MHP_seq folds views into frames, (B, F*V, ...).  On such
    a batch the JAX package's 2D loss cannot broadcast PoseAggr's (B, K, 2)
    decode against the (B, F*V, K, 2) targets at B = 1 or 2, and its
    Evaluator2D fails the same way; the port's train step and Evaluator2D
    raise ValueError naming C23, before any forward."""
    for b in (1, 2):
        jcfg, cfg = _cfgs(tiny_cfg, root, MODEL__NAME="pose_hrnet_PoseAggr",
                          DATASET__DATASET=["MHP_seq"], DATASET__TEST_DATASET=["MHP_seq"],
                          TRAIN__IMAGES_PER_GPU=b, TEST__IMAGES_PER_GPU=b, WORKERS=0,
                          DATASET__NUM_VIEWS=2, DATASET__STRIDE=1)
        batch = next(iter(make_dataloader(cfg)["MHP_seq"]))
        f_v = 3 * 2
        assert batch["imgs"].shape == (b, f_v, 64, 64, 3)
        assert batch["pose2d"].shape == (b, f_v, 21, 2)
        # JAX: the maps and decode PoseAggr gives, (B, h, w, K) and (B, K, 2),
        # against the folded targets in JAX's 2D loss
        step_batch = {k: jnp.asarray(np.asarray(v)) for k, v in
                      _batch_for_step({k: torch.from_numpy(np.asarray(v))
                                       for k, v in batch.items()}).items()}
        with pytest.raises((TypeError, ValueError)):
            JaxLoss2D(jcfg)(heatmaps_pred=jnp.zeros((b, 16, 16, 21)),
                            heatmaps_gt=step_batch["target_heatmaps"],
                            pose2d_pred=jnp.zeros((b, 21, 2)), pose2d_gt=step_batch["pose2d"],
                            visibility=step_batch["visibility"])
        model = build_model(cfg)
        state, tx = create_train_state(cfg, model, device="cpu")
        step = make_train_step(cfg, model, tx)
        tensors = _batch_for_step({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        with pytest.raises(ValueError, match="C23"):
            step(state, tensors)
        with pytest.raises(ValueError, match="C23"):
            Evaluator2D(cfg, model, None, device="cpu").run(make_test_dataloader(cfg)["MHP_seq"])
    # JAX's evaluator on the same loader, its forward giving PoseAggr's
    # (B, K, 2), fails in its rescale and metrics
    jev = JaxEvaluator2D(jcfg, jax_build_model(jcfg), None)
    jev.forward = lambda variables, images: (None, jnp.zeros((images.shape[0], 21, 2)))
    with pytest.raises((TypeError, ValueError)):
        jev.run(make_test_dataloader(cfg)["MHP_seq"])
