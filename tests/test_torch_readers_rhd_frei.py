"""The port's RHD and FreiHand readers against the JAX package's, on the
same tiny trees (``tests/torch_reader_trees.py``: PNG content, also under
FreiHand's .jpg names), item by item, loader by loader, and the 2D
evaluation slice on an RHD tree.

Raw items (no transform) are bit-equal, coordinates within 1e-6; the
keypoint readers' images pass the warp (numpy in the port, cv2 in JAX) and
agree within one gray level, the training augmentation drawing from
generators of the same seed on both sides.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_reader_trees as trees
from hrnet_hand_pose_estimation_tpu.core.evaluator import Evaluator2D as JaxEvaluator2D
from hrnet_hand_pose_estimation_tpu.data import freihand as JF
from hrnet_hand_pose_estimation_tpu.data import rhd as JR
from hrnet_hand_pose_estimation_tpu.data.build import make_test_dataloader as jax_test_loaders
from hrnet_hand_pose_estimation_tpu.data.transforms import build_transforms as jax_transforms
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
from hrnet_hand_pose_estimation_tpu_torch.data import freihand as F
from hrnet_hand_pose_estimation_tpu_torch.data import rhd as R
from hrnet_hand_pose_estimation_tpu_torch.data.build import make_test_dataloader
from hrnet_hand_pose_estimation_tpu_torch.data.legends import IDX_RHD
from hrnet_hand_pose_estimation_tpu_torch.data.transforms import build_transforms
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from tests.test_quant_infer import _activated_variables
from torch_reader_parity import (REPO_EXPERIMENTS, assert_items_match, first_batches_match,
                                 port_cfg, yaml_cfg)

torch.set_num_threads(1)
RHD_YAML = REPO_EXPERIMENTS / "RHD" / "RHD_HRNet_w32_trainable_softmax_hm-pose2dloss_v1.yaml"
FREI_YAML = REPO_EXPERIMENTS / "FreiHand" / "Frei_HRNet_w32_trainable_softmax_hm-pose2dloss_v1.yaml"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("readers")
    trees.write_rhd(root, "training", 6, seed=0)
    trees.write_rhd(root, "evaluation", 4, seed=1, filters="mixed")
    trees.write_freihand(root, 4, 3)
    return root


def _cfgs(tiny_cfg, root, **extra):
    jcfg = tiny_cfg.clone()
    jcfg.DATA_DIR = str(root)
    for key, val in extra.items():
        jcfg.merge_from_list([key.replace("__", "."), val])
    jcfg.freeze()
    return jcfg, port_cfg(jcfg)


@pytest.mark.parametrize("full_frame", [False, True])
def test_raw_rhd_items_match_jax(root, full_frame):
    """RHDDataset / RHDFullFrameDataset without a transform: every item
    bit-equal (the frame, the crop, corner and size), both subsets; the
    trees hold visibility ties, which the two variants break differently."""
    cls, jcls = ((R.RHDFullFrameDataset, JR.RHDFullFrameDataset) if full_frame
                 else (R.RHDDataset, JR.RHDDataset))
    for subset in ("training", "evaluation"):
        got, want = cls(str(root), subset), jcls(str(root), subset)
        assert len(got) == len(want) > 0 and got.rescale == want.rescale == "crop_corner"
        for i in range(len(want)):
            assert_items_match(got[i], want[i], label=f"{subset}[{i}]")


def test_c24_raw_rhd_visibility_stays_in_rhd_order(root):
    """ROADMAP C24: the raw reader reorders pose2d into the standard legend
    but leaves visibility in RHD's order, as JAX's does; the keypoint
    reader reorders both."""
    ds = R.RHDDataset(str(root), "evaluation")
    anno = ds.anno_all
    for i in range(len(ds)):
        uv = np.asarray(anno[i]["uv_vis"])
        hand = slice(0, 21) if (uv[:21, 2] == 1).sum() >= (uv[21:, 2] == 1).sum() else slice(21, 42)
        vis_rhd = (uv[hand, 2:] == 1).astype(np.float32)
        item = ds[i]
        np.testing.assert_array_equal(item["visibility"], vis_rhd)
        np.testing.assert_allclose(item["pose2d"], (uv[hand, :2] - item["corner"])[IDX_RHD],
                                   atol=1e-5)
    assert any(not np.array_equal(ds[i]["visibility"], ds[i]["visibility"][IDX_RHD])
               for i in range(len(ds)))


@pytest.mark.parametrize("cls_name", ["RHDDatasetKeypoints", "RHDFullFrameDatasetKeypoints"])
@pytest.mark.parametrize("train", [False, True])
def test_rhd_keypoint_items_match_jax(tiny_cfg, root, cls_name, train):
    """Eval transforms, and the training chain with every augmentation on
    (both sides' generators seeded alike): the same targets and joints,
    images within one gray level."""
    jcfg, cfg = _cfgs(tiny_cfg, root, WITH_DATA_AUG=True, DATASET__MAX_ROTATION=40.0,
                      DATASET__MIN_SCALE=0.7, DATASET__MAX_SCALE=1.3,
                      DATASET__MAX_TRANSLATE=20.0, DATASET__FLIP=True)
    got = getattr(R, cls_name)(cfg, "training", None,
                               build_transforms(cfg, train, rng=np.random.default_rng(3)))
    want = getattr(JR, cls_name)(jcfg, "training", None,
                                 jax_transforms(jcfg, train, rng=np.random.default_rng(3)))
    for i in range(len(want)):
        assert_items_match(got[i], want[i], "gray", label=f"{cls_name}[{i}]")


def test_rhd_loaders_of_the_shipped_yaml_match_jax(root):
    """RHD_HRNet_w32_trainable_softmax_hm-pose2dloss_v1 (RHD_kpt to train,
    raw RHD to test, 256/64), WORKERS 0: the first batch of each loader."""
    jcfg, cfg = yaml_cfg(RHD_YAML, root)
    assert first_batches_match(jcfg, cfg, True)["RHD_kpt"]["imgs"].shape == (2, 256, 256, 3)
    assert first_batches_match(jcfg, cfg, False)["RHD"]["orig_imgs"].shape == (2, 320, 320, 3)


def test_freihand_items_and_evaluate_match_jax(tiny_cfg, root, tmp_path):
    """Raw items (PNG content under the .jpg names) bit-equal; keypoint items
    within a gray level; ``evaluate`` writes the same json and EPE."""
    jcfg, cfg = _cfgs(tiny_cfg, root)
    for subset in ("training", "evaluation"):
        got, want = F.FreiHandDataset(str(root), subset), JF.FreiHandDataset(str(root), subset)
        assert len(got) == len(want) == (26048 if subset == "training" else 6512)
        for i in range(3):
            g, w = got[i], want[i]
            assert g["img_path"].replace(str(root), "") == w["img_path"].replace(str(root), "")
            assert_items_match(g, w, label=f"{subset}[{i}]")
        gk = F.FreiHandDatasetKeypoints(cfg, subset, None, build_transforms(cfg, False))
        wk = JF.FreiHandDatasetKeypoints(jcfg, subset, None, jax_transforms(jcfg, False))
        for i in range(3):
            assert_items_match(gk[i], wk[i], "gray", label=f"kpt {subset}[{i}]")
    ds, jds = F.FreiHandDataset(str(root), "evaluation"), JF.FreiHandDataset(str(root), "evaluation")
    preds = np.random.default_rng(4).uniform(0, 224, size=(3, 21, 2)).astype(np.float32)
    scores = np.array([0.5, 0.25, 1.0], np.float32)
    got = ds.evaluate(cfg, preds, scores, str(tmp_path / "port"))
    want = jds.evaluate(jcfg, preds, scores, str(tmp_path / "jax"))
    assert got["EPE_px"] == pytest.approx(want["EPE_px"], rel=1e-12) and got["EPE_px"] > 1
    with open(got["res_file"]) as f, open(want["res_file"]) as g:
        assert json.load(f) == json.load(g)
    assert F._coco_keypoint_results(preds) == JF._coco_keypoint_results(preds)
    assert F.project_points(np.eye(3) + 1, np.diag([2.0, 2.0, 1.0])).tolist() == \
        JF.project_points(np.eye(3) + 1, np.diag([2.0, 2.0, 1.0])).tolist()


def test_freihand_loaders_of_the_shipped_yaml_match_jax(root):
    """Frei_HRNet_w32_trainable_softmax_hm-pose2dloss_v1 (FreiHand_kpt to
    train, raw FreiHand to test), WORKERS 0, unshuffled: the first batch of
    each (the 80/20 split puts 26048 samples in the train loader, of which
    the tree holds the first four)."""
    jcfg, cfg = yaml_cfg(FREI_YAML, root, TRAIN__SHUFFLE=False)
    first_batches_match(jcfg, cfg, True)
    first_batches_match(jcfg, cfg, False)


def test_rhd_evaluation_slice_matches_jax(tiny_cfg, tmp_path):
    """The 2D evaluation slice on RHD: ``Evaluator2D`` (std, float32) on the
    raw RHD test set through the crop_corner rescale, on JAX's random
    weights carried by ``from_jax_variables``.  The tree's hands span 32 px,
    so each crop is 64 px, tiny_cfg's input: the warp is the identity and
    both packages see the same images.  Every result within 1e-5 relative
    (EPE in the 320 px frame's pixels)."""
    trees.write_rhd(tmp_path, "evaluation", 12, seed=2, extent=32)
    jcfg, cfg = _cfgs(tiny_cfg, tmp_path, DATASET__TEST_DATASET=["RHD"],
                      TEST__IMAGES_PER_GPU=4, WORKERS=0, TPU__COMPUTE_DTYPE="float32",
                      EXP_NAME="rhd_slice")
    rng = np.random.default_rng(0)
    jmodel = jax_build_model(jcfg)
    x = jnp.asarray(rng.normal(size=(2, 64, 64, 3)).astype(np.float32))
    variables = jax.tree.map(np.asarray, _activated_variables(jmodel, x, rng, temp=2.0))
    loader = make_test_dataloader(cfg)["RHD"]
    assert {float(b) for batch in loader for b in batch["crop_size"]} == {64.0}
    got = Evaluator2D(cfg, build_model(cfg), from_jax_variables(variables), device="cpu").run(
        loader, "RHD", str(tmp_path / "port"))
    want = JaxEvaluator2D(jcfg, jmodel, variables).run(
        jax_test_loaders(jcfg, n_devices=1)["RHD"], "RHD", str(tmp_path / "jax"))
    assert want["EPE_px"] > 1.0 and 0.0 < want["PCK_AUC_full"] < 1.0
    for key in ("EPE_px", "PCK_AUC_30", "PCK_AUC_full", "PCK@20px"):
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
    sub = "eval2D_results_rhd_slice"
    np.testing.assert_allclose(np.loadtxt(tmp_path / "port" / sub / "mse2d_each_joint.txt"),
                               np.loadtxt(tmp_path / "jax" / sub / "mse2d_each_joint.txt"),
                               atol=1.5e-4)
