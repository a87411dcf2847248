"""The port's HandGraph, FHA, STB, COCO and MPII readers against the JAX
package's on the same tiny trees (``tests/torch_reader_trees.py``), item by
item, with their helpers (the .obj and .ply loaders, the camera and object
math, COCO's OKS-NMS evaluation); the loaders of the HandGraph, FHA and
joint-training YAMLs; finding C25.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

import torch_reader_trees as trees
from hrnet_hand_pose_estimation_tpu.data import build as JB
from hrnet_hand_pose_estimation_tpu.data import coco_mpii as JC
from hrnet_hand_pose_estimation_tpu.data import fha as JFHA
from hrnet_hand_pose_estimation_tpu.data import handgraph as JH
from hrnet_hand_pose_estimation_tpu.data import stb as JS
from hrnet_hand_pose_estimation_tpu.data.transforms import HandTransforms as JaxHandTransforms
from hrnet_hand_pose_estimation_tpu.data.transforms import build_transforms as jax_transforms
from hrnet_hand_pose_estimation_tpu_torch.data import build as B
from hrnet_hand_pose_estimation_tpu_torch.data import coco_mpii as C
from hrnet_hand_pose_estimation_tpu_torch.data import fha as FHA
from hrnet_hand_pose_estimation_tpu_torch.data import handgraph as H
from hrnet_hand_pose_estimation_tpu_torch.data import stb as S
from hrnet_hand_pose_estimation_tpu_torch.data.transforms import HandTransforms, build_transforms
from torch_reader_parity import (REPO_EXPERIMENTS, assert_items_match, first_batches_match,
                                 port_cfg, yaml_cfg)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("other")
    trees.write_handgraph(root, 3, 3)
    for subject, seed in (("Subject_1", 0), ("Subject_5", 1)):
        trees.write_fha(root, subject, 3, size=(480, 270), seed=seed)
    trees.write_stb(root, "B1Counting", 3)
    trees.write_coco(root / "coco", 3)
    trees.write_mpii(root / "mpii", 3)
    return root


def _cfgs(tiny_cfg, root, **extra):
    jcfg = tiny_cfg.clone()
    jcfg.DATA_DIR = str(root)
    for key, val in extra.items():
        jcfg.merge_from_list([key.replace("__", "."), val])
    jcfg.freeze()
    return jcfg, port_cfg(jcfg)


def test_handgraph_items_and_utils_match_jax(tiny_cfg, root, tmp_path):
    """Raw items (RGBA PNGs read with IMREAD_UNCHANGED, cut to RGB)
    bit-equal in both splits, keypoint items within a gray level; the
    file-name, camera and .obj helpers give JAX's values."""
    jcfg, cfg = _cfgs(tiny_cfg, root)
    for subset in ("training", "evaluation"):
        got, want = H.HandGraphDataset(str(root), subset), JH.HandGraphDataset(str(root), subset)
        assert got.image_paths == want.image_paths and len(got) > 0
        for i in range(len(want)):
            assert_items_match(got[i], want[i], label=f"{subset}[{i}]")
        gk = H.HandGraphDatasetKeypoints(cfg, subset, None, build_transforms(cfg, False))
        wk = JH.HandGraphDatasetKeypoints(jcfg, subset, None, jax_transforms(jcfg, False))
        for i in range(len(wk)):
            assert_items_match(gk[i], wk[i], "gray", label=f"kpt {subset}[{i}]")
    assert H.extract_pose_camera_id("handV2_l21_cam03_.0007.png") == (6, 2)
    cam = got.all_camera_params[1][2]
    np.testing.assert_array_equal(H.euler_xyz_to_rot_mx(cam[4:7]), JH.euler_xyz_to_rot_mx(cam[4:7]))
    pts = got.all_global_pose3d_gt[1]
    local = H.transform_global_to_cam(pts, cam)
    np.testing.assert_array_equal(local, JH.transform_global_to_cam(pts, cam))
    K = np.array([[cam[0], 0, 180.0], [0, cam[0], 180.0], [0, 0, 1.0]])
    uv = H.cam_projection(local, K)
    np.testing.assert_array_equal(uv, JH.cam_projection(local, K))
    np.testing.assert_allclose(H.cam_deprojection(uv, K, local[:, 2:]), local, atol=1e-9)
    obj = tmp_path / "hand.obj"
    with open(obj, "w") as f:
        f.writelines(f"v {i}.0 {i + 1}.0 {i + 2}.0\n" for i in range(6))
        f.writelines("vn 0.0 0.0 1.0\n" for _ in range(12))
        f.write("f 1/1/1 2/2/2 3/3/3\nf 1/1/1 2/2/2 6/6/6\nf 4/4/4 5/5/5 6/6/6\n")
    for arm in ((2, 4), (0, 0)):
        for a, b in zip(H.load_mesh_from_obj(str(obj), arm), JH.load_mesh_from_obj(str(obj), arm)):
            np.testing.assert_array_equal(a, b)
    tri = H.load_mesh_from_obj(str(obj), (0, 0))
    np.testing.assert_array_equal(H.get_mesh_tri_vertices(tri[0], tri[2]),
                                  JH.get_mesh_tri_vertices(tri[0], tri[2]))


def test_fha_items_windows_and_object_utils_match_jax(tiny_cfg, root, tmp_path):
    """FHA: single frames and 2-frame windows (raw, bit-equal), keypoint
    items (within a gray level), the .ply loader, object poses and
    skeletons as JAX reads them."""
    jcfg, cfg = _cfgs(tiny_cfg, root)
    for subset in ("training", "evaluation"):
        for n_frames in (1, 2):
            got = FHA.FHADataset(str(root), subset, n_frames=n_frames)
            want = JFHA.FHADataset(str(root), subset, n_frames=n_frames)
            assert got.samples == want.samples and len(got) > 0
            for i in range(len(want)):
                assert_items_match(got[i], want[i], label=f"{subset} x{n_frames}[{i}]")
        gk = FHA.FHADatasetKeypoints(cfg, subset, None, build_transforms(cfg, False))
        wk = JFHA.FHADatasetKeypoints(jcfg, subset, None, jax_transforms(jcfg, False))
        for i in range(len(wk)):
            assert_items_match(gk[i], wk[i], "gray", label=f"kpt {subset}[{i}]")
    mdir = tmp_path / "Object_models" / "milk_model"
    os.makedirs(mdir)
    with open(mdir / "milk_model.ply", "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\nproperty float y\n"
                "property float z\nelement face 2\nproperty list uchar int vertex_indices\n"
                "end_header\n0.01 0.02 0.03\n-0.01 0.0 0.02\n0.0 0.03 -0.01\n0.02 0.01 0.0\n"
                "3 0 1 2\n3 1 2 3\n")
    got, want = FHA.load_objects(str(tmp_path / "Object_models")), \
        JFHA.load_objects(str(tmp_path / "Object_models"))
    assert list(got) == list(want) == ["milk"]
    for key in ("verts", "faces"):
        np.testing.assert_array_equal(got["milk"][key], want["milk"][key])
    sample = {"subject": "Subject_5", "action_name": "pour_milk", "seq_idx": "1", "frame_idx": 2}
    skel_root = str(root / "FHA" / "Hand_pose_annotation_v1")
    np.testing.assert_array_equal(FHA.get_skeleton(sample, skel_root),
                                  JFHA.get_skeleton(sample, skel_root))
    tdir = tmp_path / "poses" / "Subject_5" / "pour_milk" / "1"
    os.makedirs(tdir)
    with open(tdir / "object_pose.txt", "w") as f:
        for i in range(3):
            f.write(f"{i} " + " ".join(str(v) for v in np.random.default_rng(i).normal(size=16))
                    + "\n")
    t = FHA.get_obj_transform(sample, str(tmp_path / "poses"))
    np.testing.assert_array_equal(t, JFHA.get_obj_transform(sample, str(tmp_path / "poses")))
    verts = got["milk"]["verts"]
    np.testing.assert_array_equal(FHA.transform_obj_verts(verts, t),
                                  JFHA.transform_obj_verts(verts, t))
    np.testing.assert_array_equal(FHA.project_fha(verts * 1e3), JFHA.project_fha(verts * 1e3))


def test_fha_jpeg_frames_go_to_cv2_as_in_jax(tiny_cfg, tmp_path):
    """Real JPEG frames (written by cv2): the port hands them to cv2, as the
    JAX package does, and the items are bit-equal."""
    trees.write_fha(tmp_path, "Subject_5", 2, size=(160, 90))
    color = tmp_path / "FHA" / "Videos" / "Subject_5" / "pour_milk" / "1" / "color"
    for name in os.listdir(color):
        cv2.imwrite(str(color / name), trees.image(90, 160, 7), [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert open(color / "color_0000.jpeg", "rb").read(2) == b"\xff\xd8"
    got, want = FHA.FHADataset(str(tmp_path), "evaluation"), \
        JFHA.FHADataset(str(tmp_path), "evaluation")
    for i in range(len(want)):
        assert_items_match(got[i], want[i], label=f"jpeg[{i}]")


def test_stb_items_match_jax(root):
    """STB's .mat ground truth through the depth -> colour transform, the
    joint order, mm -> cm and the palm -> wrist step: as JAX's; items
    bit-equal raw and within a gray level through a transform."""
    got, want = S.STBDataset(str(root), "evaluation"), JS.STBDataset(str(root), "evaluation")
    np.testing.assert_allclose(got.pose_gts, want.pose_gts, rtol=0, atol=1e-6)
    for key in ("pose_roots", "pose_scales", "K"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key), rtol=0, atol=1e-6)
    for i in range(len(want)):
        assert_items_match(got[i], want[i], label=f"raw[{i}]")
    got.transform, want.transform = HandTransforms(64, [16]), JaxHandTransforms(64, [16])
    for i in range(len(want)):
        assert_items_match(got[i], want[i], "gray", label=f"[{i}]")
    pose = np.random.default_rng(2).normal(size=(2, 21, 3))
    np.testing.assert_allclose(S.depth_to_color(pose), JS.depth_to_color(pose), atol=1e-12)
    np.testing.assert_array_equal(S.palm_to_wrist(pose), JS.palm_to_wrist(pose))


def test_coco_and_mpii_items_and_coco_evaluation_match_jax(root, tmp_path):
    """COCO (crowd and keypoint-less annotations skipped) and MPII items;
    COCO's evaluate (rescoring, per-image OKS-NMS on the port's
    ``ops/nms.oks_nms`` on the CPU here, the results json, OKS-AP) and
    evaluate_oks give JAX's results."""
    tr, jtr = HandTransforms(64, [16]), JaxHandTransforms(64, [16])
    coco, jcoco = C.COCOKeypointsDataset(str(root / "coco"), "val2017", tr, 16, 2.0), \
        JC.COCOKeypointsDataset(str(root / "coco"), "val2017", jtr, 16, 2.0)
    mpii, jmpii = C.MPIIDataset(str(root / "mpii"), "valid", tr, 16, 2.0), \
        JC.MPIIDataset(str(root / "mpii"), "valid", jtr, 16, 2.0)
    assert len(coco) == len(jcoco) == 3 and len(mpii) == len(jmpii) == 3
    for ds, jds in ((coco, jcoco), (mpii, jmpii)):
        for i in range(len(jds)):
            assert_items_match(ds[i], jds[i], "gray", label=f"{ds.name}[{i}]")
    gt = [s["keypoints"] for s in coco.samples]
    g = np.random.default_rng(5)
    preds = np.stack([np.concatenate([gt[0][:, :2], np.full((17, 1), 0.9)], 1),
                      np.concatenate([gt[1][:, :2] + 2.0, np.full((17, 1), 0.8)], 1),
                      np.concatenate([gt[0][:, :2] + 0.5, np.full((17, 1), 0.5)], 1),
                      np.concatenate([gt[2][:, :2] + g.normal(size=(17, 2)) * 4,
                                      g.uniform(size=(17, 1))], 1)]).astype(np.float32)
    boxes = np.array([[45, 45, 0.3, 0.3, 3600, 1.0]] * 4, np.float32)
    ids = [1, 2, 1, 3]
    nv, ap = coco.evaluate(preds, boxes, ids, str(tmp_path / "port"), device="cpu")
    jnv, jap = jcoco.evaluate(preds, boxes, ids, str(tmp_path / "jax"))
    assert nv["num_results"] == jnv["num_results"] == 3
    assert ap == pytest.approx(jap, rel=1e-9) and ap > 0.3
    with open(nv["res_file"]) as f, open(jnv["res_file"]) as h:
        assert json.load(f) == json.load(h)
    scores = np.array([0.9, 0.8, 0.5], np.float32)
    np.testing.assert_array_equal(coco.evaluate_oks(preds[:3, :, :2], scores, device="cpu"),
                                  jcoco.evaluate_oks(preds[:3, :, :2], scores))
    assert C.bbox_to_center_scale([10, 20, 30, 90], 0.75)[1].tolist() == \
        JC.bbox_to_center_scale([10, 20, 30, 90], 0.75)[1].tolist()


@pytest.mark.parametrize("yaml", ["HandGraph/HG_w32_256x256_adam_lr1e-3.yaml",
                                  "FHA/FHA_w32_256x256_adam_lr1e-3.yaml"])
def test_handgraph_and_fha_loaders_and_c25(root, yaml):
    """The HandGraph and FHA YAMLs (WORKERS 0, 2 a batch): the training
    loader's first batch as JAX's; their test sets, ``HandGraph`` and
    ``FHA``, are in neither registry (ROADMAP C25): KeyError in both."""
    jcfg, cfg = yaml_cfg(REPO_EXPERIMENTS / yaml, root)
    first_batches_match(jcfg, cfg, True)
    name = cfg.DATASET.TEST_DATASET[0]
    assert name in ("HandGraph", "FHA")
    for make in (lambda: B.make_dataloader(cfg, is_train=False),
                 lambda: JB.make_dataloader(jcfg, is_train=False, n_devices=1)):
        with pytest.raises(KeyError, match=f"Unknown dataset '{name}'"):
            make()


def test_joint_training_loaders_match_jax(tmp_path):
    """JointTraining_v1 trains on HandGraph_kpt, MHP_kpt, FreiHand_kpt and
    RHD_kpt at once: one loader each, every first batch as JAX's."""
    trees.write_handgraph(tmp_path, 2, 3, size=96)
    trees.write_mhp(tmp_path, {"data_1": 1})
    trees.write_freihand(tmp_path, 2, 0, size=96)
    trees.write_rhd(tmp_path, "training", 2, size=96)
    jcfg, cfg = yaml_cfg(REPO_EXPERIMENTS / "JointTraining" / "JointTraining_v1.yaml", tmp_path,
                         TRAIN__SHUFFLE=False)
    got = first_batches_match(jcfg, cfg, True)
    assert list(got) == ["HandGraph_kpt", "MHP_kpt", "FreiHand_kpt", "RHD_kpt"]
