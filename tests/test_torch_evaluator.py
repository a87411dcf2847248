"""The port's 2D evaluator (core/evaluator.Evaluator2D) against the JAX
package's, on the same weights and the same Synthetic_kpt loader.

Both evaluators build their loaders from the same config; the weights are
the JAX package's "activated" random weights (tests/test_quant_infer.py)
carried across with ``utils/weights.from_jax_variables``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.core import quant_infer as JQ
from hrnet_hand_pose_estimation_tpu.core.evaluator import Evaluator2D as JaxEvaluator2D
from hrnet_hand_pose_estimation_tpu.data.build import make_dataloader as jax_make_dataloader
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core import evaluator as EV
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
from hrnet_hand_pose_estimation_tpu_torch.data.build import make_test_dataloader
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import HRNetOutput
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.conv_int8 import conv_int8
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.softmax_decode import fused_softmax_decode
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from tests.test_quant_infer import _activated_variables

torch.set_num_threads(1)
RESULT_KEYS = ("EPE_px", "PCK_AUC_30", "PCK_AUC_full", "PCK@20px")


def eval_cfg(tiny_cfg, **extra):
    cfg = tiny_cfg.clone()
    cfg.DATASET.DATASET = ["Synthetic_kpt"]
    cfg.DATASET.TEST_DATASET = ["Synthetic_kpt"]
    cfg.TEST.IMAGES_PER_GPU = 16          # 64 samples -> 4 batches
    cfg.WORKERS = 0
    cfg.EXP_NAME = "port_eval"
    for key, val in extra.items():
        cfg.merge_from_list([key.replace("__", "."), val])
    return cfg.freeze()


def activated(jcfg, temp=2.0):
    rng = np.random.default_rng(0)
    model = jax_build_model(jcfg)
    x = jnp.asarray(rng.normal(size=(2, 64, 64, 3)).astype(np.float32))
    return jax.tree.map(np.asarray, _activated_variables(model, x, rng, temp=temp))


def both(jcfg, variables, tmp_path, **kw):
    """(port results, JAX results, port dir, JAX dir) of one run each."""
    cfg = config_from_dict(jcfg.to_dict())
    port = Evaluator2D(cfg, build_model(cfg), from_jax_variables(variables), device="cpu", **kw)
    got = port.run(make_test_dataloader(cfg)["Synthetic_kpt"], "Synthetic",
                   str(tmp_path / "port"))
    jax_ev = JaxEvaluator2D(jcfg, jax_build_model(jcfg), variables, **kw)
    want = jax_ev.run(jax_make_dataloader(jcfg, is_train=False, n_devices=1)["Synthetic_kpt"],
                      "Synthetic", str(tmp_path / "jax"))
    sub = f"eval2D_results_{jcfg.EXP_NAME}"
    return got, want, tmp_path / "port" / sub, tmp_path / "jax" / sub


def test_std_float32_matches_jax(tiny_cfg, tmp_path):
    """float32 compute: every result to 1e-5 relative; the artifacts have
    JAX's shapes and formats (21 '%.4f' lines; 2x49 thresholds and curve),
    EPE per joint to the last printed digit, the PCK curve to one joint in
    the 1344 visible ones (an error on a threshold may round across it)."""
    jcfg = eval_cfg(tiny_cfg, TPU__COMPUTE_DTYPE="float32")
    variables = activated(jcfg)
    before = fused_softmax_decode.launches
    got, want, pdir, jdir = both(jcfg, variables, tmp_path)
    assert fused_softmax_decode.launches == before          # the CPU runs the twin
    assert want["EPE_px"] > 1.0 and 0.0 < want["PCK_AUC_full"] < 1.0
    for key in RESULT_KEYS:
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
    assert got["fps"] > 0.0
    for name in ("mse2d_each_joint.txt", "PCK2d.txt"):
        assert (pdir / name).exists() and (jdir / name).exists()
    port_lines = (pdir / "mse2d_each_joint.txt").read_text().splitlines()
    jax_lines = (jdir / "mse2d_each_joint.txt").read_text().splitlines()
    assert len(port_lines) == len(jax_lines) == 21
    assert all(len(line.split(".")[1]) == 4 for line in port_lines)
    np.testing.assert_allclose(np.loadtxt(pdir / "mse2d_each_joint.txt"),
                               np.loadtxt(jdir / "mse2d_each_joint.txt"), atol=1.01e-4)
    pck, jpck = np.loadtxt(pdir / "PCK2d.txt"), np.loadtxt(jdir / "PCK2d.txt")
    assert pck.shape == jpck.shape == (2, 49)
    np.testing.assert_array_equal(pck[0], jpck[0])
    np.testing.assert_allclose(pck[1], jpck[1], atol=1.0 / 1344 + 1e-7)


def test_std_bf16_matches_jax(tiny_cfg, tmp_path):
    """bf16 compute (the default): the two frameworks round to bf16 at other
    places (PERF.md); measured 0.090 px of EPE and 0.0011 of AUC
    apart, held at 0.25 px of EPE (1/16 of a heatmap pixel at this 4x
    rescale) and 0.02 of either AUC."""
    jcfg = eval_cfg(tiny_cfg)
    got, want, _, _ = both(jcfg, activated(jcfg), tmp_path)
    assert abs(got["EPE_px"] - want["EPE_px"]) <= 0.25
    for key in ("PCK_AUC_30", "PCK_AUC_full"):
        assert abs(got[key] - want[key]) <= 0.02, key


def test_softmax_head_decodes_logits_through_softmax_decode(tiny_cfg, monkeypatch):
    """A softmax head's eval forward is forward_logits + softmax_decode (B4
    on a card), and equals the JAX evaluator's decode of the probabilities
    to 1e-3 px (measured 6.7e-4: the two frameworks' float32 convs sum in
    other orders, and the activated weights at temperature 2 amplify it)."""
    jcfg = eval_cfg(tiny_cfg, TPU__COMPUTE_DTYPE="float32")
    variables = activated(jcfg)
    cfg = config_from_dict(jcfg.to_dict())
    ev = Evaluator2D(cfg, build_model(cfg), from_jax_variables(variables), device="cpu")
    calls = []
    real = EV.softmax_decode

    def spy(logits, temperature):
        calls.append((tuple(logits.shape), float(temperature)))
        return real(logits, temperature)

    monkeypatch.setattr(EV, "softmax_decode", spy)
    x = np.random.default_rng(3).normal(size=(3, 64, 64, 3)).astype(np.float32)
    got = ev.forward(torch.from_numpy(x)).numpy()
    assert calls == [((3, 16, 16, 21), 2.0)]
    jax_ev = JaxEvaluator2D(jcfg, jax_build_model(jcfg), variables)
    _, want = jax_ev.forward(variables, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3)


def test_plain_head_decodes_raw_maps_as_jax(tiny_cfg, monkeypatch):
    """pose_hrnet (plain head) with HEATMAP_SOFTMAX: true decodes its raw
    logits with soft_argmax, as the JAX evaluator does; no softmax_decode."""
    jcfg = eval_cfg(tiny_cfg, MODEL__NAME="pose_hrnet", TPU__COMPUTE_DTYPE="float32")
    variables = activated(jcfg)
    cfg = config_from_dict(jcfg.to_dict())
    ev = Evaluator2D(cfg, build_model(cfg), from_jax_variables(variables), device="cpu")
    monkeypatch.setattr(EV, "softmax_decode", lambda *a: pytest.fail("softmax_decode called"))
    x = np.random.default_rng(4).normal(size=(2, 64, 64, 3)).astype(np.float32)
    got = ev.forward(torch.from_numpy(x)).numpy()
    jax_ev = JaxEvaluator2D(jcfg, jax_build_model(jcfg), variables)
    _, want = jax_ev.forward(variables, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-3)


class _UniformHeatmapModel(torch.nn.Module):
    """Stub whose forward emits uniform probability maps: the soft-argmax of
    a uniform map is exactly the heatmap centre, a closed form that shows
    which rescale branch ran (tests/test_engine_fixes.py:380-390)."""

    def forward(self, images):
        hm = torch.full((images.shape[0], 16, 16, 21), 1.0 / 256)
        return HRNetOutput(heatmaps=hm, features=hm)


class _OneBatchLoader:
    def __init__(self, dataset, batch):
        self.dataset = dataset
        self.batch = batch
        self.batch_size = batch["imgs"].shape[0]

    def __len__(self):
        return 1

    def __iter__(self):
        yield self.batch


def _eval_epe_for_dataset(tiny_cfg, dataset):
    """EPE of the uniform stub on a corner-carrying batch: the decode is the
    centre (7.5, 7.5) and gt is 0, so EPE = sqrt(2) * 7.5 * the rescale
    factor: crop/hm = 32/16 on the crop_corner path, ow/hm = 64/16 on the
    orig-size path (mirrors tests/test_engine_fixes.py:392-413)."""
    cfg = config_from_dict(eval_cfg(tiny_cfg).to_dict())
    b = 2
    batch = {
        "imgs": np.zeros((b, 64, 64, 3), np.float32),
        "pose2d": np.zeros((b, 21, 2), np.float32),
        "visibility": np.ones((b, 21), np.float32),
        "corner": np.full((b, 2), 100.0, np.float32),
        "crop_size": np.full((b,), 32.0, np.float32),
    }
    ev = Evaluator2D(cfg, _UniformHeatmapModel(), device="cpu")
    return ev.run(_OneBatchLoader(dataset, batch))["EPE_px"]


def test_rescale_dispatch_is_reader_declared(tiny_cfg):
    """A reader without a ``rescale`` declaration takes the orig-size path
    even when its batches carry a ``corner``; only ``rescale = 'crop_corner'``
    takes the crop path (tests/test_engine_fixes.py:416-436)."""
    center_epe = float(np.hypot(7.5, 7.5))

    class PlainReader:
        orig_img_size = (64, 64)

    class CropReader:
        orig_img_size = (64, 64)
        rescale = "crop_corner"

    np.testing.assert_allclose(_eval_epe_for_dataset(tiny_cfg, PlainReader()),
                               center_epe * 64 / 16, rtol=1e-5)
    np.testing.assert_allclose(_eval_epe_for_dataset(tiny_cfg, CropReader()),
                               center_epe * 32 / 16, rtol=1e-5)


def test_fps_with_a_short_loader(tiny_cfg):
    """fps must be > 0 when the loader has fewer than 21 batches
    (tests/test_engine_fixes.py:161-183)."""
    cfg = config_from_dict(eval_cfg(tiny_cfg).to_dict())
    loader = make_test_dataloader(cfg)["Synthetic_kpt"]
    assert len(loader) == 4
    results = Evaluator2D(cfg, build_model(cfg), device="cpu").run(loader, "Synthetic")
    assert results["fps"] > 0.0
    assert np.isfinite([results[k] for k in RESULT_KEYS]).all()


def test_int8_matches_jax_from_one_calibration_record(tiny_cfg, tmp_path):
    """serving='int8' with the same saved calibration record on both sides:
    the decoded joints agree within the int8 slice's 0.05 px
    (tests/test_torch_quant_infer.py:75), which the 4x rescale makes
    0.2 px per coordinate: EPE within 0.3 px, the AUCs within 0.02
    (measured 0.016 px and 2e-4)."""
    jcfg = eval_cfg(tiny_cfg)
    variables = activated(jcfg)
    loader = jax_make_dataloader(jcfg, is_train=False, n_devices=1)["Synthetic_kpt"]
    amax = JQ.calibrate(jcfg, variables, [next(iter(loader))["imgs"]])
    record = str(tmp_path / "calibration.json")
    JQ.save_calibration(record, amax, jcfg)
    before = conv_int8.launches
    got, want, pdir, _ = both(jcfg, variables, tmp_path, serving="int8", calib_path=record)
    assert conv_int8.launches == before          # the CPU runs the twins
    assert abs(got["EPE_px"] - want["EPE_px"]) <= 0.3
    for key in ("PCK_AUC_30", "PCK_AUC_full"):
        assert abs(got[key] - want[key]) <= 0.02, key
    assert os.path.exists(pdir / "PCK2d.txt")


def test_int8_calibrates_on_the_first_batch(tiny_cfg):
    jcfg = eval_cfg(tiny_cfg)
    cfg = config_from_dict(jcfg.to_dict())
    ev = Evaluator2D(cfg, build_model(cfg), from_jax_variables(activated(jcfg)),
                     serving="int8", device="cpu")
    results = ev.run(make_test_dataloader(cfg)["Synthetic_kpt"], "Synthetic")
    assert ev._qparams is not None and np.isfinite([results[k] for k in RESULT_KEYS]).all()


def test_entry_checks(tiny_cfg):
    cfg = config_from_dict(eval_cfg(tiny_cfg).to_dict())
    with pytest.raises(NotImplementedError, match="A11"):
        Evaluator2D(cfg, build_model(cfg), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="unknown serving"):
        Evaluator2D(cfg, build_model(cfg), serving="fp8", device="cpu")
    plain = config_from_dict(eval_cfg(tiny_cfg, MODEL__HEATMAP_SOFTMAX=False).to_dict())
    with pytest.raises(ValueError, match="HEATMAP_SOFTMAX"):
        Evaluator2D(plain, build_model(plain), serving="int8", device="cpu")
    # the argmax decode of a non-softmax config
    ev = Evaluator2D(plain, build_model(plain), device="cpu")
    out = ev.forward(torch.zeros(1, 64, 64, 3))
    assert out.shape == (1, 21, 2) and torch.equal(out, out.round())
