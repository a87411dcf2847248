"""The port's tools/accuracy_gate_full and make_quant_infer(pallas_layer1=False)
against the JAX package, on the CPU.

- ``batches()`` against the same samples built with the JAX package's own
  renderer, normalisation and targets (the JAX tool itself is not imported:
  at import it points JAX's compilation cache into the repository);
- make_quant_infer's ``pallas_layer1=False`` (the gate's reference walk)
  and the ``layer1_chain=False`` int8 path against JAX's on the same
  weights (``C26_LIMITS`` says at which gain and why);
- ``gate()`` on the tiny model against the same gate computed with the
  JAX package's functions (JAX's Pallas kernels in interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.core import quant_infer as JQ
from hrnet_hand_pose_estimation_tpu.models.hrnet import hrnet_from_cfg as jax_hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core import quant_infer as Q
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import precast_variables
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import (
    fused_bottleneck_chain)
from hrnet_hand_pose_estimation_tpu_torch.tools import accuracy_gate_full as G
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from tests.test_quant_infer import _activated_variables

torch.set_num_threads(1)
NORM = (JQ.IMAGENET_MEAN, JQ.IMAGENET_STD)


def jax_batches(seed, n, img, hm):
    """The JAX tool's ``_batches`` (tools/accuracy_gate_full.py:68-90) on the
    JAX package's functions."""
    from hrnet_hand_pose_estimation_tpu.data.synthetic import render_blob_image, synthetic_pose
    from hrnet_hand_pose_estimation_tpu.data.transforms import normalize_image
    from hrnet_hand_pose_estimation_tpu.ops.targets import gaussian_targets_np

    u8s, xfs, poses, hms = [], [], [], []
    for idx in range(n):
        rng = np.random.default_rng((seed, idx))
        pose3d = synthetic_pose(rng, size=img * 0.35)
        center = rng.uniform(0.35, 0.65, size=2) * img
        pose2d_img = pose3d[:, :2] + center
        u8 = render_blob_image(pose2d_img, img, rng)
        u8s.append(u8)
        xfs.append(normalize_image(u8))
        pose_hm = pose2d_img * hm / img
        poses.append(pose_hm.astype(np.float32))
        hms.append(gaussian_targets_np(pose_hm, np.ones(21, np.float32), hm, 2.0))
    return (np.stack(u8s), np.stack(xfs).astype(np.float32), np.stack(poses),
            np.stack(hms).astype(np.float32))


@pytest.mark.parametrize("seed,n,img,hm", [(0, 3, 256, 64), (1, 4, 64, 16)])
def test_batches_match_jax(seed, n, img, hm):
    got, want = G.batches(seed, n, img, hm), jax_batches(seed, n, img, hm)
    assert got[0].dtype == np.uint8 and np.array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert got[3].max() > 0.9          # the targets are not empty


def test_flagship_train_cfg_is_constant_adam():
    cfg = G.flagship_train_cfg()
    assert (cfg.MODEL.NAME, cfg.MODEL.IMAGE_SIZE, cfg.MODEL.HEATMAP_SIZE) == (
        "pose_hrnet_softmax", [256, 256], [64, 64])
    assert cfg.MODEL.EXTRA.STAGE4.NUM_CHANNELS == [32, 64, 128, 256]
    assert cfg.TRAIN.OPTIMIZER == "adam" and cfg.TRAIN.LR == 1.5e-3
    from hrnet_hand_pose_estimation_tpu_torch.parallel.train_step import make_lr_schedule

    sched = make_lr_schedule(cfg, 10)
    for count in (0, 299, 10 ** 6):
        assert float(sched(torch.tensor(count, dtype=torch.int32))) == pytest.approx(1.5e-3)


def weights_pair(tiny_cfg, gain=1.4):
    rng = np.random.default_rng(0)
    model = jax_hrnet_from_cfg(tiny_cfg, head="softmax")
    x = jnp.asarray(rng.normal(size=(4, 64, 64, 3)).astype(np.float32))
    v = jax.tree.map(np.asarray, _activated_variables(model, x, rng, gain=gain))
    cfg = config_from_dict(tiny_cfg.to_dict())
    return v, cfg, from_jax_variables(v)


# The folded bf16 layer1 does not round as XLA:CPU does: op by op, 6.8 % of
# layer1's bf16 outputs differ from JAX's by an ulp (conv sums in another
# order), jitted 30 % (XLA fuses the bias into the conv).  On the gain-1.4
# weights, which are chaotic in bf16, that moves the decode by up to 2.96 px
# (f32 walk) and 7.20 px (int8, layer1_chain=False); the bf16 chain kernel's
# twin by 4.45 and 12.38.  At gain 1.0 both sides are stable (decode std
# 0.69 px): 0.035 and 0.096 px, held below to 0.05 (the module's tolerance)
# and to the measured 0.1 (ROADMAP C3).
C26_LIMITS = {"f32_walk": 0.05, "layer1_chain_off": 0.1}


@pytest.mark.parametrize("case", list(C26_LIMITS))
def test_c26_layer1_off_matches_jax(tiny_cfg, case):
    """C26: the folded bf16 layer1 of ``pallas_layer1=False`` against JAX's
    at gain 1.0, where both are stable; the chain kernel's twin never runs
    with it, and runs once without it."""
    v, cfg, state = weights_pair(tiny_cfg, gain=1.0)
    u8 = np.random.default_rng(7).integers(0, 256, size=(4, 64, 64, 3)).astype(np.uint8)
    xf = ((u8.astype(np.float32) / 255.0 - np.asarray(NORM[0], np.float32))
          / np.asarray(NORM[1], np.float32))
    amax = JQ.calibrate(tiny_cfg, v, [xf])
    if case == "f32_walk":
        jq, qp, trunk, x, norm = {}, {}, "f32", xf, None
    else:
        jq = JQ.prepare_serving_qparams(tiny_cfg, v, amax, layer1_chain=False)
        qp = Q.prepare_serving_qparams(cfg, state, amax, layer1_chain=False)
        trunk, x, norm = "quant", u8, NORM
    want = np.asarray(JQ.make_quant_infer(tiny_cfg, interpret=True, pallas_layer1=False,
                                          trunk=trunk, input_norm=norm)(v, jq, jnp.asarray(x)))
    weights = precast_variables(cfg, state, device="cpu")
    calls = []

    def chain(*args, **kwargs):
        calls.append(1)
        return fused_bottleneck_chain(*args, **kwargs)

    Q.fused_bottleneck_chain = chain
    try:
        infer = Q.make_quant_infer(cfg, device="cpu", trunk=trunk, input_norm=norm,
                                   pallas_layer1=False)
        got = infer(weights, qp, torch.from_numpy(x)).numpy()
        assert not calls
        # pallas_layer1=True keeps the chain kernel (its twin on the CPU) there
        Q.make_quant_infer(cfg, device="cpu", trunk=trunk, input_norm=norm)(
            weights, qp, torch.from_numpy(x))
        assert calls == [1]
    finally:
        Q.fused_bottleneck_chain = fused_bottleneck_chain
    assert want.std() > 0.2
    gap = float(np.abs(got - want).max())
    print(f"{case}: port vs JAX pallas_layer1=False at gain 1.0: max {gap:.5f} px")
    np.testing.assert_allclose(got, want, atol=C26_LIMITS[case])


def jax_gate(jcfg, v, xs, scopes):
    """The JAX tool's gate (tools/accuracy_gate_full.py:132-176) on the JAX
    package's functions, interpret mode, without the training."""
    held = G.HELD
    _, xf_train, pose_train, _ = xs["train"]
    u8_held, xf_held, _, _ = xs["held-out"]
    ref_fn = JQ.make_quant_infer(jcfg, interpret=True, pallas_layer1=False, trunk="f32")
    ref_train = np.asarray(ref_fn(v, {}, jnp.asarray(xf_train[:held])))
    results = {"train_decode_err_px": float(np.abs(ref_train - pose_train[:held]).mean())}
    amax = JQ.calibrate(jcfg, v, [xf_train[:16]])
    q_fn = JQ.make_quant_infer(jcfg, interpret=True)
    u8_fn = JQ.make_quant_infer(jcfg, interpret=True, input_norm=NORM)
    for scope in scopes:
        qparams = JQ.prepare_serving_qparams(jcfg, v, amax, scope=scope)
        tag = "" if scope == "branch" else f"_{scope}"
        for name, xf, u8 in (("train", xf_train[:held], None), ("held-out", xf_held, u8_held)):
            ref = np.asarray(ref_fn(v, {}, jnp.asarray(xf)))
            got = np.asarray(q_fn(v, qparams, jnp.asarray(xf)))
            results[f"shift_int8{tag}_{name}"] = float(np.abs(got - ref).max())
            if u8 is not None:
                got = np.asarray(u8_fn(v, qparams, jnp.asarray(u8)))
                results[f"shift_uint8{tag}_{name}"] = float(np.abs(got - ref).max())
    ok = all(val < 0.1 for k, val in results.items() if k.startswith("shift_"))
    results["pass"] = bool(ok)
    return results, ref_train


def test_gate_matches_jax_gate(tiny_cfg):
    """gate() on the tiny model: JAX's keys, and every shift within 0.05 px
    of the JAX package's, on non-chaotic weights (gain 1.0); the gate
    fails there on the training error alone (random weights do not
    localise), which it reports in ``pass``."""
    v, cfg, state = weights_pair(tiny_cfg, gain=1.0)
    xs = {"train": G.batches(0, 4, 64, 16), "held-out": G.batches(1, 4, 64, 16)}
    got = G.gate(cfg, state, xs, device="cpu")
    want, ref_train = jax_gate(tiny_cfg, v, xs, G.SCOPES)
    assert list(got) == list(want)
    assert ref_train.std(axis=0).max() > 0.5
    for key, val in want.items():
        if key.startswith("shift_"):
            print(f"{key}: port {got[key]:.4f} px, JAX {val:.4f} px")
            assert abs(got[key] - val) <= 0.05, (key, got[key], val)
    assert got["train_decode_err_px"] == pytest.approx(want["train_decode_err_px"], abs=0.05)
    assert got["train_decode_err_px"] >= G.ERR_LIMIT and got["pass"] is False
