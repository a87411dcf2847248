"""The port's CPM (``models/cpm.py``), its targets, its synthetic samples
and its train and eval steps against the JAX package's, on shared weights.

The JAX variables are built from ``jax.eval_shape`` of the module's init
(no init is run) and filled from a numpy seed: He-scaled kernels (gain 1.4,
so the six ReLU stages keep activations of order 1) and small random
biases, carried into the port by ``from_jax_variables``.  Both sides
compute in float32 at 64x64 (belief maps 8x8), B = 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu.core import train_variants as jax_tv
from hrnet_hand_pose_estimation_tpu.core.train_variants import make_train_step_cpm as jax_step
from hrnet_hand_pose_estimation_tpu.data import mhp as jax_mhp
from hrnet_hand_pose_estimation_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from hrnet_hand_pose_estimation_tpu.models.cpm import CPM as JaxCPM
from hrnet_hand_pose_estimation_tpu.ops import targets as jax_targets
from hrnet_hand_pose_estimation_tpu.utils.torch_convert import _resolve_cpm
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core import train_variants as TV
from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer
from hrnet_hand_pose_estimation_tpu_torch.data import mhp
from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import DataLoader
from hrnet_hand_pose_estimation_tpu_torch.data.synthetic import SyntheticDataset
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.cpm import CPM
from hrnet_hand_pose_estimation_tpu_torch.ops import targets
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import (from_jax_train_state,
                                                                from_jax_variables,
                                                                init_variables)
from torch_train_parity import recorded

torch.set_num_threads(1)
B, SIZE = 2, 64


def cpm_cfgs(tiny_cfg, **extra):
    """(JAX cfg, port cfg): tiny_cfg as a CPM at 64/8, adam, float32."""
    cfg = tiny_cfg.clone()
    cfg.defrost()
    opts = ["MODEL.NAME", "CPM", "MODEL.HEATMAP_SIZE", [8, 8], "MODEL.HEATMAP_SOFTMAX", False,
            "TPU.COMPUTE_DTYPE", "float32", "TRAIN.OPTIMIZER", "adam", "TRAIN.LR", 1e-3]
    for key, val in extra.items():
        opts += [key.replace("__", "."), val]
    cfg.merge_from_list(opts)
    cfg.freeze()
    return cfg, config_from_dict(cfg.to_dict())


def jax_variables(model, seed, *args):
    """A variable tree of ``model.init``'s shapes, filled from ``seed``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), *args))

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = fill(val)
            elif key == "kernel":
                fan_in = np.prod(val.shape[:-1])
                out[key] = (rng.standard_normal(val.shape) * 1.4 / np.sqrt(fan_in)).astype(
                    np.float32)
            else:
                out[key] = (0.05 * rng.standard_normal(val.shape)).astype(np.float32)
        return out

    return {coll: fill(dict(tree)) for coll, tree in dict(shapes).items()}


def inputs(seed):
    """Seeded images and the JAX package's centre maps at random centres."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(B, SIZE, SIZE, 3)).astype(np.float32)
    centers = rng.uniform(20, 44, size=(B, 2)).astype(np.float32)
    cmaps = np.asarray(jax_targets.gaussian_centermap(jnp.asarray(centers), SIZE))
    return images, cmaps


@pytest.fixture(scope="module")
def shared():
    """(JAX CPM float32, its variables, the port CPM with them, images, centre maps)."""
    jm = JaxCPM(num_joints=21, dtype=jnp.float32)
    images, cmaps = inputs(1)
    images.setflags(write=True)
    variables = jax_variables(jm, 0, images[:1], cmaps[:1], False)
    model = CPM(21).eval()
    model.load_state_dict(from_jax_variables(variables, model))
    return jm, variables, model, images, cmaps


def test_cpm_forward_matches_jax(shared):
    """The six belief maps, float32, atol 1e-4 (values of order 1)."""
    jm, variables, model, images, cmaps = shared
    want = [np.asarray(b) for b in jm.apply(variables, images, cmaps, False)]
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(cmaps))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 8, 8, 22) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4)
    assert 0.1 < np.abs(want[-1]).max() < 100 and want[-1].std() > 0.01


def test_cpm_bf16_forward_tracks_jax(shared):
    """The default bfloat16 compute (``torch.autocast``) against JAX's
    ``dtype=bf16``: the port's last belief map no farther from JAX's bf16
    one than twice JAX's bf16 map is from its float32 one (the rounding
    witness), in max and in mean."""
    jm, variables, model, images, cmaps = shared
    f32 = np.asarray(jm.apply(variables, images, cmaps, False)[-1])
    jax_bf16 = np.asarray(jm.clone(dtype=jnp.bfloat16).apply(variables, images, cmaps,
                                                               False)[-1])
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = model(torch.from_numpy(images), torch.from_numpy(cmaps))[-1]
    assert got.dtype == torch.float32
    d_port, d_wit = np.abs(got.numpy() - jax_bf16), np.abs(jax_bf16 - f32)
    assert d_wit.max() > 0
    assert d_port.max() <= 2 * d_wit.max() and d_port.mean() <= 2 * d_wit.mean()


def test_targets_and_centre_maps_match_jax():
    """``gaussian_centermap`` to 1e-6, ``cpm_heatmaps_np``, ``_cpm_center``,
    ``_cpm_centermap_np`` and ``cpm_normalize`` bit-equal."""
    rng = np.random.default_rng(3)
    centers = rng.uniform(-5, 70, size=(3, 2)).astype(np.float32)
    got = targets.gaussian_centermap(torch.from_numpy(centers), 64, 3.0).numpy()
    want = np.asarray(jax_targets.gaussian_centermap(jnp.asarray(centers), 64, 3.0))
    assert got.shape == (3, 64, 64, 1) and want.max() > 0.99
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    pose = rng.uniform(-3, 66, size=(21, 2)).astype(np.float32)
    for stride in (4.0, 8.0):
        hm = targets.cpm_heatmaps_np(pose, 64 // int(stride), 2.0, stride)
        assert hm.shape == (64 // int(stride),) * 2 + (22,)
        np.testing.assert_array_equal(hm, jax_targets.cpm_heatmaps_np(pose, 64 // int(stride),
                                                                      2.0, stride))
    np.testing.assert_array_equal(mhp._cpm_center(pose, 64, 64),
                                  jax_mhp._cpm_center(pose, 64, 64))
    np.testing.assert_array_equal(mhp._cpm_centermap_np(centers[0], 64),
                                  jax_mhp._cpm_centermap_np(centers[0], 64))
    img = rng.integers(0, 256, size=(8, 8, 3)).astype(np.uint8)
    np.testing.assert_array_equal(mhp.cpm_normalize(img), jax_mhp.cpm_normalize(img))


def test_synthetic_cpm_sample_matches_jax(tiny_cfg):
    """Under MODEL.NAME CPM the synthetic sample carries the centre map and
    the 22-channel targets, bit-equal to the JAX package's."""
    jcfg, pcfg = cpm_cfgs(tiny_cfg)
    got, want = SyntheticDataset(pcfg, "training")[3], JaxSynthetic(jcfg, "training")[3]
    assert set(got) == set(want) and got["heatmaps"].shape == (8, 8, 22)
    assert got["centermaps"].shape == (SIZE, SIZE, 1)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)


def test_cpm_train_step_matches_jax(tiny_cfg, shared, monkeypatch):
    """One adam step of ``make_train_step_cpm`` (float32, 21-channel targets
    given the background channel on the fly) from the same state: the loss
    at rtol 1e-5; given JAX's gradients, the port's update gives JAX's
    parameters at 1e-3 LR and its moments exactly (the limits of
    ``tests/test_torch_train_step.py``).  The float32 gradients are
    reported: a ReLU or max-pool input within rounding of a tie takes the
    other side in the two frameworks (3e-3 of max|g| measured here); they
    are held in float64 by the next test."""
    jm, variables, _, images, cmaps = shared
    jcfg, pcfg = cpm_cfgs(tiny_cfg)
    rng = np.random.default_rng(5)
    pose = rng.uniform(0, 8, size=(B, 21, 2)).astype(np.float32)
    hm = np.asarray(jax_targets.gaussian_targets(jnp.asarray(pose), jnp.ones((B, 21)), 8, 1.0))
    batch = {"images": images, "centermaps": cmaps, "target_heatmaps": hm}
    tx = jax_ts.make_optimizer(jcfg, 1000)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                              opt_state=tx.init(params))
    before = jax.device_get(state)
    log = []
    recorded(monkeypatch, jax_tv, log)
    with jax.disable_jit():
        after, jl = jax_step(jcfg, jm, tx)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    after, jgrads = jax.device_get(after), jax.device_get(log[-1][0])

    model = build_model(pcfg)
    pstate, ptx = TS.create_train_state(pcfg, model, device="cpu")
    pstate.load_state_dict(from_jax_train_state(before, model))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pstate, pl = TV.pick_train_step(pcfg, model, ptx)(pstate, tb)
    assert set(pl) == {"total_loss", "nonfinite_grads"} and set(jl) == set(pl)
    np.testing.assert_allclose(pl["total_loss"].item(), float(jl["total_loss"]), rtol=1e-5)
    want_g = from_jax_variables({"params": jgrads})
    got_g = dict(zip(pstate.param_names, [p.grad for p in model.parameters()]))
    gmax = max(float(g.abs().max()) for g in want_g.values())
    gap = max(float((got_g[n] - want_g[n]).abs().max()) for n in want_g)
    print(f"float32 gradient gap {gap / gmax:.3g} of max|g| = {gmax:.4g}")

    model2 = build_model(pcfg)
    st2, tx2 = TS.create_train_state(pcfg, model2, device="cpu")
    st2.load_state_dict(from_jax_train_state(before, model2))
    with torch.no_grad():
        for name, p in model2.named_parameters():
            p.grad.copy_(want_g[name])
    st2, _ = TS.apply_guarded_update(pcfg, tx2, st2, {})
    ref = from_jax_train_state(after, model2)
    upd = st2.state_dict()
    lr = float(pcfg.TRAIN.LR)
    for name, val in ref["params"].items():
        assert float((upd["params"][name] - val).abs().max()) <= 1e-3 * lr, name
        for key in ("mu", "nu"):
            assert torch.equal(upd["opt_state"][key][name], ref["opt_state"][key][name]), name


def test_cpm_gradients_match_jax_in_float64(shared):
    """The gradient of the CPM step's loss (the last stage against the
    22-channel target) with both models in float64: 1e-6 of max|g| (JAX's
    CPM hands its belief maps out in float32, whose rounding is the gap)."""
    from hrnet_hand_pose_estimation_tpu.core import losses as JL

    _, variables, _, images, cmaps = shared
    rng = np.random.default_rng(5)
    gt = rng.uniform(0, 1, size=(B, 8, 8, 22))
    with jax.enable_x64(True):
        jm = JaxCPM(num_joints=21, dtype=jnp.float64)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])

        def loss(p):
            pred = jm.apply({"params": p}, jnp.asarray(images, jnp.float64),
                            jnp.asarray(cmaps, jnp.float64), False)[-1]
            return JL.heatmap_loss(pred.astype(jnp.float64), jnp.asarray(gt))

        jgrads = jax.device_get(jax.grad(loss)(params))
    want = from_jax_variables({"params": jax.tree.map(np.asarray, jgrads)})
    model = CPM(21)
    model.load_state_dict(from_jax_variables(variables, model))
    model.double()
    pred = model(torch.from_numpy(images).double(), torch.from_numpy(cmaps).double())[-1]
    from hrnet_hand_pose_estimation_tpu_torch.core.losses import heatmap_loss

    heatmap_loss(pred.double(), torch.from_numpy(gt)).backward()
    gmax = max(float(g.abs().max()) for g in want.values())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0, atol=1e-6 * gmax,
                                   err_msg=name)


@pytest.mark.parametrize("softmax", [False, True])
def test_cpm_eval_step_matches_jax(tiny_cfg, shared, softmax):
    """The last stage without its background channel, decoded by the
    argmax (equal) or by the soft-argmax of the raw maps (1e-5 of the
    largest value: the maps are not normalised, so the "coordinates" are
    weighted sums of any size, up to ~130 here)."""
    jm, variables, _, images, cmaps = shared
    jcfg, pcfg = cpm_cfgs(tiny_cfg, MODEL__HEATMAP_SOFTMAX=softmax)
    state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats={}, opt_state=None)
    want = jax_ts.make_eval_step(jcfg, jm)(state, {"images": jnp.asarray(images),
                                                   "centermaps": jnp.asarray(cmaps)})
    model = build_model(pcfg)
    pstate, _ = TS.create_train_state(pcfg, model, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model))
    got = TS.make_eval_step(pcfg, model)(pstate, {"images": torch.from_numpy(images),
                                                  "centermaps": torch.from_numpy(cmaps)})
    assert model.training                        # the step restores the mode
    assert got["heatmaps"].shape == (B, 8, 8, 21)
    np.testing.assert_allclose(got["heatmaps"].numpy(), np.asarray(want["heatmaps"]), atol=1e-4)
    np.testing.assert_allclose(got["pose2d_pred"].numpy(), np.asarray(want["pose2d_pred"]),
                               rtol=0, atol=1e-5 * np.abs(want["pose2d_pred"]).max()
                               if softmax else 0)


def test_pick_train_step_routes_by_model_name(tiny_cfg):
    """CPM and the fusion net get their own steps, every other name the
    standard 2D step; STEPS_PER_DISPATCH > 1 batches the standard step only
    (JAX keeps CPM and mv at one step per dispatch)."""
    routes = {"CPM": "make_train_step_cpm", "multiview_pose_hrnet": "make_train_step_mv",
              "pose_hrnet_softmax": "make_train_step"}
    for name, builder in routes.items():
        _, pcfg = cpm_cfgs(tiny_cfg, MODEL__NAME=name)
        step = TV.pick_train_step(pcfg, None, None)
        assert step.__qualname__ == f"{builder}.<locals>.step", name


def test_leaf_names_are_the_reference_names(tiny_cfg):
    """Every port parameter is named as the reference CPM's: JAX's
    ``_resolve_cpm`` maps the name to a flax path of the JAX CPM, and
    ``from_jax_variables`` maps that path back to the name; the strict
    bridge fills every key, and ``init_variables`` makes a full CPM state."""
    jm = JaxCPM(num_joints=21)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                                            jnp.zeros((1, 64, 64, 1)), False))["params"]
    model = CPM(21)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == 2 * (7 + 3 + 5 * 6) and "pool_center" not in str(names)
    for name in names:
        stem, leaf = name.rsplit(".", 1)
        path, kind = _resolve_cpm(stem)
        assert kind == "conv"
        node = shapes
        for key in path:
            node = node[key]
        want = node["kernel" if leaf == "weight" else "bias"].shape
        got = tuple(model.state_dict()[name].shape)
        assert (got[2:] + got[1::-1] if leaf == "weight" else got) == tuple(want), name
        tree = {}
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node["kernel" if leaf == "weight" else "bias"] = np.zeros(want, np.float32)
        assert list(from_jax_variables({"params": tree})) == [name]
    _, pcfg = cpm_cfgs(tiny_cfg)
    build_model(pcfg).load_state_dict(init_variables(pcfg, 0))


def test_trainer_fits_cpm(tiny_cfg, tmp_path):
    """``Trainer`` on the synthetic CPM set: centre maps in the batch, the
    CPM step, validation against the targets without their background
    channel, a checkpoint."""
    _, pcfg = cpm_cfgs(tiny_cfg, OUTPUT_DIR=str(tmp_path), TRAIN__BEGIN_EPOCH=0,
                       TRAIN__END_EPOCH=1, PRINT_FREQ=1, WORKERS=0, TPU__STEPS_PER_DISPATCH=2)
    train = {"Synthetic_kpt": DataLoader(SyntheticDataset(pcfg, "training", length=4), 2)}
    val = {"Synthetic_kpt": DataLoader(SyntheticDataset(pcfg, "validation", length=2), 2)}
    trainer = Trainer(pcfg, build_model(pcfg), train, val, output_dir=str(tmp_path),
                      device="cpu")
    trainer.fit()
    assert trainer.train_global_steps == 2 and np.isfinite(trainer.best_loss)
    assert trainer.ckpt.epochs() == [0]
