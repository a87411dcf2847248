"""The port's Trainer, checkpoints, warm starts, eval step and host data
pipeline, on tiny_cfg on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.data.pipeline import DataLoader as JaxLoader
from hrnet_hand_pose_estimation_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu.parallel.train_step import make_eval_step as jax_eval_step
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core.metrics import AverageMeter
from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer, pick_train_step
from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import (DataLoader, default_collate,
                                                                device_prefetch)
from hrnet_hand_pose_estimation_tpu_torch.data.synthetic import SyntheticDataset
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.layers import bn_levers_active, set_bn_levers
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.parallel.checkpoint import (CheckpointManager,
                                                                      load_pretrained,
                                                                      merge_pretrained)
from hrnet_hand_pose_estimation_tpu_torch.utils.logging_utils import ScalarWriter
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_train_state

torch.set_num_threads(1)


def port_cfg(tiny_cfg, tmp_path, **opts):
    cfg = config_from_dict(tiny_cfg.to_dict(), freeze=False)
    cfg.merge_from_list(["OUTPUT_DIR", str(tmp_path), "TRAIN.BEGIN_EPOCH", 1,
                         "TRAIN.END_EPOCH", 3, "PRINT_FREQ", 1, "WORKERS", 0]
                        + [x for k, v in opts.items() for x in (k.replace("__", "."), v)])
    return cfg.freeze()


def loaders(cfg, n=4, batch=2):
    return ({"synthetic": DataLoader(SyntheticDataset(cfg, length=n), batch, num_workers=2)},
            {"synthetic": DataLoader(SyntheticDataset(cfg, "validation", length=n), batch,
                                     shuffle=False, num_workers=0)})


def same_state(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(same_state(a[k], b[k]) for k in a)
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_fit_checkpoints_and_resumes_bit_identical(tiny_cfg, tmp_path):
    cfg = port_cfg(tiny_cfg, tmp_path)
    train, val = loaders(cfg)
    trainer = Trainer(cfg, build_model(cfg), train, val, output_dir=str(tmp_path), device="cpu")
    assert trainer.begin_epoch == 1
    trainer.fit()
    assert trainer.ckpt.epochs() == [1, 2] and trainer.train_global_steps == 4
    assert os.path.exists(tmp_path / "checkpoints" / "best.pt")
    assert np.isfinite(trainer.best_loss)
    fitted = trainer.state.state_dict()
    assert int(fitted["step"]) == 4 and int(fitted["opt_state"]["count"]) == 4
    assert int(fitted["batch_stats"]["bn1.num_batches_tracked"]) == 4

    resumed = Trainer(port_cfg(tiny_cfg, tmp_path, AUTO_RESUME=True), build_model(cfg), train,
                      val, output_dir=str(tmp_path), device="cpu")
    assert resumed.begin_epoch == 3 and resumed.train_global_steps == 4
    assert resumed.best_loss == trainer.best_loss
    assert same_state(fitted, resumed.state.state_dict())
    resumed.fit()                     # END_EPOCH 3: nothing left to train
    assert resumed.ckpt.epochs() == [1, 2]

    # the best snapshot warm-starts a fresh trainer (MODEL.HRNET_PRETRAINED)
    best = load_pretrained(str(tmp_path / "checkpoints" / "best.pt"))
    warm = Trainer(port_cfg(tiny_cfg, tmp_path / "w",
                            MODEL__HRNET_PRETRAINED=str(tmp_path / "checkpoints" / "best.pt")),
                   build_model(cfg), train, val, output_dir=str(tmp_path / "w"), device="cpu")
    assert same_state(best["params"], warm.state.state_dict()["params"])


def test_epoch_average_takes_every_step(tiny_cfg, tmp_path):
    cfg = port_cfg(tiny_cfg, tmp_path, PRINT_FREQ=1000)
    train, val = loaders(cfg, n=8)
    trainer = Trainer(cfg, build_model(cfg), train, val, output_dir=str(tmp_path), device="cpu")
    avgs = trainer.train_epoch(1)
    assert trainer.train_global_steps == 4 and np.isfinite(avgs["total_loss"])
    assert avgs["nonfinite_grads"] == 0.0


def test_flagged_dataset_is_skipped(tiny_cfg, tmp_path):
    cfg = port_cfg(tiny_cfg, tmp_path)
    train, val = loaders(cfg)
    train["synthetic"].dataset.exception = True
    trainer = Trainer(cfg, build_model(cfg), train, val, output_dir=str(tmp_path), device="cpu")
    p0 = trainer.state.params.clone()
    assert trainer.train_epoch(1) == {} and trainer.train_global_steps == 0
    assert torch.equal(p0, trainer.state.params)


def test_warm_start_copies_the_trunk_by_name(tiny_cfg, tmp_path):
    """MODEL.PRETRAINED: a reference .pth (``state_dict`` under a
    ``module.`` prefix) warm-starts the layers PRETRAINED_LAYERS names, with
    shapes checked; the head keeps its initialisation."""
    cfg = port_cfg(tiny_cfg, tmp_path)
    donor = build_model(cfg)
    gen = torch.Generator().manual_seed(5)
    state = {k: (torch.rand(v.shape, generator=gen) + 0.5 if v.is_floating_point() else v)
             for k, v in donor.state_dict().items()}
    state["stage2.0.branches.0.0.conv1.weight"] = torch.zeros(3, 3, 1, 1)   # wrong shape
    state["incre_modules.0.weight"] = torch.zeros(4)                          # not in the trunk
    path = tmp_path / "imagenet_trunk.pth"
    torch.save({"state_dict": {"module." + k: v for k, v in state.items()}}, path)
    layers = ["conv1", "bn1", "conv2", "bn2", "layer1", "transition1", "stage2",
              "transition2", "stage3", "transition3", "stage4", "incre_modules"]
    train, val = loaders(cfg)
    fresh = Trainer(cfg, build_model(cfg), train, val, output_dir=str(tmp_path / "f"),
                    device="cpu").state.state_dict()
    warm_cfg = port_cfg(tiny_cfg, tmp_path, MODEL__PRETRAINED=str(path))
    warm_cfg.defrost()
    warm_cfg.MODEL.EXTRA.PRETRAINED_LAYERS = layers
    warm_cfg.freeze()
    got = Trainer(warm_cfg, build_model(cfg), train, val, output_dir=str(tmp_path / "w"),
                  device="cpu").state.state_dict()
    for section in ("params", "batch_stats"):
        for name, val in got[section].items():
            trunk = name.split(".")[0] in layers
            if name == "stage2.0.branches.0.0.conv1.weight" or not trunk:
                assert torch.equal(val, fresh[section][name]), name
            else:
                assert torch.equal(val, state[name].to(val.dtype)), name
    assert torch.equal(got["params"]["last_layer.3.weight"], fresh["params"]["last_layer.3.weight"])


def test_unported_options_raise(tiny_cfg, tmp_path):
    """The options that raised before multistep training and the BN levers
    were ported now train: a Trainer with each fits one epoch (2 steps,
    finite losses, the levers armed and then put back)."""
    cfg = port_cfg(tiny_cfg, tmp_path)
    train, val = loaders(cfg)
    for opts in ({"TPU__STEPS_PER_DISPATCH": 2}, {"TPU__BN_STAT_SAMPLES": 2},
                 {"TPU__BN_STAT_DTYPE": "bfloat16"}):
        out = tmp_path / next(iter(opts)).lower()
        try:
            trainer = Trainer(port_cfg(tiny_cfg, out, TRAIN__END_EPOCH=2, **opts),
                              build_model(cfg), train, val, output_dir=str(out), device="cpu")
            assert bn_levers_active() == ("TPU__STEPS_PER_DISPATCH" not in opts)
            trainer.fit()
        finally:
            set_bn_levers()
        assert trainer.train_global_steps == 2 and trainer.ckpt.epochs() == [1]
        assert np.isfinite(trainer.best_loss)
    # CPM is ported: its own train and eval steps and samples; JAX keeps it
    # at one step per dispatch, so STEPS_PER_DISPATCH does not apply to it
    cpm = port_cfg(tiny_cfg, tmp_path, MODEL__NAME="CPM", MODEL__HEATMAP_SIZE=[8, 8],
                   TPU__STEPS_PER_DISPATCH=2)
    assert pick_train_step(cpm, None, None).__qualname__ == "make_train_step_cpm.<locals>.step"
    assert TS.make_eval_step(cpm, None).__qualname__ == "make_cpm_eval_step.<locals>.step"
    sample = SyntheticDataset(cpm)[0]
    assert sample["heatmaps"].shape == (8, 8, 22) and sample["centermaps"].shape == (64, 64, 1)


def test_eval_step_matches_jax(tiny_cfg, tmp_path):
    """Flip-test TTA with the shift, float32: heatmaps and decoded joints
    against the JAX eval step on the same weights and running statistics."""
    jcfg = tiny_cfg.clone()
    jcfg.defrost()
    jcfg.merge_from_list(["TPU.COMPUTE_DTYPE", "float32", "TEST.FLIP_TEST", True,
                          "TEST.SHIFT_HEATMAP", True])
    jcfg.freeze()
    cfg = config_from_dict(jcfg.to_dict())
    rng = np.random.default_rng(11)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    jm = jax_build_model(jcfg)
    variables = jm.init(jax.random.key(3), jnp.asarray(images[:1]), False)
    stats = jax.tree.map(lambda v: v + 0.1 * jnp.abs(jnp.sin(jnp.arange(v.size, dtype=v.dtype)
                                                              .reshape(v.shape))),
                         variables["batch_stats"])
    from hrnet_hand_pose_estimation_tpu.parallel.train_step import TrainState as JaxState

    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                      batch_stats=stats, opt_state=())
    want = jax_eval_step(jcfg, jm)(jstate, {"images": jnp.asarray(images)})
    model = build_model(cfg)
    state, _ = TS.create_train_state(cfg, model, device="cpu")
    payload = from_jax_train_state(jax.device_get(jstate), model)
    sd = state.state_dict()
    sd["params"], sd["batch_stats"] = payload["params"], payload["batch_stats"]
    state.load_state_dict(sd)
    got = TS.make_eval_step(cfg, model)(state, {"images": torch.from_numpy(images)})
    assert model.training                       # the eval step restores the mode
    np.testing.assert_allclose(got["heatmaps"].numpy(), np.asarray(want["heatmaps"]),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got["pose2d_pred"].numpy(), np.asarray(want["pose2d_pred"]),
                               atol=1e-4)
    heatmaps, pose = TS.make_forward_fn(cfg, model)(torch.from_numpy(images))
    np.testing.assert_allclose(heatmaps.numpy(), np.asarray(jax_forward_hm(jm, jstate, images)),
                               rtol=1e-4, atol=1e-7)
    assert pose.shape == (2, 21, 2) and model.training


def jax_forward_hm(jm, jstate, images):
    return jm.apply({"params": jstate.params, "batch_stats": jstate.batch_stats},
                    jnp.asarray(images), False).heatmaps


def test_synthetic_samples_and_loader_match_jax(tiny_cfg):
    cfg = config_from_dict(tiny_cfg.to_dict())
    port, ref = SyntheticDataset(cfg, length=6), JaxSynthetic(tiny_cfg, length=6)
    for i in (0, 5):
        a, b = port[i], ref[i]
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for workers in (0, 2):
        mine = list(DataLoader(port, 4, num_workers=workers, seed=3))
        theirs = list(JaxLoader(ref, 4, num_workers=workers, seed=3))
        assert len(mine) == len(theirs) == 1
        for key in mine[0]:
            np.testing.assert_array_equal(mine[0][key], theirs[0][key])
    loader = DataLoader(port, 4, drop_last=False, shuffle=False, num_workers=0)
    assert len(loader) == 2 and [b["imgs"].shape[0] for b in loader] == [4, 2]
    assert default_collate([{"a": np.ones(2), "p": "x"}])["p"] == ["x"]


def test_device_prefetch_on_cpu():
    batches = [{"x": np.full((2, 3), i, np.float32), "name": f"b{i}"} for i in range(5)]
    out = list(device_prefetch(iter(batches), "cpu", depth=2))
    assert [int(b["x"][0, 0]) for b in out] == list(range(5))
    assert all(isinstance(b["x"], torch.Tensor) for b in out) and out[3]["name"] == "b3"

    def broken():
        yield batches[0]
        raise RuntimeError("bad sample")

    with pytest.raises(RuntimeError, match="bad sample"):
        list(device_prefetch(broken(), "cpu"))
    gen = device_prefetch(iter(batches * 100), "cpu", depth=1)
    next(gen)
    gen.close()                                 # stops the copying thread


def test_checkpoint_manager_and_merge(tiny_cfg, tmp_path):
    cfg = port_cfg(tiny_cfg, tmp_path)
    state, _ = TS.create_train_state(cfg, build_model(cfg), device="cpu")
    ckpt = CheckpointManager(str(tmp_path / "c"), max_to_keep=2)
    assert ckpt.latest_epoch() is None and ckpt.restore(state) is None
    for epoch in (1, 2, 3):
        ckpt.save(epoch, state, extra={"best_loss": float(epoch)})
    assert ckpt.epochs() == [2, 3] and ckpt.latest_epoch() == 3
    meta = ckpt.restore(state, epoch=2)["meta"]
    assert meta["epoch"] == 2 and meta["best_loss"] == 2.0 and meta["train_global_steps"] == 0
    dst = {"a": torch.zeros(2), "b": torch.zeros(3)}
    merged, copied, skipped = merge_pretrained(dst, {"a": torch.ones(2, dtype=torch.float64),
                                                     "b": torch.ones(4), "c": torch.ones(1)})
    assert copied == ["a"] and sorted(skipped) == ["b", "c"]
    assert merged["a"].dtype == torch.float32 and torch.equal(merged["b"], dst["b"])


def test_meter_and_writer(tmp_path):
    meter = AverageMeter()
    meter.update({"loss": 2.0}, n=2)
    meter.update({"loss": 5.0}, n=1)
    assert meter.averages() == {"loss": 3.0}
    meter.reset()
    assert meter.averages() == {}
    writer = ScalarWriter(str(tmp_path))
    writer.add_scalar("train/loss", 1.0, 1)
    writer.close()
