"""The port's 3D training step against the JAX package's, on shared weights.

One ``make_train_step_3d`` step of the alg and the vol net (float32, the
tiny_cfg backbone, V2V at 32^3, B = 2 x 2 views) from the same variables,
batch and cuboid angle (``tests/torch3d_parity.py``): the losses, the
gradients (read from adam's first moment, mu = 0.1 g after one step), the
updated parameters and the BN statistics.  Then the trainable set
against JAX's ``freeze_labels``, and a JAX 3D ``TrainState`` carried over
and continued for one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.core import trainer3d as JT3
from hrnet_hand_pose_estimation_tpu.parallel.train_step import TrainState as JaxTrainState
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core import trainer3d as PT3
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.softmax_decode import fused_softmax_decode
from hrnet_hand_pose_estimation_tpu_torch.parallel.train_step import TrainState
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import (from_jax_train_state,
                                                                from_jax_variables)
from tests.torch3d_parity import (ORIG_SIZE, fixed_theta, jax_eigh64_grad,  # noqa: F401
                                  make_batch, nets, to_torch, train_cfg)

torch.set_num_threads(1)


def jax_state(jm, variables, cfg):
    tx = JT3.make_optimizer_3d(cfg, variables["params"], 1000)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                          opt_state=tx.init(params))
    return state, tx


def run_step_pair(tiny_cfg, monkeypatch, kind, seed, b):
    jcfg, pcfg = train_cfg(tiny_cfg, kind)
    jm, variables, model = nets(jcfg, kind, seed, b=b)
    batch = make_batch(kind, seed + 100, b=b)
    fixed_theta(monkeypatch, np.array([0.3, 0.71])[:b])
    state, tx = jax_state(jm, variables, jcfg)
    step = JT3.make_train_step_3d(jcfg, jm, tx, ORIG_SIZE[kind])
    new_j, loss_j = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.key(0))
    new_j = jax.device_get(new_j)

    ptx = PT3.make_optimizer_3d(pcfg, model, 1000)
    pstate = TrainState(model, ptx)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    launches = (fused_softmax_decode.launches, fused_softmax_decode.launches_bwd)
    pstep = PT3.make_train_step_3d(pcfg, model, ptx, ORIG_SIZE[kind])
    pstate, loss_p = pstep(pstate, to_torch(batch), torch.Generator())
    # the CPU runs B4's twins: no kernel launch
    assert (fused_softmax_decode.launches, fused_softmax_decode.launches_bwd) == launches
    return new_j, loss_j, pstate, loss_p, before, model


def mu_by_name(new_j, model):
    """JAX's first moments over the groups, {port parameter name: tensor}
    (0 for the frozen group), through ``from_jax_train_state``."""
    return from_jax_train_state(new_j, model)["opt_state"]["mu"]


def check_step(new_j, loss_j, pstate, loss_p, before, model, rel, upd=1e-3):
    """Losses within 2e-4; each parameter tensor's gradient within ``rel`` of
    JAX's in norm plus 1e-6 of the largest tensor's norm (a tensor whose
    exact gradient is 0, a bias before a BN or the final conv's bias before
    the spatial softmax, holds rounding only: 3e-4 against norms of
    1e2-1e4); each update where the gradient bound leaves its sign
    certain within ``upd`` of the step; frozen weights unchanged; BN
    statistics within 1e-4 of each tensor's largest (the forward's float32
    rounding through V2V moves a deep running mean by ~1e-5)."""
    for key, val in loss_j.items():
        np.testing.assert_allclose(float(loss_p[key]), float(val), rtol=2e-4, atol=1e-5,
                                   err_msg=key)
    labels = PT3.freeze_labels(model)
    mu_j = mu_by_name(new_j, model)           # mu = 0.1 g after one step
    mu_p = {n: v for n, v in zip(pstate.param_names, torch.split(
        pstate.opt_state["mu"], [p.numel() for p in model.parameters()]))}
    top = max(float(v.norm()) for v in mu_j.values())
    new_jsd = from_jax_variables({"params": new_j.params, "batch_stats": new_j.batch_stats},
                                 model)
    checked = 0
    for name, p in model.named_parameters():
        want, got = mu_j[name], mu_p[name].reshape(mu_j[name].shape)
        if labels[name] == "frozen":
            assert not got.any() and torch.equal(p.detach(), before[name]), name
            continue
        bound = rel * float(want.norm()) + 1e-6 * top
        assert float((got - want).norm()) <= bound, name
        # adam's first step is -lr * g / (|g| + eps): +-lr where the sign of g
        # is certain, |g| above the gradient's error bound
        d_p = (p.detach() - before[name]).reshape(-1)
        d_j = (new_jsd[name] - before[name]).reshape(-1)
        held = want.reshape(-1).abs() > bound
        assert ((d_p - d_j).abs()[held] <= upd * d_j.abs().max()).all(), name
        checked += int(held.sum())
    assert checked > 100
    # BN statistics of the train forward, frozen layers included
    stats = dict(model.named_buffers())
    for name, want in new_jsd.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(stats[name].numpy(), want.numpy(), rtol=0,
                                       atol=1e-4 * float(want.abs().max()) + 1e-7,
                                       err_msg=name)


def test_train_step_3d_alg_matches_jax(tiny_cfg, monkeypatch, jax_eigh64_grad):
    check_step(*run_step_pair(tiny_cfg, monkeypatch, "alg", seed=11, b=2), rel=1e-3)


def test_jax_state_carried_over_continues_the_trajectory(tiny_cfg, monkeypatch,
                                                         jax_eigh64_grad):
    """After one JAX step, ``from_jax_train_state`` carries the 3D state
    (the per-group adam's moments and counts included) to the port, and
    one more step on each side agrees as the first step does."""
    kind = "alg"
    jcfg, pcfg = train_cfg(tiny_cfg, kind)
    jm, variables, model = nets(jcfg, kind, seed=12)
    state, tx = jax_state(jm, variables, jcfg)
    step = JT3.make_train_step_3d(jcfg, jm, tx, ORIG_SIZE[kind])
    state, _ = step(state, {k: jnp.asarray(v) for k, v in make_batch(kind, 1).items()},
                    jax.random.key(0))
    state = jax.device_get(state)
    ptx = PT3.make_optimizer_3d(pcfg, model, 1000)
    pstate = TrainState(model, ptx)
    payload = from_jax_train_state(state, model)
    assert int(payload["opt_state"]["count"]) == 1 == int(payload["opt_state"]["sched_count"])
    pstate.load_state_dict(payload)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = make_batch(kind, 2)
    new_j, loss_j = step(jax.tree.map(jnp.asarray, state),
                         {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    pstate, loss_p = PT3.make_train_step_3d(pcfg, model, ptx, ORIG_SIZE[kind])(
        pstate, to_torch(batch), torch.Generator())
    assert int(pstate.opt_state["count"]) == 2 and int(pstate.step) == 2
    # the second adam step is no longer +-lr: where g2 cancels g1 in mu, its
    # update turns on small differences; held to 1e-2 of the step
    check_step(jax.device_get(new_j), loss_j, pstate, loss_p, before, model, rel=1e-3,
               upd=1e-2)


CODES = {"main": 1, "process": 2, "volume": 3, "frozen": 4}


def vol_net_params(tiny_cfg):
    """The JAX vol net's parameter tree (shapes only, random values) and the
    port net."""
    from tests.test_torch_triangulation import init_like, jax_net  # noqa: F401

    jcfg, pcfg = train_cfg(tiny_cfg, "vol", MODEL__VOL_CONFIDENCES=True)
    jm, variables, model = nets(jcfg, "vol", seed=13)
    return jcfg, pcfg, variables, model


def test_freeze_labels_match_jax(tiny_cfg):
    """JAX's ``freeze_labels`` tree mapped through the bridge gives the
    port's labels, name for name: stage4, the head and the confidence head
    'main', transition3 frozen."""
    jcfg, _, variables, model = vol_net_params(tiny_cfg)
    labels = JT3.freeze_labels(variables["params"], "vol")
    coded = jax.tree.map(lambda lab, leaf: np.full(np.shape(leaf), CODES[lab], np.float32),
                         labels, variables["params"])
    want = from_jax_variables({"params": coded})
    got = PT3.freeze_labels(model)
    assert set(got) == set(want)
    inverse = {v: k for k, v in CODES.items()}
    for name, label in got.items():
        assert inverse[int(want[name].reshape(-1)[0])] == label, name
    assert got["backbone.transition3.3.0.0.weight"] == "frozen"
    assert got["backbone.stage4.0.branches.0.0.conv1.weight"] == "main"
    assert got["backbone.last_layer.3.weight"] == "main"
    assert got["backbone.vol_confidences.head.0.weight"] == "main"
    assert got["backbone.trainable_temp"] == "frozen"
    assert {got[n] for n in got if n.startswith("volume_net")} == {"volume"}


def test_per_group_optimizer_matches_optax(tiny_cfg):
    """Three updates of ``make_optimizer_3d`` from random gradients against
    JAX's ``optax.multi_transform`` (LR steps at update 2): parameters
    within 1e-6 of the step, frozen ones unchanged."""
    jcfg, pcfg, variables, model = vol_net_params(tiny_cfg)
    jcfg = jcfg.clone()
    jcfg.defrost()
    jcfg.TRAIN.LR_STEP = [2]
    jcfg.freeze()
    pcfg = config_from_dict(jcfg.to_dict())
    jtx = JT3.make_optimizer_3d(jcfg, variables["params"], steps_per_epoch=1)
    jparams = jax.tree.map(jnp.asarray, variables["params"])
    jopt = jtx.init(jparams)
    ptx = PT3.make_optimizer_3d(pcfg, model, steps_per_epoch=1)
    pstate = TrainState(model, ptx)
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree.map(lambda x: rng.normal(size=np.shape(x)).astype(np.float32),
                             variables["params"])
        upd, jopt = jtx.update(jax.tree.map(jnp.asarray, grads), jopt, jparams)
        jparams = jax.tree.map(lambda a, b: a + b, jparams, upd)
        g = from_jax_variables({"params": grads}, None)
        flat = torch.cat([g[n].reshape(-1) for n in pstate.param_names])
        upd_p, pstate.opt_state = ptx.update(flat, pstate.opt_state, pstate.params)
        pstate.params.add_(upd_p)
    want = from_jax_variables({"params": jax.device_get(jparams)})
    got = dict(model.named_parameters())
    start = from_jax_variables({"params": variables["params"]})
    labels = PT3.freeze_labels(model)
    for name, w in want.items():
        if labels[name] == "frozen":
            assert torch.equal(got[name].detach(), start[name]), name
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_rmsprop_matches_optax():
    """optax.rmsprop(5e-5) (decay 0.9, eps 1e-8 inside the root) over four
    updates, against the critic's optimizer: updates within 1e-6 relative."""
    import optax

    from hrnet_hand_pose_estimation_tpu_torch.core.trainer3d_gan import make_critic_optimizer

    rng = np.random.default_rng(1)
    params = rng.normal(size=1000).astype(np.float32)
    jtx, ptx = optax.rmsprop(5e-5), make_critic_optimizer()
    jst, pst = jtx.init(jnp.asarray(params)), ptx.init(torch.from_numpy(params))
    for _ in range(4):
        g = rng.normal(size=1000).astype(np.float32) * rng.uniform(0, 3, size=1000).astype(
            np.float32)
        ju, jst = jtx.update(jnp.asarray(g), jst)
        pu, pst = ptx.update(torch.from_numpy(g), pst, torch.from_numpy(params))
        np.testing.assert_allclose(pu.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(pst["nu"].numpy(), np.asarray(jst[0].nu), rtol=1e-6)


def test_build_model_registers_the_triangulation_nets():
    """C11: ``build_model`` builds what ``build_triangulation_net`` builds
    from the smoke YAML and the LearnableTriangulation YAMLs; vol_CPM (whose
    YAMLs leave TRIANGULATION_MODEL_NAME at its default) builds the
    CPM-backed volumetric net."""
    import glob

    from hrnet_hand_pose_estimation_tpu_torch.config import load_config
    from hrnet_hand_pose_estimation_tpu_torch.models import build_model
    from hrnet_hand_pose_estimation_tpu_torch.models.triangulation import (
        build_triangulation_net)

    smoke = load_config("experiments/synthetic_vol_smoke.yaml")
    a, b = build_model(smoke), build_triangulation_net(smoke)
    assert type(a) is type(b) and not a.training
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}
    kinds = {}
    for path in sorted(glob.glob("experiments/LearnableTriangulation/*.yaml")):
        cfg = load_config(path)
        if str(cfg.MODEL.NAME) == "vol_CPM":
            net = build_model(cfg)
            assert type(net).__name__ == "VolumetricTriangulationNet"
            assert type(net.backbone).__name__ == "CPMVolumetric"
        elif str(cfg.MODEL.NAME) in ("alg", "ransac", "vol"):
            kinds[str(cfg.MODEL.NAME)] = type(build_model(cfg)).__name__
    assert kinds == {"alg": "AlgebraicTriangulationNet", "ransac": "RANSACTriangulationNet",
                     "vol": "VolumetricTriangulationNet"}
