"""The port's cross-view fusion net (``models/multiview_hrnet.py``) and its
train step (``core/train_variants.make_train_step_mv``) against the JAX
package's, on shared weights.

2 views of tiny_cfg's HRNet at 64/16, float32 on both sides.  The JAX
variables are ``jax.eval_shape`` shapes filled from a numpy seed and
activated as in ``tests/test_torch_triangulation.py``; the port gets them
through ``from_jax_variables``.  The raw branch of the port's step is
decoded by ``ops.decode.softmax_decode`` (kernel B4 on the card, its twin
and the twin's autograd here); JAX decodes ``soft_argmax`` of the spatial
softmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu.core import train_variants as jax_tv
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu.models.multiview_hrnet import Aggregation as JaxAggregation
from hrnet_hand_pose_estimation_tpu.ops.targets import gaussian_targets as jax_targets
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core import train_variants as TV
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.models.multiview_hrnet import (Aggregation,
                                                                         MultiViewPoseNet)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import softmax_decode as SD
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import (from_jax_train_state,
                                                                from_jax_variables,
                                                                init_variables)
from tests.test_torch_triangulation import activate, init_like
from torch_train_parity import recorded

torch.set_num_threads(1)
V = 2


def mv_cfgs(tiny_cfg, **extra):
    """(JAX cfg, port cfg): tiny_cfg as the fusion net, 2 views, adam, float32."""
    cfg = tiny_cfg.clone()
    cfg.defrost()
    opts = ["MODEL.NAME", "multiview_pose_hrnet", "DATASET.NUM_VIEWS", V,
            "TPU.COMPUTE_DTYPE", "float32", "TRAIN.OPTIMIZER", "adam", "TRAIN.LR", 1e-3]
    for key, val in extra.items():
        opts += [key.replace("__", "."), val]
    cfg.merge_from_list(opts)
    cfg.freeze()
    return cfg, config_from_dict(cfg.to_dict())


def probabilities(rng, shape):
    x = rng.normal(size=shape).astype(np.float32) * 2
    b, v, h, w, k = shape
    e = np.exp(x.reshape(b, v, h * w, k) - x.reshape(b, v, h * w, k).max(2, keepdims=True))
    return (e / e.sum(2, keepdims=True)).reshape(shape).astype(np.float32)


@pytest.mark.parametrize("views", [2, 3])
def test_aggregation_matches_jax(views):
    """The fused maps (float32, 1e-6 of their largest) and the gradients of
    the input and of ``pair_fc`` (1e-5 of their largest) against
    ``jax.grad``, in JAX's pair order."""
    rng = np.random.default_rng(views)
    hm = probabilities(rng, (2, views, 8, 8, 5))
    fc = (rng.normal(size=(views * (views - 1), 64, 64)) / 8).astype(np.float32)
    g = rng.normal(size=hm.shape).astype(np.float32)
    jm = JaxAggregation(views, 8)

    def f(x, p):
        return jnp.sum(jm.apply({"params": {"pair_fc": p}}, x) * g)

    want = np.asarray(jm.apply({"params": {"pair_fc": jnp.asarray(fc)}}, jnp.asarray(hm)))
    want_dx, want_dfc = jax.grad(f, argnums=(0, 1))(jnp.asarray(hm), jnp.asarray(fc))
    agg = Aggregation(views, 8)
    sd = from_jax_variables({"params": {"aggregation": {"pair_fc": fc}}})
    assert list(sd) == ["aggregation.pair_fc"]
    agg.load_state_dict({"pair_fc": sd["aggregation.pair_fc"]})
    x = torch.from_numpy(hm).requires_grad_(True)
    got = agg(x)
    assert got.shape == hm.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    dx, dfc = torch.autograd.grad(got, (x, agg.pair_fc), torch.from_numpy(g))
    for a, b in ((dx, want_dx), (dfc, want_dfc)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.fixture(scope="module")
def shared(tiny_cfg):
    """(JAX cfg, port cfg, JAX net, its activated variables, the port net
    with them, views (B=1, V=2, 64, 64, 3))."""
    jcfg, pcfg = mv_cfgs(tiny_cfg)
    rng = np.random.default_rng(11)
    jm = jax_build_model(jcfg)
    views = rng.normal(size=(1, V, 64, 64, 3)).astype(np.float32)
    variables = activate(init_like(jm, rng, jnp.asarray(views), False), rng)
    variables["params"]["aggregation"]["pair_fc"] = (
        rng.normal(size=(2, 256, 256)) / 16).astype(np.float32)
    model = build_model(pcfg)
    assert isinstance(model, MultiViewPoseNet)
    model.load_state_dict(from_jax_variables(variables, model))
    return jcfg, pcfg, jm, variables, model, views


def test_multiview_net_matches_jax(shared):
    """float32, eval mode.  The raw heatmaps at the limit the triangulation
    tests hold this backbone's probabilities to (rtol 1e-2, atol 1e-6: the
    activated net's sharp softmax turns float32 rounding of the logits into
    ~5e-5 relative); the fused maps to 1e-6 of their largest against JAX's
    aggregation of the port's raw maps, and at the raw maps' limit against
    JAX's fused maps; the port's logits and temperature give its raw maps."""
    _, _, jm, variables, model, views = shared
    want = jm.apply(variables, jnp.asarray(views), False)
    with torch.no_grad():
        got = model(torch.from_numpy(views))
    for name in ("raw_heatmaps", "fused_heatmaps"):
        w = np.asarray(getattr(want, name))
        assert getattr(got, name).shape == w.shape == (1, V, 16, 16, 21)
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=1e-2, atol=1e-6,
                                   err_msg=name)
    fused = np.asarray(JaxAggregation(V, 16).apply(
        {"params": {"pair_fc": variables["params"]["aggregation"]["pair_fc"]}},
        jnp.asarray(got.raw_heatmaps.numpy())))
    np.testing.assert_allclose(got.fused_heatmaps.numpy(), fused, rtol=0,
                               atol=1e-6 * np.abs(fused).max())
    raw = torch.softmax((got.logits * got.temperature).reshape(1, V, 256, 21), dim=2)
    torch.testing.assert_close(raw.reshape(got.raw_heatmaps.shape), got.raw_heatmaps)
    assert np.asarray(want.raw_heatmaps).std() > 1e-4


def test_mv_train_step_matches_jax(shared, monkeypatch):
    """One adam step, float32, heatmap + pose2d losses, trainable
    temperature: the loss dict at rtol 1e-5; given JAX's gradients, the
    port's update gives JAX's parameters at 1e-3 LR and its moments exactly
    (``tests/test_torch_train_step.py``'s limits; the float32 gradients are
    reported, as there); the temperature's and ``pair_fc``'s gradients at
    1e-3 of their largest; the BN statistics at rtol 1e-5 + atol 1e-5
    (values of order 0.3 in this activated net); the raw decode went
    through ``softmax_decode`` once and its backward once."""
    jcfg, pcfg, jm, variables, _, views = shared
    rng = np.random.default_rng(12)
    pose = rng.uniform(2, 14, size=(1, V, 21, 2)).astype(np.float32)
    hm = np.asarray(jax_targets(jnp.asarray(pose.reshape(V, 21, 2)), jnp.ones((V, 21)), 16,
                                2.0)).reshape(1, V, 16, 16, 21)
    batch = {"images": views, "pose2d": pose, "visibility": np.ones((1, V, 21), np.float32),
             "target_heatmaps": hm}
    tx = jax_ts.make_optimizer(jcfg, 1000)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                              opt_state=tx.init(params))
    before = jax.device_get(state)
    log = []
    recorded(monkeypatch, jax_tv, log)
    with jax.disable_jit():
        after, jl = jax_tv.make_train_step_mv(jcfg, jm, tx)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    after, jgrads, jstats = jax.device_get(after), *jax.device_get(log[-1])

    calls = {"fwd": 0, "bwd": 0}
    real_decode, real_bwd = TV.softmax_decode, SD.softmax_decode_backward_reference

    def decode(*args):
        calls["fwd"] += 1
        return real_decode(*args)

    def bwd(*args):
        calls["bwd"] += 1
        return real_bwd(*args)

    monkeypatch.setattr(TV, "softmax_decode", decode)
    monkeypatch.setattr(SD, "softmax_decode_backward_reference", bwd)
    model = build_model(pcfg)
    pstate, ptx = TS.create_train_state(pcfg, model, device="cpu")
    pstate.load_state_dict(from_jax_train_state(before, model))
    launches = (SD.fused_softmax_decode.launches, SD.fused_softmax_decode.launches_bwd)
    pstate, pl = TV.pick_train_step(pcfg, model, ptx)(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert calls == {"fwd": 1, "bwd": 1}
    assert (SD.fused_softmax_decode.launches, SD.fused_softmax_decode.launches_bwd) == launches
    assert set(pl) == set(jl) == {"total_loss", "raw_loss", "fused_loss", "nonfinite_grads"}
    for key, val in jl.items():
        np.testing.assert_allclose(pl[key].item(), float(val), rtol=1e-5, err_msg=key)

    want_g = from_jax_variables({"params": jgrads})
    got_g = dict(zip(pstate.param_names, [p.grad for p in model.parameters()]))
    for name in ("backbone.trainable_temp", "aggregation.pair_fc"):
        w = want_g[name]
        assert float(w.abs().max()) > 0, name
        torch.testing.assert_close(got_g[name], w, rtol=0, atol=1e-3 * float(w.abs().max()))
    gmax = max(float(g.abs().max()) for g in want_g.values())
    gap = max(float((got_g[n] - want_g[n]).abs().max()) for n in want_g)
    print(f"float32 gradient gap {gap / gmax:.3g} of max|g| = {gmax:.4g}")

    model2 = build_model(pcfg)
    st2, tx2 = TS.create_train_state(pcfg, model2, device="cpu")
    sd = from_jax_train_state(before, model2)
    sd["batch_stats"].update(from_jax_train_state(before.replace(batch_stats=jstats),
                                                  model2)["batch_stats"])
    st2.load_state_dict(sd)
    with torch.no_grad():
        for name, p in model2.named_parameters():
            p.grad.copy_(want_g[name])
    st2, _ = TS.apply_guarded_update(pcfg, tx2, st2, {})
    ref, upd = from_jax_train_state(after, model2), st2.state_dict()
    lr = float(pcfg.TRAIN.LR)
    for name, val in ref["params"].items():
        assert float((upd["params"][name] - val).abs().max()) <= 1e-3 * lr, name
        for key in ("mu", "nu"):
            assert torch.equal(upd["opt_state"][key][name], ref["opt_state"][key][name]), name
    for name, val in ref["batch_stats"].items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(pstate.state_dict()["batch_stats"][name].numpy(),
                                       val.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


def test_eval_step_fails_as_in_jax(shared):
    """JAX's ``make_eval_step`` reads ``out.heatmaps``, which its
    ``MultiViewOutput`` lacks: calling it raises.  The port's eval step
    raises too, naming the finding (ROADMAP C13)."""
    jcfg, pcfg, jm, variables, model, views = shared
    state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"], opt_state=None)
    with pytest.raises(AttributeError, match="heatmaps"):
        jax_ts.make_eval_step(jcfg, jm)(state, {"images": jnp.asarray(views)})
    pstate, _ = TS.create_train_state(pcfg, model, device="cpu")
    with pytest.raises(NotImplementedError, match="C13"):
        TS.make_eval_step(pcfg, model)(pstate, {"images": torch.from_numpy(views)})


def test_weights_and_registry(tiny_cfg):
    """``init_variables`` fills every key of the fusion net, the bridge is
    strict about ``aggregation/pair_fc``, and without AGGRE the net has no
    aggregation and returns its raw maps as the fused ones."""
    _, pcfg = mv_cfgs(tiny_cfg)
    model = build_model(pcfg)
    sd = init_variables(pcfg, 0)
    assert sd["aggregation.pair_fc"].shape == (2, 256, 256)
    model.load_state_dict(sd)
    with pytest.raises(KeyError, match="pair_fc"):
        from_jax_variables({"params": {"aggregation": {"pair_fc2": np.zeros(1)}}}, None)
    _, plain = mv_cfgs(tiny_cfg, MODEL__AGGRE=False)
    net = build_model(plain)
    assert net.aggregation is None
    with torch.no_grad():
        out = net(torch.zeros(1, V, 64, 64, 3))
    assert out.fused_heatmaps is out.raw_heatmaps
