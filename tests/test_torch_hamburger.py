"""The port's hamburger head (``models/hamburger.py``) against the JAX
package's: the three decomposition updates, ``NMFHam`` in train and eval
mode, the whole ``pose_hrnet_hamburger`` in float32 and bfloat16, its
evaluation through B4's twin, its train-mode gradient, ROADMAP C16 and the
bridge with the ``ham_bases`` collection.

tiny_cfg's HRNet (64 px, 16x16 maps) with R = 8 bases, 3 train and 4 eval
steps, B = 2; weights from ``tests/torch_zoo_parity.py``, the BN running
statistics those of the test images (``batch_statistics``).  Everything is
compared in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu.models import hamburger as jax_ham
from hrnet_hand_pose_estimation_tpu.ops.decode import soft_argmax as jax_soft_argmax
from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer
from hrnet_hand_pose_estimation_tpu_torch.models import build_model, hamburger
from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables, init_variables
from torch_train_parity import make_batch
from torch_zoo_parity import batch_statistics, jax_variables, rel_gap, train_grads, zoo_cfgs

torch.set_num_threads(1)
B = 2
CFG = dict(MODEL__R=8, MODEL__TRAIN_STEPS=3, MODEL__EVAL_STEPS=4, MODEL__HAM_TYPE="NMF")


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def shared(tiny_cfg):
    """(JAX cfg, port cfg, JAX model float32, variables with ham_bases, the
    port model with them, images)."""
    jcfg, pcfg = zoo_cfgs(tiny_cfg, "pose_hrnet_hamburger", **CFG)
    jm = jax_build_model(jcfg)
    x = np.random.default_rng(1).normal(size=(B, 64, 64, 3)).astype(np.float32)
    variables = batch_statistics(jm, jax_variables(jm, 0, x[:1], False), x)
    variables["params"]["trainable_temp"] = np.float32(1.3)
    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(variables, model))
    return jcfg, pcfg, jm, variables, model, x


@pytest.mark.parametrize("kind", ["NMF", "VQ", "CD"])
def test_update_matches_jax(kind):
    """One update of each decomposition in float32: the new W and H within
    1e-4 of their largest value."""
    rng = np.random.default_rng(2)
    x = np.abs(rng.normal(size=(2, 16, 40))).astype(np.float32)
    w = rng.uniform(size=(2, 16, 6)).astype(np.float32)
    h = rng.uniform(size=(2, 6, 40)).astype(np.float32)
    if kind == "NMF":
        want, got = jax_ham.nmf_update(x, w, h), hamburger.nmf_update(t(x), t(w), t(h))
    elif kind == "VQ":
        want, got = jax_ham.vq_update(x, w, 100.0), hamburger.vq_update(t(x), t(w), 100.0)
    else:
        want, got = jax_ham.cd_update(x, w, 100.0), hamburger.cd_update(t(x), t(w), 100.0)
    for g, wv in zip(got, want):
        assert g.shape == wv.shape
        assert rel_gap(g, wv) <= 1e-4


@pytest.mark.parametrize("kind", ["NMF", "VQ", "CD"])
@pytest.mark.parametrize("train", [False, True])
def test_ham_matches_jax(kind, train):
    """``NMFHam`` with JAX's own bases (3 train steps, 4 eval steps), float32:
    the reconstruction within 1e-4 of its largest value."""
    x = np.random.default_rng(3).normal(size=(2, 8, 6, 16)).astype(np.float32)
    jm = jax_ham.NMFHam(rank=6, train_steps=3, eval_steps=4, ham_type=kind, dtype=jnp.float32)
    variables = jm.init(jax.random.key(0), x, train)
    want = jm.apply(variables, x, train)
    port = hamburger.NMFHam(16, 6, 3, 4, kind).train(train)
    port.load_state_dict({"bases": t(variables["ham_bases"]["w"])})
    with torch.no_grad():
        got = port(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert rel_gap(got, want) <= 1e-4, rel_gap(got, want)


def test_model_forward_and_b4_evaluation_match_jax(shared):
    """The whole model in float32: probabilities within 1e-5, the features
    within 1e-4 of their largest value.  The float32 decodes part by
    2.3e-4 px here (printed), past 1e-4, so the decode is held in float64
    on both sides, 1e-4 px (JAX's NMFHam casts
    its input to float32 even then; its softmax and the port's run in
    float32).  ``Evaluator2D`` (the logits through ``softmax_decode``, B4's
    twin here) gives the model's own float32 decode within 1e-4 px."""
    jcfg, pcfg, jm, variables, model, x = shared
    want = jax.jit(jm.apply, static_argnums=2)(variables, x, False)
    with torch.no_grad():
        got = model(t(x))
    assert got.heatmaps.shape == (B, 16, 16, 21) and model.head == "softmax"
    np.testing.assert_allclose(got.heatmaps.numpy(), np.asarray(want.heatmaps), rtol=0, atol=1e-5)
    assert rel_gap(got.features, want.features) <= 1e-4
    pose32 = TS.decode_heatmaps(got.heatmaps, True)
    gap32 = np.abs(pose32.numpy() - np.asarray(jax_soft_argmax(want.heatmaps))).max()
    print(f"float32 decode gap {gap32:.3g} px")
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        out64 = jax.jit(jm.clone(dtype=jnp.float64).apply, static_argnums=2)(
            v64, jnp.asarray(x, jnp.float64), False)
        want64 = np.asarray(jax_soft_argmax(out64.heatmaps))
    model64 = build_model(pcfg)
    model64.load_state_dict(from_jax_variables(variables, model64))
    with torch.no_grad():
        got64 = TS.decode_heatmaps(model64.double()(t(x)).heatmaps, True)
    np.testing.assert_allclose(got64.numpy(), want64, rtol=0, atol=1e-4)
    ev = Evaluator2D(pcfg, model, None, device="cpu")
    assert ev.decode_logits
    np.testing.assert_allclose(ev.forward(t(x)).numpy(), pose32.numpy(), rtol=0, atol=1e-4)


def test_bf16_forward_tracks_jax(shared):
    """bfloat16 autocast (the ham in float32 outside it) against JAX's
    ``dtype=bf16``: the probabilities no farther from JAX's bf16 ones than
    twice JAX's bf16 probabilities are from its float32 ones, max and mean."""
    _, _, jm, variables, model, x = shared
    f32 = np.asarray(jax.jit(jm.apply, static_argnums=2)(variables, x, False).heatmaps)
    jbf = np.asarray(jax.jit(jm.clone(dtype=jnp.bfloat16).apply, static_argnums=2)(
        variables, x, False).heatmaps)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = model(t(x)).heatmaps.numpy()
    d_port, d_wit = np.abs(got - jbf), np.abs(jbf - f32)
    assert d_wit.max() > 0
    assert d_port.max() <= 2 * d_wit.max() and d_port.mean() <= 2 * d_wit.mean()


def test_train_mode_gradient_matches_jax(shared):
    """The gradient of a linear function of the probabilities in train mode
    (BN on batch statistics, 3 ham steps of which the last is
    differentiated) against ``jax.grad`` of ``model.apply`` with all the
    variables: 1e-3 of max|g|, float32.  The bases get no gradient."""
    _, pcfg, jm, variables, _, x = shared
    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(variables, model))
    got, want, gmax = train_grads(jm, variables, model, x)
    gap = max((float((got[n] - want[n].double()).abs().max()) / gmax, n) for n in want)
    assert gap[0] <= 1e-3, gap
    assert not model.hamburger.ham.bases.requires_grad
    assert all(got[n].any() for n in ("hamburger.lower_bread.weight", "last_layer.3.weight",
                                       "conv1.weight"))


def test_steps_raise_c16_where_jax_fails(shared):
    """JAX's ``create_train_state`` keeps params and batch_stats only, so its
    train and eval steps fail on the missing ham_bases collection; the
    port's raise NotImplementedError naming C16 (so does ``Trainer``), and
    ``make_forward_fn`` runs, as JAX's does on the full variables."""
    jcfg, pcfg, jm, variables, model, x = shared
    batch = {k: jnp.asarray(v) for k, v in make_batch(4).items()}
    # the state create_train_state makes (parallel/train_step.py:73-91):
    # the params and batch_stats collections, no ham_bases
    tx = jax_ts.make_optimizer(jcfg, 1000)
    state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
    with pytest.raises(Exception, match="ham_bases"):
        jax_ts.make_train_step(jcfg, jm, tx)(state, batch)
    with pytest.raises(Exception, match="ham_bases"):
        jax_ts.make_eval_step(jcfg, jm)(state, batch)
    port = build_model(pcfg)
    pstate, ptx = TS.create_train_state(pcfg, port, device="cpu")
    for make in (lambda: TS.make_train_step(pcfg, port, ptx), lambda: TS.make_eval_step(pcfg, port),
                 lambda: Trainer(pcfg, port, {}, device="cpu")):
        with pytest.raises(NotImplementedError, match="C16"):
            make()
    heatmaps, pose = TS.make_forward_fn(pcfg, model)(t(x))
    assert heatmaps.shape == (B, 16, 16, 21) and pose.shape == (B, 21, 2)


def test_bridge_carries_the_bases_and_the_trunk_names(shared):
    """The strict bridge fills every key, the bases from ``ham_bases`` among
    them, and refuses a tree without them; the trunk and head keep
    PoseHRNet's names, so a PoseHRNet state loads into the hamburger's
    trunk; ``init_variables`` makes a full state with bases in [0, 1)."""
    _, pcfg, _, variables, model, _ = shared
    sd = from_jax_variables(variables, model)
    np.testing.assert_array_equal(sd["hamburger.ham.bases"].numpy(),
                                  variables["ham_bases"]["hamburger"]["ham"]["w"])
    with pytest.raises(KeyError, match="hamburger.ham.bases"):
        from_jax_variables({k: v for k, v in variables.items() if k != "ham_bases"}, model)
    trunk = hrnet_from_cfg(pcfg, head="softmax").state_dict()
    assert set(trunk) < set(model.state_dict())
    assert set(model.state_dict()) - set(trunk) == {k for k in model.state_dict()
                                                     if k.startswith("hamburger.")}
    state = init_variables(pcfg, 0)
    build_model(pcfg).load_state_dict(state)
    bases = state["hamburger.ham.bases"]
    assert bases.shape == (1, 512, 8) and 0 <= float(bases.min()) and float(bases.max()) < 1
