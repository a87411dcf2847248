"""The port's WGAN 3D steps against the JAX package's ``TrainerGAN3D``.

The JAX steps are the trainer's own (``_build_gan_steps`` on a bare
instance, so no loader or init runs), on the alg net of
``tests/torch3d_parity.py`` (float32, tiny_cfg widths, B = 2 x 2 views)
and the critic from ``Discriminator.init``, carried to the port by
``discriminator_from_jax``.  Held: the critic loss, the clipped critic
weights, rmsprop's second moment (0.1 g^2), the
generator's running statistics and weights untouched by the critic steps
and its statistics by the adversarial step, and the adversarial step's
loss and gradients.

Tolerances: a random alg net's fake poses are DLTs of views that disagree,
far out, and the critic's Gram features are bones, differences of those
far points, so they carry the poses' float32 rounding many times over: the
two critic (and adversarial) losses differ by 2.6e-3 relative, the
adversarial gradients by 4e-3 per tensor.  Held to 1e-2 (losses, the
gradients per tensor plus 1e-6 of the largest) and 2e-2 (rmsprop's moment,
which squares the gradient); the critic weights, which three rmsprop steps
move by up to 4.7e-4 before the clip, to 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.core import trainer3d_gan as JG
from hrnet_hand_pose_estimation_tpu.models.triangulation import Discriminator as JaxDisc
from hrnet_hand_pose_estimation_tpu.parallel.train_step import TrainState as JaxTrainState
from hrnet_hand_pose_estimation_tpu_torch.core import trainer3d as PT3
from hrnet_hand_pose_estimation_tpu_torch.core import trainer3d_gan as PG
from hrnet_hand_pose_estimation_tpu_torch.models.triangulation import Discriminator
from hrnet_hand_pose_estimation_tpu_torch.parallel.train_step import TrainState
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import (discriminator_from_jax,
                                                                from_jax_train_state)
from tests.test_torch_trainer3d import jax_state
from tests.torch3d_parity import (ORIG_SIZE, jax_eigh64_grad, make_batch, nets,  # noqa: F401
                                  to_torch, train_cfg)

torch.set_num_threads(1)
CLIP = 0.01


def test_critic_features_match_jax():
    rng = np.random.default_rng(0)
    pose = rng.normal(size=(3, 21, 3)).astype(np.float32) * 50
    want = np.asarray(JG.critic_features(jnp.asarray(pose)))
    got = PG.critic_features(torch.from_numpy(pose)).numpy()
    assert got.shape == (3, PG.CRITIC_FEATURES)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.fixture
def gan_pair(tiny_cfg, jax_eigh64_grad):
    """The JAX steps, the port's, and their shared starting states."""
    kind = "alg"
    jcfg, pcfg = train_cfg(tiny_cfg, kind, LOSS__WITH_KCS_LOSS=True,
                           LOSS__KCS_LOSS_FACTOR=0.01, MODEL__CLIP_VALUE=CLIP)
    jm, variables, model = nets(jcfg, kind, seed=21)
    gen_j, tx_j = jax_state(jm, variables, jcfg)
    jt = JG.TrainerGAN3D.__new__(JG.TrainerGAN3D)
    jt.cfg, jt.model, jt.orig_size, jt.tx = jcfg, jm, ORIG_SIZE[kind], tx_j
    jt.clip_value, jt.gan_factor, jt.n_critic = CLIP, 0.01, 3
    jt.critic = JaxDisc()
    cvars = jt.critic.init(jax.random.key(2), JG.critic_features(jnp.zeros((1, 21, 3))))
    jt.critic_tx = JG.optax.rmsprop(5e-5)
    jt.critic_state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=cvars["params"],
                                    batch_stats={}, opt_state=jt.critic_tx.init(cvars["params"]))
    jt._build_gan_steps()

    tx_p = PT3.make_optimizer_3d(pcfg, model, 1000)
    gen_p = TrainState(model, tx_p)
    critic = Discriminator(PG.CRITIC_FEATURES)
    critic.load_state_dict(discriminator_from_jax(jax.device_get(cvars["params"])))
    critic_tx = PG.make_critic_optimizer()
    critic_p = TrainState(critic, critic_tx)
    steps = dict(critic=PG.make_critic_step(pcfg, model, critic, critic_tx, ORIG_SIZE[kind], CLIP),
                 adv=PG.make_gen_adv_step(pcfg, model, critic, tx_p, ORIG_SIZE[kind], 0.01))
    batch = make_batch(kind, seed=33)
    return jt, gen_j, gen_p, critic_p, steps, batch, model, critic


def test_critic_steps_match_jax(gan_pair):
    """Three critic steps on one batch and key: loss, clipped weights,
    rmsprop's moment; the generator's statistics and weights as they were."""
    jt, gen_j, gen_p, critic_p, steps, batch, model, critic = gan_pair
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cstate, key = jt.critic_state, jax.random.key(5)
    stats0, params0 = gen_p.stats.clone(), gen_p.params.clone()
    for _ in range(3):
        cstate, jloss = jt._critic_step(cstate, gen_j, jbatch, key)
        critic_p, ploss = steps["critic"](critic_p, gen_p, to_torch(batch), torch.Generator())
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-2)
    cstate = jax.device_get(cstate)
    want = discriminator_from_jax(cstate.params)
    for name, p in critic.named_parameters():
        assert float(p.detach().abs().max()) <= CLIP
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=2e-5)
    nu_j = discriminator_from_jax(cstate.opt_state[0].nu)
    nu_p = dict(zip(critic_p.param_names, torch.split(
        critic_p.opt_state["nu"], [p.numel() for p in critic.parameters()])))
    for name, want_nu in nu_j.items():
        got = nu_p[name].reshape(want_nu.shape)
        assert float((got - want_nu).abs().max()) <= 2e-2 * float(want_nu.abs().max()), name
    assert int(critic_p.step) == 3
    assert torch.equal(gen_p.stats, stats0) and torch.equal(gen_p.params, params0)


def test_adversarial_step_matches_jax(gan_pair):
    """The generator's adversarial adam step: its loss, its gradients (adam's
    first moment, 0.1 g) per tensor, frozen weights and running statistics
    unchanged."""
    jt, gen_j, gen_p, critic_p, steps, batch, model, _ = gan_pair
    new_j, adv_j = jt._gen_adv_step(gen_j, jt.critic_state,
                                    {k: jnp.asarray(v) for k, v in batch.items()},
                                    jax.random.key(6))
    stats0 = gen_p.stats.clone()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen_p, adv_p = steps["adv"](gen_p, to_torch(batch), torch.Generator())
    np.testing.assert_allclose(float(adv_p["adv_loss"]), float(adv_j["adv_loss"]), rtol=1e-2)
    assert torch.equal(gen_p.stats, stats0) and int(gen_p.step) == 1
    mu_j = from_jax_train_state(jax.device_get(new_j), model)["opt_state"]["mu"]
    mu_p = dict(zip(gen_p.param_names, torch.split(gen_p.opt_state["mu"],
                                                   [p.numel() for p in model.parameters()])))
    labels = PT3.freeze_labels(model)
    top = max(float(v.norm()) for v in mu_j.values())
    assert top > 0
    for name, want in mu_j.items():
        got = mu_p[name].reshape(want.shape)
        if labels[name] == "frozen":
            assert not got.any() and torch.equal(dict(model.named_parameters())[name].detach(),
                                                 before[name])
            continue
        assert float((got - want).norm()) <= 1e-2 * float(want.norm()) + 1e-6 * top, name
