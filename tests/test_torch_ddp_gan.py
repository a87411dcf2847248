"""The port's data-parallel WGAN steps: two gloo CPU ranks (run by the
JAX-free tests/torch_ddp_cases_child.py) against the JAX package's
``TrainerGAN3D`` steps (``_build_gan_steps`` on a bare instance), jitted
with the states replicated and the batch sharded over
``Mesh(devices[:2], ('data',))``, as its trainer runs them.

The alg net and batch of tests/test_torch_ddp3d.py (tiny_cfg widths,
float32, a global 2 samples x 2 views, JAX's eigh in float64 with a JVP),
the critic from ``Discriminator.init``: two critic steps on one key, then
the adversarial step against the updated critic, from the same initial
generator.  Held at tests/test_torch_trainer3d_gan.py's tolerances (the
critic and adversarial losses rtol 1e-2, the critic's weights atol 2e-5,
rmsprop's second moment 2e-2 of each tensor's largest, the adversarial
first moment 1e-2 of each tensor's norm + 1e-6 of the largest).  The
ranks are bit-equal, and the per-rank-statistics witness misses the
limits.  The critic's means have the same count on every rank, so its
per-rank denominators are the global ones: that witness would be the
data-parallel run and is not run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from hrnet_hand_pose_estimation_tpu.core import trainer3d_gan as JG
from hrnet_hand_pose_estimation_tpu.models.triangulation import Discriminator as JaxDisc
from hrnet_hand_pose_estimation_tpu.ops import geometry as JGeo
from hrnet_hand_pose_estimation_tpu.parallel.train_step import TrainState as JaxTrainState
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import (discriminator_from_jax,
                                                                from_jax_train_state)
from tests.test_torch_ddp3d import ALG_LR, batches3d, replicated, sharded
from tests.test_torch_trainer3d import jax_state
from tests.torch3d_parity import ORIG_SIZE, _Jnp64Grad, nets, train_cfg
from tests.torch_ddp_cases import WORLD, bit_equal, collect, spawn, tensor_ratio

torch.set_num_threads(1)
CLIP, GAN_FACTOR, N_CRITIC = 0.01, 0.01, 2


@pytest.fixture(scope="module")
def runs(tiny_cfg, tmp_path_factory):
    """The ranks' runs (started first), then JAX's SPMD WGAN steps."""
    jcfg, pcfg = train_cfg(tiny_cfg, "alg", LOSS__WITH_POSE2D_LOSS=True, TRAIN__LR=ALG_LR)
    jm, variables, model = nets(jcfg, "alg", seed=11)
    batch = batches3d("alg", 2, (101,))[0]
    critic = JaxDisc()
    cvars = critic.init(jax.random.key(2), JG.critic_features(jnp.zeros((1, 21, 3))))
    case = dict(name="gan", kind="gan", cfg=pcfg.to_dict(), model=model.state_dict(),
                batches=[batch], orig_size=ORIG_SIZE["alg"], n_critic=N_CRITIC, clip=CLIP,
                gan_factor=GAN_FACTOR, modes=["global", "local_bn"],
                critic=discriminator_from_jax(jax.device_get(cvars["params"])))
    work = tmp_path_factory.mktemp("ddp_gan")
    procs = spawn([case], work)

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JGeo, "jnp", _Jnp64Grad())
        gen_j, tx_j = jax_state(jm, variables, jcfg)
        jt = JG.TrainerGAN3D.__new__(JG.TrainerGAN3D)
        jt.cfg, jt.model, jt.orig_size, jt.tx = jcfg, jm, ORIG_SIZE["alg"], tx_j
        jt.clip_value, jt.gan_factor, jt.n_critic = CLIP, GAN_FACTOR, N_CRITIC
        jt.critic = critic
        jt.critic_tx = JG.optax.rmsprop(5e-5)
        jt._build_gan_steps()
        cstate = replicated(mesh, JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=cvars["params"], batch_stats={},
            opt_state=jt.critic_tx.init(cvars["params"])))
        gen_j = replicated(mesh, gen_j)
        gbatch = sharded(mesh)(batch)
        closs = []
        for _ in range(N_CRITIC):
            cstate, loss = jt._critic_step(cstate, gen_j, gbatch, jax.random.key(5))
            closs.append(float(loss))
        new_j, adv = jt._gen_adv_step(gen_j, cstate, gbatch, jax.random.key(6))
        cstate = jax.device_get(cstate)
    ref = {"critic_loss": closs, "critic": discriminator_from_jax(cstate.params),
           "nu": discriminator_from_jax(cstate.opt_state[0].nu),
           "adv_loss": float(adv["adv_loss"]),
           "mu": from_jax_train_state(jax.device_get(new_j), model)["opt_state"]["mu"]}
    return [r["gan"] for r in collect(procs, work)], ref


def gan_ratio(run, ref) -> float:
    """The worst gap over its limit (the module docstring's limits)."""
    worst = max(abs(g - w) / (1e-2 * abs(w)) for g, w in zip(run["critic_loss"],
                                                              ref["critic_loss"]))
    worst = max(worst, abs(run["adv_loss"] - ref["adv_loss"]) / (1e-2 * abs(ref["adv_loss"])))
    worst = max(worst, tensor_ratio(run["critic"]["params"], ref["critic"], 0.0, 2e-5))
    worst = max(worst, tensor_ratio(run["critic"]["opt_state"]["nu"], ref["nu"], 2e-2))
    mu_p, top = run["gen"]["opt_state"]["mu"], max(float(v.norm()) for v in ref["mu"].values())
    for name, w in ref["mu"].items():
        bound = 1e-2 * float(w.norm()) + 1e-6 * top
        worst = max(worst, float((mu_p[name].reshape(w.shape) - w).norm()) / bound)
    return worst


def test_two_ranks_match_jax_spmd_steps(runs):
    ranks, ref = runs
    for r in ranks:
        got = gan_ratio(r["global"], ref)
        print(f"WGAN: rank run at {got:.3g} of its limit")
        assert got <= 1.0


def test_two_ranks_are_bit_equal(runs):
    """The critic's and the generator's losses and states are bit-equal."""
    a, b = (r["global"] for r in runs[0])
    assert bit_equal(a, b)


def test_statistics_witness_misses_the_limits(runs):
    """The same steps with per-rank BN statistics in the generator's
    forwards land outside the limits."""
    ranks, ref = runs
    got = gan_ratio(ranks[0]["local_bn"], ref)
    print(f"WGAN local_bn: at {got:.3g} of the limit")
    assert got > 1.0


def test_critic_steps_keep_the_generator(runs):
    """The critic steps leave the generator's weights and statistics as they
    were, and so does the adversarial step its statistics (JAX throws the
    forwards' statistics away)."""
    for r in runs[0]:
        assert r["global"]["generator_kept"] and r["global"]["gen_stats_kept"]
