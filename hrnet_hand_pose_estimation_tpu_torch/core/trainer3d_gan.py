"""WGAN-regularised 3D training.

Port of the JAX package's ``core/trainer3d_gan.py`` (reference
lib/core/function3D_GAN.py and tools/train3D_GAN.py:96-440): the generator
is a triangulation net, the critic the MLP ``Discriminator`` over
[pose3d | KCS Gram] features, trained as a WGAN with weight clipping
(MODEL.CLIP_VALUE) and MODEL.N_CRITIC critic steps per generator step.

Per batch: N_CRITIC critic steps (rmsprop, then every critic weight
clipped), the supervised 3D step of ``Trainer3D`` (with its guard), and an
adversarial generator step on ``-KCS_LOSS_FACTOR * mean(critic(fake))``:
two optimizer updates of the generator.  As in JAX, the critic step and the
adversarial step run the generator in train mode but keep its running BN
statistics as they were (JAX throws the forward's ``batch_stats`` away;
the port's BN writes them during the forward, so they are restored), and
the N_CRITIC critic steps of a batch turn the cuboid by one angle (JAX
reuses one key; here the generator's state is reset before each).

Data parallel (a process group of several ranks, as ``Trainer3D``): every
generator forward takes the global batch's BN statistics, the critic and
adversarial losses are global means (each rank's sum over the global
count), their gradients are summed over the ranks before rmsprop, the clip
and adam, which then give every rank the same weights; the critic starts
from rank 0's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..data.legends import KC_MATRIX
from ..models.triangulation import Discriminator
from ..parallel import distributed
from ..parallel.train_step import (Optimizer, TrainState, broadcast_state, count_sum,
                                   global_batch_stats, reduce_step)
from . import losses as L
from .metrics import AverageMeter
from .trainer3d import Trainer3D, _step_inputs, batch_for_step, forward_3d, make_train_step_3d


def critic_features(pose3d: torch.Tensor) -> torch.Tensor:
    """[pose3d | KCS Gram] feature vector, (B, K*3 + 20*20) float32
    (reference triangulation.py:20-44)."""
    kc = torch.as_tensor(KC_MATRIX, dtype=torch.float32, device=pose3d.device)
    bones = torch.einsum("jk,bkc->bjc", kc, pose3d.float())
    gram = torch.einsum("bjc,bkc->bjk", bones, bones)
    return torch.cat([pose3d.float().reshape(pose3d.shape[0], -1),
                      gram.reshape(gram.shape[0], -1)], dim=1)


CRITIC_FEATURES = 21 * 3 + 20 * 20
CRITIC_LR = 5e-5            # optax.rmsprop(5e-5), the standard WGAN recipe


@torch.no_grad()
def init_critic(critic: Discriminator, seed: int) -> None:
    """flax Dense's initial distributions from a ``torch.Generator`` seeded
    with ``seed`` (the numbers are not JAX's): kernels lecun-normal, biases 0."""
    gen = torch.Generator().manual_seed(int(seed))
    for fc in (critic.fc1, critic.fc2, critic.fc3):
        std = fc.in_features ** -0.5
        fc.weight.copy_(torch.randn(fc.weight.shape, generator=gen) * std)
        fc.bias.zero_()


def make_critic_optimizer() -> Optimizer:
    def constant(count: torch.Tensor) -> torch.Tensor:
        return torch.full((), CRITIC_LR, dtype=torch.float32, device=count.device)

    return Optimizer("rmsprop", constant)


class _KeepStats:
    """Restore a generator state's running BN statistics on exit."""

    def __init__(self, state: TrainState):
        self.state = state

    def __enter__(self):
        self.saved = (self.state.stats.clone(), self.state.counts.clone())

    def __exit__(self, *exc):
        self.state.stats.copy_(self.saved[0])
        self.state.counts.copy_(self.saved[1])
        return False


def batch_mean(scores: torch.Tensor, counts: L.CountSum) -> torch.Tensor:
    """The mean of the critic's scores over the batch; with ``counts`` (a
    data-parallel step's) this rank's share of the global batch's mean."""
    if counts is None:
        return scores.mean()
    return scores.sum() / counts(L._count(scores.numel(), scores))


def make_critic_step(cfg, model, critic: Discriminator, critic_tx: Optimizer, orig_size,
                     clip: float):
    """``step(critic_state, gen_state, batch, generator) -> (critic_state, loss)``
    (JAX core/trainer3d_gan.py:64-88): the WGAN critic loss
    mean(critic(fake)) - mean(critic(real)), an rmsprop update, every critic
    weight clipped to [-clip, clip]; data-parallel across ranks (see the
    module docstring)."""
    ranks = distributed.world_size()
    counts = count_sum(ranks)

    def step(critic_state: TrainState, gen_state: TrainState, batch: Dict,
             generator: Optional[torch.Generator]) -> Tuple[TrainState, torch.Tensor]:
        model.train()
        proj, _, _ = _step_inputs(cfg, batch, orig_size)
        with torch.no_grad(), _KeepStats(gen_state), global_batch_stats(ranks):
            fake = forward_3d(cfg, model, batch["images"], proj, generator).keypoints_3d
        with torch.enable_grad():
            loss = (batch_mean(critic(critic_features(fake)), counts)
                    - batch_mean(critic(critic_features(batch["pose3d"])), counts))
            critic_state.grads.zero_()
            loss.backward()
        loss = reduce_step(ranks, critic_state.grads, {"loss": loss.detach()})["loss"]
        with torch.no_grad():
            updates, critic_state.opt_state = critic_tx.update(
                critic_state.grads, critic_state.opt_state, critic_state.params)
            critic_state.params.add_(updates).clamp_(-clip, clip)
        critic_state.step = critic_state.step + 1
        return critic_state, loss

    return step


def make_gen_adv_step(cfg, model, critic: Discriminator, tx: Optimizer, orig_size,
                      gan_factor: float):
    """``step(gen_state, batch, generator) -> (gen_state, {'adv_loss'})``
    (JAX core/trainer3d_gan.py:92-111): the generator's adam update on
    ``-gan_factor * mean(critic(pose3d))``, the critic fixed, no guard, the
    running statistics kept; data-parallel across ranks (see the module
    docstring)."""
    ranks = distributed.world_size()
    counts = count_sum(ranks)

    def step(gen_state: TrainState, batch: Dict, generator: Optional[torch.Generator]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model.train()
        proj, _, _ = _step_inputs(cfg, batch, orig_size)
        params = list(model.parameters())
        with torch.enable_grad(), _KeepStats(gen_state):
            with global_batch_stats(ranks):
                pose3d = forward_3d(cfg, model, batch["images"], proj, generator).keypoints_3d
            adv = -gan_factor * batch_mean(critic(critic_features(pose3d)), counts)
            gen_state.grads.zero_()
            adv.backward(inputs=params)
        adv = reduce_step(ranks, gen_state.grads, {"adv_loss": adv.detach()})["adv_loss"]
        with torch.no_grad():
            updates, gen_state.opt_state = tx.update(gen_state.grads, gen_state.opt_state,
                                                     gen_state.params)
            gen_state.params.add_(updates)
        gen_state.step = gen_state.step + 1
        return gen_state, {"adv_loss": adv}

    return step


class TrainerGAN3D(Trainer3D):
    """``Trainer3D`` with the WGAN critic loop."""

    def __init__(self, cfg, model, train_loaders, val_loaders=None, **kw):
        super().__init__(cfg, model, train_loaders, val_loaders, **kw)
        self.n_critic = int(cfg.MODEL.N_CRITIC)
        self.clip_value = float(cfg.MODEL.CLIP_VALUE)
        self.gan_factor = float(cfg.LOSS.KCS_LOSS_FACTOR)
        self.critic = Discriminator(CRITIC_FEATURES)
        init_critic(self.critic, int(cfg.TPU.SEED) + 2)
        self.critic.to(self.device).train()
        self.critic_tx = make_critic_optimizer()
        self.critic_state = TrainState(self.critic, self.critic_tx)
        broadcast_state(self.critic_state)
        self._critic_step = make_critic_step(cfg, model, self.critic, self.critic_tx,
                                             self.orig_size, self.clip_value)
        self._gen_adv_step = make_gen_adv_step(cfg, model, self.critic, self.tx,
                                               self.orig_size, self.gan_factor)
        self._base_step = make_train_step_3d(cfg, model, self.tx, self.orig_size)

    def train_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One batch: N_CRITIC critic steps on one cuboid angle, the base
        step, the adversarial step."""
        sb = batch_for_step(batch)
        angle_state = self.generator.get_state()
        closs = None
        for _ in range(self.n_critic):
            self.generator.set_state(angle_state)
            self.critic_state, closs = self._critic_step(self.critic_state, self.state, sb,
                                                         self.generator)
        self.state, losses = self._base_step(self.state, sb, self.generator)
        self.state, adv = self._gen_adv_step(self.state, sb, self.generator)
        out = dict(losses, adv_loss=adv["adv_loss"])
        if closs is not None:
            out["critic_loss"] = closs
        return out

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        meter = AverageMeter()
        print_freq = max(int(self.cfg.PRINT_FREQ), 1)
        for name, loader in self.train_loaders.items():
            loader.set_epoch(epoch)
            for i, batch in enumerate(self._batches(loader)):
                losses = self.train_batch(batch)
                if i % print_freq == 0:
                    host = {k: float(v) for k, v in losses.items()}
                    meter.update(host)
                    self.logger.info("GAN Epoch[%d] %s[%d/%d] %s", epoch, name, i, len(loader),
                                     " ".join(f"{k}={v:.4f}" for k, v in host.items()))
        return meter.averages()
