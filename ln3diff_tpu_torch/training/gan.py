"""Adversarial VAE training: the StyleGAN discriminator head with the
hinge loss, R1 and ADA.

Port of ``ln3diff_tpu/training/gan.py`` (``GANConfig`` :26,
``hinge_d_loss`` :43, ``vanilla_g_loss`` :50, ``r1_penalty`` :55,
``calculate_adaptive_weight`` :66, ``AdversarialHead`` :74; JAX's
``disc_start_step`` and ``adaptive_weight`` fields, which nothing reads,
are not carried; reference
``nsr/losses/builder.py:866``, ``nsr/losses/disc.py``,
``dnnlib/util.py:41``).  The discriminator has its own train state: an
AdamW with betas (0, 0.99), no weight decay and no clip.  R1 is a double
backward: ``torch.autograd.grad(..., create_graph=True)`` of the logits'
sum with respect to the **augmented** real images.

The generator term judges the fake images by the **live** discriminator
(its current parameters, detached through ``train_state.frozen_apply``
so that the VAE's backward leaves it alone), the current ADA strength and
a fresh ADA draw.  (The JAX package's trainer captures the initial
discriminator, key and strength when it first traces its step:
``ROADMAP.md`` §3.)  The ADA controller runs on the host after the
discriminator steps, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..models.layers import random_init_
from ..models.stylegan import DiscriminatorConfig, StyleGANDiscriminator
from ..pipeline import resolve_device
from .augment import AugmentConfig, AugmentDraws, augment_pipe, update_ada_p
from .train_state import TrainState, frozen_apply, make_optimizer


@dataclasses.dataclass(frozen=True)
class GANConfig:
    disc: DiscriminatorConfig = DiscriminatorConfig()
    disc_lr: float = 2e-4
    adv_lambda: float = 0.01          # reference nv_patchD lambda
    r1_gamma: float = 1.0
    # adaptive discriminator augmentation (training/augment.py); None = off
    ada: Optional[AugmentConfig] = None
    ada_target: float = 0.6
    ada_interval: int = 4
    ada_kimg: float = 500.0


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor):
    return (torch.mean(F.relu(1.0 - logits_real))
            + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_g_loss(logits_fake: torch.Tensor):
    """The generator's hinge term: −E[D(fake)]."""
    return -torch.mean(logits_fake)


def r1_penalty(logits_real: torch.Tensor, real: torch.Tensor
               ) -> torch.Tensor:
    """E‖∇_x ΣD(x)‖² at the real images ``real`` (a leaf that requires
    grad) from their logits, differentiable in D's parameters (a double
    backward).  JAX's ``r1_penalty(apply, params, real)`` runs D itself;
    here the caller's forward is reused for the hinge term."""
    (grads,) = torch.autograd.grad(logits_real.sum(), real,
                                   create_graph=True)
    return torch.mean(torch.sum(torch.square(grads), dim=(1, 2, 3)))


def calculate_adaptive_weight(nll_grad_norm, g_grad_norm,
                              max_weight: float = 1e4):
    """Balance the adversarial against the reconstruction loss by their
    last-layer grad norms (reference ``dnnlib/util.py:41``)."""
    return torch.clamp(nll_grad_norm / (g_grad_norm + 1e-4), 0.0,
                       max_weight)


def apply_disc_grads(state: TrainState, loss: torch.Tensor):
    """Backpropagate a discriminator's ``loss`` into its ``state.params``
    and take one optimizer step (zeros for a parameter it misses)."""
    params = state.params
    for p in params.values():
        p.grad = None
    loss.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             for k, p in params.items()}
    for p in params.values():
        p.grad = None
    state.apply_gradients(grads)


class AdversarialHead:
    """Owns the discriminator, its train state and the ADA controller;
    gives the VAE trainer its two terms::

        g_adv = head.generator_loss(fake)        # added to the VAE loss
        d_metrics = head.disc_step(real, fake)   # one D update

    The discriminator's weights are drawn from ``seed`` and the ADA draws
    from a generator seeded with ``seed + 1``; both can be replaced (load
    into ``head.model``; pass ``draws``)."""

    def __init__(self, cfg: GANConfig = GANConfig(), seed: int = 0,
                 device='cuda'):
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.model = StyleGANDiscriminator(cfg.disc)
        random_init_(self.model, torch.Generator(
            device=self.device).manual_seed(seed))
        tx = make_optimizer(cfg.disc_lr, weight_decay=0.0, grad_clip=None,
                            betas=(0.0, 0.99))
        self.state = TrainState.create(self.model, tx)
        self.ada_p = 0.0
        self._ada_signs: list = []
        self._num_d_steps = 0
        self.generator = torch.Generator(
            device=self.device).manual_seed(seed + 1)

    def _aug(self, img, draws: Optional[AugmentDraws]):
        if self.cfg.ada is None:
            return img
        return augment_pipe(img, self.cfg.ada, self.ada_p, draws=draws,
                            generator=self.generator)

    def generator_loss(self, fake: torch.Tensor,
                       draws: Optional[AugmentDraws] = None):
        """``adv_lambda·(−E[D(aug(fake))])`` through the live, frozen
        discriminator; the grads reach ``fake``."""
        logits = frozen_apply(self.model, self._aug(fake, draws))
        return self.cfg.adv_lambda * vanilla_g_loss(logits)

    def d_loss(self, real, fake, draws=None):
        """(hinge + ½γ·R1, metrics) on augmented real and fake images;
        ``draws``: None or (the real images' AugmentDraws, the fake's)."""
        rd, fd = draws if draws is not None else (None, None)
        real = self._aug(real.detach(), rd).detach().requires_grad_(True)
        lr = self.model(real)
        lf = self.model(self._aug(fake.detach(), fd))
        loss = hinge_d_loss(lr, lf)
        r1 = r1_penalty(lr, real)
        total = loss + 0.5 * self.cfg.r1_gamma * r1
        return total, {'d_loss': loss, 'r1': r1,
                       'logits_real': lr.mean(), 'logits_fake': lf.mean(),
                       'real_sign': torch.sign(lr).mean()}

    def disc_step(self, real: torch.Tensor, fake: torch.Tensor,
                  draws=None) -> dict:
        """One discriminator update; every ``ada_interval`` steps (with
        ADA) the controller moves ``ada_p``."""
        total, metrics = self.d_loss(real, fake, draws)
        apply_disc_grads(self.state, total)
        self._num_d_steps += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics['d_total'] = total.detach()
        if self.cfg.ada is not None:
            self._ada_signs.append(metrics['real_sign'])
            if self._num_d_steps % self.cfg.ada_interval == 0:
                r_t = float(torch.stack(self._ada_signs).mean())
                self.ada_p = update_ada_p(
                    self.ada_p, r_t, batch_size=real.shape[0],
                    ada_target=self.cfg.ada_target,
                    ada_interval=self.cfg.ada_interval,
                    ada_kimg=self.cfg.ada_kimg)
                self._ada_signs = []
            metrics['ada_p'] = self.ada_p
        return metrics
