"""LSGM joint trainer: the VAE and the U-Net denoiser trained together
(the ShapeNet/FFHQ stage-2 trainer).

Port of ``ln3diff_tpu/training/lsgm_trainer.py`` (``LSGMConfig`` :37, the
joint loss of ``make_joint_loss_fn`` :46-189, ``LSGMTrainConfig`` :192,
``LSGMTrainer`` :206 with ``init_state`` :240, ``prepare_batch`` :286 and
``run_loop`` :306; reference ``nsr/lsgm/train_util_diffusion_lsgm_noD_
joint.py``).  One step over both parameter trees (the
``vae.*`` and ``ddpm.*`` names of one AdamW and one EMA):

* the reconstruction term of the VAE's patch render (``train_vae``);
* the prior (p) term: VPSDE ε matching with the mixing logit on the
  detached latent, or on the attached one under ``p_rendering_loss``,
  which also re-renders the denoised x0 prediction with the same render
  draws and adds its reconstruction loss;
* the q term (``joint_ce``): the vada CE through the **frozen** U-Net
  (``train_state.frozen_apply``, over detached parameters, the mixing
  logit detached: the grads reach the latent, not the U-Net) with the
  posterior's ``log_p``, through ``kl_balancer``;
* the latent's mean and std as metrics.

The VAE computes under autocast to its ``dtype`` and the U-Net under its
own, over f32 parameters; the renderer and the VPSDE arithmetic stay f32.
The step renders through the plain point pipeline, as JAX's does, and
takes the VAE trainer's patch render, crops, batch preparation and loop.

Randomness: the patch origins come from ``parallel.mesh.host_rng(seed)``,
the JAX trainer's host RNG; the posterior's ε, the render's uniforms and
the p and q terms' ``rho`` and noise are passed in (:class:`LSGMDraws`)
or drawn for the whole batch from a ``torch.Generator``
(:meth:`LSGMTrainer.draw`).  ``mesh=``: as the VAE trainer's, each rank
trains on its (data, fsdp) slice, grads averaged over those ranks.  JAX draws them
from ``k_vae, k_render, k_ddpm = split(rng, 3)``: ε from ``k_vae``, the
render from ``k_render``, the p term from ``k_t, k_n = split(k_ddpm)``
and the q term from ``split(fold_in(k_ddpm, 1))``.

Like JAX's, the trainer builds a ``TriplaneVAE``: it runs with the
``TriplaneVAEConfig`` presets only (``ROADMAP.md`` §3).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, NamedTuple, Optional

import torch
import torch.nn as nn

from ..diffusion.vpsde import (VPSDE, kl_balancer, kl_per_group_vada,
                               vpsde_cross_entropy_per_dim,
                               vpsde_training_losses)
from ..models.layers import random_init_, zero_init_like_jax
from ..models.vae import TriplaneVAE
from ..parallel.mesh import MeshConfig, host_rng, make_mesh
from ..pipeline import resolve_device
from ..render.renderer import RenderDraws, RenderOptions, draw_uniforms
from .losses import LossConfig, reconstruction_losses
from .train_state import (TrainState, build_train_step, frozen_apply,
                          make_optimizer)
from .vae_trainer import (crop_targets, prepare_patch_batch, render_patches,
                          train_loop)


@dataclasses.dataclass(frozen=True)
class LSGMConfig:
    iw_mode_p: str = 'drop_sigma2t_iw'   # prior objective t-sampling
    iw_mode_q: str = 'll_iw'             # CE t-sampling ('ll_*' only)
    p_rendering_loss: bool = False       # render-space loss on pred x0
    joint_ce: bool = True                # train the VAE through the prior
    ce_balanced_kl: float = 1.0
    train_vae: bool = True


class LSGMDraws(NamedTuple):
    """The random draws of one joint loss: the posterior's ε ``(B, h, w,
    z, 3)``, the render's uniforms (also those of the p-rendering
    re-render), and the p and q terms' uniform ``rho`` (B,) and noise (the
    latent's shape)."""
    eps: torch.Tensor
    render: RenderDraws
    p_rho: torch.Tensor
    p_noise: torch.Tensor
    q_rho: torch.Tensor
    q_noise: torch.Tensor


def _autocast(device, dtype):
    return torch.autocast(device.type, dtype=dtype,
                          enabled=dtype != torch.float32)


def make_joint_loss_fn(vae: TriplaneVAE, denoiser: nn.Module,
                       render_opts: RenderOptions, loss_cfg: LossConfig,
                       lsgm_cfg: LSGMConfig, patch_resolution: int,
                       render_resolution: int,
                       get_generator: Callable = lambda: None):
    """The joint loss ``loss_fn(params, constants, batch, draws) ->
    (loss, metrics)`` for ``train_state.build_train_step``; the modules
    hold the parameters.  batch: the patch-ray batch (img_to_encoder,
    img, depth, depth_mask, c, patch_h, patch_w) and an optional
    'context' for the denoiser.  Without ``draws`` every draw comes from
    ``get_generator()``."""
    if lsgm_cfg.p_rendering_loss and not lsgm_cfg.train_vae:
        # the re-render goes through the reconstruction's rays and targets
        raise ValueError('p_rendering_loss requires train_vae')
    sde = VPSDE()
    vae_dtype = vae.cfg.dtype
    den_dtype = getattr(getattr(denoiser, 'cfg', None), 'dtype',
                        torch.float32)
    mixed = getattr(getattr(denoiser, 'cfg', None), 'mixed_prediction',
                    False)

    def loss_fn(params, constants, batch, draws: Optional[LSGMDraws]):
        gen = get_generator()
        dev = batch['img_to_encoder'].device
        context = batch.get('context')

        with _autocast(dev, vae_dtype):
            moments = vae.encode(batch['img_to_encoder'])
            latent, posterior = vae.reparameterize(
                moments, True, eps=None if draws is None else draws.eps,
                generator=gen)
        # the render's draws are drawn once: the p-rendering re-render
        # takes the reconstruction's (JAX reuses k_render)
        render_draws = None if draws is None else draws.render
        metrics = {}
        total = 0.0

        def render(planes):
            return render_patches(vae, planes, batch, '', render_opts,
                                  patch_resolution, render_resolution,
                                  draws=render_draws)

        if lsgm_cfg.train_vae:
            with _autocast(dev, vae_dtype):
                planes = vae.decode_latent(latent)
            if render_draws is None and gen is not None:
                render_draws = draw_uniforms(batch['c'].shape[0],
                                             patch_resolution**2,
                                             render_opts, gen, dev)
            pred = render(planes)
            target = crop_targets(batch, '', patch_resolution)
            rec_total, rec_terms = reconstruction_losses(
                pred, target, loss_cfg, kl=posterior.kl())
            total = total + rec_total
            metrics.update({f'rec_{k}': v for k, v in rec_terms.items()})

        # ---- the prior (p) term, with the mixing logit -------------------
        mixing_logit = denoiser.mixing_logit if mixed else None

        def eps_fn(x_t, t):
            with _autocast(dev, den_dtype):
                return denoiser(x_t, t, context)

        # the denoiser trains on the detached latent (the VAE learns
        # through the q term); under p_rendering the latent stays attached
        ddpm_in = latent if lsgm_cfg.p_rendering_loss else latent.detach()
        out = vpsde_training_losses(
            sde, eps_fn, ddpm_in, mode=lsgm_cfg.iw_mode_p,
            mixing_logit=mixing_logit,
            rho=None if draws is None else draws.p_rho,
            noise=None if draws is None else draws.p_noise, generator=gen)
        p_loss = out['loss'].mean()
        total = total + p_loss
        metrics['p_eps_loss'] = p_loss

        if lsgm_cfg.p_rendering_loss:
            iw = out['iw']
            logsnr = sde.log_snr(iw.m_t, iw.var_t)
            pred_x0 = sde.predict_x0_from_eps(out['x_t'], out['pred_eps'],
                                              logsnr)
            with _autocast(dev, vae_dtype):
                planes_p = vae.decode_latent(pred_x0)
            pred_p = render(planes_p)
            p_rec_total, _ = reconstruction_losses(pred_p, target, loss_cfg)
            total = total + p_rec_total
            metrics['p_rendering_loss'] = p_rec_total

        if lsgm_cfg.joint_ce and lsgm_cfg.train_vae:
            # the q term through the frozen prior: the grads reach the
            # latent (and so the VAE), not the U-Net
            def eps_fn_q(x_t, t):
                with _autocast(dev, den_dtype):
                    return frozen_apply(denoiser, x_t, t, context)

            neg_log_p = vpsde_cross_entropy_per_dim(
                sde, eps_fn_q, latent, mode=lsgm_cfg.iw_mode_q,
                mixing_logit=None if mixing_logit is None
                else mixing_logit.detach(),
                rho=None if draws is None else draws.q_rho,
                noise=None if draws is None else draws.q_noise,
                generator=gen)
            # the posterior keeps the interleaved (z, 3) view
            log_q = posterior.log_p(
                latent.reshape(posterior.mean.shape)).reshape(latent.shape)
            kl_vada, _ = kl_per_group_vada(log_q, neg_log_p)
            ce_loss = kl_balancer(kl_vada[:, None],
                                  kl_coeff=lsgm_cfg.ce_balanced_kl)
            total = total + ce_loss
            metrics['ce_balanced_kl'] = ce_loss
            metrics['log_q'] = log_q.mean()

        metrics['latent_mean'] = latent.mean()
        metrics['latent_std'] = latent.std(correction=0)
        return total, metrics

    return loss_fn


@dataclasses.dataclass
class LSGMTrainConfig:
    lr: float = 1e-4
    weight_decay: float = 0.01
    grad_clip: float = 0.5
    ema_rate: float = 0.9999
    patch_resolution: int = 32
    render_resolution: int = 128
    microbatch_steps: int = 1
    log_interval: int = 10
    total_steps: int = 100000


class LSGMTrainer:
    """The joint VAE + denoiser loop (reference
    ``TrainLoop3DDiffusionLSGMJointnoD.run_loop``).  Batches are the VAE's
    patch-ray batches: the denoiser trains on the live latents.  The
    VAE's weights are drawn from ``seed`` and the denoiser's from ``seed +
    1`` (``random_init_``, zero where JAX's init is); load others into
    ``trainer.vae`` and ``trainer.denoiser`` before the first step."""

    def __init__(self, vae_cfg, denoiser_model: nn.Module,
                 train_cfg: LSGMTrainConfig = LSGMTrainConfig(),
                 loss_cfg: LossConfig = LossConfig(),
                 lsgm_cfg: LSGMConfig = LSGMConfig(),
                 render_opts: Optional[RenderOptions] = None,
                 seed: int = 0, device='cuda', mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            MeshConfig(), device_type=self.device.type)
        self.vae_cfg = vae_cfg
        self.cfg = train_cfg
        self.loss_cfg = loss_cfg
        self.lsgm_cfg = lsgm_cfg
        self.render_opts = render_opts or RenderOptions(
            depth_resolution=48, depth_resolution_importance=48,
            ray_start='auto', ray_end='auto', box_warp=0.9,
            filter_out_of_bbox=True)
        with torch.device(self.device):
            self.vae = TriplaneVAE(vae_cfg, encoder=True)
        self.denoiser = denoiser_model.to(self.device)
        # one module over both trees: parameter names 'vae.*' and 'ddpm.*'
        self.joint = nn.ModuleDict({'vae': self.vae, 'ddpm': self.denoiser})
        for i, mod in enumerate((self.vae, self.denoiser)):
            random_init_(mod, torch.Generator(
                device=self.device).manual_seed(seed + i))
            zero_init_like_jax(mod)
        self.rng = host_rng(seed)
        self.generator: Optional[torch.Generator] = None
        self.state: Optional[TrainState] = None
        self.loss_fn = None
        self._step_fn = None

    def init_state(self) -> TrainState:
        """One AdamW and one EMA over both trees' current parameters."""
        tx = make_optimizer(self.cfg.lr, self.cfg.weight_decay,
                            grad_clip=self.cfg.grad_clip)
        self.state = TrainState.create(
            self.joint, tx, ema_rates=(('ema', self.cfg.ema_rate),),
            mesh=self.mesh)
        return self.state

    def build(self) -> 'LSGMTrainer':
        if self.state is None:
            self.init_state()
        self.loss_fn = make_joint_loss_fn(
            self.vae, self.denoiser, self.render_opts, self.loss_cfg,
            self.lsgm_cfg, self.cfg.patch_resolution,
            self.cfg.render_resolution, get_generator=lambda: self.generator)
        self._step_fn = build_train_step(
            self.loss_fn, self.cfg.microbatch_steps, mesh=self.mesh,
            draw_fn=lambda b: self.draw(b, self.generator))
        return self

    def draw(self, batch: dict, generator: Optional[torch.Generator]
             ) -> Optional[LSGMDraws]:
        """The draws of a whole (micro)batch from ``generator``, every rank
        the same: ε, the render's uniforms, then the p and q terms' rho
        and noise."""
        if generator is None:
            return None
        cfg, dev = self.vae_cfg, self.device
        n = batch['img_to_encoder'].shape[0] // max(cfg.num_views, 1)
        h, z = cfg.latent_size, cfg.ldm_z_channels
        eps = torch.randn((n, h, h, z, 3), generator=generator, device=dev)
        render = draw_uniforms(batch['c'].shape[0],
                               self.cfg.patch_resolution**2,
                               self.render_opts, generator, dev)
        out = []
        for _ in range(2):
            out.append(torch.rand((n,), generator=generator, device=dev))
            out.append(torch.randn((n, h, h, 3 * z), generator=generator,
                                   device=dev))
        return LSGMDraws(eps, render, *out)

    def train_step(self, batch: dict,
                   draws: Optional[LSGMDraws] = None) -> dict:
        """One optimizer step on a prepared batch; ``draws`` or
        ``self.generator``'s (default: seeded with 1234)."""
        if self._step_fn is None:
            self.build()
        if self.generator is None:
            self.generator = torch.Generator(
                device=self.device).manual_seed(1234)
        return self._step_fn(self.state, batch, draws)

    def prepare_batch(self, raw: dict) -> dict:
        """The batch on the device with foreground-biased patch origins;
        unlike ``VAETrainer``, a bbox is scaled by ``render_resolution /
        img_resolution`` first (as JAX's LSGM trainer does)."""
        cfg = self.cfg
        return prepare_patch_batch(
            raw, self.rng, self.device, cfg.patch_resolution,
            cfg.render_resolution,
            keys=('img_to_encoder', 'img', 'depth', 'depth_mask', 'c',
                  'context'),
            bbox_scale=cfg.render_resolution / self.vae_cfg.img_resolution,
            mesh=self.mesh)

    def run_loop(self, data: Iterator[dict], num_steps: Optional[int] = None,
                 step_offset: int = 0, guard=None,
                 log: Callable = print) -> TrainState:
        """``num_steps`` (default ``total_steps``) steps over ``data``
        (``vae_trainer.train_loop``, with its logging and ``guard``)."""
        train_loop(lambda raw, i: self.train_step(self.prepare_batch(raw)),
                   data, num_steps or self.cfg.total_steps,
                   self.cfg.log_interval, step_offset, log, guard)
        return self.state
