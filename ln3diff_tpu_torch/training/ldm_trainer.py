"""Stage-2 latent-diffusion trainer: one loop, three objectives.

Port of ``ln3diff_tpu/training/ldm_trainer.py`` (``LDMTrainConfig`` :30,
``LDMTrainer`` :62 with ``init_state`` :124, ``_loss_fn`` :148, ``build``
:204 and ``run_loop`` :213, ``ControlNetTrainer`` :236; reference
``nsr/lsgm/flow_matching_trainer.py:303``, ``sgm_DiffusionEngine.py:210``,
``train_util_diffusion_lsgm_noD_joint.py:250-489``,
``nsr/lsgm/crossattn_cldm_objv.py:775``).  The step trains
the denoiser on pre-extracted VAE latents (÷ ``triplane_scaling_divider``)
with their context already encoded:

* ``'flow_matching'``: velocity matching at logit-normal t
  (``Transport.training_losses``);
* ``'ddpm'``: ``GaussianDiffusion.training_losses`` (every mean, variance
  and loss type; ``learned_range`` trains the VLB head), t uniform or,
  with ``schedule_sampler='loss-second-moment'``, importance-sampled on
  the host with the per-sample losses fed back;
* ``'edm'``: the EDM loss over the discrete σ table with eps scaling; the
  network gets c_noise, the σ's table index as f32, as its t.

The denoiser computes under autocast to its ``cfg.dtype`` (bf16 on the
released configs) over f32 parameters, as the JAX modules compute in
``dtype`` over f32 params; the step is ``train_state.build_train_step``
(microbatch averaging, clip, AdamW, EMA).  Randomness: t, the noise and
the σ indices come from a ``torch.Generator`` or are passed in
(:class:`LDMDraws`, so that a test can feed JAX's) — drawn for the whole
batch (:meth:`LDMTrainer.draw`); the resampler's draws come from
``parallel.mesh.host_rng(seed)``, the JAX trainer's host RNG.

``mesh=`` (default: ``make_mesh()`` over the world): each rank trains on
its (data, fsdp) slice of the batch and of the draws, grads averaged over
those ranks (``train_state.build_train_step``).  A mesh whose ``pipe``
axis is above 1 runs the DiT's trunk through the GPipe schedule
(``parallel/pipeline.py``, ``pp_microbatches`` microbatches), each stage
holding and updating its own blocks (``pipeline_parallel_rules``; the
other stages' blocks move to the ``meta`` device), as JAX does (:66-75,
:119-126, :142-145).  With an fsdp axis above 1 the parameters that
``param_sharding_rules`` shards live in the module as their shards
(``parallel/fsdp.py``).  Metrics go to ``log`` (printed by default).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from ..diffusion.edm import DiscreteDenoiser, edm_training_loss
from ..diffusion.gaussian import make_diffusion
from ..diffusion.resample import LossSecondMomentResampler
from ..diffusion.transport import Transport, TransportSpec
from ..models.controlnet import ControlNet
from ..models.layers import random_init_, zero_init_like_jax
from ..models.unet import UNetModel
from ..parallel.mesh import (MeshConfig, axis_size, host_rng, make_mesh,
                             training_placements)
from ..pipeline import resolve_device
from .train_state import TrainState, build_train_step, make_optimizer
from .vae_trainer import train_loop


@dataclasses.dataclass(frozen=True)
class LDMTrainConfig:
    objective: str = 'flow_matching'   # 'flow_matching' | 'ddpm' | 'edm'
    lr: float = 1e-4
    weight_decay: float = 0.01
    grad_clip: float = 0.5
    ema_rate: float = 0.9999
    triplane_scaling_divider: float = 0.96806   # reference objaverse value
    # ddpm objective options
    schedule: str = 'linear'
    diffusion_steps: int = 1000
    mean_type: str = 'v'
    var_type: str = 'fixed_small'     # 'learned_range' trains the VLB head
    loss_type: str = 'mse'            # 'rescaled_mse' = hybrid MSE + VLB
    # 'uniform' | 'loss-second-moment' (importance-sample t ∝ sqrt(E[loss²])
    # on the host, diffusion/resample.py)
    schedule_sampler: str = 'uniform'
    microbatch_steps: int = 1
    # microbatches of the pipelined trunk (mesh pipe axis > 1)
    pp_microbatches: int = 4
    log_interval: int = 10


class LDMDraws(NamedTuple):
    """The random draws of one loss evaluation: ``t`` (B,) — the
    flow-matching time in [0, 1], the DDPM step (int) or the EDM σ-table
    index (int) — and ``noise`` in the latent's shape."""
    t: torch.Tensor
    noise: torch.Tensor


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree, device=device)


class LDMTrainer:
    """Owns the denoiser (``model(x, t, context) -> prediction``), the
    train state and the step; drives the loop (reference ``run_loop``).
    The model's weights are redrawn at construction from ``seed``
    (``random_init_``, zero where JAX's init is); load others into
    ``trainer.model`` before the first step.  Batches are dicts with
    'latent' (B, H, W, C) and 'context' (a dict of tensors), or
    (S, B, ...) under ``microbatch_steps`` S > 1."""

    def __init__(self, model: nn.Module,
                 train_cfg: LDMTrainConfig = LDMTrainConfig(),
                 seed: int = 0, device='cuda', mesh=None):
        if getattr(getattr(model, 'cfg', None), 'fused_attention', False):
            raise ValueError('the fused attention kernel has no backward '
                             'pass: build the denoiser with '
                             'fused_attention=False to train it')
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            MeshConfig(), device_type=self.device.type)
        self._use_pp = axis_size(self.mesh, 'pipe') > 1
        if self._use_pp and not hasattr(model, 'embed'):
            raise ValueError('pipeline parallelism drives the DiT trunk; '
                             f'got {type(model).__name__}')
        self.cfg = train_cfg
        self.model = model.to(self.device)
        self.seed = seed
        self._init_weights()
        self.generator: Optional[torch.Generator] = None
        self.state: Optional[TrainState] = None
        self._step_fn = None
        self.resampler = None

        if train_cfg.objective == 'ddpm':
            self.diffusion = make_diffusion(
                schedule=train_cfg.schedule, steps=train_cfg.diffusion_steps,
                mean_type=train_cfg.mean_type, var_type=train_cfg.var_type,
                loss_type=train_cfg.loss_type)
            if train_cfg.schedule_sampler == 'loss-second-moment':
                self.resampler = LossSecondMomentResampler(
                    self.diffusion.num_timesteps)
                self._resampler_rng = host_rng(seed)
            elif train_cfg.schedule_sampler != 'uniform':
                raise ValueError(f'schedule_sampler '
                                 f'{train_cfg.schedule_sampler!r}')
        elif train_cfg.objective == 'edm':
            self.denoiser = DiscreteDenoiser(num_idx=1000, scaling='eps')
        elif train_cfg.objective == 'flow_matching':
            self.transport = Transport(TransportSpec())
        else:
            raise ValueError(f'objective {train_cfg.objective!r}')

    def _init_weights(self):
        module = self._trained_module().to(self.device)
        random_init_(module, torch.Generator(
            device=self.device).manual_seed(self.seed))
        zero_init_like_jax(module)

    # -- state -------------------------------------------------------------

    def _constants(self):
        return None

    def init_state(self) -> TrainState:
        """The optimizer and the EMA over the model's current weights."""
        tx = make_optimizer(self.cfg.lr, self.cfg.weight_decay,
                            grad_clip=self.cfg.grad_clip)
        module = self._trained_module()
        self.state = TrainState.create(
            module, tx, ema_rates=(('ema', self.cfg.ema_rate),),
            constants=self._constants(), mesh=self.mesh,
            placements=training_placements(module, self.mesh,
                                           pipeline=self._use_pp))
        return self.state

    def _trained_module(self) -> nn.Module:
        return self.model

    def build(self) -> 'LDMTrainer':
        if self.state is None:
            self.init_state()
        self._step_fn = build_train_step(
            self._loss_fn, self.cfg.microbatch_steps, mesh=self.mesh,
            draw_fn=lambda b: self.draw(b, self.generator))
        return self

    # -- the loss ----------------------------------------------------------

    def _autocast(self):
        dt = getattr(getattr(self.model, 'cfg', None), 'dtype', torch.float32)
        return torch.autocast(self.device.type, dtype=dt,
                              enabled=dt != torch.float32)

    def _loss_fn(self, params, constants, batch, draws: Optional[LDMDraws]):
        """(loss, metrics) of one (micro)batch (JAX ``_loss_fn``).  The
        draws come from ``draws`` or from ``self.generator``."""
        cfg = self.cfg
        gen = self.generator
        x0 = batch['latent'] / cfg.triplane_scaling_divider
        ctx = batch['context']
        t_in = None if draws is None else draws.t
        noise = None if draws is None else draws.noise

        def model_fn(xt, t):
            with self._autocast():
                if self._use_pp:
                    from ..parallel.pipeline import dit_pipeline_apply
                    return dit_pipeline_apply(
                        self.model, xt, t, ctx, mesh=self.mesh,
                        n_micro=cfg.pp_microbatches,
                        remat=self.model.cfg.remat)
                return self.model(xt, t, ctx)

        if cfg.objective == 'flow_matching':
            out = self.transport.training_losses(model_fn, x0, generator=gen,
                                                 t=t_in, noise=noise)
            loss = out['loss'].mean()
            return loss, {'fm_mse': loss.detach()}
        if cfg.objective == 'ddpm':
            if 't' in batch:
                # importance-sampled steps from the host-side resampler;
                # the weights undo the sampling bias
                t, t_w = batch['t'].long(), batch['t_weights']
            else:
                t = t_in if t_in is not None else torch.randint(
                    0, self.diffusion.num_timesteps, (x0.shape[0],),
                    generator=gen, device=x0.device)
                t_w = 1.0
            out = self.diffusion.training_losses(model_fn, x0, t,
                                                 noise=noise, generator=gen)
            loss = (t_w * out['loss']).mean()
            metrics = {'ddpm_mse': out.get('mse', out['loss']).mean()
                       .detach()}
            if 'vb' in out:
                metrics['vb'] = out['vb'].mean().detach()
            if 't' in batch:
                metrics['per_sample_loss'] = out['loss'].detach()
            return loss, metrics

        def network(xt, c_noise, cond):
            return model_fn(xt, c_noise.float())

        loss = edm_training_loss(self.denoiser, network, x0, ctx,
                                 generator=gen, sigma_idx=t_in,
                                 noise=noise).mean()
        return loss, {'edm_mse': loss.detach()}

    def draw(self, batch: dict, generator: Optional[torch.Generator]
             ) -> Optional[LDMDraws]:
        """The draws of a whole (micro)batch from ``generator``, every rank
        the same: t — the flow-matching time (``Transport.sample_t``), a
        DDPM step or an EDM σ index — then the noise."""
        if generator is None:
            return None
        x0 = batch['latent']
        n, dev = x0.shape[0], x0.device
        if self.cfg.objective == 'flow_matching':
            t = self.transport.sample_t(n, dev, generator)
        else:
            top = (self.diffusion.num_timesteps
                   if self.cfg.objective == 'ddpm'
                   else self.denoiser.sigmas.shape[0])
            t = torch.randint(0, top, (n,), generator=generator, device=dev)
        return LDMDraws(t, torch.randn(x0.shape, generator=generator,
                                       device=dev))

    # -- the step and the loop ----------------------------------------------

    def train_step(self, batch: dict, draws=None) -> dict:
        """One optimizer step on a batch already on the device; ``draws``:
        an :class:`LDMDraws` (a sequence of S of them under
        ``microbatch_steps`` S > 1) or None for ``self.generator``'s."""
        if self._step_fn is None:
            self.build()
        if self.generator is None:
            self.generator = torch.Generator(
                device=self.device).manual_seed(1234)
        return self._step_fn(self.state, batch, draws)

    def run_loop(self, data: Iterator[dict], num_steps: int,
                 step_offset: int = 0, eval_fn: Optional[Callable] = None,
                 eval_interval: int = 0, guard=None,
                 log: Callable = print) -> TrainState:
        """``num_steps`` steps over ``data`` (dicts of arrays) through
        ``vae_trainer.train_loop``: every ``log_interval`` steps the
        metrics go to ``log`` as floats; ``eval_fn(state, step)`` runs
        every ``eval_interval`` steps; a ``guard`` (anything with
        ``should_stop()``, such as a preemption guard) stops the loop at
        the next step boundary."""
        if self._step_fn is None:
            self.build()

        def step_fn(raw, i):
            batch = _to_device(raw, self.device)
            if self.resampler is None:
                return self.train_step(batch)
            # t for every sample, shaped like the batch's leading axes so
            # that the microbatch split slices it
            lead = batch['latent'].shape[
                :1 if self.cfg.microbatch_steps == 1 else 2]
            t_np, w_np = self.resampler.sample(self._resampler_rng,
                                               int(np.prod(lead)))
            batch['t'] = torch.as_tensor(t_np,
                                         device=self.device).reshape(lead)
            batch['t_weights'] = torch.as_tensor(
                w_np, device=self.device).reshape(lead)
            metrics = self.train_step(batch)
            self.resampler.update_with_losses(
                t_np, metrics.pop('per_sample_loss').cpu().numpy())
            return metrics

        train_loop(step_fn, data, num_steps, self.cfg.log_interval,
                   step_offset, log, guard,
                   eval_fn=eval_fn and (lambda step: eval_fn(self.state,
                                                             step)),
                   eval_interval=eval_interval)
        return self.state


class ControlNetTrainer(LDMTrainer):
    """Hint-conditioned fine-tuning (reference
    ``scripts/vit_triplane_cldm_train.py``): a frozen U-Net and a trainable
    ControlNet branch whose zero-conv residuals are added to the U-Net's
    skips.  Only the ControlNet trains: the U-Net's parameters are
    ``requires_grad=False`` and sit in the train state's ``constants``,
    out of the optimizer's reach.  The objective is 'ddpm'.  Batches carry
    'latent', 'context' and 'hint' (B, H, W, C).  The ControlNet's weights
    are redrawn from ``seed`` (zero convs at zero); the U-Net keeps the
    weights it holds."""

    def __init__(self, unet_model: UNetModel, controlnet_model: ControlNet,
                 train_cfg: LDMTrainConfig = LDMTrainConfig(
                     objective='ddpm'),
                 seed: int = 0, device='cuda', mesh=None):
        if train_cfg.objective != 'ddpm':
            raise ValueError('the ControlNet trains the DDPM objective')
        self.controlnet = controlnet_model
        super().__init__(unet_model, train_cfg, seed=seed, device=device,
                         mesh=mesh)
        self.model.requires_grad_(False)

    def _trained_module(self) -> nn.Module:
        return self.controlnet

    def _constants(self):
        return {'unet': dict(self.model.named_parameters())}

    def _loss_fn(self, params, constants, batch, draws: Optional[LDMDraws]):
        cfg = self.cfg
        gen = self.generator
        x0 = batch['latent'] / cfg.triplane_scaling_divider
        ctx = batch['context']
        crossattn = ctx.get('crossattn') if isinstance(ctx, dict) else ctx
        hint = batch['hint']

        def model_fn(xt, t):
            with self._autocast():
                controls = self.controlnet(xt, hint, t, crossattn)
                return self.model(xt, t, crossattn, control=controls)

        t = draws.t if draws is not None else torch.randint(
            0, self.diffusion.num_timesteps, (x0.shape[0],), generator=gen,
            device=x0.device)
        out = self.diffusion.training_losses(
            model_fn, x0, t, noise=None if draws is None else draws.noise,
            generator=gen)
        loss = out['loss'].mean()
        return loss, {'cldm_mse': loss.detach()}
