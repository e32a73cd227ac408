"""Stage-1 VAE trainer: patch-ray multi-view reconstruction.

Port of ``ln3diff_tpu/training/vae_trainer.py`` (``VAETrainConfig`` :38,
``_crop`` :70, ``VAETrainer`` :78 with ``init_state`` :113, ``_loss_fn``
:137, ``prepare_batch`` :240 and ``run_loop`` :264; reference
``nsr/train_nv_util.py:675-860``):

* the V input views of an instance are encoded into one latent, and the
  supervised views are rendered back from it as ``patch_resolution²``
  patches at host-sampled, foreground-biased origins of a
  ``render_resolution²`` image, against crops of the targets;
* the encoder and the decoder run under autocast to ``cfg.dtype`` over
  f32 parameters (the renderer and the point decoder in f32, as in JAX);
  with ``use_fused_osg`` the render's point pipeline is the fused CUDA
  kernel and its backward kernel;
* gradients, averaged over ``microbatch_steps`` (and the ranks), go
  through the global-norm clip and AdamW, then the EMA (``train_state.py``).

Randomness: the patch origins come from ``parallel.mesh.host_rng(seed)``
(``default_rng([seed, rank])``, the JAX trainer's host RNG), so both crop
the same windows on rank 0; the posterior's ε and the render's uniform
draws are passed in (:class:`TrainDraws`, so that a test can feed JAX's)
or drawn for the whole batch from a ``torch.Generator``
(:meth:`VAETrainer.draw`).

``mesh=`` (default: ``make_mesh()`` over the world): each rank trains on
its (data, fsdp) slice of the batch and of the draws, and the grads are
averaged over those ranks before the clip (``train_state.build_train_step``);
``loss`` and the terms are the global means.  With an fsdp axis above 1
the parameters that ``param_sharding_rules`` shards live in the module as
their shards (``parallel/fsdp.py``).

``adversarial=``: an ``AdversarialHead`` (``training/gan.py``) or a
``VisionAidedHead`` (``training/vision_aided.py``).  The generator term
``g_adv`` on the rendered patches (JAX :196-199) joins the loss; after
each step ``_disc_step`` (:211) encodes the batch again with the updated
parameters (the posterior's mean), renders the input views
deterministically without grad (through kernel 1 under
``use_fused_osg``) and trains the discriminator on (real crops, those
renders).  The generator term reads the live discriminator, ADA strength
and draw; the JAX trainer reads the ones of its first trace
(``ROADMAP.md`` §3).  Under a mesh every rank runs the discriminator
step on the whole batch, so the discriminators stay equal.  Metrics go
to ``log``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..models.vae import TriplaneVAE, TriplaneVAEConfig
from ..parallel.mesh import (DP_AXES, MeshConfig, axis_size, data_sharding,
                             host_rng, make_mesh, replicated,
                             training_placements)
from ..pipeline import resolve_device
from ..render.ray_sampler import (sample_patch_origins, sample_patch_rays,
                                  unpack_25d_camera)
from ..render.renderer import RenderDraws, RenderOptions, draw_uniforms
from .losses import LossConfig, reconstruction_losses
from .train_state import TrainState, build_train_step, make_optimizer


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    lr: float = 1e-4
    weight_decay: float = 0.01
    grad_clip: float = 0.5
    ema_rate: float = 0.9999
    patch_resolution: int = 32        # patch-ray size (reference 32-64)
    render_resolution: int = 128      # full supervision resolution
    microbatch_steps: int = 1
    # which views the render loss supervises: 'nv' = the held-out novel
    # views when the batch carries them, 'input' = the encoder's input
    # views, 'both' = the concatenation
    supervise_views: str = 'nv'
    # top-level module name → its own learning rate
    lr_groups: tuple = ()
    # the render's point pipeline through the fused kernels (forward and
    # backward); CPU tensors run the same math as plain PyTorch
    use_fused_osg: bool = False
    log_interval: int = 10
    total_steps: int = 100000


class TrainDraws(NamedTuple):
    """The random draws of one loss evaluation: the posterior's ε ``(B, h,
    w, z, 3)``, the render's uniforms, used for every supervised source,
    and with an ``AdversarialHead`` under ADA the generator term's
    augmentation draws (``augment.AugmentDraws``; None: the head's
    generator)."""
    eps: torch.Tensor
    render: RenderDraws
    adv: Optional[object] = None


def _crop(img: torch.Tensor, h0, w0, size: int) -> torch.Tensor:
    """Per-sample ``size²`` crops of ``(N, H, W, C)`` at ``(h0, w0)``; the
    starts are clamped so that the crop fits, as ``lax.dynamic_slice``
    does."""
    N, H, W, _ = img.shape
    crops = []
    for i, (h, w) in enumerate(zip(h0.tolist(), w0.tolist())):
        h = min(max(h, 0), H - size)
        w = min(max(w, 0), W - size)
        crops.append(img[i, h:h + size, w:w + size])
    return torch.stack(crops)


def crop_targets(batch: dict, prefix: str, size: int) -> dict:
    """The ``{prefix}`` views' image, depth and depth-mask crops at their
    patch origins: the targets of ``render_patches``."""
    h0, w0 = batch[f'{prefix}patch_h'], batch[f'{prefix}patch_w']
    return {'img': _crop(batch[f'{prefix}img'], h0, w0, size),
            'depth': _crop(batch[f'{prefix}depth'][..., None], h0, w0, size),
            'depth_mask': _crop(batch[f'{prefix}depth_mask'][..., None],
                                h0, w0, size)}


def render_patches(model: TriplaneVAE, planes: torch.Tensor, batch: dict,
                   prefix: str, opts: RenderOptions, patch: int,
                   render_resolution: int, use_fused_osg: bool = False,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[RenderDraws] = None) -> dict:
    """Render each instance's ``planes`` as ``patch²`` patches of its
    ``{prefix}c`` views (an instance's views are adjacent) at the batch's
    patch origins in a ``render_resolution²`` image."""
    cams = batch[f'{prefix}c']
    h0, w0 = batch[f'{prefix}patch_h'], batch[f'{prefix}patch_w']
    cam2world, intrinsics = unpack_25d_camera(cams)
    ray_o, ray_d = sample_patch_rays(
        cam2world, intrinsics, h0.to(cams.device), w0.to(cams.device),
        patch, render_resolution)
    planes_v = planes.repeat_interleave(cams.shape[0] // planes.shape[0],
                                        dim=0)
    return model.render(planes_v, None, opts, patch,
                        use_fused_osg=use_fused_osg, ray_origins=ray_o,
                        ray_directions=ray_d, generator=generator,
                        draws=draws)


def prepare_patch_batch(raw: dict, rng: np.random.Generator, device,
                        patch_resolution: int, render_resolution: int,
                        keys: tuple, bbox_scale: float = 1.0,
                        mesh=None) -> dict:
    """The ``keys`` of ``raw`` on the device, with foreground-biased patch
    origins (host RNG, int32 on the host) for the input views and, when
    ``nv_c`` is kept, the paired nv_* views.  A bbox is scaled by
    ``bbox_scale`` into render-resolution coords.  Under a ``mesh`` with
    several (data, fsdp) ranks, each rank's origins of its own rows are
    gathered, as JAX assembles a global array from each host's local
    draws, so every rank holds the same global origins."""
    out = {k: torch.as_tensor(np.asarray(v), device=device)
           for k, v in raw.items() if k in keys}
    for prefix in ('', 'nv_'):
        if f'{prefix}c' not in out:
            continue
        bbox = raw.get(f'{prefix}bbox')
        if bbox is not None:
            bbox = (np.asarray(bbox) * bbox_scale).astype(np.int32)
        h0, w0 = sample_patch_origins(rng, out[f'{prefix}c'].shape[0],
                                      patch_resolution, render_resolution,
                                      bbox)
        hw = torch.from_numpy(np.stack([h0, w0], axis=-1))
        if axis_size(mesh, *DP_AXES) > 1:
            hw = replicated(mesh, data_sharding(mesh, hw.to(device))).cpu()
        out[f'{prefix}patch_h'] = hw[:, 0].contiguous()
        out[f'{prefix}patch_w'] = hw[:, 1].contiguous()
    return out


def train_loop(step_fn: Callable, data: Iterator, num_steps: int,
               log_interval: int, step_offset: int, log: Callable,
               guard=None, eval_fn: Optional[Callable] = None,
               eval_interval: int = 0):
    """``num_steps`` calls of ``step_fn(raw batch, step index) ->
    metrics`` over ``data``; every ``log_interval`` steps the metrics go to
    ``log`` as a dict of floats, and every ``eval_interval`` steps
    ``eval_fn(step)`` runs (the in-training evaluation hook of JAX's
    ``run_loop``; the trainers pass it their state).  A ``guard``
    (anything with ``should_stop()``, such as
    ``preemption.PreemptionGuard``) stops the loop at the next step
    boundary."""
    for i in range(num_steps):
        metrics = step_fn(next(data), step_offset + i)
        step = step_offset + i + 1
        if (i + 1) % log_interval == 0:
            log(dict({k: float(v) for k, v in metrics.items()}, step=step))
        if eval_fn is not None and eval_interval \
                and (i + 1) % eval_interval == 0:
            eval_fn(step)
        if guard is not None and guard.should_stop():
            log({'stopped_after_step': step})
            break


class VAETrainer:
    """Owns the model, the train state and the step; drives the loop
    (reference ``run_loop``).  Weights are random, from
    :func:`~ln3diff_tpu_torch.models.layers.random_init_` seeded with
    ``seed``, zero where JAX's init is (:func:`zero_init_like_jax`),
    unless the caller loads others into ``trainer.model`` before the first
    step."""

    def __init__(self, model_cfg: TriplaneVAEConfig,
                 train_cfg: VAETrainConfig = VAETrainConfig(),
                 loss_cfg: LossConfig = LossConfig(),
                 render_opts: Optional[RenderOptions] = None,
                 seed: int = 0, lpips_fn: Optional[Callable] = None,
                 adversarial=None, device='cuda', mesh=None):
        from ..models.layers import random_init_, zero_init_like_jax
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            MeshConfig(), device_type=self.device.type)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.loss_cfg = loss_cfg
        self.render_opts = render_opts or RenderOptions(
            depth_resolution=48, depth_resolution_importance=48,
            ray_start='auto', ray_end='auto', box_warp=0.9,
            filter_out_of_bbox=True)
        with torch.device(self.device):
            self.model = TriplaneVAE(model_cfg, encoder=True)
        random_init_(self.model, torch.Generator(
            device=self.device).manual_seed(seed))
        zero_init_like_jax(self.model)
        # host-side patch-origin RNG, per rank (JAX's host_rng)
        self.rng = host_rng(seed)
        self.lpips_fn = lpips_fn
        self.adversarial = adversarial
        self.state: Optional[TrainState] = None

    # -- state -------------------------------------------------------------

    def init_state(self) -> TrainState:
        """The optimizer and the EMA over the model's current parameters."""
        tx = make_optimizer(self.cfg.lr, self.cfg.weight_decay,
                            grad_clip=self.cfg.grad_clip,
                            lr_groups=dict(self.cfg.lr_groups) or None)
        self.state = TrainState.create(
            self.model, tx, ema_rates=(('ema', self.cfg.ema_rate),),
            mesh=self.mesh,
            placements=training_placements(self.model, self.mesh))
        return self.state

    # -- the loss ----------------------------------------------------------

    def _autocast(self):
        dt = self.model_cfg.dtype
        return torch.autocast(self.device.type, dtype=dt,
                              enabled=dt != torch.float32)

    def loss_fn(self, batch: dict,
                generator: Optional[torch.Generator] = None,
                draws: Optional[TrainDraws] = None):
        """(total loss, unweighted terms) of one (micro)batch.  ε and the
        render's draws come from ``draws`` or from ``generator``."""
        cfg = self.cfg
        model = self.model
        patch = cfg.patch_resolution

        with self._autocast():
            moments = model.encode(batch['img_to_encoder'])
            latent, posterior = model.reparameterize(
                moments, True, eps=None if draws is None else draws.eps,
                generator=generator)
            planes = model.decode_latent(latent)

        use_nv = 'nv_c' in batch and cfg.supervise_views != 'input'
        sources = []
        if use_nv:
            sources.append('nv_')
        if not use_nv or cfg.supervise_views == 'both':
            sources.append('')

        preds = [render_patches(
            model, planes, batch, prefix, self.render_opts, patch,
            cfg.render_resolution, use_fused_osg=cfg.use_fused_osg,
            generator=generator,
            draws=None if draws is None else draws.render)
            for prefix in sources]
        targets = [crop_targets(batch, prefix, patch) for prefix in sources]
        pred = {k: torch.cat([p[k] for p in preds]) for k in preds[0]}
        target = {k: torch.cat([t[k] for t in targets]) for k in targets[0]}
        total, terms = reconstruction_losses(
            pred, target, self.loss_cfg, kl=posterior.kl(),
            step=batch.get('step'), lpips_fn=self.lpips_fn)
        if self.adversarial is not None:
            g_adv = self.adversarial.generator_loss(
                pred['image_raw'], draws=None if draws is None else draws.adv)
            total = total + g_adv
            terms = dict(terms, g_adv=g_adv)
        return total, terms

    @torch.no_grad()
    def _disc_inputs(self, batch: dict):
        """(real, fake) of the discriminator step: the input views' crops
        and their deterministic renders from the posterior's mean under
        the current parameters, without grad."""
        cfg = self.cfg
        model = self.model
        patch = cfg.patch_resolution
        with self._autocast():
            moments = model.encode(batch['img_to_encoder'])
            latent, _ = model.reparameterize(moments, False)
            planes = model.decode_latent(latent)
        fake = render_patches(model, planes, batch, '', self.render_opts,
                              patch, cfg.render_resolution,
                              use_fused_osg=cfg.use_fused_osg)['image_raw']
        return (_crop(batch['img'], batch['patch_h'], batch['patch_w'],
                      patch), fake)

    def _disc_step(self, batch: dict, draws=None) -> dict:
        """One discriminator update on ``_disc_inputs``; ``draws``: the
        head's (real, fake) augmentation draws, or None."""
        return self.adversarial.disc_step(*self._disc_inputs(batch), draws)

    # -- the step ----------------------------------------------------------

    def draw(self, batch: dict, generator: Optional[torch.Generator]
             ) -> Optional[TrainDraws]:
        """The draws of a whole (micro)batch from ``generator`` (None
        without one: the posterior's mean and the render's fixed depths):
        ε ``(B, h, w, z, 3)`` then the render's uniforms for the supervised
        views' rays, every rank the same."""
        if generator is None:
            return None
        cfg, mcfg = self.cfg, self.model_cfg
        n = batch['img_to_encoder'].shape[0] // max(mcfg.num_views, 1)
        h = mcfg.latent_size
        eps = torch.randn((n, h, h, mcfg.ldm_z_channels, 3),
                          generator=generator, device=self.device)
        use_nv = 'nv_c' in batch and cfg.supervise_views != 'input'
        rows = batch['nv_c' if use_nv else 'c'].shape[0]
        return TrainDraws(eps, draw_uniforms(
            rows, cfg.patch_resolution**2, self.render_opts, generator,
            self.device))

    def train_step(self, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[TrainDraws] = None) -> dict:
        """One optimizer step (JAX ``build_train_step``'s ``step_fn``) on
        the global batch.  With ``microbatch_steps`` S > 1 every batch
        entry of rank ≥ 2 has a leading microbatch axis, the grads are
        averaged over it and ``draws`` is a sequence of S draws.  Without
        draws they come from ``generator`` (:meth:`draw`).  Returns the
        metrics: the mean loss terms, ``loss`` and ``grad_norm`` (of the
        unclipped grads)."""
        if self.state is None:
            self.init_state()
        step_fn = build_train_step(
            lambda p, c, b, d: self.loss_fn(b, draws=d),
            self.cfg.microbatch_steps, mesh=self.mesh,
            draw_fn=lambda b: self.draw(b, generator))
        return step_fn(self.state, batch, draws)

    # -- host-side batch prep ---------------------------------------------

    def prepare_batch(self, raw: dict) -> dict:
        """The batch on the device with its patch origins (a bbox is in
        render-resolution coords)."""
        return prepare_patch_batch(
            raw, self.rng, self.device, self.cfg.patch_resolution,
            self.cfg.render_resolution,
            keys=('img_to_encoder', 'img', 'depth', 'depth_mask', 'c',
                  'nv_img', 'nv_depth', 'nv_depth_mask', 'nv_c'),
            mesh=self.mesh)

    # -- loop --------------------------------------------------------------

    def run_loop(self, data: Iterator[dict], num_steps: Optional[int] = None,
                 step_offset: int = 0,
                 generator: Optional[torch.Generator] = None,
                 log: Callable = print, guard=None,
                 eval_fn: Optional[Callable] = None,
                 eval_interval: int = 0) -> TrainState:
        """``num_steps`` (default ``total_steps``) steps over ``data``
        (:func:`train_loop`, with its logging, ``eval_fn(state, step)``
        every ``eval_interval`` steps and ``guard``); with an adversarial
        head each step is followed by a discriminator step (its metrics
        join the step's).  ε and the render's draws come from
        ``generator`` (default: a generator on the device seeded with
        1234)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(1234)

        def step_fn(raw, i):
            batch = self.prepare_batch(raw)
            # the live step of the KL anneal (losses.kl_coeff)
            batch['step'] = float(i)
            metrics = self.train_step(batch, generator=generator)
            if self.adversarial is not None:
                metrics.update(self._disc_step(batch))
            return metrics

        train_loop(step_fn, data, num_steps or self.cfg.total_steps,
                   self.cfg.log_interval, step_offset, log, guard,
                   eval_fn=eval_fn and (lambda step: eval_fn(self.state,
                                                             step)),
                   eval_interval=eval_interval)
        return self.state
