"""Reference-compatible sgm yaml config assembly.

Port of ``ln3diff_tpu/sgm_config.py`` (``LambdaLinearScheduler`` :38, the
spec dataclasses :78-250, the ``_build_*`` functions and ``_TARGETS`` :258-398,
``instantiate_from_config`` :401, ``load_ldm_configs`` :414).  The
reference drives its SGM stack (conditioner / denoiser / loss / sampler /
LR schedule) from OmegaConf yaml files whose dotted ``target:`` strings
``instantiate_from_config`` resolves (``sgm/util.py``, loaded at
``nsr/lsgm/flow_matching_trainer.py:160-192``; release configs under
``sgm/configs/*.yaml``, e.g. ``txt2img-clipl-compat.yaml`` and
``img23d-clipl-compat-fm-lognorm.yaml``).  Here the same yaml files load
unchanged and every target resolves to the port's parts, through an
explicit table: a yaml file cannot import or run arbitrary code.

- ``denoiser_config``    → ``diffusion/edm.py`` ``DiscreteDenoiser``
- ``conditioner_config`` → :class:`ConditionerSpec` (``build`` → the
  port's ``GeneralConditioner`` over ``conditioning/conditioner.py``'s
  ``make_*_embedder`` and the port's towers)
- ``loss_fn_config``     → :class:`LossSpec` (kind ``'edm'``:
  ``edm_training_loss``; ``'flow_matching'``: ``diffusion/transport.py``)
- ``sampler_config``     → :class:`EulerEDMSamplerSpec`
  (``euler_edm_sample``)
- ``scheduler_config``   → :class:`LambdaLinearScheduler`, an LR
  multiplier that also serves as ``torch.optim.lr_scheduler.LambdaLR``'s
  ``lr_lambda``

``yaml`` is imported only to read a path or a string; a mapping needs
nothing beyond the standard library and numpy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# LR schedules (reference sgm/lr_scheduler.py)
# ---------------------------------------------------------------------------


class LambdaLinearScheduler:
    """Multi-cycle warmup→linear-decay LR *multiplier* (reference
    ``sgm/lr_scheduler.py:113`` ``LambdaLinearScheduler``): within a cycle,
    warm up linearly f_start→f_max over ``warm_up_steps``, then decay
    linearly toward f_min over the cycle length.  The instance is the
    multiplier of step ``n``: ``LambdaLR(optimizer, lr_lambda=sched)``."""

    def __init__(self, warm_up_steps: Sequence[int],
                 f_min: Sequence[float], f_max: Sequence[float],
                 f_start: Sequence[float], cycle_lengths: Sequence[int]):
        n = len(warm_up_steps)
        assert len(f_min) == len(f_max) == len(f_start) \
            == len(cycle_lengths) == n
        self.warm_up_steps = list(warm_up_steps)
        self.f_min = list(f_min)
        self.f_max = list(f_max)
        self.f_start = list(f_start)
        self.cycle_lengths = list(cycle_lengths)
        self.cum_cycles = np.cumsum([0] + list(cycle_lengths))

    def _cycle(self, step: int) -> int:
        interval = np.searchsorted(self.cum_cycles, step, side='right') - 1
        return int(min(interval, len(self.cycle_lengths) - 1))

    def __call__(self, step) -> float:
        step = int(step)
        c = self._cycle(step)
        n = step - int(self.cum_cycles[c])
        if n < self.warm_up_steps[c]:
            return (self.f_max[c] - self.f_start[c]) \
                / self.warm_up_steps[c] * n + self.f_start[c]
        return self.f_min[c] + (self.f_max[c] - self.f_min[c]) \
            * (self.cycle_lengths[c] - n) / self.cycle_lengths[c]


# ---------------------------------------------------------------------------
# Spec dataclasses the targets resolve into
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DiscretizationSpec:
    """LegacyDDPMDiscretization: σ table over the LDM sqrt-space β
    schedule (reference ``sgm/modules/diffusionmodules/discretizer.py``)."""
    num_timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120

    def __call__(self, n: int) -> np.ndarray:
        from .diffusion.edm import legacy_ddpm_sigmas
        return legacy_ddpm_sigmas(n, self.num_timesteps,
                                  self.linear_start, self.linear_end)


def _module(make, generator, state_dict, device):
    """``make()`` built on ``device``: ``state_dict`` loaded when given,
    else every parameter drawn from ``generator`` (a generator seeded
    with 0 when None)."""
    import torch

    from .models.layers import random_init_
    with torch.device(device):
        model = make().to(device)   # buffers made from numpy too
    if state_dict is None:
        random_init_(model, generator or torch.Generator(
            device=device).manual_seed(0))
    else:
        model.load_state_dict(state_dict)
    return model.eval()


@dataclasses.dataclass(frozen=True)
class EmbedderSpec:
    """One ``emb_models`` entry, resolved to an embedder maker of the port.

    ``maker`` ∈ {'clip_text', 'clip_image', 'clip_image_mv', 'dino',
    'dino_mv', 'dino_mv_plucker', 'concat_timestep'}; ``options`` carries
    the maker's yaml params (arch, n_cond_frames, …)."""
    maker: str
    input_key: str
    ucg_rate: float = 0.0
    is_trainable: bool = False
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def build(self, generator=None, state_dict=None, device='cuda',
              model_cfg=None):
        """Build the tower on ``device`` and wrap it as an ``Embedder``.

        ``state_dict``: converted pretrained weights under the port's names
        (``conditioning/convert.py`` and the bridge); without one the
        weights are drawn from ``generator`` (wall-clock identical).
        ``model_cfg`` replaces the tower's full-size config."""
        from .conditioning import conditioner as C
        from .pipeline import resolve_device

        device = resolve_device(device)
        if self.maker == 'clip_text':
            from .conditioning.clip import CLIPTextConfig, CLIPTextModel
            model = _module(lambda: CLIPTextModel(
                model_cfg or CLIPTextConfig()), generator, state_dict,
                device)
            return C.make_clip_text_embedder(
                model, ucg_rate=self.ucg_rate,
                always_return_pooled=self.options.get(
                    'always_return_pooled', True))
        if self.maker in ('clip_image', 'clip_image_mv'):
            from .conditioning.clip import CLIPVisionConfig, CLIPVisionModel
            model = _module(lambda: CLIPVisionModel(
                model_cfg or CLIPVisionConfig()), generator, state_dict,
                device)
            emb = C.make_clip_image_embedder(model, ucg_rate=self.ucg_rate)
            if self.maker == 'clip_image_mv':
                # FrozenOpenCLIPImageMVEmbedder (reference modules.py:1658):
                # encode only the first condition frame of (B, V, H, W, 3).
                inner = emb.encode
                emb = dataclasses.replace(
                    emb, encode=lambda vid: inner(vid[:, 0]),
                    name='clip_image_mv')
            return emb
        if self.maker in ('dino', 'dino_mv', 'dino_mv_plucker'):
            from .models.vit import VisionTransformer, vit_registry
            arch = {'vits': 'dinov2-s/14', 'vitb': 'dinov2-b/14',
                    'vitl': 'dinov2-l/14'}.get(
                        self.options.get('arch', 'vitl'), 'dinov2-l/14')
            # mv-plucker takes a 9-channel patch embed (RGB + Plücker)
            in_ch = 9 if self.maker == 'dino_mv_plucker' else 3
            model = _module(lambda: VisionTransformer(
                model_cfg or vit_registry(arch), in_channels=in_ch),
                generator, state_dict, device)
            if self.maker == 'dino':
                return C.make_dino_embedder(model, ucg_rate=self.ucg_rate)
            make = (C.make_dino_mv_embedder if self.maker == 'dino_mv'
                    else C.make_dino_mv_plucker_embedder)
            return make(model, ucg_rate=self.ucg_rate,
                        n_cond_frames=self.options.get('n_cond_frames', 4))
        if self.maker == 'concat_timestep':
            return C.make_concat_timestep_embedder(
                outdim=self.options.get('outdim', 256),
                input_key=self.input_key, ucg_rate=self.ucg_rate,
                device=device)
        raise ValueError(f'unknown embedder maker {self.maker!r}')


@dataclasses.dataclass(frozen=True)
class ConditionerSpec:
    embedders: tuple

    def build(self, generator=None,
              state_dicts: Optional[Mapping[str, Any]] = None,
              device='cuda', model_cfgs: Optional[Mapping[str, Any]] = None):
        """→ ``GeneralConditioner``.  ``state_dicts`` and ``model_cfgs``
        map maker names to weights and configs (missing: drawn from
        ``generator`` in the embedders' order, full size)."""
        from .conditioning.conditioner import GeneralConditioner
        state_dicts = state_dicts or {}
        model_cfgs = model_cfgs or {}
        return GeneralConditioner([
            spec.build(generator, state_dicts.get(spec.maker), device,
                       model_cfgs.get(spec.maker))
            for spec in self.embedders])


@dataclasses.dataclass(frozen=True)
class LossSpec:
    """loss_fn_config → one of the trainer objectives.

    kind 'edm' ⇔ StandardDiffusionLoss (EpsWeighting ≡ eps-MSE against the
    DiscreteDenoiser); 'flow_matching' ⇔ FMLoss over a Transport."""
    kind: str
    weighting: str = 'eps'
    num_idx: int = 1000
    transport: Optional[Any] = None   # TransportSpec for kind='flow_matching'

    @property
    def objective(self) -> str:
        """The LDMTrainConfig.objective string this loss selects."""
        return self.kind

    def make_loss_fn(self, denoiser=None) -> Callable:
        """→ ``fn(network, x0, cond, generator=None, **draws)``, the
        per-sample loss; the draws come from ``generator`` unless given:
        ``sigma_idx`` (B,) and ``noise`` for 'edm', ``t`` (B,) and
        ``noise`` for 'flow_matching'."""
        if self.kind == 'edm':
            from .diffusion.edm import DiscreteDenoiser, edm_training_loss
            den = denoiser or DiscreteDenoiser(num_idx=self.num_idx)

            def edm_loss(network, x0, cond, generator=None, sigma_idx=None,
                         noise=None):
                return edm_training_loss(
                    den, network, x0, cond, loss_weighting=self.weighting,
                    generator=generator, sigma_idx=sigma_idx, noise=noise)
            return edm_loss
        if self.kind == 'flow_matching':
            from .diffusion.transport import Transport
            transport = Transport(self.transport)

            def fm_loss(network, x0, cond, generator=None, t=None,
                        noise=None):
                # one network signature net(x, t, cond_dict) for both kinds
                return transport.training_losses(
                    lambda xt, tt, **kw: network(xt, tt, kw), x0, cond,
                    generator=generator, t=t, noise=noise)['loss']
            return fm_loss
        raise ValueError(f'unknown loss kind {self.kind!r}')


@dataclasses.dataclass(frozen=True)
class GuiderSpec:
    scale: float = 6.5


@dataclasses.dataclass(frozen=True)
class EulerEDMSamplerSpec:
    num_steps: int = 250
    discretization: DiscretizationSpec = DiscretizationSpec()
    guider: GuiderSpec = GuiderSpec()
    s_churn: float = 0.0
    s_noise: float = 1.0

    def sample(self, denoiser, network, shape, cond, uc, generator=None,
               x_init=None, noise=None, device=None):
        """``euler_edm_sample`` at this spec's steps, guidance and churn;
        the start ``x_init`` and the churn ``noise`` stack come from
        ``generator`` unless given."""
        from .diffusion.edm import euler_edm_sample
        return euler_edm_sample(denoiser, network, shape, cond, uc,
                                num_steps=self.num_steps,
                                cfg_scale=self.guider.scale,
                                s_churn=self.s_churn, s_noise=self.s_noise,
                                device=device, generator=generator,
                                x_init=x_init, noise=noise)


@dataclasses.dataclass(frozen=True)
class SGMStack:
    """Everything an ``ldm_configs:`` block assembles."""
    conditioner: Optional[ConditionerSpec] = None
    denoiser: Optional[Any] = None            # DiscreteDenoiser
    loss: Optional[LossSpec] = None
    sampler: Optional[EulerEDMSamplerSpec] = None
    scheduler: Optional[LambdaLinearScheduler] = None
    guider: Optional[GuiderSpec] = None       # top-level guider_config


# ---------------------------------------------------------------------------
# Target registry + instantiate_from_config
# ---------------------------------------------------------------------------


def _build_scaling(cfg) -> str:
    name = cfg['target'].rsplit('.', 1)[-1]
    return {'EpsScaling': 'eps', 'VScaling': 'v',
            'EDMScaling': 'edm',
            'VScalingWithEDMcNoise': 'v-edm-cnoise'}[name]


def _build_discretization(params) -> DiscretizationSpec:
    return DiscretizationSpec(
        num_timesteps=params.get('num_timesteps', 1000),
        linear_start=params.get('linear_start', 0.00085),
        linear_end=params.get('linear_end', 0.0120))


def _build_denoiser(params):
    from .diffusion.edm import DiscreteDenoiser
    scaling = 'eps'
    if 'scaling_config' in params:
        scaling = _build_scaling(params['scaling_config'])
    # the discretization_config is honored through DiscreteDenoiser's own
    # legacy-DDPM σ table; non-default linear_start/end are not used by any
    # released LN3Diff config.
    return DiscreteDenoiser(num_idx=params.get('num_idx', 1000),
                            scaling=scaling)


_EMBEDDER_MAKERS = {
    'FrozenCLIPEmbedder': 'clip_text',
    'FrozenOpenCLIPImageEmbedder': 'clip_image',
    'FrozenOpenCLIPImageMVEmbedder': 'clip_image_mv',
    'FrozenDinov2ImageEmbedder': 'dino',
    'FrozenDinov2ImageEmbedderMV': 'dino_mv',
    'FrozenDinov2ImageEmbedderMVPlucker': 'dino_mv_plucker',
    'ConcatTimestepEmbedderND': 'concat_timestep',
}


def _build_conditioner(params) -> ConditionerSpec:
    specs = []
    for emb in params.get('emb_models', ()):
        name = emb['target'].rsplit('.', 1)[-1]
        if name not in _EMBEDDER_MAKERS:
            raise ValueError(
                f'unknown embedder target {emb["target"]!r}; known: '
                f'{sorted(_EMBEDDER_MAKERS)}')
        opts = dict(emb.get('params') or {})
        specs.append(EmbedderSpec(
            maker=_EMBEDDER_MAKERS[name],
            input_key=emb['input_key'],
            ucg_rate=float(emb.get('ucg_rate', 0.0)),
            is_trainable=bool(emb.get('is_trainable', False)),
            options=opts))
    return ConditionerSpec(embedders=tuple(specs))


def _build_transport(params):
    from .diffusion.transport import TransportSpec
    snr = params.get('snr_type', 'uniform')
    return TransportSpec(
        path={'Linear': 'linear', 'GVP': 'gvp', 'VP': 'vp'}.get(
            params.get('path_type', 'Linear'), 'linear'),
        t_sampling='lognorm' if snr == 'lognorm' else 'uniform')


def _build_standard_loss(params) -> LossSpec:
    weighting = 'eps'
    if 'loss_weighting_config' in params:
        name = params['loss_weighting_config']['target'].rsplit('.', 1)[-1]
        weighting = {'EpsWeighting': 'eps', 'UnitWeighting': 'unit'}[name]
    num_idx = 1000
    ss = params.get('sigma_sampler_config')
    if ss:
        num_idx = (ss.get('params') or {}).get('num_idx', 1000)
    return LossSpec(kind='edm', weighting=weighting, num_idx=num_idx)


def _build_fm_loss(params) -> LossSpec:
    tcfg = params.get('transport_config')
    transport = instantiate_from_config(tcfg) if tcfg else None
    if transport is None:
        from .diffusion.transport import TransportSpec
        transport = TransportSpec()
    return LossSpec(kind='flow_matching', transport=transport)


def _build_guider(params) -> GuiderSpec:
    return GuiderSpec(scale=float(params.get('scale', 6.5)))


def _build_sampler(params) -> EulerEDMSamplerSpec:
    disc = DiscretizationSpec()
    if 'discretization_config' in params:
        disc = _build_discretization(
            params['discretization_config'].get('params') or {})
    guider = GuiderSpec()
    if 'guider_config' in params:
        guider = instantiate_from_config(params['guider_config'])
    return EulerEDMSamplerSpec(
        num_steps=params.get('num_steps', 250), discretization=disc,
        guider=guider, s_churn=float(params.get('s_churn', 0.0)),
        s_noise=float(params.get('s_noise', 1.0)))


def _build_lambda_linear(params) -> LambdaLinearScheduler:
    return LambdaLinearScheduler(
        warm_up_steps=params['warm_up_steps'],
        f_min=params.get('f_min', [1.0]), f_max=params.get('f_max', [1.0]),
        f_start=params.get('f_start', [1e-6]),
        cycle_lengths=params['cycle_lengths'])


_TARGETS: dict = {
    'sgm.lr_scheduler.LambdaLinearScheduler': _build_lambda_linear,
    'sgm.modules.diffusionmodules.denoiser.DiscreteDenoiser':
        _build_denoiser,
    'sgm.modules.GeneralConditioner': _build_conditioner,
    'sgm.modules.encoders.modules.GeneralConditioner': _build_conditioner,
    'sgm.modules.diffusionmodules.loss.StandardDiffusionLoss':
        _build_standard_loss,
    'sgm.modules.diffusionmodules.loss.FMLoss': _build_fm_loss,
    'sgm.modules.diffusionmodules.sampling.EulerEDMSampler': _build_sampler,
    'sgm.modules.diffusionmodules.guiders.VanillaCFG': _build_guider,
    'sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization':
        _build_discretization,
    'transport.create_transport': _build_transport,
}


def instantiate_from_config(cfg: Mapping) -> Any:
    """Resolve a ``{'target': dotted.name, 'params': {...}}`` mapping to a
    port object (reference ``sgm/util.py`` ``instantiate_from_config``,
    restricted to a fixed registry instead of arbitrary imports)."""
    if 'target' not in cfg:
        raise KeyError('config block has no "target" key')
    target = cfg['target']
    if target not in _TARGETS:
        raise ValueError(f'unknown target {target!r}; known targets: '
                         f'{sorted(_TARGETS)}')
    return _TARGETS[target](dict(cfg.get('params') or {}))


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            'load_ldm_configs reads a path or a yaml string with PyYAML, '
            'which is not installed; pass an already-parsed mapping') from e
    return yaml


def load_ldm_configs(source) -> SGMStack:
    """Assemble an :class:`SGMStack` from a reference sgm yaml config.

    ``source`` — a path to a yaml file, a yaml string, or an
    already-parsed mapping.  Accepts the reference layout: a top-level
    ``ldm_configs:`` block with ``{scheduler,denoiser,conditioner,
    loss_fn,sampler}_config`` children plus an optional top-level
    ``guider_config`` (the mv23d FM configs place the guider there).
    """
    if isinstance(source, Mapping):
        doc = dict(source)
    elif isinstance(source, str) and (os.path.exists(source)
                                      or source.endswith(('.yaml', '.yml'))):
        with open(source) as f:
            doc = _yaml().safe_load(f)
    else:
        doc = _yaml().safe_load(source)
    if doc is None:
        raise ValueError('empty yaml config')
    if 'ldm_configs' in doc:
        block = doc['ldm_configs'] or {}
    elif 'model' in doc:
        # vendored SD-style layout (model.params.*_config, e.g.
        # txt2img-clipl.yaml): pick up the sub-configs assembled here;
        # network/first_stage come from the port's model presets.
        block = (doc['model'] or {}).get('params') or {}
    else:
        block = doc

    def get(name):
        sub = block.get(name)
        return instantiate_from_config(sub) if sub else None

    guider_cfg = block.get('guider_config') or doc.get('guider_config')
    return SGMStack(
        conditioner=get('conditioner_config'),
        denoiser=get('denoiser_config'),
        loss=get('loss_fn_config'),
        sampler=get('sampler_config'),
        scheduler=get('scheduler_config'),
        guider=instantiate_from_config(guider_cfg) if guider_cfg else None)
