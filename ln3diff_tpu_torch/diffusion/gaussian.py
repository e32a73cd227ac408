"""Discrete-time Gaussian diffusion: schedules, respacing and DDIM with
classifier-free guidance.

Port of the sampling side of ``ln3diff_tpu/diffusion/gaussian.py``
(``get_named_beta_schedule`` :33, ``space_timesteps`` :53,
``GaussianDiffusion`` :132 with ``p_mean_variance`` and
``ddim_sample_loop`` :447, ``make_cfg_model_fn`` :568,
``make_diffusion`` :598).  The schedule tables are computed in float64
with numpy and kept as f32 tensors; the JAX scan over steps is a Python
loop.  Training losses, the VLB and the other samplers wait for later
slices, as do the learned-variance and LSGM mixing options.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

ModelFn = Callable[..., torch.Tensor]  # (x, t, **kwargs) -> model output


def get_named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    if name == 'linear':
        scale = 1000 / num_steps
        return np.linspace(scale * 1e-4, scale * 0.02, num_steps,
                           dtype=np.float64)
    if name == 'cosine':
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2)**2
        betas = []
        for i in range(num_steps):
            t1, t2 = i / num_steps, (i + 1) / num_steps
            betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), 0.999))
        return np.array(betas)
    if name == 'linear_simple':
        return np.array([min(0.999, 0.001 / (1.001 - i / num_steps))
                         for i in range(num_steps)])
    raise NotImplementedError(name)


def space_timesteps(num_timesteps: int, section_counts) -> list[int]:
    """Timesteps to keep: "ddimN", "N", or per-section counts."""
    if isinstance(section_counts, str):
        if section_counts.startswith('ddim'):
            desired = int(section_counts[len('ddim'):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return list(range(0, num_timesteps, i))
            raise ValueError(
                f'cannot create exactly {desired} steps with an integer'
                ' stride')
        section_counts = [int(x) for x in section_counts.split(',')]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f'cannot divide section of {size} steps into'
                             f' {count}')
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur_idx = 0.0
        taken = []
        for _ in range(count):
            taken.append(start_idx + round(cur_idx))
            cur_idx += stride
        all_steps += taken
        start_idx += size
    return sorted(all_steps)


@dataclasses.dataclass(frozen=True)
class DiffusionSpec:
    schedule: str = 'linear'
    steps: int = 1000
    mean_type: str = 'eps'            # 'eps' | 'x0' | 'v'
    var_type: str = 'fixed_small'     # 'fixed_small' | 'fixed_large'


_TABLES = ('betas', 'alphas_cumprod', 'alphas_cumprod_prev',
           'sqrt_alphas_cumprod', 'sqrt_one_minus_alphas_cumprod',
           'sqrt_recip_alphas_cumprod', 'sqrt_recipm1_alphas_cumprod',
           'posterior_variance', 'posterior_log_variance_clipped',
           'posterior_mean_coef1', 'posterior_mean_coef2')


class GaussianDiffusion:
    """Schedule tables and the q/p math used by DDIM sampling."""

    def __init__(self, spec: DiffusionSpec,
                 use_timesteps: Optional[list[int]] = None):
        if spec.var_type not in ('fixed_small', 'fixed_large'):
            raise NotImplementedError(f'var_type {spec.var_type!r}')
        self.spec = spec
        betas = get_named_beta_schedule(spec.schedule, spec.steps)

        if use_timesteps is not None:
            # respacing: recompute betas over the kept subsequence
            keep = set(use_timesteps)
            last = 1.0
            new_betas, tmap = [], []
            for i, a in enumerate(np.cumprod(1.0 - betas)):
                if i in keep:
                    new_betas.append(1 - a / last)
                    last = a
                    tmap.append(i)
            betas = np.array(new_betas)
        else:
            tmap = list(range(spec.steps))
        self.num_timesteps = len(betas)

        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        tables = dict(
            betas=betas, alphas_cumprod=acp, alphas_cumprod_prev=acp_prev,
            sqrt_alphas_cumprod=np.sqrt(acp),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1 - acp),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acp),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acp - 1),
            posterior_variance=post_var,
            posterior_log_variance_clipped=np.log(
                np.append(post_var[1], post_var[1:])),
            posterior_mean_coef1=betas * np.sqrt(acp_prev) / (1.0 - acp),
            posterior_mean_coef2=(1.0 - acp_prev) * np.sqrt(alphas)
            / (1.0 - acp))
        self._host = {k: torch.tensor(v, dtype=torch.float32)
                      for k, v in tables.items()}
        self._host['timestep_map'] = torch.tensor(tmap, dtype=torch.int64)
        self._on_device = {}

    def table(self, name: str, device) -> torch.Tensor:
        """A schedule table on ``device`` (copied there once)."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = {k: v.to(device)
                                       for k, v in self._host.items()}
        return self._on_device[device][name]

    def _extract(self, name: str, t: torch.Tensor, ndim: int):
        out = self.table(name, t.device)[t]
        return out.reshape(t.shape + (1,) * (ndim - 1))

    def scale_t(self, t: torch.Tensor) -> torch.Tensor:
        """Model-facing timestep: the respaced index's original step."""
        return self.table('timestep_map', t.device)[t]

    def q_posterior_mean_variance(self, x_start, x_t, t):
        mean = (self._extract('posterior_mean_coef1', t, x_t.ndim) * x_start
                + self._extract('posterior_mean_coef2', t, x_t.ndim) * x_t)
        var = self._extract('posterior_variance', t, x_t.ndim)
        logvar = self._extract('posterior_log_variance_clipped', t, x_t.ndim)
        return mean, var, logvar

    def predict_xstart_from_eps(self, x_t, t, eps):
        return (self._extract('sqrt_recip_alphas_cumprod', t, x_t.ndim) * x_t
                - self._extract('sqrt_recipm1_alphas_cumprod', t, x_t.ndim)
                * eps)

    def predict_eps_from_xstart(self, x_t, t, x0):
        return ((self._extract('sqrt_recip_alphas_cumprod', t, x_t.ndim)
                 * x_t - x0)
                / self._extract('sqrt_recipm1_alphas_cumprod', t, x_t.ndim))

    def predict_xstart_from_v(self, x_t, t, v):
        return (self._extract('sqrt_alphas_cumprod', t, x_t.ndim) * x_t
                - self._extract('sqrt_one_minus_alphas_cumprod', t, x_t.ndim)
                * v)

    def p_mean_variance(self, model_output, x, t):
        """→ (mean, variance, log variance, x0) (reference
        ``p_mean_variance:273-349``, fixed variances)."""
        if self.spec.var_type == 'fixed_large':
            var = torch.cat([self.table('posterior_variance', x.device)[1:2],
                             self.table('betas', x.device)[1:]])
            model_variance = var[t].reshape(t.shape + (1,) * (x.ndim - 1))
            model_log_variance = torch.log(model_variance)
        else:
            model_variance = self._extract('posterior_variance', t, x.ndim)
            model_log_variance = self._extract(
                'posterior_log_variance_clipped', t, x.ndim)
        if self.spec.mean_type == 'eps':
            x0 = self.predict_xstart_from_eps(x, t, model_output)
        elif self.spec.mean_type == 'v':
            x0 = self.predict_xstart_from_v(x, t, model_output)
        else:
            x0 = model_output
        mean, _, _ = self.q_posterior_mean_variance(x0, x, t)
        return mean, model_variance, model_log_variance, x0

    @torch.no_grad()
    def ddim_sample_loop(self, model_fn: ModelFn, shape, device=None,
                         generator: Optional[torch.Generator] = None,
                         model_kwargs=None,
                         x_init: Optional[torch.Tensor] = None):
        """Deterministic DDIM (eta 0, reference ``ddim_sample_loop``).  The
        start noise is ``x_init`` when given (the tests feed JAX's draw),
        else drawn from ``generator``."""
        model_kwargs = model_kwargs or {}
        if x_init is None:
            x = torch.randn(shape, generator=generator, device=device)
        else:
            x = x_init.to(device=device, dtype=torch.float32)
        for i in range(self.num_timesteps):
            t = torch.full((shape[0],), self.num_timesteps - 1 - i,
                           dtype=torch.int64, device=x.device)
            out = model_fn(x, self.scale_t(t), **model_kwargs)
            _, _, _, x0 = self.p_mean_variance(out, x, t)
            eps = self.predict_eps_from_xstart(x, t, x0)
            alpha_bar_prev = self._extract('alphas_cumprod_prev', t, x.ndim)
            x = (x0 * torch.sqrt(alpha_bar_prev)
                 + torch.sqrt(1 - alpha_bar_prev) * eps)
        return x


def make_cfg_model_fn(model_fn: ModelFn, cfg_scale: float,
                      uncond_kwargs: dict):
    """Classifier-free guidance by batch doubling: the returned model_fn
    runs cond and uncond in one doubled batch."""

    def guided(x, t, **cond_kwargs):
        xx = torch.cat([x, x], dim=0)
        tt = torch.cat([t, t], dim=0)
        kwargs = {}
        for k, c in cond_kwargs.items():
            u = uncond_kwargs[k]
            if isinstance(c, dict):
                kwargs[k] = {n: torch.cat([c[n], u[n]], dim=0) for n in c}
            else:
                kwargs[k] = torch.cat([c, u], dim=0)
        cond, uncond = model_fn(xx, tt, **kwargs).chunk(2, dim=0)
        return uncond + cfg_scale * (cond - uncond)

    return guided


def make_diffusion(schedule: str = 'linear', steps: int = 1000,
                   mean_type: str = 'eps', var_type: str = 'fixed_small',
                   timestep_respacing: str | None = None
                   ) -> GaussianDiffusion:
    spec = DiffusionSpec(schedule=schedule, steps=steps, mean_type=mean_type,
                         var_type=var_type)
    use = None
    if timestep_respacing:
        use = space_timesteps(steps, timestep_respacing)
    return GaussianDiffusion(spec, use_timesteps=use)
