"""Discrete-time Gaussian diffusion: schedules, respacing, the DDPM,
DDIM, PLMS and reverse-DDIM samplers and classifier-free guidance.

Port of the sampling side of ``ln3diff_tpu/diffusion/gaussian.py``
(``get_named_beta_schedule`` :33, ``space_timesteps`` :53,
``DiffusionSpec`` :87, ``GaussianDiffusion`` :132 with ``scale_t`` :188,
the LSGM mixing ``_apply_mixing`` :244, ``p_mean_variance`` :264,
``p_sample_loop`` :419, ``ddim_sample_loop`` :444, ``plms_sample_loop``
:481, ``ddim_reverse_sample_loop`` :542, ``make_cfg_model_fn`` :568,
``make_diffusion`` :598) and its training half: ``mean_flat``,
``normal_kl``, ``approx_standard_normal_cdf`` and
``discretized_gaussian_log_likelihood`` :101-131, the VLB terms
``_vb_terms_bpd`` :315, ``prior_bpd`` :332, ``calc_bpd_loop`` :342 and
``training_losses`` :376 (mse, kl, rescaled_kl and rescaled_mse; eps, v
and x0 targets; the learned-range variance trained through the VLB with
the mean half detached).  The schedule tables are computed in float64
with numpy and kept as f32 tensors; each JAX scan over steps is a Python
loop.  The noise of a loss is a tensor argument (the tests feed JAX's
draws) or a draw from a ``torch.Generator``.
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
    # 'fixed_small' | 'fixed_large' | 'learned_range'
    var_type: str = 'fixed_small'
    mixed_prediction: bool = False    # LSGM mixing-logit prediction
    clip_denoised: bool = False
    rescale_timesteps: bool = False
    # 'mse' | 'rescaled_mse' (hybrid: MSE + the detached-mean VLB for
    # learned_range) | 'kl' | 'rescaled_kl'
    loss_type: str = 'mse'


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.ndim)))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL of two diagonal Gaussians, elementwise in nats (reference
    ``guided_diffusion/losses.py:12``)."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2)**2 * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """log p of uint8-discretized data in [-1, 1] under a Gaussian
    (reference ``losses.py:50``): the CDF mass of the 1/255-wide bin."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))


_TABLES = ('betas', 'alphas_cumprod', 'alphas_cumprod_prev',
           'alphas_cumprod_next', 'sqrt_alphas_cumprod',
           'sqrt_one_minus_alphas_cumprod', 'sqrt_recip_alphas_cumprod',
           'sqrt_recipm1_alphas_cumprod', 'posterior_variance',
           'posterior_log_variance_clipped', 'posterior_mean_coef1',
           'posterior_mean_coef2')


def _start_noise(shape, device, generator, x_init):
    """``x_init`` (the tests feed JAX's draw) or a standard normal draw
    from ``generator``."""
    if x_init is None:
        return torch.randn(shape, generator=generator, device=device)
    return x_init.to(device=device, dtype=torch.float32)


def _step_noise(noise, i, x, generator):
    """Step ``i``'s draw: ``noise[i]`` of a given (steps, *shape) stack, or
    a standard normal draw from ``generator``."""
    if noise is not None:
        return noise[i].to(device=x.device, dtype=x.dtype)
    return torch.randn(x.shape, generator=generator, device=x.device)


class GaussianDiffusion:
    """Schedule tables and the q/p math of the samplers."""

    def __init__(self, spec: DiffusionSpec,
                 use_timesteps: Optional[list[int]] = None):
        if spec.var_type not in ('fixed_small', 'fixed_large',
                                 'learned_range'):
            raise NotImplementedError(f'var_type {spec.var_type!r}')
        self.spec = spec
        betas = get_named_beta_schedule(spec.schedule, spec.steps)
        self.original_num_steps = spec.steps

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
            alphas_cumprod_next=np.append(acp[1:], 0.0),
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

    def _t(self, value: int, batch: int, device) -> torch.Tensor:
        return torch.full((batch,), value, dtype=torch.int64, device=device)

    def scale_t(self, t: torch.Tensor) -> torch.Tensor:
        """Model-facing timestep: the respaced index's original step, as an
        f32 ``step·1000/original steps`` with ``rescale_timesteps``."""
        mapped = self.table('timestep_map', t.device)[t]
        if self.spec.rescale_timesteps:
            return mapped.float() * (1000.0 / self.original_num_steps)
        return mapped

    # -- prediction conversions --------------------------------------------

    def q_sample(self, x_start, t, noise):
        return (self._extract('sqrt_alphas_cumprod', t, x_start.ndim)
                * x_start
                + self._extract('sqrt_one_minus_alphas_cumprod', t,
                                x_start.ndim) * noise)

    def predict_v(self, x_start, t, noise):
        return (self._extract('sqrt_alphas_cumprod', t, x_start.ndim) * noise
                - self._extract('sqrt_one_minus_alphas_cumprod', t,
                                x_start.ndim) * x_start)

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

    def predict_eps_from_v(self, x_t, t, v):
        return (self._extract('sqrt_alphas_cumprod', t, x_t.ndim) * v
                + self._extract('sqrt_one_minus_alphas_cumprod', t, x_t.ndim)
                * x_t)

    def _apply_mixing(self, model_output, x_t, t, mixing_logit,
                      space: str = 'eps'):
        """LSGM mixed prediction: (1 − σ(logit))·component +
        σ(logit)·model_output, where the component is the analytic
        denoiser of the N(0, I) prior, √(1−ᾱ_t)·x_t in ``'eps'`` space
        (model_output must already be eps) and √ᾱ_t·x_t in ``'x0'``."""
        m = torch.sigmoid(mixing_logit)
        table = ('sqrt_one_minus_alphas_cumprod' if space == 'eps'
                 else 'sqrt_alphas_cumprod')
        mixing_component = self._extract(table, t, x_t.ndim) * x_t
        return (1 - m) * mixing_component + m * model_output

    def p_mean_variance(self, model_output, x, t,
                        mixing_logit: Optional[torch.Tensor] = None):
        """→ (mean, variance, log variance, x0) (reference
        ``p_mean_variance:273-349``).  ``learned_range`` splits the output's
        channels in halves, the second interpolating the log variance
        between the clipped posterior's and log β; with
        ``mixed_prediction`` and a logit, v outputs turn into eps first,
        then mix."""
        spec = self.spec
        if spec.var_type == 'learned_range':
            model_output, var_values = model_output.chunk(2, dim=-1)
            min_log = self._extract('posterior_log_variance_clipped', t,
                                    x.ndim)
            max_log = torch.log(self.table('betas', x.device))[t].reshape(
                t.shape + (1,) * (x.ndim - 1))
            frac = (var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        elif spec.var_type == 'fixed_large':
            var = torch.cat([self.table('posterior_variance', x.device)[1:2],
                             self.table('betas', x.device)[1:]])
            model_variance = var[t].reshape(t.shape + (1,) * (x.ndim - 1))
            model_log_variance = torch.log(model_variance)
        else:
            model_variance = self._extract('posterior_variance', t, x.ndim)
            model_log_variance = self._extract(
                'posterior_log_variance_clipped', t, x.ndim)

        mean_type = spec.mean_type
        if spec.mixed_prediction and mixing_logit is not None:
            if mean_type == 'v':
                model_output = self.predict_eps_from_v(x, t, model_output)
                mean_type = 'eps'
            space = 'x0' if mean_type == 'x0' else 'eps'
            model_output = self._apply_mixing(model_output, x, t,
                                              mixing_logit, space=space)
        if mean_type == 'eps':
            x0 = self.predict_xstart_from_eps(x, t, model_output)
        elif mean_type == 'v':
            x0 = self.predict_xstart_from_v(x, t, model_output)
        else:
            x0 = model_output
        if spec.clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        mean, _, _ = self.q_posterior_mean_variance(x0, x, t)
        return mean, model_variance, model_log_variance, x0

    def _eps(self, model_fn, x, t, model_kwargs, mixing_logit):
        """The eps that the model's x0 implies at (x, t), and that x0."""
        out = model_fn(x, self.scale_t(t), **model_kwargs)
        _, _, _, x0 = self.p_mean_variance(out, x, t, mixing_logit)
        return self.predict_eps_from_xstart(x, t, x0), x0

    # -- variational bound (reference :1012-1177) --------------------------

    def _vb_terms_bpd(self, model_output, x_start, x_t, t,
                      mixing_logit=None):
        """One VLB term in bits: KL(q(x_{t-1}|x_t, x0) ‖ p(x_{t-1}|x_t)),
        the decoder NLL at t = 0.  ``model_output`` is the raw network
        output (both halves for learned_range).  → (term (B,), x0)."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(
            x_start, x_t, t)
        mean, _, log_var, x0 = self.p_mean_variance(
            model_output, x_t, t, mixing_logit=mixing_logit)
        ln2 = math.log(2.0)
        kl = mean_flat(normal_kl(true_mean, true_log_var, mean,
                                 log_var)) / ln2
        decoder_nll = -mean_flat(discretized_gaussian_log_likelihood(
            x_start, means=mean, log_scales=0.5 * log_var)) / ln2
        return torch.where(t == 0, decoder_nll, kl), x0

    def prior_bpd(self, x_start):
        """KL(q(x_T|x_0) ‖ N(0, I)) in bits (reference ``_prior_bpd``)."""
        t = self._t(self.num_timesteps - 1, x_start.shape[0], x_start.device)
        mean = self._extract('sqrt_alphas_cumprod', t, x_start.ndim) * x_start
        acp = self.table('alphas_cumprod', x_start.device)[t]
        logvar = torch.log(1.0 - acp).reshape(t.shape + (1,)
                                              * (x_start.ndim - 1))
        zero = torch.zeros((), device=x_start.device)
        return mean_flat(normal_kl(mean, logvar, zero, zero)) / math.log(2.0)

    @torch.no_grad()
    def calc_bpd_loop(self, model_fn: ModelFn, x_start,
                      generator: Optional[torch.Generator] = None,
                      model_kwargs=None,
                      noise: Optional[torch.Tensor] = None):
        """Full-chain NLL (reference ``calc_bpd_loop:1110-1177``): the VLB
        term of every t and the prior bpd.  Step i evaluates t = T−1−i
        with ``noise[i]`` of a (T, *x_start.shape) stack when given, else a
        draw from ``generator``.  → dict of total_bpd (B,), prior_bpd
        (B,), and vb, mse, xstart_mse (B, T) with columns t = T−1 .. 0."""
        model_kwargs = model_kwargs or {}
        B = x_start.shape[0]
        vb, mse, xstart_mse = [], [], []
        for i in range(self.num_timesteps):
            t = self._t(self.num_timesteps - 1 - i, B, x_start.device)
            n = _step_noise(noise, i, x_start, generator)
            x_t = self.q_sample(x_start, t, n)
            out = model_fn(x_t, self.scale_t(t), **model_kwargs)
            term, x0 = self._vb_terms_bpd(out, x_start, x_t, t)
            eps = self.predict_eps_from_xstart(x_t, t, x0)
            vb.append(term)
            mse.append(mean_flat((eps - n)**2))
            xstart_mse.append(mean_flat((x0 - x_start)**2))
        vb = torch.stack(vb, dim=1)
        prior = self.prior_bpd(x_start)
        return {'total_bpd': vb.sum(dim=1) + prior, 'prior_bpd': prior,
                'vb': vb, 'mse': torch.stack(mse, dim=1),
                'xstart_mse': torch.stack(xstart_mse, dim=1)}

    # -- training losses (reference :1050-1175) ----------------------------

    def training_losses(self, model_fn: ModelFn, x_start, t,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        model_kwargs=None) -> dict:
        """The per-sample losses at integer steps ``t`` (B,): the model sees
        x_t from ``noise`` (else a standard normal draw from ``generator``)
        and ``scale_t(t)``.  → dict with 'loss' (B,), 'x_t',
        'model_output' and, by loss type, 'mse' and 'vb'."""
        model_kwargs = model_kwargs or {}
        spec = self.spec
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator,
                                device=x_start.device, dtype=x_start.dtype)
        x_t = self.q_sample(x_start, t, noise)
        model_output = model_fn(x_t, self.scale_t(t), **model_kwargs)

        if spec.loss_type in ('kl', 'rescaled_kl'):
            vb, _ = self._vb_terms_bpd(model_output, x_start, x_t, t)
            loss = vb * self.num_timesteps \
                if spec.loss_type == 'rescaled_kl' else vb
            return {'loss': loss, 'vb': vb, 'x_t': x_t,
                    'model_output': model_output}
        if spec.loss_type not in ('mse', 'rescaled_mse'):
            raise NotImplementedError(f'loss_type {spec.loss_type!r}')

        terms = {}
        if spec.var_type == 'learned_range':
            # the variance head learns through the VLB, which must not
            # move the mean prediction (reference :1100-1127 frozen_out)
            mean_out, var_values = model_output.chunk(2, dim=-1)
            frozen = torch.cat([mean_out.detach(), var_values], dim=-1)
            vb, _ = self._vb_terms_bpd(frozen, x_start, x_t, t)
            if spec.loss_type == 'rescaled_mse':
                vb = vb * (self.num_timesteps / 1000.0)
            terms['vb'] = vb
            model_output = mean_out

        if spec.mean_type == 'eps':
            target = noise
        elif spec.mean_type == 'v':
            target = self.predict_v(x_start, t, noise)
        else:
            target = x_start
        mse = mean_flat((target - model_output)**2)
        terms.update(mse=mse, x_t=x_t, model_output=model_output)
        terms['loss'] = mse + terms['vb'] if 'vb' in terms else mse
        return terms

    # -- samplers ------------------------------------------------------------
    #
    # Each loop is JAX's ``lax.scan`` as a Python loop.  Start noise is
    # ``x_init`` when given, the per-step draws ``noise[i]`` of a (steps,
    # *shape) stack when given (the tests feed JAX's draws), else both
    # come from ``generator``.

    @torch.no_grad()
    def p_sample_loop(self, model_fn: ModelFn, shape, device=None,
                      generator: Optional[torch.Generator] = None,
                      model_kwargs=None,
                      mixing_logit: Optional[torch.Tensor] = None,
                      x_init: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None):
        """Ancestral DDPM sampling (reference ``p_sample_loop:627``)."""
        model_kwargs = model_kwargs or {}
        x = _start_noise(shape, device, generator, x_init)
        for i in range(self.num_timesteps):
            t = self._t(self.num_timesteps - 1 - i, shape[0], x.device)
            out = model_fn(x, self.scale_t(t), **model_kwargs)
            mean, _, log_var, _ = self.p_mean_variance(out, x, t,
                                                       mixing_logit)
            z = _step_noise(noise, i, x, generator)
            nonzero = (t > 0).to(x.dtype).reshape(
                (-1,) + (1,) * (x.ndim - 1))
            x = mean + nonzero * torch.exp(0.5 * log_var) * z
        return x

    @torch.no_grad()
    def ddim_sample_loop(self, model_fn: ModelFn, shape, device=None,
                         generator: Optional[torch.Generator] = None,
                         model_kwargs=None, eta: float = 0.0,
                         mixing_logit: Optional[torch.Tensor] = None,
                         x_init: Optional[torch.Tensor] = None,
                         noise: Optional[torch.Tensor] = None):
        """DDIM (reference ``ddim_sample_loop:908``); ``eta`` > 0 adds
        σ_t-scaled noise per step.  At η = 0 nothing is drawn after the
        start (JAX draws and multiplies by 0)."""
        model_kwargs = model_kwargs or {}
        x = _start_noise(shape, device, generator, x_init)
        for i in range(self.num_timesteps):
            t = self._t(self.num_timesteps - 1 - i, shape[0], x.device)
            eps, x0 = self._eps(model_fn, x, t, model_kwargs, mixing_logit)
            alpha_bar_prev = self._extract('alphas_cumprod_prev', t, x.ndim)
            if eta == 0:
                x = (x0 * torch.sqrt(alpha_bar_prev)
                     + torch.sqrt(1 - alpha_bar_prev) * eps)
                continue
            alpha_bar = self._extract('alphas_cumprod', t, x.ndim)
            sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                     * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
            z = _step_noise(noise, i, x, generator)
            mean_pred = (x0 * torch.sqrt(alpha_bar_prev)
                         + torch.sqrt(1 - alpha_bar_prev - sigma**2) * eps)
            nonzero = (t > 0).to(x.dtype).reshape(
                (-1,) + (1,) * (x.ndim - 1))
            x = mean_pred + nonzero * sigma * z
        return x

    @torch.no_grad()
    def plms_sample_loop(self, model_fn: ModelFn, shape, device=None,
                         generator: Optional[torch.Generator] = None,
                         model_kwargs=None,
                         mixing_logit: Optional[torch.Tensor] = None,
                         x_init: Optional[torch.Tensor] = None):
        """PLMS (reference ``ldm/models/diffusion/plms.py:144-242``): the
        deterministic DDIM transfer applied to an Adams–Bashforth
        extrapolation of the last ≤ 4 eps, orders 2, 3 and 4 as the
        history fills; the first step (t = T−1) averages eps at T−1 and at
        T−2, Heun-style.  T + 1 model calls."""
        model_kwargs = model_kwargs or {}
        x = _start_noise(shape, device, generator, x_init)

        def eps_at(x, t):
            return self._eps(model_fn, x, t, model_kwargs, mixing_logit)[0]

        def transfer(x, t, eps):
            x0 = self.predict_xstart_from_eps(x, t, eps)
            alpha_bar_prev = self._extract('alphas_cumprod_prev', t, x.ndim)
            return (x0 * torch.sqrt(alpha_bar_prev)
                    + torch.sqrt(1 - alpha_bar_prev) * eps)

        T = self.num_timesteps
        t0 = self._t(T - 1, shape[0], x.device)
        e0 = eps_at(x, t0)
        e0_next = eps_at(transfer(x, t0, e0), torch.clamp(t0 - 1, min=0))
        x = transfer(x, t0, (e0 + e0_next) / 2)
        hist = [e0]                     # newest first, at most 3
        for i in range(1, T):
            t = self._t(T - 1 - i, shape[0], x.device)
            e_t = eps_at(x, t)
            if len(hist) == 1:
                eps_prime = (3 * e_t - hist[0]) / 2
            elif len(hist) == 2:
                eps_prime = (23 * e_t - 16 * hist[0] + 5 * hist[1]) / 12
            else:
                eps_prime = (55 * e_t - 59 * hist[0] + 37 * hist[1]
                             - 9 * hist[2]) / 24
            x = transfer(x, t, eps_prime)
            hist = [e_t] + hist[:2]
        return x

    @torch.no_grad()
    def ddim_reverse_sample_loop(self, model_fn: ModelFn, x,
                                 model_kwargs=None,
                                 mixing_logit: Optional[torch.Tensor] = None):
        """Deterministic encoding x0 → x_T (reference
        ``ddim_reverse_sample:872``)."""
        model_kwargs = model_kwargs or {}
        for i in range(self.num_timesteps):
            t = self._t(i, x.shape[0], x.device)
            eps, x0 = self._eps(model_fn, x, t, model_kwargs, mixing_logit)
            alpha_bar_next = self._extract('alphas_cumprod_next', t, x.ndim)
            x = x0 * torch.sqrt(alpha_bar_next) \
                + torch.sqrt(1 - alpha_bar_next) * eps
        return x


def make_cfg_model_fn(model_fn: ModelFn, cfg_scale: float,
                      uncond_kwargs: dict, guided_channels: int = -1):
    """Classifier-free guidance by batch doubling: the returned model_fn
    runs cond and uncond in one doubled batch.  ``guided_channels`` > 0
    guides only the first channels and passes the rest (a learned
    variance half, say) through from the conditional half."""

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
        if guided_channels == -1:
            return uncond + cfg_scale * (cond - uncond)
        g = uncond[..., :guided_channels] + cfg_scale * (
            cond[..., :guided_channels] - uncond[..., :guided_channels])
        return torch.cat([g, cond[..., guided_channels:]], dim=-1)

    return guided


def make_diffusion(schedule: str = 'linear', steps: int = 1000,
                   mean_type: str = 'eps', var_type: str = 'fixed_small',
                   timestep_respacing: str | None = None,
                   mixed_prediction: bool = False,
                   rescale_timesteps: bool = False,
                   loss_type: str = 'mse') -> GaussianDiffusion:
    spec = DiffusionSpec(schedule=schedule, steps=steps, mean_type=mean_type,
                         var_type=var_type, mixed_prediction=mixed_prediction,
                         rescale_timesteps=rescale_timesteps,
                         loss_type=loss_type)
    use = None
    if timestep_respacing:
        use = space_timesteps(steps, timestep_respacing)
    return GaussianDiffusion(spec, use_timesteps=use)
