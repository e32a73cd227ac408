"""EDM-style denoiser wrapping, its training loss and the Euler sampler
with classifier-free guidance (the sgm stack).

Port of ``ln3diff_tpu/diffusion/edm.py``: ``legacy_ddpm_sigmas`` :28,
``ScalingFns`` :46 (every ``kind``), ``DiscreteDenoiser`` :75,
``discrete_sigma_sampler`` :102, ``edm_training_loss`` :112 and
``euler_edm_sample`` :131 (reference ``sgm/modules/diffusionmodules``:
``denoiser.py:45``, ``denoiser_scaling.py``, ``discretizer.py:42-69``,
``loss.py:14-46``, ``sampling.py:109-215``, ``guiders.py:24-42``).  The
σ tables are computed in float64 with numpy and kept as f32 tensors, as
JAX keeps them; the sampler's ``lax.scan`` is a Python loop.  Every draw
is a tensor argument (the tests feed JAX's) or comes from a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

ModelFn = Callable[..., torch.Tensor]  # (x, c_noise, cond) -> output


def _append_dims(x, ndim):
    return x.reshape(x.shape + (1,) * (ndim - x.ndim))


def legacy_ddpm_sigmas(n: int, num_timesteps: int = 1000,
                       linear_start: float = 0.00085,
                       linear_end: float = 0.0120) -> np.ndarray:
    """σ_i = sqrt((1 − ᾱ)/ᾱ) over the LDM "linear" (sqrt-space) β schedule,
    descending (reference ``LegacyDDPMDiscretization``)."""
    betas = np.linspace(linear_start**0.5, linear_end**0.5, num_timesteps,
                        dtype=np.float64)**2
    acp = np.cumprod(1.0 - betas)
    if n < num_timesteps:
        # generate_roughly_equally_spaced_steps
        idx = np.linspace(num_timesteps - 1, 0, n, endpoint=True)[::-1]
        idx = np.round(idx).astype(int)
        acp = acp[idx]
    sigmas = np.sqrt((1 - acp) / acp)
    return sigmas[::-1].copy()


@dataclasses.dataclass(frozen=True)
class ScalingFns:
    """(c_skip, c_out, c_in, c_noise) of σ for the parameterization
    ``kind``: 'eps', 'v', 'v-edm-cnoise' or 'edm'."""
    kind: str = 'eps'
    sigma_data: float = 0.5

    def __call__(self, sigma):
        if self.kind == 'eps':
            c_skip = torch.ones_like(sigma)
            c_out = -sigma
            c_in = 1 / torch.sqrt(sigma**2 + 1.0)
            c_noise = sigma
        elif self.kind in ('v', 'v-edm-cnoise'):
            c_skip = 1.0 / (sigma**2 + 1.0)
            c_out = -sigma / torch.sqrt(sigma**2 + 1.0)
            c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
            c_noise = sigma if self.kind == 'v' else 0.25 * torch.log(sigma)
        elif self.kind == 'edm':
            sd = self.sigma_data
            c_skip = sd**2 / (sigma**2 + sd**2)
            c_out = sigma * sd / torch.sqrt(sigma**2 + sd**2)
            c_in = 1 / torch.sqrt(sigma**2 + sd**2)
            c_noise = 0.25 * torch.log(sigma)
        else:
            raise NotImplementedError(f'scaling {self.kind!r}')
        return c_skip, c_out, c_in, c_noise


def _sigma_table(num_idx: int, device) -> torch.Tensor:
    """The ``num_idx`` discrete σ, ascending, f32."""
    return torch.tensor(legacy_ddpm_sigmas(num_idx, num_idx)[::-1].copy(),
                        dtype=torch.float32, device=device)


class DiscreteDenoiser:
    """Quantizes σ to the discrete table and gives the denoised-x
    parameterization D(x; σ) = c_out·F(c_in·x, c_noise) + c_skip·x.  With
    ``quantize_c_noise`` the network's c_noise is the table index (of c_noise
    for 'eps' and 'v', of the quantized σ otherwise), an integer tensor."""

    def __init__(self, num_idx: int = 1000, scaling: str = 'eps',
                 quantize_c_noise: bool = True):
        self.sigmas = _sigma_table(num_idx, 'cpu')
        self._on_device = {}
        self.scaling = ScalingFns(scaling)
        self.quantize_c_noise = quantize_c_noise

    def table(self, device) -> torch.Tensor:
        """The ascending σ table on ``device`` (copied there once)."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = self.sigmas.to(device)
        return self._on_device[device]

    def sigma_to_idx(self, sigma):
        d = (sigma[..., None] - self.table(sigma.device)).abs()
        return d.argmin(dim=-1)

    def __call__(self, network: ModelFn, x, sigma, cond):
        idx = self.sigma_to_idx(sigma)
        sigma_q = self.table(x.device)[idx]
        c_skip, c_out, c_in, c_noise = self.scaling(sigma_q)
        if self.quantize_c_noise:
            c_noise = self.sigma_to_idx(c_noise if self.scaling.kind
                                        in ('eps', 'v') else sigma_q)
        out = network(_append_dims(c_in, x.ndim) * x, c_noise, cond)
        return (out * _append_dims(c_out, x.ndim)
                + x * _append_dims(c_skip, x.ndim))


def discrete_sigma_sampler(batch: int, num_idx: int = 1000, device=None,
                           generator: Optional[torch.Generator] = None,
                           idx: Optional[torch.Tensor] = None):
    """σ at uniform indices of the discrete table (reference
    ``sigma_sampling.DiscreteSampling``); ``idx`` (batch,) when given,
    else drawn from ``generator``."""
    if idx is None:
        idx = torch.randint(0, num_idx, (batch,), generator=generator,
                            device=device)
    return _sigma_table(num_idx, device)[idx.to(device)]


def edm_training_loss(denoiser: DiscreteDenoiser, network: ModelFn, x0, cond,
                      loss_weighting: str = 'eps',
                      generator: Optional[torch.Generator] = None,
                      sigma_idx: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None):
    """StandardDiffusionLoss (reference ``loss.py:14-46``), per sample:
    the weighted squared error of the denoised x at σ from the discrete
    table.  'eps' weighting w(σ) = σ⁻² makes it the plain eps MSE.  The σ
    indices (B,) and the noise (x0's shape) are used when given, else
    drawn from ``generator``."""
    sigma = discrete_sigma_sampler(x0.shape[0], denoiser.sigmas.shape[0],
                                   x0.device, generator, sigma_idx)
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                            dtype=x0.dtype)
    x_noised = x0 + noise * _append_dims(sigma, x0.ndim)
    denoised = denoiser(network, x_noised, sigma, cond)
    w = 1.0 / sigma**2 if loss_weighting == 'eps' else torch.ones_like(sigma)
    return (_append_dims(w, x0.ndim) * (denoised - x0)**2).mean(
        dim=tuple(range(1, x0.ndim)))


@torch.no_grad()
def euler_edm_sample(denoiser: DiscreteDenoiser, network: ModelFn, shape,
                     cond, uc, num_steps: int = 250, cfg_scale: float = 6.5,
                     s_churn: float = 0.0, s_noise: float = 1.0,
                     device=None, generator: Optional[torch.Generator] = None,
                     x_init: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None):
    """EulerEDMSampler with VanillaCFG: ``num_steps`` Euler steps down the
    respaced σ schedule to 0, each denoising the batch doubled as [uc, c]
    (``cond``/``uc``: dicts of tensors, concatenated on the batch axis).
    The start is σ_0 times ``x_init`` (a standard normal draw, the tests
    feed JAX's) or a draw from ``generator``; with ``s_churn`` > 0 step i
    adds ``noise[i]`` of a (num_steps, *shape) stack when given, else a
    draw.  Without churn nothing is drawn after the start (JAX draws and
    discards)."""
    sigmas = torch.tensor(legacy_ddpm_sigmas(num_steps), dtype=torch.float32)
    sigmas = torch.cat([sigmas, torch.zeros(1)]).tolist()
    if x_init is None:
        x = torch.randn(shape, generator=generator, device=device)
    else:
        x = x_init.to(device=device, dtype=torch.float32)
    x = x * torch.tensor(sigmas[0], dtype=torch.float32)
    both_cond = {k: torch.cat([uc[k].to(x.device), cond[k].to(x.device)])
                 for k in cond}
    gamma = min(s_churn / num_steps, 2**0.5 - 1) if s_churn > 0 else 0.0

    def sigma_vec(value):
        return torch.full((shape[0],), value, dtype=torch.float32,
                          device=x.device)

    for i in range(num_steps):
        sigma = sigma_vec(sigmas[i])
        sigma_hat = sigma * (gamma + 1.0)
        if gamma > 0:
            eps = (noise[i].to(x.device, torch.float32) if noise is not None
                   else torch.randn(shape, generator=generator,
                                    device=x.device)) * s_noise
            x = x + eps * _append_dims(torch.sqrt(torch.clamp(
                sigma_hat**2 - sigma**2, min=0.0)), x.ndim)
        d = denoiser(network, torch.cat([x, x]),
                     torch.cat([sigma_hat, sigma_hat]), both_cond)
        d_u, d_c = d.chunk(2)
        denoised = d_u + cfg_scale * (d_c - d_u)
        d = (x - denoised) / _append_dims(sigma_hat, x.ndim)
        x = x + d * _append_dims(sigma_vec(sigmas[i + 1]) - sigma_hat, x.ndim)
    return x
