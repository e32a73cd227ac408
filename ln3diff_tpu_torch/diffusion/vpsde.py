"""Continuous-time VPSDE (LSGM) diffusion with importance-weighted t
sampling and the mixing-logit prediction.

Port of ``ln3diff_tpu/diffusion/vpsde.py`` (``IWQuantities`` :24,
``VPSDE`` :34 with ``inv_var`` :57, the prediction conversions :76-89,
``iw_quantities`` :93 in its six modes and ``sample_ode`` :144;
``get_mixed_prediction`` :169, ``vpsde_training_losses`` :180,
``kl_per_group`` :204, ``kl_balancer`` :214, ``vpsde_cross_entropy_per_dim``
:229 and ``kl_per_group_vada`` :249; reference
``guided_diffusion/continuous_diffusion.py``).  Every formula keeps JAX's
order of operations: ``inv_var`` cancels near ``var → σ²(ε)`` (``-β0 +
sqrt(β0² − 2a·c)``), so a reordering moves ``t`` by many ulps.

Randomness: the uniform ``rho`` of the t sampling and the noise are tensor
arguments (a test feeds JAX's draws) or draws from a ``torch.Generator``
(``rho`` first, then the noise, as JAX splits ``k_t, k_n``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch


class IWQuantities(NamedTuple):
    t: torch.Tensor               # (B,)
    var_t: torch.Tensor           # (B, 1, 1, 1) σ²(t)
    m_t: torch.Tensor             # (B, 1, 1, 1) mean coefficient α(t)
    obj_weight_t: torch.Tensor
    obj_weight_t_ll: torch.Tensor
    g2_t: torch.Tensor


IW_MODES = ('ll_uniform', 'll_iw', 'drop_all_uniform', 'drop_sigma2t_iw',
            'drop_sigma2t_uniform', 'rescale_iw')


@dataclasses.dataclass(frozen=True)
class VPSDE:
    """Linear-β VPSDE: β(t) = β0 + (β1 − β0)t with β0 = 0.1, β1 = 20
    (DDPM's schedule rescaled to unit time)."""
    beta_start: float = 0.1
    beta_end: float = 20.0
    sigma2_0: float = 0.0
    time_eps: float = 0.01

    def g2(self, t):
        return self.beta_start + (self.beta_end - self.beta_start) * t

    def f(self, t):
        return -0.5 * self.g2(t)

    def var(self, t):
        return 1.0 - (1.0 - self.sigma2_0) * torch.exp(
            -self.beta_start * t
            - 0.5 * (self.beta_end - self.beta_start) * t * t)

    def e2int_f(self, t):
        return torch.exp(-0.5 * self.beta_start * t
                         - 0.25 * (self.beta_end - self.beta_start) * t * t)

    def inv_var(self, var):
        c = torch.log((1 - var) / (1 - self.sigma2_0))
        a = self.beta_end - self.beta_start
        return (-self.beta_start
                + torch.sqrt(self.beta_start**2 - 2 * a * c)) / a

    # -- q process ---------------------------------------------------------

    def sample_q(self, x_init, noise, var_t, m_t):
        return m_t * x_init + torch.sqrt(var_t) * noise

    def log_snr(self, m_t, var_t):
        return torch.log(torch.square(m_t) / var_t)

    def mixing_component(self, x_noisy, var_t):
        """The optimal ε-denoiser for N(0, I) data: sqrt(σ²)·x_t."""
        return torch.sqrt(var_t) * x_noisy

    # -- prediction conversions -------------------------------------------

    def predict_x0_from_eps(self, z, eps, logsnr):
        return torch.sqrt(1 + torch.exp(-logsnr)) * (
            z - eps * torch.rsqrt(1 + torch.exp(logsnr)))

    def predict_eps_from_x0(self, z, x0, logsnr):
        return torch.sqrt(1 + torch.exp(logsnr)) * (
            z - x0 * torch.rsqrt(1 + torch.exp(-logsnr)))

    def predict_eps_from_z_and_v(self, v_t, var_t, z, m_t):
        return torch.sqrt(var_t) * z + m_t * v_t

    def predict_x0_from_z_and_v(self, v_t, var_t, z, m_t):
        return torch.sqrt(var_t) * v_t + m_t * z

    # -- importance-weighted t sampling ------------------------------------

    def iw_quantities(self, size: int, mode: str = 'll_iw',
                      rho: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> IWQuantities:
        """t and its weights for ``size`` samples from the uniform ``rho``
        (given, or drawn from ``generator`` on ``device``)."""
        if rho is None:
            rho = torch.rand((size,), generator=generator, device=device)
        eps = self.time_eps

        def expand(a):
            return a.reshape(-1, 1, 1, 1)

        if mode in ('ll_uniform', 'drop_all_uniform', 'drop_sigma2t_uniform',
                    'rescale_iw'):
            t = rho * (1 - eps) + eps
            var_t, m_t, g2_t = self.var(t), self.e2int_f(t), self.g2(t)
            if mode == 'll_uniform':
                w = g2_t / (2.0 * var_t)
                w_ll = w
            elif mode == 'drop_all_uniform':
                w = torch.ones_like(t)
                w_ll = g2_t / (2.0 * var_t)
            elif mode == 'drop_sigma2t_uniform':
                w = g2_t / 2.0
                w_ll = g2_t / (2.0 * var_t)
            else:
                w = 0.5 / (1.0 - var_t)
                w_ll = g2_t / (2.0 * var_t)
        elif mode in ('ll_iw', 'drop_sigma2t_iw'):
            ones = torch.ones_like(rho)
            s2_1, s2_eps = self.var(ones), self.var(eps * ones)
            if mode == 'll_iw':
                log1, logeps = torch.log(s2_1), torch.log(s2_eps)
                var_t = torch.exp(rho * log1 + (1 - rho) * logeps)
            else:
                var_t = rho * s2_1 + (1 - rho) * s2_eps
            t = self.inv_var(var_t)
            m_t, g2_t = self.e2int_f(t), self.g2(t)
            if mode == 'll_iw':
                w = 0.5 * (log1 - logeps) / (1.0 - var_t)
                w_ll = w
            else:
                w = 0.5 * (s2_1 - s2_eps) / (1.0 - var_t)
                w_ll = w / var_t
        else:
            raise ValueError(mode)
        return IWQuantities(t, expand(var_t), expand(m_t), expand(w),
                            expand(w_ll), expand(g2_t))

    # -- probability-flow ODE sampling -------------------------------------

    @torch.no_grad()
    def sample_ode(self, eps_fn: Callable, shape, num_steps: int = 250,
                   temperature: float = 1.0,
                   x_init: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> torch.Tensor:
        """Euler steps of dx/dt = f(t)x − ½g²(t)·score from t = 1 to
        ``time_eps`` with the ε-parameterised score −ε/sqrt(σ²).

        eps_fn: (x, t (B,)) → the ε prediction, mixing already applied.
        ``x_init``: the standard-normal start (JAX draws it from the
        second half of ``split(key)``), else drawn from ``generator``; it
        is scaled by ``temperature``."""
        if x_init is None:
            x_init = torch.randn(tuple(shape), generator=generator,
                                 device=device)
        x = x_init * temperature
        t0, t1 = 1.0, self.time_eps
        dt = (t1 - t0) / num_steps
        ts = t0 + dt * torch.arange(num_steps, dtype=torch.float32,
                                    device=x.device)
        for i in range(num_steps):
            t_scalar = ts[i]
            t = t_scalar.expand(shape[0])
            var_t = self.var(t).reshape(-1, 1, 1, 1)
            eps_pred = eps_fn(x, t)
            score = -eps_pred / torch.sqrt(var_t)
            dx = self.f(t_scalar) * x - 0.5 * self.g2(t_scalar) * score
            x = x + dx * dt
        return x


def get_mixed_prediction(mixed: bool, param, mixing_logit, mixing_component):
    """Blend the network's output with the analytic N(0, I) denoiser
    through a learnable logit (reference
    ``continuous_diffusion_utils.py:748``)."""
    if not mixed or mixing_logit is None:
        return param
    coef = torch.sigmoid(mixing_logit)
    return (1 - coef) * mixing_component + coef * param


def vpsde_training_losses(sde: VPSDE, eps_fn: Callable, x0: torch.Tensor,
                          mode: str = 'll_iw',
                          mixing_logit: Optional[torch.Tensor] = None,
                          rho: Optional[torch.Tensor] = None,
                          noise: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> dict:
    """LSGM ε matching with the IW weights (reference ``ddpm_step``).
    eps_fn: (x_t, t) → the raw model output (before the mixing)."""
    iw = sde.iw_quantities(x0.shape[0], mode, rho=rho, generator=generator,
                           device=x0.device)
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                            dtype=x0.dtype)
    x_t = sde.sample_q(x0, noise, iw.var_t, iw.m_t)
    pred = eps_fn(x_t, iw.t)
    mixing = sde.mixing_component(x_t, iw.var_t)
    pred = get_mixed_prediction(mixing_logit is not None, pred, mixing_logit,
                                mixing)
    l2 = torch.square(pred - noise)
    dims = tuple(range(1, x0.ndim))
    loss = torch.sum(iw.obj_weight_t * l2, dim=dims)
    return {'loss': loss, 'p_eps_objs': l2, 'iw': iw, 'x_t': x_t,
            'pred_eps': pred, 'noise': noise}


def kl_per_group(kl_all: torch.Tensor):
    """(per-group mean over the batch, per-group mean magnitude) of
    ``kl_all`` (B, groups)."""
    return torch.mean(kl_all, dim=0), torch.mean(torch.abs(kl_all), dim=0)


def kl_balancer(kl_all: torch.Tensor, kl_coeff: float = 1.0,
                balance: bool = False) -> torch.Tensor:
    """NVAE-style KL balancing: with ``balance`` each group's KL is
    reweighted by its (detached) magnitude, else a plain coefficient
    (``kl_coeff·mean(Σ_groups kl)``).  kl_all: (B, groups)."""
    if not balance:
        return kl_coeff * torch.mean(torch.sum(kl_all, dim=1))
    _, alpha = kl_per_group(kl_all)
    alpha = (alpha * (alpha.shape[0] / (torch.sum(alpha) + 1e-10))).detach()
    return kl_coeff * torch.mean(torch.sum(kl_all * alpha, dim=1))


def cross_entropy_const(sde: VPSDE, device=None) -> torch.Tensor:
    """The CE constant per dimension at the ODE cutoff, in f32."""
    var_eps = sde.var(torch.tensor(sde.time_eps, dtype=torch.float32,
                                   device=device))
    return 0.5 * (1.0 + torch.log(2.0 * math.pi * var_eps))


def vpsde_cross_entropy_per_dim(sde: VPSDE, eps_fn: Callable, x0,
                                mode: str = 'll_iw',
                                mixing_logit: Optional[torch.Tensor] = None,
                                rho: Optional[torch.Tensor] = None,
                                noise: Optional[torch.Tensor] = None,
                                generator: Optional[torch.Generator] = None
                                ) -> torch.Tensor:
    """The q objective's per-element −log p(z) through the prior
    (reference ``ce_ddpm_step``): ``obj_weight_t_ll·‖ε̂ − ε‖²`` plus the
    CE constant; ``mode`` must be a likelihood weighting."""
    if mode not in ('ll_uniform', 'll_iw'):
        raise ValueError(f'the CE needs a likelihood weighting, got {mode!r}')
    out = vpsde_training_losses(sde, eps_fn, x0, mode=mode,
                                mixing_logit=mixing_logit, rho=rho,
                                noise=noise, generator=generator)
    return (out['iw'].obj_weight_t_ll * out['p_eps_objs']
            + cross_entropy_const(sde, x0.device))


def kl_per_group_vada(log_q: torch.Tensor, neg_log_p: torch.Tensor):
    """(per-sample KL (B,), per-dim KL): the mean (not the sum, as the
    reference) of ``neg_log_p + log_q`` over the non-batch dims, and over
    the batch and the trailing dims for ``kl_diag``."""
    dims = tuple(range(1, log_q.ndim))
    s = neg_log_p + log_q
    kl_per_sample = torch.mean(s, dim=dims)
    kl_diag = (torch.mean(s, dim=(0,) + dims[1:]) if log_q.ndim > 2
               else torch.mean(s, dim=0))
    return kl_per_sample, kl_diag
