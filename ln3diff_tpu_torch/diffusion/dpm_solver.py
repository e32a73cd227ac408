"""DPM-Solver++(2M): the deterministic multistep ODE sampler.

Port of ``ln3diff_tpu/diffusion/dpm_solver.py`` (``_to_x0`` :29,
``dpm_solver_timesteps`` :55, ``dpm_solver_sample_loop`` :87).  The
data-prediction (x0) variant with the second-order multistep correction
(Lu et al., 2022), in log-SNR (λ) space, over per-step coefficients
computed once on the host:

  x_{i+1} = (σ_{i+1}/σ_i) · x_i − α_{i+1} · expm1(−h_i) · D_i
  D_i     = (1 + c_i) · x0(x_i, t_i) − c_i · x0_{i−1},
  c_i     = h_i / (2 h_{i−1})   (0 on the first step)

where α, σ come from the diffusion's f32 ᾱ table and h_i = λ_{i+1} − λ_i.
The coefficients are the JAX version's numpy arithmetic on the same f32
table (f32 values, the multistep weight stored in float64), cast to f32;
the JAX scan over steps is a Python loop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .gaussian import _start_noise


def _to_x0(diffusion, model_output, x, t, mixing_logit=None):
    """Model output → x0 per the diffusion's ``mean_type``.  A
    ``learned_range`` output's variance half is dropped; with
    ``mixed_prediction`` and a logit, v outputs turn into eps first, then
    mix with the analytic N(0, I) denoiser, as in ``p_mean_variance``."""
    C = x.shape[-1]
    if model_output.shape[-1] == 2 * C:
        model_output = model_output[..., :C]
    mt = diffusion.spec.mean_type
    if diffusion.spec.mixed_prediction and mixing_logit is not None:
        if mt == 'v':
            model_output = diffusion.predict_eps_from_v(x, t, model_output)
            mt = 'eps'
        space = 'x0' if mt == 'x0' else 'eps'
        model_output = diffusion._apply_mixing(model_output, x, t,
                                               mixing_logit, space=space)
    if mt == 'eps':
        return diffusion.predict_xstart_from_eps(x, t, model_output)
    if mt == 'v':
        return diffusion.predict_xstart_from_v(x, t, model_output)
    if mt == 'x0':
        return model_output
    raise ValueError(mt)


def dpm_solver_timesteps(num_train_steps: int, num_steps: int,
                         alphas_cumprod: Optional[np.ndarray] = None,
                         skip_type: str = 'time_uniform') -> np.ndarray:
    """Integer timestep grid T−1 → 0 (``num_steps`` + 1 points), uniform in
    t (``'time_uniform'``) or in λ = log(α/σ) (``'logsnr'``, needs
    ``alphas_cumprod``), snapped to integers and forced strictly
    decreasing."""
    if skip_type == 'logsnr':
        if alphas_cumprod is None:
            raise ValueError("skip_type='logsnr' needs alphas_cumprod")
        acp = np.asarray(alphas_cumprod, np.float64)
        lam = 0.5 * (np.log(acp) - np.log1p(-acp))
        targets = np.linspace(lam[num_train_steps - 1], lam[0],
                              num_steps + 1)
        # λ decreases with t: invert by interpolation
        ts = np.interp(targets, lam[::-1],
                       np.arange(num_train_steps)[::-1].astype(np.float64))
        ts = np.round(ts).astype(np.int64)
        # strictly decreasing (snap collisions near t = 0)
        for i in range(len(ts) - 2, -1, -1):
            ts[i] = max(ts[i], ts[i + 1] + 1)
        ts[0] = num_train_steps - 1
        return ts.astype(np.int32)
    if skip_type != 'time_uniform':
        raise ValueError(f'skip_type {skip_type!r}')
    return np.linspace(num_train_steps - 1, 0, num_steps + 1).round() \
        .astype(np.int32)


@torch.no_grad()
def dpm_solver_sample_loop(diffusion, model_fn, shape, num_steps: int = 25,
                           model_kwargs=None, device=None,
                           generator: Optional[torch.Generator] = None,
                           x_init: Optional[torch.Tensor] = None,
                           mixing_logit: Optional[torch.Tensor] = None,
                           skip_type: str = 'logsnr'):
    """DPM-Solver++(2M) over the full (unspaced) schedule of
    ``diffusion``: ``num_steps`` solver steps, then the x0 prediction at
    t = 0 (``num_steps`` + 1 model calls).  The start noise is ``x_init``
    when given (the tests feed JAX's draw), else a draw from
    ``generator``.  ``model_fn(x, t, **model_kwargs)`` may be a CFG
    wrapper."""
    model_kwargs = model_kwargs or {}
    acp_table = diffusion.table('alphas_cumprod', 'cpu').numpy()
    ts = dpm_solver_timesteps(diffusion.num_timesteps, num_steps, acp_table,
                              skip_type=skip_type)
    acp = acp_table[ts]
    alpha = np.sqrt(acp)
    sigma = np.sqrt(1.0 - acp)
    lam = np.log(alpha / sigma)
    h = lam[1:] - lam[:-1]
    c = np.zeros(num_steps)
    c[1:] = h[1:] / (2.0 * h[:-1])

    x = _start_noise(shape, device, generator, x_init)

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=x.device)

    sig_ratio, alpha_next = f32(sigma[1:] / sigma[:-1]), f32(alpha[1:])
    em1, cc = f32(np.expm1(-h)), f32(c)
    x0_prev = torch.zeros_like(x)
    for i in range(num_steps):
        t = torch.full((shape[0],), int(ts[i]), dtype=torch.int64,
                       device=x.device)
        out = model_fn(x, diffusion.scale_t(t), **model_kwargs)
        x0 = _to_x0(diffusion, out, x, t, mixing_logit)
        D = (1.0 + cc[i]) * x0 - cc[i] * x0_prev
        x = sig_ratio[i] * x - alpha_next[i] * em1[i] * D
        x0_prev = x0

    # land on the data manifold: the x0 prediction at t = 0
    t0 = torch.zeros((shape[0],), dtype=torch.int64, device=x.device)
    out = model_fn(x, diffusion.scale_t(t0), **model_kwargs)
    return _to_x0(diffusion, out, x, t0, mixing_logit)
