"""Flow-matching / stochastic-interpolant transport (SiT): the path plans,
the training loss and the ODE and SDE samplers.

Port of ``ln3diff_tpu/diffusion/transport.py``: ``PathPlan`` :27 (linear,
gvp and vp interpolants with their velocities and the velocity→score
map), ``TransportSpec`` :80, ``Transport.sample_t`` :96 and
``Transport.training_losses`` :105 (velocity matching at uniform or
logit-normal t), ``Transport.sample_ode`` :120 (fixed-step
Euler or Heun from noise at t = 0 to data at t = 1, or back with
``reverse``), ``Transport.sample_sde`` :151 (Euler–Maruyama with the
score-augmented drift) and ``create_transport`` :189.  The denoiser gets
t as JAX sends it: a float in [0, 1], not scaled to 1000 steps.

The JAX loop is one ``lax.scan``; here it is a Python loop of eager
steps.  Every draw is a tensor argument (the tests feed JAX's) or comes
from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

ModelFn = Callable[..., torch.Tensor]


def _expand(t, x):
    return t.reshape(t.shape + (1,) * (x.ndim - 1))


@dataclasses.dataclass(frozen=True)
class PathPlan:
    """Interpolant x_t = α(t)·x1 + σ(t)·x0 with velocity u = α'·x1 + σ'·x0."""
    kind: str = 'linear'          # 'linear' | 'gvp' | 'vp'
    sigma_min: float = 0.1        # vp only
    sigma_max: float = 20.0

    def _vp_log_mean_coeff(self, t):
        lmc = (-0.25 * (1 - t)**2 * (self.sigma_max - self.sigma_min)
               - 0.5 * (1 - t) * self.sigma_min)
        dlmc = (0.5 * (1 - t) * (self.sigma_max - self.sigma_min)
                + 0.5 * self.sigma_min)
        return lmc, dlmc

    def alpha(self, t):
        """(α(t), α'(t))."""
        if self.kind == 'linear':
            return t, torch.ones_like(t)
        if self.kind == 'gvp':
            return (torch.sin(t * math.pi / 2),
                    math.pi / 2 * torch.cos(t * math.pi / 2))
        lmc, dlmc = self._vp_log_mean_coeff(t)
        a = torch.exp(lmc)
        return a, a * dlmc

    def sigma(self, t):
        """(σ(t), σ'(t))."""
        if self.kind == 'linear':
            return 1 - t, -torch.ones_like(t)
        if self.kind == 'gvp':
            return (torch.cos(t * math.pi / 2),
                    -math.pi / 2 * torch.sin(t * math.pi / 2))
        lmc, dlmc = self._vp_log_mean_coeff(t)
        p = 2 * lmc
        s = torch.sqrt(1 - torch.exp(p))
        ds = torch.exp(p) * (2 * dlmc) / (-2 * s)
        return s, ds

    def plan(self, t, x0, x1):
        """(x_t, u_t) for noise x0, data x1 and per-sample t."""
        te = _expand(t, x1)
        a, da = self.alpha(te)
        s, ds = self.sigma(te)
        return a * x1 + s * x0, da * x1 + ds * x0

    def score_from_velocity(self, velocity, x, t):
        te = _expand(t, x)
        a, da = self.alpha(te)
        s, ds = self.sigma(te)
        r = a / da
        var = s**2 - r * ds * s
        return (r * velocity - x) / var


@dataclasses.dataclass(frozen=True)
class TransportSpec:
    """The path, what the model predicts (the velocity on every released
    path, and the only prediction the JAX package trains or samples), how
    training draws t (``'lognorm'``: sigmoid of a standard normal, or
    ``'uniform'``) and the offsets of training and sampling from the ends
    of [0, 1]."""
    path: str = 'linear'
    prediction: str = 'velocity'
    t_sampling: str = 'lognorm'       # 'uniform' | 'lognorm'
    train_eps: float = 0.0
    sample_eps: float = 0.0


class Transport:
    """Functional transport object (reference ``Transport``)."""

    def __init__(self, spec: TransportSpec = TransportSpec()):
        if spec.prediction != 'velocity':
            raise NotImplementedError(f'prediction {spec.prediction!r}')
        self.spec = spec
        self.path = PathPlan(kind=spec.path)

    def sample_t(self, batch: int, device=None,
                 generator: Optional[torch.Generator] = None,
                 u: Optional[torch.Tensor] = None):
        """Training times in [train_eps, 1 − train_eps]: ``'lognorm'``
        maps a standard normal draw through the sigmoid, ``'uniform'`` a
        U[0, 1) draw.  ``u`` is that draw when given (the tests feed
        JAX's), else it comes from ``generator``."""
        t0, t1 = self.spec.train_eps, 1.0 - self.spec.train_eps
        lognorm = self.spec.t_sampling == 'lognorm'
        if u is None:
            draw = torch.randn if lognorm else torch.rand
            u = draw((batch,), generator=generator, device=device)
        if lognorm:
            u = torch.sigmoid(u)
        return u * (t1 - t0) + t0

    def training_losses(self, model_fn: ModelFn, x1, model_kwargs=None,
                        generator: Optional[torch.Generator] = None,
                        t: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None) -> dict:
        """Velocity matching (reference ``transport.py:148-190`` with
        ``FMLoss``): x_t on the path from the noise x0 to the data x1, the
        per-sample mean squared error of the model's velocity.  ``t`` (B,)
        and ``noise`` (x1's shape) are used when given, else drawn from
        ``generator`` (t through ``sample_t``)."""
        model_kwargs = model_kwargs or {}
        if t is None:
            t = self.sample_t(x1.shape[0], x1.device, generator)
        if noise is None:
            noise = torch.randn(x1.shape, generator=generator,
                                device=x1.device, dtype=x1.dtype)
        xt, ut = self.path.plan(t, noise, x1)
        pred = model_fn(xt, t, **model_kwargs)
        loss = ((pred - ut)**2).mean(dim=tuple(range(1, x1.ndim)))
        return {'loss': loss, 'pred': pred, 't': t, 'xt': xt}

    @torch.no_grad()
    def sample_ode(self, model_fn: ModelFn, shape, num_steps: int = 250,
                   method: str = 'euler', model_kwargs=None,
                   reverse: bool = False, device=None,
                   generator: Optional[torch.Generator] = None,
                   x_init: Optional[torch.Tensor] = None):
        """Fixed-step probability-flow ODE from noise (t = 0) to data
        (t = 1), or from data to noise with ``reverse``.  The start point
        is ``x_init`` when given (the tests feed JAX's draw), else a
        standard normal draw from ``generator``."""
        if method not in ('euler', 'heun'):
            raise NotImplementedError(method)
        model_kwargs = model_kwargs or {}
        if x_init is None:
            x = torch.randn(shape, generator=generator, device=device)
        else:
            x = x_init.to(device=device, dtype=torch.float32)
        t0, t1 = self.spec.sample_eps, 1.0
        if reverse:
            t0, t1 = 1.0, self.spec.sample_eps
        dt = (t1 - t0) / num_steps
        # f32 times, as JAX's t0 + dt·arange
        ts = t0 + dt * torch.arange(num_steps, dtype=torch.float32,
                                    device=x.device)

        def velocity(x, t_scalar):
            t = t_scalar.expand(shape[0])
            return model_fn(x, t, **model_kwargs)

        for t_scalar in ts:
            v1 = velocity(x, t_scalar)
            if method == 'euler':
                x = x + dt * v1
            else:
                v2 = velocity(x + dt * v1, t_scalar + dt)
                x = x + 0.5 * dt * (v1 + v2)
        return x

    @torch.no_grad()
    def sample_sde(self, model_fn: ModelFn, shape, num_steps: int = 250,
                   diffusion_norm: float = 1.0, model_kwargs=None,
                   last_step_size: float = 0.04, device=None,
                   generator: Optional[torch.Generator] = None,
                   x_init: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None):
        """Euler–Maruyama from noise at t = ``sample_eps`` to t = 1 −
        ``last_step_size``: dx = (v + g²/2 · score)·dt + g·dW with g² =
        ``diffusion_norm`` and the score from the velocity, then one
        deterministic Euler step of ``last_step_size``.  The start is
        ``x_init`` and the step draws ``noise[i]`` of a (num_steps,
        *shape) stack when given (the tests feed JAX's draws), else both
        come from ``generator``."""
        model_kwargs = model_kwargs or {}
        if x_init is None:
            x = torch.randn(shape, generator=generator, device=device)
        else:
            x = x_init.to(device=device, dtype=torch.float32)
        t0 = self.spec.sample_eps
        t1 = 1.0 - last_step_size
        dt = (t1 - t0) / num_steps
        ts = t0 + dt * torch.arange(num_steps, dtype=torch.float32,
                                    device=x.device)
        g2 = diffusion_norm
        # √(g²·dt) in f32, as JAX takes it
        g_sqrt_dt = torch.sqrt(torch.tensor(g2 * dt, dtype=torch.float32,
                                            device=x.device))
        for i, t_scalar in enumerate(ts):
            t = t_scalar.expand(shape[0])
            v = model_fn(x, t, **model_kwargs)
            s = self.path.score_from_velocity(v, x, t)
            z = (noise[i].to(device=x.device, dtype=x.dtype)
                 if noise is not None else
                 torch.randn(shape, generator=generator, device=x.device))
            x = x + (v + 0.5 * g2 * s) * dt + g_sqrt_dt * z
        t = torch.full((shape[0],), t1, dtype=torch.float32, device=x.device)
        return x + last_step_size * model_fn(x, t, **model_kwargs)


def create_transport(path_type: str = 'Linear',
                     prediction: str = 'velocity',
                     snr_type: str = 'lognorm') -> Transport:
    """Factory mirroring reference ``transport/__init__.py:3-71``."""
    return Transport(TransportSpec(path=path_type.lower(),
                                   prediction=prediction,
                                   t_sampling=snr_type))
