"""Diagonal Gaussian posterior of the VAE's KL bottleneck.

Port of ``ln3diff_tpu/models/distributions.py`` (reference
``utils/torch_utils/distributions/distributions.py:44-138``,
``DiagonalGaussianDistribution`` with the LSGM soft clamp).  Works on
channels-last moments; mean and logvar are the caller's split.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def soft_clamp20(x: torch.Tensor) -> torch.Tensor:
    """Differentiable clamp to [-20, 20] (LSGM)."""
    return torch.tanh(x / 20.0) * 20.0


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    @property
    def std(self):
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self):
        return torch.exp(self.logvar)

    def sample(self, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mean + std·ε, with ε given (a test feeds JAX's draw) or drawn
        from ``generator``."""
        if eps is None:
            eps = torch.randn(self.mean.shape, generator=generator,
                              device=self.mean.device,
                              dtype=self.mean.dtype)
        return self.mean + self.std * eps

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL to N(0, I), summed over the non-batch dims."""
        dims = tuple(range(1, self.mean.ndim))
        return 0.5 * torch.sum(
            torch.square(self.mean) + self.var - 1.0 - self.logvar, dim=dims)

    def log_p(self, samples: torch.Tensor) -> torch.Tensor:
        """Elementwise log-density surrogate of the reference's ``log_p``:
        it divides by var, not std, and subtracts logvar, not ½·logvar
        (kept as the reference and the JAX package have it)."""
        normalized = (samples - self.mean) / self.var
        return -0.5 * normalized * normalized - 0.5 * _LOG_2PI - self.logvar

    def normal_entropy(self) -> torch.Tensor:
        return self.logvar + 0.5 * (_LOG_2PI + 1.0)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, self.mean.ndim))
        return 0.5 * torch.sum(
            _LOG_2PI + self.logvar
            + torch.square(sample - self.mean) / self.var, dim=dims)


def make_gaussian(moments_mean: torch.Tensor, moments_logvar: torch.Tensor,
                  soft_clamp: bool = True) -> DiagonalGaussian:
    if soft_clamp:
        logvar = soft_clamp20(moments_logvar)
    else:
        logvar = torch.clamp(moments_logvar, -30.0, 20.0)
    return DiagonalGaussian(moments_mean, logvar)
