"""Timestep samplers for discrete diffusion training.

Port of ``ln3diff_tpu/diffusion/resample.py``: ``uniform_timesteps`` :20
and the loss-second-moment importance resampler
``LossSecondMomentResampler`` :27-69 (reference
``guided_diffusion/resample.py``).  The resampler is host-side numpy, the
same arithmetic as the JAX package's, so one ``np.random.Generator`` and
one loss history give the same t and weights bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def uniform_timesteps(batch: int, num_timesteps: int, device=None,
                      generator: Optional[torch.Generator] = None):
    """UniformSampler: t ~ U{0..T-1} (int64), weights = 1."""
    t = torch.randint(0, num_timesteps, (batch,), generator=generator,
                      device=device)
    return t, torch.ones((batch,), device=device)


@dataclasses.dataclass
class LossSecondMomentResampler:
    """Importance-sample t ∝ sqrt(E[loss²]) with uniform mixing (reference
    ``LossSecondMomentResampler:124``).  The history lives in host numpy."""
    num_timesteps: int
    history_per_term: int = 10
    uniform_prob: float = 0.001

    def __post_init__(self):
        self._loss_history = np.zeros(
            (self.num_timesteps, self.history_per_term), np.float64)
        self._loss_counts = np.zeros(self.num_timesteps, np.int64)

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones(self.num_timesteps, np.float64)
        w = np.sqrt(np.mean(self._loss_history**2, axis=-1))
        w /= w.sum()
        w *= 1 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def sample(self, rng: np.random.Generator, batch: int):
        """(t (batch,) int32, importance weights (batch,) f32), numpy."""
        p = self.weights()
        p = p / p.sum()
        t = rng.choice(self.num_timesteps, size=batch, p=p)
        weights = 1.0 / (self.num_timesteps * p[t])
        return t.astype(np.int32), weights.astype(np.float32)

    def update_with_losses(self, ts: np.ndarray, losses: np.ndarray):
        """Feed back the per-sample losses of the t drawn by ``sample``."""
        for t, loss in zip(np.asarray(ts), np.asarray(losses)):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1
