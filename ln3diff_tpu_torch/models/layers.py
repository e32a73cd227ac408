"""Layers shared across the port's models.

Port of ``ln3diff_tpu/models/layers.py`` (``EqualDense``,
``timestep_embedding``), plus the attention core that the JAX package
takes from ``jax.nn.dot_product_attention`` and a seeded random init for
runs without released weights.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class EqualDense(nn.Module):
    """Dense layer with runtime weight scaling (StyleGAN equalized lr):
    the weight is multiplied by ``lr_multiplier / sqrt(fan_in)`` and the
    bias by ``lr_multiplier`` at call time, as the JAX layer does."""

    def __init__(self, in_features: int, features: int,
                 lr_multiplier: float = 1.0):
        super().__init__()
        self.lr_multiplier = lr_multiplier
        self.weight = nn.Parameter(
            torch.randn(features, in_features) / lr_multiplier)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        scale = self.lr_multiplier / math.sqrt(self.weight.shape[1])
        return F.linear(x, (self.weight * scale).to(x.dtype),
                        (self.bias * self.lr_multiplier).to(x.dtype))


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings ``(N,) → (N, dim)``, [cos | sin], in f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          is_causal: bool = False) -> torch.Tensor:
    """softmax(q kᵀ/√d) v on ``(B, L, H, d)`` operands, with the numerics
    of ``jax.nn.dot_product_attention``'s XLA path: logits and softmax in
    f32, probabilities cast to the value dtype before the product."""
    d = q.shape[-1]
    logits = torch.einsum('bthd,bshd->bhts', q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(d))
    if is_causal:
        T, S = logits.shape[-2:]
        mask = torch.ones(T, S, dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum('bhts,bshd->bthd', probs, v)


def random_init_(module: nn.Module,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Fill every parameter from ``generator`` (for runs with no released
    weights): Linear and Conv weights ~ N(0, 1/fan_in), :class:`EqualDense`
    weights ~ N(0, 1) (they are scaled at run time), normalisation scales
    1, biases 0, embeddings and other tables ~ N(0, 0.02²)."""

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32) * std)

    with torch.no_grad():
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
                    p.fill_(1.0 if name == 'weight' else 0.0)
                elif name == 'bias':
                    p.zero_()
                elif isinstance(mod, EqualDense):
                    normal(p, 1.0)
                elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                    normal(p, 1.0 / math.sqrt(p[0].numel()))
                else:
                    normal(p, 0.02)
    return module
