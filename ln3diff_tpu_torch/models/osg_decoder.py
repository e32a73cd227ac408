"""OSG point decoder: triplane features → (rgb, σ).

Port of ``OSGDecoder`` in ``ln3diff_tpu/models/osg_decoder.py`` (reference
``nsr/triplane.py:338-375``): mean over planes → EqualDense(64) →
softplus → EqualDense(1 + C) → sigmoid clamp (or lrelu·√2) on the colour.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import EqualDense


class OSGDecoder(nn.Module):
    """Input features ``(B, n_planes, M, C)``; returns rgb ``(B, M, C_out)``
    and sigma ``(B, M, 1)``."""

    def __init__(self, in_features: int = 32, decoder_output_dim: int = 32,
                 hidden_dim: int = 64, decoder_lr_mul: float = 1.0,
                 activation: str = 'sigmoid'):
        super().__init__()
        self.decoder_lr_mul = decoder_lr_mul
        self.activation = activation
        # names follow the JAX module's auto-naming: the bridge maps 1:1
        self.EqualDense_0 = EqualDense(in_features, hidden_dim,
                                       lr_multiplier=decoder_lr_mul)
        self.EqualDense_1 = EqualDense(hidden_dim, 1 + decoder_output_dim,
                                       lr_multiplier=decoder_lr_mul)

    def forward(self, sampled_features: torch.Tensor, ray_directions=None):
        x = torch.mean(sampled_features, dim=1)
        x = F.softplus(self.EqualDense_0(x))
        x = self.EqualDense_1(x)
        sigma = x[..., 0:1]
        rgb = x[..., 1:]
        if self.activation == 'sigmoid':
            rgb = torch.sigmoid(rgb) * 1.002 - 0.001
        elif self.activation == 'lrelu':
            rgb = F.leaky_relu(rgb, 0.2) * math.sqrt(2)
        return rgb, sigma
