"""Point decoders: triplane features → (rgb, σ).

Port of ``ln3diff_tpu/models/osg_decoder.py``:

* ``OSGDecoder`` (:28; reference ``nsr/triplane.py:338-375``): mean over
  planes → EqualDense(64) → softplus → EqualDense(1 + C) → sigmoid clamp
  (or lrelu·√2) on the colour;
* ``LRMOSGDecoder`` (:52; reference ``nsr/triplane.py:378-420``): the
  planes' features concatenated → a ReLU MLP of ``num_layers`` Linears →
  σ and a sigmoid-clamped colour.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import EqualDense


def _sigmoid_clamp(rgb: torch.Tensor) -> torch.Tensor:
    """MipNeRF's sigmoid clamp: sigmoid(x)·(1 + 2·0.001) − 0.001."""
    return torch.sigmoid(rgb) * 1.002 - 0.001


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
            rgb = _sigmoid_clamp(rgb)
        elif self.activation == 'lrelu':
            rgb = F.leaky_relu(rgb, 0.2) * math.sqrt(2)
        return rgb, sigma


class LRMOSGDecoder(nn.Module):
    """LRM-style decoder: input features ``(B, n_planes, M, C)``, each
    point's planes concatenated to ``n_planes·C`` features, then
    ``num_layers`` Linears (``Dense_0`` … ``Dense_{num_layers-1}``, JAX's
    auto-names, so the bridge maps them one to one) with a ReLU after all
    but the last.  Returns rgb ``(B, M, decoder_output_dim)`` and sigma
    ``(B, M, 1)``.  It computes in the wider of the features' and its
    weights' dtypes, as JAX's ``Dense`` promotes (bf16 planes, f32
    weights: f32)."""

    def __init__(self, in_features: int = 32, n_planes: int = 3,
                 hidden_dim: int = 64, num_layers: int = 4,
                 decoder_output_dim: int = 3):
        super().__init__()
        self.num_layers = num_layers
        dims = ([n_planes * in_features] + [hidden_dim] * (num_layers - 1)
                + [1 + decoder_output_dim])
        for i in range(num_layers):
            self.add_module(f'Dense_{i}', nn.Linear(dims[i], dims[i + 1]))

    def forward(self, sampled_features: torch.Tensor, ray_directions=None):
        B, n_planes, M, C = sampled_features.shape
        dtype = torch.promote_types(sampled_features.dtype,
                                    self.Dense_0.weight.dtype)
        x = sampled_features.to(dtype).transpose(1, 2).reshape(
            B, M, n_planes * C)
        for i in range(self.num_layers):
            x = getattr(self, f'Dense_{i}')(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return _sigmoid_clamp(x[..., 1:]), x[..., 0:1]
