"""Layers shared across the port's models.

Port of ``ln3diff_tpu/models/layers.py`` (``EqualDense``,
``timestep_embedding``), plus the attention core that the JAX package
takes from ``jax.nn.dot_product_attention``, the Linen ``LayerNorm`` and
``RMSNorm``, a seeded random init for runs without released weights and
the zeros of JAX's initializers for the trainers.
"""

from __future__ import annotations

import contextlib
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
                 lr_multiplier: float = 1.0, bias_init: float = 0.0):
        super().__init__()
        self.lr_multiplier = lr_multiplier
        self.bias_init = bias_init
        self.weight = nn.Parameter(
            torch.randn(features, in_features) / lr_multiplier)
        self.bias = nn.Parameter(torch.full((features,), bias_init))

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


class LayerNorm(nn.LayerNorm):
    """Linen's ``LayerNorm``: the statistics and the affine map in f32
    whatever the input's dtype, the output in the weight's dtype (the
    layer's compute dtype), so that an f32 residual stream may feed a
    bf16 layer as it does in JAX."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(self.weight.dtype)


class RMSNorm(nn.Module):
    """Linen's ``RMSNorm`` over the last axis: x·(rsqrt(mean(x²) + eps)·w)
    with the statistics and the product in f32, cast back to x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        mul = torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (xf * (mul * self.weight.float())).to(x.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          is_causal: bool = False) -> torch.Tensor:
    """softmax(q kᵀ/√d) v on ``(B, L, H, d)`` operands, with the numerics
    of ``jax.nn.dot_product_attention``'s XLA path: logits and softmax in
    f32, probabilities cast to the value dtype before the product.  Under
    autocast (training in bf16) the logits stay f32 all the same."""
    d = q.shape[-1]
    dev = q.device.type
    with (torch.autocast(dev, enabled=False)
          if torch.is_autocast_enabled(dev) else contextlib.nullcontext()):
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
    weights ~ N(0, 1/lr_multiplier²) as JAX draws them (they are scaled at
    run time) and biases ``bias_init``, normalisation scales 1, biases 0,
    embeddings and other tables ~ N(0, 0.02²).  A module with a
    ``reset_free_parameters(generator)`` method then sets its free
    parameters to their JAX initial values (layerscale gains, the U-Net's
    mixing logit, sin-cos tables, StyleGAN weights).  An ``Int8Linear`` or
    ``Int8Conv`` quantizes the draw a Linear or Conv2d of its shape would
    get, so a quantized model holds the int8 form of its float twin's
    weights."""
    from ..ops.int8 import Int8Module

    def draw(shape, std, device):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * std

    def normal(p, std):
        p.copy_(draw(p.shape, std, p.device))

    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, Int8Module):
                w = mod.kernel_q
                mod.load_weight(draw(w.shape, 1.0 / math.sqrt(w[0].numel()),
                                     w.device))
                if mod.bias is not None:
                    mod.bias.zero_()
                continue
            for name, p in mod.named_parameters(recurse=False):
                if isinstance(mod, (nn.GroupNorm, nn.LayerNorm, RMSNorm)):
                    p.fill_(1.0 if name == 'weight' else 0.0)
                elif isinstance(mod, EqualDense) and name == 'bias':
                    p.fill_(mod.bias_init)
                elif name == 'bias':
                    p.zero_()
                elif isinstance(mod, EqualDense):
                    normal(p, 1.0 / mod.lr_multiplier)
                elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                    normal(p, 1.0 / math.sqrt(p[0].numel()))
                else:
                    normal(p, 0.02)
        for mod in module.modules():
            if hasattr(mod, 'reset_free_parameters'):
                mod.reset_free_parameters(generator)
    return module


def zero_init_like_jax(model: nn.Module) -> nn.Module:
    """Zero what the JAX modules zero-initialise (weight and bias): every
    adaLN modulation (adaLN-zero: each DiT block starts as the identity),
    the DiT's final ``linear`` and ``cap_proj``, the multi-view
    attention's ``proj_out``, the U-Net blocks' last layers
    (``ResBlock.out_conv``, ``SpatialTransformer.proj_out``,
    ``SelfAttention2D.proj``, ``UNetModel.conv_out``) and the ControlNet's
    ``zero_*`` convs and ``hint_encoder.conv_out``."""
    from .controlnet import ControlNet, HintEncoder
    from .dit import FinalLayer
    from .sd_vae import MVAttn
    from .unet import ResBlock, SelfAttention2D, SpatialTransformer, UNetModel
    last = {FinalLayer: 'linear', MVAttn: 'proj_out', ResBlock: 'out_conv',
            SpatialTransformer: 'proj_out', SelfAttention2D: 'proj',
            UNetModel: 'conv_out', HintEncoder: 'conv_out'}
    zeroed = []
    for mod in model.modules():
        names = [n for n in ('adaLN_modulation', 'cap_proj')
                 if hasattr(mod, n)]
        names += [n for cls, n in last.items() if isinstance(mod, cls)]
        if isinstance(mod, ControlNet):
            names += [n for n, _ in mod.named_children()
                      if n.startswith('zero_')]
        zeroed += [getattr(mod, n) for n in names]
    with torch.no_grad():
        for mod in zeroed:
            for p in mod.parameters(recurse=False):
                p.zero_()
    return model
