"""Stable-Diffusion-style conv decoder, used by the triplane VAE as its
plane upsampler.

Port of the decoder side of ``ln3diff_tpu/models/sd_vae.py``
(``GroupNorm32`` :34, ``ResnetBlock`` :46, ``AttnBlock`` :67,
``Upsample`` :166, ``Decoder`` :236; reference
``ldm/modules/diffusionmodules/model.py``).  :class:`Decoder` takes and
returns channels-last tensors, as the JAX module does; inside, the blocks
run NCHW.  GroupNorm(≤32 groups, eps 1e-6), swish.  The encoder side is
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import dot_product_attention


def swish(x):
    return x * torch.sigmoid(x)


def _groups(channels: int) -> int:
    g = min(32, channels)
    while channels % g:
        g -= 1
    return g


class GroupNorm32(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(_groups(channels), channels,
                                        eps=1e-6)

    def forward(self, x):
        return self.GroupNorm_0(x)


def _conv3(cin, cout):
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = _conv3(in_channels, out_channels)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = _conv3(out_channels, out_channels)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if hasattr(self, 'nin_shortcut'):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention with 1x1 convs."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)

        def tokens(t):   # (B, C, H, W) → (B, HW, 1, C)
            return t.flatten(2).transpose(1, 2)[:, :, None, :]

        out = dot_product_attention(tokens(self.q(h)), tokens(self.k(h)),
                                    tokens(self.v(h)))
        out = out[:, :, 0, :].transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(out)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv3(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode='nearest'))


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    ch: int = 64
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 1
    z_channels: int = 12
    out_ch: int = 3


class Decoder(nn.Module):
    """SD conv decoder; upsamples by 2^(len(ch_mult)-1).  Input
    ``(B, h, w, z_channels)``, output ``(B, H, W, out_ch)``."""

    def __init__(self, cfg: AutoencoderConfig):
        super().__init__()
        self.cfg = cfg
        n = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = _conv3(cfg.z_channels, block_in)
        self.mid_block_1 = ResnetBlock(block_in, block_in)
        self.mid_attn_1 = AttnBlock(block_in)
        self.mid_block_2 = ResnetBlock(block_in, block_in)
        self._up_names = []
        for i_level in reversed(range(n)):
            block_out = cfg.ch * cfg.ch_mult[i_level]
            for i_block in range(cfg.num_res_blocks + 1):
                name = f'up_{i_level}_block_{i_block}'
                self.add_module(name, ResnetBlock(block_in, block_out))
                self._up_names.append(name)
                block_in = block_out
            if i_level != 0:
                name = f'up_{i_level}_upsample'
                self.add_module(name, Upsample(block_in))
                self._up_names.append(name)
        self.norm_out = GroupNorm32(block_in)
        self.conv_out = _conv3(block_in, cfg.out_ch)

    def forward(self, z):
        h = z.permute(0, 3, 1, 2).to(self.conv_in.weight.dtype)
        h = self.conv_in(h)
        h = self.mid_block_1(h)
        h = self.mid_attn_1(h)
        h = self.mid_block_2(h)
        for name in self._up_names:
            h = getattr(self, name)(h)
        h = self.conv_out(swish(self.norm_out(h)))
        return h.permute(0, 2, 3, 1)
