"""Stable-Diffusion-style conv encoder and decoder: the triplane VAE's
multi-view image encoder and its plane upsampler.

Port of ``ln3diff_tpu/models/sd_vae.py`` (``GroupNorm32`` :34,
``ResnetBlock`` :46, ``AttnBlock`` :67, ``MVAttn`` :93, ``Downsample``
:154, ``Upsample`` :166, ``Encoder`` :192, ``Decoder`` :236, ``MVEncoder``
:266, ``MVEncoderDynamic`` :285; reference
``ldm/modules/diffusionmodules/model.py``).  :class:`Encoder`,
:class:`Decoder` and the multi-view encoders take and return
channels-last tensors, as the JAX modules do; inside, the blocks run NCHW.
GroupNorm(≤32 groups, eps 1e-6), swish.  Module names follow the JAX
modules', so the bridge maps parameters one to one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

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


class MVAttn(nn.Module):
    """Multi-view transformer attention (reference 'mv-vanilla'
    ``SpatialTransformer3D``, ``ldm/modules/attention.py:405-463``):
    GroupNorm and a 1x1 ``proj_in`` to ``heads·dim_head`` channels, then
    per block self-attention jointly over all views' tokens (attn1),
    per-view self-attention (attn2) and a GEGLU feed-forward with exact
    GELU, each behind a LayerNorm (eps 1e-6, the Linen default) and a
    residual; q, k and v have no bias; a zero-initialised 1x1
    ``proj_out`` (the block starts as the identity) and the outer
    residual."""

    def __init__(self, channels: int, num_views: int, num_heads: int = 8,
                 dim_head: int = 64, depth: int = 1):
        super().__init__()
        self.num_views = num_views
        self.num_heads = num_heads
        self.dim_head = dim_head
        self.depth = depth
        inner = num_heads * dim_head
        self.norm = GroupNorm32(channels)
        self.proj_in = nn.Conv2d(channels, inner, 1)
        for d in range(depth):
            blk = f'block_{d}'
            for i in (1, 2, 3):
                self.add_module(f'{blk}_norm{i}',
                                nn.LayerNorm(inner, eps=1e-6))
            for a in ('attn1', 'attn2'):
                for n in ('q', 'k', 'v'):
                    self.add_module(f'{blk}_{a}_{n}',
                                    nn.Linear(inner, inner, bias=False))
                self.add_module(f'{blk}_{a}_out', nn.Linear(inner, inner))
            self.add_module(f'{blk}_ff_proj', nn.Linear(inner, 8 * inner))
            self.add_module(f'{blk}_ff_out', nn.Linear(4 * inner, inner))
        self.proj_out = nn.Conv2d(inner, channels, 1)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def _mha(self, x, name):
        n = x.shape[0]

        def heads(t):
            return t.reshape(n, -1, self.num_heads, self.dim_head)

        out = dot_product_attention(heads(getattr(self, f'{name}_q')(x)),
                                    heads(getattr(self, f'{name}_k')(x)),
                                    heads(getattr(self, f'{name}_v')(x)))
        return getattr(self, f'{name}_out')(out.reshape(n, x.shape[1], -1))

    def forward(self, x):
        B, C, H, W = x.shape
        V = self.num_views
        inner = self.num_heads * self.dim_head
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, inner)
        for d in range(self.depth):
            blk = f'block_{d}'
            # attn1: joint over the views, (b v) l c -> b (v l) c
            hj = h.reshape(B // V, V * H * W, inner)
            hj = hj + self._mha(getattr(self, f'{blk}_norm1')(hj),
                                f'{blk}_attn1')
            h = hj.reshape(B, H * W, inner)
            h = h + self._mha(getattr(self, f'{blk}_norm2')(h),
                              f'{blk}_attn2')
            ff = getattr(self, f'{blk}_ff_proj')(
                getattr(self, f'{blk}_norm3')(h))
            val, gate = ff.chunk(2, dim=-1)
            h = h + getattr(self, f'{blk}_ff_out')(
                val * F.gelu(gate, approximate='none'))
        h = h.reshape(B, H, W, inner).permute(0, 3, 1, 2)
        return x + self.proj_out(h)


class Downsample(nn.Module):
    """Stride-2 3x3 conv after the reference's asymmetric pad: one row at
    the bottom and one column on the right."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


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
    in_channels: int = 10         # encoder input: RGB + depth + Plücker
    attn_resolutions: Sequence[int] = ()
    resolution: int = 256
    double_z: bool = True
    num_views: int = 1            # >1: multi-view attention in the encoder
    attn_heads: int = 8           # mv-vanilla SpatialTransformer3D heads
    attn_dim_head: int = 64       # reference nsr/script_util.py:1311-1314
    # the compute dtype; parameters are built in f32 and the owner stores
    # or autocasts the module to it (``TriplaneVAE.cast_decoder``)
    dtype: Any = torch.float32


class Encoder(nn.Module):
    """SD conv encoder (reference ``Encoder:459``): input ``(B, H, W,
    C_in)``, output moments ``(B, H/2^(n-1), W/2^(n-1), 2z)`` with
    ``double_z``.  With ``num_views > 1`` its attention is :class:`MVAttn`
    over groups of that many consecutive images."""

    def __init__(self, cfg: AutoencoderConfig):
        super().__init__()
        self.cfg = cfg
        n = len(cfg.ch_mult)
        curr_res = cfg.resolution
        block_in = cfg.ch
        self.conv_in = _conv3(cfg.in_channels, cfg.ch)
        self._down_names = []
        for i_level in range(n):
            block_out = cfg.ch * cfg.ch_mult[i_level]
            for i_block in range(cfg.num_res_blocks):
                name = f'down_{i_level}_block_{i_block}'
                self.add_module(name, ResnetBlock(block_in, block_out))
                self._down_names.append(name)
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    name = f'down_{i_level}_attn_{i_block}'
                    self.add_module(name, self._attn(block_in))
                    self._down_names.append(name)
            if i_level != n - 1:
                name = f'down_{i_level}_downsample'
                self.add_module(name, Downsample(block_in))
                self._down_names.append(name)
                curr_res //= 2
        self.mid_block_1 = ResnetBlock(block_in, block_in)
        self.mid_attn_1 = self._attn(block_in)
        self.mid_block_2 = ResnetBlock(block_in, block_in)
        self.norm_out = GroupNorm32(block_in)
        out_c = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = _conv3(block_in, out_c)

    def _attn(self, channels):
        cfg = self.cfg
        if cfg.num_views > 1:
            return MVAttn(channels, cfg.num_views, cfg.attn_heads,
                          cfg.attn_dim_head)
        return AttnBlock(channels)

    def features(self, x):
        """NCHW in, NCHW out."""
        h = self.conv_in(x.to(self.conv_in.weight.dtype))
        for name in self._down_names:
            h = getattr(self, name)(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(swish(self.norm_out(h)))

    def forward(self, x):
        return self.features(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


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


class MVEncoder(nn.Module):
    """Multi-view encoder (reference ``MVEncoder:563-578``): the shared
    :class:`Encoder` with joint-view attention, then the views fused by
    channel concat in (view, channel) order and a 3x3 conv.  Input
    ``(B·V, H, W, C)``, output ``(B, h, w, 2z)``."""

    def __init__(self, cfg: AutoencoderConfig, num_frames: int = 4):
        super().__init__()
        self.num_frames = num_frames
        self.encoder = Encoder(dataclasses.replace(cfg,
                                                   num_views=num_frames))
        C = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.fusion_layer = _conv3(num_frames * C, C)

    def forward(self, x):
        h = self.encoder.features(x.permute(0, 3, 1, 2))
        BV, C, hh, ww = h.shape
        V = self.num_frames
        h = h.reshape(BV // V, V * C, hh, ww)     # channel v·C + c
        return self.fusion_layer(h).permute(0, 2, 3, 1)


class MVEncoderDynamic(nn.Module):
    """Dynamic-view-count encoder (reference
    ``MVEncoderGSDynamicInp:603-624``): the views' features are averaged.
    Input ``(B·V, H, W, C)``, output ``(B, h, w, 2z)``."""

    def __init__(self, cfg: AutoencoderConfig, num_frames: int = 8):
        super().__init__()
        self.num_frames = num_frames
        self.encoder = Encoder(dataclasses.replace(cfg,
                                                   num_views=num_frames))

    def forward(self, x):
        h = self.encoder(x)
        BV, hh, ww, C = h.shape
        V = self.num_frames
        return h.reshape(BV // V, V, hh, ww, C).mean(dim=1)
