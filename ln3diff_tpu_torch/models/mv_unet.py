"""LGM-style multi-view U-Net and encoder (the ``'lgm'`` VAE encoder).

Port of ``ln3diff_tpu/models/mv_unet.py`` (``MVAttention`` :43,
``ResnetBlock`` :75, ``DownBlock`` :114, ``MidBlock`` :146, ``UpBlock``
:173, ``MVUNetConfig`` :204, ``MVUNet`` :220, ``LGMMVEncoder`` :250-284;
reference ``ldm/modules/diffusionmodules/mv_unet.py:16-456``):

* ``MVAttention``: GroupNorm(32) → the views' spatial tokens folded into
  one sequence per instance → multi-head attention → residual, scaled by
  ``skip_scale``;
* ``ResnetBlock`` / ``DownBlock`` / ``MidBlock`` / ``UpBlock`` with the
  LGM ``skip_scale = √0.5``;
* ``MVUNet``: the (possibly asymmetric) U-Net;
* ``LGMMVEncoder``: the down path and the mid block, a per-view
  ``conv_out`` to 2·z moments, the views concatenated along channels and
  a ``fusion_layer`` conv.  The reference's ``LGM_MVEncoder.forward``
  never applies its ``conv_out`` (its ``fusion_layer``, declared for
  2·z·V input channels, cannot take the mid block's features); the port
  follows the JAX package's reading: ``conv_out`` per view, then the
  fusion.

``MVUNet`` and ``LGMMVEncoder`` take and return view-folded channels-last
tensors ``(B·V, H, W, C)``, as the JAX modules do; the blocks work on
NCHW.  ``MVAttention`` computes the attention over chunks of
``query_chunk`` queries with the numerics of ``jax.nn.dot_product_attention``
(f32 logits and softmax, probabilities cast to v's dtype): at 4 views of
64² and 16 heads the whole f32 logits would take 16 GiB per instance.
Module names follow the JAX modules' (``GroupNorm_0`` … for the unnamed
norms), so the bridge maps the parameters leaf by leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import dot_product_attention


def swish(x):
    return x * torch.sigmoid(x)


def _group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-5)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class MVAttention(nn.Module):
    """Self-attention over every view's tokens of an instance.  x: NCHW
    ``(B·V, C, H, W)``; the qkv projection (no bias) and ``proj`` are
    Linear layers over the channels."""

    def __init__(self, dim: int, num_heads: int = 16, num_frames: int = 4,
                 skip_scale: float = 1.0, query_chunk: int = 1024):
        super().__init__()
        self.num_heads, self.num_frames = num_heads, num_frames
        self.skip_scale = skip_scale
        self.query_chunk = query_chunk
        self.GroupNorm_0 = _group_norm(dim)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        BV, C, H, W = x.shape
        B, heads = BV // self.num_frames, self.num_heads
        h = self.GroupNorm_0(x).permute(0, 2, 3, 1)
        qkv = self.qkv(h.reshape(B, self.num_frames * H * W, C))
        q, k, v = qkv.reshape(B, -1, 3, heads, C // heads).unbind(2)
        n = self.query_chunk
        o = torch.cat([dot_product_attention(q[:, i:i + n], k, v)
                       for i in range(0, q.shape[1], n)], dim=1)
        o = self.proj(o.reshape(B, -1, C)).reshape(BV, H, W, C)
        return (o.permute(0, 3, 1, 2) + x) * self.skip_scale


class ResnetBlock(nn.Module):
    """GN → swish → (nearest 2x ``'up'`` or 2x2 mean ``'down'``, the skip
    too) → conv → GN → swish → conv, plus the skip (a 1x1 ``shortcut``
    when the width changes), × ``skip_scale``.  NCHW."""

    def __init__(self, in_channels: int, out_channels: int,
                 resample: str = 'default', skip_scale: float = 1.0):
        super().__init__()
        self.resample, self.skip_scale = resample, skip_scale
        self.GroupNorm_0 = _group_norm(in_channels)
        self.conv1 = _conv3(in_channels, out_channels)
        self.GroupNorm_1 = _group_norm(out_channels)
        self.conv2 = _conv3(out_channels, out_channels)
        if in_channels != out_channels:
            self.shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        res = x
        h = swish(self.GroupNorm_0(x))
        if self.resample == 'up':
            res, h = (F.interpolate(t, scale_factor=2, mode='nearest')
                      for t in (res, h))
        elif self.resample == 'down':
            res, h = (F.avg_pool2d(t, 2) for t in (res, h))
        h = self.conv2(swish(self.GroupNorm_1(self.conv1(h))))
        if hasattr(self, 'shortcut'):
            res = self.shortcut(res)
        return (h + res) * self.skip_scale


def _down_conv(channels: int) -> nn.Conv2d:
    """3x3 stride-2 conv; 'SAME' on an even input pads (0, 1)."""
    return nn.Conv2d(channels, channels, 3, stride=2)


class DownBlock(nn.Module):
    """``num_layers`` × (resnet [+ mv-attention]), then a stride-2 conv;
    returns (x, the per-layer skips, the downsampled x last)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 1, downsample: bool = True,
                 attention: bool = True, attention_heads: int = 16,
                 num_frames: int = 4, skip_scale: float = 1.0):
        super().__init__()
        self.num_layers, self.attention = num_layers, attention
        for i in range(num_layers):
            self.add_module(f'net{i}', ResnetBlock(
                in_channels if i == 0 else out_channels, out_channels,
                skip_scale=skip_scale))
            if attention:
                self.add_module(f'attn{i}', MVAttention(
                    out_channels, attention_heads, num_frames, skip_scale))
        if downsample:
            self.downsample = _down_conv(out_channels)

    def forward(self, x):
        skips = []
        for i in range(self.num_layers):
            x = getattr(self, f'net{i}')(x)
            if self.attention:
                x = getattr(self, f'attn{i}')(x)
            skips.append(x)
        if hasattr(self, 'downsample'):
            x = self.downsample(F.pad(x, (0, 1, 0, 1)))
            skips.append(x)
        return x, skips


class MidBlock(nn.Module):
    """resnet, then ``num_layers`` × (mv-attention? → resnet)."""

    def __init__(self, channels: int, num_layers: int = 1,
                 attention: bool = True, attention_heads: int = 16,
                 num_frames: int = 4, skip_scale: float = 1.0):
        super().__init__()
        self.num_layers, self.attention = num_layers, attention
        self.net0 = ResnetBlock(channels, channels, skip_scale=skip_scale)
        for i in range(num_layers):
            if attention:
                self.add_module(f'attn{i}', MVAttention(
                    channels, attention_heads, num_frames, skip_scale))
            self.add_module(f'net{i + 1}', ResnetBlock(
                channels, channels, skip_scale=skip_scale))

    def forward(self, x):
        x = self.net0(x)
        for i in range(self.num_layers):
            if self.attention:
                x = getattr(self, f'attn{i}')(x)
            x = getattr(self, f'net{i + 1}')(x)
        return x


class UpBlock(nn.Module):
    """``num_layers`` × (concat a skip → resnet [+ mv-attention]), then a
    nearest 2x upsample and a conv.  ``skip_channels``: the widths of the
    skips it takes, last first."""

    def __init__(self, in_channels: int, skip_channels, out_channels: int,
                 upsample: bool = True, attention: bool = True,
                 attention_heads: int = 16, num_frames: int = 4,
                 skip_scale: float = 1.0):
        super().__init__()
        self.num_layers, self.attention = len(skip_channels), attention
        cin = in_channels
        for i, cs in enumerate(skip_channels):
            self.add_module(f'net{i}', ResnetBlock(cin + cs, out_channels,
                                                   skip_scale=skip_scale))
            if attention:
                self.add_module(f'attn{i}', MVAttention(
                    out_channels, attention_heads, num_frames, skip_scale))
            cin = out_channels
        if upsample:
            self.upsample = _conv3(out_channels, out_channels)

    def forward(self, x, skips):
        for i in range(self.num_layers):
            x = getattr(self, f'net{i}')(torch.cat([x, skips[-1 - i]], 1))
            if self.attention:
                x = getattr(self, f'attn{i}')(x)
        if hasattr(self, 'upsample'):
            x = self.upsample(F.interpolate(x, scale_factor=2,
                                            mode='nearest'))
        return x


@dataclasses.dataclass(frozen=True)
class MVUNetConfig:
    in_channels: int = 9               # LGM: RGB + Plücker
    out_channels: int = 3
    down_channels: Tuple[int, ...] = (64, 128, 256, 512, 1024)
    down_attention: Tuple[bool, ...] = (False, False, False, True, True)
    mid_attention: bool = True
    up_channels: Tuple[int, ...] = (1024, 512, 256)
    up_attention: Tuple[bool, ...] = (True, True, False)
    layers_per_block: int = 2
    skip_scale: float = math.sqrt(0.5)
    num_frames: int = 4
    dtype: Any = torch.float32


def _down_path(module: nn.Module, cfg: MVUNetConfig) -> list:
    """``conv_in``, the down blocks and the mid block on ``module``;
    returns the widths of the skips in the order they are made."""
    c0 = cfg.down_channels[0]
    module.conv_in = _conv3(cfg.in_channels, c0)
    skips, cin = [c0], c0
    for i, ch in enumerate(cfg.down_channels):
        last = i == len(cfg.down_channels) - 1
        module.add_module(f'down{i}', DownBlock(
            cin, ch, cfg.layers_per_block, downsample=not last,
            attention=cfg.down_attention[i], num_frames=cfg.num_frames,
            skip_scale=cfg.skip_scale))
        skips += [ch] * (cfg.layers_per_block + (0 if last else 1))
        cin = ch
    module.mid = MidBlock(cin, attention=cfg.mid_attention,
                          num_frames=cfg.num_frames,
                          skip_scale=cfg.skip_scale)
    return skips


class MVUNet(nn.Module):
    """The multi-view U-Net; fewer up stages than down stages are allowed
    (the output is then at a lower resolution than the input).
    ``(B·V, H, W, in_channels)`` → ``(B·V, H', W', out_channels)``."""

    def __init__(self, cfg: MVUNetConfig):
        super().__init__()
        self.cfg = cfg
        skips = _down_path(self, cfg)
        cin = cfg.down_channels[-1]
        n = cfg.layers_per_block + 1
        for i, ch in enumerate(cfg.up_channels):
            last = i == len(cfg.up_channels) - 1
            taken, skips = skips[-n:], skips[:-n]
            self.add_module(f'up{i}', UpBlock(
                cin, taken[::-1], ch, upsample=not last,
                attention=cfg.up_attention[i], num_frames=cfg.num_frames,
                skip_scale=cfg.skip_scale))
            cin = ch
        self.GroupNorm_0 = _group_norm(cin)
        self.conv_out = _conv3(cin, cfg.out_channels)

    def forward(self, x):
        cfg = self.cfg
        x = self.conv_in(x.permute(0, 3, 1, 2))
        skips = [x]
        for i in range(len(cfg.down_channels)):
            x, s = getattr(self, f'down{i}')(x)
            skips.extend(s)
        x = self.mid(x)
        n = cfg.layers_per_block + 1
        for i in range(len(cfg.up_channels)):
            x = getattr(self, f'up{i}')(x, skips[-n:])
            skips = skips[:-n]
        x = self.conv_out(swish(self.GroupNorm_0(x)))
        return x.permute(0, 2, 3, 1)


class LGMMVEncoder(nn.Module):
    """The encoder half of ``MVUNet`` with cross-view conv pooling:
    ``(B·V, H, W, C_in)`` → moments ``(B, H/2^(D-1), W/2^(D-1), 2·z)``
    (``z`` with ``double_z=False``), for ``TriplaneVAE``'s ``'lgm'``
    encoder."""

    def __init__(self, cfg: MVUNetConfig, z_channels: int = 12,
                 double_z: bool = True):
        super().__init__()
        self.cfg = cfg
        zc = 2 * z_channels if double_z else z_channels
        _down_path(self, cfg)
        self.conv_out = _conv3(cfg.down_channels[-1], zc)
        self.fusion_layer = _conv3(cfg.num_frames * zc, zc)

    def forward(self, x):
        x = self.conv_in(x.permute(0, 3, 1, 2))
        for i in range(len(self.cfg.down_channels)):
            x, _ = getattr(self, f'down{i}')(x)
        x = self.conv_out(self.mid(x))
        BV, C, H, W = x.shape
        V = self.cfg.num_frames
        # channels of the fusion input: view-major, then the moment channel
        x = self.fusion_layer(x.reshape(BV // V, V * C, H, W))
        return x.permute(0, 2, 3, 1)
