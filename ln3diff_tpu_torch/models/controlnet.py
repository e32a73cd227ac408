"""ControlNet: a zero-conv controlled copy of the U-Net's encoder.

Port of ``ln3diff_tpu/models/controlnet.py`` (``_zero_conv`` :23,
``HintEncoder`` :29, ``ControlNet`` :48; reference ``cldm/cldm.py``): a
trainable copy of the U-Net's down and middle path takes the hint image
through a conv hint encoder; its per-level outputs pass through 1x1 convs
that start at zero and are added to the frozen U-Net's skips
(``UNetModel.forward(control=...)``).  Built on the port's U-Net blocks
(``models/unet.py``) with the JAX module's names, so
``bridge.unet_state_dict`` maps its parameters one to one.  Its input and
hint are channels-last (B, H, W, C); the residuals it returns are NCHW
tensors in channels-last memory, the layout of the U-Net's activations.
Built in f32; ``cfg.dtype`` is the dtype the caller casts it to.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import timestep_embedding
from .unet import (Downsample, ResBlock, SpatialTransformer, UNetConfig,
                   _conv3)


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Zero-pad NCHW ``x`` as Linen's ``padding='SAME'`` does before a
    ``kernel``² conv of ``stride``: ceil(size/stride) outputs, the odd
    pixel of padding at the bottom and right."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _zero_conv(channels: int) -> nn.Conv2d:
    """1x1 conv, zero at JAX's init (``layers.zero_init_like_jax``)."""
    return nn.Conv2d(channels, channels, 1)


class HintEncoder(nn.Module):
    """Eight convs from the hint image down to the latent resolution (÷8;
    reference ``input_hint_block``): 3x3 convs to 16, 16, 32, 32, 96, 96,
    256 channels, the third, fifth and seventh of stride 2, each with a
    SiLU, then ``conv_out`` to ``model_channels``."""

    CHANNELS = (16, 16, 32, 32, 96, 96, 256)

    def __init__(self, in_channels: int, model_channels: int):
        super().__init__()
        cin = in_channels
        for i, ch in enumerate(self.CHANNELS):
            stride = 2 if i in (2, 4, 6) else 1
            self.add_module(f'conv_{i}', nn.Conv2d(cin, ch, 3, stride=stride))
            cin = ch
        self.conv_out = nn.Conv2d(cin, model_channels, 1)

    def forward(self, hint):
        x = hint
        for i in range(len(self.CHANNELS)):
            conv = getattr(self, f'conv_{i}')
            x = F.silu(conv(same_pad(x, 3, conv.stride[0])))
        return self.conv_out(x)


class ControlNet(nn.Module):
    """The control branch: ``forward(x, hint, timesteps, context=None)``
    → the residuals [conv_in, every down block's output, middle], one per
    skip of ``UNetModel(cfg)`` plus the middle block.  ``x`` is the
    latent as the U-Net takes it; ``hint`` (B, Hh, Wh, ``hint_channels``)
    is tiled three times along the width under ``roll_out`` unless it
    already spans the rolled-out planes, and its encoding is resized
    (bilinear) to the latent's grid where the sizes differ.  Every
    attention is a ``SpatialTransformer`` with ``cfg.num_heads`` heads, as
    in JAX.  The branch is float whatever ``cfg.quantized`` says: JAX's
    never reads it, so the config of an int8 U-Net gives the float branch
    whose residuals that U-Net adds to its skips."""

    def __init__(self, cfg: UNetConfig, hint_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        emb = 4 * mc
        self.time_fc1 = nn.Linear(mc, emb)
        self.time_fc2 = nn.Linear(emb, emb)
        self.hint_encoder = HintEncoder(hint_channels, mc)
        self.conv_in = _conv3(cfg.in_channels, mc)
        self.zero_0 = _zero_conv(mc)
        self._down = []
        ch, ds, zi = mc, 1, 1
        for level, mult in enumerate(cfg.channel_mult):
            for i in range(cfg.num_res_blocks):
                names = [f'down_{level}_res_{i}']
                self.add_module(names[0], ResBlock(
                    ch, mc * mult, emb, cfg.use_scale_shift_norm))
                ch = mc * mult
                if ds in cfg.attention_resolutions:
                    names.append(f'down_{level}_attn_{i}')
                    self.add_module(names[-1], SpatialTransformer(
                        ch, cfg.num_heads, cfg.context_dim,
                        cfg.transformer_depth))
                self.add_module(f'zero_{zi}', _zero_conv(ch))
                self._down.append((names, f'zero_{zi}'))
                zi += 1
            if level != len(cfg.channel_mult) - 1:
                name = f'down_{level}_downsample'
                self.add_module(name, ResBlock(
                    ch, ch, emb, cfg.use_scale_shift_norm, down=True)
                    if cfg.resblock_updown else Downsample(ch, ch))
                self.add_module(f'zero_{zi}', _zero_conv(ch))
                self._down.append(([name], f'zero_{zi}'))
                zi += 1
                ds *= 2
        self.mid_res_1 = ResBlock(ch, ch, emb, cfg.use_scale_shift_norm)
        self.mid_attn = SpatialTransformer(ch, cfg.num_heads, cfg.context_dim,
                                           cfg.transformer_depth)
        self.mid_res_2 = ResBlock(ch, ch, emb, cfg.use_scale_shift_norm)
        self.zero_mid = _zero_conv(ch)
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                mod.to(memory_format=torch.channels_last)

    def _run(self, names, h, emb, context):
        for name in names:
            mod = getattr(self, name)
            if isinstance(mod, ResBlock):
                h = mod(h, emb)
            elif isinstance(mod, SpatialTransformer):
                h = mod(h, context)
            else:
                h = mod(h)
        return h

    def forward(self, x, hint, timesteps, context=None):
        cfg = self.cfg
        if isinstance(context, dict):
            context = context.get('crossattn')
        dt = self.conv_in.weight.dtype
        t_emb = timestep_embedding(timesteps, cfg.model_channels).to(dt)
        emb = self.time_fc2(F.silu(self.time_fc1(t_emb)))
        B, H, W, C = x.shape
        if cfg.roll_out:
            x = x.reshape(B, H, W, 3, C // 3).transpose(2, 3)
            x = x.reshape(B, H, 3 * W, C // 3)
            if hint.shape[2] != 3 * W:
                hint = hint.repeat(1, 1, 3, 1)

        def nchw(v):
            return v.permute(0, 3, 1, 2).to(
                dt, memory_format=torch.channels_last)

        x = nchw(x)
        guided = self.hint_encoder(nchw(hint))
        if guided.shape[2:] != x.shape[2:]:
            guided = F.interpolate(guided, size=x.shape[2:], mode='bilinear',
                                   align_corners=False, antialias=True)
        h = self.conv_in(x) + guided
        controls = [self.zero_0(h)]
        for names, zero in self._down:
            h = self._run(names, h, emb, context)
            controls.append(getattr(self, zero)(h))
        h = self._run(('mid_res_1', 'mid_attn', 'mid_res_2'), h, emb,
                      context)
        controls.append(self.zero_mid(h))
        return controls
