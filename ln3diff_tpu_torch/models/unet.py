"""LDM/ADM U-Net denoiser with the triplane roll-out and the LSGM mixing
logit (the ShapeNet/FFHQ text→3D denoiser, U-Net-320).

Port of ``ln3diff_tpu/models/unet.py`` (``_norm`` :34, ``ResBlock`` :58,
``Downsample`` :107, ``Upsample`` :121, ``SelfAttention2D`` :135,
``TransformerBlock`` :165, ``SpatialTransformer`` :204, ``UNetConfig``
:233, ``UNetModel`` :257; reference ``guided_diffusion/unet.py``): ResBlocks
with FiLM scale-shift norm (and the ``resblock_updown`` resampling
variants), strided-conv ``Downsample`` / nearest + conv ``Upsample``, LDM
``SpatialTransformer`` cross-attention blocks (GEGLU with erf-GELU) or ADM
self-attention, the ``roll_out`` layout that concatenates the three planes
along the width, ControlNet ``control`` residuals, and the ``mixing_logit``
parameter that the LSGM samplers read.  The attention is the plain
``models/layers.py`` ``dot_product_attention``, as JAX's is
``jax.nn.dot_product_attention``.

The model takes and returns channels-last latents (B, H, W, 3·c) with the
'(n c)' plane-outer channel layout, as JAX's NHWC model does.  Inside, the
activations and the conv weights are NCHW tensors in channels-last memory
(NHWC storage), the layout Hopper's cuDNN convs take without transposing
their operands.  Submodule names are the JAX module's, so ``bridge.py``
maps the parameters one to one.
Built in f32; ``cfg.dtype`` (bf16 for serving) is the dtype the caller
casts it to.  ``quantized=True`` is the W8A8 int8 U-Net of serving (JAX
``_conv_cls`` / ``_dense_cls`` :42-57): ``ops.int8.Int8Conv`` for the
ResBlocks' convs and skip, the resampling convs and the attention's 1x1
projections, ``Int8Linear`` for the transformer blocks' layers; ``conv_in``,
``conv_out``, the time MLP, the ResBlocks' ``emb_proj`` and the mixing
logit stay float.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.int8 import Int8Conv, Int8Linear
from .layers import dot_product_attention, timestep_embedding


def _norm(channels: int, eps: float = 1e-5) -> nn.GroupNorm:
    """GroupNorm with the largest group count ≤ 32 that divides
    ``channels``."""
    groups = min(32, channels)
    while channels % groups:
        groups -= 1
    return nn.GroupNorm(groups, channels, eps=eps)


def _conv3(cin, cout, stride=1, quantized=False):
    conv = Int8Conv if quantized else nn.Conv2d
    return conv(cin, cout, 3, stride=stride, padding=1)


def _conv1(cin, cout, quantized=False):
    return (Int8Conv if quantized else nn.Conv2d)(cin, cout, 1)


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 use_scale_shift_norm: bool = True, up: bool = False,
                 down: bool = False, quantized: bool = False):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.in_norm = _norm(in_channels)
        self.in_conv = _conv3(in_channels, out_channels, quantized=quantized)
        self.emb_proj = nn.Linear(
            emb_channels,
            2 * out_channels if use_scale_shift_norm else out_channels)
        self.out_norm = _norm(out_channels)
        self.out_conv = _conv3(out_channels, out_channels,
                               quantized=quantized)
        if in_channels != out_channels:
            self.skip = _conv1(in_channels, out_channels, quantized)

    def _resample(self, v):
        if self.up:
            return F.interpolate(v, scale_factor=2, mode='nearest')
        if self.down:
            return F.avg_pool2d(v, 2)
        return v

    def forward(self, x, emb):
        h = F.silu(self.in_norm(x))
        h = self.in_conv(self._resample(h))
        x = self._resample(x)
        emb_out = self.emb_proj(F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = F.silu(self.out_norm(h) * (1 + scale) + shift)
        else:
            h = F.silu(self.out_norm(h + emb_out))
        h = self.out_conv(h)
        if hasattr(self, 'skip'):
            x = self.skip(x)
        return x + h


class Downsample(nn.Module):
    """3x3 stride-2 conv with torch's (1, 1) padding."""

    def __init__(self, in_channels: int, out_channels: int,
                 quantized: bool = False):
        super().__init__()
        self.op = _conv3(in_channels, out_channels, stride=2,
                         quantized=quantized)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """Nearest ×2, then a 3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 quantized: bool = False):
        super().__init__()
        self.conv = _conv3(in_channels, out_channels, quantized=quantized)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode='nearest'))


def _heads(t, B, num_heads):
    return t.reshape(B, t.shape[1], num_heads, -1)


class SelfAttention2D(nn.Module):
    """ADM ``AttentionBlock`` (with ``use_spatial_transformer=False``)."""

    def __init__(self, channels: int, num_head_channels: int = 64,
                 quantized: bool = False):
        super().__init__()
        self.num_heads = max(1, channels // num_head_channels)
        self.norm = _norm(channels)
        self.qkv = _conv1(channels, 3 * channels, quantized)
        self.proj = _conv1(channels, channels, quantized)

    def forward(self, x, context=None):
        B, C, H, W = x.shape
        qkv = self.qkv(self.norm(x)).flatten(2).transpose(1, 2)  # B HW 3C
        q, k, v = (_heads(t, B, self.num_heads) for t in qkv.chunk(3, -1))
        # C / tp channels on a tensor rank that holds num_heads / tp heads
        out = dot_product_attention(q, k, v).reshape(B, H, W, -1)
        return x + self.proj(out.permute(0, 3, 1, 2))


class TransformerBlock(nn.Module):
    """LDM ``BasicTransformerBlock``: self-attention, cross-attention to
    the context (self-attention again without one) and a GEGLU feed-forward
    with erf-GELU, each behind a LayerNorm (eps 1e-6, Linen's default)."""

    def __init__(self, channels: int, num_heads: int,
                 context_dim: Optional[int] = None, quantized: bool = False):
        super().__init__()
        C = channels
        kv_dim = context_dim or C
        linear = Int8Linear if quantized else nn.Linear
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(C, eps=1e-6)
        self.norm2 = nn.LayerNorm(C, eps=1e-6)
        self.norm3 = nn.LayerNorm(C, eps=1e-6)
        for name, kv_in in (('attn1', C), ('attn2', kv_dim)):
            self.add_module(f'{name}_q', linear(C, C, bias=False))
            self.add_module(f'{name}_k', linear(kv_in, C, bias=False))
            self.add_module(f'{name}_v', linear(kv_in, C, bias=False))
            self.add_module(f'{name}_out', linear(C, C))
        self.ff_proj = linear(C, 8 * C)
        self.ff_out = linear(4 * C, C)

    def _mha(self, q_in, kv_in, name):
        B, L, C = q_in.shape
        q = getattr(self, f'{name}_q')(q_in)
        k = getattr(self, f'{name}_k')(kv_in)
        v = getattr(self, f'{name}_v')(kv_in)
        out = dot_product_attention(_heads(q, B, self.num_heads),
                                    _heads(k, B, self.num_heads),
                                    _heads(v, B, self.num_heads))
        return getattr(self, f'{name}_out')(out.reshape(B, L, C))

    def forward(self, h, context=None):
        hn = self.norm1(h)
        h = h + self._mha(hn, hn, 'attn1')
        hn = self.norm2(h)
        kv = hn if context is None else context.to(hn.dtype)
        h = h + self._mha(hn, kv, 'attn2')
        val, gate = self.ff_proj(self.norm3(h)).chunk(2, dim=-1)
        return h + self.ff_out(val * F.gelu(gate, approximate='none'))


class SpatialTransformer(nn.Module):
    """LDM ``SpatialTransformer``: GroupNorm (eps 1e-6) → 1x1 ``proj_in``
    → transformer blocks → 1x1 ``proj_out``, residual; inner width =
    channels."""

    def __init__(self, channels: int, num_heads: int, context_dim: int,
                 depth: int = 1, quantized: bool = False):
        super().__init__()
        self.depth = depth
        self.norm = _norm(channels, eps=1e-6)
        self.proj_in = _conv1(channels, channels, quantized)
        for d in range(depth):
            self.add_module(f'block_{d}', TransformerBlock(
                channels, num_heads, context_dim, quantized))
        self.proj_out = _conv1(channels, channels, quantized)

    def forward(self, x, context=None):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x)).flatten(2).transpose(1, 2)
        for d in range(self.depth):
            h = getattr(self, f'block_{d}')(h, context)
        h = h.transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(h)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4              # per-plane latent channels
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (8,)   # downsample rates
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    num_heads: int = 8
    num_head_channels: int = -1
    use_spatial_transformer: bool = True
    context_dim: int = 768
    transformer_depth: int = 1
    use_scale_shift_norm: bool = True
    resblock_updown: bool = False
    roll_out: bool = True
    mixed_prediction: bool = True
    mixing_logit_init: float = -6.0
    quantized: bool = False
    dtype: Any = torch.bfloat16


class UNetModel(nn.Module):
    """The U-Net.  ``forward(x, timesteps, context=None, control=None)``:
    x (B, H, W, 3·in_channels) with ``roll_out`` ('(n c)' channels), else
    (B, H, W, in_channels); ``context`` (B, L, context_dim) or a dict with
    'crossattn'; ``control``: ControlNet residuals [conv_in, *down blocks,
    middle].  Returns the prediction channels-last in f32."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        q = cfg.quantized
        mc = cfg.model_channels
        emb = 4 * mc
        if cfg.mixed_prediction:
            n = cfg.in_channels * (3 if cfg.roll_out else 1)
            self.mixing_logit = nn.Parameter(
                torch.full((1, 1, 1, n), cfg.mixing_logit_init))
        self.time_fc1 = nn.Linear(mc, emb)
        self.time_fc2 = nn.Linear(emb, emb)
        self.conv_in = _conv3(cfg.in_channels, mc)

        def res(name, cin, cout, **kw):
            self.add_module(name, ResBlock(cin, cout, emb,
                                           cfg.use_scale_shift_norm,
                                           quantized=q, **kw))

        chans = [mc]
        ch, ds = mc, 1
        self._down = []
        for level, mult in enumerate(cfg.channel_mult):
            for i in range(cfg.num_res_blocks):
                res(f'down_{level}_res_{i}', ch, mc * mult)
                ch = mc * mult
                names = [f'down_{level}_res_{i}']
                if ds in cfg.attention_resolutions:
                    self._attn(f'down_{level}_attn_{i}', ch)
                    names.append(f'down_{level}_attn_{i}')
                self._down.append(names)
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                name = f'down_{level}_downsample'
                if cfg.resblock_updown:
                    res(name, ch, ch, down=True)
                else:
                    self.add_module(name, Downsample(ch, ch, q))
                self._down.append([name])
                chans.append(ch)
                ds *= 2
        res('mid_res_1', ch, ch)
        self._attn('mid_attn', ch)
        res('mid_res_2', ch, ch)
        self._up = []
        for level in reversed(range(len(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                cout = mc * cfg.channel_mult[level]
                res(f'up_{level}_res_{i}', ch + chans.pop(), cout)
                ch = cout
                names = [f'up_{level}_res_{i}']
                if ds in cfg.attention_resolutions:
                    self._attn(f'up_{level}_attn_{i}', ch)
                    names.append(f'up_{level}_attn_{i}')
                if level and i == cfg.num_res_blocks:
                    name = f'up_{level}_upsample'
                    if cfg.resblock_updown:
                        res(name, ch, ch, up=True)
                    else:
                        self.add_module(name, Upsample(ch, ch, q))
                    names.append(name)
                    ds //= 2
                self._up.append(names)
        self.out_norm = _norm(ch)
        self.conv_out = _conv3(ch, cfg.out_channels)
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                mod.to(memory_format=torch.channels_last)

    def _attn(self, name, ch):
        cfg = self.cfg
        if cfg.use_spatial_transformer:
            heads = (cfg.num_heads if cfg.num_head_channels == -1
                     else max(1, ch // cfg.num_head_channels))
            mod = SpatialTransformer(ch, heads, cfg.context_dim,
                                     cfg.transformer_depth, cfg.quantized)
        else:
            mod = SelfAttention2D(
                ch, cfg.num_head_channels if cfg.num_head_channels > 0
                else max(1, ch // cfg.num_heads), cfg.quantized)
        self.add_module(name, mod)

    def reset_free_parameters(self, generator=None):
        if self.cfg.mixed_prediction:
            self.mixing_logit.fill_(self.cfg.mixing_logit_init)

    def _run(self, names, h, emb, context):
        for name in names:
            mod = getattr(self, name)
            if isinstance(mod, ResBlock):
                h = mod(h, emb)
            elif isinstance(mod, (SpatialTransformer, SelfAttention2D)):
                h = mod(h, context)
            else:
                h = mod(h)
        return h

    def forward(self, x, timesteps, context=None, control=None):
        cfg = self.cfg
        if isinstance(context, dict):
            context = context.get('crossattn')
        dt = self.conv_in.weight.dtype
        t_emb = timestep_embedding(timesteps, cfg.model_channels).to(dt)
        emb = self.time_fc2(F.silu(self.time_fc1(t_emb)))
        B, H, W, C = x.shape
        if cfg.roll_out:
            # '(n c)' channels → the planes side by side along the width
            x = x.reshape(B, H, W, 3, C // 3).transpose(2, 3)
            x = x.reshape(B, H, 3 * W, C // 3)
        h = self.conv_in(x.permute(0, 3, 1, 2).to(
            dt, memory_format=torch.channels_last))
        hs = [h]
        for names in self._down:
            h = self._run(names, h, emb, context)
            hs.append(h)
        h = self._run(('mid_res_1', 'mid_attn', 'mid_res_2'), h, emb,
                      context)
        if control is not None:
            if len(control) != len(hs) + 1:
                raise ValueError(f'control has {len(control)} residuals, '
                                 f'the U-Net {len(hs) + 1}')
            h = h + control[-1].to(h.dtype)
            hs = [s + c.to(s.dtype) for s, c in zip(hs, control[:-1])]
        for names in self._up:
            h = torch.cat([h, hs.pop()], dim=1)
            h = self._run(names, h, emb, context)
        h = self.conv_out(F.silu(self.out_norm(h))).permute(0, 2, 3, 1)
        if cfg.roll_out:
            c = h.shape[-1]
            h = h.reshape(B, H, 3, W, c).transpose(2, 3)
            h = h.reshape(B, H, W, 3 * c)
        return h.float()
