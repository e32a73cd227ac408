"""DiT denoiser (stage 2) and the VAE's DiT2 decoder backbone.

Port of ``ln3diff_tpu/models/dit.py`` for the block variants on the
text→3D path: plain adaLN-zero (``'adaln'``, DiT2) and adaLN with text
cross-attention (``'text'``, DiT-L/2).  Attention is the plain
matmul-softmax-matmul of ``jax.nn.dot_product_attention`` (the JAX
default, ``fused_attention=False``).  The PixArt / image-conditioned
variants, the fused-attention and int8 serving knobs wait for later
slices.

Layout: latents are channels-last ``(B, H, W, C)`` with the channel axis
decomposed as ``(c, plane)``, plane fastest, as in the JAX package.  The
JAX package scans a stacked trunk (leading depth axis); here each block is
its own module (``blocks.{i}``), and ``bridge.py`` splits the stack.

Modules are built in f32; ``cfg.dtype`` (bf16 for serving) is the compute
and storage dtype the caller casts them to (``module.to(cfg.dtype)``), which
matches the JAX modules' per-op cast of f32 params to ``dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import dot_product_attention, timestep_embedding


# ---------------------------------------------------------------------------
# sin-cos positional embeddings (MAE convention)
# ---------------------------------------------------------------------------

def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega = 1.0 / 10000**(omega / (embed_dim / 2.0))
    out = np.einsum('m,d->md', pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size) -> np.ndarray:
    """``grid_size`` is an int (square) or ``(gh, gw)``."""
    if isinstance(grid_size, tuple):
        gh, gw = grid_size
    else:
        gh = gw = grid_size
    grid_h = np.arange(gh, dtype=np.float32)
    grid_w = np.arange(gw, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)  # w first
    grid = grid.reshape(2, 1, gh, gw)
    emb_h = _sincos_1d(embed_dim // 2, grid[0])
    emb_w = _sincos_1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def t2i_modulate(x, shift, scale):
    return x * (1 + scale) + shift


def _layer_norm(x):
    """LayerNorm without affine params, eps 1e-6, statistics in f32."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, L, D = x.shape
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        hd = D // self.num_heads
        out = dot_product_attention(q.reshape(B, L, self.num_heads, hd),
                                    k.reshape(B, L, self.num_heads, hd),
                                    v.reshape(B, L, self.num_heads, hd))
        return self.proj(out.reshape(B, L, D))


class CrossAttention(nn.Module):
    """Query tokens attend to context tokens with the reference's fixed
    ``dim_head=64`` inner width (projections map to heads·64)."""

    def __init__(self, dim: int, num_heads: int, context_dim: int,
                 dim_head: int = 64):
        super().__init__()
        self.num_heads = num_heads
        self.dim_head = dim_head
        inner = num_heads * dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x, context):
        B, L, _ = x.shape

        def heads(t):
            return t.reshape(B, -1, self.num_heads, self.dim_head)

        out = dot_product_attention(heads(self.to_q(x)),
                                    heads(self.to_k(context)),
                                    heads(self.to_v(context)))
        return self.to_out(out.reshape(B, L, -1))


class GeluMLP(nn.Module):
    def __init__(self, dim: int, hidden_mult: int = 4,
                 exact_gelu: bool = False):
        super().__init__()
        self.approximate = 'none' if exact_gelu else 'tanh'
        self.fc1 = nn.Linear(dim, dim * hidden_mult)
        self.fc2 = nn.Linear(dim * hidden_mult, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, freq_size: int = 256):
        super().__init__()
        self.freq_size = freq_size
        self.fc1 = nn.Linear(freq_size, hidden_size)
        self.fc2 = nn.Linear(hidden_size, hidden_size)

    def forward(self, t):
        emb = timestep_embedding(t, self.freq_size).to(self.fc1.weight.dtype)
        return self.fc2(F.silu(self.fc1(emb)))


class CaptionEmbedder(nn.Module):
    """Caption tokens → hidden size, with the learned null embedding of
    CFG training (unused at inference, carried for the weights)."""

    def __init__(self, hidden_size: int, token_num: int = 77,
                 context_dim: int = 768):
        super().__init__()
        self.y_embedding = nn.Parameter(
            torch.randn(token_num, context_dim) / context_dim**0.5)
        self.fc1 = nn.Linear(context_dim, hidden_size)
        self.fc2 = nn.Linear(hidden_size, hidden_size)

    def forward(self, caption):
        return self.fc2(F.gelu(self.fc1(caption), approximate='tanh'))


class DiTBlock(nn.Module):
    """adaLN-zero block; ``variant='text'`` adds text cross-attention.
    ``token_modulation=True`` (DiT2) takes per-token conditioning
    ``(B, L, D)`` instead of pooled ``(B, D)``."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: int = 4,
                 variant: str = 'adaln', context_dim: Optional[int] = None,
                 token_modulation: bool = False, exact_gelu: bool = True):
        super().__init__()
        if variant not in ('adaln', 'text'):
            raise NotImplementedError(f'DiT block variant {variant!r}')
        self.variant = variant
        self.token_modulation = token_modulation
        self.adaLN_modulation = nn.Linear(hidden_size, 6 * hidden_size)
        self.attn = Attention(hidden_size, num_heads)
        if variant == 'text':
            self.cross_attn = CrossAttention(
                hidden_size, num_heads, context_dim or hidden_size)
        self.mlp = GeluMLP(hidden_size, mlp_ratio, exact_gelu=exact_gelu)

    def forward(self, x, c, context=None):
        mod = self.adaLN_modulation(F.silu(c))
        if not self.token_modulation:
            mod = mod[:, None]
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = mod.chunk(6, dim=-1)
        h = t2i_modulate(_layer_norm(x), shift_msa, scale_msa)
        x = x + gate_msa * self.attn(h)
        if self.variant == 'text':
            if context is None:
                raise ValueError("the 'text' DiT block needs a context")
            x = x + self.cross_attn(x, context)
        h = t2i_modulate(_layer_norm(x), shift_mlp, scale_mlp)
        return x + gate_mlp * self.mlp(h)


class FinalLayer(nn.Module):
    def __init__(self, hidden_size: int, out_dim: int,
                 token_modulation: bool = False):
        super().__init__()
        self.token_modulation = token_modulation
        self.adaLN_modulation = nn.Linear(hidden_size, 2 * hidden_size)
        self.linear = nn.Linear(hidden_size, out_dim)

    def forward(self, x, c):
        mod = self.adaLN_modulation(F.silu(c))
        if not self.token_modulation:
            mod = mod[:, None]
        shift, scale = mod.chunk(2, dim=-1)
        return self.linear(t2i_modulate(_layer_norm(x), shift, scale))


class PatchEmbed(nn.Module):
    """Conv patch embedding; channels-last ``(B, H, W, C)`` →
    ``(B, h*w, D)``."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size,
                              stride=patch_size)

    def forward(self, x):
        x = self.proj(x.permute(0, 3, 1, 2))
        return x.flatten(2).transpose(1, 2)


# ---------------------------------------------------------------------------
# DiT denoiser (stage 2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiTConfig:
    input_size: int = 32          # latent H=W
    patch_size: int = 2
    in_channels: int = 4          # per-plane latent channels
    hidden_size: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    plane_n: int = 3
    context_dim: int = 768
    variant: str = 'text'
    # serving mode: tanh-approximate MLP GELU
    exact_gelu: bool = True
    dtype: Any = torch.bfloat16


class DiT_TriLatent(nn.Module):
    """Triplane DiT denoiser (reference ``dit/dit_trilatent.py``).

    ``x``: ``(B, H, W, plane_n*in_channels)`` channels-last, (c, plane)
    channel layout; ``context``: ``{'crossattn': (B, L, context_dim)}``.
    Returns the prediction in the same layout, f32.
    """

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        if cfg.variant != 'text':
            raise NotImplementedError(f'DiT variant {cfg.variant!r}')
        self.cfg = cfg
        D = cfg.hidden_size
        self.t_embedder = TimestepEmbedder(D)
        self.x_embedder = PatchEmbed(cfg.patch_size, cfg.in_channels, D)
        self.clip_text_proj = CaptionEmbedder(D, context_dim=cfg.context_dim)
        self.blocks = nn.ModuleList([
            DiTBlock(D, cfg.num_heads, cfg.mlp_ratio, variant=cfg.variant,
                     context_dim=D, exact_gelu=cfg.exact_gelu)
            for _ in range(cfg.depth)])
        self.final_layer = FinalLayer(D, cfg.patch_size**2 * cfg.in_channels)
        L = (cfg.input_size // cfg.patch_size)**2
        self.register_buffer('pos_embed', torch.from_numpy(
            get_2d_sincos_pos_embed(D, (cfg.plane_n, L))[None]),
            persistent=False)

    def forward(self, x, timesteps, context):
        cfg = self.cfg
        B, H, W, _ = x.shape
        n = cfg.plane_n
        dtype = self.x_embedder.proj.weight.dtype

        t = self.t_embedder(timesteps)
        # roll-out: fold planes into the batch for the patch conv
        x = x.reshape(B, H, W, cfg.in_channels, n).permute(0, 4, 1, 2, 3)
        x = x.reshape(B * n, H, W, cfg.in_channels)
        x = self.x_embedder(x.to(dtype))
        L = x.shape[1]
        x = x.reshape(B, n * L, cfg.hidden_size)
        x = x + self.pos_embed.to(dtype)

        crossattn = self.clip_text_proj(context['crossattn'].to(dtype))
        for block in self.blocks:
            x = block(x, t, context=crossattn)

        x = self.final_layer(x, t)
        p = cfg.patch_size
        h = w = H // p
        x = x.reshape(B, n, h, w, p, p, cfg.in_channels)
        x = x.permute(0, 2, 4, 3, 5, 6, 1)      # B h p w p c n
        return x.reshape(B, H, W, cfg.in_channels * n).float()


def dit_registry(name: str, **overrides) -> DiTConfig:
    """Named configs of the reference registry
    (``dit/dit_trilatent.py:320``); the port has the released text→3D one."""
    presets = {
        'DiT-L/2': dict(depth=24, hidden_size=1024, patch_size=2,
                        num_heads=16),
    }
    kw = dict(presets[name], variant='text')
    kw.update(overrides)
    return DiTConfig(**kw)


# ---------------------------------------------------------------------------
# DiT2: VAE decoder backbone
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiT2Config:
    tokens_per_plane: int = 256
    hidden_size: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    plane_n: int = 3
    dtype: Any = torch.bfloat16


class _Pair(nn.Module):
    """One within-plane block and one cross-plane block."""

    def __init__(self, cfg: DiT2Config):
        super().__init__()
        D = cfg.hidden_size
        self.within = DiTBlock(D, cfg.num_heads, cfg.mlp_ratio,
                               token_modulation=True)
        self.across = DiTBlock(D, cfg.num_heads, cfg.mlp_ratio,
                               token_modulation=True)


class DiT2(nn.Module):
    """VAE decoder backbone (reference ``dit/dit_decoder.py:53-163``): the
    learnable ``pos_embed`` is the query; the latent tokens ``c``
    ``(B, plane_n*L, D)`` condition every block per token.  Even blocks
    attend within a plane, odd blocks across all planes (the released
    roll-out configuration)."""

    def __init__(self, cfg: DiT2Config):
        super().__init__()
        if cfg.depth % 2:
            raise ValueError('DiT2 depth must be even')
        self.cfg = cfg
        n, L, D = cfg.plane_n, cfg.tokens_per_plane, cfg.hidden_size
        self.pos_embed = nn.Parameter(torch.randn(1, n * L, D) * 0.02)
        self.blocks = nn.ModuleList([_Pair(cfg)
                                     for _ in range(cfg.depth // 2)])

    def forward(self, c):
        cfg = self.cfg
        B = c.shape[0]
        n, L, D = cfg.plane_n, cfg.tokens_per_plane, cfg.hidden_size
        dtype = self.pos_embed.dtype
        c = c.to(dtype)
        x = self.pos_embed.expand(B, n * L, D)
        for pair in self.blocks:
            h = pair.within(x.reshape(B * n, L, D), c.reshape(B * n, L, D))
            x = pair.across(h.reshape(B, n * L, D), c)
        return x


def dit2_registry(name: str, **overrides) -> DiT2Config:
    """The released Objaverse VAE decoder backbone."""
    presets = {
        'DiT2-L/2': dict(depth=24, hidden_size=1024, num_heads=16),
    }
    kw = dict(presets[name])
    kw.update(overrides)
    return DiT2Config(**kw)
