"""DiT denoiser (stage 2) and the VAE's DiT2 decoder backbone.

Port of ``ln3diff_tpu/models/dit.py`` with every block variant of the
released Objaverse families: plain adaLN-zero (``'adaln'``, DiT2), adaLN
with text cross-attention (``'text'``, DiT-L/2 of text→3D) and the
PixArt variants with one shared adaLN (``'pixelart-text'``,
``'image-pixelart'`` of image→3D, ``'image-pixelart-noclip'`` and
``'mv-pixelart'`` of multi-view→3D): a ``scale_shift_table`` per block,
RMSNorm or parameter-free LayerNorm, RMSNorm of q and k in the
self-attention, DINO tokens concatenated into the self-attention, the
pooled-vector embedding ``cap_norm``/``cap_proj`` and the T2I final
layer.  Attention is the plain matmul-softmax-matmul of
``jax.nn.dot_product_attention`` (the JAX default);
``DiTConfig.fused_attention=True`` (the serving switch) sends the
denoiser's self-attention through the fused kernel
(``ops/fused_attention.py``), as the JAX package's ``Attention.fused``
does.  ``DiTConfig.quantized=True`` (the W8A8 serving knob) makes every
block's ``qkv``/``proj``, ``to_q``/``to_k``/``to_v``/``to_out`` and
``fc1``/``fc2`` an ``ops.int8.Int8Linear``, as the JAX package's
``_dense_cls`` does; the adaLN, the norms and the embedders stay in the
model's dtype.  ``learn_sigma`` doubles the head's channels with a
variance half for learned-range VLB training.  ``remat`` recomputes each
block (DiT2: each block pair) in the backward pass: ``remat_policy='full'``
keeps only the block's inputs (``torch.utils.checkpoint``), ``'dots'``
also keeps the outputs of its matrix products (selective checkpointing:
``aten.mm``, ``addmm`` and ``bmm``) and recomputes the elementwise ops,
as ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` keeps the
projections' outputs (it recomputes the attention's batched products).

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
import functools
from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils import checkpoint

from ..ops.fused_attention import sdpa_auto
from ..ops.int8 import Int8Linear
from .layers import RMSNorm, dot_product_attention, timestep_embedding


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
# rematerialization
# ---------------------------------------------------------------------------

_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (checkpoint.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_call(policy: str, fn, *args):
    """``fn(*args)`` recomputed in the backward pass under ``policy``
    (``'full'`` or ``'dots'``); a plain call when autograd records
    nothing."""
    if policy not in ('full', 'dots'):
        raise ValueError(f'unknown remat_policy {policy!r}')
    if not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if policy == 'dots':
        kw['context_fn'] = functools.partial(
            checkpoint.create_selective_checkpoint_contexts, _save_dots)
    return checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _dense_cls(quantized: bool):
    """``nn.Linear``, or its W8A8 int8 drop-in for quantized serving."""
    return Int8Linear if quantized else nn.Linear


def t2i_modulate(x, shift, scale):
    return x * (1 + scale) + shift


def _layer_norm(x):
    """LayerNorm without affine params, eps 1e-6, statistics in f32."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6).to(x.dtype)


class Attention(nn.Module):
    """Multi-head self-attention.  ``qk_norm`` RMS-normalises q and k over
    the head dim (eps 1e-5).  ``fused=True`` runs the fused kernel on q, k
    and v: v (and q, k without ``qk_norm``) read in place from the one
    qkv projection (int8 with ``quantized``)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_norm: bool = False, fused: bool = False,
                 quantized: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.fused = fused
        dense = _dense_cls(quantized)
        self.qkv = dense(dim, 3 * dim, bias=qkv_bias)
        hd = dim // num_heads
        self.q_norm = RMSNorm(hd) if qk_norm else None
        self.k_norm = RMSNorm(hd) if qk_norm else None
        self.proj = dense(dim, dim)

    def forward(self, x):
        B, L, _ = x.shape
        # heads from the projection's width: a tensor-parallel rank holds
        # num_heads / tp of them (parallel/serving.py)
        q, k, v = (t.reshape(B, L, self.num_heads, -1)
                   for t in self.qkv(x).chunk(3, dim=-1))
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        out = sdpa_auto(q, k, v, use_fused=self.fused)
        return self.proj(out.reshape(B, L, -1))


class CrossAttention(nn.Module):
    """Query tokens attend to context tokens with the reference's fixed
    ``dim_head=64`` inner width (projections map to heads·64)."""

    def __init__(self, dim: int, num_heads: int, context_dim: int,
                 dim_head: int = 64, quantized: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dim_head = dim_head
        inner = num_heads * dim_head
        dense = _dense_cls(quantized)
        self.to_q = dense(dim, inner, bias=False)
        self.to_k = dense(context_dim, inner, bias=False)
        self.to_v = dense(context_dim, inner, bias=False)
        self.to_out = dense(inner, dim)

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
                 exact_gelu: bool = False, quantized: bool = False):
        super().__init__()
        self.approximate = 'none' if exact_gelu else 'tanh'
        dense = _dense_cls(quantized)
        self.fc1 = dense(dim, dim * hidden_mult)
        self.fc2 = dense(dim * hidden_mult, dim)

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


PIXART_VARIANTS = ('pixelart-text', 'image-pixelart', 'image-pixelart-noclip',
                   'mv-pixelart')
CROSS_ATTN_VARIANTS = ('text', 'pixelart-text', 'image-pixelart',
                       'mv-pixelart')


class DiTBlock(nn.Module):
    """The DiT block of every variant (``ln3diff_tpu/models/dit.py:193``):

    * ``'adaln'``: adaLN-zero; ``'text'`` adds text cross-attention.
      ``token_modulation=True`` (DiT2) takes per-token conditioning
      ``(B, L, D)`` instead of pooled ``(B, D)``.
    * the PixArt variants take ``c``, the shared adaLN output ``(B, 6D)``,
      and add their own ``scale_shift_table`` (6, D).  ``'pixelart-text'``
      and ``'mv-pixelart'`` use RMSNorm for ``norm1``/``norm2``, the others
      the parameter-free LayerNorm; every image variant and
      ``'mv-pixelart'`` RMS-normalise q and k in the self-attention;
      ``'image-*'`` concatenate the DINO tokens into the self-attention
      and drop them after it; ``'pixelart-text'`` RMS-normalises the
      context (``attention_y_norm``).  ``quantized`` makes the
      attention projections and the MLP W8A8 int8."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: int = 4,
                 variant: str = 'adaln', context_dim: Optional[int] = None,
                 token_modulation: bool = False, exact_gelu: bool = True,
                 fused_attention: bool = False, quantized: bool = False):
        super().__init__()
        if variant not in ('adaln',) + CROSS_ATTN_VARIANTS + PIXART_VARIANTS:
            raise NotImplementedError(f'DiT block variant {variant!r}')
        self.variant = variant
        self.pixelart = variant in PIXART_VARIANTS
        self.token_modulation = token_modulation
        D = hidden_size
        if self.pixelart:
            self.scale_shift_table = nn.Parameter(torch.randn(6, D) / D**0.5)
        else:
            self.adaLN_modulation = nn.Linear(D, 6 * D)
        if variant in ('pixelart-text', 'mv-pixelart'):
            self.norm1, self.norm2 = RMSNorm(D), RMSNorm(D)
        else:
            self.norm1 = self.norm2 = _layer_norm
        qk_norm = variant.startswith('image-') or variant == 'mv-pixelart'
        self.attn = Attention(D, num_heads, qk_norm=qk_norm,
                              fused=fused_attention, quantized=quantized)
        if variant == 'pixelart-text':
            self.attention_y_norm = RMSNorm(context_dim or D)
        if variant in CROSS_ATTN_VARIANTS:
            self.cross_attn = CrossAttention(D, num_heads, context_dim or D,
                                             quantized=quantized)
        self.mlp = GeluMLP(D, mlp_ratio, exact_gelu=exact_gelu,
                           quantized=quantized)

    def forward(self, x, c, context=None, dino_tokens=None):
        if self.pixelart:
            B, D = c.shape[0], self.scale_shift_table.shape[1]
            mods = (self.scale_shift_table[None].to(c.dtype)
                    + c.reshape(B, 6, D)).chunk(6, dim=1)
        else:
            mod = self.adaLN_modulation(F.silu(c))
            if not self.token_modulation:
                mod = mod[:, None]
            mods = mod.chunk(6, dim=-1)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods
        h = t2i_modulate(self.norm1(x), shift_msa, scale_msa)
        if self.variant.startswith('image-') and dino_tokens is not None:
            h = torch.cat([h, dino_tokens.to(h.dtype)], dim=1)
            h = self.attn(h)[:, :x.shape[1]]
        else:
            h = self.attn(h)
        x = x + gate_msa * h
        if self.variant in CROSS_ATTN_VARIANTS:
            if context is None:
                raise ValueError(f'the {self.variant!r} DiT block needs a '
                                 f'context')
            if self.variant == 'pixelart-text':
                context = self.attention_y_norm(context)
            x = x + self.cross_attn(x, context)
        h = t2i_modulate(self.norm2(x), shift_mlp, scale_mlp)
        return x + gate_mlp * self.mlp(h)


class FinalLayer(nn.Module):
    """adaLN final projection; ``t2i=True`` uses the PixArt (2, D)
    ``scale_shift_table`` added to ``c`` (the timestep embedding) in place
    of the adaLN projection."""

    def __init__(self, hidden_size: int, out_dim: int, t2i: bool = False,
                 token_modulation: bool = False):
        super().__init__()
        self.t2i = t2i
        self.token_modulation = token_modulation
        if t2i:
            self.scale_shift_table = nn.Parameter(
                torch.randn(2, hidden_size) / hidden_size**0.5)
        else:
            self.adaLN_modulation = nn.Linear(hidden_size, 2 * hidden_size)
        self.linear = nn.Linear(hidden_size, out_dim)

    def forward(self, x, c):
        if self.t2i:
            shift, scale = (self.scale_shift_table[None].to(c.dtype)
                            + c[:, None]).chunk(2, dim=1)
        else:
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
    dino_dim: int = 768           # raw DINO token width (image variants)
    variant: str = 'text'         # DiTBlock variant
    pooled_vector_dim: int = 0    # > 0: add cap_proj(cap_norm(vector)) to t
    t2i_final: bool = False
    # serving mode: tanh-approximate MLP GELU
    exact_gelu: bool = True
    # serving mode: self-attention through the fused kernel
    fused_attention: bool = False
    # serving mode: W8A8 int8 block projections and MLPs (ops/int8.py)
    quantized: bool = False
    # double the output channels with a variance head (learned_range)
    learn_sigma: bool = False
    # training: recompute each block in the backward pass ('full' | 'dots')
    remat: bool = False
    remat_policy: str = 'full'
    dtype: Any = torch.bfloat16


class DiT_TriLatent(nn.Module):
    """Triplane DiT denoiser (reference ``dit/dit_trilatent.py``,
    ``dit/dit_i23d.py``).

    ``x``: ``(B, H, W, plane_n*in_channels)`` channels-last, (c, plane)
    channel layout; ``context``: a dict with ``'crossattn'`` (B, L,
    context_dim) — for ``'mv-pixelart'`` ``'concat'`` or ``'crossattn'``,
    (B, V, L, C) flattened to (B, V·L, C) — ``'vector'`` (B,
    pooled_vector_dim) when ``pooled_vector_dim`` > 0, and ``'dino'`` (B,
    L2, dino_dim) for the image variants.  Returns the prediction in x's
    layout, f32; with ``learn_sigma`` its channels are (mean C, var C) ×
    planes, c slow and plane fast, so the last axis splits in halves.
    """

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        if cfg.variant not in CROSS_ATTN_VARIANTS + PIXART_VARIANTS:
            raise NotImplementedError(f'DiT variant {cfg.variant!r}')
        self.cfg = cfg
        D = cfg.hidden_size
        self.t_embedder = TimestepEmbedder(D)
        if cfg.pooled_vector_dim:
            self.cap_norm = nn.LayerNorm(cfg.pooled_vector_dim, eps=1e-6)
            self.cap_proj = nn.Linear(cfg.pooled_vector_dim, D)
        self.x_embedder = PatchEmbed(cfg.patch_size, cfg.in_channels, D)
        if cfg.variant == 'text':
            self.clip_text_proj = CaptionEmbedder(
                D, context_dim=cfg.context_dim)
        if cfg.variant.startswith('image-'):
            self.dino_proj = CaptionEmbedder(D, context_dim=cfg.dino_dim)
        if cfg.variant in PIXART_VARIANTS:
            self.adaLN_modulation = nn.Linear(D, 6 * D)
        # the text variant's cross-attention reads the projected captions
        block_ctx = D if cfg.variant == 'text' else cfg.context_dim
        self.blocks = nn.ModuleList([
            DiTBlock(D, cfg.num_heads, cfg.mlp_ratio, variant=cfg.variant,
                     context_dim=block_ctx, exact_gelu=cfg.exact_gelu,
                     fused_attention=cfg.fused_attention,
                     quantized=cfg.quantized)
            for _ in range(cfg.depth)])
        self.out_channels = cfg.in_channels * (2 if cfg.learn_sigma else 1)
        self.final_layer = FinalLayer(D, cfg.patch_size**2 * self.out_channels,
                                      t2i=cfg.t2i_final)
        L = (cfg.input_size // cfg.patch_size)**2
        self.register_buffer('pos_embed', torch.from_numpy(
            get_2d_sincos_pos_embed(D, (cfg.plane_n, L))[None]),
            persistent=False)

    def _context(self, context, dtype):
        """(crossattn, dino) as the blocks take them."""
        cfg = self.cfg
        crossattn = context.get('crossattn')
        dino = context.get('dino')
        if cfg.variant == 'mv-pixelart':
            # multi-view DINO features (B, V, L, C) → one cross-attention
            # context (B, V·L, C), raw: the K/V projections embed them
            crossattn = context.get('concat', crossattn)
            if crossattn.ndim == 4:
                crossattn = crossattn.reshape(crossattn.shape[0], -1,
                                              crossattn.shape[-1])
            crossattn = crossattn.to(dtype)
        elif crossattn is not None and cfg.variant == 'text':
            crossattn = self.clip_text_proj(crossattn.to(dtype))
        elif crossattn is not None:
            crossattn = crossattn.to(dtype)
        if dino is not None and cfg.variant.startswith('image-'):
            dino = self.dino_proj(dino.to(dtype))
        return crossattn, dino

    def embed(self, x, timesteps, context):
        """Patchify and condition (JAX ``embed``): → (tokens ``(B, n·L,
        D)``, the timestep embedding, the blocks' conditioning ``c``, the
        cross-attention context, the DINO tokens)."""
        cfg = self.cfg
        B, H, W, _ = x.shape
        n = cfg.plane_n
        dtype = self.x_embedder.proj.weight.dtype

        t = self.t_embedder(timesteps)
        if cfg.pooled_vector_dim:
            t = t + self.cap_proj(self.cap_norm(context['vector'].to(dtype)))
        # roll-out: fold planes into the batch for the patch conv
        x = x.reshape(B, H, W, cfg.in_channels, n).permute(0, 4, 1, 2, 3)
        x = x.reshape(B * n, H, W, cfg.in_channels)
        x = self.x_embedder(x.to(dtype))
        L = x.shape[1]
        x = x.reshape(B, n * L, cfg.hidden_size)
        x = x + self.pos_embed.to(dtype)

        crossattn, dino = self._context(context or {}, dtype)
        # PixArt: one adaLN for all blocks
        c = (self.adaLN_modulation(F.silu(t))
             if cfg.variant in PIXART_VARIANTS else t)
        return x, t, c, crossattn, dino

    def head(self, x, t, shape):
        """Final layer and unpatchify (JAX ``head``): tokens → the
        prediction ``(B, H, W, C·n)`` f32 for an input of ``shape`` (B, H,
        W)."""
        cfg = self.cfg
        B, H, W = shape
        n = cfg.plane_n
        x = self.final_layer(x, t)
        p, C = cfg.patch_size, self.out_channels
        h = w = H // p
        x = x.reshape(B, n, h, w, p, p, C)
        x = x.permute(0, 2, 4, 3, 5, 6, 1)      # B h p w p c n
        return x.reshape(B, H, W, C * n).float()

    def forward(self, x, timesteps, context):
        cfg = self.cfg
        tokens, t, c, crossattn, dino = self.embed(x, timesteps, context)
        for block in self.blocks:
            if cfg.remat:
                tokens = _remat_call(cfg.remat_policy, block, tokens, c,
                                     crossattn, dino)
            else:
                tokens = block(tokens, c, context=crossattn,
                               dino_tokens=dino)
        return self.head(tokens, t, x.shape[:3])


def dit_registry(name: str, **overrides) -> DiTConfig:
    """Named configs of the reference registries
    (``dit/dit_trilatent.py:320``, ``dit/dit_i23d.py``): the released
    text→3D, PixArt, image→3D and multi-view→3D ones."""
    presets = {
        'DiT-XL/2': dict(depth=28, hidden_size=1152, patch_size=2,
                         num_heads=16, variant='text'),
        'DiT-L/2': dict(depth=24, hidden_size=1024, patch_size=2,
                        num_heads=16, variant='text'),
        'DiT-B/2': dict(depth=12, hidden_size=768, patch_size=2,
                        num_heads=12, variant='text'),
        'DiT-B/1': dict(depth=12, hidden_size=768, patch_size=1,
                        num_heads=12, variant='text'),
        'DiT-B/16': dict(depth=12, hidden_size=768, patch_size=16,
                         num_heads=12, variant='text'),
        'DiT-S/2': dict(depth=12, hidden_size=384, patch_size=2,
                        num_heads=6, variant='text'),
        'DiT-PixelArt-L/2': dict(depth=24, hidden_size=1024, patch_size=2,
                                 num_heads=16, variant='pixelart-text',
                                 pooled_vector_dim=768, t2i_final=True),
        'DiT-PixelArt-B/2': dict(depth=12, hidden_size=768, patch_size=2,
                                 num_heads=12, variant='pixelart-text',
                                 pooled_vector_dim=768, t2i_final=True),
        # i23d: CLIP-image spatial crossattn (1024) + DINO tokens
        'DiT-I23D-L/2': dict(depth=24, hidden_size=1024, patch_size=2,
                             num_heads=16, variant='image-pixelart',
                             context_dim=1024, pooled_vector_dim=768,
                             t2i_final=True),
        'DiT-I23D-B/2': dict(depth=12, hidden_size=768, patch_size=2,
                             num_heads=12, variant='image-pixelart',
                             context_dim=1024, pooled_vector_dim=768,
                             t2i_final=True),
        # mv23d: multi-view DINO tokens through the cross-attention
        'DiT-PixArt-MV-L/2': dict(depth=24, hidden_size=1024, patch_size=2,
                                  num_heads=16, variant='mv-pixelart',
                                  context_dim=768),
        'DiT-PixArt-MV-B/2': dict(depth=12, hidden_size=768, patch_size=2,
                                  num_heads=12, variant='mv-pixelart',
                                  context_dim=768),
    }
    kw = dict(presets[name])
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
    # the first block of each pair attends within each plane (False: over
    # all planes, as the second does)
    roll_out: bool = True
    # recompute each block pair in the backward pass ('full' | 'dots')
    remat: bool = False
    remat_policy: str = 'full'
    dtype: Any = torch.bfloat16


class _Pair(nn.Module):
    """One within-plane block and one cross-plane block (with
    ``roll_out=False`` both attend over all planes, JAX ``dit.py:695-703``;
    the first keeps the name ``within``)."""

    def __init__(self, cfg: DiT2Config):
        super().__init__()
        D = cfg.hidden_size
        self.within = DiTBlock(D, cfg.num_heads, cfg.mlp_ratio,
                               token_modulation=True)
        self.across = DiTBlock(D, cfg.num_heads, cfg.mlp_ratio,
                               token_modulation=True)
        self.plane_n = cfg.plane_n
        self.roll_out = cfg.roll_out

    def forward(self, x, c):
        if not self.roll_out:
            return self.across(self.within(x, c), c)
        B, nL, D = x.shape
        n = self.plane_n
        h = self.within(x.reshape(B * n, nL // n, D),
                        c.reshape(B * n, nL // n, D))
        return self.across(h.reshape(B, nL, D), c)


class DiT2(nn.Module):
    """VAE decoder backbone (reference ``dit/dit_decoder.py:53-163``): the
    learnable ``pos_embed`` is the query; the latent tokens ``c``
    ``(B, plane_n*L, D)`` condition every block per token.  Even blocks
    attend within a plane, odd blocks across all planes (the released
    roll-out configuration); with ``roll_out=False`` every block attends
    across all planes."""

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
            x = (_remat_call(cfg.remat_policy, pair, x, c) if cfg.remat
                 else pair(x, c))
        return x


def dit2_registry(name: str, **overrides) -> DiT2Config:
    """The VAE decoder backbones (JAX ``dit2_registry``): the released
    Objaverse one (L/2), the fg/bg FFHQ preset's (B/2) and the other
    sizes.  Patching lives in the VAE's ``ldm_upsample``
    (``TriplaneVAEConfig.patch_size``), so B/16 differs from B/2 only in
    ``tokens_per_plane``."""
    presets = {
        'DiT2-S/2': dict(depth=12, hidden_size=384, num_heads=6),
        'DiT2-B/2': dict(depth=12, hidden_size=768, num_heads=12),
        'DiT2-B/16': dict(depth=12, hidden_size=768, num_heads=12,
                          tokens_per_plane=4),
        'DiT2-L/2': dict(depth=24, hidden_size=1024, num_heads=16),
        'DiT2-XL/2': dict(depth=28, hidden_size=1152, num_heads=16),
    }
    kw = dict(presets[name])
    kw.update(overrides)
    return DiT2Config(**kw)
