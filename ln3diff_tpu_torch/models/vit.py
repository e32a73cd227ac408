"""DINO / DINOv2 Vision Transformer and the triplane fusion decoders.

Port of ``ln3diff_tpu/models/vit.py``: ``ViTBlock`` :28, ``ViTConfig``
:58, ``VisionTransformer`` :72 and ``vit_registry`` :113 (a pre-LN ViT in
the DINO layout, with DINOv2's per-channel layerscale gains and erf-GELU,
over channels-last images: the DINOv2 image embedder of the image→3D and
multi-view→3D paths and the encoder of the ShapeNet/FFHQ VAEs), and the
released ShapeNet/FFHQ decoder backbone: ``XYGridCrossAttention`` :215,
``DinoFusionBlock`` :256 (v4), ``DinoFusionBlockV3`` :293,
``DinoFusionDecoder`` :320 and ``unpatchify_triplane`` :371; and the
generic fusion decoder of no released model, ``TriplaneFusionBlock``
:142, ``TriplaneViTDecoderConfig`` :163 and ``TriplaneViTDecoder`` :174.
The blocks reuse the DiT's ``Attention`` and ``GeluMLP``, as in the JAX
package.

The LayerNorms compute in f32 and return the layer's dtype (Linen's
numerics).  The fusion blocks' own gains ``gamma1``/``gamma2`` stay f32
under a bf16 cast (JAX keeps them f32 and does not cast them), so their
residual stream turns f32 as JAX's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn as nn

from .dit import Attention, GeluMLP, get_2d_sincos_pos_embed
from .layers import LayerNorm, dot_product_attention


class ViTBlock(nn.Module):
    """Pre-LN transformer block (norm1/attn/norm2/mlp, LayerNorm eps
    1e-6).  ``layerscale`` adds DINOv2's residual gains ``gamma1`` and
    ``gamma2``; ``exact_gelu`` selects erf-GELU (DINOv2) over tanh-GELU."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 layerscale: bool = False, exact_gelu: bool = False):
        super().__init__()
        if layerscale:
            self.gamma1 = nn.Parameter(torch.full((dim,), 1e-5))
            self.gamma2 = nn.Parameter(torch.full((dim,), 1e-5))
        else:
            self.gamma1 = self.gamma2 = None
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = GeluMLP(dim, mlp_ratio, exact_gelu=exact_gelu)

    def reset_free_parameters(self, generator=None):
        if self.gamma1 is not None:
            self.gamma1.fill_(1e-5)
            self.gamma2.fill_(1e-5)

    def forward(self, x):
        h = self.attn(self.norm1(x))
        x = x + (h if self.gamma1 is None else self.gamma1.to(x.dtype) * h)
        h = self.mlp(self.norm2(x))
        return x + (h if self.gamma2 is None else self.gamma2.to(x.dtype) * h)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 384        # ViT-S
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    use_cls_token: bool = True
    layerscale: bool = False     # DINOv2
    exact_gelu: bool = False     # DINOv2
    dtype: Any = torch.float32


class VisionTransformer(nn.Module):
    """DINO ViT encoder: images (B, H, W, C) channels-last → normalised
    tokens (B, [1 +] h·w, D), in the module's dtype (``cfg.dtype`` is the
    dtype the caller casts it to).  ``in_channels``: C, 3 for images, 9
    for RGB + Plücker rays (JAX's conv takes it from its input)."""

    def __init__(self, cfg: ViTConfig, in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        D, p = cfg.embed_dim, cfg.patch_size
        self.patch_embed = nn.Conv2d(in_channels, D, p, stride=p)
        n_tok = (cfg.img_size // p)**2 + (1 if cfg.use_cls_token else 0)
        self.pos_embed = nn.Parameter(torch.randn(1, n_tok, D) * 0.02)
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.blocks = nn.ModuleList([
            ViTBlock(D, cfg.num_heads, cfg.mlp_ratio,
                     layerscale=cfg.layerscale, exact_gelu=cfg.exact_gelu)
            for _ in range(cfg.depth)])
        self.norm = LayerNorm(D, eps=1e-6)

    def forward(self, x):
        B = x.shape[0]
        dtype = self.patch_embed.weight.dtype
        x = self.patch_embed(x.to(dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)
        if self.cfg.use_cls_token:
            x = torch.cat([self.cls_token.expand(B, 1, -1).to(x.dtype), x],
                          dim=1)
        x = x + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)


def vit_registry(name: str, **overrides) -> ViTConfig:
    presets = {
        'vit-s/16': dict(patch_size=16, embed_dim=384, depth=12,
                         num_heads=6),
        'vit-s/14': dict(patch_size=14, embed_dim=384, depth=12,
                         num_heads=6),
        'vit-b/16': dict(patch_size=16, embed_dim=768, depth=12,
                         num_heads=12),
        'vit-b/14': dict(patch_size=14, embed_dim=768, depth=12,
                         num_heads=12),
        'vit-l/14': dict(patch_size=14, embed_dim=1024, depth=24,
                         num_heads=16),
        # DINOv2 flavours (layerscale + erf-GELU; HF Dinov2Model layout)
        'dinov2-s/14': dict(patch_size=14, embed_dim=384, depth=12,
                            num_heads=6, layerscale=True, exact_gelu=True),
        'dinov2-b/14': dict(patch_size=14, embed_dim=768, depth=12,
                            num_heads=12, layerscale=True, exact_gelu=True),
        'dinov2-l/14': dict(patch_size=14, embed_dim=1024, depth=24,
                            num_heads=16, layerscale=True, exact_gelu=True),
    }
    kw = dict(presets[name])
    kw.update(overrides)
    return ViTConfig(**kw)


# ---------------------------------------------------------------------------
# triplane fusion
# ---------------------------------------------------------------------------

class TriplaneFusionBlock(nn.Module):
    """Fusion step over (B, 3, L, D) triplane tokens: a ``ViTBlock``
    within each plane, then one over all 3L tokens jointly."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.within = ViTBlock(dim, num_heads, mlp_ratio)
        self.across = ViTBlock(dim, num_heads, mlp_ratio)

    def forward(self, x):
        B, n, L, D = x.shape
        h = self.within(x.reshape(B * n, L, D))
        return self.across(h.reshape(B, n * L, D)).reshape(B, n, L, D)


@dataclasses.dataclass(frozen=True)
class TriplaneViTDecoderConfig:
    tokens_per_plane: int = 256
    embed_dim: int = 384
    depth: int = 12               # number of fusion blocks (2 attn each)
    num_heads: int = 6
    mlp_ratio: int = 4
    uvit_skips: bool = True       # long skips second half ← first half
    dtype: Any = torch.float32


class TriplaneViTDecoder(nn.Module):
    """ViT triplane decoder backbone: a sin-cos ``pos_embed`` over the (3,
    L) grid, ``depth`` fusion blocks and, with ``uvit_skips``, long skips
    into the second half (``skip_linear_{i}`` maps [x, skip] to x).
    Tokens (B, 3, L, D) in and out."""

    def __init__(self, cfg: TriplaneViTDecoderConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.pos_embed = nn.Parameter(self._sincos())
        half = cfg.depth // 2
        for i in range(cfg.depth):
            if cfg.uvit_skips and i >= cfg.depth - half:
                self.add_module(f'skip_linear_{i}', nn.Linear(2 * D, D))
            self.add_module(f'fusion_{i}', TriplaneFusionBlock(
                D, cfg.num_heads, cfg.mlp_ratio))

    def _sincos(self):
        n, L, D = 3, self.cfg.tokens_per_plane, self.cfg.embed_dim
        return torch.tensor(get_2d_sincos_pos_embed(D, (n, L))
                            ).reshape(1, n, L, D)

    def reset_free_parameters(self, generator=None):
        self.pos_embed.copy_(self._sincos())

    def forward(self, x):
        cfg = self.cfg
        x = x + self.pos_embed.to(x.dtype)
        half = cfg.depth // 2
        skips = []
        for i in range(cfg.depth):
            if hasattr(self, f'skip_linear_{i}') and skips:
                x = getattr(self, f'skip_linear_{i}')(
                    torch.cat([x, skips.pop()], dim=-1))
            x = getattr(self, f'fusion_{i}')(x)
            if cfg.uvit_skips and i < half:
                skips.append(x)
        return x


# ---------------------------------------------------------------------------
# released ShapeNet/FFHQ decoder: DINOv2 blocks fused in pairs with a
# 3D-aware row/column cross-attention (fusionv4/v5 family)
# ---------------------------------------------------------------------------

class XYGridCrossAttention(nn.Module):
    """3D-aware cross-plane attention over ``(B, 3, N, C)`` tokens: each
    plane-i token at grid (row a, col b) attends to row a of plane
    (i+1)%3 followed by column b of plane (i+2)%3, 2p keys for p² = N.

    ``w_kv`` is per-token linear, so it runs once per plane token and the
    2p-token contexts gather its output (JAX projects the gathered
    contexts: the same products, 2p times fewer of them)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.wq = nn.Linear(dim, dim)
        self.w_kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, n, N, C = x.shape
        p = math.isqrt(N)
        H = self.num_heads
        kv = self.w_kv(x).reshape(B, n, p, p, 2 * C)
        # rows[i, a, b, k] = plane (i+1)%3 at (a, k); cols[i, a, b, k] =
        # plane (i+2)%3 at (k, b)
        rows = kv[:, [1, 2, 0]][:, :, :, None].expand(B, n, p, p, p, 2 * C)
        cols = kv[:, [2, 0, 1]].transpose(2, 3)[:, :, None].expand(
            B, n, p, p, p, 2 * C)
        ctx = torch.cat([rows, cols], dim=4).reshape(B * n * N, 2 * p,
                                                     2 * C)
        k, v = ctx.chunk(2, dim=-1)
        q = self.wq(x).reshape(B * n * N, 1, H, C // H)
        out = dot_product_attention(q, k.reshape(B * n * N, 2 * p, H, -1),
                                    v.reshape(B * n * N, 2 * p, H, -1))
        return self.proj(out.reshape(B, n, N, C))


class DinoFusionBlock(nn.Module):
    """The v4 fusion of two DINOv2 blocks (ShapeNet): block 0 is a stock
    DINOv2 block over each plane; block 1's attention is replaced by a
    residual ``XYGridCrossAttention``::

        h = norm1(x);  a3 = h + attn3d(attn3d_norm(h))
        x = x + gamma1·a3;  x = x + gamma2·mlp(norm2(x))
    """

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.blk0 = ViTBlock(dim, num_heads, mlp_ratio, layerscale=True,
                             exact_gelu=True)
        self.gamma1 = nn.Parameter(torch.full((dim,), 1e-5))
        self.gamma2 = nn.Parameter(torch.full((dim,), 1e-5))
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn3d_norm = LayerNorm(dim, eps=1e-6)
        self.attn3d = XYGridCrossAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = GeluMLP(dim, mlp_ratio, exact_gelu=True)

    def reset_free_parameters(self, generator=None):
        self.gamma1.fill_(1e-5)
        self.gamma2.fill_(1e-5)

    def forward(self, x):
        B, n, N, C = x.shape
        h = self.blk0(x.reshape(B * n, N, C))
        hn3 = self.norm1(h).reshape(B, n, N, C)
        a3 = hn3 + self.attn3d(self.attn3d_norm(hn3))
        h = h + self.gamma1 * a3.reshape(B * n, N, C)
        h = h + self.gamma2 * self.mlp(self.norm2(h))
        return h.reshape(B, n, N, C)


class DinoFusionBlockV3(nn.Module):
    """The v3 fusion (FFHQ): two DINOv2 blocks intact over each plane,
    then one residual ``XYGridCrossAttention`` over all three."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.blk0 = ViTBlock(dim, num_heads, mlp_ratio, layerscale=True,
                             exact_gelu=True)
        self.blk1 = ViTBlock(dim, num_heads, mlp_ratio, layerscale=True,
                             exact_gelu=True)
        self.attn3d_norm = LayerNorm(dim, eps=1e-6)
        self.attn3d = XYGridCrossAttention(dim, num_heads)

    def forward(self, x):
        B, n, N, C = x.shape
        h = self.blk1(self.blk0(x.reshape(B * n, N, C))).reshape(B, n, N, C)
        return h + self.attn3d(self.attn3d_norm(h))


class DinoFusionDecoder(nn.Module):
    """The ViT-triplane decoder backbone of the released ShapeNet/FFHQ
    VAEs: ``depth`` fusion blocks (``block_variant`` 'v4' for ShapeNet,
    'v3' for FFHQ) with uvit long skips into the second half, a sin-cos
    ``pos_embed`` parameter over the (3p, p) grid and a final LayerNorm.
    Tokens ``(B, 3L, D)`` plane-major in and out."""

    def __init__(self, dim: int, depth: int = 6, num_heads: int = 12,
                 tokens_per_plane: int = 256, mlp_ratio: int = 4,
                 block_variant: str = 'v4'):
        super().__init__()
        self.depth = depth
        self.tokens_per_plane = tokens_per_plane
        self.pos_embed = nn.Parameter(self._sincos(dim))
        block = DinoFusionBlockV3 if block_variant == 'v3' else DinoFusionBlock
        half = depth // 2
        for i in range(depth):
            self.add_module(f'block_{i}', block(dim, num_heads, mlp_ratio))
        for i in range(half, depth):
            self.add_module(f'skip_linear_{i}', nn.Linear(2 * dim, dim))
        self.norm = LayerNorm(dim, eps=1e-6)

    def _sincos(self, dim):
        p = math.isqrt(self.tokens_per_plane)
        # torch.tensor, not from_numpy: it follows a torch.device context
        return torch.tensor(get_2d_sincos_pos_embed(dim, (3 * p, p))
                            ).reshape(1, 3 * p * p, dim)

    def reset_free_parameters(self, generator=None):
        self.pos_embed.copy_(self._sincos(self.pos_embed.shape[-1]))

    def forward(self, x):
        B, L3, D = x.shape
        x = (x + self.pos_embed.to(x.dtype)).reshape(B, 3, L3 // 3, D)
        half = self.depth // 2
        blocks = [getattr(self, f'block_{i}') for i in range(self.depth)]
        skips = [x]
        for blk in blocks[:half - 1]:
            x = blk(x)
            skips.append(x)
        x = blocks[half - 1](x)
        for i in range(half, self.depth):
            skip_linear = getattr(self, f'skip_linear_{i}')
            h = torch.cat([x, skips.pop().to(x.dtype)], dim=-1)
            x = x + skip_linear(h.to(skip_linear.weight.dtype))
            x = blocks[i](x)
        return self.norm(x).reshape(B, L3, D)


def unpatchify_triplane(x: torch.Tensor, patch_size: int,
                        out_channels: int) -> torch.Tensor:
    """(B, 3, L, p·p·C) tokens → (B, 3, H, W, C) planes."""
    B, n, L, _ = x.shape
    h = w = math.isqrt(L)
    p = patch_size
    x = x.reshape(B, n, h, w, p, p, out_channels).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, n, h * p, w * p, out_channels)
