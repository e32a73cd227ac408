"""DINO / DINOv2 Vision Transformer.

Port of the encoder of ``ln3diff_tpu/models/vit.py`` (``ViTBlock`` :28,
``ViTConfig`` :58, ``VisionTransformer`` :72, ``vit_registry`` :113): a
pre-LN ViT in the DINO layout, with DINOv2's per-channel layerscale gains
and erf-GELU, over channels-last images.  It is the DINOv2 image embedder
of the image→3D and multi-view→3D paths.  Its blocks reuse the DiT's
``Attention`` and ``GeluMLP``, as in the JAX package.  The triplane
fusion decoders of the same JAX module (other VAE families) are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn as nn

from .dit import Attention, GeluMLP


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
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = GeluMLP(dim, mlp_ratio, exact_gelu=exact_gelu)

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
    """DINO ViT encoder: images (B, H, W, 3) channels-last → normalised
    tokens (B, [1 +] h·w, D), in the module's dtype (``cfg.dtype`` is the
    dtype the caller casts it to)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        D, p = cfg.embed_dim, cfg.patch_size
        self.patch_embed = nn.Conv2d(3, D, p, stride=p)
        n_tok = (cfg.img_size // p)**2 + (1 if cfg.use_cls_token else 0)
        self.pos_embed = nn.Parameter(torch.randn(1, n_tok, D) * 0.02)
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.blocks = nn.ModuleList([
            ViTBlock(D, cfg.num_heads, cfg.mlp_ratio,
                     layerscale=cfg.layerscale, exact_gelu=cfg.exact_gelu)
            for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(D, eps=1e-6)

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
