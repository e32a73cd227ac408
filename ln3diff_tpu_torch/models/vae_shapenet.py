"""The released ShapeNet (fusionv5) and FFHQ (4XC_final) VAEs.

Port of ``ln3diff_tpu/models/vae_shapenet.py`` (``ShapeNetVAEConfig`` :44,
``ShapeNetVAE`` :81, ``FFHQVAEConfig`` :201, ``FFHQVAE`` :239):

  * encoder (built on request): DINOv2 ViT-S/14 → patch tokens (class
    token dropped) → ``ldm_downsample`` Linear → unpatchify3D → grouped
    ``quant_conv`` → moments viewed (2z, 3), plane fastest;
  * decode: ``ldm_upsample`` (ShapeNet: the grouped PatchEmbedTriplane
    conv, its channels viewed (D, 3); FFHQ: a per-token Linear on the
    latent viewed (z, 3)) → ``DinoFusionDecoder`` (v4 / v3) →
    ``decoder_pred`` → unpatchify → ``RodinConv3D4XResidual`` (lite /
    non-lite) → planes (B, 3, 256, 256, 32);
  * render, point queries, the reparameterisation and the end-to-end
    ``forward`` are :class:`TriplaneVAE`'s, with the ``'nearest'``
    (ShapeNet) or ``'stylegan-8xdc'`` (FFHQ) SR head.

The reference's channel interleaves are reproduced exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn as nn

from .osg_decoder import OSGDecoder
from .rodin import RodinConv3D4XResidual
from .vae import TriplaneVAE
from .vit import DinoFusionDecoder, ViTConfig, VisionTransformer, vit_registry


@dataclasses.dataclass(frozen=True)
class ShapeNetVAEConfig:
    # encoder (DINOv2 ViT-S/14 @ 224)
    encoder_vit: ViTConfig = vit_registry('dinov2-s/14')
    # bottleneck
    ldm_z_channels: int = 4
    vae_p: int = 2                     # unpatchify3D patch
    token_size: int = 16               # encoder grid 16x16 (224/14)
    patch_size: int = 2                # ldm_upsample patch embed
    # fusion decoder (DINOv2 ViT-B pairs → 6 fusion blocks)
    decoder_embed_dim: int = 768
    decoder_fusion_depth: int = 6
    decoder_num_heads: int = 12
    # head
    channel_multiplier: int = 4
    unpatchify_p: int = 4
    plane_channels: int = 32
    triplane_resolution: int = 256
    decoder_output_dim: int = 32
    # render-space SR (TriplaneVAE's render)
    use_sr: bool = True
    sr_ratio: int = 2
    sr_module: str = 'nearest'
    use_background: bool = False
    dtype: Any = torch.float32

    @property
    def latent_size(self) -> int:
        return self.token_size * self.vae_p      # 32

    @property
    def latent_channels(self) -> int:
        return 3 * self.ldm_z_channels


@dataclasses.dataclass(frozen=True)
class FFHQVAEConfig:
    """DINOv2-S/14 encoder, per-token Linear ``ldm_upsample`` (vae_p 1,
    latent 16x16x12), v3 fusion decoder, non-lite Rodin SR, 128² renders
    and ``SuperresolutionHybrid8XDC`` to 512²."""
    encoder_vit: ViTConfig = vit_registry('dinov2-s/14')
    ldm_z_channels: int = 4
    vae_p: int = 1
    token_size: int = 16
    decoder_embed_dim: int = 768
    decoder_fusion_depth: int = 6
    decoder_num_heads: int = 12
    channel_multiplier: int = 4
    unpatchify_p: int = 4
    plane_channels: int = 32
    triplane_resolution: int = 256
    decoder_output_dim: int = 32
    use_sr: bool = True
    sr_ratio: int = 4
    sr_module: str = 'stylegan-8xdc'
    use_background: bool = False
    dtype: Any = torch.float32

    @property
    def latent_size(self) -> int:
        return self.token_size * self.vae_p      # 16

    @property
    def latent_channels(self) -> int:
        return 3 * self.ldm_z_channels


def _cast_layers(module: nn.Module, dtype) -> None:
    """Store the Linear, conv and norm layers of ``module`` in ``dtype``;
    free parameters (sin-cos tables, the fusion blocks' gains) stay f32,
    as JAX keeps them, and are cast where they are used."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.LayerNorm)):
            m.to(dtype)


class ShapeNetVAE(TriplaneVAE):
    """The fusionv5 VAE.  ``encoder=True`` builds the DINOv2 encoder,
    ``ldm_downsample`` and ``quant_conv`` too; the default builds the
    decode side (the parameters that JAX's ``init_decoder_paths``
    creates)."""

    block_variant = 'v4'
    lite_sr = True

    def __init__(self, cfg, encoder: bool = False):
        # not TriplaneVAE.__init__: the decoder here is no DiT2 + SD Decoder
        nn.Module.__init__(self)
        self.cfg = cfg
        D = cfg.decoder_embed_dim
        self._build_upsample()
        self.fusion_decoder = DinoFusionDecoder(
            D, depth=cfg.decoder_fusion_depth,
            num_heads=cfg.decoder_num_heads,
            tokens_per_plane=self._tokens_per_plane(),
            block_variant=self.block_variant)
        C = cfg.plane_channels * cfg.channel_multiplier
        self.decoder_pred = nn.Linear(D, cfg.unpatchify_p**2 * C)
        self.conv_sr = RodinConv3D4XResidual(
            3 * C, 3 * cfg.plane_channels,
            input_resolution=cfg.triplane_resolution, lite=self.lite_sr)
        self.osg_decoder = OSGDecoder(
            in_features=cfg.plane_channels,
            decoder_output_dim=cfg.decoder_output_dim)
        self._build_sr_head()
        if encoder:
            self._build_encoder()

    def _tokens_per_plane(self) -> int:
        return (self.cfg.latent_size // self.cfg.patch_size)**2

    def _build_upsample(self):
        """The grouped PatchEmbedTriplane conv over the latent."""
        cfg = self.cfg
        self.ldm_upsample = nn.Conv2d(
            cfg.latent_channels, 3 * cfg.decoder_embed_dim, cfg.patch_size,
            stride=cfg.patch_size, groups=3)

    def _build_encoder(self):
        cfg = self.cfg
        z2 = 2 * cfg.ldm_z_channels
        self.encoder = VisionTransformer(cfg.encoder_vit)
        self.ldm_downsample = nn.Linear(cfg.encoder_vit.embed_dim,
                                        cfg.vae_p**2 * 3 * z2)
        self.quant_conv = nn.Conv2d(3 * z2, 3 * z2, 1, groups=3)

    def cast_decoder(self) -> 'ShapeNetVAE':
        """Store the decoder's layers and a ``NearestConvSR`` head in
        ``cfg.dtype`` (serving); see :func:`_cast_layers`."""
        for m in (self.ldm_upsample, self.fusion_decoder, self.decoder_pred,
                  self.conv_sr):
            _cast_layers(m, self.cfg.dtype)
        if self.cfg.sr_module == 'nearest' and self.cfg.use_sr:
            self.superresolution.to(self.cfg.dtype)
        return self

    # -- encoder ----------------------------------------------------------

    def _tokens(self, imgs):
        tokens = self.encoder(imgs)
        if self.cfg.encoder_vit.use_cls_token:
            tokens = tokens[:, 1:]
        return self.ldm_downsample(tokens)

    def encode(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, 224, 224, 3) → moments (B, 32, 32, 2z, 3)."""
        cfg = self.cfg
        z2, p, t = 2 * cfg.ldm_z_channels, cfg.vae_p, cfg.token_size
        lat = self._tokens(imgs)                       # (B, t·t, p·p·3·2z)
        B = lat.shape[0]
        # unpatchify3D: token grid (t, t), patch (p, p), planes, channels →
        # plane-major channels over (t·p)²
        lat = lat.reshape(B, t, t, p, p, 3, z2).permute(0, 5, 6, 1, 3, 2, 4)
        lat = lat.reshape(B, 3 * z2, t * p, t * p)
        moments = self.quant_conv(lat).permute(0, 2, 3, 1)
        # the grouped conv's plane-major channels viewed (2z, 3)
        return moments.reshape(B, t * p, t * p, z2, 3)

    # -- decoder ----------------------------------------------------------

    def _decode_tokens(self, latent):
        """latent (B, h, w, z·3) → plane-major tokens (B, 3L, D) and the
        token grid side."""
        B = latent.shape[0]
        D = self.cfg.decoder_embed_dim
        x = latent.permute(0, 3, 1, 2).to(self.ldm_upsample.weight.dtype)
        tok = self.ldm_upsample(x)                     # (B, 3D, th, tw)
        th, tw = tok.shape[2:]
        # channels (grouped by plane) viewed (D, 3) → plane-major tokens
        tok = tok.reshape(B, D, 3, th * tw).permute(0, 2, 3, 1)
        return tok.reshape(B, 3 * th * tw, D), th

    def decode_latent(self, latent: torch.Tensor) -> torch.Tensor:
        """latent (B, h, w, z·3) → planes (B, 3, R, R, C)."""
        cfg = self.cfg
        B = latent.shape[0]
        tok, h = self._decode_tokens(latent)
        lat = self.decoder_pred(self.fusion_decoder(tok))   # (B, 3L, p²·C')
        p = cfg.unpatchify_p
        C = cfg.plane_channels * cfg.channel_multiplier
        lat = lat.reshape(B, 3, h, h, p, p, C).permute(0, 2, 4, 3, 5, 1, 6)
        planes = self.conv_sr(lat.reshape(B, h * p, h * p, 3 * C))
        R = planes.shape[1]
        planes = planes.reshape(B, R, R, 3, cfg.plane_channels)
        return planes.permute(0, 3, 1, 2, 4)


class FFHQVAE(ShapeNetVAE):
    """4XC_final: the decode path mirrors the reference.  The reference's
    own encode path is dead code, so ``encode`` follows the fusionv5
    structure (grouped ``quant_conv`` over the plane-major
    ``ldm_downsample`` output), as in JAX."""

    block_variant = 'v3'
    lite_sr = False

    def _tokens_per_plane(self) -> int:
        return self.cfg.latent_size**2

    def _build_upsample(self):
        """A per-token Linear over the latent's z channels."""
        self.ldm_upsample = nn.Linear(self.cfg.ldm_z_channels,
                                      self.cfg.decoder_embed_dim)

    def encode(self, imgs: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        z2, t = 2 * cfg.ldm_z_channels, cfg.token_size
        lat = self._tokens(imgs)                       # (B, t·t, 3·2z)
        B = lat.shape[0]
        lat = lat.reshape(B, t, t, 3 * z2).permute(0, 3, 1, 2)
        moments = self.quant_conv(lat).permute(0, 2, 3, 1)
        return moments.reshape(B, t, t, z2, 3)

    def _decode_tokens(self, latent):
        """The latent viewed (z, 3) → plane-major tokens of z features →
        the per-token Linear."""
        B, hh, ww, _ = latent.shape
        z = self.cfg.ldm_z_channels
        tok = latent.reshape(B, hh * ww, z, 3).permute(0, 3, 1, 2)
        tok = tok.reshape(B, 3 * hh * ww, z)
        return self.ldm_upsample(tok.to(self.ldm_upsample.weight.dtype)), hh
