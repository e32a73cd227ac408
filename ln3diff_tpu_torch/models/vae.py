"""Stage-1 triplane VAE, decode side: latent → planes → volume render and
point queries.

Port of ``ln3diff_tpu/models/vae.py`` (``decode_latent`` :213-238,
``_fused_osg`` :245-251, ``render`` :253-306, ``query_points`` :359-378).
The encoder, the KL bottleneck and the render-space SR heads wait for
later slices.

Latent layout ``(B, h, w, z*3)`` channels-last with plane fastest, and the
absorbed channel interleaves of the reference are reproduced exactly: the
grouped ``ldm_upsample`` consumes the raw z*3+p channels and its
plane-grouped output channels are viewed as (D, plane) with plane fastest.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn as nn

from ..ops.fused_render import FusedOSG, fused_osg_from_params
from ..render.ray_sampler import sample_full_rays, unpack_25d_camera
from ..render.renderer import (RenderOptions, pack_corner_table,
                               packed_gather, project_onto_planes,
                               render_rays, sample_from_planes)
from .dit import DiT2, DiT2Config
from .osg_decoder import OSGDecoder
from .sd_vae import AutoencoderConfig, Decoder


@dataclasses.dataclass(frozen=True)
class TriplaneVAEConfig:
    """Decode-side fields of the JAX ``TriplaneVAEConfig``."""
    ldm_z_channels: int = 4            # per-plane latent channels
    latent_size: int = 32              # latent h = w
    dit2: DiT2Config = DiT2Config()
    patch_size: int = 2
    conv_sr_ch: int = 32
    conv_sr_ch_mult: tuple = (1, 2, 2, 4)
    conv_sr_res_blocks: int = 1
    plane_channels: int = 32
    decoder_output_dim: int = 32
    dtype: Any = torch.float32

    @property
    def plane_resolution(self) -> int:
        up = 2**(len(self.conv_sr_ch_mult) - 1)
        return (self.latent_size // self.patch_size) * up

    @property
    def latent_channels(self) -> int:
        return 3 * self.ldm_z_channels


class TriplaneVAE(nn.Module):
    """Decode side of the triplane VAE.

    ``cfg.dtype`` is the compute dtype of ``decode_latent``; call
    :meth:`cast_decoder` to store the decoder backbone in it (the point
    decoder stays f32, as the fused kernel takes f32 weights).
    """

    def __init__(self, cfg: TriplaneVAEConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.dit2.hidden_size
        # grouped patch embed (reference PatchEmbedTriplane)
        self.ldm_upsample = nn.Conv2d(
            cfg.latent_channels, 3 * D, cfg.patch_size,
            stride=cfg.patch_size, groups=3)
        self.dit2 = DiT2(cfg.dit2)
        self.conv_sr = Decoder(AutoencoderConfig(
            ch=cfg.conv_sr_ch, ch_mult=tuple(cfg.conv_sr_ch_mult),
            num_res_blocks=cfg.conv_sr_res_blocks, z_channels=D,
            out_ch=cfg.plane_channels))
        self.osg_decoder = OSGDecoder(
            in_features=cfg.plane_channels,
            decoder_output_dim=cfg.decoder_output_dim)

    def cast_decoder(self) -> 'TriplaneVAE':
        """Store ``ldm_upsample``, ``dit2`` and ``conv_sr`` in
        ``cfg.dtype``."""
        for m in (self.ldm_upsample, self.dit2, self.conv_sr):
            m.to(self.cfg.dtype)
        return self

    # -- decoder ----------------------------------------------------------

    def decode_latent(self, latent: torch.Tensor) -> torch.Tensor:
        """latent (B, h, w, z*3) → planes (B, 3, Hp, Wp, C)."""
        cfg = self.cfg
        B = latent.shape[0]
        x = latent.permute(0, 3, 1, 2).to(self.ldm_upsample.weight.dtype)
        tok = self.ldm_upsample(x).permute(0, 2, 3, 1)   # (B, th, tw, 3D)
        th, tw = tok.shape[1], tok.shape[2]
        D = cfg.dit2.hidden_size
        # channels viewed as (D, plane) → plane-major tokens
        tok = tok.reshape(B, th * tw, D, 3).permute(0, 3, 1, 2)
        tok = tok.reshape(B, 3 * th * tw, D)
        tok = self.dit2(tok)
        planes = self.conv_sr(tok.reshape(B * 3, th, tw, D))
        Hp, Wp, C = planes.shape[1:]
        return planes.reshape(B, 3, Hp, Wp, C)

    # -- rendering --------------------------------------------------------

    def fused_osg(self) -> FusedOSG:
        """The fused point pipeline built from this module's OSG weights."""
        dec = self.osg_decoder
        return fused_osg_from_params(dec.state_dict(),
                                     lr_multiplier=dec.decoder_lr_mul,
                                     activation=dec.activation)

    def render(self, planes: torch.Tensor, camera25: torch.Tensor,
               render_opts: RenderOptions, resolution: int,
               use_fused_osg: bool = False) -> dict:
        """Volume-render planes for 25-dim cameras.  Returns image_raw
        (B, res, res, 3), feature_image, image_depth, image_mask."""
        cam2world, intrinsics = unpack_25d_camera(camera25)
        ray_origins, ray_directions = sample_full_rays(cam2world, intrinsics,
                                                       resolution)
        out = render_rays(planes, self.osg_decoder, ray_origins,
                          ray_directions, render_opts,
                          fused_osg=self.fused_osg() if use_fused_osg
                          else None)
        B = ray_origins.shape[0]
        feature_image = out.feature_samples.reshape(B, resolution,
                                                    resolution, -1)
        depth_image = out.depth_samples.reshape(B, resolution, resolution, 1)
        weights = out.weights_samples.reshape(B, resolution, resolution, 1)
        return dict(feature_image=feature_image,
                    image_raw=feature_image[..., :3],
                    image_depth=depth_image,
                    image_mask=weights * 1.002 - 0.001)

    # -- point queries (mesh extraction) ----------------------------------

    def query_points(self, planes: torch.Tensor, coords: torch.Tensor,
                     box_warp: float, use_fused_osg: bool = False):
        """σ/rgb at world coords (B, M, 3) → (rgb, sigma)."""
        if use_fused_osg:
            H, W = planes.shape[2:4]
            packed = pack_corner_table(planes)
            proj = project_onto_planes((2.0 / box_warp) * coords)
            rows, tx, ty, live = packed_gather(packed, proj, H, W)
            return self.fused_osg()(rows, tx, ty, live)
        feats = sample_from_planes(planes, coords, box_warp)
        return self.osg_decoder(feats, None)
