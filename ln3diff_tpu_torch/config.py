"""The presets of the serving paths and the VAE trainer, as plain
dataclasses.

The port's copy of the presets of ``ln3diff_tpu/config.py`` (that module
imports JAX and every model) that those paths use: the render options of
the Objaverse, ShapeNet and FFHQ releases (``RENDER_PRESETS`` :35-54), the
evaluation cameras (``CAMERA_PRESETS`` :156-160), the Objaverse, ShapeNet,
FFHQ and fg/bg FFHQ VAEs (``vae_preset`` :167-232, encoder fields
included),
``build_vae`` (:236) and the denoisers of the text→3D, image→3D,
multi-view→3D and ShapeNet/FFHQ checkpoints (``denoiser_preset``
:250-270).
"""

from __future__ import annotations

import torch

from .models.dit import DiTConfig, dit2_registry, dit_registry
from .models.unet import UNetConfig
from .models.vae import TriplaneVAE, TriplaneVAEConfig
from .models.vae_shapenet import (FFHQVAE, FFHQVAEConfig, ShapeNetVAE,
                                  ShapeNetVAEConfig)
from .models.vit import vit_registry
from .render.renderer import RenderOptions

RENDER_PRESETS: dict[str, RenderOptions] = {
    # Objaverse release cfg (reference nsr/script_util.py:761-797)
    'objverse_tuneray_aug_resolution_64_64_auto': RenderOptions(
        depth_resolution=64, depth_resolution_importance=64,
        ray_start='auto', ray_end='auto', box_warp=0.9, white_back=True,
        filter_out_of_bbox=True, sampler_bbox_min=-0.45,
        sampler_bbox_max=0.45),
    # ShapeNet release cfg (:679-699); ray_start/end 0.6/1.8 from the
    # release scripts (radius 1.2, box_warp = end - start)
    'shapenet_tuneray_aug_resolution_64_64_nearestSR': RenderOptions(
        depth_resolution=64, depth_resolution_importance=64,
        ray_start=0.6, ray_end=1.8, box_warp=1.2, white_back=True),
    # FFHQ (:466-489): 48+48 samples, fixed near and far
    'ffhq': RenderOptions(
        depth_resolution=48, depth_resolution_importance=48,
        ray_start=2.25, ray_end=3.3, box_warp=1.0, white_back=False),
}

# per-dataset evaluation orbits (radius, fov, pitch)
CAMERA_PRESETS = {
    'objaverse': dict(radius=1.8, fov=30.0, pitch_deg=20.0),
    'shapenet': dict(radius=1.2, fov=50.0, pitch_deg=20.0),
    'ffhq': dict(radius=2.7, fov=12.6, pitch_deg=0.0),
}


def vae_preset(name: str = 'objaverse', dtype=torch.bfloat16):
    """The released VAEs.  'objaverse': SD MVEncoder over 4 views of 256²
    × 10 channels, DiT2-L/2 backbone over 16² tokens per plane, SD-Decoder
    upsampler to (3, 128, 128, 32) planes.  'shapenet' (fusionv5):
    DINOv2-S/14 encoder, v4 DINOv2-B pair-fusion decoder with uvit skips,
    lite Rodin 4X SR to (3, 256, 256, 32) planes, ``NearestConvSR`` render
    SR.  'ffhq' (4XC_final): per-token Linear ``ldm_upsample`` over the
    16x16x12 latent, v3 fusion decoder, non-lite Rodin SR,
    ``SuperresolutionHybrid8XDC`` to 512².  'ffhq-fgbg' (the reference's
    ``Triplane_fg_bg_plane``, not on the released path): mono SD encoder
    over 256² RGB, DiT2-B/2, (3, 128, 128, 64) planes split 32 fg | 32 bg,
    a NeRF++ background of 16 samples per ray and ``SuperresolutionHybrid``
    (×4)."""
    if name == 'ffhq-fgbg':
        return TriplaneVAEConfig(
            encoder_in_channels=3, encoder_ch=64,
            encoder_ch_mult=(1, 2, 4, 4), encoder_res_blocks=1,
            img_resolution=256, num_views=0, ldm_z_channels=4,
            latent_size=32,
            dit2=dit2_registry('DiT2-B/2', tokens_per_plane=256,
                               dtype=dtype),
            patch_size=2, conv_sr_ch=32, conv_sr_ch_mult=(1, 2, 2, 4),
            conv_sr_res_blocks=1, plane_channels=64, decoder_output_dim=32,
            use_sr=True, sr_ratio=4, sr_module='stylegan',
            use_background=True, bg_depth_resolution=16, dtype=dtype)
    if name == 'shapenet':
        return ShapeNetVAEConfig(
            encoder_vit=vit_registry('dinov2-s/14', img_size=224,
                                     dtype=dtype),
            ldm_z_channels=4, vae_p=2, token_size=16, patch_size=2,
            decoder_embed_dim=768, decoder_fusion_depth=6,
            decoder_num_heads=12, channel_multiplier=4, unpatchify_p=4,
            plane_channels=32, triplane_resolution=256,
            decoder_output_dim=32, use_sr=True, sr_ratio=2, dtype=dtype)
    if name == 'ffhq':
        return FFHQVAEConfig(
            encoder_vit=vit_registry('dinov2-s/14', img_size=224,
                                     dtype=dtype),
            ldm_z_channels=4, vae_p=1, token_size=16,
            decoder_embed_dim=768, decoder_fusion_depth=6,
            decoder_num_heads=12, channel_multiplier=4, unpatchify_p=4,
            plane_channels=32, triplane_resolution=256,
            decoder_output_dim=32, dtype=dtype)
    if name != 'objaverse':
        raise KeyError(name)
    return TriplaneVAEConfig(
        encoder_in_channels=10, encoder_ch=64, encoder_ch_mult=(1, 2, 4, 4),
        encoder_res_blocks=1, img_resolution=256, num_views=4,
        ldm_z_channels=4, latent_size=32,
        dit2=dit2_registry('DiT2-L/2', tokens_per_plane=256, dtype=dtype),
        patch_size=2, conv_sr_ch=32, conv_sr_ch_mult=(1, 2, 2, 4),
        conv_sr_res_blocks=1, plane_channels=32, decoder_output_dim=32,
        dtype=dtype)


def build_vae(cfg, encoder: bool = False) -> TriplaneVAE:
    """The VAE module of a preset config: ``ShapeNetVAE``, ``FFHQVAE`` or
    ``TriplaneVAE``."""
    if isinstance(cfg, FFHQVAEConfig):
        return FFHQVAE(cfg, encoder=encoder)
    if isinstance(cfg, ShapeNetVAEConfig):
        return ShapeNetVAE(cfg, encoder=encoder)
    return TriplaneVAE(cfg, encoder=encoder)


def denoiser_preset(name: str, dtype=torch.bfloat16):
    """Stage-2 denoisers of the released checkpoints: a ``DiTConfig`` for
    the Objaverse families, the ``UNetConfig`` of the ShapeNet/FFHQ LSGM
    U-Net-320 for 'shapenet-unet' (release flags: 320 channels, attention
    at downsample rate 8 of the 32² input, channel_mult (1, 2, 4, 4))."""
    if name == 'shapenet-unet':
        return UNetConfig(in_channels=4, model_channels=320, out_channels=4,
                          num_res_blocks=2, attention_resolutions=(8,),
                          channel_mult=(1, 2, 4, 4), num_heads=8,
                          use_spatial_transformer=True, context_dim=768,
                          roll_out=True, mixed_prediction=True, dtype=dtype)
    registry_names = {
        't23d-dit-l2': 'DiT-L/2',               # text→3D, DDPM
        'i23d-pixart-l2': 'DiT-I23D-L/2',       # image→3D, flow matching
        # multi-view→3D, flow matching: flattened multi-view DINO tokens
        # through the cross-attention (sample_obajverse_mv23d_dit.sh:88)
        'mv23d-dit-l2': 'DiT-PixArt-MV-L/2',
    }
    return dit_registry(registry_names[name], input_size=32, in_channels=4,
                        dtype=dtype)
