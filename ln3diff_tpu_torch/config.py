"""The presets of the Objaverse serving paths and the VAE trainer, as
plain dataclasses.

The port's copy of the presets of ``ln3diff_tpu/config.py`` (that module
imports JAX and every model) that those paths use: the Objaverse render
options (``RENDER_PRESETS['objverse_tuneray_aug_resolution_64_64_auto']``
:35), the Objaverse VAE (``vae_preset('objaverse')`` :167-186, encoder
fields included) and the denoisers of the text→3D, image→3D and
multi-view→3D checkpoints (``denoiser_preset`` :250-262).
"""

from __future__ import annotations

import torch

from .models.dit import DiTConfig, dit2_registry, dit_registry
from .models.vae import TriplaneVAEConfig
from .render.renderer import RenderOptions

RENDER_PRESETS: dict[str, RenderOptions] = {
    # Objaverse release cfg (reference nsr/script_util.py:761-797)
    'objverse_tuneray_aug_resolution_64_64_auto': RenderOptions(
        depth_resolution=64, depth_resolution_importance=64,
        ray_start='auto', ray_end='auto', box_warp=0.9, white_back=True,
        filter_out_of_bbox=True, sampler_bbox_min=-0.45,
        sampler_bbox_max=0.45),
}


def vae_preset(name: str = 'objaverse',
               dtype=torch.bfloat16) -> TriplaneVAEConfig:
    """The released Objaverse VAE: SD MVEncoder over 4 views of 256² ×
    10 channels, DiT2-L/2 backbone over 16² tokens per plane, SD-Decoder
    upsampler to (3, 128, 128, 32) planes."""
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


def denoiser_preset(name: str, dtype=torch.bfloat16) -> DiTConfig:
    """Stage-2 denoisers of the released Objaverse checkpoints."""
    registry_names = {
        't23d-dit-l2': 'DiT-L/2',               # text→3D, DDPM
        'i23d-pixart-l2': 'DiT-I23D-L/2',       # image→3D, flow matching
        # multi-view→3D, flow matching: flattened multi-view DINO tokens
        # through the cross-attention (sample_obajverse_mv23d_dit.sh:88)
        'mv23d-dit-l2': 'DiT-PixArt-MV-L/2',
    }
    return dit_registry(registry_names[name], input_size=32, in_channels=4,
                        dtype=dtype)
