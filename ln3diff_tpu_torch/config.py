"""The presets of the text→3D serving path, as plain dataclasses.

The port's copy of three presets of ``ln3diff_tpu/config.py`` (that
module imports JAX and every model): the Objaverse render options
(``RENDER_PRESETS['objverse_tuneray_aug_resolution_64_64_auto']`` :35),
the Objaverse VAE (``vae_preset('objaverse')`` :167-186) and the text→3D
denoiser (``denoiser_preset('t23d-dit-l2')`` :250-252).
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
    """Decode side of the released Objaverse VAE: DiT2-L/2 backbone over
    16² tokens per plane, SD-Decoder upsampler to (3, 128, 128, 32)
    planes."""
    if name != 'objaverse':
        raise KeyError(name)
    return TriplaneVAEConfig(
        ldm_z_channels=4, latent_size=32,
        dit2=dit2_registry('DiT2-L/2', tokens_per_plane=256, dtype=dtype),
        patch_size=2, conv_sr_ch=32, conv_sr_ch_mult=(1, 2, 2, 4),
        conv_sr_res_blocks=1, plane_channels=32, decoder_output_dim=32,
        dtype=dtype)


def denoiser_preset(name: str, dtype=torch.bfloat16) -> DiTConfig:
    """Stage-2 denoiser of the released Objaverse text→3D checkpoint."""
    if name != 't23d-dit-l2':
        raise KeyError(name)
    return dit_registry('DiT-L/2', input_size=32, in_channels=4,
                        dtype=dtype)
