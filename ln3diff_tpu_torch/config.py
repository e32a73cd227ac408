"""The presets of the serving paths, the trainers and the release
scripts, as plain dataclasses.

The port's copy of ``ln3diff_tpu/config.py`` (that module imports JAX and
every model): the render options of every reference preset
(``RENDER_PRESETS`` :33-133), the evaluation cameras
(``CAMERA_PRESETS`` :156-160), the Objaverse (DiT2-L/2 and the smaller
'objaverse-s', DiT2-B/2), ShapeNet, FFHQ and fg/bg FFHQ VAEs
(``vae_preset`` :167-232, encoder fields included), ``build_vae`` (:236),
the denoisers of the text→3D, image→3D, multi-view→3D and ShapeNet/FFHQ
checkpoints (``denoiser_preset`` :250-270), one entry per release script
(``RELEASE_PRESETS`` :280-354, ``release_preset`` :356), the
``ExperimentConfig`` of the CLIs (:372) and its argparse helpers
(``add_config_to_argparser``, ``args_to_config``, ``add_preset_argument``
:404-449).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

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
    'objverse_tuneray_aug_resolution_128_128_auto': RenderOptions(
        depth_resolution=128, depth_resolution_importance=128,
        ray_start='auto', ray_end='auto', box_warp=0.9, white_back=True,
        filter_out_of_bbox=True, sampler_bbox_min=-0.45,
        sampler_bbox_max=0.45),
    # ShapeNet release cfg (:679-699); ray_start/end 0.6/1.8 from the
    # release scripts (radius 1.2, box_warp = end - start).
    'shapenet_tuneray_aug_resolution_64_64_nearestSR': RenderOptions(
        depth_resolution=64, depth_resolution_importance=64,
        ray_start=0.6, ray_end=1.8, box_warp=1.2, white_back=True),
    # FFHQ (:466-489): 48+48 fg (16 bg samples handled by the fg/bg
    # renderer variant), fixed near/far.
    'ffhq': RenderOptions(
        depth_resolution=48, depth_resolution_importance=48,
        ray_start=2.25, ray_end=3.3, box_warp=1.0, white_back=False),
    # AFHQ (:490-503): same camera/near/far as FFHQ, Hybrid8X SR head.
    'afhq': RenderOptions(
        depth_resolution=48, depth_resolution_importance=48,
        ray_start=2.25, ray_end=3.3, box_warp=1.0, white_back=False),
    # Legacy fixed-ray ShapeNet (:504-518).
    'shapenet': RenderOptions(
        depth_resolution=64, depth_resolution_importance=64,
        ray_start=0.2, ray_end=2.2, box_warp=2.0, white_back=True),
    # EG3D-rendered ShapeNet family (:519-566): radius-1.2 orbit,
    # near/far 0.1/1.9, box_warp 1.1; depth-resolution ladder.
    'eg3d_shapenet_aug_resolution': RenderOptions(
        depth_resolution=80, depth_resolution_importance=80,
        ray_start=0.1, ray_end=1.9, box_warp=1.1, white_back=True),
    'eg3d_shapenet_aug_resolution_chair': RenderOptions(
        depth_resolution=96, depth_resolution_importance=96,
        ray_start=0.1, ray_end=1.9, box_warp=1.1, white_back=True),
    'eg3d_shapenet_aug_resolution_chair_128': RenderOptions(
        depth_resolution=128, depth_resolution_importance=128,
        ray_start=0.1, ray_end=1.9, box_warp=1.1, white_back=True),
    'eg3d_shapenet_aug_resolution_chair_64': RenderOptions(
        depth_resolution=64, depth_resolution_importance=64,
        ray_start=0.1, ray_end=1.9, box_warp=1.1, white_back=True),
    # (:579-599) — same rays as chair_128; Residual SR head (see
    # RENDER_PRESET_SR).
    'eg3d_shapenet_aug_resolution_chair_128_residualSR': RenderOptions(
        depth_resolution=128, depth_resolution_importance=128,
        ray_start=0.1, ray_end=1.9, box_warp=1.1, white_back=True),
    # SRN-rendered chairs (:567-578): radius-2 orbit.
    'srn_shapenet_aug_resolution_chair_128': RenderOptions(
        depth_resolution=128, depth_resolution_importance=128,
        ray_start=1.25, ray_end=2.75, box_warp=1.5, white_back=True),
    # 'tuneray' family (:600-730,870-931): near/far come from the shell
    # scripts (--ray_start 0.6 --ray_end 1.8, radius 1.2; box_warp =
    # end - start); only the sample-count ladder and SR head differ.
    'shapenet_tuneray': RenderOptions(
        depth_resolution=64, depth_resolution_importance=64,
        ray_start=0.6, ray_end=1.8, box_warp=1.2, white_back=True),
    'shapenet_tuneray_aug_resolution': RenderOptions(
        depth_resolution=80, depth_resolution_importance=80,
        ray_start=0.6, ray_end=1.8, box_warp=1.2, white_back=True),
    'shapenet_tuneray_aug_resolution_64': RenderOptions(
        depth_resolution=128, depth_resolution_importance=128,
        ray_start=0.6, ray_end=1.8, box_warp=1.2, white_back=True),
    'shapenet_tuneray_aug_resolution_64_96': RenderOptions(
        depth_resolution=96, depth_resolution_importance=96,
        ray_start=0.6, ray_end=1.8, box_warp=1.2, white_back=True),
    'shapenet_tuneray_aug_resolution_64_96_nearestSR': RenderOptions(
        depth_resolution=96, depth_resolution_importance=96,
        ray_start=0.6, ray_end=1.8, box_warp=1.2, white_back=True),
    'shapenet_tuneray_aug_resolution_64_96_nearestResidualSR':
        RenderOptions(
            depth_resolution=96, depth_resolution_importance=96,
            ray_start=0.6, ray_end=1.8, box_warp=1.2, white_back=True),
    'shapenet_tuneray_aug_resolution_64_64_nearestResidualSR':
        RenderOptions(
            depth_resolution=64, depth_resolution_importance=64,
            ray_start=0.6, ray_end=1.8, box_warp=1.2, white_back=True),
    'shapenet_tuneray_aug_resolution_64_104': RenderOptions(
        depth_resolution=104, depth_resolution_importance=104,
        ray_start=0.6, ray_end=1.8, box_warp=1.2, white_back=True),
    # (:702-730) — identical geometry to 64_64_nearestSR; patch-ray
    # sampling is a trainer knob here (VAETrainConfig
    # .patch_rendering_resolution), not a render option.
    'shapenet_tuneray_aug_resolution_64_64_nearestSR_patch':
        RenderOptions(
            depth_resolution=64, depth_resolution_importance=64,
            ray_start=0.6, ray_end=1.8, box_warp=1.2, white_back=True),
    # (:731-760) objaverse with fixed rays + NearestConvSR (pre-'auto'
    # cfg; radius 1.946 orbit).
    'objverse_tuneray_aug_resolution_64_64_nearestSR': RenderOptions(
        depth_resolution=64, depth_resolution_importance=64,
        ray_start=0.6, ray_end=1.8, box_warp=1.2, white_back=True),
    # (:838-869) 96-sample variant of the released auto cfg.
    'objverse_tuneray_aug_resolution_96_96_auto': RenderOptions(
        depth_resolution=96, depth_resolution_importance=96,
        ray_start='auto', ray_end='auto', box_warp=0.9, white_back=True,
        filter_out_of_bbox=True, sampler_bbox_min=-0.45,
        sampler_bbox_max=0.45),
}

# Which render-space SR head the reference couples to each preset
# (``superresolution_module`` in rendering_options_defaults; the VAE
# configs hold the SR choice, and this map documents the pairing for
# preset-faithful assembly).  Presets absent here use the table default
# NearestConvSR (nsr/script_util.py:496).
RENDER_PRESET_SR = {
    'ffhq': 'stylegan-8xdc',          # SuperresolutionHybrid8XDC
    'afhq': 'stylegan-8x',            # SuperresolutionHybrid8X
    'eg3d_shapenet_aug_resolution_chair_128_residualSR':
        'nearest-conv-residual',
    'shapenet_tuneray_aug_resolution_64_96_nearestResidualSR':
        'nearest-conv-residual',
    'shapenet_tuneray_aug_resolution_64_64_nearestResidualSR':
        'nearest-conv-residual',
    'objverse_tuneray_aug_resolution_64_64_auto': None,  # no render SR
    'objverse_tuneray_aug_resolution_128_128_auto': None,
    'objverse_tuneray_aug_resolution_96_96_auto': None,
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
    upsampler to (3, 128, 128, 32) planes; 'objaverse-s' (the smaller
    published training config, the sample script's default): the same
    with DiT2-B/2.  'shapenet' (fusionv5):
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
    if name not in ('objaverse', 'objaverse-s'):
        raise KeyError(name)
    dit2 = 'DiT2-B/2' if name == 'objaverse-s' else 'DiT2-L/2'
    return TriplaneVAEConfig(
        encoder_in_channels=10, encoder_ch=64, encoder_ch_mult=(1, 2, 4, 4),
        encoder_res_blocks=1, img_resolution=256, num_views=4,
        ldm_z_channels=4, latent_size=32,
        dit2=dit2_registry(dit2, tokens_per_plane=256, dtype=dtype),
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


# -- release presets: one entry per reference final-release shell script
# (``shell_scripts/final_release/{inference,train}``); each resolves to an
# ExperimentConfig through release_preset() ---------------------------------

RELEASE_PRESETS: dict[str, dict] = {
    # --- inference -------------------------------------------------------
    # sample_obajverse_t23d_dit.sh: DiT-L/2 text→3D, ddim250, cfg 6.5
    'objaverse/t23d-dit': dict(
        dataset='objaverse', vae='objaverse', denoiser='t23d-dit-l2',
        objective='ddpm', triplane_scaling_divider=0.96806,
        cfg_scale=6.5, sample_steps=250, sampler='ddim',
        cfg='objverse_tuneray_aug_resolution_64_64_auto'),
    # sample_obajverse_i23d_dit.sh: PixArt-L/2 image→3D, flow matching,
    # cfg 4.0
    'objaverse/i23d-dit': dict(
        dataset='objaverse', vae='objaverse', denoiser='i23d-pixart-l2',
        objective='flow_matching', triplane_scaling_divider=0.96806,
        cfg_scale=4.0, sample_steps=250, sampler='flow_matching',
        cfg='objverse_tuneray_aug_resolution_64_64_auto'),
    # sample_obajverse_mv23d_dit.sh: MV-L/2 multi-view→3D, flow matching
    'objaverse/mv23d-dit': dict(
        dataset='objaverse', vae='objaverse', denoiser='mv23d-dit-l2',
        objective='flow_matching', triplane_scaling_divider=0.96806,
        cfg_scale=4.0, sample_steps=250, sampler='flow_matching',
        cfg='objverse_tuneray_aug_resolution_64_64_auto'),
    # sample_obajverse.sh: older LDM text→3D release (divider 0.88)
    'objaverse/t23d-ldm': dict(
        dataset='objaverse', vae='objaverse', denoiser='t23d-dit-l2',
        objective='ddpm', triplane_scaling_divider=0.88,
        cfg_scale=6.5, sample_steps=250, sampler='ddim',
        cfg='objverse_tuneray_aug_resolution_64_64_auto'),
    # sample_shapenet_{car,chair,plane}_t23d.sh: U-Net LSGM, cfg 1.0; the
    # conditioning is the pooled CLIP text feature, L2-normalised and
    # scaled by --scale_clip_encoding 18.4 (FrozenCLIPTextEmbedder,
    # ldm/modules/encoders/modules.py:209-260)
    **{f'shapenet/{cls}-t23d': dict(
        dataset='shapenet', vae='shapenet', denoiser='shapenet-unet',
        objective='vpsde', triplane_scaling_divider=1.0,
        cfg_scale=1.0, sample_steps=250, sampler='ddim',
        scale_clip_encoding=18.4,
        cfg='shapenet_tuneray_aug_resolution_64_64_nearestSR',
        dataset_class=cls) for cls in ('car', 'chair', 'plane')},
    # sample_ffhq_t23d.sh: FFHQ 4XC_final VAE + U-Net, cfg 6.5
    'ffhq/t23d': dict(
        dataset='ffhq', vae='ffhq', denoiser='shapenet-unet',
        objective='vpsde', triplane_scaling_divider=1.0,
        cfg_scale=6.5, sample_steps=250, sampler='ddim',
        scale_clip_encoding=1.0, cfg='ffhq'),
    # vae_reconstruction.sh / vae_xl_reconstruction.sh
    'objaverse/vae-rec': dict(
        dataset='objaverse', vae='objaverse', denoiser='t23d-dit-l2',
        objective='reconstruction',
        cfg='objverse_tuneray_aug_resolution_64_64_auto'),
    # --- training --------------------------------------------------------
    # train/stage-1-vae/Objaverse/mv-75k-addDepth_disc.sh (8×A100)
    'train/objaverse-vae': dict(
        dataset='objaverse', vae='objaverse', objective='reconstruction',
        lr=1e-4, batch_size=8, patch_rendering_resolution=32,
        cfg='objverse_tuneray_aug_resolution_64_64_auto'),
    # train/stage-2-diffusion/objaverse-dit.sh (DiT on extracted latents)
    'train/objaverse-dit': dict(
        dataset='objaverse', vae='objaverse', denoiser='t23d-dit-l2',
        objective='flow_matching', lr=1e-4, batch_size=20,
        triplane_scaling_divider=0.96806,
        cfg='objverse_tuneray_aug_resolution_64_64_auto'),
    # train/stage-1-vae/ShapeNet/{car,chair,plane}_vae.sh
    **{f'train/shapenet-{cls}-vae': dict(
        dataset='shapenet', vae='shapenet', objective='reconstruction',
        lr=1e-4, batch_size=8,
        cfg='shapenet_tuneray_aug_resolution_64_64_nearestSR',
        dataset_class=cls) for cls in ('car', 'chair', 'plane')},
    # train/stage-2-diffusion/shapenet_cldm (joint LSGM)
    'train/shapenet-lsgm': dict(
        dataset='shapenet', vae='shapenet', denoiser='shapenet-unet',
        objective='vpsde_joint', lr=1e-4,
        cfg='shapenet_tuneray_aug_resolution_64_64_nearestSR'),
}


def release_preset(name: str) -> 'ExperimentConfig':
    """A release-preset name → its ``ExperimentConfig``; the keys that are
    not fields (cfg_scale, sampler, …) land in ``extras``."""
    spec = dict(RELEASE_PRESETS[name])
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    extras = {k: spec.pop(k) for k in list(spec) if k not in fields}
    cfg = ExperimentConfig(**spec)
    cfg.extras = extras
    return cfg


@dataclasses.dataclass
class ExperimentConfig:
    """The flat experiment config of the CLIs (the reference's argparse
    surface)."""
    dataset: str = 'objaverse'
    cfg: str = 'objverse_tuneray_aug_resolution_64_64_auto'
    vae: str = 'objaverse-s'
    denoiser: str = 't23d-dit-l2'
    objective: str = 'flow_matching'
    logdir: str = os.path.join(tempfile.gettempdir(), 'ln3diff')
    seed: int = 0
    # trainer knobs
    lr: float = 1e-4
    batch_size: int = 1
    microbatch_steps: int = 1
    patch_rendering_resolution: int = 32
    triplane_scaling_divider: float = 0.96806
    total_steps: int = 100000
    save_interval: int = 10000
    log_interval: int = 10
    resume_checkpoint: str = ''
    dataset_class: str = ''           # shapenet car/chair/plane
    # sampler extras carried by release presets (cfg_scale, sampler, ...)
    extras: dict = dataclasses.field(default_factory=dict)

    def render_opts(self) -> RenderOptions:
        return RENDER_PRESETS[self.cfg]

    def vae_config(self):
        return vae_preset(self.vae)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def add_config_to_argparser(parser: argparse.ArgumentParser,
                            cfg: ExperimentConfig):
    """One ``--<field>`` flag per field of ``cfg``, defaulting to its
    value (the reference's ``add_dict_to_argparser``)."""
    for f in dataclasses.fields(cfg):
        default = getattr(cfg, f.name)
        ftype = type(default)
        if ftype is dict:          # preset extras: not a CLI surface
            continue
        if ftype is bool:
            parser.add_argument(f'--{f.name}', default=default,
                                type=lambda s: s.lower() in
                                ('1', 'true', 'yes'))
        else:
            parser.add_argument(f'--{f.name}', default=default, type=ftype)
    return parser


def args_to_config(args: argparse.Namespace) -> ExperimentConfig:
    names = {f.name for f in dataclasses.fields(ExperimentConfig)}
    return ExperimentConfig(**{k: v for k, v in vars(args).items()
                               if k in names})


def add_preset_argument(parser: argparse.ArgumentParser, argv=None):
    """A ``--preset`` flag resolving ``RELEASE_PRESETS``: ``--preset`` is
    parsed ahead and the named config rewrites the parser's defaults, so
    explicit flags still override the preset's values."""
    parser.add_argument('--preset', default='',
                        help="RELEASE_PRESETS name (e.g. "
                             "'train/objaverse-vae', 'train/objaverse-"
                             "dit'); explicit flags override it")
    argv = sys.argv[1:] if argv is None else argv
    pre_parser = argparse.ArgumentParser(add_help=False)
    pre_parser.add_argument('--preset', default='')
    pre, _ = pre_parser.parse_known_args(argv)
    if pre.preset:
        cfg = release_preset(pre.preset)
        names = {f.name for f in dataclasses.fields(ExperimentConfig)}
        parser.set_defaults(**{k: v for k, v in
                               dataclasses.asdict(cfg).items()
                               if k in names and not isinstance(v, dict)})
    return parser
