"""Text→3D sampling entry.

Port of ``scripts/vit_triplane_diffusion_sample.py`` (reference
``scripts/vit_triplane_diffusion_sample_objaverse.py``): per prompt, the
CLIP text context → CFG denoiser sampling → VAE decode → orbit video
(MJPEG avi, gif or PNGs) and mesh export, through the port's pipeline
builders (``build_t23d_pipeline`` for the DiT denoisers,
``build_unet_pipeline`` for the ShapeNet/FFHQ U-Net):

    python -m ln3diff_tpu_torch.scripts.vit_triplane_diffusion_sample \\
        --preset objaverse/t23d-dit --denoiser_ckpt ckpt/denoiser.npz \\
        --vae_ckpt ckpt/vae.npz --prompts 'a wooden chair'

``--denoiser_ckpt`` / ``--vae_ckpt`` take the ``.npz`` trees that
``convert_checkpoint`` (either package's) writes; without them the
weights are random, drawn from ``--seed``.  As in the JAX script the CLIP
text tower is random: no converted text weights are loaded.  The
denoiser is stored in bf16 after loading (``cast_floating``);
``--int8_dit`` then quantizes a DiT (``ops.int8.quantize_dit``), while a
U-Net stays bf16.  The renders and σ-grid queries run the fused point
kernel; ``--device`` (default ``cuda``) picks the device, and a missing
card raises.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

DEFAULT_PROMPTS = [
    # the hard-coded prompt list of the reference (:189-223)
    'a wooden chair',
    'a sports car',
    'an airplane',
]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--prompts', nargs='*', default=DEFAULT_PROMPTS)
    parser.add_argument('--outdir', default=os.path.join(
        tempfile.gettempdir(), 'ln3diff-samples'))
    parser.add_argument('--denoiser', default='t23d-dit-l2')
    parser.add_argument('--vae', default='objaverse-s')
    parser.add_argument('--objective', default='ddim',
                        choices=['ddim', 'flow_matching', 'dpm', 'plms'],
                        help='dpm = DPM-Solver++(2M) over the full '
                             'schedule; plms = 4th-order multistep over '
                             'the respaced schedule')
    parser.add_argument('--num_steps', type=int, default=250)
    parser.add_argument('--unconditional_guidance_scale', type=float,
                        default=6.5)
    parser.add_argument('--num_frames', type=int, default=24)
    parser.add_argument('--eval_pose_asset', default='',
                        help='path to a packed (N, 25) pose asset '
                             '(reference assets/objv_eval_pose.pt); '
                             'overrides the analytic orbit and '
                             '--num_frames')
    parser.add_argument('--render_resolution', type=int, default=128)
    parser.add_argument('--export_mesh', default=True,
                        type=lambda s: str(s).lower() in ('1', 'true'))
    parser.add_argument('--mesh_grid', type=int, default=192)
    parser.add_argument('--denoiser_ckpt', default='')
    parser.add_argument('--vae_ckpt', default='')
    parser.add_argument('--int8_dit', action='store_true',
                        help='W8A8 int8 DiT (ops/int8.py); a U-Net stays '
                             'bf16')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--clip_vocab', default='',
                        help='path to the CLIP BPE merges file '
                             '(bpe_simple_vocab_16e6.txt[.gz]); default '
                             'resolves $LN3DIFF_CLIP_BPE then assets/, '
                             'else the hash fallback')
    parser.add_argument('--video_format', default='avi',
                        choices=['avi', 'gif', 'png'],
                        help='orbit container: MJPEG avi, animated gif or '
                             'per-frame PNGs')
    parser.add_argument('--fps', type=int, default=24)
    parser.add_argument('--preset', default='',
                        help='RELEASE_PRESETS name (e.g. '
                             "'objaverse/t23d-dit', 'shapenet/car-t23d'): "
                             'sets the denoiser, VAE, objective, steps, '
                             'CFG scale and divider of the release')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    return parser


def apply_preset(args) -> argparse.Namespace:
    """``--preset`` overrides the denoiser, VAE, objective, steps, CFG
    scale and latent divider, and sets the pooled-CLIP scale of the
    ShapeNet/FFHQ releases (``args.clip_scale``, None otherwise)."""
    from ..config import RELEASE_PRESETS, release_preset
    args.triplane_scaling_divider = None
    args.clip_scale = None
    if args.preset:
        rp = release_preset(args.preset)
        args.denoiser = rp.denoiser
        args.vae = rp.vae
        args.objective = {'ddpm': 'ddim', 'vpsde': 'ddim'}.get(
            rp.objective, rp.objective)
        args.unconditional_guidance_scale = rp.extras.get(
            'cfg_scale', args.unconditional_guidance_scale)
        args.num_steps = rp.extras.get('sample_steps', args.num_steps)
        args.triplane_scaling_divider = rp.triplane_scaling_divider
        args.clip_scale = RELEASE_PRESETS[args.preset].get(
            'scale_clip_encoding')
    return args


def model_configs(args):
    """``(denoiser, VAE, CLIP text)`` configs of ``args``: the preset
    denoiser as released (exact GELU, bf16), the VAE preset, and the CLIP
    text tower (with the ``text_projection`` head when the pooled feature
    conditions)."""
    from ..conditioning.clip import CLIPTextConfig
    from ..config import denoiser_preset, vae_preset
    return (denoiser_preset(args.denoiser), vae_preset(args.vae),
            CLIPTextConfig(with_projection=args.clip_scale is not None))


def start_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """A prompt's start latent, drawn from the run's generator."""
    return torch.randn(shape, generator=generator, device=device)


def _modules(args, den_cfg, vae_cfg, text_cfg, device, log):
    """The denoiser, the VAE's decode side and the text tower on
    ``device``: checkpoints through ``load_jax_tree_npz``, random weights
    from ``--seed`` otherwise; the denoiser stored in bf16, then quantized
    under ``--int8_dit``.  Of a VAE checkpoint (a whole converted VAE) the
    subtrees that the decode side holds load, strictly; the encoder's are
    left out, as the JAX script loads only its decode paths."""
    from .. import bridge
    from ..conditioning.clip import CLIPTextModel
    from ..config import build_vae
    from ..models.dit import DiT_TriLatent
    from ..models.layers import random_init_
    from ..models.unet import UNetConfig, UNetModel
    from ..training.checkpoint import load_jax_tree_npz
    from ..utils.misc import cast_floating

    is_unet = isinstance(den_cfg, UNetConfig)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.device(device):
        denoiser = UNetModel(den_cfg) if is_unet else DiT_TriLatent(den_cfg)
        vae = build_vae(vae_cfg)
        text_model = CLIPTextModel(text_cfg)
    decode_side = {k.split('.')[0] for k in vae.state_dict()}
    load_s = {}
    for name, module, path, to_sd in (
            ('denoiser', denoiser, args.denoiser_ckpt,
             bridge.unet_state_dict if is_unet else bridge.dit_state_dict),
            ('vae', vae, args.vae_ckpt, lambda tree: bridge.vae_state_dict(
                {k: v for k, v in tree.items() if k in decode_side})),
            ('text_model', text_model, '', None)):
        if path:
            t0 = time.perf_counter()
            load_jax_tree_npz(path, module, to_sd)
            load_s[name] = time.perf_counter() - t0
            log(f'loaded {path} in {load_s[name]:.1f} s')
        else:
            random_init_(module, gen)
    # bf16 weight storage: the bf16-compute denoiser casts per call anyway
    denoiser = cast_floating(denoiser, torch.bfloat16)
    if args.int8_dit:
        if is_unet:
            log('--int8_dit: the U-Net stays bf16')
        else:
            from ..ops.int8 import quantize_dit
            denoiser = quantize_dit(denoiser)
            log('int8 DiT serving: projections quantized W8A8')
    return dict(denoiser=denoiser, vae=vae, text_model=text_model), load_s


def sample(args) -> dict:
    """Run every prompt of ``args`` (parsed, preset applied) → a dict:
    ``outputs``, one dict per prompt (``prompt``, ``video`` (F, H, W, 3)
    float frames in [-1, 1] on the host, ``latents``, ``planes``, ``mesh``
    (verts, faces) when exported, ``video_path``, ``mesh_path``,
    ``sample_wall_s``); ``modules``, the denoiser, VAE and text tower that
    ran; ``load_seconds``, the seconds each checkpoint took to load."""
    from ..conditioning.clip import default_tokenizer, pooled_text_context
    from ..config import RENDER_PRESETS
    from ..models.unet import UNetConfig
    from ..pipeline import (SamplerSpec, build_t23d_pipeline,
                            build_unet_pipeline, resolve_device,
                            save_video_frames)
    from ..utils import logger
    from ..utils.video import save_video_avi, save_video_gif

    device = resolve_device(args.device)
    logger.configure(args.outdir)
    os.makedirs(args.outdir, exist_ok=True)

    den_cfg, vae_cfg, text_cfg = model_configs(args)
    is_unet = isinstance(den_cfg, UNetConfig)
    modules, load_s = _modules(args, den_cfg, vae_cfg, text_cfg, device,
                               logger.log)

    render_opts = RENDER_PRESETS[
        'shapenet_tuneray_aug_resolution_64_64_nearestSR'
        if args.vae == 'shapenet' else 'ffhq' if args.vae == 'ffhq'
        else 'objverse_tuneray_aug_resolution_64_64_auto']
    latent_shape = (vae_cfg.latent_size, vae_cfg.latent_size,
                    vae_cfg.latent_channels)
    sampler = SamplerSpec(
        kind=args.objective, num_steps=args.num_steps,
        cfg_scale=args.unconditional_guidance_scale,
        latent_shape=latent_shape,
        **({'triplane_scaling_divider': args.triplane_scaling_divider}
           if args.triplane_scaling_divider is not None else {}))
    common = dict(den_cfg=den_cfg, vae_cfg=vae_cfg, text_cfg=text_cfg,
                  render_opts=render_opts,
                  render_resolution=args.render_resolution,
                  sampler=sampler, render_dtype=None, modules=modules)
    if is_unet:
        # the LSGM U-Net: v-prediction with the mixing logit; the frames
        # are the renders before the VAE's SR head, as in the JAX script
        pipeline, _, modules = build_unet_pipeline(
            args.vae, device, render_key='image_raw', **common)
    else:
        pipeline, _, modules = build_t23d_pipeline(device, **common)

    # ShapeNet/FFHQ presets condition on the pooled CLIP feature,
    # L2-normalised × scale_clip_encoding; the rest on the 77 token states
    text_model = modules['text_model']
    tokenizer = default_tokenizer(args.clip_vocab or None,
                                  max_length=text_cfg.max_length)

    @torch.no_grad()
    def encode_text(text: str) -> torch.Tensor:
        out = text_model(torch.as_tensor(tokenizer([text]), device=device))
        if args.clip_scale is None:
            return out['last_hidden_state']
        return pooled_text_context(out['text_embeds'],
                                   scale_clip_encoding=args.clip_scale)

    eval_cameras = None
    if args.eval_pose_asset:
        from ..render.camera import load_pose_asset
        eval_cameras = load_pose_asset(args.eval_pose_asset)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    results = []
    for p_i, prompt in enumerate(args.prompts):
        t_start = time.perf_counter()
        cond = {'crossattn': encode_text(prompt)}
        uncond = {'crossattn': encode_text('')}
        mesh_path = os.path.join(args.outdir, f'{p_i:02d}.obj') \
            if args.export_mesh else None
        out = pipeline(cond, uncond, batch=1, num_frames=args.num_frames,
                       mesh_path=mesh_path, mesh_grid=args.mesh_grid,
                       render_resolution=args.render_resolution,
                       cameras=eval_cameras,
                       x_init=start_noise((1,) + latent_shape, gen, device))
        frames = out['video'][0].float().cpu().numpy()
        stem = os.path.join(args.outdir, f'{p_i:02d}')
        if args.video_format == 'avi':
            video_path = save_video_avi(frames, stem + '.avi', fps=args.fps)
        elif args.video_format == 'gif':
            video_path = save_video_gif(frames, stem + '.gif', fps=args.fps)
        else:
            video_path = save_video_frames(frames, stem)
        wall = time.perf_counter() - t_start
        logger.log(f'[{p_i}] "{prompt}": {wall:.1f} s '
                   f'({args.num_steps} steps, {len(frames)} frames'
                   + (', mesh' if mesh_path else '') + ')')
        logger.logkv('sample_wall_s', wall)
        logger.dumpkvs()
        results.append(dict(prompt=prompt, video=frames,
                            latents=out['latents'], planes=out['planes'],
                            mesh=out.get('mesh'), video_path=video_path,
                            mesh_path=mesh_path, sample_wall_s=wall))
    return dict(outputs=results, modules=modules, load_seconds=load_s)


def main(argv=None) -> dict:
    return sample(apply_preset(build_parser().parse_args(argv)))


if __name__ == '__main__':
    main()
