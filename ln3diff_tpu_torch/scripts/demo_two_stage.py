"""From-scratch two-stage demo: restore the stage-1 VAE and the stage-2
DiT that this port's training entries wrote (no external weights), sample
latents from noise, decode, render an orbit and export a mesh.

Port of ``scripts/demo_two_stage.py``; it closes the LN3Diff loop with
self-trained weights:

  stage 1: ``python -m ln3diff_tpu_torch.scripts.vit_triplane_train
           --vae objaverse-s --encoder_resolution 128 --num_views 4
           --logdir VAE``
  stage 2: ``python -m ln3diff_tpu_torch.scripts.vit_triplane_diffusion_train
           --denoiser_scale DiT-B/2 --latent_size 16
           --triplane_scaling_divider 1.0 --logdir LDM``
  here:    ``python -m ln3diff_tpu_torch.scripts.demo_two_stage
           --vae_logdir VAE --ldm_logdir LDM`` — noise → the flow-matching
           ODE → planes → orbit frames (PNGs) and ``sample.obj``.

Both checkpoints are restored through the trainers, which give their
structure (JAX :58-96).  ``--device`` (default ``cuda``) picks the
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--vae_logdir', required=True)
    parser.add_argument('--ldm_logdir', required=True)
    parser.add_argument('--outdir', default=os.path.join(
        tempfile.gettempdir(), 'two_stage_demo'))
    parser.add_argument('--encoder_resolution', type=int, default=128)
    parser.add_argument('--num_steps', type=int, default=100)
    parser.add_argument('--num_frames', type=int, default=8)
    parser.add_argument('--render_resolution', type=int, default=64)
    parser.add_argument('--mesh_grid', type=int, default=96)
    parser.add_argument('--cfg_scale', type=float, default=1.0)
    parser.add_argument('--denoiser_scale', default='DiT-B/2')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default='cuda')
    return parser


def configs(args):
    """The VAE, the denoiser and the render options the training entries
    use at the demo's widths: the ``objaverse-s`` VAE at 4 views and the
    encoder resolution (latent ÷ 8), the ``--denoiser_scale`` DiT over the
    latent with 4 channels per plane."""
    from ..config import RENDER_PRESETS, vae_preset
    from ..models.dit import dit_registry
    latent_size = args.encoder_resolution // 8
    base = vae_preset('objaverse-s')
    vae_cfg = dataclasses.replace(
        base, num_views=4, img_resolution=args.encoder_resolution,
        latent_size=latent_size,
        dit2=dataclasses.replace(
            base.dit2,
            tokens_per_plane=(latent_size // base.patch_size)**2))
    den_cfg = dit_registry(args.denoiser_scale, input_size=latent_size,
                           in_channels=4)
    return (vae_cfg, den_cfg,
            RENDER_PRESETS['objverse_tuneray_aug_resolution_64_64_auto'])


def two_stage(args, vae_cfg=None, den_cfg=None, render_opts=None,
              x_init=None, log=print) -> dict:
    """Restore both stages, sample, render and write the mesh → ``{'out':
    the pipeline's output, 'frames': PNG paths, 'mesh_path', 'vae_step',
    'ldm_step', 'vae', 'denoiser'}``.  The configs default to
    :func:`configs`; ``x_init`` is the start noise (else drawn from
    ``--seed``)."""
    from ..pipeline import (SamplerSpec, TextTo3DPipeline, resolve_device,
                            save_video_frames)
    from ..training.checkpoint import CheckpointManager
    from ..training.ldm_trainer import LDMTrainConfig, LDMTrainer
    from ..training.losses import LossConfig
    from ..training.vae_trainer import VAETrainConfig, VAETrainer
    from ..models.dit import DiT_TriLatent

    device = resolve_device(args.device)
    defaults = configs(args)
    vae_cfg = vae_cfg or defaults[0]
    den_cfg = den_cfg or defaults[1]
    render_opts = render_opts or defaults[2]
    os.makedirs(args.outdir, exist_ok=True)
    latent_size = vae_cfg.latent_size

    # ---- stage-1 VAE (restored through the trainer for its structure) ---
    vae_trainer = VAETrainer(vae_cfg, VAETrainConfig(render_resolution=64),
                             LossConfig(), render_opts=render_opts,
                             device=device)
    vae_trainer.init_state()
    restored = CheckpointManager(
        os.path.join(args.vae_logdir, 'checkpoints')).restore(
            vae_trainer.state)
    assert restored is not None, 'no VAE checkpoint'
    vae = vae_trainer.model.eval()
    log(f'restored VAE @ step {int(restored.step)}')

    # ---- stage-2 denoiser ------------------------------------------------
    ldm_trainer = LDMTrainer(DiT_TriLatent(den_cfg),
                             LDMTrainConfig(triplane_scaling_divider=1.0),
                             device=device)
    ldm_trainer.init_state()
    restored_ldm = CheckpointManager(
        os.path.join(args.ldm_logdir, 'checkpoints')).restore(
            ldm_trainer.state)
    assert restored_ldm is not None, 'no LDM checkpoint'
    denoiser = ldm_trainer.model.eval()
    log(f'restored DiT @ step {int(restored_ldm.step)}')
    steps = dict(vae_step=int(restored.step),
                 ldm_step=int(restored_ldm.step))

    # ---- pipeline: the modules in their compute dtypes --------------------
    denoiser.to(den_cfg.dtype)
    vae.cast_decoder()
    pipeline = TextTo3DPipeline(
        denoiser, vae.decode_latent,
        lambda planes, cam: vae.render(planes, cam, render_opts,
                                       args.render_resolution)['image_raw'],
        lambda planes, coords: vae.query_points(planes, coords,
                                                render_opts.box_warp),
        sampler=SamplerSpec(kind='flow_matching', num_steps=args.num_steps,
                            cfg_scale=args.cfg_scale,
                            triplane_scaling_divider=1.0,
                            latent_shape=(latent_size, latent_size, 12)),
        device=device)

    ctx = {'crossattn': torch.zeros((1, 77, den_cfg.context_dim),
                                    device=device)}
    mesh_path = os.path.join(args.outdir, 'sample.obj')
    out = pipeline(ctx, ctx, batch=1, num_frames=args.num_frames,
                   mesh_path=mesh_path, mesh_grid=args.mesh_grid,
                   render_resolution=args.render_resolution,
                   generator=torch.Generator(device=device).manual_seed(
                       args.seed),
                   x_init=x_init)
    frames = save_video_frames(out['video'][0],
                               os.path.join(args.outdir, 'sample'))
    lat = out['latents'].float()
    log(f'sampled latent stats: mean {float(lat.mean()):.3f} '
        f'std {float(lat.std()):.3f}')
    log(f'wrote {len(frames)} frames + mesh to {args.outdir}')
    return dict(out=out, frames=frames, mesh_path=mesh_path, vae=vae,
                denoiser=denoiser, **steps)


def main(argv=None):
    return two_stage(build_parser().parse_args(argv))


if __name__ == '__main__':
    main()
