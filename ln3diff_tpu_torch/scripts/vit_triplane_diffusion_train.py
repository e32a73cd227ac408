"""Stage-2 latent-diffusion training entry.

Port of ``scripts/vit_triplane_diffusion_train.py`` (reference
``scripts/vit_triplane_diffusion_train.py`` / ``vit_triplane_sit_train.py``):
trains a denoiser on pre-extracted VAE latents (``--latent_dir`` of
``.npy`` files, else random latents: the pipeline's smoke mode) with
their text context; ``--objective`` picks flow matching, DDPM or EDM
(``LDMTrainer``), or ``vpsde_joint``: the LSGM joint VAE + U-Net trainer
on image batches (:func:`run_lsgm_joint`).  ``--pp`` > 1 splits the DiT's
trunk into that many pipeline stages (a mesh with a ``pipe`` axis, the
remaining ranks on ``data``), ``--pp_microbatches`` microbatches per step.

    python -m ln3diff_tpu_torch.scripts.vit_triplane_diffusion_train \\
        --preset train/objaverse-dit --logdir runs/dit
    torchrun --nproc_per_node=2 \\
        -m ln3diff_tpu_torch.scripts.vit_triplane_diffusion_train \\
        --pp 2 --device cpu ...

``--device`` (default ``cuda``) picks the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os

import numpy as np


def latent_stream(latent_dir: str, batch: int, shape, context_dim: int,
                  seed: int = 0):
    """Batches of ``batch`` latents drawn (with replacement) from the
    ``.npy`` files of ``latent_dir`` — random ones without files — with a
    random ``(batch, 77, context_dim)`` cross-attention context (JAX
    :23)."""
    rng = np.random.default_rng(seed)
    files = sorted(glob.glob(os.path.join(latent_dir, '*.npy'))) \
        if latent_dir else []
    if files:
        latents = np.concatenate(
            [np.load(f).astype(np.float32) for f in files], axis=0)
    else:
        latents = rng.standard_normal((max(batch, 8),) + tuple(shape)
                                      ).astype(np.float32)
    n = latents.shape[0]
    while True:
        idx = rng.integers(0, n, size=batch)
        yield {
            'latent': latents[idx],
            'context': {'crossattn': rng.standard_normal(
                (batch, 77, context_dim)).astype(np.float32)},
        }


def build_parser(argv=None) -> argparse.ArgumentParser:
    from ..config import (ExperimentConfig, add_config_to_argparser,
                          add_preset_argument)
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_config_to_argparser(parser, ExperimentConfig())
    add_preset_argument(parser, argv)
    parser.add_argument('--latent_dir', type=str, default='')
    parser.add_argument('--latent_size', type=int, default=0,
                        help='override denoiser input size (latent h=w)')
    parser.add_argument('--remat', default='dots',
                        choices=['none', 'full', 'dots'],
                        help='recompute each DiT block in the backward '
                             'pass')
    parser.add_argument('--denoiser_scale', default='',
                        help="override preset, e.g. 'DiT-B/2'")
    parser.add_argument('--unet_channels', type=int, default=320,
                        help='U-Net width for --objective vpsde_joint')
    parser.add_argument('--pp', type=int, default=1,
                        help='pipeline-parallel stages of the DiT trunk '
                             '(parallel/pipeline.py); the remaining ranks '
                             'become the data axis')
    parser.add_argument('--pp_microbatches', type=int, default=4,
                        help='microbatches per pipelined forward; bubble '
                             'fraction (pp-1)/(n+pp-1)')
    parser.add_argument('--device', default='cuda')
    return parser


def denoiser_config(cfg, args):
    """The preset's denoiser with the CLI's scale, latent size and
    remat."""
    from ..config import denoiser_preset
    from ..models.dit import DiTConfig, dit_registry
    den_cfg = denoiser_preset(cfg.denoiser)
    if args.denoiser_scale:
        den_cfg = dit_registry(args.denoiser_scale,
                               input_size=den_cfg.input_size,
                               in_channels=den_cfg.in_channels)
    if args.latent_size and hasattr(den_cfg, 'input_size'):
        den_cfg = dataclasses.replace(den_cfg, input_size=args.latent_size)
    if isinstance(den_cfg, DiTConfig) and args.remat != 'none':
        den_cfg = dataclasses.replace(den_cfg, remat=True,
                                      remat_policy=args.remat)
    return den_cfg


def run_lsgm_joint(cfg, args, device, log, vae_cfg=None, unet_cfg=None):
    """LSGM joint VAE + U-Net training (reference trainer names
    ``vpsde_lsgm_joint_noD`` / ``vpsde_crossattn``) → ``(trainer, last
    metrics)``."""
    from ..data.synthetic import load_memory_data
    from ..models.unet import UNetConfig, UNetModel
    from ..parallel.mesh import make_mesh
    from ..training.checkpoint import CheckpointManager
    from ..training.lsgm_trainer import LSGMTrainConfig, LSGMTrainer
    from ._lib import metric_log, resume, tile_instances, train_until

    vae_cfg = vae_cfg or cfg.vae_config()
    num_views = max(vae_cfg.num_views, 1)
    # the in-memory batches carry no context: the cross-attention reads
    # the features (``context_dim=None``), the in-width Linen infers there
    denoiser = UNetModel(unet_cfg or UNetConfig(
        in_channels=vae_cfg.ldm_z_channels,
        out_channels=vae_cfg.ldm_z_channels,
        model_channels=int(args.unet_channels), context_dim=None))
    train_cfg = LSGMTrainConfig(
        lr=cfg.lr, patch_resolution=cfg.patch_rendering_resolution,
        microbatch_steps=cfg.microbatch_steps,
        log_interval=cfg.log_interval, total_steps=cfg.total_steps)
    data = tile_instances(load_memory_data(
        cfg.batch_size, num_views, vae_cfg.img_resolution,
        train_cfg.render_resolution, seed=cfg.seed), cfg.batch_size)
    trainer = LSGMTrainer(vae_cfg, denoiser, train_cfg,
                          render_opts=cfg.render_opts(), seed=cfg.seed,
                          device=device,
                          mesh=make_mesh(device_type=device.type))
    trainer.build()
    ckpt = CheckpointManager(os.path.join(cfg.logdir, 'checkpoints'))
    resume(trainer, ckpt, cfg, log)
    metrics = {}
    train_until(trainer, data, cfg.total_steps, cfg.save_interval, ckpt,
                log=metric_log(metrics, log))
    ckpt.close()
    return trainer, metrics


def run(argv=None, den_cfg=None, vae_cfg=None, unet_cfg=None):
    """The entry's work → ``(trainer, last metrics)``; ``den_cfg`` (or,
    for ``vpsde_joint``, ``vae_cfg`` and ``unet_cfg``) replaces the
    preset's model (a test passes toy ones)."""
    import torch

    from ..config import args_to_config
    from ..models.dit import DiT_TriLatent
    from ..models.unet import UNetConfig, UNetModel
    from ..parallel.mesh import MeshConfig, make_mesh
    from ..training.checkpoint import CheckpointManager
    from ..training.ldm_trainer import LDMTrainConfig, LDMTrainer
    from ..utils import logger
    from ._lib import metric_log, resume, setup, train_until

    args = build_parser(argv).parse_args(argv)
    cfg = args_to_config(args)
    device, _, _ = setup(cfg, args.device)
    if cfg.objective == 'vpsde_joint':
        return run_lsgm_joint(cfg, args, device, logger.log, vae_cfg,
                              unet_cfg)

    den_cfg = den_cfg or denoiser_config(cfg, args)
    if isinstance(den_cfg, UNetConfig):
        model = UNetModel(den_cfg)
        latent_hw = 32
    else:
        model = DiT_TriLatent(den_cfg)
        latent_hw = den_cfg.input_size
    train_cfg = LDMTrainConfig(
        objective=cfg.objective, lr=cfg.lr,
        triplane_scaling_divider=cfg.triplane_scaling_divider,
        microbatch_steps=cfg.microbatch_steps,
        pp_microbatches=args.pp_microbatches,
        log_interval=cfg.log_interval)
    data = latent_stream(args.latent_dir, cfg.batch_size,
                         (latent_hw, latent_hw, 12), den_cfg.context_dim,
                         cfg.seed)
    trainer = LDMTrainer(model, train_cfg, seed=cfg.seed, device=device,
                         mesh=make_mesh(MeshConfig(pipe=args.pp),
                                        device_type=device.type))
    trainer.build()
    trainer.generator = torch.Generator(device=device).manual_seed(
        cfg.seed + 42)
    ckpt = CheckpointManager(os.path.join(cfg.logdir, 'checkpoints'))
    resume(trainer, ckpt, cfg, logger.log)
    metrics = {}
    train_until(trainer, data, cfg.total_steps, cfg.save_interval, ckpt,
                log=metric_log(metrics, logger.log))
    ckpt.close()
    return trainer, metrics


def main(argv=None):
    run(argv)


if __name__ == '__main__':
    main()
