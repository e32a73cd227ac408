"""Stage-1 VAE training entry.

Port of ``scripts/vit_triplane_train.py`` (reference
``scripts/vit_triplane_train.py:46-348``): builds the 3D VAE, the data
stream and the patch-ray reconstruction trainer; ``--overfitting`` selects
the in-memory single-instance stream (reference ``load_memory_data``),
tiled to ``--batch_size`` instances so that the (data, fsdp) ranks split
whole instances.  ``--inference`` runs the novel-view eval loop and with
``--save_latent`` dumps the latents for stage 2 (reference
``eval_novelview_loop(save_latent=True)``).  ``--resume_checkpoint``
(any non-empty value) resumes from the newest checkpoint under
``logdir/checkpoints``.

    python -m ln3diff_tpu_torch.scripts.vit_triplane_train \\
        --preset train/objaverse-vae --logdir runs/vae
    torchrun --nproc_per_node=2 \\
        -m ln3diff_tpu_torch.scripts.vit_triplane_train \\
        --batch_size 2 --device cpu ...

Under ``torchrun`` each rank trains on its slice of the batch (gloo on the
CPU, NCCL on the card); ``--device`` (default ``cuda``) picks the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch


def _flag(s) -> bool:
    return str(s).lower() in ('1', 'true')


def build_parser(argv=None) -> argparse.ArgumentParser:
    from ..config import (ExperimentConfig, add_config_to_argparser,
                          add_preset_argument)
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_config_to_argparser(parser, ExperimentConfig())
    add_preset_argument(parser, argv)
    parser.add_argument('--overfitting', default=True, type=_flag)
    parser.add_argument('--inference', default=False, type=_flag)
    parser.add_argument('--save_latent', default=False, type=_flag)
    parser.add_argument('--num_views', type=int, default=4)
    parser.add_argument('--encoder_resolution', type=int, default=256)
    parser.add_argument('--render_resolution', type=int, default=128)
    parser.add_argument('--device', default='cuda')
    return parser


def model_config(cfg, args):
    """The preset's VAE at the CLI's views and resolutions (the SD
    encoder downsamples by 8)."""
    base = cfg.vae_config()
    latent_size = args.encoder_resolution // 8
    return dataclasses.replace(
        base, num_views=args.num_views,
        img_resolution=args.encoder_resolution, latent_size=latent_size,
        dit2=dataclasses.replace(
            base.dit2,
            tokens_per_plane=(latent_size // base.patch_size)**2))


def run(argv=None, model_cfg=None):
    """The entry's work → ``(trainer, last metrics)``; ``model_cfg``
    replaces the preset's VAE (a test passes a toy one)."""
    from ..config import args_to_config
    args = build_parser(argv).parse_args(argv)
    return train_vae(args_to_config(args), args, model_cfg)


def train_vae(cfg, args, model_cfg=None, adversarial=None):
    """Set up, build the VAE trainer (with the ``adversarial`` head of the
    cvD entry) and train it, or with ``args.inference`` run the novel-view
    eval → ``(trainer, last metrics)``."""
    from ..data.synthetic import load_memory_data
    from ..parallel.mesh import make_mesh
    from ..training.checkpoint import CheckpointManager
    from ..training.losses import LossConfig
    from ..training.vae_trainer import VAETrainConfig, VAETrainer
    from ..utils import logger
    from ._lib import (eval_novelview_loop, metric_log, resume, setup,
                       tile_instances, train_until)

    device, _, _ = setup(cfg, args.device)
    model_cfg = model_cfg or model_config(cfg, args)
    train_cfg = VAETrainConfig(
        lr=cfg.lr, patch_resolution=cfg.patch_rendering_resolution,
        render_resolution=args.render_resolution,
        microbatch_steps=cfg.microbatch_steps,
        log_interval=cfg.log_interval, total_steps=cfg.total_steps)
    data = tile_instances(load_memory_data(
        cfg.batch_size, args.num_views, args.encoder_resolution,
        args.render_resolution, seed=cfg.seed), cfg.batch_size)
    trainer = VAETrainer(model_cfg, train_cfg, LossConfig(),
                         render_opts=cfg.render_opts(), seed=cfg.seed,
                         adversarial=adversarial, device=device,
                         mesh=make_mesh(device_type=device.type))
    trainer.init_state()
    ckpt = CheckpointManager(os.path.join(cfg.logdir, 'checkpoints'))
    resume(trainer, ckpt, cfg, logger.log)

    if getattr(args, 'inference', False):
        eval_novelview_loop(trainer, data, cfg, save_latent=args.save_latent,
                            log=logger.log)
        return trainer, {}

    metrics = {}
    # the step's draws are global: the same seed on every rank
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 1234)
    train_until(trainer, data, cfg.total_steps, cfg.save_interval, ckpt,
                log=metric_log(metrics, logger.log), generator=generator)
    ckpt.close()
    return trainer, metrics


def main(argv=None):
    run(argv)


if __name__ == '__main__':
    main()
