"""Stage-2 flow-matching (SiT) training entry.

Port of ``scripts/vit_triplane_sit_train.py`` (reference
``scripts/vit_triplane_sit_train.py``, trainer map {flow_matching,
flow_matching_gs} at :340-345 and ``parse_transport_args``): a DiT
denoiser trained on pre-extracted VAE latents with the transport
(stochastic-interpolant) objective — ``LDMTrainer`` with
``objective='flow_matching'`` and the transport built from the flags here,
where the reference exposes them.  ``--pp`` splits the trunk into
pipeline stages, as in ``vit_triplane_diffusion_train``.

    python -m ln3diff_tpu_torch.scripts.vit_triplane_sit_train \\
        --preset train/objaverse-dit --path_type linear --logdir runs/sit

``--device`` (default ``cuda``) picks the device; under ``torchrun`` each
rank trains on its slice of the batch.
"""

from __future__ import annotations

import argparse
import os


def parse_transport_args(parser: argparse.ArgumentParser):
    """Reference ``transport/__init__.py`` / ``parse_transport_args``."""
    group = parser.add_argument_group('transport')
    group.add_argument('--path_type', default='linear',
                       choices=['linear', 'gvp', 'vp'])
    group.add_argument('--prediction', default='velocity',
                       choices=['velocity', 'noise', 'score'])
    group.add_argument('--t_sampling', default='lognorm',
                       choices=['lognorm', 'uniform'],
                       help='lognorm is the released i23d/t23d FM setting '
                            '(reference transport.py:138-146)')
    group.add_argument('--train_eps', type=float, default=0.0)
    group.add_argument('--sample_eps', type=float, default=0.0)


def build_parser(argv=None) -> argparse.ArgumentParser:
    from ..config import ExperimentConfig, add_config_to_argparser
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_config_to_argparser(parser, ExperimentConfig())
    parse_transport_args(parser)
    parser.add_argument('--latent_dir', type=str, default='')
    parser.add_argument('--latent_size', type=int, default=0)
    parser.add_argument('--denoiser_scale', default='',
                        help="override preset, e.g. 'DiT-B/2'")
    parser.add_argument('--remat', default='dots',
                        choices=['none', 'full', 'dots'],
                        help='recompute each DiT block in the backward '
                             'pass')
    parser.add_argument('--pp', type=int, default=1,
                        help='pipeline-parallel stages over the DiT trunk')
    parser.add_argument('--pp_microbatches', type=int, default=4)
    parser.add_argument('--device', default='cuda')
    return parser


def run(argv=None, den_cfg=None):
    """The entry's work → ``(trainer, last metrics)``; ``den_cfg``
    replaces the preset's DiT (a test passes a toy one)."""
    import torch

    from ..config import args_to_config
    from ..diffusion.transport import Transport, TransportSpec
    from ..models.dit import DiT_TriLatent
    from ..parallel.mesh import MeshConfig, make_mesh
    from ..training.checkpoint import CheckpointManager
    from ..training.ldm_trainer import LDMTrainConfig, LDMTrainer
    from ..utils import logger
    from ._lib import metric_log, resume, setup, train_until
    from .vit_triplane_diffusion_train import denoiser_config, latent_stream

    args = build_parser(argv).parse_args(argv)
    cfg = args_to_config(args)
    device, _, _ = setup(cfg, args.device)
    den_cfg = den_cfg or denoiser_config(cfg, args)
    train_cfg = LDMTrainConfig(
        objective='flow_matching', lr=cfg.lr,
        triplane_scaling_divider=cfg.triplane_scaling_divider,
        microbatch_steps=cfg.microbatch_steps,
        pp_microbatches=args.pp_microbatches,
        log_interval=cfg.log_interval)
    data = latent_stream(args.latent_dir, cfg.batch_size,
                         (den_cfg.input_size, den_cfg.input_size, 12),
                         den_cfg.context_dim, cfg.seed)
    trainer = LDMTrainer(DiT_TriLatent(den_cfg), train_cfg, seed=cfg.seed,
                         device=device,
                         mesh=make_mesh(MeshConfig(pipe=args.pp),
                                        device_type=device.type))
    # the transport of the flags (path, prediction, t distribution)
    trainer.transport = Transport(TransportSpec(
        path=args.path_type, prediction=args.prediction,
        t_sampling=args.t_sampling, train_eps=args.train_eps,
        sample_eps=args.sample_eps))
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
