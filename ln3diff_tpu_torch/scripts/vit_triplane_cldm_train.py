"""ControlNet fine-tuning entry.

Port of ``scripts/vit_triplane_cldm_train.py`` (reference
``scripts/vit_triplane_cldm_train.py``): freeze a pre-trained LDM U-Net
and train the zero-conv ControlNet branch on hint-conditioned latents.
Without ``--unet_ckpt`` (a JAX-tree ``.npz`` of the U-Net, as either
package's convert CLI writes it) the U-Net is random (the pipeline's
smoke mode); the latents, the context and the hints are random batches.

    python -m ln3diff_tpu_torch.scripts.vit_triplane_cldm_train \\
        --denoiser shapenet-unet --total_steps 100

``--device`` (default ``cuda``) picks the device; under ``torchrun`` each
rank trains on its slice of the batch.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--logdir', default=os.path.join(
        tempfile.gettempdir(), 'ln3diff-cldm'))
    parser.add_argument('--denoiser', default='shapenet-unet')
    parser.add_argument('--unet_ckpt', default='')
    parser.add_argument('--lr', type=float, default=1e-5)
    parser.add_argument('--batch_size', type=int, default=4)
    parser.add_argument('--total_steps', type=int, default=100)
    parser.add_argument('--log_interval', type=int, default=10)
    parser.add_argument('--triplane_scaling_divider', type=float,
                        default=1.0)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default='cuda')
    return parser


def random_batches(batch: int, context_dim: int, seed: int):
    """Random (latent, context, hint) batches at the U-Net's 32² grid."""
    rng = np.random.default_rng(seed)
    while True:
        yield {
            'latent': rng.standard_normal(
                (batch, 32, 32, 12)).astype(np.float32),
            'context': {'crossattn': rng.standard_normal(
                (batch, 77, context_dim)).astype(np.float32)},
            'hint': rng.standard_normal(
                (batch, 32, 32, 3)).astype(np.float32),
        }


def run(argv=None, unet_cfg=None):
    """The entry's work → ``(trainer, last metrics)``; ``unet_cfg``
    replaces the preset's U-Net (a test passes a toy one)."""
    import types

    import torch

    from .. import bridge
    from ..config import denoiser_preset
    from ..models.controlnet import ControlNet
    from ..models.layers import random_init_, zero_init_like_jax
    from ..models.unet import UNetModel
    from ..parallel.mesh import make_mesh
    from ..training.checkpoint import load_jax_tree_npz
    from ..training.ldm_trainer import ControlNetTrainer, LDMTrainConfig
    from ..utils import logger
    from ._lib import metric_log, setup

    args = build_parser().parse_args(argv)
    cfg = types.SimpleNamespace(logdir=args.logdir,
                                to_json=lambda: str(vars(args)))
    device, _, _ = setup(cfg, args.device)
    unet_cfg = unet_cfg or denoiser_preset(args.denoiser)
    with torch.device(device):
        unet, controlnet = UNetModel(unet_cfg), ControlNet(unet_cfg)
    trainer = ControlNetTrainer(
        unet, controlnet,
        LDMTrainConfig(objective='ddpm', lr=args.lr,
                       triplane_scaling_divider=args.triplane_scaling_divider,
                       log_interval=args.log_interval),
        seed=args.seed, device=device,
        mesh=make_mesh(device_type=device.type))
    # the trainer draws the ControlNet's weights; the U-Net keeps the
    # ones it holds: the checkpoint's, or random ones from seed 1 (JAX's
    # PRNGKey(1) init)
    if args.unet_ckpt:
        load_jax_tree_npz(args.unet_ckpt, trainer.model,
                          bridge.unet_state_dict)
    else:
        random_init_(trainer.model,
                     torch.Generator(device=device).manual_seed(1))
        zero_init_like_jax(trainer.model)
    trainer.build()
    trainer.generator = torch.Generator(device=device).manual_seed(
        args.seed + 42)
    metrics = {}
    trainer.run_loop(random_batches(args.batch_size, unet_cfg.context_dim,
                                    args.seed),
                     num_steps=args.total_steps,
                     log=metric_log(metrics, logger.log))
    logger.log('controlnet training done')
    return trainer, metrics


def main(argv=None):
    run(argv)


if __name__ == '__main__':
    main()
