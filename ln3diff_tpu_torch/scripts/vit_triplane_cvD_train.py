"""Adversarial stage-1 VAE training entry (GAN-assisted reconstruction).

Port of ``scripts/vit_triplane_cvD_train.py`` (reference
``scripts/vit_triplane_cvD_train.py`` / ``vit_triplane_cvD_train_ffhq.py``,
trainer classes ``TrainLoop3DcvD*``, ``nsr/cvD/nvsD_canoD.py:50``): the
patch-ray VAE trainer plus a discriminator on rendered vs. ground-truth
patches — the StyleGAN patch discriminator with hinge loss and R1, or
``--disc_type vision_aided``: the frozen-CLIP multilevel discriminator
(random backbone offline, ``training/vision_aided.py``).

    python -m ln3diff_tpu_torch.scripts.vit_triplane_cvD_train \\
        --disc_type stylegan --logdir runs/cvd

``--device`` (default ``cuda``) picks the device; under ``torchrun`` each
rank trains the VAE on its slice of the batch and every rank steps the
discriminator on the whole batch.
"""

from __future__ import annotations

import argparse


def build_parser(argv=None) -> argparse.ArgumentParser:
    from ..config import ExperimentConfig, add_config_to_argparser
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_config_to_argparser(parser, ExperimentConfig())
    parser.add_argument('--num_views', type=int, default=4)
    parser.add_argument('--encoder_resolution', type=int, default=256)
    parser.add_argument('--render_resolution', type=int, default=128)
    parser.add_argument('--disc_lr', type=float, default=2e-4)
    parser.add_argument('--r1_gamma', type=float, default=1.0)
    parser.add_argument('--disc_weight', type=float, default=0.1,
                        help='generator adversarial loss weight '
                             '(reference --lambda_adv)')
    parser.add_argument('--disc_type', default='stylegan',
                        choices=['stylegan', 'vision_aided'],
                        help='vision_aided = frozen-CLIP multilevel D '
                             '(reference vision_aided_loss cvD, '
                             'nsr/train_util_cvD.py:98)')
    parser.add_argument('--device', default='cuda')
    return parser


def run(argv=None, model_cfg=None, disc_cfg=None, va_kw=None):
    """The entry's work → ``(trainer, last metrics)``: the discriminator
    of the flags, then the VAE entry's training
    (``vit_triplane_train.train_vae``) with it.
    ``model_cfg`` and ``disc_cfg`` (a ``DiscriminatorConfig``) replace the
    presets, ``va_kw`` updates the ``VisionAidedConfig`` (a test passes
    toy ones)."""
    from ..config import args_to_config
    from ..models.stylegan import DiscriminatorConfig
    from ..pipeline import resolve_device
    from ..training.gan import AdversarialHead, GANConfig
    from .vit_triplane_train import train_vae

    args = build_parser(argv).parse_args(argv)
    cfg = args_to_config(args)
    device = resolve_device(args.device)
    if args.disc_type == 'vision_aided':
        from ..training.vision_aided import VisionAidedConfig, VisionAidedHead
        va = VisionAidedConfig(disc_lr=args.disc_lr,
                               adv_lambda=args.disc_weight, **(va_kw or {}))
        adv = VisionAidedHead(va, seed=cfg.seed, device=device)
    else:
        disc = disc_cfg or DiscriminatorConfig(
            img_resolution=cfg.patch_rendering_resolution)
        adv = AdversarialHead(GANConfig(disc=disc, disc_lr=args.disc_lr,
                                        r1_gamma=args.r1_gamma,
                                        adv_lambda=args.disc_weight),
                              seed=cfg.seed, device=device)
    return train_vae(cfg, args, model_cfg, adversarial=adv)


def main(argv=None):
    run(argv)


if __name__ == '__main__':
    main()
