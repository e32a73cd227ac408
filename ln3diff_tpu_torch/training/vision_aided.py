"""Vision-aided discriminator: a frozen CLIP backbone with small
trainable heads on several of its layers.

Port of ``ln3diff_tpu/training/vision_aided.py`` (``_vit_b32`` :40,
``VisionAidedConfig`` :48, ``clip_preprocess`` :60, ``_LevelHead`` :83,
``VisionAidedDiscriminator`` :101, ``multilevel_d_loss`` :133,
``multilevel_g_loss`` :146, ``trainable_labels`` :159,
``VisionAidedHead`` :188; reference ``vision_aided_loss.Discriminator(
cv_type='clip', loss_type='multilevel_sigmoid_s')`` in
``nsr/train_util_cvD.py:98-125``).  The backbone's parameters have
``requires_grad=False`` from construction and stay out of the optimizer
(JAX: ``set_to_zero`` under ``multi_transform``); the 6-channel variant
trains its patch embedding.  The heads train with Adam (β1 0, β2 0.999).
The generator term goes through the live heads, detached (see
``gan.py``).  The backbone is randomly initialised unless converted CLIP
weights are loaded (``backbone_state_dict``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..conditioning.clip import CLIPVisionConfig, CLIPVisionModel
from ..models.layers import random_init_
from ..pipeline import resolve_device
from .gan import apply_disc_grads
from .train_state import TrainState, frozen_apply, make_optimizer

# OpenAI CLIP normalisation, tiled to the channel count (6-ch variant)
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _vit_b32() -> CLIPVisionConfig:
    """CLIP ViT-B/32, the ``cv_type='clip'`` backbone."""
    return CLIPVisionConfig(hidden_size=768, num_layers=12, num_heads=12,
                            intermediate_size=3072, patch_size=32,
                            image_size=224)


@dataclasses.dataclass(frozen=True)
class VisionAidedConfig:
    clip: CLIPVisionConfig = dataclasses.field(default_factory=_vit_b32)
    taps: tuple = (3, 6, 9, 12)     # backbone layers tapped (1-based)
    head_width: int = 128
    in_channels: int = 3            # 6 for the SR (rgb + raw) variant
    disc_lr: float = 1e-4
    adv_lambda: float = 0.025
    label_smoothing: float = 0.1


def clip_preprocess(images: torch.Tensor, cfg: VisionAidedConfig
                    ) -> torch.Tensor:
    """[-1, 1] images (B, H, W, C) → CLIP-normalised at the backbone's
    resolution (``jax.image.resize``'s antialiased bilinear)."""
    B, H, W, C = images.shape
    if C != cfg.in_channels:
        raise ValueError(f'{C} channels, the config says {cfg.in_channels}')
    size = cfg.clip.image_size
    x = (images + 1.0) * 0.5
    if (H, W) != (size, size):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                          mode='bilinear', align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    reps = C // 3
    mean = torch.tensor(_CLIP_MEAN * reps, dtype=x.dtype, device=x.device)
    std = torch.tensor(_CLIP_STD * reps, dtype=x.dtype, device=x.device)
    return (x - mean) / std


class _LevelHead(nn.Module):
    """Per-tap patch head: the token grid → a patch logit map (B, s²)."""

    def __init__(self, dim: int, width: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, width, 3, padding=1)
        self.conv2 = nn.Conv2d(width, width, 3, padding=1)
        self.out = nn.Conv2d(width, 1, 1)

    def forward(self, tokens):
        B, L, D = tokens.shape
        s = int(round(L**0.5))
        x = tokens.transpose(1, 2).reshape(B, D, s, s)
        x = F.leaky_relu(self.conv1(x), 0.2)
        x = F.leaky_relu(self.conv2(x), 0.2)
        return self.out(x).reshape(B, -1)


class VisionAidedDiscriminator(nn.Module):
    """Multilevel logits: one patch map per tapped layer (class token
    dropped), then a head on the pooled output; a list of (B, P_i)."""

    def __init__(self, cfg: VisionAidedConfig = VisionAidedConfig()):
        super().__init__()
        self.cfg = cfg
        D = cfg.clip.hidden_size
        self.backbone = CLIPVisionModel(cfg.clip,
                                        in_channels=cfg.in_channels)
        for i in range(len(cfg.taps)):
            self.add_module(f'head_{i}', _LevelHead(D, cfg.head_width))
        self.cls_fc = nn.Linear(D, cfg.head_width)
        self.head_cls = nn.Linear(cfg.head_width, 1)

    def forward(self, images):
        cfg = self.cfg
        feats = self.backbone(clip_preprocess(images, cfg),
                              output_hidden_states=True)
        logits = [getattr(self, f'head_{i}')(
            feats['hidden_states'][layer - 1][:, 1:])
            for i, layer in enumerate(cfg.taps)]
        cls = F.leaky_relu(self.cls_fc(feats['pooler_output']), 0.2)
        logits.append(self.head_cls(cls))
        return logits


def multilevel_d_loss(logits_real: list, logits_fake: list,
                      smoothing: float = 0.1) -> torch.Tensor:
    """Σ over levels of BCE with logits; the real targets smoothed to
    ``1 − smoothing`` (one-sided: the fake targets stay 0)."""
    loss = 0.0
    t = 1.0 - smoothing
    for lr, lf in zip(logits_real, logits_fake):
        loss = loss + torch.mean(F.softplus(lr) - t * lr)
        loss = loss + torch.mean(F.softplus(lf))
    return loss


def multilevel_g_loss(logits_fake: list) -> torch.Tensor:
    """Non-saturating: Σ over levels of softplus(−D(fake))."""
    loss = 0.0
    for lf in logits_fake:
        loss = loss + torch.mean(F.softplus(-lf))
    return loss


def trainable_labels(names, in_channels: int = 3) -> dict:
    """'trainable' for the heads' parameters (and the patch embedding of
    a widened 6-channel input), 'frozen' for the CLIP backbone's."""
    def label(name):
        if not name.startswith('backbone.'):
            return 'trainable'
        if in_channels != 3 and 'patch_embedding' in name:
            return 'trainable'
        return 'frozen'

    return {n: label(n) for n in names}


class VisionAidedHead:
    """``AdversarialHead``'s interface over the frozen-CLIP multilevel
    discriminator.  Weights from ``seed`` (``random_init_``); converted
    CLIP weights as ``backbone_state_dict`` (the port's names)."""

    def __init__(self, cfg: VisionAidedConfig = VisionAidedConfig(),
                 seed: int = 0, backbone_state_dict: Optional[dict] = None,
                 device='cuda'):
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.model = VisionAidedDiscriminator(cfg)
        random_init_(self.model, torch.Generator(
            device=self.device).manual_seed(seed))
        if backbone_state_dict is not None:
            self.model.backbone.load_state_dict(backbone_state_dict)
        labels = trainable_labels(
            [n for n, _ in self.model.named_parameters()], cfg.in_channels)
        for n, p in self.model.named_parameters():
            p.requires_grad_(labels[n] == 'trainable')
        tx = make_optimizer(cfg.disc_lr, weight_decay=0.0, grad_clip=None,
                            betas=(0.0, 0.999))
        self.state = TrainState.create(self.model, tx)

    def generator_loss(self, fake: torch.Tensor, draws=None):
        """``adv_lambda·Σ softplus(−D(fake))`` through the live, frozen
        discriminator (``draws``: unused, there is no augmentation)."""
        return self.cfg.adv_lambda * multilevel_g_loss(
            frozen_apply(self.model, fake))

    def d_loss(self, real, fake, draws=None):
        """(the multilevel loss, metrics); ``draws``: unused."""
        lr = self.model(real)
        lf = self.model(fake.detach())
        loss = multilevel_d_loss(lr, lf, self.cfg.label_smoothing)
        return loss, {'d_loss': loss,
                      'logits_real': sum(x.mean() for x in lr) / len(lr),
                      'logits_fake': sum(x.mean() for x in lf) / len(lf)}

    def disc_step(self, real: torch.Tensor, fake: torch.Tensor,
                  draws=None) -> dict:
        loss, metrics = self.d_loss(real, fake)
        apply_disc_grads(self.state, loss)
        return {k: v.detach() for k, v in metrics.items()}
