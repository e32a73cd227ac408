"""Reconstruction losses of stage-1 VAE training.

Port of ``ln3diff_tpu/training/losses.py`` (reference
``nsr/losses/builder.py`` ``E3DGELossClass:354``): foreground-weighted L2
and L1, the alpha/mask loss, the scale-and-shift-invariant depth loss,
SILog, SSIM, the KL term with its linear anneal (``kl_coeff``) and an
injected LPIPS.  ``lpips_fn`` is optional: without it the term is skipped,
as in JAX, so no VGG weights are needed.  Images are channels-last.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LossConfig:
    l2_lambda: float = 1.0
    l1_lambda: float = 0.0
    mask_lambda: float = 1.0        # alpha/silhouette loss
    depth_lambda: float = 0.5
    kl_lambda: float = 1e-6
    kl_anneal_steps: int = 0        # 0 → constant
    lpips_lambda: float = 0.8
    ssim_lambda: float = 0.0
    fg_mask_loss: bool = True       # weight the rgb loss by the fg mask


def masked_mse(pred, target, mask=None):
    if mask is None:
        return torch.mean((pred - target)**2)
    w = mask / (mask.mean() + 1e-8)  # conf-style normalisation
    return torch.mean(w * (pred - target)**2)


def masked_l1(pred, target, mask=None):
    if mask is None:
        return torch.mean(torch.abs(pred - target))
    w = mask / (mask.mean() + 1e-8)
    return torch.mean(w * torch.abs(pred - target))


def silog_depth_loss(pred_depth, gt_depth, fg_mask, lambd: float = 0.5):
    """Scale-invariant log depth loss over the foreground (reference
    two-stage depth loss, ``nsr/losses/sdfstudio_losses.py`` SILog)."""
    valid = (fg_mask > 0.5) & (gt_depth > 1e-3)
    d = torch.where(valid,
                    torch.log(torch.clamp(pred_depth, min=1e-3))
                    - torch.log(torch.clamp(gt_depth, min=1e-3)),
                    torch.zeros_like(pred_depth))
    n = torch.clamp(valid.sum().to(d.dtype), min=1.0)
    mean_sq = torch.sum(d**2) / n
    sq_mean = (torch.sum(d) / n)**2
    return mean_sq - lambd * sq_mean


def scale_shift_invariant_depth_loss(pred, gt, mask):
    """Least-squares align pred to gt in scale and shift over the
    foreground, then L2."""
    m = (mask > 0.5).to(pred.dtype)
    n = torch.clamp(m.sum(), min=1.0)
    p_mean = (pred * m).sum() / n
    g_mean = (gt * m).sum() / n
    p_c = pred - p_mean
    g_c = gt - g_mean
    scale = (m * p_c * g_c).sum() / torch.clamp((m * p_c**2).sum(), min=1e-6)
    aligned = scale * p_c + g_mean
    return (m * (aligned - gt)**2).sum() / n


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5,
         val_range: float = 2.0):
    """SSIM of NHWC images: Gaussian window, per channel, VALID
    (depthwise ``F.conv2d``), averaged."""
    half = window_size // 2
    coords = torch.arange(window_size, dtype=torch.float32,
                          device=img1.device) - half
    g = torch.exp(-(coords**2) / (2 * sigma**2))
    g = g / g.sum()
    kernel = torch.outer(g, g)                       # (K, K)
    C = img1.shape[-1]
    weight = kernel.expand(C, 1, window_size, window_size).to(img1.dtype)

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), weight, groups=C)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1**2, mu2**2, mu1 * mu2
    s1 = filt(img1**2) - mu1_sq
    s2 = filt(img2**2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    C1 = (0.01 * val_range)**2
    C2 = (0.03 * val_range)**2
    ssim_map = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return ssim_map.mean()


def kl_coeff(step, total_steps, constant_step, min_kl_coeff, max_kl_coeff):
    """Linear KL anneal (reference ``builder.py:192``)."""
    if total_steps <= constant_step:
        return torch.as_tensor(max_kl_coeff)
    frac = torch.clamp(torch.as_tensor((step - constant_step)
                                       / max(total_steps - constant_step, 1)),
                       0.0, 1.0)
    return min_kl_coeff + (max_kl_coeff - min_kl_coeff) * frac


def reconstruction_losses(pred: dict, target: dict, cfg: LossConfig,
                          kl: Optional[torch.Tensor] = None,
                          step=None,
                          lpips_fn: Optional[Callable] = None):
    """The weighted VAE loss.

    pred: image_raw (B, H, W, 3), image_mask, image_depth, optionally
      image_sr.
    target: img (B, H, W, 3) in [-1, 1], depth_mask, depth.
    Returns (total loss, dict of the unweighted terms).
    """
    terms = {}
    total = 0.0

    gt_img = target['img']
    fg_mask = target.get('depth_mask')
    rgb_mask = None
    if cfg.fg_mask_loss and fg_mask is not None:
        rgb_mask = fg_mask
        if rgb_mask.ndim == 3:
            rgb_mask = rgb_mask[..., None]

    pred_img = pred['image_raw']
    if cfg.l2_lambda:
        terms['l2'] = masked_mse(pred_img, gt_img, rgb_mask)
        total = total + cfg.l2_lambda * terms['l2']
    if cfg.l1_lambda:
        terms['l1'] = masked_l1(pred_img, gt_img, rgb_mask)
        total = total + cfg.l1_lambda * terms['l1']

    if 'image_sr' in pred and 'img_sr' in target:
        terms['l2_sr'] = masked_mse(pred['image_sr'], target['img_sr'], None)
        total = total + cfg.l2_lambda * terms['l2_sr']

    if cfg.mask_lambda and fg_mask is not None and 'image_mask' in pred:
        m = fg_mask if fg_mask.ndim == 4 else fg_mask[..., None]
        terms['mask'] = torch.mean((pred['image_mask'] - m)**2)
        total = total + cfg.mask_lambda * terms['mask']

    if (cfg.depth_lambda and 'depth' in target
            and 'image_depth' in pred and fg_mask is not None):
        gt_d = target['depth']
        if gt_d.ndim == 3:
            gt_d = gt_d[..., None]
        m = fg_mask if fg_mask.ndim == 4 else fg_mask[..., None]
        terms['depth'] = scale_shift_invariant_depth_loss(
            pred['image_depth'], gt_d, m)
        total = total + cfg.depth_lambda * terms['depth']

    if cfg.ssim_lambda:
        terms['ssim'] = 1.0 - ssim(pred_img, gt_img)
        total = total + cfg.ssim_lambda * terms['ssim']

    if cfg.lpips_lambda and lpips_fn is not None:
        terms['lpips'] = lpips_fn(pred_img, gt_img)
        total = total + cfg.lpips_lambda * terms['lpips']

    if kl is not None and cfg.kl_lambda:
        terms['kl'] = torch.mean(kl)
        coeff = cfg.kl_lambda
        if cfg.kl_anneal_steps and step is not None:
            coeff = kl_coeff(step, cfg.kl_anneal_steps,
                             cfg.kl_anneal_steps // 2, cfg.kl_lambda * 1e-2,
                             cfg.kl_lambda)
        total = total + coeff * terms['kl']

    return total, terms
