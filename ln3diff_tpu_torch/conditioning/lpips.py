"""LPIPS perceptual distance: a VGG16 feature stack and per-layer linear
heads.

Port of ``ln3diff_tpu/conditioning/lpips.py`` (``VGG16Features`` :31,
``LPIPS`` :51, ``make_lpips_fn`` :109), ``lpips.LPIPS(net='vgg',
spatial=False)``'s arithmetic: inputs shifted and scaled, features after
the last ReLU of each of the five stages, unit-normalised over channels,
squared differences weighted by the heads' absolute weights, averaged
over space and summed over layers.  Without converted weights
``make_lpips_fn`` draws the VGG16 at random (``random_init_``) and sets
the heads to 1, as the JAX init does.  Loading ``lpips``' torch
state dict (``convert_lpips_torch``) waits for the port's state-dict
loader (``ROADMAP.md`` §1 item 4).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import random_init_
from ..pipeline import resolve_device

# (channels, convs) per stage; features after each stage's last ReLU
_VGG_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """conv0 … conv12 (3x3, 'SAME'), ReLU, 2x2 max pools between the
    stages; NCHW in, the five stage outputs out."""

    def __init__(self):
        super().__init__()
        cin, idx = 3, 0
        for ch, n in _VGG_PLAN:
            for _ in range(n):
                self.add_module(f'conv{idx}', nn.Conv2d(cin, ch, 3,
                                                        padding=1))
                cin, idx = ch, idx + 1

    def forward(self, x):
        feats, idx = [], 0
        for stage, (_, n) in enumerate(_VGG_PLAN):
            for _ in range(n):
                x = F.relu(getattr(self, f'conv{idx}')(x))
                idx += 1
            feats.append(x)
            if stage < len(_VGG_PLAN) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


class LPIPS(nn.Module):
    """img0, img1 (B, H, W, 3) in [-1, 1] → (B,) distances.  The heads
    ``lin{i}`` keep the JAX shape (1, 1, 1, C)."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(_VGG_PLAN):
            self.register_parameter(f'lin{i}', nn.Parameter(
                torch.ones(1, 1, 1, ch)))

    def reset_free_parameters(self, generator=None):
        for i in range(len(_VGG_PLAN)):
            getattr(self, f'lin{i}').fill_(1.0)

    def forward(self, img0, img1):
        dt = self.vgg.conv0.weight.dtype
        shift = torch.tensor(_SHIFT, device=img0.device)
        scale = torch.tensor(_SCALE, device=img0.device)

        def features(img):
            x = ((img.float() - shift) / scale).permute(0, 3, 1, 2)
            return self.vgg(x.to(dt))

        total = 0.0
        for i, (a, b) in enumerate(zip(features(img0), features(img1))):
            a, b = a.float(), b.float()
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True)
                     + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True)
                     + 1e-10)
            w = getattr(self, f'lin{i}').reshape(1, -1, 1, 1)
            d = torch.sum(torch.abs(w) * (a - b)**2, dim=1, keepdim=True)
            total = total + d.mean(dim=(1, 2, 3))
        return total


def make_lpips_fn(state_dict: Optional[dict] = None, device='cuda',
                  seed: int = 0, dtype=torch.float32) -> Callable:
    """``lpips(img0, img1) -> scalar`` (the batch mean) for the VAE
    trainer's ``lpips_fn``: a frozen LPIPS on ``device`` with the given
    weights (the port's names) or random ones drawn from ``seed``; the
    grads reach the images only."""
    device = resolve_device(device)
    with torch.device(device):
        model = LPIPS()
    random_init_(model, torch.Generator(device=device).manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.vgg.to(dtype)
    model.requires_grad_(False)

    def fn(img0, img1):
        return model(img0, img1).mean()

    fn.model = model
    return fn
