"""Confidence network (unsup3d-style) for confidence-weighted losses.

Port of ``ln3diff_tpu/models/confnet.py`` (``ConfNet`` :20,
``confidence_weighted_l2`` :42; reference ``nsr/confnet.py``): a small
conv encoder-decoder that predicts a per-pixel confidence; the loss
divides the squared residual by the confidence and regularises its log
(aleatoric weighting).  Off the released paths.  Linen's defaults carry
over: 'SAME' padding, GroupNorm eps 1e-6 and the tanh-approximate GELU.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .controlnet import same_pad


class ConfNet(nn.Module):
    """``forward(x)``: (B, H, W, 3) image in [-1, 1] → confidence
    (B, H, W, 1) > 0, for H and W divisible by 4."""

    def __init__(self, base_ch: int = 32, in_channels: int = 3):
        super().__init__()
        cin = in_channels
        for i, ch in enumerate((base_ch, 2 * base_ch)):
            self.add_module(f'down_{i}', nn.Conv2d(cin, ch, 4, stride=2))
            self.add_module(f'gn_{i}', nn.GroupNorm(8, ch, eps=1e-6))
            cin = ch
        for i in range(2):
            self.add_module(f'up_{i}', nn.Conv2d(cin, base_ch, 3, padding=1))
            cin = base_ch
        self.out = nn.Conv2d(base_ch, 1, 3, padding=1)

    def forward(self, x):
        h = x.permute(0, 3, 1, 2).to(self.out.weight.dtype)
        for i in range(2):
            h = getattr(self, f'down_{i}')(same_pad(h, 4, 2))
            h = F.gelu(getattr(self, f'gn_{i}')(h), approximate='tanh')
        for i in range(2):
            h = F.interpolate(h, scale_factor=2, mode='nearest')
            h = F.gelu(getattr(self, f'up_{i}')(h), approximate='tanh')
        out = self.out(h).permute(0, 2, 3, 1)
        return F.softplus(out) + 1e-6


def confidence_weighted_l2(pred, target, conf):
    """Aleatoric L2: |e|²/(2σ²) + log σ (unsup3d eq. 2)."""
    err = ((pred - target)**2).mean(dim=-1, keepdim=True)
    return (err / (2 * conf**2) + torch.log(conf)).mean()
