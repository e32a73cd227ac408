"""Render-space super-resolution: ``NearestConvSR`` and its residual
form.

Port of ``ln3diff_tpu/models/sr.py``: ``NearestConvSR`` :24 (reference
``utils/torch_utils/components.py:367``), the SR head of the ShapeNet VAE,
and ``NearestConvSRResidual`` :51 (:402).  Channels-last in and out, NCHW
inside.  The StyleGAN heads of FFHQ and ``PixelUnshuffleUpsample`` are in
``stylegan.py``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _conv3(cin, cout):
    return nn.Conv2d(cin, cout, 3, padding=1)


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode='nearest')


class NearestConvSR(nn.Module):
    """Nearest-upsample + conv SR: feature image (B, H, W, C) → (B,
    sr_ratio·H, sr_ratio·W, num_out_ch), unbounded.  The leaky ReLU after
    ``conv_before_upsample`` has slope 0.01 (the reference's torch default),
    every other one 0.2.  The input is cast to the layers' dtype."""

    def __init__(self, in_channels: int, num_feat: int = 128,
                 num_out_ch: int = 3, sr_ratio: int = 2):
        super().__init__()
        self.sr_ratio = sr_ratio
        self.conv_after_body = _conv3(in_channels, in_channels)
        self.conv_before_upsample = _conv3(in_channels, num_feat)
        self.conv_up1 = _conv3(num_feat, num_feat)
        if sr_ratio == 4:
            self.conv_up2 = _conv3(num_feat, num_feat)
        self.conv_hr = _conv3(num_feat, num_feat)
        self.conv_last = _conv3(num_feat, num_out_ch)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.conv_last.weight.dtype)
        x = self.conv_after_body(x) + x
        x = F.leaky_relu(self.conv_before_upsample(x), 0.01)
        x = F.leaky_relu(self.conv_up1(_up2(x)), 0.2)
        if self.sr_ratio == 4:
            x = F.leaky_relu(self.conv_up2(_up2(x)), 0.2)
        x = F.leaky_relu(self.conv_hr(x), 0.2)
        return self.conv_last(x).permute(0, 2, 3, 1)


class NearestConvSRResidual(NearestConvSR):
    """tanh of ``NearestConvSR``'s output added to the bilinear upsample of
    the base render ``base_x`` (B, H, W, C) to the SR size."""

    def forward(self, x, base_x):
        r = torch.tanh(super().forward(x))
        scale = r.shape[1] // base_x.shape[1]
        up = F.interpolate(base_x.permute(0, 3, 1, 2), scale_factor=scale,
                           mode='bilinear', align_corners=False)
        return r + up.permute(0, 2, 3, 1)
