"""Rodin roll-out convolution super-resolution of the ShapeNet/FFHQ VAEs.

Port of ``ln3diff_tpu/models/rodin.py`` (``_roll_out_3d`` :29,
``RodinRollOutConv3D`` :47, ``RodinGroupConv`` :60, ``_resize_bilinear``
:72, ``RodinConv3D4XResidual`` :82).  The modules take and return
channels-last tensors with plane-major 3C channels, as the JAX modules do;
inside, they run NCHW.  Two absorbed quirks of the reference, on which the
released weights depend, are reproduced exactly:

  * the conv path transposes H and W before its convs, the residual path
    does not;
  * the linear shortcut views the plane-major 3C channels as (C, 3), plane
    fastest.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _roll_out_3d(x: torch.Tensor) -> torch.Tensor:
    """(B, 3C, H, W) plane-major → (B, 9C, H, W): for each plane i,
    [plane_i, mean over W of plane_{i+1}, mean over H of plane_{i+2}],
    each broadcast back to H × W."""
    B, C3, H, W = x.shape
    planes = x.reshape(B, 3, C3 // 3, H, W)
    yz = planes.mean(dim=4, keepdim=True).expand_as(planes)
    zx = planes.mean(dim=3, keepdim=True).expand_as(planes)
    out = torch.stack([planes, yz.roll(-1, dims=1), zx.roll(-2, dims=1)],
                      dim=2)
    return out.reshape(B, 3 * C3, H, W)


class RodinRollOutConv3D(nn.Module):
    """3x3 conv over the rolled-out planes, grouped by plane (NCHW)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(3 * in_channels, out_channels, 3, padding=1,
                              groups=3)

    def forward(self, x):
        return self.conv(_roll_out_3d(x))


class RodinGroupConv(nn.Module):
    """Per-plane 3x3 conv (groups 3), no roll-out (NCHW)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                              groups=3)

    def forward(self, x):
        return self.conv(x)


def _resize_bilinear(x: torch.Tensor, res: int) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to res².  JAX's ``jax.image.resize``
    (a triangle kernel renormalised at the borders) equals
    ``align_corners=False`` interpolation when upsampling, the only
    direction taken here (64 → 256)."""
    if x.shape[2] == res and x.shape[3] == res:
        return x
    return F.interpolate(x, size=(res, res), mode='bilinear',
                         align_corners=False)


class RodinConv3D4XResidual(nn.Module):
    """``RodinConv3D4X_lite_mlp_as_residual``: (B, h, w, 3Cin) → (B, R, R,
    3Cout) at ``input_resolution`` R.  ``lite=True`` (ShapeNet) makes the
    first conv a per-plane grouped conv, ``lite=False`` (FFHQ) a roll-out
    conv; leaky ReLU slope 0.01."""

    def __init__(self, in_channels: int, out_channels: int,
                 input_resolution: int = 256, lite: bool = True):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.input_resolution = input_resolution
        if in_channels != out_channels:
            self.short_cut = nn.Linear(in_channels // 3, out_channels // 3)
        self.conv3D_0 = (RodinGroupConv(in_channels, out_channels) if lite
                         else RodinRollOutConv3D(in_channels, out_channels))
        self.conv3D_1 = RodinRollOutConv3D(out_channels, out_channels)

    def forward(self, x):
        B, h, w, _ = x.shape
        R = self.input_resolution
        x = x.permute(0, 3, 1, 2)
        if self.in_channels != self.out_channels:
            # channels viewed (Cin, 3), plane fastest → per-plane Linear →
            # plane-major (3, Cout) channels
            s = x.reshape(B, self.in_channels // 3, 3, h, w)
            s = self.short_cut(s.permute(0, 2, 3, 4, 1))     # B 3 h w Cout
            res = _resize_bilinear(
                s.permute(0, 1, 4, 2, 3).reshape(B, -1, h, w), R)
        else:
            res = _resize_bilinear(x, R)
        xt = _resize_bilinear(x.transpose(2, 3), R)
        x0 = res + F.leaky_relu(self.conv3D_0(xt), 0.01)
        out = x0 + F.leaky_relu(self.conv3D_1(x0), 0.01)
        return out.permute(0, 2, 3, 1)
