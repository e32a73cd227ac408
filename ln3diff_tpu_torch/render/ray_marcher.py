"""MipNeRF-style midpoint-quadrature ray marcher.

Port of ``ln3diff_tpu/render/ray_marcher.py`` (reference
``MipRayMarcher2.run_forward``, ``nsr/volumetric_rendering/ray_marcher.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class MarchResult(NamedTuple):
    rgb: torch.Tensor          # (B, R, C) in [-1, 1]
    depth: torch.Tensor        # (B, R, 1)
    visibility: torch.Tensor   # (B, R, 1)
    weights: torch.Tensor      # (B, R, S-1, 1)


def march_rays(colors: torch.Tensor, densities: torch.Tensor,
               depths: torch.Tensor, white_back: bool = True) -> MarchResult:
    """Composite ``(B, R, S, C)`` colours with ``(B, R, S, 1)`` raw
    densities at sorted ``(B, R, S, 1)`` depths."""
    deltas = depths[:, :, 1:] - depths[:, :, :-1]
    colors_mid = (colors[:, :, :-1] + colors[:, :, 1:]) * 0.5
    densities_mid = (densities[:, :, :-1] + densities[:, :, 1:]) * 0.5
    depths_mid = (depths[:, :, :-1] + depths[:, :, 1:]) * 0.5

    densities_mid = F.softplus(densities_mid - 1.0)
    alpha = 1.0 - torch.exp(-densities_mid * deltas)

    alpha_shifted = torch.cat(
        [torch.ones_like(alpha[:, :, :1]), 1.0 - alpha + 1e-10], dim=-2)
    transmittance = torch.cumprod(alpha_shifted, dim=-2)
    weights = alpha * transmittance[:, :, :-1]
    visibility = transmittance[:, :, -1]

    composite_rgb = torch.sum(weights * colors_mid, dim=-2)
    weight_total = torch.sum(weights, dim=2)
    composite_depth = torch.sum(weights * depths_mid, dim=-2)
    composite_depth = torch.nan_to_num(composite_depth, nan=float('inf'))
    composite_depth = torch.clamp(composite_depth, torch.min(depths),
                                  torch.max(depths))

    if white_back:
        composite_rgb = composite_rgb + 1.0 - weight_total
    composite_rgb = composite_rgb * 2.0 - 1.0
    return MarchResult(composite_rgb, composite_depth, visibility, weights)
