"""Bilinear and trilinear grid sampling, channels-last.

Port of ``ln3diff_tpu/ops/grid_sample.py`` (``grid_sample_2d`` :24,
``grid_sample_2d_batched`` :74, ``grid_sample_3d`` :87).  The JAX
functions are four (eight) clamped gathers and a lerp with the convention
of ``torch.nn.functional.grid_sample(mode='bilinear',
padding_mode='zeros', align_corners=False)``: x indexes the width, y the
height (z the depth), pixel centres at ``(i + 0.5)·2/W − 1``, zero
outside.  So the port calls ``F.grid_sample`` with that convention
(``tests/test_torch_augment.py`` holds it to JAX's gathers), on
channels-last features as JAX has them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _sample(features: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    return F.grid_sample(features, grid.to(features.dtype), mode='bilinear',
                         padding_mode='zeros', align_corners=False)


def grid_sample_2d(features: torch.Tensor, coords: torch.Tensor
                   ) -> torch.Tensor:
    """features (H, W, C), coords (P, 2) xy in [-1, 1] → (P, C)."""
    return grid_sample_2d_batched(features[None], coords[None])[0]


def grid_sample_2d_batched(features: torch.Tensor, coords: torch.Tensor
                           ) -> torch.Tensor:
    """features (N, H, W, C), coords (N, P, 2) → (N, P, C)."""
    out = _sample(features.permute(0, 3, 1, 2), coords[:, None])
    return out[:, :, 0].transpose(1, 2)


def grid_sample_3d(grid: torch.Tensor, coords: torch.Tensor
                   ) -> torch.Tensor:
    """grid (D, H, W, C) indexed (z, y, x), coords (P, 3) xyz in [-1, 1]
    → (P, C) (reference ``sample_from_3dgrid``)."""
    out = _sample(grid.permute(3, 0, 1, 2)[None],
                  coords[None, None, None])
    return out[0, :, 0, 0].t()
