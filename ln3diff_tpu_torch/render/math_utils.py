"""Ray/box math for the volume renderer.

Port of ``ln3diff_tpu/render/math_utils.py`` (reference
``nsr/volumetric_rendering/math_utils.py``): slab ray-box intersection,
invalid-limit repair and tensor linspace.
"""

from __future__ import annotations

import torch


def normalize_vecs(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + eps)


def get_ray_limits_box(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       box_side_length: float):
    """Intersect rays with the centred cube of side ``box_side_length``.

    Invalid rays get (tmin, tmax) = (-1, -2) so ``tmax > tmin`` is False.
    Returns (tmin, tmax), each ``(..., 1)``.
    """
    half = box_side_length / 2.0
    invdir = 1.0 / rays_d
    t_lo = (-half - rays_o) * invdir
    t_hi = (half - rays_o) * invdir
    t_near_ax = torch.minimum(t_lo, t_hi)
    t_far_ax = torch.maximum(t_lo, t_hi)

    tmin_xy = torch.maximum(t_near_ax[..., 0], t_near_ax[..., 1])
    tmax_xy = torch.minimum(t_far_ax[..., 0], t_far_ax[..., 1])
    valid = ~((t_near_ax[..., 0] > t_far_ax[..., 1])
              | (t_near_ax[..., 1] > t_far_ax[..., 0]))
    valid &= ~((tmin_xy > t_far_ax[..., 2]) | (t_near_ax[..., 2] > tmax_xy))

    tmin = torch.maximum(tmin_xy, t_near_ax[..., 2])
    tmax = torch.minimum(tmax_xy, t_far_ax[..., 2])
    tmin = torch.where(valid, tmin, torch.full_like(tmin, -1.0))
    tmax = torch.where(valid, tmax, torch.full_like(tmax, -2.0))
    return tmin[..., None], tmax[..., None]


def fix_invalid_ray_limits(ray_start: torch.Tensor, ray_end: torch.Tensor):
    """Invalid rays (start >= end) get start = min(valid starts) and
    end = max(valid starts), over the whole call (reference
    ``renderer.py:151-155``)."""
    is_valid = ray_end > ray_start
    big = torch.full_like(ray_start, 1e10)
    valid_starts_min = torch.min(torch.where(is_valid, ray_start, big))
    valid_starts_max = torch.max(torch.where(is_valid, ray_start, -big))
    ray_start = torch.where(is_valid, ray_start, valid_starts_min)
    ray_end = torch.where(is_valid, ray_end, valid_starts_max)
    return ray_start, ray_end


def linspace_vec(start: torch.Tensor, stop: torch.Tensor,
                 num: int) -> torch.Tensor:
    """Evenly spaced values over tensor endpoints: ``(num, *start.shape)``."""
    steps = torch.arange(num, dtype=torch.float32,
                         device=start.device) / (num - 1)
    steps = steps.reshape((num,) + (1,) * start.ndim)
    return start[None] + steps * (stop - start)[None]
