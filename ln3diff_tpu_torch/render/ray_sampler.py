"""Ray generation from 25-dim cameras (OpenCV convention).

Port of ``ln3diff_tpu/render/ray_sampler.py``: full-image rays (reference
``RaySampler.forward``, ``nsr/volumetric_rendering/ray_sampler.py:197-257``)
and the training path's patch rays (``pack_25d_camera`` :33, ``patch_uv``
:86, ``sample_patch_rays`` :105 and the host-side patch-origin policy
``sample_patch_origins`` :113, numpy, which replays JAX's draws from the
same ``numpy.random.Generator``).
"""

from __future__ import annotations

import numpy as np
import torch

from .math_utils import normalize_vecs


def unpack_25d_camera(c: torch.Tensor):
    """``c = [cam2world.flatten(16), intrinsics.flatten(9)]`` →
    (cam2world (..., 4, 4), intrinsics (..., 3, 3))."""
    cam2world = c[..., :16].reshape(*c.shape[:-1], 4, 4)
    intrinsics = c[..., 16:25].reshape(*c.shape[:-1], 3, 3)
    return cam2world, intrinsics


def pack_25d_camera(cam2world: torch.Tensor,
                    intrinsics: torch.Tensor) -> torch.Tensor:
    """(cam2world (..., 4, 4), intrinsics (..., 3, 3)) → ``(..., 25)``."""
    return torch.cat([cam2world.reshape(*cam2world.shape[:-2], 16),
                      intrinsics.reshape(*intrinsics.shape[:-2], 9)], dim=-1)


def _lift_uv_to_rays(uv: torch.Tensor, cam2world: torch.Tensor,
                     intrinsics: torch.Tensor):
    N, M = uv.shape[0], uv.shape[1]
    cam_locs_world = cam2world[:, :3, 3]
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]

    x_cam = uv[:, :, 0]
    y_cam = uv[:, :, 1]
    z_cam = torch.ones((N, M), dtype=uv.dtype, device=uv.device)

    x_lift = (x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx * z_cam
    y_lift = (y_cam - cy) / fy * z_cam

    cam_rel = torch.stack([x_lift, y_lift, z_cam, torch.ones_like(z_cam)],
                          dim=-1)
    world = torch.einsum('nij,nmj->nmi', cam2world, cam_rel)[..., :3]

    ray_dirs = normalize_vecs(world - cam_locs_world[:, None, :])
    ray_origins = cam_locs_world[:, None, :].expand(ray_dirs.shape)
    return ray_origins, ray_dirs


def full_image_uv(resolution: int, batch: int,
                  device=None) -> torch.Tensor:
    """Pixel-centre uv in [0, 1], x-major flattening: (batch, res², 2)."""
    ar = torch.arange(resolution, dtype=torch.float32, device=device)
    ii, jj = torch.meshgrid(ar, ar, indexing='ij')
    uv = torch.stack([jj, ii], dim=-1)
    uv = uv.reshape(-1, 2) * (1.0 / resolution) + (0.5 / resolution)
    return uv[None].expand(batch, resolution * resolution, 2)


def sample_full_rays(cam2world: torch.Tensor, intrinsics: torch.Tensor,
                     resolution: int):
    """Full-image rays: (origins (N, R, 3), dirs (N, R, 3))."""
    uv = full_image_uv(resolution, cam2world.shape[0], cam2world.device)
    return _lift_uv_to_rays(uv, cam2world, intrinsics)


def patch_uv(h_start: torch.Tensor, w_start: torch.Tensor,
             patch_resolution: int, resolution: int) -> torch.Tensor:
    """Pixel-centre uv in [0, 1] of ``patch_resolution²`` patches at
    integer origins ``(N,)``, x-major: ``(N, patch_resolution², 2)``."""
    ar = torch.arange(patch_resolution, dtype=torch.float32,
                      device=h_start.device)
    ii, jj = torch.meshgrid(ar, ar, indexing='ij')
    base = torch.stack([jj, ii], dim=-1).reshape(-1, 2)
    start = torch.stack([w_start, h_start], dim=-1).float()
    return ((base[None] + start[:, None, :]) * (1.0 / resolution)
            + (0.5 / resolution))


def sample_patch_rays(cam2world: torch.Tensor, intrinsics: torch.Tensor,
                      h_start: torch.Tensor, w_start: torch.Tensor,
                      patch_resolution: int, resolution: int):
    """Rays of the patches at ``(h_start, w_start)`` of a
    ``resolution²`` image: (origins (N, P², 3), dirs (N, P², 3))."""
    uv = patch_uv(h_start, w_start, patch_resolution, resolution)
    return _lift_uv_to_rays(uv, cam2world, intrinsics)


def sample_patch_origins(rng: np.random.Generator, batch: int,
                         patch_resolution: int, resolution: int,
                         fg_bbox=None, fg_prob: float = 0.875):
    """Host-side patch origins, biased to the foreground (reference
    ``create_patch_uv``, ``ray_sampler.py:72-166``): with probability
    ``fg_prob`` a patch overlaps the fg bbox ``(batch, 4)`` [top, left,
    height_max, width_max], else it lies anywhere.  The same draws from
    the same ``rng`` as the JAX package.  Returns int32 ``(h_start,
    w_start)``, each ``(batch,)``."""
    def sample_end(lo, hi):
        end = int(rng.integers(lo, hi + 1))
        return min(max(end, patch_resolution), resolution)

    h_starts, w_starts = [], []
    for b in range(batch):
        use_fg = fg_bbox is not None and rng.random() < fg_prob
        if use_fg:
            top, left, hmax, wmax = [int(v) for v in fg_bbox[b]]
            if top + patch_resolution < hmax:
                h_end = sample_end(top + patch_resolution, hmax)
            else:
                h_end = max(hmax, patch_resolution)
            if left + patch_resolution < wmax:
                w_end = sample_end(left + patch_resolution, wmax)
            else:
                w_end = max(wmax, patch_resolution)
        else:
            h_end = sample_end(patch_resolution, resolution + patch_resolution)
            w_end = sample_end(patch_resolution, resolution + patch_resolution)
        h_starts.append(h_end - patch_resolution)
        w_starts.append(w_end - patch_resolution)
    return (np.asarray(h_starts, np.int32), np.asarray(w_starts, np.int32))
