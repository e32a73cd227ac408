"""Full-image ray generation from 25-dim cameras (OpenCV convention).

Port of ``ln3diff_tpu/render/ray_sampler.py`` (reference
``RaySampler.forward``, ``nsr/volumetric_rendering/ray_sampler.py:197-257``).
"""

from __future__ import annotations

import torch

from .math_utils import normalize_vecs


def unpack_25d_camera(c: torch.Tensor):
    """``c = [cam2world.flatten(16), intrinsics.flatten(9)]`` →
    (cam2world (..., 4, 4), intrinsics (..., 3, 3))."""
    cam2world = c[..., :16].reshape(*c.shape[:-1], 4, 4)
    intrinsics = c[..., 16:25].reshape(*c.shape[:-1], 3, 3)
    return cam2world, intrinsics


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
