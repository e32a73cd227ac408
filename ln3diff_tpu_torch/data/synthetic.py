"""Procedural multi-view dataset (numpy ray-traced sphere scenes).

The port's own copy of ``ln3diff_tpu/data/synthetic.py`` (same numpy code,
so both packages make the same batch byte for byte from one seed): a
deterministic in-memory instance for training the VAE end to end without
downloads, in the reference batch schema: ``img_to_encoder`` (V, H, W,
10 = RGB + depth + 6-ch Plücker), ``img``, ``depth``, ``depth_mask``,
``c`` (25-dim camera), ``bbox``, and optionally the held-out ``nv_*``
views.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..render.camera import fov_to_intrinsics, lookat_pose


def _rays_for_camera(cam2world, intrinsics, resolution):
    """Pixel-center rays (numpy mirror of the jax ray sampler)."""
    ii, jj = np.meshgrid(np.arange(resolution), np.arange(resolution),
                         indexing='ij')
    uv_x = (jj + 0.5) / resolution
    uv_y = (ii + 0.5) / resolution
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x = (uv_x - cx) / fx
    y = (uv_y - cy) / fy
    z = np.ones_like(x)
    dirs = np.stack([x, y, z], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs @ cam2world[:3, :3].T
    origins = np.broadcast_to(cam2world[:3, 3], dirs.shape)
    return origins.astype(np.float32), dirs.astype(np.float32)


def _trace_sphere(origins, dirs, center, radius):
    """Ray-sphere intersection: returns (hit mask, depth)."""
    oc = origins - center
    b = np.sum(oc * dirs, axis=-1)
    c = np.sum(oc * oc, axis=-1) - radius**2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit &= t > 0
    return hit, np.where(hit, t, 0.0)


def _shade(points, normals):
    """Position-colored lambertian shading in [0, 1]."""
    albedo = 0.5 + 0.5 * np.clip(points * 2.5, -1, 1)
    light = np.array([0.5, 0.7, -0.5])
    light = light / np.linalg.norm(light)
    lam = np.clip(np.sum(normals * light, axis=-1, keepdims=True), 0, 1)
    return albedo * (0.35 + 0.65 * lam)


@dataclasses.dataclass
class SyntheticScene:
    center: np.ndarray
    radius: float

    def render(self, cam2world, intrinsics, resolution):
        o, d = _rays_for_camera(cam2world, intrinsics, resolution)
        hit, t = _trace_sphere(o, d, self.center, self.radius)
        pts = o + t[..., None] * d
        normals = (pts - self.center) / self.radius
        rgb01 = np.where(hit[..., None], _shade(pts, normals), 1.0)
        depth = t.astype(np.float32)
        return (rgb01.astype(np.float32), depth, hit.astype(np.float32))


def make_multiview_batch(num_views: int = 4, resolution: int = 256,
                         render_resolution: int = 128,
                         radius_cam: float = 1.8, fov: float = 40.0,
                         sphere_radius: float = 0.35, seed: int = 0,
                         num_views_sup: int = 0):
    """One instance, V posed views. Returns the reference batch dict.

    ``num_views_sup > 0`` additionally emits paired held-out novel views
    (``nv_*`` fields at interleaved yaws — the reference nv schema)."""
    rng = np.random.default_rng(seed)
    scene = SyntheticScene(center=np.zeros(3) + rng.uniform(
        -0.05, 0.05, 3), radius=sphere_radius)

    n_in = num_views
    num_views = num_views + num_views_sup     # render all, split below
    yaw = rng.uniform(0, 2 * np.pi) + np.arange(num_views) \
        * (2 * np.pi / num_views)
    pitch = np.full(num_views, np.pi / 2 - 0.3)
    cam2world = lookat_pose(yaw, pitch, radius=radius_cam)
    intr = fov_to_intrinsics(fov)

    imgs, depths, masks, cams, enc_inputs = [], [], [], [], []
    imgs_lr, depths_lr, masks_lr = [], [], []
    for v in range(num_views):
        rgb01, depth, mask = scene.render(cam2world[v], intr, resolution)
        rgb01_lr, depth_lr, mask_lr = scene.render(cam2world[v], intr,
                                                   render_resolution)
        o, d = _rays_for_camera(cam2world[v], intr, resolution)
        plucker = np.concatenate([np.cross(o, d), d], axis=-1)
        enc_in = np.concatenate(
            [rgb01 * 2 - 1, depth[..., None], plucker], axis=-1)
        enc_inputs.append(enc_in.astype(np.float32))
        imgs.append(rgb01 * 2 - 1)
        depths.append(depth)
        masks.append(mask)
        imgs_lr.append(rgb01_lr * 2 - 1)
        depths_lr.append(depth_lr)
        masks_lr.append(mask_lr)
        cams.append(np.concatenate([cam2world[v].reshape(16),
                                    intr.reshape(9)]))

    # fg bbox per view in RENDER-resolution coords (the PostProcess
    # convention): [top, left, bottom, right]
    bboxes = []
    for m in masks_lr:
        ys, xs = np.nonzero(m > 0.5)
        if len(ys) == 0:
            bboxes.append(np.array([0, 0, render_resolution,
                                    render_resolution]))
        else:
            bboxes.append(np.array([ys.min(), xs.min(), ys.max() + 1,
                                    xs.max() + 1]))

    out = {
        'img_to_encoder': np.stack(enc_inputs[:n_in]).astype(np.float32),
        'img': np.stack(imgs_lr[:n_in]).astype(np.float32),
        'img_hr': np.stack(imgs[:n_in]).astype(np.float32),
        'depth': np.stack(depths_lr[:n_in]).astype(np.float32),
        'depth_mask': np.stack(masks_lr[:n_in]).astype(np.float32),
        'c': np.stack(cams[:n_in]).astype(np.float32),
        'bbox': np.stack(bboxes[:n_in]).astype(np.int32),
    }
    if num_views > n_in:    # held-out novel views (nv_* schema)
        out.update({
            'nv_img': np.stack(imgs_lr[n_in:]).astype(np.float32),
            'nv_depth': np.stack(depths_lr[n_in:]).astype(np.float32),
            'nv_depth_mask': np.stack(masks_lr[n_in:]).astype(np.float32),
            'nv_c': np.stack(cams[n_in:]).astype(np.float32),
            'nv_bbox': np.stack(bboxes[n_in:]).astype(np.int32),
        })
    return out


def load_memory_data(batch_size: int, num_views: int = 4,
                     resolution: int = 256, render_resolution: int = 128,
                     seed: int = 0, num_views_sup: int = 0):
    """Infinite iterator over a single cached instance (overfit mode)."""
    batch = make_multiview_batch(num_views, resolution, render_resolution,
                                 seed=seed, num_views_sup=num_views_sup)
    while True:
        yield batch
