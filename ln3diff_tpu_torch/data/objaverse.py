"""G-Objaverse camera rays and their Plücker embedding (numpy, host side).

The port's copy of ``rays_from_camera`` and ``plucker_embedding``
(``ln3diff_tpu/data/objaverse.py:20-39``; reference
``datasets/g_buffer_objaverse.py`` ``gen_rays:3272``), the same numpy
code, so both packages embed a camera byte for byte alike.  The Objaverse
loaders of that module are not ported yet.
"""

from __future__ import annotations

import numpy as np


def rays_from_camera(c25: np.ndarray, resolution: int):
    """Pixel-centre rays (origins, dirs), each (H, W, 3), of a 25-dim
    camera (cam2world 4x4, then intrinsics 3x3 normalised by the image
    size), OpenCV convention."""
    c2w = c25[:16].reshape(4, 4)
    intr = c25[16:25].reshape(3, 3)
    fx, fy, cx, cy = intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2]
    yy, xx = np.meshgrid(
        (np.arange(resolution) + 0.5) / resolution,
        (np.arange(resolution) + 0.5) / resolution, indexing='ij')
    dirs = np.stack([(xx - cx) / fx, (yy - cy) / fy, np.ones_like(xx)],
                    axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs @ c2w[:3, :3].T
    origins = np.broadcast_to(c2w[:3, 3], dirs.shape)
    return origins.astype(np.float32), dirs.astype(np.float32)


def plucker_embedding(c25: np.ndarray, resolution: int) -> np.ndarray:
    """6-channel Plücker rays [cross(o, d), d], (H, W, 6) f32."""
    o, d = rays_from_camera(c25, resolution)
    return np.concatenate([np.cross(o, d), d], axis=-1).astype(np.float32)
