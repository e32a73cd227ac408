"""Cameras (numpy, host side).

The port's own copy of the functions of ``ln3diff_tpu/render/camera.py``
that it needs (reference ``nsr/camera_utils.py``): G-Objaverse z-up
pitch/yaw cameras packed as 25-dim labels for the orbit render
(``generate_input_camera`` :84, reference :221-263), the loader of the
release's pose assets (``load_pose_asset`` :112), the look-at
poses and FOV intrinsics of the synthetic training scene
(``create_cam2world_matrix`` :20, ``lookat_pose`` :46,
``fov_to_intrinsics`` :77; reference :23-219), and the Gaussian and
uniform pose samplers of the EG3D warm-up (``gaussian_pose`` :56,
``uniform_pose`` :66; reference ``GaussianCameraPoseSampler``,
``UniformCameraPoseSampler``) over a ``numpy.random.Generator``, so that
one seed gives the JAX package's cameras bit for bit.
"""

from __future__ import annotations

import math

import numpy as np


def _normalize(v, axis=-1):
    return v / np.linalg.norm(v, axis=axis, keepdims=True)


def create_cam2world_matrix(forward_vector: np.ndarray,
                            origin: np.ndarray) -> np.ndarray:
    """y-up, no-roll cam2world from forward dirs and origins, both
    ``(B, 3)``."""
    forward = _normalize(forward_vector)
    up = np.broadcast_to(np.array([0.0, 1.0, 0.0], np.float32),
                         forward.shape)
    right = -_normalize(np.cross(up, forward))
    up = _normalize(np.cross(forward, right))

    B = forward.shape[0]
    cam2world = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    cam2world[:, :3, :3] = np.stack([right, up, forward], axis=-1)
    cam2world[:, :3, 3] = origin
    return cam2world


def _spherical_origin(h, v, radius):
    """EG3D spherical convention: azimuth h, polar v (radians)."""
    v = np.clip(v, 1e-5, math.pi - 1e-5)
    phi = np.arccos(1 - 2 * (v / math.pi))
    x = radius * np.sin(phi) * np.cos(math.pi - h)
    z = radius * np.sin(phi) * np.sin(math.pi - h)
    y = radius * np.cos(phi)
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def lookat_pose(horizontal: np.ndarray, vertical: np.ndarray,
                lookat_position=np.zeros(3), radius: float = 1.0):
    """Look-at poses from explicit angles ``(B,)`` (reference
    ``LookAtPoseSampler``, :71-110)."""
    origins = _spherical_origin(np.asarray(horizontal, np.float64),
                                np.asarray(vertical, np.float64), radius)
    lookat = np.broadcast_to(np.asarray(lookat_position, np.float32),
                             origins.shape)
    return create_cam2world_matrix(lookat - origins, origins)


def gaussian_pose(rng: np.random.Generator, horizontal_mean, vertical_mean,
                  horizontal_stddev=0.0, vertical_stddev=0.0,
                  radius: float = 1.0, batch_size: int = 1):
    """Cameras looking at the origin from azimuth ~ N(horizontal_mean,
    horizontal_stddev²) and polar angle ~ N(vertical_mean,
    vertical_stddev²) at ``radius``: ``(B, 4, 4)`` f32."""
    h = rng.standard_normal((batch_size,)) * horizontal_stddev \
        + horizontal_mean
    v = rng.standard_normal((batch_size,)) * vertical_stddev + vertical_mean
    origins = _spherical_origin(h, v, radius)
    return create_cam2world_matrix(-origins, origins)


def uniform_pose(rng: np.random.Generator, horizontal_mean, vertical_mean,
                 horizontal_stddev=0.0, vertical_stddev=0.0,
                 radius: float = 1.0, batch_size: int = 1):
    """As :func:`gaussian_pose`, the angles uniform in mean ± stddev."""
    h = (rng.uniform(size=(batch_size,)) * 2 - 1) * horizontal_stddev \
        + horizontal_mean
    v = (rng.uniform(size=(batch_size,)) * 2 - 1) * vertical_stddev \
        + vertical_mean
    origins = _spherical_origin(h, v, radius)
    return create_cam2world_matrix(-origins, origins)


def fov_to_intrinsics(fov_degrees: float) -> np.ndarray:
    """Normalised pinhole intrinsics from a FOV (reference :208-219)."""
    focal = float(1 / (math.tan(fov_degrees * 3.14159 / 360) * 1.414))
    return np.array([[focal, 0, 0.5], [0, focal, 0.5], [0, 0, 1]],
                    np.float32)


def generate_input_camera(radius: float, poses_deg, fov: float = 30.0):
    """poses_deg: (B, 2) [pitch, yaw] degrees.  Returns (cam2world
    (B, 4, 4), fxfycxcy (4,))."""
    poses = np.deg2rad(np.asarray(poses_deg, np.float64))
    pitch, yaw = poses[:, 0], poses[:, 1]
    z = radius * np.sin(pitch)
    x = radius * np.cos(pitch) * np.cos(yaw)
    y = radius * np.cos(pitch) * np.sin(yaw)
    cam_pos = np.stack([x, y, z], axis=-1).astype(np.float32)

    forward = _normalize(-cam_pos)
    up = np.broadcast_to(np.array([0.0, 0.0, -1.0], np.float32),
                         forward.shape)
    left = _normalize(np.cross(up, forward))
    up = _normalize(np.cross(forward, left))

    B = forward.shape[0]
    cam2world = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    cam2world[:, :3, :3] = np.stack([left, up, forward], axis=-1)
    cam2world[:, :3, 3] = cam_pos

    fx = 0.5 / math.tan(math.radians(fov / 2))
    return cam2world, np.array([fx, fx, 0.5, 0.5], np.float32)


def load_pose_asset(path: str) -> np.ndarray:
    """A release pose asset (``assets/objv_eval_pose.pt``, ...): a
    ``torch.save``d ``(N, 25)`` tensor of packed [c2w (16), normalised
    intrinsics (9)] labels, as ``(N, 25)`` f32 numpy.  The objv asset's
    first 24 rows are the orbit at pitch 13.73°, radius 1.772, which
    :func:`generate_input_camera` reproduces."""
    import torch
    cam = torch.load(path, map_location='cpu', weights_only=True)
    cam = np.asarray(torch.as_tensor(cam).float().numpy(), np.float32)
    if cam.ndim != 2 or cam.shape[1] != 25:
        raise ValueError(f'{path}: pose asset of shape {cam.shape}, '
                         f'expected (N, 25)')
    return cam


def orbit_cameras(num: int = 24, radius: float = 1.8, fov: float = 30.0,
                  pitch_deg: float = 20.0) -> np.ndarray:
    """Evaluation orbit as packed ``(num, 25)`` labels."""
    yaws = np.linspace(0, 360, num, endpoint=False)
    poses = np.stack([np.full(num, pitch_deg), yaws], axis=-1)
    cam2world, fxfycxcy = generate_input_camera(radius, poses, fov=fov)
    fx, fy, cx, cy = fxfycxcy
    intr = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    intr = np.tile(intr[None], (num, 1, 1))
    return np.concatenate([cam2world.reshape(num, 16),
                           intr.reshape(num, 9)], axis=-1)
