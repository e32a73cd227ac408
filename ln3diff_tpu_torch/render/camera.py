"""Orbit cameras (numpy, host side).

The port's own copy of the two functions of ``ln3diff_tpu/render/camera.py``
that the orbit render needs (reference ``nsr/camera_utils.py:221-263``):
G-Objaverse z-up pitch/yaw cameras packed as 25-dim labels.
"""

from __future__ import annotations

import math

import numpy as np


def _normalize(v, axis=-1):
    return v / np.linalg.norm(v, axis=axis, keepdims=True)


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
