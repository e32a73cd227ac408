"""EG3D ``TriPlaneGenerator``: StyleGAN2 backbone → triplane → render.

Port of ``ln3diff_tpu/models/eg3d.py`` (``_nf`` :31, ``SynthesisNetworkSG2``
:35-68, ``TriPlaneGeneratorConfig`` :73, ``TriPlaneGenerator`` :82 with
``generate_planes`` :99, ``forward`` :106 and ``query_points`` :128;
reference ``nsr/triplane.py:29-300``): a mapping network (z and a camera
label c → w, ``w_avg`` a buffer for the truncation), a StyleGAN2 synthesis
network from a learned 4x4 constant up to ``plane_resolution``² with
``3 · plane_channels`` output channels viewed as three planes, the point
decoder and the two-pass renderer.  The frozen teacher of the EG3D
warm-up (``training/eg3d_warmup.py``).

As in the JAX module, each block takes one w (``ws[:, i]``), not one per
conv layer; the mapping's ``num_ws`` is the number of blocks plus one.
The render passes no draws: the fixed stratum midpoints and the linspaced
PDF of the renderer's deterministic mode, as JAX's ``key=None``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from ..render.ray_sampler import sample_full_rays, unpack_25d_camera
from ..render.renderer import RenderOptions, render_rays, sample_from_planes
from .osg_decoder import OSGDecoder
from .stylegan import (MappingNetwork, SynthesisBlockSG2, SynthesisLayerSG2,
                       ToRGBSG2)


def _nf(res: int, channel_base: int = 32768, channel_max: int = 512) -> int:
    return min(channel_base // res, channel_max)


class SynthesisNetworkSG2(nn.Module):
    """StyleGAN2 skip-architecture synthesis (``networks_stylegan2.py:
    626-700``): a learned 4x4 constant (stored channels-last, as JAX
    stores it) → ``b4_conv1`` and ``b4_torgb`` → one up-block per
    resolution 8 … ``img_resolution`` with the standard channel schedule.
    ws ``(B, num_ws, w_dim)`` → img ``(B, H, W, img_channels)`` f32,
    without the constant noise (JAX's default ``noise_mode='none'``, the
    only one its generator uses)."""

    def __init__(self, img_resolution: int = 256, img_channels: int = 96,
                 w_dim: int = 512):
        super().__init__()
        self.block_resolutions = []
        res = 8
        while res <= img_resolution:
            self.block_resolutions.append(res)
            res *= 2
        c0 = _nf(4)
        self.const = nn.Parameter(torch.randn(4, 4, c0))
        self.b4_conv1 = SynthesisLayerSG2(c0, c0, 4, w_dim=w_dim)
        self.b4_torgb = ToRGBSG2(c0, img_channels, w_dim=w_dim)
        cin = c0
        for res in self.block_resolutions:
            self.add_module(f'b{res}', SynthesisBlockSG2(
                cin, _nf(res), res, img_channels=img_channels, w_dim=w_dim))
            cin = _nf(res)

    @property
    def num_ws(self) -> int:
        return len(self.block_resolutions) + 1

    def reset_free_parameters(self, generator=None):
        self.const.copy_(torch.randn(self.const.shape, generator=generator,
                                     device=self.const.device))

    def forward(self, ws: torch.Tensor):
        B = ws.shape[0]
        x = self.const.permute(2, 0, 1)[None].expand(B, -1, -1, -1)
        x = self.b4_conv1(x, ws[:, 0])
        img = self.b4_torgb(x, ws[:, 0])
        for i, res in enumerate(self.block_resolutions):
            x, img = getattr(self, f'b{res}')(x, img, ws[:, i + 1])
        return img.permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class TriPlaneGeneratorConfig:
    z_dim: int = 512
    c_dim: int = 25                  # camera-conditioned (EG3D gen_pose_cond)
    w_dim: int = 512
    plane_resolution: int = 256
    plane_channels: int = 32
    decoder_output_dim: int = 32


class TriPlaneGenerator(nn.Module):
    """z (and a camera label c) → w → synthesis → planes ``(B, 3, H, W,
    C)``, with the render and point-query heads of the port's renderer.
    f32 throughout, as in JAX."""

    def __init__(self,
                 cfg: TriPlaneGeneratorConfig = TriPlaneGeneratorConfig()):
        super().__init__()
        self.cfg = cfg
        self.synthesis = SynthesisNetworkSG2(
            img_resolution=cfg.plane_resolution,
            img_channels=3 * cfg.plane_channels, w_dim=cfg.w_dim)
        self.mapping = MappingNetwork(
            z_dim=cfg.z_dim, c_dim=cfg.c_dim, w_dim=cfg.w_dim,
            num_ws=self.synthesis.num_ws)
        self.decoder = OSGDecoder(in_features=cfg.plane_channels,
                                  decoder_output_dim=cfg.decoder_output_dim)

    def _planes(self, ws):
        img = self.synthesis(ws)                        # (B, H, W, 3C)
        B, H, W, _ = img.shape
        planes = img.reshape(B, H, W, 3, self.cfg.plane_channels)
        return planes.permute(0, 3, 1, 2, 4)

    def generate_planes(self, z: torch.Tensor,
                        c: Optional[torch.Tensor] = None,
                        truncation_psi: float = 1.0) -> torch.Tensor:
        return self._planes(self.mapping(z, c, truncation_psi=truncation_psi))

    def forward(self, z: torch.Tensor, camera25: torch.Tensor,
                opts: RenderOptions, resolution: int = 64,
                c: Optional[torch.Tensor] = None,
                truncation_psi: float = 1.0, return_ws: bool = False) -> dict:
        """image_raw ``(B, res, res, 3)``, image_depth ``(B, res, res, 1)``
        and planes from a deterministic render of ``camera25``; ``ws``
        ``(B, num_ws, w_dim)`` too with ``return_ws``."""
        ws = self.mapping(z, c, truncation_psi=truncation_psi)
        planes = self._planes(ws)
        B = planes.shape[0]
        cam2world, intrinsics = unpack_25d_camera(camera25)
        ray_o, ray_d = sample_full_rays(cam2world, intrinsics, resolution)
        out = render_rays(planes, self.decoder, ray_o, ray_d, opts)
        ret = {'image_raw': out.feature_samples[..., :3].reshape(
                   B, resolution, resolution, 3),
               'planes': planes,
               'image_depth': out.depth_samples.reshape(
                   B, resolution, resolution, 1)}
        if return_ws:
            ret['ws'] = ws
        return ret

    def query_points(self, planes: torch.Tensor, coords: torch.Tensor,
                     box_warp: float):
        """(rgb, σ) at world coords ``(B, M, 3)``: the teacher side of the
        warm-up's shape term."""
        return self.decoder(sample_from_planes(planes, coords, box_warp),
                            None)
