"""Foreground/background composition renderer (the fg/bg FFHQ planes).

Port of ``ln3diff_tpu/render/background.py`` (reference
``ImportanceRendererfg_bg``, ``renderer.py:555-637``, and the NeRF++
inverted-sphere parameterisation ``depth2pts_outside``,
``ray_sampler.py:27-57``): the plane channels split into fg | bg halves;
the background renders on inverted-sphere points with stratified
inverse-depth samples and no importance pass, and is composited behind the
foreground by its residual transmittance.

Sampling follows :mod:`.renderer`: midpoints unless the caller passes a
``torch.Generator`` or the uniform draws themselves (the fg pass's
:class:`~.renderer.RenderDraws` and the bg pass's ``(B, R, S, 1)``
stratified draws; JAX splits one key into the two passes' keys).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .ray_marcher import MarchResult, march_rays
from .renderer import (DecoderFn, RenderDraws, RenderOptions, RenderOutput,
                       render_rays, run_decoder, sample_stratified)

TINY = 1e-6


def depth2pts_outside(ray_o: torch.Tensor, ray_d: torch.Tensor,
                      depth: torch.Tensor):
    """NeRF++ inverted-sphere points: rays (..., 3), inverse distance
    ``depth`` (...) in [0, 1] → (pts (..., 4), depth_real (...))."""
    d1 = -torch.sum(ray_d * ray_o, dim=-1) / torch.sum(ray_d * ray_d, dim=-1)
    p_mid = ray_o + d1[..., None] * ray_d
    p_mid_norm = torch.linalg.norm(p_mid, dim=-1)
    ray_d_cos = 1.0 / torch.linalg.norm(ray_d, dim=-1)
    d2 = torch.sqrt(torch.clamp(1.0 - p_mid_norm**2, min=TINY)) * ray_d_cos
    p_sphere = ray_o + (d1 + d2)[..., None] * ray_d

    rot_axis = torch.linalg.cross(ray_o, p_sphere, dim=-1)
    rot_axis = rot_axis / (torch.linalg.norm(rot_axis, dim=-1, keepdim=True)
                           + TINY)
    phi = torch.arcsin(torch.clamp(p_mid_norm, -1, 1))
    theta = torch.arcsin(torch.clamp(p_mid_norm * depth, -1, 1))
    rot_angle = (phi - theta)[..., None]

    cos_a = torch.cos(rot_angle)
    sin_a = torch.sin(rot_angle)
    p_new = (p_sphere * cos_a
             + torch.linalg.cross(rot_axis, p_sphere, dim=-1) * sin_a
             + rot_axis * torch.sum(rot_axis * p_sphere, dim=-1,
                                    keepdim=True) * (1.0 - cos_a))
    p_new = p_new / (torch.linalg.norm(p_new, dim=-1, keepdim=True) + TINY)
    pts = torch.cat([p_new, depth[..., None]], dim=-1)

    depth_real = 1.0 / (depth + TINY) * torch.cos(theta) * ray_d_cos + d1
    return pts, depth_real


def render_background(bg_planes: torch.Tensor, decoder: DecoderFn,
                      ray_origins: torch.Tensor,
                      ray_directions: torch.Tensor, opts: RenderOptions,
                      bg_depth_resolution: int = 16,
                      u: Optional[torch.Tensor] = None) -> MarchResult:
    """The background pass: ``bg_depth_resolution`` stratified
    inverse-depth samples in [0, 1] (at the strata's midpoints, or
    jittered by ``u`` (B, R, S, 1)) on the inverted sphere, the planes
    sampled at the sphere-surface xyz with no bbox filter, one march."""
    B, R, _ = ray_origins.shape
    S = bg_depth_resolution
    if opts.deterministic:
        u = None
    depths = sample_stratified(ray_origins, 0.0, 1.0, S, u=u)[..., 0]
    o = ray_origins[:, :, None, :].expand(B, R, S, 3)
    d = ray_directions[:, :, None, :].expand(B, R, S, 3)
    bg_pts, _ = depth2pts_outside(o, d, depths)
    rgb, sigma = run_decoder(
        bg_planes, decoder, bg_pts[..., :3].reshape(B, -1, 3),
        d.reshape(B, -1, 3),
        dataclasses.replace(opts, filter_out_of_bbox=False))
    return march_rays(rgb.reshape(B, R, S, -1), sigma.reshape(B, R, S, 1),
                      depths[..., None], white_back=opts.white_back)


def render_rays_fg_bg(planes: torch.Tensor, decoder: DecoderFn,
                      bg_decoder: DecoderFn, ray_origins: torch.Tensor,
                      ray_directions: torch.Tensor, opts: RenderOptions,
                      bg_depth_resolution: int = 16, fused_osg=None,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[RenderDraws] = None,
                      bg_u: Optional[torch.Tensor] = None) -> RenderOutput:
    """The fg/bg render: the first half of the plane channels through the
    two-pass renderer (``fused_osg``, kernel 1, applies to this pass only),
    the second half through :func:`render_background`, composited in
    premultiplied [0, 1] space: out01 = fg01 + (1 − w_fg)·bg01.  Draws:
    ``draws`` (fg) and ``bg_u`` (bg), or both from ``generator`` (fg
    first); with neither, midpoints."""
    C = planes.shape[-1]
    fg_planes, bg_planes = planes[..., :C // 2], planes[..., C // 2:]
    fg = render_rays(fg_planes, decoder, ray_origins, ray_directions, opts,
                     fused_osg=fused_osg, generator=generator, draws=draws)
    if bg_u is None and generator is not None and not opts.deterministic:
        B, R = ray_origins.shape[:2]
        bg_u = torch.rand((B, R, bg_depth_resolution, 1),
                          generator=generator, device=ray_origins.device)
    bg = render_background(bg_planes, bg_decoder, ray_origins,
                           ray_directions, opts, bg_depth_resolution, u=bg_u)
    fg01 = (fg.feature_samples + 1.0) * 0.5
    bg01 = (bg.rgb + 1.0) * 0.5
    out01 = fg01 + (1.0 - fg.weights_samples) * bg01
    return RenderOutput(feature_samples=out01 * 2.0 - 1.0,
                        depth_samples=fg.depth_samples,
                        weights_samples=fg.weights_samples,
                        visibility=fg.visibility)
