"""Two-pass importance-sampled triplane volume renderer.

Port of ``ln3diff_tpu/render/renderer.py`` (reference
``nsr/volumetric_rendering/renderer.py``): plane projection in the
(xy, yz, zx) order, the corner-packed gather table, stratified and
importance sampling, the coarse+fine merge and march, and the optional bbox
culling of the Objaverse presets.

Sampling is deterministic — fixed stratum midpoints and a linspaced PDF
draw, as ``key=None`` gives in JAX (``renderer.py:441-446``) — unless the
caller passes a ``torch.Generator`` or the uniform draws themselves
(:class:`RenderDraws`, so that a test can feed JAX's draws): then the
strata are jittered and the PDF is sampled at random, as in training.
Planes are channels-last: ``(B, 3, H, W, C)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import math_utils
from .ray_marcher import march_rays

# decoder: (features (B, n_planes, M, C), dirs (B, M, 3)) -> (rgb, sigma)
DecoderFn = Callable[[torch.Tensor, Optional[torch.Tensor]],
                     tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Static rendering options (the live keys of the reference
    ``rendering_kwargs`` presets)."""
    depth_resolution: int = 64
    depth_resolution_importance: int = 64
    ray_start: float | str = 'auto'   # 'auto' → ray-box intersection
    ray_end: float | str = 'auto'
    box_warp: float = 0.9
    white_back: bool = True
    disparity_space_sampling: bool = False
    filter_out_of_bbox: bool = False
    sampler_bbox_min: float = -0.45
    sampler_bbox_max: float = 0.45
    # midpoints and a linspaced PDF even when draws are given
    deterministic: bool = False


class RenderDraws(NamedTuple):
    """The renderer's uniform draws in [0, 1): ``stratified`` jitters the
    coarse depths ``(B, R, S, 1)``, ``importance`` samples the PDF
    ``(B·R, n_importance)`` (JAX draws them from ``k_strat`` and ``k_imp``
    of ``jax.random.split(key)``)."""
    stratified: torch.Tensor
    importance: torch.Tensor


class RenderOutput(NamedTuple):
    feature_samples: torch.Tensor   # (B, R, C)
    depth_samples: torch.Tensor     # (B, R, 1)
    weights_samples: torch.Tensor   # (B, R, 1)
    visibility: torch.Tensor        # (B, R, 1)


def project_onto_planes(coordinates: torch.Tensor) -> torch.Tensor:
    """(B, M, 3) → (B, 3, M, 2) per-plane coords in (xy, yz, zx) order."""
    xy = coordinates[..., [0, 1]]
    yz = coordinates[..., [1, 2]]
    zx = coordinates[..., [2, 0]]
    return torch.stack([xy, yz, zx], dim=1)


def pack_corner_table(plane_features: torch.Tensor) -> torch.Tensor:
    """Row (y, x) of the zero-padded planes holds the four bilinear
    corners [f(y,x), f(y,x+1), f(y+1,x), f(y+1,x+1)], so one gathered row
    serves a whole bilinear sample; the zero ring gives grid_sample's
    ``padding_mode='zeros'``.  Returns ``(B*3*(H+1)*(W+1), 4C)``."""
    B, n_planes, H, W, C = plane_features.shape
    p = F.pad(plane_features, (0, 0, 1, 1, 1, 1))
    c00 = p[:, :, :-1, :-1]
    c01 = p[:, :, :-1, 1:]
    c10 = p[:, :, 1:, :-1]
    c11 = p[:, :, 1:, 1:]
    packed = torch.cat([c00, c01, c10, c11], dim=-1)
    return packed.reshape(B * n_planes * (H + 1) * (W + 1), 4 * C)


def packed_gather(packed: torch.Tensor, proj: torch.Tensor, H: int, W: int):
    """Gather corner rows and bilinear fractions (no lerp).

    proj: ``(B, 3, M, 2)`` per-plane coords in [-1, 1].  Returns rows
    ``(B, 3, M, 4C)`` in the table's dtype, tx and ty ``(B, 3, M)`` f32,
    live ``(B, 3, M)`` in the table's dtype.
    """
    B, n_planes, M, _ = proj.shape
    C = packed.shape[-1] // 4
    Hp, Wp = H + 1, W + 1

    x = (proj[..., 0] + 1.0) * (W * 0.5) - 0.5
    y = (proj[..., 1] + 1.0) * (H * 0.5) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    # packed row (y0+1, x0+1) holds the corners at (y0, x0); rows off the
    # table only occur far outside [-1, 1] and are clamped onto the zero
    # ring, where live=0 kills them anyway.
    xi = torch.clamp(x0.to(torch.int64) + 1, 0, Wp - 1)
    yi = torch.clamp(y0.to(torch.int64) + 1, 0, Hp - 1)
    far = (x0 < -1) | (x0 > W - 1) | (y0 < -1) | (y0 > H - 1)
    live = 1.0 - far.to(packed.dtype)

    base = (torch.arange(B * n_planes, dtype=torch.int64,
                         device=proj.device).reshape(B, n_planes, 1)
            * (Hp * Wp))
    idx = base + yi * Wp + xi
    rows = torch.index_select(packed, 0, idx.reshape(-1))
    return rows.reshape(B, n_planes, M, 4 * C), tx, ty, live


def sample_packed_planes(packed: torch.Tensor, proj: torch.Tensor, H: int,
                         W: int) -> torch.Tensor:
    """Bilinear lookup from a corner-packed table → ``(B, 3, M, C)``."""
    C = packed.shape[-1] // 4
    rows, tx, ty, live = packed_gather(packed, proj, H, W)
    tx, ty, live = tx[..., None], ty[..., None], live[..., None]
    w00 = (1 - tx) * (1 - ty) * live
    w01 = tx * (1 - ty) * live
    w10 = (1 - tx) * ty * live
    w11 = tx * ty * live
    return (w00 * rows[..., :C] + w01 * rows[..., C:2 * C]
            + w10 * rows[..., 2 * C:3 * C] + w11 * rows[..., 3 * C:])


def sample_from_planes(plane_features: torch.Tensor,
                       coordinates: torch.Tensor,
                       box_warp: float) -> torch.Tensor:
    """Bilinear triplane lookup: planes ``(B, 3, H, W, C)``, world coords
    ``(B, M, 3)`` → ``(B, 3, M, C)``."""
    H, W = plane_features.shape[2:4]
    proj = project_onto_planes((2.0 / box_warp) * coordinates)
    return sample_packed_planes(pack_corner_table(plane_features), proj,
                                H, W)


def sample_stratified(ray_origins: torch.Tensor, ray_start, ray_end,
                      depth_resolution: int,
                      disparity_space_sampling: bool = False,
                      u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depths ``(B, R, S, 1)`` in S strata between ray_start and ray_end
    (per-ray tensors or scalars): at the strata's midpoints, or jittered
    by the uniform draws ``u`` ``(B, R, S, 1)`` (reference
    ``sample_stratified:437-477``)."""
    B, R, _ = ray_origins.shape
    S = depth_resolution
    dev = ray_origins.device
    jitter = 0.5 if u is None else u
    if disparity_space_sampling:
        d = torch.linspace(0.0, 1.0, S, device=dev).reshape(1, 1, S, 1)
        d = d.expand(B, R, S, 1)
        d = d + jitter * (1.0 / (S - 1))
        return 1.0 / (1.0 / ray_start * (1.0 - d) + 1.0 / ray_end * d)
    if torch.is_tensor(ray_start) and ray_start.ndim > 0:
        # per-ray auto bounds: (B, R, 1) each
        d = math_utils.linspace_vec(ray_start, ray_end, S)
        d = torch.movedim(d, 0, 2)                    # (B, R, S, 1)
        delta = (ray_end - ray_start) / (S - 1)
        return d + jitter * delta[..., None]
    d = torch.linspace(float(ray_start), float(ray_end), S, device=dev)
    d = d.reshape(1, 1, S, 1).expand(B, R, S, 1)
    delta = (float(ray_end) - float(ray_start)) / (S - 1)
    return d + jitter * delta


def smooth_weights(weights: torch.Tensor) -> torch.Tensor:
    """maxpool(2, 1, pad 1) → avgpool(2, 1) + 0.01 floor; weights (N, S)."""
    padded = F.pad(weights, (1, 1), value=float('-inf'))
    mx = torch.maximum(padded[:, :-1], padded[:, 1:])     # S+1
    avg = (mx[:, :-1] + mx[:, 1:]) * 0.5                  # S
    return avg + 0.01


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
               n_importance: int, eps: float = 1e-5,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling: bins ``(N, S+1)``, weights ``(N, S)`` →
    ``(N, n_importance)`` (reference ``sample_pdf:504-552``), at linspaced
    u, or at the uniform draws ``u`` ``(N, n_importance)``."""
    N, S = weights.shape
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)

    if u is None:
        u = torch.linspace(0.0, 1.0, n_importance, device=weights.device)
        u = u.expand(N, n_importance)
    u = u.contiguous()

    # side='right': the count of cdf entries <= u
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=S)
    nb = bins.shape[1]
    cdf_g0 = torch.gather(cdf, 1, below)
    cdf_g1 = torch.gather(cdf, 1, above)
    bins_g0 = torch.gather(bins, 1, torch.clamp(below, max=nb - 1))
    bins_g1 = torch.gather(bins, 1, torch.clamp(above, max=nb - 1))

    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_g0 + (u - cdf_g0) / denom * (bins_g1 - bins_g0)


def sample_importance(z_vals: torch.Tensor, weights: torch.Tensor,
                      n_importance: int,
                      u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Importance depths ``(B, R, n_importance, 1)`` from coarse depths
    ``(B, R, S, 1)`` and weights ``(B, R, S-1, 1)``; ``u`` as in
    :func:`sample_pdf`."""
    B, R, S, _ = z_vals.shape
    z = z_vals.detach().reshape(B * R, S)
    w = smooth_weights(weights.detach().reshape(B * R, -1))
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
    samples = sample_pdf(z_mid, w[:, 1:-1], n_importance, u=u)
    return samples.reshape(B, R, n_importance, 1)


def draw_uniforms(B: int, R: int, opts: RenderOptions,
                  generator: Optional[torch.Generator],
                  device) -> RenderDraws:
    """The renderer's uniform draws for a ``(B, R)`` ray bundle, from
    ``generator`` (stratified first, then importance)."""
    strat = torch.rand((B, R, opts.depth_resolution, 1),
                       generator=generator, device=device)
    imp = torch.rand((B * R, opts.depth_resolution_importance),
                     generator=generator, device=device)
    return RenderDraws(strat, imp)


def unify_samples(depths1, colors1, densities1, depths2, colors2,
                  densities2):
    """Concatenate coarse and fine samples and sort them by depth."""
    all_depths = torch.cat([depths1, depths2], dim=-2)
    all_colors = torch.cat([colors1, colors2], dim=-2)
    all_densities = torch.cat([densities1, densities2], dim=-2)
    all_depths, perm = torch.sort(all_depths, dim=-2, stable=True)
    all_colors = torch.gather(
        all_colors, -2, perm.expand(*perm.shape[:-1], all_colors.shape[-1]))
    all_densities = torch.gather(all_densities, -2, perm)
    return all_depths, all_colors, all_densities


def merge_and_march(depths1, colors1, densities1, depths2, colors2,
                    densities2, white_back: bool = True):
    """Coarse+fine merge and MipNeRF march without sorting the colours.

    Only depth and density are put in depth order; the per-sample colour
    coefficient u_j = (w_{r_j-1} + w_{r_j}) / 2 is scattered back through
    the inverse permutation and the composite is one unsorted contraction
    Σ_j u_j·c_j, which equals sorting the colours and compositing at the
    midpoints (``ln3diff_tpu/render/renderer.py:331``)."""
    all_depths = torch.cat([depths1, depths2], dim=-2)[..., 0]
    all_colors = torch.cat([colors1, colors2], dim=-2)
    all_dens = torch.cat([densities1, densities2], dim=-2)[..., 0]

    key_s, perm = torch.sort(all_depths, dim=2, stable=True)
    dens_s = torch.gather(all_dens, 2, perm)

    deltas = key_s[..., 1:] - key_s[..., :-1]
    dens_mid = F.softplus((dens_s[..., :-1] + dens_s[..., 1:]) * 0.5 - 1.0)
    alpha = 1.0 - torch.exp(-dens_mid * deltas)
    alpha_shift = torch.cat(
        [torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1)
    transmittance = torch.cumprod(alpha_shift, dim=-1)
    w = alpha * transmittance[..., :-1]               # (B, R, S-1)
    visibility = transmittance[..., -1:]

    w_pad = F.pad(w, (1, 1))
    u_sorted = (w_pad[..., :-1] + w_pad[..., 1:]) * 0.5   # (B, R, S)
    u = torch.empty_like(u_sorted).scatter_(2, perm, u_sorted)

    composite_rgb = torch.einsum('brs,brsc->brc', u, all_colors)
    weight_total = torch.sum(w, dim=-1, keepdim=True)
    depth_mid = (key_s[..., :-1] + key_s[..., 1:]) * 0.5
    composite_depth = torch.sum(w * depth_mid, dim=-1, keepdim=True)
    composite_depth = torch.nan_to_num(composite_depth, nan=float('inf'))
    composite_depth = torch.clamp(composite_depth, torch.min(all_depths),
                                  torch.max(all_depths))

    if white_back:
        composite_rgb = composite_rgb + 1.0 - weight_total
    composite_rgb = composite_rgb * 2.0 - 1.0
    return composite_rgb, composite_depth, weight_total, visibility


def run_decoder(planes: torch.Tensor, decoder: DecoderFn,
                coords: torch.Tensor, dirs: Optional[torch.Tensor],
                opts: RenderOptions, packed: Optional[torch.Tensor] = None,
                fused_osg=None):
    """Triplane lookup + point decoder with optional bbox culling
    (reference ``run_model`` / ``_forward_pass``).

    ``packed`` (from :func:`pack_corner_table`) shares the gather table
    across passes; ``fused_osg``
    (:class:`~ln3diff_tpu_torch.ops.fused_render.FusedOSG`) runs
    lerp → plane mean → MLP as one kernel instead of ``decoder`` and
    needs ``packed``.
    """
    inbox = None
    if opts.filter_out_of_bbox:
        inbox = torch.all((coords >= opts.sampler_bbox_min)
                          & (coords <= opts.sampler_bbox_max), dim=-1)
    if packed is not None:
        H, W = planes.shape[2:4]
        proj = project_onto_planes((2.0 / opts.box_warp) * coords)
        if fused_osg is not None:
            rows, tx, ty, live = packed_gather(packed, proj, H, W)
            # the bbox filter is folded into the kernel
            return fused_osg(rows, tx, ty, live,
                             inbox=None if inbox is None else inbox.float())
        feats = sample_packed_planes(packed, proj, H, W)
    else:
        if fused_osg is not None:
            raise ValueError('fused_osg requires a packed table')
        feats = sample_from_planes(planes, coords, opts.box_warp)
    rgb, sigma = decoder(feats, dirs)
    if inbox is not None:
        # a large negative σ keeps softplus(σ - 1) at 0 while staying finite
        sigma = torch.where(inbox[..., None], sigma,
                            torch.full_like(sigma, -1e10))
        rgb = torch.where(inbox[..., None], rgb, torch.zeros_like(rgb))
    return rgb, sigma


def render_rays(planes: torch.Tensor, decoder: DecoderFn,
                ray_origins: torch.Tensor, ray_directions: torch.Tensor,
                opts: RenderOptions, fused_osg=None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[RenderDraws] = None) -> RenderOutput:
    """Full two-pass render (reference ``ImportanceRenderer.forward``):
    planes ``(B, 3, H, W, C)``, rays ``(B, R, 3)``.  Deterministic unless
    ``draws`` or a ``generator`` is given and ``opts.deterministic`` is
    off (JAX: a ``key``)."""
    B, R, _ = ray_origins.shape
    if opts.deterministic or (draws is None and generator is None):
        draws = RenderDraws(None, None)
    elif draws is None:
        draws = draw_uniforms(B, R, opts, generator, ray_origins.device)

    # one corner-packed table shared by the coarse and fine passes
    packed = pack_corner_table(planes)

    if opts.ray_start == 'auto':
        if opts.ray_end != 'auto':
            raise ValueError("ray_start='auto' needs ray_end='auto'")
        ray_start, ray_end = math_utils.get_ray_limits_box(
            ray_origins.detach(), ray_directions.detach(),
            box_side_length=opts.box_warp)
        ray_start, ray_end = math_utils.fix_invalid_ray_limits(
            ray_start, ray_end)
    else:
        ray_start, ray_end = opts.ray_start, opts.ray_end

    depths_coarse = sample_stratified(ray_origins, ray_start, ray_end,
                                      opts.depth_resolution,
                                      opts.disparity_space_sampling,
                                      u=draws.stratified)
    S = opts.depth_resolution

    def eval_points(depths, n_samples):
        coords = (ray_origins[:, :, None, :]
                  + depths * ray_directions[:, :, None, :]).reshape(B, -1, 3)
        dirs = None
        if fused_osg is None:
            dirs = ray_directions[:, :, None, :].expand(
                B, R, n_samples, 3).reshape(B, -1, 3)
        rgb, sigma = run_decoder(planes, decoder, coords, dirs, opts,
                                 packed=packed, fused_osg=fused_osg)
        return (rgb.reshape(B, R, n_samples, -1),
                sigma.reshape(B, R, n_samples, 1))

    colors_coarse, densities_coarse = eval_points(depths_coarse, S)

    n_imp = opts.depth_resolution_importance
    if n_imp > 0:
        coarse = march_rays(colors_coarse, densities_coarse, depths_coarse,
                            white_back=opts.white_back)
        depths_fine = sample_importance(depths_coarse, coarse.weights,
                                        n_imp, u=draws.importance)
        colors_fine, densities_fine = eval_points(depths_fine, n_imp)
        rgb, depth, wtot, vis = merge_and_march(
            depths_coarse, colors_coarse, densities_coarse,
            depths_fine, colors_fine, densities_fine,
            white_back=opts.white_back)
        return RenderOutput(feature_samples=rgb, depth_samples=depth,
                            weights_samples=wtot, visibility=vis)

    final = march_rays(colors_coarse, densities_coarse, depths_coarse,
                       white_back=opts.white_back)
    return RenderOutput(feature_samples=final.rgb,
                        depth_samples=final.depth,
                        weights_samples=torch.sum(final.weights, dim=2),
                        visibility=final.visibility)
