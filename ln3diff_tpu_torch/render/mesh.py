"""Dense σ-grid query for mesh extraction.

Port of ``query_grid_sigma`` (:29) and ``smooth_sigma_grid`` (:61) of
``ln3diff_tpu/render/mesh.py`` (reference ``triplane_decode_grid``,
``vit/vit_triplane.py:1625-1692``): the grid is decoded in chunks of
points and returned as a flat f16 σ field.  Marching tetrahedra, vertex
colours and the OBJ/PLY writers are the next slice.
"""

from __future__ import annotations

from typing import Callable

import torch

PointDecoder = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]
# (B, M, 3) coords -> (rgb (B, M, C), sigma (B, M, 1))


def grid_points(grid_size: int, aabb: float, device=None) -> torch.Tensor:
    """``(grid_size³, 3)`` f32 points of the ±aabb cube, 'ij' order
    (z fastest)."""
    lin = torch.linspace(-aabb, aabb, grid_size, device=device)
    gx, gy, gz = torch.meshgrid(lin, lin, lin, indexing='ij')
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


@torch.no_grad()
def query_grid_sigma(point_decoder: PointDecoder, grid_size: int,
                     aabb: float = 0.45, chunk: int = 2**16,
                     smooth: bool = False, device=None) -> torch.Tensor:
    """σ on a dense grid by chunked decoding → ``(grid_size³,)`` f16.

    f16 because the field only places the iso-surface; ``smooth`` applies
    :func:`smooth_sigma_grid` before returning."""
    pts = grid_points(grid_size, aabb, device)
    sigmas = torch.empty(pts.shape[0], dtype=torch.float16,
                         device=pts.device)
    for start in range(0, pts.shape[0], chunk):
        _, sigma = point_decoder(pts[None, start:start + chunk])
        sigmas[start:start + chunk] = sigma[0, :, 0].to(torch.float16)
    if smooth:
        g = grid_size
        sigmas = smooth_sigma_grid(sigmas.reshape(g, g, g)).reshape(-1)
    return sigmas


def smooth_sigma_grid(s: torch.Tensor) -> torch.Tensor:
    """Separable 3³ box mean with replicated edges (serving guard against
    noisy σ fields; the reference marches the raw field)."""
    for ax in range(3):
        n = s.shape[ax]
        first = s.narrow(ax, 0, 1)
        last = s.narrow(ax, n - 1, 1)
        sp = torch.cat([first, s, last], dim=ax)
        s = (sp.narrow(ax, 0, n) + sp.narrow(ax, 1, n)
             + sp.narrow(ax, 2, n)) / 3
    return s
