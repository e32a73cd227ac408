"""Mesh extraction: dense σ-grid query → marching tetrahedra → coloured
OBJ/PLY.

Port of ``ln3diff_tpu/render/mesh.py`` (reference ``triplane_decode_grid``,
``vit/vit_triplane.py:1625-1692``, and the mesh block of
``render_video_given_triplane``, ``nsr/train_util_diffusion.py:208-249``):
the grid is decoded in chunks of points on the planes' device and returned
as a flat f16 σ field; a device-side census counts the iso-crossing cells;
the host marches the crossing cells with the port's copy of the native C++
marcher (``native/marching_cubes.cpp``); vertex colours are re-queried on
the device; the native writers (``native/mesh_io.cpp``) export the mesh.
Reference defaults: 192³ (objaverse) grid, σ threshold 10, aabb ±0.45,
−90° x-rotation on export.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..ops._build import LIBRARIES

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


# the seven corners of a cell other than its origin corner
_CORNERS = ((0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1),
            (1, 1, 0), (1, 1, 1))


@torch.no_grad()
def count_crossing_cells(sigma_flat: torch.Tensor, grid_size: int,
                         threshold: float = 10.0) -> torch.Tensor:
    """Device-side census of iso-crossing cells: a 0-d int64 tensor on the
    grid's device, left in flight.  Serving reads it before pulling the
    grid to the host, and skips the pull and the march for an empty
    surface.  The same any/all corner test as :func:`_crossing_cells`."""
    g = grid_size
    n = g - 1
    m = sigma_flat.reshape(g, g, g) > threshold
    any_in = m[:-1, :-1, :-1].clone()
    all_in = any_in.clone()
    for dx, dy, dz in _CORNERS:
        corner = m[dx:dx + n, dy:dy + n, dz:dz + n]
        any_in |= corner
        all_in &= corner
    return (any_in & ~all_in).sum()


def _crossing_cells(sigma: np.ndarray, threshold: float) -> np.ndarray:
    """Linear indices (z fastest) of the cells whose 8 corners straddle the
    iso value: a few vector passes over the grid, so that the serial C++
    marcher visits only the crossing cells."""
    m = sigma > threshold
    n = sigma.shape[0] - 1
    any_in = m[:-1, :-1, :-1].copy()
    all_in = any_in.copy()
    for dx, dy, dz in _CORNERS:
        corner = m[dx:dx + n, dy:dy + n, dz:dz + n]
        any_in |= corner
        all_in &= corner
    return np.flatnonzero(any_in & ~all_in)


def _marcher():
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    return LIBRARIES.function(
        'marching_cubes', 'marching_tetrahedra_cells',
        [fp, i64, i64, i64, ctypes.c_float, ip, i64, fp, i64],
        restype=i64)


FIRST_GUESS_TRIS = 4_000_000


def march_grid(sigma: np.ndarray, grid_size: int, aabb: float = 0.45,
               threshold: float = 10.0, max_tris_cap: int = 20_000_000):
    """Host stage: σ grid (numpy) → (verts (3T, 3) world coordinates,
    faces (T, 3)), flat vertices, three per triangle.

    The first buffer holds ≤ 12 triangles per crossing cell but at most
    ``FIRST_GUESS_TRIS``; when the marcher reports more (it returns
    −needed), the buffer is reallocated once, to at most ``max_tris_cap``
    triangles (720 MB at the default).  The marcher fills the buffer in
    cell order, so a capped run returns the first ``max_tris_cap``
    triangles as valid geometry, with a warning: a noise field at 192³
    wants up to ~84 M triangles, a real surface well under 2 M."""
    g = grid_size
    sigma = np.ascontiguousarray(
        np.asarray(sigma, np.float32).reshape(g, g, g))
    cells = np.ascontiguousarray(_crossing_cells(sigma, threshold))
    mt = _marcher()
    cap = max(int(max_tris_cap), 1)
    max_tris = min(max(min(cells.size * 12, FIRST_GUESS_TRIS), 1), cap)

    fp = ctypes.POINTER(ctypes.c_float)

    def run(max_tris):
        out = np.empty((max_tris, 9), np.float32)
        n = mt(sigma.ctypes.data_as(fp), g, g, g, threshold,
               cells.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
               cells.size, out.ctypes.data_as(fp), max_tris)
        return out, n

    out, n = run(max_tris)
    if n < 0 and min(-n, cap) > max_tris:
        max_tris = min(-n, cap)
        out, n = run(max_tris)
    if n < 0:
        warnings.warn(
            f'march_grid: triangle count {-n} exceeds max_tris_cap={cap}; '
            f'returning the first {max_tris} triangles (cell-order prefix, '
            'usually a noise field, not a real surface)', RuntimeWarning,
            stacklevel=2)
        n = max_tris
    tris = out[:n].reshape(n * 3, 3)
    verts = tris * ((2 * aabb) / (g - 1)) - aabb
    faces = np.arange(n * 3, dtype=np.int64).reshape(n, 3)
    return verts, faces


@torch.no_grad()
def dispatch_vertex_colors(point_decoder: PointDecoder, verts: np.ndarray,
                           chunk: int = 2**16, as_uint8: bool = False,
                           device=None) -> Optional[torch.Tensor]:
    """Enqueue the per-vertex RGB re-query on ``device`` without waiting:
    returns the ``(N, 3)`` colours still in flight (``None`` for an empty
    mesh).  ``as_uint8`` clips to [0, 1] and quantises on the device (a
    quarter of the bytes to pull; the writers quantise anyway).

    The vertices go through ``point_decoder`` in chunks of ``chunk``
    points, the last one ragged.  The JAX version pads the chunk count up
    to a bucket so that the number of compiled programs stays small;
    PyTorch runs eagerly and compiles nothing per shape, and each point's
    colour does not depend on its chunk, so no padding is needed."""
    if not len(verts):
        return None
    v = torch.as_tensor(np.ascontiguousarray(verts, np.float32),
                        device=device)
    out = torch.empty((v.shape[0], 3),
                      dtype=torch.uint8 if as_uint8 else torch.float32,
                      device=v.device)
    for start in range(0, v.shape[0], chunk):
        rgb, _ = point_decoder(v[None, start:start + chunk])
        rgb = rgb[0, :, :3]
        if as_uint8:
            rgb = (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)
        out[start:start + chunk] = rgb
    return out


def extract_mesh(point_decoder: PointDecoder, grid_size: int = 128,
                 aabb: float = 0.45, threshold: float = 10.0,
                 chunk: int = 2**16,
                 sigma_grid: Optional[torch.Tensor] = None,
                 smooth: bool = False, device=None):
    """σ grid → triangles → per-vertex colours.  ``sigma_grid`` is an
    already dispatched :func:`query_grid_sigma` result.  Returns (verts
    (N, 3) world coordinates, colours (N, 3) in [0, 1], faces (T, 3)), all
    numpy."""
    if sigma_grid is None:
        sigma_grid = query_grid_sigma(point_decoder, grid_size, aabb, chunk,
                                      smooth=smooth, device=device)
    verts, faces = march_grid(sigma_grid.float().cpu().numpy(), grid_size,
                              aabb, threshold)
    rgb = dispatch_vertex_colors(point_decoder, verts, chunk,
                                 device=sigma_grid.device)
    colors = np.zeros_like(verts) if rgb is None \
        else np.clip(rgb.cpu().numpy(), 0.0, 1.0)
    return verts, colors, faces


def rotate_x(verts: np.ndarray, degrees: float = -90.0) -> np.ndarray:
    """Rotate about x (the reference exports with −90°)."""
    r = np.deg2rad(degrees)
    c, s = np.cos(r), np.sin(r)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)
    return (verts @ rot.T).astype(verts.dtype)


def _writer(symbol: str, color_type):
    fp = ctypes.POINTER(ctypes.c_float)
    return LIBRARIES.function(
        'mesh_io', symbol,
        [ctypes.c_char_p, fp, ctypes.POINTER(color_type), ctypes.c_int64,
         ctypes.POINTER(ctypes.c_int64), ctypes.c_int64],
        restype=ctypes.c_int64)


def _write(symbol, color_type, path, verts, colors, faces):
    v = np.ascontiguousarray(verts, np.float32)
    fc = np.ascontiguousarray(faces, np.int64)
    n = _writer(symbol, color_type)(
        str(path).encode(), v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        colors.ctypes.data_as(ctypes.POINTER(color_type)), len(v),
        fc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(fc))
    if n < 0:
        raise OSError(f'cannot write the mesh to {path}')


def export_obj(path: str, verts: np.ndarray, colors: np.ndarray,
               faces: np.ndarray):
    """Coloured OBJ (``v x y z r g b`` lines, 1-based faces), written by
    the native writer."""
    _write('ln_write_obj', ctypes.c_float, path, verts,
           np.ascontiguousarray(colors, np.float32), faces)


def export_ply(path: str, verts: np.ndarray, colors: np.ndarray,
               faces: np.ndarray):
    """ASCII PLY with uchar colours, written by the native writer."""
    _write('ln_write_ply', ctypes.c_uint8, path, verts,
           np.ascontiguousarray(np.clip(colors, 0, 1) * 255, np.uint8),
           faces)
