// Marching-tetrahedra isosurface extraction.
//
// Native replacement for the reference's PyMCubes dependency
// (reference mesh path: mcubes.marching_cubes(sigma, thres) at
// nsr/train_util_diffusion.py:208-249).  Marching tetrahedra instead of
// classic marching cubes: each cell is split into 6 tetrahedra, each tet
// has 16 sign cases trivially enumerable — no 256-entry tables, no
// ambiguous cases, watertight within its triangulation.
//
// The port's copy of ln3diff_tpu/native/marching_cubes.cpp, built at first
// use by ln3diff_tpu_torch/ops/_build.py with g++ and the flags of the JAX
// package's build, so that both march a grid to the same triangles.
//
// Grid layout: sigma[x*ny*nz + y*nz + z], vertices in index space
// (caller rescales to world coordinates).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

inline V3 lerp_vertex(const V3 &a, const V3 &b, float va, float vb,
                      float iso) {
  float denom = vb - va;
  float t = (denom > 1e-12f || denom < -1e-12f) ? (iso - va) / denom : 0.5f;
  if (t < 0.f) t = 0.f;
  if (t > 1.f) t = 1.f;
  return V3{a.x + t * (b.x - a.x), a.y + t * (b.y - a.y),
            a.z + t * (b.z - a.z)};
}

// The 6-tetrahedra decomposition of a cube (corner indices 0..7 with
// corner c = (x + (c&1), y + ((c>>1)&1), z + ((c>>2)&1))).
// All six share the main diagonal 0-7.
constexpr int kTets[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};

// Process one cell at (x, y, z); emits triangles through `emit`.
template <typename Emit>
inline void process_cell(const float *grid, int64_t syz, int64_t nz,
                         int64_t x, int64_t y, int64_t z, float iso,
                         Emit &&emit) {
  const float *col0 = grid + x * syz + y * nz;
  float cv[8];
  V3 cp[8];
  bool any_in = false, any_out = false;
  for (int c = 0; c < 8; ++c) {
    int64_t dx = c & 1, dy = (c >> 1) & 1, dz = (c >> 2) & 1;
    cv[c] = col0[dx * syz + dy * nz + z + dz];
    cp[c] = V3{float(x + dx), float(y + dy), float(z + dz)};
    (cv[c] > iso ? any_in : any_out) = true;
  }
  if (!any_in || !any_out) return;  // fully inside/outside

  for (const auto &tet : kTets) {
          const int i0 = tet[0], i1 = tet[1], i2 = tet[2], i3 = tet[3];
          int code = (cv[i0] > iso) | ((cv[i1] > iso) << 1) |
                     ((cv[i2] > iso) << 2) | ((cv[i3] > iso) << 3);
          if (code == 0 || code == 15) continue;

          // Canonicalize: ensure the "inside" set is the minority-coded
          // one by flipping; enumerate the 14 surface cases directly.
          auto ev = [&](int a, int b) {
            return lerp_vertex(cp[a], cp[b], cv[a], cv[b], iso);
          };
          switch (code) {
            case 1:  emit(ev(i0,i1), ev(i0,i2), ev(i0,i3)); break;
            case 14: emit(ev(i0,i2), ev(i0,i1), ev(i0,i3)); break;
            case 2:  emit(ev(i1,i0), ev(i1,i3), ev(i1,i2)); break;
            case 13: emit(ev(i1,i3), ev(i1,i0), ev(i1,i2)); break;
            case 4:  emit(ev(i2,i0), ev(i2,i1), ev(i2,i3)); break;
            case 11: emit(ev(i2,i1), ev(i2,i0), ev(i2,i3)); break;
            case 8:  emit(ev(i3,i0), ev(i3,i2), ev(i3,i1)); break;
            case 7:  emit(ev(i3,i2), ev(i3,i0), ev(i3,i1)); break;
            case 3:  // {i0,i1} inside
              emit(ev(i0,i2), ev(i0,i3), ev(i1,i2));
              emit(ev(i1,i2), ev(i0,i3), ev(i1,i3));
              break;
            case 12:
              emit(ev(i0,i3), ev(i0,i2), ev(i1,i2));
              emit(ev(i0,i3), ev(i1,i2), ev(i1,i3));
              break;
            case 5:  // {i0,i2}
              emit(ev(i0,i1), ev(i2,i1), ev(i0,i3));
              emit(ev(i2,i1), ev(i2,i3), ev(i0,i3));
              break;
            case 10:
              emit(ev(i2,i1), ev(i0,i1), ev(i0,i3));
              emit(ev(i2,i3), ev(i2,i1), ev(i0,i3));
              break;
            case 6:  // {i1,i2}
              emit(ev(i1,i0), ev(i2,i0), ev(i1,i3));
              emit(ev(i2,i0), ev(i2,i3), ev(i1,i3));
              break;
            case 9:
              emit(ev(i2,i0), ev(i1,i0), ev(i1,i3));
              emit(ev(i2,i3), ev(i2,i0), ev(i1,i3));
              break;
          }
  }
}

}  // namespace

extern "C" {

// Returns the number of triangles written (<= max_tris).  If the mesh
// would exceed max_tris, returns -needed (caller re-allocates).
// out_verts: 9 floats per triangle (3 vertices x xyz, index space).
int64_t marching_tetrahedra(const float *grid, int64_t nx, int64_t ny,
                            int64_t nz, float iso, float *out_verts,
                            int64_t max_tris) {
  int64_t n_tris = 0;
  int64_t needed = 0;
  const int64_t syz = ny * nz;

  auto emit = [&](const V3 &a, const V3 &b, const V3 &c) {
    ++needed;
    if (n_tris < max_tris) {
      float *o = out_verts + n_tris * 9;
      o[0] = a.x; o[1] = a.y; o[2] = a.z;
      o[3] = b.x; o[4] = b.y; o[5] = b.z;
      o[6] = c.x; o[7] = c.y; o[8] = c.z;
      ++n_tris;
    }
  };

  for (int64_t x = 0; x + 1 < nx; ++x)
    for (int64_t y = 0; y + 1 < ny; ++y)
      for (int64_t z = 0; z + 1 < nz; ++z)
        process_cell(grid, syz, nz, x, y, z, iso, emit);
  if (needed > max_tris) return -needed;
  return n_tris;
}

// Sparse variant: only the listed cells are processed.  `cells` holds
// linear indices over the (nx-1, ny-1, nz-1) CELL grid (row-major, z
// fastest) — the caller computes crossing candidates with a vectorized
// scan (numpy) so the serial per-cell loop never touches the ~99% of
// cells with no sign change.  Semantics identical to the dense entry
// when `cells` = all crossing cells (each cell's triangles depend only
// on its own 8 corners).
int64_t marching_tetrahedra_cells(const float *grid, int64_t nx, int64_t ny,
                                  int64_t nz, float iso,
                                  const int64_t *cells, int64_t n_cells,
                                  float *out_verts, int64_t max_tris) {
  int64_t n_tris = 0;
  int64_t needed = 0;
  const int64_t syz = ny * nz;
  const int64_t cy = ny - 1, cz = nz - 1;

  auto emit = [&](const V3 &a, const V3 &b, const V3 &c) {
    ++needed;
    if (n_tris < max_tris) {
      float *o = out_verts + n_tris * 9;
      o[0] = a.x; o[1] = a.y; o[2] = a.z;
      o[3] = b.x; o[4] = b.y; o[5] = b.z;
      o[6] = c.x; o[7] = c.y; o[8] = c.z;
      ++n_tris;
    }
  };

  for (int64_t i = 0; i < n_cells; ++i) {
    const int64_t cell = cells[i];
    const int64_t z = cell % cz;
    const int64_t y = (cell / cz) % cy;
    const int64_t x = cell / (cz * cy);
    process_cell(grid, syz, nz, x, y, z, iso, emit);
  }
  if (needed > max_tris) return -needed;
  return n_tris;
}

}  // extern "C"
