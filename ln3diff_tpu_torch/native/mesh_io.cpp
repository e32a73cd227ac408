// Fast colored-mesh writers (OBJ / ascii PLY).
//
// The port's copy of ln3diff_tpu/native/mesh_io.cpp (built by
// ln3diff_tpu_torch/ops/_build.py).  The reference exports meshes through
// trimesh; these writers stream through a large stdio buffer, in the file
// layout of the JAX package's writers, byte for byte.

#include <cstdint>
#include <cstdio>
#include <vector>

extern "C" {

// verts (n,3) float, colors (n,3) float in [0,1], faces (m,3) int64.
int64_t ln_write_obj(const char* path, const float* verts,
                     const float* colors, int64_t n_verts,
                     const int64_t* faces, int64_t n_faces) {
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  std::vector<char> buf(1 << 22);
  std::setvbuf(f, buf.data(), _IOFBF, buf.size());
  for (int64_t i = 0; i < n_verts; ++i) {
    const float* v = verts + 3 * i;
    const float* c = colors + 3 * i;
    std::fprintf(f, "v %.6f %.6f %.6f %.4f %.4f %.4f\n",
                 v[0], v[1], v[2], c[0], c[1], c[2]);
  }
  for (int64_t i = 0; i < n_faces; ++i) {
    const int64_t* t = faces + 3 * i;
    std::fprintf(f, "f %lld %lld %lld\n", (long long)(t[0] + 1),
                 (long long)(t[1] + 1), (long long)(t[2] + 1));
  }
  std::fclose(f);
  return n_verts;
}

int64_t ln_write_ply(const char* path, const float* verts,
                     const uint8_t* colors255, int64_t n_verts,
                     const int64_t* faces, int64_t n_faces) {
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  std::vector<char> buf(1 << 22);
  std::setvbuf(f, buf.data(), _IOFBF, buf.size());
  std::fprintf(f,
               "ply\nformat ascii 1.0\n"
               "element vertex %lld\n"
               "property float x\nproperty float y\nproperty float z\n"
               "property uchar red\nproperty uchar green\n"
               "property uchar blue\n"
               "element face %lld\n"
               "property list uchar int vertex_indices\nend_header\n",
               (long long)n_verts, (long long)n_faces);
  for (int64_t i = 0; i < n_verts; ++i) {
    const float* v = verts + 3 * i;
    const uint8_t* c = colors255 + 3 * i;
    std::fprintf(f, "%.6f %.6f %.6f %u %u %u\n", v[0], v[1], v[2],
                 (unsigned)c[0], (unsigned)c[1], (unsigned)c[2]);
  }
  for (int64_t i = 0; i < n_faces; ++i) {
    const int64_t* t = faces + 3 * i;
    std::fprintf(f, "3 %lld %lld %lld\n", (long long)t[0],
                 (long long)t[1], (long long)t[2]);
  }
  std::fclose(f);
  return n_verts;
}

}  // extern "C"
