// Device code of the fused self-attention: the kernel of fused_attention.cu
// (kernel 3), also run by fused_qkv_attention.cu (kernel 4) over the
// workspace its projection writes.  The algorithm (two passes over K, the
// normalised p rounded to the input dtype) is described at the top of
// fused_attention.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace attn {

constexpr int TQ = 64;            // query rows per block
constexpr int TK = 64;            // key rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RW = TQ / WARPS;    // query rows per warp

struct Strides {
    long long b, l, h;            // in elements; the d stride is 1
};

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    Strides sq, sk, sv, so;
    int L, H;
    float scale;
};

// Shared memory of one block.  bf16: Q, K, V and P padded by 8 elements a
// row (wmma wants a multiple of 16 bytes, the pad spreads the banks) and an
// f32 staging tile S for the warps' scores and, at the end, their outputs.
// f32: rows padded by one element so that lanes reading a column of K hit
// different banks; no staging tile.
template <typename T, int D>
struct Layout {
    static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
    static constexpr int LD = kMma ? D + 8 : D + 1;
    static constexpr int LDP = kMma ? TK + 8 : TK + 1;
    static constexpr int LDS = TK + 4;
    static constexpr size_t kQ = 0;
    static constexpr size_t kK = kQ + sizeof(T) * TQ * LD;
    static constexpr size_t kV = kK + sizeof(T) * TK * LD;
    static constexpr size_t kP = kV + sizeof(T) * TK * LD;
    static constexpr size_t kS = kP + sizeof(T) * TQ * LDP;
    static constexpr size_t bytes = kS + (kMma ? sizeof(float) * TQ * LDS : 0);
    static_assert(!kMma || (kK % 32 == 0 && kV % 32 == 0 && kP % 32 == 0 &&
                            kS % 32 == 0),
                  "wmma tiles must start on 32-byte boundaries");
    static_assert(LDS >= D, "the staging tile holds the outputs too");
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// Copy `rows` rows of D elements (row stride `stride` in global memory)
// into a ROWS-row tile with row stride LD; rows past `rows` are zeroed, so
// masked keys meet v = 0 and never a stale value.
template <typename T, int D, int LD, int ROWS = 64>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int rows) {
    constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
    constexpr int CPR = D / VEC;            // loads per row
    for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
        const int r = i / CPR;
        const int c = (i - r * CPR) * VEC;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows)
            val = *reinterpret_cast<const uint4*>(src + r * stride + c);
        if constexpr ((LD * sizeof(T)) % 16 == 0) {
            *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
        } else {
            const uint32_t w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
                dst[r * LD + c + j] = __uint_as_float(w[j]);
        }
    }
}

namespace wmma = nvcuda::wmma;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Raw scores of the warp's 16 query rows against the 64 keys of the tile:
// s[r][c] = q_r . k_{lane + 32c}.  bf16: wmma from the warp's Q fragments
// `qa`, staged through the warp's f32 tile Sw; f32: FMA on the CUDA cores
// straight from Q_s.
template <typename T, int D, int NQ>
__device__ __forceinline__ void scores(float (&s)[RW][2], const T* Q_s,
                                       const T* K_s, float* Sw,
                                       const FragA (&qa)[NQ], int warp,
                                       int lane) {
    using Lay = Layout<T, D>;
    if constexpr (Lay::kMma) {
#pragma unroll
        for (int n = 0; n < TK / 16; ++n) {
            FragC acc;
            wmma::fill_fragment(acc, 0.f);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                // k^T as a col-major B: element (i, j) = K[16n + j][16kk + i]
                FragBc kb;
                wmma::load_matrix_sync(kb, K_s + 16 * n * Lay::LD + 16 * kk,
                                       Lay::LD);
                wmma::mma_sync(acc, qa[kk], kb, acc);
            }
            wmma::store_matrix_sync(Sw + 16 * n, acc, Lay::LDS,
                                    wmma::mem_row_major);
        }
        __syncwarp();
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            s[r][0] = Sw[r * Lay::LDS + lane];
            s[r][1] = Sw[r * Lay::LDS + lane + 32];
        }
        __syncwarp();
    } else {
        const T* Qw = Q_s + warp * RW * Lay::LD;
#pragma unroll
        for (int r = 0; r < RW; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < D; ++kk) {
            const float k0 = K_s[lane * Lay::LD + kk];
            const float k1 = K_s[(lane + 32) * Lay::LD + kk];
#pragma unroll
            for (int r = 0; r < RW; ++r) {
                const float q = Qw[r * Lay::LD + kk];
                s[r][0] = fmaf(q, k0, s[r][0]);
                s[r][1] = fmaf(q, k1, s[r][1]);
            }
        }
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const Params p) {
    using Lay = Layout<T, D>;
    constexpr bool kMma = Lay::kMma;
    constexpr int NC = D / 32;     // output columns per lane (SIMT path)
    extern __shared__ __align__(128) unsigned char smem[];
    T* Q_s = reinterpret_cast<T*>(smem + Lay::kQ);
    T* K_s = reinterpret_cast<T*>(smem + Lay::kK);
    T* V_s = reinterpret_cast<T*>(smem + Lay::kV);
    T* P_s = reinterpret_cast<T*>(smem + Lay::kP);
    float* S_s = reinterpret_cast<float*>(smem + Lay::kS);

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.y / p.H;
    const int h = blockIdx.y - b * p.H;
    const int q0 = blockIdx.x * TQ;
    const int L = p.L;
    const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
    const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
    const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
    T* og = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;
    T* Pw = P_s + warp * RW * Lay::LDP;
    float* Sw = S_s + warp * RW * Lay::LDS;

    load_tile<T, D, Lay::LD>(Q_s, qg + (long long)q0 * p.sq.l, p.sq.l,
                             min(TQ, L - q0));
    __syncthreads();

    constexpr int NQ = kMma ? D / 16 : 1;
    FragA qa[NQ];
    if constexpr (kMma) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wmma::load_matrix_sync(qa[kk], Q_s + warp * RW * Lay::LD + 16 * kk,
                                   Lay::LD);
    }

    // ---- pass 1: row max and row sum of exp(s - max) ----
    float m[RW], l[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
    }
    float s[RW][2];
    for (int k0 = 0; k0 < L; k0 += TK) {
        load_tile<T, D, Lay::LD>(K_s, kg + (long long)k0 * p.sk.l, p.sk.l,
                                 min(TK, L - k0));
        __syncthreads();
        scores<T, D, NQ>(s, Q_s, K_s, Sw, qa, warp, lane);
        __syncthreads();           // K_s free for the next tile
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            if (k0 + lane + 32 * c >= L) continue;
#pragma unroll
            for (int r = 0; r < RW; ++r) {
                const float x = s[r][c] * p.scale;
                if (x > m[r]) {
                    l[r] = l[r] * expf(m[r] - x) + 1.f;
                    m[r] = x;
                } else {
                    l[r] += expf(x - m[r]);
                }
            }
        }
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        const float mx = warp_max(m[r]);
        l[r] = warp_sum(l[r] * expf(m[r] - mx));   // exp(-inf) = 0
        m[r] = mx;
    }

    // ---- pass 2: p = exp(s - m) / l in the input dtype, o += p v ----
    float acc[kMma ? 1 : RW][NC];
    FragC oacc[kMma ? D / 16 : 1];
    if constexpr (kMma) {
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) wmma::fill_fragment(oacc[dn], 0.f);
    } else {
#pragma unroll
        for (int r = 0; r < RW; ++r)
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
    }
    for (int k0 = 0; k0 < L; k0 += TK) {
        const int rows = min(TK, L - k0);
        load_tile<T, D, Lay::LD>(K_s, kg + (long long)k0 * p.sk.l, p.sk.l,
                                 rows);
        load_tile<T, D, Lay::LD>(V_s, vg + (long long)k0 * p.sv.l, p.sv.l,
                                 rows);
        __syncthreads();
        scores<T, D, NQ>(s, Q_s, K_s, Sw, qa, warp, lane);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const bool ok = k0 + lane + 32 * c < L;
#pragma unroll
            for (int r = 0; r < RW; ++r) {
                const float e = ok ? expf(s[r][c] * p.scale - m[r]) : 0.f;
                Pw[r * Lay::LDP + lane + 32 * c] = from_float<T>(e / l[r]);
            }
        }
        __syncwarp();
        if constexpr (kMma) {
#pragma unroll
            for (int kb = 0; kb < TK / 16; ++kb) {
                FragA pa;
                wmma::load_matrix_sync(pa, Pw + 16 * kb, Lay::LDP);
#pragma unroll
                for (int dn = 0; dn < D / 16; ++dn) {
                    FragBr vb;
                    wmma::load_matrix_sync(
                        vb, V_s + 16 * kb * Lay::LD + 16 * dn, Lay::LD);
                    wmma::mma_sync(oacc[dn], pa, vb, oacc[dn]);
                }
            }
        } else {
#pragma unroll 4
            for (int kv = 0; kv < TK; ++kv) {
                float vv[NC];
#pragma unroll
                for (int c = 0; c < NC; ++c)
                    vv[c] = V_s[kv * Lay::LD + lane + 32 * c];
#pragma unroll
                for (int r = 0; r < RW; ++r) {
                    const float pr = Pw[r * Lay::LDP + kv];
#pragma unroll
                    for (int c = 0; c < NC; ++c)
                        acc[r][c] = fmaf(pr, vv[c], acc[r][c]);
                }
            }
        }
        __syncthreads();           // K_s, V_s and P free for the next tile
    }

    // ---- write o (B, L, H, d) in the input dtype ----
    if constexpr (kMma) {
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn)
            wmma::store_matrix_sync(Sw + 16 * dn, oacc[dn], Lay::LDS,
                                    wmma::mem_row_major);
        __syncwarp();
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        const int row = q0 + warp * RW + r;
        if (row >= L) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            float val;
            if constexpr (kMma) val = Sw[r * Lay::LDS + lane + 32 * c];
            else val = acc[r][c];
            og[(long long)row * p.so.l + lane + 32 * c] = from_float<T>(val);
        }
    }
}

template <typename T, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
    constexpr int smem = (int)Layout<T, D>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((p.L + TQ - 1) / TQ), (unsigned)(B * p.H));
    attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace attn
