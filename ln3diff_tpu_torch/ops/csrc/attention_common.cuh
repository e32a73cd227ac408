// Device code of the fused self-attention: the kernels of
// fused_attention.cu (kernel 3), also run by fused_qkv_attention.cu
// (kernel 4) over the workspace its projection writes.  The algorithm (two
// passes over K, the normalised p rounded to the input dtype) and the
// design are described at the top of fused_attention.cu.
//
// Two kernels, one per operand type:
//   attn::sm90::attention_kernel  bf16, wgmma + TMA (the DiT's path);
//   attn::simt::attention_kernel  f32, FMA on the CUDA cores (no model
//                                 path runs it; no tensor-core
//                                 instruction keeps f32's numerics).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace attn {

// q, k, v and o: (B, L, H, d) through (batch, row, head) strides in bytes;
// the d stride is one element.
struct Strides {
    long long b, l, h;
};

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    Strides sq, sk, sv, so;
    int B, L, H;
    float scale;
};

// ===========================================================================
// bf16: one warpgroup of 64 query rows per block, K and V streamed by TMA
// ===========================================================================
namespace sm90 {

using namespace ::hopper;

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int STAGES = 3;        // K/V tiles in flight
constexpr int CONSUMERS = 128;   // one warpgroup
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory: Q (later O) | K ring | V ring | mbarriers.  Rows are d
// bf16 = 2d bytes, which is also the swizzle (128 B for d = 64, 64 B for
// d = 32), so one 64-row tile is 8 or 4 KB and each starts on a
// 1024-byte boundary.
template <int D>
struct Smem {
    static constexpr int ROW = 2 * D;
    static constexpr int SW = ROW;
    static constexpr int TILE = BK * ROW;
    static constexpr int kQ = 0;
    static constexpr int kK = kQ + TILE;
    static constexpr int kV = kK + STAGES * TILE;
    static constexpr int kBar = kV + STAGES * TILE;   // full, empty, q
    static constexpr int bytes = kBar + 8 * (2 * STAGES + 1) + 1024;
    static_assert(TILE % 1024 == 0, "tiles must keep 1024-byte alignment");
};

// Issue s = q · k_tileᵀ for the warpgroup's 64 rows and the tile's 64 keys
// (f32, unscaled), both operands K-major in shared memory, as one wgmma
// group; the caller waits for it.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint64_t dq,
                                             uint64_t dk) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)        // 16 columns = 32 bytes
        wgmma_ss_n64<0>(s, dq + 2 * kk, dk + 2 * kk);
    wgmma_commit();
}

// o += p · v_tile: p (64 x 64) bf16 from registers, v (64 keys x D) an
// MN-major B in shared memory; each step takes the next 16 keys
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 2],
                                        const uint32_t (&a)[4][4],
                                        uint64_t dv) {
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const uint64_t db = dv + (16 * Smem<D>::ROW >> 4) * c;
        if constexpr (D == 64) wgmma_rs_n64<1>(o, a[c], db);
        else wgmma_rs_n32<1>(o, a[c], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
}

// 2^x on the special-function unit (one instruction; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Raw scores of keys at or past `kmax` (columns of the tile) to -inf: TMA
// fills those rows of K with zeros, which would score 0
__device__ __forceinline__ void mask_keys(float (&s)[32], int kmax, int t4) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
        if (8 * (i >> 2) + 2 * t4 + (i & 1) >= kmax) s[i] = -INFINITY;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 3)
attention_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mo, int L, int H,
                 float scale_log2) {
    using S = Smem<D>;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
    unsigned char* smem = smem_raw + pad;
    const uint32_t base = raw + pad;
    const uint32_t sQ = base + S::kQ, sK = base + S::kK, sV = base + S::kV;
    const uint32_t full = base + S::kBar;
    const uint32_t empty = full + 8 * STAGES;
    const uint32_t qbar = empty + 8 * STAGES;

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * BQ;
    const int b = blockIdx.y / H;
    const int h = blockIdx.y - b * H;
    const int nk = (L + BK - 1) / BK;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, CONSUMERS / 32);
        }
        mbar_init(qbar, 1);
        mbar_init_fence();
    }
    __syncthreads();

    if (tid >= CONSUMERS) {
        // ---- producer: Q once, then K (pass 1), then K and V (pass 2)
        if (tid == CONSUMERS) {
            mbar_expect_tx(qbar, S::TILE);
            tma_load_4d(sQ, &mq, qbar, 0, q0, h, b);
            int stage = 0;
            uint32_t phase = 0;
            for (int it = 0; it < 2 * nk; ++it) {
                const bool pass2 = it >= nk;
                const int k0 = (pass2 ? it - nk : it) * BK;
                mbar_wait(empty + 8 * stage, phase ^ 1);
                mbar_expect_tx(full + 8 * stage,
                               pass2 ? 2 * S::TILE : S::TILE);
                tma_load_4d(sK + stage * S::TILE, &mk, full + 8 * stage, 0,
                            k0, h, b);
                if (pass2)
                    tma_load_4d(sV + stage * S::TILE, &mv, full + 8 * stage,
                                0, k0, h, b);
                if (++stage == STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
        return;
    }

    // ---- consumer warpgroup ----
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t4 = lane & 3;
    mbar_wait(qbar, 0);
    const uint64_t dq = smem_desc(sQ, 0, 8 * S::ROW, S::SW);

    // ring position of the it-th tile the consumer takes (pass 1 takes
    // tiles 0..nk-1, pass 2 tiles nk..2nk-1)
    auto stage_of = [](int it) { return it % STAGES; };
    auto wait_tile = [&](int it) {
        mbar_wait(full + 8 * stage_of(it), (uint32_t)(it / STAGES) & 1u);
    };
    auto release = [&](int it) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * stage_of(it));
    };
    auto kdesc = [&](int it) {
        return smem_desc(sK + stage_of(it) * S::TILE, 0, 8 * S::ROW, S::SW);
    };

    // pass 1: per thread and row, a running max m and sum l of
    // 2^(s·c - m) over the thread's columns, in log2 units
    // (c = scale·log2(e) > 0, so the max of s·c is c times the max of s).
    // The next tile's scores are issued before this tile's sums, so the
    // tensor cores and the exp2s overlap: two score buffers, in turns.
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    auto stats = [&](float (&s)[32], int j) {
        if (L - j * BK < BK) mask_keys(s, L - j * BK, t4);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float tmax = -INFINITY;
#pragma unroll
            for (int c = 0; c < 8; ++c)
                tmax = fmaxf(tmax, fmaxf(s[4 * c + 2 * r],
                                         s[4 * c + 2 * r + 1]));
            if (tmax == -INFINITY) continue;  // all of this tile masked
            const float mn = fmaxf(m[r], tmax * scale_log2);
            float acc = l[r] * ex2(m[r] - mn);    // 2^-inf = 0
#pragma unroll
            for (int c = 0; c < 8; ++c)
                acc += ex2(fmaf(s[4 * c + 2 * r], scale_log2, -mn))
                       + ex2(fmaf(s[4 * c + 2 * r + 1], scale_log2, -mn));
            l[r] = acc;
            m[r] = mn;
        }
    };
    float sa[32], sb[32];
    wait_tile(0);
    issue_scores<D>(sa, dq, kdesc(0));
    for (int j = 0; j < nk; j += 2) {
        if (j + 1 < nk) {
            wait_tile(j + 1);
            issue_scores<D>(sb, dq, kdesc(j + 1));
            wgmma_wait<1>();
        } else {
            wgmma_wait<0>();
        }
        fence_regs(sa);
        release(j);
        stats(sa, j);
        if (j + 1 >= nk) break;
        if (j + 2 < nk) {
            wait_tile(j + 2);
            issue_scores<D>(sa, dq, kdesc(j + 2));
            wgmma_wait<1>();
        } else {
            wgmma_wait<0>();
        }
        fence_regs(sb);
        release(j + 1);
        stats(sb, j + 1);
    }
    // a row's four lanes merge their (m, l)
    float inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float mx = m[r];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float lr = m[r] == -INFINITY ? 0.f : l[r] * ex2(m[r] - mx);
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        m[r] = mx;
        inv_l[r] = 1.f / lr;
    }

    // pass 2: p = 2^(s·c - m) · (1/l), rounded to bf16 in registers, then
    // o += p v (issuing the next tile's scores ahead, as in pass 1, measured
    // slower here: it keeps a third 32-register tile live)
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    for (int j = 0; j < nk; ++j) {
        const int it = nk + j;
        wait_tile(it);
        issue_scores<D>(sa, dq, kdesc(it));
        wgmma_wait<0>();
        fence_regs(sa);
        if (L - j * BK < BK) mask_keys(sa, L - j * BK, t4);
        uint32_t a[4][4];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
            const int r = (i >> 1) & 1;
            a[i >> 3][(i >> 1) & 3] = pack_bf16(
                ex2(fmaf(sa[i], scale_log2, -m[r])) * inv_l[r],
                ex2(fmaf(sa[i + 1], scale_log2, -m[r])) * inv_l[r]);
        }
        pv_tile<D>(o, a, smem_desc(sV + stage_of(it) * S::TILE, 0,
                                   8 * S::ROW, S::SW));
        release(it);
    }

    // o → bf16 into Q's tile (swizzled as the map expects), then one TMA
    // store; rows at or past L fall outside the map and are not written
    named_barrier(1, CONSUMERS);
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
        const int row = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
        const int col = 8 * (i >> 2) + 2 * t4;
        *reinterpret_cast<uint32_t*>(
            smem + S::kQ + swizzle<S::SW>(row * S::ROW + 2 * col)) =
            pack_bf16(o[i], o[i + 1]);
    }
    fence_async_smem();
    named_barrier(1, CONSUMERS);
    if (tid == 0) {
        tma_store_4d(&mo, sQ, 0, q0, h, b);
        tma_store_wait();
    }
}

// (B, L, H, D) bf16 at `ptr` through byte strides `st`, read and written
// in boxes of 64 rows of one (b, h)
template <int D>
int encode_rows(CUtensorMap* map, const void* ptr, const Strides& st, int B,
                int L, int H) {
    const uint64_t dims[4] = {(uint64_t)D, (uint64_t)L, (uint64_t)H,
                              (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)st.l, (uint64_t)st.h,
                                 (uint64_t)st.b};
    const uint32_t box[4] = {(uint32_t)D, (uint32_t)BK, 1, 1};
    return encode_bf16(map, ptr, 4, dims, strides, box, Smem<D>::SW);
}

template <int D>
int launch(const Params& p, cudaStream_t stream) {
    constexpr int smem = Smem<D>::bytes;
    const cudaError_t attr = allow_dynamic_smem<attention_kernel<D>>(smem);
    if (attr != cudaSuccess) return (int)attr;
    CUtensorMap mq, mk, mv, mo;
    int err;
    if ((err = encode_rows<D>(&mq, p.q, p.sq, p.B, p.L, p.H))) return err;
    if ((err = encode_rows<D>(&mk, p.k, p.sk, p.B, p.L, p.H))) return err;
    if ((err = encode_rows<D>(&mv, p.v, p.sv, p.B, p.L, p.H))) return err;
    if ((err = encode_rows<D>(&mo, p.o, p.so, p.B, p.L, p.H))) return err;
    const dim3 grid((unsigned)((p.L + BQ - 1) / BQ), (unsigned)(p.B * p.H));
    attention_kernel<D><<<grid, THREADS, smem, stream>>>(
        mq, mk, mv, mo, p.L, p.H, p.scale * LOG2E);
    return (int)cudaGetLastError();
}

}  // namespace sm90

// ===========================================================================
// f32: FMA on the CUDA cores, one block of 4 warps per 64 query rows
// ===========================================================================
namespace simt {

constexpr int TQ = 64;            // query rows per block
constexpr int TK = 64;            // key rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RW = TQ / WARPS;    // query rows per warp

// Shared memory of one block: Q, K, V and P, rows padded by one element so
// that lanes reading a column of K hit different banks.
template <int D>
struct Layout {
    static constexpr int LD = D + 1;
    static constexpr int LDP = TK + 1;
    static constexpr size_t kQ = 0;
    static constexpr size_t kK = kQ + sizeof(float) * TQ * LD;
    static constexpr size_t kV = kK + sizeof(float) * TK * LD;
    static constexpr size_t kP = kV + sizeof(float) * TK * LD;
    static constexpr size_t bytes = kP + sizeof(float) * TQ * LDP;
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

// Copy `rows` rows of C floats (row stride `stride` elements in global
// memory) into a ROWS-row tile with row stride LDS; rows past `rows` are
// zeroed, so masked keys meet v = 0 and never a stale value.  THREADS
// threads share the copy, 16 bytes each.
template <int C, int LDS, int ROWS, int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride, int rows) {
    constexpr int CPR = C / 4;              // 16-byte loads per row
    for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
        const int r = i / CPR;
        const int c = (i - r * CPR) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < rows)
            val = *reinterpret_cast<const float4*>(src + r * stride + c);
        dst[r * LDS + c] = val.x;
        dst[r * LDS + c + 1] = val.y;
        dst[r * LDS + c + 2] = val.z;
        dst[r * LDS + c + 3] = val.w;
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const Params p) {
    using Lay = Layout<D>;
    constexpr int NC = D / 32;     // output columns per lane
    extern __shared__ __align__(128) unsigned char smem[];
    float* Q_s = reinterpret_cast<float*>(smem + Lay::kQ);
    float* K_s = reinterpret_cast<float*>(smem + Lay::kK);
    float* V_s = reinterpret_cast<float*>(smem + Lay::kV);
    float* P_s = reinterpret_cast<float*>(smem + Lay::kP);

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.y / p.H;
    const int h = blockIdx.y - b * p.H;
    const int q0 = blockIdx.x * TQ;
    const int L = p.L;
    // byte strides → element strides
    const long long sql = p.sq.l / 4, skl = p.sk.l / 4, svl = p.sv.l / 4,
                    sol = p.so.l / 4;
    const float* qg = static_cast<const float*>(p.q) + b * (p.sq.b / 4)
                      + h * (p.sq.h / 4);
    const float* kg = static_cast<const float*>(p.k) + b * (p.sk.b / 4)
                      + h * (p.sk.h / 4);
    const float* vg = static_cast<const float*>(p.v) + b * (p.sv.b / 4)
                      + h * (p.sv.h / 4);
    float* og = static_cast<float*>(p.o) + b * (p.so.b / 4)
                + h * (p.so.h / 4);
    float* Pw = P_s + warp * RW * Lay::LDP;
    const float* Qw = Q_s + warp * RW * Lay::LD;

    load_tile<D, Lay::LD, TQ, THREADS>(Q_s, qg + (long long)q0 * sql, sql,
                                       min(TQ, L - q0));
    __syncthreads();

    // raw scores of the warp's 16 query rows against the 64 keys of the
    // tile: s[r][c] = q_r . k_{lane + 32c}
    float s[RW][2];
    auto scores = [&]() {
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
    };

    // ---- pass 1: row max and row sum of exp(s - max) ----
    float m[RW], l[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
    }
    for (int k0 = 0; k0 < L; k0 += TK) {
        load_tile<D, Lay::LD, TK, THREADS>(K_s, kg + (long long)k0 * skl,
                                           skl, min(TK, L - k0));
        __syncthreads();
        scores();
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

    // ---- pass 2: p = exp(s - m) / l, o += p v ----
    float acc[RW][NC];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < L; k0 += TK) {
        const int rows = min(TK, L - k0);
        load_tile<D, Lay::LD, TK, THREADS>(K_s, kg + (long long)k0 * skl,
                                           skl, rows);
        load_tile<D, Lay::LD, TK, THREADS>(V_s, vg + (long long)k0 * svl,
                                           svl, rows);
        __syncthreads();
        scores();
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const bool ok = k0 + lane + 32 * c < L;
#pragma unroll
            for (int r = 0; r < RW; ++r) {
                const float e = ok ? expf(s[r][c] * p.scale - m[r]) : 0.f;
                Pw[r * Lay::LDP + lane + 32 * c] = e / l[r];
            }
        }
        __syncwarp();
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
        __syncthreads();           // K_s, V_s and P free for the next tile
    }

    // ---- write o (B, L, H, d) ----
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        const int row = q0 + warp * RW + r;
        if (row >= L) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c)
            og[(long long)row * sol + lane + 32 * c] = acc[r][c];
    }
}

template <int D>
int launch(const Params& p, cudaStream_t stream) {
    constexpr int smem = (int)Layout<D>::bytes;
    const cudaError_t attr = allow_dynamic_smem<attention_kernel<D>>(smem);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((unsigned)((p.L + TQ - 1) / TQ), (unsigned)(p.B * p.H));
    attention_kernel<D><<<grid, THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace simt

// bf16 → the wgmma kernel, f32 → the CUDA-core kernel; d is 32 or 64
inline int launch(const Params& p, bool bf16, int d, cudaStream_t stream) {
    if (bf16)
        return d == 64 ? sm90::launch<64>(p, stream)
                       : sm90::launch<32>(p, stream);
    return d == 64 ? simt::launch<64>(p, stream)
                   : simt::launch<32>(p, stream);
}

}  // namespace attn
