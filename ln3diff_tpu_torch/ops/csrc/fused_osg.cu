// Fused triplane point pipeline for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `_osg_forward` of
// ln3diff_tpu/ops/fused_render.py (:98, :143; pallas_call at :200).
// Per point m it computes, from the gathered corner-packed rows of the
// three planes,
//
//   f_k   = w00*c00 + w01*c01 + w10*c10 + w11*c11        (rows' dtype)
//           with w00 = (1-tx)(1-ty)live, w01 = tx(1-ty)live,
//                w10 = (1-tx)ty live,    w11 = tx ty live
//   x     = (f_0 + f_1 + f_2) * (1/3)                      (f32)
//   h     = softplus(x @ w1 + b1)                          (f32, 32 -> 64)
//   out   = h @ w2 + b2                                    (f32, 64 -> 33)
//   sigma = out[0], rgb = act(out[1:])  (sigmoid*1.002-0.001 or lrelu*sqrt2)
//   inbox: sigma -> -1e10 and rgb -> 0 where inbox <= 0 (optional)
//
// Precision follows the TPU kernel: with bf16 rows the lerp is done in
// bf16 arithmetic (every product and sum rounded to bf16, in the same
// order as the TPU kernel and the plain PyTorch version), the plane mean
// and both layers in f32.  f32 rows lerp in f32.
//
// What bounds it on an H100: per point it reads 768 B of bf16 rows, 36 B
// of tx/ty/live and 4 B of inbox and writes 132 B, against 12.6 kFLOP of
// MLP, so at 3.35 TB/s the render pass (M = 2,359,296) cannot take less
// than 0.662 ms: the bytes bound it.  The first design took 1.902 ms
// (NVIDIA H100 80GB HBM3, 700 W): its MLP ran on the CUDA cores with
// about one shared-memory load per FMA (some 9.1k warp-wide loads per
// 64-point tile, at one a clock per SM), its loads and math were
// separated by barriers, and its lerp rounded op by op in f32.  This
// design:
//
// * streams the rows through a ring in shared memory: one producer warp
//   per block issues, per tile and plane, one 1-D bulk copy of the tile's
//   contiguous rows (no tensor map) and 4-byte cp.async copies of the
//   per-point inputs, on a full/empty mbarrier pair per stage, while the
//   consumer warps work on earlier tiles.  A persistent grid (one block per
//   SM, weights staged once) walks the tiles; a consumer releases its
//   stage right after the lerp, so the next copy overlaps the MLP;
// * lerps in packed bf16x2 (mul.rn / add.rn, one instruction per two
//   channels and op, each rounding once as the op-by-op f32 version did;
//   the lerp weights too), reading each corner chunk with a 16-byte load;
// * runs both layers on the tensor cores (mma.sync m16n8k8 TF32, 3xTF32
//   split for f32 accuracy) from registers: each warp owns 16 points, the
//   lerp leaves x in the A fragments and layer 1's accumulators are layer
//   2's A fragments (osg_common.cuh), the weights sit pre-split in
//   fragment order in shared memory (one 16-byte load per B fragment,
//   feeding three mma); softplus and sigmoid take their exp2, log2 and
//   reciprocal from the special-function unit;
// * stores rgb straight from the accumulators (8-byte stores that fill
//   whole 32-byte sectors) and sigma from one lane per point; the ragged
//   last tile is copied and stored only up to M.
//
// bf16 rows: 3 stages of 64 points (48 KB of rows each) and two consumer
// warpgroups that take alternate tiles (288 threads, 192 KB of shared
// memory).  f32 rows (96 KB per tile) keep one stage and one warpgroup.
// At the render pass the math alone takes about three quarters of the
// stream's time, and the kernel runs within a few percent of its stream,
// which reaches nine tenths of the bytes bound
// (scripts/osg_card_check.py --ablate; PERF.md).
//
// OSG_ABLATE (0 when not defined) builds cut-down variants for measuring
// what bounds the kernel (scripts/osg_card_check.py --ablate): 1 streams
// the tiles and stores zeros, 2 skips the MLP, 3 skips the copies and
// computes on whatever the ring holds.

#include "osg_common.cuh"

#ifndef OSG_ABLATE
#define OSG_ABLATE 0
#endif

namespace {

using namespace osg;
using namespace hopper;

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
    static constexpr int STAGES = 3, GROUPS = 2;
};
template <> struct Cfg<float> {
    static constexpr int STAGES = 1, GROUPS = 1;
};

constexpr int NSCAL = 10;   // tx, ty, live of the three planes; inbox

// shared memory, in bytes: the barriers, the two layers' weights in
// fragment order (pre-split), then the ring
template <typename T>
struct Layout {
    static constexpr int STAGES = Cfg<T>::STAGES, GROUPS = Cfg<T>::GROUPS;
    static constexpr int CONSUMERS = 32 * WPT * GROUPS;
    static constexpr int THREADS = CONSUMERS + 32;
    static constexpr uint32_t ROWS = 3 * P * 4 * C * sizeof(T);
    static constexpr uint32_t STAGE = ROWS + NSCAL * P * 4;
    static constexpr uint32_t W1F = 128;
    static constexpr uint32_t W2F = W1F + W1::KK * W1::NT * 32 * 16;
    static constexpr uint32_t RING = W2F + W2::KK * W2::NT * 32 * 16;
    static constexpr uint32_t BYTES = RING + STAGES * STAGE;
    static_assert(16 * STAGES <= W1F, "barriers fit before the weights");
    static_assert(STAGE % 128 == 0, "stages stay 128-byte aligned");
    static_assert(BYTES <= 232448, "fits one block per SM");
    static_assert(RAW_FLOATS * 4 <= STAGE, "the weights' scratch fits");
};

template <typename T>
__global__ void __launch_bounds__(Layout<T>::THREADS, 1)
osg_forward_kernel(const T* __restrict__ rows, const float* __restrict__ tx,
                   const float* __restrict__ ty,
                   const float* __restrict__ live,
                   const float* __restrict__ inbox,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   float* __restrict__ rgb, float* __restrict__ sigma,
                   long long M, int activation) {
    using L = Layout<T>;
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t base = smem_u32(smem);
    const uint32_t full = base, empty = base + 8 * L::STAGES;
    const float4* w1f = reinterpret_cast<const float4*>(smem + L::W1F);
    const float4* w2f = reinterpret_cast<const float4*>(smem + L::W2F);
    const int tid = threadIdx.x;
    // the weights, through the first stage as scratch, into fragment order
    float* raw = reinterpret_cast<float*>(smem + L::RING);
    load_raw(raw, w1, w2, tid, L::THREADS);
    __syncthreads();
    stage_split<W1>(reinterpret_cast<float4*>(smem + L::W1F), raw,
                    raw + C * HID, tid, L::THREADS);
    stage_split<W2>(reinterpret_cast<float4*>(smem + L::W2F), raw,
                    raw + C * HID, tid, L::THREADS);
    fence_async_smem();   // the scratch reads before the copies overwrite it
    if (tid == 0) {
        for (int s = 0; s < L::STAGES; ++s) {
            mbar_init(full + 8 * s, 33);
            mbar_init(empty + 8 * s, WPT);
        }
        mbar_init_fence();
    }
    __syncthreads();

    const long long tiles = (M + P - 1) / P;
    const int warp = tid >> 5, lane = tid & 31;

    if (warp == L::CONSUMERS / 32) {
        // ---- producer: tile i of this block into stage i % STAGES ----
        const float* src[NSCAL] = {tx,   tx + M,   tx + 2 * M,
                                   ty,   ty + M,   ty + 2 * M,
                                   live, live + M, live + 2 * M, inbox};
        for (int i = 0;; ++i) {
            const long long tile = blockIdx.x + (long long)i * gridDim.x;
            if (tile >= tiles) break;
            const int s = i % L::STAGES;
            mbar_wait(empty + 8 * s, ((i / L::STAGES) & 1) ^ 1);
            const long long m0 = tile * P;
            const int n = (int)(M - m0 < P ? M - m0 : P);
            const uint32_t st = base + L::RING + s * L::STAGE;
            if (OSG_ABLATE == 3) {
                if (lane == 0) mbar_arrive(full + 8 * s);
                cp_async_arrive(full + 8 * s);
                continue;
            }
            load_tile<T, NSCAL>(full + 8 * s, st, rows, st + L::ROWS, src, M,
                                m0, n, lane);
        }
        cp_async_wait_all();
        return;
    }

    // ---- consumers: warpgroup grp takes tiles grp, grp + GROUPS, ... ----
    const int grp = warp / WPT, wg = warp % WPT;
    const int g = lane >> 2, t = lane & 3;
    const int pa = 16 * wg + g, pb = pa + 8;   // the lane's two points
    float bias1[HID / 8][2], bias2[NP / 8][2];
#pragma unroll
    for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) bias1[nt][e] = b1[8 * nt + 2 * t + e];
#pragma unroll
    for (int nt = 0; nt < NP / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
            bias2[nt][e] = b2p(b2, 8 * nt + 2 * t + e);

    for (int i = grp;; i += L::GROUPS) {
        const long long tile = blockIdx.x + (long long)i * gridDim.x;
        if (tile >= tiles) break;
        const int s = i % L::STAGES;
        const uint32_t parity = (i / L::STAGES) & 1;
        // With two groups and an odd ring, this stage's previous tile
        // (i - STAGES) was the other group's: wait until it was released,
        // so that the full barrier's parity cannot name a phase two back
        if (L::GROUPS > 1) mbar_wait(empty + 8 * s, parity ^ 1);
        mbar_wait(full + 8 * s, parity);
        const unsigned char* st = smem + L::RING + s * L::STAGE;
        const T* rs = reinterpret_cast<const T*>(st);
        const float* sc = reinterpret_cast<const float*>(st + L::ROWS);
        const long long m0 = tile * P;
        const bool va = m0 + pa < M, vb = m0 + pb < M;

        float xa[8], xb[8];
        if (OSG_ABLATE != 1) {
            lerp_point<T>(rs, sc, pa, va, t, xa);
            lerp_point<T>(rs, sc, pb, vb, t, xb);
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) xa[j] = xb[j] = 0.f;
        }
        const float boxa = (inbox != nullptr && va) ? sc[INBOX * P + pa] : 1.f;
        const float boxb = (inbox != nullptr && vb) ? sc[INBOX * P + pb] : 1.f;
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);

        float o[NP / 8][4];
        if (OSG_ABLATE == 1 || OSG_ABLATE == 2) {
#pragma unroll
            for (int nt = 0; nt < NP / 8; ++nt)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    o[nt][e] = nt < 4 ? xa[2 * nt + e] : 0.f;
                    o[nt][2 + e] = nt < 4 ? xb[2 * nt + e] : 0.f;
                }
        } else {
            // layer 1: h = softplus(x @ w1 + b1), 16 x 64 per warp
            float h[HID / 8][4];
#pragma unroll
            for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) h[nt][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < W1::KK; ++kk) {
                const AFrag a(xa[2 * kk], xb[2 * kk], xa[2 * kk + 1],
                              xb[2 * kk + 1]);
#pragma unroll
                for (int nt = 0; nt < W1::NT; ++nt)
                    mma3(h[nt], a,
                         BFrag::split4(w1f + (kk * W1::NT + nt) * 32 + lane));
            }
#pragma unroll
            for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    h[nt][e] = softplus_fast(h[nt][e] + bias1[nt][e & 1]);

            // layer 2: out = h @ w2 + b2, 16 x 40 per warp
#pragma unroll
            for (int nt = 0; nt < NP / 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < W2::KK; ++kk) {
                const AFrag a = a_from_c(h[kk]);
#pragma unroll
                for (int nt = 0; nt < W2::NT; ++nt)
                    mma3(o[nt], a,
                         BFrag::split4(w2f + (kk * W2::NT + nt) * 32 + lane));
            }
        }

        // ---- epilogue: rows g (point pa) and g + 8 (point pb) ----
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const bool valid = r ? vb : va;
            if (!valid) continue;
            const long long m = m0 + (r ? pb : pa);
            const float box = r ? boxb : boxa;
#pragma unroll
            for (int nt = 0; nt < COUT / 8; ++nt) {
                float v[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float y, dy;
                    activate(o[nt][2 * r + e] + bias2[nt][e], activation, y,
                             dy);
                    v[e] = inbox != nullptr ? y * box : y;
                }
                *reinterpret_cast<float2*>(rgb + m * COUT + 8 * nt + 2 * t) =
                    make_float2(v[0], v[1]);
            }
            if (t == 0) {
                float sg = o[COUT / 8][2 * r] + bias2[COUT / 8][0];
                if (inbox != nullptr && !(box > 0.f)) sg = -1e10f;
                sigma[m] = sg;
            }
        }
    }
}

template <typename T>
cudaError_t launch(const T* rows, const float* tx, const float* ty,
                   const float* live, const float* inbox, const float* w1,
                   const float* b1, const float* w2, const float* b2,
                   float* rgb, float* sigma, long long M, int activation,
                   int nblocks, cudaStream_t s) {
    using L = Layout<T>;
    cudaError_t err = allow_dynamic_smem<osg_forward_kernel<T>>(L::BYTES);
    if (err != cudaSuccess) return err;
    osg_forward_kernel<T><<<nblocks, L::THREADS, L::BYTES, s>>>(
        rows, tx, ty, live, inbox, w1, b1, w2, b2, rgb, sigma, M, activation);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` with a persistent grid of `nblocks` (>= 1; one per
// SM at most is useful, each takes tiles blockIdx, blockIdx + nblocks,
// ...).  rows: (3, M, 128) contiguous, bf16 when rows_bf16 else f32,
// 16-byte aligned; tx, ty, live: (3, M) f32; inbox: (M,) f32 or NULL; w1
// (32, 64), b1 (64), w2 (64, 33), b2 (33) f32; rgb (M, 32) and sigma
// (M, 1) f32 outputs.  activation: 0 sigmoid clamp, 1 lrelu*sqrt2.
// Returns the cudaError_t of the launch (0 on success).
int ln3diff_fused_osg_forward(const void* rows, int rows_bf16,
                              const void* tx, const void* ty,
                              const void* live, const void* inbox,
                              const void* w1, const void* b1,
                              const void* w2, const void* b2, void* rgb,
                              void* sigma, long long M, int activation,
                              int nblocks, void* stream) {
    if (M <= 0) return 0;
    if (nblocks <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const float* f_tx = static_cast<const float*>(tx);
    const float* f_ty = static_cast<const float*>(ty);
    const float* f_live = static_cast<const float*>(live);
    const float* f_inbox = static_cast<const float*>(inbox);
    const float* f_w1 = static_cast<const float*>(w1);
    const float* f_b1 = static_cast<const float*>(b1);
    const float* f_w2 = static_cast<const float*>(w2);
    const float* f_b2 = static_cast<const float*>(b2);
    float* f_rgb = static_cast<float*>(rgb);
    float* f_sigma = static_cast<float*>(sigma);
    cudaError_t err;
    if (rows_bf16) {
        err = launch<__nv_bfloat16>(
            static_cast<const __nv_bfloat16*>(rows), f_tx, f_ty, f_live,
            f_inbox, f_w1, f_b1, f_w2, f_b2, f_rgb, f_sigma, M, activation,
            nblocks, s);
    } else {
        err = launch<float>(static_cast<const float*>(rows), f_tx, f_ty,
                            f_live, f_inbox, f_w1, f_b1, f_w2, f_b2, f_rgb,
                            f_sigma, M, activation, nblocks, s);
    }
    return (int)err;
}

}  // extern "C"
