// Backward of the fused triplane point pipeline for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` / `_osg_backward` of
// ln3diff_tpu/ops/fused_render.py (:219, :323; pallas_call at :400), the
// custom VJP of the forward kernel (fused_osg.cu).  Its residuals are the
// forward's inputs only: each tile of points recomputes the forward,
//
//   f_k  = w00*c00 + w01*c01 + w10*c10 + w11*c11    (rows' dtype, as forward)
//   x    = (f_0 + f_1 + f_2) / 3,  hpre = x @ w1 + b1,  h = softplus(hpre)
//   out  = h @ w2 + b2,  rgb_pre = out[1:]
//
// and pushes the cotangents g_rgb (M, 32), g_sigma (M, 1) back through it:
//
//   ginbox = sum_c g_rgb * act(rgb_pre)             (with inbox only)
//   g_out  = [g_sigma * (inbox > 0), g_rgb * inbox * act'(rgb_pre)]
//   gw2 += h^T g_out, gb2 += sum g_out, g_hpre = (g_out @ w2^T) * sigmoid(hpre)
//   gw1 += x^T g_hpre, gb1 += sum g_hpre, g_f = (g_hpre @ w1^T) / 3
//   grows_k = [w00, w01, w10, w11] * round(g_f)      (rows' dtype)
//   g_wk  = sum_c g_f * c_k                          (f32, widened corners)
//   gtx, gty, glive from g_wk and the f32 tx, ty, live
//
// with the TPU kernel's rounding: the recomputed lerp and the row grads in
// bf16 for bf16 rows, everything else in f32.
//
// Weight grads.  The TPU kernel adds them in place across its sequential
// grid.  Here the blocks run concurrently, so each block keeps its own
// f32 sums in registers over the tiles it walks (a fixed set: tiles
// blockIdx, blockIdx + gridDim, ...) and writes them to a partials
// buffer; a second kernel adds the partials in block order.  No atomics:
// the result is the same on every run.
//
// What bounds it on an H100: per point it reads 940 B (768 B of bf16 rows,
// 36 B tx/ty/live, 4 B inbox, 128 B g_rgb, 4 B g_sigma) and writes 808 B,
// 0.0342 ms at 3.35 TB/s for a training launch (M = 65,536), against 38
// kFLOP per point of products, which the tensor cores do in a fraction of
// that.  The first design took 0.215 ms (NVIDIA H100 80GB HBM3,
// 700 W): seven barrier-separated phases per 64-point tile, six products
// and the weight-grad sums on the CUDA cores from shared memory, the rows
// read twice.  This design:
//
// * streams each tile's rows (one 1-D bulk copy per plane), its g_rgb (one
//   more) and the per-point inputs (4-byte cp.async) into shared memory on
//   a persistent grid of one block per SM.  The block's two groups of four
//   warps take alternate tiles, each through its own stage, which the
//   group's first warp refills with the group's next tile as soon as the
//   group has read it, so one group's copy overlaps the other group's
//   math (no producer warp: with 8 warps a thread may hold 255 registers).
//   The stage is held until the row grads have read the corners again, so
//   the rows come from device memory once;
// * keeps the forward recompute and the two transposed products in
//   registers on the tensor cores (mma.sync m16n8k8, 3xTF32): each warp
//   owns 16 points, and with the k orders of osg_common.cuh x, h, g_out
//   and g_hpre pass from one product to the next without shared memory;
//   g_f lands on the lane that holds the corners it multiplies.  The
//   recompute keeps f32 softplus and the more accurate accumulation
//   (mma3_acc), since its colour pre-activations decide lrelu's
//   derivative;
// * runs the two weight-grad products over the points on the tensor cores
//   too, through two buffers per group (row strides of 8 mod 32 words, so
//   the transposed fragment reads hit 32 distinct banks), in turn: h and
//   g_out for gw2, then g_hpre and x for gw1; each warp keeps 9 of their
//   36 m16n8 output tiles in registers across its group's tiles; the bias
//   grads are column sums of the same buffers;
// * four named barriers per tile within a group (buffers free, written,
//   read, rewritten) are its only synchronisation besides the stage's
//   mbarrier.
//
// What holds it at about a fifth of its bound is the instruction stream
// of a tile (softplus with f32 log1p, the row grads, the weight-grad
// fragments) issued by two warps per scheduler, not the bytes
// (scripts/osg_card_check.py --ablate; PERF.md).
//
// f32 rows (96 KB of rows per tile) keep one group and one stage.  The
// ragged last tile is masked: a point past M has zero features and
// cotangents and writes nothing, so it adds nothing to the weight grads.
//
// OSG_ABLATE (0 when not defined) builds cut-down variants for measuring
// (scripts/osg_card_check.py --ablate): 1 skips the weight grads, 2 the
// row grads, 3 the exponentials, logarithms and divisions.

#include "osg_common.cuh"

#ifndef OSG_ABLATE
#define OSG_ABLATE 0
#endif

namespace {

using namespace osg;
using namespace hopper;

// Group g of four warps takes the block's tiles g, g + GROUPS, ...
// through its own stage g of the ring, which its first warp fills.
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> { static constexpr int GROUPS = 2; };
template <> struct Cfg<float> { static constexpr int GROUPS = 1; };

constexpr int NSCAL = 11;   // tx, ty, live of the three planes; inbox; g_sigma
constexpr int AS = HID + 8;    // row strides (floats) of a group's buffers
constexpr int BS = NP;         // A (h, then g_hpre) and B (g_out, then x):
static_assert(BS == C + 8, "x fits buffer B");   // 8 mod 32 words

// weight grads, flat: [gw1 (C x HID) | gb1 (HID) | gw2 (HID x NOUT) | gb2]
constexpr int OFF_GB1 = C * HID;
constexpr int OFF_GW2 = OFF_GB1 + HID;
constexpr int OFF_GB2 = OFF_GW2 + HID * NOUT;
constexpr int NW = OFF_GB2 + NOUT;
static_assert(NW == 4257, "the wrapper allocates 4257 floats of wgrad");
static_assert(HID + NP <= 32 * WPT, "a group has a thread per bias");

// shared memory, in bytes: the barriers, the four products' weights in
// fragment order (f32, split when used), each group's two buffers of the
// weight-grad products, then the ring (one stage per group)
template <typename T>
struct Layout {
    static constexpr int GROUPS = Cfg<T>::GROUPS, STAGES = GROUPS;
    static constexpr int THREADS = 32 * WPT * GROUPS;
    static constexpr uint32_t ROWS = 3 * P * 4 * C * sizeof(T);
    static constexpr uint32_t GRGB = P * COUT * 4;
    static constexpr uint32_t STAGE = ROWS + GRGB + NSCAL * P * 4;
    static constexpr uint32_t W1F = 128;
    static constexpr uint32_t W2F = W1F + W1::KK * W1::NT * 32 * 8;
    static constexpr uint32_t W2TF = W2F + W2::KK * W2::NT * 32 * 8;
    static constexpr uint32_t W1TF = W2TF + W2T::KK * W2T::NT * 32 * 8;
    static constexpr uint32_t BIAS = W1TF + W1T::KK * W1T::NT * 32 * 8;
    static constexpr uint32_t BUF = BIAS + 512;   // b1, b2 padded: 104 floats
    static constexpr uint32_t BUF_A = P * AS * 4;
    static constexpr uint32_t BUF_GROUP = BUF_A + P * BS * 4;
    static constexpr uint32_t RING = BUF + GROUPS * BUF_GROUP;
    static constexpr uint32_t BYTES = RING + STAGES * STAGE;
    static_assert(16 * STAGES <= W1F, "barriers fit before the weights");
    static_assert(STAGE % 128 == 0 && RING % 128 == 0, "aligned stages");
    static_assert(BYTES <= 232448, "fits one block per SM");
    static_assert(RAW_FLOATS * 4 <= BUF_GROUP, "the weights' scratch fits");
};

// softplus(z) to f32 accuracy (the forward recompute decides lrelu's
// derivative, so h keeps the plain version's precision) and its derivative
// sigmoid(z), from one exponential
__device__ __forceinline__ void softplus_sigmoid(float z, float& sp,
                                                 float& sg) {
    const float e = expf(-fabsf(z));
    sp = fmaxf(z, 0.f) + log1pf(e);
    const float inv = __fdividef(1.f, 1.f + e);
    sg = z >= 0.f ? inv : e * inv;
}

// B fragment of product W at (kk, nt), full f32 in shared memory
template <typename W>
__device__ __forceinline__ BFrag bfrag(const float2* f, int kk, int nt,
                                       int lane) {
    const float2 v = f[(kk * W::NT + nt) * 32 + lane];
    return BFrag::full(v.x, v.y);
}

// x of point p into buffer B: two 16-byte stores, the halves in another
// order for odd points (rows 8 mod 32 words apart) so that each 8-lane
// phase hits 32 distinct banks
__device__ __forceinline__ void store_x(float* b, int p, int t,
                                       const float (&x)[8]) {
    const int odd = p & 1;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int h = s ^ odd;
        const float4 lo = make_float4(x[0], x[1], x[2], x[3]);
        const float4 hi = make_float4(x[4], x[5], x[6], x[7]);
        *reinterpret_cast<float4*>(b + p * BS + 8 * t + 4 * h) = h ? hi : lo;
    }
}

// C fragments (rows pa, pb; columns 8nt + 2t, + 1) into a buffer
template <int NT>
__device__ __forceinline__ void store_c(float* buf, int stride, int pa,
                                        int pb, int t,
                                        const float (&c)[NT][4]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        *reinterpret_cast<float2*>(buf + pa * stride + 8 * nt + 2 * t) =
            make_float2(c[nt][0], c[nt][1]);
        *reinterpret_cast<float2*>(buf + pb * stride + 8 * nt + 2 * t) =
            make_float2(c[nt][2], c[nt][3]);
    }
}

// round(g_f) of the lane's 8 channels in the rows' dtype: bf16x2 pairs
// (f32 rows keep g_f itself)
struct GfRound {
    uint32_t b[4];
    __device__ __forceinline__ GfRound(const float (&gf)[8]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i] = pack_bf16x2(gf[2 * i], gf[2 * i + 1]);
    }
};

// w * round(g_f) for one corner's 8 channels, in the rows' dtype
__device__ __forceinline__ void store_grow(__nv_bfloat16* dst,
                                           const Weights<__nv_bfloat16>& w,
                                           int q, const float (&)[8],
                                           const GfRound& r) {
    const uint32_t ws = w.splat(q);
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(bf16x2_mul(ws, r.b[0]), bf16x2_mul(ws, r.b[1]),
                   bf16x2_mul(ws, r.b[2]), bf16x2_mul(ws, r.b[3]));
}

__device__ __forceinline__ void store_grow(float* dst,
                                           const Weights<float>& w, int q,
                                           const float (&gf)[8],
                                           const GfRound&) {
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __fmul_rn(w.at(q), gf[j]);
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(o[4], o[5], o[6], o[7]);
}

// Point p's row grads (its 8 channels of each corner and plane, from the
// lerp weights, recomputed) and its tx / ty / live grads.  Every lane
// calls it (the corner sums are summed across the point's 4 lanes); a
// point past M computes on whatever its stage rows hold and stores
// nothing, so that only the stores branch.
template <typename T>
__device__ __forceinline__ void row_grads(
    const T* rs, const float* sc, int p, bool valid, int t,
    const float (&gf)[8], long long m, long long M, T* grows, float* gtx,
    float* gty, float* glive) {
    const GfRound r(gf);
    float s[3][4];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const Corners<T> c(rs + (size_t)(k * P + p) * (4 * C), t);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            s[k][q] = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
                s[k][q] = fmaf(gf[j], c.at(q, j), s[k][q]);
        }
        if (valid) {
            const Weights<T> w(sc[(TX + k) * P + p], sc[(TY + k) * P + p],
                               sc[(LIVE + k) * P + p]);
            T* dst = grows + ((long long)k * M + m) * (4 * C) + 8 * t;
#pragma unroll
            for (int q = 0; q < 4; ++q) store_grow(dst + q * C, w, q, gf, r);
        }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[k][q] = quad_sum(s[k][q]);
    if (valid && t == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float fx = sc[(TX + k) * P + p], fy = sc[(TY + k) * P + p];
            const float fl = sc[(LIVE + k) * P + p];
            const float* v = s[k];
            const long long pt = (long long)k * M + m;
            gtx[pt] = fl * ((1.f - fy) * (v[1] - v[0]) + fy * (v[3] - v[2]));
            gty[pt] = fl * ((1.f - fx) * (v[2] - v[0]) + fx * (v[3] - v[1]));
            glive[pt] = (1.f - fx) * (1.f - fy) * v[0] + fx * (1.f - fy) * v[1]
                        + (1.f - fx) * fy * v[2] + fx * fy * v[3];
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(Layout<T>::THREADS, 1)
osg_backward_kernel(const T* __restrict__ rows, const float* __restrict__ tx,
                    const float* __restrict__ ty,
                    const float* __restrict__ live,
                    const float* __restrict__ inbox,
                    const float* __restrict__ w1,
                    const float* __restrict__ b1,
                    const float* __restrict__ w2,
                    const float* __restrict__ b2,
                    const float* __restrict__ g_rgb,
                    const float* __restrict__ g_sigma,
                    T* __restrict__ grows, float* __restrict__ gtx,
                    float* __restrict__ gty, float* __restrict__ glive,
                    float* __restrict__ ginbox,
                    float* __restrict__ partials, long long M,
                    int activation) {
    using L = Layout<T>;
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t base = smem_u32(smem);
    const uint32_t full = base;
    const float2* w1f = reinterpret_cast<const float2*>(smem + L::W1F);
    const float2* w2f = reinterpret_cast<const float2*>(smem + L::W2F);
    const float2* w2tf = reinterpret_cast<const float2*>(smem + L::W2TF);
    const float2* w1tf = reinterpret_cast<const float2*>(smem + L::W1TF);

    const int tid = threadIdx.x;
    // the weights, through group 0's buffers as scratch, into fragment order
    float* raw = reinterpret_cast<float*>(smem + L::BUF);
    load_raw(raw, w1, w2, tid, L::THREADS);
    __syncthreads();
    const float* rw2 = raw + C * HID;
    stage_full<W1>(reinterpret_cast<float2*>(smem + L::W1F), raw, rw2, tid,
                   L::THREADS);
    stage_full<W2>(reinterpret_cast<float2*>(smem + L::W2F), raw, rw2, tid,
                   L::THREADS);
    stage_full<W2T>(reinterpret_cast<float2*>(smem + L::W2TF), raw, rw2, tid,
                    L::THREADS);
    stage_full<W1T>(reinterpret_cast<float2*>(smem + L::W1TF), raw, rw2, tid,
                    L::THREADS);
    if (tid < HID + NP) {
        reinterpret_cast<float*>(smem + L::BIAS)[tid] =
            tid < HID ? b1[tid] : b2p(b2, tid - HID);
    }
    if (tid == 0) {
        for (int s = 0; s < L::STAGES; ++s) mbar_init(full + 8 * s, 33);
        mbar_init_fence();
    }
    __syncthreads();

    const long long tiles = (M + P - 1) / P;
    const int warp = tid >> 5, lane = tid & 31;
    // group grp; its warp wg owns points 16wg .. 16wg + 15 of each of the
    // group's tiles, and warp 0 of the group fills the group's stage
    const int grp = warp / WPT, wg = warp % WPT, tg = tid % (32 * WPT);
    const int bar = 1 + grp;   // the group's named barrier
    const uint32_t stage = base + L::RING + grp * L::STAGE;
    const uint32_t stage_full = full + 8 * grp;
    const float* src[NSCAL] = {tx,   tx + M,   tx + 2 * M,
                               ty,   ty + M,   ty + 2 * M,
                               live, live + M, live + 2 * M,
                               inbox, g_sigma};
    // block tile i (i % GROUPS == grp) into the group's stage
    auto load = [&](int i) {
        const long long m0 = (blockIdx.x + (long long)i * gridDim.x) * P;
        const int n = (int)(M - m0 < P ? M - m0 : P);
        load_tile<T, NSCAL>(stage_full, stage, rows,
                            stage + L::ROWS + L::GRGB, src, M, m0, n, lane,
                            stage + L::ROWS, g_rgb + m0 * COUT,
                            (uint32_t)n * COUT * 4);
    };
    if (wg == 0 && blockIdx.x + (long long)grp * gridDim.x < tiles) load(grp);
    const int g = lane >> 2, t = lane & 3;
    const int pa = 16 * wg + g, pb = pa + 8;
    float* buf_a = reinterpret_cast<float*>(smem + L::BUF
                                            + grp * L::BUF_GROUP);
    float* buf_b = buf_a + P * AS;
    // the biases from shared memory where they are used (in registers
    // they would push the recompute into spills): b1 at [j], b2 padded at
    // [HID + n]
    const float* bias = reinterpret_cast<const float*>(smem + L::BIAS);
    // this warp's weight-grad tiles, summed over the group's tiles: gw2
    // rows (hidden) 16wg .. 16wg+15 by all five column tiles; gw1 rows
    // (channels) 16(wg/2) .. by column (hidden) tiles 4(wg%2) .. +3; and
    // thread tg's bias grad (gb2 column tg < NP, gb1 column tg - HID)
    float acc2[NP / 8][4], acc1[4][4], accb = 0.f;
#pragma unroll
    for (int nt = 0; nt < NP / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc2[nt][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[j][e] = 0.f;
    const int mt1 = wg >> 1, nt1 = 4 * (wg & 1);

    for (int i = grp;; i += L::GROUPS) {
        const long long tile = blockIdx.x + (long long)i * gridDim.x;
        if (tile >= tiles) break;
        mbar_wait(stage_full, (i / L::GROUPS) & 1);
        const unsigned char* st = smem + L::RING + grp * L::STAGE;
        const T* rs = reinterpret_cast<const T*>(st);
        const float* grs = reinterpret_cast<const float*>(st + L::ROWS);
        const float* sc =
            reinterpret_cast<const float*>(st + L::ROWS + L::GRGB);
        const long long m0 = tile * P;
        const bool va = m0 + pa < M, vb = m0 + pb < M;

        // ---- forward recompute ----
        float xa[8], xb[8];
        lerp_point<T>(rs, sc, pa, va, t, xa);
        lerp_point<T>(rs, sc, pb, vb, t, xb);

        float h[HID / 8][4], sg[HID / 8][4];   // sg: first the small terms
#pragma unroll
        for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) h[nt][e] = sg[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < W1::KK; ++kk) {
            const AFrag a(xa[2 * kk], xb[2 * kk], xa[2 * kk + 1],
                          xb[2 * kk + 1]);
#pragma unroll
            for (int nt = 0; nt < W1::NT; ++nt)
                mma3_acc(h[nt], sg[nt], a, bfrag<W1>(w1f, kk, nt, lane));
        }
        acc_finish(h, sg);
#pragma unroll
        for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                if (OSG_ABLATE == 3) {
                    h[nt][e] += bias[8 * nt + 2 * t + (e & 1)];
                    sg[nt][e] = 0.5f;
                } else {
                    softplus_sigmoid(h[nt][e] + bias[8 * nt + 2 * t + (e & 1)],
                                     h[nt][e], sg[nt][e]);
                }
            }

        float o[NP / 8][4], os[NP / 8][4];
#pragma unroll
        for (int nt = 0; nt < NP / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[nt][e] = os[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < W2::KK; ++kk) {
            const AFrag a = a_from_c(h[kk]);
#pragma unroll
            for (int nt = 0; nt < W2::NT; ++nt)
                mma3_acc(o[nt], os[nt], a, bfrag<W2>(w2f, kk, nt, lane));
        }
        acc_finish(o, os);

        // ---- cotangents of the outputs: o becomes g_out ----
        float gbox[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int p = r ? pb : pa;
            const bool valid = r ? vb : va;
            const float box =
                (inbox != nullptr && valid) ? sc[INBOX * P + p] : 1.f;
#pragma unroll
            for (int nt = 0; nt < COUT / 8; ++nt) {
                const float2 gin2 =
                    valid ? *reinterpret_cast<const float2*>(
                                grs + p * COUT + 8 * nt + 2 * t)
                          : make_float2(0.f, 0.f);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float gin = e ? gin2.y : gin2.x;
                    const float v =
                        o[nt][2 * r + e] + bias[HID + 8 * nt + 2 * t + e];
                    float act, dact;
                    if (OSG_ABLATE == 3) {
                        act = v;
                        dact = 1.f;
                    } else {
                        activate(v, activation, act, dact);
                    }
                    gbox[r] = fmaf(gin, act, gbox[r]);
                    o[nt][2 * r + e] =
                        (inbox != nullptr ? gin * box : gin) * dact;
                }
            }
            // column COUT (sigma; lane t = 0) and the zero padding
            float gs = 0.f;
            if (t == 0 && valid) {
                gs = sc[GSIGMA * P + p];
                // sigma's where(inbox > 0, ., -1e10) is flat in inbox
                if (inbox != nullptr && !(box > 0.f)) gs = 0.f;
            }
            o[COUT / 8][2 * r] = gs;
            o[COUT / 8][2 * r + 1] = 0.f;
        }
        gbox[0] = quad_sum(gbox[0]);
        gbox[1] = quad_sum(gbox[1]);
        if (inbox != nullptr && t == 0) {
            if (va) ginbox[m0 + pa] = gbox[0];
            if (vb) ginbox[m0 + pb] = gbox[1];
        }
        named_barrier(bar, 32 * WPT);   // the last tile's buffers are read
        store_c<HID / 8>(buf_a, AS, pa, pb, t, h);
        store_c<NP / 8>(buf_b, BS, pa, pb, t, o);

        // ---- g_hpre = (g_out @ w2^T) * sigmoid(hpre): h becomes g_hpre ----
#pragma unroll
        for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) h[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < W2T::KK; ++kk) {
            const AFrag a = a_from_c(o[kk]);
#pragma unroll
            for (int nt = 0; nt < W2T::NT; ++nt)
                mma3(h[nt], a, bfrag<W2T>(w2tf, kk, nt, lane));
        }
#pragma unroll
        for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                h[nt][e] = __fmul_rn(h[nt][e], sg[nt][e]);

        // ---- g_f = (g_hpre @ w1^T) / 3, channels 8t..8t+7 of pa, pb ----
        float gf[C / 8][4];
#pragma unroll
        for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) gf[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < W1T::KK; ++kk) {
            const AFrag a = a_from_c(h[kk]);
#pragma unroll
            for (int nt = 0; nt < W1T::NT; ++nt)
                mma3(gf[nt], a, bfrag<W1T>(w1tf, kk, nt, lane));
        }
        float gfa[8], gfb[8];
#pragma unroll
        for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                gfa[2 * nt + e] = __fmul_rn(gf[nt][e], 1.f / 3.f);
                gfb[2 * nt + e] = __fmul_rn(gf[nt][2 + e], 1.f / 3.f);
            }

        // ---- row grads from the staged corners ----
        if (OSG_ABLATE != 2) {
            row_grads<T>(rs, sc, pa, va, t, gfa, m0 + pa, M, grows, gtx, gty,
                         glive);
            row_grads<T>(rs, sc, pb, vb, t, gfb, m0 + pb, M, grows, gtx, gty,
                         glive);
        }

        // ---- weight grads over the tile's points, two products in turn
        // through the group's buffers: gw2 += h^T g_out from (A, B) ----
        named_barrier(bar, 32 * WPT);   // A = h, B = g_out are written,
        // and the stage is read: refill it with the group's next tile
        if (wg == 0 && tile + (long long)L::GROUPS * gridDim.x < tiles) {
            fence_async_smem();
            load(i + L::GROUPS);
        }
        if (OSG_ABLATE != 1) {
#pragma unroll 2
            for (int k0 = 0; k0 < P; k0 += 8) {
                const float* a0 = buf_a + (k0 + t) * AS + 16 * wg + g;
                const float* a4 = a0 + 4 * AS;
                const AFrag a(a0[0], a0[8], a4[0], a4[8]);
                const float* b0 = buf_b + (k0 + t) * BS + g;
#pragma unroll
                for (int nt = 0; nt < NP / 8; ++nt)
                    mma3(acc2[nt], a,
                         BFrag::full(b0[8 * nt], b0[8 * nt + 4 * BS]));
            }
            if (tg < NP) {
                float sum = 0.f;
                for (int p = 0; p < P; ++p) sum += buf_b[p * BS + tg];
                accb += sum;
            }
        }
        named_barrier(bar, 32 * WPT);   // ... and read
        store_c<HID / 8>(buf_a, AS, pa, pb, t, h);
        store_x(buf_b, pa, t, xa);
        store_x(buf_b, pb, t, xb);
        named_barrier(bar, 32 * WPT);   // A = g_hpre, B = x are written
        // ---- gw1 += x^T g_hpre from (B, A) ----
        if (OSG_ABLATE != 1) {
#pragma unroll 2
            for (int k0 = 0; k0 < P; k0 += 8) {
                const float* x0 = buf_b + (k0 + t) * BS + 16 * mt1 + g;
                const float* x4 = x0 + 4 * BS;
                const AFrag a(x0[0], x0[8], x4[0], x4[8]);
                const float* q0 = buf_a + (k0 + t) * AS + g;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    mma3(acc1[j], a,
                         BFrag::full(q0[8 * (nt1 + j)],
                                     q0[8 * (nt1 + j) + 4 * AS]));
            }
            if (tg >= HID) {
                float sum = 0.f;
                for (int p = 0; p < P; ++p) sum += buf_a[p * AS + tg - HID];
                accb += sum;
            }
        }
    }

    // this group's weight-grad sums: partials slot blockIdx * GROUPS + grp
    float* part = partials + ((size_t)blockIdx.x * L::GROUPS + grp) * NW;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int ch = 16 * mt1 + g + 8 * (e >> 1);
            const int hid = 8 * (nt1 + j) + 2 * t + (e & 1);
            part[ch * HID + hid] = acc1[j][e];
        }
#pragma unroll
    for (int nt = 0; nt < NP / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int hid = 16 * wg + g + 8 * (e >> 1);
            const int n = 8 * nt + 2 * t + (e & 1);
            if (n <= COUT)
                part[OFF_GW2 + hid * NOUT + (n < COUT ? n + 1 : 0)] =
                    acc2[nt][e];
        }
    if (tg < NP) {
        if (tg <= COUT) part[OFF_GB2 + (tg < COUT ? tg + 1 : 0)] = accb;
    } else if (tg >= HID) {
        part[OFF_GB1 + tg - HID] = accb;
    }
}

// wgrad[e] = sum over partial slots b, in order, of partials[b][e]
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       int nslots,
                                       float* __restrict__ wgrad) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= NW) return;
    float s = 0.f;
    for (int b = 0; b < nslots; ++b) s += partials[(size_t)b * NW + e];
    wgrad[e] = s;
}

template <typename T>
cudaError_t launch(const T* rows, const float* tx, const float* ty,
                   const float* live, const float* inbox, const float* w1,
                   const float* b1, const float* w2, const float* b2,
                   const float* g_rgb, const float* g_sigma, T* grows,
                   float* gtx, float* gty, float* glive, float* ginbox,
                   float* partials, int nblocks, float* wgrad, long long M,
                   int activation, cudaStream_t s) {
    using L = Layout<T>;
    cudaError_t err = allow_dynamic_smem<osg_backward_kernel<T>>(L::BYTES);
    if (err != cudaSuccess) return err;
    osg_backward_kernel<T><<<nblocks, L::THREADS, L::BYTES, s>>>(
        rows, tx, ty, live, inbox, w1, b1, w2, b2, g_rgb, g_sigma, grows,
        gtx, gty, glive, ginbox, partials, M, activation);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    reduce_partials_kernel<<<(NW + 255) / 256, 256, 0, s>>>(
        partials, nblocks * L::GROUPS, wgrad);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`.  Inputs as the forward (ln3diff_fused_osg_forward)
// plus g_rgb (M, 32) and g_sigma (M, 1) f32, g_rgb 16-byte aligned.
// Outputs: grows (3, M, 128) in the rows' dtype, gtx / gty / glive (3, M)
// f32, ginbox (M,) f32 when inbox is given (else unused, may be NULL), and
// wgrad: NW = 4257 floats, gw1 (32, 64), gb1 (64), gw2 (64, 33), gb2 (33)
// in that order.  nblocks >= 1 is the persistent grid of the main kernel
// (one block per SM at most is useful); partials: scratch of
// nblocks * GROUPS * NW floats (one set per group of consumer warps: two
// for bf16 rows, one for f32).  Returns the cudaError_t of the launches.
int ln3diff_fused_osg_backward(const void* rows, int rows_bf16,
                               const void* tx, const void* ty,
                               const void* live, const void* inbox,
                               const void* w1, const void* b1,
                               const void* w2, const void* b2,
                               const void* g_rgb, const void* g_sigma,
                               void* grows, void* gtx, void* gty,
                               void* glive, void* ginbox, void* partials,
                               int nblocks, void* wgrad, long long M,
                               int activation, void* stream) {
    if (M <= 0 || nblocks <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const float* f_tx = static_cast<const float*>(tx);
    const float* f_ty = static_cast<const float*>(ty);
    const float* f_live = static_cast<const float*>(live);
    const float* f_inbox = static_cast<const float*>(inbox);
    const float* f_w1 = static_cast<const float*>(w1);
    const float* f_b1 = static_cast<const float*>(b1);
    const float* f_w2 = static_cast<const float*>(w2);
    const float* f_b2 = static_cast<const float*>(b2);
    const float* f_grgb = static_cast<const float*>(g_rgb);
    const float* f_gsig = static_cast<const float*>(g_sigma);
    float* f_gtx = static_cast<float*>(gtx);
    float* f_gty = static_cast<float*>(gty);
    float* f_glive = static_cast<float*>(glive);
    float* f_ginbox = static_cast<float*>(ginbox);
    float* f_part = static_cast<float*>(partials);
    float* f_wgrad = static_cast<float*>(wgrad);
    cudaError_t err;
    if (rows_bf16) {
        err = launch<__nv_bfloat16>(
            static_cast<const __nv_bfloat16*>(rows), f_tx, f_ty, f_live,
            f_inbox, f_w1, f_b1, f_w2, f_b2, f_grgb, f_gsig,
            static_cast<__nv_bfloat16*>(grows), f_gtx, f_gty, f_glive,
            f_ginbox, f_part, nblocks, f_wgrad, M, activation, s);
    } else {
        err = launch<float>(
            static_cast<const float*>(rows), f_tx, f_ty, f_live, f_inbox,
            f_w1, f_b1, f_w2, f_b2, f_grgb, f_gsig,
            static_cast<float*>(grows), f_gtx, f_gty, f_glive, f_ginbox,
            f_part, nblocks, f_wgrad, M, activation, s);
    }
    return (int)err;
}

}  // extern "C"
