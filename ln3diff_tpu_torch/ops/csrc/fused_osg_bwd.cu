// Backward of the fused triplane point pipeline for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` / `_osg_backward` of
// ln3diff_tpu/ops/fused_render.py (:219, :323; pallas_call at :400), the
// custom VJP of the forward kernel (fused_osg.cu).  Its residuals are the
// forward's inputs only: each tile of points recomputes the forward in
// shared memory,
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
// f32 partial sums in registers over the tiles it walks (a fixed set, by
// grid stride) and writes them to a partials buffer; a second kernel adds
// the partials in block order.  No atomics: the result is the same on
// every run.
//
// What bounds it on an H100: per point it reads 940 B (768 B of bf16 rows,
// 36 B tx/ty/live, 4 B inbox, 128 B g_rgb, 4 B g_sigma) and writes 808 B,
// against about 27 kFLOP of f32 work (forward recompute, the two
// transposed products and the weight-grad sums).  At 3.35 TB/s and
// 67 TFLOP/s the bytes and the operations take about as long.  This first
// version keeps every intermediate in shared memory and streams each row
// once per use (the second read of a tile's rows, for the row grads,
// mostly hits L2); its products run on the CUDA cores from shared memory.
//
// Layout: a block of 256 threads owns tiles of 64 points (grid stride).
// The ragged last tile is masked: a point past M has zero cotangents and
// writes nothing, so it adds nothing to the weight grads.

#include "osg_common.cuh"

namespace {

using namespace osg;

constexpr int P = 64;          // points per tile
constexpr int THREADS = 256;
constexpr int XS = C + 1;      // row stride of the x / g_f tile
constexpr int HS = HID + 1;    // row stride of the h and g_hpre tiles
constexpr int GS = NOUT;       // row stride of the g_out tile

// weight grads, flat: [gw1 (C x HID) | gb1 (HID) | gw2 (HID x NOUT) | gb2]
constexpr int OFF_GB1 = C * HID;
constexpr int OFF_GW2 = OFF_GB1 + HID;
constexpr int OFF_GB2 = OFF_GW2 + HID * NOUT;
constexpr int NW = OFF_GB2 + NOUT;
static_assert(NW == 4257, "the wrapper allocates 4257 floats of wgrad");
constexpr int W1_PER_T = C * HID / THREADS;
constexpr int W2_PER_T = (HID * NOUT + THREADS - 1) / THREADS;
static_assert(C * HID % THREADS == 0, "gw1 splits evenly over the block");
static_assert(HID + NOUT <= THREADS, "one thread per bias grad");

// shared memory, in floats
constexpr int SM_W1 = 0;
constexpr int SM_B1 = SM_W1 + C * HID;
constexpr int SM_W2 = SM_B1 + HID;
constexpr int SM_B2 = SM_W2 + HID * NOUT;
constexpr int SM_X = SM_B2 + NOUT;      // x, later g_f
constexpr int SM_H = SM_X + P * XS;     // softplus(hpre)
constexpr int SM_GH = SM_H + P * HS;    // sigmoid(hpre), later g_hpre
constexpr int SM_GO = SM_GH + P * HS;   // g_out
constexpr int SM_FLOATS = SM_GO + P * GS;
constexpr size_t SMEM_BYTES = SM_FLOATS * sizeof(float);

__device__ __forceinline__ float quad_sum(float v) {
    // sum over the 4 consecutive lanes that share one point
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
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
    using A = Arith<T>;
    extern __shared__ float sm[];
    float* w1_s = sm + SM_W1;
    float* b1_s = sm + SM_B1;
    float* w2_s = sm + SM_W2;
    float* b2_s = sm + SM_B2;
    float* x_s = sm + SM_X;
    float* h_s = sm + SM_H;
    float* gh_s = sm + SM_GH;
    float* go_s = sm + SM_GO;

    const int t = threadIdx.x;
    for (int i = t; i < C * HID; i += THREADS) w1_s[i] = w1[i];
    for (int i = t; i < HID * NOUT; i += THREADS) w2_s[i] = w2[i];
    if (t < HID) b1_s[t] = b1[t];
    if (t < NOUT) b2_s[t] = b2[t];

    float acc_w1[W1_PER_T], acc_w2[W2_PER_T], acc_b = 0.f;
#pragma unroll
    for (int i = 0; i < W1_PER_T; ++i) acc_w1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < W2_PER_T; ++i) acc_w2[i] = 0.f;

    const long long num_tiles = (M + P - 1) / P;
    for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        const long long m0 = tile * P;
        __syncthreads();   // weights staged; the previous tile is done

        // ---- 1: recompute the lerp and the plane mean -> x_s ----
        {
            const int p = t >> 2;
            const int g = t & 3;
            const long long m = m0 + p;
            float acc[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i] = 0.f;
            if (m < M) {
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    const long long pt = (long long)k * M + m;
                    const float fx = A::r(tx[pt]);
                    const float fy = A::r(ty[pt]);
                    const float fl = A::r(live[pt]);
                    const float omx = A::r(__fsub_rn(1.f, fx));
                    const float omy = A::r(__fsub_rn(1.f, fy));
                    const float w00 = A::r(__fmul_rn(A::r(__fmul_rn(omx, omy)), fl));
                    const float w01 = A::r(__fmul_rn(A::r(__fmul_rn(fx, omy)), fl));
                    const float w10 = A::r(__fmul_rn(A::r(__fmul_rn(omx, fy)), fl));
                    const float w11 = A::r(__fmul_rn(A::r(__fmul_rn(fx, fy)), fl));
                    const T* row = rows + (size_t)pt * (4 * C) + g * 8;
                    float c00[8], c01[8], c10[8], c11[8];
                    A::load8(row, c00);
                    A::load8(row + C, c01);
                    A::load8(row + 2 * C, c10);
                    A::load8(row + 3 * C, c11);
#pragma unroll
                    for (int i = 0; i < 8; ++i) {
                        float f = A::r(__fadd_rn(A::r(__fmul_rn(w00, c00[i])),
                                                 A::r(__fmul_rn(w01, c01[i]))));
                        f = A::r(__fadd_rn(f, A::r(__fmul_rn(w10, c10[i]))));
                        f = A::r(__fadd_rn(f, A::r(__fmul_rn(w11, c11[i]))));
                        acc[i] = __fadd_rn(acc[i], f);
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
                x_s[p * XS + g * 8 + i] = __fmul_rn(acc[i], 1.f / 3.f);
        }
        __syncthreads();

        // ---- 2: hpre = x @ w1 + b1 -> h_s = softplus, gh_s = sigmoid ----
        {
            const int j = t & (HID - 1);
            const int p0 = (t >> 6) * (P / 4);
            float acc[P / 4];
#pragma unroll
            for (int i = 0; i < P / 4; ++i) acc[i] = 0.f;
            for (int c = 0; c < C; ++c) {
                const float w = w1_s[c * HID + j];
#pragma unroll
                for (int i = 0; i < P / 4; ++i)
                    acc[i] = fmaf(x_s[(p0 + i) * XS + c], w, acc[i]);
            }
#pragma unroll
            for (int i = 0; i < P / 4; ++i) {
                const float hp = acc[i] + b1_s[j];
                h_s[(p0 + i) * HS + j] = softplus(hp);
                gh_s[(p0 + i) * HS + j] = sigmoid(hp);
            }
        }
        __syncthreads();

        // ---- 3: rgb_pre = (h @ w2 + b2)[1:]; cotangents -> g_out ----
        {
            const int p = t >> 2;
            const int q = t & 3;
            constexpr int NO = (NOUT + 3) / 4;   // outputs per thread (<= 9)
            float acc[NO];
#pragma unroll
            for (int i = 0; i < NO; ++i) acc[i] = 0.f;
            for (int j = 0; j < HID; ++j) {
                const float hv = h_s[p * HS + j];
#pragma unroll
                for (int i = 0; i < NO; ++i) {
                    const int o = q + 4 * i;
                    if (o < NOUT) acc[i] = fmaf(hv, w2_s[j * NOUT + o], acc[i]);
                }
            }
            const long long m = m0 + p;
            const bool valid = m < M;
            const float box = (inbox != nullptr && valid) ? inbox[m] : 1.f;
            float gbox = 0.f;
#pragma unroll
            for (int i = 0; i < NO; ++i) {
                const int o = q + 4 * i;
                if (o >= NOUT) continue;
                float go;
                if (o == 0) {
                    go = valid ? g_sigma[m] : 0.f;
                    // sigma's where(inbox > 0, ., -1e10) is flat in inbox
                    if (inbox != nullptr && !(box > 0.f)) go = 0.f;
                } else {
                    const float v = acc[i] + b2_s[o];
                    const float gin = valid ? g_rgb[m * COUT + o - 1] : 0.f;
                    float act, dact;
                    if (activation == 0) {
                        const float s = sigmoid(v);
                        act = s * 1.002f - 0.001f;
                        dact = s * (1.f - s) * 1.002f;
                    } else {
                        act = (v >= 0.f ? v : 0.2f * v) * 1.41421356237f;
                        dact = (v >= 0.f ? 1.f : 0.2f) * 1.41421356237f;
                    }
                    gbox = fmaf(gin, act, gbox);
                    go = (inbox != nullptr ? gin * box : gin) * dact;
                }
                go_s[p * GS + o] = go;
            }
            gbox = quad_sum(gbox);
            if (inbox != nullptr && valid && q == 0) ginbox[m] = gbox;
        }
        __syncthreads();

        // ---- 4: g_hpre = (g_out @ w2^T) * sigmoid(hpre) -> gh_s ----
        {
            const int j = t & (HID - 1);
            const int p0 = (t >> 6) * (P / 4);
            float acc[P / 4];
#pragma unroll
            for (int i = 0; i < P / 4; ++i) acc[i] = 0.f;
            for (int o = 0; o < NOUT; ++o) {
                const float w = w2_s[j * NOUT + o];
#pragma unroll
                for (int i = 0; i < P / 4; ++i)
                    acc[i] = fmaf(go_s[(p0 + i) * GS + o], w, acc[i]);
            }
#pragma unroll
            for (int i = 0; i < P / 4; ++i) {
                float* s = &gh_s[(p0 + i) * HS + j];
                *s = __fmul_rn(acc[i], *s);
            }
        }
        __syncthreads();

        // ---- 5: this tile's weight grads, added to the block's sums ----
#pragma unroll
        for (int i = 0; i < W1_PER_T; ++i) {
            const int e = t + THREADS * i;
            const int c = e / HID, j = e % HID;
            float s = 0.f;
            for (int p = 0; p < P; ++p)
                s = fmaf(x_s[p * XS + c], gh_s[p * HS + j], s);
            acc_w1[i] += s;
        }
#pragma unroll
        for (int i = 0; i < W2_PER_T; ++i) {
            const int e = t + THREADS * i;
            if (e < HID * NOUT) {
                const int j = e / NOUT, o = e % NOUT;
                float s = 0.f;
                for (int p = 0; p < P; ++p)
                    s = fmaf(h_s[p * HS + j], go_s[p * GS + o], s);
                acc_w2[i] += s;
            }
        }
        if (t < HID) {
            float s = 0.f;
            for (int p = 0; p < P; ++p) s += gh_s[p * HS + t];
            acc_b += s;
        } else if (t < HID + NOUT) {
            float s = 0.f;
            for (int p = 0; p < P; ++p) s += go_s[p * GS + t - HID];
            acc_b += s;
        }
        __syncthreads();

        // ---- 6: g_f = (g_hpre @ w1^T) / 3 -> x_s ----
        {
            const int p = t & (P - 1);
            const int c0 = (t >> 6) * (C / 4);
            float acc[C / 4];
#pragma unroll
            for (int i = 0; i < C / 4; ++i) acc[i] = 0.f;
            for (int j = 0; j < HID; ++j) {
                const float gh = gh_s[p * HS + j];
#pragma unroll
                for (int i = 0; i < C / 4; ++i)
                    acc[i] = fmaf(gh, w1_s[(c0 + i) * HID + j], acc[i]);
            }
#pragma unroll
            for (int i = 0; i < C / 4; ++i)
                x_s[p * XS + c0 + i] = __fmul_rn(acc[i], 1.f / 3.f);
        }
        __syncthreads();

        // ---- 7: row grads and the tx / ty / live grads ----
        {
            const int p = t >> 2;
            const int g = t & 3;
            const long long m = m0 + p;
            const bool valid = m < M;
            float gf[8], gfd[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                gf[i] = x_s[p * XS + g * 8 + i];
                gfd[i] = A::r(gf[i]);
            }
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const long long pt = (long long)k * M + m;
                float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
                float fx = 0.f, fy = 0.f, fl = 0.f;
                if (valid) {
                    fx = tx[pt];
                    fy = ty[pt];
                    fl = live[pt];
                    const float rx = A::r(fx), ry = A::r(fy), rl = A::r(fl);
                    const float omx = A::r(__fsub_rn(1.f, rx));
                    const float omy = A::r(__fsub_rn(1.f, ry));
                    const float w00 = A::r(__fmul_rn(A::r(__fmul_rn(omx, omy)), rl));
                    const float w01 = A::r(__fmul_rn(A::r(__fmul_rn(rx, omy)), rl));
                    const float w10 = A::r(__fmul_rn(A::r(__fmul_rn(omx, ry)), rl));
                    const float w11 = A::r(__fmul_rn(A::r(__fmul_rn(rx, ry)), rl));
                    const size_t off = (size_t)pt * (4 * C) + g * 8;
                    float c00[8], c01[8], c10[8], c11[8];
                    A::load8(rows + off, c00);
                    A::load8(rows + off + C, c01);
                    A::load8(rows + off + 2 * C, c10);
                    A::load8(rows + off + 3 * C, c11);
                    float o00[8], o01[8], o10[8], o11[8];
#pragma unroll
                    for (int i = 0; i < 8; ++i) {
                        o00[i] = A::r(__fmul_rn(w00, gfd[i]));
                        o01[i] = A::r(__fmul_rn(w01, gfd[i]));
                        o10[i] = A::r(__fmul_rn(w10, gfd[i]));
                        o11[i] = A::r(__fmul_rn(w11, gfd[i]));
                        s00 = fmaf(gf[i], c00[i], s00);
                        s01 = fmaf(gf[i], c01[i], s01);
                        s10 = fmaf(gf[i], c10[i], s10);
                        s11 = fmaf(gf[i], c11[i], s11);
                    }
                    A::store8(grows + off, o00);
                    A::store8(grows + off + C, o01);
                    A::store8(grows + off + 2 * C, o10);
                    A::store8(grows + off + 3 * C, o11);
                }
                s00 = quad_sum(s00);
                s01 = quad_sum(s01);
                s10 = quad_sum(s10);
                s11 = quad_sum(s11);
                if (valid && g == 0) {
                    gtx[pt] = fl * ((1.f - fy) * (s01 - s00) + fy * (s11 - s10));
                    gty[pt] = fl * ((1.f - fx) * (s10 - s00) + fx * (s11 - s01));
                    glive[pt] = (1.f - fx) * (1.f - fy) * s00
                                + fx * (1.f - fy) * s01
                                + (1.f - fx) * fy * s10 + fx * fy * s11;
                }
            }
        }
    }

    // this block's weight-grad sums
    float* part = partials + (size_t)blockIdx.x * NW;
#pragma unroll
    for (int i = 0; i < W1_PER_T; ++i) part[t + THREADS * i] = acc_w1[i];
#pragma unroll
    for (int i = 0; i < W2_PER_T; ++i) {
        const int e = t + THREADS * i;
        if (e < HID * NOUT) part[OFF_GW2 + e] = acc_w2[i];
    }
    if (t < HID) part[OFF_GB1 + t] = acc_b;
    else if (t < HID + NOUT) part[OFF_GB2 + t - HID] = acc_b;
}

// wgrad[e] = sum over blocks b, in order, of partials[b][e]
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       int nblocks,
                                       float* __restrict__ wgrad) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= NW) return;
    float s = 0.f;
    for (int b = 0; b < nblocks; ++b) s += partials[(size_t)b * NW + e];
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
    cudaError_t err = cudaFuncSetAttribute(
        osg_backward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    osg_backward_kernel<T><<<nblocks, THREADS, SMEM_BYTES, s>>>(
        rows, tx, ty, live, inbox, w1, b1, w2, b2, g_rgb, g_sigma, grows,
        gtx, gty, glive, ginbox, partials, M, activation);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    reduce_partials_kernel<<<(NW + 255) / 256, 256, 0, s>>>(partials,
                                                            nblocks, wgrad);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`.  Inputs as the forward (ln3diff_fused_osg_forward)
// plus g_rgb (M, 32) and g_sigma (M, 1) f32.  Outputs: grows (3, M, 128)
// in the rows' dtype, gtx / gty / glive (3, M) f32, ginbox (M,) f32 when
// inbox is given (else unused, may be NULL), and wgrad: NW = 4257 floats,
// gw1 (32, 64), gb1 (64), gw2 (64, 33), gb2 (33) in that order.
// partials: scratch of nblocks * NW floats; nblocks >= 1 is the grid of
// the main kernel.  Returns the cudaError_t of the launches.
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
