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
// and both layers accumulate in f32.  f32 rows lerp in f32.
//
// What bounds it on an H100: per point it reads 3 x 128 bf16 of rows
// (768 B), 36 B of tx/ty/live and 4 B of inbox, and writes 132 B, against
// about 8.4 kFLOP of f32 MLP.  At 3.35 TB/s and 67 TFLOP/s (f32, no
// tensor cores) the bytes take about twice as long as the arithmetic, so
// the kernel is memory-bound.  The design streams each row from device
// memory exactly once with 16-byte loads and keeps every intermediate
// (the lerped features, the plane mean, the hidden layer) in shared
// memory: only rgb and sigma are written.
//
// Layout: a block of 256 threads owns tiles of 64 points and walks over
// tiles with a grid stride, so the MLP weights (16.9 KB of f32) are staged
// into shared memory once per block.  Phase 1: thread (point p, channel
// group g of 8) lerps its 8 channels of all three planes.  Phase 2: thread
// (hidden unit j, quarter of the points) runs layer 1.  Phase 3: thread
// (point, output residue mod 4) runs layer 2 and the activations.
// Phase 4 writes rgb and sigma with coalesced stores.  The ragged last
// tile is masked here; the caller pads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;          // plane channels (rows hold 4*C)
constexpr int HID = 64;        // hidden width
constexpr int NOUT = 33;       // 1 + C_out
constexpr int COUT = NOUT - 1;
constexpr int P = 64;          // points per tile
constexpr int THREADS = 256;
constexpr int XS = C + 1;      // padded row stride of the feature tile
constexpr int HS = HID + 1;    // padded row stride of the hidden tile
static_assert(XS == NOUT, "the output tile reuses the feature tile");

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// Round to the rows' dtype: bf16 rounds, f32 is exact.
template <typename T> struct Arith;

template <> struct Arith<__nv_bfloat16> {
    __device__ __forceinline__ static float r(float x) { return round_bf16(x); }
    // 8 consecutive bf16 (one 16-byte load) widened to f32 (exact).
    __device__ __forceinline__ static void load8(const __nv_bfloat16* p,
                                                 float out[8]) {
        const uint4 q = *reinterpret_cast<const uint4*>(p);
        const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            out[2 * i] = __uint_as_float(w[i] << 16);
            out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
};

template <> struct Arith<float> {
    __device__ __forceinline__ static float r(float x) { return x; }
    __device__ __forceinline__ static void load8(const float* p, float out[8]) {
        const float4 a = *reinterpret_cast<const float4*>(p);
        const float4 b = *reinterpret_cast<const float4*>(p + 4);
        out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
        out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
    }
};

__device__ __forceinline__ float softplus(float x) {
    // log(1 + e^x) = max(x, 0) + log1p(e^-|x|), as jax.nn.softplus
    return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
osg_forward_kernel(const T* __restrict__ rows, const float* __restrict__ tx,
                   const float* __restrict__ ty,
                   const float* __restrict__ live,
                   const float* __restrict__ inbox,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   float* __restrict__ rgb, float* __restrict__ sigma,
                   long long M, int activation) {
    using A = Arith<T>;
    __shared__ float w1_s[C * HID];
    __shared__ float b1_s[HID];
    __shared__ float w2_s[HID * NOUT];
    __shared__ float b2_s[NOUT];
    __shared__ float x_s[P * XS];   // lerped features, later the outputs
    __shared__ float h_s[P * HS];   // hidden layer

    const int t = threadIdx.x;
    for (int i = t; i < C * HID; i += THREADS) w1_s[i] = w1[i];
    for (int i = t; i < HID * NOUT; i += THREADS) w2_s[i] = w2[i];
    if (t < HID) b1_s[t] = b1[t];
    if (t < NOUT) b2_s[t] = b2[t];

    const long long num_tiles = (M + P - 1) / P;
    for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        const long long m0 = tile * P;
        __syncthreads();   // weights staged; previous tile's outputs written

        // ---- phase 1: bilinear lerp of 3 planes, plane mean -> x_s ----
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

        // ---- phase 2: h = softplus(x @ w1 + b1) -> h_s ----
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
            for (int i = 0; i < P / 4; ++i)
                h_s[(p0 + i) * HS + j] = softplus(acc[i] + b1_s[j]);
        }
        __syncthreads();

        // ---- phase 3: out = h @ w2 + b2, activations -> x_s ----
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
            const float box = (inbox != nullptr && m < M) ? inbox[m] : 1.f;
#pragma unroll
            for (int i = 0; i < NO; ++i) {
                const int o = q + 4 * i;
                if (o >= NOUT) continue;
                float v = acc[i] + b2_s[o];
                if (o == 0) {
                    if (inbox != nullptr && !(box > 0.f)) v = -1e10f;
                } else {
                    if (activation == 0) {
                        v = (1.f / (1.f + expf(-v))) * 1.002f - 0.001f;
                    } else {
                        v = (v >= 0.f ? v : 0.2f * v) * 1.41421356237f;
                    }
                    if (inbox != nullptr) v = v * box;
                }
                x_s[p * XS + o] = v;
            }
        }
        __syncthreads();

        // ---- phase 4: coalesced stores of rgb (M, 32) and sigma (M, 1) ----
        for (int idx = t; idx < P * COUT; idx += THREADS) {
            const int p = idx / COUT;
            const int c = idx - p * COUT;
            const long long m = m0 + p;
            if (m < M) rgb[m * COUT + c] = x_s[p * XS + 1 + c];
        }
        if (t < P && m0 + t < M) sigma[m0 + t] = x_s[t * XS];
    }
}

}  // namespace

extern "C" {

// Launch on `stream`.  rows: (3, M, 128) contiguous, bf16 when rows_bf16
// else f32, 16-byte aligned; tx, ty, live: (3, M) f32; inbox: (M,) f32 or
// NULL; w1 (32, 64), b1 (64), w2 (64, 33), b2 (33) f32; rgb (M, 32) and
// sigma (M, 1) f32 outputs.  activation: 0 sigmoid clamp, 1 lrelu*sqrt2.
// Returns the cudaError_t of the launch (0 on success).
int ln3diff_fused_osg_forward(const void* rows, int rows_bf16,
                              const void* tx, const void* ty,
                              const void* live, const void* inbox,
                              const void* w1, const void* b1,
                              const void* w2, const void* b2, void* rgb,
                              void* sigma, long long M, int activation,
                              void* stream) {
    if (M <= 0) return 0;
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = (M + P - 1) / P;
    const long long cap = (long long)sms * 8;
    const dim3 grid((unsigned)(tiles < cap ? tiles : cap));
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
    if (rows_bf16) {
        osg_forward_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
            static_cast<const __nv_bfloat16*>(rows), f_tx, f_ty, f_live,
            f_inbox, f_w1, f_b1, f_w2, f_b2, f_rgb, f_sigma, M, activation);
    } else {
        osg_forward_kernel<float><<<grid, THREADS, 0, s>>>(
            static_cast<const float*>(rows), f_tx, f_ty, f_live, f_inbox,
            f_w1, f_b1, f_w2, f_b2, f_rgb, f_sigma, M, activation);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
