// Shared pieces of the fused triplane point kernels (fused_osg.cu, the
// forward, and fused_osg_bwd.cu, its backward): the shapes they are
// compiled for, rounding to the rows' dtype and the 16-byte row loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace osg {

constexpr int C = 32;          // plane channels (rows hold 4*C)
constexpr int HID = 64;        // hidden width
constexpr int NOUT = 33;       // 1 + C_out
constexpr int COUT = NOUT - 1;

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
    // 8 values that are already bf16-exact, stored as one 16-byte write.
    __device__ __forceinline__ static void store8(__nv_bfloat16* p,
                                                  const float v[8]) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            w[i] = (__float_as_uint(v[2 * i]) >> 16)
                   | (__float_as_uint(v[2 * i + 1]) & 0xffff0000u);
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
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
    __device__ __forceinline__ static void store8(float* p, const float v[8]) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
};

__device__ __forceinline__ float softplus(float x) {
    // log(1 + e^x) = max(x, 0) + log1p(e^-|x|), as jax.nn.softplus
    return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
    return 1.f / (1.f + expf(-x));
}

}  // namespace osg
