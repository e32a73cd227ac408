// Fused qkv projection + self-attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_qkv_attn_kernel` of
// ln3diff_tpu/ops/fused_attention.py (:104; `fused_qkv_attention` :145,
// pallas_call :171, weight layout from `split_qkv_weights` :182).  For each
// (batch b, head h), on x (L, D) and the head's weights W_q, W_k, W_v (D, d)
// and biases (d,),
//
//   q = round(f32(x W_q) + f32(b_q)),  and the same for k and v
//       (f32 accumulation of the input-dtype products, the bias added in
//       f32, one rounding to x's dtype)
//   o = softmax(q k^T / sqrt(d)) v      (kernel 3's arithmetic)
//
// and o is written into the (L, D) output at columns h*d..h*d+d-1, so the
// heads come out concatenated, before the out projection.
//
// The TPU kernel keeps x, one head's weights and the whole (L, L) f32 score
// tile in VMEM for each grid step.  On an H100 one (b, h) pair's q, k and v
// alone (3 x 768 x 64 x 2 B = 295 KB at the DiT's shapes) exceed a block's
// 227 KB of shared memory, so the work is split into two stages, launched
// one after the other on the caller's stream by one entry point:
//
//   (A) the projection: one block per (64-row tile of the B*L rows of x,
//       head h) computes that tile's q, k and v of head h, a (64, 3d)
//       product over D in chunks of 32, adds the f32 bias, rounds to x's
//       dtype and writes a (B, L, 3, H, d) workspace, the layout of one
//       nn.Linear(D, 3D) projection split into q | k | v;
//   (B) the attention: kernel 3's device code (attention_common.cuh) reads
//       q, k and v in place from the workspace through its strides and
//       writes o (B, L, H, d) = (B, L, D).
//
// The workspace holds exactly the rounded q, k and v of the TPU kernel.
//
// What bounds it on an H100: 2 B L D 3D + 4 B H L^2 d operations (at the
// DiT's B=2, L=768, D=1024, H=16, bf16: 14.5 GFLOP, 14.7 us at 989 TFLOP/s
// of dense bf16) against x, the weights and the biases read once and the
// output written once (12.6 MB, 3.8 us at 3.35 TB/s): operations.  This
// first version is simple rather than fast.  bf16 products run on the
// tensor cores through nvcuda::wmma (bf16 in, f32 accumulate), f32 on the
// CUDA cores (no TF32); stage A reloads its x tile for every head and does
// not pipeline its loads; the workspace costs a write and a read of
// 3 B L D elements; stage B is kernel 3 as it is.

#include "attention_common.cuh"

namespace {

namespace wmma = nvcuda::wmma;
using attn::THREADS;
using attn::WARPS;

constexpr int TR = 64;    // rows of x per projection block
constexpr int KC = 32;    // depth of one chunk of x and W
constexpr int RWP = TR / WARPS;   // rows per warp

struct ProjParams {
    const void* x;        // (M, D), M = B*L
    const void* w[3];     // q, k, v weights, each (H, D, d)
    const void* b[3];     // q, k, v biases, each (H, d)
    void* qkv;            // (M, 3, H, d)
    int M, D, H;
};

// Shared memory of one projection block: the x chunk (TR, KC), the weight
// chunk (KC, 3d) with q | k | v side by side and, for bf16, one 16x16 f32
// staging tile per warp for the epilogue.  bf16 rows are padded by 8
// elements (wmma wants 16-byte multiples, the pad spreads the banks); f32
// needs no pad: each lane reads its own column of W, and a warp reads one
// element of x at a time (a broadcast).
template <typename T, int DH>
struct ProjLayout {
    static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
    static constexpr int N = 3 * DH;
    static constexpr int LDX = kMma ? KC + 8 : KC;
    static constexpr int LDW = kMma ? N + 8 : N;
    static constexpr int LDS = 20;
    static constexpr size_t kX = 0;
    static constexpr size_t kW = kX + sizeof(T) * TR * LDX;
    static constexpr size_t kS = kW + sizeof(T) * KC * LDW;
    static constexpr size_t bytes =
        kS + (kMma ? sizeof(float) * WARPS * 16 * LDS : 0);
    static_assert(!kMma || (kW % 32 == 0 && kS % 32 == 0),
                  "wmma tiles must start on 32-byte boundaries");
};

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ float
to_float<__nv_bfloat16>(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
qkv_projection_kernel(const ProjParams p) {
    using Lay = ProjLayout<T, DH>;
    constexpr int N = Lay::N;
    __shared__ __align__(128) unsigned char smem[Lay::bytes];
    T* X_s = reinterpret_cast<T*>(smem + Lay::kX);
    T* W_s = reinterpret_cast<T*>(smem + Lay::kW);

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int r0 = blockIdx.x * TR;
    const int h = blockIdx.y;
    const int rows = min(TR, p.M - r0);
    const T* xg = static_cast<const T*>(p.x) + (long long)r0 * p.D;
    const long long wh = (long long)h * p.D * DH;    // head h's (D, d) slice
    const long long HD = (long long)p.H * DH;
    T* out = static_cast<T*>(p.qkv);

    constexpr int NF = Lay::kMma ? N / 16 : 1;       // wmma accumulators
    constexpr int NC = N / 32;                       // SIMT columns per lane
    attn::FragC acc_f[NF];
    float acc[Lay::kMma ? 1 : RWP][NC];
    if constexpr (Lay::kMma) {
#pragma unroll
        for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc_f[n], 0.f);
    } else {
#pragma unroll
        for (int r = 0; r < RWP; ++r)
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
    }

    for (int k0 = 0; k0 < p.D; k0 += KC) {
        attn::load_tile<T, KC, Lay::LDX, TR>(X_s, xg + k0, p.D, rows);
#pragma unroll
        for (int m = 0; m < 3; ++m)
            attn::load_tile<T, DH, Lay::LDW, KC>(
                W_s + m * DH,
                static_cast<const T*>(p.w[m]) + wh + (long long)k0 * DH, DH,
                KC);
        __syncthreads();
        if constexpr (Lay::kMma) {
#pragma unroll
            for (int kk = 0; kk < KC / 16; ++kk) {
                attn::FragA a;
                wmma::load_matrix_sync(
                    a, X_s + warp * RWP * Lay::LDX + 16 * kk, Lay::LDX);
#pragma unroll
                for (int n = 0; n < NF; ++n) {
                    attn::FragBr bf;
                    wmma::load_matrix_sync(
                        bf, W_s + 16 * kk * Lay::LDW + 16 * n, Lay::LDW);
                    wmma::mma_sync(acc_f[n], a, bf, acc_f[n]);
                }
            }
        } else {
            const T* Xw = X_s + warp * RWP * Lay::LDX;
#pragma unroll 4
            for (int kk = 0; kk < KC; ++kk) {
                float wv[NC];
#pragma unroll
                for (int c = 0; c < NC; ++c)
                    wv[c] = W_s[kk * Lay::LDW + lane + 32 * c];
#pragma unroll
                for (int r = 0; r < RWP; ++r) {
                    const float xv = Xw[r * Lay::LDX + kk];
#pragma unroll
                    for (int c = 0; c < NC; ++c)
                        acc[r][c] = fmaf(xv, wv[c], acc[r][c]);
                }
            }
        }
        __syncthreads();           // X_s and W_s free for the next chunk
    }

    // ---- epilogue: + f32 bias, one rounding, into the (M, 3, H, d)
    // workspace; column j of the block's (TR, 3d) tile is element j % d of
    // q, k or v (j / d = 0, 1, 2) ----
    if constexpr (Lay::kMma) {
        float* Sw = reinterpret_cast<float*>(smem + Lay::kS)
                    + warp * 16 * Lay::LDS;
        const int rr = lane >> 1;              // the lane's row of a tile
        const int cc = (lane & 1) * 8;         // and its 8 columns
        const int row = r0 + warp * RWP + rr;
#pragma unroll
        for (int n = 0; n < NF; ++n) {
            wmma::store_matrix_sync(Sw, acc_f[n], Lay::LDS,
                                    wmma::mem_row_major);
            __syncwarp();
            // a 16-column tile lies within one of q, k, v
            const int m = 16 * n / DH;
            const int e = 16 * n - m * DH + cc;
            const T* bias = static_cast<const T*>(p.b[m]) + h * DH + e;
            if (row < p.M) {
                uint32_t w[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const __nv_bfloat16 lo = __float2bfloat16_rn(
                        Sw[rr * Lay::LDS + cc + 2 * i]
                        + to_float<T>(bias[2 * i]));
                    const __nv_bfloat16 hi = __float2bfloat16_rn(
                        Sw[rr * Lay::LDS + cc + 2 * i + 1]
                        + to_float<T>(bias[2 * i + 1]));
                    w[i] = (uint32_t)__bfloat16_as_ushort(lo)
                           | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
                }
                *reinterpret_cast<uint4*>(
                    out + (long long)row * 3 * HD + m * HD + h * DH + e) =
                    make_uint4(w[0], w[1], w[2], w[3]);
            }
            __syncwarp();          // Sw free for the next tile
        }
    } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int m = 32 * c / DH;
            const int e = 32 * c - m * DH + lane;
            const float bias = to_float<T>(
                static_cast<const T*>(p.b[m])[h * DH + e]);
#pragma unroll
            for (int r = 0; r < RWP; ++r) {
                const int row = r0 + warp * RWP + r;
                if (row < p.M)
                    out[(long long)row * 3 * HD + m * HD + h * DH + e] =
                        attn::from_float<T>(acc[r][c] + bias);
            }
        }
    }
}

template <typename T, int DH>
int launch(const ProjParams& pp, int B, int L, float scale, void* o,
           cudaStream_t stream) {
    const dim3 grid((unsigned)((pp.M + TR - 1) / TR), (unsigned)pp.H);
    qkv_projection_kernel<T, DH><<<grid, THREADS, 0, stream>>>(pp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    // stage B: kernel 3 over the workspace, q | k | v at element offsets
    // 0, H*d and 2*H*d of each row
    const long long HD = (long long)pp.H * DH;
    const T* ws = static_cast<const T*>(pp.qkv);
    attn::Params ap;
    ap.q = ws;
    ap.k = ws + HD;
    ap.v = ws + 2 * HD;
    ap.o = o;
    ap.sq = ap.sk = ap.sv = attn::Strides{(long long)L * 3 * HD, 3 * HD, DH};
    ap.so = attn::Strides{(long long)L * HD, HD, DH};
    ap.L = L;
    ap.H = pp.H;
    ap.scale = scale;
    return attn::launch<T, DH>(ap, B, stream);
}

}  // namespace

extern "C" {

// Launch both stages on `stream`.  x: (B, L, D) contiguous, bf16
// (dtype_bf16 = 1) or f32 (0); wq, wk, wv: (H, D, d) contiguous; bq, bk,
// bv: (H, d) contiguous; qkv: a (B, L, 3, H, d) workspace; o: the
// (B, L, D) output; all of one dtype, 16-byte aligned.  d = D / H is 32 or
// 64; scale is the f32 score scale (1/sqrt(d)).  Returns the cudaError_t
// of the launches (0 on success).
int ln3diff_fused_qkv_attention(const void* x, const void* wq,
                                const void* wk, const void* wv,
                                const void* bq, const void* bk,
                                const void* bv, void* qkv, void* o,
                                int dtype_bf16, int B, int L, int H, int d,
                                float scale, void* stream) {
    if (B <= 0 || L <= 0 || H <= 0) return 0;
    if ((d != 32 && d != 64) || (long long)B * H > 65535
        || (long long)B * L > 0x7fffffffLL - TR || H > 65535)
        return (int)cudaErrorInvalidValue;
    ProjParams pp;
    pp.x = x;
    pp.w[0] = wq;
    pp.w[1] = wk;
    pp.w[2] = wv;
    pp.b[0] = bq;
    pp.b[1] = bk;
    pp.b[2] = bv;
    pp.qkv = qkv;
    pp.M = B * L;
    pp.D = H * d;
    pp.H = H;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (dtype_bf16) {
        return d == 64 ? launch<__nv_bfloat16, 64>(pp, B, L, scale, o, s)
                       : launch<__nv_bfloat16, 32>(pp, B, L, scale, o, s);
    }
    return d == 64 ? launch<float, 64>(pp, B, L, scale, o, s)
                   : launch<float, 32>(pp, B, L, scale, o, s);
}

}  // extern "C"
