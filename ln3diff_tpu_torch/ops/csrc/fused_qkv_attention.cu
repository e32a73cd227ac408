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
//   (A) the projection, one GEMM: the (B, L, 3, H, d) workspace is exactly
//       the row-major (M = B*L, N = 3 H d) product x [W_q | W_k | W_v],
//       each of q, k, v rounded once after its f32 bias;
//   (B) the attention: kernel 3's device code (attention_common.cuh) reads
//       q, k and v in place from the workspace through its strides and
//       writes o (B, L, H, d) = (B, L, D).
//
// What bounds it on an H100: 2 B L D 3D + 4 B H L^2 d operations (at the
// DiT's B=2, L=768, D=1024, H=16, bf16: 14.5 GFLOP, 14.7 us at 989 TFLOP/s
// of dense bf16) against x, the weights and the biases read once and the
// output written once (12.6 MB, 3.8 us at 3.35 TB/s): operations.  The
// projection alone is 9.66 GFLOP, 9.8 us.
//
// bf16 design of stage A (namespace proj::sm90):
//   - one block per (128 rows of x, head h) computes that tile's q | k | v
//     of head h, N = 3d: at the DiT's shapes 12 x 16 = 192 blocks.  Two
//     consumer warpgroups own 64 rows each; one producer warp keeps the
//     ring full.
//   - copies: TMA over K = D in chunks of 64 through a 4-stage ring; a
//     stage holds x's (128 x 64) tile, K-major with 128-byte swizzle, and
//     the three (64 x d) panels of W_q, W_k, W_v side by side, MN-major
//     with rows of 2d bytes (128- or 64-byte swizzle).  So one x tile
//     serves q, k and v, and the three panels read as one MN-major B of
//     width 3d (its leading byte offset steps from panel to panel).
//   - products: one wgmma m64n(3d)k16 per 16-deep step, both operands in
//     shared memory; a stage is released as soon as the next chunk's
//     products are issued (one wgmma group in flight).
//   - epilogue: + f32 bias, one rounding to bf16, into shared tiles laid
//     out as the workspace's tensor map expects, then TMA stores; rows past
//     B*L are clipped by the map.  No split-K and no atomics: two launches
//     agree bit for bit.
// f32 operands keep the CUDA-core projection (proj::simt); stage B is
// kernel 3 for either type.

#include "attention_common.cuh"

namespace proj {

struct Params {
    const void* x;        // (M, D), M = B*L
    const void* w[3];     // q, k, v weights, each (H, D, d)
    const void* b[3];     // q, k, v biases, each (H, d)
    void* qkv;            // (M, 3, H, d)
    int M, D, H;
};

// ===========================================================================
// bf16: wgmma GEMM fed by TMA
// ===========================================================================
namespace sm90 {

using namespace ::hopper;

constexpr int BM = 128;               // rows of x per block
constexpr int KC = 64;                // depth of one chunk (128 bytes of x)
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;        // two warpgroups
constexpr int THREADS = CONSUMERS + 32;

// Shared memory: STAGES x (x tile | W_q | W_k | W_v panels), the output
// tiles (two warpgroups x q, k, v, 64 rows each), the mbarriers.
template <int DH>
struct Smem {
    static constexpr int ROW_W = 2 * DH;          // bytes per panel row
    static constexpr int SW_W = ROW_W;
    static constexpr int PANEL = KC * ROW_W;      // one (64 x d) tile
    static constexpr int X_TILE = BM * 2 * KC;    // 16 KB
    static constexpr int STAGE = X_TILE + 3 * PANEL;
    static constexpr int kOut = STAGES * STAGE;
    static constexpr int kBar = kOut + 2 * 3 * PANEL;
    static constexpr int bytes = kBar + 8 * 2 * STAGES + 1024;
    static_assert(PANEL % 1024 == 0 && STAGE % 1024 == 0,
                  "tiles must keep 1024-byte alignment");
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
projection_kernel(const __grid_constant__ CUtensorMap mx,
                  const __grid_constant__ CUtensorMap mwq,
                  const __grid_constant__ CUtensorMap mwk,
                  const __grid_constant__ CUtensorMap mwv,
                  const __grid_constant__ CUtensorMap mqkv,
                  const __nv_bfloat16* __restrict__ bq,
                  const __nv_bfloat16* __restrict__ bk,
                  const __nv_bfloat16* __restrict__ bv, int M, int D,
                  int H) {
    using S = Smem<DH>;
    constexpr int N = 3 * DH;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
    unsigned char* smem = smem_raw + pad;
    const uint32_t base = raw + pad;
    const uint32_t full = base + S::kBar;
    const uint32_t empty = full + 8 * STAGES;

    const int tid = threadIdx.x;
    const int m0 = blockIdx.x * BM;
    const int h = blockIdx.y;
    const int nkc = (D + KC - 1) / KC;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, CONSUMERS / 32);
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (tid >= CONSUMERS) {
        // ---- producer: x's chunk and the three weight panels per stage
        if (tid == CONSUMERS) {
            int stage = 0;
            uint32_t phase = 0;
            for (int kc = 0; kc < nkc; ++kc) {
                const uint32_t st = base + stage * S::STAGE;
                const uint32_t bar = full + 8 * stage;
                mbar_wait(empty + 8 * stage, phase ^ 1);
                mbar_expect_tx(bar, S::STAGE);
                tma_load_2d(st, &mx, bar, kc * KC, m0);
                tma_load_3d(st + S::X_TILE, &mwq, bar, 0, kc * KC, h);
                tma_load_3d(st + S::X_TILE + S::PANEL, &mwk, bar, 0,
                            kc * KC, h);
                tma_load_3d(st + S::X_TILE + 2 * S::PANEL, &mwv, bar, 0,
                            kc * KC, h);
                if (++stage == STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
        return;
    }

    // ---- consumer warpgroups: rows 64·wg .. 64·wg + 63 of the tile ----
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int t4 = lane & 3;
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int kc = 0; kc < nkc; ++kc) {
        const uint32_t st = base + stage * S::STAGE;
        mbar_wait(full + 8 * stage, phase);
        // A: x rows of this warpgroup, K-major, 128-byte rows
        const uint64_t da = smem_desc(st + wg * (S::X_TILE / 2), 0, 1024,
                                      128);
        // B: the q | k | v panels, MN-major; LBO steps between panels
        const uint64_t db = smem_desc(st + S::X_TILE, S::PANEL,
                                      8 * S::ROW_W, S::SW_W);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
            const uint64_t a = da + 2 * kk;                    // +32 bytes
            const uint64_t b = db + (16 * S::ROW_W >> 4) * kk; // +16 rows
            if constexpr (DH == 64) wgmma_ss_n192<1>(acc, a, b);
            else wgmma_ss_n96<1>(acc, a, b);
        }
        wgmma_commit();
        wgmma_wait<1>();             // the previous chunk's products done
        fence_regs(acc);
        if (kc > 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = stage;
        if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
        }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // ---- epilogue: + f32 bias, one rounding, into the output tiles ----
    const __nv_bfloat16* bias[3] = {bq + h * DH, bk + h * DH, bv + h * DH};
    unsigned char* out = smem + S::kOut + wg * 3 * S::PANEL;
#pragma unroll
    for (int i = 0; i < N / 2; i += 2) {
        // columns 8j .. 8j+7 of q | k | v lie within one of q, k, v
        const int part = 8 * (i >> 2) / DH;
        const int e = 8 * (i >> 2) - part * DH + 2 * t4;
        const int row = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
        const __nv_bfloat162 bb =
            *reinterpret_cast<const __nv_bfloat162*>(bias[part] + e);
        const __nv_bfloat162 val = __floats2bfloat162_rn(
            acc[i] + __bfloat162float(bb.x),
            acc[i + 1] + __bfloat162float(bb.y));
        *reinterpret_cast<__nv_bfloat162*>(
            out + part * S::PANEL
            + swizzle<S::SW_W>(row * S::ROW_W + 2 * e)) = val;
    }
    fence_async_smem();
    named_barrier(1 + wg, 128);
    const int r0 = m0 + 64 * wg;
    if ((tid & 127) == 0 && r0 < M) {
        const uint32_t o = base + S::kOut + wg * 3 * S::PANEL;
        for (int part = 0; part < 3; ++part)
            tma_store_2d(&mqkv, o + part * S::PANEL, (part * H + h) * DH,
                         r0);
        tma_store_wait();
    }
}

template <int DH>
int launch(const Params& p, cudaStream_t stream) {
    using S = Smem<DH>;
    const cudaError_t attr =
        allow_dynamic_smem<projection_kernel<DH>>(S::bytes);
    if (attr != cudaSuccess) return (int)attr;
    CUtensorMap mx, mw[3], mqkv;
    int err;
    {   // x: (M, D), boxes of (128 rows, 64 columns)
        const uint64_t dims[2] = {(uint64_t)p.D, (uint64_t)p.M};
        const uint64_t strides[1] = {(uint64_t)p.D * 2};
        const uint32_t box[2] = {KC, BM};
        if ((err = encode_bf16(&mx, p.x, 2, dims, strides, box, 128)))
            return err;
    }
    for (int i = 0; i < 3; ++i) {   // W: (H, D, d), boxes of (64 rows, d)
        const uint64_t dims[3] = {(uint64_t)DH, (uint64_t)p.D,
                                  (uint64_t)p.H};
        const uint64_t strides[2] = {(uint64_t)DH * 2,
                                     (uint64_t)p.D * DH * 2};
        const uint32_t box[3] = {DH, KC, 1};
        if ((err = encode_bf16(&mw[i], p.w[i], 3, dims, strides, box,
                               S::SW_W)))
            return err;
    }
    {   // workspace: (M, 3 H d), boxes of (64 rows, d)
        const uint64_t dims[2] = {(uint64_t)3 * p.H * DH, (uint64_t)p.M};
        const uint64_t strides[1] = {(uint64_t)3 * p.H * DH * 2};
        const uint32_t box[2] = {DH, 64};
        if ((err = encode_bf16(&mqkv, p.qkv, 2, dims, strides, box,
                               S::SW_W)))
            return err;
    }
    const dim3 grid((unsigned)((p.M + BM - 1) / BM), (unsigned)p.H);
    projection_kernel<DH><<<grid, THREADS, S::bytes, stream>>>(
        mx, mw[0], mw[1], mw[2], mqkv,
        static_cast<const __nv_bfloat16*>(p.b[0]),
        static_cast<const __nv_bfloat16*>(p.b[1]),
        static_cast<const __nv_bfloat16*>(p.b[2]), p.M, p.D, p.H);
    return (int)cudaGetLastError();
}

}  // namespace sm90

// ===========================================================================
// f32: FMA on the CUDA cores
// ===========================================================================
namespace simt {

constexpr int TR = 64;    // rows of x per block
constexpr int KC = 32;    // depth of one chunk of x and W
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RWP = TR / WARPS;   // rows per warp

// Shared memory of one block: the x chunk (TR, KC) and the weight chunk
// (KC, 3d) with q | k | v side by side.  No pad: each lane reads its own
// column of W, and a warp reads one element of x at a time (a broadcast).
template <int DH>
struct Layout {
    static constexpr int N = 3 * DH;
    static constexpr size_t kX = 0;
    static constexpr size_t kW = kX + sizeof(float) * TR * KC;
    static constexpr size_t bytes = kW + sizeof(float) * KC * N;
};

template <int DH>
__global__ void __launch_bounds__(THREADS)
projection_kernel(const Params p) {
    using Lay = Layout<DH>;
    constexpr int N = Lay::N;
    constexpr int NC = N / 32;                       // columns per lane
    __shared__ __align__(128) unsigned char smem[Lay::bytes];
    float* X_s = reinterpret_cast<float*>(smem + Lay::kX);
    float* W_s = reinterpret_cast<float*>(smem + Lay::kW);

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int r0 = blockIdx.x * TR;
    const int h = blockIdx.y;
    const int rows = min(TR, p.M - r0);
    const float* xg = static_cast<const float*>(p.x) + (long long)r0 * p.D;
    const long long wh = (long long)h * p.D * DH;    // head h's (D, d) slice
    const long long HD = (long long)p.H * DH;
    float* out = static_cast<float*>(p.qkv);

    float acc[RWP][NC];
#pragma unroll
    for (int r = 0; r < RWP; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

    for (int k0 = 0; k0 < p.D; k0 += KC) {
        attn::simt::load_tile<KC, KC, TR, THREADS>(X_s, xg + k0, p.D, rows);
#pragma unroll
        for (int m = 0; m < 3; ++m)
            attn::simt::load_tile<DH, N, KC, THREADS>(
                W_s + m * DH,
                static_cast<const float*>(p.w[m]) + wh + (long long)k0 * DH,
                DH, KC);
        __syncthreads();
        const float* Xw = X_s + warp * RWP * KC;
#pragma unroll 4
        for (int kk = 0; kk < KC; ++kk) {
            float wv[NC];
#pragma unroll
            for (int c = 0; c < NC; ++c) wv[c] = W_s[kk * N + lane + 32 * c];
#pragma unroll
            for (int r = 0; r < RWP; ++r) {
                const float xv = Xw[r * KC + kk];
#pragma unroll
                for (int c = 0; c < NC; ++c)
                    acc[r][c] = fmaf(xv, wv[c], acc[r][c]);
            }
        }
        __syncthreads();           // X_s and W_s free for the next chunk
    }

    // ---- epilogue: + f32 bias into the (M, 3, H, d) workspace; column j
    // of the block's (TR, 3d) tile is element j % d of q, k or v ----
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        const int m = 32 * c / DH;
        const int e = 32 * c - m * DH + lane;
        const float bias = static_cast<const float*>(p.b[m])[h * DH + e];
#pragma unroll
        for (int r = 0; r < RWP; ++r) {
            const int row = r0 + warp * RWP + r;
            if (row < p.M)
                out[(long long)row * 3 * HD + m * HD + h * DH + e] =
                    acc[r][c] + bias;
        }
    }
}

template <int DH>
int launch(const Params& p, cudaStream_t stream) {
    const dim3 grid((unsigned)((p.M + TR - 1) / TR), (unsigned)p.H);
    projection_kernel<DH><<<grid, THREADS, 0, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace simt
}  // namespace proj

namespace {

template <int DH>
int launch(const proj::Params& pp, bool bf16, int B, int L, float scale,
           void* o, cudaStream_t stream) {
    int err = bf16 ? proj::sm90::launch<DH>(pp, stream)
                   : proj::simt::launch<DH>(pp, stream);
    if (err) return err;

    // stage B: kernel 3 over the workspace, q | k | v at element offsets
    // 0, H*d and 2*H*d of each row (byte strides)
    const long long es = bf16 ? 2 : 4;
    const long long HD = (long long)pp.H * DH;
    const unsigned char* ws = static_cast<const unsigned char*>(pp.qkv);
    attn::Params ap;
    ap.q = ws;
    ap.k = ws + HD * es;
    ap.v = ws + 2 * HD * es;
    ap.o = o;
    ap.sq = ap.sk = ap.sv =
        attn::Strides{(long long)L * 3 * HD * es, 3 * HD * es, DH * es};
    ap.so = attn::Strides{(long long)L * HD * es, HD * es, DH * es};
    ap.B = B;
    ap.L = L;
    ap.H = pp.H;
    ap.scale = scale;
    return attn::launch(ap, bf16, DH, stream);
}

}  // namespace

extern "C" {

// Launch both stages on `stream`.  x: (B, L, D) contiguous, bf16
// (dtype_bf16 = 1) or f32 (0); wq, wk, wv: (H, D, d) contiguous; bq, bk,
// bv: (H, d) contiguous; qkv: a (B, L, 3, H, d) workspace; o: the
// (B, L, D) output; all of one dtype, 16-byte aligned.  d = D / H is 32 or
// 64; scale is the f32 score scale (1/sqrt(d)).  Returns the cudaError_t
// of the launches (0 on success), or 10000 and up when a TMA tensor map
// cannot be encoded.
int ln3diff_fused_qkv_attention(const void* x, const void* wq,
                                const void* wk, const void* wv,
                                const void* bq, const void* bk,
                                const void* bv, void* qkv, void* o,
                                int dtype_bf16, int B, int L, int H, int d,
                                float scale, void* stream) {
    if (B <= 0 || L <= 0 || H <= 0) return 0;
    if ((d != 32 && d != 64) || (long long)B * H > 65535
        || (long long)B * L > 0x7fffffffLL - 128 || H > 65535)
        return (int)cudaErrorInvalidValue;
    proj::Params pp;
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
    return d == 64 ? launch<64>(pp, dtype_bf16 != 0, B, L, scale, o, s)
                   : launch<32>(pp, dtype_bf16 != 0, B, L, scale, o, s);
}

}  // extern "C"
