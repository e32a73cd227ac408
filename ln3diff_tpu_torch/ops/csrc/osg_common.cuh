// Shared pieces of the fused triplane point kernels (fused_osg.cu, the
// forward, and fused_osg_bwd.cu, its backward): the shapes they are
// compiled for, the bilinear lerp of one point's corner rows from shared
// memory, the 3xTF32 tensor-core product and the fragment order of the
// MLP weights.
//
// Products.  Every product runs on mma.sync.m16n8k8 TF32 with the 3xTF32
// split: a ~ a_hi + a_lo (each rounded to TF32 with cvt.rna: 11 bits,
// then the next 11, so to 2^-22 of a), and a·b ~ a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi accumulated in f32, which keeps about f32's precision (the
// dropped a_lo·b_lo is 2^-22 of the product).
// A warp owns 16 points of a tile: lane (g = lane / 4, t = lane % 4)
// holds points g and g + 8.  The mma's A fragment pairs row g with
// columns t and t + 4 of each 8-deep k-step, and its C fragment pairs row
// g with columns 2t and 2t + 1 of each n8 tile.  A product's k order is
// free, so each product permutes its k index to what the lanes already
// hold:
//
//   x·w1     k-step kk, positions (t, t+4) = channels (8t+2kk, 8t+2kk+1):
//            the lane lerped channels 8t..8t+7, so x feeds A as it is;
//   h·w2     k-step kk = hidden (8kk+2t, 8kk+2t+1): the C fragment of
//            layer 1's n-tile kk is A's fragment of k-step kk, so h never
//            goes through shared memory (likewise g_out and g_hpre in the
//            backward);
//   g_hpre·w1^T  n-tile nt, column j = channel 8(j/2) + 2nt + j%2, so the
//            lane ends with g_f for its own channels 8t..8t+7.
//
// The 33 outputs are padded to NP = 40 columns (five n8 tiles): columns
// 0..31 are rgb, 32 is sigma, 33..39 have zero weights and are never
// stored.
#pragma once

#include "hopper.cuh"

namespace osg {

constexpr int C = 32;          // plane channels (rows hold 4*C)
constexpr int HID = 64;        // hidden width
constexpr int NOUT = 33;       // 1 + C_out
constexpr int COUT = NOUT - 1;
constexpr int NP = 40;         // outputs padded to five n8 tiles
constexpr int P = 64;          // points per tile
constexpr int WPT = P / 16;    // consumer warps per tile

// softplus(z) = max(z, 0) + log(1 + e^-|z|), as jax.nn.softplus, from the
// special-function unit's exp2 and log2: log2's absolute error on [1, 2]
// (2^-21.4) bounds the error of h, well inside the forward's tolerance
__device__ __forceinline__ float softplus_fast(float z) {
    return fmaxf(z, 0.f) + __logf(1.f + __expf(-fabsf(z)));
}

// the colour head's activation and its derivative: sigmoid·1.002 - 0.001
// (from the special-function unit's exp2 and reciprocal) or lrelu·sqrt(2)
__device__ __forceinline__ void activate(float v, int activation, float& act,
                                         float& dact) {
    if (activation == 0) {
        const float s = __fdividef(1.f, 1.f + __expf(-v));
        act = s * 1.002f - 0.001f;
        dact = s * (1.f - s) * 1.002f;
    } else {
        act = (v >= 0.f ? v : 0.2f * v) * 1.41421356237f;
        dact = (v >= 0.f ? 1.f : 0.2f) * 1.41421356237f;
    }
}

// sum over the 4 lanes of one row group (lanes 4g .. 4g+3)
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v;
}

// ---------------------------------------------------------------------------
// 3xTF32 products
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// x ~ hi + lo to 2^-22 of x, both TF32 (x - hi is exact in f32)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// A fragment of one k-step from four f32 values
struct AFrag {
    uint32_t hi[4], lo[4];
    __device__ __forceinline__ AFrag(float a0, float a1, float a2,
                                     float a3) {
        split(a0, hi[0], lo[0]);
        split(a1, hi[1], lo[1]);
        split(a2, hi[2], lo[2]);
        split(a3, hi[3], lo[3]);
    }
};

// B fragment of one (k-step, n-tile): b0 = B[t][g], b1 = B[t+4][g]
struct BFrag {
    uint32_t hi0, hi1, lo0, lo1;
    // pre-split in shared memory as {hi0, hi1, lo0, lo1}
    __device__ __forceinline__ static BFrag split4(const float4* p) {
        const float4 v = *p;
        return {__float_as_uint(v.x), __float_as_uint(v.y),
                __float_as_uint(v.z), __float_as_uint(v.w)};
    }
    // full f32 values, split here
    __device__ __forceinline__ static BFrag full(float b0, float b1) {
        BFrag f;
        split(b0, f.hi0, f.lo0);
        split(b1, f.hi1, f.lo1);
        return f;
    }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b, 3xTF32 (small terms first)
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a,
                                     const BFrag& b) {
    mma_tf32(d, a.lo, b.hi0, b.hi1);
    mma_tf32(d, a.hi, b.lo0, b.lo1);
    mma_tf32(d, a.hi, b.hi0, b.hi1);
}

// d += a·b on the 3xTF32 split, more accurately than mma3, for the
// backward's recompute of the forward, whose colour pre-activations decide
// lrelu's derivative: the two small terms go to their own accumulator s
// (added to d by acc_finish), and each k-step's a_hi·b_hi is summed by the
// tensor cores from zero and added to d in f32 with round-to-nearest, so
// that d takes 8 rounded additions instead of 24 inside the tensor cores,
// which do not round to nearest.  With mma3 instead, the lrelu case of
// chip_smoke.py's osg_backward_check took the other side of lrelu's kink
// than the plain version at one colour whose pre-activation is near 0.
__device__ __forceinline__ void mma3_acc(float (&d)[4], float (&s)[4],
                                         const AFrag& a, const BFrag& b) {
    mma_tf32(s, a.lo, b.hi0, b.hi1);
    mma_tf32(s, a.hi, b.lo0, b.lo1);
    float p[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(p, a.hi, b.hi0, b.hi1);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], p[i]);
}

template <int NT>
__device__ __forceinline__ void acc_finish(float (&d)[NT][4],
                                           const float (&s)[NT][4]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[nt][i] = __fadd_rn(d[nt][i], s[nt][i]);
}

// The A fragment of k-step kk of a product whose A is the C fragments
// `c` of an earlier product, k permuted as above: {c0, c2, c1, c3}.
__device__ __forceinline__ AFrag a_from_c(const float (&c)[4]) {
    return AFrag(c[0], c[2], c[1], c[3]);
}

// ---------------------------------------------------------------------------
// Weights in fragment order.  B fragment (kk, nt) of lane (g, t) holds
// (b0, b1); the functions give b_e from the weights in global memory.
// ---------------------------------------------------------------------------

// w2 padded to NP columns: rgb first, sigma at column COUT, then zeros
__device__ __forceinline__ float w2p(const float* w2, int j, int n) {
    return n < COUT ? w2[j * NOUT + n + 1] : n == COUT ? w2[j * NOUT] : 0.f;
}

__device__ __forceinline__ float b2p(const float* b2, int n) {
    return n < COUT ? b2[n + 1] : n == COUT ? b2[0] : 0.f;
}

// x·w1: k = channel, n = hidden; 4 k-steps x 8 n-tiles
struct W1 {
    static constexpr int KK = C / 8, NT = HID / 8;
    __device__ static float at(const float* w1, const float*, int kk, int nt,
                               int g, int t, int e) {
        return w1[(8 * t + 2 * kk + e) * HID + 8 * nt + g];
    }
};
// h·w2: k = hidden, n = padded output; 8 x 5
struct W2 {
    static constexpr int KK = HID / 8, NT = NP / 8;
    __device__ static float at(const float*, const float* w2, int kk, int nt,
                               int g, int t, int e) {
        return w2p(w2, 8 * kk + 2 * t + e, 8 * nt + g);
    }
};
// g_out·w2^T: k = padded output, n = hidden; 5 x 8
struct W2T {
    static constexpr int KK = NP / 8, NT = HID / 8;
    __device__ static float at(const float*, const float* w2, int kk, int nt,
                               int g, int t, int e) {
        return w2p(w2, 8 * nt + g, 8 * kk + 2 * t + e);
    }
};
// g_hpre·w1^T: k = hidden, n = channel 8(g/2) + 2nt + g%2; 8 x 4
struct W1T {
    static constexpr int KK = HID / 8, NT = C / 8;
    __device__ static float at(const float* w1, const float*, int kk, int nt,
                               int g, int t, int e) {
        return w1[(8 * (g >> 1) + 2 * nt + (g & 1)) * HID + 8 * kk + 2 * t
                  + e];
    }
};

// The MLP weights w1 (C x HID) then w2 (HID x NOUT), read once with
// coalesced loads into shared scratch, so that the fragment orders below
// gather from shared memory and not from L2
constexpr int RAW_FLOATS = C * HID + HID * NOUT;

__device__ __forceinline__ void load_raw(float* raw, const float* w1,
                                         const float* w2, int tid,
                                         int nthreads) {
    for (int i = tid; i < C * HID; i += nthreads) raw[i] = w1[i];
    for (int i = tid; i < HID * NOUT; i += nthreads) raw[C * HID + i] = w2[i];
}

// Stage the fragments of W into shared memory, pre-split: float4
// {hi0, hi1, lo0, lo1} at ((kk * NT + nt) * 32 + lane).
template <typename W>
__device__ void stage_split(float4* dst, const float* w1, const float* w2,
                            int tid, int nthreads) {
    for (int i = tid; i < W::KK * W::NT * 32; i += nthreads) {
        const int lane = i & 31, nt = (i >> 5) % W::NT, kk = (i >> 5) / W::NT;
        const int g = lane >> 2, t = lane & 3;
        uint32_t h0, l0, h1, l1;
        split(W::at(w1, w2, kk, nt, g, t, 0), h0, l0);
        split(W::at(w1, w2, kk, nt, g, t, 1), h1, l1);
        dst[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                             __uint_as_float(l0), __uint_as_float(l1));
    }
}

// The same, full f32: float2 {b0, b1}.
template <typename W>
__device__ void stage_full(float2* dst, const float* w1, const float* w2,
                           int tid, int nthreads) {
    for (int i = tid; i < W::KK * W::NT * 32; i += nthreads) {
        const int lane = i & 31, nt = (i >> 5) % W::NT, kk = (i >> 5) / W::NT;
        const int g = lane >> 2, t = lane & 3;
        dst[i] = make_float2(W::at(w1, w2, kk, nt, g, t, 0),
                             W::at(w1, w2, kk, nt, g, t, 1));
    }
}

// ---------------------------------------------------------------------------
// The lerp of one point's corner rows, staged in shared memory
// ---------------------------------------------------------------------------

// packed bf16x2 arithmetic, each op rounded once to nearest
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

// bf16x2 of round(lo) in the low half and round(hi) in the high half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    uint32_t d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
}

// a bf16-exact f32 value in both halves of a bf16x2
__device__ __forceinline__ uint32_t bf16x2_splat(float x) {
    const uint32_t b = __float_as_uint(x) >> 16;
    return b | (b << 16);
}

// The four lerp weights of one point and plane, rounded as the TPU kernel
// rounds them (each op in the rows' dtype): w00 = (1-x)(1-y)l,
// w01 = x(1-y)l, w10 = (1-x)y l, w11 = x y l, each product rounded before
// the next.  at(q) gives weight q as f32.
template <typename T> struct Weights;

template <> struct Weights<float> {
    float w[4];
    __device__ __forceinline__ Weights(float fx, float fy, float fl) {
        const float omx = __fsub_rn(1.f, fx), omy = __fsub_rn(1.f, fy);
        w[0] = __fmul_rn(__fmul_rn(omx, omy), fl);
        w[1] = __fmul_rn(__fmul_rn(fx, omy), fl);
        w[2] = __fmul_rn(__fmul_rn(omx, fy), fl);
        w[3] = __fmul_rn(__fmul_rn(fx, fy), fl);
    }
    __device__ __forceinline__ float at(int q) const { return w[q]; }
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
    uint32_t d;
    asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
    return d;
}

// bf16 rows: the weights two at a time in packed bf16x2 (explicit
// rounding, so each op rounds once, as the op-by-op f32 version does):
// p01 = (w00, w01), p23 = (w10, w11), low half first.
template <> struct Weights<__nv_bfloat16> {
    uint32_t p01, p23;
    __device__ __forceinline__ Weights(float tx, float ty, float live) {
        const uint32_t xy = pack_bf16x2(tx, ty);                // (x, y)
        const uint32_t om = bf16x2_sub(0x3f803f80u, xy);        // (1-x, 1-y)
        const uint32_t a = prmt(om, xy, 0x5410);                // (1-x, x)
        const uint32_t l = pack_bf16x2(live, live);
        p01 = bf16x2_mul(bf16x2_mul(a, prmt(om, om, 0x3232)), l);
        p23 = bf16x2_mul(bf16x2_mul(a, prmt(xy, xy, 0x3232)), l);
    }
    // weight q in both halves of a bf16x2
    __device__ __forceinline__ uint32_t splat(int q) const {
        const uint32_t p = q < 2 ? p01 : p23;
        return prmt(p, p, (q & 1) ? 0x3232 : 0x1010);
    }
    __device__ __forceinline__ float at(int q) const {
        const uint32_t p = q < 2 ? p01 : p23;
        return __uint_as_float((q & 1) ? (p & 0xffff0000u) : (p << 16));
    }
};

// Row layout: [c00 | c01 | c10 | c11], C channels each.  Lane t reads
// channels 8t..8t+7 of every corner with 16-byte loads.  (Rows are 256 B
// or 512 B, so the two points of an 8-lane phase meet on the same banks;
// reading odd points' chunks in another order avoids that but measured no
// faster, the loads being far from the kernels' limit.)
template <typename T> struct Corners;

template <> struct Corners<__nv_bfloat16> {
    uint4 c[4];   // corner q, channels 8t..8t+7, bf16 pairs
    __device__ __forceinline__ Corners(const __nv_bfloat16* row, int t) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
            c[q] = *reinterpret_cast<const uint4*>(row + q * C + 8 * t);
    }
    __device__ __forceinline__ static uint32_t word(const uint4& v, int i) {
        return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
    }
    __device__ __forceinline__ float at(int q, int j) const {
        const uint32_t w = word(c[q], j >> 1);
        return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
    }
};

template <> struct Corners<float> {
    uint4 c[4][2];   // corner q, channels 8t..8t+3 and 8t+4..8t+7
    __device__ __forceinline__ Corners(const float* row, int t) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                c[q][h] = *reinterpret_cast<const uint4*>(row + q * C + 8 * t
                                                          + 4 * h);
    }
    __device__ __forceinline__ float at(int q, int j) const {
        return __uint_as_float(
            Corners<__nv_bfloat16>::word(c[q][j >> 2], j & 3));
    }
};

// f = ((w00 c00 + w01 c01) + w10 c10) + w11 c11 for the lane's 8
// channels, every product and sum rounded to the rows' dtype (bf16: in
// packed bf16x2 with explicit rounding, so nothing contracts to an FMA;
// one bf16 rounding of a product of two bf16 values equals rounding it to
// f32 first, since f32 keeps 24 >= 2·8 + 2 bits).
__device__ __forceinline__ void lerp8(const Corners<__nv_bfloat16>& c,
                                      const Weights<__nv_bfloat16>& w,
                                      float (&f)[8]) {
    const uint32_t w00 = w.splat(0), w01 = w.splat(1);
    const uint32_t w10 = w.splat(2), w11 = w.splat(3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        uint32_t a = bf16x2_mul(w00, Corners<__nv_bfloat16>::word(c.c[0], i));
        a = bf16x2_add(a, bf16x2_mul(w01,
                                     Corners<__nv_bfloat16>::word(c.c[1], i)));
        a = bf16x2_add(a, bf16x2_mul(w10,
                                     Corners<__nv_bfloat16>::word(c.c[2], i)));
        a = bf16x2_add(a, bf16x2_mul(w11,
                                     Corners<__nv_bfloat16>::word(c.c[3], i)));
        f[2 * i] = __uint_as_float(a << 16);
        f[2 * i + 1] = __uint_as_float(a & 0xffff0000u);
    }
}

__device__ __forceinline__ void lerp8(const Corners<float>& c,
                                      const Weights<float>& w, float (&f)[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        float a = __fadd_rn(__fmul_rn(w.at(0), c.at(0, j)),
                            __fmul_rn(w.at(1), c.at(1, j)));
        a = __fadd_rn(a, __fmul_rn(w.at(2), c.at(2, j)));
        f[j] = __fadd_rn(a, __fmul_rn(w.at(3), c.at(3, j)));
    }
}

// Per-point f32 inputs of a tile, staged beside its rows: tx, ty, live of
// the three planes, then inbox, then (backward) g_sigma; P floats each.
enum Scalar { TX = 0, TY = 3, LIVE = 6, INBOX = 9, GSIGMA = 10 };

// x: the plane mean of the lerped features of point p, channels 8t..8t+7
// (zero for a point past M)
template <typename T>
__device__ __forceinline__ void lerp_point(const T* rs, const float* sc,
                                           int p, bool valid, int t,
                                           float (&x)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = 0.f;
    if (!valid) return;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const Weights<T> w(sc[(TX + k) * P + p], sc[(TY + k) * P + p],
                           sc[(LIVE + k) * P + p]);
        const Corners<T> c(rs + (size_t)(k * P + p) * (4 * C), t);
        float f[8];
        lerp8(c, w, f);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = __fadd_rn(x[i], f[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __fmul_rn(x[i], 1.f / 3.f);
}

// ---------------------------------------------------------------------------
// The ring of row tiles
// ---------------------------------------------------------------------------

// The copies of one tile of n <= P points from m0, by one warp: lane
// 0 posts the bytes of the bulk copies (the rows of each plane, and an
// optional further contiguous span `extra`) on `full` and issues them;
// every lane copies its share of the per-point f32 inputs (src[j] + m0,
// NULL when absent) with 4-byte cp.async (a plane's tx starts k·M·4 bytes
// in, which is 16-byte aligned only when M % 4 == 0) and arrives on `full`
// when they land.  `full` expects 33 arrivals: lane 0's and the 32
// lanes'.  Points past M are not copied; the consumers mask them.
template <typename T, int NS>
__device__ __forceinline__ void load_tile(
    uint32_t full, uint32_t rows_s, const T* rows, uint32_t scal_s,
    const float* const (&src)[NS], long long M, long long m0, int n,
    int lane, uint32_t extra_s = 0, const void* extra = nullptr,
    uint32_t extra_bytes = 0) {
    constexpr uint32_t ROW_BYTES = 4 * C * sizeof(T);
    if (lane == 0) {
        hopper::mbar_expect_tx(full, 3 * n * ROW_BYTES + extra_bytes);
#pragma unroll
        for (int k = 0; k < 3; ++k)
            hopper::bulk_load(rows_s + k * P * ROW_BYTES,
                              rows + ((long long)k * M + m0) * (4 * C),
                              n * ROW_BYTES, full);
        if (extra_bytes) hopper::bulk_load(extra_s, extra, extra_bytes, full);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
        if (src[j] == nullptr) continue;
#pragma unroll
        for (int r = 0; r < P / 32; ++r) {
            const int p = lane + 32 * r;
            if (p < n)
                hopper::cp_async_4(scal_s + (j * P + p) * 4, src[j] + m0 + p);
        }
    }
    hopper::cp_async_arrive(full);
}

}  // namespace osg
