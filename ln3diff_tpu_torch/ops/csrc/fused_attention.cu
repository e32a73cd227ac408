// Fused short-sequence self-attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` of
// ln3diff_tpu/ops/fused_attention.py (:39; `fused_attention` :58,
// pallas_call :76, reached through `sdpa_auto` :87).  For each
// (batch, head) it computes, on (L, d) operands,
//
//   s = q k^T                (f32 accumulation of the input-dtype products)
//   s = s * (1/sqrt(d))
//   m = max_j s,  e = exp(s - m),  l = sum_j e          (f32)
//   p = (e / l) rounded to the input dtype
//   o = p v                  (f32 accumulation), rounded to the input dtype
//
// exactly the arithmetic of the TPU kernel, which keeps the whole (L, L)
// f32 score tile in VMEM.  At the DiT's L = 768 that tile is 2.36 MB, ten
// times the shared memory of an H100 block, so this kernel streams K and V
// through shared memory in 64-row tiles and makes two passes over K:
//
//   pass 1: the row max m and the row sum l, each lane keeping a running
//           (max, sum) over its own columns, merged across the warp once
//           at the end;
//   pass 2: recompute s, form p = exp(s - m) / l, round p to the input
//           dtype and accumulate p v in f32.
//
// Rounding the normalised p (and not the unnormalised exponentials of a
// one-pass online softmax) keeps the kernel equal to the TPU kernel and to
// the plain version up to f32 summation order.
//
// What bounds it on an H100: the function does 4 B H L^2 d operations on
// 4 B L H d elements of input and output: at the DiT's shapes (B=2, L=768,
// H=16, d=64, bf16) 4.83 GFLOP (4.9 us at 989 TFLOP/s of dense bf16)
// against 12.6 MB (3.8 us at 3.35 TB/s), so operations bound it.  This
// first version is simple rather than fast: bf16 products run on the
// tensor cores through nvcuda::wmma (bf16 in, f32 accumulate), f32
// operands on the CUDA cores; pass 2 recomputes q k^T; nothing is
// pipelined.
//
// Layout: one block of 4 warps per (64-query tile, batch*head); warp w owns
// query rows 16w..16w+15 of the tile.  q, k and v are read in place in
// their (B, L, H, d) layout through a (batch, row, head) stride each, so
// the three thirds of one fused qkv projection (row stride 3*H*d) need no
// copies; o is written through its own strides.  The ragged last query
// tile and the ragged last key tile are masked here.  d must be 32 or 64.
// The device code lives in attention_common.cuh, which kernel 4
// (fused_qkv_attention.cu) runs as its attention stage.

#include "attention_common.cuh"

extern "C" {

// Launch on `stream`.  q, k, v: (B, L, H, d) bf16 (dtype_bf16 = 1) or f32
// (0), unit stride along d, 16-byte aligned rows; strides: 12 element
// strides, (batch, row, head) of q, k, v and then o; o: (B, L, H, d) output
// of the same dtype; scale: the f32 score scale (1/sqrt(d)).  d is 32 or
// 64.  Returns the cudaError_t of the launch (0 on success).
int ln3diff_fused_attention(const void* q, const void* k, const void* v,
                            void* o, int dtype_bf16, int B, int L, int H,
                            int d, const long long* strides, float scale,
                            void* stream) {
    if (B <= 0 || L <= 0 || H <= 0) return 0;
    if ((d != 32 && d != 64) || (long long)B * H > 65535)
        return (int)cudaErrorInvalidValue;
    attn::Params p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.o = o;
    attn::Strides* st[4] = {&p.sq, &p.sk, &p.sv, &p.so};
    for (int i = 0; i < 4; ++i) {
        st[i]->b = strides[3 * i];
        st[i]->l = strides[3 * i + 1];
        st[i]->h = strides[3 * i + 2];
    }
    p.L = L;
    p.H = H;
    p.scale = scale;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (dtype_bf16) {
        return d == 64 ? attn::launch<__nv_bfloat16, 64>(p, B, s)
                       : attn::launch<__nv_bfloat16, 32>(p, B, s);
    }
    return d == 64 ? attn::launch<float, 64>(p, B, s)
                   : attn::launch<float, 32>(p, B, s);
}

}  // extern "C"
