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
// the arithmetic of the TPU kernel, which keeps the whole (L, L) f32 score
// tile in VMEM.  At the DiT's L = 768 that tile is 2.36 MB, ten times the
// shared memory of an H100 block, so K and V stream through shared memory
// and the kernel makes two passes over K:
//
//   pass 1: the row max m and the row sum l;
//   pass 2: recompute s, form p, round it to the input dtype and
//           accumulate p v in f32.
//
// Rounding the normalised p (and not the unnormalised exponentials of a
// one-pass online softmax) keeps the kernel equal to the TPU kernel and to
// the plain version up to f32 summation order and the last f32 ulp of p.
//
// What bounds it on an H100: the function does 4 B H L^2 d operations on
// 4 B L H d elements of input and output: at the DiT's shapes (B=2, L=768,
// H=16, d=64, bf16) 4.83 GFLOP (4.9 us at 989 TFLOP/s of dense bf16)
// against 12.6 MB (3.8 us at 3.35 TB/s), so operations bound it.  The
// second pass's recomputed q k^T makes 7.2 GFLOP of tensor work, 7.3 us.
//
// bf16 design (attention_common.cuh, attn::sm90), what the tensor cores
// and the copy engine need:
//   - one block per (64 query rows, batch*head): one consumer warpgroup
//     that owns the 64 rows, and one producer warp.  At the DiT's shapes
//     that is 12 x 32 = 384 blocks; a block takes 57 KB of shared memory
//     and at most 136 registers a thread, so three fit on an SM and all
//     384 are resident at once on 132 SMs (396 slots): no second wave and
//     no tail, and the three blocks' softmax and tensor work overlap on
//     the SM.  128-row blocks would give 192 blocks, 1.45 waves.
//   - copies: the producer's TMA loads, through tensor maps that carry
//     the (batch, row, head) strides, so the thirds of one qkv projection
//     (row stride 3 H d) are read in place.  Q once; then K (pass 1), then
//     K and V (pass 2), 64 keys a tile, through a ring of 3 stages with a
//     full and an empty mbarrier each.  128-byte swizzle for d = 64,
//     64-byte for d = 32: the layouts the wgmma descriptors read.  Rows
//     past L are zero-filled by TMA.  Only the ring streams, so any L fits.
//   - products: s = q k^T by wgmma m64n64k16 with both operands in shared
//     memory; the scores stay in registers (no shared staging tile).  Pass
//     1 keeps a running (max, sum) per thread and row in log2 units,
//     merged over the row's 4 lanes once at the end, and issues the next
//     tile's q k^T before it sums this tile's exponentials, so the tensor
//     cores and the exp2s overlap.  Pass 2 forms
//     p = exp2(s*scale*log2(e) - m) * (1/l) (no division per score; one
//     ex2.approx per exponential), rounds it to bf16 in registers, where
//     the accumulator's layout already is wgmma's register-A layout, and
//     accumulates p v by wgmma m64nDk16 against V as an MN-major B.  Keys
//     >= L are set to -inf explicitly, on the last key tile only.
//   - the limit of the design: two exponentials per score (one per pass,
//     on the 16 special-function lanes of an SM: 37.7 M at the DiT's
//     shapes, about 10 us) and 1.5x the tensor work of one pass, against
//     a one-pass online softmax, which cannot round the normalised p.
//   - output: o is rounded to bf16 into Q's shared tile and written by one
//     TMA store through o's strides; rows past L are clipped by the map.
//   - cudaFuncSetAttribute runs once per template instance; the tensor
//     maps are encoded on the host per call (cuTensorMapEncodeTiled,
//     reached through cudaGetDriverEntryPoint: no -lcuda).  No setmaxnreg:
//     the consumer fits in the 136 registers that three blocks per SM
//     leave it.
// f32 operands keep the CUDA-core kernel (attn::simt): FMA products from
// shared memory, expf and a division per score; no model path runs them.

#include "attention_common.cuh"

extern "C" {

// Launch on `stream`.  q, k, v: (B, L, H, d) bf16 (dtype_bf16 = 1) or f32
// (0), unit stride along d; then 12 byte strides, each a multiple of 16,
// (row, head, batch) of q, k, v and then o (the order of the TMA tensor
// maps' dimensions 1..3); o: (B, L, H, d) output of the same dtype; all
// 16-byte aligned; scale: the f32 score scale
// (1/sqrt(d)).  d is 32 or 64.  Returns the cudaError_t of the launch (0
// on success), or 10000 and up when a TMA tensor map cannot be encoded.
int ln3diff_fused_attention(const void* q, const void* k, const void* v,
                            void* o, int dtype_bf16, int B, int L, int H,
                            int d, long long qsl, long long qsh,
                            long long qsb, long long ksl, long long ksh,
                            long long ksb, long long vsl, long long vsh,
                            long long vsb, long long osl, long long osh,
                            long long osb, float scale, void* stream) {
    if (B <= 0 || L <= 0 || H <= 0) return 0;
    if ((d != 32 && d != 64) || (long long)B * H > 65535)
        return (int)cudaErrorInvalidValue;
    attn::Params p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.o = o;
    p.sq = attn::Strides{qsb, qsl, qsh};
    p.sk = attn::Strides{ksb, ksl, ksh};
    p.sv = attn::Strides{vsb, vsl, vsh};
    p.so = attn::Strides{osb, osl, osh};
    p.B = B;
    p.L = L;
    p.H = H;
    p.scale = scale;
    return attn::launch(p, dtype_bf16 != 0, d,
                        reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
