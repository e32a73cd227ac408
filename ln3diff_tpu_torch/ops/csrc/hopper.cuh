// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA tensor copies, 1-D bulk loads and 4-byte cp.async copies, wgmma
// shared-memory descriptors and the wgmma instructions themselves, and the
// host-side encoding of TMA tensor maps.  Everything here is plain PTX
// through inline asm: no CUTLASS, so a source that includes it still builds
// in seconds.
#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// host: TMA tensor maps
// ---------------------------------------------------------------------------

// Error codes the entry points return besides cudaError_t values: the
// driver's cuTensorMapEncodeTiled could not be found, or refused a map
// (then the code is kEncodeError + its CUresult).
constexpr int kNoEncoder = 10000;
constexpr int kEncodeError = 10001;

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library needs no -lcuda link; looked up once.
inline EncodeTiledFn encode_tiled() {
    static const EncodeTiledFn fn = []() -> EncodeTiledFn {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (err != cudaSuccess || q != cudaDriverEntryPointSuccess)
            return nullptr;
        return reinterpret_cast<EncodeTiledFn>(p);
    }();
    return fn;
}

// A bf16 tensor map of `rank` dimensions, innermost first: sizes `dims`,
// byte strides `strides` of dimensions 1..rank-1 (each a multiple of 16),
// a `box` per copy and a swizzle of `swizzle_bytes` (128, 64 or 32: the
// box's inner extent in bytes).  Elements outside the tensor read as zero
// and are not written.  Returns 0 or one of the codes above.
inline int encode_bf16(CUtensorMap* map, const void* ptr, int rank,
                       const uint64_t* dims, const uint64_t* strides,
                       const uint32_t* box, int swizzle_bytes) {
    const EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return kNoEncoder;
    const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
    const CUtensorMapSwizzle sw =
        swizzle_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
        : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B;
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          (cuuint32_t)rank, const_cast<void*>(ptr), dims,
                          strides, box, elem_strides,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

}  // namespace hopper

namespace {

// Let `Kernel` use `bytes` of dynamic shared memory: cudaFuncSetAttribute
// once per kernel instance, not per launch.  In an unnamed namespace, so
// that each library that includes this header keeps its own flag: a
// function-local static of an inline function with external linkage is
// one object across every loaded library (STB_GNU_UNIQUE), and the second
// library's kernel would never be given its limit.
template <auto Kernel>
cudaError_t allow_dynamic_smem(int bytes) {
    static const cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return err;
}

}  // namespace

namespace hopper {

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset inside a tile whose rows are SW bytes long (SW = 128, 64),
// stored as TMA's SW-byte swizzle lays it out: the 16-byte chunk index is
// XORed with bits 7.. of the offset
template <int SW>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
    return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("{\n .reg .b64 state;\n"
                 " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
                 :: "r"(bar) : "memory");
}

// Wait for the phase of parity `parity` to complete.  A wait that spins
// 2^26 times (seconds) traps, so that a fault in the ring ends the launch
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    for (uint32_t spins = 0;; ++spins) {
        uint32_t done;
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (spins == (1u << 26)) __trap();
    }
}

// One contiguous copy of `bytes` from global `src` into shared `dst`
// (both 16-byte aligned, bytes a multiple of 16), reported to `bar` by
// complete_tx: a 1-D bulk copy, which needs no tensor map.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
           "r"(bar) : "memory");
}

// A 4-byte asynchronous copy from global to shared memory (no alignment
// beyond 4 bytes).
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src))
                 : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed;
// the arrival counts against the barrier's expected count (noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.tile.bulk_group"
        " [%0, {%2, %3}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
        " [%0, {%2, %3, %4, %5}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
           "r"(c2), "r"(c3) : "memory");
}

// the TMA stores issued so far have read their shared memory
__device__ __forceinline__ void tma_store_wait() {
    asm volatile("cp.async.bulk.commit_group;\n"
                 "cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory become visible to TMA and wgmma
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier among `threads` threads (a multiple of 32) only
__device__ __forceinline__ void named_barrier(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1 = 128 B, 2 = 64 B, 3 = 32 B).
// Tiles start on 1024-byte boundaries, so the base offset is 0.  Adding n
// to a descriptor moves its start by 16·n bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
    const uint64_t layout = swizzle == 128 ? 1 : swizzle == 64 ? 2 : 3;
    return (uint64_t)((addr & 0x3FFFF) >> 4)
           | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
           | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that owns it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Accumulator layout of m64nN (f32), thread t of the warpgroup (warp
// w = t / 32, lane): d[4j + 2r + e] is row 16w + lane/4 + 8r, column
// 8j + 2(lane % 4) + e.  The bf16 A operand from registers (m64nNk16)
// has the same layout over its 16 columns, packed in pairs: so the f32
// scores of columns 16c..16c+15 become A's registers {d[8c..8c+1],
// d[8c+2..3], d[8c+4..5], d[8c+6..7]}, each pair rounded to bf16x2.

// d (64 x 64, f32) += A (64 x 16, smem) * B (16 x 64, smem)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, 1, 1, 1, 0, %34;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "n"(TRANS_B));
}

// d (64 x 96, f32) += A (64 x 16, smem) * B (16 x 96, smem)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t da,
                                              uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, 1, 1, 1, 0, %50;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "n"(TRANS_B));
}

// d (64 x 192, f32) += A (64 x 16, smem) * B (16 x 192, smem)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n192(float (&d)[96], uint64_t da,
                                              uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, 1, 1, 1, 0, %98;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "n"(TRANS_B));
}

// d (64 x 32, f32) += A (64 x 16, bf16 registers) * B (16 x 32, smem)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, 1, 1, 1, %21;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TRANS_B));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, %37;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TRANS_B));
}

}  // namespace hopper
