// Hopper primitives of the port's wgmma kernels (K2 int8_conv.cu, K5
// ir_block.cu, K6 conv_flat.cu, K7 int8_gemm_v2.cu): the warpgroup product
// wgmma.mma_async m64nNk32 (N = 32, 64, 128) with s8 operands and s32
// accumulators, its shared-memory matrix descriptors, the fences that order
// it against the generic-proxy writes (cp.async, st.shared) that fill its
// operands, the shared-memory mbarriers of K6's and K7's producer/consumer
// rings, and the 1-D bulk copy (cp.async.bulk) that K6's producer fills its
// ring with.  K1 and K3 keep mma_tile.cuh's mma.sync tile.
//
// Operand layout in shared memory ("no swizzle", K-major, both operands):
// a tile of R rows (M rows of A, N columns of B) by 64 bytes of the
// reduction is stored as four 16-byte k-chunks, each a run of R rows of 16
// bytes:
//
//     byte offset of (row r, k byte b) = (b / 16) * R * 16 + r * 16 + b % 16
//
// so 8 consecutive rows of one chunk form wgmma's 8 x 16-byte core matrix
// (128 contiguous bytes).  In the descriptor, the leading byte offset (LBO)
// is the step from one k-chunk to the next (R * 16 bytes) and the stride
// byte offset (SBO) the step from one 8-row group to the next (128 bytes);
// one k32 instruction reads two chunks.  wgmma has no transpose for 8-bit
// types, so both A and B must be K-major: that is why the weights are packed
// once, on the host, into this chunked layout (ops/conv.py:pack_conv_weight).
// Writing 16-byte chunks of consecutive rows touches consecutive addresses,
// so the cp.async fill is free of bank conflicts.
//
// Accumulator fragment of m64nNk32 (.s32), per thread of the warpgroup:
// warp w = (tid % 128) / 32 holds rows 16w + lane/4 and 16w + lane/4 + 8;
// register 4j + i (j < N/8) holds row 16w + lane/4 + 8 * (i >= 2), column
// 8j + 2 * (lane % 4) + (i & 1).
#pragma once

#include <cstdint>

namespace f8 {

// Descriptor of a K-major, unswizzled shared-memory operand starting at p
// (16-byte aligned): start address, LBO and SBO in 16-byte units, layout
// type 0 (no swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// Make this thread's generic-proxy writes to shared memory (st.shared, and
// cp.async copies it has waited for) visible to the async proxy, which is
// where wgmma reads its operands.  Each writing thread fences, then the
// block synchronises, then wgmma may read.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Order register accesses before the warpgroup's next wgmma (required
// before the first one and after the accumulators are written by others).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of the warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d = A (64 x 32 bytes, descriptor da) . B (N x 32 bytes, descriptor db)^T
// + (accumulate ? d : 0), s8 x s8 -> s32; issued by all 128 threads of a
// warpgroup, asynchronous until wgmma_commit / wgmma_wait.  Starting a sum
// with accumulate = 0, rather than zeroing d with ordinary instructions,
// keeps other instructions from defining the accumulators, which would make
// ptxas serialise the wgmma pipeline.
template <int N>
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int32_t (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int32_t (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int32_t (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// Shared-memory mbarriers (K7's ring): init by one thread, then a block
// barrier before first use; arrive counts one arrival; wait spins on the
// phase parity (0 for the first completion of the barrier, then 1, 0, ...).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// one arrival on `bar` from each thread whose `pred` is true: a predicated
// instruction, not a branch, so that a consumer can release a stage from one
// lane without a divergent path between its warpgroup's wgmmas
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 st;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) { mbar_arrive_if(bar, true); }

// spin until the phase with parity `parity` of `bar` has completed; the loop
// is inside the asm block (its labels are local to the block)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Make the barriers' initialisation visible to the other threads and to the
// async proxy (the bulk copies' completion) before their first use.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// as mbar_wait, but after about 2^32 clocks (seconds) of waiting it traps: a
// launch error where a broken hand-off would hang the card
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.lt.u64 p, t1, 4294967296;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one arrival on `bar` that also expects `bytes` more bytes of transactions
// (the bulk copies that complete on it) before its phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory by the async proxy, completing as
// transactions on `bar`: no thread waits on it, and wgmma, in the same
// proxy, reads what it wrote without a proxy fence
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace f8
