// Block tile of the port's mma.sync s8 x s8 -> s32 products (K1
// int8_gemm.cu, K6 conv_flat.cu; K3 stem_pool.cu uses its fragment
// primitives): a 64 x 64 output tile per block of 4 warps, each warp 32 x 32,
// on mma.sync.m16n8k32 tensor-core instructions.  The wgmma kernels (K2, K5,
// K7) take only the cp.async helpers and kMaxSmem from here.
//
// Per step of the reduction the block stages a 64 x 64-byte A tile (rows =
// GEMM rows or output pixels, k contiguous) and a 64 x 64-byte B tile
// (columns = output channels, k contiguous) in shared memory.  K1 copies B
// from its packed weights (ops/gemm.py:pack_k1_weight), already k-contiguous;
// K6 reads a (K, N) row-major matrix -- the reference's HWIO layout -- and
// transposes it 4 x 4 bytes at a time on its way into shared memory
// (load_b_kn).
//
// Fragment layouts are PTX's for m16n8k32 with .s8 operands (g = lane / 4,
// t = lane % 4):
//   A (16 x 32, row):  a0 = A[g][4t..4t+3],   a1 = A[g+8][4t..],
//                      a2 = A[g][16+4t..],    a3 = A[g+8][16+4t..]
//   B (32 x 8, col):   b0 = B[4t..4t+3][g],   b1 = B[16+4t..][g]
//   C (16 x 8, s32):   c0,c1 = C[g][2t, 2t+1], c2,c3 = C[g+8][2t, 2t+1]
// A shared-memory row stride of 80 bytes (20 words) puts the 32 lanes of a
// fragment read on 32 distinct banks.
#pragma once

#include <cstdint>

#include "requant.cuh"

namespace f8 {

constexpr int kBM = 64;       // output rows per block
constexpr int kBN = 64;       // output columns per block
constexpr int kBK = 64;       // reduction bytes per shared-memory stage
constexpr int kLDS = kBK + 16;
constexpr int kThreads = 128;
constexpr int kMaxSmem = 232448;  // 227 KB, the most shared memory one block can have

struct SmemTile {
  alignas(16) int8_t a[kBM * kLDS];
  alignas(16) int8_t b[kBN * kLDS];
};

using Acc = int32_t[2][4][4];

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc += A . B^T over kBK bytes of k: A is the block's 64 rows starting at
// `a` (row stride lda bytes), B its 64 columns starting at `b`, stored
// k-contiguous (row stride ldb bytes), both in shared memory.  A stride of
// 16 mod 64 bytes (kLDS = 80, or a round-up of the reduction to 64 plus 16)
// puts the 32 lanes of a fragment read on 32 distinct banks.
__device__ __forceinline__ void tile_mma_ptr(const int8_t* a, int lda, const int8_t* b, int ldb,
                                             Acc& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 32) {
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* p = a + (wm + mi * 16 + g) * lda + kk + t * 4;
      af[mi][0] = lds32(p);
      af[mi][1] = lds32(p + 8 * lda);
      af[mi][2] = lds32(p + 16);
      af[mi][3] = lds32(p + 8 * lda + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* p = b + (wn + ni * 8 + g) * ldb + kk + t * 4;
      bf[ni][0] = lds32(p);
      bf[ni][1] = lds32(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
  }
}

// acc += A_tile . B_tile^T over the kBK bytes staged in shared memory
__device__ __forceinline__ void tile_mma(const SmemTile& s, Acc& acc) {
  tile_mma_ptr(s.a, kLDS, s.b, kLDS, acc);
}

// Four bytes B[k][n .. n+3] of a row-major int8 matrix with row stride N,
// 0 past column N: one 32-bit load when kVec4 (N % 4 == 0, `row` 4-byte
// aligned), byte loads otherwise.
template <bool kVec4>
__device__ __forceinline__ uint32_t load_row4(const int8_t* row, int n, int N) {
  if (kVec4) return n < N ? *reinterpret_cast<const uint32_t*>(row + n) : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (n + b < N) v |= static_cast<uint32_t>(static_cast<uint8_t>(row[n + b])) << (8 * b);
  return v;
}

// Stage B[k0 .. k0+kvalid, n0 .. n0+64) of a (K, N) row-major int8 matrix
// whose row k0 starts at `w` (row stride N) as sb[n][k], row stride kLDS.
// Each thread moves two 4 x 4 byte blocks: four row loads, a register
// transpose with byte permutes, four 32-bit column stores.  Rows past kvalid
// and columns past N are staged as 0.  kVec4 requires N % 4 == 0.
template <bool kVec4>
__device__ __forceinline__ void load_b_kn(int8_t* sb, const int8_t* w, int N, int kvalid,
                                          int n0) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int nq = q & 15, k = (q >> 4) * 4;
    const int n = n0 + nq * 4;
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = k + i < kvalid ? load_row4<kVec4>(w + static_cast<size_t>(k + i) * N, n, N) : 0u;
    // r[i] holds B[k+i][n..n+3]; c[c] gathers B[k..k+3][n+c]
    const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
    const uint32_t c[4] = {
        __byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
        __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      *reinterpret_cast<uint32_t*>(sb + (nq * 4 + cc) * kLDS + k) = c[cc];
  }
}

// 16-byte asynchronous copy global -> shared (cp.async, L2 only); with
// `valid` false it reads nothing and writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(int8_t* dst, const int8_t* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;
}

// f(row, col, value) for each accumulator element this thread holds, with
// row and col relative to the block's 64 x 64 tile.
template <class F>
__device__ __forceinline__ void for_each_acc(const Acc& acc, F&& f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f(wm + mi * 16 + g + (i >= 2 ? 8 : 0), wn + ni * 8 + t * 2 + (i & 1), acc[mi][ni][i]);
}

// Epilogue of a 64 x 64 tile into a row-major (M, N) output: bias add,
// optional ReLU, then int32 out or requant8 (s8 out).
__device__ __forceinline__ void store_tile(const Acc& acc, int m0, int n0, int M, int N,
                                           const int32_t* __restrict__ bias, int epilogue,
                                           int net, bool out_signed, bool relu, void* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + wm + mi * 16 + g + (i >= 2 ? 8 : 0);
        const int col = n0 + wn + ni * 8 + t * 2 + (i & 1);
        if (row >= M || col >= N) continue;
        const int32_t v = bias_relu(acc[mi][ni][i], bias[col], relu);
        const size_t idx = static_cast<size_t>(row) * N + col;
        if (epilogue == kInt32)
          static_cast<int32_t*>(out)[idx] = v;
        else
          static_cast<int8_t*>(out)[idx] = requant8(v, net, out_signed);
      }
}

}  // namespace f8
