// Block tile of the port's mma.sync s8 x s8 -> s32 products (K1
// int8_gemm.cu's general form; K1's other forms and K3 stem_pool.cu use its
// fragment primitives): a 64 x 64 output tile per block of 4 warps, each
// warp 32 x 32, on mma.sync.m16n8k32 tensor-core instructions.  The wgmma
// kernels (K2, K5, K6, K7) take only the cp.async helpers and kMaxSmem from
// here.
//
// Per step of the reduction the block stages a 64 x 64-byte A tile (rows =
// GEMM rows, k contiguous) and a 64 x 64-byte B tile (columns = output
// channels, k contiguous) in shared memory; K1 copies B from its packed
// weights (ops/gemm.py:pack_k1_weight), already k-contiguous.
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

// acc += A_tile . B_tile^T over the kBK bytes staged in shared memory: A is
// the block's 64 rows, B its 64 columns, both k-contiguous with row stride
// kLDS (16 mod 64 bytes: the 32 lanes of a fragment read fall on 32
// distinct banks).
__device__ __forceinline__ void tile_mma(const SmemTile& s, Acc& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 32) {
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* p = s.a + (wm + mi * 16 + g) * kLDS + kk + t * 4;
      af[mi][0] = lds32(p);
      af[mi][1] = lds32(p + 8 * kLDS);
      af[mi][2] = lds32(p + 16);
      af[mi][3] = lds32(p + 8 * kLDS + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* p = s.b + (wn + ni * 8 + g) * kLDS + kk + t * 4;
      bf[ni][0] = lds32(p);
      bf[ni][1] = lds32(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
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
