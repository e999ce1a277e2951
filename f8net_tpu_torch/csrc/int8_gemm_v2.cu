// K7: persistent int8 GEMM with resident weights, the contract of K1,
//   y[M, N] = epilogue(x[M, K] . w[K, N] + bias[N])
// Replaces f8net_tpu/ops/pallas_gemm_v2.py:int8_gemm_v2 (:123-228; kernel
// body _kernel :30, pallas_call :174).
//
// The TPU kernel runs one program per N-block, keeps that block's weights
// and bias resident in VMEM and streams M chunks of x through two buffers.
// Here: a persistent grid of at most one block per SM.  Block (bx, by)
// owns the 64 output columns of N-block by: it stages their whole K-deep
// weight slab once in shared memory, transposed for the mma.sync B operand
// (mma_tile.cuh's load_b_kn at a row stride of round_up(K, 64) + 16 bytes),
// then walks the M chunks bx, bx + gridDim.x, ...  Each chunk is 64 rows of
// x, streamed in 64-byte K slices through a three-stage cp.async ring, so
// the copies of the next slices (of the next chunk, at a chunk's end) are in
// flight while one slice runs on the tensor cores.  The shared epilogue
// (requant.cuh through store_tile) writes each 64 x 64 tile once.
//
// What bounds it on an H100: ResNet-50's 33 pointwise convs at batch 8 do
// about 29 G operations (0.015 ms at the int8 peak) but move about 250 MB,
// most of it the int32 outputs of each block's last conv and shortcut
// (0.07 ms at 3.35 TB/s), so bytes bound it.  The resident weights are read
// once per block instead of once per 64-row tile.
// Not yet done (later PRs): TMA and wgmma, more than 4 warps per block,
// writing the output through shared memory.
//
// Shared memory: 64 * (round_up(K, 64) + 16) bytes of weights plus the
// 15 KB ring: 147 KB at K = 2048 (ResNet-50 stage 3), so K <= 3328.
#include <algorithm>
#include <cstdint>

#include "launch.cuh"
#include "mma_tile.cuh"

namespace f8 {

constexpr int kStages = 3;  // x slices in flight

struct GemmV2Layout {
  int ldb;    // weight slab row stride in bytes: round_up(K, 64) + 16
  int a;      // offset of the x ring
  int total;  // dynamic shared memory bytes
};

inline GemmV2Layout gemm_v2_layout(int K) {
  GemmV2Layout l;
  l.ldb = (K + kBK - 1) / kBK * kBK + 16;
  l.a = kBN * l.ldb;
  l.total = l.a + kStages * kBM * kLDS;
  return l;
}

__global__ void __launch_bounds__(kThreads)
    int8_gemm_v2_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const int32_t* __restrict__ bias, void* __restrict__ out, int M, int N,
                        int K, GemmV2Layout l, int epilogue, int net, int out_signed, int relu) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sw = smem;
  int8_t* sa = smem + l.a;
  const int n0 = blockIdx.y * kBN;
  const int ksteps = (K + kBK - 1) / kBK;
  const int mchunks = (M + kBM - 1) / kBM;
  const int bx = static_cast<int>(blockIdx.x), gx = static_cast<int>(gridDim.x);
  const int my_chunks = bx < mchunks ? (mchunks - 1 - bx) / gx + 1 : 0;
  const int steps = my_chunks * ksteps;  // (chunk, K slice) pairs, in order

  // step s: rows of chunk bx + (s / ksteps) * gx, K slice s % ksteps, into
  // ring slot s % kStages; rows past M and bytes past K arrive as zeros
  auto load_a = [&](int s) {
    const int m0 = (bx + (s / ksteps) * gx) * kBM;
    const int k0 = (s % ksteps) * kBK;
    int8_t* dst = sa + (s % kStages) * kBM * kLDS;
#pragma unroll
    for (int j = 0; j < kBM * kBK / 16 / kThreads; ++j) {
      const int q = threadIdx.x + j * kThreads;
      const int row = q >> 2, kc = (q & 3) * 16;
      const int m = m0 + row, k = k0 + kc;
      const bool ok = m < M && k < K;
      cp_async16(dst + row * kLDS + kc, ok ? x + static_cast<size_t>(m) * K + k : x, ok);
    }
  };

  // the first slices fly while the weight slab loads
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_a(s);
    cp_async_commit();
  }
  for (int k0 = 0; k0 < ksteps * kBK; k0 += kBK)
    load_b_kn<true>(sw + k0, w + static_cast<size_t>(k0) * N, N, min(kBK, K - k0), n0, l.ldb);

  Acc acc;
  zero_acc(acc);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step s have landed
    __syncthreads();               // everyone's have, and slot (s - 1) is free
    if (s + kStages - 1 < steps) load_a(s + kStages - 1);
    cp_async_commit();
    const int ks = s % ksteps;
    tile_mma_ptr(sa + (s % kStages) * kBM * kLDS, kLDS, sw + ks * kBK, l.ldb, acc);
    if (ks == ksteps - 1) {
      store_tile(acc, (bx + (s / ksteps) * gx) * kBM, n0, M, N, bias, epilogue, net,
                 out_signed != 0, relu != 0, out);
      zero_acc(acc);
    }
  }
  cp_async_wait<0>();
}

}  // namespace f8

// x: (M, K) int8, K % 16 == 0, 16-byte aligned; w: (K, N) int8, N % 4 ==
// 0, 4-byte aligned; bias: (N,) int32; out: (M, N) int32 (epilogue 0) or
// int8 (epilogue 1).  Returns cudaErrorInvalidValue when the weight slab
// does not fit one block's shared memory (K > 3328).
extern "C" int f8_int8_gemm_v2(const void* x, const void* w, const void* bias, void* out, int M,
                               int N, int K, int epilogue, int net, int out_signed, int relu,
                               void* stream) {
  const f8::GemmV2Layout l = f8::gemm_v2_layout(K);
  if (l.total > f8::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(f8::int8_gemm_v2_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, l.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblocks = (N + f8::kBN - 1) / f8::kBN;
  const int mchunks = (M + f8::kBM - 1) / f8::kBM;
  // at most one block per SM in all: the SMs split among the N-blocks
  const int gx = std::max(1, std::min(mchunks, sms / nblocks));
  const dim3 grid(gx, nblocks);
  f8::int8_gemm_v2_kernel<<<grid, f8::kThreads, l.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), out, M, N, K, l, epilogue, net, out_signed, relu);
  return static_cast<int>(cudaGetLastError());
}
