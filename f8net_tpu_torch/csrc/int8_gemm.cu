// K1: int8 GEMM with int32 accumulation and the fused requant epilogue,
//   y[M, N] = epilogue(x[M, K] . w[K, N] + bias[N])
// Replaces f8net_tpu/ops/pallas_gemm.py:int8_gemm (:121-198; kernel body
// _gemm_kernel :49, pallas_call :175).
//
// What bounds it on an H100: at the classifier's shape (M = batch, K = 512,
// N = 1000) the weights dominate the bytes and the product is tiny, so it is
// bound by bytes and by launch latency; at 1x1-conv shapes (M in the tens of
// thousands) it is bound by tensor-core operations.  Design: s8 mma.sync
// tiles of 64 x 64 per block (mma_tile.cuh), the K loop inside the block
// (the TPU's sequential K grid axis), bias + ReLU + requant applied to the
// registers before the single store, so the int32 accumulator never goes to
// device memory in the requant8 epilogue.  No software pipelining yet: each
// 64-byte K step loads, synchronises, computes.
//
// Any K % 4 == 0: the last K step stages the bytes past K as zeros in
// shared memory for both operands (the Pallas kernel padded K in device
// memory instead, pallas_gemm.py:153-158).  x rows load 16 bytes at a time
// when K % 16 == 0, else 4 (MobileNetV2's K = 24 expand).
#include <cstdint>

#include "launch.cuh"
#include "mma_tile.cuh"

namespace f8 {

template <bool kVec4, int kVecA>
__global__ void __launch_bounds__(kThreads)
    int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const int32_t* __restrict__ bias, void* __restrict__ out, int M, int N,
                     int K, int epilogue, int net, int out_signed, int relu) {
  __shared__ SmemTile s;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  Acc acc = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_a_rows<kVecA>(s, x, M, K, m0, k0);
    load_b_kn<kVec4>(s, w + static_cast<size_t>(k0) * N, N, min(kBK, K - k0), n0);
    __syncthreads();
    tile_mma(s, acc);
    __syncthreads();
  }
  store_tile(acc, m0, n0, M, N, bias, epilogue, net, out_signed != 0, relu != 0, out);
}

template <bool kVec4>
void launch_gemm(dim3 grid, cudaStream_t stream, int vec_a, const int8_t* x, const int8_t* w,
                 const int32_t* bias, void* out, int M, int N, int K, int epilogue, int net,
                 int out_signed, int relu) {
  const auto kernel = vec_a == 16 ? int8_gemm_kernel<kVec4, 16> : int8_gemm_kernel<kVec4, 4>;
  kernel<<<grid, kThreads, 0, stream>>>(x, w, bias, out, M, N, K, epilogue, net, out_signed,
                                        relu);
}

}  // namespace f8

// x: (M, K) int8, vec_a-byte aligned with K % vec_a == 0 (vec_a 16 or 4);
// w: (K, N) int8, 4-byte aligned; bias: (N,) int32; out: (M, N) int32
// (epilogue 0) or int8 (epilogue 1).
extern "C" int f8_int8_gemm(const void* x, const void* w, const void* bias, void* out, int M,
                            int N, int K, int vec_a, int epilogue, int net, int out_signed,
                            int relu, void* stream) {
  const dim3 grid((M + f8::kBM - 1) / f8::kBM, (N + f8::kBN - 1) / f8::kBN);
  // 32-bit weight loads where every row starts 4-byte aligned; a class count
  // N that is not a multiple of 4 (a 10-class bundle) takes byte loads
  const auto launch = N % 4 == 0 ? f8::launch_gemm<true> : f8::launch_gemm<false>;
  launch(grid, static_cast<cudaStream_t>(stream), vec_a, static_cast<const int8_t*>(x),
         static_cast<const int8_t*>(w), static_cast<const int32_t*>(bias), out, M, N, K,
         epilogue, net, out_signed, relu);
  return static_cast<int>(cudaGetLastError());
}
