// K6: stride-1 odd kxk int8 convolution on the flat padded raster, + int32
// bias, optional ReLU, int32 or requant8 epilogue, pad-ring mask.
// Replaces f8net_tpu/ops/pallas_conv_flat.py:conv_flat_int8 (:130-241;
// kernel body _flat_kernel :56, pallas_call :221).
//
// The activation is a flat (M, C) int8 matrix whose rows are the spatially
// padded image raster, M = n * h2 * w2, with the layer's packed zero in the
// pad ring.  Tap (dy, dx) of output row m reads row m + (dy - p) * w2 +
// (dx - p); rows outside [0, M) read 0 (the TPU kernel's zero lead and tail
// pads).  So the conv is kh*kw row-shifted GEMMs.  With mask_pad, output
// rows on the pad ring are set to mask_value -- the consumer's packed zero
// -- so a chain of stride-1 convs runs from flat raster to flat raster with
// nothing between them.  Without it they keep what their windows compute,
// across image boundaries.
//
// Design: one block owns 64 consecutive output rows x 64 output channels
// (mma_tile.cuh's 4-warp tile).  For each 64-channel slice it stages the
// rows [m0 - H, m0 + 64 + H) once in shared memory (H = p * w2 + p, 59 at
// 56x56 with p = 1), then runs the kh*kw taps as mma.sync tiles whose A
// operand is that staging buffer shifted by the tap's row offset, against
// the tap's (C, O) weight slice staged transposed per tap.  The ring mask
// comes from m % w2 and (m / w2) % h2 in the epilogue.
//
// What bounds it on an H100: ResNet-50's 3x3 convs do 2*9*C operations per
// output element against about 2 bytes (int8 in and out; 5 with an int32
// output), far above the card's ~590 int8 operations per byte, so
// tensor-core operations bound it.  Each block reads (64 + 2H) / 64 times
// its share of rows from L2 (2.8x at 56x56) and synchronises twice per
// (slice, tap) step with no copy in flight: a first version, right before
// fast.
#include <cstdint>

#include "launch.cuh"
#include "mma_tile.cuh"

namespace f8 {

struct FlatShape {
  int M, C, O;  // rows, input and output channels
  int h2, w2;   // padded raster
  int k, p, H;  // kernel size, pad (k - 1) / 2, row reach p * w2 + p
};

inline int conv_flat_smem(const FlatShape& sh) { return (kBN + kBM + 2 * sh.H) * kLDS; }

__global__ void __launch_bounds__(kThreads)
    conv_flat_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const int32_t* __restrict__ bias, void* __restrict__ out, FlatShape sh,
                     int epilogue, int net, int out_signed, int relu, int mask_pad,
                     int mask_value) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sb = smem;               // the tap's weights, kBN x kLDS
  int8_t* sx = smem + kBN * kLDS;  // rows m0 - H .. m0 + kBM + H, kLDS each
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int rows = kBM + 2 * sh.H;

  Acc acc;
  zero_acc(acc);
  for (int c0 = 0; c0 < sh.C; c0 += kBK) {
    // the previous slice's last tap ended in a barrier, so sx is free
    for (int q = threadIdx.x; q < rows * (kBK / 16); q += kThreads) {
      const int r = q >> 2, kc = (q & 3) * 16;
      const int m = m0 - sh.H + r, c = c0 + kc;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m >= 0 && m < sh.M && c < sh.C)
        v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * sh.C + c);
      *reinterpret_cast<uint4*>(sx + r * kLDS + kc) = v;
    }
    for (int dy = 0; dy < sh.k; ++dy)
      for (int dx = 0; dx < sh.k; ++dx) {
        const int off = (dy - sh.p) * sh.w2 + (dx - sh.p);
        const int8_t* wt = w + (static_cast<size_t>(dy * sh.k + dx) * sh.C + c0) * sh.O;
        load_b_kn<true>(sb, wt, sh.O, min(kBK, sh.C - c0), n0);
        __syncthreads();
        tile_mma_ptr(sx + (sh.H + off) * kLDS, kLDS, sb, kLDS, acc);
        __syncthreads();
      }
  }

  const bool requant = epilogue == kRequant8;
  for_each_acc(acc, [&](int r, int c, int32_t a) {
    const int m = m0 + r, col = n0 + c;
    if (m >= sh.M || col >= sh.O) return;
    bool ring = false;
    if (mask_pad) {
      const int cx = m % sh.w2, ry = (m / sh.w2) % sh.h2;
      ring = cx < sh.p || cx >= sh.w2 - sh.p || ry < sh.p || ry >= sh.h2 - sh.p;
    }
    const int32_t v = bias_relu(a, bias[col], relu != 0);
    const size_t idx = static_cast<size_t>(m) * sh.O + col;
    if (requant)
      static_cast<int8_t*>(out)[idx] =
          ring ? static_cast<int8_t>(mask_value) : requant8(v, net, out_signed != 0);
    else
      static_cast<int32_t*>(out)[idx] = ring ? mask_value : v;
  });
}

}  // namespace f8

// x: (M, c) int8, M = n * h2 * w2, c % 16 == 0, 16-byte aligned; w: (k, k,
// c, o) int8, k odd, o % 4 == 0, 4-byte aligned; bias: (o,) int32; out:
// (M, o) int32 (epilogue 0) or int8 (epilogue 1).  mask_value must fit the
// output type.  Returns cudaErrorInvalidValue when the staged rows do not
// fit one block's shared memory.
extern "C" int f8_conv_flat(const void* x, const void* w, const void* bias, void* out, int M,
                            int c, int o, int h2, int w2, int k, int epilogue, int net,
                            int out_signed, int relu, int mask_pad, int mask_value,
                            void* stream) {
  const int p = (k - 1) / 2;
  const f8::FlatShape sh{M, c, o, h2, w2, k, p, p * w2 + p};
  const int smem = f8::conv_flat_smem(sh);
  if (smem > f8::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      f8::conv_flat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + f8::kBM - 1) / f8::kBM, (o + f8::kBN - 1) / f8::kBN);
  f8::conv_flat_kernel<<<grid, f8::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), out, sh, epilogue, net, out_signed, relu, mask_pad,
      mask_value);
  return static_cast<int>(cudaGetLastError());
}
