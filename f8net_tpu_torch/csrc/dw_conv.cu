// K4: NHWC int8 depthwise KxK convolution (square odd kernel, stride 1 or 2),
// + int32 bias, optional ReLU, int32 or requant8 epilogue.
//   y[n, oy, ox, c] = epi(sum_{ky,kx} x[n, oy*s - p + ky, ox*s - p + kx, c]
//                                    * w[ky, kx, 0, c] + bias[c])
// Replaces f8net_tpu/ops/pallas_dw.py:pallas_depthwise_int8 (:112-230;
// kernel body _dw_kernel :49-93, pallas_call :200).  The Pallas kernel
// compiled only at stride 1 (pallas_dw.py:143-148); this one takes stride 2
// too, so every MobileNet depthwise layer runs on it.
//
// What bounds it on an H100: bytes.  There is no contraction across
// channels, so the tensor cores have nothing to do: 2 * k*k operations per
// output element against one byte of input and one (requant8) or four
// (int32) bytes of output, far below the card's ~590 int8 operations per
// byte.  Design: one thread takes a 16-byte channel slice of one output
// pixel and runs its k*k taps as int32 multiply-adds on the CUDA cores; the
// 16-byte loads of neighbouring threads cover neighbouring slices, so a warp
// reads whole pixel rows.  A block holds up to 32 slices (512 channels) of
// up to 128 / slices pixels, and stages those slices' weights and biases in
// shared memory once.  Each input byte is read by up to k*k threads; those
// re-reads are served by L1 and L2, not by a halo tile in shared memory (a
// later PR's work if PERF.md shows the kernel far from its bound).  Border
// taps read `pad_value`, the packed zero, so the colsum bias stays exact.
#include <cstdint>

#include "launch.cuh"
#include "requant.cuh"

namespace f8 {

constexpr int kDwThreads = 128;
constexpr int kDwMaxSlices = 32;

struct DwShape {
  int n, h, w, c;  // input NHWC
  int oh, ow;      // output spatial size
  int k, stride, pad;
};

__device__ __forceinline__ void mac16(int32_t (&acc)[16], const uint4& xv, const uint4& wv) {
  const uint32_t xs[4] = {xv.x, xv.y, xv.z, xv.w};
  const uint32_t ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      acc[4 * i + b] += static_cast<int32_t>(static_cast<int8_t>(xs[i] >> (8 * b))) *
                        static_cast<int32_t>(static_cast<int8_t>(ws[i] >> (8 * b)));
}

// blockDim = (slices per block, pixels per block); grid = (pixel groups,
// slice groups).  Dynamic shared memory: k*k*slices uint4 weights, then
// 16*slices int32 biases.
__global__ void __launch_bounds__(kDwThreads)
    dw_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const int32_t* __restrict__ bias, void* __restrict__ out, DwShape sh,
                   int pad_value, int epilogue, int net, int out_signed, int relu) {
  extern __shared__ uint4 dw_smem[];
  const int S = sh.c / 16, sb = blockDim.x, taps = sh.k * sh.k;
  const int s0 = blockIdx.y * sb;
  uint4* ws = dw_smem;                                         // [taps][sb]
  int32_t* bs = reinterpret_cast<int32_t*>(dw_smem + taps * sb);  // [sb * 16]
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < taps * sb; i += nthreads) {
    const int tap = i / sb, sl = s0 + i % sb;
    const int8_t* src = w + static_cast<size_t>(tap) * sh.c + sl * 16;
    ws[i] = sl < S ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
  }
  for (int i = tid; i < sb * 16; i += nthreads) bs[i] = s0 * 16 + i < sh.c ? bias[s0 * 16 + i] : 0;
  __syncthreads();

  const int s = s0 + threadIdx.x;
  const long long pix = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (s >= S || pix >= static_cast<long long>(sh.n) * sh.oh * sh.ow) return;
  const int img = static_cast<int>(pix / (sh.oh * sh.ow));
  const int rem = static_cast<int>(pix - static_cast<long long>(img) * sh.oh * sh.ow);
  const int oy = rem / sh.ow, ox = rem - (rem / sh.ow) * sh.ow;
  const int8_t* xs = x + static_cast<size_t>(img) * sh.h * sh.w * sh.c + s * 16;
  const uint32_t pv = 0x01010101u * static_cast<uint8_t>(pad_value);
  const uint4 pad4 = make_uint4(pv, pv, pv, pv);

  int32_t acc[16] = {};
  for (int ky = 0; ky < sh.k; ++ky) {
    const int iy = oy * sh.stride - sh.pad + ky;
    const bool row_ok = iy >= 0 && iy < sh.h;
    for (int kx = 0; kx < sh.k; ++kx) {
      const int ix = ox * sh.stride - sh.pad + kx;
      const uint4 xv = row_ok && ix >= 0 && ix < sh.w
                           ? *reinterpret_cast<const uint4*>(
                                 xs + (static_cast<size_t>(iy) * sh.w + ix) * sh.c)
                           : pad4;
      mac16(acc, xv, ws[(ky * sh.k + kx) * sb + threadIdx.x]);
    }
  }

  const size_t o = static_cast<size_t>(pix) * sh.c + s * 16;
  const int32_t* b = bs + threadIdx.x * 16;
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = bias_relu(acc[j], b[j], relu != 0);
  if (epilogue == kInt32) {
    int4* dst = reinterpret_cast<int4*>(static_cast<int32_t*>(out) + o);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dst[q] = make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  } else {
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int8_t q = requant8(acc[j], net, out_signed != 0);
      packed[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(q)) << (8 * (j % 4));
    }
    *reinterpret_cast<uint4*>(static_cast<int8_t*>(out) + o) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

}  // namespace f8

// x: (n, h, w, c) int8, c % 16 == 0, 16-byte aligned; w: (k, k, 1, c) int8,
// 16-byte aligned, k odd <= 9; bias: (c,) int32; out: (n, oh, ow, c) int32
// (epilogue 0) or int8 (epilogue 1).
extern "C" int f8_dw_conv(const void* x, const void* w, const void* bias, void* out, int n, int h,
                          int wd, int c, int oh, int ow, int k, int stride, int pad,
                          int pad_value, int epilogue, int net, int out_signed, int relu,
                          void* stream) {
  const f8::DwShape sh{n, h, wd, c, oh, ow, k, stride, pad};
  const int S = c / 16;
  const int sb = S < f8::kDwMaxSlices ? S : f8::kDwMaxSlices;
  const int pb = f8::kDwThreads / sb;
  const long long npix = static_cast<long long>(n) * oh * ow;
  const dim3 block(sb, pb);
  const dim3 grid(static_cast<unsigned>((npix + pb - 1) / pb), (S + sb - 1) / sb);
  const size_t smem = static_cast<size_t>(k) * k * sb * 16 + sb * 16 * sizeof(int32_t);
  f8::dw_conv_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), out, sh, pad_value, epilogue, net, out_signed, relu);
  return static_cast<int>(cudaGetLastError());
}
