// K4: NHWC int8 depthwise KxK convolution (square odd kernel, stride 1 or 2),
// + int32 bias, optional ReLU, int32 or requant8 epilogue.
//   y[n, oy, ox, c] = epi(sum_{ky,kx} x[n, oy*s - p + ky, ox*s - p + kx, c]
//                                    * w[ky, kx, 0, c] + bias[c])
// Replaces f8net_tpu/ops/pallas_dw.py:pallas_depthwise_int8 (:112-230;
// kernel body _dw_kernel :49-93, pallas_call :200).  The Pallas kernel
// compiled only at stride 1 (pallas_dw.py:143-148); this one takes stride 2
// too, so every MobileNet depthwise layer runs on it.
//
// What bounds it on an H100: bytes, and close behind them the CUDA cores.
// There is no contraction across channels, so the tensor cores have nothing
// to do: k*k multiply-adds per output element against one input and one
// (requant8) or four (int32) output bytes.  MobileNetV2's five calls at
// batch 8 move 7.65 us worth of bytes and make 63 M multiply-adds; at 2-3
// integer instructions per multiply-add the CUDA cores alone would need
// 8-11 us.  The first design (one thread per 16-byte channel slice of one
// pixel, k*k global loads each, re-reads left to L1, a byte extract and a
// multiply per tap) ran at 5.8x the bytes bound.  This design cuts both the
// traffic and the instructions:
//   * a halo tile in shared memory: a block step owns th x tw output pixels
//     x cb channels and copies the ((th-1)s+k) x ((tw-R)s+npx) input halo
//     once, with 16-byte cp.async, writing every cell outside the image
//     itself with pad_value -- the packed zero, -128 for an unsigned input,
//     which neither cp.async's zero fill nor TMA's out-of-bounds fill can
//     produce, and which the colsum bias needs on every border tap;
//   * register reuse along x: a thread computes a run of R adjacent output
//     pixels (R = 8 at stride 1, 4 at stride 2) for 4 channels, reading
//     each halo pixel of its window once per row (npx words) instead of
//     k per output;
//   * four taps per instruction: a 4 x 4 byte transpose (6 byte permutes)
//     turns 4 pixels x 4 channels into 4 words of 4 horizontal pixels of one
//     channel, the weights of a row the same way into words of 4 taps (zero
//     past k), and __dp4a sums 4 taps of one channel at once -- k * ceil(k/4)
//     dp4a per output element, the window shifted by one byte permute;
//   * a persistent grid with two halo buffers: the next tile's copies fly
//     while this tile's multiply-adds run;
//   * tiles shaped per call by the host planner (ops/dw.py:plan_dw): wide
//     pixel tiles where channels are few (112x112 x 32), wide channel
//     blocks where pixels are few (7x7 x 576), and a halo row stride padded
//     so that a warp's reads spread over the banks.
#include <cstdint>

#include "launch.cuh"
#include "requant.cuh"

namespace f8 {

constexpr int kDwMaxThreads = 512;

template <int S>
__host__ __device__ constexpr int dw_run() {
  return S == 1 ? 8 : 4;
}

// input pixels per halo row a thread reads: its run's window, widened so
// that every 4-tap weight word's window lies inside (ops/dw.py:dw_npx)
template <int KS, int S>
__host__ __device__ constexpr int dw_npx() {
  return ((dw_run<S>() - 1) * S + (KS + 3) / 4 * 4 + 3) / 4 * 4;
}

struct DwArgs {
  int n, h, w, c, oh, ow, pad;
  int th, tw, cb, rowb;  // tile and halo row stride (bytes)
  int ty, tx, cg, tiles;
  // ceil(2^16 / d), d = cb / 16 <= 8: r / d == (r * cpp_magic) >> 16 for r < 2^13,
  // since cpp_magic * d - 2^16 = e < d and r * e < 2^16
  uint32_t cpp_magic;
  int pad_value, epilogue, net, out_signed, relu;
};

__device__ __forceinline__ void dw_cp16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// r[i] holds 4 bytes (channels, or taps) of row i; afterwards r[j] holds
// byte j of each of the 4 rows
__device__ __forceinline__ void transpose4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140), hi01 = __byte_perm(r0, r1, 0x7362);
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140), hi23 = __byte_perm(r2, r3, 0x7362);
  r0 = __byte_perm(lo01, lo23, 0x5410);
  r1 = __byte_perm(lo01, lo23, 0x7632);
  r2 = __byte_perm(hi01, hi23, 0x5410);
  r3 = __byte_perm(hi01, hi23, 0x7632);
}

// bytes P .. P+3 of a channel's row of pixels held 4 to a word (P is a
// compile-time constant once the callers' loops unroll)
template <int NW>
__device__ __forceinline__ uint32_t window(const uint32_t (&q)[NW], int P) {
  const int i = P >> 2, sh = P & 3;
  if (sh == 0) return q[i];
  return __byte_perm(q[i], q[i + 1], (sh) | ((sh + 1) << 4) | ((sh + 2) << 8) | ((sh + 3) << 12));
}

// one block: threads = (cb / 4) channel quads x th output rows x tw / R
// runs; lane -> quad, then row, then run.  Dynamic shared memory: two halos
// of ih rows x rowb bytes.
template <int KS, int S>
__global__ void __launch_bounds__(kDwMaxThreads)
    dw_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const int32_t* __restrict__ bias, void* __restrict__ out, DwArgs a) {
  constexpr int R = dw_run<S>(), NPX = dw_npx<KS, S>(), KW = (KS + 3) / 4;
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int ih = (a.th - 1) * S + KS, iwp = (a.tw - R) * S + NPX;
  const int halo = ih * a.rowb;
  const int Q = a.cb / 4;
  const int q = tid % Q, run = tid / Q, ry = run % a.th, rx = run / a.th;
  const uint32_t pv = 0x01010101u * static_cast<uint8_t>(a.pad_value);
  const Epilogue8 epi(a.net, a.out_signed != 0, a.relu != 0);
  const int ntile = static_cast<int>(blockIdx.x) < a.tiles
                        ? (a.tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1
                        : 0;
  // tile t -> (image, tile row, tile column, channel block), channel block fastest
  auto decode = [&](int t, int& img, int& oy0, int& ox0, int& c0) {
    const int cgi = t % a.cg;
    t /= a.cg;
    const int txi = t % a.tx;
    t /= a.tx;
    img = t / a.ty;
    oy0 = (t % a.ty) * a.th;
    ox0 = txi * a.tw;
    c0 = cgi * a.cb;
  };
  // tile j's halo into buffer j & 1: thread r of a halo row takes 16-byte
  // chunk r of every row (a pixel's cb bytes are cb / 16 chunks), so its
  // column and channel offsets are worked out once per tile, not per chunk
  auto issue = [&](int j) {
    int img, oy0, ox0, c0;
    decode(static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x), img, oy0, ox0, c0);
    const int iy0 = oy0 * S - a.pad, ix0 = ox0 * S - a.pad;
    int8_t* buf = smem + (j & 1) * halo;
    const int cpp = a.cb >> 4;
    const size_t pitch = static_cast<size_t>(a.w) * a.c;  // bytes per input row
    for (int r = tid; r < iwp * cpp; r += nthreads) {
      const int hx = static_cast<int>((static_cast<uint32_t>(r) * a.cpp_magic) >> 16);
      const int ch = r - hx * cpp, ix = ix0 + hx;
      const bool xin = ix >= 0 && ix < a.w;
      int8_t* dst = buf + hx * a.cb + ch * 16;
      const int8_t* src = x + static_cast<size_t>(img) * a.h * pitch +
                          static_cast<size_t>(xin ? ix : 0) * a.c + c0 + ch * 16;
      for (int hy = 0, iy = iy0; hy < ih; ++hy, ++iy, dst += a.rowb) {
        if (xin && iy >= 0 && iy < a.h)
          dw_cp16(dst, src + static_cast<size_t>(iy) * pitch);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(pv, pv, pv, pv);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (ntile > 0) issue(0);
  for (int j = 0; j < ntile; ++j) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile j's halo is in; every thread is done with the other buffer
    if (j + 1 < ntile) issue(j + 1);
    int img, oy0, ox0, c0;
    decode(static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x), img, oy0, ox0, c0);
    const int oy = oy0 + ry, ox = ox0 + rx * R, c = c0 + 4 * q;
    if (oy >= a.oh || ox >= a.ow) continue;
    const int8_t* hrow = smem + (j & 1) * halo + ry * S * a.rowb + rx * R * S * a.cb + 4 * q;
    int32_t acc[4][R];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
#pragma unroll
      for (int o = 0; o < R; ++o) acc[ch][o] = 0;
#pragma unroll
    for (int ky = 0; ky < KS; ++ky) {
      // weights of row ky for channels c .. c+3, as words of 4 taps per channel
      uint32_t wt[4][KW];
#pragma unroll
      for (int jw = 0; jw < KW; ++jw) {
        uint32_t r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kx = 4 * jw + i;
          r[i] = kx < KS ? __ldg(reinterpret_cast<const uint32_t*>(
                               w + static_cast<size_t>(ky * KS + kx) * a.c + c))
                         : 0u;
        }
        transpose4(r[0], r[1], r[2], r[3]);
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) wt[ch][jw] = r[ch];
      }
      // the run's window of halo row ry * S + ky, as words of 4 pixels per channel
      const int8_t* src = hrow + ky * a.rowb;
      uint32_t xc[4][NPX / 4];
#pragma unroll
      for (int b = 0; b < NPX / 4; ++b) {
        uint32_t r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = *reinterpret_cast<const uint32_t*>(src + (4 * b + i) * a.cb);
        transpose4(r[0], r[1], r[2], r[3]);
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) xc[ch][b] = r[ch];
      }
#pragma unroll
      for (int o = 0; o < R; ++o)
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
#pragma unroll
          for (int jw = 0; jw < KW; ++jw)
            acc[ch][o] = __dp4a(static_cast<int>(window(xc[ch], o * S + 4 * jw)),
                                static_cast<int>(wt[ch][jw]), acc[ch][o]);
    }
    int32_t b[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) b[ch] = __ldg(bias + c + ch);
    const size_t row0 = (static_cast<size_t>(img) * a.oh + oy) * a.ow;
#pragma unroll
    for (int o = 0; o < R; ++o) {
      if (ox + o >= a.ow) break;
      const size_t idx = (row0 + ox + o) * a.c + c;
      if (a.epilogue == kInt32)
        *reinterpret_cast<int4*>(static_cast<int32_t*>(out) + idx) =
            make_int4(epi.int32(acc[0][o], b[0]), epi.int32(acc[1][o], b[1]),
                      epi.int32(acc[2][o], b[2]), epi.int32(acc[3][o], b[3]));
      else
        *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + idx) =
            pack4(epi.byte(acc[0][o], b[0]), epi.byte(acc[1][o], b[1]), epi.byte(acc[2][o], b[2]),
                  epi.byte(acc[3][o], b[3]));
    }
  }
}

template <int KS, int S>
int launch_dw(int grid, int threads, size_t smem, cudaStream_t stream, const int8_t* x,
              const int8_t* w, const int32_t* bias, void* out, const DwArgs& a) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dw_conv_kernel<KS, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dw_conv_kernel<KS, S><<<grid, threads, smem, stream>>>(x, w, bias, out, a);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_dw_k(int k, int grid, int threads, size_t smem, cudaStream_t st, const int8_t* x,
                const int8_t* w, const int32_t* bias, void* out, const DwArgs& a) {
  switch (k) {
    case 1: return launch_dw<1, S>(grid, threads, smem, st, x, w, bias, out, a);
    case 3: return launch_dw<3, S>(grid, threads, smem, st, x, w, bias, out, a);
    case 5: return launch_dw<5, S>(grid, threads, smem, st, x, w, bias, out, a);
    case 7: return launch_dw<7, S>(grid, threads, smem, st, x, w, bias, out, a);
    case 9: return launch_dw<9, S>(grid, threads, smem, st, x, w, bias, out, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace f8

// x: (n, h, w, c) int8, c % 16 == 0, 16-byte aligned; w: (k, k, 1, c) int8,
// 4-byte aligned, k odd <= 9; bias: (c,) int32; out: (n, oh, ow, c) int32
// (epilogue 0) or int8 (epilogue 1).  Plan (ops/dw.py:plan_dw): tiles of th
// x tw output pixels (tw a multiple of the run: 8 at stride 1, 4 at stride
// 2) x cb channels (cb % 16 == 0, at most 128, dividing c), halo rows of
// rowb bytes, grid persistent blocks.
extern "C" int f8_dw_conv(const void* x, const void* w, const void* bias, void* out, int n, int h,
                          int wd, int c, int oh, int ow, int k, int stride, int pad, int th,
                          int tw, int cb, int rowb, int grid, int pad_value, int epilogue,
                          int net, int out_signed, int relu, void* stream) {
  const int r = stride == 1 ? 8 : 4;
  if ((stride != 1 && stride != 2) || k < 1 || k > 9 || k % 2 == 0 || cb < 16 || cb > 128 ||
      cb % 16 != 0 || c % cb != 0 || th < 1 || tw < r || tw % r != 0 || rowb % 16 != 0 ||
      grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int npx = ((r - 1) * stride + (k + 3) / 4 * 4 + 3) / 4 * 4;
  const int iwp = (tw - r) * stride + npx, ih = (th - 1) * stride + k;
  const int threads = cb / 4 * th * (tw / r);
  const size_t smem = 2 * static_cast<size_t>(ih) * rowb;
  if (rowb < iwp * cb || threads > f8::kDwMaxThreads || smem > 232448 || iwp * cb / 16 > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ty = (oh + th - 1) / th, tx = (ow + tw - 1) / tw, cg = c / cb;
  const uint32_t magic = (65536u + cb / 16 - 1) / (cb / 16);
  const f8::DwArgs a{n,     h,         wd,       c,   oh,         ow,  pad,  th, tw, cb, rowb, ty,
                     tx,    cg,        n * ty * tx * cg, magic, pad_value, epilogue, net, out_signed, relu};
  auto* xs = static_cast<const int8_t*>(x);
  auto* ws = static_cast<const int8_t*>(w);
  auto* b = static_cast<const int32_t*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  return stride == 1 ? f8::launch_dw_k<1>(k, grid, threads, smem, st, xs, ws, b, out, a)
                     : f8::launch_dw_k<2>(k, grid, threads, smem, st, xs, ws, b, out, a);
}
