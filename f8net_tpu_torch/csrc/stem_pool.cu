// K3: the fused ResNet stem -- 7x7/s2/p3 conv over 3 packed int8 channels,
// + int32 bias, ReLU, 3x3/s2/p1 maxpool -- writing only the pooled int32
// activation (n, ph, pw, oc), oc a multiple of 64 (64 for ResNet's stem;
// 128 once IntEngine(pad_channels_to=128) pads it).
// Replaces f8net_tpu/ops/pallas_stem.py:stem_pool_int8_v2 (:252-316; body
// _stem_kernel_v2 :212, _pool_finish :171, pallas_call :292) and the v1
// stem_pool_int8 (:101; body _stem_kernel :55, pallas_call :143), which
// compute the same output.  The kernel reads the packed NHWC input directly:
// the space-to-depth bands of build_stem_inputs_v2 existed for Mosaic's
// layout rules only.
//
// What bounds it on an H100: bytes -- 3 input bytes per input pixel and 256
// output bytes per pooled pixel against 2*147 int8 operations per conv
// output, which the tensor cores do in a fraction of that time.  So the
// conv runs on tensor cores as an int8 GEMM per tile, and the conv map never
// leaves shared memory:
//   * a block owns an 8 x 8 tile of pooled outputs of one image: the 17 x 17
//     conv positions under it are the GEMM's rows (289, in 19 tiles of 16),
//     its group's 64 output channels the columns;
//   * the reduction is 7 ky rows x 32 bytes: the 7 taps of one kernel row
//     are 7 neighbouring pixels, contiguous in an input tile stored at 4
//     bytes per pixel (3 channels + 1), padded to 8 pixels.  The weights are
//     packed once on the host into that K-major layout, (oc, 7 * 32) with
//     zeros at the pad bytes (ops/stem.py:pack_stem_weight), so whatever
//     the pad bytes of the input tile hold adds nothing;
//   * mma.sync.m16n8k32 (mma_tile.cuh) rather than wgmma: wgmma's 64-row
//     operand tiles must be 8 x 16-byte core matrices in shared memory, and
//     the rows here are overlapping windows of the input tile (conv position
//     lx starts 8 bytes after lx - 1), which only register fragments loaded
//     per row can express without an im2col copy in shared memory.  With
//     the conv off the CUDA cores the kernel is bound by bytes, which is
//     where its bound lies;
//   * a block computes one 64-channel group of the output (blockIdx.y): a
//     wider stem runs one group per grid row, each reading the same input
//     tiles (3 bytes per pixel against 256 output bytes per pooled pixel
//     per group);
//   * blocks are persistent, two per SM: each walks pooled tiles with the
//     next tile's input rows in flight (4-byte cp.async of the aligned words
//     under each row) during this tile's products and pool; the 7 x 7 x 3
//     weights are staged once per block.  Border pixels are pad_value, the
//     packed zero, as in the other convs.
// Neighbouring tiles recompute their one shared conv row and column (17^2 /
// 16^2 = 1.13x).  Conv positions outside the conv map are stored as 0: after
// the ReLU every value is >= 0 and every pool window holds a real one, so a
// 0 never wins (the same argument as pallas_stem.py:23-25).
#include <algorithm>
#include <cstdint>

#include "launch.cuh"
#include "mma_tile.cuh"
#include "requant.cuh"

namespace f8 {

constexpr int kTP = 8;                  // pooled rows / cols per tile
constexpr int kTC = 2 * kTP + 1;        // conv rows / cols per tile
constexpr int kConvPos = kTC * kTC;     // conv positions per tile: GEMM rows
constexpr int kMTiles = (kConvPos + 15) / 16;
constexpr int kTI = 2 * (kTC - 1) + 7;  // input rows per tile
constexpr int kTIW = kTI + 1;           // input pixels per tile row, incl. the 8th tap
constexpr int kOC = 64;                 // output channels per block (one group)
constexpr int kSK = 7 * 32;             // packed reduction: 7 ky x 8 pixels x 4 bytes
constexpr int kWLD = kSK + 16;          // weight row stride in shared memory (bank spread)
constexpr int kCLD = kOC + 4;           // conv-map row stride in int32 (bank spread)
constexpr int kRawWords = 32;           // aligned words staged per input row
constexpr int kStemThreads = 256;
constexpr size_t kConvBytes = sizeof(int32_t) * kConvPos * kCLD;
constexpr size_t kIn4Bytes = sizeof(uint32_t) * kTI * kTIW;
constexpr size_t kWBytes = kOC * kWLD;
constexpr size_t kRawBytes = sizeof(uint32_t) * kTI * kRawWords;
constexpr size_t kStemSmem = kConvBytes + kIn4Bytes + kWBytes + 2 * kRawBytes;

struct StemShape {
  int n, h, w, oh, ow, ph, pw, tiles_x, tiles_y, oc;
};

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// first input row / col of a tile, and the image it is in
__device__ __forceinline__ void tile_origin(const StemShape& sh, int tile, int& img, int& iy0,
                                           int& ix0) {
  const int per_img = sh.tiles_x * sh.tiles_y;
  img = tile / per_img;
  const int t = tile - img * per_img;
  const int ty = t / sh.tiles_x, tx = t - ty * sh.tiles_x;
  iy0 = 2 * (2 * ty * kTP - 1) - 3;
  ix0 = 2 * (2 * tx * kTP - 1) - 3;
}

// the columns [gx_lo, gx_hi) of the tile's input rows that lie in the image
__device__ __forceinline__ void row_span(const StemShape& sh, int ix0, int& gx_lo, int& gx_hi) {
  gx_lo = max(ix0, 0);
  gx_hi = min(ix0 + kTIW, sh.w);
}

// issue the 4-byte copies of the aligned words under each in-image input
// row of `tile` into raw[row][word]
__device__ __forceinline__ void fetch_rows(const int8_t* __restrict__ x, const StemShape& sh,
                                           int tile, uint32_t* raw) {
  int img, iy0, ix0, gx_lo, gx_hi;
  tile_origin(sh, tile, img, iy0, ix0);
  row_span(sh, ix0, gx_lo, gx_hi);
  if (gx_lo >= gx_hi) return;
  for (int i = threadIdx.x; i < kTI * kRawWords; i += kStemThreads) {
    const int r = i / kRawWords, wd = i - r * kRawWords;
    const int gy = iy0 + r;
    if (gy < 0 || gy >= sh.h) continue;
    const int8_t* row = x + (static_cast<size_t>(img) * sh.h + gy) * sh.w * 3;
    const uintptr_t lo = reinterpret_cast<uintptr_t>(row + gx_lo * 3);
    const uintptr_t hi = reinterpret_cast<uintptr_t>(row + gx_hi * 3);
    const uintptr_t a = (lo & ~static_cast<uintptr_t>(3)) + 4 * static_cast<uintptr_t>(wd);
    if (a < hi) cp_async4(raw + i, reinterpret_cast<const void*>(a));
  }
}

__global__ void __launch_bounds__(kStemThreads, 2)
    stem_pool_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                     const int32_t* __restrict__ bias, int32_t* __restrict__ out, StemShape sh,
                     int pad_value) {
  extern __shared__ __align__(16) unsigned char smem[];
  // this block's 64-channel group: its weight rows, biases and output columns
  const int group = blockIdx.y;
  wp += static_cast<size_t>(group) * kOC * kSK;
  bias += group * kOC;
  out += group * kOC;
  int32_t* conv = reinterpret_cast<int32_t*>(smem);                        // [kConvPos][kCLD]
  uint32_t* in4 = reinterpret_cast<uint32_t*>(smem + kConvBytes);          // [kTI][kTIW]
  int8_t* wsm = reinterpret_cast<int8_t*>(smem + kConvBytes + kIn4Bytes);  // [kOC][kWLD]
  uint32_t* raw = reinterpret_cast<uint32_t*>(smem + kConvBytes + kIn4Bytes + kWBytes);

  const int ntiles = sh.n * sh.tiles_x * sh.tiles_y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t pad_word = 0x01010101u * static_cast<uint8_t>(pad_value);

  for (int i = tid; i < kOC * (kSK / 16); i += kStemThreads) {
    const int o = i / (kSK / 16), ch = i - o * (kSK / 16);
    cp_async16(wsm + o * kWLD + ch * 16, wp + o * kSK + ch * 16, true);
  }
  if (static_cast<int>(blockIdx.x) < ntiles) fetch_rows(x, sh, blockIdx.x, raw);
  cp_async_commit();

  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();
    // unpack the staged rows to 4 bytes per pixel, pad_value outside the image
    int img, iy0, ix0, gx_lo, gx_hi;
    tile_origin(sh, tile, img, iy0, ix0);
    row_span(sh, ix0, gx_lo, gx_hi);
    const uint32_t* rb = raw + buf * kTI * kRawWords;
    for (int i = tid; i < kTI * kTIW; i += kStemThreads) {
      const int r = i / kTIW, cx = i - r * kTIW;
      const int gy = iy0 + r, gx = ix0 + cx;
      uint32_t v = pad_word;
      if (gy >= 0 && gy < sh.h && gx >= 0 && gx < sh.w) {
        const int8_t* row = x + (static_cast<size_t>(img) * sh.h + gy) * sh.w * 3;
        const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(row + gx_lo * 3) & 3);
        const uint8_t* bytes = reinterpret_cast<const uint8_t*>(rb + r * kRawWords);
        const int b = shift + (gx - gx_lo) * 3;
        v = static_cast<uint32_t>(bytes[b]) | (static_cast<uint32_t>(bytes[b + 1]) << 8) |
            (static_cast<uint32_t>(bytes[b + 2]) << 16);
      }
      in4[i] = v;
    }
    __syncthreads();
    if (tile + gridDim.x < ntiles) fetch_rows(x, sh, tile + gridDim.x, raw + (buf ^ 1) * kTI * kRawWords);
    cp_async_commit();

    // conv + bias + ReLU on tensor cores: warp unit u = (16-row tile, 32
    // channels); conv position p = ly * kTC + lx reads input row 2 ly + ky,
    // pixels 2 lx .. 2 lx + 7
    const int pool_y0 = (tile % (sh.tiles_x * sh.tiles_y)) / sh.tiles_x * kTP;
    const int pool_x0 = (tile % sh.tiles_x) * kTP;
    const int cy0 = 2 * pool_y0 - 1, cx0 = 2 * pool_x0 - 1;
    for (int u = warp; u < 2 * kMTiles; u += kStemThreads / 32) {
      const int mt = u >> 1, nb = (u & 1) * 32;
      const int p0 = min(mt * 16 + g, kConvPos - 1), p1 = min(mt * 16 + g + 8, kConvPos - 1);
      const int8_t* a0 = reinterpret_cast<const int8_t*>(
          in4 + 2 * (p0 / kTC) * kTIW + 2 * (p0 % kTC)) + 4 * t;
      const int8_t* a1 = reinterpret_cast<const int8_t*>(
          in4 + 2 * (p1 / kTC) * kTIW + 2 * (p1 % kTC)) + 4 * t;
      int32_t acc[4][4] = {};
#pragma unroll
      for (int ky = 0; ky < 7; ++ky) {
        const int ro = ky * kTIW * 4;
        const uint32_t af[4] = {lds32(a0 + ro), lds32(a1 + ro), lds32(a0 + ro + 16),
                                lds32(a1 + ro + 16)};
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int8_t* bp = wsm + (nb + ni * 8 + g) * kWLD + ky * 32 + 4 * t;
          const uint32_t bf[2] = {lds32(bp), lds32(bp + 16)};
          mma_s8(acc[ni], af, bf);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = mt * 16 + g + 8 * hh;
        if (p >= kConvPos) continue;
        const int ly = p / kTC, lx = p - ly * kTC;
        const int cy = cy0 + ly, cx = cx0 + lx;
        const bool inside = cy >= 0 && cy < sh.oh && cx >= 0 && cx < sh.ow;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = nb + ni * 8 + 2 * t;
          int2 v = make_int2(0, 0);
          if (inside) {
            v.x = bias_relu(acc[ni][2 * hh], bias[col], true);
            v.y = bias_relu(acc[ni][2 * hh + 1], bias[col + 1], true);
          }
          *reinterpret_cast<int2*>(conv + p * kCLD + col) = v;
        }
      }
    }
    __syncthreads();

    // 3x3/s2 maxpool: pooled (py, px) covers local conv rows / cols
    // 2*(py-py0) .. 2*(py-py0)+2; thread = one channel of a quarter of them
    const int o = tid & (kOC - 1);
    for (int q = tid / kOC; q < kTP * kTP; q += kStemThreads / kOC) {
      const int qy = q / kTP, qx = q % kTP;
      const int py = pool_y0 + qy, px = pool_x0 + qx;
      if (py >= sh.ph || px >= sh.pw) continue;
      int32_t m = 0;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          m = max(m, conv[((2 * qy + dy) * kTC + 2 * qx + dx) * kCLD + o]);
      out[((static_cast<size_t>(img) * sh.ph + py) * sh.pw + px) * sh.oc + o] = m;
    }
  }
}

}  // namespace f8

// x: (n, h, wd, 3) int8; wp: (oc, 224) int8, the packed weights
// (ops/stem.py:pack_stem_weight); bias: (oc,) int32 (already holding the
// zero-point compensation); out: (n, ph, pw, oc) int32; oc % 64 == 0.
extern "C" int f8_stem_pool(const void* x, const void* wp, const void* bias, void* out, int n,
                            int h, int wd, int oh, int ow, int ph, int pw, int oc, int pad_value,
                            void* stream) {
  // set once per process: the shared-memory attribute and the grid of
  // resident blocks it allows
  static int grid_max = 0;
  static const cudaError_t init = [] {
    cudaError_t e = cudaFuncSetAttribute(f8::stem_pool_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(f8::kStemSmem));
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f8::stem_pool_kernel,
                                                        f8::kStemThreads, f8::kStemSmem);
    grid_max = sms * per_sm;
    return e;
  }();
  if (init != cudaSuccess) return static_cast<int>(init);
  if (grid_max < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (oc < f8::kOC || oc % f8::kOC) return static_cast<int>(cudaErrorInvalidValue);
  const f8::StemShape sh{n, h, wd, oh, ow, ph, pw, (pw + f8::kTP - 1) / f8::kTP,
                         (ph + f8::kTP - 1) / f8::kTP, oc};
  const int ntiles = n * sh.tiles_x * sh.tiles_y;
  const int groups = oc / f8::kOC;  // grid rows; all groups' blocks resident at once
  const dim3 grid(std::min(ntiles, std::max(grid_max / groups, 1)), groups);
  f8::stem_pool_kernel<<<grid, f8::kStemThreads, f8::kStemSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wp),
      static_cast<const int32_t*>(bias), static_cast<int32_t*>(out), sh, pad_value);
  return static_cast<int>(cudaGetLastError());
}
