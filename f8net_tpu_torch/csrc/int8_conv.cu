// K2: NHWC int8 KxK convolution (groups 1, stride 1 or 2) as an implicit
// GEMM on Hopper's warpgroup tensor-core product (wgmma), + int32 bias,
// optional ReLU, int32 or requant8 epilogue.
// Replaces f8net_tpu/ops/pallas_conv.py:pallas_conv_int8 (:212-344; kernel
// bodies _conv_kernel :95 and _conv_kernel_bigk :141, pallas_calls :314 and
// :332).
//
// GEMM view: rows are output pixels (M = N*OH*OW), columns output channels
// (O), reduction K = kh*kw*C in tap-major, channel-minor order -- the order
// of the HWIO weight flattened, so 16 consecutive reduction bytes are one
// (tap, 16-channel chunk) and lie contiguous in the NHWC input.
//
// What bounds it on an H100: ResNet's 3x3 convs do 2*9*C operations per
// output element against about one byte of input and one of output, far
// above the card's ~590 int8 operations per byte, so tensor-core operations
// bound it (about 0.001 ms per ResNet-18 3x3 conv at batch 8).  The design,
// against what held the mma.sync version of this kernel at 30x its bound:
//   * wgmma m64nNk32 (N = BN = 64 or 128) from shared memory, a 128-row tile
//     on two warpgroups -- the only path to the int8 tensor-core peak;
//   * weights packed once on the host into the operand's K-major chunked
//     shared-memory image (ops/conv.py:pack_conv_weight, layout in
//     wgmma_s8.cuh), so a weight stage is a straight 16-byte cp.async copy:
//     no transpose in the kernel;
//   * a kConvStages-deep ring: the copies for step i + kConvStages - 2 are in
//     flight while the tensor cores work on step i, one wgmma group stays in
//     flight across the next step's barrier;
//   * the activation gather stays implicit (no im2col in device memory):
//     16-byte cp.async per (pixel, 16-channel chunk) straight from NHWC;
//     each thread keeps its two rows' image/row/column bases from the tile's
//     start and walks the taps with adds and compares only; a border tap is
//     a plain st.shared of the packed zero pad_value (cp.async can only
//     zero-fill, and an unsigned input's packed zero is -128).  Chunks past
//     the reduction and rows past M are left as whatever the stage held:
//     their packed weights are 0, resp. their outputs are never stored;
//   * split-K where the output tiles cannot fill the SMs (ResNet's stage 3:
//     M = 392 at batch 8 is 32 tiles of 128 x 64): the planner
//     (ops/conv.py:plan_conv) splits the reduction steps across blockIdx.z,
//     and the splits of one tile form a thread-block cluster that adds its
//     partial tiles through distributed shared memory (exact: integer adds
//     mod 2^32 in any order), each block finishing a share of the tile's
//     elements; no workspace, no atomics, no second launch;
//   * the tile's biases staged in shared memory at the start: read per
//     element from global memory, they serialised the epilogue's stores.
#include <cooperative_groups.h>

#include <cstdint>

#include "launch.cuh"
#include "mma_tile.cuh"
#include "requant.cuh"
#include "wgmma_s8.cuh"

namespace f8 {

constexpr int kConvBK = 64;      // reduction bytes per stage
constexpr int kConvStages = 6;   // ring depth; copies run kConvStages - 2 steps ahead
constexpr int kChunks = kConvBK / 16;  // 16-byte k-chunks per step
constexpr int kConvBM = 128;           // output rows per block: two warpgroups of 64
constexpr int kConvThreads = 256;

struct ConvShape {
  int n, h, w, c;   // input NHWC
  int oh, ow, o;    // output spatial size and channels
  int kh, kw, stride, pad;
};

template <int BN>
constexpr int conv_smem_bytes() {
  return kConvStages * (kConvBM + BN) * kConvBK;
}

// x: NHWC input; wp: packed weights, (K_pad / 16, o_pad, 16).  With
// splits > 1 the grid's z blocks of one output tile form a thread-block
// cluster of `splits` blocks (cluster dimension (1, 1, splits)).
template <int BN>
__global__ void __launch_bounds__(kConvThreads)
    int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                     const int32_t* __restrict__ bias, void* __restrict__ out, ConvShape sh,
                     int o_pad, int ksteps, int splits, int pad_value, int epilogue, int net,
                     int out_signed, int relu) {
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ int32_t sbias[BN];
  constexpr int BM = kConvBM, kThr = kConvThreads;
  constexpr int kRowsPerThread = BM * kChunks / kThr;  // A rows each thread copies,
  constexpr int kRowStep = kThr / kChunks;             // ... this many rows apart
  constexpr int kA = BM * kConvBK, kStage = kA + BN * kConvBK;
  const int tid = threadIdx.x;
  const int M = sh.n * sh.oh * sh.ow;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int lo = static_cast<int>(static_cast<long long>(split) * ksteps / splits);
  const int nsteps = static_cast<int>(static_cast<long long>(split + 1) * ksteps / splits) - lo;
  // the tile's biases, read once and early (the epilogue reads them per
  // element; straight from global memory each read would stall it)
  if (tid < BN) sbias[tid] = n0 + tid < sh.o ? bias[n0 + tid] : 0;

  // A gather: this thread's 16-byte chunk position kc of kRowsPerThread rows
  const int kc = tid % kChunks;
  long long boff[kRowsPerThread];
  int iy0[kRowsPerThread], ix0[kRowsPerThread], soff[kRowsPerThread];
  bool mvalid[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int row = tid / kChunks + kRowStep * j;
    const int m = m0 + row;
    mvalid[j] = m < M;
    const int mm = mvalid[j] ? m : 0;
    const int img = mm / (sh.oh * sh.ow);
    const int rem = mm - img * sh.oh * sh.ow;
    const int oy = rem / sh.ow, ox = rem - (rem / sh.ow) * sh.ow;
    iy0[j] = oy * sh.stride - sh.pad;
    ix0[j] = ox * sh.stride - sh.pad;
    boff[j] = (static_cast<long long>(img) * sh.h * sh.w + static_cast<long long>(iy0[j]) * sh.w +
               ix0[j]) * sh.c;
    soff[j] = (kc * BM + row) * 16;
  }
  // tap state of chunk kc at step lo: tap (ky, kx), channel chunk cc, and
  // toff = (ky * W + kx) * C + 16 * cc, the chunk's offset from a row's base
  const int c16 = sh.c >> 4;
  int ky, kx, cc;
  {
    const int q = lo * kChunks + kc, tap = q / c16;
    cc = q - tap * c16;
    ky = tap / sh.kw;
    kx = tap - ky * sh.kw;
  }
  long long toff = (static_cast<long long>(ky) * sh.w + kx) * sh.c + 16 * cc;
  const long long row_wrap = static_cast<long long>(sh.w - sh.kw) * sh.c;
  const uint32_t pv = 0x01010101u * static_cast<uint8_t>(pad_value);
  const uint4 pad4 = make_uint4(pv, pv, pv, pv);

  // copy reduction step `s` into ring stage `st`, then advance the tap state
  auto load = [&](int s, int st) {
    int8_t* sa = smem + st * kStage;
    if (ky < sh.kh) {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        if (!mvalid[j]) continue;
        const int iy = iy0[j] + ky, ix = ix0[j] + kx;
        if (static_cast<unsigned>(iy) < static_cast<unsigned>(sh.h) &&
            static_cast<unsigned>(ix) < static_cast<unsigned>(sh.w))
          cp_async16(sa + soff[j], x + boff[j] + toff, true);
        else
          *reinterpret_cast<uint4*>(sa + soff[j]) = pad4;
      }
    }
    cc += kChunks;
    toff += 16 * kChunks;
    while (cc >= c16) {  // into the next tap: the next pixel's channels follow
      cc -= c16;
      if (++kx == sh.kw) {
        kx = 0;
        ++ky;
        toff += row_wrap;
      }
    }
    // B: chunk j of output channels n0 .. n0 + BN is one contiguous run
    int8_t* sb = sa + kA;
    const int8_t* src = wp + (static_cast<long long>(s) * kChunks * o_pad + n0) * 16;
#pragma unroll
    for (int q = 0; q < kChunks * BN / kThr; ++q) {
      const int i = tid + q * kThr, j = i / BN, r = i - j * BN;
      cp_async16(sb + i * 16, src + (static_cast<long long>(j) * o_pad + r) * 16, true);
    }
  };

  int32_t acc[BN / 2];  // set by the first wgmma (accumulate = 0): nsteps >= 1

#pragma unroll
  for (int p = 0; p < kConvStages - 2; ++p) {
    if (p < nsteps) load(lo + p, p);
    cp_async_commit();
  }
  const int wg = tid >> 7;
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<kConvStages - 3>();  // step i has landed (this thread's copies)
    fence_proxy_async();               // ... and is visible to wgmma's proxy
    __syncthreads();                   // everyone's; step i - 2's wgmma done everywhere
    const int s = i + kConvStages - 2;
    if (s < nsteps) load(lo + s, s % kConvStages);
    cp_async_commit();
    const int8_t* sa = smem + (i % kConvStages) * kStage;
    const int8_t* sb = sa + kA;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kConvBK / 32; ++kk) {
      const uint64_t da = smem_desc(sa + kk * 2 * BM * 16 + wg * 64 * 16, BM * 16, 128);
      const uint64_t db = smem_desc(sb + kk * 2 * BN * 16, BN * 16, 128);
      wgmma_s8<BN>(acc, da, db, i > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();

  __syncthreads();  // every wgmma and copy of the ring is done; sbias is in

  const int lane = tid & 31;
  const int row0 = m0 + wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  if (splits > 1) {
    // split-K: the cluster's blocks exchange their partial tiles through
    // distributed shared memory.  Each block parks its accumulators in its
    // own (now idle) ring, in fragment order; after a cluster barrier, block
    // q sums registers [q * R / splits, (q + 1) * R / splits) of every
    // thread across all blocks -- integer adds, exact in any order -- and
    // runs the epilogue on them, so each output element's epilogue runs
    // once, on the whole sum.  A second barrier keeps every block's shared
    // memory alive until the others have read it.
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    int32_t* part = reinterpret_cast<int32_t*>(smem);
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) part[r * kThr + tid] = acc[r];
    cluster.sync();
    const int q = static_cast<int>(cluster.block_rank());
    const int r_lo = q * (BN / 2) / splits, r_hi = (q + 1) * (BN / 2) / splits;
    for (int r = r_lo; r < r_hi; ++r) {
      int32_t v = 0;
      for (int k = 0; k < splits; ++k)
        v = add_wrap(v, cluster.map_shared_rank(part, k)[r * kThr + tid]);
      // register r: row row0 + 8 * ((r >> 1) & 1), column 8 * (r >> 2) + 2 * (lane % 4) + (r & 1)
      const int row = row0 + 8 * ((r >> 1) & 1);
      const int cl = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      if (row < M && n0 + cl < sh.o) {
        const int32_t y = bias_relu(v, sbias[cl], relu != 0);
        const size_t idx = static_cast<size_t>(row) * sh.o + n0 + cl;
        if (epilogue == kInt32)
          static_cast<int32_t*>(out)[idx] = y;
        else
          static_cast<int8_t*>(out)[idx] = requant8(y, net, out_signed != 0);
      }
    }
    cluster.sync();
    return;
  }

  // epilogue: walk the wgmma accumulator fragment (layout in wgmma_s8.cuh)
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cl = 8 * j + 2 * (lane & 3);
    if (n0 + cl >= sh.o) continue;  // O % 4 == 0, so col + 1 < O too
    const int32_t b0 = sbias[cl], b1 = sbias[cl + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const int32_t v0 = bias_relu(acc[4 * j + 2 * h], b0, relu != 0);
      const int32_t v1 = bias_relu(acc[4 * j + 2 * h + 1], b1, relu != 0);
      const size_t idx = static_cast<size_t>(row) * sh.o + n0 + cl;
      if (epilogue == kInt32) {
        *reinterpret_cast<int2*>(static_cast<int32_t*>(out) + idx) = make_int2(v0, v1);
      } else {
        const uint32_t q0 = static_cast<uint8_t>(requant8(v0, net, out_signed != 0));
        const uint32_t q1 = static_cast<uint8_t>(requant8(v1, net, out_signed != 0));
        *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(out) + idx) =
            static_cast<uint16_t>(q0 | (q1 << 8));
      }
    }
  }
}

template <int BN>
int launch_conv(const int8_t* x, const int8_t* wp, const int32_t* bias, void* out,
                const ConvShape& sh, int o_pad, int ksteps, int splits, int pad_value,
                int epilogue, int net, int out_signed, int relu, cudaStream_t stream) {
  // the shared-memory attribute is set once per process, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_conv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, conv_smem_bytes<BN>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long M = static_cast<long long>(sh.n) * sh.oh * sh.ow;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((M + kConvBM - 1) / kConvBM), o_pad / BN, splits);
  cfg.blockDim = dim3(kConvThreads);
  cfg.dynamicSmemBytes = conv_smem_bytes<BN>();
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, int8_conv_kernel<BN>, x, wp, bias, out, sh,
                                             o_pad, ksteps, splits, pad_value, epilogue, net,
                                             out_signed, relu);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace f8

// x: (n, h, w, c) int8, c % 16 == 0, 16-byte aligned; wp: packed weights
// (K_pad / 16, o_pad, 16) int8, K_pad = ksteps * kConvBK >= kh * kw * c,
// o_pad a multiple of bn; bias: (o,) int32; out: (n, oh, ow, o) int32
// (epilogue 0) or int8 (epilogue 1), o % 4 == 0; bn: 64 or 128; splits:
// 1 .. 8 (a cluster of that many blocks per output tile).
extern "C" int f8_int8_conv(const void* x, const void* wp, const void* bias, void* out, int n,
                            int h, int wd, int c, int oh, int ow, int o, int kh, int kw,
                            int stride, int pad, int pad_value, int epilogue, int net,
                            int out_signed, int relu, int bn, int o_pad, int ksteps, int splits,
                            void* stream) {
  const f8::ConvShape sh{n, h, wd, c, oh, ow, o, kh, kw, stride, pad};
  auto* xs = static_cast<const int8_t*>(x);
  auto* w8 = static_cast<const int8_t*>(wp);
  auto* b = static_cast<const int32_t*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (bn == 128)
    return f8::launch_conv<128>(xs, w8, b, out, sh, o_pad, ksteps, splits, pad_value, epilogue,
                                net, out_signed, relu, st);
  if (bn == 64)
    return f8::launch_conv<64>(xs, w8, b, out, sh, o_pad, ksteps, splits, pad_value, epilogue,
                               net, out_signed, relu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
