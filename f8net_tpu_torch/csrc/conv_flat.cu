// K6: stride-1 odd kxk int8 convolution on the flat padded raster, + int32
// bias, optional ReLU, int32 or requant8 epilogue, pad-ring mask.
// Replaces f8net_tpu/ops/pallas_conv_flat.py:conv_flat_int8 (:130-241;
// kernel body _flat_kernel :52, pallas_call :221).
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
// What bounds it on an H100: ResNet's 3x3 convs do 2*9*C operations per
// output row and channel against about 2 bytes (int8 in and out; 5 with an
// int32 output), far above the card's ~590 int8 operations per byte, so
// tensor-core operations bound it: 1-2 us a call at batch 8, where the
// launch, the first copies' latency and the last tile's epilogue weigh as
// much as the products.  The design:
//   * wgmma m64nBNk32 (BN = 64 or 128, wgmma_s8.cuh) on 128-row output
//     tiles, two consumer warpgroups of 64 rows -- the only path to the int8
//     tensor-core rate (the mma.sync version reached under 4% of its bound);
//   * one staged halo per 64-byte channel slice serves all k*k taps: the
//     consumers copy rows [m0 - H, m0 + 128 + H) of the slice (H = p*w2 + p)
//     with cp.async into wgmma's unswizzled K-major chunk layout, R = 128 +
//     2H rows per 16-byte chunk; tap (dy, dx) is the same buffer read through
//     a descriptor whose start moves by (H + (dy - p)*w2 + (dx - p)) rows of
//     16 bytes, a step the unswizzled layout takes (a swizzled one does not
//     take an arbitrary row shift).  Rows outside [0, M) and channels past C
//     are zero-filled (0, not the packed zero: the raster's own ring holds
//     that).  One halo buffer, refilled at each slice boundary once the last
//     slice's products are done everywhere; the weight ring runs across that
//     boundary, so the next slice's B stages are already in flight.  A
//     second buffer prefetching the next slice's halo bought nothing
//     measurable at ResNet's calls on an H100, and would nearly halve the
//     widest raster that fits;
//   * weights packed once on the host into K2's operand image
//     (ops/conv.py:pack_conv_weight; K6's reduction order, tap-major and
//     channel-minor, is K2's), so the B operand of (tap t, slice s, column
//     tile) is four 16-byte k-chunks starting at chunk (t*C + 64 s) / 16,
//     each one contiguous run of BN x 16 bytes: no transpose in the kernel.
//     Where C % 64 != 0 the last slice's chunks reach into tap t + 1's
//     weights; the zero-filled channels of the halo cancel them;
//   * a producer warp keeps a kFlatStages-deep ring of those B stages in
//     flight behind full/empty mbarriers, each stage four 1-D bulk copies
//     (cp.async.bulk) issued by one thread and completing on the stage's
//     full barrier.  Bulk copies rather than TMA tensor maps: the B runs are
//     contiguous, so they need no map (and no cuTensorMapEncodeTiled to encode
//     one), and the halo, whose rows outside [0, M) a 2-D map would
//     zero-fill, would need two boxes past 256 rows and a second layout for
//     the channel tail; its copies are spread over the 256 consumer threads
//     instead, 4 per thread at 56x56;
//   * split-K across a thread-block cluster where the output tiles cannot
//     fill the SMs (ResNet's 14x14 and 7x7 stages at batch 8): the planner
//     (ops/conv_flat.py:plan_flat) splits the channel slices across
//     blockIdx.z, and the cluster adds its partial tiles through distributed
//     shared memory (integer adds mod 2^32, exact in any order) before one
//     epilogue per element, as K2 and K7 do; the bias is added once, after
//     the sum;
//   * the epilogue: the tile's biases staged in shared memory, each row's
//     ring test worked out once from its raster row into a flag in shared
//     memory, and the outputs staged per consumer warp (16 rows x 64
//     columns, in the halo's memory once every product is done) and written
//     back as 16-byte row-contiguous stores, as K7 does.
// A raster whose halo does not fit one block's shared memory (the halo,
// the ring and the rest) is refused: cudaErrorInvalidValue.
#include <cooperative_groups.h>

#include <cstdint>

#include "launch.cuh"
#include "mma_tile.cuh"
#include "requant.cuh"
#include "wgmma_s8.cuh"

namespace f8 {

constexpr int kFlatBM = 128;                 // output rows per tile: two warpgroups of 64
// B ring depth, and wgmma groups left in flight behind a step (probe_plans.py
// --only k6parts: 10 stages, or 2 or 3 groups, measured within 8% of these)
constexpr int kFlatStages = 6;
constexpr int kFlatInFlight = 1;
constexpr int kFlatConsumers = 256;          // two warpgroups
constexpr int kFlatThreads = kFlatConsumers + 32;  // + the producer warp
constexpr int kFlatLd = 64 * 4 + 32;         // a staged output row: 64 int32 + 32 bytes
constexpr int kFlatMaxSplits = 8;            // a cluster of at most 8 blocks (portable)
constexpr int kFlatNAlign = 64;              // packed output channels (ops/conv.py N_ALIGN)

struct FlatArgs {
  int M, C, O, h2, w2, k, p, H;
  int R;      // staged halo rows, kFlatBM + 2H
  int o_pad;  // the packed weights' output channels, o rounded up to kFlatNAlign
  int slices, splits;
  int epilogue, net, out_signed, relu, mask_pad, mask_value;
};

// Byte offsets in the dynamic shared memory, the formula of
// ops/conv_flat.py:flat_smem: the halo, then the B ring (both reused by the epilogue's staging or the split-K partial tile, which is
// larger where `body` says so), the biases, the ring flags, the barriers.
struct FlatSmem {
  int ring, body, bias, flags, bars, total;
};

__host__ __device__ inline FlatSmem flat_smem(int R, int bn, int splits) {
  FlatSmem s;
  s.ring = (R * 64 + 127) / 128 * 128;  // the halo, rounded up to 128 bytes
  const int rings = s.ring + kFlatStages * bn * 64;
  const int park = splits > 1 ? kFlatBM * (bn * 4 + 32) : 8 * 16 * kFlatLd;
  s.body = rings > park ? rings : park;
  s.bias = s.body;
  s.flags = s.bias + bn * 4;
  s.bars = s.flags + kFlatBM;
  s.total = s.bars + 2 * kFlatStages * 8;
  return s;
}

// The epilogue of 4 consecutive raw sums of output row `row` from column
// `col` (tile column c): int32 as one 16-byte store, int8 as one 4-byte store.
__device__ __forceinline__ void flat_store4(const int32_t (&v)[4], int row, int col, int c,
                                            bool ring, const int32_t* sbias,
                                            const Epilogue8& ep, void* out, const FlatArgs& a) {
  const size_t idx = static_cast<size_t>(row) * a.O + col;
  if (a.epilogue == kInt32) {
    int4 y = make_int4(a.mask_value, a.mask_value, a.mask_value, a.mask_value);
    if (!ring)
      y = make_int4(ep.int32(v[0], sbias[c]), ep.int32(v[1], sbias[c + 1]),
                    ep.int32(v[2], sbias[c + 2]), ep.int32(v[3], sbias[c + 3]));
    *reinterpret_cast<int4*>(static_cast<int32_t*>(out) + idx) = y;
  } else {
    uint32_t q = 0x01010101u * static_cast<uint8_t>(a.mask_value);
    if (!ring)
      q = pack4(ep.byte(v[0], sbias[c]), ep.byte(v[1], sbias[c + 1]),
                ep.byte(v[2], sbias[c + 2]), ep.byte(v[3], sbias[c + 3]));
    *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + idx) = q;
  }
}

// One consumer warp's epilogue of 16 tile rows (from tile row tr0) x 64
// columns (from tile column c0), staged raw in `s` (row stride kFlatLd).
__device__ __forceinline__ void flat_write_rows(const int8_t* s, int tr0, int c0, int m0, int n0,
                                                const int32_t* sbias, const uint8_t* sflags,
                                                const Epilogue8& ep, void* out,
                                                const FlatArgs& a) {
  const int lane = threadIdx.x & 31;
  if (a.epilogue == kInt32) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // 16 rows x 16 four-column groups
      const int q = lane + 32 * i, r = q >> 4, c = (q & 15) * 4;
      const int row = m0 + tr0 + r, col = n0 + c0 + c;
      if (row >= a.M || col >= a.O) continue;
      const int4 v = *reinterpret_cast<const int4*>(s + r * kFlatLd + c * 4);
      const int32_t vv[4] = {v.x, v.y, v.z, v.w};
      flat_store4(vv, row, col, c0 + c, sflags[tr0 + r] != 0, sbias, ep, out, a);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // 16 rows x 4 sixteen-column groups
    const int q = lane + 32 * i, r = q >> 2, c = (q & 3) * 16;
    const int row = m0 + tr0 + r, col = n0 + c0 + c;
    if (row >= a.M || col >= a.O) continue;
    const bool ring = sflags[tr0 + r] != 0;
    uint32_t w[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int4 v = *reinterpret_cast<const int4*>(s + r * kFlatLd + (c + 4 * g) * 4);
      const int32_t* b = sbias + c0 + c + 4 * g;
      w[g] = ring ? 0x01010101u * static_cast<uint8_t>(a.mask_value)
                  : pack4(ep.byte(v.x, b[0]), ep.byte(v.y, b[1]), ep.byte(v.z, b[2]),
                          ep.byte(v.w, b[3]));
    }
    int8_t* dst = static_cast<int8_t*>(out) + static_cast<size_t>(row) * a.O + col;
    if (a.O % 16 == 0) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        if (col + 4 * g < a.O) *reinterpret_cast<uint32_t*>(dst + 4 * g) = w[g];
    }
  }
}

// the two consumer warpgroups' own barrier (the producer warp is not in it)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kFlatConsumers) : "memory");
}

// x: the flat (M, C) raster; wp: packed weights (K_pad / 16, o_pad, 16).
// Grid (M tiles, o_pad / BN, splits); with splits > 1 the z blocks of one
// output tile form a cluster of `splits` blocks.
template <int BN>
__global__ void __launch_bounds__(kFlatThreads, 1)
    conv_flat_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                     const int32_t* __restrict__ bias, void* __restrict__ out, FlatArgs a) {
  extern __shared__ __align__(128) int8_t smem[];
  const FlatSmem lay = flat_smem(a.R, BN, a.splits);
  int8_t* ring = smem + lay.ring;
  int32_t* sbias = reinterpret_cast<int32_t*>(smem + lay.bias);
  uint8_t* sflags = reinterpret_cast<uint8_t*>(smem + lay.flags);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + kFlatStages;
  constexpr int kStage = BN * 64;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp index through a shuffle: provably warp-uniform, so the role
  // branches below do not make ptxas serialise the consumers' wgmmas
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int m0 = blockIdx.x * kFlatBM, n0 = blockIdx.y * BN;
  const int slo = static_cast<int>(blockIdx.z) * a.slices / a.splits;
  const int nsl = (static_cast<int>(blockIdx.z) + 1) * a.slices / a.splits - slo;
  const int T = a.k * a.k, steps = nsl * T;
  if (tid == 0) {
    for (int s = 0; s < kFlatStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival, then the stage's bytes
      mbar_init(&empty[s], 8);  // the consumer warps, once their wgmma read the stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  int32_t acc[BN / 2];  // set by the first wgmma (accumulate = 0): steps >= 1
  const int wg = warp >> 2;
  if (warp == kFlatConsumers / 32) {
    // producer: stage `step` = tap step % T of slice slo + step / T, four
    // runs of BN x 16 bytes of the packed weights
    if (lane == 0) {
      for (int step = 0; step < steps; ++step) {
        const int st = step % kFlatStages;
        if (step >= kFlatStages) mbar_wait_or_trap(&empty[st], ((step / kFlatStages) - 1) & 1);
        const int q0 = ((step % T) * a.C) / 16 + 4 * (slo + step / T);
        mbar_arrive_expect_tx(&full[st], 4 * BN * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bulk_copy_g2s(ring + st * kStage + j * BN * 16,
                        wp + (static_cast<size_t>(q0 + j) * a.o_pad + n0) * 16, BN * 16,
                        &full[st]);
      }
    }
  } else {
    // the tile's biases and ring flags, read in the epilogue (after a barrier)
    if (tid < BN) sbias[tid] = n0 + tid < a.O ? bias[n0 + tid] : 0;
    if (tid < kFlatBM) {
      const int m = m0 + tid;
      bool r = false;
      if (a.mask_pad && m < a.M) {
        const int cx = m % a.w2, ry = (m / a.w2) % a.h2;
        r = cx < a.p || cx >= a.w2 - a.p || ry < a.p || ry >= a.h2 - a.p;
      }
      sflags[tid] = r;
    }
    // copy slice slo + i's halo (zero outside [0, M) and past C)
    auto issue_halo = [&](int i) {
      const int c0 = (slo + i) * 64;
      for (int q = tid; q < a.R * 4; q += kFlatConsumers) {
        const int r = q >> 2, c = q & 3;
        const int m = m0 - a.H + r, ch = c0 + 16 * c;
        const bool ok = m >= 0 && m < a.M && ch < a.C;
        cp_async16(smem + (c * a.R + r) * 16, ok ? x + static_cast<size_t>(m) * a.C + ch : x, ok);
      }
      cp_async_commit();
    };
    int released = -1;  // the stages of steps <= released are handed back to the producer
    auto release_upto = [&](int last) {
      for (; released < last; ++released) {
        __syncwarp();
        mbar_arrive_if(&empty[(released + 1) % kFlatStages], lane == 0);
      }
    };
    issue_halo(0);
    int step = 0;
    for (int i = 0; i < nsl; ++i) {
      if (i > 0) {  // the last slice's products are done: release its last stages
        wgmma_wait<0>();
        release_upto(step - 1);
        consumer_sync();  // everyone is done with the halo before it is refilled
        issue_halo(i);
      }
      cp_async_wait<0>();   // slice i's halo has landed (this thread's copies)
      fence_proxy_async();  // ... is visible to wgmma's proxy
      consumer_sync();      // ... everyone's
      const int8_t* hb = smem + (a.H + wg * 64) * 16;
      int dy = 0, dx = 0;
      for (int t = 0; t < T; ++t, ++step) {
        const int8_t* sa = hb + ((dy - a.p) * a.w2 + (dx - a.p)) * 16;  // tap (dy, dx)'s rows
        if (++dx == a.k) {
          dx = 0;
          ++dy;
        }
        const int st = step % kFlatStages;
        mbar_wait_or_trap(&full[st], (step / kFlatStages) & 1);
        const int8_t* sb = ring + st * kStage;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t da = smem_desc(sa + kk * 2 * a.R * 16, a.R * 16, 128);
          const uint64_t db = smem_desc(sb + kk * 2 * BN * 16, BN * 16, 128);
          wgmma_s8<BN>(acc, da, db, step > 0 || kk > 0);
        }
        wgmma_commit();
        if (t < T - 1) {  // steps up to step - kFlatInFlight are done: refill their stages
          wgmma_wait<kFlatInFlight>();
          release_upto(step - kFlatInFlight);
        }
      }
    }
    wgmma_wait<0>();
    consumer_sync();  // every product is done: the halo and ring memory is free
    if (a.splits == 1) {
      // stage 16 rows x 64 columns of the fragment per warp, store them row-contiguous
      const Epilogue8 ep(a.net, a.out_signed != 0, a.relu != 0);
      int8_t* s = smem + warp * 16 * kFlatLd;
      const int tr0 = wg * 64 + (warp & 3) * 16;
      const int g = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int h = 0; h < BN / 64; ++h) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 4 * (8 * h + j) + 2 * hh;  // accumulator register
            *reinterpret_cast<int2*>(s + (g + 8 * hh) * kFlatLd + (8 * j + 2 * tq) * 4) =
                make_int2(acc[r], acc[r + 1]);
          }
        __syncwarp();
        flat_write_rows(s, tr0, 64 * h, m0, n0, sbias, sflags, ep, out, a);
        __syncwarp();
      }
    }
  }
  if (a.splits > 1) {
    // park the raw partial tile, row-major (row stride BN * 4 + 32), in the
    // halo and ring memory; block q of the cluster then sums rows
    // [q * 128 / s, (q + 1) * 128 / s) of the s partial tiles (integer adds:
    // exact in any order) and runs their epilogue; a second cluster barrier
    // keeps every block's shared memory alive until the others have read it
    constexpr int ld = BN * 4 + 32;
    __syncthreads();
    if (tid < kFlatConsumers) {
      const int g = lane >> 2, tq = lane & 3;
      const int rw = wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<int2*>(smem + (rw + 8 * hh) * ld + (8 * j + 2 * tq) * 4) =
              make_int2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int q = static_cast<int>(cluster.block_rank());
    const int rlo = q * kFlatBM / a.splits, rhi = (q + 1) * kFlatBM / a.splits;
    if (tid < kFlatConsumers) {
      const Epilogue8 ep(a.net, a.out_signed != 0, a.relu != 0);
      for (int i = tid; i < (rhi - rlo) * (BN / 4); i += kFlatConsumers) {
        const int r = rlo + i / (BN / 4), c = (i % (BN / 4)) * 4;
        const int row = m0 + r, col = n0 + c;
        if (row >= a.M || col >= a.O) continue;
        int4 v[kFlatMaxSplits];  // every rank's partial in flight before any is added
#pragma unroll
        for (int k = 0; k < kFlatMaxSplits; ++k)
          if (k < a.splits)
            v[k] = *reinterpret_cast<const int4*>(cluster.map_shared_rank(smem, k) + r * ld +
                                                  c * 4);
        uint32_t sum[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < kFlatMaxSplits; ++k)
          if (k < a.splits) {
            sum[0] += static_cast<uint32_t>(v[k].x);
            sum[1] += static_cast<uint32_t>(v[k].y);
            sum[2] += static_cast<uint32_t>(v[k].z);
            sum[3] += static_cast<uint32_t>(v[k].w);
          }
        const int32_t vv[4] = {static_cast<int32_t>(sum[0]), static_cast<int32_t>(sum[1]),
                               static_cast<int32_t>(sum[2]), static_cast<int32_t>(sum[3])};
        flat_store4(vv, row, col, c, sflags[r] != 0, sbias, ep, out, a);
      }
    }
    cluster.sync();
  }
}

template <int BN>
int launch_flat(const int8_t* x, const int8_t* wp, const int32_t* bias, void* out,
                const FlatArgs& a, int smem, cudaStream_t stream) {
  // the shared-memory ceiling is set once per process; a launch asks for its own size
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_flat_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((a.M + kFlatBM - 1) / kFlatBM), a.o_pad / BN,
                     a.splits);
  cfg.blockDim = dim3(kFlatThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = a.splits;
  cfg.attrs = cluster;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, conv_flat_kernel<BN>, x, wp, bias, out, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace f8

// x: (M, c) int8, M = n * h2 * w2, c % 16 == 0, 16-byte aligned; wp: packed
// weights (K_pad / 16, o_pad, 16) int8 (ops/conv.py:pack_conv_weight of the
// (k, k, c, o) HWIO weights, K_pad = 64 * ceil(k*k*c / 64)), 16-byte aligned;
// bias: (o,) int32; out: (M, o) int32 (epilogue 0) or int8 (epilogue 1),
// o % 4 == 0; k odd.  mask_value must fit the output type.  The plan
// (ops/conv_flat.py:plan_flat): bn 64 or 128 dividing o_pad, splits 1 ..
// min(8, ceil(c / 64)).  Returns cudaErrorInvalidValue on a plan it does not
// take and when the staging does not fit one block's shared memory.
extern "C" int f8_conv_flat(const void* x, const void* wp, const void* bias, void* out, int M,
                            int c, int o, int h2, int w2, int k, int epilogue, int net,
                            int out_signed, int relu, int mask_pad, int mask_value, int bn,
                            int splits, void* stream) {
  const int p = (k - 1) / 2, H = p * w2 + p, R = f8::kFlatBM + 2 * H;
  const int o_pad = (o + f8::kFlatNAlign - 1) / f8::kFlatNAlign * f8::kFlatNAlign;
  const int slices = (c + 63) / 64;
  if ((bn != 64 && bn != 128) || o_pad % bn != 0 || k % 2 != 1 || splits < 1 ||
      splits > f8::kFlatMaxSplits || splits > slices)
    return static_cast<int>(cudaErrorInvalidValue);
  const f8::FlatSmem lay = f8::flat_smem(R, bn, splits);
  if (lay.total > f8::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const f8::FlatArgs a{M, c, o, h2, w2, k, p, H, R, o_pad, slices, splits,
                       epilogue, net, out_signed, relu, mask_pad, mask_value};
  auto* xs = static_cast<const int8_t*>(x);
  auto* w8 = static_cast<const int8_t*>(wp);
  auto* b = static_cast<const int32_t*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  return bn == 128 ? f8::launch_flat<128>(xs, w8, b, out, a, lay.total, st)
                   : f8::launch_flat<64>(xs, w8, b, out, a, lay.total, st);
}
