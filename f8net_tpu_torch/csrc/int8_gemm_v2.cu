// K7: persistent int8 GEMM, the contract of K1,
//   y[M, N] = epilogue(x[M, K] . w[K, N] + bias[N])
// Replaces f8net_tpu/ops/pallas_gemm_v2.py:int8_gemm_v2 (:123-228; kernel
// body _kernel :30, pallas_call :174).  The TPU kernel runs one program per
// N-block, keeps that block's weights resident in VMEM and streams M chunks
// of x through two buffers.
//
// What bounds it on an H100: ResNet-50's 33 pointwise convs at batch 8 do
// about 29 G operations (0.015 ms at the int8 peak) but move about 250 MB,
// most of it the int32 outputs of each block's last conv and shortcut
// (0.07 ms at 3.35 TB/s), so bytes bound it.  What held the mma.sync version
// of this kernel at 7.5x that bound, and what this design does about each:
//   * the weight slab was transposed on every call (load_b_kn): the weights
//     are packed once on the host into wgmma's K-major 16-byte-chunk image
//     (ops/gemm_v2.py:pack_gemm_weight, K2's PackedConvWeight of a 1x1
//     conv), so a weight stage is a straight 16-byte cp.async copy;
//   * 64 x 64 mma.sync tiles on one 4-warp block per SM left every latency
//     exposed: the products are wgmma m64nBNk32 (wgmma_s8.cuh) on 128 x BN
//     tiles (BN = 64 or 128), two consumer warpgroups of 64 rows each;
//   * a 3-stage ring of 64-byte K slices overlapped little at small K: one
//     producer warp keeps a kG2Stages-deep ring of (A, B) stages in flight,
//     in a stream of (tile, K step) pairs that runs on across tile
//     boundaries, so the next tile's copies fly while a tile's last products
//     and its epilogue run.  The producer signals a stage full through an
//     mbarrier once its copies have landed and are fenced to the async proxy;
//     each consumer warp signals it empty once the wgmma that read it is done;
//   * the int32 epilogue stored straight from the wgmma fragment: each
//     consumer warp stages its 16 rows x 64 columns in shared memory and
//     writes them back as 16-byte row-contiguous stores (int32: 4 columns per
//     lane; int8: 16 columns per lane, 4-byte pieces at a ragged N);
//   * the blocks are persistent (one per SM, walking tiles blockIdx.x,
//     blockIdx.x + gridDim.x, ...), and where the tiles cannot fill the SMs
//     (ResNet-50's stage 3 at batch 8: M = 392, K = 2048) the reduction is
//     split across the blocks of a thread-block cluster, one tile per
//     cluster, whose partial tiles are summed through distributed shared
//     memory before one epilogue per element (as K2).  The plan -- tile
//     width, split, grid -- comes from ops/gemm_v2.py:plan_gemm.
#include <cooperative_groups.h>

#include <cstdint>

#include "launch.cuh"
#include "mma_tile.cuh"
#include "requant.cuh"
#include "wgmma_s8.cuh"

namespace f8 {

constexpr int kG2BM = 128;                // output rows per tile: two warpgroups of 64
constexpr int kG2BK = 64;                 // reduction bytes per stage
constexpr int kG2Stages = 6;              // ring depth
constexpr int kG2Lag = kG2Stages - 2;     // a stage is signalled full kG2Lag issues later
constexpr int kG2Consumers = 256;         // two warpgroups
constexpr int kG2Threads = kG2Consumers + 32;  // + the producer warp
constexpr int kG2Ld = 64 * 4 + 32;        // staged row: 64 int32 + 32 bytes against bank conflicts
constexpr int kG2Staging = 8 * 16 * kG2Ld;  // 16 rows per consumer warp

template <int BN>
constexpr int g2_stage_bytes() {
  return (kG2BM + BN) * kG2BK;
}

template <int BN>
constexpr int g2_smem_bytes() {
  return kG2Stages * g2_stage_bytes<BN>() + kG2Staging + 2 * kG2Stages * 8;
}

struct G2Args {
  int M, N, K, n_pad, ksteps, ntiles, tiles, splits;
  int epilogue, net, out_signed, relu;
};

// the epilogue of 4 consecutive columns [col, col + 4) of one output row
__device__ __forceinline__ void g2_store4(const int32_t (&v)[4], int row, int col,
                                          const int32_t* __restrict__ bias, void* out,
                                          const G2Args& a) {
  const int4 b = __ldg(reinterpret_cast<const int4*>(bias + col));
  const int32_t bb[4] = {b.x, b.y, b.z, b.w};
  const size_t idx = static_cast<size_t>(row) * a.N + col;
  if (a.epilogue == kInt32) {
    int4 y;
    y.x = bias_relu(v[0], bb[0], a.relu != 0);
    y.y = bias_relu(v[1], bb[1], a.relu != 0);
    y.z = bias_relu(v[2], bb[2], a.relu != 0);
    y.w = bias_relu(v[3], bb[3], a.relu != 0);
    *reinterpret_cast<int4*>(static_cast<int32_t*>(out) + idx) = y;
  } else {
    uint32_t q = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      q |= static_cast<uint32_t>(static_cast<uint8_t>(
               requant8(bias_relu(v[e], bb[e], a.relu != 0), a.net, a.out_signed != 0)))
           << (8 * e);
    *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + idx) = q;
  }
}

// One consumer warp's epilogue of its 16 rows (from row r0) x 64 columns
// (from col c0), staged raw in `s` (row stride kG2Ld): 16-byte stores.
__device__ __forceinline__ void g2_write_rows(const int8_t* s, int r0, int c0,
                                              const int32_t* __restrict__ bias, void* out,
                                              const G2Args& a) {
  const int lane = threadIdx.x & 31;
  if (a.epilogue == kInt32) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // 16 rows x 16 four-column groups
      const int q = lane + 32 * i, r = q >> 4, c = (q & 15) * 4;
      const int row = r0 + r, col = c0 + c;
      if (row >= a.M || col >= a.N) continue;
      const int4 v = *reinterpret_cast<const int4*>(s + r * kG2Ld + c * 4);
      const int32_t vv[4] = {v.x, v.y, v.z, v.w};
      g2_store4(vv, row, col, bias, out, a);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // 16 rows x 4 sixteen-column groups
    const int q = lane + 32 * i, r = q >> 2, c = (q & 3) * 16;
    const int row = r0 + r, col = c0 + c;
    if (row >= a.M || col >= a.N) continue;
    uint32_t w[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int4 v = *reinterpret_cast<const int4*>(s + r * kG2Ld + (c + 4 * g) * 4);
      const int4 b = __ldg(reinterpret_cast<const int4*>(bias + min(col + 4 * g, a.N - 4)));
      const int32_t vv[4] = {v.x, v.y, v.z, v.w}, bb[4] = {b.x, b.y, b.z, b.w};
      w[g] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[g] |= static_cast<uint32_t>(static_cast<uint8_t>(
                    requant8(bias_relu(vv[e], bb[e], a.relu != 0), a.net, a.out_signed != 0)))
                << (8 * e);
    }
    int8_t* dst = static_cast<int8_t*>(out) + static_cast<size_t>(row) * a.N + col;
    if (col + 16 <= a.N && a.N % 16 == 0) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        if (col + 4 * g < a.N) *reinterpret_cast<uint32_t*>(dst + 4 * g) = w[g];
    }
  }
}

// x: (M, K) int8 rows; wp: packed weights (K_pad / 16, n_pad, 16).
template <int BN>
__global__ void __launch_bounds__(kG2Threads, 1)
    int8_gemm_v2_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                        const int32_t* __restrict__ bias, void* __restrict__ out, G2Args a) {
  extern __shared__ __align__(128) int8_t smem[];
  constexpr int kA = kG2BM * kG2BK, kStage = kA + BN * kG2BK;  // g2_stage_bytes<BN>()
  int8_t* staging = smem + kG2Stages * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kG2Staging);
  uint64_t* empty = full + kG2Stages;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp index through a shuffle: provably warp-uniform, so the role
  // branches below do not make ptxas serialise the consumers' wgmmas
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (tid == 0) {
    for (int s = 0; s < kG2Stages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes, once their copies landed
      mbar_init(&empty[s], 8);  // the consumer warps, once their wgmma read the stage
    }
  }
  __syncthreads();

  // this block's work: tiles t0, t0 + tstep, ... over K steps [klo, khi)
  int t0, tstep, ntile, klo, khi;
  if (a.splits > 1) {  // one tile per cluster, the K steps split over its blocks
    const int rank = static_cast<int>(blockIdx.x) % a.splits;
    t0 = static_cast<int>(blockIdx.x) / a.splits;
    tstep = 1;
    ntile = 1;
    klo = static_cast<int>(static_cast<long long>(rank) * a.ksteps / a.splits);
    khi = static_cast<int>(static_cast<long long>(rank + 1) * a.ksteps / a.splits);
  } else {
    t0 = blockIdx.x;
    tstep = gridDim.x;
    ntile = t0 < a.tiles ? (a.tiles - 1 - t0) / tstep + 1 : 0;
    klo = 0;
    khi = a.ksteps;
  }
  const int kn = khi - klo, total = ntile * kn;
  const int wg = warp >> 2;  // consumers: warpgroup wg computes rows [64 wg, 64 wg + 64)
  int32_t acc[BN / 2];

  if (warp == kG2Consumers / 32) {
    // producer: stage `it` = K step klo + it % kn of tile t0 + (it / kn) * tstep
    for (int it = 0; it < total; ++it) {
      const int st = it % kG2Stages;
      if (it >= kG2Stages) mbar_wait(&empty[st], ((it / kG2Stages) - 1) & 1);
      const int t = t0 + (it / kn) * tstep, ks = klo + it % kn;
      const int m0 = (t / a.ntiles) * kG2BM, n0 = (t % a.ntiles) * BN;
      int8_t* sa = smem + st * kStage;
#pragma unroll
      for (int j = 0; j < kA / 16 / 32; ++j) {  // A: 128 rows x 4 chunks, row-contiguous reads
        const int q = lane + 32 * j, row = q >> 2, c = q & 3;
        const int m = m0 + row, k = ks * kG2BK + c * 16;
        const bool ok = m < a.M && k < a.K;
        cp_async16(sa + (c * kG2BM + row) * 16, ok ? x + static_cast<size_t>(m) * a.K + k : x,
                   ok);
      }
      const int8_t* src = wp + (static_cast<size_t>(ks) * 4 * a.n_pad + n0) * 16;
#pragma unroll
      for (int j = 0; j < 4 * BN / 32; ++j) {  // B: 4 runs of BN x 16 bytes
        const int q = lane + 32 * j, c = q / BN, r = q - c * BN;
        cp_async16(sa + kA + q * 16, src + (static_cast<size_t>(c) * a.n_pad + r) * 16, true);
      }
      cp_async_commit();
      if (it >= kG2Lag) {
        cp_async_wait<kG2Lag>();  // stage it - kG2Lag has landed
        fence_proxy_async();
        mbar_arrive(&full[(it - kG2Lag) % kG2Stages]);
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int it = total > kG2Lag ? total - kG2Lag : 0; it < total; ++it)
      mbar_arrive(&full[it % kG2Stages]);
  } else {
    int pend = -1;  // the step whose stage this warp has not released yet
    auto release = [&](int step) {
      if (step < 0) return;
      __syncwarp();
      mbar_arrive_if(&empty[step % kG2Stages], lane == 0);
    };
    for (int it = 0; it < total; ++it) {
      const int st = it % kG2Stages, ks = it % kn;
      mbar_wait(&full[st], (it / kG2Stages) & 1);
      const int8_t* sa = smem + st * kStage;
      const int8_t* sb = sa + kA;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kG2BK / 32; ++kk) {
        const uint64_t da = smem_desc(sa + kk * 2 * kG2BM * 16 + wg * 64 * 16, kG2BM * 16, 128);
        const uint64_t db = smem_desc(sb + kk * 2 * BN * 16, BN * 16, 128);
        wgmma_s8<BN>(acc, da, db, ks > 0 || kk > 0);
      }
      wgmma_commit();
      if (ks < kn - 1) {
        wgmma_wait<1>();  // step it - 1 is done: its stage may be refilled
        release(pend);
        pend = it;
        continue;
      }
      wgmma_wait<0>();
      release(pend);
      release(it);
      pend = -1;
      if (a.splits > 1) break;  // the cluster sums the partial tiles below
      // epilogue: stage 16 rows x 64 columns of the fragment, store them row-contiguous
      const int t = t0 + (it / kn) * tstep;
      const int r0 = (t / a.ntiles) * kG2BM + wg * 64 + (warp & 3) * 16;
      const int n0 = (t % a.ntiles) * BN;
      int8_t* s = staging + warp * 16 * kG2Ld;
      const int g = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int h = 0; h < BN / 64; ++h) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 4 * (8 * h + j) + 2 * hh;  // accumulator register
            *reinterpret_cast<int2*>(s + (g + 8 * hh) * kG2Ld + (8 * j + 2 * tq) * 4) =
                make_int2(acc[r], acc[r + 1]);
          }
        __syncwarp();
        g2_write_rows(s, r0, n0 + 64 * h, bias, out, a);
        __syncwarp();
      }
    }
  }
  if (a.splits > 1) {
    // park the raw partial tile, row-major (row stride BN * 4 + 32), in the
    // ring once every wgmma and copy of the block is done with it (the plan
    // gives every split at least one K step, so acc is set)
    const int ld = BN * 4 + 32;
    __syncthreads();
    if (tid < kG2Consumers) {
      const int g = lane >> 2, tq = lane & 3;
      const int rw = wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<int2*>(smem + (rw + 8 * hh) * ld + (8 * j + 2 * tq) * 4) =
              make_int2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
    // block q of the cluster sums rows [q * 128 / s, (q + 1) * 128 / s) of
    // the s partial tiles (integer adds: exact in any order) and runs their
    // epilogue; a second cluster barrier keeps every block's shared memory
    // alive until the others have read it
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int q = static_cast<int>(cluster.block_rank());
    const int rlo = q * kG2BM / a.splits, rhi = (q + 1) * kG2BM / a.splits;
    const int m0 = (t0 / a.ntiles) * kG2BM, n0 = (t0 % a.ntiles) * BN;
    if (tid < kG2Consumers) {
      for (int i = tid; i < (rhi - rlo) * (BN / 4); i += kG2Consumers) {
        const int r = rlo + i / (BN / 4), c = (i % (BN / 4)) * 4;
        const int row = m0 + r, col = n0 + c;
        if (row >= a.M || col >= a.N) continue;
        int4 v[8];  // every rank's partial in flight before any is added
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < a.splits)
            v[k] = *reinterpret_cast<const int4*>(cluster.map_shared_rank(smem, k) + r * ld +
                                                  c * 4);
        uint32_t sum[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < a.splits) {
            sum[0] += static_cast<uint32_t>(v[k].x);
            sum[1] += static_cast<uint32_t>(v[k].y);
            sum[2] += static_cast<uint32_t>(v[k].z);
            sum[3] += static_cast<uint32_t>(v[k].w);
          }
        const int32_t vv[4] = {static_cast<int32_t>(sum[0]), static_cast<int32_t>(sum[1]),
                               static_cast<int32_t>(sum[2]), static_cast<int32_t>(sum[3])};
        g2_store4(vv, row, col, bias, out, a);
      }
    }
    cluster.sync();
  }
}

template <int BN>
int launch_gemm_v2(const int8_t* x, const int8_t* wp, const int32_t* bias, void* out,
                   const G2Args& a, int grid, cudaStream_t stream) {
  // the shared-memory attribute is set once per process, not per launch
  static const cudaError_t attr =
      cudaFuncSetAttribute(int8_gemm_v2_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           g2_smem_bytes<BN>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kG2Threads);
  cfg.dynamicSmemBytes = g2_smem_bytes<BN>();
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, int8_gemm_v2_kernel<BN>, x, wp, bias, out, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace f8

// x: (M, K) int8, K % 16 == 0, 16-byte aligned; wp: packed weights
// (ksteps * 4, n_pad, 16) int8, ksteps * 64 >= K, n_pad a multiple of bn;
// bias: (N,) int32, 16-byte aligned; out: (M, N) int32 (epilogue 0) or int8
// (epilogue 1), N % 4 == 0; bn: 64 or 128; splits: 1 .. 8 (then grid =
// ceil(M / 128) * n_pad / bn * splits, a cluster of `splits` blocks per
// tile), else grid: the persistent blocks.
extern "C" int f8_int8_gemm_v2(const void* x, const void* wp, const void* bias, void* out, int M,
                               int N, int K, int n_pad, int bn, int ksteps, int splits, int grid,
                               int epilogue, int net, int out_signed, int relu, void* stream) {
  if (splits < 1 || splits > 8 || grid < 1 || (bn != 64 && bn != 128) || n_pad % bn != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = n_pad / bn, tiles = (M + f8::kG2BM - 1) / f8::kG2BM * ntiles;
  if (splits > 1 && grid != tiles * splits) return static_cast<int>(cudaErrorInvalidValue);
  const f8::G2Args a{M, N, K, n_pad, ksteps, ntiles, tiles, splits,
                     epilogue, net, out_signed, relu};
  auto* xs = static_cast<const int8_t*>(x);
  auto* w8 = static_cast<const int8_t*>(wp);
  auto* b = static_cast<const int32_t*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  return bn == 128 ? f8::launch_gemm_v2<128>(xs, w8, b, out, a, grid, st)
                   : f8::launch_gemm_v2<64>(xs, w8, b, out, a, grid, st);
}
