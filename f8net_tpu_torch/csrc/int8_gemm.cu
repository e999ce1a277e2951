// K1: int8 GEMM with int32 accumulation and the fused requant epilogue,
//   y[M, N] = epilogue(x[M, K] . w[K, N] + bias[N])
// Replaces f8net_tpu/ops/pallas_gemm.py:int8_gemm (:121-198; kernel body
// _gemm_kernel :49, pallas_call :175).
//
// What bounds it on an H100: bytes at every call the engine makes.  The
// classifier (M = batch <= 64, K = 512-2048, N = 1000) reads 0.5-2 MB of
// weights for a product the tensor cores finish in nanoseconds; MobileNet's
// narrow 1x1 convs (M = 25088-100352 rows, K = 24-96, N = 16-144) stream
// x and the output once.  The first design (one 64 x 64 mma.sync tile per
// block, load -> sync -> mma per 64-byte K step) ran them at ~20x their
// bound: 16 blocks streamed the classifier's weights, and a K of 24 or 32
// was one exposed load per block.  The weights are now packed once on the
// host (ops/gemm.py:pack_k1_weight: w transposed, each column's reduction
// bytes contiguous, zero-padded to K % 32 == 0 and N % 8 == 0), and the host
// planner (ops/gemm.py:plan_k1) picks one of three forms per call:
//
//   skinny (M <= 64): a block owns 8 output columns, so 125 blocks stream a
//     1000-class head's weights; its 4 warps take every 4th 64-byte chunk of
//     the reduction, each lane copying 16-byte pieces of its own x rows and
//     weight column with cp.async into an up-to-8-stage ring that only it
//     reads (no block barrier in the loop).  The reduction order inside an
//     m16n8k32 step is free as long as A and B agree, so a lane's 16
//     contiguous bytes feed two mma.sync steps straight from its own
//     pieces.  Rows M..15 of an m16 tile are zero registers, never copied.
//     The warps' partials are summed in shared memory and the epilogue,
//     bias included, runs once on the full sum.  (On an H100, splitting the
//     reduction over a cluster lost at every classifier shape and wider
//     column groups gained at most 0.1 us, so neither is built.)
//   narrow (N < 32 or K % 16 != 0, many rows): the whole padded weight
//     sits in shared memory, loaded once per block; a persistent grid walks
//     128-row tiles of x, each a contiguous BM * K-byte run of memory,
//     through a 4-stage cp.async ring, so the next tiles' loads fly under
//     this tile's mma.sync and store; the MMA width is the real N (n8
//     tiles); a K of 24 runs as one k32 step whose last 8 bytes meet zero
//     weights; 8 warps take 16 rows each, and a second 8 the other half of
//     a wide N's columns, because at N = 144 the requant epilogue, not the
//     bytes, sets the time; the output tile is staged in shared memory and
//     leaves as one contiguous run of 16-byte stores (a 16- or 24-byte row
//     alone would not coalesce).
//   general: 64 x 64 mma.sync tiles (mma_tile.cuh) over a 3-stage cp.async
//     ring of 64-byte K steps; x rows copy 16 bytes at a time when K % 16
//     == 0, else 4.
//
// The skinny and narrow epilogues use requant.cuh's Epilogue8: the call's
// shift, clamp and ReLU constants worked out once, no branch per element.
// Any K % 4 == 0 and any N: the zero pad of the packed weights and the
// zero fill of cp.async beyond K make the padded reduction exact (the
// Pallas kernel padded K in device memory instead, pallas_gemm.py:153-158).
#include <cstdint>

#include "launch.cuh"
#include "mma_tile.cuh"
#include "requant.cuh"

namespace f8 {

constexpr int kK1Threads = 128;
constexpr int kChunk = 64;        // skinny: reduction bytes per warp per stage
constexpr int kNarrowBM = 128;    // narrow: rows per tile, 16 per warp
constexpr int kNarrowMaxThreads = 512;  // narrow: 8 row warps x 1 or 2 column groups
constexpr int kNarrowStages = 4;  // narrow: tiles in flight
constexpr int kGeneralStages = 3;

struct K1Args {
  int M, N, K, n_pad, k_pad;
  int epilogue, net, out_signed, relu;
};

// cp.async with a memory clobber: the skinny form has no block barrier
// between a thread's reads of a ring slot and its next copy into it, so the
// compiler must not move shared-memory accesses across these.
__device__ __forceinline__ void k1_cp16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void k1_cp4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void k1_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void k1_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the epilogue of one output element
__device__ __forceinline__ void k1_store(void* out, size_t idx, int32_t acc, int32_t b,
                                         const Epilogue8& epi, bool int32_out) {
  if (int32_out)
    static_cast<int32_t*>(out)[idx] = epi.int32(acc, b);
  else
    static_cast<int8_t*>(out)[idx] = static_cast<int8_t>(epi.byte(acc, b));
}

// ---- skinny: M <= 64 -------------------------------------------------------

// ring depth: each thread keeps 1 + 2 MT 16-byte pieces per stage, 2 to 8
// stages in at most ~96 KB of ring per block
template <int MT>
__host__ __device__ constexpr int skinny_stages() {
  constexpr int s = 96 * 1024 / (kK1Threads * 16 * (1 + 2 * MT));
  return s < 2 ? 2 : s > 8 ? 8 : s;
}

template <int MT>
constexpr size_t skinny_smem() {
  return static_cast<size_t>(skinny_stages<MT>()) * (1 + 2 * MT) * kK1Threads * 16;
}

// grid = ceil(N / 8): block b owns output columns 8b .. 8b + 7
template <int MT>
__global__ void __launch_bounds__(kK1Threads)
    k1_skinny_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                     const int32_t* __restrict__ bias, void* __restrict__ out, K1Args a) {
  constexpr int S = skinny_stages<MT>(), P = 1 + 2 * MT, BM = MT * 16;
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int n0 = static_cast<int>(blockIdx.x) * 8;
  const int nst = ((a.K + kChunk - 1) / kChunk + 3) / 4;  // stages: chunk 4 i + warp in stage i
  auto slot = [&](int st, int p) { return smem + ((st * P + p) * kK1Threads + tid) * 16; };
  auto issue = [&](int i) {
    const int k = (4 * i + warp) * kChunk + 16 * t, st = i % S;
    const bool kin = k < a.K;
    k1_cp16(slot(st, 0), kin ? wp + static_cast<size_t>(n0 + g) * a.k_pad + k : wp, kin);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        if (r < a.M)
          k1_cp16(slot(st, 1 + 2 * mt + h), kin ? x + static_cast<size_t>(r) * a.K + k : x, kin);
      }
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < nst) issue(i);
    k1_commit();
  }
  int32_t acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0;
  for (int i = 0; i < nst; ++i) {
    k1_wait<S - 2>();  // this thread's copies of stage i have landed
    const int st = i % S;
    const uint4 b = *reinterpret_cast<const uint4*>(slot(st, 0));
    uint4 lo[MT], hi[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = mt * 16 + g;
      const uint4 z = make_uint4(0, 0, 0, 0);
      lo[mt] = r < a.M ? *reinterpret_cast<const uint4*>(slot(st, 1 + 2 * mt)) : z;
      hi[mt] = r + 8 < a.M ? *reinterpret_cast<const uint4*>(slot(st, 2 + 2 * mt)) : z;
    }
    // slot (i - 1) % S was read in the last iteration: refill it
    if (i + S - 1 < nst) issue(i + S - 1);
    k1_commit();
    // a lane's 16 bytes 16t .. 16t+15 of the chunk: bytes 0-7 are the
    // first step's reduction positions {4t..4t+3, 16+4t..16+4t+3}, bytes
    // 8-15 the second's, for x and w alike
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t a0[4] = {lo[mt].x, hi[mt].x, lo[mt].y, hi[mt].y};
      const uint32_t b0[2] = {b.x, b.y};
      mma_s8(acc[mt], a0, b0);
      const uint32_t a1[4] = {lo[mt].z, hi[mt].z, lo[mt].w, hi[mt].w};
      const uint32_t b1[2] = {b.z, b.w};
      mma_s8(acc[mt], a1, b1);
    }
  }
  k1_wait<0>();
  __syncthreads();  // every warp is done with the ring: its partials go there
  int32_t* red = reinterpret_cast<int32_t*>(smem);  // [4 warps][BM][8]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[(warp * BM + mt * 16 + g + (i >= 2 ? 8 : 0)) * 8 + 2 * t + (i & 1)] = acc[mt][i];
  __syncthreads();
  const Epilogue8 epi(a.net, a.out_signed != 0, a.relu != 0);
  const bool int32_out = a.epilogue == kInt32;
  for (int e = tid; e < BM * 8; e += kK1Threads) {
    const int row = e >> 3, col = n0 + (e & 7);
    if (row >= a.M || col >= a.N) continue;
    // integer adds in uint32: exact mod 2^32 in any order, as one sum
    const uint32_t s = static_cast<uint32_t>(red[e]) + static_cast<uint32_t>(red[BM * 8 + e]) +
                       static_cast<uint32_t>(red[2 * BM * 8 + e]) +
                       static_cast<uint32_t>(red[3 * BM * 8 + e]);
    k1_store(out, static_cast<size_t>(row) * a.N + col, static_cast<int32_t>(s), __ldg(bias + col),
             epi, int32_out);
  }
}

// ---- narrow: N < 32 or K % 16 != 0, many rows --------------------------------

__host__ __device__ constexpr size_t narrow_smem(int K, int N, int k_pad, int esize) {
  return static_cast<size_t>(kNarrowStages) * kNarrowBM * K + 32 +
         static_cast<size_t>(N) * (k_pad + 16) + static_cast<size_t>(kNarrowBM) * N * esize;
}

// 8 x WN warps: warp w takes rows 16 (w % 8) .. + 16 of a 128-row tile and
// every WN-th pass of NCH n8 tiles from pass w / 8 (N / 8 is a multiple of
// NCH); WN = blockDim.x / 256.  Persistent blocks walk tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...
template <int NCH>
__global__ void __launch_bounds__(kNarrowMaxThreads)
    k1_narrow_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                     const int32_t* __restrict__ bias, void* __restrict__ out, K1Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int nthreads = blockDim.x, wrow = warp & 7, wcol = warp >> 3, wn = nthreads >> 8;
  const int K = a.K, N = a.N, ldw = a.k_pad + 16;
  const bool int32_out = a.epilogue == kInt32;
  const int esize = int32_out ? 4 : 1;
  const Epilogue8 epi(a.net, a.out_signed != 0, a.relu != 0);
  const int tile_bytes = kNarrowBM * K;  // K % 4 == 0: a multiple of 512
  int8_t* ring = smem;
  int8_t* sw = ring + kNarrowStages * tile_bytes + 32;  // weights [N][ldw]
  int8_t* stg = sw + N * ldw;                           // output tile [BM][N]
  const int tiles = (a.M + kNarrowBM - 1) / kNarrowBM;
  const int ntile = static_cast<int>(blockIdx.x) < tiles
                        ? (tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1
                        : 0;
  auto issue = [&](int j) {  // tile j of this block: one contiguous run of x
    const int m0 = (static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x)) * kNarrowBM;
    const int bytes = min(kNarrowBM, a.M - m0) * K;
    const int8_t* src = x + static_cast<size_t>(m0) * K;
    int8_t* dst = ring + (j % kNarrowStages) * tile_bytes;
    const int full = bytes & ~15;
    for (int off = tid * 16; off < full; off += nthreads * 16) k1_cp16(dst + off, src + off, true);
    if (tid < (bytes - full) / 4) k1_cp4(dst + full + 4 * tid, src + full + 4 * tid, true);
  };
  // the weights join tile 0's copy group
  const int wchunks = a.k_pad / 16;
  for (int i = tid; i < N * wchunks; i += nthreads) {
    const int n = i / wchunks, c = i - n * wchunks;
    k1_cp16(sw + n * ldw + 16 * c, wp + static_cast<size_t>(n) * a.k_pad + 16 * c, true);
  }
#pragma unroll
  for (int j = 0; j < kNarrowStages - 1; ++j) {
    if (j < ntile) issue(j);
    k1_commit();
  }
  const int nt_all = N / 8, ksteps = a.k_pad / 32;
  for (int j = 0; j < ntile; ++j) {
    k1_wait<kNarrowStages - 2>();
    __syncthreads();  // tile j (and the weights) landed; tile j - 1's stores left staging
    if (j + kNarrowStages - 1 < ntile) issue(j + kNarrowStages - 1);
    k1_commit();
    const int8_t* sx = ring + (j % kNarrowStages) * tile_bytes;
    const int m0 = (static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x)) * kNarrowBM;
    for (int nc = wcol * NCH; nc < nt_all; nc += wn * NCH) {
      int32_t acc[NCH][4];
#pragma unroll
      for (int jn = 0; jn < NCH; ++jn)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[jn][i] = 0;
      for (int ks = 0; ks < ksteps; ++ks) {
        // a k step past K reads the next row's bytes (or the ring's 32-byte
        // tail): they meet zero weights
        const int8_t* p = sx + (16 * wrow + g) * K + 32 * ks + 4 * t;
        const uint32_t af[4] = {lds32(p), lds32(p + 8 * K), lds32(p + 16), lds32(p + 8 * K + 16)};
#pragma unroll
        for (int jn = 0; jn < NCH; ++jn) {
          const int8_t* q = sw + ((nc + jn) * 8 + g) * ldw + 32 * ks + 4 * t;
          const uint32_t bf[2] = {lds32(q), lds32(q + 16)};
          mma_s8(acc[jn], af, bf);
        }
      }
#pragma unroll
      for (int jn = 0; jn < NCH; ++jn) {
        const int col = (nc + jn) * 8 + 2 * t;
        const int32_t b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * wrow + g + 8 * h;
          if (int32_out) {
            *reinterpret_cast<int2*>(stg + (row * N + col) * 4) =
                make_int2(epi.int32(acc[jn][2 * h], b0), epi.int32(acc[jn][2 * h + 1], b1));
          } else {
            *reinterpret_cast<uint16_t*>(stg + row * N + col) = static_cast<uint16_t>(
                __byte_perm(epi.byte(acc[jn][2 * h], b0), epi.byte(acc[jn][2 * h + 1], b1), 0x0040));
          }
        }
      }
    }
    __syncthreads();
    // the tile's rows are one contiguous run of the output: 16-byte stores
    // (N % 8 == 0, so the run is a multiple of 8 bytes)
    const int bytes = min(kNarrowBM, a.M - m0) * N * esize;
    int8_t* dst = static_cast<int8_t*>(out) + static_cast<size_t>(m0) * N * esize;
    const int full = bytes & ~15;
    for (int off = tid * 16; off < full; off += nthreads * 16)
      *reinterpret_cast<uint4*>(dst + off) = *reinterpret_cast<const uint4*>(stg + off);
    if (tid == 0 && full < bytes)
      *reinterpret_cast<uint2*>(dst + full) = *reinterpret_cast<const uint2*>(stg + full);
  }
  k1_wait<0>();
}

// ---- general -----------------------------------------------------------------

// grid = (ceil(M / 64), ceil(N / 64)); VA: bytes per x copy (16: K % 16 == 0)
template <int VA>
__global__ void __launch_bounds__(kK1Threads)
    k1_general_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                      const int32_t* __restrict__ bias, void* __restrict__ out, K1Args a) {
  __shared__ SmemTile ring[kGeneralStages];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int ksteps = (a.K + kBK - 1) / kBK;
  auto issue = [&](int ks) {
    SmemTile& s = ring[ks % kGeneralStages];
    const int k0 = ks * kBK;
    constexpr int kPerRow = kBK / VA;
#pragma unroll
    for (int j = 0; j < kBM * kPerRow / kK1Threads; ++j) {  // A: 64 rows of x
      const int q = tid + j * kK1Threads, row = q / kPerRow, c = (q % kPerRow) * VA;
      const int m = m0 + row, k = k0 + c;
      const bool ok = m < a.M && k < a.K;
      const int8_t* src = ok ? x + static_cast<size_t>(m) * a.K + k : x;
      if constexpr (VA == 16)
        k1_cp16(s.a + row * kLDS + c, src, ok);
      else
        k1_cp4(s.a + row * kLDS + c, src, ok);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // B: 64 packed columns, 4 chunks each
      const int q = tid + j * kK1Threads, n = q >> 2, c = (q & 3) * 16;
      const int nn = n0 + n, k = k0 + c;
      const bool ok = nn < a.n_pad && k < a.k_pad;
      k1_cp16(s.b + n * kLDS + c, ok ? wp + static_cast<size_t>(nn) * a.k_pad + k : wp, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < kGeneralStages - 1; ++i) {
    if (i < ksteps) issue(i);
    k1_commit();
  }
  Acc acc;
  zero_acc(acc);
  for (int ks = 0; ks < ksteps; ++ks) {
    k1_wait<kGeneralStages - 2>();
    __syncthreads();
    if (ks + kGeneralStages - 1 < ksteps) issue(ks + kGeneralStages - 1);
    k1_commit();
    tile_mma(ring[ks % kGeneralStages], acc);
  }
  k1_wait<0>();
  store_tile(acc, m0, n0, a.M, a.N, bias, a.epilogue, a.net, a.out_signed != 0, a.relu != 0, out);
}

// ---- launch --------------------------------------------------------------------

template <typename Kernel>
int k1_launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
              const int8_t* x, const int8_t* wp, const int32_t* bias, void* out, const K1Args& a) {
  kernel<<<grid, threads, smem, stream>>>(x, wp, bias, out, a);
  return static_cast<int>(cudaGetLastError());
}

// the dynamic shared-memory limit of a kernel, raised once per process
template <typename Kernel>
cudaError_t k1_allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

template <int MT>
int launch_skinny(int grid, cudaStream_t st, const int8_t* x, const int8_t* wp,
                  const int32_t* bias, void* out, const K1Args& a) {
  static const cudaError_t attr = k1_allow_smem(k1_skinny_kernel<MT>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return k1_launch(k1_skinny_kernel<MT>, dim3(grid), kK1Threads, skinny_smem<MT>(), st, x, wp,
                   bias, out, a);
}

template <int NCH>
int launch_narrow(int grid, int threads, cudaStream_t st, const int8_t* x, const int8_t* wp,
                  const int32_t* bias, void* out, const K1Args& a) {
  static const cudaError_t attr = k1_allow_smem(k1_narrow_kernel<NCH>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = narrow_smem(a.K, a.N, a.k_pad, a.epilogue == kInt32 ? 4 : 1);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  return k1_launch(k1_narrow_kernel<NCH>, dim3(grid), threads, smem, st, x, wp, bias, out, a);
}

}  // namespace f8

// x: (M, K) int8, K % 4 == 0 (16-byte aligned, or 4-byte in the general
// form at K % 16 != 0); wp: packed weights (N_pad, K_pad) int8 (N_pad =
// N rounded up to 8, K_pad = K rounded up to 32), 16-byte aligned; bias:
// (N,) int32; out: (M, N) int32 (epilogue 0) or int8 (epilogue 1).
// form 0 skinny (M <= 64, K % 16 == 0, grid = ceil(N / 8)); form 1 narrow
// (N % 8 == 0; grid persistent blocks of `warps` = 8 or 16 warps); form 2
// general (vec_a 16 or 4).
extern "C" int f8_int8_gemm(const void* x, const void* wp, const void* bias, void* out, int M,
                            int N, int K, int form, int grid, int warps, int vec_a, int epilogue,
                            int net, int out_signed, int relu, void* stream) {
  const f8::K1Args a{M, N, K, (N + 7) / 8 * 8, (K + 31) / 32 * 32, epilogue, net, out_signed, relu};
  auto* xs = static_cast<const int8_t*>(x);
  auto* w8 = static_cast<const int8_t*>(wp);
  auto* b = static_cast<const int32_t*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 4 || K % 4 != 0 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == 0) {
    if (M > 64 || K % 16 != 0 || grid != (N + 7) / 8) return static_cast<int>(cudaErrorInvalidValue);
    switch ((M + 15) / 16) {
      case 1: return f8::launch_skinny<1>(grid, st, xs, w8, b, out, a);
      case 2: return f8::launch_skinny<2>(grid, st, xs, w8, b, out, a);
      case 3: return f8::launch_skinny<3>(grid, st, xs, w8, b, out, a);
      default: return f8::launch_skinny<4>(grid, st, xs, w8, b, out, a);
    }
  }
  if (form == 1) {
    if (N % 8 != 0 || (warps != 8 && warps != 16)) return static_cast<int>(cudaErrorInvalidValue);
    const int th = 32 * warps;
    const int nt = N / 8;
    const int nch = nt % 6 == 0 ? 6 : nt % 5 == 0 ? 5 : nt % 4 == 0 ? 4 : nt % 3 == 0 ? 3
                                                                         : nt % 2 == 0 ? 2 : 1;
    switch (nch) {
      case 6: return f8::launch_narrow<6>(grid, th, st, xs, w8, b, out, a);
      case 5: return f8::launch_narrow<5>(grid, th, st, xs, w8, b, out, a);
      case 4: return f8::launch_narrow<4>(grid, th, st, xs, w8, b, out, a);
      case 3: return f8::launch_narrow<3>(grid, th, st, xs, w8, b, out, a);
      case 2: return f8::launch_narrow<2>(grid, th, st, xs, w8, b, out, a);
      default: return f8::launch_narrow<1>(grid, th, st, xs, w8, b, out, a);
    }
  }
  if (form != 2 || (vec_a != 16 && vec_a != 4) || (vec_a == 16 && K % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 g2((M + f8::kBM - 1) / f8::kBM, (N + f8::kBN - 1) / f8::kBN);
  const int th = f8::kK1Threads;
  return vec_a == 16
             ? f8::k1_launch(f8::k1_general_kernel<16>, g2, th, 0, st, xs, w8, b, out, a)
             : f8::k1_launch(f8::k1_general_kernel<4>, g2, th, 0, st, xs, w8, b, out, a);
}
