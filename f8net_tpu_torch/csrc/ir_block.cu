// K5: a whole MobileNetV2 inverted-residual block in one kernel, stride 1,
//   e = requant(x . w1 + b1)                  1x1 expand, s8 x s8 -> s32
//   d = requant(depthwise_kxk(e, wd) + bd)    on the unpacked grid values
//   y = d . w2 + b2                           1x1 project, s8 x s8 -> s32
//   y = clip((y << shift_res) + ((carry + offset) << shift_carry))   optional
// then an int32, requant8 or bf16 output.
// Replaces f8net_tpu/ops/pallas_ir_block.py:fused_ir_block (:249-329;
// kernel body _ir_kernel :121-217, pallas_call :317) in all its forms: the
// carry is int32 (strict rung) or a 1-byte operand packed for the block's
// expand (int8-boundary rung), widened as (int32)c + carry_add_offset (128
// for an unsigned grid's u - 128) before the shift; the output is int32,
// requant8, or the real value y * 2^-out_fl in bf16 (bf16-boundary rung),
// rounded twice as the reference does: int32 -> float32 (__int2float_rn),
// an exact multiply by 2^-out_fl, float32 -> bf16 (__float2bfloat16_rn) --
// not __int2bfloat16_rn, which rounds once and differs for |y| >= 2^24.
//
// Junction math, in the Pallas kernel's order: the expand requant (net1) is
// clamped to the depthwise input's range, which absorbs the ReLU, and its
// values stay UNPACKED (0..255 unsigned, -127..127 signed) in shared memory;
// the depthwise pads with true zeros and adds the plain bias bd; its requant
// (net2) packs for the project (s8 = u8 - 128 when unsigned); the residual
// shifts and adds in uint32 (int32 wraparound, as JAX's) and clips to
// +-INT32_MAX.
//
// What bounds it on an H100: the two 1x1 products are tensor-core work, the
// depthwise CUDA-core work, and per-layer kernels would move the expanded
// activation (6x the block's width) through device memory four times; fused,
// only x, the weights, the carry and the output touch device memory, so at
// MobileNetV2's shapes bytes bound it (0.0054 ms for the 12 calls at batch
// 8).  What held the mma.sync version of this kernel at 266x that bound, and
// what this design does about each:
//   * serial weight stages (an L2 transpose of a 64 x 64 tile of w1 or w2,
//     a barrier, one mma.sync tile, a barrier, 90 times a block at 7x7 x
//     960): w1 and w2 are packed once on the host into wgmma's K-major
//     16-byte-chunk image (ops/gemm_v2.py:pack_gemm_weight), and a block
//     copies its whole slice of both with cp.async at its start, in two
//     groups -- x and the w1 slice first, the w2 slice second, in flight
//     under the expand and the depthwise;
//   * one mma.sync tile at a time on 64-row tiles holding 7-21 rows: the
//     products are wgmma m64nNk32 (N = 64, and 32 for a slice's or cout's
//     32-channel tail, wgmma_s8.cuh) from shared memory, the two warpgroups
//     of a block taking alternate (64-row, N-column) tiles, each running its
//     whole reduction (up to 30 k32 steps) before one wait;
//   * a grid of (ceil(h / th), n) blocks with th = 1 at 28x28 and below
//     (56 blocks at 7x7, each expanding 3 rows to make 1): the planner
//     (ops/ir_block.py:plan_ir) chooses a band height th and a split of the
//     expanded channels Ce across the s blocks of a thread-block cluster.
//     The depthwise is per channel, so a block needs only its own slice's
//     expand columns and depthwise channels, and it computes a partial
//     project over that slice of the reduction; the cluster sums the
//     partials through distributed shared memory (integer adds, exact in any
//     order) and each block runs the carry add and the epilogue once on its
//     share of the band's pixels, as K2's split-K does.  At 7x7 a block holds
//     a whole image (no halo) and an eighth of Ce: 64 blocks instead of 56
//     blocks of a third of the work;
//   * every block read all of w1 and w2 (307 KB at 7x7 x 960): a block reads
//     its slice only;
//   * the epilogue stores from the accumulator fragment: the partial project
//     is staged in shared memory and the epilogue writes 16-byte int32
//     (8-byte bf16, 4-byte int8) row-contiguous groups of 4 channels,
//     reading the carry the same way (16 or 4 bytes).  A block's carry rows
//     start at element (pix0 + rlo) * cout, which for a 1-byte carry at
//     cout = 24 is 8-byte aligned at best: that carry is copied in pieces
//     of 16, 8 or 4 bytes, the widest that cout allows.
// The depthwise stays on the CUDA cores, from shared memory: one thread per
// (pixel, 4-channel group), its k*k taps read from the expanded rows with
// their zero border.  The layout of shared memory and the plan come from the
// wrapper (IrParams, in the order of ops/ir_block.py:_PARAMS).
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "launch.cuh"
#include "mma_tile.cuh"
#include "requant.cuh"
#include "wgmma_s8.cuh"

namespace f8 {

constexpr int kIrThreads = 256;  // two warpgroups
constexpr int32_t kInt32Max = 2147483647;
enum IrOut : int { kOutInt32 = 0, kOutRequant8 = 1, kOutBf16 = 2 };

// The plan and shared-memory layout, as ops/ir_block.py computes them (all
// offsets in bytes from the start of dynamic shared memory).
struct IrParams {
  int n, h, w, cin, ce, cout, k, pad;
  int th, cs, splits, cin_k, ce_pad, cout32, cout_pad, xvec;
  int net1, dw_in_signed, net2, proj_in_signed, epilogue, net_out, out_signed;
  int shift_res, shift_carry, out_fl, carry_offset, ld_x, ld_d, ld_p, carry_bytes;
  int o_w2, o_d, o_wd, o_bd, o_b1, o_b2, o_c, o_x, o_w1, o_e, o_p, total;
  int has_carry;  // set by the C entry
};

__device__ __forceinline__ int32_t shl_wrap(int32_t v, int s) {
  return static_cast<int32_t>(static_cast<uint32_t>(v) << s);
}

// asynchronous copy of 4 or 8 bytes global -> shared (cp.async.ca), zeros
// when !valid
template <int kBytes>
__device__ __forceinline__ void cp_async_small(int8_t* dst, const int8_t* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(kBytes), "r"(valid ? kBytes : 0));
}

// One warpgroup's product of a 64-row tile of A (chunked K-major, lda_rows
// rows per chunk, from `a`) and an N-column tile of B (chunked K-major,
// ldb_rows rows per chunk, from `b`) over ksteps k32 steps, then f(row,
// col, v0, v1) for the pairs of adjacent columns each thread holds (row and
// col relative to the tile).
template <int N, class F>
__device__ __forceinline__ void wg_product(const int8_t* a, int lda_rows, const int8_t* b,
                                           int ldb_rows, int ksteps, F&& f) {
  int32_t acc[N / 2];
  wgmma_fence();
  for (int ks = 0; ks < ksteps; ++ks) {
    const uint64_t da = smem_desc(a + ks * 2 * lda_rows * 16, lda_rows * 16, 128);
    const uint64_t db = smem_desc(b + ks * 2 * ldb_rows * 16, ldb_rows * 16, 128);
    wgmma_s8<N>(acc, da, db, ks > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  const int lane = threadIdx.x & 31;
  const int row = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      f(row + 8 * hh, 8 * j + col, acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
}

// K: the depthwise kernel size when known at compile time (3: MobileNetV2's),
// else 0
template <int K>
__global__ void __launch_bounds__(kIrThreads, 2)
    ir_block_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w1p,
                    const int32_t* __restrict__ b1, const int8_t* __restrict__ wd,
                    const int32_t* __restrict__ bd, const int8_t* __restrict__ w2p,
                    const int32_t* __restrict__ b2, const int8_t* __restrict__ carry,
                    void* __restrict__ out, IrParams p) {
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* sw2 = smem + p.o_w2;
  int8_t* sd = smem + p.o_d;
  int8_t* swd = smem + p.o_wd;
  int32_t* sbd = reinterpret_cast<int32_t*>(smem + p.o_bd);
  int32_t* sb1 = reinterpret_cast<int32_t*>(smem + p.o_b1);
  int32_t* sb2 = reinterpret_cast<int32_t*>(smem + p.o_b2);
  int8_t* sc = smem + p.o_c;  // this block's carry rows, carry_bytes per element
  int8_t* sx = smem + p.o_x;
  int8_t* sw1 = smem + p.o_w1;
  uint8_t* se = reinterpret_cast<uint8_t*>(smem + p.o_e);
  int8_t* sp = smem + p.o_p;  // the partial project; overlays sx, sw1 and se

  const int tid = threadIdx.x, wg = tid >> 7;
  const int q = blockIdx.x, img = blockIdx.z;
  const int r0 = blockIdx.y * p.th, rows = min(p.th, p.h - r0);  // output rows of the band
  const int e_lo = max(r0 - p.pad, 0), e_hi = min(r0 + rows + p.pad, p.h);
  const int me = (e_hi - e_lo) * p.w;  // expand rows: the band's in-image rows, halo included
  const int mp = rows * p.w;           // project rows
  const int ewp = p.w + 2 * p.pad;     // expanded row width, zero border included
  const int c0 = q * p.cs, cw = min(p.cs, (p.ce + 31) / 32 * 32 - c0);  // the channel slice
  const int rlo = q * mp / p.splits, rhi = (q + 1) * mp / p.splits;  // pixels this block finishes
  const size_t pix0 = (static_cast<size_t>(img) * p.h + r0) * p.w;

  // group 0: the band's input rows (chunked K-major) and the w1 slice
  const int8_t* xb = x + (static_cast<size_t>(img) * p.h + e_lo) * p.w * p.cin;
  const int xch = p.cin_k / 16;
  if (p.xvec == 16) {
    for (int i = tid; i < me * xch; i += kIrThreads) {
      const int r = i / xch, j = i - r * xch;
      const bool ok = 16 * j < p.cin;
      cp_async16(sx + (j * p.ld_x + r) * 16, ok ? xb + static_cast<size_t>(r) * p.cin + 16 * j : x,
                 ok);
    }
  } else {  // cin % 16 != 0 (MobileNetV2's 24): 8- or 4-byte pieces, zero past cin
    const int per = 16 / p.xvec;
    for (int i = tid; i < me * xch * per; i += kIrThreads) {
      const int r = i / (xch * per), rem = i - r * xch * per, j = rem / per;
      const int b = j * 16 + (rem - j * per) * p.xvec;
      const bool ok = b < p.cin;
      int8_t* dst = sx + (j * p.ld_x + r) * 16 + (b - j * 16);
      const int8_t* src = ok ? xb + static_cast<size_t>(r) * p.cin + b : x;
      if (p.xvec == 8)
        cp_async_small<8>(dst, src, ok);
      else
        cp_async_small<4>(dst, src, ok);
    }
  }
  for (int i = tid; i < xch * cw; i += kIrThreads) {
    const int j = i / cw, r = i - j * cw;
    cp_async16(sw1 + (j * p.cs + r) * 16, w1p + (static_cast<size_t>(j) * p.ce_pad + c0 + r) * 16,
               true);
  }
  cp_async_commit();
  // group 1: the w2 slice, rows c0 .. c0 + cw of the project's reduction
  for (int i = tid; i < (cw / 16) * p.cout32; i += kIrThreads) {
    const int j = i / p.cout32, r = i - j * p.cout32;
    cp_async16(sw2 + (j * p.cout32 + r) * 16,
               w2p + (static_cast<size_t>(c0 / 16 + j) * p.cout_pad + r) * 16, true);
  }
  cp_async_commit();
  // group 2: the carry of the pixels this block finishes, for the epilogue,
  // in the widest pieces its alignment allows (an int32 carry's rows are
  // always 16-byte aligned: cout % 4 == 0)
  if (p.has_carry) {
    const int8_t* src = carry + (pix0 + rlo) * p.cout * p.carry_bytes;
    const int bytes = (rhi - rlo) * p.cout * p.carry_bytes;
    const int row_bytes = p.cout * p.carry_bytes;
    if (row_bytes % 16 == 0) {
      for (int i = tid; i < bytes / 16; i += kIrThreads) cp_async16(sc + 16 * i, src + 16 * i, true);
    } else if (row_bytes % 8 == 0) {
      for (int i = tid; i < bytes / 8; i += kIrThreads)
        cp_async_small<8>(sc + 8 * i, src + 8 * i, true);
    } else {
      for (int i = tid; i < bytes / 4; i += kIrThreads)
        cp_async_small<4>(sc + 4 * i, src + 4 * i, true);
    }
  }
  cp_async_commit();
  // the slice's depthwise weights and biases, 0 past ce; the zero border
  // columns of the expanded rows and their rows outside the image
  const int cw4 = cw / 4, cs4 = p.cs / 4;
  for (int i = tid; i < p.k * p.k * cw4; i += kIrThreads) {
    const int tap = i / cw4, c = 4 * (i - tap * cw4);
    reinterpret_cast<uint32_t*>(swd)[tap * cs4 + c / 4] =
        c0 + c < p.ce ? *reinterpret_cast<const uint32_t*>(wd + tap * p.ce + c0 + c) : 0u;
  }
  for (int c = tid; c < cw; c += kIrThreads) {
    sbd[c] = c0 + c < p.ce ? bd[c0 + c] : 0;
    sb1[c] = c0 + c < p.ce ? b1[c0 + c] : 0;
  }
  for (int c = tid; c < p.cout; c += kIrThreads) sb2[c] = b2[c];
  {
    const int row_words = ewp * cs4, pad_words = p.pad * cs4;
    for (int i = tid; i < (rows + 2 * p.pad) * row_words; i += kIrThreads) {
      const int er = i / row_words, word = i - er * row_words, y = r0 - p.pad + er;
      if (y < 0 || y >= p.h || word < pad_words || word >= row_words - pad_words)
        reinterpret_cast<uint32_t*>(se)[i] = 0u;
    }
  }
  cp_async_wait<2>();  // x and the w1 slice
  fence_proxy_async();
  __syncthreads();

  // expand: e = requant(x . w1 + b1) onto the depthwise's grid, unpacked,
  // into the expanded rows at (band row, column + pad)
  const int e_off = e_lo - (r0 - p.pad);  // band row of the first expand row
  const int nt64e = cw / 64, nte = nt64e + (cw % 64 ? 1 : 0), mte = (me + 63) / 64;
  const bool dw_signed = p.dw_in_signed != 0;
  for (int it = wg; it < mte * nte; it += 2) {
    const int mt = it / nte, nt = it - mt * nte;
    const int8_t* a = sx + mt * 64 * 16;
    const int8_t* b = sw1 + nt * 64 * 16;
    auto put = [&](int row, int col, int32_t v0, int32_t v1) {
      const int r = mt * 64 + row;
      if (r >= me) return;
      const int er = e_off + r / p.w, xc = r - (r / p.w) * p.w, c = nt * 64 + col;
      const uint32_t e0 = static_cast<uint8_t>(requant_value(add_wrap(v0, sb1[c]), p.net1, dw_signed));
      const uint32_t e1 =
          static_cast<uint8_t>(requant_value(add_wrap(v1, sb1[c + 1]), p.net1, dw_signed));
      *reinterpret_cast<uint16_t*>(se + (er * ewp + xc + p.pad) * p.cs + c) =
          static_cast<uint16_t>(e0 | (e1 << 8));
    };
    if (nt < nt64e)
      wg_product<64>(a, p.ld_x, b, p.cs, p.cin_k / 32, put);
    else
      wg_product<32>(a, p.ld_x, b, p.cs, p.cin_k / 32, put);
  }
  __syncthreads();

  // depthwise on the unpacked values, + bd, requant packed for the project,
  // into the project's A operand (chunked K-major, ld_d rows per chunk).
  // Thread t keeps one 4-channel group, cb + t % ng, and its k*k weight
  // words in registers, and walks pixels t / ng, t / ng + step, ...
  const int kk = K > 0 ? K : p.k;
  for (int cb = 0; cb < cw4; cb += kIrThreads) {
    const int ng = min(cw4 - cb, kIrThreads), step = kIrThreads / ng;
    if (tid >= step * ng) continue;
    const int c = 4 * (cb + tid % ng);
    uint32_t wr[K > 0 ? K * K : 1];
    if constexpr (K > 0) {
#pragma unroll
      for (int t = 0; t < K * K; ++t) wr[t] = *reinterpret_cast<const uint32_t*>(swd + t * p.cs + c);
    }
    int32_t bdv[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) bdv[b] = sbd[c + b];
    int pix = tid / ng;
    int orow = pix / p.w, col = pix - orow * p.w;
    const int dr = step / p.w, dc = step - dr * p.w;
    int8_t* dst = sd + (c / 16) * p.ld_d * 16 + c % 16;
    for (; pix < mp; pix += step) {
      int32_t acc[4] = {0, 0, 0, 0};
      const uint8_t* e0 = se + (orow * ewp + col) * p.cs + c;
#pragma unroll
      for (int ky = 0; ky < kk; ++ky)
#pragma unroll
        for (int kx = 0; kx < kk; ++kx) {
          const uint32_t e = *reinterpret_cast<const uint32_t*>(e0 + (ky * ewp + kx) * p.cs);
          uint32_t wv;
          if constexpr (K > 0)
            wv = wr[ky * K + kx];
          else
            wv = *reinterpret_cast<const uint32_t*>(swd + (ky * kk + kx) * p.cs + c);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint32_t eb = (e >> (8 * b)) & 0xFFu;
            const int32_t ev = dw_signed ? static_cast<int32_t>(static_cast<int8_t>(eb))
                                         : static_cast<int32_t>(eb);
            acc[b] += ev * static_cast<int32_t>(static_cast<int8_t>(wv >> (8 * b)));
          }
        }
      uint32_t packed = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int8_t v = requant8(add_wrap(acc[b], bdv[b]), p.net2, p.proj_in_signed != 0);
        packed |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * b);
      }
      *reinterpret_cast<uint32_t*>(dst + pix * 16) = packed;
      col += dc;
      orow += dr;
      if (col >= p.w) {
        col -= p.w;
        ++orow;
      }
    }
  }
  fence_proxy_async();
  cp_async_wait<1>();  // the w2 slice
  fence_proxy_async();
  __syncthreads();

  // project: the partial y = d . w2 over this slice of Ce, raw, into the
  // staging rows (row stride ld_p) that now overlay the expand's buffers
  const int nt64p = p.cout32 / 64, ntp = nt64p + (p.cout32 % 64 ? 1 : 0), mtp = (mp + 63) / 64;
  for (int it = wg; it < mtp * ntp; it += 2) {
    const int mt = it / ntp, nt = it - mt * ntp;
    const int8_t* a = sd + mt * 64 * 16;
    const int8_t* b = sw2 + nt * 64 * 16;
    auto put = [&](int row, int col, int32_t v0, int32_t v1) {
      const int r = mt * 64 + row;
      if (r < mp)
        *reinterpret_cast<int2*>(sp + r * p.ld_p + (nt * 64 + col) * 4) = make_int2(v0, v1);
    };
    if (nt < nt64p)
      wg_product<64>(a, p.ld_d, b, p.cout32, cw / 32, put);
    else
      wg_product<32>(a, p.ld_d, b, p.cout32, cw / 32, put);
  }

  // the slices' partials summed (one block: its own), + b2, the carry add,
  // the output epilogue; block q of a cluster finishes rows
  // [q * mp / s, (q + 1) * mp / s) of the band
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cp_async_wait<0>();  // the carry
  if (p.splits > 1)
    cluster.sync();
  else
    __syncthreads();
  const int cq = p.cout / 4;
  const float out_scale = ldexpf(1.0f, -p.out_fl);  // exact: a power of two
  for (int i = tid; i < (rhi - rlo) * cq; i += kIrThreads) {
    const int r = rlo + i / cq, c = 4 * (i - (i / cq) * cq);
    // every rank's partial loaded before any is added: the (distributed)
    // shared-memory reads are in flight together
    int4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < p.splits)
        v[k] = *reinterpret_cast<const int4*>(
            (p.splits > 1 ? cluster.map_shared_rank(sp, k) : sp) + r * p.ld_p + c * 4);
    uint32_t s[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < p.splits) {
        s[0] += static_cast<uint32_t>(v[k].x);
        s[1] += static_cast<uint32_t>(v[k].y);
        s[2] += static_cast<uint32_t>(v[k].z);
        s[3] += static_cast<uint32_t>(v[k].w);
      }
    const size_t idx = (pix0 + r) * p.cout + c;
    int32_t y[4];
    int32_t cc[4] = {0, 0, 0, 0};
    if (p.has_carry) {
      const int8_t* crow = sc + ((r - rlo) * p.cout + c) * p.carry_bytes;
      if (p.carry_bytes == 4) {
        const int4 cv = *reinterpret_cast<const int4*>(crow);
        cc[0] = cv.x, cc[1] = cv.y, cc[2] = cv.z, cc[3] = cv.w;
      } else {
        const uint32_t cv = *reinterpret_cast<const uint32_t*>(crow);
#pragma unroll
        for (int e = 0; e < 4; ++e) cc[e] = static_cast<int8_t>(cv >> (8 * e));
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      y[e] = add_wrap(static_cast<int32_t>(s[e]), sb2[c + e]);
      if (p.has_carry) {
        // widen, then offset, then shift: (c + 128) << shift_carry on an
        // unsigned grid, every step wrapping in uint32 as JAX's int32 does
        const int32_t widened = add_wrap(cc[e], p.carry_offset);
        y[e] = add_wrap(shl_wrap(y[e], p.shift_res), shl_wrap(widened, p.shift_carry));
        y[e] = max(y[e], -kInt32Max);  // of int32, only INT32_MIN lies outside +-INT32_MAX
      }
    }
    if (p.epilogue == kOutInt32) {
      *reinterpret_cast<int4*>(static_cast<int32_t*>(out) + idx) = make_int4(y[0], y[1], y[2], y[3]);
    } else if (p.epilogue == kOutBf16) {
      uint32_t h[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const __nv_bfloat16 lo = __float2bfloat16_rn(__int2float_rn(y[2 * e]) * out_scale);
        const __nv_bfloat16 hi = __float2bfloat16_rn(__int2float_rn(y[2 * e + 1]) * out_scale);
        h[e] = static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
               (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
      }
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + idx) = make_uint2(h[0], h[1]);
    } else {
      uint32_t v = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v |= static_cast<uint32_t>(static_cast<uint8_t>(requant8(y[e], p.net_out, p.out_signed != 0)))
             << (8 * e);
      *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + idx) = v;
    }
  }
  if (p.splits > 1) cluster.sync();  // keep this block's partial alive for the others
}

template <int K>
int launch_ir(const void* x, const void* w1p, const void* b1, const void* wd, const void* bd,
              const void* w2p, const void* b2, const void* carry, void* out, const IrParams& p,
              cudaStream_t stream) {
  // the shared-memory limit is raised once per process, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      ir_block_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, (p.h + p.th - 1) / p.th, p.n);
  cfg.blockDim = dim3(kIrThreads);
  cfg.dynamicSmemBytes = p.total;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, ir_block_kernel<K>, static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1p),
      static_cast<const int32_t*>(b1), static_cast<const int8_t*>(wd),
      static_cast<const int32_t*>(bd), static_cast<const int8_t*>(w2p),
      static_cast<const int32_t*>(b2), static_cast<const int8_t*>(carry), out, p);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace f8

// x: (n, h, w, cin) int8, xvec-byte aligned (16 if cin % 16 == 0, else 8 or
// 4); w1p, w2p: packed weights (cin_k / 16 .. , ce_pad, 16) and
// (.., cout_pad, 16) int8, 16-byte aligned; wd: (k, k, ce) int8; b1, bd:
// (ce,) int32; b2: (cout,) int32; carry: (n, h, w, cout) int32 or int8
// (carry_bytes 4 or 1), 16-byte aligned, or null; out: (n, h, w, cout) int32
// (epilogue 0), int8 (epilogue 1) or bf16 (epilogue 2); params: the IrParams
// fields up to `total`, in order, from ops/ir_block.py.  The grid is (splits, bands, n), a cluster of `splits`
// blocks per band.
extern "C" int f8_ir_block(const void* x, const void* w1p, const void* b1, const void* wd,
                           const void* bd, const void* w2p, const void* b2, const void* carry,
                           void* out, const int* params, int nparams, void* stream) {
  f8::IrParams p;
  constexpr int kFields = sizeof(f8::IrParams) / sizeof(int) - 1;
  if (nparams != kFields) return static_cast<int>(cudaErrorInvalidValue);
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < kFields; ++i) dst[i] = params[i];
  p.has_carry = carry != nullptr;
  if (p.splits < 1 || p.splits > 8 || p.total > f8::kMaxSmem || p.epilogue < 0 || p.epilogue > 2 ||
      (p.has_carry && p.carry_bytes != 1 && p.carry_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (p.k == 3) return f8::launch_ir<3>(x, w1p, b1, wd, bd, w2p, b2, carry, out, p, st);
  return f8::launch_ir<0>(x, w1p, b1, wd, bd, w2p, b2, carry, out, p, st);
}
