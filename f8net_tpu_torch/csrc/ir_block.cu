// K5: a whole MobileNetV2 inverted-residual block in one kernel, stride 1,
//   e = requant(x . w1 + b1)                  1x1 expand, s8 x s8 -> s32
//   d = requant(depthwise_kxk(e, wd) + bd)    on the unpacked grid values
//   y = d . w2 + b2                           1x1 project, s8 x s8 -> s32
//   y = clip((y << shift_res) + (carry << shift_carry))   optional residual
// then an int32 or requant8 output.
// Replaces f8net_tpu/ops/pallas_ir_block.py:fused_ir_block (:249-329;
// kernel body _ir_kernel :121-217, pallas_call :317), strict rung (int32 and
// requant8 outputs, int32 carry).
//
// Junction math, in the Pallas kernel's order: the expand requant (net1) is
// clamped to the depthwise input's range, which absorbs the ReLU, and its
// values stay UNPACKED (0..255 unsigned, -127..127 signed) in shared memory;
// the depthwise pads with true zeros and adds the plain bias bd; its requant
// (net2) packs for the project (s8 = u8 - 128 when unsigned); the residual
// shifts and adds in uint32 (int32 wraparound, as JAX's) and clips to
// +-INT32_MAX.
//
// What bounds it on an H100: the two 1x1 products are tensor-core work and
// the depthwise is CUDA-core work, and per-layer kernels would move the
// expanded activation (6x the block's width) through device memory four
// times.  Design: one block of 4 warps computes `th` output rows x the full
// width of one image and recomputes the pad-row halo above and below.  The
// block stages its input rows in shared memory (zero outside the image and
// past cin, so Cin = 24 needs no padding in device memory), runs the expand
// on mma.sync tiles (mma_tile.cuh) with w1 streamed through a 64 x 64 tile
// from L2, keeps the expanded rows in shared memory as bytes, runs the
// depthwise from there on the CUDA cores, keeps its output packed in shared
// memory, and runs the project from there with w2 streamed the same way.
// Only x, the weights, the carry and the output touch device memory.  `th`
// is the largest row count that keeps at least one block per SM and the
// block's shared memory under half an SM (two blocks per SM); at 7x7 x 960
// channels one row fits.  No pipelining of the weight tiles yet.
#include <cstdint>

#include "launch.cuh"
#include "mma_tile.cuh"

namespace f8 {

// the most each of two blocks can have on one SM: 228 KB per SM, less 1 KB
// the hardware reserves per block
constexpr int kHalfSmSmem = 233472 / 2 - 1024;
constexpr int32_t kInt32Max = 2147483647;

struct IrParams {
  int n, h, w, cin, ce, cout, k, pad, th;
  int net1, dw_in_signed, net2, proj_in_signed;
  int epilogue, net_out, out_signed;
  int has_carry, shift_res, shift_carry;
};

// Byte offsets of the shared-memory regions and the row strides of the two
// GEMM A operands (a reduction rounded up to 64, plus 16 for the banks).
struct IrLayout {
  int ldx, ldd;
  int x, e, d, wd, bd, total;
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

inline IrLayout ir_layout(const IrParams& p, int th) {
  IrLayout l;
  const int er = th + 2 * p.pad, ewp = p.w + 2 * p.pad;
  l.ldx = round_up(p.cin, kBK) + 16;
  l.ldd = round_up(p.ce, kBK) + 16;
  l.x = kBN * kLDS;                                  // B stage tile at 0
  l.e = l.x + round_up(er * p.w, kBM) * l.ldx;       // input rows
  l.d = l.e + round_up(er * ewp * p.ce, 16);         // expanded rows
  l.wd = l.d + round_up(th * p.w, kBM) * l.ldd;      // depthwise output
  l.bd = l.wd + round_up(p.k * p.k * p.ce, 16);      // depthwise weights
  l.total = l.bd + p.ce * static_cast<int>(sizeof(int32_t));
  return l;
}

inline int pick_rows(const IrParams& p, int sms) {
  int th = 1;
  for (int t = 2; t <= p.h; ++t) {
    if (ir_layout(p, t).total > kHalfSmSmem) break;
    if (static_cast<long long>(p.n) * ((p.h + t - 1) / t) < sms) break;
    th = t;
  }
  return th;
}

__device__ __forceinline__ int32_t shl_wrap(int32_t v, int s) {
  return static_cast<int32_t>(static_cast<uint32_t>(v) << s);
}

__global__ void __launch_bounds__(kThreads)
    ir_block_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w1,
                    const int32_t* __restrict__ b1, const int8_t* __restrict__ wd,
                    const int32_t* __restrict__ bd, const int8_t* __restrict__ w2,
                    const int32_t* __restrict__ b2, const int32_t* __restrict__ carry,
                    void* __restrict__ out, IrParams p, IrLayout l) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sb = smem;
  int8_t* sx = smem + l.x;
  uint8_t* se = reinterpret_cast<uint8_t*>(smem + l.e);
  int8_t* sd = smem + l.d;
  const int8_t* swd = smem + l.wd;
  int32_t* sbd = reinterpret_cast<int32_t*>(smem + l.bd);

  const int img = blockIdx.y, r0 = blockIdx.x * p.th;
  const int rows = min(p.th, p.h - r0);  // output rows of this block
  const int er = p.th + 2 * p.pad;       // expanded rows held, halo included
  const int ewp = p.w + 2 * p.pad;       // expanded row width, zero border included
  const int me = er * p.w;               // expand GEMM rows
  const int mp = rows * p.w;             // project GEMM rows
  const int cw = p.ce / 4;               // 4-byte words per expanded pixel
  const int tid = threadIdx.x;

  // stage the input rows (0 outside the image and past cin), the zero
  // border columns of the expanded rows, and the depthwise weights and bias
  const int8_t* ximg = x + static_cast<size_t>(img) * p.h * p.w * p.cin;
  const int xw = (l.ldx - 16) / 4;
  for (int i = tid; i < me * xw; i += kThreads) {
    const int r = i / xw, k4 = i - r * xw;
    const int y = r0 - p.pad + r / p.w, col = r % p.w;
    uint32_t v = 0u;
    if (y >= 0 && y < p.h && k4 * 4 < p.cin)
      v = *reinterpret_cast<const uint32_t*>(
          ximg + (static_cast<size_t>(y) * p.w + col) * p.cin + k4 * 4);
    *reinterpret_cast<uint32_t*>(sx + r * l.ldx + k4 * 4) = v;
  }
  for (int i = tid; i < er * 2 * p.pad * cw; i += kThreads) {
    const int q = i / cw, c4 = i - q * cw;
    const int row = q / (2 * p.pad), b = q - row * 2 * p.pad;
    const int col = b < p.pad ? b : p.w + b;
    *reinterpret_cast<uint32_t*>(se + (row * ewp + col) * p.ce + c4 * 4) = 0u;
  }
  for (int i = tid; i < p.k * p.k * cw; i += kThreads)
    reinterpret_cast<uint32_t*>(smem + l.wd)[i] = reinterpret_cast<const uint32_t*>(wd)[i];
  for (int i = tid; i < p.ce; i += kThreads) sbd[i] = bd[i];
  __syncthreads();

  // expand: e = requant(x . w1 + b1) as grid values; rows outside the image 0
  for (int m0 = 0; m0 < me; m0 += kBM)
    for (int n0 = 0; n0 < p.ce; n0 += kBN) {
      Acc acc = {};
      for (int k0 = 0; k0 < p.cin; k0 += kBK) {
        load_b_kn<true>(sb, w1 + static_cast<size_t>(k0) * p.ce, p.ce, min(kBK, p.cin - k0), n0);
        __syncthreads();
        tile_mma_ptr(sx + m0 * l.ldx + k0, l.ldx, sb, kLDS, acc);
        __syncthreads();
      }
      for_each_acc(acc, [&](int row, int col, int32_t v) {
        const int r = m0 + row, c = n0 + col;
        if (r >= me || c >= p.ce) return;
        const int e_row = r / p.w, x_col = r - e_row * p.w;
        const int y = r0 - p.pad + e_row;
        const int32_t q = y >= 0 && y < p.h
                              ? requant_value(add_wrap(v, b1[c]), p.net1, p.dw_in_signed != 0)
                              : 0;
        se[(e_row * ewp + x_col + p.pad) * p.ce + c] = static_cast<uint8_t>(q);
      });
    }
  __syncthreads();

  // depthwise on the unpacked values, + bd, requant packed for the project;
  // the reduction tail of each row (ce up to a multiple of 64) is set to 0
  const int dw4 = (l.ldd - 16) / 4;
  const bool dw_signed = p.dw_in_signed != 0;
  for (int i = tid; i < mp * dw4; i += kThreads) {
    const int pix = i / dw4, c4 = i - pix * dw4;
    uint32_t packed = 0u;
    if (c4 < cw) {
      const int orow = pix / p.w, col = pix - orow * p.w;
      int32_t acc[4] = {0, 0, 0, 0};
      for (int ky = 0; ky < p.k; ++ky)
        for (int kx = 0; kx < p.k; ++kx) {
          const uint32_t e = *reinterpret_cast<const uint32_t*>(
              se + ((orow + ky) * ewp + col + kx) * p.ce + c4 * 4);
          const uint32_t wv =
              *reinterpret_cast<const uint32_t*>(swd + (ky * p.k + kx) * p.ce + c4 * 4);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint32_t eb = (e >> (8 * b)) & 0xFFu;
            const int32_t ev = dw_signed ? static_cast<int32_t>(static_cast<int8_t>(eb))
                                         : static_cast<int32_t>(eb);
            acc[b] += ev * static_cast<int32_t>(static_cast<int8_t>(wv >> (8 * b)));
          }
        }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int8_t q =
            requant8(add_wrap(acc[b], sbd[c4 * 4 + b]), p.net2, p.proj_in_signed != 0);
        packed |= static_cast<uint32_t>(static_cast<uint8_t>(q)) << (8 * b);
      }
    }
    *reinterpret_cast<uint32_t*>(sd + pix * l.ldd + c4 * 4) = packed;
  }
  __syncthreads();

  // project: y = d . w2 + b2 (+ aligned, clipped residual), int32 or requant8
  const size_t pix0 = (static_cast<size_t>(img) * p.h + r0) * p.w;
  for (int m0 = 0; m0 < mp; m0 += kBM)
    for (int n0 = 0; n0 < p.cout; n0 += kBN) {
      Acc acc = {};
      for (int k0 = 0; k0 < p.ce; k0 += kBK) {
        load_b_kn<true>(sb, w2 + static_cast<size_t>(k0) * p.cout, p.cout, min(kBK, p.ce - k0),
                        n0);
        __syncthreads();
        tile_mma_ptr(sd + m0 * l.ldd + k0, l.ldd, sb, kLDS, acc);
        __syncthreads();
      }
      for_each_acc(acc, [&](int row, int col, int32_t v) {
        const int r = m0 + row, c = n0 + col;
        if (r >= mp || c >= p.cout) return;
        const size_t idx = (pix0 + r) * p.cout + c;
        int32_t y = add_wrap(v, b2[c]);
        if (p.has_carry) {
          y = add_wrap(shl_wrap(y, p.shift_res), shl_wrap(carry[idx], p.shift_carry));
          y = max(y, -kInt32Max);  // of int32, only INT32_MIN lies outside +-INT32_MAX
        }
        if (p.epilogue == kInt32)
          static_cast<int32_t*>(out)[idx] = y;
        else
          static_cast<int8_t*>(out)[idx] = requant8(y, p.net_out, p.out_signed != 0);
      });
    }
}

}  // namespace f8

// x: (n, h, w, cin) int8, cin % 4 == 0; w1: (cin, ce) int8; wd: (k, k, ce)
// int8, k odd, pad (k-1)/2; w2: (ce, cout) int8; ce % 4 == 0, cout % 4 ==
// 0, every pointer 4-byte aligned; b1, bd: (ce,) int32; b2: (cout,) int32;
// carry: (n, h, w, cout) int32 or null; out: (n, h, w, cout) int32
// (epilogue 0) or int8 (epilogue 1).  Returns cudaErrorInvalidValue when
// even one output row per block needs more shared memory than a block has.
extern "C" int f8_ir_block(const void* x, const void* w1, const void* b1, const void* wd,
                           const void* bd, const void* w2, const void* b2, const void* carry,
                           void* out, int n, int h, int w, int cin, int ce, int cout, int k,
                           int net1, int dw_in_signed, int net2, int proj_in_signed,
                           int epilogue, int net_out, int out_signed, int shift_res,
                           int shift_carry, void* stream) {
  const int has_carry = carry != nullptr;
  f8::IrParams p{n, h, w, cin, ce, cout, k, (k - 1) / 2, 1,
                 net1, dw_in_signed, net2, proj_in_signed,
                 epilogue, net_out, out_signed,
                 has_carry, shift_res, shift_carry};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.th = f8::pick_rows(p, sms);
  const f8::IrLayout l = f8::ir_layout(p, p.th);
  if (l.total > f8::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(f8::ir_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             l.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h + p.th - 1) / p.th, n);
  f8::ir_block_kernel<<<grid, f8::kThreads, l.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1),
      static_cast<const int32_t*>(b1), static_cast<const int8_t*>(wd),
      static_cast<const int32_t*>(bd), static_cast<const int8_t*>(w2),
      static_cast<const int32_t*>(b2), static_cast<const int32_t*>(carry), out, p, l);
  return static_cast<int>(cudaGetLastError());
}
