// Shared epilogue of the port's integer kernels: bias add, optional ReLU,
// and the static-shift requant of the fxp algebra.
//
// Replaces f8net_tpu/ops/pallas_gemm.py:_requant_i32 (:35-46) and the
// bias/ReLU lines of the Pallas epilogues that call it.  On the TPU the
// shift was a trace-time constant; here it is a runtime argument, so one
// compiled kernel serves every layer.
//
// int32 arithmetic must wrap exactly as JAX's does.  Signed overflow is
// undefined behaviour in C++, so every add that can leave the int32 range
// (bias add, the rounding bias acc + 2^(net-1), the left shift) is done in
// uint32 and cast back, which is two's-complement wraparound.
#pragma once

#include <cstdint>

namespace f8 {

enum Epilogue : int { kInt32 = 0, kRequant8 = 1 };

__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// acc + bias (wrapping), then ReLU when asked
__device__ __forceinline__ int32_t bias_relu(int32_t acc, int32_t bias, bool relu) {
  const int32_t v = add_wrap(acc, bias);
  return relu ? max(v, 0) : v;
}

// Shift right by net with round-half-to-even (net > 0) or left by -net
// (net <= 0), clamp to the 8-bit range -- symmetric -127..127 when signed,
// 0..255 when not -- and store unsigned values as s8 = u - 128 (the packed
// operand of the next conv).  Requires -31 < net < 31 (checked by callers).
//
// Round-half-to-even, as f8net_tpu/ops/fxp.py:shift_requant:
//   res = v + 2^(net-1)                          (wraps)
//   tie = (v mod 2^net) == 2^(net-1)             (mod of a power of two is
//                                                 the low bits of the two's
//                                                 complement, as jnp.mod)
//   res = tie ? (res >> (net+1)) << 1 : res >> net   (arithmetic shifts)
//
// requant_value returns the clamped grid value itself (-127..127 or
// 0..255); requant8 packs it.
__device__ __forceinline__ int32_t requant_value(int32_t v, int net, bool out_signed) {
  int32_t r;
  if (net > 0) {
    const uint32_t half = 1u << (net - 1);
    const int32_t biased = static_cast<int32_t>(static_cast<uint32_t>(v) + half);
    const bool tie = (static_cast<uint32_t>(v) & ((1u << net) - 1u)) == half;
    // |biased >> (net+1)| < 2^30, so doubling it cannot overflow
    r = tie ? (biased >> (net + 1)) * 2 : (biased >> net);
  } else {
    r = static_cast<int32_t>(static_cast<uint32_t>(v) << (-net));
  }
  return out_signed ? min(max(r, -127), 127) : min(max(r, 0), 255);
}

__device__ __forceinline__ int8_t requant8(int32_t v, int net, bool out_signed) {
  const int32_t r = requant_value(v, net, out_signed);
  return static_cast<int8_t>(out_signed ? r : r - 128);
}

}  // namespace f8
