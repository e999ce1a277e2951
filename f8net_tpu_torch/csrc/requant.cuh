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
#include <climits>

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

// bias_relu and requant8 with the call's constants worked out once, for
// kernels whose time goes to the epilogue (K1, K4): per element an add, a
// max, an add, two shifts, a tie test, a clamp and an offset, with no
// branch on net, relu or out_signed.  The same values:
//   * relu is max(v, 0), and no relu max(v, INT32_MIN);
//   * with s = v + 2^(net-1) (wrapping), v's low net bits equal 2^(net-1)
//     exactly when s's are 0, and then (s >> (net+1)) * 2 == (s >> net) & ~1
//     (arithmetic shifts), so a tie clears the low bit;
//   * net <= 0 shifts left by -net, adds nothing, and never ties (mask 0
//     against tie value 1).
struct Epilogue8 {
  int32_t floor, lo, hi, off;
  uint32_t half, mask, tie;
  int shr, shl;

  __device__ __forceinline__ Epilogue8(int net, bool out_signed, bool relu)
      : floor(relu ? 0 : INT32_MIN),
        lo(out_signed ? -127 : 0),
        hi(out_signed ? 127 : 255),
        off(out_signed ? 0 : 128),
        half(net > 0 ? 1u << (net - 1) : 0u),
        mask(net > 0 ? (1u << net) - 1u : 0u),
        tie(net > 0 ? 0u : 1u),
        shr(net > 0 ? net : 0),
        shl(net > 0 ? 0 : -net) {}

  // the int32 epilogue: acc + bias (wrapping), then the ReLU
  __device__ __forceinline__ int32_t int32(int32_t acc, int32_t bias) const {
    return max(add_wrap(acc, bias), floor);
  }

  // the requant8 epilogue's stored byte (-128..127), as an int
  __device__ __forceinline__ int32_t byte(int32_t acc, int32_t bias) const {
    const uint32_t s = static_cast<uint32_t>(int32(acc, bias)) + half;
    int32_t r = static_cast<int32_t>(static_cast<uint32_t>(static_cast<int32_t>(s) >> shr) << shl);
    if ((s & mask) == tie) r &= ~1;
    return min(max(r, lo), hi) - off;
  }
};

// the low bytes of four ints, packed into one word (byte i from v_i)
__device__ __forceinline__ uint32_t pack4(int32_t v0, int32_t v1, int32_t v2, int32_t v3) {
  return __byte_perm(__byte_perm(v0, v1, 0x0040), __byte_perm(v2, v3, 0x0040), 0x5410);
}

}  // namespace f8
