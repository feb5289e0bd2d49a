// The per-element dither quantiser shared by the port's two quantisation
// kernels, for Hopper (sm_90a): the standalone quantiser (quantize.cu) and
// the quantise-and-multiply kernel (dither_matmul.cu).
//
// It computes, for one f32 element x with its global row-major element index
// idx and the runtime use-counter, the k-bit code of the reference's
// quantize_codes_ref (src/repro/kernels/ref.py, and the in-tile quantiser of
// the TPU kernels _quantize_body / _quantize_tile):
//
//   scaled = (x - zero) * scale
//   deterministic: floor(scaled + 0.5)
//   stochastic:    floor(scaled) + [hash_uniform(seed, idx, counter) < frac]
//   dither:        floor(scaled) + dither_bit(frac, slot, u, N), with
//                  slot = slot_index(counter, idx, N, seed, fmt) and
//                  u = hash_uniform(seed ^ 0xD1CE, idx, counter)
//   code = clip(., 0, 2^bits - 1)
//
// bit for bit: the murmur fmix32 hash, the LCG permutation slot and the
// dither pulse are native uint32 and IEEE f32 in the reference's operation
// order (src/repro/core/rounding.py).  Every f32 multiply, add, subtract and
// divide is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn): nvcc never contracts those into a fused multiply-add,
// and the division is IEEE, both of which the dither pulse's
// (N*f - n) / max(N - n, 1) needs to match the reference.
//
// What a code costs, and what this header does about it.  A dither code is
// some 35 integer operations of the reference's formula (three fmix32
// rounds that depend on the element, the LCG slot, two modulos) and ~25 f32
// ones; on an H100 the integer work bounds every caller (about 1.7e13
// INT32 operations a second: 132 SMs x 64 lanes x 1.98 GHz).  Everything
// that does not depend on the element comes from the host in Params: the
// first hash round mix(seed ^ kGolden) (h0), the slot phase's key, counter
// * kM2, f32(N), the LCG multiplier and the modulo's magic number.  Each
// "% N" is an exact multiply-high reduction (Granlund and Montgomery's
// round-up method: a 32-bit magic and two shifts, exact for every uint32
// numerator), and the dither pulse takes the one IEEE division its branch
// needs.  The host builds Params (kernels/quantize.py:quant_params); the
// card's tests hold mod_n against "%" for every uint32 numerator
// (quantize.cu's fastmod_check).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dither_quant {

enum Scheme : int { kDeterministic = 0, kStochastic = 1, kDither = 2 };
enum Fmt : int { kSpread = 0, kUnary = 1 };

constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;

// One operand's quantiser: codes = clip(round((x - zero) * scale), 0,
// levels).  Only 4-byte fields, in the order of kernels/quantize.py's
// QuantParams, which the host fills and passes by pointer.
struct Params {
  float scale;
  float zero;
  float levels;       // 2^bits - 1
  float n_f;          // f32(n_pulses)
  int scheme;         // Scheme
  int fmt;            // Fmt
  uint32_t h0;        // mix(seed ^ kGolden), seed ^ 0xD1CE for dither
  uint32_t key;       // seed ^ kGolden: the slot phase's key
  uint32_t c2;        // counter * kM2
  uint32_t counter;
  uint32_t n_pulses;  // dither N (>= 1)
  uint32_t mult;      // _coprime_multiplier(N)
  uint32_t magic;     // x % N by multiply-high: see mod_n
  uint32_t sh1;
  uint32_t sh2;
};

// murmur3 fmix32.
__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  h ^= h >> 16;
  return h;
}

// x % N for every uint32 x: q = (t + ((x - t) >> sh1)) >> sh2 with
// t = mulhi(x, magic) is floor(x / N) (Granlund and Montgomery 1994,
// fig. 4.1: l = ceil(log2 N), magic = floor(2^32 (2^l - N) / N) + 1,
// sh1 = min(l, 1), sh2 = max(l - 1, 0)).
__device__ __forceinline__ uint32_t mod_n(uint32_t x, const Params& p) {
  const uint32_t t = __umulhi(x, p.magic);
  const uint32_t q = (t + ((x - t) >> p.sh1)) >> p.sh2;
  return x + q * (0u - p.n_pulses);
}

// Uniform in [0, 1) from (seed, idx, counter): a 24-bit mantissa, exact;
// h0 = mix(seed ^ kGolden) and c2 = counter * kM2 come from the host.
__device__ __forceinline__ float hash_uniform(uint32_t idx, const Params& p) {
  uint32_t h = mix(p.h0 ^ (idx * kM1));
  h = mix(h ^ p.c2);
  return __fmul_rn(__uint2float_rn(h >> 8), 1.0f / 16777216.0f);
}

// x % N, or x & (N - 1) where the caller knows N is a power of two (the
// weight's N_B = max(M, 2) = 8 at batch 8).
template <bool kPow2>
__device__ __forceinline__ uint32_t mod_pulses(uint32_t x, const Params& p) {
  return kPow2 ? x & (p.n_pulses - 1u) : mod_n(x, p);
}

// sigma(i_s mod N): the LCG permutation (spread, Format 2) or the identity
// with a per-element phase (unary, Format 1), both computed and one kept,
// so that no branch splits a caller's run of independent codes.
template <bool kPow2 = false>
__device__ __forceinline__ uint32_t slot_index(uint32_t idx, const Params& p) {
  const uint32_t phase = mix(idx ^ p.key);
  const uint32_t q = mod_pulses<kPow2>(p.counter + phase, p);
  const uint32_t spread = mod_pulses<kPow2>(p.mult * q + (phase >> 8), p);
  return p.fmt == kUnary ? q : spread;
}

// Rounding to an integer on the FP32 pipe, for |v| <= 2^22: v + 1.5 * 2^23
// lies in [2^23, 2^24], where the spacing is 1, so adding it rounding down
// (up) and subtracting it again is floor (ceil), exactly.  Also exact: u
// < 2^23 as f32 through the bits of 2^23 + u, and an integral f32 in
// [0, 2^23) as int through the bits of 2^23 + c.  floorf, ceilf and the
// int-float conversions run on the SM's quarter-rate conversion pipe.
constexpr float kRound = 12582912.0f;   // 1.5 * 2^23
__device__ __forceinline__ float floor_small(float v) {
  return __fsub_rn(__fadd_rd(v, kRound), kRound);
}
__device__ __forceinline__ float ceil_small(float v) {
  return __fsub_rn(__fadd_ru(v, kRound), kRound);
}
__device__ __forceinline__ float u2f_small(uint32_t u) {
  return __fsub_rn(__uint_as_float(0x4B000000u | u), 8388608.0f);
}
__device__ __forceinline__ int code_int(float c) {
  return __float_as_int(__fadd_rn(c, 8388608.0f)) - 0x4B000000;
}

// The dither code of element x (global row-major index idx) as an integral
// f32, with the pulse X_slot of the dither representation of frac in
// [0, 1] taken lazily:
//   frac <= 1/2: n = floor(N f), delta = (N f - n) / (N - n):
//                bit = [slot < n] or Bern(delta)
//   frac >  1/2: n = ceil(N f),  delta = (n - N f) / n:
//                bit = [slot < n] * Bern(1 - delta)
// The reference computes both deltas and selects one; this computes the
// selected one only, from the same operands, so the value is the same; it
// branches nowhere, so a caller's independent codes interleave.
// kSmallN (N <= 2^22, so slot < 2^22 and N f <= 2^22): the roundings on
// the FP32 pipe.  floor_small(scaled) is then floor(scaled) wherever the
// code is not clipped: |scaled| > 2^22 gives fl >= 2^22 - 1 > levels or
// fl <= -2^22, and either way the clip makes the code levels or 0 whatever
// the pulse.
template <bool kSmallN, bool kPow2 = false>
__device__ __forceinline__ float dither_code(float x, uint32_t idx,
                                             const Params& p) {
  const float scaled = __fmul_rn(__fsub_rn(x, p.zero), p.scale);
  const float fl = kSmallN ? floor_small(scaled) : floorf(scaled);
  const float f = __fsub_rn(scaled, fl);
  const uint32_t slot = slot_index<kPow2>(idx, p);
  const float u = hash_uniform(idx, p);
  const bool lo = f <= 0.5f;
  const float nf = __fmul_rn(p.n_f, f);
  const float n = lo ? (kSmallN ? floor_small(nf) : floorf(nf))
                     : (kSmallN ? ceil_small(nf) : ceilf(nf));
  const float num = lo ? __fsub_rn(nf, n) : __fsub_rn(n, nf);
  const float den = lo ? __fsub_rn(p.n_f, n) : n;
  const float q = __fdiv_rn(num, fmaxf(den, 1.0f));
  const float delta = den > 0.0f ? q : 0.0f;
  const bool head = (kSmallN ? u2f_small(slot) : __uint2float_rn(slot)) < n;
  const float prob = head ? (lo ? 1.0f : __fsub_rn(1.0f, delta))
                          : (lo ? delta : 0.0f);
  const float code = __fadd_rn(fl, u < prob ? 1.0f : 0.0f);
  return fminf(fmaxf(code, 0.0f), p.levels);
}

// The code of element x (global row-major index idx) as an integral f32.
__device__ __forceinline__ float quantize(float x, uint32_t idx,
                                          const Params& p) {
  if (p.scheme == kDither) return dither_code<false>(x, idx, p);
  const float scaled = __fmul_rn(__fsub_rn(x, p.zero), p.scale);
  float code;
  if (p.scheme == kDeterministic) {
    code = floorf(__fadd_rn(scaled, 0.5f));
  } else {
    const float fl = floorf(scaled);
    const float frac = __fsub_rn(scaled, fl);
    code = __fadd_rn(fl, hash_uniform(idx, p) < frac ? 1.0f : 0.0f);
  }
  return fminf(fmaxf(code, 0.0f), p.levels);
}

// Whether a call may take the dither fast path (dither_code<true>): the
// scheme is dither and N <= 2^22.
__host__ __device__ __forceinline__ bool fast_path(const Params& p) {
  return p.scheme == kDither && p.n_pulses <= (1u << 22);
}

// quantize() as an int, or, where the caller has checked fast_path(p)
// (and, for kPow2, that N is a power of two), dither_code<true>() as an
// int.
template <bool kFast, bool kPow2 = false>
__device__ __forceinline__ int code_of(float x, uint32_t idx,
                                       const Params& p) {
  return code_int(kFast ? dither_code<true, kPow2>(x, idx, p)
                        : quantize(x, idx, p));
}

__host__ __device__ __forceinline__ bool pow2_pulses(const Params& p) {
  return (p.n_pulses & (p.n_pulses - 1u)) == 0;
}

// f32 rounded to bf16 (nearest even) and widened back: what torch's
// bf16 ops store.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The policy's operand range: clamp_min(absmax, 1e-6) in bf16, from an
// absmax that is a bf16 value held in f32.
__device__ __forceinline__ float clamp_absmax(float amax) {
  return bf16_round(fmaxf(amax, 1e-6f));
}

// x normalised by its operand's absmax as the policy does it in torch:
// bf16(x / absmax), an IEEE f32 division rounded once to bf16.
__device__ __forceinline__ float normalise(float x, float absmax) {
  return bf16_round(__fdiv_rn(x, absmax));
}

// normalise() from r = __frcp_rn(absmax), in three instructions for a
// divisor fixed over the call: q = x r, the residual x - q absmax exact by
// FMA, q + residual r rounded once (Markstein's correction).  Equal to
// normalise() for every bf16 x with |x| <= absmax and every finite bf16
// absmax >= bf16(1e-6): the policy's case, where absmax is the clamped
// max |x| of x's own operand (div_check in dither_matmul.cu tries all such
// pairs on the card; outside |x| <= absmax it is not exact).  Callers use
// normalise() where the absmax is not finite.
__device__ __forceinline__ float normalise_rcp(float x, float absmax,
                                               float r) {
  const float q = __fmul_rn(x, r);
  const float c = __fmaf_rn(__fmaf_rn(-q, absmax, x), r, q);
  return bf16_round(x == 0.0f ? x : c);   // -0 / absmax is -0
}

}  // namespace dither_quant
