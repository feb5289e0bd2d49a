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
// (N*f - n) / max(N - n, 1) needs to match the reference.  The LCG
// multiplier (the reference's _coprime_multiplier(N)) is computed on the host
// and passed in, as the TPU kernels take it as a static.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace dither_quant {

enum Scheme : int { kDeterministic = 0, kStochastic = 1, kDither = 2 };
enum Fmt : int { kSpread = 0, kUnary = 1 };

constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kDitherTail = 0xD1CEu;

// One operand's quantiser: codes = clip(round((x - zero) * scale), 0, levels).
struct Params {
  float scale;
  float zero;
  float levels;       // 2^bits - 1
  int scheme;         // Scheme
  int fmt;            // Fmt
  uint32_t seed;
  uint32_t n_pulses;  // dither N (>= 2)
  uint32_t mult;      // _coprime_multiplier(N), from the host
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

// Uniform in [0, 1) from (seed, idx, counter): a 24-bit mantissa, exact.
__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t idx,
                                              uint32_t counter) {
  uint32_t h = mix(seed ^ kGolden);
  h = mix(h ^ (idx * kM1));
  h = mix(h ^ (counter * kM2));
  return __fmul_rn(__uint2float_rn(h >> 8), 1.0f / 16777216.0f);
}

// sigma(i_s mod N): the LCG permutation (spread, Format 2) or the identity
// with a per-element phase (unary, Format 1).
__device__ __forceinline__ uint32_t slot_index(uint32_t counter, uint32_t idx,
                                               const Params& p) {
  const uint32_t phase = mix(idx ^ p.seed ^ kGolden);
  const uint32_t q = (counter + phase) % p.n_pulses;
  if (p.fmt == kUnary) return q;
  return (p.mult * q + (phase >> 8)) % p.n_pulses;
}

// Pulse X_slot of the dither representation of frac in [0, 1], lazily:
//   frac <= 1/2: n = floor(N f), delta = (N f - n) / (N - n):
//                bit = [slot < n] or Bern(delta)
//   frac >  1/2: n = ceil(N f),  delta = (n - N f) / n:
//                bit = [slot < n] * Bern(1 - delta)
__device__ __forceinline__ float dither_bit(float f, uint32_t slot, float u,
                                            float n_f) {
  const bool lo = f <= 0.5f;
  const float nf = __fmul_rn(n_f, f);
  const float n_lo = floorf(nf);
  const float den_lo = __fsub_rn(n_f, n_lo);
  const float delta_lo =
      den_lo > 0.0f ? __fdiv_rn(__fsub_rn(nf, n_lo), fmaxf(den_lo, 1.0f))
                    : 0.0f;
  const float n_hi = ceilf(nf);
  const float delta_hi =
      n_hi > 0.0f ? __fdiv_rn(__fsub_rn(n_hi, nf), fmaxf(n_hi, 1.0f)) : 0.0f;
  const float n = lo ? n_lo : n_hi;
  const bool head = __uint2float_rn(slot) < n;
  const float prob = lo ? (head ? 1.0f : delta_lo)
                        : (head ? __fsub_rn(1.0f, delta_hi) : 0.0f);
  return u < prob ? 1.0f : 0.0f;
}

// The code of element x (global row-major index idx) as an integral f32.
__device__ __forceinline__ float quantize(float x, uint32_t idx,
                                          uint32_t counter, const Params& p) {
  const float scaled = __fmul_rn(__fsub_rn(x, p.zero), p.scale);
  float code;
  if (p.scheme == kDeterministic) {
    code = floorf(__fadd_rn(scaled, 0.5f));
  } else {
    const float fl = floorf(scaled);
    const float frac = __fsub_rn(scaled, fl);
    if (p.scheme == kStochastic) {
      const float u = hash_uniform(p.seed, idx, counter);
      code = __fadd_rn(fl, u < frac ? 1.0f : 0.0f);
    } else {
      const uint32_t slot = slot_index(counter, idx, p);
      const float u = hash_uniform(p.seed ^ kDitherTail, idx, counter);
      code = __fadd_rn(fl, dither_bit(frac, slot, u,
                                       __uint2float_rn(p.n_pulses)));
    }
  }
  return fminf(fmaxf(code, 0.0f), p.levels);
}

}  // namespace dither_quant
