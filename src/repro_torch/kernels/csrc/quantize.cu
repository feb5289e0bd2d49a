// k-bit quantisation of an f32 matrix with deterministic, stochastic or
// dither rounding, for Hopper (sm_90a).
//
// Replaces: the TPU kernel src/repro/kernels/quantize.py quantize_kernel_call
// (body _quantize_body), and computes the same function as its plain version
// repro_torch/kernels/ref.py:quantize_codes_ref:
//
//   x (M, N) f32, counter  ->  codes (M, N) int32,
//   codes = clip(round_scheme((x - zero) * scale), 0, 2^bits - 1),
//
// with the hash's element index the unpadded global row-major index m*N + n
// (the reference's xla-ref rule; its ops.quantize_2d hashes with the padded
// width, so the TPU kernel agrees with this one only on block-multiple
// shapes).  The per-element arithmetic is dither_quant.cuh, which the
// quantise-and-multiply kernel (dither_matmul.cu) shares.
//
// What bounds it on an H100: HBM bytes in principle, 4 read and 4 written
// per element at 3.35 TB/s (~4.2e11 elements a second), but a dither code
// costs four murmur fmix32 rounds, two 32-bit modulos and an IEEE divide (a
// stochastic one three fmix32 rounds), some 60-100 instructions per element,
// against about 1.7e13 32-bit integer instructions a second (132 SMs x 64
// lanes x 1.98 GHz): ~2e11 elements a second, so the arithmetic is the
// practical limit.
//
// What this design does about it: nothing beyond the plain layout, one
// thread per element in a grid-stride loop with coalesced loads and stores,
// no padding and no shared memory.  The serving path never runs this kernel
// (the dither matmul quantises its operands itself); it is the port of the
// reference's standalone dispatch.quantize.
//
// The C entry point returns cudaGetLastError() after the launch; the wrapper
// (kernels/quantize.py) checks shapes, dtypes and contiguity before calling
// and raises on a non-zero return.

#include "dither_quant.cuh"

namespace {

__global__ void quantize_kernel(const float* __restrict__ x,
                                int32_t* __restrict__ out, int64_t total,
                                dither_quant::Params p, uint32_t counter) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    // idx = m * N + n in uint32, wrapping as the reference's does
    const uint32_t idx = static_cast<uint32_t>(i);
    out[i] = static_cast<int32_t>(dither_quant::quantize(x[i], idx, counter, p));
  }
}

}  // namespace

extern "C" {

// x, out: (M, N) row-major f32 and int32.  scheme: 0 deterministic,
// 1 stochastic, 2 dither; fmt: 0 spread, 1 unary.
int repro_quantize(const void* x, void* out, long long total, float scale,
                   float zero, float levels, int scheme, int fmt,
                   unsigned seed, unsigned n_pulses, unsigned mult,
                   unsigned counter, void* stream) {
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const dither_quant::Params p{scale, zero, levels, scheme, fmt,
                               seed,  n_pulses, mult};
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  quantize_kernel<<<blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int32_t*>(out), total, p,
      counter);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
