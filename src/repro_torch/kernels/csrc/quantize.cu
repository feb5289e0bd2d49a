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
// costs some 35 integer operations (dither_quant.cuh) against about 1.7e13
// a second: ~4.8e11 codes a second, so the two limits are close and the
// kernel has to keep both the memory system and the integer pipes busy.
//
// What this design does about it: four elements a thread, read as one
// 16-byte float4 and written as one 16-byte int4, so the four independent
// hashes overlap; a grid of at most 8 blocks of 256 threads per SM, which
// holds the whole (576, 1536) operand in one wave, striding beyond it; the
// ragged tail (numel % 4) taken by the first threads one element each.  A
// tensor whose storage is not 16-byte aligned takes the same grid one
// element at a time.  The serving path never runs this kernel (the dither
// matmul quantises its operands itself); it is the port of the reference's
// standalone dispatch.quantize.
//
// The C entry points return cudaGetLastError() after the launch; the
// wrapper (kernels/quantize.py) checks shapes, dtypes and contiguity before
// calling and raises on a non-zero return.

#include "dither_quant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;   // 2048 threads an SM

template <bool kVec, bool kFast>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x, int32_t* __restrict__ out,
                    int64_t total, dither_quant::Params p) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // idx = m * N + n in uint32, wrapping as the reference's does
  auto code = [&p](float v, uint32_t idx) {
    return dither_quant::code_of<kFast>(v, idx, p);
  };
  if (kVec) {
    const int64_t nvec = total >> 2;
    const float4* xv = reinterpret_cast<const float4*>(x);
    int4* ov = reinterpret_cast<int4*>(out);
    for (int64_t v = tid; v < nvec; v += stride) {
      const float4 in = __ldcs(xv + v);
      const uint32_t i0 = static_cast<uint32_t>(v << 2);
      __stcs(ov + v, make_int4(code(in.x, i0), code(in.y, i0 + 1u),
                               code(in.z, i0 + 2u), code(in.w, i0 + 3u)));
    }
    const int64_t i = (nvec << 2) + tid;
    if (i < total) out[i] = code(x[i], static_cast<uint32_t>(i));
  } else {
    for (int64_t i = tid; i < total; i += stride)
      out[i] = code(x[i], static_cast<uint32_t>(i));
  }
}

// How many uint32 numerators in [lo, lo + count) give mod_n(x) != x % N.
__global__ void fastmod_check(dither_quant::Params p, uint64_t lo,
                              uint64_t count,
                              unsigned long long* __restrict__ mismatches) {
  unsigned long long bad = 0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i =
           static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    const uint32_t v = static_cast<uint32_t>(lo + i);
    bad += dither_quant::mod_n(v, p) != v % p.n_pulses;
  }
  for (int o = 16; o > 0; o >>= 1) bad += __shfl_xor_sync(0xffffffffu, bad, o);
  if ((threadIdx.x & 31) == 0 && bad) atomicAdd(mismatches, bad);
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

extern "C" {

// x, out: (M, N) row-major f32 and int32, total = M * N elements; params
// from kernels/quantize.py:quant_params.
int repro_quantize(const void* x, void* out, long long total,
                   const dither_quant::Params* params, void* stream) {
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const dither_quant::Params p = *params;
  const bool vec = (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const long long per_block = kThreads * (vec ? 4LL : 1LL);
  const long long want = (total + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  const bool fast = dither_quant::fast_path(p);
  if (vec && fast)
    quantize_kernel<true, true><<<blocks, kThreads, 0, s>>>(xf, o, total, p);
  else if (vec)
    quantize_kernel<true, false><<<blocks, kThreads, 0, s>>>(xf, o, total, p);
  else if (fast)
    quantize_kernel<false, true><<<blocks, kThreads, 0, s>>>(xf, o, total, p);
  else
    quantize_kernel<false, false><<<blocks, kThreads, 0, s>>>(xf, o, total,
                                                             p);
  return static_cast<int>(cudaGetLastError());
}

// mismatches (one uint64 on the card, zeroed by the caller) += the count of
// x in [lo, lo + count) with mod_n(x) != x % N, for params' N and magic.
int repro_fastmod_check(const dither_quant::Params* params,
                        unsigned long long lo, unsigned long long count,
                        void* mismatches, void* stream) {
  fastmod_check<<<sm_count() * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      *params, lo, count, static_cast<unsigned long long*>(mismatches));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
