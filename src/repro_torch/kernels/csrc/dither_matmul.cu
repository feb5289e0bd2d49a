// Quantise-and-multiply, the paper's section VIII "separate" product, for
// Hopper (sm_90a): C = dequant(Q(A) . Q(B)).
//
// Replaces: the TPU kernel src/repro/kernels/dither_matmul.py
// dither_matmul_kernel_call (in-tile quantiser _quantize_tile, body
// _matmul_body), and computes the same function as its plain version
// repro_torch/kernels/ref.py:dither_matmul_ref:
//
//   a (M, K) f32, b (K, N) f32, counter  ->  out (M, N) f32.
//   A's codes: clip(round((a - za) * sa), 0, 2^bits - 1) with seed, dither
//   N_A = max(N, 2) pulses, element index m*K + k; B's with seed + 1,
//   N_B = max(M, 2), index k*N + n (dither_quant.cuh, shared with
//   quantize.cu).  acc = sum_k ca[m,k] cb[k,n], exact in int32; then the
//   reference's dequantisation as it runs compiled (ref.dequant_constants):
//   out = fma(acc, r_acc, colsum[n] * c_col) + rowsum[m] * c_row + c_k,
//   or acc * r_acc when both zeros are 0, each f32 op rounded once.
//
// A second entry takes the quantised-matmul policy's product whole
// (numerics/policy.py _fused_matmul; plain version
// ref.dither_matmul_scaled_ref): x (M, K) bf16 and w (K, N) bf16, row-major
// or the transposed view of a row-major (N, K) weight (the tied LM head),
// each normalised in the kernel as bf16(v / absmax) (an IEEE division
// rounded to bf16, what torch's bf16 division by a 0-dim CUDA tensor
// stores), the product above with ranges (-1, 1), and the output
// bf16(out * f32(bf16(ax * aw))).  The activation's absmax
// (clamp_min(max |x|, 1e-6) in bf16) is reduced in the kernel; the
// weight's comes in as a 0-dim bf16 device tensor, computed once per
// weight by the wrapper.
//
// What bounds it on an H100.  Each operand element is read once and
// quantised once; a dither code is ~35 integer operations of the
// reference's formula (~100 instructions as compiled, ~50 of them on the
// INT32 pipe), against about 1.7e13 INT32 operations a second, and at
// decode (M = the batch, 8) the weight's K*N codes are the whole cost:
// 0.0019 ms at 576 x 1536, 0.059 ms for the 576 x 49152 LM head, against
// 0.0011 and 0.034 ms for its bytes.  The int8 product (2*M*K*N
// operations at 1979 TOPS) bounds only large prefills.
//
// What this design does about it, and where it departs from the TPU
// kernel.  The TPU kernel re-quantises its A and B tiles at every grid
// step, so B is hashed M/bm times and A N/bn times.  Here every element is
// hashed once, in one of two regimes the wrapper picks from M:
//
// Decode (M <= 128), two launches:
//   1. prep_rows: A's codes and the row code sums, one block a row (with
//      the policy entry each block first reduces |x|'s maximum itself, in
//      16-byte loads);
//   2. fused_decode: blocks of 256 threads, each a 16-column strip of B
//      and a span of 32-row K chunks, as many blocks as the wrapper's plan
//      gives (at least 132 at every serve shape, at most one wave).  The
//      span streams through a two-stage cp.async ring in groups of 4
//      chunks (A's codes for the group with them); all 256 threads
//      quantise the group, each a column and rows 16 apart, into shared
//      memory in the u8 mma's fragment order, then warp c multiplies chunk
//      c with mma.sync.m16n8k32 (weight columns are the MMA's rows and
//      the batch its 8 columns, so no row is padding at M = 8) while the
//      next group's bytes arrive.  The split over K merges exactly: int32
//      partials and column sums are added with atomics, and the last
//      block of a strip to arrive (a __threadfence before its arrival
//      counter) reads the totals, resets them and the counter to 0 for
//      the next call, and writes the epilogue.
// Prefill (M > 128), quantise once, then multiply:
//   1. A's codes, row-major (Mp, Kp), and rowsum (prep_rows; for the policy
//      entry |x|'s maximum first, by absmax_rows with atomicMax on the bits
//      of non-negative floats);
//   2. B's codes transposed to (Np, Kp), k contiguous per column, and
//      colsum: quantize_bt through shared memory for a row-major weight,
//      prep_rows for the transposed view;
//   3. gemm_u8: 128x128 output tiles, 8 warps of 64x32, mma.sync.m16n8k32
//      over 64-byte K chunks in a 3-stage cp.async pipeline, then the
//      epilogue.
// Where dither_quant.cuh's fast path applies (the dither scheme, N <=
// 2^22) every loop takes it: no branch on the scheme, roundings on the
// FP32 pipe; the fused kernel also takes "% N" as a mask when N is a
// power of two (the weight's N_B = 8 at batch 8) and the policy entry's
// normalisation by a reciprocal (normalise_rcp) where the absmax is
// finite.
//
// Measured (chip_smoke.py --dither-times, NVIDIA H100 80GB HBM3, 700 W;
// PERF.md): see PERF.md section 6 for this design's device times beside
// the previous one's and the bounds.  The small decode products are
// latency-bound: two launches and the split merge's chain of round trips
// (atomics, fence, arrival, exchange) take most of their time; the LM
// head runs at about half the issue rate of its ~100 instructions a code.
//
// The int32 accumulator is exact while K*(2^bits - 1)^2 < 2^31 (K < 33,025
// at 8 bits), which the wrapper checks; codes are u8, so bits <= 8.
//
// The C entry points return cudaGetLastError() after the last launch; the
// wrapper (kernels/dither_matmul.py) checks shapes, dtypes and layouts,
// plans the grid, keeps the zeroed split scratch, and raises on a non-zero
// return.

#include <cstdint>

#include "dither_quant.cuh"

namespace {

using dither_quant::Params;
using bf16 = __nv_bfloat16;

constexpr int kStages = 3;        // cp.async ring depth (both regimes)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_u8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Epilogue {
  float r_acc, c_col, c_row, c_k;
  int cross;  // both zeros 0: out = acc * r_acc
};

// The reference's compiled dequantisation of one output.
__device__ __forceinline__ float dequant(int32_t acc, int32_t colsum,
                                         int32_t rowsum, const Epilogue& e) {
  const float accf = __int2float_rn(acc);
  if (!e.cross) return __fmul_rn(accf, e.r_acc);
  float o = __fmaf_rn(accf, e.r_acc,
                      __fmul_rn(__int2float_rn(colsum), e.c_col));
  o = __fadd_rn(o, __fmul_rn(__int2float_rn(rowsum), e.c_row));
  return __fadd_rn(o, e.c_k);
}

// The policy entry's output scale f32(bf16(ax * aw)), from the two clamped
// absmaxes; 0 for the f32 entry (null pointers).
__device__ __forceinline__ float out_scale(const float* ax, const bf16* aw) {
  if (ax == nullptr) return 0.0f;
  return dither_quant::bf16_round(
      __fmul_rn(dither_quant::clamp_absmax(*ax),
                dither_quant::clamp_absmax(__bfloat162float(*aw))));
}

// One output: f32, or the policy's bf16(o * scale).
__device__ __forceinline__ void store(float* out, int64_t i, float o, float) {
  out[i] = o;
}
__device__ __forceinline__ void store(bf16* out, int64_t i, float o,
                                      float scale) {
  out[i] = __float2bfloat16_rn(__fmul_rn(o, scale));
}

// One output of gemm_u8: dequantised (f32, or the policy's bf16), or, for
// the sharded entry's partials (int32 out), the raw int32 accumulator.
template <typename O>
__device__ __forceinline__ void emit(O* out, int64_t i, int32_t acc,
                                     int32_t colsum, int32_t rowsum,
                                     const Epilogue& e, float scale) {
  store(out, i, dequant(acc, colsum, rowsum, e), scale);
}
__device__ __forceinline__ void emit(int32_t* out, int64_t i, int32_t acc,
                                     int32_t, int32_t, const Epilogue&,
                                     float) {
  out[i] = acc;
}

// ---------------------------------------------------------------- absmax

// *out_bits = max(*out_bits, bits of max |x|) over n bf16 values: the bits
// of non-negative floats order as the floats do.
__global__ void absmax_rows(const bf16* __restrict__ x, int64_t n,
                            unsigned* __restrict__ out_bits) {
  float m = 0.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride)
    m = fmaxf(m, fabsf(__bfloat162float(x[i])));
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) atomicMax(out_bits, __float_as_uint(m));
}

// ---------------------------------------------------------------- prep_rows

// The codes of an (R, C) operand with row stride ld, one block a row of
// blockDim.x = prep_threads(C) threads (one or two codes each): codes
// (Rp, Cp) u8, k contiguous, code 0 past R or C; rowsum[r] = the row's
// code sum.  The hash index of (r, c) is g(r)*ir + c*ic + base, with g(r) =
// (r / seg) * seg_stride + r % seg the row's global row (A: ir = K, ic = 1;
// a transposed weight's row n: ir = 1, ic = N; g(r) = r and base 0 for an
// unsharded operand, seg = INT_MAX; the sharded entry's blocks give their
// global offsets, every product wrapping at 2^32 as the reference's uint32
// index does).  norm 0: the values as they
// are; 1: normalised by clamp(max |src|), which each block reduces over
// the whole (contiguous) operand itself and block 0 stores (clamped) to
// *absmax; 2:
// normalised by clamp(*absmax); 3: by clamp(*absmax_bf16).
template <typename T, bool kFast>
__global__ void __launch_bounds__(1024)
    prep_rows(const T* __restrict__ src, uint8_t* __restrict__ codes,
              int32_t* __restrict__ rowsum, int R, int C, int64_t ld, int Cp,
              uint32_t ir, uint32_t ic, int norm, float* __restrict__ absmax,
              const bf16* __restrict__ absmax_bf16, uint32_t base, int seg,
              uint32_t seg_stride, Params p) {
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  float scale = 1.0f;
  if (norm == 1) {   // src contiguous (ld == C): 16-byte loads if aligned
    float m = 0.0f;
    const int64_t total = static_cast<int64_t>(R) * C;
    constexpr int kPer = 16 / sizeof(T);
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && total % kPer == 0) {
      const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll 4
      for (int64_t i = tid; i < total / kPer; i += threads) {
        const uint4 q = v[i];
        const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
        for (int j = 0; j < kPer; ++j) m = fmaxf(m, fabsf(to_f32(e[j])));
      }
    } else {
#pragma unroll 4
      for (int64_t i = tid; i < total; i += threads)
        m = fmaxf(m, fabsf(to_f32(src[i])));
    }
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) red_f[warp] = m;
    __syncthreads();
    m = red_f[0];
    for (int w = 1; w < warps; ++w) m = fmaxf(m, red_f[w]);
    scale = dither_quant::clamp_absmax(m);
    if (blockIdx.x == 0 && tid == 0) *absmax = scale;
  } else if (norm == 2) {
    scale = dither_quant::clamp_absmax(*absmax);
  } else if (norm == 3) {
    scale = dither_quant::clamp_absmax(__bfloat162float(*absmax_bf16));
  }
  const int r = blockIdx.x;
  uint8_t* row = codes + static_cast<int64_t>(r) * Cp;
  const uint32_t row_idx =
      (static_cast<uint32_t>(r / seg) * seg_stride +
       static_cast<uint32_t>(r % seg)) * ir + base;
  int sum = 0;
  for (int c = tid; c < Cp; c += threads) {
    int code = 0;
    if (r < R && c < C) {
      float v = to_f32(src[r * ld + c]);
      if (norm) v = dither_quant::normalise(v, scale);
      code = dither_quant::code_of<kFast>(
          v, row_idx + static_cast<uint32_t>(c) * ic, p);
    }
    row[c] = static_cast<uint8_t>(code);
    sum += code;
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) red_i[warp] = sum;
  __syncthreads();
  if (tid == 0 && r < R) {
    for (int w = 1; w < warps; ++w) sum += red_i[w];
    rowsum[r] = sum;
  }
}

// prep_rows' row map of an unsharded operand: one segment, g(r) = r.
constexpr int kWhole = 0x7FFFFFFF;

// prep_rows' block: a warp multiple covering half of the padded row, at
// most 1024 threads.
inline int prep_threads(int Cp) {
  const int t = ((Cp + 1) / 2 + 31) / 32 * 32;
  return t < 1024 ? t : 1024;
}

// ---------------------------------------------------------------- decode

constexpr int kDecThreads = 256;

// The decode kernel's tiles.  A block holds a 16-column weight strip and
// walks its K span in groups of kG 32-row chunks.  One stage of the
// cp.async ring holds a group's raw weight (row-major: [32 kG k][16 n],
// 32 or 64-byte rows; transposed view: [16 n][32 kG k] bf16, rows padded
// by 32 bytes so that the two rows a warp reads fall on disjoint banks)
// and A's codes for it ([8 kMT m][32 kG k]).  The group's codes go to
// `frag` in the u8 mma's A-fragment order: word (c*4 + j)*33 + lane is
// register j of that lane for chunk c (the 33-word stride keeps the two
// register halves of a column pair on different banks).
template <typename T, bool kTrans, int kMT>
struct Dec {
  static constexpr int kG = kMT >= 16 ? 2 : 4;
  static constexpr int kRowsK = 32 * kG;
  static constexpr int kWRow = kTrans ? 2 * kRowsK + 32 : 16 * sizeof(T);
  static constexpr int kWBytes = (kTrans ? 16 : kRowsK) * kWRow;
  static constexpr int kXBytes = 8 * kMT * kRowsK;
  static constexpr int kStage = kWBytes + kXBytes;
  static constexpr int kFragWords = kG * 4 * 33;
};

// Stage group cg0.. (gc chunks, k0 = 32 cg0) of the strip n0 into st, all
// 256 threads (dec_load_x: A's codes for it).
template <typename T, bool kTrans, int kMT>
__device__ __forceinline__ void dec_load_w(uint8_t* st,
                                           const T* __restrict__ w, int k0,
                                           int gc, int n0, int K, int N,
                                           bool async, int tid) {
  using D = Dec<T, kTrans, kMT>;
  constexpr int kPer = 16 / sizeof(T);       // values per 16 bytes
  const int krows = 32 * gc;                 // rows of this block's chunks
  if (async) {
    constexpr int kParts = kTrans ? D::kRowsK / 8 : 16 / kPer;
    constexpr int kCopies = (kTrans ? 16 : D::kRowsK) * kParts;
    for (int c = tid; c < kCopies; c += kDecThreads) {
      const int row = c / kParts, part = c % kParts;
      int64_t off;
      bool ok;
      if (kTrans) {   // row = n, part = 8 k
        ok = n0 + row < N && part * 8 < krows && k0 + part * 8 < K;
        off = static_cast<int64_t>(n0 + row) * K + k0 + part * 8;
      } else {        // row = k, part = kPer n
        ok = row < krows && k0 + row < K && n0 + part * kPer < N;
        off = static_cast<int64_t>(k0 + row) * N + n0 + part * kPer;
      }
      cp_async16(st + row * D::kWRow + part * 16, ok ? w + off : w,
                 ok ? 16 : 0);
    }
  } else {            // rows not 16-byte aligned: one value at a time
    T* s = reinterpret_cast<T*>(st);
    for (int e = tid; e < 16 * D::kRowsK; e += kDecThreads) {
      int kl, nl, at;
      if (kTrans) {
        nl = e / D::kRowsK; kl = e % D::kRowsK;
        at = nl * (D::kWRow / 2) + kl;
      } else {
        kl = e >> 4; nl = e & 15; at = kl * 16 + nl;
      }
      if (kl < krows && k0 + kl < K && n0 + nl < N)
        s[at] = kTrans ? w[static_cast<int64_t>(n0 + nl) * K + k0 + kl]
                       : w[static_cast<int64_t>(k0 + kl) * N + n0 + nl];
    }
  }
}

template <typename T, bool kTrans, int kMT>
__device__ __forceinline__ void dec_load_x(uint8_t* st,
                                           const uint8_t* __restrict__ codes_x,
                                           int Kp, int k0, int gc, int tid) {
  using D = Dec<T, kTrans, kMT>;
  const int krows = 32 * gc;
  constexpr int kXParts = D::kRowsK / 16;
  for (int c = tid; c < 8 * kMT * kXParts; c += kDecThreads) {
    const int row = c / kXParts, part = c % kXParts;
    if (part * 16 < krows)
      cp_async16(st + D::kWBytes + row * D::kRowsK + part * 16,
                 codes_x + static_cast<int64_t>(row) * Kp + k0 + part * 16,
                 16);
  }
}

// This thread's share of a staged group: rows kl0 + 16 i (kl0 < 16) of
// column nl (2 kG values), each quantised (code 0 outside the block's
// chunks and the matrix) into its byte of `frag`; returns their code sum.
// Row kl0 + 16 i is chunk i / 2, slot kl0 + 16 (i % 2), so its byte sits
// at a fixed offset from the thread's first one.  Every value is computed
// and the out-of-range ones dropped after, so that the 2 kG independent
// hashes interleave.
template <typename T, bool kTrans, int kMT, bool kScaled, bool kFast,
          bool kPow2, bool kRcp>
__device__ __forceinline__ int dec_quantise(const uint8_t* st, uint8_t* fb,
                                            int krows, int nl, int kl0,
                                            uint32_t idx0, int N, float aw,
                                            float awr, const Params& p) {
  using D = Dec<T, kTrans, kMT>;
  const T* sw = reinterpret_cast<const T*>(st) +
                (kTrans ? nl * (D::kWRow / 2) + kl0 : kl0 * 16 + nl);
  uint8_t* fp = fb + ((((nl >> 3) * 33) + ((nl & 7) << 2) + (kl0 >> 2)) * 4 +
                      (kl0 & 3));
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 2 * D::kG; ++i) {
    float x = to_f32(sw[kTrans ? 16 * i : 256 * i]);
    if (kScaled)
      x = kRcp ? dither_quant::normalise_rcp(x, aw, awr)
               : dither_quant::normalise(x, aw);
    const int q = dither_quant::code_of<kFast, kPow2>(
        x, idx0 + static_cast<uint32_t>(16 * i) * static_cast<uint32_t>(N),
        p);
    const int code = kl0 + 16 * i < krows ? q : 0;
    sum += code;
    fp[(i >> 1) * (4 * 33 * 4) + (i & 1) * (2 * 33 * 4)] =
        static_cast<uint8_t>(code);
  }
  return sum;
}

// Grid (ceil(N / 16), splits), 256 threads a block.  Block (t, s)
// quantises the weight strip n0 = 16 t over k chunks [s * cps, min(KC,
// (s + 1) * cps)), every thread its share of each group (a column, rows 16
// apart), into `frag`; then warp c multiplies chunk c of the group with
// A's codes (codes_x: 8 kMT rows of Kp = 32 KC bytes) by mma.sync, while
// the next group's bytes arrive.  The warps' partials meet in shared
// memory; splits > 1: the block adds them to acc (M, N) and colacc (N,)
// by atomics, arrivals[t] counts the blocks, and the last one writes out
// and leaves all three at 0.
template <typename T, typename O, bool kTrans, int kMT>
__global__ void __launch_bounds__(kDecThreads, kMT >= 16 ? 2 : 4)
    fused_decode(const T* __restrict__ w, const uint8_t* __restrict__ codes_x,
                 const int32_t* __restrict__ rowsum, int32_t* __restrict__ acc,
                 int32_t* __restrict__ colacc, unsigned* __restrict__ arrivals,
                 O* __restrict__ out, const float* __restrict__ x_absmax,
                 const bf16* __restrict__ w_absmax, int M, int K, int N,
                 int cps, int splits, int async, Params p, Epilogue e) {
  using D = Dec<T, kTrans, kMT>;
  __shared__ __align__(16) uint8_t ring[2][D::kStage];
  __shared__ uint32_t frag[D::kFragWords];
  __shared__ int acc_s[8 * kMT * 16];
  __shared__ int colsum_s[16];
  __shared__ int last_s;
  constexpr bool kScaled = sizeof(O) == 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * 16;
  const int KC = (K + 31) >> 5, Kp = KC * 32;
  const int c_begin = blockIdx.y * cps;
  const int c_end = min(KC, c_begin + cps);
  const int groups = (c_end - c_begin + D::kG - 1) / D::kG;
  const float aw =
      kScaled ? dither_quant::clamp_absmax(__bfloat162float(*w_absmax))
              : 1.0f;
  const bool fast = dither_quant::fast_path(p);
  const bool pow2 = dither_quant::pow2_pulses(p);
  // the weight's 1/absmax for normalise_rcp, where that is exact
  const float awr = __frcp_rn(aw);
  const bool rcp = !kScaled || isfinite(aw);
  // this thread's column of the strip, and its first row in a group
  const int nl = kTrans ? tid >> 4 : tid & 15;
  const int kl0 = kTrans ? tid & 15 : tid >> 4;
  const int n = n0 + nl;

  for (int i = tid; i < 8 * kMT * 16; i += kDecThreads) acc_s[i] = 0;
  if (tid < 16) colsum_s[tid] = 0;
  int cs = 0;

  const int gc0 = min(D::kG, c_end - c_begin);
  dec_load_w<T, kTrans, kMT>(ring[0], w, 32 * c_begin, gc0, n0, K, N, async,
                             tid);
  dec_load_x<T, kTrans, kMT>(ring[0], codes_x, Kp, 32 * c_begin, gc0, tid);
  cp_async_commit();
  for (int gi = 0; gi < groups; ++gi) {
    const int cg0 = c_begin + gi * D::kG;
    const int gc = min(D::kG, c_end - cg0);
    const int k0 = 32 * cg0;
    cp_async_wait<0>();
    __syncthreads();   // the group has landed; the last group's MMAs are done
    if (gi + 1 < groups) {
      const int cn = cg0 + D::kG, gn = min(D::kG, c_end - cn);
      uint8_t* sn = ring[(gi + 1) & 1];
      dec_load_w<T, kTrans, kMT>(sn, w, 32 * cn, gn, n0, K, N, async, tid);
      dec_load_x<T, kTrans, kMT>(sn, codes_x, Kp, 32 * cn, gn, tid);
    }
    cp_async_commit();
    const uint8_t* st = ring[gi & 1];
    // rows of this group this thread may code: the block's chunks, the
    // matrix (none past column N)
    const int krows = n < N ? min(32 * gc, K - k0) : 0;
    const uint32_t idx0 = static_cast<uint32_t>(k0 + kl0) *
                              static_cast<uint32_t>(N) +
                          static_cast<uint32_t>(n);
    uint8_t* fb = reinterpret_cast<uint8_t*>(frag);
    if (!rcp)
      cs += dec_quantise<T, kTrans, kMT, kScaled, false, false, false>(
          st, fb, krows, nl, kl0, idx0, N, aw, awr, p);
    else if (fast && pow2)
      cs += dec_quantise<T, kTrans, kMT, kScaled, true, true, true>(
          st, fb, krows, nl, kl0, idx0, N, aw, awr, p);
    else if (fast)
      cs += dec_quantise<T, kTrans, kMT, kScaled, true, false, true>(
          st, fb, krows, nl, kl0, idx0, N, aw, awr, p);
    else
      cs += dec_quantise<T, kTrans, kMT, kScaled, false, false, true>(
          st, fb, krows, nl, kl0, idx0, N, aw, awr, p);
    __syncthreads();
    if (warp < gc) {   // warp c multiplies chunk c; partials meet in acc_s
      uint32_t a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = frag[(warp * 4 + j) * 33 + lane];
      const uint8_t* xs = st + D::kWBytes + 32 * warp + 4 * tq;
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const uint8_t* xr = xs + (8 * mi + g) * D::kRowsK;
        int32_t c[4] = {0, 0, 0, 0};
        mma_u8(c, a, *reinterpret_cast<const uint32_t*>(xr),
               *reinterpret_cast<const uint32_t*>(xr + 16));
#pragma unroll
        for (int r = 0; r < 4; ++r)
          atomicAdd(acc_s + (8 * mi + 2 * tq + (r & 1)) * 16 + g +
                        8 * (r >> 1),
                    c[r]);
      }
    }
  }
  cp_async_wait<0>();
  atomicAdd(colsum_s + nl, cs);
  __syncthreads();
  const int outs = 16 * min(M, 8 * kMT);
  if (splits > 1) {
    for (int o = tid; o < outs; o += kDecThreads) {
      const int m = o >> 4, nn = n0 + (o & 15);
      if (m < M && nn < N) atomicAdd(acc + static_cast<int64_t>(m) * N + nn,
                                     acc_s[o]);
    }
    if (tid < 16 && n0 + tid < N) atomicAdd(colacc + n0 + tid, colsum_s[tid]);
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last_s = atomicAdd(arrivals + blockIdx.x, 1u) == unsigned(splits - 1);
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    if (tid < 16 && n0 + tid < N)
      colsum_s[tid] = atomicExch(colacc + n0 + tid, 0);
    for (int o = tid; o < outs; o += kDecThreads) {
      const int m = o >> 4, nn = n0 + (o & 15);
      if (m < M && nn < N)
        acc_s[o] = atomicExch(acc + static_cast<int64_t>(m) * N + nn, 0);
    }
    if (tid == 0) atomicExch(arrivals + blockIdx.x, 0u);
    __syncthreads();
  }
  const float scale = kScaled ? out_scale(x_absmax, w_absmax) : 0.0f;
  for (int o = tid; o < outs; o += kDecThreads) {
    const int m = o >> 4, nn = n0 + (o & 15);
    if (m < M && nn < N)
      store(out, static_cast<int64_t>(m) * N + nn,
            dequant(acc_s[o], colsum_s[o & 15], rowsum[m], e), scale);
  }
}

// ---------------------------------------------------------------- prefill

constexpr int kBM = 128;          // output rows per block
constexpr int kBN = 128;          // output columns per block
constexpr int kBK = 64;           // K bytes per staged chunk
constexpr int kLd = kBK + 16;     // shared-memory row stride (bytes)
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kTileM = kBM / kWarpsM / 16;   // m16 tiles per warp (4)
constexpr int kTileN = kBN / kWarpsN / 8;    // n8 tiles per warp (4)
constexpr int kGemmStage = (kBM + kBN) * kLd;
constexpr int kGemmSmem = kStages * kGemmStage;   // 61,440 bytes

// B's codes of a row-major (K, N) weight for a 32 (k) x 32 (n) tile:
// thread (tx, ty) quantises column n0 + tx, rows k0 + ty + 8 j (coalesced
// reads along n), the tile is transposed in shared memory, and each
// column's 32 codes are written as eight 4-byte words, k contiguous, into
// codes_t (Np, Kp).  Column sums: one atomic per column (colsum zeroed by
// the caller).  absmax: null, or the weight's clamped absmax (policy
// entry: values normalised first).  The hash index of (k, n) is k*nidx + n
// + base (nidx = N and base 0 unless a sharded entry's block gives the
// global width and offset).
template <typename T, bool kFast>
__global__ void quantize_bt(const T* __restrict__ b,
                            uint8_t* __restrict__ codes_t,
                            int32_t* __restrict__ colsum, int K, int N,
                            int Kp, const bf16* __restrict__ absmax,
                            uint32_t nidx, uint32_t base, Params p) {
  __shared__ __align__(16) uint8_t tile[32][36];
  __shared__ int part[8][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int n = n0 + tx;
  const float scale =
      absmax ? dither_quant::clamp_absmax(__bfloat162float(*absmax)) : 1.0f;
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kl = ty + 8 * j;
    const int k = k0 + kl;
    int code = 0;
    if (n < N && k < K) {
      float v = to_f32(b[static_cast<int64_t>(k) * N + n]);
      if (absmax) v = dither_quant::normalise(v, scale);
      code = dither_quant::code_of<kFast>(
          v, static_cast<uint32_t>(k) * nidx + static_cast<uint32_t>(n) + base,
          p);
    }
    tile[tx][kl] = static_cast<uint8_t>(code);
    sum += code;
  }
  part[ty][tx] = sum;
  __syncthreads();
  if (ty == 0 && n < N) {
    int s = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) s += part[r][tx];
    if (s) atomicAdd(colsum + n, s);
  }
  const int t = ty * 32 + tx;        // 256 threads: 32 columns x 8 words
  const int nl = t >> 3, wd = t & 7;
  const uint32_t word = *reinterpret_cast<const uint32_t*>(&tile[nl][4 * wd]);
  reinterpret_cast<uint32_t*>(codes_t + static_cast<int64_t>(n0 + nl) * Kp +
                              k0)[wd] = word;
}

// codes_a (Mp, Kp) and codes_bt (Np, Kp) u8, k contiguous; Mp, Np multiples
// of 128, Kp of 64.  One block per 128x128 output tile; chunk kc + 2 is in
// flight while chunk kc is multiplied.
template <typename O>
__global__ void __launch_bounds__(kThreads)
    gemm_u8(const uint8_t* __restrict__ codes_a,
            const uint8_t* __restrict__ codes_bt,
            const int32_t* __restrict__ rowsum,
            const int32_t* __restrict__ colsum, O* __restrict__ out, int M,
            int N, int Kp, const float* __restrict__ x_absmax,
            const bf16* __restrict__ w_absmax, Epilogue e) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;       // groupID, thread in group
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = Kp / kBK;

  auto load = [&](int kc) {
    uint8_t* As = smem + (kc % kStages) * kGemmStage;
    uint8_t* Bs = As + kBM * kLd;
#pragma unroll
    for (int v = 0; v < 2; ++v) {   // 128 rows x 64 bytes, each operand
      const int e16 = tid + v * kThreads;
      const int row = e16 >> 2, col = (e16 & 3) * 16;
      cp_async16(As + row * kLd + col,
                 codes_a + static_cast<int64_t>(m0 + row) * Kp + kc * kBK +
                     col,
                 16);
      cp_async16(Bs + row * kLd + col,
                 codes_bt + static_cast<int64_t>(n0 + row) * Kp + kc * kBK +
                     col,
                 16);
    }
  };

  int32_t acc[kTileM][kTileN][4];
#pragma unroll
  for (int i = 0; i < kTileM; ++i)
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kc + kStages - 1 < nk) load(kc + kStages - 1);
    cp_async_commit();
    const uint8_t* As = smem + (kc % kStages) * kGemmStage;
    const uint8_t* Bs = As + kBM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[kTileM][4], bf[kTileN][2];
#pragma unroll
      for (int i = 0; i < kTileM; ++i) {
        const uint8_t* r = As + (wm * 64 + i * 16 + g) * kLd + kk + tq * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(r);
        af[i][1] = *reinterpret_cast<const uint32_t*>(r + 8 * kLd);
        af[i][2] = *reinterpret_cast<const uint32_t*>(r + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(r + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < kTileN; ++j) {
        const uint8_t* cptr = Bs + (wn * 32 + j * 8 + g) * kLd + kk + tq * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(cptr);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(cptr + 16);
      }
#pragma unroll
      for (int i = 0; i < kTileM; ++i)
#pragma unroll
        for (int j = 0; j < kTileN; ++j)
          mma_u8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  const float scale = out_scale(x_absmax, w_absmax);
#pragma unroll
  for (int i = 0; i < kTileM; ++i)
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm * 64 + i * 16 + g + (r >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + j * 8 + tq * 2 + (r & 1);
        if (m >= M || n >= N) continue;
        emit(out, static_cast<int64_t>(m) * N + n, acc[i][j][r], colsum[n],
             rowsum[m], e, scale);
      }
}

// ---------------------------------------------------------------- sharded

// The sharded entry's epilogue over all-reduced partials: out[m, n] =
// bf16(dequant(acc, colsum[n], rowsum[m]) * f32(bf16(ax * aw))), the
// epilogue gemm_u8 applies, at the global K's constants; one thread an
// output.
__global__ void epilogue_bf16(const int32_t* __restrict__ acc,
                              const int32_t* __restrict__ rowsum,
                              const int32_t* __restrict__ colsum,
                              bf16* __restrict__ out, int M, int N,
                              const float* __restrict__ x_absmax,
                              const bf16* __restrict__ w_absmax, Epilogue e) {
  const float scale = out_scale(x_absmax, w_absmax);
  const int64_t total = static_cast<int64_t>(M) * N;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int m = static_cast<int>(i / N), n = static_cast<int>(i % N);
    store(out, i, dequant(acc[i], colsum[n], rowsum[m], e), scale);
  }
}

// ---------------------------------------------------------------- checks

// How many pairs (x, b) of a bf16 x (every pattern) and a finite bf16 b >=
// bf16(1e-6) (patterns 0x3586..0x7F7F) give normalise_rcp(x, b, 1/b) !=
// normalise(x, b): [0] where |x| <= b (what the kernel sees: b is the
// clamped max |x| of x's own operand), [1] over all pairs.
__global__ void div_check(unsigned long long* __restrict__ mismatches) {
  constexpr uint32_t kLo = 0x3586u, kHi = 0x7F7Fu;
  constexpr uint64_t kPairs = 65536ull * (kHi - kLo + 1);
  unsigned long long bad[2] = {0, 0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       i < kPairs; i += stride) {
    const float x = __uint_as_float(static_cast<uint32_t>(i & 0xFFFF) << 16);
    const float b = __uint_as_float((kLo + static_cast<uint32_t>(i >> 16))
                                    << 16);
    const float want = dither_quant::normalise(x, b);
    const float got = dither_quant::normalise_rcp(x, b, __frcp_rn(b));
    const bool differ = __float_as_uint(want) != __float_as_uint(got) &&
                        !(isnan(want) && isnan(got));
    bad[0] += differ && fabsf(x) <= b;
    bad[1] += differ;
  }
  for (int k = 0; k < 2; ++k) {
    for (int o = 16; o > 0; o >>= 1)
      bad[k] += __shfl_xor_sync(0xffffffffu, bad[k], o);
    if ((threadIdx.x & 31) == 0 && bad[k]) atomicAdd(mismatches + k, bad[k]);
  }
}

// ---------------------------------------------------------------- launch

struct Args {
  const void* a;          // (M, K) f32 or bf16, row stride K
  const void* b;          // (K, N) row-major, or (N, K) row-major (trans)
  void* out;              // (M, N) f32 or bf16
  uint8_t* codes_a;       // decode: (8 mt, 32 KC); prefill: (Mp, Kp)
  uint8_t* codes_bt;      // prefill: (Np, Kp)
  int32_t* rowsum;        // (M,)
  int32_t* colsum;        // (N,): prefill column sums; decode split scratch
  int32_t* acc;           // decode split scratch (M, N), zero
  unsigned* arrivals;     // decode split scratch (ceil(N / 16),), zero
  float* x_absmax;        // policy entry: f32 scratch word; else null
  const bf16* w_absmax;   // policy entry: the weight's clamped absmax
  int M, K, N;
};

// prep_rows on `rows` blocks for rows of Cp codes, on the dither fast path
// where p allows it.
template <typename T, typename... A>
void launch_prep(int rows, int Cp, cudaStream_t s, const Params& p,
                 A... args) {
  const int threads = prep_threads(Cp);
  if (dither_quant::fast_path(p))
    prep_rows<T, true><<<rows, threads, 0, s>>>(args..., p);
  else
    prep_rows<T, false><<<rows, threads, 0, s>>>(args..., p);
}

template <typename T, typename O, bool kTrans, int kMT>
int launch_decode(const Args& g, int cps, int splits, int async,
                  const Params& pa, const Params& pb, const Epilogue& e,
                  cudaStream_t s) {
  const int KC = (g.K + 31) / 32;
  const bool scaled = sizeof(O) == 2;
  launch_prep<T>(8 * kMT, 32 * KC, s, pa, static_cast<const T*>(g.a),
                 g.codes_a, g.rowsum, g.M, g.K, static_cast<int64_t>(g.K),
                 32 * KC, static_cast<uint32_t>(g.K), 1u, scaled ? 1 : 0,
                 g.x_absmax, static_cast<const bf16*>(nullptr), 0u, kWhole,
                 0u);
  fused_decode<T, O, kTrans, kMT>
      <<<dim3((g.N + 15) / 16, splits), kDecThreads, 0, s>>>(
          static_cast<const T*>(g.b), g.codes_a, g.rowsum, g.acc, g.colsum,
          g.arrivals, static_cast<O*>(g.out), g.x_absmax, g.w_absmax, g.M,
          g.K, g.N, cps, splits, async, pb, e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O, bool kTrans>
int launch_decode_mt(const Args& g, int mt, int cps, int splits, int async,
                     const Params& pa, const Params& pb, const Epilogue& e,
                     cudaStream_t s) {
  switch (mt) {
    case 1: return launch_decode<T, O, kTrans, 1>(g, cps, splits, async, pa,
                                                  pb, e, s);
    case 4: return launch_decode<T, O, kTrans, 4>(g, cps, splits, async, pa,
                                                  pb, e, s);
    case 16: return launch_decode<T, O, kTrans, 16>(g, cps, splits, async,
                                                    pa, pb, e, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename O, bool kTrans>
int launch_prefill(const Args& g, int Mp, int Np, int Kp, const Params& pa,
                   const Params& pb, const Epilogue& e, cudaStream_t s) {
  const bool scaled = sizeof(O) == 2;
  if (scaled) {
    cudaMemsetAsync(g.x_absmax, 0, sizeof(float), s);
    const int64_t n = static_cast<int64_t>(g.M) * g.K;
    const int64_t want = (n + 255) / 256;
    absmax_rows<<<static_cast<int>(want < 1056 ? want : 1056), 256, 0, s>>>(
        static_cast<const bf16*>(g.a), n,
        reinterpret_cast<unsigned*>(g.x_absmax));
  }
  launch_prep<T>(Mp, Kp, s, pa, static_cast<const T*>(g.a), g.codes_a,
                 g.rowsum, g.M, g.K, static_cast<int64_t>(g.K), Kp,
                 static_cast<uint32_t>(g.K), 1u, scaled ? 2 : 0, g.x_absmax,
                 static_cast<const bf16*>(nullptr), 0u, kWhole, 0u);
  if (kTrans) {   // row n of the (N, K) weight: index k * N + n
    launch_prep<T>(Np, Kp, s, pb, static_cast<const T*>(g.b), g.codes_bt,
                   g.colsum, g.N, g.K, static_cast<int64_t>(g.K), Kp, 1u,
                   static_cast<uint32_t>(g.N), 3, static_cast<float*>(nullptr),
                   g.w_absmax, 0u, kWhole, 0u);
  } else {
    cudaMemsetAsync(g.colsum, 0, sizeof(int32_t) * g.N, s);
    const dim3 grid(Np / 32, Kp / 32), block(32, 8);
    const bf16* aw = scaled ? g.w_absmax : nullptr;
    if (dither_quant::fast_path(pb))
      quantize_bt<T, true><<<grid, block, 0, s>>>(
          static_cast<const T*>(g.b), g.codes_bt, g.colsum, g.K, g.N, Kp, aw,
          static_cast<uint32_t>(g.N), 0u, pb);
    else
      quantize_bt<T, false><<<grid, block, 0, s>>>(
          static_cast<const T*>(g.b), g.codes_bt, g.colsum, g.K, g.N, Kp, aw,
          static_cast<uint32_t>(g.N), 0u, pb);
  }
  cudaFuncSetAttribute(gemm_u8<O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kGemmSmem);
  gemm_u8<O><<<dim3(Np / kBN, Mp / kBM), kThreads, kGemmSmem, s>>>(
      g.codes_a, g.codes_bt, g.rowsum, g.colsum, static_cast<O*>(g.out), g.M,
      g.N, Kp, scaled ? g.x_absmax : nullptr, g.w_absmax, e);
  return static_cast<int>(cudaGetLastError());
}

// The sharded policy entry: one block of a product whose operands are
// split over a mesh, always in the prefill regime.  x (M, K) bf16 is the
// block's rows and K slice, w (K, N) its K slice and columns (row-major,
// or the transposed view of a row-major (N, K) weight); the hash indices
// are the global ones (A: g(m) * Kg + k0 + k with g(m) = m0 + (m / seg) *
// seg_stride + m % seg; B: (k0 + k) * Ng + n0 + n) and the pulse counts,
// in pa and pb, the global N and M.  x_absmax (an f32 word) and w_absmax
// (bf16) are the global operands' clamped absmaxes.  partials 0: out is
// the bf16 product; 1: out is the int32 accumulator (M, N), rowsum and
// colsum the code sums of this K slice, for an exact all-reduce and
// epilogue_bf16.
template <bool kTrans>
int launch_sharded(const Args& g, int Mp, int Np, int Kp, uint32_t a_base,
                   int seg, uint32_t seg_stride, uint32_t Kg, uint32_t b_base,
                   uint32_t Ng, int partials, const Params& pa,
                   const Params& pb, const Epilogue& e, cudaStream_t s) {
  launch_prep<bf16>(Mp, Kp, s, pa, static_cast<const bf16*>(g.a), g.codes_a,
                    g.rowsum, g.M, g.K, static_cast<int64_t>(g.K), Kp, Kg, 1u,
                    2, g.x_absmax, static_cast<const bf16*>(nullptr), a_base,
                    seg, seg_stride);
  if (kTrans) {   // row n of the (N, K) weight: index (k0 + k) Ng + n0 + n
    launch_prep<bf16>(Np, Kp, s, pb, static_cast<const bf16*>(g.b),
                      g.codes_bt, g.colsum, g.N, g.K,
                      static_cast<int64_t>(g.K), Kp, 1u, Ng, 3,
                      static_cast<float*>(nullptr), g.w_absmax, b_base, kWhole,
                      0u);
  } else {
    cudaMemsetAsync(g.colsum, 0, sizeof(int32_t) * g.N, s);
    const dim3 grid(Np / 32, Kp / 32), block(32, 8);
    if (dither_quant::fast_path(pb))
      quantize_bt<bf16, true><<<grid, block, 0, s>>>(
          static_cast<const bf16*>(g.b), g.codes_bt, g.colsum, g.K, g.N, Kp,
          g.w_absmax, Ng, b_base, pb);
    else
      quantize_bt<bf16, false><<<grid, block, 0, s>>>(
          static_cast<const bf16*>(g.b), g.codes_bt, g.colsum, g.K, g.N, Kp,
          g.w_absmax, Ng, b_base, pb);
  }
  const dim3 grid(Np / kBN, Mp / kBM);
  if (partials) {
    cudaFuncSetAttribute(gemm_u8<int32_t>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kGemmSmem);
    gemm_u8<int32_t><<<grid, kThreads, kGemmSmem, s>>>(
        g.codes_a, g.codes_bt, g.rowsum, g.colsum,
        static_cast<int32_t*>(g.out), g.M, g.N, Kp, g.x_absmax, g.w_absmax,
        e);
  } else {
    cudaFuncSetAttribute(gemm_u8<bf16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kGemmSmem);
    gemm_u8<bf16><<<grid, kThreads, kGemmSmem, s>>>(
        g.codes_a, g.codes_bt, g.rowsum, g.colsum, static_cast<bf16*>(g.out),
        g.M, g.N, Kp, g.x_absmax, g.w_absmax, e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One product.  Arrays (all on the card, allocated by the wrapper):
// a, b, out as in Args; codes_a, codes_bt, rowsum, colsum, acc, arrivals,
// x_absmax scratch (acc, colsum and arrivals zero at entry in the decode
// regime with splits > 1, and zero again at exit).
//   kind: 0 the f32 entry (a, b f32, b row-major, out f32); 1 the policy
//         entry with a row-major bf16 weight; 2 with the transposed view
//         (b is the (N, K) row-major weight); both write bf16.
//   mt > 0: the decode regime (M <= 8 mt; mt in {1, 4, 16}), grid
//         (ceil(N / 16), splits), cps K chunks of 32 a block; async: the
//         weight's rows are 16-byte aligned for cp.async.
//   mt == 0: the prefill regime, Mp, Np multiples of 128 and Kp of 64.
// pa, pb: A's and B's quantiser (kernels/quantize.py:quant_params).
int repro_dither_matmul(const void* a, const void* b, void* out,
                        void* codes_a, void* codes_bt, void* rowsum,
                        void* colsum, void* acc, void* arrivals,
                        void* x_absmax, const void* w_absmax, int M, int K,
                        int N, int kind, int mt, int cps, int splits,
                        int async, int Mp, int Np, int Kp,
                        const dither_quant::Params* pa,
                        const dither_quant::Params* pb, float r_acc,
                        float c_col, float c_row, float c_k, int cross,
                        void* stream) {
  const Args g{a, b, out, static_cast<uint8_t*>(codes_a),
               static_cast<uint8_t*>(codes_bt), static_cast<int32_t*>(rowsum),
               static_cast<int32_t*>(colsum), static_cast<int32_t*>(acc),
               static_cast<unsigned*>(arrivals), static_cast<float*>(x_absmax),
               static_cast<const bf16*>(w_absmax), M, K, N};
  const Epilogue e{r_acc, c_col, c_row, c_k, cross};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind < 0 || kind > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (mt > 0) {
    if (M > 8 * mt || cps < 1 || splits < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    if (kind == 0)
      return launch_decode_mt<float, float, false>(g, mt, cps, splits, async,
                                                   *pa, *pb, e, s);
    if (kind == 1)
      return launch_decode_mt<bf16, bf16, false>(g, mt, cps, splits, async,
                                                 *pa, *pb, e, s);
    return launch_decode_mt<bf16, bf16, true>(g, mt, cps, splits, async, *pa,
                                              *pb, e, s);
  }
  if (Mp % kBM || Np % kBN || Kp % kBK || M > Mp || N > Np || K > Kp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == 0)
    return launch_prefill<float, float, false>(g, Mp, Np, Kp, *pa, *pb, e, s);
  if (kind == 1)
    return launch_prefill<bf16, bf16, false>(g, Mp, Np, Kp, *pa, *pb, e, s);
  return launch_prefill<bf16, bf16, true>(g, Mp, Np, Kp, *pa, *pb, e, s);
}

// The sharded policy entry (launch_sharded): x (M, K) and w bf16 (kind 1
// row-major (K, N), kind 2 the transposed view of a row-major (N, K)),
// local shapes; Mp, Np multiples of 128 and Kp of 64; a_base = m0 * Kg +
// k0 and b_base = k0 * Ng + n0 mod 2^32; x_absmax an f32 word, w_absmax
// bf16; out bf16 (M, N), or with partials int32 (M, N) beside rowsum (M,)
// and colsum (N,).
int repro_dither_matmul_sharded(const void* x, const void* w, void* out,
                                void* codes_a, void* codes_bt, void* rowsum,
                                void* colsum, void* x_absmax,
                                const void* w_absmax, int M, int K, int N,
                                int kind, int Mp, int Np, int Kp,
                                unsigned a_base, int seg, unsigned seg_stride,
                                unsigned Kg, unsigned b_base, unsigned Ng,
                                int partials, const dither_quant::Params* pa,
                                const dither_quant::Params* pb, float r_acc,
                                float c_col, float c_row, float c_k,
                                int cross, void* stream) {
  const Args g{x, w, out, static_cast<uint8_t*>(codes_a),
               static_cast<uint8_t*>(codes_bt), static_cast<int32_t*>(rowsum),
               static_cast<int32_t*>(colsum), nullptr, nullptr,
               static_cast<float*>(x_absmax),
               static_cast<const bf16*>(w_absmax), M, K, N};
  const Epilogue e{r_acc, c_col, c_row, c_k, cross};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((kind != 1 && kind != 2) || seg < 1 || Mp % kBM || Np % kBN ||
      Kp % kBK || M > Mp || N > Np || K > Kp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == 1)
    return launch_sharded<false>(g, Mp, Np, Kp, a_base, seg, seg_stride, Kg,
                                 b_base, Ng, partials, *pa, *pb, e, s);
  return launch_sharded<true>(g, Mp, Np, Kp, a_base, seg, seg_stride, Kg,
                              b_base, Ng, partials, *pa, *pb, e, s);
}

// epilogue_bf16 over all-reduced partials: acc (M, N), rowsum (M,), colsum
// (N,) int32, x_absmax an f32 word, w_absmax bf16 → out (M, N) bf16.
int repro_dither_matmul_epilogue(const void* acc, const void* rowsum,
                                 const void* colsum, void* out, int M, int N,
                                 const void* x_absmax, const void* w_absmax,
                                 float r_acc, float c_col, float c_row,
                                 float c_k, int cross, void* stream) {
  const Epilogue e{r_acc, c_col, c_row, c_k, cross};
  const int64_t total = static_cast<int64_t>(M) * N;
  const int64_t want = (total + 255) / 256;
  epilogue_bf16<<<static_cast<int>(want < 4096 ? (want > 0 ? want : 1)
                                                : 4096),
                  256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(acc), static_cast<const int32_t*>(rowsum),
      static_cast<const int32_t*>(colsum), static_cast<bf16*>(out), M, N,
      static_cast<const float*>(x_absmax), static_cast<const bf16*>(w_absmax),
      e);
  return static_cast<int>(cudaGetLastError());
}

// mismatches (two uint64 on the card, zeroed by the caller) += div_check's
// counts: pairs with |x| <= b, then all pairs.
int repro_div_check(void* mismatches, void* stream) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  div_check<<<sms * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(mismatches));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
