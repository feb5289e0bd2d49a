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
// What bounds it on an H100.  In decode (M = the batch, 8) the weight
// operand dominates: every one of its K*N elements is read (4 bytes) and
// hashed once per call, ~60-100 integer instructions each, against about
// 1.7e13 a second; the product is 2*M*K*N int8 operations, far below
// 1979 TOPS.  In prefill (M = 4096) the product grows to 2*M*K*N and the
// int8 tensor-core rate bounds it.
//
// What this design does about it, and where it departs from the TPU
// kernel.  The TPU kernel re-quantises its A and B tiles at every grid step,
// so B is hashed M/bm times and A N/bn times; at a 4096-row prefill that is
// some 30-60x the hashing, which on this card would take seconds per
// forward.  Here each operand is quantised once, into u8 code buffers
// (padded with code 0 to the tile multiples, which adds nothing to a
// product or a sum), with the row and column code sums taken on the way:
//
//   1. quantize_a: A's codes, row-major (Mp, Kp), and rowsum (M,);
//   2. quantize_b: B's codes transposed through shared memory to (Np, Kp),
//      k contiguous per column, and colsum (N,);
//   3. gemm: 128x128 output tiles, 8 warps of 64x32, the u8 x u8 -> s32
//      tensor-core product mma.sync.m16n8k32 over 64-wide K chunks staged
//      in shared memory (single-buffered), then the epilogue above.
//
// The int32 accumulator is exact while K*(2^bits - 1)^2 < 2^31 (K < 33,025
// at 8 bits), which the wrapper checks; codes are u8, so bits <= 8.
// cp.async/TMA pipelining, wgmma and a split-K decode path are later work.
//
// The C entry point returns cudaGetLastError() after the last launch; the
// wrapper (kernels/dither_matmul.py) checks shapes, dtypes and contiguity,
// allocates the code buffers and sums, and raises on a non-zero return.

#include <cstdint>

#include "dither_quant.cuh"

namespace {

constexpr int kBM = 128;          // output rows per block
constexpr int kBN = 128;          // output columns per block
constexpr int kBK = 64;           // K bytes per staged chunk
constexpr int kPad = 16;          // shared-memory row padding (bytes)
constexpr int kLd = kBK + kPad;   // shared-memory row stride (bytes)
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kTileM = kBM / kWarpsM / 16;   // m16 tiles per warp (4)
constexpr int kTileN = kBN / kWarpsN / 8;    // n8 tiles per warp (4)

// A's codes: thread (tx, ty) of a (32, 8) block quantises row m, columns
// k0 + tx + 32 j (j < 4), and adds its row's code sum with one atomic per
// warp.  Columns K <= k < Kp and rows M <= m < Mp get code 0.
__global__ void quantize_a(const float* __restrict__ a,
                           uint8_t* __restrict__ codes,
                           int32_t* __restrict__ rowsum, int M, int K, int Kp,
                           dither_quant::Params p, uint32_t counter) {
  const int m = blockIdx.y * 8 + threadIdx.y;
  const int k0 = blockIdx.x * 128 + threadIdx.x;
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + 32 * j;
    if (k >= Kp) break;
    int code = 0;
    if (m < M && k < K) {
      const uint32_t idx =
          static_cast<uint32_t>(m) * static_cast<uint32_t>(K) +
          static_cast<uint32_t>(k);
      code = static_cast<int>(dither_quant::quantize(
          a[static_cast<int64_t>(m) * K + k], idx, counter, p));
    }
    codes[static_cast<int64_t>(m) * Kp + k] = static_cast<uint8_t>(code);
    sum += code;
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (threadIdx.x == 0 && m < M && sum) atomicAdd(rowsum + m, sum);
}

// B's codes for a 32 (k) x 32 (n) tile: thread (tx, ty) quantises column
// n0 + tx, rows k0 + ty + 8 j (coalesced reads along n), the tile is
// transposed in shared memory, and each column's 32 codes are written as
// eight 4-byte words, k contiguous.  Column sums: one atomic per column.
__global__ void quantize_b(const float* __restrict__ b,
                           uint8_t* __restrict__ codes_t,
                           int32_t* __restrict__ colsum, int K, int N, int Kp,
                           dither_quant::Params p, uint32_t counter) {
  __shared__ __align__(16) uint8_t tile[32][36];
  __shared__ int part[8][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int n = n0 + tx;
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kl = ty + 8 * j;
    const int k = k0 + kl;
    int code = 0;
    if (n < N && k < K) {
      const uint32_t idx =
          static_cast<uint32_t>(k) * static_cast<uint32_t>(N) +
          static_cast<uint32_t>(n);
      code = static_cast<int>(dither_quant::quantize(
          b[static_cast<int64_t>(k) * N + n], idx, counter, p));
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
  const int nl = t >> 3, w = t & 7;
  const uint32_t word = *reinterpret_cast<const uint32_t*>(&tile[nl][4 * w]);
  reinterpret_cast<uint32_t*>(codes_t + static_cast<int64_t>(n0 + nl) * Kp +
                              k0)[w] = word;
}

__device__ __forceinline__ void mma_u8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Epilogue {
  float r_acc, c_col, c_row, c_k;
  int cross;  // both zeros 0: out = acc * r_acc
};

// codes_a (Mp, Kp) and codes_bt (Np, Kp) u8, k contiguous; Mp, Np multiples
// of 128, Kp of 64.  One block per 128x128 output tile.
__global__ void __launch_bounds__(kThreads)
    gemm_u8(const uint8_t* __restrict__ codes_a,
            const uint8_t* __restrict__ codes_bt,
            const int32_t* __restrict__ rowsum,
            const int32_t* __restrict__ colsum, float* __restrict__ out,
            int M, int N, int Kp, Epilogue e) {
  __shared__ __align__(16) uint8_t As[kBM][kLd];
  __shared__ __align__(16) uint8_t Bs[kBN][kLd];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;       // groupID, thread in group
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int32_t acc[kTileM][kTileN][4];
#pragma unroll
  for (int i = 0; i < kTileM; ++i)
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int kc = 0; kc < Kp; kc += kBK) {
    // stage: 128 rows x 64 bytes of each operand = 512 16-byte vectors,
    // two per thread
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int e16 = tid + v * kThreads;
      const int row = e16 >> 2, col = (e16 & 3) * 16;
      *reinterpret_cast<uint4*>(&As[row][col]) =
          *reinterpret_cast<const uint4*>(
              codes_a + static_cast<int64_t>(m0 + row) * Kp + kc + col);
      *reinterpret_cast<uint4*>(&Bs[row][col]) =
          *reinterpret_cast<const uint4*>(
              codes_bt + static_cast<int64_t>(n0 + row) * Kp + kc + col);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[kTileM][4], bf[kTileN][2];
#pragma unroll
      for (int i = 0; i < kTileM; ++i) {
        const int r = wm * 64 + i * 16 + g;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tq * 4]);
        af[i][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tq * 4]);
        af[i][2] =
            *reinterpret_cast<const uint32_t*>(&As[r][kk + 16 + tq * 4]);
        af[i][3] =
            *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 16 + tq * 4]);
      }
#pragma unroll
      for (int j = 0; j < kTileN; ++j) {
        const int c = wn * 32 + j * 8 + g;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + tq * 4]);
        bf[j][1] =
            *reinterpret_cast<const uint32_t*>(&Bs[c][kk + 16 + tq * 4]);
      }
#pragma unroll
      for (int i = 0; i < kTileM; ++i)
#pragma unroll
        for (int j = 0; j < kTileN; ++j) mma_u8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTileM; ++i)
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm * 64 + i * 16 + g + (r >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + j * 8 + tq * 2 + (r & 1);
        if (m >= M || n >= N) continue;
        const float accf = __int2float_rn(acc[i][j][r]);
        float o;
        if (e.cross) {
          o = __fmaf_rn(accf, e.r_acc,
                        __fmul_rn(__int2float_rn(colsum[n]), e.c_col));
          o = __fadd_rn(o, __fmul_rn(__int2float_rn(rowsum[m]), e.c_row));
          o = __fadd_rn(o, e.c_k);
        } else {
          o = __fmul_rn(accf, e.r_acc);
        }
        out[static_cast<int64_t>(m) * N + n] = o;
      }
}

}  // namespace

extern "C" {

// a (M, K), b (K, N), out (M, N): f32 row-major.  Scratch from the wrapper:
// codes_a (Mp, Kp) and codes_bt (Np, Kp) u8, rowsum (M,) and colsum (N,)
// int32; Mp, Np multiples of 128 and Kp of 64, each >= its dimension.
// scheme: 0 deterministic, 1 stochastic, 2 dither; fmt: 0 spread, 1 unary.
int repro_dither_matmul(const void* a, const void* b, void* out, void* codes_a,
                        void* codes_bt, void* rowsum, void* colsum, int M,
                        int K, int N, int Mp, int Np, int Kp, float sa,
                        float za, float sb, float zb, float levels, int scheme,
                        int fmt, unsigned seed_a, unsigned seed_b,
                        unsigned n_pulses_a, unsigned mult_a,
                        unsigned n_pulses_b, unsigned mult_b, unsigned counter,
                        float r_acc, float c_col, float c_row, float c_k,
                        int cross, void* stream) {
  if (Mp % kBM || Np % kBN || Kp % kBK || M > Mp || N > Np || K > Kp)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(rowsum, 0, sizeof(int32_t) * M, s);
  cudaMemsetAsync(colsum, 0, sizeof(int32_t) * N, s);
  const dither_quant::Params pa{sa,     za,         levels, scheme,
                                fmt,    seed_a,     n_pulses_a, mult_a};
  const dither_quant::Params pb{sb,     zb,         levels, scheme,
                                fmt,    seed_b,     n_pulses_b, mult_b};
  quantize_a<<<dim3((Kp + 127) / 128, Mp / 8), dim3(32, 8), 0, s>>>(
      static_cast<const float*>(a), static_cast<uint8_t*>(codes_a),
      static_cast<int32_t*>(rowsum), M, K, Kp, pa, counter);
  quantize_b<<<dim3(Np / 32, Kp / 32), dim3(32, 8), 0, s>>>(
      static_cast<const float*>(b), static_cast<uint8_t*>(codes_bt),
      static_cast<int32_t*>(colsum), K, N, Kp, pb, counter);
  const Epilogue e{r_acc, c_col, c_row, c_k, cross};
  gemm_u8<<<dim3(Np / kBN, Mp / kBM), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(codes_a),
      static_cast<const uint8_t*>(codes_bt),
      static_cast<const int32_t*>(rowsum),
      static_cast<const int32_t*>(colsum), static_cast<float*>(out), M, N, Kp,
      e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
