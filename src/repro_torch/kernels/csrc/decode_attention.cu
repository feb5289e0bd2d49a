// Ring flash-decode attention over the bf16 or int8-dither KV cache, for
// Hopper (sm_90a).  One query token per slot, GQA groups of any size.
//
// Replaces: the TPU kernel src/repro/kernels/decode_attention.py
// decode_attention_call (body _attn_body), and computes the same function as
// its plain version repro_torch/kernels/ref.py:decode_attention_ref:
//
//   q (B, n_kv, group, HD) bf16, k/v (B, cap, n_kv, HD) int8 codes or bf16,
//   k_pos (B, cap) i32, pos (B,) i32, k_scale/v_scale (B, cap, n_kv) f32 when
//   int8  ->  out (B, n_kv, group, HD) f32.
//   Per cache tile of bk slots: logits = (q . upcast(k)) * 1/sqrt(HD)
//   [* k_scale/127]; masked (k_pos >= 0, k_pos <= pos, k_pos > pos - window)
//   to -1e30; online softmax with f32 running max m, sum s and value
//   accumulator acc; p [* v_scale/127] after the sum update; out = acc / s.
//   Tiles past pos // bk are skipped (the length-aware skip), so a fully
//   masked row gives uniform weights over the -1e30 logits it processed,
//   exactly as the plain version with the same block does, never NaN.
//
// What bounds it on an H100: HBM bytes.  A slot at position pos must read
// min(pos+1, cap) cache positions of K and V for each KV head,
// B * (pos+1) * n_kv * HD * (1 B int8 | 2 B bf16) * 2, plus the scales
// (8 B per position and head when int8) and k_pos (4 B per position), at
// 3.35 TB/s; the work is 4 * group * HD flops per position and head, far
// below the card's arithmetic rate.
//
// What this design does about it: the int8 cache is read as codes (half the
// bytes of bf16) and upcast in registers, with the scales folded in after
// the dot, so no dequantised copy of the cache is ever written; the tile loop
// stops at pos // bk, so a slot reads only the tiles it has written.  It is
// a first, simple design: one thread block per (b, kv head), which stages
// each tile of K, V, scales and k_pos in shared memory (single-buffered),
// one warp per query row of the group, each keeping its own f32 m, s and acc.
// B * n_kv is only 24 blocks at batch 8 on 132 SMs, and each block waits on
// every tile's load; splitting the cache length across blocks (split-K with
// a second reduction pass), cp.async/TMA double-buffering and tensor cores
// are later work.
//
// inv_sqrt_hd is 1/sqrt(HD) rounded to f32 on the host, the plain version's
// constant.  The C entry points return cudaGetLastError() after the launch; the
// wrapper (kernels/decode_attention.py) checks shapes, dtypes and alignment
// before calling and raises on a non-zero return.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxBk = 64;      // cache slots per tile (shrunk to divide cap)
constexpr int kMaxGroup = 16;   // query rows per KV head: one warp each
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Butterfly sum: every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float i8_at(uint32_t w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}

// Elements of one 32-bit word of a cache row: 2 bf16 or 4 int8 codes.
template <typename KT>
struct Word {
  static constexpr int kElems = 4 / sizeof(KT);
  __device__ __forceinline__ static float at(uint32_t w, int i) {
    if constexpr (std::is_same<KT, int8_t>::value) {
      return i8_at(w, i);
    } else {
      return i == 0 ? bf16_lo(w) : bf16_hi(w);
    }
  }
};

template <int HD, typename KT>
__global__ void __launch_bounds__(kMaxGroup * 32)
decode_attention_kernel(const uint16_t* __restrict__ q,
                        const KT* __restrict__ k, const KT* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ k_pos,
                        const int* __restrict__ pos,
                        float* __restrict__ out, int cap, int nkv, int group,
                        int bk, int window, float inv) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int kRowBytes = HD * static_cast<int>(sizeof(KT));
  constexpr int kRowWords = kRowBytes / 4;
  constexpr int kKStride = kRowWords + 1;  // padded: lanes read across rows
  constexpr int kChunks = kRowBytes / 16;  // 16-byte loads per cache row
  constexpr int kVPL = HD / 32;            // value dims per lane
  constexpr int kEl = Word<KT>::kElems;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                // group * HD
  uint32_t* k_s = reinterpret_cast<uint32_t*>(q_s + group * HD);
  uint32_t* v_s = k_s + kMaxBk * kKStride;                    // unpadded
  float* ks_s = reinterpret_cast<float*>(v_s + kMaxBk * kRowWords);
  float* vs_s = ks_s + kMaxBk;
  int* kp_s = reinterpret_cast<int*>(vs_s + kMaxBk);
  float* p_s = reinterpret_cast<float*>(kp_s + kMaxBk);      // group * kMaxBk

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int g = tid >> 5, lane = tid & 31;
  const int p = pos[b];
  const int nb = cap / bk;
  const int last = p >= 0 ? p / bk : -1;          // floor(p / bk)
  const int ntiles = min(last, nb - 1) + 1;

  const uint16_t* qb = q + static_cast<size_t>(b * nkv + h) * group * HD;
  for (int i = tid; i < group * HD; i += nthreads)
    q_s[i] = __uint_as_float(static_cast<uint32_t>(qb[i]) << 16);

  float m = -INFINITY, s = 0.f;
  float acc[kVPL];
#pragma unroll
  for (int d = 0; d < kVPL; ++d) acc[d] = 0.f;
  const float* qr = q_s + g * HD;
  float* pr = p_s + g * kMaxBk;

  for (int t = 0; t < ntiles; ++t) {
    const int t0 = t * bk;
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < bk * kChunks; c += nthreads) {
      const int j = c / kChunks, col = c % kChunks;
      const size_t row = (static_cast<size_t>(b) * cap + t0 + j) * nkv + h;
      const uint4 kw = reinterpret_cast<const uint4*>(k + row * HD)[col];
      const uint4 vw = reinterpret_cast<const uint4*>(v + row * HD)[col];
      uint32_t* kd = k_s + j * kKStride + col * 4;
      kd[0] = kw.x; kd[1] = kw.y; kd[2] = kw.z; kd[3] = kw.w;
      reinterpret_cast<uint4*>(v_s + j * kRowWords)[col] = vw;
    }
    for (int j = tid; j < bk; j += nthreads) {
      const size_t slot = static_cast<size_t>(b) * cap + t0 + j;
      kp_s[j] = k_pos[slot];
      if constexpr (kQuant) {
        ks_s[j] = k_scale[slot * nkv + h];
        vs_s[j] = v_scale[slot * nkv + h];
      }
    }
    __syncthreads();

    // logits: lane owns keys lane and lane + 32 of the tile
    float lg[kMaxBk / 32];
#pragma unroll
    for (int i = 0; i < kMaxBk / 32; ++i) {
      const int j = lane + 32 * i;
      lg[i] = -INFINITY;  // outside the block: no part of its max or sum
      if (j < bk) {
        const uint32_t* kr = k_s + j * kKStride;
        float dot = 0.f;
#pragma unroll 8
        for (int w = 0; w < kRowWords; ++w) {
          const uint32_t word = kr[w];
#pragma unroll
          for (int e = 0; e < kEl; ++e)
            dot = fmaf(qr[w * kEl + e], Word<KT>::at(word, e), dot);
        }
        float l = dot * inv;
        if constexpr (kQuant) l = l * (ks_s[j] * (1.0f / 127.0f));
        const int kp = kp_s[j];
        bool valid = kp >= 0 && kp <= p;
        if (window > 0) valid = valid && kp > p - window;
        lg[i] = valid ? l : kNegBig;
      }
    }
    float tmax = lg[0];
#pragma unroll
    for (int i = 1; i < kMaxBk / 32; ++i) tmax = fmaxf(tmax, lg[i]);
    const float m_new = fmaxf(m, warp_max(tmax));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxBk / 32; ++i) {
      const int j = lane + 32 * i;
      float pe = j < bk ? expf(lg[i] - m_new) : 0.f;
      psum += pe;
      if constexpr (kQuant) {
        if (j < bk) pe = pe * (vs_s[j] * (1.0f / 127.0f));
      }
      if (j < bk) pr[j] = pe;
    }
    s = s * alpha + warp_sum(psum);
    m = m_new;
    __syncwarp();

    // p @ V: lane owns value dims lane * kVPL .. lane * kVPL + kVPL - 1
    float pv[kVPL];
#pragma unroll
    for (int d = 0; d < kVPL; ++d) pv[d] = 0.f;
    const unsigned char* vbase = reinterpret_cast<const unsigned char*>(v_s) +
                                 lane * kVPL * static_cast<int>(sizeof(KT));
    for (int j = 0; j < bk; ++j) {
      const float pj = pr[j];
      const unsigned char* vr = vbase + j * kRowBytes;
      if constexpr (kVPL * sizeof(KT) == 2) {         // int8, HD 64
        const uint32_t w = *reinterpret_cast<const uint16_t*>(vr);
        pv[0] = fmaf(pj, i8_at(w, 0), pv[0]);
        pv[1] = fmaf(pj, i8_at(w, 1), pv[1]);
      } else {
        constexpr int kWords = kVPL * sizeof(KT) / 4;
        uint32_t ws[kWords];
        if constexpr (kWords == 1) {
          ws[0] = *reinterpret_cast<const uint32_t*>(vr);
        } else {
          const uint2 w2 = *reinterpret_cast<const uint2*>(vr);
          ws[0] = w2.x; ws[1] = w2.y;
        }
#pragma unroll
        for (int w = 0; w < kWords; ++w)
#pragma unroll
          for (int e = 0; e < kEl; ++e)
            pv[w * kEl + e] = fmaf(pj, Word<KT>::at(ws[w], e), pv[w * kEl + e]);
      }
    }
#pragma unroll
    for (int d = 0; d < kVPL; ++d) acc[d] = acc[d] * alpha + pv[d];
    __syncwarp();
  }

  float* o = out + (static_cast<size_t>(b * nkv + h) * group + g) * HD +
             lane * kVPL;
#pragma unroll
  for (int d = 0; d < kVPL; ++d) o[d] = acc[d] / s;
}

template <typename KT>
size_t smem_bytes(int hd, int group) {
  const int row_words = hd * static_cast<int>(sizeof(KT)) / 4;
  return sizeof(float) * (static_cast<size_t>(group) * hd +
                          kMaxBk * (row_words + 1) + kMaxBk * row_words +
                          3 * kMaxBk + static_cast<size_t>(group) * kMaxBk);
}

template <typename KT>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* k_pos, const void* pos, void* out,
           int B, int cap, int nkv, int group, int hd, int bk, int window,
           float inv_sqrt_hd, void* stream) {
  if (B <= 0 || nkv <= 0 || group < 1 || group > kMaxGroup || bk < 1 ||
      bk > kMaxBk || cap % bk != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nkv, B), block(32 * group);
  const size_t smem = smem_bytes<KT>(hd, group);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const uint16_t*>(q);
  const auto* kk = static_cast<const KT*>(k);
  const auto* vv = static_cast<const KT*>(v);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* kp = static_cast<const int*>(k_pos);
  const auto* ps = static_cast<const int*>(pos);
  auto* oo = static_cast<float*>(out);
  if (hd == 64) {
    decode_attention_kernel<64, KT><<<grid, block, smem, st>>>(
        qq, kk, vv, ks, vs, kp, ps, oo, cap, nkv, group, bk, window, inv_sqrt_hd);
  } else if (hd == 128) {
    decode_attention_kernel<128, KT><<<grid, block, smem, st>>>(
        qq, kk, vv, ks, vs, kp, ps, oo, cap, nkv, group, bk, window, inv_sqrt_hd);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 cache: k, v hold bf16 bits; no scales.
int repro_decode_attention_bf16(const void* q, const void* k, const void* v,
                                const void* k_pos, const void* pos, void* out,
                                int B, int cap, int nkv, int group, int hd,
                                int bk, int window, float inv_sqrt_hd,
                                void* stream) {
  return launch<uint16_t>(q, k, v, nullptr, nullptr, k_pos, pos, out, B, cap,
                          nkv, group, hd, bk, window, inv_sqrt_hd, stream);
}

// int8 dither cache: k, v hold codes; k_scale, v_scale (B, cap, n_kv) f32.
int repro_decode_attention_int8(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* k_pos, const void* pos, void* out,
                                int B, int cap, int nkv, int group, int hd,
                                int bk, int window, float inv_sqrt_hd,
                                void* stream) {
  return launch<int8_t>(q, k, v, k_scale, v_scale, k_pos, pos, out, B, cap,
                        nkv, group, hd, bk, window, inv_sqrt_hd, stream);
}

}  // extern "C"
