// The flash-decode tile body shared by the port's four attention kernels,
// for Hopper (sm_90a): the ring and paged decode kernels
// (decode_attention.cu, paged_decode_attention.cu) and the ring and paged
// speculative verify kernels (verify_attention.cu,
// paged_verify_attention.cu).
//
// kq query rows per slot (1 for decode), row t at position pos[b] + t; GQA
// groups of any size up to 16.  The kernels differ only in how a tile of the
// cache is addressed, which a `Tiles` policy supplies (RingTiles and
// PagedTiles below):
//
//   ntiles(b, p)  tiles slot b reads at position p (the length-aware skip,
//                 clamped to the tiles that exist)
//   base(b, t)    cache row of tile t's first key: K/V element
//                 (base + j) * nkv + h, scale (base + j) * nkv + h
//   key_pos(base, t, j)  absolute position of key j of tile t
//   size          keys per tile (bk)
//
// Everything else — staging, the dot, the masks, the online softmax, the
// scale folding and the output — is this one template, so the ring and the
// paged kernel run the same arithmetic in the same order on the same
// tiles: paged == ring bit for bit when bs == bk and no ring slot wrapped.
// A verify row is a decode block of its own (grid axis z), reading query
// row t and attending at pos + t, so verify row t == decode at pos + t bit
// for bit by construction.
//
// Per tile of bk keys: logits = (q . upcast(k)) * 1/sqrt(HD)
// [* k_scale/127]; masked (key_pos >= 0, key_pos <= pos, key_pos > pos -
// window) to -1e30; online softmax with f32 running max m, sum s and value
// accumulator acc; p [* v_scale/127] after the sum update; out = acc / s.
// Slots outside the tile are -inf, so a fully masked row gives uniform
// weights over the -1e30 logits it processed, as the plain version does,
// never NaN.
//
// Design: one thread block per (KV head, slot, query row), which stages
// each tile of K, V, scales and key positions in shared memory
// (single-buffered), one warp per query row of the group, each warp keeping
// its own f32 m, s and acc in registers.  int8 codes stay codes in shared
// memory and are upcast in registers; the scales fold in after the dot and
// after the sum update.  A verify call reads the cache once per query row
// (kq times); sharing one tile load across the rows is later work.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace flash_decode {

constexpr int kMaxBk = 64;      // keys per tile
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

template <int HD, typename KT, typename Tiles>
__global__ void __launch_bounds__(kMaxGroup * 32)
flash_decode_kernel(const uint16_t* __restrict__ q,
                    const KT* __restrict__ k, const KT* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const Tiles tiles,
                    const int* __restrict__ pos, float* __restrict__ out,
                    int nkv, int group, int kq, int window, float inv) {
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

  const int h = blockIdx.x, b = blockIdx.y, row = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int g = tid >> 5, lane = tid & 31;
  const int p = pos[b] + row;        // this query row's absolute position
  const int bk = tiles.size;
  const int ntiles = tiles.ntiles(b, p);
  // q and out are (B, kq, nkv, group, HD): this block's (b, row, h) group
  const size_t qrow = (static_cast<size_t>(b) * kq + row) * nkv + h;

  const uint16_t* qb = q + qrow * group * HD;
  for (int i = tid; i < group * HD; i += nthreads)
    q_s[i] = __uint_as_float(static_cast<uint32_t>(qb[i]) << 16);

  float m = -INFINITY, s = 0.f;
  float acc[kVPL];
#pragma unroll
  for (int d = 0; d < kVPL; ++d) acc[d] = 0.f;
  const float* qr = q_s + g * HD;
  float* pr = p_s + g * kMaxBk;

  for (int t = 0; t < ntiles; ++t) {
    const size_t base = tiles.base(b, t);
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < bk * kChunks; c += nthreads) {
      const int j = c / kChunks, col = c % kChunks;
      const size_t row = (base + j) * nkv + h;
      const uint4 kw = reinterpret_cast<const uint4*>(k + row * HD)[col];
      const uint4 vw = reinterpret_cast<const uint4*>(v + row * HD)[col];
      uint32_t* kd = k_s + j * kKStride + col * 4;
      kd[0] = kw.x; kd[1] = kw.y; kd[2] = kw.z; kd[3] = kw.w;
      reinterpret_cast<uint4*>(v_s + j * kRowWords)[col] = vw;
    }
    for (int j = tid; j < bk; j += nthreads) {
      kp_s[j] = tiles.key_pos(base, t, j);
      if constexpr (kQuant) {
        ks_s[j] = k_scale[(base + j) * nkv + h];
        vs_s[j] = v_scale[(base + j) * nkv + h];
      }
    }
    __syncthreads();

    // logits: lane owns keys lane and lane + 32 of the tile
    float lg[kMaxBk / 32];
#pragma unroll
    for (int i = 0; i < kMaxBk / 32; ++i) {
      const int j = lane + 32 * i;
      lg[i] = -INFINITY;  // outside the tile: no part of its max or sum
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

  float* o = out + (qrow * group + g) * HD + lane * kVPL;
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

// Launch on `stream` with grid (nkv, B, kq) and one warp per query row of
// the group; returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape it does not take).  k_scale / v_scale are null for a bf16 cache.
template <typename KT, typename Tiles>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const Tiles& tiles, const void* pos,
           void* out, int B, int nkv, int group, int kq, int hd, int window,
           float inv_sqrt_hd, void* stream) {
  if (B <= 0 || B > 65535 || nkv <= 0 || group < 1 || group > kMaxGroup ||
      kq < 1 || kq > 65535 || tiles.size < 1 || tiles.size > kMaxBk ||
      window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nkv, B, kq), block(32 * group);
  const size_t smem = smem_bytes<KT>(hd, group);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const uint16_t*>(q);
  const auto* kk = static_cast<const KT*>(k);
  const auto* vv = static_cast<const KT*>(v);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* ps = static_cast<const int*>(pos);
  auto* oo = static_cast<float*>(out);
  if (hd == 64) {
    flash_decode_kernel<64, KT, Tiles><<<grid, block, smem, st>>>(
        qq, kk, vv, ks, vs, tiles, ps, oo, nkv, group, kq, window,
        inv_sqrt_hd);
  } else if (hd == 128) {
    flash_decode_kernel<128, KT, Tiles><<<grid, block, smem, st>>>(
        qq, kk, vv, ks, vs, tiles, ps, oo, nkv, group, kq, window,
        inv_sqrt_hd);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Ring tiles: bk consecutive ring slots of row b (bk divides cap); key
// positions come from k_pos (-1 for a slot never written).  Past the ring's
// last tile (a verify row beyond the write budget) the count clamps.
struct RingTiles {
  const int* __restrict__ k_pos;
  int cap;
  int size;  // bk
  __device__ __forceinline__ int ntiles(int, int p) const {
    const int last = p >= 0 ? p / size : -1;     // floor(p / bk)
    return min(last, cap / size - 1) + 1;
  }
  __device__ __forceinline__ size_t base(int b, int t) const {
    return static_cast<size_t>(b) * cap + static_cast<size_t>(t) * size;
  }
  __device__ __forceinline__ int key_pos(size_t base, int, int j) const {
    return k_pos[base + j];
  }
};

// Paged tiles: tile t of slot b is pool block block_tables[b, t], key
// positions implicit.  Past the table's last entry (a verify row beyond the
// write budget) the count clamps, so the table is never read out of bounds.
struct PagedTiles {
  const int* __restrict__ block_tables;
  int nbmax;
  int size;  // bs
  __device__ __forceinline__ int ntiles(int, int p) const {
    const int last = p >= 0 ? p / size : -1;     // floor(p / bs)
    return min(last, nbmax - 1) + 1;
  }
  __device__ __forceinline__ size_t base(int b, int t) const {
    const int phys = block_tables[static_cast<size_t>(b) * nbmax + t];
    return static_cast<size_t>(phys) * size;
  }
  __device__ __forceinline__ int key_pos(size_t, int t, int j) const {
    return t * size + j;
  }
};

// Ring cache (B, cap, nkv, HD): bf16 when `quant` is false (scales null),
// int8 codes with (B, cap, nkv) scales when true.  bk must divide cap.
inline int launch_ring(bool quant, const void* q, const void* k,
                       const void* v, const void* k_scale,
                       const void* v_scale, const void* k_pos,
                       const void* pos, void* out, int B, int cap, int nkv,
                       int group, int kq, int hd, int bk, int window,
                       float inv_sqrt_hd, void* stream) {
  if (bk < 1 || cap % bk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const RingTiles tiles{static_cast<const int*>(k_pos), cap, bk};
  if (quant)
    return launch<int8_t>(q, k, v, k_scale, v_scale, tiles, pos, out, B, nkv,
                          group, kq, hd, window, inv_sqrt_hd, stream);
  return launch<uint16_t>(q, k, v, nullptr, nullptr, tiles, pos, out, B, nkv,
                          group, kq, hd, window, inv_sqrt_hd, stream);
}

// Paged pool (n_blocks, bs, nkv, HD) through block_tables (B, nbmax).
inline int launch_paged(bool quant, const void* q, const void* k,
                        const void* v, const void* k_scale,
                        const void* v_scale, const void* block_tables,
                        const void* pos, void* out, int B, int bs, int nbmax,
                        int nkv, int group, int kq, int hd, int window,
                        float inv_sqrt_hd, void* stream) {
  if (nbmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  const PagedTiles tiles{static_cast<const int*>(block_tables), nbmax, bs};
  if (quant)
    return launch<int8_t>(q, k, v, k_scale, v_scale, tiles, pos, out, B, nkv,
                          group, kq, hd, window, inv_sqrt_hd, stream);
  return launch<uint16_t>(q, k, v, nullptr, nullptr, tiles, pos, out, B, nkv,
                          group, kq, hd, window, inv_sqrt_hd, stream);
}

}  // namespace flash_decode
