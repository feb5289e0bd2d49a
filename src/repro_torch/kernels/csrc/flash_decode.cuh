// The flash-decode tile body shared by the port's four attention kernels,
// for Hopper (sm_90a): the ring and paged decode kernels
// (decode_attention.cu, paged_decode_attention.cu) and the ring and paged
// speculative verify kernels (verify_attention.cu,
// paged_verify_attention.cu).
//
// kq query rows per slot (1 for decode), row t at position pos[b] + t; GQA
// groups of any size up to 16; head dims 64 and 128, and 256 for the ring
// decode kernel (a lane then owns 8 value dims: 4 words of V in bf16, 2 in
// int8; at group 16 two bf16 stages, the q rows and p take 167,440 bytes of
// shared memory, within the 232,448 opt-in).  The kernels differ only in how a tile of the
// cache is addressed, which a `Tiles` policy supplies (RingTiles and
// PagedTiles below):
//
//   ntiles(b, p)  tiles slot b reads at position p (the length-aware skip,
//                 clamped to the tiles that exist)
//   max_tiles()   the most tiles any row can read (cap / bk, or nbmax)
//   base(b, t)    cache row of tile t's first key: K/V element
//                 (base + j) * nkv + h, scale (base + j) * nkv + h
//   size          keys per tile (bk)
//   kStoredPos    key positions are read from k_pos and staged beside the
//                 tile (ring); otherwise key j of tile t is at t * bk + j
//
// Per tile of bk keys: logits = (q . upcast(k)) * 1/sqrt(HD)
// [* k_scale/127]; masked (key_pos >= 0, key_pos <= pos, key_pos > pos -
// window) to -1e30; online softmax with f32 running max m, sum s and value
// accumulator acc; p [* v_scale/127] after the sum update.  Slots outside
// the tile are -inf, so a fully masked row gives uniform weights over the
// -1e30 logits it processed, as the plain version does, never NaN.
//
// Fixed-span split (flash-decoding).  Split s of a query row covers its
// tiles [s*S, min((s+1)*S, ntiles)), S = kSplitTiles.  A row with at most S
// tiles has one split and writes out = acc / s directly.  A longer row
// writes f32 partials (acc_s, m_s, s_s) to scratch (B, kq, nkv, group,
// splits, HD + 2), and merge_kernel, launched right after from the same C
// entry point, combines them in ascending s: M = max m_s, w_s = exp(m_s -
// M), out = sum w_s * acc_s / sum w_s * s_s (products and sums each rounded,
// as the plain version's).  Each row's split count comes from pos on the
// device, so the scratch needs no memset; a fully masked split carries m =
// -1e30 and drops out, a fully masked row stays uniform.  The partition
// depends only on the absolute tile index, so verify row t == decode at
// pos + t, and paged == ring at bs == bk, bit for bit.  S = 2 tiles (128
// keys at bk 64): at B 8 and a 1024-slot ring it gives 192 blocks at
// SmolLM-135M's heads in place of the previous design's 24.  S = 2, 4 and 8
// were measured (chip_smoke.py --attention-times split=N, PERF.md §6): 2
// was the fastest at the long and the serve shapes but two, where 4 tied
// or led by 3 %.
//
// Grid (nkv * chunks, B, splits): one block per (KV head, slot, split)
// covers all kq * group query rows of the slot (in chunks of kMaxRows), so
// a verify call stages each tile once for all its rows.  Warp w of nwarps
// (as many as keep the rows per warp lowest) carries rows w, w + nwarps,
// ... (at most kRowsPerWarp), each row's f32 m, s and acc in registers;
// the warp converts each K and V element once for all its rows.  Each row
// keeps its own skip (ntiles at pos + t) and its own split count; the
// block stages tiles up to its longest row's count.
//
// Asynchronous tile pipeline.  K, V, the scales and the key positions are
// copied with cp.async (16-byte .cg for the K/V rows, 4-byte .ca for the
// strided scales and k_pos) into shared-memory stages, one commit group per
// tile, up to kStages - 1 = 2 tiles ahead of the one computed (so both
// tiles of a split are requested at once); one __syncthreads per tile.  K
// rows carry a 16-byte pad, which keeps cp.async's 16-byte alignment and
// makes each lane's 16-byte reads (one key per lane) conflict-free; each
// lane still dots the same keys in the same order.  TMA is not used: a
// tensor map per call costs host time on a host-bound path, and a cache
// row is only 64-256 bytes.
//
// No tensor cores: at a few flops per cache byte these kernels sit far
// below the card's ridge (~295 flops per byte), and a bf16 P in an mma would
// round the softmax weights the plain version keeps in f32 (KERNEL_TOL 1e-4).
// Every multiply-add of a row's recurrence is an explicit fmaf, none left
// to the compiler's contraction, so a row's bits do not depend on how many
// rows its warp carries (the plain version rounds the product and the sum
// apart: within KERNEL_TOL).

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace flash_decode {
// Internal linkage: each kernel library keeps its own instantiations and
// its own once-per-device flags (template statics of vague linkage would be
// shared between the libraries loaded into one process).
namespace {

constexpr int kMaxBk = 64;        // keys per tile
constexpr int kMaxGroup = 16;     // GQA group limit
constexpr int kMaxWarps = 16;     // warps per block
constexpr int kRowsPerWarp = 4;   // query rows a warp carries at most
constexpr int kMaxRows = kMaxWarps * kRowsPerWarp;   // rows per block
constexpr int kSplitTiles = 2;    // S: tiles per split
constexpr int kStages = 3;        // cp.async pipeline depth (tiles)
// stage buffers: a split never holds more than kSplitTiles tiles
constexpr int kBuffers = kSplitTiles < kStages ? kSplitTiles : kStages;
constexpr int kMaxDevices = 64;
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
// Code i of a word of int8 codes, exactly: the byte in offset binary as the
// mantissa of 2^23, minus 2^23 + 128 (a byte permute and an add, not an
// integer-to-float conversion).
__device__ __forceinline__ float i8_at(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                     0x7540u | i)) -
         8388736.0f;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Everything a launch shares but the cache addressing.
struct Args {
  const uint16_t* q;       // (B, kq, nkv, group, HD) bf16 bits
  const void* k;
  const void* v;
  const float* k_scale;    // null for a bf16 cache
  const float* v_scale;
  const int* pos;          // (B,)
  float* out;              // (B, kq, nkv, group, HD)
  float* part;             // (B, kq, nkv, group, splits, HD + 2); null if
                           // splits == 1
  int nkv, group, kq, window, splits;
  float inv;               // 1/sqrt(HD), rounded to f32 on the host
};

// Shared-memory words of one stage: K (padded rows), V, k_scale, v_scale,
// key positions.
template <int HD, typename KT>
struct Layout {
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(KT));
  static constexpr int kRowWords = kRowBytes / 4;
  static constexpr int kChunks = kRowBytes / 16;   // 16-byte pieces per row
  static constexpr int kKStride = kRowWords + 4;   // 16-byte pad
  static constexpr int kK = 0;
  static constexpr int kV = kK + kMaxBk * kKStride;
  static constexpr int kKs = kV + kMaxBk * kRowWords;
  static constexpr int kVs = kKs + kMaxBk;
  static constexpr int kKp = kVs + kMaxBk;
  static constexpr int kStageWords = kKp + kMaxBk;
  static constexpr int kBaseWords = (2 * kSplitTiles + 3) & ~3;   // size_t
  static size_t bytes(int rows, int nwarps) {
    return 4 * (static_cast<size_t>(kBaseWords) + kBuffers * kStageWords +
                static_cast<size_t>(rows) * HD +
                static_cast<size_t>(nwarps) * kRowsPerWarp * kMaxBk);
  }
};

// One tile of R query rows carried by one warp: logits for the lane's keys
// (lane, lane + 32), online-softmax update, p @ V.  Row rr is active on this
// tile when act[rr]; an inactive row's state is left as it was.
template <int HD, typename KT, bool kStoredPos, int R, int N>
__device__ __forceinline__ void tile_rows(
    const uint32_t* __restrict__ st, const float* __restrict__ q_s,
    float* __restrict__ pw, const int (&row)[N], const int (&p)[N],
    const bool (&act)[N], float (&m)[N], float (&s)[N],
    float (&acc)[N][HD / 32], int t, int bk, int window, float inv,
    int lane) {
  using L = Layout<HD, KT>;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int kEl = Word<KT>::kElems;
  constexpr int kVPL = HD / 32;
  const uint32_t* k_s = st + L::kK;
  const uint32_t* v_s = st + L::kV;
  const float* ks_s = reinterpret_cast<const float*>(st + L::kKs);
  const float* vs_s = reinterpret_cast<const float*>(st + L::kVs);
  const int* kp_s = reinterpret_cast<const int*>(st + L::kKp);

  // logits: the lane owns keys lane and lane + 32 of the tile; each q
  // chunk is read once for both keys, each K chunk converted once for all
  // rows, and each (row, key) dot is one fma chain in element order
  const bool has[2] = {lane < bk, lane + 32 < bk};
  float dot[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) dot[r][0] = dot[r][1] = 0.f;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    float kf[2][4 * kEl];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = has[i] ? lane + 32 * i : 0;   // key 0 stands in, unused
      const uint4 kw =
          reinterpret_cast<const uint4*>(k_s + j * L::kKStride)[c];
      const uint32_t words[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
      for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int e = 0; e < kEl; ++e)
          kf[i][w * kEl + e] = Word<KT>::at(words[w], e);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4* q4 =
          reinterpret_cast<const float4*>(q_s + row[r] * HD) + c * kEl;
#pragma unroll
      for (int x = 0; x < kEl; ++x) {
        const float4 qv = q4[x];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dot[r][i] = fmaf(qv.x, kf[i][4 * x + 0], dot[r][i]);
          dot[r][i] = fmaf(qv.y, kf[i][4 * x + 1], dot[r][i]);
          dot[r][i] = fmaf(qv.z, kf[i][4 * x + 2], dot[r][i]);
          dot[r][i] = fmaf(qv.w, kf[i][4 * x + 3], dot[r][i]);
        }
      }
    }
  }
  float lg[R][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = lane + 32 * i;
    int kp = 0;
    float ksc = 0.f;
    if (has[i]) {
      kp = kStoredPos ? kp_s[j] : t * bk + j;
      if constexpr (kQuant) ksc = ks_s[j] * (1.0f / 127.0f);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      lg[r][i] = -INFINITY;  // outside the tile: no part of its max or sum
      if (has[i]) {
        float l = dot[r][i] * inv;
        if constexpr (kQuant) l = l * ksc;
        bool valid = kp >= 0 && kp <= p[r];
        if (window > 0) valid = valid && kp > p[r] - window;
        lg[r][i] = valid ? l : kNegBig;
      }
    }
  }

  float alpha[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float m_new = fmaxf(m[r], warp_max(fmaxf(lg[r][0], lg[r][1])));
    alpha[r] = expf(m[r] - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = lane + 32 * i;
      float pe = j < bk ? expf(lg[r][i] - m_new) : 0.f;
      psum += pe;
      if constexpr (kQuant) {
        if (j < bk) pe = pe * (vs_s[j] * (1.0f / 127.0f));
      }
      if (j < bk) pw[r * kMaxBk + j] = pe;
    }
    const float tot = warp_sum(psum);
    if (act[r]) {
      s[r] = fmaf(s[r], alpha[r], tot);
      m[r] = m_new;
    }
  }
  __syncwarp();

  // p @ V: the lane owns value dims lane * kVPL .. lane * kVPL + kVPL - 1
  float pv[R][kVPL];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < kVPL; ++d) pv[r][d] = 0.f;
  const unsigned char* vbase = reinterpret_cast<const unsigned char*>(v_s) +
                               lane * kVPL * static_cast<int>(sizeof(KT));
#pragma unroll 8
  for (int j = 0; j < bk; ++j) {
    const unsigned char* vr = vbase + j * L::kRowBytes;
    float vf[kVPL];
    if constexpr (kVPL * sizeof(KT) == 2) {         // int8, HD 64
      const uint32_t w = *reinterpret_cast<const uint16_t*>(vr);
      vf[0] = i8_at(w, 0);
      vf[1] = i8_at(w, 1);
    } else {
      constexpr int kWords = kVPL * sizeof(KT) / 4;
      uint32_t ws[kWords];
      if constexpr (kWords == 1) {
        ws[0] = *reinterpret_cast<const uint32_t*>(vr);
      } else if constexpr (kWords == 2) {
        const uint2 w2 = *reinterpret_cast<const uint2*>(vr);
        ws[0] = w2.x; ws[1] = w2.y;
      } else {                                      // bf16, HD 256
        static_assert(kWords == 4, "a lane reads 1, 2 or 4 words of V");
        const uint4 w4 = *reinterpret_cast<const uint4*>(vr);
        ws[0] = w4.x; ws[1] = w4.y; ws[2] = w4.z; ws[3] = w4.w;
      }
#pragma unroll
      for (int w = 0; w < kWords; ++w)
#pragma unroll
        for (int e = 0; e < kEl; ++e) vf[w * kEl + e] = Word<KT>::at(ws[w], e);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float pj = pw[r * kMaxBk + j];
#pragma unroll
      for (int d = 0; d < kVPL; ++d) pv[r][d] = fmaf(pj, vf[d], pv[r][d]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (act[r]) {
#pragma unroll
      for (int d = 0; d < kVPL; ++d)
        acc[r][d] = fmaf(acc[r][d], alpha[r], pv[r][d]);
    }
  }
  __syncwarp();
}

// kMaxR: the most rows a warp carries in this instantiation (1 when the
// block has at most kMaxWarps rows, as every decode call: fewer registers).
template <int HD, typename KT, typename Tiles, int kMaxR>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_decode_kernel(const Args a, const Tiles tiles) {
  using L = Layout<HD, KT>;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int kVPL = HD / 32;

  extern __shared__ __align__(16) uint32_t smem[];
  size_t* base_s = reinterpret_cast<size_t*>(smem);
  uint32_t* stages = smem + L::kBaseWords;
  float* q_s = reinterpret_cast<float*>(stages + kBuffers * L::kStageWords);

  const int nkv = a.nkv, group = a.group;
  const int h = blockIdx.x % nkv, chunk = blockIdx.x / nkv;
  const int b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int g = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int bk = tiles.size;
  const int row0 = chunk * kMaxRows;
  const int nrows = min(a.kq * group - row0, kMaxRows);
  float* p_s = q_s + nrows * HD;

  // tiles this block stages: its split of the longest row's tiles
  const int pos_b = a.pos[b];
  const int t0 = split * kSplitTiles;
  const int p_last = pos_b + (row0 + nrows - 1) / group;
  const int t1 = min(t0 + kSplitTiles, tiles.ntiles(b, p_last));
  const int n = t1 - t0;
  if (n <= 0) return;

  for (int i = tid; i < n; i += nthreads) base_s[i] = tiles.base(b, t0 + i);
  __syncthreads();

  auto issue = [&](int i) {
    uint32_t* st = stages + (i % kBuffers) * L::kStageWords;
    const size_t base = base_s[i];
    const char* kg = static_cast<const char*>(a.k);
    const char* vg = static_cast<const char*>(a.v);
    for (int c = tid; c < bk * L::kChunks; c += nthreads) {
      const int j = c / L::kChunks, col = c % L::kChunks;
      const size_t off = ((base + j) * nkv + h) * L::kRowBytes + 16 * col;
      cp_async16(st + L::kK + j * L::kKStride + 4 * col, kg + off);
      cp_async16(st + L::kV + j * L::kRowWords + 4 * col, vg + off);
    }
    for (int j = tid; j < bk; j += nthreads) {
      if constexpr (Tiles::kStoredPos)
        cp_async4(st + L::kKp + j, tiles.k_pos + base + j);
      if constexpr (kQuant) {
        cp_async4(st + L::kKs + j, a.k_scale + (base + j) * nkv + h);
        cp_async4(st + L::kVs + j, a.v_scale + (base + j) * nkv + h);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) issue(i);
    cp_async_commit();
  }

  // this block's query rows: chunk row r is query row (t, gg) = divmod(row0
  // + r, group); q and out are (B, kq, nkv, group, HD)
  auto qrow = [&](int r) {
    const int rr = row0 + r, t = rr / group;
    return ((static_cast<size_t>(b) * a.kq + t) * nkv + h) * group +
           (rr - t * group);
  };
  for (int i = tid; i < nrows * HD; i += nthreads) {
    const int r = i / HD, d = i - r * HD;
    q_s[i] = __uint_as_float(static_cast<uint32_t>(a.q[qrow(r) * HD + d])
                             << 16);
  }

  // the warp's rows: g, g + nwarps, ... (at most kMaxR)
  int row[kMaxR], p[kMaxR], nt[kMaxR];
  bool act[kMaxR];
  float m[kMaxR], s[kMaxR], acc[kMaxR][kVPL];
  int nr = 0;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    row[r] = min(g + nwarps * r, nrows - 1);
    if (g + nwarps * r < nrows) nr = r + 1;
    p[r] = pos_b + (row0 + row[r]) / group;
    nt[r] = tiles.ntiles(b, p[r]);
    m[r] = -INFINITY;
    s[r] = 0.f;
#pragma unroll
    for (int d = 0; d < kVPL; ++d) acc[r][d] = 0.f;
  }
  float* pw = p_s + g * kRowsPerWarp * kMaxBk;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; every reader of tile i - 1 is done
    if (i + kStages - 1 < n) issue(i + kStages - 1);
    cp_async_commit();
    const uint32_t* st = stages + (i % kBuffers) * L::kStageWords;
    const int t = t0 + i;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) act[r] = r < nr && t < nt[r];
    // nr is warp-uniform: one inlined body per row count
    constexpr bool kPos = Tiles::kStoredPos;
    if (nr == 1) {
      tile_rows<HD, KT, kPos, 1>(st, q_s, pw, row, p, act, m, s, acc, t, bk,
                                 a.window, a.inv, lane);
    } else if constexpr (kMaxR == kRowsPerWarp) {
      if (nr == 2)
        tile_rows<HD, KT, kPos, 2>(st, q_s, pw, row, p, act, m, s, acc, t,
                                   bk, a.window, a.inv, lane);
      else if (nr == 3)
        tile_rows<HD, KT, kPos, 3>(st, q_s, pw, row, p, act, m, s, acc, t,
                                   bk, a.window, a.inv, lane);
      else if (nr == 4)
        tile_rows<HD, KT, kPos, 4>(st, q_s, pw, row, p, act, m, s, acc, t,
                                   bk, a.window, a.inv, lane);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    if (r >= nr || nt[r] <= t0) continue;   // no tile of this row here
    const size_t o = qrow(row[r]);
    if (nt[r] <= kSplitTiles) {             // one split: out = acc / s
      float* dst = a.out + o * HD + lane * kVPL;
#pragma unroll
      for (int d = 0; d < kVPL; ++d) dst[d] = acc[r][d] / s[r];
    } else {                                // partial (acc, m, s) of split
      float* dst = a.part + (o * a.splits + split) * (HD + 2);
#pragma unroll
      for (int d = 0; d < kVPL; ++d) dst[lane * kVPL + d] = acc[r][d];
      if (lane == 0) {
        dst[HD] = m[r];
        dst[HD + 1] = s[r];
      }
    }
  }
}

// Combine the partials of every row with more than one split, in ascending
// split order; one thread per output element.
template <int HD, typename Tiles>
__global__ void __launch_bounds__(256)
merge_kernel(const float* __restrict__ part, const int* __restrict__ pos,
             float* __restrict__ out, const Tiles tiles, int total,
             int per_slot, int per_row, int splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int o = idx / HD, d = idx - o * HD;          // o: (b, t, h, g) row
  const int b = o / per_slot;
  const int t = (o - b * per_slot) / per_row;        // per_row = nkv * group
  const int ns = (tiles.ntiles(b, pos[b] + t) + kSplitTiles - 1) / kSplitTiles;
  if (ns <= 1) return;
  const float* pr = part + static_cast<size_t>(o) * splits * (HD + 2);
  float mx = -INFINITY;
  for (int sp = 0; sp < ns; ++sp) mx = fmaxf(mx, pr[sp * (HD + 2) + HD]);
  float num = 0.f, den = 0.f;
  for (int sp = 0; sp < ns; ++sp) {
    const float* x = pr + sp * (HD + 2);
    const float w = expf(x[HD] - mx);
    num = __fadd_rn(num, __fmul_rn(w, x[d]));
    den = __fadd_rn(den, __fmul_rn(w, x[HD + 1]));
  }
  out[static_cast<size_t>(o) * HD + d] = num / den;
}

template <int HD, typename KT, typename Tiles, int kMaxR>
int launch_main(const Args& a, const Tiles& tiles, int B, cudaStream_t st) {
  const int rows = a.kq * a.group;
  const int chunks = (rows + kMaxRows - 1) / kMaxRows;
  const int chunk_rows = rows < kMaxRows ? rows : kMaxRows;
  // as few rows per warp as kMaxWarps allow, spread evenly (24 rows: 12
  // warps of 2, not 8 of 2 and 8 of 1)
  const int per_warp = (chunk_rows + kMaxWarps - 1) / kMaxWarps;
  const int nwarps = (chunk_rows + per_warp - 1) / per_warp;
  auto* kern = flash_decode_kernel<HD, KT, Tiles, kMaxR>;
  // more than 48 KB of dynamic shared memory: allowed once per device
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices || !allowed[dev]) {
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  const dim3 grid(a.nkv * chunks, B, a.splits), block(32 * nwarps);
  kern<<<grid, block, Layout<HD, KT>::bytes(chunk_rows, nwarps), st>>>(a,
                                                                       tiles);
  return static_cast<int>(cudaGetLastError());
}

// kMaxR: 1 for a decode entry point (its group of at most 16 rows takes one
// warp each), kRowsPerWarp for a verify one, which takes the one-row
// instantiation too when its rows fit.
template <int HD, typename KT, typename Tiles, int kMaxR>
int launch_hd(const Args& a, const Tiles& tiles, int B, cudaStream_t st) {
  const int rows = a.kq * a.group;
  int rc;
  if (rows <= kMaxWarps)
    rc = launch_main<HD, KT, Tiles, 1>(a, tiles, B, st);
  else if constexpr (kMaxR > 1)
    rc = launch_main<HD, KT, Tiles, kMaxR>(a, tiles, B, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0 || a.splits == 1) return rc;
  const int total = B * rows * a.nkv * HD;
  merge_kernel<HD, Tiles><<<(total + 255) / 256, 256, 0, st>>>(
      a.part, a.pos, a.out, tiles, total, a.kq * a.nkv * a.group,
      a.nkv * a.group, a.splits);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`; returns cudaGetLastError() after the launches (or
// cudaErrorInvalidValue for a shape it does not take).  k_scale / v_scale
// are null for a bf16 cache; `splits` must be ceil(max_tiles / S), with
// `part` the scratch for it (null when it is 1).
template <typename KT, typename Tiles, int kMaxR>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const Tiles& tiles, const void* pos,
           void* out, void* part, int B, int nkv, int group, int kq, int hd,
           int window, int splits, float inv_sqrt_hd, void* stream) {
  const long long grid_x =
      static_cast<long long>(nkv) * ((kq * group + kMaxRows - 1) / kMaxRows);
  if (B <= 0 || B > 65535 || nkv <= 0 || group < 1 || group > kMaxGroup ||
      kq < 1 || kq > 65535 || tiles.size < 1 || tiles.size > kMaxBk ||
      window < 0 || grid_x > 2147483647LL ||
      splits != (tiles.max_tiles() + kSplitTiles - 1) / kSplitTiles ||
      splits > 65535 || (splits > 1 && part == nullptr) ||
      static_cast<long long>(B) * kq * nkv * group * hd > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint16_t*>(q), k, v,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(pos), static_cast<float*>(out),
               static_cast<float*>(part), nkv, group, kq, window, splits,
               inv_sqrt_hd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch_hd<64, KT, Tiles, kMaxR>(a, tiles, B, st);
  if (hd == 128) return launch_hd<128, KT, Tiles, kMaxR>(a, tiles, B, st);
  // HD 256 (recurrentgemma's local attention) for the ring decode kernel
  // only: kernels 2-4 are not instantiated at it
  if constexpr (kMaxR == 1 && Tiles::kStoredPos) {
    if (hd == 256) return launch_hd<256, KT, Tiles, 1>(a, tiles, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Ring tiles: bk consecutive ring slots of row b (bk divides cap); key
// positions come from k_pos (-1 for a slot never written).  Past the ring's
// last tile (a verify row beyond the write budget) the count clamps.
struct RingTiles {
  static constexpr bool kStoredPos = true;
  const int* __restrict__ k_pos;
  int cap;
  int size;  // bk
  __host__ __device__ __forceinline__ int max_tiles() const {
    return cap / size;
  }
  __device__ __forceinline__ int ntiles(int, int p) const {
    const int last = p >= 0 ? p / size : -1;     // floor(p / bk)
    return min(last, cap / size - 1) + 1;
  }
  __device__ __forceinline__ size_t base(int b, int t) const {
    return static_cast<size_t>(b) * cap + static_cast<size_t>(t) * size;
  }
};

// Paged tiles: tile t of slot b is pool block block_tables[b, t], key
// positions implicit (t * bs + j).  Past the table's last entry (a verify
// row beyond the write budget) the count clamps, so the table is never read
// out of bounds.
struct PagedTiles {
  static constexpr bool kStoredPos = false;
  const int* __restrict__ block_tables;
  int nbmax;
  int size;  // bs
  const int* k_pos = nullptr;  // unused: positions are implicit
  __host__ __device__ __forceinline__ int max_tiles() const { return nbmax; }
  __device__ __forceinline__ int ntiles(int, int p) const {
    const int last = p >= 0 ? p / size : -1;     // floor(p / bs)
    return min(last, nbmax - 1) + 1;
  }
  __device__ __forceinline__ size_t base(int b, int t) const {
    const int phys = block_tables[static_cast<size_t>(b) * nbmax + t];
    return static_cast<size_t>(phys) * size;
  }
};

// Ring cache (B, cap, nkv, HD): bf16 when `quant` is false (scales null),
// int8 codes with (B, cap, nkv) scales when true.  bk must divide cap.
// Templates, so a library instantiates only the kernels it launches.
template <int kMaxR>
int launch_ring(bool quant, const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale, const void* k_pos,
                const void* pos, void* out, void* part, int B, int cap,
                int nkv, int group, int kq, int hd, int bk, int window,
                int splits, float inv_sqrt_hd, void* stream) {
  if (bk < 1 || cap % bk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const RingTiles tiles{static_cast<const int*>(k_pos), cap, bk};
  if (quant)
    return launch<int8_t, RingTiles, kMaxR>(
        q, k, v, k_scale, v_scale, tiles, pos, out, part, B, nkv, group, kq,
        hd, window, splits, inv_sqrt_hd, stream);
  return launch<uint16_t, RingTiles, kMaxR>(
      q, k, v, nullptr, nullptr, tiles, pos, out, part, B, nkv, group, kq,
      hd, window, splits, inv_sqrt_hd, stream);
}

// Paged pool (n_blocks, bs, nkv, HD) through block_tables (B, nbmax).
template <int kMaxR>
int launch_paged(bool quant, const void* q, const void* k, const void* v,
                 const void* k_scale, const void* v_scale,
                 const void* block_tables, const void* pos, void* out,
                 void* part, int B, int bs, int nbmax, int nkv, int group,
                 int kq, int hd, int window, int splits, float inv_sqrt_hd,
                 void* stream) {
  if (nbmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  const PagedTiles tiles{static_cast<const int*>(block_tables), nbmax, bs};
  if (quant)
    return launch<int8_t, PagedTiles, kMaxR>(
        q, k, v, k_scale, v_scale, tiles, pos, out, part, B, nkv, group, kq,
        hd, window, splits, inv_sqrt_hd, stream);
  return launch<uint16_t, PagedTiles, kMaxR>(
      q, k, v, nullptr, nullptr, tiles, pos, out, part, B, nkv, group, kq,
      hd, window, splits, inv_sqrt_hd, stream);
}

}  // namespace
}  // namespace flash_decode
