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
// a first, simple design, its tile body and tile policy (RingTiles) in
// flash_decode.cuh (shared with the paged and the verify kernels): one
// thread block per (b, kv head), which stages
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

#include "flash_decode.cuh"

using flash_decode::launch_ring;

extern "C" {

// bf16 cache: k, v hold bf16 bits; no scales.
int repro_decode_attention_bf16(const void* q, const void* k, const void* v,
                                const void* k_pos, const void* pos, void* out,
                                int B, int cap, int nkv, int group, int hd,
                                int bk, int window, float inv_sqrt_hd,
                                void* stream) {
  return launch_ring(false, q, k, v, nullptr, nullptr, k_pos, pos, out, B,
                     cap, nkv, group, 1, hd, bk, window, inv_sqrt_hd, stream);
}

// int8 dither cache: k, v hold codes; k_scale, v_scale (B, cap, n_kv) f32.
int repro_decode_attention_int8(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* k_pos, const void* pos, void* out,
                                int B, int cap, int nkv, int group, int hd,
                                int bk, int window, float inv_sqrt_hd,
                                void* stream) {
  return launch_ring(true, q, k, v, k_scale, v_scale, k_pos, pos, out, B,
                     cap, nkv, group, 1, hd, bk, window, inv_sqrt_hd, stream);
}

}  // extern "C"
