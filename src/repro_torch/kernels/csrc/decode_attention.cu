// Ring flash-decode attention over the bf16 or int8-dither KV cache, for
// Hopper (sm_90a).  One query token per slot, GQA groups of any size.
//
// Replaces: the TPU kernel src/repro/kernels/decode_attention.py
// decode_attention_call (body _attn_body), and computes the same function as
// its plain version repro_torch/kernels/ref.py:decode_attention_ref with the
// kernel's tiles and split (block=(bk,), split=S):
//
//   q (B, n_kv, group, HD) bf16, k/v (B, cap, n_kv, HD) int8 codes or bf16,
//   k_pos (B, cap) i32, pos (B,) i32, k_scale/v_scale (B, cap, n_kv) f32 when
//   int8  ->  out (B, n_kv, group, HD) f32.
//   Per cache tile of bk slots: logits = (q . upcast(k)) * 1/sqrt(HD)
//   [* k_scale/127]; masked (k_pos >= 0, k_pos <= pos, k_pos > pos - window)
//   to -1e30; online softmax with f32 running max m, sum s and value
//   accumulator acc; p [* v_scale/127] after the sum update.  Tiles past
//   pos // bk are skipped (the length-aware skip).  A slot's tiles are cut
//   into splits of S = 2 tiles, each its own recurrence, merged in ascending
//   order (flash_decode.cuh); a slot with at most S tiles is one split and
//   writes acc / s, the unsplit recurrence.
//
// What bounds it on an H100: HBM bytes.  A slot at position pos must read
// min(pos+1, cap) cache positions of K and V for each KV head,
// B * (pos+1) * n_kv * HD * (1 B int8 | 2 B bf16) * 2, plus the scales
// (8 B per position and head when int8) and k_pos (4 B per position), at
// 3.35 TB/s: 0.00106 ms (bf16) / 0.00057 ms (int8) at B 8, cap 1024 and
// positions to 2047.  The work is 4 * group * HD flops per position and
// head, on the CUDA cores.
//
// What this design does about it (flash_decode.cuh): the int8 cache is read
// as codes and upcast in registers, with the scales folded in after the dot;
// the tile loop stops at pos // bk; the fixed-span split spreads a slot's
// tiles over (n_kv, B, cap / bk / S) blocks (192 in place of 24 at
// SmolLM-135M's heads, batch 8, cap 1024) and a second small kernel merges
// the partials; cp.async requests both tiles of a split at once.
// Measured (chip_smoke.py --attention-times, NVIDIA H100 80GB HBM3,
// 700 W): 0.0105 ms of device time (bf16; int8 0.0111) at B 8, SmolLM's
// heads and positions to 2047, against the previous design's 0.0629 (one
// block per slot and head walking its tiles one HBM round trip at a time)
// and SDPA's own 0.0174; 0.0090 at the serve profile's positions (203-343).
// That is still ~10 % of the byte bound: a block waits one HBM round trip
// for its tiles, and the merge (~0.003 ms) is a second launch.  Head dims
// 64, 128 and 256; at 256 (recurrentgemma-9b's local attention: 1 KV head,
// group 16) 0.0284 ms of device time (bf16; int8 0.0307) at B 8 on a
// wrapped 2,048-slot ring under a 2,048-token window, against a 0.0030 ms
// byte bound (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
//
// inv_sqrt_hd is 1/sqrt(HD) rounded to f32 on the host, the plain version's
// constant.  `part` is f32 scratch (B, 1, n_kv, group, splits, HD + 2),
// null when splits == ceil(cap / bk / S) is 1.  The C entry points return
// cudaGetLastError() after the launches; the wrapper
// (kernels/decode_attention.py) checks shapes, dtypes and alignment before
// calling and raises on a non-zero return.

#include "flash_decode.cuh"

using flash_decode::launch_ring;

extern "C" {

// bf16 cache: k, v hold bf16 bits; no scales.
int repro_decode_attention_bf16(const void* q, const void* k, const void* v,
                                const void* k_pos, const void* pos, void* out,
                                void* part, int B, int cap, int nkv,
                                int group, int hd, int bk, int window,
                                int splits, float inv_sqrt_hd, void* stream) {
  return launch_ring<1>(false, q, k, v, nullptr, nullptr, k_pos, pos, out,
      part, B, cap, nkv, group, 1, hd, bk, window, splits, inv_sqrt_hd,
      stream);
}

// int8 dither cache: k, v hold codes; k_scale, v_scale (B, cap, n_kv) f32.
int repro_decode_attention_int8(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* k_pos, const void* pos, void* out,
                                void* part, int B, int cap, int nkv,
                                int group, int hd, int bk, int window,
                                int splits, float inv_sqrt_hd, void* stream) {
  return launch_ring<1>(true, q, k, v, k_scale, v_scale, k_pos, pos, out,
      part, B, cap, nkv, group, 1, hd, bk, window, splits, inv_sqrt_hd,
      stream);
}

}  // extern "C"
