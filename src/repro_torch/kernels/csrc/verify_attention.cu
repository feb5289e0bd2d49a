// Ring speculative-verify attention over the bf16 or int8-dither KV cache,
// for Hopper (sm_90a).  kq query rows per slot, GQA groups of any size up to
// 16.
//
// Replaces: the TPU kernel src/repro/kernels/decode_attention.py
// verify_attention_call (body _verify_body), and computes the same function
// as its plain version repro_torch/kernels/ref.py:verify_attention_ref with
// the kernel's tiles and split (block=(bk,), split=S):
//
//   q (B, kq, n_kv, group, HD) bf16, k/v (B, cap, n_kv, HD) int8 codes or
//   bf16, k_pos (B, cap) i32, pos (B,) i32 (the first row's position),
//   k_scale/v_scale (B, cap, n_kv) f32 when int8
//   ->  out (B, kq, n_kv, group, HD) f32.
//   Row t attends as a decode at pos[b] + t: mask k_pos >= 0 and
//   k_pos <= pos + t (plus the window), tiles past (pos + t) // bk skipped
//   (the per-row processed-block freeze), int8 scales folded after the dot
//   and after the sum update, its tiles cut into splits of S tiles by
//   absolute tile index and merged in ascending order.
//
// One block per (KV head, slot, split) covers all kq * group rows of the
// slot (flash_decode.cuh): it stages each tile once, up to the longest
// row's tile count, and its warps carry the rows (Qwen2-1.5B's heads at K 8:
// 48 rows, 16 warps of 3).  Each row runs the ring decode kernel's per-tile
// arithmetic with its own skip and split count, so row t equals the ring
// decode kernel at pos + t bit for bit — the contract that keeps a
// speculative stream equal to the plain one.  Rows past a slot's write
// budget still run (their outputs are discarded by the engine); at a
// position past the ring's last tile the tile count clamps, so nothing is
// read out of bounds.
//
// What bounds it on an H100: HBM bytes.  The distinct cache positions the
// rows need, up to pos + kq - 1 (K and V, n_kv * HD * (1 B int8 | 2 B bf16)
// each, plus 8 B of scales per position and head when int8, plus k_pos),
// read once at 3.35 TB/s; the work is 4 * group * HD flops per position,
// head and row, on the CUDA cores.  Sharing the tile load across the rows
// cuts a call's cache reads by kq to those bytes; the cost left is the
// rows' arithmetic (kq times decode's) and the latency of one HBM round
// trip per block.  Measured (chip_smoke.py --attention-times, NVIDIA H100
// 80GB HBM3, 700 W; K 4, B 8, positions to 2047): 0.0146 ms of device
// time (bf16; int8 0.0164) at SmolLM-135M's heads, 1.4x the ring decode
// kernel at the same positions, against the previous design's 0.0602 (one
// block per row) and SDPA's own 0.0246; 0.0107 at the serve profile's
// positions; 0.0182 at Qwen2-1.5B's heads (1.5x decode).
//
// `part` is f32 scratch (B, kq, n_kv, group, splits, HD + 2), null when
// splits == ceil(cap / bk / S) is 1.  The C entry points return
// cudaGetLastError() after the launches; the wrapper
// (kernels/verify_attention.py) checks shapes, dtypes and alignment before
// calling and raises on a non-zero return.

#include "flash_decode.cuh"

using flash_decode::launch_ring;
using flash_decode::kRowsPerWarp;

extern "C" {

// bf16 cache: k, v hold bf16 bits; no scales.
int repro_verify_attention_bf16(const void* q, const void* k, const void* v,
                                const void* k_pos, const void* pos, void* out,
                                void* part, int B, int cap, int nkv,
                                int group, int kq, int hd, int bk, int window,
                                int splits, float inv_sqrt_hd, void* stream) {
  return launch_ring<kRowsPerWarp>(false, q, k, v, nullptr, nullptr, k_pos,
      pos, out, part, B, cap, nkv, group, kq, hd, bk, window, splits,
      inv_sqrt_hd, stream);
}

// int8 dither cache: k, v hold codes; k_scale, v_scale (B, cap, n_kv) f32.
int repro_verify_attention_int8(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* k_pos, const void* pos, void* out,
                                void* part, int B, int cap, int nkv,
                                int group, int kq, int hd, int bk, int window,
                                int splits, float inv_sqrt_hd, void* stream) {
  return launch_ring<kRowsPerWarp>(true, q, k, v, k_scale, v_scale, k_pos,
      pos, out, part, B, cap, nkv, group, kq, hd, bk, window, splits,
      inv_sqrt_hd, stream);
}

}  // extern "C"
