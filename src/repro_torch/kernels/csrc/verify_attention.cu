// Ring speculative-verify attention over the bf16 or int8-dither KV cache,
// for Hopper (sm_90a).  kq query rows per slot, GQA groups of any size up to
// 16.
//
// Replaces: the TPU kernel src/repro/kernels/decode_attention.py
// verify_attention_call (body _verify_body), and computes the same function
// as its plain version repro_torch/kernels/ref.py:verify_attention_ref:
//
//   q (B, kq, n_kv, group, HD) bf16, k/v (B, cap, n_kv, HD) int8 codes or
//   bf16, k_pos (B, cap) i32, pos (B,) i32 (the first row's position),
//   k_scale/v_scale (B, cap, n_kv) f32 when int8
//   ->  out (B, kq, n_kv, group, HD) f32.
//   Row t attends as a decode at pos[b] + t: mask k_pos >= 0 and
//   k_pos <= pos + t (plus the window), tiles past (pos + t) // bk skipped
//   (the per-row processed-block freeze), int8 scales folded after the dot
//   and after the sum update.
//
// Row t is a block of its own (grid (n_kv, B, kq)) running the ring decode
// kernel's tile body (flash_decode.cuh) at pos + t on query row t, so row t
// equals the ring decode kernel at pos + t bit for bit — the contract that
// keeps a speculative stream equal to the plain one.  Rows past a slot's
// write budget still run (their outputs are discarded by the engine); at a
// position past the ring's last tile the tile count clamps, so nothing is
// read out of bounds.
//
// What bounds it on an H100: HBM bytes.  The distinct cache positions the
// rows need, up to pos + kq - 1 (K and V, n_kv * HD * (1 B int8 | 2 B bf16)
// each, plus 8 B of scales per position and head when int8, plus k_pos),
// read once at 3.35 TB/s; the work is 4 * group * HD flops per position,
// head and row.  This simple design reads the cache once per row — kq times
// the bound's bytes, mostly from L2 for rows of one slot — since each row is
// a separate block; sharing one tile load across the rows of a slot is
// later work.
//
// The C entry points return cudaGetLastError() after the launch; the
// wrapper (kernels/verify_attention.py) checks shapes, dtypes and alignment
// before calling and raises on a non-zero return.

#include "flash_decode.cuh"

using flash_decode::launch_ring;

extern "C" {

// bf16 cache: k, v hold bf16 bits; no scales.
int repro_verify_attention_bf16(const void* q, const void* k, const void* v,
                                const void* k_pos, const void* pos, void* out,
                                int B, int cap, int nkv, int group, int kq,
                                int hd, int bk, int window, float inv_sqrt_hd,
                                void* stream) {
  return launch_ring(false, q, k, v, nullptr, nullptr, k_pos, pos, out, B,
                     cap, nkv, group, kq, hd, bk, window, inv_sqrt_hd,
                     stream);
}

// int8 dither cache: k, v hold codes; k_scale, v_scale (B, cap, n_kv) f32.
int repro_verify_attention_int8(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* k_pos, const void* pos, void* out,
                                int B, int cap, int nkv, int group, int kq,
                                int hd, int bk, int window, float inv_sqrt_hd,
                                void* stream) {
  return launch_ring(true, q, k, v, k_scale, v_scale, k_pos, pos, out, B,
                     cap, nkv, group, kq, hd, bk, window, inv_sqrt_hd,
                     stream);
}

}  // extern "C"
