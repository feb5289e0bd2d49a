// Paged speculative-verify attention over the bf16 or int8-dither block
// pool, for Hopper (sm_90a).  kq query rows per slot, GQA groups of any size
// up to 16.
//
// Replaces: the TPU kernel src/repro/kernels/decode_attention.py
// paged_verify_attention_call (body _paged_verify_body), and computes the
// same function as its plain version
// repro_torch/kernels/ref.py:paged_verify_attention_ref:
//
//   q (B, kq, n_kv, group, HD) bf16, pool k/v (n_blocks, bs, n_kv, HD) int8
//   codes or bf16, block_tables (B, nbmax) i32, pos (B,) i32 (the first
//   row's position), k_scale/v_scale (n_blocks, bs, n_kv) f32 when int8
//   ->  out (B, kq, n_kv, group, HD) f32.
//   Row t attends as a paged decode at pos[b] + t: logical block j is
//   physical block block_tables[b, j] for j = 0 .. min((pos + t) // bs,
//   nbmax - 1), key positions the implicit j * bs + i.
//
// One block per (KV head, slot, split) covers all kq * group rows and stages
// each pool block once (flash_decode.cuh); each row runs the paged decode
// kernel's per-tile arithmetic at pos + t with its own skip and split count,
// so row t equals the paged decode kernel at pos + t bit for bit, and at
// 64-token blocks the ring verify kernel at bk 64.  Pool blocks of 1..64
// tokens; the tile is the pool block.  Rows past a slot's write budget
// still run (the engine discards them); the table read clamps at its last
// entry.
//
// What bounds it on an H100: HBM bytes — each distinct pool position the
// rows need (blocks shared by several slots once), up to pos + kq - 1, read
// once at 3.35 TB/s.  Blocks shared by several slots are still read by
// each; the tile is the pool block (ROADMAP Queue 2).  `part` is f32
// scratch (B, kq, n_kv, group, splits, HD + 2), null when splits ==
// ceil(nbmax / S) is 1.
//
// The C entry points return cudaGetLastError() after the launch; the
// wrapper (kernels/paged_verify_attention.py) checks shapes, dtypes and
// alignment before calling and raises on a non-zero return.

#include "flash_decode.cuh"

using flash_decode::launch_paged;
using flash_decode::kRowsPerWarp;

extern "C" {

// bf16 pool: k, v hold bf16 bits; no scales.
int repro_paged_verify_attention_bf16(const void* q, const void* k,
                                      const void* v, const void* block_tables,
                                      const void* pos, void* out, void* part,
                                      int B, int bs, int nbmax, int nkv,
                                      int group, int kq, int hd, int window,
                                      int splits, float inv_sqrt_hd,
                                      void* stream) {
  return launch_paged<kRowsPerWarp>(false, q, k, v, nullptr, nullptr,
      block_tables, pos, out, part, B, bs, nbmax, nkv, group, kq, hd, window,
      splits, inv_sqrt_hd, stream);
}

// int8 dither pool: k, v hold codes; k_scale, v_scale (n_blocks, bs, n_kv).
int repro_paged_verify_attention_int8(const void* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale,
                                      const void* block_tables,
                                      const void* pos, void* out, void* part,
                                      int B, int bs, int nbmax, int nkv,
                                      int group, int kq, int hd, int window,
                                      int splits, float inv_sqrt_hd,
                                      void* stream) {
  return launch_paged<kRowsPerWarp>(true, q, k, v, k_scale, v_scale,
      block_tables, pos, out, part, B, bs, nbmax, nkv, group, kq, hd, window,
      splits, inv_sqrt_hd, stream);
}

}  // extern "C"
