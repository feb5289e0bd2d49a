// Paged flash-decode attention over the bf16 or int8-dither block pool, for
// Hopper (sm_90a).  One query token per slot, GQA groups of any size.
//
// Replaces: the TPU kernel src/repro/kernels/decode_attention.py
// paged_decode_attention_call (body _paged_attn_body), and computes the same
// function as its plain version
// repro_torch/kernels/ref.py:paged_decode_attention_ref:
//
//   q (B, n_kv, group, HD) bf16, pool k/v (n_blocks, bs, n_kv, HD) int8
//   codes or bf16, block_tables (B, nbmax) i32, pos (B,) i32,
//   k_scale/v_scale (n_blocks, bs, n_kv) f32 when int8
//   ->  out (B, n_kv, group, HD) f32.
//   The tile is the pool block: logical block j of slot b is physical block
//   block_tables[b, j] for j = 0 .. min(pos // bs, nbmax - 1), and the key
//   position of in-block slot t is the implicit j * bs + t.  The tile body
//   (flash_decode.cuh) is the ring kernel's, so paged == ring bit for bit
//   when bs == bk on the same token stream.
//
// Idle slots: the engine points every entry of an idle slot's table row at
// the pool's trailing trash block (a valid id), so the kernel reads in
// bounds there; their outputs are discarded.  Table entries must be ids of
// the pool: the kernel does not check them.
//
// What bounds it on an H100: HBM bytes.  A slot at position pos reads its
// ceil((pos+1) / bs) blocks of K and V for each KV head — bs * n_kv * HD *
// (1 B int8 | 2 B bf16) * 2 per block, plus the scales (8 B per position and
// head when int8) — at 3.35 TB/s; blocks that several slots share (a common
// prompt prefix) are read by each of them, but the bound counts each
// distinct block once.  The work is 4 * group * HD flops per position and
// head, far below the card's arithmetic rate.
//
// What this design does about it: the ring kernel's tile body
// (flash_decode.cuh) — codes are read as codes and upcast in registers, the
// tile loop stops at pos // bs, a slot's tiles are cut into splits of S = 2
// tiles over (n_kv, B, ceil(nbmax / S)) blocks merged by a second kernel,
// and cp.async keeps two tiles in flight.  A tile is one pool block, so bs
// keys (1 <= bs <= 64) come from one contiguous bs * n_kv * HD run of the
// pool; at small blocks a split covers only S * bs keys.  A tile that is
// not the pool block (several blocks per tile) is later work (ROADMAP
// Queue 2).  `part` is f32 scratch (B, 1, n_kv, group, splits, HD + 2),
// null when splits == ceil(nbmax / S) is 1.
//
// The C entry points return cudaGetLastError() after the launch; the
// wrapper (kernels/paged_decode_attention.py) checks shapes, dtypes and
// alignment before calling and raises on a non-zero return.

#include "flash_decode.cuh"

using flash_decode::launch_paged;

extern "C" {

// bf16 pool: k, v hold bf16 bits; no scales.
int repro_paged_decode_attention_bf16(const void* q, const void* k,
                                      const void* v, const void* block_tables,
                                      const void* pos, void* out, void* part,
                                      int B, int bs, int nbmax, int nkv,
                                      int group, int hd, int window,
                                      int splits, float inv_sqrt_hd,
                                      void* stream) {
  return launch_paged<1>(false, q, k, v, nullptr, nullptr, block_tables, pos,
      out, part, B, bs, nbmax, nkv, group, 1, hd, window, splits, inv_sqrt_hd,
      stream);
}

// int8 dither pool: k, v hold codes; k_scale, v_scale (n_blocks, bs, n_kv).
int repro_paged_decode_attention_int8(const void* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale,
                                      const void* block_tables,
                                      const void* pos, void* out, void* part,
                                      int B, int bs, int nbmax, int nkv,
                                      int group, int hd, int window,
                                      int splits, float inv_sqrt_hd,
                                      void* stream) {
  return launch_paged<1>(true, q, k, v, k_scale, v_scale, block_tables, pos,
      out, part, B, bs, nbmax, nkv, group, 1, hd, window, splits, inv_sqrt_hd,
      stream);
}

}  // extern "C"
