// KV-tile helpers shared by the KV-cache attention kernels on the bf16
// tensor cores (prefill_attention.cu, decode_attention.cu): the 64-position
// tile, where a slot's KV lives (contiguous or paged), q staged as the plain
// version stages it, and p split into two bf16 terms for PV.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace sm90 {

constexpr int BKV = 64;          // KV positions a tile

// Where the KV of one slot lives.
struct KVArgs {
  long long kv_bstride, s_bstride;   // contiguous: batch strides (elements)
  const int* pages;                  // paged: (B, n_blk) int32 table
  int n_blk, page_size;
};

// row(pos): the storage row of position pos; (row, head 0, dim 0) of a KV
// leaf is at kv0 + row * Hkv * hd, (row, head 0) of a scale leaf at s0 +
// row * Hkv.
struct ContigAddr {
  static constexpr bool kPaged = false;
  size_t kv0, s0;
  __device__ ContigAddr(const KVArgs& a, int b)
      : kv0(b * a.kv_bstride), s0(b * a.s_bstride) {}
  __device__ size_t row(int pos) const { return pos; }
};

// Paged: one table read a position, from the slot's row of any length; a
// kernel reads only the entries of the positions it copies.
struct PagedAddr {
  static constexpr bool kPaged = true;
  size_t kv0 = 0, s0 = 0;
  const int* tbl;                    // the slot's table row
  int ps;
  __device__ PagedAddr(const KVArgs& a, int b)
      : tbl(a.pages + (size_t)b * a.n_blk), ps(a.page_size) {}
  __device__ size_t row(int pos) const {
    return (size_t)__ldg(tbl + pos / ps) * ps + pos % ps;
  }
};

// Two q values, scaled in f32 and rounded to bf16 (the plain version's
// staging), packed as an MMA operand word.
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* p,
                                           float scale) {
  const float2 x = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(p));
  return pack_bf16(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale));
}

// Two f32 values as hi = bf16(x) and lo = bf16(x - hi), each packed as an
// MMA operand word: hi + lo holds x to ~16 bits.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

}  // namespace sm90
