// KV-tile helpers shared by the KV-cache attention kernels on the bf16
// tensor cores (prefill_attention.cu, decode_attention.cu): the 64-position
// tile, q staged as the plain version stages it, and p split into two bf16
// terms for PV.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace sm90 {

constexpr int BKV = 64;          // KV positions a tile

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
