// Causal flash attention for the train route (Fisher pass and the prune
// evaluations): q (B, S, Hq, hd) against k, v (B, S, Hkv, hd), GQA, bf16,
// online softmax over KV blocks, query i seeing kv positions <= i. Writes
// the bf16 output and, for the backward, the f32 log-sum-exp m + log(l) of
// every (b, query head, row).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
//   (B7: _kernel), which takes (B*H, S, hd) with the query heads folded
//   into the batch by the caller (kernels/backend.py, _fold_heads), equal q
//   and kv heads, and S a multiple of its 512-row blocks.
// Bound on the card: at the shapes the train route runs (S = 32 in the
//   calibration batch) bytes, a few hundred KB a layer; at long S the
//   operations, 2 * 2 * B * Hq * S^2 * hd / 2 for the causal half.
// Design: one block per (batch b, kv head h, tile of bq queries), with the
//   G = Hq / Hkv query heads of each query folded into the rows (bq = 32 / G,
//   so a block holds 32 rows): query head h*G + g reads kv head h, and a K/V
//   tile staged once serves all G heads, with no G-fold copy of K/V. 128
//   threads. KV blocks of 32 positions are visited in increasing order up
//   to the block that holds the tile's deepest row; blocks strictly above
//   the diagonal are never read (the Pallas kernel's block skip). K is staged
//   in shared memory as f32, then the scores, the online-softmax update (one
//   warp per row, one lane per position), then V and the PV update. q, k
//   and v are read through their strides (no transposes); the output is
//   contiguous. S need not be a multiple of anything: the ragged query tail
//   is masked (never loaded, never stored), and a K/V position past S is
//   never loaded and is masked by causality.
// Staging: B7's. Scores (q . k) in f32 from the bf16 operands, times
//   hd^-0.5 in f32; the mask value -1e30; m and l in f32 with expf; l sums
//   the unrounded p, PV takes p rounded to bf16, accumulated in f32; out =
//   acc / max(l, 1e-30) rounded to bf16. The jnp train route of the JAX
//   package instead scales q in f32 and rounds it to bf16 before the
//   product (models/attention.py); for hd = 64 the scale is 2^-3, so both
//   give the same scores.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128, BK = 32, HD_MAX = 128, ROWS = 32;
constexpr int MAXO = ROWS * HD_MAX / kThreads;    // outputs per thread
constexpr float kNegInf = -1e30f;

struct Strides {            // elements, of the batch, position and head axes
  long long b, s, h;
};

__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int S, int Hkv, int G, int hd,
                       Strides qs, Strides ks, Strides vs, float scale) {
  __shared__ float q_sh[ROWS * HD_MAX];
  __shared__ float kv_sh[BK * (HD_MAX + 1)];     // row stride hd + 1
  __shared__ float p_sh[ROWS * BK];
  __shared__ float m_sh[ROWS], l_sh[ROWS], corr_sh[ROWS];
  __shared__ int lim_sh[ROWS];

  const int h = blockIdx.x, qt = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * G, bq = ROWS / G, R = bq * G, kst = hd + 1;
  const int q0 = qt * bq;                        // first query of the tile

  // row r is query q0 + r / G, head h * G + r % G
  for (int idx = tid; idx < R * hd; idx += kThreads) {
    const int r = idx / hd, d = idx % hd, qi = q0 + r / G;
    q_sh[idx] = qi < S ? __bfloat162float(
                             q[b * qs.b + qi * qs.s + (h * G + r % G) * qs.h +
                               d])
                       : 0.0f;
  }
  if (tid < R) {
    const int qi = q0 + tid / G;
    lim_sh[tid] = qi < S ? qi : -1;              // tail rows see nothing
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.0f;
  }
  float acc[MAXO];
#pragma unroll
  for (int o = 0; o < MAXO; ++o) acc[o] = 0.0f;

  const int q_last = min(q0 + bq, S) - 1;
  const int n_kv = q_last / BK + 1;              // blocks meeting the diagonal
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  __syncthreads();
  for (int jb = 0; jb < n_kv; ++jb) {
    const int j0 = jb * BK;
    for (int idx = tid; idx < BK * hd; idx += kThreads) {
      const int j = idx / hd, d = idx % hd;
      kv_sh[j * kst + d] =
          j0 + j < S ? __bfloat162float(kb[(long long)(j0 + j) * ks.s + d])
                     : 0.0f;
    }
    __syncthreads();

    for (int idx = tid; idx < R * BK; idx += kThreads) {
      const int r = idx / BK, j = idx % BK;
      float s = 0.0f;
      for (int d = 0; d < hd; ++d)
        s = fmaf(q_sh[r * hd + d], kv_sh[j * kst + d], s);
      p_sh[idx] = (j0 + j <= lim_sh[r]) ? __fmul_rn(s, scale) : kNegInf;
    }
    __syncthreads();

    for (int r = warp; r < R; r += kThreads / 32) {
      const float s0 = p_sh[r * BK + lane];
      float mx = s0;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_sh[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new);
      float sum = p0;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_sh[r * BK + lane] = __bfloat162float(__float2bfloat16_rn(p0));
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_sh[r] = corr;
        l_sh[r] = l_sh[r] * corr + sum;
        m_sh[r] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < BK * hd; idx += kThreads) {
      const int j = idx / hd, d = idx % hd;
      kv_sh[j * kst + d] =
          j0 + j < S ? __bfloat162float(vb[(long long)(j0 + j) * vs.s + d])
                     : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int o = 0; o < MAXO; ++o) {
      const int idx = tid + o * kThreads;
      if (idx < R * hd) {
        const int r = idx / hd, d = idx % hd;
        float pv = 0.0f;
        for (int j = 0; j < BK; ++j)
          pv = fmaf(p_sh[r * BK + j], kv_sh[j * kst + d], pv);
        acc[o] = acc[o] * corr_sh[r] + pv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int o = 0; o < MAXO; ++o) {
    const int idx = tid + o * kThreads;
    if (idx < R * hd) {
      const int r = idx / hd, d = idx % hd, qi = q0 + r / G;
      if (qi < S)
        out[(((long long)b * S + qi) * Hq + h * G + r % G) * hd + d] =
            __float2bfloat16_rn(acc[o] / fmaxf(l_sh[r], 1e-30f));
    }
  }
  if (tid < R) {
    const int qi = q0 + tid / G;
    if (qi < S)
      lse[((long long)b * Hq + h * G + tid % G) * S + qi] =
          m_sh[tid] + logf(l_sh[tid]);
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, S, Hq, hd), k and v (B, S, Hkv, hd), all bf16 with the last dim
// contiguous and the other strides given in elements (q_sb, q_ss, q_sh for
// q's batch, position and head axes; likewise k_* and v_*); Hq = G * Hkv.
// -> out (B, S, Hq, hd) bf16 contiguous, lse (B, Hq, S) f32 contiguous.
// Needs hd <= 128, G <= 32 and at most 65535 tiles of 32 / G queries.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* lse, int B, int S, int Hkv,
                               int G, int hd, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss,
                               long long v_sh, float scale, void* stream) {
  if (hd > HD_MAX || hd < 1 || G < 1 || G > ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && S > 0 && Hkv > 0) {
    const int bq = ROWS / G;
    const long long tiles = (S + bq - 1) / bq;
    if (tiles > 65535 || B > 65535 || Hkv > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid(Hkv, static_cast<unsigned>(tiles), B);
    flash_attention_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), S, Hkv,
        G, hd, Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
        Strides{v_sb, v_ss, v_sh}, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
