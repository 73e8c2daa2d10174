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
// Bound on the card: at the train route's calibration batch (S = 32) bytes,
//   a few hundred KB a layer; at long S the operations, 4 * hd per visible
//   causal (query, key) pair, on the bf16 tensor cores.
// Design, FlashAttention-2 on mma.sync for Hopper:
//   * One block of 4 warps per (batch b, kv head h, tile of 64 rows): the
//     G = Hq / Hkv query heads of floor(64 / G) queries, row r being query
//     q0 + r / G of head h*G + r % G. A K/V tile staged once serves all G
//     heads, with no G-fold copy. Each warp owns 16 rows. Tiles are issued
//     deepest first, so the long causal rows start early.
//   * Staging: q, then K and V tiles of 64 positions, in bf16 in shared
//     memory, by 16-byte cp.async into a ring of three stages (the next two
//     tiles' copies fly while this one is computed: at S = 2048 the deepest
//     block walks 32 tiles in a row, and one tile's products take less
//     time than its copy); rows are padded by 16 bytes, so the
//     8 rows of an ldmatrix fall on 8 different bank groups. Positions past
//     S and rows past S are zero-filled by the copy, never read from memory.
//   * Products on the bf16 tensor cores, mma.sync m16n8k16 with f32
//     accumulators: S = Q K^T with Q fragments from ldmatrix (kept in
//     registers for the whole row) and K fragments from ldmatrix; O += P V
//     with V fragments from ldmatrix.trans. The online softmax stays in
//     registers: each thread holds two rows' scores, their max and sum over
//     the quad by shuffles; p goes to bf16 in registers as the A operand of
//     PV, in the accumulator layout the score MMA left it in.
//   * KV tiles are visited in increasing order up to the tile that holds
//     the block's deepest query; tiles wholly above the diagonal are never
//     read (the Pallas kernel's block skip), and only tiles that cross the
//     block's first query apply the causal mask. q, k and v are read
//     through their strides (no transposes); the output is contiguous.
//   * Templated on hd in {16, 64, 96, 128}: 64 is the repo's qwen3-0.6b,
//     128 the published one's, 96 phi-3-vision's (six k16 steps, twelve
//     n8 tiles; 208-byte rows), 16 the smoke config's. Register budget at
//     hd 128: 64 f32 of O, 32 of S, 32 words of Q a thread.
// Staging: B7's. Scores (q . k) in f32 from the bf16 operands, times
//   hd^-0.5 in f32 after the product; the mask value -1e30; m and l in f32
//   with expf; l sums the unrounded p, PV takes p rounded to bf16,
//   accumulated in f32; out = acc / max(l, 1e-30) rounded to bf16; lse =
//   m + log l. The jnp train route of the JAX package instead scales q in
//   f32 and rounds it to bf16 before the product (models/attention.py); for
//   hd = 64 the scale is 2^-3, so both give the same scores (at hd 96 and
//   128 they differ by that rounding).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace sm90;

constexpr int ROWS = 64, BKV = 64, kWarps = 4, kThreads = 32 * kWarps;
constexpr int STAGES = 3;   // K/V tiles in flight: a tile's copies take
                            // longer than one tile's products
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

struct Strides {            // elements, of the batch, position and head axes
  long long b, s, h;
};

template <int HD>
constexpr int smem_bytes() {
  return (ROWS + 2 * STAGES * BKV) * (HD + 8) * 2;   // q; K, V a stage
}

// 64 positions from j0 of one kv head into a [BKV][HD + 8] tile.
template <int HD>
__device__ __forceinline__ void load_kv(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src,
                                        long long stride, int j0, int S,
                                        int tid) {
  constexpr int P = HD + 8, CH = HD / 8;
#pragma unroll
  for (int c = tid; c < BKV * CH; c += kThreads) {
    const int j = c / CH, d = (c % CH) * 8;
    const bool ok = j0 + j < S;
    cp_async16(dst + j * P + d, ok ? src + (j0 + j) * stride + d : src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int S, int Hkv, int G,
                       Strides qs, Strides ks, Strides vs, float scale) {
  constexpr int P = HD + 8, CH = HD / 8, KC = HD / 16, DT = HD / 8;
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  __nv_bfloat16* q_sh = sm;                    // [ROWS][P]
  __nv_bfloat16* k_sh = q_sh + ROWS * P;       // [STAGES][BKV][P]
  __nv_bfloat16* v_sh = k_sh + STAGES * BKV * P;   // [STAGES][BKV][P]

  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = gridDim.y - 1 - blockIdx.y;   // deepest tiles first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Hq = Hkv * G, bq = ROWS / G, R = bq * G;
  const int q0 = qt * bq;                      // first query of the tile
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

#pragma unroll
  for (int c = tid; c < ROWS * CH; c += kThreads) {
    const int r = c / CH, d = (c % CH) * 8, qi = q0 + r / G;
    const bool ok = r < R && qi < S;
    cp_async16(q_sh + r * P + d,
               ok ? q + b * qs.b + qi * qs.s + (h * G + r % G) * qs.h + d : q,
               ok);
  }
  const int q_last = min(q0 + bq, S) - 1;
  const int n_kv = q_last / BKV + 1;           // tiles meeting the diagonal
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {    // q rides in the first group
    if (st < n_kv) {
      load_kv<HD>(k_sh + st * BKV * P, kb, ks.s, st * BKV, S, tid);
      load_kv<HD>(v_sh + st * BKV * P, vb, vs.s, st * BKV, S, tid);
    }
    cp_async_commit();
  }

  // this thread's two rows: g and g + 8 of the warp's 16
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int lim0 = q0 + r0 / G, lim1 = q0 + r1 / G;

  uint32_t qf[KC][4];
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  for (int jb = 0; jb < n_kv; ++jb) {
    cp_async_wait<STAGES - 2>();                 // tile jb has landed
    __syncthreads();
    {
      const int nt = jb + STAGES - 1;            // into the slot read at jb - 1
      if (nt < n_kv) {
        const int slot = nt % STAGES;
        load_kv<HD>(k_sh + slot * BKV * P, kb, ks.s, nt * BKV, S, tid);
        load_kv<HD>(v_sh + slot * BKV * P, vb, vs.s, nt * BKV, S, tid);
      }
      cp_async_commit();
    }
    if (jb == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldmatrix_x4(qf[kc], q_sh + (warp * 16 + (lane & 15)) * P + kc * 16 +
                                (lane >> 4) * 8);
    }
    const __nv_bfloat16* kt = k_sh + (jb % STAGES) * BKV * P;
    const __nv_bfloat16* vt = v_sh + (jb % STAGES) * BKV * P;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * P +
                            kc * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kc], bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qf[kc], bk[2], bk[3]);
      }

    const int j0 = jb * BKV;
    const bool diag = j0 + BKV - 1 > q0;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[j][e], scale);
        if (diag && j0 + 8 * j + 2 * t + (e & 1) > (e < 2 ? lim0 : lim1))
          x = kNegInf;
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - (e < 2 ? mn0 : mn1));
        s[j][e] = p;
        if (e < 2) sum0 += p; else sum1 += p;
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      o[i][0] *= c0;
      o[i][1] *= c0;
      o[i][2] *= c1;
      o[i][3] *= c1;
    }

#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + (kc * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * P +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0, qi = q0 + r / G;
    if (r >= R || qi >= S) continue;
    const float l = half ? l1 : l0, m = half ? m1 : m0;
    const float den = fmaxf(l, 1e-30f);
    const int head = h * G + r % G;
    __nv_bfloat16* orow = out + (((long long)b * S + qi) * Hq + head) * HD;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8 + 2 * t) =
          __floats2bfloat162_rn(o[i][2 * half] / den, o[i][2 * half + 1] / den);
    }
    if (t == 0) lse[((long long)b * Hq + head) * S + qi] = m + logf(l);
  }
}

template <int HD>
cudaError_t launch(dim3 grid, const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                   int S, int Hkv, int G, Strides qs, Strides ks, Strides vs,
                   float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  // the attribute belongs to a device: set once on each (past
  // kMaxDevices, at every launch)
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= kMaxDevices || !attr_set[dev])) {
    e = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, S, Hkv, G, qs, ks, vs, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, S, Hq, hd), k and v (B, S, Hkv, hd), all bf16 with the last dim
// contiguous, 16-byte aligned, and the other strides given in elements,
// multiples of 8 (q_sb, q_ss, q_sh for q's batch, position and head axes;
// likewise k_* and v_*); Hq = G * Hkv.
// -> out (B, S, Hq, hd) bf16 contiguous, lse (B, Hq, S) f32 contiguous.
// Needs hd in {16, 64, 96, 128}, G <= 64 and at most 65535 tiles of 64 / G
// queries.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* lse, int B, int S, int Hkv,
                               int G, int hd, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss,
                               long long v_sh, float scale, void* stream) {
  if (G < 1 || G > ROWS) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || S <= 0 || Hkv <= 0)
    return static_cast<int>(cudaGetLastError());
  const int bq = ROWS / G;
  const long long tiles = (S + bq - 1) / bq;
  if (tiles > 65535 || B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Hkv, static_cast<unsigned>(tiles), B);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (hd) {
    case 16: e = launch<16>(grid, qp, kp, vp, op, lp, S, Hkv, G, qs, ks, vs, scale, st); break;
    case 64: e = launch<64>(grid, qp, kp, vp, op, lp, S, Hkv, G, qs, ks, vs, scale, st); break;
    case 96: e = launch<96>(grid, qp, kp, vp, op, lp, S, Hkv, G, qs, ks, vs, scale, st); break;
    case 128: e = launch<128>(grid, qp, kp, vp, op, lp, S, Hkv, G, qs, ks, vs, scale, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
