// Chunked-prefill attention: a chunk of Sq queries per slot at absolute
// positions start..start+Sq-1 against a slotted KV window (B4) or a paged KV
// arena (B6), GQA, bf16 or INT8 KV, online softmax, causal limit
// kv_pos <= start + i per query.
//
// Replaces: src/repro/kernels/prefill_attention.py, prefill_attention_pallas
//   (B4: _body, _kernel) and paged_prefill_attention_pallas (B6: _body,
//   _paged_kernel).
// Bound on the card: bytes for the chunk sizes the engine runs (16 queries
//   against a window of a few hundred positions): each block reads its KV
//   prefix (int8 KV with its scales and, paged, the table prefix) once per
//   query tile and does ~4 flops per KV element and row.
// Design: one block per (slot b, kv head h, tile of bq queries), where the
//   G = Hq/Hkv heads of each query are folded into the rows: bq = 32 / G,
//   so a block holds 32 rows. 128 threads. KV blocks of 32 positions sit at
//   absolute boundaries j*32 and are visited in increasing j, up to the
//   block that holds the tile's deepest row; K is staged in shared memory
//   as f32, then scores, the online-softmax update (one warp per row), then
//   V and the PV update. Each row is masked at kv_pos <= start + i, and the
//   ragged query tail is masked (never loaded, never stored), not padded.
//   A KV block wholly past a row's limit leaves that row's state unchanged
//   bit for bit (max unchanged, p == 0, corr == 1), and a row's arithmetic
//   never depends on the other rows of its tile. So a row's output does not
//   depend on how the prompt was chunked: chunked prefill gives the same bits
//   as whole-prompt prefill, row for row.
// Layouts: as decode_attention.cu, one body templated on an address policy
//   (contiguous: b * kv_bstride + pos * Hkv * hd; paged: (table[b, pos /
//   page_size] * page_size + pos % page_size) * Hkv * hd in size_t, the
//   table prefix staged in shared memory once per block, each position
//   looked up once per KV block into shared offsets). The 32-position
//   compute block runs over logical positions whatever the page size, so
//   the paged kernel equals the contiguous one on the gathered window bit
//   for bit, at any page size. The paged window is W = n_blk * page_size.
// Staging: as decode_attention.cu: the plain version's (kernels/ref.py
//   cached_attention_ref) for q, the scores, the -1e30 mask, k_s on scores
//   and v_s on probabilities; online softmax in f32 with expf; p stays f32
//   for PV (as in the TPU kernel), where the plain version rounds it to
//   bf16. Hence a stated tolerance, not equality, against the plain version.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128, BK = 32, HD_MAX = 128, ROWS = 32;
constexpr int MAXO = ROWS * HD_MAX / kThreads;    // outputs per thread
constexpr int TBL_MAX = 2048;                     // page-table entries a row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// Where the KV of one slot lives. kv(pos) / sc(pos) give the element offset
// of (pos, head 0, dim 0) in a KV leaf and of (pos, head 0) in a scale leaf.
struct KVArgs {
  long long kv_bstride, s_bstride;   // contiguous: batch strides (elements)
  const int* pages;                  // paged: (B, n_blk) int32 table
  int n_blk, page_size;
};

struct ContigAddr {
  size_t kv0, s0, kv_row, s_row;
  __device__ ContigAddr(const KVArgs& a, int b, int Hkv, int hd, int*)
      : kv0(b * a.kv_bstride), s0(b * a.s_bstride),
        kv_row((size_t)Hkv * hd), s_row(Hkv) {}
  __device__ size_t kv(int pos) const { return kv0 + (size_t)pos * kv_row; }
  __device__ size_t sc(int pos) const { return s0 + (size_t)pos * s_row; }
};

struct PagedAddr {
  const int* tbl;                    // the row's table prefix, in shared
  size_t kv_row, s_row;
  int ps;
  __device__ PagedAddr(const KVArgs& a, int b, int Hkv, int hd, int* tbl_sh)
      : tbl(tbl_sh), kv_row((size_t)Hkv * hd), s_row(Hkv), ps(a.page_size) {
    for (int i = threadIdx.x; i < a.n_blk; i += blockDim.x)
      tbl_sh[i] = a.pages[(size_t)b * a.n_blk + i];
    __syncthreads();
  }
  __device__ size_t slot(int pos) const {
    return (size_t)tbl[pos / ps] * ps + pos % ps;
  }
  __device__ size_t kv(int pos) const { return slot(pos) * kv_row; }
  __device__ size_t sc(int pos) const { return slot(pos) * s_row; }
};

template <typename T, bool kQuant, typename Addr>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const float* __restrict__ k_s,
                         const float* __restrict__ v_s,
                         const int* __restrict__ start,
                         __nv_bfloat16* __restrict__ out, int Sq, int W,
                         int Hkv, int G, int hd, KVArgs kv_args,
                         float scale) {
  __shared__ float q_sh[ROWS * HD_MAX];
  __shared__ float kv_sh[BK * (HD_MAX + 1)];     // row stride hd + 1
  __shared__ float p_sh[ROWS * BK];
  __shared__ float ks_sh[BK], vs_sh[BK];
  __shared__ float m_sh[ROWS], l_sh[ROWS], corr_sh[ROWS];
  __shared__ int lim_sh[ROWS];
  __shared__ int tbl_sh[TBL_MAX];                // paged only
  __shared__ size_t kv_off[BK], s_off[BK];       // per staged position

  const int h = blockIdx.x, qt = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * G, bq = ROWS / G, R = bq * G, ks = hd + 1;
  const int q0 = qt * bq;                        // first query of the tile
  const int st = start[b];
  const Addr at(kv_args, b, Hkv, hd, tbl_sh);

  // row r is query q0 + r / G, head h * G + r % G
  for (int idx = tid; idx < R * hd; idx += kThreads) {
    const int r = idx / hd, d = idx % hd, qi = q0 + r / G;
    float x = 0.0f;
    if (qi < Sq)
      x = __bfloat162float(
          q[(((size_t)b * Sq + qi) * Hq + h * G + r % G) * hd + d]);
    q_sh[idx] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, scale)));
  }
  if (tid < R) {
    const int qi = q0 + tid / G;
    // tail rows see nothing; no row sees past the window, as in the plain
    // version
    lim_sh[tid] = qi < Sq ? min(st + qi, W - 1) : -1;
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.0f;
  }
  float acc[MAXO];
#pragma unroll
  for (int o = 0; o < MAXO; ++o) acc[o] = 0.0f;

  const int q_last = min(q0 + bq, Sq) - 1;
  const int n_kv = min(st + q_last, W - 1) / BK + 1;
  __syncthreads();
  for (int jb = 0; jb < n_kv; ++jb) {
    const int j0 = jb * BK;
    // one address lookup per position (for a paged arena, one table read)
    for (int j = tid; j < BK; j += kThreads) {
      const int pos = min(j0 + j, W - 1);
      kv_off[j] = at.kv(pos) + (size_t)h * hd;
      s_off[j] = at.sc(pos) + h;
    }
    __syncthreads();
    for (int idx = tid; idx < BK * hd; idx += kThreads) {
      const int j = idx / hd, d = idx % hd;
      kv_sh[j * ks + d] = j0 + j < W ? to_f32(k[kv_off[j] + d]) : 0.0f;
    }
    if (kQuant) {
      for (int j = tid; j < BK; j += kThreads) {
        ks_sh[j] = j0 + j < W ? k_s[s_off[j]] : 0.0f;
        vs_sh[j] = j0 + j < W ? v_s[s_off[j]] : 0.0f;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < R * BK; idx += kThreads) {
      const int r = idx / BK, j = idx % BK;
      float s = 0.0f;
      for (int d = 0; d < hd; ++d)
        s = fmaf(q_sh[r * hd + d], kv_sh[j * ks + d], s);
      if (kQuant) s = __fmul_rn(s, ks_sh[j]);
      p_sh[idx] = (j0 + j <= lim_sh[r]) ? s : kNegInf;
    }
    __syncthreads();

    for (int r = warp; r < R; r += kThreads / 32) {
      const float s0 = p_sh[r * BK + lane];
      float mx = s0;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_sh[r];
      const float m_new = fmaxf(m_prev, mx);
      float p0 = expf(s0 - m_new);
      float sum = p0;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (kQuant) p0 = __fmul_rn(p0, vs_sh[lane]);
      p_sh[r * BK + lane] = p0;
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
      kv_sh[j * ks + d] = j0 + j < W ? to_f32(v[kv_off[j] + d]) : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int o = 0; o < MAXO; ++o) {
      const int idx = tid + o * kThreads;
      if (idx < R * hd) {
        const int r = idx / hd, d = idx % hd;
        float pv = 0.0f;
        for (int j = 0; j < BK; ++j)
          pv = fmaf(p_sh[r * BK + j], kv_sh[j * ks + d], pv);
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
      if (qi < Sq)
        out[(((size_t)b * Sq + qi) * Hq + h * G + r % G) * hd + d] =
            __float2bfloat16_rn(acc[o] / fmaxf(l_sh[r], 1e-30f));
    }
  }
}

template <typename Addr>
int launch(const void* q, const void* k, const void* v, const void* k_s,
           const void* v_s, const void* start, void* out, int B, int Sq,
           int W, int Hkv, int G, int hd, KVArgs kv_args, int quantized,
           float scale, void* stream) {
  if (hd > HD_MAX || G > ROWS || hd < 1 || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && Sq > 0 && Hkv > 0) {
    const int bq = ROWS / G;
    dim3 grid(Hkv, (Sq + bq - 1) / bq, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
    const float* ksp = static_cast<const float*>(k_s);
    const float* vsp = static_cast<const float*>(v_s);
    const int* sp = static_cast<const int*>(start);
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
    if (quantized) {
      prefill_attention_kernel<int8_t, true, Addr><<<grid, kThreads, 0, s>>>(
          qp, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
          ksp, vsp, sp, op, Sq, W, Hkv, G, hd, kv_args, scale);
    } else {
      prefill_attention_kernel<__nv_bfloat16, false, Addr>
          <<<grid, kThreads, 0, s>>>(
              qp, static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v), ksp, vsp, sp, op, Sq, W,
              Hkv, G, hd, kv_args, scale);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Sq, Hq, hd) bf16 contiguous; k, v (B, W, Hkv, hd) bf16 (quantized
// == 0) or int8 (quantized == 1) with the last three dims contiguous and
// batch stride kv_bstride elements; k_s, v_s (B, W, Hkv) f32 with the last
// two dims contiguous and batch stride s_bstride (ignored unless
// quantized); start (B,) int32 -> out (B, Sq, Hq, hd) bf16. Needs hd <= 128
// and G <= 32. A query at start[b] + i >= W sees the whole window, as in the
// plain version.
extern "C" int prefill_attention(const void* q, const void* k, const void* v,
                                 const void* k_s, const void* v_s,
                                 const void* start, void* out, int B, int Sq,
                                 int W, int Hkv, int G, int hd,
                                 long long kv_bstride, long long s_bstride,
                                 int quantized, float scale, void* stream) {
  const KVArgs a{kv_bstride, s_bstride, nullptr, 0, 0};
  return launch<ContigAddr>(q, k, v, k_s, v_s, start, out, B, Sq, W, Hkv, G,
                            hd, a, quantized, scale, stream);
}

// The same against a paged arena: k, v (n_pages, page_size, Hkv, hd) and
// k_s, v_s (n_pages, page_size, Hkv), all contiguous; pages (B, n_blk) int32
// contiguous, physical page ids of each slot's window prefix. The window is
// W = n_blk * page_size. Needs n_blk <= 2048.
extern "C" int paged_prefill_attention(const void* q, const void* k,
                                       const void* v, const void* k_s,
                                       const void* v_s, const void* start,
                                       const void* pages, void* out, int B,
                                       int Sq, int n_blk, int page_size,
                                       int Hkv, int G, int hd, int quantized,
                                       float scale, void* stream) {
  if (n_blk < 1 || n_blk > TBL_MAX || page_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const KVArgs a{0, 0, static_cast<const int*>(pages), n_blk, page_size};
  return launch<PagedAddr>(q, k, v, k_s, v_s, start, out, B, Sq,
                           n_blk * page_size, Hkv, G, hd, a, quantized, scale,
                           stream);
}
