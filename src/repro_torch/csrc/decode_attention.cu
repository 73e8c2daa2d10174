// Decode attention: one query per slot against a slotted KV window (B3) or
// a paged KV arena (B5), GQA, bf16 or INT8 KV, online softmax, per-slot
// causal limit.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_pallas
//   (B3: _body, _kernel) and paged_decode_attention_pallas (B5: _body,
//   _paged_kernel).
// Bound on the card: bytes. Each slot reads its visible KV once (int8 KV
//   halves the stream), with its scales and, paged, its page-table prefix,
//   and does ~4 flops per KV element and query head.
// Design: one block per (slot b, kv head h), 128 threads. The G = Hq/Hkv
//   query heads of the group are the block's rows, so each KV block is read
//   once per group. A loop visits the KV blocks 0..start/64 in order (blocks
//   past the slot's position are never read), staging a 64-position block of
//   K in shared memory as f32, then scores, the online-softmax update (one
//   warp per row), then the same block of V, then the PV update. INT8 KV is
//   read as int8: k_s scales the scores and v_s the probabilities, and l sums
//   the unscaled probabilities. At B x Hkv = 32 blocks it leaves most of the
//   132 SMs idle; split-KV with a combine step is later work.
// Layouts: one body, templated on an address policy that maps a logical
//   position to its element offset. Contiguous: b * kv_bstride + pos * Hkv *
//   hd. Paged: (table[b, pos / page_size] * page_size + pos % page_size) *
//   Hkv * hd, in size_t, the same rule for the scales; the block first loads
//   its row's table prefix into shared memory, and each KV block's 64
//   positions are looked up once, into offsets in shared memory that the
//   K, V and scale staging loops read. The 64-position compute block
//   runs over logical positions whatever the page size (the TPU kernel pins
//   its block to one page because its DMA moves whole blocks), so any page
//   size works and the paged kernel does the same f32 operations in the same
//   order as the contiguous one on the gathered window: paged == contiguous
//   bit for bit. The paged window is W = n_blk * page_size; unmapped table
//   entries (the trash page 0) lie past every slot's limit.
// Staging: the plain version's (kernels/ref.py cached_attention_ref) for q
//   (scaled in f32, rounded to bf16), the scores (f32, k_s applied to the
//   scores, -1e30 mask) and v_s on the probabilities; the softmax is online
//   in f32 with expf, and, as in the TPU kernel, p stays f32 for PV where
//   the plain version rounds it to bf16. l is floored at 1e-30 and the
//   output rounded to bf16. Hence a stated tolerance, not equality, against
//   the plain version. Every row's arithmetic depends only on its own slot,
//   so a row's bits do not depend on the batch or on the window length.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128, BK = 64, HD_MAX = 128, G_MAX = 8;
constexpr int MAXO = G_MAX * HD_MAX / kThreads;   // outputs per thread
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
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ k_s,
                        const float* __restrict__ v_s,
                        const int* __restrict__ start,
                        __nv_bfloat16* __restrict__ out, int W, int Hkv,
                        int G, int hd, KVArgs kv_args, float scale) {
  __shared__ float q_sh[G_MAX * HD_MAX];
  __shared__ float kv_sh[BK * (HD_MAX + 1)];     // row stride hd + 1
  __shared__ float p_sh[G_MAX * BK];
  __shared__ float ks_sh[BK], vs_sh[BK];
  __shared__ float m_sh[G_MAX], l_sh[G_MAX], corr_sh[G_MAX];
  __shared__ int tbl_sh[TBL_MAX];                // paged only
  __shared__ size_t kv_off[BK], s_off[BK];       // per staged position

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * G, R = G, ks = hd + 1;
  // visible: kv_pos <= start[b] and kv_pos < W, as in the plain version
  const int limit = min(start[b], W - 1);
  const Addr at(kv_args, b, Hkv, hd, tbl_sh);

  for (int idx = tid; idx < R * hd; idx += kThreads) {
    const int g = idx / hd, d = idx % hd;
    const float x = __bfloat162float(q[((size_t)b * Hq + h * G + g) * hd + d]);
    q_sh[idx] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, scale)));
  }
  if (tid < R) {
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.0f;
  }
  float acc[MAXO];
#pragma unroll
  for (int o = 0; o < MAXO; ++o) acc[o] = 0.0f;

  const int n_kv = limit / BK + 1;
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
      p_sh[idx] = (j0 + j <= limit) ? s : kNegInf;
    }
    __syncthreads();

    for (int r = warp; r < R; r += kThreads / 32) {
      const float s0 = p_sh[r * BK + lane], s1 = p_sh[r * BK + lane + 32];
      float mx = fmaxf(s0, s1);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_sh[r];
      const float m_new = fmaxf(m_prev, mx);
      float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (kQuant) {
        p0 = __fmul_rn(p0, vs_sh[lane]);
        p1 = __fmul_rn(p1, vs_sh[lane + 32]);
      }
      p_sh[r * BK + lane] = p0;
      p_sh[r * BK + lane + 32] = p1;
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
      const int r = idx / hd, d = idx % hd;
      out[((size_t)b * Hq + h * G + r) * hd + d] =
          __float2bfloat16_rn(acc[o] / fmaxf(l_sh[r], 1e-30f));
    }
  }
}

template <typename Addr>
int launch(const void* q, const void* k, const void* v, const void* k_s,
           const void* v_s, const void* start, void* out, int B, int W,
           int Hkv, int G, int hd, KVArgs kv_args, int quantized, float scale,
           void* stream) {
  if (hd > HD_MAX || G > G_MAX || hd < 1 || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && Hkv > 0) {
    dim3 grid(Hkv, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
    const float* ksp = static_cast<const float*>(k_s);
    const float* vsp = static_cast<const float*>(v_s);
    const int* sp = static_cast<const int*>(start);
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
    if (quantized) {
      decode_attention_kernel<int8_t, true, Addr><<<grid, kThreads, 0, s>>>(
          qp, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
          ksp, vsp, sp, op, W, Hkv, G, hd, kv_args, scale);
    } else {
      decode_attention_kernel<__nv_bfloat16, false, Addr>
          <<<grid, kThreads, 0, s>>>(
              qp, static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v), ksp, vsp, sp, op, W, Hkv,
              G, hd, kv_args, scale);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Hq, hd) bf16 contiguous; k, v (B, W, Hkv, hd) bf16 (quantized == 0)
// or int8 (quantized == 1) with the last three dims contiguous and batch
// stride kv_bstride elements; k_s, v_s (B, W, Hkv) f32 with the last two
// dims contiguous and batch stride s_bstride (ignored unless quantized);
// start (B,) int32 -> out (B, Hq, hd) bf16. Needs hd <= 128 and G <= 8. A
// slot at start[b] >= W sees the whole window, as in the plain version.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* k_s, const void* v_s,
                                const void* start, void* out, int B, int W,
                                int Hkv, int G, int hd, long long kv_bstride,
                                long long s_bstride, int quantized,
                                float scale, void* stream) {
  const KVArgs a{kv_bstride, s_bstride, nullptr, 0, 0};
  return launch<ContigAddr>(q, k, v, k_s, v_s, start, out, B, W, Hkv, G, hd,
                            a, quantized, scale, stream);
}

// The same against a paged arena: k, v (n_pages, page_size, Hkv, hd) and
// k_s, v_s (n_pages, page_size, Hkv), all contiguous; pages (B, n_blk) int32
// contiguous, physical page ids of each slot's window prefix. The window is
// W = n_blk * page_size. Needs n_blk <= 2048.
extern "C" int paged_decode_attention(const void* q, const void* k,
                                      const void* v, const void* k_s,
                                      const void* v_s, const void* start,
                                      const void* pages, void* out, int B,
                                      int n_blk, int page_size, int Hkv,
                                      int G, int hd, int quantized,
                                      float scale, void* stream) {
  if (n_blk < 1 || n_blk > TBL_MAX || page_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const KVArgs a{0, 0, static_cast<const int*>(pages), n_blk, page_size};
  return launch<PagedAddr>(q, k, v, k_s, v_s, start, out, B,
                           n_blk * page_size, Hkv, G, hd, a, quantized, scale,
                           stream);
}
