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
//   prefix (int8 KV with its scales and, paged, a table entry a position)
//   once per query tile and does 4 * hd operations per visible (query,
//   key) pair.
//   At the serve chunk the whole launch is a few round trips to memory, so
//   what counts is that no copy waits on another and no thread waits on a
//   scalar loop.
// Design, FlashAttention-2 on mma.sync for Hopper:
//   * One block of 1-4 warps per (slot b, kv head h, query tile); the
//     wrapper picks the warp count from Sq * G (kernels/prefill_attention.py,
//     prefill_plan) and the block takes floor(16 * warps / G) queries. Row r
//     of the block is query q0 + r / G of head h*G + r % G, so the G heads
//     share each K/V tile with no G-fold copy. Each warp owns 16 rows (one
//     m16 tile); the rows past the last whole query and the ragged query
//     tail are masked (never loaded, never stored).
//   * q is scaled by hd^-0.5 in f32 and rounded to bf16 as it is loaded
//     from global memory straight into the MMA's A fragments, which stay in
//     registers for the whole KV loop.
//   * K and V come in tiles of 64 positions at absolute boundaries j*64, by
//     16-byte cp.async into a ring of three stages, so the next two tiles'
//     copies fly while this one is computed. A position row of one kv head
//     is hd * sizeof(T) contiguous bytes; one thread copies each position
//     of a tile, for K, V and their scales. Paged, the thread first reads
//     the table entries of its positions of the tile (one a position, all
//     in flight together) when the tile's copy is issued: a block reads
//     only the entries of the tiles it copies, so no table length binds
//     B6. Reading them one or two tiles ahead was no faster (PERF.md). (B5
//     stages its rows in shared memory because several threads copy one
//     position; here one thread owns a position, so registers hold them.)
//     Positions at or past W are zero-filled by the copy, never read.
//   * INT8 KV is copied as int8 and widened to bf16 (exact: |x| <= 127) in
//     one pass from the int8 stage into one bf16 K/V tile that ldmatrix
//     reads, the same tile layout the bf16 path copies into. A pass in
//     shared memory rather than in registers: V's B fragments need four
//     positions of one column, which ldmatrix.trans gathers from a bf16
//     tile and nothing gathers from bytes without a transpose. k_s scales
//     the f32 score columns after the product, v_s scales p before PV, and
//     l sums the unscaled p (the TPU kernel's rule).
//   * bf16 tiles have rows padded by 16 bytes, so the 8 rows of an ldmatrix
//     fall on 8 different bank groups.
//   * S = Q K^T and O += P V on mma.sync m16n8k16 bf16 with f32
//     accumulators; K fragments from ldmatrix, V from ldmatrix.trans. The
//     online softmax stays in registers: each thread holds two rows'
//     scores, their max and sum over the quad by shuffles, expf, the mask
//     value -1e30 at kv_pos > min(start + i, W - 1).
//   * PV takes p as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), in
//     the accumulator layout the score MMA left p in: two MMAs, and the
//     products see p to ~16 bits, as the TPU kernel's f32 p. One bf16 term
//     would round p unnormalized where the plain version rounds it
//     normalized: two independent roundings, which at hd 16 brought the
//     worst output row of chip_smoke.py's checks to the edge of its 1 %
//     limit. With hi + lo the output's own rounding is what remains.
//   * KV tiles are visited in increasing order up to the tile that holds the
//     block's deepest row's limit. A tile wholly past a row's limit leaves
//     that row's state unchanged bit for bit (max unchanged, p == 0,
//     corr == 1, PV adds exact zeros), and an MMA's value for one (row,
//     column) does not depend on the other rows of its tile. So a row's
//     output depends only on its absolute position: chunked prefill gives
//     the same bits as whole-prompt prefill, row for row.
//   * Templated on hd in {16, 32, 64, 96, 128}: 64 is the repo's
//     qwen3-0.6b, 128 the published one's, 96 phi-3-vision's, 16 the smoke
//     config's. This narrows the earlier contract (any hd <= 128): another
//     hd is refused. At hd 96 the INT8 stage's 96-byte rows widen in six
//     16-value steps into the same 208-byte bf16 rows as the bf16 ring.
//   * No split-KV: at the serve chunk the window is one or two tiles.
// Layouts: one body templated on an address policy (attn_tile.cuh;
//   contiguous: b * kv_bstride + pos * Hkv * hd; paged: (table[b, pos /
//   page_size] * page_size + pos % page_size) * Hkv * hd in size_t, any
//   table length). The 64-position tile runs over
//   logical positions whatever the page size, so the paged kernel equals
//   the contiguous one on the gathered window bit for bit, at any page
//   size. The paged window is W = n_blk * page_size.
// Staging: the plain version's (kernels/ref.py cached_attention_ref) for q,
//   the scores, the -1e30 mask, k_s on scores and v_s on probabilities;
//   online softmax in f32 with expf, p to ~16 bits for PV (the plain
//   version rounds the normalized p to bf16), out = acc / max(l, 1e-30)
//   rounded to bf16. Sums run in another order: hence a stated tolerance,
//   not equality, against the plain version.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tile.cuh"

namespace {

using namespace sm90;

constexpr int STAGES = 3;        // K/V tiles in flight
constexpr int MAX_WARPS = 4;     // 16 rows each
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

// The block's shared memory: the K/V ring in the KV type (pitch PT), its
// scales (INT8) and the widened bf16 K/V tile (INT8; pitch P).
template <typename T, int HD>
struct Smem {
  static constexpr bool kQuant = std::is_same<T, int8_t>::value;
  static constexpr int P = HD + 8;                 // bf16 tile pitch
  static constexpr int PT = kQuant ? HD : P;       // ring pitch, elements
  static constexpr int tile = BKV * PT * (int)sizeof(T);
  static constexpr int ring = 2 * STAGES * tile;
  static constexpr int scales = kQuant ? 2 * STAGES * BKV * 4 : 0;
  static constexpr int widened = kQuant ? 2 * BKV * P * 2 : 0;
  static constexpr int bytes = ring + scales + widened;
};

// Tile j0..j0+63 of kv head h into one stage: one thread a position (two
// in a one-warp block), each position's storage row looked up first, the
// thread's table reads (paged) in flight together.
template <typename T, int HD, typename Addr>
__device__ __forceinline__ void load_tile(
    T* k_dst, T* v_dst, float* ks_dst, float* vs_dst, const T* k,
    const T* v, const float* k_s, const float* v_s, const Addr& at,
    int Hkv, int h, int j0, int W) {
  using S = Smem<T, HD>;
  constexpr int E = 16 / sizeof(T), CH = HD / E;   // elements, copies a row
  constexpr int PER = BKV / 32;                    // positions a thread
  size_t rows[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    rows[i] = j < BKV && j0 + j < W ? at.row(j0 + j) : 0;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j >= BKV) continue;
    const bool ok = j0 + j < W;
    const size_t r = rows[i];
    const size_t off = at.kv0 + r * Hkv * HD + (size_t)h * HD;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      cp_async16(k_dst + j * S::PT + c * E, ok ? k + off + c * E : k, ok);
      cp_async16(v_dst + j * S::PT + c * E, ok ? v + off + c * E : v, ok);
    }
    if constexpr (S::kQuant) {
      const size_t so = at.s0 + r * Hkv + h;
      cp_async4(ks_dst + j, ok ? k_s + so : k_s, ok);
      cp_async4(vs_dst + j, ok ? v_s + so : v_s, ok);
    }
  }
}

// An int8 [BKV][HD] tile into a bf16 [BKV][HD + 8] one, 16 values a step.
template <int HD>
__device__ __forceinline__ void widen(__nv_bfloat16* dst, const int8_t* src) {
  constexpr int U = HD / 16, P = HD + 8;
  for (int u = threadIdx.x; u < BKV * U; u += blockDim.x) {
    const int j = u / U, c = (u % U) * 16;
    const int4 w = *reinterpret_cast<const int4*>(src + j * HD + c);
    const int8_t* x = reinterpret_cast<const int8_t*>(&w);
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = pack_bf16(static_cast<float>(x[2 * i]),
                       static_cast<float>(x[2 * i + 1]));
    *reinterpret_cast<uint4*>(dst + j * P + c) =
        make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(dst + j * P + c + 8) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// One block a query tile; 1 is the least a block needs of an SM, so ptxas
// spends registers before it spills.
template <typename T, int HD, typename Addr>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const float* __restrict__ k_s,
                         const float* __restrict__ v_s,
                         const int* __restrict__ start,
                         __nv_bfloat16* __restrict__ out, int Sq, int W,
                         int Hkv, int G, KVArgs kv_args, float scale) {
  using S = Smem<T, HD>;
  constexpr int P = S::P, KC = HD / 16, DT = HD / 8;
  extern __shared__ __align__(16) unsigned char sm[];
  T* k_ring = reinterpret_cast<T*>(sm);                  // [STAGES][BKV][PT]
  T* v_ring = k_ring + STAGES * BKV * S::PT;
  float* ks_ring = reinterpret_cast<float*>(sm + S::ring);   // [STAGES][BKV]
  float* vs_ring = ks_ring + (S::kQuant ? STAGES * BKV : 0);
  auto* k_wide = reinterpret_cast<__nv_bfloat16*>(sm + S::ring + S::scales);
  __nv_bfloat16* v_wide = k_wide + (S::kQuant ? BKV * P : 0);

  const int h = blockIdx.x, qt = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Hq = Hkv * G, bq = (blockDim.x / 2) / G, R = bq * G;
  const int q0 = qt * bq;                        // first query of the tile
  const int st = start[b];
  const Addr at(kv_args, b);

  const int q_last = min(q0 + bq, Sq) - 1;
  const int n_kv = min(st + q_last, W - 1) / BKV + 1;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kv)
      load_tile<T, HD>(k_ring + s * BKV * S::PT, v_ring + s * BKV * S::PT,
                       ks_ring + s * BKV, vs_ring + s * BKV, k, v, k_s, v_s,
                       at, Hkv, h, s * BKV, W);
    cp_async_commit();
  }

  // this thread's two rows: g and g + 8 of the warp's 16; a row past the
  // tile's last whole query or past Sq sees nothing (limit -1)
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int qi0 = q0 + r0 / G, qi1 = q0 + r1 / G;
  const bool ok0 = r0 < R && qi0 < Sq, ok1 = r1 < R && qi1 < Sq;
  const int lim0 = ok0 ? min(st + qi0, W - 1) : -1;
  const int lim1 = ok1 ? min(st + qi1, W - 1) : -1;
  const __nv_bfloat16* q_row0 =
      q + (((size_t)b * Sq + qi0) * Hq + h * G + r0 % G) * HD;
  const __nv_bfloat16* q_row1 =
      q + (((size_t)b * Sq + qi1) * Hq + h * G + r1 % G) * HD;
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int d = kc * 16 + 2 * t;
    qf[kc][0] = ok0 ? q_pair(q_row0 + d, scale) : 0u;
    qf[kc][1] = ok1 ? q_pair(q_row1 + d, scale) : 0u;
    qf[kc][2] = ok0 ? q_pair(q_row0 + d + 8, scale) : 0u;
    qf[kc][3] = ok1 ? q_pair(q_row1 + d + 8, scale) : 0u;
  }

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
        load_tile<T, HD>(k_ring + slot * BKV * S::PT,
                         v_ring + slot * BKV * S::PT, ks_ring + slot * BKV,
                         vs_ring + slot * BKV, k, v, k_s, v_s, at, Hkv, h,
                         nt * BKV, W);
      }
      cp_async_commit();
    }
    const int slot = jb % STAGES;
    const __nv_bfloat16 *kt, *vt;
    const float* ks_t = ks_ring + slot * BKV;
    const float* vs_t = vs_ring + slot * BKV;
    if constexpr (S::kQuant) {
      widen<HD>(k_wide, reinterpret_cast<const int8_t*>(k_ring) +
                            slot * BKV * S::PT);
      widen<HD>(v_wide, reinterpret_cast<const int8_t*>(v_ring) +
                            slot * BKV * S::PT);
      __syncthreads();
      kt = k_wide;
      vt = v_wide;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(k_ring) +
           slot * BKV * S::PT;
      vt = reinterpret_cast<const __nv_bfloat16*>(v_ring) +
           slot * BKV * S::PT;
    }

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
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        float x = s[j][e];
        if constexpr (S::kQuant) x = __fmul_rn(x, ks_t[col]);
        if (j0 + col > (e < 2 ? lim0 : lim1)) x = kNegInf;
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
        if (e < 2) sum0 += p; else sum1 += p;
        // v_s scales p for PV; l sums the unscaled p
        s[j][e] = S::kQuant ? __fmul_rn(p, vs_t[8 * j + 2 * t + (e & 1)])
                            : p;
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
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kc][0], s[2 * kc][1], hi[0], lo[0]);
      split_bf16(s[2 * kc][2], s[2 * kc][3], hi[1], lo[1]);
      split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + (kc * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * P +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], hi, bv[0], bv[1]);
        mma_bf16(o[2 * dp], lo, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], hi, bv[2], bv[3]);
        mma_bf16(o[2 * dp + 1], lo, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!(half ? ok1 : ok0)) continue;
    const float den = fmaxf(half ? l1 : l0, 1e-30f);
    const int r = half ? r1 : r0, qi = half ? qi1 : qi0;
    __nv_bfloat16* orow =
        out + (((size_t)b * Sq + qi) * Hq + h * G + r % G) * HD;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8 + 2 * t) =
          __floats2bfloat162_rn(o[i][2 * half] / den,
                                o[i][2 * half + 1] / den);
    }
  }
}

template <typename T, int HD, typename Addr>
cudaError_t launch_one(dim3 grid, int warps, const void* q, const void* k,
                       const void* v, const void* k_s, const void* v_s,
                       const void* start, void* out, int Sq, int W, int Hkv,
                       int G, const KVArgs& kv_args, float scale,
                       cudaStream_t stream) {
  constexpr int smem = Smem<T, HD>::bytes;
  auto kernel = prefill_attention_kernel<T, HD, Addr>;
  // the attribute belongs to a device: set once on each (past
  // kMaxDevices, at every launch)
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= kMaxDevices || !attr_set[dev])) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  kernel<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(k_s),
      static_cast<const float*>(v_s), static_cast<const int*>(start),
      static_cast<__nv_bfloat16*>(out), Sq, W, Hkv, G, kv_args, scale);
  return cudaGetLastError();
}

template <typename T, typename Addr>
cudaError_t launch_hd(int hd, dim3 grid, int warps, const void* q,
                      const void* k, const void* v, const void* k_s,
                      const void* v_s, const void* start, void* out, int Sq,
                      int W, int Hkv, int G, const KVArgs& a, float scale,
                      cudaStream_t s) {
  switch (hd) {
    case 16: return launch_one<T, 16, Addr>(grid, warps, q, k, v, k_s, v_s, start, out, Sq, W, Hkv, G, a, scale, s);
    case 32: return launch_one<T, 32, Addr>(grid, warps, q, k, v, k_s, v_s, start, out, Sq, W, Hkv, G, a, scale, s);
    case 64: return launch_one<T, 64, Addr>(grid, warps, q, k, v, k_s, v_s, start, out, Sq, W, Hkv, G, a, scale, s);
    case 96: return launch_one<T, 96, Addr>(grid, warps, q, k, v, k_s, v_s, start, out, Sq, W, Hkv, G, a, scale, s);
    case 128: return launch_one<T, 128, Addr>(grid, warps, q, k, v, k_s, v_s, start, out, Sq, W, Hkv, G, a, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// The launch the wrapper planned (prefill_plan): `warps` warps a block and
// `tiles` query tiles of floor(16 * warps / G) queries, which must cover Sq
// with no tile past it.
template <typename Addr>
int launch(const void* q, const void* k, const void* v, const void* k_s,
           const void* v_s, const void* start, void* out, int B, int Sq,
           int W, int Hkv, int G, int hd, const KVArgs& kv_args,
           int quantized, float scale, int warps, int tiles, void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0)
    return static_cast<int>(cudaGetLastError());
  if (warps < 1 || warps > MAX_WARPS || G < 1 || G > 16 * warps || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bq = 16 * warps / G;
  if (tiles < 1 || (long long)(tiles - 1) * bq >= Sq ||
      (long long)tiles * bq < Sq || tiles > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Hkv, tiles, B);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      quantized
          ? launch_hd<int8_t, Addr>(hd, grid, warps, q, k, v, k_s, v_s,
                                    start, out, Sq, W, Hkv, G, kv_args,
                                    scale, s)
          : launch_hd<__nv_bfloat16, Addr>(hd, grid, warps, q, k, v, k_s,
                                           v_s, start, out, Sq, W, Hkv, G,
                                           kv_args, scale, s);
  return static_cast<int>(e);
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Sq, Hq, hd) bf16 contiguous, 4-byte aligned; k, v (B, W, Hkv, hd)
// bf16 (quantized == 0) or int8 (quantized == 1) with the last three dims
// contiguous, 16-byte aligned, and batch stride kv_bstride elements (a
// multiple of 16 bytes); k_s, v_s (B, W, Hkv) f32 with the last two dims
// contiguous and batch stride s_bstride (ignored unless quantized); start
// (B,) int32 -> out (B, Sq, Hq, hd) bf16. Needs hd in {16, 32, 64, 96,
// 128} and G <= 16 * warps. A query at start[b] + i >= W sees the whole
// window, as in the plain version.
extern "C" int prefill_attention(const void* q, const void* k, const void* v,
                                 const void* k_s, const void* v_s,
                                 const void* start, void* out, int B, int Sq,
                                 int W, int Hkv, int G, int hd,
                                 long long kv_bstride, long long s_bstride,
                                 int quantized, float scale, int warps,
                                 int tiles, void* stream) {
  const KVArgs a{kv_bstride, s_bstride, nullptr, 0, 0};
  return launch<ContigAddr>(q, k, v, k_s, v_s, start, out, B, Sq, W, Hkv, G,
                            hd, a, quantized, scale, warps, tiles, stream);
}

// The same against a paged arena: k, v (n_pages, page_size, Hkv, hd) and
// k_s, v_s (n_pages, page_size, Hkv), all contiguous, k and v 16-byte
// aligned; pages (B, n_blk) int32 contiguous, physical page ids of each
// slot's window prefix, of any length. The window is W = n_blk * page_size.
extern "C" int paged_prefill_attention(const void* q, const void* k,
                                       const void* v, const void* k_s,
                                       const void* v_s, const void* start,
                                       const void* pages, void* out, int B,
                                       int Sq, int n_blk, int page_size,
                                       int Hkv, int G, int hd, int quantized,
                                       float scale, int warps, int tiles,
                                       void* stream) {
  if (n_blk < 1 || page_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const KVArgs a{0, 0, static_cast<const int*>(pages), n_blk, page_size};
  return launch<PagedAddr>(q, k, v, k_s, v_s, start, out, B, Sq,
                           n_blk * page_size, Hkv, G, hd, a, quantized,
                           scale, warps, tiles, stream);
}
