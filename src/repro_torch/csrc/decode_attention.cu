// Decode attention: one query per slot at position start[b] against a
// slotted KV window (B3) or a paged KV arena (B5), GQA, bf16 or INT8 KV,
// causal limit kv_pos <= min(start[b], W - 1).
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_pallas
//   (B3: _body, _kernel) and paged_decode_attention_pallas (B5: _body,
//   _paged_kernel).
// Bound on the card: bytes. A slot's visible KV is read once (int8 KV with
//   its two f32 scales a position, and, paged, one table entry a position's
//   page), for 4 * hd operations a (query head, position): far under the
//   tensor cores' rate. At the serve shape (4 slots, 64 positions) the whole
//   launch is one round trip to memory, so what counts is that every copy
//   is in flight at once; at a long window, that enough blocks stream the
//   window to fill the card's 132 SMs.
// Design, split-KV on mma.sync for Hopper:
//   * The KV axis is cut into segments of SEG = 256 positions at absolute
//     boundaries s * SEG, whatever W, the batch or the page size. One block
//     of four warps per (kv head h, segment s, slot b): grid (Hkv,
//     ceil(W / SEG), B), the wrapper's decode_plan. A block whose segment
//     starts past its slot's limit exits at once: it writes nothing and
//     takes no ticket. At W = 4096 and 4 slots of 8 kv heads that is 512
//     blocks where one block a (slot, kv head) made 32. Segments of 128 and
//     512 positions were slower at long windows (PERF.md).
//   * One round trip a segment: the block's 128 threads start 16-byte
//     cp.async copies of K, V and the scales for every position of the
//     segment's live 64-position tiles at once, neighbouring threads on
//     neighbouring 16-byte pieces of a position's row (a warp's copy
//     touches 4-8 rows, not 32). Positions past the limit are zero-filled
//     by the copy, never read. Paged, each position is first looked up
//     once, table[b, pos / page_size], all lookups in flight together,
//     into shared memory: a segment reads only its own slice of the table
//     (at most SEG / page_size + 1 entries), so no table length binds B5
//     any more.
//   * INT8 KV is widened to bf16 in registers (exact: |x| <= 127), not in
//     shared memory as B4/B6 do: the int8 stage is the only copy, 43 KB a
//     block at hd 64, so four blocks an SM fit where a widened bf16 copy
//     took 108 KB and two, and a 32,768-position window ran at 4.1x its
//     bound, not 2.1x (PERF.md).
//     For the scores, q's and K's dims are taken in another order inside
//     each 16-dim chunk (k slots 2t, 2t+1, 2t+8, 2t+9 of thread t hold dims
//     4t..4t+3), so a K fragment is one 4-byte load of one position; for
//     PV, column n of n-tile i holds dim v_dim(i, n), so one 4-byte load of
//     a position feeds four n-tiles. int8 rows are padded to max(hd, 32) +
//     16 bytes, so both loads of 8 neighbouring positions fall on distinct
//     banks. bf16 KV takes B4/B6's ldmatrix / ldmatrix.trans path on rows
//     padded by 16 bytes.
//   * Registers are bounded (__launch_bounds__) so that as many blocks an
//     SM as shared memory holds, at most four, also fit in registers: the
//     INT8 hd-64 instance went from 229 registers (two blocks) to 128, no
//     spills, and a 32,768-position window from 0.127 to 0.091 ms.
//   * Each warp takes one 64-position tile. Scores and PV run on mma.sync
//     m16n8k16 bf16 with f32 accumulators: the G query heads of the group
//     are the rows of one m16 tile (rows past G are padding, never stored),
//     q scaled by hd^-0.5 in f32 and rounded to bf16 as it is loaded from
//     global memory while the copies fly. k_s scales the f32 score columns,
//     -1e30 masks past the limit, v_s scales p before PV and l sums the
//     unscaled p (the TPU kernel's rule). PV takes p as two bf16 terms, hi =
//     bf16(p) and lo = bf16(p - hi), as in B4/B6, so it sees p to ~16 bits.
//   * The combine is one fold: (M, L, A) <- the first partial, then for
//     each next partial (m, l, a): M' = max(M, m), L = L * e^(M - M') +
//     l * e^(m - M'), A likewise, per output element. The block folds its
//     warps' partials in warp order through shared memory. A slot with one
//     live segment writes A / max(L, 1e-30) as bf16 at once. Otherwise the
//     block writes its (A, M, L) in f32 to its record of a per-device
//     workspace, fences, and takes a ticket per (b, h); the block that
//     takes the last one folds every live segment's record in increasing
//     segment order (staged into shared memory by cp.async, as many records
//     a round trip as fit), writes the bf16 output and puts the ticket back
//     to 0. The fold of one record returns that record, so a slot with one
//     live segment gets the same bits whichever way it goes. No second
//     launch: the host sets the pace of a decode step, and a combine kernel
//     would add one launch a layer.
//   * Templated on hd in {16, 32, 64, 96, 128} (64 the repo's qwen3-0.6b,
//     128 the published one's, 96 phi-3-vision's, 16 the smoke config's)
//     and G <= 16, one m16 tile. This narrows the earlier contract (any hd
//     <= 128, G <= 8): the wrapper refuses anything else. At hd 96 a 16-dim
//     chunk is one of six k16 steps and INT8 V's dims go in three groups of
//     four n-tiles (v_dim); rows pad to 112 bytes (INT8) and 208 (bf16),
//     both on distinct banks for 8 neighbouring positions.
// Bits: a tile or segment wholly past the limit is skipped, the positions
//   past it in a live tile are zeros masked to -1e30 (p == 0 exactly), the
//   64-position tiles and the segments sit at absolute positions, the warps
//   and the segments fold in a fixed order, and an MMA's value for one row
//   does not depend on the other rows. So a row's output depends only on
//   its slot's data and its limit, not on the batch, W, the page size or
//   the grid: engine == serial decode, windowed == full and paged ==
//   contiguous on the gathered window, bit for bit.
// Staging: the plain version's (kernels/ref.py cached_attention_ref) for q,
//   the scores, the -1e30 mask, k_s on scores and v_s on probabilities;
//   softmax in f32 with expf, p to ~16 bits for PV (the plain version rounds
//   the normalized p to bf16), out = A / max(L, 1e-30) rounded to bf16.
//   Sums run in another order: hence a stated tolerance, not equality,
//   against the plain version. A slot at start < 0 sees nothing and gets
//   zeros (the engine never passes one).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tile.cuh"

namespace {

using namespace sm90;

constexpr int SEG = 256;              // KV positions a segment (a block)
// blocks an SM should hold at most: registers are bounded so that this many
// fit where shared memory allows them
constexpr int BLOCKS_MAX = 4;
constexpr int WARPS = SEG / BKV;       // one 64-position tile a warp
constexpr int THREADS = 32 * WARPS;
constexpr int G_MAX = 16;              // query heads a kv head: one m16 tile
constexpr int TICKETS = 8192;          // int32 tickets ahead of the records
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

// The block's shared memory. Dynamic: the segment's K and V in the KV type,
// and their scales (INT8). Rows are padded so that the fragment loads of
// 8 consecutive positions fall on distinct banks: bf16 rows by 16 bytes (the
// 8 rows of an ldmatrix), int8 rows to 16 bytes past max(hd, 32). The
// warps' partials, then the workspace records, alias it once the tiles are
// consumed. Static: each position's storage row (paged) and the last
// block's flag.
template <typename T, int HD, bool kPaged>
struct Smem {
  static constexpr bool kQuant = std::is_same<T, int8_t>::value;
  static constexpr int PT = kQuant ? (HD > 32 ? HD : 32) + 16 : HD + 8;
  static constexpr int stage = SEG * PT * (int)sizeof(T);   // K or V
  static constexpr int scales = kQuant ? 2 * SEG * 4 : 0;
  static constexpr int bytes = 2 * stage + scales;
  static constexpr int rows = kPaged ? SEG : 1;
  static constexpr int static_bytes = rows * 4 + 4;
  // blocks an SM holds by shared memory (233,472 bytes an SM, 1 KB
  // reserved a block), at most BLOCKS_MAX: the launch bounds' register
  // budget
  static constexpr int fit = 233472 / (bytes + static_bytes + 1024);
  static constexpr int blocks =
      fit < 1 ? 1 : (fit < BLOCKS_MAX ? fit : BLOCKS_MAX);
  // per warp: A [G_MAX][HD], then M and L [G_MAX]
  static constexpr int partials = WARPS * G_MAX * (HD + 2) * 4;
  static_assert(partials <= bytes, "the warps' partials alias the tiles");
};

// Floats of a segment's workspace record: A [G][HD], M [G], L [G], padded to
// 16 bytes.
__host__ __device__ __forceinline__ int record_floats(int G, int HD) {
  return G * HD + ((2 * G + 3) & ~3);
}

// INT8 V's dims in the PV product: n-tile i, column n holds dim
// v_dim<HD>(i, n). A thread's B operand is one column n = g at four
// positions; with DW = min(4, hd / 8) neighbouring dims in DW neighbouring
// n-tiles, one DW-byte load a position feeds DW n-tiles.
template <int HD>
__device__ __forceinline__ int v_dim(int i, int n) {
  constexpr int DW = HD / 8 < 4 ? HD / 8 : 4;
  return 8 * DW * (i / DW) + DW * n + i % DW;
}

// Signed byte c of w as a float (exact).
__device__ __forceinline__ float s8(uint32_t w, int c) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * c)));
}

// Folds one partial (m, l, a) into (M, L, A); the first one is taken as it
// is.
__device__ __forceinline__ void fold(float& M, float& L, float& A, float m,
                                     float l, float a, bool first) {
  if (first) {
    M = m;
    L = l;
    A = a;
    return;
  }
  const float mn = fmaxf(M, m);
  const float c0 = expf(M - mn), c1 = expf(m - mn);
  L = L * c0 + l * c1;
  A = A * c0 + a * c1;
  M = mn;
}

template <typename T, int HD, typename Addr>
__global__ void __launch_bounds__(THREADS,
                                  (Smem<T, HD, Addr::kPaged>::blocks))
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ k_s,
                        const float* __restrict__ v_s,
                        const int* __restrict__ start,
                        __nv_bfloat16* __restrict__ out, float* ws, int W,
                        int Hkv, int G, KVArgs kv_args, float scale) {
  using S = Smem<T, HD, Addr::kPaged>;
  constexpr int PT = S::PT, KC = HD / 16, DT = HD / 8;
  constexpr int EPT = G_MAX * HD / THREADS;      // output elements a thread
  extern __shared__ __align__(16) unsigned char sm[];
  T* k_st = reinterpret_cast<T*>(sm);                      // [SEG][PT]
  T* v_st = k_st + SEG * PT;
  float* ks_st = reinterpret_cast<float*>(sm + 2 * S::stage);   // [SEG]
  float* vs_st = ks_st + (S::kQuant ? SEG : 0);
  __shared__ int rows_sh[S::rows];
  __shared__ int last_sh;

  const int h = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Hq = Hkv * G, n_seg = gridDim.y, GH = G * HD;
  // visible: kv_pos <= start[b] and kv_pos < W, as in the plain version
  const int limit = min(start[b], W - 1);
  const int n_live = limit < 0 ? 1 : limit / SEG + 1;  // segments to fold
  if (s >= n_live) return;
  const int seg0 = s * SEG;
  const int n_tiles = limit < seg0 ? 0 : min(WARPS, (limit - seg0) / BKV + 1);
  const Addr at(kv_args, b);

  // paged: each position's storage row, looked up once, all lookups in
  // flight together
  if constexpr (Addr::kPaged) {
    for (int j = tid; j < n_tiles * BKV; j += THREADS)
      rows_sh[j] =
          seg0 + j <= limit ? static_cast<int>(at.row(seg0 + j)) : 0;
    __syncthreads();
  }
  // every position of the live tiles at once, neighbouring threads on
  // neighbouring 16-byte pieces of a position's row
  {
    constexpr int E = 16 / sizeof(T), CH = HD / E;   // elements, copies a row
    for (int u = tid; u < n_tiles * BKV * CH; u += THREADS) {
      const int j = u / CH, c = u % CH;
      const bool ok = seg0 + j <= limit;
      const size_t r = !ok ? 0
                       : Addr::kPaged ? (size_t)rows_sh[j] : at.row(seg0 + j);
      const size_t off = at.kv0 + r * Hkv * HD + (size_t)h * HD + c * E;
      cp_async16(k_st + j * PT + c * E, ok ? k + off : k, ok);
      cp_async16(v_st + j * PT + c * E, ok ? v + off : v, ok);
      if (S::kQuant && c == 0) {
        const size_t so = at.s0 + r * Hkv + h;
        cp_async4(ks_st + j, ok ? k_s + so : k_s, ok);
        cp_async4(vs_st + j, ok ? v_s + so : v_s, ok);
      }
    }
    cp_async_commit();
  }

  // this thread's two rows of the m16 tile: query heads g and g + 8 of the
  // group (a row past G is padding: q zero, never stored). Its A fragment
  // holds dims d, d + 1 (k slots 2t, 2t + 1) and e, e + 1 (2t + 8, 2t + 9)
  // of each 16-dim chunk: the MMA's order for bf16 KV (ldmatrix), four
  // neighbouring dims for INT8 KV, whose B fragment is one 4-byte load.
  const int r0 = g, r1 = g + 8;
  const bool ok0 = r0 < G, ok1 = r1 < G;
  const bool live = warp < n_tiles;
  uint32_t qf[KC][4];
  {
    const __nv_bfloat16* q0 = q + ((size_t)b * Hq + h * G + r0) * HD;
    const __nv_bfloat16* q1 = q + ((size_t)b * Hq + h * G + r1) * HD;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int d = kc * 16 + (S::kQuant ? 4 : 2) * t;
      const int e = d + (S::kQuant ? 2 : 8);
      qf[kc][0] = live && ok0 ? q_pair(q0 + d, scale) : 0u;
      qf[kc][1] = live && ok1 ? q_pair(q1 + d, scale) : 0u;
      qf[kc][2] = live && ok0 ? q_pair(q0 + e, scale) : 0u;
      qf[kc][3] = live && ok1 ? q_pair(q1 + e, scale) : 0u;
    }
  }

  cp_async_wait<0>();
  __syncthreads();

  // this warp's tile: positions j0..j0+63; score column c of n-tile j is
  // position j0 + 8j + c
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  if (live) {
    const int j0 = seg0 + warp * BKV;
    const T* kt = k_st + warp * BKV * PT;
    const T* vt = v_st + warp * BKV * PT;
    const float* ks_t = ks_st + warp * BKV;
    const float* vs_t = vs_st + warp * BKV;

    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if constexpr (S::kQuant) {
        // position 8j + g, dims 16kc + 4t .. +3, widened in registers
        const int8_t* row = reinterpret_cast<const int8_t*>(kt) + g * PT +
                            kc * 16 + 4 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(row + j * 8 * PT);
          mma_bf16(sc[j], qf[kc], pack_bf16(s8(w, 0), s8(w, 1)),
                   pack_bf16(s8(w, 2), s8(w, 3)));
        }
      } else {
        const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(kt);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kb + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * PT +
                              kc * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * jp], qf[kc], bk[0], bk[1]);
          mma_bf16(sc[2 * jp + 1], qf[kc], bk[2], bk[3]);
        }
      }
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        float x = sc[j][e];
        if constexpr (S::kQuant) x = __fmul_rn(x, ks_t[col]);
        if (j0 + col > limit) x = kNegInf;
        sc[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[j][e] - (e < 2 ? m0 : m1));
        if (e < 2) l0 += p; else l1 += p;
        // v_s scales p for PV; l sums the unscaled p
        sc[j][e] = S::kQuant ? __fmul_rn(p, vs_t[8 * j + 2 * t + (e & 1)])
                             : p;
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }

#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t hi[4], lo[4];
      split_bf16(sc[2 * kc][0], sc[2 * kc][1], hi[0], lo[0]);
      split_bf16(sc[2 * kc][2], sc[2 * kc][3], hi[1], lo[1]);
      split_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1], hi[2], lo[2]);
      split_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3], hi[3], lo[3]);
      if constexpr (S::kQuant) {
        // k slots 2t, 2t + 1, 2t + 8, 2t + 9 are positions 16kc + 2t, +1,
        // +8, +9; column g of n-tile i is dim v_dim(i, g)
        constexpr int DW = HD / 8 < 4 ? HD / 8 : 4;
        const int8_t* vb = reinterpret_cast<const int8_t*>(vt) +
                           (kc * 16 + 2 * t) * PT + DW * g;
#pragma unroll
        for (int grp = 0; grp < DT / DW; ++grp) {
          uint32_t w[4];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int8_t* p = vb + ((rr & 1) + (rr >> 1) * 8) * PT +
                              8 * DW * grp;
            w[rr] = DW == 4 ? *reinterpret_cast<const uint32_t*>(p)
                            : *reinterpret_cast<const uint16_t*>(p);
          }
#pragma unroll
          for (int c = 0; c < DW; ++c) {
            const uint32_t b0 = pack_bf16(s8(w[0], c), s8(w[1], c));
            const uint32_t b1 = pack_bf16(s8(w[2], c), s8(w[3], c));
            mma_bf16(o[grp * DW + c], hi, b0, b1);
            mma_bf16(o[grp * DW + c], lo, b0, b1);
          }
        }
      } else {
        const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(vt);
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vb + (kc * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * PT +
                                    dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], hi, bv[0], bv[1]);
          mma_bf16(o[2 * dp], lo, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], hi, bv[2], bv[3]);
          mma_bf16(o[2 * dp + 1], lo, bv[2], bv[3]);
        }
      }
    }
  }

  // the warps' partials into shared memory, over the consumed tiles;
  // accumulator column n of n-tile i is dim 8i + n (bf16 KV) or v_dim(i, n)
  __syncthreads();
  float* a_sh = reinterpret_cast<float*>(sm);          // [WARPS][G_MAX][HD]
  float* m_sh = a_sh + WARPS * G_MAX * HD;             // [WARPS][G_MAX]
  float* l_sh = m_sh + WARPS * G_MAX;
  if (live) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= G) continue;
      float* arow = a_sh + (warp * G_MAX + r) * HD;
#pragma unroll
      for (int i = 0; i < DT; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          arow[S::kQuant ? v_dim<HD>(i, 2 * t + e) : i * 8 + 2 * t + e] =
              o[i][2 * half + e];
      if (t == 0) {
        m_sh[warp * G_MAX + r] = half ? m1 : m0;
        l_sh[warp * G_MAX + r] = half ? l1 : l0;
      }
    }
  }
  __syncthreads();

  // fold the tiles in warp order: this thread's elements idx = r * HD + d
  float fm[EPT], fl[EPT], fa[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    fm[e] = kNegInf;
    fl[e] = 0.0f;
    fa[e] = 0.0f;
    const int idx = tid + e * THREADS;
    if (idx >= GH) continue;
    const int r = idx / HD, d = idx % HD;
    for (int w = 0; w < n_tiles; ++w)
      fold(fm[e], fl[e], fa[e], m_sh[w * G_MAX + r], l_sh[w * G_MAX + r],
           a_sh[(w * G_MAX + r) * HD + d], w == 0);
  }
  __nv_bfloat16* orow = out + ((size_t)b * Hq + h * G) * HD;
  if (n_live == 1) {
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int idx = tid + e * THREADS;
      if (idx < GH)
        orow[idx] = __float2bfloat16_rn(fa[e] / fmaxf(fl[e], 1e-30f));
    }
    return;
  }

  // several live segments: this one's record, then a ticket
  const int R = record_floats(G, HD);
  int* ticket = reinterpret_cast<int*>(ws) + (size_t)b * Hkv + h;
  float* recs = ws + TICKETS + ((size_t)b * Hkv + h) * n_seg * R;
  {
    float* rec = recs + (size_t)s * R;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int idx = tid + e * THREADS;
      if (idx >= GH) continue;
      rec[idx] = fa[e];
      if (idx % HD == 0) {
        rec[GH + idx / HD] = fm[e];
        rec[GH + G + idx / HD] = fl[e];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_sh = atomicAdd(ticket, 1) == n_live - 1;
  __syncthreads();
  if (!last_sh) return;
  __threadfence();

  // the last block: fold the live segments' records in increasing order,
  // as many a round trip as the shared memory holds
  float* rec_sh = reinterpret_cast<float*>(sm);
  const int per = S::bytes / (R * 4);
  for (int c0 = 0; c0 < n_live; c0 += per) {
    const int n = min(per, n_live - c0);
    const float* src = recs + (size_t)c0 * R;
    for (int u = tid; u < n * R / 4; u += THREADS)
      cp_async16(rec_sh + 4 * u, src + 4 * u, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int idx = tid + e * THREADS;
      if (idx >= GH) continue;
      const int r = idx / HD;
      for (int i = 0; i < n; ++i) {
        const float* rec = rec_sh + i * R;
        fold(fm[e], fl[e], fa[e], rec[GH + r], rec[GH + G + r], rec[idx],
             c0 + i == 0);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int idx = tid + e * THREADS;
    if (idx < GH)
      orow[idx] = __float2bfloat16_rn(fa[e] / fmaxf(fl[e], 1e-30f));
  }
  if (tid == 0) *ticket = 0;
}

template <typename T, int HD, typename Addr>
cudaError_t launch_one(dim3 grid, const void* q, const void* k,
                       const void* v, const void* k_s, const void* v_s,
                       const void* start, void* out, void* ws, int W,
                       int Hkv, int G, const KVArgs& kv_args, float scale,
                       cudaStream_t stream) {
  constexpr int smem = Smem<T, HD, Addr::kPaged>::bytes;
  auto kernel = decode_attention_kernel<T, HD, Addr>;
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
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(k_s),
      static_cast<const float*>(v_s), static_cast<const int*>(start),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), W, Hkv, G,
      kv_args, scale);
  return cudaGetLastError();
}

template <typename T, typename Addr>
cudaError_t launch_hd(int hd, dim3 grid, const void* q, const void* k,
                      const void* v, const void* k_s, const void* v_s,
                      const void* start, void* out, void* ws, int W, int Hkv,
                      int G, const KVArgs& a, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_one<T, 16, Addr>(grid, q, k, v, k_s, v_s, start, out, ws, W, Hkv, G, a, scale, s);
    case 32: return launch_one<T, 32, Addr>(grid, q, k, v, k_s, v_s, start, out, ws, W, Hkv, G, a, scale, s);
    case 64: return launch_one<T, 64, Addr>(grid, q, k, v, k_s, v_s, start, out, ws, W, Hkv, G, a, scale, s);
    case 96: return launch_one<T, 96, Addr>(grid, q, k, v, k_s, v_s, start, out, ws, W, Hkv, G, a, scale, s);
    case 128: return launch_one<T, 128, Addr>(grid, q, k, v, k_s, v_s, start, out, ws, W, Hkv, G, a, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// The launch the wrapper planned (decode_plan): n_seg segments of SEG
// positions, which must be ceil(W / SEG); with more than one, a workspace
// of ws_len >= TICKETS + B * Hkv * n_seg * record_floats(G, hd) 4-byte
// elements whose first B * Hkv (tickets) are zero, and B * Hkv <= TICKETS.
template <typename Addr>
int launch(const void* q, const void* k, const void* v, const void* k_s,
           const void* v_s, const void* start, void* out, void* ws,
           long long ws_len, int B, int W, int Hkv, int G, int hd,
           const KVArgs& kv_args, int quantized, float scale, int n_seg,
           void* stream) {
  if (B <= 0 || Hkv <= 0) return static_cast<int>(cudaGetLastError());
  if (G < 1 || G > G_MAX || W < 1 || B > 65535 || n_seg > 65535 ||
      n_seg != (W - 1) / SEG + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_seg > 1 &&
      (ws == nullptr || (long long)B * Hkv > TICKETS ||
       ws_len < TICKETS + (long long)B * Hkv * n_seg * record_floats(G, hd)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Hkv, n_seg, B);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      quantized
          ? launch_hd<int8_t, Addr>(hd, grid, q, k, v, k_s, v_s, start, out,
                                    ws, W, Hkv, G, kv_args, scale, s)
          : launch_hd<__nv_bfloat16, Addr>(hd, grid, q, k, v, k_s, v_s,
                                           start, out, ws, W, Hkv, G,
                                           kv_args, scale, s);
  return static_cast<int>(e);
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Hq, hd) bf16 contiguous, 4-byte aligned; k, v (B, W, Hkv, hd) bf16
// (quantized == 0) or int8 (quantized == 1) with the last three dims
// contiguous, 16-byte aligned, and batch stride kv_bstride elements (a
// multiple of 16 bytes); k_s, v_s (B, W, Hkv) f32 with the last two dims
// contiguous and batch stride s_bstride (ignored unless quantized); start
// (B,) int32 -> out (B, Hq, hd) bf16. ws: the split-KV workspace (see
// launch). Needs hd in {16, 32, 64, 96, 128} and G <= 16. A slot at
// start[b] >= W sees the whole window, as in the plain version.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* k_s, const void* v_s,
                                const void* start, void* out, void* ws,
                                long long ws_len, int B, int W, int Hkv,
                                int G, int hd, long long kv_bstride,
                                long long s_bstride, int quantized,
                                float scale, int n_seg, void* stream) {
  const KVArgs a{kv_bstride, s_bstride, nullptr, 0, 0};
  return launch<ContigAddr>(q, k, v, k_s, v_s, start, out, ws, ws_len, B, W,
                            Hkv, G, hd, a, quantized, scale, n_seg, stream);
}

// The same against a paged arena: k, v (n_pages, page_size, Hkv, hd) and
// k_s, v_s (n_pages, page_size, Hkv), all contiguous, k and v 16-byte
// aligned; pages (B, n_blk) int32 contiguous, physical page ids of each
// slot's window prefix, of any length. The window is W = n_blk * page_size.
extern "C" int paged_decode_attention(const void* q, const void* k,
                                      const void* v, const void* k_s,
                                      const void* v_s, const void* start,
                                      const void* pages, void* out, void* ws,
                                      long long ws_len, int B, int n_blk,
                                      int page_size, int Hkv, int G, int hd,
                                      int quantized, float scale, int n_seg,
                                      void* stream) {
  if (n_blk < 1 || page_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const KVArgs a{0, 0, static_cast<const int*>(pages), n_blk, page_size};
  return launch<PagedAddr>(q, k, v, k_s, v_s, start, out, ws, ws_len, B,
                           n_blk * page_size, Hkv, G, hd, a, quantized,
                           scale, n_seg, stream);
}
