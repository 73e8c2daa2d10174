// W8A8 matmul with int32 accumulation and a per-row x per-column dequant
// epilogue: out[m, n] = bf16((float(sum_k x_q[m,k] * w_q[k,n]) * xs[m]) *
// ws[n]); in its second form it first quantizes a bf16 x per row itself.
//
// Replaces: src/repro/kernels/int8_matmul.py, int8_matmul_pallas (_kernel);
//   the second form also src/repro/kernels/quantize.py,
//   quantize_rowwise_pallas (_kernel), as its prologue: the pair that
//   src/repro/kernels/ops.py int8_matmul runs on a float x.
// Bound on the card: bytes on the main path. Decode runs at M = n_slots = 4
//   and a prefill chunk at M = 16, where every weight byte is used M times:
//   (4, 1024) x (1024, 3072) moves 3.16 MB, 0.94 us at 3.35 TB/s, against
//   0.025 us of int8 tensor-core work. The 196 launches of a decode step
//   move 352 MB together, ~105 us.
// Design, for skinny M on Hopper:
//   * Tensor cores in one 16-row M tile: mma.sync m16n8k32 s8.s8.s32. Rows
//     past M are zero in registers and never stored; larger M takes more
//     16-row tiles (grid.y). wgmma takes 64-row tiles, which at M <= 16
//     would read the same bytes for 4x the idle rows: the bound is bytes,
//     so it buys nothing here.
//   * Operand layout: int8 MMA wants both operands K-major, and
//     ldmatrix.trans exists only for 16-bit types, so the (K, N) weight
//     tile is turned into K-major B fragments in registers: each thread
//     reads four 32-bit words (four k rows, four adjacent columns) from
//     shared memory and transposes the 4x4 bytes with __byte_perm. The MMA
//     sees a permuted order inside each 16-k group (logical k 4t+i is
//     physical k t+4i) and inside each 32-column strip (column g of n8 tile
//     j is physical column 4g+j); x is staged in shared memory in the same
//     k order, and the epilogue maps columns back. Both permutations leave
//     the sum unchanged, and make the B reads free of bank conflicts.
//   * Weight streaming: a ring of 4 stages of 128 k rows x 32 columns in
//     shared memory, filled by cp.async (16-byte cp.async.cg, so a warp
//     reads whole 32-byte rows of the 32-column strip); each of the 4 warps
//     takes one 32-row slice of each stage. The copy width is a template
//     parameter (16, 8, 4 or 1 byte) that the wrapper picks from the
//     alignment of N and of w_q's pointer: a ragged N (3,035 after a
//     per-layer cut) has rows that do not start on 16 bytes, and width 1
//     copies bytes through registers into the same ring. x (tiny) is
//     staged once per block, 4 bytes at a time where K allows it.
//   * Split-K to fill 132 SMs: the wrapper's plan (kernels/int8_matmul.py,
//     gemm_plan) splits K over grid.z so that a decode shape launches at
//     least 132 blocks, N = 512 included. Partial int32 sums are reduced
//     inside the launch: each block adds its tile into an int32 workspace
//     with atomics, and the last block of a tile to arrive (a counter per
//     tile) reads the sums, applies the epilogue, and resets the workspace
//     and its counter to zero for the next launch. No second launch. A
//     cluster reduction through distributed shared memory would need no
//     workspace, but a portable cluster holds 8 blocks: 16 tiles of N = 512
//     times 8 is 128 blocks. Integer addition is associative and |acc| <=
//     127^2 * K < 2^31, so the sum is exact whatever the order.
// Quantize prologue (int8_matmul_quant, the serving path's form): x comes
//   as bf16 (M, K), and the launch does B2's work (quantize_rowwise.cu)
//   itself, so B2 is no longer a launch of its own on the serving path: a
//   launch of B2 costs 1-2 us of device time and a host wrapper call for
//   8 KB of work (PERF.md). After the weight ring's first copies are
//   issued, and while they fly, each block (1) reduces the f32 absmax of
//   each of its <= 16 rows over the whole K, four rows a warp, by 16-byte
//   loads where K % 8 == 0 and x allows it, else element by element, then
//   warp shuffles; max does not depend on the order, so every block of an
//   m-tile, whatever its K range, gets the same bits; (2) takes scale =
//   max(amax, 1e-8) / 127 by one IEEE division, kept in shared memory; (3)
//   quantizes only its own K range into x's tile, in the MMA's k order, q
//   = clamp(rint(x / scale), -127, 127) by IEEE division and round half to
//   even: B2's sequence, so the codes and scales are B2's bit for bit; (4)
//   scales the epilogue by the row's scale from shared memory (in a split
//   K the last block computed the same one). Every block reads its rows
//   over all of K (from L2 after the first: 8 KB a block at decode, 96 KB
//   at a prefill chunk's K = 3,072) and divides for its whole range, once
//   per n-tile: the prologue's cost grows with M, and at M = 16 the fused
//   launch is slower than B2 then B1 at the two largest shapes (PERF.md,
//   with the designs tried: staging x's range by cp.async ahead of the
//   weights, the whole ring ahead, and codes by reciprocal screened for
//   ties were no faster). Optional outputs receive the codes (from the
//   blocks of n-tile 0, each its K range) and the scales (n-tile 0, K
//   range 0) for the parity checks; null on the serving path.
// Staging: the plain version's (kernels/ref.py int8_matmul_ref, after
//   quantize_ref in the second form), exactly: the int32 sum, rounded to
//   f32, times xs[m], then times ws[n], rounded to bf16 (nearest even). The
//   output equals the plain version bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Mirrored by kernels/int8_matmul.py (gemm_plan); int8_matmul below
// refuses a plan that does not fit them.
constexpr int BM = 16, BN = 32, KSTEP = 32, kWarps = 4, kThreads = 32 * kWarps;
constexpr int STAGES = 4, STAGE_ROWS = KSTEP * kWarps;
constexpr int STAGE_BYTES = STAGE_ROWS * BN;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
static_assert(kWarps * BM * BN * 4 <= RING_BYTES, "reduce buffer fits the ring");
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? V : 0;        // 0 source bytes: zero-fill
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(V), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + STAGE_ROWS) of the weight's 32-column strip at n0 into one
// ring slot (row-major, 32 bytes a row). Rows at or past k_end and columns
// past N are zeros. V divides N, so a chunk is all in or all out.
template <int V>
__device__ __forceinline__ void load_stage(int8_t* dst,
                                           const int8_t* __restrict__ wq,
                                           int N, int n0, int r0, int k_end,
                                           int tid) {
  constexpr int CH = BN / V, TOTAL = STAGE_ROWS * CH;
#pragma unroll
  for (int c = tid; c < TOTAL; c += kThreads) {
    const int r = c / CH, col = (c % CH) * V;
    const int gk = r0 + r, gn = n0 + col;
    const bool ok = gk < k_end && gn < N;
    int8_t* d = dst + r * BN + col;
    if constexpr (V == 1) {
      *d = ok ? wq[(size_t)gk * N + gn] : int8_t(0);
    } else {
      cp_async<V>(d, ok ? wq + (size_t)gk * N + gn : wq, ok);
    }
  }
}

// out[j] byte i = in[i] byte j: four k rows of four columns -> four
// K-major column words.
__device__ __forceinline__ void transpose4x4(const uint32_t in[4],
                                             uint32_t out[4]) {
  const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
  const uint32_t t1 = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t t2 = __byte_perm(in[2], in[3], 0x5140);
  const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Position of physical k (within its 16-k group) in the MMA's order.
__device__ __forceinline__ int perm16(int q) { return 4 * (q & 3) + (q >> 2); }

// Where x's tile is staged: row r's physical k p (of the block's range)
// at xt[r * x_pitch + xt_col(p)], each 16-k group in the MMA's order.
__device__ __forceinline__ int xt_col(int p) {
  return (p & ~15) + perm16(p & 15);
}

// int8 x: rows m0.. of the block's K range [k_begin, k_begin + span) into
// xt, zeros past the span up to kx, 4 bytes at a time where x_vec == 4.
__device__ __forceinline__ void stage_x_int8(
    int8_t* xt, const int8_t* __restrict__ xq, int m0, int rows, int K,
    int k_begin, int span, int kx, int x_pitch, int x_vec, int tid) {
  if (x_vec == 4) {
    const int words = kx / 4;
    for (int idx = tid; idx < rows * words; idx += kThreads) {
      const int r = idx / words, p = (idx % words) * 4;
      const int v = p < span ? *reinterpret_cast<const int*>(
                                   xq + (size_t)(m0 + r) * K + k_begin + p)
                             : 0;
      int8_t* d = xt + r * x_pitch + (p & ~15) + ((p & 15) >> 2);
#pragma unroll
      for (int b = 0; b < 4; ++b) d[4 * b] = static_cast<int8_t>(v >> (8 * b));
    }
  } else {
    for (int idx = tid; idx < rows * kx; idx += kThreads) {
      const int r = idx / kx, p = idx % kx;
      xt[r * x_pitch + xt_col(p)] =
          p < span ? xq[(size_t)(m0 + r) * K + k_begin + p] : int8_t(0);
    }
  }
}

__device__ __forceinline__ float abs_hi(uint32_t w) {
  return fabsf(__uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float abs_lo(uint32_t w) {
  return fabsf(__uint_as_float(w << 16));
}

// Four int8 as the bytes of one word, a first.
__device__ __forceinline__ uint32_t byte_pack(int8_t a, int8_t b, int8_t c,
                                              int8_t d) {
  return static_cast<uint32_t>(static_cast<uint8_t>(a)) |
         static_cast<uint32_t>(static_cast<uint8_t>(b)) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(c)) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(d)) << 24;
}

// B2's code of one value: rint(x / scale) by IEEE division, clamped.
__device__ __forceinline__ int8_t quant_code(float x, float scale) {
  const float v = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
}

constexpr int RPW = BM / kWarps;   // rows a warp takes in the absmax pass

// The largest |x| of the 8 bf16 values of one 16-byte load, in f32.
__device__ __forceinline__ float abs_max(const uint4& u) {
  return fmaxf(fmaxf(fmaxf(abs_lo(u.x), abs_hi(u.x)),
                     fmaxf(abs_lo(u.y), abs_hi(u.y))),
               fmaxf(fmaxf(abs_lo(u.z), abs_hi(u.z)),
                     fmaxf(abs_lo(u.w), abs_hi(u.w))));
}

// Chunk idx (row r = idx / chunks, physical k p = 8 * (idx % chunks) of
// the block's range) of bf16 x, 16-byte rows: its 8 codes, by B2's
// division, into x's tile (and out_q) from the 16-byte load u (ignored
// past the span, which codes 0).
__device__ __forceinline__ void quant_chunk(
    int8_t* xt, const float* scale_sh, const uint4& u, int idx, int chunks,
    int span, int x_pitch, int8_t* __restrict__ q_row0, int K) {
  const int r = idx / chunks, p = (idx % chunks) * 8;
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  const float scale = scale_sh[r];
  int8_t c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t h = i & 1 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16;
    c[i] = quant_code(p < span ? __uint_as_float(h) : 0.0f, scale);
  }
  // physical k p + i sits at (p & ~15) + perm16((p & 15) + i): codes i and
  // i + 4 at neighbouring bytes, 4 * (i & 3) + (p & 15) / 4
  int8_t* d = xt + r * x_pitch + (p & ~15) + ((p & 15) >> 2);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<uint16_t*>(d + 4 * i) =
        static_cast<uint16_t>(byte_pack(c[i], c[i + 4], 0, 0));
  if (q_row0 != nullptr && p < span)
    *reinterpret_cast<uint2*>(q_row0 + (size_t)r * K + p) =
        make_uint2(byte_pack(c[0], c[1], c[2], c[3]),
                   byte_pack(c[4], c[5], c[6], c[7]));
}

// The codes of the block's K range, 16-byte rows: U loads a thread in
// flight at once (a dead one rereads the range's first 8 values).
template <int U>
__device__ __forceinline__ void quant_range16(
    int8_t* xt, const float* scale_sh, const __nv_bfloat16* __restrict__ x,
    int m0, int rows, int K, int k_begin, int span, int kx, int x_pitch,
    int tid, int8_t* q_row0) {
  const int chunks = kx / 8, total = rows * chunks;
  const __nv_bfloat16* x0 = x + (size_t)m0 * K + k_begin;
  for (int base = tid; base < total; base += U * kThreads) {
    uint4 u[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int idx = base + j * kThreads, r = idx / chunks,
                p = (idx % chunks) * 8;
      u[j] = __ldg(reinterpret_cast<const uint4*>(
          idx < total && p < span ? x0 + (size_t)r * K + p : x0));
    }
#pragma unroll
    for (int j = 0; j < U; ++j)
      if (base + j * kThreads < total)
        quant_chunk(xt, scale_sh, u[j], base + j * kThreads, chunks, span,
                    x_pitch, q_row0, K);
  }
}

// bf16 x, the quantize prologue: (1) each row's absmax over the whole K,
// four rows a warp; (2) its scale into scale_sh; (3) the codes of the
// block's K range into xt, zeros past the span, by B2's division:
// 16-byte rows U loads a thread in flight (U = 1 for a tile of at most 4
// rows, which has few, else 4), a ragged K element by element. With
// out_q / out_s set, the codes of the range and (write_s) the scales go
// there too.
__device__ __forceinline__ void stage_x_quant(
    int8_t* xt, float* scale_sh, const __nv_bfloat16* __restrict__ x,
    int m0, int rows, int K, int k_begin, int span, int kx, int x_pitch,
    int x_vec, int tid, int8_t* __restrict__ out_q,
    float* __restrict__ out_s, bool write_s) {
  const int lane = tid & 31, warp = tid >> 5;
  float amax[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) amax[i] = 0.0f;
  if (x_vec == 16) {
    const int n8 = K / 8;
#pragma unroll 4
    for (int c = lane; c < n8; c += 32) {
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + kWarps * i;
        if (r < rows)
          amax[i] = fmaxf(amax[i], abs_max(__ldg(
              reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K) + c)));
      }
    }
  } else {
#pragma unroll 4
    for (int c = lane; c < K; c += 32) {
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + kWarps * i;
        if (r < rows)
          amax[i] = fmaxf(amax[i],
                          fabsf(__bfloat162float(x[(size_t)(m0 + r) * K + c])));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + kWarps * i;
    float a = amax[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    if (lane == 0 && r < rows) {
      const float s = __fdiv_rn(fmaxf(a, 1e-8f), 127.0f);
      scale_sh[r] = s;
      if (write_s) out_s[m0 + r] = s;
    }
  }
  __syncthreads();

  int8_t* q_row0 = out_q == nullptr ? nullptr
                                    : out_q + (size_t)m0 * K + k_begin;
  if (x_vec == 16) {
    if (rows <= kWarps)
      quant_range16<1>(xt, scale_sh, x, m0, rows, K, k_begin, span, kx,
                       x_pitch, tid, q_row0);
    else
      quant_range16<4>(xt, scale_sh, x, m0, rows, K, k_begin, span, kx,
                       x_pitch, tid, q_row0);
  } else {
    for (int idx = tid; idx < rows * kx; idx += kThreads) {
      const int r = idx / kx, p = idx % kx;
      int8_t c = 0;
      if (p < span) {
        c = quant_code(__bfloat162float(x[(size_t)(m0 + r) * K + k_begin +
                                          p]),
                       scale_sh[r]);
        if (q_row0 != nullptr) q_row0[(size_t)r * K + p] = c;
      }
      xt[r * x_pitch + xt_col(p)] = c;
    }
  }
}

// One block's tile of the product. kQuantX: x is bf16 (M, K) and the block
// quantizes it (stage_x_quant), xs is unused; otherwise x is int8 with its
// scales xs.
template <int V, bool kQuantX>
__device__ __forceinline__ void gemm_block(
    const void* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ xs, const float* __restrict__ ws,
    __nv_bfloat16* __restrict__ out, int* __restrict__ acc_ws,
    int* __restrict__ counters, int8_t* __restrict__ out_q,
    float* __restrict__ out_s, int M, int N, int K, int ksteps, int x_vec) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* ring = smem;
  int8_t* xt = smem + RING_BYTES;
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int split = gridDim.z;
  const int k_begin = blockIdx.z * ksteps * KSTEP;
  const int k_end = min(K, k_begin + ksteps * KSTEP);
  const int span = max(0, k_end - k_begin);
  const int n_stages = (span + STAGE_ROWS - 1) / STAGE_ROWS;
  const int x_pitch = ksteps * KSTEP + 16;     // 4 mod 8 words: no conflicts
  const int rows = min(BM, M - m0);
  // after x's tile: its rows' scales (quantize prologue)
  float* scale_sh = reinterpret_cast<float*>(xt + BM * x_pitch);

  // weights first, so that their copies are in flight while x is staged
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages)
      load_stage<V>(ring + s * STAGE_BYTES, wq, N, n0, k_begin + s * STAGE_ROWS,
                    k_end, tid);
    cp_async_commit();
  }
  // x rows m0.. of this block's K range, each 16-k group in the MMA's order
  const int kx = (span + KSTEP - 1) / KSTEP * KSTEP;
  if constexpr (kQuantX)
    stage_x_quant(xt, scale_sh, static_cast<const __nv_bfloat16*>(x), m0,
                  rows, K, k_begin, span, kx, x_pitch, x_vec, tid,
                  blockIdx.x == 0 ? out_q : nullptr, out_s,
                  out_s != nullptr && blockIdx.x == 0 && blockIdx.z == 0);
  else
    stage_x_int8(xt, static_cast<const int8_t*>(x), m0, rows, K, k_begin,
                 span, kx, x_pitch, x_vec, tid);

  int acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int sn = s + STAGES - 1;       // into the slot read at s - 1
      if (sn < n_stages)
        load_stage<V>(ring + (sn % STAGES) * STAGE_BYTES, wq, N, n0,
                      k_begin + sn * STAGE_ROWS, k_end, tid);
      cp_async_commit();
    }
    const int kk = s * STAGE_ROWS + warp * KSTEP;
    if (kk < span) {
      const int8_t* wsl = ring + (s % STAGES) * STAGE_BYTES + warp * KSTEP * BN;
      const int8_t* x0 = xt + g * x_pitch + kk + 4 * t;
      const int8_t* x8 = x0 + 8 * x_pitch;
      uint32_t a[4];
      a[0] = g < rows ? *reinterpret_cast<const uint32_t*>(x0) : 0u;
      a[1] = g + 8 < rows ? *reinterpret_cast<const uint32_t*>(x8) : 0u;
      a[2] = g < rows ? *reinterpret_cast<const uint32_t*>(x0 + 16) : 0u;
      a[3] = g + 8 < rows ? *reinterpret_cast<const uint32_t*>(x8 + 16) : 0u;
      uint32_t lo[4], hi[4], blo[4], bhi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = *reinterpret_cast<const uint32_t*>(wsl + (t + 4 * i) * BN + 4 * g);
        hi[i] = *reinterpret_cast<const uint32_t*>(wsl + (16 + t + 4 * i) * BN +
                                                   4 * g);
      }
      transpose4x4(lo, blo);
      transpose4x4(hi, bhi);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[j], a, blo[j], bhi[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the 4 warps' partial tiles, in physical columns, summed through the ring
  int* red = reinterpret_cast<int*>(ring);     // [warp][BM][BN]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1), c = 4 * (2 * t + (e & 1)) + j;
      red[(warp * BM + r) * BN + c] = acc[j][e];
    }
  __syncthreads();

  constexpr int PER = BM * BN / kThreads;
  int total[PER];
#pragma unroll
  for (int o = 0; o < PER; ++o) {
    const int idx = tid + o * kThreads;
    int v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w * BM * BN + idx];
    total[o] = v;
  }

  if (split > 1) {
#pragma unroll
    for (int o = 0; o < PER; ++o) {
      const int idx = tid + o * kThreads, r = idx / BN, c = idx % BN;
      if (r < rows && n0 + c < N)
        atomicAdd(acc_ws + (size_t)(m0 + r) * N + n0 + c, total[o]);
    }
    __threadfence();
    __syncthreads();
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) is_last = atomicAdd(counters + tile, 1) == split - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
#pragma unroll
    for (int o = 0; o < PER; ++o) {
      const int idx = tid + o * kThreads, r = idx / BN, c = idx % BN;
      if (r < rows && n0 + c < N) {
        int* p = acc_ws + (size_t)(m0 + r) * N + n0 + c;
        total[o] = __ldcg(p);
        __stcg(p, 0);
      }
    }
    if (tid == 0) counters[tile] = 0;
  }

#pragma unroll
  for (int o = 0; o < PER; ++o) {
    const int idx = tid + o * kThreads, r = idx / BN, c = idx % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (r < rows && gn < N) {
      const float v = __fmul_rn(
          __fmul_rn(__int2float_rn(total[o]), kQuantX ? scale_sh[r] : xs[gm]),
          ws[gn]);
      out[(size_t)gm * N + gn] = __float2bfloat16_rn(v);
    }
  }
}

// The two forms, under their own names (the profiler and ptxas tell them
// apart): x int8 with its scales, and x bf16 quantized in the launch.
template <int V>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ xq,
                   const int8_t* __restrict__ wq,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   __nv_bfloat16* __restrict__ out, int* __restrict__ acc_ws,
                   int* __restrict__ counters, int M, int N, int K,
                   int ksteps, int x_vec) {
  gemm_block<V, false>(xq, wq, xs, ws, out, acc_ws, counters, nullptr,
                       nullptr, M, N, K, ksteps, x_vec);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
int8_matmul_quant_kernel(const __nv_bfloat16* __restrict__ x,
                         const int8_t* __restrict__ wq,
                         const float* __restrict__ ws,
                         __nv_bfloat16* __restrict__ out,
                         int* __restrict__ acc_ws, int* __restrict__ counters,
                         int8_t* __restrict__ out_q,
                         float* __restrict__ out_s, int M, int N, int K,
                         int ksteps, int x_vec) {
  gemm_block<V, true>(x, wq, nullptr, ws, out, acc_ws, counters, out_q,
                      out_s, M, N, K, ksteps, x_vec);
}

template <int V, bool kQuantX>
cudaError_t launch(const void* x, const int8_t* wq, const float* xs,
                   const float* ws, __nv_bfloat16* out, int* workspace,
                   int8_t* out_q, float* out_s, int M, int N, int K,
                   int ksteps, int split, int x_vec, int smem,
                   cudaStream_t stream) {
  // the attribute belongs to a device: kept per device, set again only
  // when a launch needs more (past kMaxDevices, at every launch)
  static int smem_set[kMaxDevices] = {};
  constexpr auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > smem_set[dev])) {
    if constexpr (kQuantX)
      e = cudaFuncSetAttribute(int8_matmul_quant_kernel<V>, attr, smem);
    else
      e = cudaFuncSetAttribute(int8_matmul_kernel<V>, attr, smem);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) smem_set[dev] = smem;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  int* counters = workspace == nullptr ? nullptr : workspace + (size_t)M * N;
  if constexpr (kQuantX)
    int8_matmul_quant_kernel<V><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), wq, ws, out, workspace,
        counters, out_q, out_s, M, N, K, ksteps, x_vec);
  else
    int8_matmul_kernel<V><<<grid, kThreads, smem, stream>>>(
        static_cast<const int8_t*>(x), wq, xs, ws, out, workspace, counters,
        M, N, K, ksteps, x_vec);
  return cudaGetLastError();
}

// The plan checks of both forms: K split into `split` ranges of `ksteps`
// 32-row steps that cover K with none empty, the dynamic shared memory of
// this tiling (the ring, x's tile and, quantizing, 16 f32 scales), a
// workspace of at least M * N sums and one counter a tile when K is split,
// an x load width the form has (int8: 4 or 1 bytes; bf16: 16, with K % 8
// == 0 and x on 16 bytes, or 2), and a grid within its limits.
bool plan_fits(const void* x, long long workspace_len, bool workspace,
               bool quant, int M, int N, int K, int ksteps, int split,
               int x_vec, int smem) {
  const long long range = (long long)ksteps * KSTEP;
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const bool x_ok =
      quant ? (x_vec == 2 ||
               (x_vec == 16 && K % 8 == 0 &&
                reinterpret_cast<uintptr_t>(x) % 16 == 0))
            : (x_vec == 1 || x_vec == 4);
  return ksteps >= 1 && split >= 1 && split <= 65535 && range * split >= K &&
         !(split > 1 && range * (split - 1) >= K) &&
         smem == RING_BYTES + BM * (int)(range + 16) + (quant ? BM * 4 : 0) &&
         !(split > 1 && (!workspace ||
                         workspace_len < (long long)M * N + tiles)) &&
         x_ok && (M + BM - 1) / BM <= 65535;
}

template <bool kQuantX>
int launch_vec(const void* x, const void* w_q, const void* x_s,
               const void* w_s, void* out, void* workspace,
               long long workspace_len, void* out_q, void* out_s, int M,
               int N, int K, int ksteps, int split, int vec, int x_vec,
               int smem, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (!plan_fits(x, workspace_len, workspace != nullptr, kQuantX, M, N, K,
                 ksteps, split, x_vec, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* wq = static_cast<const int8_t*>(w_q);
  const auto* xs = static_cast<const float*>(x_s);
  const auto* ws = static_cast<const float*>(w_s);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* wsp = static_cast<int*>(workspace);
  auto* oq = static_cast<int8_t*>(out_q);
  auto* os = static_cast<float*>(out_s);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (vec) {
    case 16: e = launch<16, kQuantX>(x, wq, xs, ws, o, wsp, oq, os, M, N, K, ksteps, split, x_vec, smem, st); break;
    case 8: e = launch<8, kQuantX>(x, wq, xs, ws, o, wsp, oq, os, M, N, K, ksteps, split, x_vec, smem, st); break;
    case 4: e = launch<4, kQuantX>(x, wq, xs, ws, o, wsp, oq, os, M, N, K, ksteps, split, x_vec, smem, st); break;
    case 1: e = launch<1, kQuantX>(x, wq, xs, ws, o, wsp, oq, os, M, N, K, ksteps, split, x_vec, smem, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x_q (M, K) int8, w_q (K, N) int8, x_s (M,) f32, w_s (N,) f32, all
// contiguous -> out (M, N) bf16. The launch plan comes from the wrapper
// (gemm_plan): K is split into `split` ranges of `ksteps` 32-row steps;
// `vec` is the weight copy width, `x_vec` x's (4 or 1), `smem` the dynamic
// shared memory. With split > 1, `workspace` holds `workspace_len` zeroed
// int32, at least M * N + (tiles), and the kernel leaves it zeroed. A plan
// that does not fit this tiling (K ranges that miss K or one that is
// empty, another shared-memory size, a short workspace) is refused.
extern "C" int int8_matmul(const void* x_q, const void* w_q, const void* x_s,
                           const void* w_s, void* out, void* workspace,
                           long long workspace_len, int M, int N, int K,
                           int ksteps, int split, int vec, int x_vec,
                           int smem, void* stream) {
  return launch_vec<false>(x_q, w_q, x_s, w_s, out, workspace, workspace_len,
                           nullptr, nullptr, M, N, K, ksteps, split, vec,
                           x_vec, smem, stream);
}

// The same from x (M, K) bf16, contiguous, quantized per row in the launch
// (B2's codes and scales): out = int8_matmul(quantize_rowwise(x), w_q, w_s).
// `x_vec` is x's load width in bytes (16, or 2); `smem` adds 16 f32 scales.
// out_q (M, K) int8 and out_s (M,) f32, both optional (null), receive the
// codes and the scales.
extern "C" int int8_matmul_quant(const void* x, const void* w_q,
                                 const void* w_s, void* out, void* workspace,
                                 long long workspace_len, void* out_q,
                                 void* out_s, int M, int N, int K, int ksteps,
                                 int split, int vec, int x_vec, int smem,
                                 void* stream) {
  return launch_vec<true>(x, w_q, nullptr, w_s, out, workspace,
                          workspace_len, out_q, out_s, M, N, K, ksteps, split,
                          vec, x_vec, smem, stream);
}
