// W8A8 matmul with int32 accumulation and a per-row x per-column dequant
// epilogue: out[m, n] = bf16((float(sum_k x_q[m,k] * w_q[k,n]) * xs[m]) * ws[n]).
//
// Replaces: src/repro/kernels/int8_matmul.py, int8_matmul_pallas (_kernel).
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
// Staging: the plain version's (kernels/ref.py int8_matmul_ref), exactly:
//   the int32 sum, rounded to f32, times xs[m], then times ws[n], rounded to
//   bf16 (nearest even). The output equals the plain version bit for bit.
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

template <int V>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ xq,
                   const int8_t* __restrict__ wq,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   __nv_bfloat16* __restrict__ out, int* __restrict__ acc_ws,
                   int* __restrict__ counters, int M, int N, int K,
                   int ksteps, int x_vec) {
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
      xt[r * x_pitch + (p & ~15) + perm16(p & 15)] =
          p < span ? xq[(size_t)(m0 + r) * K + k_begin + p] : int8_t(0);
    }
  }

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
      const float v =
          __fmul_rn(__fmul_rn(__int2float_rn(total[o]), xs[gm]), ws[gn]);
      out[(size_t)gm * N + gn] = __float2bfloat16_rn(v);
    }
  }
}

template <int V>
cudaError_t launch(const int8_t* xq, const int8_t* wq, const float* xs,
                   const float* ws, __nv_bfloat16* out, int* workspace, int M,
                   int N, int K, int ksteps, int split, int x_vec, int smem,
                   cudaStream_t stream) {
  // the attribute belongs to a device: kept per device, set again only
  // when a launch needs more (past kMaxDevices, at every launch)
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > smem_set[dev])) {
    e = cudaFuncSetAttribute(int8_matmul_kernel<V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) smem_set[dev] = smem;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  int* counters = workspace == nullptr ? nullptr : workspace + (size_t)M * N;
  int8_matmul_kernel<V><<<grid, kThreads, smem, stream>>>(
      xq, wq, xs, ws, out, workspace, counters, M, N, K, ksteps, x_vec);
  return cudaGetLastError();
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
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const long long range = (long long)ksteps * KSTEP;
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (ksteps < 1 || split < 1 || split > 65535 || range * split < K ||
      (split > 1 && range * (split - 1) >= K) ||
      smem != RING_BYTES + BM * (int)(range + 16) ||
      (split > 1 && (!workspace ||
                     workspace_len < (long long)M * N + tiles)) ||
      (x_vec != 1 && x_vec != 4) || (M + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xq = static_cast<const int8_t*>(x_q);
  const auto* wq = static_cast<const int8_t*>(w_q);
  const auto* xs = static_cast<const float*>(x_s);
  const auto* ws = static_cast<const float*>(w_s);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* wsp = static_cast<int*>(workspace);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (vec) {
    case 16: e = launch<16>(xq, wq, xs, ws, o, wsp, M, N, K, ksteps, split, x_vec, smem, st); break;
    case 8: e = launch<8>(xq, wq, xs, ws, o, wsp, M, N, K, ksteps, split, x_vec, smem, st); break;
    case 4: e = launch<4>(xq, wq, xs, ws, o, wsp, M, N, K, ksteps, split, x_vec, smem, st); break;
    case 1: e = launch<1>(xq, wq, xs, ws, o, wsp, M, N, K, ksteps, split, x_vec, smem, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
