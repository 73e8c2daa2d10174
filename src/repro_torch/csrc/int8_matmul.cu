// W8A8 matmul with int32 accumulation and a per-row x per-column dequant
// epilogue: out[m, n] = bf16((float(sum_k x_q[m,k] * w_q[k,n]) * xs[m]) * ws[n]).
//
// Replaces: src/repro/kernels/int8_matmul.py, int8_matmul_pallas (_kernel).
// Bound on the card: bytes on the main path. Decode runs at M = n_slots
//   (skinny M), where every weight byte is used M times: far below the
//   ~590 int8 operations per byte at which the tensor cores would bound it.
// Design: one block per 32 x 64 output tile, 256 threads, 8 outputs per
//   thread. The K loop stages a 32 x 64 tile of x and a 64 x 64 tile of w in
//   shared memory, w transposed so that four consecutive k of one column
//   form one 32-bit word, and accumulates with __dp4a (4 int8 products into
//   an int32 per instruction). Ragged M, N and K are masked in the kernel:
//   out-of-range bytes are staged as zeros and out-of-range outputs are not
//   written, so no padded copy is made. Simple first: no tensor cores, no
//   cp.async/TMA pipelining, no split-K (a later PR).
// Staging: the plain version's (kernels/ref.py int8_matmul_ref), exactly:
//   the int32 sum is exact whatever its order, it is rounded to f32, then
//   multiplied by xs[m], then by ws[n], then rounded to bf16 (nearest even).
//   The output equals the plain version bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 32, BN = 64, BK = 64, kThreads = 256;
constexpr int kStride = BK + 4;   // bytes per staged row: word-aligned, and
                                  // 17 words apart, so column reads do not
                                  // collide on a bank

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t x_tile[BM][kStride];
  __shared__ __align__(16) int8_t w_tile[BN][kStride];   // [n][k]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  // staging assignments
  const int xm = tid / 8, xk = (tid % 8) * 8;     // 8 bytes of one x row
  const int wn = tid % 64, wk = (tid / 64) * 16;  // 16 k of one w column

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const int gm = m0 + xm;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int gk = k0 + xk + e;
        x_tile[xm][xk + e] =
            (gm < M && gk < K) ? xq[(size_t)gm * K + gk] : int8_t(0);
      }
    }
    {
      const int gn = n0 + wn;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int gk = k0 + wk + e;
        w_tile[wn][wk + e] =
            (gn < N && gk < K) ? wq[(size_t)gk * N + gn] : int8_t(0);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kw = 0; kw < BK / 4; ++kw) {
      int a[2], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        a[i] = *reinterpret_cast<const int*>(&x_tile[ty * 2 + i][kw * 4]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const int*>(&w_tile[tx + 16 * j][kw * 4]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gm = m0 + ty * 2 + i;
    if (gm >= M) continue;
    const float row_scale = xs[gm];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), row_scale),
                                ws[gn]);
      out[(size_t)gm * N + gn] = __float2bfloat16_rn(v);
    }
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x_q (M, K) int8, w_q (K, N) int8, x_s (M,) f32, w_s (N,) f32, all
// contiguous -> out (M, N) bf16.
extern "C" int int8_matmul(const void* x_q, const void* w_q, const void* x_s,
                           const void* w_s, void* out, int M, int N, int K,
                           void* stream) {
  if (M > 0 && N > 0) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    int8_matmul_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x_q), static_cast<const int8_t*>(w_q),
        static_cast<const float*>(x_s), static_cast<const float*>(w_s),
        static_cast<__nv_bfloat16*>(out), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
