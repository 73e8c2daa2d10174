// Rowwise symmetric INT8 quantization of activations (bf16 -> int8 + f32).
//
// Replaces: src/repro/kernels/quantize.py, quantize_rowwise_pallas (_kernel).
// Bound on the card: bytes. It reads 2 B and writes 1 B per element plus one
//   f32 per row, and does a handful of operations per element.
// Design: one block per row. The block reduces the row's absmax in f32
//   through warp shuffles and shared memory, then every thread quantizes its
//   strided share of the row. Rows are independent, so the codes of a row do
//   not depend on how many rows the call holds.
// Staging: the plain version's (kernels/ref.py quantize_ref), exactly:
//   scale = max(amax, 1e-8f) / 127 with an IEEE division, q = clamp(
//   rint(x / scale), -127, 127) with an IEEE division and round half to even.
//   Codes and scales equal the plain version bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void quantize_rowwise_kernel(const __nv_bfloat16* __restrict__ x,
                                        int8_t* __restrict__ q,
                                        float* __restrict__ s, int K) {
  const size_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * K;
  int8_t* qr = q + row * K;

  float amax = 0.0f;
  for (int k = threadIdx.x; k < K; k += kThreads)
    amax = fmaxf(amax, fabsf(__bfloat162float(xr[k])));
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));

  __shared__ float warp_max[kThreads / 32];
  __shared__ float row_scale;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    row_scale = __fdiv_rn(fmaxf(m, 1e-8f), 127.0f);
    s[row] = row_scale;
  }
  __syncthreads();
  const float scale = row_scale;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float v = rintf(__fdiv_rn(__bfloat162float(xr[k]), scale));
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    qr[k] = static_cast<int8_t>(v);
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, K) bf16 contiguous -> q (M, K) int8, s (M,) f32.
extern "C" int quantize_rowwise(const void* x, void* q, void* s, int M, int K,
                                void* stream) {
  if (M > 0 && K > 0) {
    quantize_rowwise_kernel<<<M, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(s), K);
  }
  return static_cast<int>(cudaGetLastError());
}
