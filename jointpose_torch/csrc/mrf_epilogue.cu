// Fused MRF epilogue, forward: out[r, a] = sum_v log(max(resp[r, v*Ka + a] + bias[v, a], eps)).
//
// Replaces the TPU kernel jointpose/ops/mrf_pallas.py:_fwd_kernel (called
// through mrf_epilogue_pallas).  resp is (rows, Kv*Ka) row-major in bf16 or
// f32, rows = B*H*W pixels; bias is (Kv, Ka) f32; out is (rows, Ka) f32.
//
// Bound on an H100: memory.  Per row it reads Kv*Ka values (162 B at bf16,
// K=9) and writes Ka floats (36 B), for about 4*Kv*Ka flops and Kv*Ka logs,
// far below the card's 67 TFLOP/s fp32 per byte moved.  The design therefore
// only makes sure each byte crosses HBM once: one thread per (row, a) walks
// its Kv column entries of the row (the warp's threads cover a few
// consecutive rows, so together they read whole contiguous rows and L1
// serves the strided re-reads), the biases sit in shared memory, the sum
// stays in a register and the K^2 log terms never leave the SM.  bf16 is
// widened to f32 before the add, as the TPU kernel does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
mrf_epilogue_fwd_kernel(const T* __restrict__ resp, const float* __restrict__ bias,
                        float* __restrict__ out, long long rows, int kv, int ka, float eps) {
  extern __shared__ float bias_s[];
  for (int i = threadIdx.x; i < kv * ka; i += blockDim.x) bias_s[i] = bias[i];
  __syncthreads();
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * ka) return;
  const long long r = idx / ka;
  const int a = (int)(idx - r * ka);
  const T* row = resp + r * (long long)(kv * ka);
  float acc = 0.f;
#pragma unroll 9
  for (int v = 0; v < kv; ++v) {
    const float x = to_f32(row[v * ka + a]) + bias_s[v * ka + a];
    acc += logf(fmaxf(x, eps));
  }
  out[idx] = acc;
}

}  // namespace

extern "C" int mrf_epilogue_fwd(const void* resp, int resp_is_bf16, const void* bias, void* out,
                                long long rows, int kv, int ka, float eps, void* stream) {
  if (rows == 0) return 0;
  const long long n = rows * ka;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  const size_t smem = sizeof(float) * kv * ka;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resp_is_bf16) {
    mrf_epilogue_fwd_kernel<__nv_bfloat16><<<blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(resp), static_cast<const float*>(bias),
        static_cast<float*>(out), rows, kv, ka, eps);
  } else {
    mrf_epilogue_fwd_kernel<float><<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(resp), static_cast<const float*>(bias),
        static_cast<float*>(out), rows, kv, ka, eps);
  }
  return (int)cudaGetLastError();
}
