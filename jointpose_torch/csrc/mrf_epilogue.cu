// Fused MRF epilogue, forward and backward.
//
//   forward:  out[r, a] = sum_v log(max(x[r, v*Ka + a], eps)),  x = resp + bias
//   backward: dresp[r, v*Ka + a] = g[r, a] * (x > eps ? 1/x : 0)
//             dbias[v*Ka + a]    = sum_r dresp[r, v*Ka + a]
//
// Replaces the TPU kernels jointpose/ops/mrf_pallas.py:_fwd_kernel and
// _bwd_kernel (called through mrf_epilogue_pallas and its custom VJP).
// resp and dresp are (rows, Kv*Ka) row-major in bf16 or f32, rows = B*H*W
// pixels; bias and dbias are (Kv, Ka) f32; out and g are (rows, Ka) f32.
//
// Bound on an H100: memory, both ways.  Per row the forward reads Kv*Ka
// values (162 B at bf16, K=9) and writes Ka floats (36 B); the backward
// reads the same row plus Ka floats of g and writes the row back.  Each
// does a handful of flops per value, far below the card's 67 TFLOP/s fp32
// per byte moved, so the designs only make sure each byte crosses HBM once.
//
// Forward: one thread per (row, a) walks its Kv column entries of the row
// (the warp's threads cover a few consecutive rows, so together they read
// whole contiguous rows and L1 serves the strided re-reads), the biases
// sit in shared memory, the sum stays in a register and the K^2 log terms
// never leave the SM.  bf16 is widened to f32 before the add, as the TPU
// kernel does.
//
// Backward: the TPU kernel accumulates dbias across its sequential grid in
// one VMEM block.  CUDA blocks run in no order, and float atomics would
// make the sum depend on that order, so the reduction has two stages with
// a fixed order each.  Stage 1: a block of R*Kv*Ka threads owns a fixed
// range of rows; thread t keeps column j = t % (Kv*Ka) and walks every R-th
// row of the range, so the block's threads read R whole rows at a time,
// contiguously, and each thread sums its fp32 dresp values (before any
// rounding to bf16) in a register.  The R row-slots of a column are then
// added in order through shared memory and the block writes one partial row.
// Stage 2: one block per column adds the partial rows, each thread a fixed
// strided subset, then a fixed-shape tree in shared memory.  Repeated runs
// give bit-identical dbias.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPartials = 1024;  // stage-1 blocks at most
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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

// Stage 1 of the backward: blockDim.x = slots * kk, kk = Kv*Ka.
template <typename T>
__global__ void mrf_epilogue_bwd_kernel(const T* __restrict__ resp, const float* __restrict__ bias,
                                        const float* __restrict__ g, T* __restrict__ dresp,
                                        float* __restrict__ partials, long long rows,
                                        long long rows_per_block, int kk, int ka, float eps) {
  extern __shared__ float part_s[];  // (slots, kk)
  const int slots = blockDim.x / kk;
  const int j = threadIdx.x % kk;
  const int slot = threadIdx.x / kk;
  const int a = j % ka;
  const float bj = bias[j];
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  float acc = 0.f;
  for (long long r = r0 + slot; r < r1; r += slots) {
    const long long e = r * kk + j;
    const float x = __fadd_rn(to_f32(resp[e]), bj);
    const float inv = x > eps ? __frcp_rn(x) : 0.f;
    const float d = __fmul_rn(g[r * ka + a], inv);
    store(dresp + e, d);
    acc = __fadd_rn(acc, d);
  }
  part_s[threadIdx.x] = acc;
  __syncthreads();
  if (slot == 0) {
    float s = part_s[j];
    for (int k = 1; k < slots; ++k) s = __fadd_rn(s, part_s[k * kk + j]);
    partials[(long long)blockIdx.x * kk + j] = s;
  }
}

// Stage 2: block j adds column j of the (n_parts, kk) partials.
__global__ void __launch_bounds__(kReduceThreads)
mrf_epilogue_bias_reduce_kernel(const float* __restrict__ partials, float* __restrict__ dbias,
                                int n_parts, int kk) {
  __shared__ float s[kReduceThreads];
  const int j = blockIdx.x;
  float acc = 0.f;
  for (int p = threadIdx.x; p < n_parts; p += kReduceThreads)
    acc = __fadd_rn(acc, partials[(long long)p * kk + j]);
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) dbias[j] = s[0];
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

namespace {

// Stage-1 geometry: slots rows in flight per block, rows_per_block a
// multiple of slots, and at most kMaxPartials blocks.
struct BwdPlan {
  int slots;
  long long rows_per_block;
  int blocks;
};

BwdPlan bwd_plan(long long rows, int kk) {
  BwdPlan p;
  p.slots = kk > kThreads ? 1 : kThreads / kk;
  long long parts = (rows + p.slots - 1) / p.slots;
  if (parts > kMaxPartials) parts = kMaxPartials;
  if (parts < 1) parts = 1;
  long long per = (rows + parts - 1) / parts;
  per = (per + p.slots - 1) / p.slots * p.slots;
  p.rows_per_block = per < 1 ? 1 : per;
  p.blocks = (int)((rows + p.rows_per_block - 1) / p.rows_per_block);
  if (p.blocks < 1) p.blocks = 1;
  return p;
}

}  // namespace

// Rows of the (rows, kk) f32 scratch the backward needs for its partials.
extern "C" int mrf_epilogue_bwd_partials(long long rows, int kk) {
  return bwd_plan(rows, kk).blocks;
}

extern "C" int mrf_epilogue_bwd(const void* resp, int resp_is_bf16, const void* bias,
                                const void* g, void* dresp, void* dbias, void* partials,
                                long long rows, int kv, int ka, float eps, void* stream) {
  const int kk = kv * ka;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kk > 1024) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaMemsetAsync(dbias, 0, sizeof(float) * kk, s);
  const BwdPlan p = bwd_plan(rows, kk);
  const int threads = p.slots * kk;
  const size_t smem = sizeof(float) * threads;
  if (resp_is_bf16) {
    mrf_epilogue_bwd_kernel<__nv_bfloat16><<<p.blocks, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(resp), static_cast<const float*>(bias),
        static_cast<const float*>(g), static_cast<__nv_bfloat16*>(dresp),
        static_cast<float*>(partials), rows, p.rows_per_block, kk, ka, eps);
  } else {
    mrf_epilogue_bwd_kernel<float><<<p.blocks, threads, smem, s>>>(
        static_cast<const float*>(resp), static_cast<const float*>(bias),
        static_cast<const float*>(g), static_cast<float*>(dresp),
        static_cast<float*>(partials), rows, p.rows_per_block, kk, ka, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mrf_epilogue_bias_reduce_kernel<<<kk, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(dbias), p.blocks, kk);
  return (int)cudaGetLastError();
}
