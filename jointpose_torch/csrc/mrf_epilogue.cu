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
// (a warp's threads cover a few consecutive rows, so together they read
// whole contiguous rows and L1 serves the strided re-reads), the biases sit
// in shared memory and the K^2 log terms never leave the SM.  bf16 is
// widened to f32 before the add, as the TPU kernel does.  What holds this
// kernel back on the card, above the cost of a launch, is neither bytes nor
// load requests but instructions: an accurate logf is some twenty of them
// per value.  The sum of Kv logs is therefore taken as one log of a
// product: x = m * 2^e with m in [1, 2), sum_v log x_v = log(prod_v m_v) +
// ln2 * sum_v e_v, with the mantissas multiplied in index order in fp32.
// That is a different rounding from adding Kv rounded logs (measured: one
// ulp of the result apart, and nearer the float64 sum); a sum that meets an
// infinity or a NaN is taken again log by log, which passes it on.
//
// Backward: the TPU kernel accumulates dbias across its sequential grid in
// one VMEM block.  CUDA blocks run in no order, and float atomics would
// make the sum depend on that order, so the reduction has two stages with
// a fixed order each.  What bounds stage 1 is the bytes in flight: a row
// is Kv*Ka values (162 B at bf16, K=9), so per-value loads move 64 B per
// warp request.  resp and dresp are therefore walked as flat arrays of
// 16-byte vectors (8 bf16 or 4 f32): a group of 8 (or 4) rows is exactly
// Kv*Ka vectors whatever Kv*Ka is, so thread t of a group always holds the
// columns (8t + i) mod Kv*Ka of rows (8t + i) / (Kv*Ka) of the group, keeps
// their biases and joint indices in registers, and sums its fp32 dresp
// values (before any rounding to bf16) in 8 registers.  A block of
// slots*Kv*Ka threads takes `slots` groups per step and two steps' loads
// are in flight before the first is used; g[r, a] comes through L1 (a row's
// Ka values serve Kv*Ka elements).  Rows past the last whole group go
// through the same threads one value at a time.  At the end the block adds,
// per column, its slots and the group's rows in a fixed order through shared
// memory and writes one partial row.
// Stage 2: one block per column adds the partial rows, each thread a fixed
// strided subset, then a fixed-shape tree in shared memory.  Repeated runs
// give bit-identical dbias.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPartials = 1024;  // stage-1 blocks at most
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// out[r, a] of one row: the sum over v in index order, fp32.
template <typename T>
__device__ __forceinline__ float fwd_row_sum(const T* __restrict__ row,
                                             const float* __restrict__ bias_s, int kv, int ka,
                                             int a, float eps) {
  float acc = 0.f;
#pragma unroll 9
  for (int v = 0; v < kv; ++v) {
    const float x = to_f32(row[v * ka + a]) + bias_s[v * ka + a];
    acc += logf(fmaxf(x, eps));
  }
  return acc;
}

// The same sum with one logf per kChunk values instead of one per value:
// a chunk's product of mantissas stays below 2^kChunk.  x >= eps > 0 here,
// so only an infinity or a NaN has no such form: a sum that meets one is
// taken again value by value, which passes it on.
constexpr int kChunk = 16;
template <typename T>
__device__ __forceinline__ float fwd_row_sum_product(const T* __restrict__ row,
                                                     const float* __restrict__ bias_s, int kv,
                                                     int ka, int a, float eps) {
  float acc = 0.f;
  uint32_t top = 0;
  for (int v0 = 0; v0 < kv; v0 += kChunk) {
    float prod = 1.f;
    int e = 0;
    const int v1 = v0 + kChunk < kv ? v0 + kChunk : kv;
#pragma unroll 9
    for (int v = v0; v < v1; ++v) {
      const float x = fmaxf(to_f32(row[v * ka + a]) + bias_s[v * ka + a], eps);
      const uint32_t bits = __float_as_uint(x);
      top = max(top, bits);
      e += (int)(bits >> 23);
      prod *= __uint_as_float((bits & 0x007fffffu) | 0x3f800000u);
    }
    acc += fmaf((float)(e - 127 * (v1 - v0)), 0.693147180559945309f, logf(prod));
  }
  // x > 0, so its bits order as its value: inf is 0x7f800000, a NaN above
  // (fmaxf drops a NaN operand, so a NaN response reads as eps, as in logf(fmaxf)).
  if (top >= 0x7f800000u) return fwd_row_sum(row, bias_s, kv, ka, a, eps);
  return acc;
}

// One thread per (row, a), Kv scalar loads from device memory.
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
  out[idx] = fwd_row_sum_product(resp + r * (long long)(kv * ka), bias_s, kv, ka, a, eps);
}

// A 16-byte vector of T as floats and back (bf16 rounds to nearest even).
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void unpack(const uint4& q, float (&v)[4]) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void unpack(const uint4& q, float (&v)[8]) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the upper half of its float
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

constexpr int kSteps = 2;  // steps whose loads are in flight together

// One value of the backward: x = resp + bias, d = g * (x > eps ? 1/x : 0).
__device__ __forceinline__ float bwd_value(float resp, float bj, float g, float eps) {
  const float x = __fadd_rn(resp, bj);
  return __fmul_rn(g, x > eps ? __frcp_rn(x) : 0.f);
}

// Stage 1 of the backward: blockDim.x = slots * kk, kk = Kv*Ka; a group is
// VEC rows = kk vectors of VEC values.  MAX_THREADS: 256 where the block is
// `slots` groups wide (three blocks an SM), 1024 where one group of
// kk > 256 vectors fills it.
template <typename T, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, MAX_THREADS == kThreads ? 3 : 1)
mrf_epilogue_bwd_kernel(const T* __restrict__ resp, const float* __restrict__ bias,
                        const float* __restrict__ g, T* __restrict__ dresp,
                        float* __restrict__ partials, long long rows, int steps_per_block,
                        int kk, int ka, float eps) {
  constexpr int VEC = Vec16<T>::n;
  extern __shared__ float part_s[];  // (slots, VEC * kk)
  const int slots = blockDim.x / kk;
  const int t = threadIdx.x % kk;
  const int slot = threadIdx.x / kk;
  // This thread's VEC values of a group: value i is flat element t*VEC + i,
  // row e / kk of the group, column e % kk, joint column % ka; g_of is its
  // offset into the group's VEC rows of g.  Walked without a division per value.
  int g_of[VEC];
  float bj[VEC], acc[VEC];
  {
    int row = t * VEC / kk, col = t * VEC - row * kk, a = col % ka;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      g_of[i] = row * ka + a;
      bj[i] = bias[col];
      acc[i] = 0.f;
      if (++a == ka) a = 0;
      if (++col == kk) col = 0, ++row;  // kk is a multiple of ka: a is 0 here already
    }
  }
  const long long whole = rows / VEC;  // groups of VEC whole rows
  const long long first = (long long)blockIdx.x * steps_per_block * slots + slot;
  const uint4* src = reinterpret_cast<const uint4*>(resp);
  uint4* dst = reinterpret_cast<uint4*>(dresp);

  for (int s0 = 0; s0 < steps_per_block; s0 += kSteps) {
    uint4 in[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const long long grp = first + (long long)(s0 + u) * slots;
      if (s0 + u < steps_per_block && grp < whole) in[u] = __ldg(src + grp * kk + t);
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const long long grp = first + (long long)(s0 + u) * slots;
      if (s0 + u >= steps_per_block) continue;
      const float* gp = g + grp * VEC * ka;
      if (grp < whole) {
        float vals[VEC];
        Vec16<T>::unpack(in[u], vals);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          vals[i] = bwd_value(vals[i], bj[i], __ldg(gp + g_of[i]), eps);
          acc[i] = __fadd_rn(acc[i], vals[i]);
        }
        dst[grp * kk + t] = Vec16<T>::pack(vals);
      } else if (grp == whole) {
        // The ragged last group: rows % VEC rows, one value at a time.
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const long long e = grp * VEC * kk + t * VEC + i;
          if (e < rows * kk) {
            const float d = bwd_value(to_f32(resp[e]), bj[i], __ldg(gp + g_of[i]), eps);
            store(dresp + e, d);
            acc[i] = __fadd_rn(acc[i], d);
          }
        }
      }
    }
  }
  // Column j of the block: its slots in order, and within a slot the group's rows in order.
#pragma unroll
  for (int i = 0; i < VEC; ++i) part_s[(slot * kk + t) * VEC + i] = acc[i];
  __syncthreads();
  if (slot == 0) {
    float s = 0.f;
    for (int k = 0; k < slots; ++k)
      for (int r = 0; r < VEC; ++r) s = __fadd_rn(s, part_s[k * kk * VEC + r * kk + t]);
    partials[(long long)blockIdx.x * kk + t] = s;
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

// The forward: one block per kThreads outputs.
extern "C" int mrf_epilogue_fwd(const void* resp, int resp_is_bf16, const void* bias, void* out,
                                long long rows, int kv, int ka, float eps, void* stream) {
  if (rows == 0) return 0;
  const int blocks = (int)((rows * ka + kThreads - 1) / kThreads);
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

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
  }
  return n;
}

// Stage-1 geometry: `slots` groups of `vec` rows per block and step, and so
// many steps a block that all blocks run at once (three per SM), at most
// kMaxPartials of them: a second, ragged wave would cost as much as the first.
struct BwdPlan {
  int slots;
  int steps_per_block;
  int blocks;
};

BwdPlan bwd_plan(long long rows, int kk, int vec) {
  BwdPlan p;
  p.slots = kk > kThreads ? 1 : kThreads / kk;
  const long long groups = (rows + vec - 1) / vec;
  const long long steps = (groups + p.slots - 1) / p.slots;
  long long blocks = (steps + kSteps - 1) / kSteps;
  const long long wave = (long long)sm_count() * (kk > kThreads ? 1 : 3);
  if (blocks > wave) blocks = wave;
  if (blocks > kMaxPartials) blocks = kMaxPartials;
  if (blocks < 1) blocks = 1;
  p.steps_per_block = (int)((steps + blocks - 1) / blocks);
  if (p.steps_per_block < 1) p.steps_per_block = 1;
  p.blocks = (int)((steps + p.steps_per_block - 1) / p.steps_per_block);
  if (p.blocks < 1) p.blocks = 1;
  return p;
}

}  // namespace

// Rows of the (rows, kk) f32 scratch the backward needs for its partials.
extern "C" int mrf_epilogue_bwd_partials(long long rows, int kk, int resp_is_bf16) {
  return bwd_plan(rows, kk, resp_is_bf16 ? 8 : 4).blocks;
}

extern "C" int mrf_epilogue_bwd(const void* resp, int resp_is_bf16, const void* bias,
                                const void* g, void* dresp, void* dbias, void* partials,
                                long long rows, int kv, int ka, float eps, void* stream) {
  const int kk = kv * ka;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kk > 1024) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaMemsetAsync(dbias, 0, sizeof(float) * kk, s);
  const int vec = resp_is_bf16 ? 8 : 4;
  const BwdPlan p = bwd_plan(rows, kk, vec);
  const int threads = p.slots * kk;
  const size_t smem = sizeof(float) * threads * vec;
  if (resp_is_bf16) {
    (kk > kThreads ? mrf_epilogue_bwd_kernel<__nv_bfloat16, 1024> : mrf_epilogue_bwd_kernel<__nv_bfloat16, kThreads>)
        <<<p.blocks, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(resp), static_cast<const float*>(bias),
        static_cast<const float*>(g), static_cast<__nv_bfloat16*>(dresp),
        static_cast<float*>(partials), rows, p.steps_per_block, kk, ka, eps);
  } else {
    (kk > kThreads ? mrf_epilogue_bwd_kernel<float, 1024> : mrf_epilogue_bwd_kernel<float, kThreads>)
        <<<p.blocks, threads, smem, s>>>(
        static_cast<const float*>(resp), static_cast<const float*>(bias),
        static_cast<const float*>(g), static_cast<float*>(dresp),
        static_cast<float*>(partials), rows, p.steps_per_block, kk, ka, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mrf_epilogue_bias_reduce_kernel<<<kk, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(dbias), p.blocks, kk);
  return (int)cudaGetLastError();
}
