// The coarse MRF pass's last step, forward and backward (ops/mrf_upsample.py):
//
//   forward:  out[b, y, x, k] = log(max(p[b, y, x, k], eps)) + up[b, y, x, k]
//             up = the bilinear upsample of coarse (B, Hc, Wc, K) fp32 to
//                  (B, H, W, K), H = s*Hc and W = s*Wc, half-pixel centres
//   backward: dcoarse = the upsample's adjoint applied to g (B, H, W, K) fp32
//             dp[b, y, x, k] = p >= eps ? g / p : 0, in p's type
//
// with p (B, H, W, K) in fp32, bf16 or fp16, every tensor contiguous.  It
// replaces no TPU kernel: the reference leaves this step to XLA
// (jointpose/ops/mrf_xla.py, mrf_message_pass_coarse).  It was added because
// PyTorch ran the upsample as its generic NCHW kernel on a channels_last view
// of 9 channels: one thread an output pixel, each looping over all B*K
// planes, 5,400 threads at flagship's 60 x 90, about 0.75 ms at batch 128 on
// an H100; the log of the unaries and the add took three more passes.
//
// Bound on an H100: memory, both ways.  At batch 128 (Hc x Wc 30 x 45,
// K = 9, bf16 p) the forward reads coarse (6.2 MB) and p (12.4 MB) once and
// writes out (24.9 MB): 43.5 MB, 13.0 us at 3.35 TB/s.  A value costs a
// dozen operations, far below what the card does per byte moved.
//
// Forward.  The B*H*W*K outputs are one flat array; a thread takes four
// consecutive values (one 16-byte store) and walks (k, x, y, b) from the
// first, taking the source rows, columns and weights of a pixel as
// PyTorch's half-pixel rule does (upsample_bilinear2d with
// align_corners=False: src = scale * (dst + 0.5) - 0.5 with scale = Hc / H
// in fp32, clamped at 0; the second tap is the first at the last row or
// column) and combining the four taps in its order,
// h0 * (w0 * a + w1 * b) + h1 * (w0 * c + w1 * d).  The taps come through
// the read-only cache: a coarse value serves 4 * s * s outputs, and
// neighbouring threads read neighbouring channels.  The unary's log is
// logf of max(p, eps) in fp32 (a NaN passes, as clamp_min passes it), added
// last, so the result is the composition's up to how nvcc contracts the
// products into fused multiply-adds.
//
// Backward.  One launch, two roles by block.  The first blocks give a thread
// one coarse value and gather, in a fixed order (fine rows, their two taps,
// fine columns, their two taps), every fine gradient whose taps reach it,
// with the forward's weights: (h * w) * g.  A fine row y reaches coarse row
// c only if its first tap is c - 1 or c, so only rows s*(c - 1) .. s*(c + 2)
// - 1 are tried (the source index of the rows just outside is at least half
// a coarse row beyond).  No atomics: two calls agree bit for bit, where
// PyTorch's backward adds with atomics in no fixed order.  The other blocks
// compute dp four values a thread, as autograd of log(clamp_min(p.float(),
// eps)) does: g / max(p, eps) where p >= eps, else 0, rounded to p's type.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // values a thread: one 16-byte store of fp32

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// kVec values from e0 on, as one vector store where all lie inside n.
template <typename T>
__device__ __forceinline__ void store(T* __restrict__ dst, int e0, int n, const float (&v)[kVec]) {
  struct alignas(kVec * sizeof(T)) Pack { T x[kVec]; };
  if (e0 + kVec <= n) {
    Pack pk;
#pragma unroll
    for (int i = 0; i < kVec; ++i) pk.x[i] = from_f32<T>(v[i]);
    *reinterpret_cast<Pack*>(dst + e0) = pk;
  } else {
    for (int i = 0; e0 + i < n; ++i) dst[e0 + i] = from_f32<T>(v[i]);
  }
}

// The two source indices and weights of output index dst along one axis.
struct Tap {
  int i0, i1;
  float l0, l1;
};

__device__ __forceinline__ Tap source_tap(int dst, float scale, int in_size) {
  float src = scale * (dst + 0.5f) - 0.5f;
  src = src < 0.f ? 0.f : src;
  Tap t;
  t.i0 = static_cast<int>(src);
  t.i1 = t.i0 + (t.i0 < in_size - 1 ? 1 : 0);
  t.l1 = src - t.i0;
  t.l0 = 1.f - t.l1;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample_log_fwd_kernel(const float* __restrict__ coarse, const T* __restrict__ p,
                            float* __restrict__ out, int n, int h, int w, int k, int hc, int wc,
                            float rh, float rw, float eps) {
  const int e0 = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (e0 >= n) return;
  int pix = e0 / k, c = e0 - pix * k;
  int row = pix / w, x = pix - row * w;
  int b = row / h, y = row - b * h;
  Tap ty = source_tap(y, rh, hc), tx = source_tap(x, rw, wc);
  float v[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (e0 + i >= n) break;
    if (i > 0 && ++c == k) {
      c = 0;
      if (++x == w) {
        x = 0;
        if (++y == h) {
          y = 0;
          ++b;
        }
        ty = source_tap(y, rh, hc);
      }
      tx = source_tap(x, rw, wc);
    }
    const float* r0 = coarse + (b * hc + ty.i0) * wc * k + c;
    const float* r1 = coarse + (b * hc + ty.i1) * wc * k + c;
    const float up =
        ty.l0 * (tx.l0 * __ldg(r0 + tx.i0 * k) + tx.l1 * __ldg(r0 + tx.i1 * k)) +
        ty.l1 * (tx.l0 * __ldg(r1 + tx.i0 * k) + tx.l1 * __ldg(r1 + tx.i1 * k));
    const float q = to_f32(p[e0 + i]);
    v[i] = logf(q < eps ? eps : q) + up;
  }
  store(out, e0, n, v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample_log_bwd_kernel(const float* __restrict__ g, const T* __restrict__ p,
                            float* __restrict__ dcoarse, T* __restrict__ dp, int n, int nc, int h,
                            int w, int k, int hc, int wc, int s, float rh, float rw, float eps,
                            int coarse_blocks) {
  if (static_cast<int>(blockIdx.x) < coarse_blocks) {
    const int ec = blockIdx.x * kThreads + threadIdx.x;
    if (ec >= nc) return;
    const int pix = ec / k, c = ec - pix * k;
    const int row = pix / wc, xc = pix - row * wc;
    const int b = row / hc, yc = row - b * hc;
    const int y_hi = min(s * (yc + 2), h), x_lo = max(s * (xc - 1), 0), x_hi = min(s * (xc + 2), w);
    float acc = 0.f;
    for (int y = max(s * (yc - 1), 0); y < y_hi; ++y) {
      const Tap ty = source_tap(y, rh, hc);
      const float* grow = g + (b * h + y) * w * k + c;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if ((t ? ty.i1 : ty.i0) != yc) continue;
        const float hl = t ? ty.l1 : ty.l0;
        for (int x = x_lo; x < x_hi; ++x) {
          const Tap tx = source_tap(x, rw, wc);
          if (tx.i0 == xc) acc += (hl * tx.l0) * __ldg(grow + x * k);
          if (tx.i1 == xc) acc += (hl * tx.l1) * __ldg(grow + x * k);
        }
      }
    }
    dcoarse[ec] = acc;
    return;
  }
  const int e0 = ((blockIdx.x - coarse_blocks) * kThreads + threadIdx.x) * kVec;
  if (e0 >= n) return;
  float v[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (e0 + i >= n) break;
    const float q = to_f32(p[e0 + i]);
    v[i] = q >= eps ? __ldg(g + e0 + i) / q : 0.f;
  }
  store(dp, e0, n, v);
}

struct Shape {
  int n, nc, h, w, k, hc, wc, s;
  float rh, rw;
};

// Sizes the kernels take: flat indices in int, with room for a block's
// overrun.  False also for an empty tensor (nothing to launch).
bool shape_of(int batch, int hc, int wc, int k, int s, Shape* sh) {
  if (batch <= 0 || hc <= 0 || wc <= 0 || k <= 0 || s <= 0) return false;
  const long long n = 1LL * batch * hc * s * wc * s * k;
  if (n > INT_MAX - kThreads * kVec) return false;
  // scale = Hc / H in fp32, as PyTorch's area_pixel_compute_scale takes it.
  *sh = Shape{static_cast<int>(n), batch * hc * wc * k, hc * s, wc * s, k, hc, wc, s,
              static_cast<float>(hc) / (hc * s), static_cast<float>(wc) / (wc * s)};
  return true;
}

int blocks_for(int values, int per_thread) {
  return (values + kThreads * per_thread - 1) / (kThreads * per_thread);
}

template <typename T>
int launch_fwd(const void* coarse, const void* p, void* out, const Shape& sh, float eps,
               cudaStream_t stream) {
  upsample_log_fwd_kernel<T><<<blocks_for(sh.n, kVec), kThreads, 0, stream>>>(
      static_cast<const float*>(coarse), static_cast<const T*>(p), static_cast<float*>(out), sh.n,
      sh.h, sh.w, sh.k, sh.hc, sh.wc, sh.rh, sh.rw, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* g, const void* p, void* dcoarse, void* dp, const Shape& sh, float eps,
               cudaStream_t stream) {
  const int coarse_blocks = blocks_for(sh.nc, 1);
  upsample_log_bwd_kernel<T><<<coarse_blocks + blocks_for(sh.n, kVec), kThreads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const T*>(p), static_cast<float*>(dcoarse),
      static_cast<T*>(dp), sh.n, sh.nc, sh.h, sh.w, sh.k, sh.hc, sh.wc, sh.s, sh.rh, sh.rw, eps,
      coarse_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of p (and dp): 0 fp32, 1 bf16, 2 fp16.  Returns the launch's
// cudaError_t; sizes beyond int indices are refused as invalid values.
extern "C" int mrf_upsample_log_fwd(const void* coarse, const void* p, int dtype, void* out,
                                    int batch, int hc, int wc, int k, int s, float eps,
                                    void* stream) {
  Shape sh;
  if (batch == 0 || hc == 0 || wc == 0 || k == 0) return 0;
  if (!shape_of(batch, hc, wc, k, s, &sh)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fwd<float>(coarse, p, out, sh, eps, st);
    case 1: return launch_fwd<__nv_bfloat16>(coarse, p, out, sh, eps, st);
    case 2: return launch_fwd<__half>(coarse, p, out, sh, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int mrf_upsample_log_bwd(const void* g, const void* p, int dtype, void* dcoarse,
                                    void* dp, int batch, int hc, int wc, int k, int s, float eps,
                                    void* stream) {
  Shape sh;
  if (batch == 0 || hc == 0 || wc == 0 || k == 0) return 0;
  if (!shape_of(batch, hc, wc, k, s, &sh)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bwd<float>(g, p, dcoarse, dp, sh, eps, st);
    case 1: return launch_bwd<__nv_bfloat16>(g, p, dcoarse, dp, sh, eps, st);
    case 2: return launch_bwd<__half>(g, p, dcoarse, dp, sh, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
