// The two-pass (shear) affine image warp, both passes in one launch.
//
// For image b, line n (a source row in the first pass, an output column in
// the second), output position o and channel c:
//   pos = alpha_b * o + shear_b * n + off_b
//   out[b, n, o, c] = sum_i max(0, 1 - |i - pos|) * src[b, n, i, c],  0 <= i < S_in
// with zero weight outside the frame.
//
// Replaces the TPU kernels jointpose/ops/warp_pallas.py:_resample_kernel_csub
// (production shear_warp) and _resample_kernel (shear_warp_rowmajor).  On
// the TPU each line is an (S_out x S_in) hat matrix built in VMEM and
// applied as one MXU matmul, at bf16 Precision.DEFAULT.  The hat has at
// most two nonzero taps, floor(pos) and floor(pos) + 1, so this kernel
// computes just those two in fp32: the dense sum differs from it only by
// exact zeros.  The position and both tap weights are rounded exactly as
// the dense fp32 reference rounds them (no contraction into FMAs).
//
// Bound on an H100: memory.  Each output value reads two source values
// and does a few flops.  Run as two launches, the passes would move the
// fp32 intermediate through device memory: 133 MB at the training shape
// where the function needs 66 MB.  A strip of output columns [x0, x0 + TW)
// is self-contained: pass 2 reads the intermediate only in those columns,
// over all H rows, and pass 1 makes those columns of every source row from
// the NHWC input.  So one block per (image, strip) keeps its intermediate
// in shared memory, and the intermediate never leaves the SM.  Its size
// depends on the image's shape alone, not on the warp's parameters, which
// stay on the device (the wrapper never reads them).  Each intermediate and
// output value goes through the same fp32 operations in the same order as
// in ops/warp.shear_warp_strips, which repeats the kernel per strip in
// plain PyTorch, so the result is bit-equal to it.  Neighbouring threads
// walk neighbouring columns of one row: the output rows of a strip are
// written as contiguous TW * C floats.
//
// `shear_warp_fused` is the production orientation: the strip's
// intermediate is (H, TW, C).  `shear_warp_fused_rowmajor` serves the
// reference's row-major orientation (the cross-orientation oracle
// shear_warp_rowmajor): a template parameter keeps the strip's intermediate
// as that orientation holds it, (TW, H, C), a line of H * C values per
// output column, contiguous along H for pass 2, the line stride made odd
// where it fits so that the columns' lines start in other banks.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Both taps of one hat at `pos` in a line of s_in values: their weights and
// the first tap's index, rounded as the dense fp32 reference rounds them.
struct Taps {
  int i0;
  bool tap0, tap1;
  float w0, w1;
};

__device__ __forceinline__ Taps hat_taps(float alpha, float shear, float off, int o, int n,
                                         int s_in) {
  const float pos = __fadd_rn(__fadd_rn(__fmul_rn(alpha, (float)o), __fmul_rn(shear, (float)n)), off);
  const bool in_frame = pos > -1.f && pos < (float)s_in;
  const float f0 = in_frame ? floorf(pos) : 0.f;
  Taps t;
  t.i0 = (int)f0;
  t.tap0 = in_frame && t.i0 >= 0;
  t.tap1 = in_frame && t.i0 + 1 < s_in;
  t.w0 = __fsub_rn(1.f, __fsub_rn(pos, f0));
  t.w1 = __fsub_rn(1.f, fabsf(__fsub_rn(__fadd_rn(f0, 1.f), pos)));
  return t;
}

// How a strip's intermediate t1 lies in shared memory: kRows, the production
// orientation, (H, TW * C); kLines, the row-major one, (TW, line) with a
// line of H * C values (and a pad) per column.
enum class Strip { kRows, kLines };

// One block per (strip, image).  A thread owns one (row, column) of the
// strip at a time and its C channels.  The passes' parameters come from the
// inverse map (a_inv (B, 2, 2), b_inv (B, 2)) in the block itself, rounded
// as ops/warp._pass_params rounds them (each product and quotient on its
// own, no contraction), so that the call is one launch and bit-equal to
// shear_warp_strips, which takes them from that function.  `line`: floats
// per column line (kLines).
template <Strip kLayout>
__global__ void __launch_bounds__(kThreads)
shear_warp_fused_kernel(const float* __restrict__ src, float* __restrict__ dst,
                        const float* __restrict__ a_inv, const float* __restrict__ b_inv, int h,
                        int w, int chans, int tw, int line) {
  extern __shared__ float t1[];
  const int b = blockIdx.y;
  const float a00 = a_inv[4 * b], a01 = a_inv[4 * b + 1], a10 = a_inv[4 * b + 2];
  const float a11 = a_inv[4 * b + 3], b0 = b_inv[2 * b], b1 = b_inv[2 * b + 1];
  const float det = __fsub_rn(__fmul_rn(a00, a11), __fmul_rn(a01, a10));
  const int x0 = blockIdx.x * tw;
  const int nx = min(tw, w - x0);
  const int row = tw * chans;  // floats per row of t1 (kRows)
  // t1's offsets of column xl and of one step along y.
  const int x_step = kLayout == Strip::kRows ? chans : line;
  const int y_step = kLayout == Strip::kRows ? row : chans;
  const size_t plane = (size_t)h * w * chans;
  const float* img = src + b * plane;
  // (row, column) of this thread's first item and the step between items.
  const int dy = kThreads / nx, dx = kThreads % nx;
  const int n_items = h * nx;

  // Pass 1: x-resample of source row y at output columns x0 .. x0 + nx.
  {
    const float alpha = __fdiv_rn(det, a11), shear = __fdiv_rn(a01, a11);
    const float off = __fsub_rn(b0, __fdiv_rn(__fmul_rn(a01, b1), a11));
    int y = threadIdx.x / nx, xl = threadIdx.x % nx;
    for (int item = threadIdx.x; item < n_items; item += kThreads) {
      const Taps t = hat_taps(alpha, shear, off, x0 + xl, y, w);
      const float* line = img + (size_t)y * w * chans;
      float* out = t1 + y * y_step + xl * x_step;
      for (int c = 0; c < chans; ++c) {
        float acc = 0.f;
        if (t.tap0) acc = __fmul_rn(t.w0, __ldg(line + t.i0 * chans + c));
        if (t.tap1) acc = __fadd_rn(acc, __fmul_rn(t.w1, __ldg(line + (t.i0 + 1) * chans + c)));
        out[c] = acc;
      }
      y += dy;
      xl += dx;
      if (xl >= nx) {
        xl -= nx;
        ++y;
      }
    }
  }
  __syncthreads();

  // Pass 2: y-resample of column x0 + xl at output rows yo, from t1.
  {
    const float alpha = a11, shear = a10, off = b1;
    int yo = threadIdx.x / nx, xl = threadIdx.x % nx;
    for (int item = threadIdx.x; item < n_items; item += kThreads) {
      const Taps t = hat_taps(alpha, shear, off, yo, x0 + xl, h);
      const float* col = t1 + xl * x_step;
      float* out = dst + b * plane + ((size_t)yo * w + x0 + xl) * chans;
      for (int c = 0; c < chans; ++c) {
        float acc = 0.f;
        if (t.tap0) acc = __fmul_rn(t.w0, col[t.i0 * y_step + c]);
        if (t.tap1) acc = __fadd_rn(acc, __fmul_rn(t.w1, col[(t.i0 + 1) * y_step + c]));
        out[c] = acc;
      }
      yo += dy;
      xl += dx;
      if (xl >= nx) {
        xl -= nx;
        ++yo;
      }
    }
  }
}

// Floats per column line of the row-major strip: H * C, made odd where
// that still fits a block.
int rowmajor_line(int h, int chans, int tw) {
  const long long line = (long long)h * chans;
  return (line % 2 == 0 && (line + 1) * tw * (long long)sizeof(float) <= 232448) ? (int)line + 1
                                                                               : (int)line;
}

template <Strip kLayout>
int launch_fused(const void* src, void* dst, const void* a_inv, const void* b_inv, int batch,
                 int h, int w, int chans, int tw, void* stream) {
  if (batch == 0 || h == 0 || w == 0 || chans == 0) return 0;
  if (tw < 1 || batch > 65535 || (long long)h * w * chans > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int line = kLayout == Strip::kLines ? rowmajor_line(h, chans, tw) : h * chans;
  const long long smem = (long long)tw * line * (long long)sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(shear_warp_fused_kernel<kLayout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((w + tw - 1) / tw), (unsigned)batch);
  shear_warp_fused_kernel<kLayout><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), static_cast<const float*>(a_inv),
      static_cast<const float*>(b_inv), h, w, chans, tw, line);
  return (int)cudaGetLastError();
}

}  // namespace

// Both passes of the production orientation: (B, H, W, C) f32 NHWC in and
// out, the inverse map a_inv (B, 2, 2) and b_inv (B, 2) f32, strips of tw
// columns.  The wrapper picks tw by its shape rule.
extern "C" int shear_warp_fused(const void* src, void* dst, const void* a_inv, const void* b_inv,
                                int batch, int h, int w, int chans, int tw, void* stream) {
  return launch_fused<Strip::kRows>(src, dst, a_inv, b_inv, batch, h, w, chans, tw, stream);
}

// The same in the row-major orientation: the strip's intermediate as (TW, H, C).
extern "C" int shear_warp_fused_rowmajor(const void* src, void* dst, const void* a_inv,
                                         const void* b_inv, int batch, int h, int w, int chans,
                                         int tw, void* stream) {
  return launch_fused<Strip::kLines>(src, dst, a_inv, b_inv, batch, h, w, chans, tw, stream);
}
