// One shear pass of the two-pass affine image warp.
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
// and does a few flops.  One thread per (line, output position) computes
// the position and weights once and loops over the channels; the batch
// index is blockIdx.y, so a thread finds its (n, o) with one 32-bit
// division (64-bit divisions per value made the first version
// integer-bound).  The logical (b, n, i|o, c) axes of source and output
// are given as element strides, so one kernel serves both orientations,
// reads the NHWC input directly and writes whatever layout the next pass
// reads.  `order` names which of n and o the neighbouring threads walk,
// which the wrapper picks so that they write neighbouring addresses.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Strides {
  long long b, n, x, c;  // x: the resample axis (i for the source, o for the output)
};

__global__ void __launch_bounds__(kThreads)
shear_pass_kernel(const float* __restrict__ src, float* __restrict__ dst,
                  const float* __restrict__ pars, int lines, int s_in, int s_out, int chans,
                  Strides ss, Strides ds, int order) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= lines * s_out) return;
  const int b = blockIdx.y;
  // order 0: n is the fastest-varying axis across threads; 1: o is.
  int n, o;
  if (order == 0) {
    n = t % lines;
    o = t / lines;
  } else {
    o = t % s_out;
    n = t / s_out;
  }
  const float alpha = pars[3 * b], shear = pars[3 * b + 1], off = pars[3 * b + 2];
  const float pos = __fadd_rn(__fadd_rn(__fmul_rn(alpha, (float)o), __fmul_rn(shear, (float)n)), off);
  // Outside (-1, S_in) both taps lie outside the frame.
  const bool in_frame = pos > -1.f && pos < (float)s_in;
  const float f0 = in_frame ? floorf(pos) : 0.f;
  const int i0 = (int)f0;
  const bool tap0 = in_frame && i0 >= 0;
  const bool tap1 = in_frame && i0 + 1 < s_in;
  const float w0 = __fsub_rn(1.f, __fsub_rn(pos, f0));
  const float w1 = __fsub_rn(1.f, fabsf(__fsub_rn(__fadd_rn(f0, 1.f), pos)));
  const float* line = src + b * ss.b + n * ss.n;
  float* out = dst + b * ds.b + n * ds.n + o * ds.x;
  for (int c = 0; c < chans; ++c) {
    float acc = 0.f;
    if (tap0) acc = __fmul_rn(w0, __ldg(line + i0 * ss.x + c * ss.c));
    if (tap1) acc = __fadd_rn(acc, __fmul_rn(w1, __ldg(line + (i0 + 1) * ss.x + c * ss.c)));
    out[c * ds.c] = acc;
  }
}

}  // namespace

// src_strides and dst_strides: 4 element strides each, (b, n, x, c).
extern "C" int shear_pass(const void* src, void* dst, const void* pars, int batch, int lines,
                          int s_in, int s_out, int chans, const long long* src_strides,
                          const long long* dst_strides, int order, void* stream) {
  const long long per_image = (long long)lines * s_out;
  if (batch == 0 || per_image == 0 || chans == 0) return 0;
  if (order < 0 || order > 1 || batch > 65535 || per_image > 0x7fffffffLL - kThreads)
    return (int)cudaErrorInvalidValue;
  const Strides ss{src_strides[0], src_strides[1], src_strides[2], src_strides[3]};
  const Strides ds{dst_strides[0], dst_strides[1], dst_strides[2], dst_strides[3]};
  const dim3 grid((unsigned)((per_image + kThreads - 1) / kThreads), (unsigned)batch);
  shear_pass_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), static_cast<const float*>(pars),
      lines, s_in, s_out, chans, ss, ds, order);
  return (int)cudaGetLastError();
}
