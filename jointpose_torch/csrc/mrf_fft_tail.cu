// Fused Fourier MRF tail, forward: for each image b and target joint a,
//
//   out[b, a, y, x] = sum_v log(max(o_v[y, x] + bias[v, a], eps)),
//   o_v = Re{ Ir @ ((conj(Kf[v, a]) * Pf[b, v]) @ Ic) }
//
// Replaces the TPU kernel jointpose/ops/mrf_fft_pallas.py:_fused_kernel
// (called through _fused_inverse_epilogue / mrf_message_pass_fft_fused).
// Inputs, all f32 and contiguous:
//   pf_re, pf_im  (B, Kv, Ph, G)  forward DFTs of the unaries (half column spectrum)
//   kf_re, kf_im  (Kv, Ka, Ph, G) forward DFTs of the pairwise kernels
//   ir            (H, Ph, 2)      inverse row DFT with the SAME crop, (re, im) interleaved
//   ict_re/_im    (G, W)          inverse column DFT, pair-weighted, transposed
//   bias          (Kv, Ka)
//   out           (B, Ka, H, W)
//
// Bound on an H100: operations.  Per (b, v, a) pair the two inverse
// transforms cost 8*Ph*G*W + 4*H*Ph*W flops (8.2 MFLOP at the paper
// geometry Ph=104, G=79, H=60, W=90) against 0.13 MB of Pf/Kf, all in
// fp32 on the CUDA cores (67 TFLOP/s): plain TF32 would lose the small
// responses that the log amplifies, as the TPU kernel's note says.
//
// Design.  The TPU walks a sequential (batch tile, v) grid and carries the
// output in VMEM between steps; here nothing carries between blocks, so
// one block owns an output tile (b, a, 64 rows, 32 columns) and loops over
// v itself, with the log-sum accumulator in registers.  Splitting columns
// costs no repeated work: a column tile of U = R @ Ic needs only its own
// columns of Ic.  Per v the block
//   1. forms R = conj(Kf) * Pf for all (f, g) into shared memory,
//   2. computes its (Ph, 32) tile of U into shared memory (lane = column,
//      each thread a register block of 13 rows, R read as warp broadcasts),
//   3. contracts U over f with Ir for its 8 rows x 1 column per thread,
//      adds the bias, takes the log and accumulates.
// Everything between the forward DFTs and the (B, Ka, H, W) output stays
// on chip: R and U never reach HBM.  Shared memory at the paper geometry:
// R 65.7 KB + U 26.6 KB + Ic tile 20.2 KB = 112.6 KB, two blocks per SM.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 32;            // output columns per block (one per lane)
constexpr int kRowsPerThread = 8;    // output rows per thread
constexpr int kRows = kWarps * kRowsPerThread;  // output rows per block
constexpr int kRB = 13;              // U rows per thread register block

__global__ void __launch_bounds__(kThreads, 2)
mrf_fft_tail_kernel(const float* __restrict__ pf_re, const float* __restrict__ pf_im,
                    const float* __restrict__ kf_re, const float* __restrict__ kf_im,
                    const float2* __restrict__ ir, const float* __restrict__ ict_re,
                    const float* __restrict__ ict_im, const float* __restrict__ bias,
                    float* __restrict__ out, int kv, int ka, int ph, int g_bins, int h,
                    int w, float eps) {
  extern __shared__ float2 smem[];
  const int nfi = (ph + kWarps - 1) / kWarps;  // U rows per warp
  const int php = nfi * kWarps;                // Ph padded to the warps
  float2* r_s = smem;                          // (php, G)
  float2* u_s = r_s + php * g_bins;            // (php, kCols)
  float2* ic_s = u_s + php * kCols;            // (G, kCols)

  const int nxc = (w + kCols - 1) / kCols;
  const int nyc = (h + kRows - 1) / kRows;
  int bid = blockIdx.x;
  const int xc = bid % nxc;
  bid /= nxc;
  const int yc = bid % nyc;
  bid /= nyc;
  const int a = bid % ka;
  const int b = bid / ka;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x = xc * kCols + lane;
  const int plane = ph * g_bins;

  for (int i = tid; i < g_bins * kCols; i += kThreads) {
    const int g = i / kCols, c = xc * kCols + i % kCols;
    ic_s[i] = c < w ? make_float2(ict_re[g * w + c], ict_im[g * w + c]) : make_float2(0.f, 0.f);
  }
  for (int i = plane + tid; i < php * g_bins; i += kThreads) r_s[i] = make_float2(0.f, 0.f);

  // Ir row offsets of this thread's output rows (clamped; stores are masked).
  int ir_row[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int y = yc * kRows + warp + kWarps * j;
    ir_row[j] = (y < h ? y : h - 1) * ph;
  }
  float acc[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0.f;

  for (int v = 0; v < kv; ++v) {
    // 1. R = conj(Kf[v, a]) * Pf[b, v] over the (Ph, G) half spectrum.
    const float* pr = pf_re + (size_t)(b * kv + v) * plane;
    const float* pi = pf_im + (size_t)(b * kv + v) * plane;
    const float* kr = kf_re + (size_t)(v * ka + a) * plane;
    const float* ki = kf_im + (size_t)(v * ka + a) * plane;
    for (int i = tid; i < plane; i += kThreads) {
      const float p_r = pr[i], p_i = pi[i], k_r = kr[i], k_i = ki[i];
      r_s[i] = make_float2(k_r * p_r + k_i * p_i, k_r * p_i - k_i * p_r);
    }
    __syncthreads();

    // 2. U[f, x] = sum_g R[f, g] * Ic[g, x]; warp w owns rows w + 8*i.
    for (int i0 = 0; i0 < nfi; i0 += kRB) {
      int r_off[kRB];
#pragma unroll
      for (int i = 0; i < kRB; ++i) {
        const int ii = i0 + i < nfi ? i0 + i : nfi - 1;
        r_off[i] = (warp + kWarps * ii) * g_bins;
      }
      float ure[kRB], uim[kRB];
#pragma unroll
      for (int i = 0; i < kRB; ++i) ure[i] = uim[i] = 0.f;
      for (int g = 0; g < g_bins; ++g) {
        const float2 c = ic_s[g * kCols + lane];
#pragma unroll
        for (int i = 0; i < kRB; ++i) {
          const float2 r = r_s[r_off[i] + g];
          ure[i] = fmaf(r.x, c.x, ure[i]);
          ure[i] = fmaf(-r.y, c.y, ure[i]);
          uim[i] = fmaf(r.x, c.y, uim[i]);
          uim[i] = fmaf(r.y, c.x, uim[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRB; ++i)
        if (i0 + i < nfi) u_s[(warp + kWarps * (i0 + i)) * kCols + lane] = make_float2(ure[i], uim[i]);
    }
    __syncthreads();

    // 3. o[y, x] = Re sum_f Ir[y, f] * U[f, x]; then bias, log, accumulate.
    float o[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) o[j] = 0.f;
    for (int f = 0; f < ph; ++f) {
      const float2 u = u_s[f * kCols + lane];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const float2 c = __ldg(ir + ir_row[j] + f);
        o[j] = fmaf(c.x, u.x, o[j]);
        o[j] = fmaf(-c.y, u.y, o[j]);
      }
    }
    const float bv = bias[v * ka + a];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) acc[j] += logf(fmaxf(o[j] + bv, eps));
  }

  if (x < w) {
    float* dst = out + (size_t)(b * ka + a) * h * w;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int y = yc * kRows + warp + kWarps * j;
      if (y < h) dst[y * w + x] = acc[j];
    }
  }
}

}  // namespace

extern "C" long long mrf_fft_tail_smem_bytes(int ph, int g_bins) {
  const int php = (ph + kWarps - 1) / kWarps * kWarps;
  return (long long)sizeof(float2) * (php * g_bins + php * kCols + g_bins * kCols);
}

extern "C" int mrf_fft_tail(const void* pf_re, const void* pf_im, const void* kf_re,
                            const void* kf_im, const void* ir, const void* ict_re,
                            const void* ict_im, const void* bias, void* out, int batch, int kv,
                            int ka, int ph, int g_bins, int h, int w, float eps, void* stream) {
  if (batch == 0) return 0;
  const long long smem = mrf_fft_tail_smem_bytes(ph, g_bins);
  cudaError_t err = cudaFuncSetAttribute(
      mrf_fft_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nxc = (w + kCols - 1) / kCols;
  const int nyc = (h + kRows - 1) / kRows;
  const long long blocks = (long long)nxc * nyc * batch * ka;
  mrf_fft_tail_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pf_re), static_cast<const float*>(pf_im),
      static_cast<const float*>(kf_re), static_cast<const float*>(kf_im),
      static_cast<const float2*>(ir), static_cast<const float*>(ict_re),
      static_cast<const float*>(ict_im), static_cast<const float*>(bias),
      static_cast<float*>(out), kv, ka, ph, g_bins, h, w, eps);
  return (int)cudaGetLastError();
}
