// The MRF's pairwise correlation with an fp32 result: the forward of
// ops/mrf_xla.grouped_conv_f32 on the card (ops/mrf_corr.py).  For image b,
// output row y and column x, source joint v and target joint a,
//
//   out[b, y, x, v*Ka + a] = sum_{dy, dx} p[b, y + dy - ht, x + dx - wl, v] * k[dy, dx, v*Ka + a]
//
// with p (B, H, W, Kv) NHWC and k (wh, ww, Kv*Ka) HWIO (the grouped conv's
// single input channel dropped), both bf16 or both fp16, p zero outside the
// image, ht = (wh - 1) / 2 and wl = (ww - 1) / 2: the reference's SAME
// cross-correlation, padded (k - 1) // 2 before and k // 2 after.
//
// It replaces no TPU kernel: the reference leaves this conv to XLA
// (jointpose/ops/mrf_xla.py).  It was added because cuDNN's grouped fprop
// (sm80_xmma_fprop_implicit_gemm_indexed_tf32f32, 9 groups of one input and
// 9 output channels, 425 taps) took 10.0 ms of flagship's 18.06 ms predictor
// call at batch 128 on an H100: about 1.2 TFLOP/s.
//
// Bound.  At flagship's shape (B 128, 30 x 45, Kv = Ka = 9, 17 x 25) one call
// does 11.90 GFLOP (12.0 us at the bf16 tensor-core peak of 989 TFLOP/s),
// reads p (3.11 MB) and the kernels (76.5 KB) and writes the fp32 responses
// (55.99 MB): 17.7 us at 3.35 TB/s.  Memory bounds it, by the output.
//
// Design.  For a source v and a kernel row dy, the correlation along the
// width is a product of padded input rows with a banded Toeplitz matrix,
//   T[k, (a, x)] = k[dy, 16 kc + k - x, v*Ka + a]   (zero outside [0, ww)),
// whose k runs over the 16 input columns of chunk kc of an 8-column output
// tile (kc < KC = ceil((ww + 7) / 16)).  A block takes one image, 16 * MT
// output rows and 8 output columns, all Kv * Ka channels; warp w takes
// source v = w / achunks and up to 9 targets a, as nine n8 tiles of
// mma.sync.m16n8k16 (bf16 or fp16 operands, fp32 accumulators) over MT m16
// tiles of output rows.  The A operand is the input tile staged in shared
// memory per source ([v][row][col], rows padded to an odd multiple of 16
// bytes so that ldmatrix is conflict-free): the m16 x k16 fragment of
// kernel row dy is rows dy .. dy + 15 of the tile, one ldmatrix.x4.  The B
// operand, the Toeplitz fragment, is built in registers from the HWIO
// kernels staged in shared memory as they lie in device memory (each lane
// loads its four taps, zero outside the window) and serves the warp's MT
// m-tiles.  Sums run over dy, then kc, then the 16 taps of an mma, in one
// fixed order, with no atomics: two calls agree bit for bit, whatever the
// batch.  A product of two bf16 (or fp16) values is exact in fp32, so this
// is the arithmetic of an fp32 conv on these values up to the order of the
// fp32 sums.  Shared memory does not grow with the window: kernel rows are
// staged dyc at a time and input chunks kcc at a time (the wrapper's rule,
// ops/mrf_corr.tiling), the accumulators staying in registers across the
// stages.  At the end the block's (16 MT, 8, Kv*Ka) fp32 outputs go through
// shared memory, so that each output row leaves as one contiguous run of
// 8 * Kv * Ka floats.
//
// Cost of the Toeplitz form: 16 KC products a tap row where ww are needed,
// 32 / 25 at flagship's window (8 + 24 input columns, two k16 chunks), and
// the last column tile's 48 / 45.  A non-finite value of p reaches the
// outputs of its tile whose window misses it (through a zero of T).
//
// As built, on an H100 SXM at 700 W: 0.165-0.175 ms at batch 128 (about 10%
// of the bound, 57x faster than cuDNN's fprop), 0.058 ms at batch 32.  Cut
// apart at batch 128: the mma.sync products alone take about 0.09 ms, the
// Toeplitz fragments' loads about 0.04 ms, the staging and the output about
// 0.04 ms.  mma.sync's rate is the first limit; wgmma with the Toeplitz as
// its register operand and several images a block, which would share each
// fragment over more output rows, is untried.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTx = 8;        // output columns a block: one n8 tile a target
constexpr int kNa = 9;        // targets a warp: n8 tiles of its accumulators
constexpr int kMaxWarps = 9;  // (source, target chunk) items a block, one a warp
constexpr int kSmemLimit = 232448;

struct Geometry {
  int h, w, kv, ka, wh, ww;
  int achunks;  // chunks of up to kNa targets
  int kc;       // 16-column input chunks an output tile needs
  int kcc;      // of which staged at once
  int dyc;      // kernel rows staged at once
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1);

template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Elements (16-bit) per staged input row: 16 kcc columns and 8 more, an odd
// multiple of 16 bytes.
__host__ __device__ __forceinline__ int in_stride(int kcc) { return 16 * kcc + 8; }

__host__ __device__ __forceinline__ long long in_elems(const Geometry& g, int mt) {
  return (long long)g.kv * (16 * mt + g.dyc - 1) * in_stride(g.kcc);
}

__host__ __device__ __forceinline__ long long kern_elems(const Geometry& g) {
  return (long long)g.dyc * g.ww * g.kv * g.ka;
}

long long smem_bytes(const Geometry& g, int mt) {
  const long long stage = 2 * (in_elems(g, mt) + kern_elems(g));
  const long long outs = 4LL * 16 * mt * kTx * g.kv * g.ka;
  return stage > outs ? stage : outs;
}

// 16-bit copy of n elements, 16 bytes at a time by cp.async where src is
// 16-byte aligned (dst always is): the caller waits (cp.async.wait_all).
__device__ __forceinline__ void copy_u16(uint16_t* dst, const uint16_t* src, int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n16 = n / 8;
    const uint32_t d0 = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d0 + 16 * i),
                   "l"(src + 8 * i));
    for (int i = 8 * n16 + threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    mrf_grouped_corr_kernel(const uint16_t* __restrict__ p, const uint16_t* __restrict__ kern,
                            float* __restrict__ out, Geometry g) {
  constexpr int kRows = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* s_in = reinterpret_cast<uint16_t*>(smem);
  uint16_t* s_k = s_in + in_elems(g, MT);  // a multiple of 8 elements: 16-byte aligned
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kRows, b = blockIdx.z;
  const int kk = g.kv * g.ka;
  const int ht = (g.wh - 1) / 2, wl = (g.ww - 1) / 2;
  const int stride = in_stride(g.kcc);
  const int plane = (kRows + g.dyc - 1) * stride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int v = warp / g.achunks, a0 = (warp % g.achunks) * kNa;
  const int na = min(kNa, g.ka - a0);
  const uint16_t* img = p + (size_t)b * g.h * g.w * g.kv;

  float acc[MT][kNa][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kNa; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  // This lane's ldmatrix row: tile row (lane & 15), column (lane >> 4) * 8.
  const uint32_t a_lane = static_cast<uint32_t>(__cvta_generic_to_shared(s_in)) +
                          2u * (v * plane + (lane & 15) * stride + (lane >> 4) * 8);

  for (int dy0 = 0; dy0 < g.wh; dy0 += g.dyc) {
    const int ndy = min(g.dyc, g.wh - dy0);
    for (int kc0 = 0; kc0 < g.kc; kc0 += g.kcc) {
      const int nkc = min(g.kcc, g.kc - kc0);
      __syncthreads();  // the previous stage's readers are done
      if (kc0 == 0) copy_u16(s_k, kern + (size_t)dy0 * g.ww * kk, ndy * g.ww * kk);
      // Input rows y0 - ht + dy0 + r and columns x0 - wl + 16 kc0 + c, zero
      // outside the image, source by source.
      const int cols = 16 * nkc, rows = kRows + ndy - 1;
      for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
        const int r = i / cols, c = i - r * cols;
        const int y = y0 - ht + dy0 + r, x = x0 - wl + 16 * kc0 + c;
        uint16_t* dst = s_in + r * stride + c;
        if (y >= 0 && y < g.h && x >= 0 && x < g.w) {
          const uint16_t* px = img + ((size_t)y * g.w + x) * g.kv;
          for (int s = 0; s < g.kv; ++s) dst[s * plane] = __ldg(px + s);
        } else {
          for (int s = 0; s < g.kv; ++s) dst[s * plane] = 0;
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();

      const int k_v = v * g.ka + a0;
#pragma unroll 1
      for (int dyl = 0; dyl < ndy; ++dyl) {
        const int k_row = k_v + dyl * g.ww * kk;
#pragma unroll 1
        for (int kcl = 0; kcl < nkc; ++kcl) {
          uint32_t af[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            ldmatrix_x4(af[m], a_lane + 2u * ((16 * m + dyl) * stride + 16 * kcl));
          // Taps of B[k][x] for k = 2tq, 2tq + 1, 2tq + 8, 2tq + 9 and x = gq.
          const int dx0 = 16 * (kc0 + kcl) + 2 * tq - gq;
          const int dxs[4] = {dx0, dx0 + 1, dx0 + 8, dx0 + 9};
          bool ok[4];
          int tap[4];  // element offsets in s_k
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ok[e] = (unsigned)dxs[e] < (unsigned)g.ww;
            tap[e] = k_row + (ok[e] ? dxs[e] : 0) * kk;
          }
#pragma unroll
          for (int j = 0; j < kNa; ++j) {
            if (j < na) {
              const uint32_t t0 = ok[0] ? s_k[tap[0] + j] : 0u, t1 = ok[1] ? s_k[tap[1] + j] : 0u;
              const uint32_t t2 = ok[2] ? s_k[tap[2] + j] : 0u, t3 = ok[3] ? s_k[tap[3] + j] : 0u;
              const uint32_t b0 = t0 | (t1 << 16), b1 = t2 | (t3 << 16);
#pragma unroll
              for (int m = 0; m < MT; ++m) mma<T>(acc[m][j], af[m], b0, b1);
            }
          }
        }
      }
    }
  }

  // The block's outputs as (rows, kTx, Kv*Ka) fp32 in shared memory, then
  // each row's 8 * Kv * Ka contiguous floats to device memory.
  __syncthreads();
  float* s_out = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kNa; ++j)
      if (j < na) {
        const int c = v * g.ka + a0 + j;
        const int r = 16 * m + gq, x = 2 * tq;
        s_out[(r * kTx + x) * kk + c] = acc[m][j][0];
        s_out[(r * kTx + x + 1) * kk + c] = acc[m][j][1];
        s_out[((r + 8) * kTx + x) * kk + c] = acc[m][j][2];
        s_out[((r + 8) * kTx + x + 1) * kk + c] = acc[m][j][3];
      }
  __syncthreads();
  const int nx = min(kTx, g.w - x0), ny = min(kRows, g.h - y0);
  const int run = nx * kk;
  for (int r = 0; r < ny; ++r) {
    float* dst = out + (((size_t)b * g.h + y0 + r) * g.w + x0) * kk;
    const float* src = s_out + r * kTx * kk;
    for (int i = threadIdx.x; i < run; i += blockDim.x) dst[i] = src[i];
  }
}

template <typename T, int MT>
int launch(const void* p, const void* kern, void* out, int batch, const Geometry& g,
           cudaStream_t stream) {
  const long long smem = smem_bytes(g, MT);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = mrf_grouped_corr_kernel<T, MT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((g.w + kTx - 1) / kTx), (unsigned)((g.h + 16 * MT - 1) / (16 * MT)),
                  (unsigned)batch);
  kernel<<<grid, 32 * g.kv * g.achunks, smem, stream>>>(
      static_cast<const uint16_t*>(p), static_cast<const uint16_t*>(kern),
      static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace

// p (B, H, W, Kv) and kern (wh, ww, 1, Kv*Ka), contiguous, both bf16
// (half = 0) or both fp16 (half = 1); out (B, H, W, Kv*Ka) fp32.  mt, kcc and
// dyc are the wrapper's tiling (ops/mrf_corr.tiling).
extern "C" int mrf_grouped_corr(const void* p, const void* kern, void* out, int batch, int h,
                                int w, int kv, int ka, int wh, int ww, int half, int mt, int kcc,
                                int dyc, void* stream) {
  if (batch == 0 || h == 0 || w == 0 || kv == 0 || ka == 0) return 0;
  Geometry g{h, w, kv, ka, wh, ww, (ka + kNa - 1) / kNa, (ww + kTx - 1 + 15) / 16, kcc, dyc};
  if (wh < 1 || ww < 1 || batch > 65535 || kv * g.achunks > kMaxWarps || kcc < 1 ||
      kcc > g.kc || dyc < 1 || dyc > wh || (mt != 1 && mt != 2) ||
      (long long)batch * h * w * kv * ka > 0x7fffffffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half)
    return mt == 1 ? launch<__half, 1>(p, kern, out, batch, g, s)
                   : launch<__half, 2>(p, kern, out, batch, g, s);
  return mt == 1 ? launch<__nv_bfloat16, 1>(p, kern, out, batch, g, s)
                 : launch<__nv_bfloat16, 2>(p, kern, out, batch, g, s);
}
