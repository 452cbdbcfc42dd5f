// Fourier head-conv tails: for every column bin g, row bin f, image b and
// output channel o,
//
//   K_f[g,f,i,o] = sum_y gr[f,y] * a[g,y,i,o]          (complex row DFT, Kh taps)
//   R[g,f,b,o]   = sum_i conj(K_f[g,f,i,o]) * X[g,f,b,i]
//   T[y,g,b,o]   = sum_f ir[y,f] * R[g,f,b,o]          (complex inverse row DFT, SAME crop)
//
// written as out (H, 2, G, B, Co) with re at [:, 0] and im at [:, 1].
// Three entries replace the three TPU kernels of jointpose/ops/fft_conv.py:
//
//   fft_conv_tail_kdft_resident  _tail_kdft_resident_kernel: K_f built from `a`
//       in the kernel, once per (g, Co tile), and reused over the whole batch;
//   fft_conv_tail_kdft           _tail_kdft_kernel: the batch tile is a grid
//       dimension and every block rebuilds the K_f rows it needs;
//   fft_conv_tail_kf             _tail_kernel (+ _tail_body): K_f read from
//       device memory, no build.
//
// Inputs, contiguous, T = bf16 or f32 (one type per call):
//   xr, xi   (G, Ph, B, Ci) T   spectrum of the input
//   ar, ai   (G, Kh, Ci, Co) T  column DFT of the kernel   (the two kdft entries)
//   kr, ki   (G, Ph, Ci, Co) T  full kernel spectrum       (the kf entry)
//   gr       (Ph, Kh, 2) f32    row DFT of the kernel taps, (re, im)
//   irt      (Ph, H, 2) f32     inverse row DFT, transposed, (re, im)
//   gpack, irpack  bf16         the same two tables as real block matrices, for
//                               the tensor-core version (below); null in f32
// The tables hold values already rounded to T.  Rounding points, as in the
// TPU kernels: K_f to T after its build, R to T before the inverse row DFT,
// the output once at the end; every sum is f32.  In f32 nothing rounds.
//
// Bound on an H100: bytes for the function as counted (x, a and the output
// once: 0.05 ms at the paper head, batch 8).  The work is 8*Ph*Kh*Ci*Co*G
// flops for the build, 8*Ph*Ci*Co*G*B pointwise and 8*H*Ph*Co*G*B for the
// inverse.  Three versions share the entries, chosen in the entry by a
// rule on the shapes (ops/fft_conv.tail_body repeats it): scalar f32 FMAs
// on the CUDA cores (f32 operands, which must keep full f32 products, and
// bf16 shapes the others do not take), bound by those operations; bf16
// mma.sync on the tensor cores with operands staged through registers
// (further down; the kf entry, and the build form's shapes the ring does
// not take), and the ring version of the build form (last), where the
// loads of the operands from L2 (`a` is re-read per row-bin chunk), the
// barriers of the walk and the waves of one-per-SM blocks take over from
// the arithmetic.
//
// Design of the CUDA-core version.  The TPU keeps a (Ph, Ci, CoT) K_f block
// in VMEM across a sequential batch axis; a block here has 227 KB, and K_f[f,i,o] depends
// only on a[:,i,o], so a K_f entry never needs to be stored at all: a
// thread owns one output channel (its lane) and FPT row bins (its warp),
// builds K_f[f,i,o] in registers from a staged (Kh, 8, 32) chunk of `a`
// and its own gr[f,:] taps, and spends it at once on every image of the
// block (NB accumulators per row bin).  "Resident" means that reuse: the
// resident entry puts the whole batch (up to 16 images) into one block, so
// K_f is built once per (g, Co tile); the kdft entry tiles the batch over
// the grid (up to 8 images a block) and rebuilds.  The TPU's cross-step f32
// accumulator becomes a loop over row-bin chunks inside the block: each
// chunk's R rows are rounded into a (Ph, images, 32) tile in shared memory,
// and after the walk each thread (image = warp, channel = lane) contracts
// its column of that tile with the inverse row table, 10 output rows at a
// time.  K_f and R never reach device memory (in the kf entry K_f is an
// input).  Ragged edges (Co % 32, Ci % 8, Ph % chunk, B % tile, H % 10) are
// masked: staged values are zero and stores are guarded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCoT = 32;      // output channels per block, one per lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTB = 8;        // images per batch tile
constexpr int kCiC = 8;       // input channels per staged chunk
constexpr int kYB = 10;       // output rows per inverse pass
constexpr int kSmemLimit = 232448;

struct TailArgs {
  const void* xr;
  const void* xi;
  const void* kr;  // a_re (build) or K_f re (read)
  const void* ki;
  const float2* gr;
  const float2* irt;
  const void* gpack;   // bf16 tables of the tensor-core version, or null
  const void* irpack;
  void* out;
  int g, ph, b, ci, co, kh, h, tb;
};

__device__ __forceinline__ float ld(const float* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T> struct Pair;
template <> struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ type pack(float re, float im) { return make_float2(re, im); }
  static __device__ __forceinline__ float2 unpack(type v) { return v; }
};
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type pack(float re, float im) {
    return __floats2bfloat162_rn(re, im);
  }
  static __device__ __forceinline__ float2 unpack(type v) { return __bfloat1622float2(v); }
};

// Shared memory of one block, in bytes; the Python wrapper repeats this sum.
__host__ __device__ constexpr long long smem_bytes(int ph, int tb, int khp, int itemsize) {
  return 2LL * kWarps * kCiC * kTB * (long long)sizeof(float2)  // X chunk (FPT * NT == 2)
         + 2LL * khp * kCiC * kCoT * (long long)sizeof(float)      // a chunk, re and im
         + (long long)ph * kYB * (long long)sizeof(float2)         // inverse table slice
         + (long long)ph * tb * kCoT * 2 * itemsize;               // R tile
}

// KHP: kernel taps the build is unrolled for (kh <= KHP, the rest are zero).
// FPT: row bins per thread and chunk.  NT: batch tiles of 8 held per thread.
// BUILD: K_f from `a` (true) or from memory (false).
template <typename T, int KHP, int FPT, int NT, bool BUILD>
__global__ void __launch_bounds__(kThreads) tail_kernel(TailArgs p) {
  constexpr int FB = kWarps * FPT;  // row bins per chunk
  constexpr int NB = kTB * NT;      // images per thread
  static_assert(FPT * NT == 2, "the X chunk is sized for FPT * NT == 2");
  using P = Pair<T>;
  using RT = typename P::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* x_s = reinterpret_cast<float2*>(smem_raw);            // (FB, kCiC, NB)
  float* a_re_s = reinterpret_cast<float*>(x_s + FB * kCiC * NB);  // (KHP, kCiC, kCoT)
  float* a_im_s = a_re_s + (BUILD ? KHP * kCiC * kCoT : 0);
  float2* ir_s = reinterpret_cast<float2*>(a_im_s + (BUILD ? KHP * kCiC * kCoT : 0));  // (Ph, kYB)
  RT* r_s = reinterpret_cast<RT*>(ir_s + p.ph * kYB);           // (Ph, tb, kCoT)

  const T* xr = static_cast<const T*>(p.xr);
  const T* xi = static_cast<const T*>(p.xi);
  const T* kr = static_cast<const T*>(p.kr);
  const T* ki = static_cast<const T*>(p.ki);
  T* out = static_cast<T*>(p.out);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int co0 = blockIdx.x * kCoT;
  const int co = co0 + lane;
  const int g = blockIdx.y;
  const int b0 = blockIdx.z * p.tb;
  const int nimg = min(p.tb, p.b - b0);
  const int ph = p.ph, ci = p.ci, n_co = p.co, kh = p.kh, tb = p.tb;

  for (int f0 = 0; f0 < ph; f0 += FB) {
    float2 acc[FPT][NB];
#pragma unroll
    for (int j = 0; j < FPT; ++j)
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) acc[j][bb] = make_float2(0.f, 0.f);

    // This thread's row-DFT taps gr[f, :] for its FPT row bins.
    float2 taps[BUILD ? FPT : 1][BUILD ? KHP : 1];
    if constexpr (BUILD) {
#pragma unroll
      for (int j = 0; j < FPT; ++j) {
        const int f = f0 + warp + kWarps * j;
#pragma unroll
        for (int y = 0; y < KHP; ++y)
          taps[j][y] = (f < ph && y < kh) ? __ldg(p.gr + f * kh + y) : make_float2(0.f, 0.f);
      }
    }

    for (int c0 = 0; c0 < ci; c0 += kCiC) {
      __syncthreads();  // the previous chunk has been consumed
      for (int idx = tid; idx < FB * NB * kCiC; idx += kThreads) {
        const int c = idx % kCiC;
        const int bb = (idx / kCiC) % NB;
        const int fr = idx / (kCiC * NB);
        const int f = f0 + fr;
        float2 v = make_float2(0.f, 0.f);
        if (f < ph && bb < nimg && c0 + c < ci) {
          const size_t off = ((size_t)(g * ph + f) * p.b + (b0 + bb)) * ci + (c0 + c);
          v = make_float2(ld(xr, off), ld(xi, off));
        }
        x_s[(fr * kCiC + c) * NB + bb] = v;
      }
      if constexpr (BUILD) {
        for (int idx = tid; idx < KHP * kCiC * kCoT; idx += kThreads) {
          const int l = idx % kCoT;
          const int c = (idx / kCoT) % kCiC;
          const int y = idx / (kCoT * kCiC);
          float re = 0.f, im = 0.f;
          if (y < kh && c0 + c < ci && co0 + l < n_co) {
            const size_t off = ((size_t)(g * kh + y) * ci + (c0 + c)) * n_co + (co0 + l);
            re = ld(kr, off);
            im = ld(ki, off);
          }
          a_re_s[idx] = re;
          a_im_s[idx] = im;
        }
      }
      __syncthreads();

#pragma unroll
      for (int c = 0; c < kCiC; ++c) {
        float k_re[FPT], k_im[FPT];
        if constexpr (BUILD) {
#pragma unroll
          for (int j = 0; j < FPT; ++j) k_re[j] = k_im[j] = 0.f;
#pragma unroll
          for (int y = 0; y < KHP; ++y) {
            const float a_re = a_re_s[(y * kCiC + c) * kCoT + lane];
            const float a_im = a_im_s[(y * kCiC + c) * kCoT + lane];
#pragma unroll
            for (int j = 0; j < FPT; ++j) {
              k_re[j] = fmaf(taps[j][y].x, a_re, k_re[j]);
              k_re[j] = fmaf(-taps[j][y].y, a_im, k_re[j]);
              k_im[j] = fmaf(taps[j][y].x, a_im, k_im[j]);
              k_im[j] = fmaf(taps[j][y].y, a_re, k_im[j]);
            }
          }
#pragma unroll
          for (int j = 0; j < FPT; ++j) {
            k_re[j] = round_to(k_re[j], T());
            k_im[j] = round_to(k_im[j], T());
          }
        } else {
#pragma unroll
          for (int j = 0; j < FPT; ++j) {
            const int f = f0 + warp + kWarps * j;
            k_re[j] = k_im[j] = 0.f;
            if (f < ph && c0 + c < ci && co < n_co) {
              const size_t off = ((size_t)(g * ph + f) * ci + (c0 + c)) * n_co + co;
              k_re[j] = ld(kr, off);
              k_im[j] = ld(ki, off);
            }
          }
        }
        // R += conj(K_f) * X for every image of the block.
#pragma unroll
        for (int j = 0; j < FPT; ++j) {
          const float4* xp =
              reinterpret_cast<const float4*>(x_s + ((warp + kWarps * j) * kCiC + c) * NB);
#pragma unroll
          for (int bb = 0; bb < NB; bb += 2) {
            const float4 x = xp[bb / 2];  // (re, im) of images bb and bb + 1
            acc[j][bb].x = fmaf(x.x, k_re[j], acc[j][bb].x);
            acc[j][bb].x = fmaf(x.y, k_im[j], acc[j][bb].x);
            acc[j][bb].y = fmaf(x.y, k_re[j], acc[j][bb].y);
            acc[j][bb].y = fmaf(-x.x, k_im[j], acc[j][bb].y);
            acc[j][bb + 1].x = fmaf(x.z, k_re[j], acc[j][bb + 1].x);
            acc[j][bb + 1].x = fmaf(x.w, k_im[j], acc[j][bb + 1].x);
            acc[j][bb + 1].y = fmaf(x.w, k_re[j], acc[j][bb + 1].y);
            acc[j][bb + 1].y = fmaf(-x.z, k_im[j], acc[j][bb + 1].y);
          }
        }
      }
    }

    // The chunk's R rows, rounded to T, wait in shared memory.
#pragma unroll
    for (int j = 0; j < FPT; ++j) {
      const int f = f0 + warp + kWarps * j;
      if (f < ph) {
#pragma unroll
        for (int bb = 0; bb < NB; ++bb)
          if (bb < tb) r_s[(f * tb + bb) * kCoT + lane] = P::pack(acc[j][bb].x, acc[j][bb].y);
      }
    }
  }

  // Inverse row DFT: thread = (image, channel), kYB output rows a pass.
  const int h = p.h;
  for (int y0 = 0; y0 < h; y0 += kYB) {
    __syncthreads();  // R is complete; the previous table slice has been consumed
    for (int idx = tid; idx < ph * kYB; idx += kThreads) {
      const int f = idx / kYB;
      const int y = min(y0 + idx % kYB, h - 1);
      ir_s[idx] = __ldg(p.irt + (size_t)f * h + y);
    }
    __syncthreads();
    for (int bb = warp; bb < nimg; bb += kWarps) {
      float t_re[kYB], t_im[kYB];
#pragma unroll
      for (int j = 0; j < kYB; ++j) t_re[j] = t_im[j] = 0.f;
      for (int f = 0; f < ph; ++f) {
        const float2 r = P::unpack(r_s[(f * tb + bb) * kCoT + lane]);
#pragma unroll
        for (int j = 0; j < kYB; ++j) {
          const float2 c = ir_s[f * kYB + j];
          t_re[j] = fmaf(c.x, r.x, t_re[j]);
          t_re[j] = fmaf(-c.y, r.y, t_re[j]);
          t_im[j] = fmaf(c.x, r.y, t_im[j]);
          t_im[j] = fmaf(c.y, r.x, t_im[j]);
        }
      }
      if (co < n_co) {
#pragma unroll
        for (int j = 0; j < kYB; ++j) {
          const int y = y0 + j;
          if (y < h) {
            const size_t base = (((size_t)y * 2 * p.g + g) * p.b + (b0 + bb)) * n_co + co;
            st(out, base, t_re[j]);
            st(out, base + (size_t)p.g * p.b * n_co, t_im[j]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core version (mma.sync m16n8k16, f32 accumulation), taken
// when Ci % 16 == 0, Co % 32 == 0, kh <= 9 and at most 8 images a block.
// The three stages are matrix products with natural operand layouts
// (channels fastest everywhere; ldmatrix.trans feeds the B operands):
//
//   build      [K_re | K_im](16 f, 16 ci x 32 co) = Gpack(16 f, 32) . a'(32, 16 ci x 32 co)
//              a' stacks a_re (taps 0..8) over a_im (taps 9..17), zero above;
//              Gpack rows are [gr_re, -gr_im] and [gr_im, gr_re]: the complex
//              row DFT as one real product.  K_f rounds to bf16 into shared memory.
//   pointwise  per row bin f: [xr; xi](16, 16 ci) . K_re(16 ci, 32 co) and . K_im:
//              rows 0..7 are the images' re parts, 8..15 their im parts, so one
//              thread holds both halves of a column and forms
//              R_re = xr.kr + xi.ki, R_im = xi.kr - xr.ki in registers.
//   inverse    [T_re; T_im](2H, 8 b x 32 co) = IRpack(2H, 2Ph) . [R_re; R_im](2Ph, 8 b x 32 co)
//              IRpack rows are [ir_re, -ir_im] and [ir_im, ir_re].
//
// One block owns (g, 32 channels, up to 8 images); a warp owns two of the 16
// row bins of a chunk in the pointwise stage, two input channels in the
// build, one image in the inverse.  K_f is spent once per block (the
// pointwise products have only 16 rows), so what bounds this version is not
// the tensor cores but the operands' way to them: the a' chunk is re-read
// from L2 for each of the Ph/16 row-bin chunks, every step passes its
// operands through shared memory, and three block-wide barriers separate a
// step's stages at one block per SM (the R tile takes 94 KB at the paper
// head).  The next step's operands are fetched into registers during the
// current one to hide the L2 latency.  profile_tail_stages.py times the
// kernel with each stage cut out.
constexpr int kMmaCi = 16;                          // input channels per step
constexpr int kMmaF = 16;                           // row bins per chunk
constexpr int kMmaKp = 32;                          // padded taps of a'
constexpr int kARow = kMmaCi * kCoT * 2 + 16;       // bytes per tap row of a'
constexpr int kKCi = kCoT * 2 + 16;                 // bytes per ci row of K_f
constexpr int kKF = kMmaCi * kKCi + 16;             // bytes per row bin of K_f
constexpr int kKPart = kMmaF * kKF;                 // bytes of K_re (K_im follows)
constexpr int kRImg = kCoT + 8;                     // R columns per image (32 + pad)
constexpr int kRRow = kTB * kRImg * 2 + 16;         // bytes per row of R

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr long long mma_smem_bytes(int ph, bool build) {
  return (build ? (long long)kMmaKp * kARow : 0) + 2LL * kKPart +
         (long long)round_up(2 * ph, 16) * kRRow;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Four 8x8 b16 matrices, transposed: lane l gives the address of row l % 8 of
// matrix l / 8; r[m] then holds elements (2 * (lane % 4) + {0, 1}, lane / 4) of
// matrix m: the B fragment of a (k, n) row-major tile.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const unsigned char* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

struct MmaArgs {
  const __nv_bfloat16* xr;
  const __nv_bfloat16* xi;
  const __nv_bfloat16* kr;      // a_re (build) or K_f re (read)
  const __nv_bfloat16* ki;
  const __nv_bfloat16* gpack;   // (round_up(Ph, 16), 2, 32)
  const __nv_bfloat16* irpack;  // (round_up(2H, 32), round_up(2Ph, 16))
  __nv_bfloat16* out;
  int g, ph, b, ci, co, kh, h, tb;
};

template <bool BUILD>
__global__ void __launch_bounds__(kThreads) tail_mma_kernel(MmaArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* a_s = smem_raw;                                   // (32 taps, 16 ci, 32 co)
  unsigned char* k_s = a_s + (BUILD ? kMmaKp * kARow : 0);         // (2, 16 f, 16 ci, 32 co)
  unsigned char* r_s = k_s + 2 * kKPart;                           // (2Ph, 8 b, 32 co)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // fragment row group
  const int tq = lane & 3;   // fragment column pair
  const int co0 = blockIdx.x * kCoT;
  const int g = blockIdx.y;
  const int b0 = blockIdx.z * p.tb;
  const int nimg = min(p.tb, p.b - b0);
  const int ph = p.ph, ci = p.ci, n_co = p.co, kh = p.kh, h = p.h;
  const int kp = round_up(2 * ph, 16);

  // Zero the padded tap rows of a' and the padded rows of R once.
  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    const int n16 = (int)(((BUILD ? kMmaKp * kARow : 0) + 2 * kKPart + kp * kRRow) / 16);
    for (int i = tid; i < n16; i += kThreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  // One step = (row-bin chunk f0, input-channel chunk c0).  The next step's
  // operands (the a' or K_f chunk, and this warp's X fragments) are fetched
  // into registers while the current step computes.
  constexpr int kStage = BUILD ? 5 : 8;  // 16 B copies a thread per step
  const int nc = ci / kMmaCi;
  const int nsteps = (ph + kMmaF - 1) / kMmaF * nc;
  uint4 stage[kStage];
  uint32_t xnext[2][4];
  auto fetch = [&](int step) {
    const int f0 = step / nc * kMmaF, c0 = step % nc * kMmaCi;
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int u = tid + i * kThreads;
      const int q = u & 3;
      const int c = (u >> 2) % kMmaCi;
      stage[i] = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (BUILD) {
        // a' chunk: tap rows y (re) and 9 + y (im), 16 ci x 32 co each.
        const int row = u / (4 * kMmaCi);
        if (row < 2 * kh) {
          const int part = row >= kh, y = row - part * kh;
          const __nv_bfloat16* src = (part ? p.ki : p.kr) +
                                     ((size_t)(g * kh + y) * ci + (c0 + c)) * n_co + co0 + q * 8;
          stage[i] = __ldg(reinterpret_cast<const uint4*>(src));
        }
      } else {
        // K_f chunk from memory: (part, f, ci) rows of 32 channels.
        const int fl = (u / (4 * kMmaCi)) % kMmaF;
        const int part = u / (4 * kMmaCi * kMmaF);
        if (f0 + fl < ph) {
          const __nv_bfloat16* src = (part ? p.ki : p.kr) +
                                     ((size_t)(g * ph + f0 + fl) * ci + (c0 + c)) * n_co + co0 + q * 8;
          stage[i] = __ldg(reinterpret_cast<const uint4*>(src));
        }
      }
    }
    // X fragments of this warp's two row bins: rows 0..7 = xr[b], 8..15 = xi[b].
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int f = f0 + warp + kWarps * j;
#pragma unroll
      for (int e = 0; e < 4; ++e) xnext[j][e] = 0u;
      if (f < ph && gq < nimg) {
        const size_t off = ((size_t)(g * ph + f) * p.b + (b0 + gq)) * ci + c0 + 2 * tq;
        xnext[j][0] = ldg_u32(p.xr + off);
        xnext[j][1] = ldg_u32(p.xi + off);
        xnext[j][2] = ldg_u32(p.xr + off + 8);
        xnext[j][3] = ldg_u32(p.xi + off + 8);
      }
    }
  };
  auto commit = [&]() {
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int u = tid + i * kThreads;
      const int q = u & 3;
      const int c = (u >> 2) % kMmaCi;
      if constexpr (BUILD) {
        const int row = u / (4 * kMmaCi);
        if (row < 2 * kh) {
          const int part = row >= kh, y = row - part * kh;
          *reinterpret_cast<uint4*>(a_s + (part * 9 + y) * kARow + c * (kCoT * 2) + q * 16) = stage[i];
        }
      } else {
        const int fl = (u / (4 * kMmaCi)) % kMmaF;
        const int part = u / (4 * kMmaCi * kMmaF);
        *reinterpret_cast<uint4*>(k_s + part * kKPart + fl * kKF + c * kKCi + q * 16) = stage[i];
      }
    }
  };

  uint32_t ga[2][2][4];
  float acc_r[2][4][4], acc_i[2][4][4];
  fetch(0);
  for (int step = 0; step < nsteps; ++step) {
    const int f0 = step / nc * kMmaF;
    const bool first = step % nc == 0, last = step % nc == nc - 1;
    if (first) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc_r[j][n][e] = acc_i[j][n][e] = 0.f;
      if constexpr (BUILD) {
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const __nv_bfloat16* lo =
                p.gpack + ((size_t)(f0 + gq) * 2 + part) * kMmaKp + ks * 16 + 2 * tq;
            const __nv_bfloat16* hi = lo + 8 * 2 * kMmaKp;
            ga[part][ks][0] = ldg_u32(lo);
            ga[part][ks][1] = ldg_u32(hi);
            ga[part][ks][2] = ldg_u32(lo + 8);
            ga[part][ks][3] = ldg_u32(hi + 8);
          }
      }
    }
    __syncthreads();  // the previous step's a' and K_f have been consumed
    commit();
    uint32_t xa[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xa[j][e] = xnext[j][e];
    if (step + 1 < nsteps) fetch(step + 1);
    __syncthreads();
    if constexpr (BUILD) {
      // Build: this warp's two input channels, four 8-channel tiles each.
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int c = 2 * warp + cc;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, a_s + lane * kARow + c * (kCoT * 2) + n * 16);
          float k_re[4] = {0.f, 0.f, 0.f, 0.f}, k_im[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(k_re, ga[0][0], bf[0], bf[1]);
          mma_bf16(k_re, ga[0][1], bf[2], bf[3]);
          mma_bf16(k_im, ga[1][0], bf[0], bf[1]);
          mma_bf16(k_im, ga[1][1], bf[2], bf[3]);
          unsigned char* dst = k_s + gq * kKF + c * kKCi + (n * 8 + 2 * tq) * 2;
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(k_re[0], k_re[1]);
          *reinterpret_cast<uint32_t*>(dst + 8 * kKF) = pack_bf16(k_re[2], k_re[3]);
          *reinterpret_cast<uint32_t*>(dst + kKPart) = pack_bf16(k_im[0], k_im[1]);
          *reinterpret_cast<uint32_t*>(dst + kKPart + 8 * kKF) = pack_bf16(k_im[2], k_im[3]);
        }
      }
      __syncthreads();
    }

    // Pointwise: this warp's two row bins against K_re and K_im.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int fl = warp + kWarps * j;
      // lane -> matrix m = lane / 8: ci rows (m & 1) * 8 + lane % 8, channel tile m >> 1.
      const unsigned char* kbase = k_s + fl * kKF + (((lane >> 3) & 1) * 8 + (lane & 7)) * kKCi +
                                   (lane >> 4) * 16;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, kbase + np * 32);
        mma_bf16(acc_r[j][2 * np], xa[j], bf[0], bf[1]);
        mma_bf16(acc_r[j][2 * np + 1], xa[j], bf[2], bf[3]);
        ldsm_x4_trans(bf, kbase + kKPart + np * 32);
        mma_bf16(acc_i[j][2 * np], xa[j], bf[0], bf[1]);
        mma_bf16(acc_i[j][2 * np + 1], xa[j], bf[2], bf[3]);
      }
    }

    if (last) {
      // R = conj(K_f) . X, rounded to bf16: rows f (re) and Ph + f (im).
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int f = f0 + warp + kWarps * j;
        if (f < ph) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            unsigned char* dst = r_s + f * kRRow + (gq * kRImg + n * 8 + 2 * tq) * 2;
            *reinterpret_cast<uint32_t*>(dst) =
                pack_bf16(acc_r[j][n][0] + acc_i[j][n][2], acc_r[j][n][1] + acc_i[j][n][3]);
            *reinterpret_cast<uint32_t*>(dst + ph * kRRow) =
                pack_bf16(acc_r[j][n][2] - acc_i[j][n][0], acc_r[j][n][3] - acc_i[j][n][1]);
          }
        }
      }
    }
  }
  __syncthreads();

  // Inverse row DFT: this warp's image, 32 channels, two 16-row tiles a pass.
  const int bimg = warp;
  const int m_tiles = round_up(2 * h, 32) / 16;
  const unsigned char* rbase = r_s + (((lane >> 3) & 1) * 8 + (lane & 7)) * kRRow +
                               (bimg * kRImg + (lane >> 4) * 8) * 2;
  for (int mt = 0; mt < m_tiles; mt += 2) {
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
    for (int ks = 0; ks < kp / 16; ++ks) {
      uint32_t ia[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* lo = p.irpack + (size_t)((mt + i) * 16 + gq) * kp + ks * 16 + 2 * tq;
        const __nv_bfloat16* hi = lo + (size_t)8 * kp;
        ia[i][0] = ldg_u32(lo);
        ia[i][1] = ldg_u32(hi);
        ia[i][2] = ldg_u32(lo + 8);
        ia[i][3] = ldg_u32(hi + 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, rbase + ks * 16 * kRRow + np * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * np], ia[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * np + 1], ia[i], bf[2], bf[3]);
        }
      }
    }
    if (bimg < nimg) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = (mt + i) * 16 + gq + 8 * half;
          if (m < 2 * h) {
            const int part = m >= h, y = m - part * h;
            __nv_bfloat16* dst = p.out + ((((size_t)y * 2 + part) * p.g + g) * p.b + (b0 + bimg)) * n_co +
                                 co0 + 2 * tq;
#pragma unroll
            for (int n = 0; n < 4; ++n)
              *reinterpret_cast<uint32_t*>(dst + n * 8) =
                  pack_bf16(acc[i][n][2 * half], acc[i][n][2 * half + 1]);
          }
        }
    }
  }
}

// ---------------------------------------------------------------------------
// The ring version of the build form (the two kdft entries, bf16), taken
// ahead of tail_mma_kernel<true> on the shapes it takes.  Cut out one stage
// at a time, the register-staged version spends its time on the loads of
// the next step's operands, the K_f build and the inverse row DFT: one
// step's loads go global -> registers -> shared behind three block-wide
// barriers at 8 warps an SM, the build pads its 18 taps to 32, and the
// inverse reads its table from global memory per k-step.  Here:
//   - every thread issues cp.async copies into a 3-stage shared-memory ring
//     (the a' chunk and the X tiles of one step, zero-filled where ragged),
//     two steps ahead, so a step's loads are in flight for two steps; two
//     barriers a step;
//   - 16 warps (one block of 512 threads an SM): warp w builds input
//     channel w of the step and spends row bin w of the chunk, so a step
//     has exactly one build tile column and one pointwise row bin per warp;
//   - the build's taps are 16 + 8 (m16n8k16 and m16n8k8), not 32;
//   - X reaches the pointwise product through ldmatrix from a swizzled tile;
//   - the inverse row table is staged once per block into the ring, which
//     is free after the walk.
// The order of the walk stays row-bin chunk outer: R for all row bins of a
// (g, 32-channel) tile is 160 KB in f32, more than registers or shared
// memory hold beside the ring, so the a' chunk is still read once per
// row-bin chunk (from L2).  Rounding points and the f32 sums are those of
// the register-staged version; the sums run in another order.
constexpr int kRingWarps = 16;
constexpr int kRingThreads = kRingWarps * 32;
constexpr int kRingStages = 3;
constexpr int kRingTaps = 24;                         // a' rows: re 0..8, im 9..17, zero 18..23
constexpr int kXTile = 16 * 32;                        // one row bin's X: 16 rows x 16 ci
constexpr int kAStage = kRingTaps * kARow;
constexpr int kRingStage = kAStage + kMmaF * kXTile;
constexpr int kRRowRing = kTB * kCoT * 2 + 16;         // bytes per row of R (8 images x 32 co)
static_assert(kMmaF * 16 * 2 == kRingThreads, "one 16-byte X copy a thread and step");
static_assert(kMmaCi == kRingWarps && kMmaF == kRingWarps, "a warp per channel and row bin");

__host__ __device__ constexpr long long ring_region_bytes(int ph, int h) {
  const long long ring = (long long)kRingStages * kRingStage;
  const long long table = (long long)round_up(2 * h, 32) * (round_up(2 * ph, 16) * 2 + 16);
  return ring > table ? ring : table;
}
__host__ __device__ constexpr long long ring_smem_bytes(int ph, int h) {
  return ring_region_bytes(ph, h) + 2LL * kKPart + (long long)round_up(2 * ph, 16) * kRRowRing +
         (long long)round_up(ph, 16) * 2 * kMmaKp * 2;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const unsigned char* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__global__ void __launch_bounds__(kRingThreads, 1) tail_ring_kernel(MmaArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ph = p.ph, ci = p.ci, n_co = p.co, kh = p.kh, h = p.h;
  const int kp = round_up(2 * ph, 16);
  unsigned char* ring = smem_raw;  // the ring; after the walk, the inverse table
  unsigned char* k_s = ring + ring_region_bytes(ph, h);  // (2, 16 f, 16 ci, 32 co)
  unsigned char* r_s = k_s + 2 * kKPart;                  // (kp rows, 8 b, 32 co)
  unsigned char* g_s = r_s + kp * kRRowRing;              // Gpack (Ph up to 16, 2, 32 taps)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int co0 = blockIdx.x * kCoT;
  const int g = blockIdx.y;
  const int b0 = blockIdx.z * p.tb;
  const int nimg = min(p.tb, p.b - b0);

  // R's padded rows are read by the inverse (against zero table columns),
  // and the a' rows of taps past kh and rows 18..23 of every stage by the
  // build (against zero Gpack columns): all zero once, never written.
  for (int i = tid; i < kp * kRRowRing / 16; i += kRingThreads)
    reinterpret_cast<uint4*>(r_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kRingStages * kRingTaps * (kARow / 16); i += kRingThreads) {
    const int stage = i / (kRingTaps * (kARow / 16));
    const int rem = i - stage * (kRingTaps * (kARow / 16));
    const int row = rem / (kARow / 16);
    if (row >= 18 || row - 9 * (row >= 9) >= kh)
      reinterpret_cast<uint4*>(ring + stage * kRingStage + row * kARow)[rem - row * (kARow / 16)] =
          make_uint4(0u, 0u, 0u, 0u);
  }

  const int nc = ci / kMmaCi;
  const int nsteps = (ph + kMmaF - 1) / kMmaF * nc;
  // Copies of one step, fixed per thread up to the step's (f0, c0): up to
  // three 16-byte pieces of the a' chunk (rows re 0..kh-1 and im 9..8+kh of
  // 16 ci x 32 co) and one of the X tiles of 16 row bins (rows 0..7 xr of
  // the block's images, 8..15 xi; the two 16-byte halves of a row swapped
  // on rows 4..7 and 12..15, so that ldmatrix meets no bank twice).  Ragged
  // row bins and images are zero-filled.
  constexpr int kACopies = (18 * kMmaCi * 4 + kRingThreads - 1) / kRingThreads;
  const __nv_bfloat16* a_src[kACopies];
  int a_dst[kACopies];
#pragma unroll
  for (int k = 0; k < kACopies; ++k) {
    const int u = tid + k * kRingThreads;
    const int q = u & 3, c = (u >> 2) & 15, row = u >> 6;
    const int part = row >= 9, y = row - 9 * part;
    a_dst[k] = row < 18 && y < kh ? row * kARow + c * (kCoT * 2) + q * 16 : -1;
    a_src[k] = (part ? p.ki : p.kr) + ((size_t)(g * kh + (a_dst[k] < 0 ? 0 : y)) * ci + c) * n_co +
               co0 + q * 8;
  }
  const int x_half = tid & 1, x_r = (tid >> 1) & 15, x_fl = tid >> 5;
  const bool x_img = (x_r & 7) < nimg;
  const __nv_bfloat16* x_src =
      (x_r >> 3 ? p.xi : p.xr) + ((size_t)(g * ph + x_fl) * p.b + b0 + (x_img ? x_r & 7 : 0)) * ci +
      x_half * 8;
  const int x_dst = kAStage + x_fl * kXTile + x_r * 32 + (x_half ^ ((x_r >> 2) & 1)) * 16;
  auto issue = [&](int step) {
    unsigned char* st = ring + (step % kRingStages) * kRingStage;
    const int f0 = step / nc * kMmaF, c0 = step % nc * kMmaCi;
#pragma unroll
    for (int k = 0; k < kACopies; ++k)
      if (a_dst[k] >= 0) cp_async16(st + a_dst[k], a_src[k] + (size_t)c0 * n_co, true);
    const bool valid = x_img && f0 + x_fl < ph;
    cp_async16(st + x_dst, valid ? x_src + ((size_t)f0 * p.b * ci + c0) : p.xr, valid);
  };

  // Gpack rides with the first step's copies, read from shared memory at
  // the start of each row-bin chunk.
  for (int u = tid; u < round_up(ph, 16) * 2 * kMmaKp * 2 / 16; u += kRingThreads)
    cp_async16(g_s + u * 16, p.gpack + u * 8, true);
  for (int s = 0; s < kRingStages - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }
  uint32_t ga[2][4], gb[2][2];  // Gpack rows of the chunk: taps 0..15, taps 16..23
  float acc_r[4][4], acc_i[4][4];
  for (int step = 0; step < nsteps; ++step) {
    const int f0 = step / nc * kMmaF;
    const bool first = step % nc == 0, last = step % nc == nc - 1;
    cp_async_wait<kRingStages - 2>();
    __syncthreads();  // this step's operands have landed; the last step's K_f is spent
    if (step + kRingStages - 1 < nsteps) issue(step + kRingStages - 1);
    cp_async_commit();
    if (first) {
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const uint32_t* lo = reinterpret_cast<const uint32_t*>(
            g_s + (((f0 + gq) * 2 + part) * kMmaKp + 2 * tq) * 2);
        const uint32_t* hi = lo + 8 * 2 * kMmaKp / 2;
        ga[part][0] = lo[0];
        ga[part][1] = hi[0];
        ga[part][2] = lo[4];
        ga[part][3] = hi[4];
        gb[part][0] = lo[8];
        gb[part][1] = hi[8];
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_r[n][e] = acc_i[n][e] = 0.f;
    }
    const unsigned char* a_st = ring + (step % kRingStages) * kRingStage;
    const unsigned char* x_st = a_st + kAStage;

    // Build: input channel `warp` of the step, four 8-channel tiles.
    const int trow = lane < 24 ? lane : lane - 8;  // lanes 24..31 repeat taps 16..23
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, a_st + trow * kARow + warp * (kCoT * 2) + n * 16);
      float k_re[4] = {0.f, 0.f, 0.f, 0.f}, k_im[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(k_re, ga[0], bf[0], bf[1]);
      mma_bf16_k8(k_re, gb[0][0], gb[0][1], bf[2]);
      mma_bf16(k_im, ga[1], bf[0], bf[1]);
      mma_bf16_k8(k_im, gb[1][0], gb[1][1], bf[2]);
      unsigned char* dst = k_s + gq * kKF + warp * kKCi + (n * 8 + 2 * tq) * 2;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(k_re[0], k_re[1]);
      *reinterpret_cast<uint32_t*>(dst + 8 * kKF) = pack_bf16(k_re[2], k_re[3]);
      *reinterpret_cast<uint32_t*>(dst + kKPart) = pack_bf16(k_im[0], k_im[1]);
      *reinterpret_cast<uint32_t*>(dst + kKPart + 8 * kKF) = pack_bf16(k_im[2], k_im[3]);
    }
    __syncthreads();  // K_f of the step is complete

    // Pointwise: row bin `warp` of the chunk against K_re and K_im.
    {
      uint32_t xa[4];
      const int r = (lane & 7) + ((lane >> 3) & 1) * 8, half = lane >> 4;
      ldsm_x4(xa, x_st + warp * kXTile + r * 32 + (half ^ ((r >> 2) & 1)) * 16);
      const unsigned char* kf_base = k_s + warp * kKF +
                                   (((lane >> 3) & 1) * 8 + (lane & 7)) * kKCi + (lane >> 4) * 16;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, kf_base + np * 32);
        mma_bf16(acc_r[2 * np], xa, bf[0], bf[1]);
        mma_bf16(acc_r[2 * np + 1], xa, bf[2], bf[3]);
        ldsm_x4_trans(bf, kf_base + kKPart + np * 32);
        mma_bf16(acc_i[2 * np], xa, bf[0], bf[1]);
        mma_bf16(acc_i[2 * np + 1], xa, bf[2], bf[3]);
      }
    }
    if (last) {
      // R = conj(K_f) . X, rounded to bf16: rows f (re) and Ph + f (im).
      const int f = f0 + warp;
      if (f < ph) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          unsigned char* dst = r_s + f * kRRowRing + (gq * kCoT + n * 8 + 2 * tq) * 2;
          *reinterpret_cast<uint32_t*>(dst) =
              pack_bf16(acc_r[n][0] + acc_i[n][2], acc_r[n][1] + acc_i[n][3]);
          *reinterpret_cast<uint32_t*>(dst + ph * kRRowRing) =
              pack_bf16(acc_r[n][2] - acc_i[n][0], acc_r[n][3] - acc_i[n][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // R is complete and the ring is free

  // The inverse table into the ring, rows padded by 16 bytes.
  const int ir_rows = round_up(2 * h, 32), ir_row = kp * 2 + 16, chunks = kp / 8;
  for (int u = tid; u < ir_rows * chunks; u += kRingThreads) {
    const int r = u / chunks, q = u - r * chunks;
    cp_async16(ring + r * ir_row + q * 16, p.irpack + (size_t)r * kp + q * 8, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Inverse row DFT: warp = (image, half of the 32-row pairs of 2H).
  const int bimg = warp & 7, mh = warp >> 3;
  const unsigned char* rbase = r_s + (((lane >> 3) & 1) * 8 + (lane & 7)) * kRRowRing +
                               (bimg * kCoT + (lane >> 4) * 8) * 2;
  const unsigned char* ibase =
      ring + ((lane & 7) + ((lane >> 3) & 1) * 8) * ir_row + (lane >> 4) * 16;
  for (int pair = mh; pair < ir_rows / 32; pair += 2) {
    const int mt = 2 * pair;
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
    for (int ks = 0; ks < kp / 16; ++ks) {
      uint32_t ia[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldsm_x4(ia[i], ibase + (mt + i) * 16 * ir_row + ks * 32);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, rbase + ks * 16 * kRRowRing + np * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * np], ia[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * np + 1], ia[i], bf[2], bf[3]);
        }
      }
    }
    if (bimg < nimg) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = (mt + i) * 16 + gq + 8 * half;
          if (m < 2 * h) {
            const int part = m >= h, y = m - part * h;
            __nv_bfloat16* dst = p.out + ((((size_t)y * 2 + part) * p.g + g) * p.b + (b0 + bimg)) * n_co +
                                 co0 + 2 * tq;
#pragma unroll
            for (int n = 0; n < 4; ++n)
              *reinterpret_cast<uint32_t*>(dst + n * 8) =
                  pack_bf16(acc[i][n][2 * half], acc[i][n][2 * half + 1]);
          }
        }
    }
  }
}

// Whether the ring version takes the call: the tensor-core version's
// shapes whose ring, K_f chunk and R tile fit one block.
bool ring_takes(const TailArgs& p, int itemsize) {
  return itemsize == 2 && p.gpack != nullptr && p.ci % kMmaCi == 0 && p.co % kCoT == 0 &&
         p.tb <= kTB && p.kh <= 9 && ring_smem_bytes(p.ph, p.h) <= kSmemLimit;
}

int launch_ring(const TailArgs& p, cudaStream_t stream) {
  if (p.g == 0 || p.b == 0 || p.co == 0 || p.h == 0) return 0;
  using B = __nv_bfloat16;
  const MmaArgs m{static_cast<const B*>(p.xr), static_cast<const B*>(p.xi),
                  static_cast<const B*>(p.kr), static_cast<const B*>(p.ki),
                  static_cast<const B*>(p.gpack), static_cast<const B*>(p.irpack),
                  static_cast<B*>(p.out), p.g, p.ph, p.b, p.ci, p.co, p.kh, p.h, p.tb};
  const long long smem = ring_smem_bytes(p.ph, p.h);
  cudaError_t err = cudaFuncSetAttribute(tail_ring_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.co / kCoT, p.g, (p.b + p.tb - 1) / p.tb);
  tail_ring_kernel<<<grid, kRingThreads, smem, stream>>>(m);
  return (int)cudaGetLastError();
}

// Whether the tensor-core version takes the call.
bool mma_takes(const TailArgs& p, int itemsize, bool build) {
  return itemsize == 2 && p.gpack != nullptr && p.ci % kMmaCi == 0 && p.co % kCoT == 0 &&
         p.tb <= kTB && (!build || p.kh <= 9) && mma_smem_bytes(p.ph, build) <= kSmemLimit;
}

template <bool BUILD>
int launch_mma(const TailArgs& p, cudaStream_t stream) {
  if (p.g == 0 || p.b == 0 || p.co == 0 || p.h == 0) return 0;
  using B = __nv_bfloat16;
  const MmaArgs m{static_cast<const B*>(p.xr), static_cast<const B*>(p.xi),
                  static_cast<const B*>(p.kr), static_cast<const B*>(p.ki),
                  static_cast<const B*>(p.gpack), static_cast<const B*>(p.irpack),
                  static_cast<B*>(p.out), p.g, p.ph, p.b, p.ci, p.co, p.kh, p.h, p.tb};
  const long long smem = mma_smem_bytes(p.ph, BUILD);
  auto kernel = tail_mma_kernel<BUILD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.co / kCoT, p.g, (p.b + p.tb - 1) / p.tb);
  kernel<<<grid, kThreads, smem, stream>>>(m);
  return (int)cudaGetLastError();
}

template <typename T, int KHP, int FPT, int NT, bool BUILD>
int launch(const TailArgs& p, cudaStream_t stream) {
  const long long smem = smem_bytes(p.ph, p.tb, BUILD ? KHP : 0, (int)sizeof(T));
  if (smem > kSmemLimit || p.tb < 1 || p.tb > kTB * NT || (BUILD && p.kh > KHP))
    return (int)cudaErrorInvalidValue;
  auto kernel = tail_kernel<T, KHP, FPT, NT, BUILD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.co + kCoT - 1) / kCoT, p.g, (p.b + p.tb - 1) / p.tb);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// NT == 1: two row bins a thread; NT == 2: one row bin, sixteen images.
template <typename T, bool BUILD>
int dispatch(const TailArgs& p, cudaStream_t stream) {
  if (p.g == 0 || p.b == 0 || p.co == 0 || p.h == 0) return 0;
  if (!BUILD) return launch<T, 1, 2, 1, false>(p, stream);
  if (p.tb <= kTB)
    return p.kh <= 5 ? launch<T, 5, 2, 1, true>(p, stream) : launch<T, 9, 2, 1, true>(p, stream);
  return p.kh <= 5 ? launch<T, 5, 1, 2, true>(p, stream) : launch<T, 9, 1, 2, true>(p, stream);
}

template <bool BUILD>
int by_dtype(const TailArgs& p, int itemsize, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BUILD && ring_takes(p, itemsize)) return launch_ring(p, s);
  if (mma_takes(p, itemsize, BUILD)) return launch_mma<BUILD>(p, s);
  if (itemsize == 2) return dispatch<__nv_bfloat16, BUILD>(p, s);
  if (itemsize == 4) return dispatch<float, BUILD>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Row 6: the whole batch (b <= 16) in one block, K_f built once per (g, Co tile).
// The ring version holds at most 8 images a block: 9 to 16 images go to it
// as two batch tiles (K_f built by each) where it takes the shapes, ahead
// of the CUDA-core version that holds them in one block.
extern "C" int fft_conv_tail_kdft_resident(const void* xr, const void* xi, const void* ar,
                                           const void* ai, const void* gr, const void* irt,
                                           const void* gpack, const void* irpack, void* out,
                                           int g, int ph, int b, int ci, int co, int kh, int h,
                                           int itemsize, void* stream) {
  TailArgs p{xr, xi, ar, ai, static_cast<const float2*>(gr),
             static_cast<const float2*>(irt), gpack, irpack, out,
             g, ph, b, ci, co, kh, h, b};
  if (b > kTB) {
    TailArgs tiled = p;
    tiled.tb = kTB;
    if (ring_takes(tiled, itemsize)) return launch_ring(tiled, static_cast<cudaStream_t>(stream));
  }
  return by_dtype<true>(p, itemsize, stream);
}

// Row 7: batch tiles of tb <= 8 images over the grid, K_f rebuilt per tile.
extern "C" int fft_conv_tail_kdft(const void* xr, const void* xi, const void* ar, const void* ai,
                                  const void* gr, const void* irt, const void* gpack,
                                  const void* irpack, void* out, int g, int ph, int b, int ci,
                                  int co, int kh, int h, int tb, int itemsize, void* stream) {
  if (tb > kTB) return (int)cudaErrorInvalidValue;
  const TailArgs p{xr, xi, ar, ai, static_cast<const float2*>(gr),
                   static_cast<const float2*>(irt), gpack, irpack, out,
                   g, ph, b, ci, co, kh, h, tb};
  return by_dtype<true>(p, itemsize, stream);
}

// Row 8: K_f (G, Ph, Ci, Co) read from device memory.
extern "C" int fft_conv_tail_kf(const void* xr, const void* xi, const void* kr, const void* ki,
                                const void* irt, const void* irpack, void* out, int g, int ph,
                                int b, int ci, int co, int h, int tb, int itemsize, void* stream) {
  if (tb > kTB) return (int)cudaErrorInvalidValue;
  // The kf entry builds nothing: irpack stands in for gpack in the null test.
  const TailArgs p{xr, xi, kr, ki, nullptr, static_cast<const float2*>(irt), irpack, irpack,
                   out, g, ph, b, ci, co, 0, h, tb};
  return by_dtype<false>(p, itemsize, stream);
}
