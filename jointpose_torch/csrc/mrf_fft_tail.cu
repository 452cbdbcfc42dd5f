// Fused Fourier MRF tail, forward: for each image b and target joint a,
//
//   out[b, a, y, x] = sum_v log(max(o_v[y, x] + bias[v, a], eps)),
//   o_v = Re{ Ir @ (conj(Kf[v, a]) * Pf[b, v]) @ Ic }
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
//   scratch       (2, B, Ka, H, W) workspace, see Grid below
//
// Bound on an H100: operations.  Rows first (T = Ir @ R, then
// o = Re{T @ Ic}) a (b, v, a) pair costs 6*Ph*G + 8*H*Ph*G + 4*H*G*W + 4*H*W
// flops (5.7 MFLOP at the paper geometry Ph=104, G=79, H=60, W=90; columns
// first would cost 8.2) against 0.13 MB of Pf and Kf.  This kernel serves
// precision HIGH/HIGHEST (TPU row 3).  The log amplifies the absolute error
// of small responses, so plain TF32 is out; the products run on the tensor
// cores as 3xTF32: each operand x is split into hi = x rounded to TF32 and
// lo = x - hi (exact; the tensor core reads its upper 19 bits), and lo*hi +
// hi*lo are added before hi*hi into an fp32 accumulator.  lo*lo, 2^-22 of a
// product, is dropped.  That is three mma per product: a third of the TF32
// rate, 2.5 times the fp32 CUDA cores.  Precision DEFAULT, one TF32 pass, is
// the kernel of mrf_fft_tail_wgmma.cu.
//
// Design.  mma.sync.m16n8k8 TF32, 384 threads a block in two roles.
//   Consumers (warps 0-7) do all the arithmetic on the tensor cores, 8 output
//   rows of a (b, a, 64 rows, 96 columns) tile each.  Per source joint v, and
//   per chunk of 40 column bins g:
//     row transform     as one real product whose 16-row tile stacks the 8
//                       rows of T_re on the 8 rows of T_im:
//                       [T_re; T_im] = [Ir_re; Ir_im] @ R_re + [-Ir_im; Ir_re] @ R_im.
//                       One 8-byte load of the interleaved Ir gives both A
//                       fragments (the second is the first, swapped and
//                       negated); one 8-byte load of R both B fragments.
//     column transform  transposed, so that the 8 rows are the n side:
//                       o^T[96, 8] += Ic_re^T @ T_re^T - Ic_im^T @ T_im^T over the
//                       chunk's bins.  T never leaves the registers: an
//                       accumulator tile holds bins (2t, 2t+1) per thread
//                       where a B fragment wants depths (t, t+4), so the
//                       depth index is permuted and the Ic rows are stored in
//                       pairs to match (one 16-byte load gives the A
//                       fragment halves of the re and the im step).
//   After the last chunk: bias, log, add into the log-sum accumulators, which
//   stay in registers until the block's last v of the tile.
//   Producers (warps 8-11) form R = conj(Kf[v, a]) * Pf[b, v] for the next
//   (v, chunk) from device memory (L2: Pf[b, v] and Kf[v, a] are shared by 9
//   tiles each) into a ring of 2 to 4 stages in shared memory, 68 loads in
//   flight per thread, also across steps, while the consumers multiply the
//   current stage.  Named barriers (a full/empty pair per stage) hand the
//   stages over.
// Hi/lo splitting happens at fragment load (three instructions a value):
// shared memory has no room for split copies.
//
// Grid.  The work is B*Ka tiles x Kv source joints (648 units at the paper
// geometry, batch 8), and a tile is indivisible only up to the log: the sum
// over v can be cut anywhere.  The units are dealt out in consecutive runs,
// one block per SM: 132 blocks of 5 (twelve of 4) units, one wave, every SM
// within a fifth of the same work; whole tiles per block would leave 60 SMs
// idle (72 tiles).  A run is at least Kv/2 long, so a tile spreads over at
// most three blocks.  The first writes its partial log-sum to `out`, the
// others to a scratch of two output-sized planes, and a second small kernel
// adds them in block order: the result does not depend on which block ran
// first.  Only these partial sums, never R, T or the K^2 responses, reach
// device memory.
//
// Shared memory at the paper geometry: Ir 64 x (104+4) x 8 B = 55.3 KB,
// Ic 40 row pairs x (96+2) x 16 B = 62.7 KB, R ring 3 x 104 x (40+4) x 8 B =
// 109.8 KB: 227.8 KB of the block's 232.4, one block per SM.  The paddings
// make every fragment load conflict-free.  Given up: split copies of the
// tables (125 KB for Ic alone) and whole-R stages (66.6 KB each; hence the
// g chunks).  Registers: 20 (T) + 24 (o) + 24 (log-sum) accumulators and
// up to 136 of fragments per consumer thread, 168 by __launch_bounds__(384, 1).
// What bounds it as built: mma.sync starts one TF32 m16n8k8 per 8 cycles
// and tensor core, half the wgmma rate, and the splits share its dispatch port.
// Ragged sizes are zero-filled in shared memory and masked at the store; a
// geometry whose tables and two R stages exceed the block's shared memory
// is refused (mrf_fft_tail_smem_bytes).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kConsumers = 256;         // threads of warps 0-7
constexpr int kProducers = 128;         // threads of warps 8-11
constexpr int kThreads = kConsumers + kProducers;
constexpr int kRows = 64;               // output rows per block: 8 per consumer warp
constexpr int kCols = 96;               // output columns per block
constexpr int kMW = kCols / 16;         // column m-tiles of the column transform
constexpr int kGC = 40;                 // column bins per R chunk
constexpr int kNJ = kGC / 8;            // n-tiles of the row transform per chunk
constexpr int kRStride = kGC + 4;       // float2 per R row: 44 = 12 mod 16, conflict-free
constexpr int kIcStride = kCols + 2;    // float4 per Ic row pair: 98 = 2 mod 8, conflict-free
constexpr int kMinStages = 2;
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;
constexpr int kLoads = 17;              // R values a producer thread forms per batch
constexpr int kMaxParts = 3;            // blocks that may share one output tile
// Named barriers: 0 is __syncthreads'.
constexpr int kBarTables = 1;
constexpr int kBarFull = 2;
constexpr int kBarEmpty = kBarFull + kMaxStages;

struct Plan {
  int php;       // Ph rounded up to the mma depth
  int irs;       // float2 per Ir row: php + 4 = 4 or 12 mod 16, conflict-free
  int nchunks;   // chunks of kGC column bins
  int stages;    // R ring depth, 0 if even kMinStages do not fit
  long long ir_bytes, ic_bytes, stage_bytes;
  long long smem(int s) const { return ir_bytes + ic_bytes + s * stage_bytes; }
};

Plan make_plan(int ph, int g_bins) {
  Plan p;
  p.php = (ph + 7) / 8 * 8;
  p.irs = p.php + 4;
  p.nchunks = (g_bins + kGC - 1) / kGC;
  p.ir_bytes = (long long)kRows * p.irs * sizeof(float2);
  p.ic_bytes = (long long)p.nchunks * (kGC / 2) * kIcStride * sizeof(float4);
  p.stage_bytes = (long long)p.php * kRStride * sizeof(float2);
  p.stages = 0;
  for (int s = kMinStages; s <= kMaxStages; ++s)
    if (p.smem(s) <= kSmemLimit) p.stages = s;
  return p;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// x rounded to TF32, to nearest with ties away from zero: what
// cvt.rna.tf32.f32 gives for finite x, in two integer instructions instead
// of the four the compiler emits for it.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo exactly, hi = to_tf32(x).  lo goes to the tensor core as it is.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An mma fragment of N values, split into hi and lo.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int e, float x) { split(x, hi[e], lo[e]); }
  // -x at e from the value at f (both parts)
  __device__ __forceinline__ void set_neg(int e, const Frag& o, int f) {
    hi[e] = o.hi[f] ^ 0x80000000u;
    lo[e] = o.lo[f] ^ 0x80000000u;
  }
  __device__ __forceinline__ void copy(int e, const Frag& o, int f) {
    hi[e] = o.hi[f];
    lo[e] = o.lo[f];
  }
};
using AFrag = Frag<4>;
using BFrag = Frag<2>;
// c += a * b is three mma: a.lo*b.hi and a.hi*b.lo (the small terms,
// first), then a.hi*b.hi.  The callers give
// one term to all their accumulators before the next term, so that an mma
// does not wait for the one before it.
__device__ __forceinline__ void mma_lh(float (&c)[4], const AFrag& a, const BFrag& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
}
__device__ __forceinline__ void mma_hl(float (&c)[4], const AFrag& a, const BFrag& b) {
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
}
__device__ __forceinline__ void mma_hh(float (&c)[4], const AFrag& a, const BFrag& b) {
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

struct Args {
  const float* pf_re;
  const float* pf_im;
  const float* kf_re;
  const float* kf_im;
  const float2* ir;
  const float* ict_re;
  const float* ict_im;
  const float* bias;
  float* out;
  float* scratch;  // (kMaxParts - 1, B, Ka, H, W): the partial log-sums of later parts
  int kv, ka, ph, g_bins, h, w;
  int php, irs, nchunks, stages;
  int units;            // (tile, v) units in all: B*Ka*row tiles*column tiles*Kv
  int units_per_block;  // consecutive units of one block
  long long n_out;      // B*Ka*H*W
  float eps;
};

// Unit u is source joint v = u % Kv of output tile u / Kv; tiles count
// (b, a, row tile, column tile), the last fastest.
struct Tile {
  int b, a, y0, x0, yx;
};
__device__ __forceinline__ Tile tile_of(const Args& p, int tile) {
  const int nxt = (p.w + kCols - 1) / kCols, nyt = (p.h + kRows - 1) / kRows;
  Tile t;
  t.yx = tile % (nyt * nxt);
  t.x0 = t.yx % nxt * kCols;
  t.y0 = t.yx / nxt * kRows;
  tile /= nyt * nxt;
  t.a = tile % p.ka;
  t.b = tile / p.ka;
  return t;
}

__global__ void __launch_bounds__(kThreads, 1) mrf_fft_tail_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* ir_s = reinterpret_cast<float2*>(smem_raw);                       // (kRows, irs)
  float4* ic_s = reinterpret_cast<float4*>(ir_s + kRows * p.irs);           // (pairs, kIcStride)
  float2* r_s = reinterpret_cast<float2*>(ic_s + p.nchunks * (kGC / 2) * kIcStride);
  const int stage_elems = p.php * kRStride;                                 // float2 per stage

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * p.units_per_block;
  const int u1 = min(u0 + p.units_per_block, p.units);
  const int total = (u1 - u0) * p.nchunks;  // ring steps: (unit, chunk)

  if (tid >= kConsumers) {
    // ---- producers: R = conj(Kf[v, a]) * Pf[b, v], one (unit, chunk) per ring step,
    // in batches of kLoads values a thread; a batch's loads are in flight while the
    // one before it is multiplied and stored, also across steps.
    const int ptid = tid - kConsumers;
    const int plane = p.ph * p.g_bins;
    const int n_el = p.php * kGC;
    const int nbatch = (n_el + kLoads * kProducers - 1) / (kLoads * kProducers);
    float p_r[kLoads], p_i[kLoads], k_r[kLoads], k_i[kLoads];
    auto load = [&](int step, int batch) {
      const int u = u0 + step / p.nchunks, g0 = step % p.nchunks * kGC;
      const Tile t = tile_of(p, u / p.kv);
      const int v = u % p.kv;
      const float* pr = p.pf_re + (size_t)(t.b * p.kv + v) * plane;
      const float* pi = p.pf_im + (size_t)(t.b * p.kv + v) * plane;
      const float* kr = p.kf_re + (size_t)(v * p.ka + t.a) * plane;
      const float* ki = p.kf_im + (size_t)(v * p.ka + t.a) * plane;
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int idx = (batch * kLoads + i) * kProducers + ptid;
        const int f = idx / kGC, g = g0 + idx % kGC;
        p_r[i] = p_i[i] = k_r[i] = k_i[i] = 0.f;  // rows past Ph and bins past G are zero
        if (f < p.ph && g < p.g_bins) {
          const int off = f * p.g_bins + g;
          p_r[i] = __ldg(pr + off);
          p_i[i] = __ldg(pi + off);
          k_r[i] = __ldg(kr + off);
          k_i[i] = __ldg(ki + off);
        }
      }
    };
    if (total > 0) load(0, 0);
    for (int it = 0; it < total; ++it) {
      const int s = it % p.stages;
      if (it >= p.stages) bar_sync(kBarEmpty + s, kThreads);  // the consumers are done with it
      float2* dst = r_s + s * stage_elems;
      for (int batch = 0; batch < nbatch; ++batch) {
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int idx = (batch * kLoads + i) * kProducers + ptid;
          if (idx < n_el)
            dst[idx / kGC * kRStride + idx % kGC] = make_float2(
                k_r[i] * p_r[i] + k_i[i] * p_i[i], k_r[i] * p_i[i] - k_i[i] * p_r[i]);
        }
        if (batch + 1 < nbatch) load(it, batch + 1);
        else if (it + 1 < total) load(it + 1, 0);
      }
      __threadfence_block();
      bar_arrive(kBarFull + s, kThreads);
    }
    return;
  }

  // ---- consumers.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // fragment row group
  const int tq = lane & 3;   // fragment column group
  const float2* ir_w = ir_s + (8 * warp + gq) * p.irs + tq;
  const int nks = p.php / 8;

  float ls[kMW][4], o[kMW][4];
#pragma unroll
  for (int m = 0; m < kMW; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[m][e] = 0.f;

  int loaded_yx = -1;
  int it = 0;
  for (int u = u0; u < u1; ++u) {
    const int v = u % p.kv;
    const Tile t = tile_of(p, u / p.kv);
    if (u == u0 || v == 0) {
      // A new output tile: its slices of the tables, zero-filled past H, Ph, G and W.
      if (t.yx != loaded_yx) {
        if (loaded_yx >= 0) bar_sync(kBarTables, kConsumers);  // the old slices are spent
        for (int i = tid; i < kRows * p.irs; i += kConsumers) {
          const int y = t.y0 + i / p.irs, f = i % p.irs;
          ir_s[i] = (y < p.h && f < p.ph) ? __ldg(p.ir + (size_t)y * p.ph + f)
                                          : make_float2(0.f, 0.f);
        }
        for (int i = tid; i < p.nchunks * (kGC / 2) * kIcStride; i += kConsumers) {
          const int g = i / kIcStride * 2, x = t.x0 + i % kIcStride;
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i % kIcStride < kCols && x < p.w) {
            if (g < p.g_bins) {
              val.x = __ldg(p.ict_re + (size_t)g * p.w + x);
              val.z = -__ldg(p.ict_im + (size_t)g * p.w + x);
            }
            if (g + 1 < p.g_bins) {
              val.y = __ldg(p.ict_re + (size_t)(g + 1) * p.w + x);
              val.w = -__ldg(p.ict_im + (size_t)(g + 1) * p.w + x);
            }
          }
          ic_s[i] = val;
        }
        bar_sync(kBarTables, kConsumers);
        loaded_yx = t.yx;
      }
#pragma unroll
      for (int m = 0; m < kMW; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) ls[m][e] = 0.f;
    }

    for (int c = 0; c < p.nchunks; ++c, ++it) {
      const int s = it % p.stages;
      bar_sync(kBarFull + s, kThreads);  // the producers have filled the stage
      const float2* r_w = r_s + s * stage_elems + tq * kRStride + gq;

      // Row transform: rows 0-7 of the tile are T_re, rows 8-15 T_im, of this
      // warp's 8 output rows, for the chunk's 40 bins:
      // [T_re; T_im] = [Ir_re; Ir_im] @ R_re + [-Ir_im; Ir_re] @ R_im.
      float tt[kNJ][4];
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tt[j][e] = 0.f;
      for (int ks = 0; ks < nks; ++ks) {
        AFrag a1, a2;  // [Ir_re; Ir_im] and [-Ir_im; Ir_re]
        {
          const float2 lo = ir_w[ks * 8], hi = ir_w[ks * 8 + 4];
          a1.set(0, lo.x);
          a1.set(1, lo.y);
          a1.set(2, hi.x);
          a1.set(3, hi.y);
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            a2.set_neg(e, a1, e + 1);
            a2.copy(e + 1, a1, e);
          }
        }
        BFrag bre[kNJ], bim[kNJ];
        const float2* bp = r_w + ks * 8 * kRStride;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const float2 b0 = bp[8 * j], b1 = bp[4 * kRStride + 8 * j];
          bre[j].set(0, b0.x);
          bre[j].set(1, b1.x);
          bim[j].set(0, b0.y);
          bim[j].set(1, b1.y);
        }
#define JP_ROW_TERM(MMA, A, B) \
  _Pragma("unroll") for (int j = 0; j < kNJ; ++j) MMA(tt[j], A, B[j]);
        JP_ROW_TERM(mma_lh, a1, bre)
        JP_ROW_TERM(mma_hl, a1, bre)
        JP_ROW_TERM(mma_lh, a2, bim)
        JP_ROW_TERM(mma_hl, a2, bim)
        JP_ROW_TERM(mma_hh, a1, bre)
        JP_ROW_TERM(mma_hh, a2, bim)
#undef JP_ROW_TERM
      }
      // The stage is consumed; the last stages of the run are not refilled.
      if (it + p.stages < total) bar_arrive(kBarEmpty + s, kThreads);

      // Column transform, transposed: o^T[96 columns, 8 rows] += Ic_re^T @ T_re^T -
      // Ic_im^T @ T_im^T over the chunk's bins.  T is the B operand straight from
      // the accumulators (depth t is bin 2t of the tile, depth t + 4 bin 2t + 1).
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        BFrag tr, ti;
        tr.set(0, tt[j][0]);
        tr.set(1, tt[j][1]);
        ti.set(0, tt[j][2]);
        ti.set(1, tt[j][3]);
        const float4* icp = ic_s + (c * (kGC / 2) + 4 * j + tq) * kIcStride + gq;
        {
          AFrag cre[kMW], cim[kMW];
#pragma unroll
          for (int m = 0; m < kMW; ++m) {
            const float4 lo = icp[16 * m], hi = icp[16 * m + 8];
            cre[m].set(0, lo.x);
            cre[m].set(1, hi.x);
            cre[m].set(2, lo.y);
            cre[m].set(3, hi.y);
            cim[m].set(0, lo.z);
            cim[m].set(1, hi.z);
            cim[m].set(2, lo.w);
            cim[m].set(3, hi.w);
          }
#define JP_COL_TERM(MMA, A, B) \
  _Pragma("unroll") for (int m = 0; m < kMW; ++m) MMA(o[m], A[m], B);
          JP_COL_TERM(mma_lh, cre, tr)
          JP_COL_TERM(mma_hl, cre, tr)
          JP_COL_TERM(mma_lh, cim, ti)
          JP_COL_TERM(mma_hl, cim, ti)
          JP_COL_TERM(mma_hh, cre, tr)
          JP_COL_TERM(mma_hh, cim, ti)
#undef JP_COL_TERM
        }
      }
    }

    // Epilogue of this v: bias, log, into the log-sum.
    const float bv = __ldg(p.bias + v * p.ka + t.a);
#pragma unroll
    for (int m = 0; m < kMW; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ls[m][e] += logf(fmaxf(o[m][e] + bv, p.eps));
        o[m][e] = 0.f;
      }

    if (v == p.kv - 1 || u == u1 - 1) {
      // This block's last v of the tile.  The first block of a tile writes to
      // out, the later ones to their part of the scratch.
      const int tile = u / p.kv;
      const int part = blockIdx.x - tile * p.kv / p.units_per_block;
      float* dst = (part == 0 ? p.out : p.scratch + (size_t)(part - 1) * p.n_out) +
                   (size_t)(t.b * p.ka + t.a) * p.h * p.w;
#pragma unroll
      for (int m = 0; m < kMW; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int y = t.y0 + 8 * warp + 2 * tq + (e & 1);
          const int x = t.x0 + 16 * m + gq + 8 * (e >> 1);
          if (y < p.h && x < p.w) dst[(size_t)y * p.w + x] = ls[m][e];
        }
    }
  }
}

// out += the later parts of each tile, in the order of the blocks that made them.
__global__ void mrf_fft_tail_combine_kernel(float* __restrict__ out,
                                            const float* __restrict__ scratch, long long n,
                                            int kv, int h, int w, int units_per_block) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int nxt = (w + kCols - 1) / kCols, nyt = (h + kRows - 1) / kRows;
  const int x = (int)(i % w), y = (int)(i / w % h);
  const long long tile = (i / ((long long)h * w) * nyt + y / kRows) * nxt + x / kCols;
  const int first = (int)(tile * kv / units_per_block);
  const int last = (int)((tile * kv + kv - 1) / units_per_block);
  float acc = out[i];
  for (int part = 1; part <= last - first; ++part) acc += scratch[(part - 1) * n + i];
  out[i] = acc;
}

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

}  // namespace

// Shared memory of one block with the shallowest R ring; above the block's
// limit (232,448 B) the geometry is refused.
extern "C" long long mrf_fft_tail_smem_bytes(int ph, int g_bins) {
  return make_plan(ph, g_bins).smem(kMinStages);
}

// Copies of the output the scratch must hold.
extern "C" int mrf_fft_tail_scratch_parts() { return kMaxParts - 1; }

// 3xTF32, precision HIGH/HIGHEST.
extern "C" int mrf_fft_tail(const void* pf_re, const void* pf_im, const void* kf_re,
                            const void* kf_im, const void* ir, const void* ict_re,
                            const void* ict_im, const void* bias, void* out, void* scratch,
                            int batch, int kv, int ka, int ph, int g_bins, int h, int w,
                            float eps, void* stream) {
  if (batch == 0 || ka == 0 || h == 0 || w == 0) return 0;
  const Plan plan = make_plan(ph, g_bins);
  if (plan.stages == 0 || kv < 1) return (int)cudaErrorInvalidValue;
  const long long smem = plan.smem(plan.stages);
  cudaError_t err = cudaFuncSetAttribute(mrf_fft_tail_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // The (tile, v) units are dealt out in consecutive runs, one per block and
  // as many blocks as SMs; a run of at least Kv/2 units keeps a tile within
  // kMaxParts blocks.
  const long long tiles =
      (long long)batch * ka * ((h + kRows - 1) / kRows) * ((w + kCols - 1) / kCols);
  const long long units = tiles * kv;
  if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  int per = (int)((units + sms - 1) / sms);
  if (per < (kv + 1) / 2) per = (kv + 1) / 2;
  const int blocks = (int)((units + per - 1) / per);
  const long long n_out = (long long)batch * ka * h * w;
  if (n_out > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const Args args{static_cast<const float*>(pf_re), static_cast<const float*>(pf_im),
                  static_cast<const float*>(kf_re), static_cast<const float*>(kf_im),
                  static_cast<const float2*>(ir), static_cast<const float*>(ict_re),
                  static_cast<const float*>(ict_im), static_cast<const float*>(bias),
                  static_cast<float*>(out), static_cast<float*>(scratch),
                  kv, ka, ph, g_bins, h, w,
                  plan.php, plan.irs, plan.nchunks, plan.stages, (int)units, per, n_out, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mrf_fft_tail_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || per % kv == 0) return (int)err;  // whole tiles: nothing to add
  mrf_fft_tail_combine_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(
      static_cast<float*>(out), static_cast<const float*>(scratch), n_out, kv, h, w, per);
  return (int)cudaGetLastError();
}
