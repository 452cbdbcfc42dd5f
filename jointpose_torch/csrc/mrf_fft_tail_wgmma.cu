// Fused Fourier MRF tail, single pass, on wgmma: for each image b and target
// joint a,
//
//   out[b, a, y, x] = sum_v log(max(o_v[y, x] + bias[v, a], eps)),
//   o_v = Re{ Ir @ (conj(Kf[v, a]) * Pf[b, v]) @ Ic }
//
// with one TF32 pass: every operand of a product rounded once to TF32, to
// nearest with ties away from zero, and fp32 sums.  Replaces the TPU kernel
// jointpose/ops/mrf_fft_pallas.py:_fused_kernel compiled at
// lax.Precision.DEFAULT (one reduced-precision pass), the form the server
// runs at its default MRF precision.  csrc/mrf_fft_tail.cu computes the same
// function at 3xTF32 (precision HIGH/HIGHEST) on mma.sync.
//
// Inputs, f32 and contiguous:
//   pf_re, pf_im  (B, Kv, Ph, G)    forward DFTs of the unaries (half column spectrum)
//   kf_re, kf_im  (Kv, Ka, Ph, G)   forward DFTs of the pairwise kernels
//                 (both with rows of `stride` >= G floats, a multiple of 8,
//                 the bins past G zero: ops/mrf_fft.forward_ffts(padded_bins))
//   ir_img        (row tiles, 64 * 2Php)  [ir_im | ir_re] (ir_stack's lower half),
//   ic_img        (column tiles, 96 * 2Gp) ic_stack = [ict_re; -ict_im],
//                 both rounded to TF32 and laid out as the tensor cores read
//                 them (ops/mrf_fft.tail_table_images); Php, Gp: Ph, G to 8
//   bias          (Kv, Ka)
//   out           (B, Ka, H, W)
//   scratch       (parts - 1, B, Ka, H, W)  partial log-sums, see Work below
//
// Bound on an H100: operations.  Rows first a (b, v, a) unit costs
// 6*Ph*G + 8*H*Ph*G + 4*H*G*W + 4*H*W flops (5.7 MFLOP at the paper geometry
// Ph=104, G=79, H=60, W=90), against 0.13 MB of Pf and Kf read from L2.  At
// the TF32 peak (495 TFLOP/s) the 648 units of batch 8 take 7.5 us.  Two
// more floors: Pf[b, v] and Kf[v, a] are read from L2 once a unit (85 MB at
// batch 8, some 15 us at the L2's rate), and shared memory feeds both
// operands of the row transform.  As built the L2 reads and each
// warpgroup's chain of products, drains and logs bound it, not the tensor
// cores (profile_mrf_tail_stages.py --wgmma cuts each stage out).
//
// Design.  Both inverse transforms are real products on the tensor cores,
// wgmma.mma_async m64nNk8 TF32, over operands in shared memory in the
// no-swizzle K-major layout (core matrices of 8 rows x 16 bytes):
//   row transform     T_re = Ir_re R_re - Ir_im R_im, T_im = Ir_im R_re + Ir_re R_im:
//                     four products a depth step of 8 rows of the DFT, A the
//                     resident table image (64 output rows), B the chunk of
//                     R (N = up to 32 column bins), the minus by the
//                     instruction's scale-a of -1.
//   column transform  o += [T_re, T_im] @ ic_stack, A from registers: the row
//                     transform's accumulator tile is an A fragment once the
//                     depth order inside each 8 bins is (0, 2, 4, 6, 1, 3,
//                     5, 7), which the host bakes into the Ic image.  T is
//                     rounded to TF32 in place, the only conversion the
//                     consumers do.  N = 96 output columns.
// A block has two consumer warpgroups, each a worker with its own run of
// units and its own ring of R stages, fed by its own two producer warps of
// the third warpgroup, which hands registers to the consumers (setmaxnreg,
// 136 / 184 a thread).  A producer thread forms 4 rows x 4 bins of R =
// conj(Kf) * Pf from 16 aligned 16-byte loads (the spectra's rows padded to
// 8 bins), rounds it and stores it as four 16-byte rows of core matrices;
// the next item's loads fly while it multiplies and stores, also across
// stages.  mbarriers hand the stages over (full: the 64 producers arrive
// after a proxy fence; empty: the 128 consumers arrive once their row
// products are done).  The tables come in once a block, by two bulk copies
// (cp.async.bulk) on an mbarrier.  While one warpgroup rounds T or takes
// its logs (__logf), the other keeps the tensor cores busy.
//
// Work.  Per (64-row, 96-column) output tile slice (grid.y), the B*Ka*Kv
// units (tile, v), v fastest, are dealt in consecutive runs as evenly as
// possible over two workers a block and as many blocks as SMs: 264 workers
// of 2 or 3 units at batch 8.  A tile's log-sum over v may be cut anywhere,
// so a tile spreads over several workers: the first writes `out`, the k-th
// the (k-1)-th scratch plane, and a second small kernel adds them in worker
// order.  The result does not depend on which block ran first: a rerun is
// bit-identical.  Only those partial sums reach device memory.
//
// Shared memory at the paper geometry: Ir 64 x 208 x 4 B = 53.2 KB, Ic
// 96 x 160 x 4 B = 61.4 KB, 2 rings x 2 stages x (32 bins x 208) x 4 B =
// 106.5 KB: 221.3 KB of the block's 232.4.  A chunk narrower
// than 32 bins (or one stage a ring) is taken where that does not fit; a
// geometry for which even 8 bins and one stage do not is refused
// (mrf_tail_wgmma_smem_bytes).  Ragged sizes are zero-filled (in the images
// and by the producers) and masked at the store.  No host sync, no
// allocation: capturable.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWG = 128;          // threads of a consumer warpgroup
constexpr int kRings = 2;         // consumer warpgroups (workers) a block
constexpr int kFeeders = 64;      // producer threads of a ring
constexpr int kConsumers = kRings * kWG;
constexpr int kThreads = kConsumers + kRings * kFeeders;
constexpr int kRows = 64;         // output rows of a tile: one wgmma M
constexpr int kCols = 96;         // output columns of a tile: the column transform's N
constexpr int kColGroups = kCols / 8;
constexpr int kMaxStages = 2;     // R stages a ring
constexpr int kSmemLimit = 232448;
constexpr int kBarBytes = 128;    // the tables' mbarrier and each ring's full/empty pairs
// Registers a thread after the hand-over (168 each at launch): the consumers
// hold T, o and the log-sums (128) besides their addresses.
constexpr int kProducerRegs = 136;
constexpr int kConsumerRegs = 184;
static_assert(kConsumers * kConsumerRegs + kRings * kFeeders * kProducerRegs <= 168 * kThreads,
              "the hand-over must stay within the registers of the launch");
constexpr int kChunks[] = {32, 24, 16, 8};

struct Plan {
  int php, gp, gc, stages;  // Ph and G to 8; bins a chunk; stages a ring (0: refused)
  long long ir_bytes, ic_bytes, stage_bytes;
  long long smem() const { return kBarBytes + ir_bytes + ic_bytes + kRings * stages * stage_bytes; }
};

Plan make_plan(int ph, int g_bins) {
  Plan p;
  p.php = (ph + 7) / 8 * 8;
  p.gp = (g_bins + 7) / 8 * 8;
  p.ir_bytes = (long long)kRows * 2 * p.php * 4;
  p.ic_bytes = (long long)kCols * 2 * p.gp * 4;
  for (int stages = kMaxStages; stages >= 1; --stages)
    for (int c : kChunks) {
      p.gc = c < p.gp ? c : p.gp;
      p.stages = stages;
      p.stage_bytes = (long long)p.gc * 2 * p.php * 4;
      if (p.smem() <= kSmemLimit) return p;
    }
  p.stages = 0;
  return p;
}

// The units of one tile slice dealt to `workers` workers: worker w takes
// [start(w), start(w + 1)).
__host__ __device__ __forceinline__ int run_start(int w, int units, int workers) {
  return (int)((long long)w * units / workers);
}
__host__ __device__ __forceinline__ int worker_of(int u, int units, int workers) {
  return (int)(((long long)(u + 1) * workers - 1) / units);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// A barrier that never completes (a fault in the hand-over) traps after
// about 2^28 polls, seconds, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32
// for finite x), in two integer instructions.
__device__ __forceinline__ float to_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// Shared-memory matrix descriptor, no swizzle: start, leading (K) and stride
// (M or N) byte offsets between core matrices.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads of accumulators across a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define JP_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define JP_D8(i) JP_D4(i), JP_D4(i + 4)

// d[0 .. 4*NG) (+)= SA * A @ B^T: A 64 x 8 and B (8*NG) x 8 in shared memory.
template <int NG, int SA>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  if constexpr (NG == 4) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, %19, 1;\n}\n"
        : JP_D8(0), JP_D8(8)
        : "l"(a), "l"(b), "r"(acc), "n"(SA));
  } else if constexpr (NG == 3) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11}, %12, %13, p, %15, 1;\n}\n"
        : JP_D8(0), JP_D4(8)
        : "l"(a), "l"(b), "r"(acc), "n"(SA));
  } else if constexpr (NG == 2) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p, %11, 1;\n}\n"
        : JP_D8(0)
        : "l"(a), "l"(b), "r"(acc), "n"(SA));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3}, %4, %5, p, %7, 1;\n}\n"
        : JP_D4(0)
        : "l"(a), "l"(b), "r"(acc), "n"(SA));
  }
}

// d (+)= A @ B^T: A 64 x 8 from registers (an mma.m16n8k8 TF32 A fragment a
// warp), B 96 x 8 in shared memory.
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], float a0, float a1, float a2, float a3,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,"
      "%46,%47}, {%48,%49,%50,%51}, %52, p, 1, 1;\n}\n"
      : JP_D8(0), JP_D8(8), JP_D8(16), JP_D8(24), JP_D8(32), JP_D8(40)
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)), "r"(__float_as_uint(a2)),
        "r"(__float_as_uint(a3)), "l"(b), "r"(acc));
}
#undef JP_D8
#undef JP_D4

struct Args {
  const float* pf_re;
  const float* pf_im;
  const float* kf_re;
  const float* kf_im;
  const float* ir_img;
  const float* ic_img;
  const float* bias;
  float* out;
  float* scratch;
  int kv, ka, ph, g_bins, stride, h, w;
  int php, gp, gc, nchunks, stages;
  int units;    // B*Ka*Kv units of one tile slice
  int workers;  // workers of one tile slice
  long long n_out;
  float eps;
};

// Shared-memory addresses of a block's pieces.
struct Smem {
  uint32_t bars, ir, ic, stages;
  __device__ Smem(uint32_t base, const Args& p) {
    bars = base;
    ir = base + kBarBytes;
    ic = ir + kRows * 2 * p.php * 4;
    stages = ic + kCols * 2 * p.gp * 4;
  }
  __device__ uint32_t tables_bar() const { return bars; }
  __device__ uint32_t full(int r, int s) const { return bars + 8 * (1 + r * kMaxStages + s); }
  __device__ uint32_t empty(int r, int s) const {
    return bars + 8 * (1 + (kRings + r) * kMaxStages + s);
  }
};

// One R chunk through both transforms into o: the row products over the
// whole depth, then the column products over the chunk's NG bin groups.
template <int NG>
__device__ __forceinline__ void chunk_products(float (&o)[48], float (&tre)[16], float (&tim)[16],
                                               const Smem& sm, const Args& p, uint32_t stage,
                                               uint32_t empty_bar, int c) {
  const int kq = p.php / 4;          // core-matrix columns of one half of the depth
  const int ngc = p.gc / 8;          // bin groups a stage row holds
  const uint64_t da = make_desc(sm.ir, 8 * 128, 128);  // LBO: 8 row groups
  const int lbo = ngc * 128;  // bytes between the stage's rows of core matrices
  const uint64_t db = make_desc(stage, lbo, 128);
  wgmma_wait_all();  // the previous column products have read T
  fence_regs(o);
  fence_regs(tre);
  fence_regs(tim);
  wgmma_fence();
  // Image halves: 0 = Ir_im, 1 = Ir_re; stage halves: 0 = R_re, 1 = R_im.
  for (int ks = 0; ks < p.php / 8; ++ks) {
    const uint64_t a_im = da + (uint64_t)(2 * ks) * 64, a_re = da + (uint64_t)(kq + 2 * ks) * 64;
    const uint64_t b_re = db + (uint64_t)(2 * ks) * (lbo >> 4);
    const uint64_t b_im = db + (uint64_t)(kq + 2 * ks) * (lbo >> 4);
    const int acc = ks > 0;
    wgmma_ss<NG, 1>(tre, a_re, b_re, acc);
    wgmma_ss<NG, 1>(tim, a_im, b_re, acc);
    wgmma_ss<NG, -1>(tre, a_im, b_im, 1);
    wgmma_ss<NG, 1>(tim, a_re, b_im, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(tre);
  fence_regs(tim);
  mbar_arrive(empty_bar);  // the stage is read
#pragma unroll
  for (int i = 0; i < 4 * NG; ++i) {
    tre[i] = to_tf32(tre[i]);
    tim[i] = to_tf32(tim[i]);
  }
  wgmma_fence();
  // Column products: bin group jj of the chunk; K order (0, 2, 4, 6, 1, 3, 5, 7).
  const uint64_t dc = make_desc(sm.ic, kColGroups * 128, 128);
  const int jj0 = c * p.gc / 8;
#pragma unroll
  for (int j = 0; j < NG; ++j)
    wgmma_rs_n96(o, tre[4 * j], tre[4 * j + 2], tre[4 * j + 1], tre[4 * j + 3],
                 dc + (uint64_t)(2 * (jj0 + j)) * kColGroups * 8, c > 0 || j > 0);
#pragma unroll
  for (int j = 0; j < NG; ++j)
    wgmma_rs_n96(o, tim[4 * j], tim[4 * j + 2], tim[4 * j + 1], tim[4 * j + 3],
                 dc + (uint64_t)(p.gp / 4 + 2 * (jj0 + j)) * kColGroups * 8, 1);
  wgmma_commit();
}

__global__ void __launch_bounds__(kThreads, 1) mrf_tail_wgmma_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem sm(smem_u32(smem_raw), p);
  const int tid = threadIdx.x;
  const int nxt = (p.w + kCols - 1) / kCols;
  const int yt = blockIdx.y / nxt, xt = blockIdx.y % nxt;

  if (tid == 0) {
    mbar_init(sm.tables_bar(), 1);
    for (int r = 0; r < kRings; ++r)
      for (int s = 0; s < kMaxStages; ++s) {
        mbar_init(sm.full(r, s), kFeeders);
        mbar_init(sm.empty(r, s), kWG);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t ir_bytes = kRows * 2 * p.php * 4, ic_bytes = kCols * 2 * p.gp * 4;
    mbar_expect_tx(sm.tables_bar(), ir_bytes + ic_bytes);
    bulk_copy(sm.ir, p.ir_img + (size_t)yt * kRows * 2 * p.php, ir_bytes, sm.tables_bar());
    bulk_copy(sm.ic, p.ic_img + (size_t)xt * kCols * 2 * p.gp, ic_bytes, sm.tables_bar());
  }

  const bool consumer = tid < kConsumers;
  const int r = consumer ? tid / kWG : (tid - kConsumers) / kFeeders;
  const int worker = blockIdx.x * kRings + r;
  const int u0 = run_start(worker, p.units, p.workers);
  const int u1 = worker < p.workers ? run_start(worker + 1, p.units, p.workers) : u0;
  const int total = (u1 - u0) * p.nchunks;  // ring steps: (unit, chunk)
  const int stage_row = p.gc * 4;  // floats of a row of core matrices
  const int stage_floats = stage_row * 2 * (p.php / 4);
  const uint32_t ring = sm.stages + (uint32_t)(r * p.stages * stage_floats * 4);

  if (!consumer) {
    // Registers to the consumers, by the whole producer warpgroup at once.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    // ---- producers: R = conj(Kf[v, a]) * Pf[b, v] for each (unit, chunk), as
    // items of 4 DFT rows x 4 bins: 16 aligned 16-byte loads, then one
    // 16-byte row of a core matrix per bin and half.  An item's loads are in
    // flight while the one before it is multiplied and stored, also across
    // steps.
    const int pt = (tid - kConsumers) % kFeeders;
    const int plane = p.ph * p.stride;
    const int kq = p.php / 4;
    float4 vpr[4], vpi[4], vkr[4], vki[4];
    auto quads = [&](int step) { return min(p.gc, p.gp - step % p.nchunks * p.gc) / 4; };
    auto load = [&](int step, int batch) {
      const int u = u0 + step / p.nchunks, c = step % p.nchunks;
      const int tile = u / p.kv, v = u % p.kv;
      const int b = tile / p.ka, a = tile % p.ka;
      const int nq = quads(step);  // 4-bin columns of the chunk
      const int idx = batch * kFeeders + pt;
      const int kc = idx / nq, q4 = idx % nq;
      const float* pr = p.pf_re + (size_t)(b * p.kv + v) * plane + c * p.gc;
      const float* pi = p.pf_im + (size_t)(b * p.kv + v) * plane + c * p.gc;
      const float* kr = p.kf_re + (size_t)(v * p.ka + a) * plane + c * p.gc;
      const float* ki = p.kf_im + (size_t)(v * p.ka + a) * plane + c * p.gc;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // Rows past Ph (and items past the chunk) read row 0, bins past G
        // the rows' padding; both are zeroed at the store.
        const int f = 4 * kc + q;
        const int off = (kc < kq && f < p.ph ? f : 0) * p.stride + 4 * q4;
        vpr[q] = __ldg(reinterpret_cast<const float4*>(pr + off));
        vpi[q] = __ldg(reinterpret_cast<const float4*>(pi + off));
        vkr[q] = __ldg(reinterpret_cast<const float4*>(kr + off));
        vki[q] = __ldg(reinterpret_cast<const float4*>(ki + off));
      }
    };
    if (total > 0) load(0, 0);
    for (int it = 0; it < total; ++it) {
      const int s = it % p.stages;
      if (it >= p.stages) mbar_wait(sm.empty(r, s), (it / p.stages - 1) & 1);
      float* dst = reinterpret_cast<float*>(smem_raw + (ring - sm.bars)) + s * stage_floats;
      const int nq = quads(it);
      const int items = kq * nq;
      const int g0 = it % p.nchunks * p.gc;  // the chunk's first bin
      const int nbatch = (items + kFeeders - 1) / kFeeders;
      for (int batch = 0; batch < nbatch; ++batch) {
        const int idx = batch * kFeeders + pt;
        if (idx < items) {
          const int kc = idx / nq, q4 = idx % nq;
          const float* pr = &vpr[0].x;
          const float* pi = &vpi[0].x;
          const float* kr = &vkr[0].x;
          const float* ki = &vki[0].x;
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // bin 4 * q4 + j: rows 4kc .. 4kc + 3
            const int gl = 4 * q4 + j;
            float4 re, im;
            float* rp = &re.x;
            float* ip = &im.x;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int e = 4 * q + j;
              const bool in = 4 * kc + q < p.ph && g0 + gl < p.g_bins;
              rp[q] = in ? to_tf32(__fadd_rn(__fmul_rn(kr[e], pr[e]), __fmul_rn(ki[e], pi[e])))
                         : 0.f;
              ip[q] = in ? to_tf32(__fsub_rn(__fmul_rn(kr[e], pi[e]), __fmul_rn(ki[e], pr[e])))
                         : 0.f;
            }
            const int col = (gl / 8) * 32 + (gl % 8) * 4;  // floats into a core-matrix column
            *reinterpret_cast<float4*>(dst + kc * stage_row + col) = re;
            *reinterpret_cast<float4*>(dst + (kq + kc) * stage_row + col) = im;
          }
        }
        if (batch + 1 < nbatch) load(it, batch + 1);
        else if (it + 1 < total) load(it + 1, 0);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the tensor cores
      mbar_arrive(sm.full(r, s));
    }
    return;
  }

  // ---- consumers: a warpgroup, one worker.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = tid & 31;
  const int wq = (tid % kWG) >> 5;  // the warp's 16 rows of the tile
  const int gq = lane >> 2, tq = lane & 3;
  const int y0 = yt * kRows, x0 = xt * kCols;
  float ls[48], o[48], tre[16], tim[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) tre[i] = tim[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 48; ++i) o[i] = 0.f;
  mbar_wait(sm.tables_bar(), 0);

  int it = 0;
  for (int u = u0; u < u1; ++u) {
    const int tile = u / p.kv, v = u % p.kv;
    const int b = tile / p.ka, a = tile % p.ka;
    const float bv = __ldg(p.bias + v * p.ka + a);  // in flight while the products run
    if (u == u0 || v == 0) {
#pragma unroll
      for (int i = 0; i < 48; ++i) ls[i] = 0.f;
    }
    for (int c = 0; c < p.nchunks; ++c, ++it) {
      const int s = it % p.stages;
      mbar_wait(sm.full(r, s), (it / p.stages) & 1);
      const uint32_t stage = ring + (uint32_t)(s * stage_floats * 4);
      switch (min(p.gc, p.gp - c * p.gc) / 8) {
        case 4: chunk_products<4>(o, tre, tim, sm, p, stage, sm.empty(r, s), c); break;
        case 3: chunk_products<3>(o, tre, tim, sm, p, stage, sm.empty(r, s), c); break;
        case 2: chunk_products<2>(o, tre, tim, sm, p, stage, sm.empty(r, s), c); break;
        default: chunk_products<1>(o, tre, tim, sm, p, stage, sm.empty(r, s), c); break;
      }
    }
    wgmma_wait_all();
    fence_regs(o);
#pragma unroll
    for (int i = 0; i < 48; ++i) ls[i] += __logf(fmaxf(o[i] + bv, p.eps));

    if (v == p.kv - 1 || u == u1 - 1) {
      // This worker's last v of the tile: the tile's first worker writes
      // out, the k-th the (k - 1)-th scratch plane.
      const int part = worker - worker_of(tile * p.kv, p.units, p.workers);
      float* dst = (part == 0 ? p.out : p.scratch + (size_t)(part - 1) * p.n_out) +
                   (size_t)(b * p.ka + a) * p.h * p.w;
#pragma unroll
      for (int j = 0; j < kColGroups; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int y = y0 + 16 * wq + gq + 8 * (e >> 1);
          const int x = x0 + 8 * j + 2 * tq + (e & 1);
          if (y < p.h && x < p.w) dst[(size_t)y * p.w + x] = ls[4 * j + e];
        }
    }
  }
}

// out += the later parts of each tile, in worker order.
__global__ void mrf_tail_wgmma_combine_kernel(float* __restrict__ out,
                                              const float* __restrict__ scratch, long long n,
                                              int kv, int h, int w, int units, int workers) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int tile = (int)(i / ((long long)h * w));  // b * Ka + a
  const int parts = worker_of(tile * kv + kv - 1, units, workers) -
                    worker_of(tile * kv, units, workers);
  float acc = out[i];
  for (int part = 1; part <= parts; ++part) acc += scratch[(part - 1) * n + i];
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

// Workers of one tile slice: two a block, as many blocks as SMs share the
// slices, and never more than the units.
int workers_of(int units, int slices) {
  int per_slice = sm_count() / slices;
  if (per_slice < 1) per_slice = 1;
  const int workers = kRings * per_slice;
  return units < workers ? units : workers;
}

}  // namespace

// Shared memory of one block for a geometry, or -1 if it does not fit.
extern "C" long long mrf_tail_wgmma_smem_bytes(int ph, int g_bins) {
  const Plan plan = make_plan(ph, g_bins);
  return plan.stages == 0 ? -1 : plan.smem();
}

// Scratch planes (copies of the output) the partial log-sums need.
extern "C" int mrf_tail_wgmma_scratch_parts(int batch, int kv, int ka, int h, int w) {
  if (batch <= 0 || kv <= 0 || ka <= 0 || h <= 0 || w <= 0) return 0;
  const long long units = (long long)batch * ka * kv;
  if (units > 0x7fffffff) return 0;
  const int slices = ((h + kRows - 1) / kRows) * ((w + kCols - 1) / kCols);
  const int workers = workers_of((int)units, slices);
  const int run = (int)(units / workers);  // the shortest run
  const int parts = (kv - 1 + run - 1) / run + 1;
  return (parts < kv ? parts : kv) - 1;
}

// `scratch` holds mrf_tail_wgmma_scratch_parts(...) output-sized planes;
// `stride`: floats per row of the spectra.
extern "C" int mrf_tail_wgmma(const void* pf_re, const void* pf_im, const void* kf_re,
                              const void* kf_im, const void* ir_img, const void* ic_img,
                              const void* bias, void* out, void* scratch, int batch, int kv, int ka,
                              int ph, int g_bins, int stride, int h, int w, float eps,
                              void* stream) {
  if (batch == 0 || ka == 0 || h == 0 || w == 0) return 0;
  const Plan plan = make_plan(ph, g_bins);
  if (plan.stages == 0 || kv < 1 || ph < 1 || g_bins < 1 || stride < plan.gp || stride % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)batch * ka * kv;
  const long long n_out = (long long)batch * ka * h * w;
  if (units > 0x7fffffff || n_out > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int slices = ((h + kRows - 1) / kRows) * ((w + kCols - 1) / kCols);
  if (slices > 65535) return (int)cudaErrorInvalidValue;
  const int workers = workers_of((int)units, slices);
  const int blocks = (workers + kRings - 1) / kRings;
  const long long smem = plan.smem();
  cudaError_t err = cudaFuncSetAttribute(mrf_tail_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Args args{static_cast<const float*>(pf_re), static_cast<const float*>(pf_im),
                  static_cast<const float*>(kf_re), static_cast<const float*>(kf_im),
                  static_cast<const float*>(ir_img), static_cast<const float*>(ic_img),
                  static_cast<const float*>(bias), static_cast<float*>(out),
                  static_cast<float*>(scratch), kv, ka, ph, g_bins, stride, h, w,
                  plan.php, plan.gp, plan.gc, (plan.gp + plan.gc - 1) / plan.gc, plan.stages,
                  (int)units, workers, n_out, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  mrf_tail_wgmma_kernel<<<dim3((unsigned)blocks, (unsigned)slices), kThreads, smem, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || mrf_tail_wgmma_scratch_parts(batch, kv, ka, h, w) == 0) return (int)err;
  mrf_tail_wgmma_combine_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(
      static_cast<float*>(out), static_cast<const float*>(scratch), n_out, kv, h, w, (int)units,
      workers);
  return (int)cudaGetLastError();
}
