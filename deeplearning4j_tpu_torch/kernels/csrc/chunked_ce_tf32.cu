// Chunked LM cross-entropy for Hopper (sm_90a), f32: the forward (K3f) and
// one ce chunk's dlogits (K3b) of the tied head's softmax cross-entropy
// through TF32 wgmma on operands split in two, with x and E fed by TMA and
// every logit kept in registers. chunked_ce_wgmma.cu is the bf16 design
// this one follows; chunked_ce.cu keeps the scalar-FMA f32 kernel (and
// bf16 at d not a multiple of 64).
//
// Replaces `chunked_softmax_xent` of deeplearning4j_tpu/kernels/chunked_ce.py:
// `_forward_pieces` (:40, under the custom VJP :71-83: a lax.scan over vocab
// chunks of f32 logits x E_c^T, an online max and sum, the target logit
// picked from the chunk that holds it) and, per chunk, the dlogits of its
// backward `_bwd` (:85-110):
//   dlog = (exp(s - lse) - onehot(target)) * g / N, in f32.
// The two products of `_bwd` (dx += dlog E_c, dE_c = dlog^T x) stay plain
// f32 matrix products in the wrapper, as the reference leaves them to
// `dot_general`.
//
// What bounds it on the H100: 2 N V d FLOPs (550 GFLOP at N 8192, V 32768,
// d 1024) in f32. The port rounds no f32 product's operands to TF32 alone,
// so each operand a is split once, before the products, into
//   big = rna_tf32(a), small = rna_tf32(a - big)
// (ce_split_kernel: f32 bit patterns with the low 13 bits zero), and every
// logit is small_x big_e + big_x small_e + big_x big_e (small x small, below
// 2^-22 of the product, is dropped), three products on the tensor cores'
// TF32 path: 3.33 ms at the 495 TFLOP/s peak, against 8.2 ms for the FMA
// units at 67 TFLOP/s. Splitting inside the product loop would split each
// E tile once per row tile (64 times at N 8192); the split pass instead
// reads x and E once and writes both parts (480 MB at the training shape).
//
// - One block an SM: two consumer warpgroups of 64 rows each (a 128-row
//   tile of x) against a 256-row tile of E (256 vocab columns), plus one
//   producer warpgroup (384 threads; setmaxnreg 40 / 232).
// - One producer thread streams 32-column panels (128-byte rows, 128-byte
//   swizzle) of both parts of the x tile and of the E tile through TMA into
//   a ring of two 96 KB stages, each with a "full" mbarrier (transaction bytes) and
//   an "empty" one (all 256 consumer threads arrive once their products
//   have read the stage). The ring runs on across tiles. Rows past N and
//   vocab rows past V arrive zero-filled; the split pass zero-pads the
//   parts' rows to a multiple of 32 columns, so a panel never runs past a
//   row.
// - Each consumer warpgroup issues, per 8-deep step of a panel, the three
//   products small first. The tensor cores' f32 sums truncate: summed
//   there over all of d (1024), the logits drift toward zero by ~1e-5 of
//   their size, and K3b's dlogits read 6.9e-6 relative L2 from the plain
//   version against the 1e-5 row (PERF.md §6). So the sums are
//   promoted: each panel's twelve products go, 128 columns at a time, into
//   a zeroed accumulator (64 registers) that is waited for and added into
//   the tile's f32 accumulator (128 registers) with round-to-nearest
//   FADDs, and the truncation acts on one panel's partial sum only
//   (6.9e-7 from the plain version, 3.4e-7 from f64). While one warpgroup
//   adds, the other's products keep the tensor cores busy. (128-column
//   tiles in three 64 KB stages, and sums kept in the tensor cores, were
//   slower at the training shape: PERF.md §6.)
// - K3f's epilogue, per vocab tile, in registers: columns at or past V set
//   to -inf, the row max over the thread's columns and then the quad, the
//   running (m, l) by ex2.approx on log2(e)-scaled logits, and the target's
//   logit taken by the thread that holds its column; the partials per
//   vocab split go to ce_merge_kernel (chunked_ce_merge.cuh), which forms
//   lse and the loss in a fixed order: deterministic, no atomics.
// - K3b: a persistent grid (one block per SM) walks the (row tile, column
//   tile) pairs of one chunk, row tiles outer so that the blocks in flight
//   share the chunk's E tiles in L2. The epilogue forms the f32 dlogits in
//   registers and stores them from there, 8 bytes a thread and 32 bytes a
//   quad of threads (whole sectors): an f32 staging tile for a TMA store
//   would take 128 KB, the room of more than one ring stage. g is read on
//   the device.
//
// The parts are contiguous (rows, dp) f32, dp = d rounded up to 32; the E
// parts of a chunk are row views of E's; targets are int64; every other
// buffer is contiguous, the dlogits rows `ldo` apart (ldo even).

#include "hopper_wgmma.cuh"
#include "chunked_ce_merge.cuh"

namespace {

constexpr int BM = 128;               // rows of x in a block tile
constexpr int NCONSUMER = 256;        // threads of the two consumer warpgroups
constexpr int NPRODUCER = 128;        // the producer warpgroup
constexpr int NTHREADS = NCONSUMER + NPRODUCER;
constexpr int TF32_PANEL = 32;        // f32 columns in one 128-byte row
constexpr int X_PART = BM * 128;      // bytes of one part's panel of x
constexpr int SMEM_OPT_IN = 232448;   // the H100's shared-memory opt-in

constexpr int BN = 256;               // vocab columns (rows of E) a tile
constexpr int E_PART = BN * 128;      // bytes of one part's panel of E
// x big, x small, E big, E small: every part 1024-byte aligned
constexpr int STAGE = 2 * X_PART + 2 * E_PART;
constexpr int STAGES = (SMEM_OPT_IN - 1024 - 64) / STAGE;
constexpr int RING = STAGES * STAGE;
// + 1024 for aligning the base, + full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = 1024 + RING + 8 * 2 * STAGES;
static_assert(STAGES >= 2 && SMEM_BYTES <= SMEM_OPT_IN,
              "two stages must fit the H100's shared memory");

struct Args {
  const long long* targets;   // (n,) global vocab ids
  int n, v;                   // rows of x; rows of E (K3f) or of the chunk
  int panels;                 // dp / 32
  // K3f: vocab tiles of each split, and the (3, splits, n) partials
  int splits, tiles_per_split;
  float* part;
  // K3b
  const float* lse;           // (n,)
  const float* g;             // the loss's cotangent, one f32
  float* dlog;                // (n, v), row stride ldo
  long long ldo;
  int n_total;                // the mean's denominator, B * T
  int col0;                   // global vocab id of the chunk's row 0
};

// The tiles a block walks, in order: K3f its split's vocab tiles against
// its row tile; K3b every (row tile, column tile) pair of the chunk from
// blockIdx.x on, gridDim.x apart.
template <bool DLOGITS> struct Schedule {
  int count, first, stride, col_tiles;
  __device__ Schedule(const Args& a) {
    const int tiles = (a.v + BN - 1) / BN;
    if constexpr (DLOGITS) {
      const int total = ((a.n + BM - 1) / BM) * tiles;
      first = blockIdx.x;
      stride = gridDim.x;
      count = first < total ? (total - first + stride - 1) / stride : 0;
    } else {
      first = blockIdx.y * a.tiles_per_split;
      stride = 1;
      count = min(a.tiles_per_split, tiles - first);
    }
    col_tiles = tiles;
  }
  // (first row, first vocab column) of tile j of this block
  __device__ void at(int j, int& row0, int& col) const {
    const int id = first + j * stride;
    if constexpr (DLOGITS) {
      row0 = (id / col_tiles) * BM;
      col = (id % col_tiles) * BN;
    } else {
      row0 = blockIdx.x * BM;
      col = id * BN;
    }
  }
};

// The ring's position: stage and the parity of its current phase.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from
// zero) in two integer ops: half of the dropped 13 bits added to the
// pattern carries into the kept bits exactly when rounding away does
__device__ __forceinline__ float rna_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// Both operands' parts: rows of x (n, d) then rows of e (v, d), each into
// its big and small parts (rows dp apart, the columns past d zero), four
// columns a thread.
__global__ void __launch_bounds__(256)
ce_split_kernel(const float* x, long long ldx, int n, const float* e,
                long long lde, int v, int d, int dp, float* xb, float* xs,
                float* eb, float* es) {
  const int q = dp / 4;
  const long long total = (long long)(n + v) * q;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    long long r = i / q;
    const int c = (int)(i - r * q) * 4;
    const float* src;
    float *big, *small;
    if (r < n) {
      src = x + r * ldx;
      big = xb + r * dp;
      small = xs + r * dp;
    } else {
      r -= n;
      src = e + r * lde;
      big = eb + r * dp;
      small = es + r * dp;
    }
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c < d) a = *reinterpret_cast<const float4*>(src + c);
    const float4 hi = make_float4(rna_tf32(a.x), rna_tf32(a.y),
                                  rna_tf32(a.z), rna_tf32(a.w));
    const float4 lo = make_float4(rna_tf32(a.x - hi.x), rna_tf32(a.y - hi.y),
                                  rna_tf32(a.z - hi.z), rna_tf32(a.w - hi.w));
    *reinterpret_cast<float4*>(big + c) = hi;
    *reinterpret_cast<float4*>(small + c) = lo;
  }
}

// The descriptors of depth step kk of a panel: x's rows of this warpgroup
// and E's rows [h * 128, ...) of both parts.
struct Panel {
  uint32_t xb, xs, eb, es;
  __device__ __forceinline__ Panel(uint32_t stage, int wg, int h) {
    const uint32_t x_off = wg * 64 * 128, e_off = h * 128 * 128;
    xb = stage + x_off;
    xs = stage + X_PART + x_off;
    eb = stage + 2 * X_PART + e_off;
    es = stage + 2 * X_PART + E_PART + e_off;
  }
};

// One panel's twelve products (four depth steps of three, small first) into
// the 128-column accumulator acc, the first of the group overwriting it.
// Issues and commits.
__device__ __forceinline__ void issue_panel(float (&acc)[64], const Panel& p) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t xb = smem_desc(p.xb + kk * 32, 16, 1024);
    const uint64_t xs = smem_desc(p.xs + kk * 32, 16, 1024);
    const uint64_t eb = smem_desc(p.eb + kk * 32, 16, 1024);
    const uint64_t es = smem_desc(p.es + kk * 32, 16, 1024);
    wgmma_tf32_n128(acc, xs, eb, kk > 0);
    wgmma_tf32_n128(acc, xb, es, 1);
    wgmma_tf32_n128(acc, xb, eb, 1);
  }
  wgmma_commit();
}

// acc = x_tile[wg rows] E_tile^T over every panel of d with the sums
// promoted: each panel's products, 128 columns at a time, into the zeroed
// partial accumulator `pa`, waited for and added into acc in f32 (round to
// nearest); each stage is released once its products are done.
__device__ __forceinline__ void tile_products(float (&acc)[BN / 2],
                                              float (&pa)[64], Ring& ring,
                                              uint32_t ring_base,
                                              uint32_t bar_full,
                                              uint32_t bar_empty, int wg,
                                              int panels) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int p = 0; p < panels; ++p) {
    mbar_wait(bar_full + 8 * ring.stage, ring.phase);
    const uint32_t stage = ring_base + ring.stage * STAGE;
#pragma unroll
    for (int h = 0; h < BN / 128; ++h) {
      reg_fence(pa);
      wgmma_fence();
      issue_panel(pa, Panel(stage, wg, h));
      wgmma_wait<0>();
      reg_fence(pa);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[64 * h + i] += pa[i];
    }
    mbar_arrive(bar_empty + 8 * ring.stage);
    ring.next();
  }
}

// Column of register i of a thread's accumulator, less 2 (lane % 4).
__device__ __forceinline__ constexpr int col_of(int i) {
  return 8 * (i / 4) + (i & 1);
}

// K3f's running state for the thread's two rows.
struct Online {
  float m0 = -INFINITY, m1 = -INFINITY;   // running max, logit units
  float l0 = 0.0f, l1 = 0.0f;             // this thread's part of the sums
  float c0 = 0.0f, c1 = 0.0f;             // the target logit, where held
};

// Fold one vocab tile's logits (columns col .. col + BN - 1) into the
// state: `rem` is V - col, `colq` the thread's first column (2 (lane % 4)),
// and t0, t1 the rows' target columns less col and colq.
__device__ __forceinline__ void fold_tile(float (&acc)[BN / 2], Online& st,
                                          int rem, int colq, int t0,
                                          int t1) {
  constexpr int R = BN / 2;
  if (rem < BN) {                       // the ragged end of the vocab
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (col_of(i) + colq >= rem) acc[i] = -INFINITY;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(acc[i], acc[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(acc[i + 2], acc[i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // every tile holds a column below V, so the new max is finite
  const float mn0 = fmaxf(st.m0, mx0), mn1 = fmaxf(st.m1, mx1);
  const float mc0 = -mn0 * LOG2E, mc1 = -mn1 * LOG2E;
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    s0 += fast_exp2(fmaf(acc[i], LOG2E, mc0)) +
          fast_exp2(fmaf(acc[i + 1], LOG2E, mc0));
    s1 += fast_exp2(fmaf(acc[i + 2], LOG2E, mc1)) +
          fast_exp2(fmaf(acc[i + 3], LOG2E, mc1));
  }
  st.l0 = st.l0 * fast_exp2((st.m0 - mn0) * LOG2E) + s0;
  st.l1 = st.l1 * fast_exp2((st.m1 - mn1) * LOG2E) + s1;
  st.m0 = mn0;
  st.m1 = mn1;
  // the target's column falls in this tile for one tile in V / BN
  if ((unsigned)(t0 + 6) < (unsigned)(BN + 6)) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (!(i & 2) && col_of(i) == t0) st.c0 += acc[i];
  }
  if ((unsigned)(t1 + 6) < (unsigned)(BN + 6)) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if ((i & 2) && col_of(i) == t1) st.c1 += acc[i];
  }
}

// K3b's epilogue for one tile: the dlogits in registers, stored from there
// as pairs of columns. o0, o1 point at the thread's first column of its two
// rows (null for a row past N); `crem` is the chunk's columns left from the
// thread's first.
__device__ __forceinline__ void store_dlogits(float (&acc)[BN / 2],
                                              float* o0, float* o1, int crem,
                                              float scale, float nl0,
                                              float nl1, int t0, int t1) {
  constexpr int R = BN / 2;
#pragma unroll
  for (int i = 0; i < R; ++i)
    acc[i] = fast_exp2(fmaf(acc[i], LOG2E, (i & 2) ? nl1 : nl0)) * scale;
  if ((unsigned)(t0 + 6) < (unsigned)(BN + 6)) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (!(i & 2) && col_of(i) == t0) acc[i] -= scale;
  }
  if ((unsigned)(t1 + 6) < (unsigned)(BN + 6)) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if ((i & 2) && col_of(i) == t1) acc[i] -= scale;
  }
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    float* o = (i & 2) ? o1 : o0;
    if (o != nullptr && col_of(i) < crem)
      *reinterpret_cast<float2*>(o + col_of(i)) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// ---------------------------------------------------------------- the kernel

template <bool DLOGITS>
__global__ void __launch_bounds__(NTHREADS, 1)
ce_tf32_kernel(const __grid_constant__ CUtensorMap tm_xb,
               const __grid_constant__ CUtensorMap tm_xs,
               const __grid_constant__ CUtensorMap tm_eb,
               const __grid_constant__ CUtensorMap tm_es, Args a) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: align every tile to them
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + RING;              // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // [STAGES]
  const Schedule<DLOGITS> sched(a);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NCONSUMER) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == NCONSUMER) {
      Ring ring;
      int it = 0;
      for (int j = 0; j < sched.count; ++j) {
        int row0, col;
        sched.at(j, row0, col);
        for (int p = 0; p < a.panels; ++p, ++it) {
          if (it >= STAGES)   // both warpgroups have released the stage
            mbar_wait(bar_empty + 8 * ring.stage, ring.phase ^ 1);
          const uint32_t full = bar_full + 8 * ring.stage;
          const uint32_t st = base + ring.stage * STAGE;
          const int k = p * TF32_PANEL;
          mbar_expect_tx(full, STAGE);
          tma_load_2d(st, &tm_xb, full, k, row0);
          tma_load_2d(st + X_PART, &tm_xs, full, k, row0);
          tma_load_2d(st + 2 * X_PART, &tm_eb, full, k, col);
          tma_load_2d(st + 2 * X_PART + E_PART, &tm_es, full, k, col);
          ring.next();
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int lane = t % 32;
    // the thread's rows within the block tile, and its first column
    const int r0 = wg * 64 + 16 * (t / 32) + lane / 4, r1 = r0 + 8;
    const int colq = 2 * (lane % 4);
    float acc[BN / 2];
    float pa[64];
    Ring ring;
    if constexpr (!DLOGITS) {
      const int row0 = blockIdx.x * BM;
      const int g0 = row0 + r0, g1 = row0 + r1;
      // targets as column offsets from the thread's first column
      const int tg0 = (g0 < a.n ? (int)a.targets[g0] : -BN - 8) - colq;
      const int tg1 = (g1 < a.n ? (int)a.targets[g1] : -BN - 8) - colq;
      Online st;
      for (int j = 0; j < sched.count; ++j) {
        int row_unused, col;
        sched.at(j, row_unused, col);
        tile_products(acc, pa, ring, base, bar_full, bar_empty, wg, a.panels);
        fold_tile(acc, st, a.v - col, colq, tg0 - col, tg1 - col);
      }
      // the quad's four parts of each row (same m), then one write a row
      float l0 = st.l0, l1 = st.l1, c0 = st.c0, c1 = st.c1;
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        c0 += __shfl_xor_sync(0xffffffffu, c0, off);
        c1 += __shfl_xor_sync(0xffffffffu, c1, off);
      }
      if (lane % 4 == 0) {
        const long long plane = (long long)a.splits * a.n;
        const long long at = (long long)blockIdx.y * a.n;
        if (g0 < a.n) {
          a.part[at + g0] = st.m0;
          a.part[plane + at + g0] = l0;
          a.part[2 * plane + at + g0] = c0;
        }
        if (g1 < a.n) {
          a.part[at + g1] = st.m1;
          a.part[plane + at + g1] = l1;
          a.part[2 * plane + at + g1] = c1;
        }
      }
    } else {
      // the reference's scale (g / (B * T)) in f32
      const float scale = a.g[0] / (float)a.n_total;
      for (int j = 0; j < sched.count; ++j) {
        int row0, col;
        sched.at(j, row0, col);
        const int g0 = row0 + r0, g1 = row0 + r1;
        const bool in0 = g0 < a.n, in1 = g1 < a.n;
        // -lse in log2 units, and the targets as column offsets in the
        // chunk from the thread's first column
        const float nl0 = in0 ? -a.lse[g0] * LOG2E : 0.0f;
        const float nl1 = in1 ? -a.lse[g1] * LOG2E : 0.0f;
        const long long tl0 = in0 ? a.targets[g0] - a.col0 - col - colq : -BN;
        const long long tl1 = in1 ? a.targets[g1] - a.col0 - col - colq : -BN;
        const int t0 = (int)max(min(tl0, (long long)BN), (long long)-BN);
        const int t1 = (int)max(min(tl1, (long long)BN), (long long)-BN);
        float* o0 = in0 ? a.dlog + g0 * a.ldo + col + colq : nullptr;
        float* o1 = in1 ? a.dlog + g1 * a.ldo + col + colq : nullptr;
        tile_products(acc, pa, ring, base, bar_full, bar_empty, wg, a.panels);
        store_dlogits(acc, o0, o1, a.v - col - colq, scale, nl0, nl1, t0, t1);
      }
    }
  }
}

// ------------------------------------------------------------------ host side

template <bool DLOGITS>
cudaError_t launch(dim3 grid, const CUtensorMap (&m)[4], const Args& a,
                   cudaStream_t s) {
  // the shared-memory opt-in, once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      ce_tf32_kernel<DLOGITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  ce_tf32_kernel<DLOGITS>
      <<<grid, NTHREADS, SMEM_BYTES, s>>>(m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

// The four parts' tensor maps: x's (n, dp) and E's (v, dp), rows dp apart.
CUresult encode_parts(CUtensorMap (&m)[4], const void* xb, const void* xs,
                      const void* eb, const void* es, int n, int v, int dp,
                      long long lde) {
  CUresult r = encode_2d_f32(&m[0], xb, n, dp, dp, BM);
  if (r == CUDA_SUCCESS) r = encode_2d_f32(&m[1], xs, n, dp, dp, BM);
  if (r == CUDA_SUCCESS) r = encode_2d_f32(&m[2], eb, v, dp, lde, BN);
  if (r == CUDA_SUCCESS) r = encode_2d_f32(&m[3], es, v, dp, lde, BN);
  return r;
}

bool bad_shape(int n, int v, int dp) {
  return n < 1 || v < 1 || dp < TF32_PANEL || dp % TF32_PANEL != 0;
}

}  // namespace

// Plain C interface, loaded with ctypes; f32 only. Each returns 0, the
// first failing launch's cudaError_t, or -CUresult when a tensor map cannot
// be encoded, and never synchronises.

// The split pass: x (n, d), rows ldx apart, and e (v, d), rows lde apart,
// into xb, xs (n, dp) and eb, es (v, dp), contiguous; d % 4 == 0, dp the
// multiple of 32 at or above d, both operands 16-byte aligned.
extern "C" int dl4j_ce_split_tf32(const void* x, const void* e, void* xb,
                                  void* xs, void* eb, void* es, int n, int v,
                                  int d, int dp, long long ldx, long long lde,
                                  void* stream) {
  if (n < 0 || v < 0 || d < 4 || d % 4 != 0 || dp < d ||
      dp % TF32_PANEL != 0 || dp - d >= TF32_PANEL)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)(n + v) * (dp / 4);
  if (total == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long want = (total + 255) / 256;
  const int grid = (int)(want < 16ll * sms ? want : 16ll * sms);
  ce_split_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ldx, n, static_cast<const float*>(e), lde,
      v, d, dp, static_cast<float*>(xb), static_cast<float*>(xs),
      static_cast<float*>(eb), static_cast<float*>(es));
  return (int)cudaGetLastError();
}

// K3f: lse (n,) f32 and loss (1,) f32 from the parts of x (n, dp) and of e
// (v, dp) and targets (n,) int64; part is (3, splits, n) f32 scratch, each
// split tiles_per_split vocab tiles of 256 columns.
extern "C" int dl4j_ce_fwd_tf32(const void* xb, const void* xs,
                                const void* eb, const void* es,
                                const long long* targets, void* part,
                                void* lse, void* loss, int n, int v, int dp,
                                int splits, int tiles_per_split,
                                void* stream) {
  if (bad_shape(n, v, dp) || splits < 1 || splits > 65535 ||
      tiles_per_split < 1 ||
      (long long)(splits - 1) * tiles_per_split * BN >= (long long)v ||
      (long long)splits * tiles_per_split * BN < (long long)v)
    return (int)cudaErrorInvalidValue;
  if (cudaError_t err = bind_context()) return (int)err;
  CUtensorMap m[4];
  if (CUresult r = encode_parts(m, xb, xs, eb, es, n, v, dp, dp))
    return -(int)r;
  Args a{};
  a.targets = targets;
  a.n = n; a.v = v; a.panels = dp / TF32_PANEL;
  a.splits = splits; a.tiles_per_split = tiles_per_split;
  a.part = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch<false>(dim3((n + BM - 1) / BM, splits), m, a, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(a.part, splits, n, static_cast<float*>(lse),
                           static_cast<float*>(loss), s);
}

// K3b: dlog (n, c) f32, rows ldo apart (ldo even), for the chunk whose
// parts eb, es (c, dp, rows lde apart) start at global vocab id col0:
// (exp(x e^T - lse) - onehot) * g[0] / n_total.
extern "C" int dl4j_ce_dlogits_tf32(const void* xb, const void* xs,
                                    const void* eb, const void* es,
                                    const long long* targets,
                                    const void* lse, const void* g,
                                    void* dlog, int n, int c, int dp,
                                    long long lde, long long ldo, int col0,
                                    int n_total, void* stream) {
  if (bad_shape(n, c, dp) || n_total < 1 || ldo < c || ldo % 2 != 0)
    return (int)cudaErrorInvalidValue;
  if (cudaError_t err = bind_context()) return (int)err;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap m[4];
  if (CUresult r = encode_parts(m, xb, xs, eb, es, n, c, dp, lde))
    return -(int)r;
  Args a{};
  a.targets = targets;
  a.n = n; a.v = c; a.panels = dp / TF32_PANEL;
  a.lse = static_cast<const float*>(lse);
  a.g = static_cast<const float*>(g);
  a.dlog = static_cast<float*>(dlog);
  a.ldo = ldo;
  a.n_total = n_total;
  a.col0 = col0;
  const long long tiles =
      (long long)((n + BM - 1) / BM) * ((c + BN - 1) / BN);
  if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  return (int)launch<true>(dim3(grid), m, a, static_cast<cudaStream_t>(stream));
}

extern "C" const char* dl4j_ce_tf32_error_string(int err) {
  if (err < 0) return "cuTensorMapEncodeTiled failed (see the CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
