// Chunked LM cross-entropy for Hopper (sm_90a), bf16 at d a multiple of 64:
// the forward (K3f) and one ce chunk's dlogits (K3b) of the tied head's
// softmax cross-entropy through wgmma, with x and E fed by TMA and every
// logit kept in registers. chunked_ce.cu keeps f32 and bf16 at other d.
//
// Replaces `chunked_softmax_xent` of deeplearning4j_tpu/kernels/chunked_ce.py:
// `_forward_pieces` (:40, under the custom VJP :71-83: a lax.scan over vocab
// chunks of f32 logits x E_c^T, an online max and sum, the target logit
// picked from the chunk that holds it) and, per chunk, the dlogits of its
// backward `_bwd` (:85-110):
//   dlog = (exp(s - lse) - onehot(target)) * g / N, cast to bf16.
// The two products of `_bwd` (dx += dlog E_c, dE_c = dlog^T x) stay plain
// f32-accumulated matrix products in the wrapper, as the reference leaves
// them to `dot_general`.
//
// What bounds it on the H100: 2 N V d FLOPs (550 GFLOP at N 8192, V 32768,
// d 1024: 0.556 ms at the dense bf16 peak) against reading x and E once
// (84 MB), so the tensor cores; K3b writes N C bf16 dlogits besides (67 MB a
// chunk at C 4096), below its products' time. Only wgmma reaches the
// tensor cores' full rate, and a block tile re-reads x once per vocab tile
// and E once per row tile from L2, so the design:
//
// - One block per SM-sized piece of work: two consumer warpgroups of 64
//   rows each (a 128-row tile of x) against a 256-row tile of E (256 vocab
//   columns), plus one producer warpgroup (384 threads; setmaxnreg 40 /
//   232). At 128 x 256 the L2 traffic is N V d 2 B (1/256 + 1/128), 6.4 GB
//   at the training shape, against 8.6 GB for chunked_ce.cu's 128 x 128.
// - One producer thread streams 64-column panels (128-byte rows, 128-byte
//   swizzle) of the x tile and the E tile through TMA into a ring of 4
//   stages (3 for K3b, whose output staging takes the room of the fourth),
//   each with a "full" mbarrier (transaction bytes) and an "empty" one (all
//   256 consumer threads arrive once their products have read the stage).
//   The ring runs on across tiles, so a tile's first panels load while the
//   last tile's epilogue runs. Rows past N and vocab rows past V arrive
//   zero-filled.
// - Each consumer warpgroup runs wgmma m64n256k16 from shared memory
//   (both operands K-major) into 128 f32 registers a thread, one product
//   group per panel, the next panel's issued before the last one's is
//   waited for.
// - K3f's epilogue, per vocab tile, in registers (the m64nN accumulator
//   layout of hopper_wgmma.cuh: a thread holds two rows, 64 columns of
//   each): columns at or past V set to -inf (a zero-filled row of E gives a
//   logit of 0, which must not enter the sum), the row max over the
//   thread's columns and then the quad (shfl_xor 1, 2), the running (m, l)
//   updated with ex2.approx on log2(e)-scaled logits, and the target's
//   logit taken by the thread that holds its column. A block walks the
//   vocab tiles of one split; its partial (m, l, correct) per row goes to
//   ce_merge_kernel (chunked_ce_merge.cuh), which forms lse and the loss in
//   a fixed order: deterministic, no atomics.
// - K3b: a persistent grid (one block per SM) walks the (row tile, column
//   tile) pairs of one chunk, row tiles outer so that the blocks in flight
//   share the chunk's E tiles in L2. The epilogue forms the dlogits in
//   registers, packs them to bf16 into a 128-byte-swizzled staging tile in
//   shared memory (conflict-free) and writes it with TMA stores, which drop
//   the rows past N and columns past C. g is read on the device.
//
// x (N, d) and E (V, d), or the chunk E_c (C, d), are row-major with unit
// stride on d, row strides and bases 16-byte aligned (the wrapper checks
// this); targets are int64; every other buffer is contiguous.

#include "hopper_wgmma.cuh"
#include "chunked_ce_merge.cuh"

namespace {

constexpr int BM = 128;               // rows of x in a block tile
constexpr int BN = 256;               // vocab columns (rows of E) in a tile
constexpr int NCONSUMER = 256;        // threads of the two consumer warpgroups
constexpr int NPRODUCER = 128;        // the producer warpgroup
constexpr int NTHREADS = NCONSUMER + NPRODUCER;
constexpr int X_PANEL = BM * 128;     // bytes of a 64-column panel of x
constexpr int E_PANEL = BN * 128;     // ... and of E
constexpr int OUT_PANEL = 64 * 128;   // a 64 x 64 bf16 box of dlogits

template <bool DLOGITS> struct Smem {
  static constexpr int STAGES = DLOGITS ? 3 : 4;
  static constexpr int STAGE = X_PANEL + E_PANEL;
  // K3b: each warpgroup's 64 x 256 dlogits as four 64 x 64 boxes
  static constexpr int STAGING = DLOGITS ? 2 * 4 * OUT_PANEL : 0;
  static constexpr int BARRIERS = STAGES * STAGE + STAGING;
  // + 1024 for aligning the base, + full[STAGES], empty[STAGES]
  static constexpr int BYTES = 1024 + BARRIERS + 8 * 2 * STAGES;
  static_assert(BYTES <= 227 * 1024, "over the H100's shared memory opt-in");
};

struct Args {
  const long long* targets;   // (n,) global vocab ids
  int n, v;                   // rows of x; rows of E (K3f) or of the chunk
  int panels;                 // d / 64
  // K3f: vocab tiles of each split, and the (3, splits, n) partials
  int splits, tiles_per_split;
  float* part;
  // K3b
  const float* lse;           // (n,)
  const float* g;             // the loss's cotangent, one f32
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
  template <int STAGES> __device__ __forceinline__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// One panel's products into acc: four depth steps of 16 columns, the first
// of the tile's first panel overwriting acc. Issues and commits.
template <bool FIRST>
__device__ __forceinline__ void issue_panel(float (&acc)[128], uint32_t sx,
                                            uint32_t se) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n256(acc, smem_desc(sx + kk * 32, 16, 1024),
                  smem_desc(se + kk * 32, 16, 1024), !FIRST || kk > 0);
  wgmma_commit();
}

// acc = x_tile[wg rows] E_tile^T over every panel of d: one wgmma group per
// panel, the next issued before the previous one is waited for; each
// stage is released once the products that read it are done.
template <int STAGES>
__device__ __forceinline__ void tile_products(float (&acc)[128], Ring& ring,
                                              uint32_t ring_base,
                                              uint32_t bar_full,
                                              uint32_t bar_empty, int wg,
                                              int panels) {
  constexpr int STAGE = X_PANEL + E_PANEL;
  const uint32_t x_off = wg * 64 * 128;   // this warpgroup's 64 rows
  reg_fence(acc);
  mbar_wait(bar_full + 8 * ring.stage, ring.phase);
  wgmma_fence();
  uint32_t sx = ring_base + ring.stage * STAGE;
  issue_panel<true>(acc, sx + x_off, sx + X_PANEL);
  int prev = ring.stage;
  ring.next<STAGES>();
  for (int p = 1; p < panels; ++p) {
    mbar_wait(bar_full + 8 * ring.stage, ring.phase);
    wgmma_fence();
    sx = ring_base + ring.stage * STAGE;
    issue_panel<false>(acc, sx + x_off, sx + X_PANEL);
    wgmma_wait<1>();                    // panel p - 1's products are done
    mbar_arrive(bar_empty + 8 * prev);
    prev = ring.stage;
    ring.next<STAGES>();
  }
  wgmma_wait<0>();
  reg_fence(acc);
  mbar_arrive(bar_empty + 8 * prev);
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

// Fold one vocab tile's logits (columns col .. col + 255) into the state:
// `rem` is V - col, `colq` the thread's first column (2 (lane % 4)), and
// t0, t1 the rows' target columns less col and colq.
__device__ __forceinline__ void fold_tile(float (&acc)[128], Online& st,
                                          int rem, int colq, int t0,
                                          int t1) {
  if (rem < BN) {                       // the ragged end of the vocab
#pragma unroll
    for (int i = 0; i < 128; ++i)
      if (col_of(i) + colq >= rem) acc[i] = -INFINITY;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 128; i += 4) {
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
  for (int i = 0; i < 128; i += 4) {
    s0 += fast_exp2(fmaf(acc[i], LOG2E, mc0)) +
          fast_exp2(fmaf(acc[i + 1], LOG2E, mc0));
    s1 += fast_exp2(fmaf(acc[i + 2], LOG2E, mc1)) +
          fast_exp2(fmaf(acc[i + 3], LOG2E, mc1));
  }
  st.l0 = st.l0 * fast_exp2((st.m0 - mn0) * LOG2E) + s0;
  st.l1 = st.l1 * fast_exp2((st.m1 - mn1) * LOG2E) + s1;
  st.m0 = mn0;
  st.m1 = mn1;
  // the target's column falls in this tile for one tile in V / 256
  if ((unsigned)(t0 + 6) < (unsigned)(BN + 6)) {
#pragma unroll
    for (int i = 0; i < 128; ++i)
      if (!(i & 2) && col_of(i) == t0) st.c0 += acc[i];
  }
  if ((unsigned)(t1 + 6) < (unsigned)(BN + 6)) {
#pragma unroll
    for (int i = 0; i < 128; ++i)
      if ((i & 2) && col_of(i) == t1) st.c1 += acc[i];
  }
}

// K3b's epilogue for one tile: the dlogits in registers, bf16 into this
// warpgroup's 128-byte-swizzled staging boxes, then TMA stores.
__device__ __forceinline__ void store_dlogits(
    float (&acc)[128], const CUtensorMap* tm_out, uint32_t stage_wg, int t,
    int row0_wg, int col, float scale, float nl0, float nl1, int t0,
    int t1) {
#pragma unroll
  for (int i = 0; i < 128; ++i)
    acc[i] = fast_exp2(fmaf(acc[i], LOG2E, (i & 2) ? nl1 : nl0)) * scale;
  if ((unsigned)(t0 + 6) < (unsigned)(BN + 6)) {
#pragma unroll
    for (int i = 0; i < 128; ++i)
      if (!(i & 2) && col_of(i) == t0) acc[i] -= scale;
  }
  if ((unsigned)(t1 + 6) < (unsigned)(BN + 6)) {
#pragma unroll
    for (int i = 0; i < 128; ++i)
      if ((i & 2) && col_of(i) == t1) acc[i] -= scale;
  }
  const int wg = threadIdx.x / 128, lane = t % 32;
  // the last tile's stores have read the staging boxes
  if (t == 0) bulk_wait_read();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  // row r of a box at r * 128 bytes, its 16-byte chunk k at k ^ (r % 8);
  // the thread's rows are 8 apart, so r % 8 is lane / 4 for both
  const int r0 = 16 * (t / 32) + lane / 4;
  const uint32_t row_base = stage_wg + r0 * 128 + 4 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 128; i += 2) {
    const int box = i / 32, chunk = (i / 4) % 8;
    const uint32_t addr = row_base + box * OUT_PANEL + ((i & 2) ? 8 * 128 : 0)
                          + ((chunk ^ (lane / 4)) << 4);
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr),
                 "r"(pack_bf16(acc[i], acc[i + 1]))
                 : "memory");
  }
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (t == 0) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      tma_store_2d(tm_out, stage_wg + b * OUT_PANEL, col + 64 * b, row0_wg);
    bulk_commit();
  }
}

// ---------------------------------------------------------------- the kernel

template <bool DLOGITS>
__global__ void __launch_bounds__(NTHREADS, 1)
ce_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_e,
                const __grid_constant__ CUtensorMap tm_out, Args a) {
  using S = Smem<DLOGITS>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: align every tile to them
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t staging = base + STAGES * S::STAGE;
  const uint32_t bar_full = base + S::BARRIERS;       // [STAGES]
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
          const uint32_t sx = base + ring.stage * S::STAGE;
          mbar_expect_tx(full, S::STAGE);
          tma_load_2d(sx, &tm_x, full, p * PANEL, row0);
          tma_load_2d(sx + X_PANEL, &tm_e, full, p * PANEL, col);
          ring.next<STAGES>();
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
    float acc[128];
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
        tile_products<STAGES>(acc, ring, base, bar_full, bar_empty, wg,
                              a.panels);
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
      const uint32_t stage_wg = staging + wg * 4 * OUT_PANEL;
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
        tile_products<STAGES>(acc, ring, base, bar_full, bar_empty, wg,
                              a.panels);
        store_dlogits(acc, &tm_out, stage_wg, t, row0 + wg * 64, col, scale,
                      nl0, nl1, t0, t1);
      }
      if (t == 0) bulk_wait();
    }
  }
}

// ------------------------------------------------------------------ host side

template <bool DLOGITS>
cudaError_t launch(dim3 grid, const CUtensorMap& tx, const CUtensorMap& te,
                   const CUtensorMap& to, const Args& a, cudaStream_t s) {
  // the shared-memory opt-in, once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      ce_wgmma_kernel<DLOGITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<DLOGITS>::BYTES);
  if (attr != cudaSuccess) return attr;
  ce_wgmma_kernel<DLOGITS>
      <<<grid, NTHREADS, Smem<DLOGITS>::BYTES, s>>>(tx, te, to, a);
  return cudaGetLastError();
}

bool bad_shape(int n, int v, int d) {
  return n < 1 || v < 1 || d < PANEL || d % PANEL != 0;
}

}  // namespace

// Plain C interface, loaded with ctypes; bf16 x and E only. Each returns 0,
// the first failing launch's cudaError_t, or -CUresult when a tensor map
// cannot be encoded, and never synchronises.

// K3f: lse (n,) f32 and loss (1,) f32 of x (n, d) against e (v, d) and
// targets (n,) int64; part is (3, splits, n) f32 scratch, each split
// tiles_per_split vocab tiles of 256.
extern "C" int dl4j_ce_fwd_wgmma(const void* x, const void* e,
                                 const long long* targets, void* part,
                                 void* lse, void* loss, int n, int v, int d,
                                 long long ldx, long long lde, int splits,
                                 int tiles_per_split, void* stream) {
  if (bad_shape(n, v, d) || splits < 1 || splits > 65535 ||
      tiles_per_split < 1 ||
      (long long)(splits - 1) * tiles_per_split * BN >= (long long)v ||
      (long long)splits * tiles_per_split * BN < (long long)v)
    return (int)cudaErrorInvalidValue;
  if (cudaError_t err = bind_context()) return (int)err;
  CUtensorMap tx, te;
  CUresult r = encode_2d(&tx, x, n, d, ldx, BM);
  if (r == CUDA_SUCCESS) r = encode_2d(&te, e, v, d, lde, BN);
  if (r != CUDA_SUCCESS) return -(int)r;
  Args a{};
  a.targets = targets;
  a.n = n; a.v = v; a.panels = d / PANEL;
  a.splits = splits; a.tiles_per_split = tiles_per_split;
  a.part = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the output map is not read by the forward: any valid map will do
  cudaError_t err = launch<false>(dim3((n + BM - 1) / BM, splits), tx, te, tx,
                                  a, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(a.part, splits, n, static_cast<float*>(lse),
                           static_cast<float*>(loss), s);
}

// K3b: dlog (n, c) bf16, row stride ldo, for the chunk e (c, d) whose row
// 0 is global vocab id col0: (exp(x e^T - lse) - onehot) * g[0] / n_total.
extern "C" int dl4j_ce_dlogits_wgmma(const void* x, const void* e,
                                     const long long* targets,
                                     const void* lse, const void* g,
                                     void* dlog, int n, int c, int d,
                                     long long ldx, long long lde,
                                     long long ldo, int col0, int n_total,
                                     void* stream) {
  if (bad_shape(n, c, d) || n_total < 1) return (int)cudaErrorInvalidValue;
  if (cudaError_t err = bind_context()) return (int)err;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tx, te, to;
  CUresult r = encode_2d(&tx, x, n, d, ldx, BM);
  if (r == CUDA_SUCCESS) r = encode_2d(&te, e, c, d, lde, BN);
  if (r == CUDA_SUCCESS) r = encode_2d(&to, dlog, n, c, ldo, 64);
  if (r != CUDA_SUCCESS) return -(int)r;
  Args a{};
  a.targets = targets;
  a.n = n; a.v = c; a.panels = d / PANEL;
  a.lse = static_cast<const float*>(lse);
  a.g = static_cast<const float*>(g);
  a.n_total = n_total;
  a.col0 = col0;
  const long long tiles =
      (long long)((n + BM - 1) / BM) * ((c + BN - 1) / BN);
  if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  return (int)launch<true>(dim3(grid), tx, te, to, a,
                           static_cast<cudaStream_t>(stream));
}

extern "C" const char* dl4j_ce_wgmma_error_string(int err) {
  if (err < 0) return "cuTensorMapEncodeTiled failed (see the CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
