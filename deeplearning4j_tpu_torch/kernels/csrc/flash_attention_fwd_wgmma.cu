// Flash-attention forward for Hopper (sm_90a): wgmma, TMA, bf16, d in {64, 128}.
//
// Replaces the Pallas TPU kernel `_attn_fwd_kernel` (launched by `_fwd_pallas`)
// in deeplearning4j_tpu/kernels/flash_attention.py for bf16 operands at head
// dim 64 and 128; flash_attention_fwd.cu keeps every other dtype and head dim.
// It computes the same function: o = softmax(q k^T * scale) v and
// lse = m + log l per query row, with an online softmax over key tiles (f32
// running max, sum and output accumulator), bf16 operands with f32
// accumulation, keys kept where k_idx < seq_k (and q_idx >= k_idx when causal)
// and the rest set to the finite sentinel -1e30, P rounded to bf16 before
// P V, the row sum taken over the unrounded f32 P, o / max(l, 1e-30) and
// lse in f32. The exponentials are ex2.approx of one FFMA on the raw score
// (scale * log2(e) folded in); the sentinel is applied to the raw score.
// Without a key mask key 0 is kept for every row, so a row's max is finite
// from the first tile on. An optional key mask (one byte a key of each batch
// element, shared by its heads: the attention layers' sequence masks) masks
// a key where its byte is 0; then a row's first tiles may keep no key, and
// while its max is still the sentinel its P is 0 (not ex2 of the FFMA, whose
// rounding at 1e30 is itself ~1e22): the first kept key rescales nothing. A
// row that keeps no key at all gives o = 0; the callers never hand one over
// (ops/standard.py). Wherever a row keeps a key this matches the reference.
//
// What bounds it on the H100: per (batch, head) 4 * Tq * Tk * d FLOPs (about
// half when causal) over 2 * (2 Tq + 2 Tk) * d bytes. At the prefill shapes
// (d = 64, T <= 1024) the bound is device memory below T ~ 600 and the
// tensor cores above; but a block's key loop is short (at most 8 tiles at
// T = 1024) and each 128 x 128 tile costs about as much in exponentials
// (16384 MUFU ops at 16 per clock per SM) as in tensor-core work, so what
// sets the time is how well loads, products and softmax overlap along the
// longest block's chain. The design:
//
// - One block per (batch*head, 128-row query tile): two consumer warpgroups of
//   64 query rows each plus one producer warpgroup (384 threads, one block
//   per SM). The producer gives its registers to the consumers with
//   setmaxnreg (24 / 240 a thread); ptxas budgets 168 a thread at entry,
//   which 24 / 240 balances to the register.
// - One producer thread loads the Q tile once and then K and V tiles through
//   TMA (cp.async.bulk.tensor) into a ring of 2 stages (3 at d = 128), each
//   with a "full" mbarrier (transaction bytes) and an "empty" mbarrier (all
//   256 consumer threads arrive when their products no longer read the
//   stage), so later tiles load while earlier ones are computed. Out-of-range rows
//   (ragged T) arrive zero-filled by TMA and are masked with the sentinel.
// - S = Q K^T is an SS wgmma m64n128k16 (Q and K from shared memory, 128-byte
//   swizzle, K-major) into 64 f32 registers a thread. Each thread holds two
//   rows (lane/4 and lane/4 + 8 of its warp's 16) and 32 columns of each; a
//   row max takes two quad shuffles (xor 1, 2); the row sum stays a per-thread
//   partial until the end.
// - P is packed to bf16 pairs in registers in the layout of the wgmma A
//   fragment (which is the accumulator layout taken pairwise) and fed as the
//   register A operand of an RS wgmma m64n{d}k16 against V, which stays
//   row-major in shared memory and is read MN-major (the B-transpose bit).
// - O is rescaled in registers; no score, P or O tile touches shared memory in
//   the key loop. The epilogue writes o straight from registers.
// - Each tensor-core phase of a warpgroup issues S_j = Q K_j^T together with
//   O += P_{j-1} V_{j-1}; the softmax of S_j runs while the latter is in
//   flight, and the two warpgroups take turns at the tensor cores (named
//   barriers), so one's softmax overlaps the other's products.
// - Causal: key tiles past the block's last query row are skipped, only tiles
//   that cross the diagonal (or the ragged end of the keys) are masked, and
//   query tiles launch longest-first.
// - Operands are 4-D (B, H, T, d) views with unit stride on d and any other
//   strides that are multiples of 16 bytes: the fused-QKV projection's views
//   go in as they are, and o is written into a caller-given strided view.
// - The key mask is a template parameter: the unmasked instantiations are
//   the kernel as it was, and the masked ones carry the mask's bytes of each
//   K/V tile with it (a 128-byte bulk copy into the tile's stage; the mask
//   is (B, ld) bytes, ld a multiple of 128, zero past seq_k) and test every
//   key of every tile. A warp's vote on whole tiles (kept whole: unmasked
//   path; masked whole: no exponentials) measured slower than the per-key
//   test at A1's shape (PERF.md, PR 17).
//
// The PTX helpers, the wgmma products and the tensor-map encoding are shared
// with the backward in hopper_wgmma.cuh.

#include "hopper_wgmma.cuh"

namespace {

constexpr int BM = 128;               // query rows per block (2 warpgroups)
constexpr int BN = 128;               // key rows per tile
constexpr int NCONSUMER = 256;        // threads of the two consumer warpgroups
constexpr int NPRODUCER = 128;        // the producer warpgroup
constexpr int NTHREADS = NCONSUMER + NPRODUCER;
constexpr int BOX_BYTES = PANEL * 128 * 2;  // one TMA box: 128 rows x 128 B
constexpr float NEG_INF = -1e30f;     // the reference's finite sentinel

template <int D, bool MASK> struct Smem {
  // K/V ring depth: a third stage measured faster only at d 128 (PERF.md),
  // where it still fits: 32 KB of Q + 3 x 64 KB of K/V < 227 KB
  static constexpr int STAGES = D == 128 ? 3 : 2;
  static constexpr int PANELS = D / PANEL;
  static constexpr int Q = PANELS * BOX_BYTES;         // BM rows
  static constexpr int KV = PANELS * BOX_BYTES;        // BN rows, K or V
  static constexpr int STAGE = 2 * KV;                 // K then V
  static constexpr int BARRIERS = Q + STAGES * STAGE;  // offset of mbarriers
  // q_full, full[STAGES], empty[STAGES], then (masked) each stage's
  // key-mask bytes
  static constexpr int MASKS = BARRIERS + 64;
  static_assert(8 * (1 + 2 * STAGES) <= 64, "the mbarriers overlap the masks");
  // + 1024 for aligning the base
  static constexpr int BYTES = 1024 + (MASK ? MASKS + STAGES * BN
                                            : BARRIERS + 8 * (1 + 2 * STAGES));
  static_assert(BYTES <= 227 * 1024, "over the H100's shared memory opt-in");
};

struct OutArgs {
  __nv_bfloat16* o;
  float* lse;
  long long sb, sh, st;   // o strides in elements (unit stride on d)
};

// Named barriers 1 and 2: the tensor-core turn of consumer warpgroup 0 and 1.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NCONSUMER) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(NCONSUMER) : "memory");
}

// One consumer warpgroup's view of the block: which rows it holds, and its
// softmax state. Each thread holds rows row0 and row0 + 8 of the warpgroup's
// 64 and, of every 8-column group, columns col0 and col0 + 1.
struct Rows {
  int wg, lane, qrow0, qrow1, col0, q0_wg;
  float m0 = NEG_INF, m1 = NEG_INF;   // running max of the two rows
  float l0 = 0.0f, l1 = 0.0f;         // this thread's part of the row sums
};

// S = Q K^T for this warpgroup's 64 rows: K-major A and B, 16 columns of d
// (32 bytes) per step. Issues and commits; does not wait.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sacc)[64], uint32_t sQ_wg,
                                         uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss_n128(sacc, smem_desc(sQ_wg + off, 16, 1024),
                  smem_desc(sK + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V: V row-major (keys x d) read MN-major; 16 keys = 2 atoms (2048
// bytes) per step, the second 64-column panel LBO bytes on. Issues and
// commits; does not wait.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o_acc)[D / 2],
                                         const uint32_t (&pf)[BN / 16][4],
                                         uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<D>(o_acc, pf[kk], smem_desc(sV + kk * 2048, BOX_BYTES, 1024));
  wgmma_commit();
}

// The sentinel on keys out of range, in the future or (MASK) masked
// (``kmask``: the tile's key-mask bytes in shared memory), the new row max,
// and P = exp(s * scale - m * scale) in place (f32), as ex2.approx of one
// FFMA on the raw score: m is kept in raw-score units. Returns the two rows'
// rescale factors for O; adds P's row sums into l after rescaling it.
template <bool MASK>
__device__ __forceinline__ void softmax_scores(float (&sacc)[64], Rows& r,
                                               int kv0, int seq_k,
                                               float scale, int causal,
                                               const uint8_t* kmask,
                                               float& alpha0, float& alpha1) {
  const bool masked = MASK || kv0 + BN > seq_k ||
                      (causal && kv0 + BN - 1 > r.q0_wg);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float x = sacc[i];
    if (masked) {
      const int col = 8 * (i / 4) + r.col0 + (i & 1);
      const int k_idx = kv0 + col;
      const int q_idx = (i & 2) ? r.qrow1 : r.qrow0;
      bool keep = k_idx < seq_k && (!causal || q_idx >= k_idx);
      if constexpr (MASK) keep = keep && kmask[col];
      if (!keep) x = NEG_INF;
    }
    sacc[i] = x;
  }
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(sacc[i], sacc[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(sacc[i + 2], sacc[i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(r.m0, mx0), mn1 = fmaxf(r.m1, mx1);
  float ls0 = 0.0f, ls1 = 0.0f;
  // without a key mask key 0 is kept for every row, so m is finite from the
  // first tile on; under one a row whose every key so far is masked gets
  // P = 0 (its max the sentinel: -inf as the FFMA's addend), so the first
  // kept key rescales nothing
  const float c = scale * LOG2E;
  float mc0 = -mn0 * c, mc1 = -mn1 * c;
  if constexpr (MASK) {
    if (mn0 == NEG_INF) mc0 = -INFINITY;
    if (mn1 == NEG_INF) mc1 = -INFINITY;
  }
  alpha0 = fast_exp2((r.m0 - mn0) * c);
  alpha1 = fast_exp2((r.m1 - mn1) * c);
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    sacc[i] = fast_exp2(fmaf(sacc[i], c, mc0));
    sacc[i + 1] = fast_exp2(fmaf(sacc[i + 1], c, mc0));
    sacc[i + 2] = fast_exp2(fmaf(sacc[i + 2], c, mc1));
    sacc[i + 3] = fast_exp2(fmaf(sacc[i + 3], c, mc1));
    ls0 += sacc[i] + sacc[i + 1];
    ls1 += sacc[i + 2] + sacc[i + 3];
  }
  r.m0 = mn0;
  r.m1 = mn1;
  r.l0 = r.l0 * alpha0 + ls0;
  r.l1 = r.l1 * alpha1 + ls1;
}

template <int D>
__device__ __forceinline__ void rescale_o(float (&o_acc)[D / 2], float alpha0,
                                          float alpha1) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 4) {
    o_acc[i] *= alpha0;
    o_acc[i + 1] *= alpha0;
    o_acc[i + 2] *= alpha1;
    o_acc[i + 3] *= alpha1;
  }
}

// The two consumer warpgroups: 64 query rows each, the whole key loop;
// ``masks`` the stages' key-mask bytes (MASK).
template <int D, bool MASK>
__device__ __forceinline__ void consume(uint32_t sQ, uint32_t sKV,
                                        const uint8_t* masks,
                                        uint32_t bar_q, uint32_t bar_full,
                                        uint32_t bar_empty, int n_tiles,
                                        int q0, int b, int h, int bh,
                                        const OutArgs& out, int seq_q,
                                        int seq_k, float scale, int causal) {
  using S = Smem<D, MASK>;
  constexpr int STAGES = S::STAGES;
  Rows r;
  r.wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  r.lane = t % 32;
  r.q0_wg = q0 + r.wg * 64;
  r.qrow0 = r.q0_wg + (t / 32) * 16 + r.lane / 4;
  r.qrow1 = r.qrow0 + 8;
  r.col0 = 2 * (r.lane % 4);

  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.0f;
  float sacc[64];
  uint32_t pf[BN / 16][4];
  float alpha0, alpha1;

  // this warpgroup's 64 rows of Q: 8 swizzle atoms into each panel
  const uint32_t sQ_wg = sQ + r.wg * 64 * 128;
  mbar_wait(bar_q, 0);

  // Each tensor-core phase issues S_j = Q K_j^T and O += P_{j-1} V_{j-1}
  // together; the softmax of S_j then runs while P_{j-1} V_{j-1} is still
  // in flight. The two warpgroups take turns at the tensor cores (named
  // barriers), so one's softmax overlaps the other's products. Tile 0 (S
  // alone) and the last P V are peeled off, so the loop body has one shape
  // for ptxas to pipeline.
  const int my_turn = 1 + r.wg, other_turn = 2 - r.wg;
  if (r.wg == 1) named_arrive(1);     // warpgroup 0 first
  mbar_wait(bar_full, 0);
  named_sync(my_turn);
  wgmma_fence();
  issue_qk<D>(sacc, sQ_wg, sKV);
  named_arrive(other_turn);
  wgmma_wait<0>();
  reg_fence(sacc);
  softmax_scores<MASK>(sacc, r, 0, seq_k, scale, causal, masks, alpha0,
                       alpha1);
  pack_a<BN>(pf, sacc);                   // O is still zero: nothing to rescale
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % STAGES, sp = (j - 1) % STAGES;
    mbar_wait(bar_full + 8 * s, (j / STAGES) & 1);
    named_sync(my_turn);
    reg_fence(o_acc);
    reg_fence(pf);
    wgmma_fence();
    issue_qk<D>(sacc, sQ_wg, sKV + s * S::STAGE);
    issue_pv<D>(o_acc, pf, sKV + sp * S::STAGE + S::KV);
    named_arrive(other_turn);
    wgmma_wait<1>();                  // S_j done; P_{j-1} V_{j-1} may not be
    reg_fence(sacc);
    softmax_scores<MASK>(sacc, r, j * BN, seq_k, scale, causal,
                         MASK ? masks + s * BN : nullptr, alpha0, alpha1);
    wgmma_wait<0>();
    reg_fence(o_acc);
    reg_fence(pf);
    mbar_arrive(bar_empty + 8 * sp);  // the stage of tile j - 1 is free
    rescale_o<D>(o_acc, alpha0, alpha1);
    pack_a<BN>(pf, sacc);
  }
  const int sl = (n_tiles - 1) % STAGES;
  named_sync(my_turn);
  reg_fence(o_acc);
  reg_fence(pf);
  wgmma_fence();
  issue_pv<D>(o_acc, pf, sKV + sl * S::STAGE + S::KV);
  // warpgroup 1's last arrival would have no partner: skip it
  if (r.wg == 0) named_arrive(other_turn);
  wgmma_wait<0>();
  reg_fence(o_acc);
  mbar_arrive(bar_empty + 8 * sl);

  // epilogue: full row sums, o / max(l, 1e-30) in bf16, lse = m + log l
  float l0 = r.l0, l1 = r.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = out.o + (long long)b * out.sb + (long long)h * out.sh;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const bool second = (i & 2) != 0;
    const int q_idx = second ? r.qrow1 : r.qrow0;
    if (q_idx < seq_q) {
      const float l = second ? l1 : l0;
      const int col = 8 * (i / 4) + r.col0;
      __nv_bfloat162 v = __floats2bfloat162_rn(o_acc[i] / l, o_acc[i + 1] / l);
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)q_idx * out.st + col) = v;
    }
  }
  if (r.lane % 4 == 0) {
    // m is in raw-score units
    float* lb = out.lse + (long long)bh * seq_q;
    if (r.qrow0 < seq_q) lb[r.qrow0] = r.m0 * scale + logf(l0);
    if (r.qrow1 < seq_q) lb[r.qrow1] = r.m1 * scale + logf(l1);
  }
}

// ---------------------------------------------------------------- the kernel

template <int D, bool MASK>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       int perm_q, int perm_k, int perm_v, OutArgs out,
                       int n_heads, int seq_q, int seq_k, float scale,
                       int causal, const uint8_t* kmask, long long kmask_ld) {
  using S = Smem<D, MASK>;
  constexpr int PANELS = S::PANELS, STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: align every tile to them
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = base + S::Q;
  const uint32_t bar_q = base + S::BARRIERS;
  const uint32_t bar_full = bar_q + 8;                  // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * STAGES;     // [STAGES]
  const uint32_t sMask = base + S::MASKS;               // [STAGES][BN]

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int n_qt = gridDim.y;
  // causal: the longest query tiles (most key tiles) launch first
  const int qt = causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * BM;
  // causal: a key tile starting past the block's last query row contributes
  // nothing, so the loop stops before it
  const int kv_end = causal ? min(seq_k, q0 + BM) : seq_k;
  const int n_tiles = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NCONSUMER) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == NCONSUMER) {
      int c1, c2, c3;
      outer_coords(perm_q, q0, h, b, c1, c2, c3);
      mbar_expect_tx(bar_q, S::Q);
      for (int p = 0; p < PANELS; ++p)
        tma_load_4d(sQ + p * BOX_BYTES, &tm_q, bar_q, p * PANEL, c1, c2, c3);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES)   // wait for both warpgroups to release the stage
          mbar_wait(bar_empty + 8 * s, ((j / STAGES) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t sK = sKV + s * S::STAGE, sV = sK + S::KV;
        mbar_expect_tx(full, S::STAGE + (MASK ? BN : 0));
        if constexpr (MASK)   // this tile's key bytes of batch element b
          bulk_load(sMask + s * BN, kmask + b * kmask_ld + j * BN, BN, full);
        outer_coords(perm_k, j * BN, h, b, c1, c2, c3);
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(sK + p * BOX_BYTES, &tm_k, full, p * PANEL, c1, c2, c3);
        outer_coords(perm_v, j * BN, h, b, c1, c2, c3);
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(sV + p * BOX_BYTES, &tm_v, full, p * PANEL, c1, c2, c3);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<D, MASK>(sQ, sKV, MASK ? smem_raw + (sMask - raw) : nullptr,
                     bar_q, bar_full, bar_empty, n_tiles, q0, b, h, bh, out,
                     seq_q, seq_k, scale, causal);
  }
}

// ------------------------------------------------------------------ host side

template <int D, bool MASK>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           int pq, int pk, int pv, OutArgs out, int batch, int heads,
           int seq_q, int seq_k, float scale, int causal,
           const uint8_t* kmask, long long kmask_ld, cudaStream_t stream) {
  // the shared-memory opt-in, once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D, MASK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D, MASK>::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(batch * heads, (seq_q + BM - 1) / BM);
  flash_fwd_wgmma_kernel<D, MASK>
      <<<grid, NTHREADS, Smem<D, MASK>::BYTES, stream>>>(
      tq, tk, tv, pq, pk, pv, out, heads, seq_q, seq_k, scale, causal, kmask,
      kmask_ld);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. q (B, H, seq_q, d), k and v
// (B, H, seq_k, d), o like q: bf16 views with unit stride on d, strides given
// in elements. lse: contiguous f32 (B * H, seq_q). kmask: null, or (B,
// kmask_ld) bytes, nonzero where a key is kept, zero past seq_k, 16-byte
// aligned with kmask_ld a multiple of 128. Returns 0 on success, a
// cudaError_t from the launch, or -CUresult when a tensor map cannot be
// encoded. Never synchronises.
extern "C" int dl4j_flash_attention_fwd_wgmma(
    const void* q, const void* k, const void* v, void* o, void* lse, int batch,
    int heads, int seq_q, int seq_k, int d, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long o_sb,
    long long o_sh, long long o_st, float scale, int causal,
    const void* kmask, long long kmask_ld, void* stream) {
  if (batch < 1 || heads < 1 || seq_q < 1 || seq_k < 1 ||
      (seq_q + BM - 1) / BM > 65535 || (d != 64 && d != 128) ||
      (kmask && (reinterpret_cast<uintptr_t>(kmask) % 16 || kmask_ld % BN ||
                 kmask_ld < (seq_k + BN - 1) / BN * BN)))
    return (int)cudaErrorInvalidValue;
  if (cudaError_t err = bind_context()) return (int)err;
  CUtensorMap tq, tk, tv;
  int pq, pk, pv;
  CUresult r = encode_4d(&tq, &pq, q, batch, heads, seq_q, d, q_sb, q_sh,
                         q_st, BM);
  if (r == CUDA_SUCCESS)
    r = encode_4d(&tk, &pk, k, batch, heads, seq_k, d, k_sb, k_sh, k_st, BN);
  if (r == CUDA_SUCCESS)
    r = encode_4d(&tv, &pv, v, batch, heads, seq_k, d, v_sb, v_sh, v_st, BN);
  if (r != CUDA_SUCCESS) return -(int)r;
  OutArgs out{static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), o_sb,
              o_sh, o_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* km = static_cast<const uint8_t*>(kmask);
  if (d == 64 && km)
    return launch<64, true>(tq, tk, tv, pq, pk, pv, out, batch, heads, seq_q,
                            seq_k, scale, causal, km, kmask_ld, s);
  if (d == 64)
    return launch<64, false>(tq, tk, tv, pq, pk, pv, out, batch, heads, seq_q,
                             seq_k, scale, causal, km, kmask_ld, s);
  if (km)
    return launch<128, true>(tq, tk, tv, pq, pk, pv, out, batch, heads, seq_q,
                             seq_k, scale, causal, km, kmask_ld, s);
  return launch<128, false>(tq, tk, tv, pq, pk, pv, out, batch, heads, seq_q,
                            seq_k, scale, causal, km, kmask_ld, s);
}

extern "C" const char* dl4j_flash_wgmma_error_string(int err) {
  if (err < 0) return "cuTensorMapEncodeTiled failed (see the CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
