// Flash-attention backward for Hopper (sm_90a): wgmma, TMA, bf16, d in {64, 128}.
//
// Replaces `_bwd_blockwise` (the custom-VJP backward `_flash_bwd` of the Pallas
// kernel, registered with `_flash.defvjp`) in
// deeplearning4j_tpu/kernels/flash_attention.py for bf16 operands at head dim
// 64 and 128; flash_attention_bwd.cu keeps f32 and the other head dims. It
// computes the same function with the same rounding points:
//   D  = rowsum(f32 dO * f32 O)
//   p  = exp(s * scale - lse) in f32, masked keys exactly 0: keys past
//        seq_k, and k_idx > q_idx (absolute indices) when causal
//   dV = bf16(p)^T dO          dP = dO V^T
//   dS = bf16(p * (dP - D))    dQ = scale * dS K     dK = scale * dS^T Q
// with bf16 operands and f32 accumulation. The exponentials are ex2.approx of
// one FFMA on the raw score (scale * log2(e) folded in, lse * log2(e) per row).
//
// What bounds it on the H100: the five products are 10 * Tq * Tk * d FLOPs
// per head (about half when causal) against 4 (Tq + Tk) d bf16 elements read
// and written, so at the training shape (T 1024, d 64) the tensor cores bound
// it, and only wgmma reaches their full rate. The design:
//
// - FA2's split, one launch each from dl4j_flash_attention_bwd_wgmma: D (and a
//   copy of lse padded to 64-row query tiles) in delta_kernel, then a dQ
//   kernel and a dK/dV kernel. Every sum stays in one block's registers, so
//   dq is deterministic (no atomics), as the JAX scan is; the price is S and
//   dP computed in both kernels (7 products for 5).
// - Both kernels are one template. A block owns 128 rows of X and Y (its own
//   operands: Q and dO in the dQ kernel, K and V in the dK/dV kernel) as two
//   consumer warpgroups of 64 rows each, plus a producer warpgroup that gives
//   its registers away with setmaxnreg (24 / 240) and streams 64-row tiles
//   of U and W (K and V, or Q and dO with the tile's lse and D) through a
//   3-stage TMA ring with full / empty mbarriers.
// - Per tile, each consumer warpgroup issues two SS wgmma m64n64k16 (d / 16
//   steps each, K-major operands): X U^T and Y W^T, which are S and dP in
//   the dQ kernel and S^T and dP^T (rows keys, columns queries) in the dK/dV
//   kernel: the forward's Q K^T with the roles swapped. P and dS are formed
//   in registers, rounded to bf16 in place as the A fragments of RS wgmma
//   m64n{d}k16 against the streamed tile read MN-major (the forward's P V):
//   dV += P^T dO (issued while dP^T is still in flight) and dK += dS^T Q, or
//   dQ += dS K. No score tile touches shared memory; dK, dV and dQ stay f32
//   accumulators until the epilogue writes them, scaled and rounded to bf16,
//   straight into the caller's strided views.
// - Causal: streamed tiles that no row of the block sees are never loaded,
//   only tiles that cross the diagonal (or the ragged end) are masked, and
//   the longest blocks launch first. A dK/dV block whose keys no query sees
//   (causal with Tk > Tq) loads nothing and writes zeros.
// - Operands are 4-D (B, H, T, d) views with unit stride on d and other
//   strides that are multiples of 16 bytes, read through tensor maps, so the
//   fused-QKV projection's views go in as they are and its gradient is
//   written in place.

#include "hopper_wgmma.cuh"
#include "flash_bwd_delta.cuh"

namespace {

constexpr int BLOCK = 128;           // own rows per block (2 warpgroups)
constexpr int TILE = 64;             // rows of a streamed tile
constexpr int NCONSUMER = 256;       // threads of the two consumer warpgroups
constexpr int NPRODUCER = 128;       // the producer warpgroup
constexpr int NTHREADS = NCONSUMER + NPRODUCER;
constexpr int STAGES = 3;
constexpr int PANEL_BYTES = TILE * 128;   // a 64-row x 64-column bf16 panel
constexpr int STATS_BYTES = 2 * TILE * 4; // lse and D of one query tile

// (b, h, t) strides in elements of the eight operands, in this order
enum { Q = 0, K, V, O, DO, DQ, DK, DV };

// Shared memory of a block: its own X and Y (BLOCK rows each, as two 64-row
// tiles), then STAGES stages of U and W (one 64-row tile each, and in the
// dK/dV kernel the tile's lse and D), then the mbarriers. A 64-row tile is
// its d / 64 panels one after another.
template <int D, bool KV> struct Smem {
  static constexpr int PANELS = D / PANEL;
  static constexpr int UNIT = PANELS * PANEL_BYTES;   // one 64-row tile
  static constexpr int OWN = 2 * UNIT;                // BLOCK rows of X or Y
  static constexpr int STAGE = 2 * UNIT + (KV ? 1024 : 0);
  static constexpr int RING = 2 * OWN;                // offset of the ring
  static constexpr int BARRIERS = RING + STAGES * STAGE;
  // + 1024 for aligning the base, + own, full[STAGES], empty[STAGES]
  static constexpr int BYTES = 1024 + BARRIERS + 8 * (1 + 2 * STAGES);
  static constexpr uint32_t STAGE_TX = 2 * UNIT + (KV ? STATS_BYTES : 0);
  static_assert(BYTES <= 227 * 1024, "over the H100's shared memory opt-in");
};

struct BwdArgs {
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* lse_pad;   // (B * H, q_pad): lse, 0 past seq_q
  const float* delta;     // (B * H, q_pad): D, 0 past seq_q
  long long st[8][3];
  int h, seq_q, seq_k, q_pad;
  float scale;
  int causal;
};

// Acc[64 x 64] = A[64 x d] B[64 x d]^T: A the warpgroup's 64 own rows, B a
// streamed tile, both K-major, 16 columns of d (32 bytes) per step. Issues
// and commits; does not wait.
template <int D>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint32_t sA,
                                         uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * PANEL_BYTES + (kk % 4) * 32;
    wgmma_ss_n64(acc, smem_desc(sA + off, 16, 1024),
                 smem_desc(sB + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// Acc[64 x d] += F[64 x 64] B[64 x d]: F bf16 A fragments in registers, B a
// streamed tile (rows the depth) read MN-major, 16 rows (2048 bytes) per
// step, the second 64-column panel PANEL_BYTES on. Issues and commits.
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&f)[TILE / 16][4],
                                         uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
    wgmma_rs<D>(acc, f[kk], smem_desc(sB + kk * 2048, PANEL_BYTES, 1024));
  wgmma_commit();
}

// Rows row_a and row_b (of n_rows) of dst = scale * acc, in bf16; this
// thread's columns of every 8-column group are col0 and col0 + 1.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           __nv_bfloat16* dst, long long st,
                                           int row_a, int row_b, int n_rows,
                                           int col0, float scale) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = (i & 2) ? row_b : row_a;
    if (r < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)r * st +
                                         8 * (i / 4) + col0) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
  }
}

// The two consumer warpgroups: 64 own rows each, the whole streamed loop,
// then the epilogue. KV: own rows are keys, streamed rows queries (dK, dV);
// otherwise own rows are queries, streamed rows keys (dQ).
template <int D, bool KV>
__device__ __forceinline__ void consume(uint32_t sX, uint32_t sY,
                                        uint32_t sRing,
                                        const uint8_t* ring_ptr,
                                        uint32_t bar_own, uint32_t bar_full,
                                        uint32_t bar_empty, int r0, int t0,
                                        int n, int b, int h, int bh,
                                        const BwdArgs& a) {
  using S = Smem<D, KV>;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int w0 = r0 + wg * TILE;              // this warpgroup's first row
  const int row_a = w0 + (t / 32) * 16 + lane / 4, row_b = row_a + 8;
  const int col0 = 2 * (lane % 4);
  const float scale2 = a.scale * LOG2E;
  const uint32_t sX_wg = sX + wg * S::UNIT, sY_wg = sY + wg * S::UNIT;

  float acc1[KV ? D / 2 : 1];   // dV
  float acc2[D / 2];            // dK, or dQ
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    if constexpr (KV) acc1[i] = 0.0f;
    acc2[i] = 0.0f;
  }
  // the dQ kernel's rows: -lse * log2(e) and D
  float nl_a = 0.0f, nl_b = 0.0f, d_a = 0.0f, d_b = 0.0f;
  if constexpr (!KV) {
    const size_t at = (size_t)bh * a.q_pad;
    if (row_a < a.seq_q) {
      nl_a = -a.lse_pad[at + row_a] * LOG2E;
      d_a = a.delta[at + row_a];
    }
    if (row_b < a.seq_q) {
      nl_b = -a.lse_pad[at + row_b] * LOG2E;
      d_b = a.delta[at + row_b];
    }
  }
  float sacc[32], pacc[32];
  uint32_t pf[TILE / 16][4], df[TILE / 16][4];

  if (n > 0) mbar_wait(bar_own, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % STAGES;
    const uint32_t sU = sRing + s * S::STAGE, sW = sU + S::UNIT;
    const int c0 = t0 + j * TILE;             // first streamed row
    mbar_wait(bar_full + 8 * s, (j / STAGES) & 1);
    if constexpr (KV) reg_fence(acc1);
    reg_fence(acc2);
    wgmma_fence();
    issue_ss<D>(sacc, sX_wg, sU);             // S^T = K Q^T  |  S = Q K^T
    issue_ss<D>(pacc, sY_wg, sW);             // dP^T = V dO^T | dP = dO V^T
    wgmma_wait<1>();
    reg_fence(sacc);

    // P in place of S, exactly 0 where masked; only a tile that crosses the
    // diagonal or the ragged end needs the mask
    if constexpr (KV) {
      const bool masked = c0 + TILE > a.seq_q ||
                          (a.causal && c0 < w0 + TILE - 1);
      const float* lse_t = reinterpret_cast<const float*>(
          ring_ptr + s * S::STAGE + 2 * S::UNIT);
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int c = 8 * g + col0;           // query columns c, c + 1
        const float2 l = *reinterpret_cast<const float2*>(lse_t + c);
        const float nl0 = -l.x * LOG2E, nl1 = -l.y * LOG2E;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * g + e;
          float p = fast_exp2(fmaf(sacc[i], scale2, (e & 1) ? nl1 : nl0));
          if (masked) {
            const int q = c0 + c + (e & 1), k = (e & 2) ? row_b : row_a;
            if (!(q < a.seq_q && (!a.causal || q >= k))) p = 0.0f;
          }
          sacc[i] = p;
        }
      }
      // dV += bf16(P^T) dO, while dP^T may still be in flight
      pack_a<TILE>(pf, sacc);
      reg_fence(pf);
      wgmma_fence();
      issue_rs<D>(acc1, pf, sW);
      wgmma_wait<1>();
    } else {
      const bool masked = c0 + TILE > a.seq_k ||
                          (a.causal && c0 + TILE - 1 > w0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float p = fast_exp2(fmaf(sacc[i], scale2, (i & 2) ? nl_b : nl_a));
        if (masked) {
          const int k = c0 + 8 * (i / 4) + col0 + (i & 1);
          const int q = (i & 2) ? row_b : row_a;
          if (!(k < a.seq_k && (!a.causal || q >= k))) p = 0.0f;
        }
        sacc[i] = p;
      }
      wgmma_wait<0>();
    }
    reg_fence(pacc);

    // dS = P (dP - D) in place of dP, then bf16 A fragments
    if constexpr (KV) {
      const float* d_t = reinterpret_cast<const float*>(
          ring_ptr + s * S::STAGE + 2 * S::UNIT) + TILE;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const float2 dd = *reinterpret_cast<const float2*>(d_t + 8 * g + col0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * g + e;
          pacc[i] = sacc[i] * (pacc[i] - ((e & 1) ? dd.y : dd.x));
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        pacc[i] = sacc[i] * (pacc[i] - ((i & 2) ? d_b : d_a));
    }
    pack_a<TILE>(df, pacc);
    reg_fence(df);
    wgmma_fence();
    issue_rs<D>(acc2, df, sU);                // dK += dS^T Q  |  dQ += dS K
    wgmma_wait<0>();
    if constexpr (KV) {
      reg_fence(acc1);
      reg_fence(pf);
    }
    reg_fence(acc2);
    reg_fence(df);
    mbar_arrive(bar_empty + 8 * s);           // the stage is free
  }

  // epilogue: f32 sums, scaled, as bf16 into the caller's views
  if constexpr (KV) {
    store_rows<D>(acc1, a.dv + b * a.st[DV][0] + h * a.st[DV][1], a.st[DV][2],
                  row_a, row_b, a.seq_k, col0, 1.0f);
    store_rows<D>(acc2, a.dk + b * a.st[DK][0] + h * a.st[DK][1], a.st[DK][2],
                  row_a, row_b, a.seq_k, col0, a.scale);
  } else {
    store_rows<D>(acc2, a.dq + b * a.st[DQ][0] + h * a.st[DQ][1], a.st[DQ][2],
                  row_a, row_b, a.seq_q, col0, a.scale);
  }
}

// ---------------------------------------------------------------- the kernel

template <int D, bool KV>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_y,
                       const __grid_constant__ CUtensorMap tm_u,
                       const __grid_constant__ CUtensorMap tm_w, int perm_x,
                       int perm_y, int perm_u, int perm_w, BwdArgs a) {
  using S = Smem<D, KV>;
  constexpr int PANELS = S::PANELS;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: align every tile to them
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sX = base, sY = base + S::OWN, sRing = base + S::RING;
  const uint32_t bar_own = base + S::BARRIERS;
  const uint32_t bar_full = bar_own + 8;                // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * STAGES;     // [STAGES]

  const int bh = blockIdx.x;
  const int b = bh / a.h, h = bh % a.h;
  // own rows [r0, r0 + BLOCK); streamed tiles start at rows t0 + TILE j,
  // j < n. Causal: the longest blocks launch first, and a tile that no own
  // row sees is not streamed.
  int r0, t0, n;
  if constexpr (KV) {
    r0 = blockIdx.y * BLOCK;                  // the first keys see most rows
    t0 = a.causal ? r0 : 0;
    n = t0 < a.seq_q ? (a.seq_q - t0 + TILE - 1) / TILE : 0;
  } else {
    const int qb = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
    r0 = qb * BLOCK;
    t0 = 0;
    const int end = a.causal ? min(a.seq_k, r0 + BLOCK) : a.seq_k;
    n = (end + TILE - 1) / TILE;
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
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
    if (threadIdx.x == NCONSUMER && n > 0) {
      int c1, c2, c3;
      mbar_expect_tx(bar_own, 2 * S::OWN);
      for (int half = 0; half < 2; ++half) {
        const uint32_t off = half * S::UNIT;
        outer_coords(perm_x, r0 + half * TILE, h, b, c1, c2, c3);
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(sX + off + p * PANEL_BYTES, &tm_x, bar_own, p * PANEL,
                      c1, c2, c3);
        outer_coords(perm_y, r0 + half * TILE, h, b, c1, c2, c3);
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(sY + off + p * PANEL_BYTES, &tm_y, bar_own, p * PANEL,
                      c1, c2, c3);
      }
      for (int j = 0; j < n; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES)   // wait for both warpgroups to release the stage
          mbar_wait(bar_empty + 8 * s, ((j / STAGES) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t sU = sRing + s * S::STAGE, sW = sU + S::UNIT;
        const int row = t0 + j * TILE;
        mbar_expect_tx(full, S::STAGE_TX);
        outer_coords(perm_u, row, h, b, c1, c2, c3);
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(sU + p * PANEL_BYTES, &tm_u, full, p * PANEL, c1, c2,
                      c3);
        outer_coords(perm_w, row, h, b, c1, c2, c3);
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(sW + p * PANEL_BYTES, &tm_w, full, p * PANEL, c1, c2,
                      c3);
        if constexpr (KV) {   // the tile's lse and D, 256 bytes each
          const size_t at = (size_t)bh * a.q_pad + row;
          bulk_load(sW + S::UNIT, a.lse_pad + at, TILE * 4, full);
          bulk_load(sW + S::UNIT + TILE * 4, a.delta + at, TILE * 4, full);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<D, KV>(sX, sY, sRing, smem_raw + (sRing - raw), bar_own,
                   bar_full, bar_empty, r0, t0, n, b, h, bh, a);
  }
}

// ------------------------------------------------------------------ host side

template <int D>
int launch(const CUtensorMap* tm, const int* perm, const DeltaArgs& da,
           const BwdArgs& a, int bh, cudaStream_t stream) {
  // the shared-memory opt-ins, once per instantiation
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_wgmma_kernel<D, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D, false>::BYTES);
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_wgmma_kernel<D, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D, true>::BYTES);
  if (attr_q != cudaSuccess) return (int)attr_q;
  if (attr_kv != cudaSuccess) return (int)attr_kv;
  delta_kernel<__nv_bfloat16>
      <<<dim3((da.rows + 31) / 32, bh), 256, 0, stream>>>(da);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dQ: own Q and dO, streamed K and V
  flash_bwd_wgmma_kernel<D, false>
      <<<dim3(bh, (a.seq_q + BLOCK - 1) / BLOCK), NTHREADS,
         Smem<D, false>::BYTES, stream>>>(tm[Q], tm[DO], tm[K], tm[V],
                                          perm[Q], perm[DO], perm[K], perm[V],
                                          a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dK, dV: own K and V, streamed Q and dO
  flash_bwd_wgmma_kernel<D, true>
      <<<dim3(bh, (a.seq_k + BLOCK - 1) / BLOCK), NTHREADS,
         Smem<D, true>::BYTES, stream>>>(tm[K], tm[V], tm[Q], tm[DO],
                                         perm[K], perm[V], perm[Q], perm[DO],
                                         a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes, as dl4j_flash_attention_bwd's:
// q, k, v, o, dO and dq, dk, dv are bf16 (B, H, T, d) views with unit stride
// on d; strides: 24 (b, h, t) strides in elements of q, k, v, o, dO, dq, dk,
// dv, in that order, each a multiple of 16 bytes. lse is contiguous f32
// (B * H, seq_q); scratch holds 2 * B * H * q_pad f32, q_pad = seq_q rounded
// up to 64 (D, then the padded copy of lse). Returns 0 on success, a
// cudaError_t from a launch, or -CUresult when a tensor map cannot be
// encoded. Never synchronises.
extern "C" int dl4j_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* scratch, int b, int h, int seq_q, int seq_k, int d,
    const long long* strides, float scale, int causal, void* stream) {
  if (b < 1 || h < 1 || (long long)b * h > 65535 || seq_q < 1 || seq_k < 1 ||
      (seq_q + BLOCK - 1) / BLOCK > 65535 ||
      (seq_k + BLOCK - 1) / BLOCK > 65535 || (d != 64 && d != 128))
    return (int)cudaErrorInvalidValue;
  if (cudaError_t err = bind_context()) return (int)err;
  const long long(*st)[3] = reinterpret_cast<const long long(*)[3]>(strides);
  CUtensorMap tm[DO + 1];
  int perm[DO + 1] = {0, 0, 0, 0, 0};
  const void* ops[DO + 1] = {q, k, v, o, dout};
  const int mapped[4] = {Q, K, V, DO};   // o is read by delta_kernel only
  for (int i : mapped) {
    const int seq = i == K || i == V ? seq_k : seq_q;
    const CUresult r = encode_4d(&tm[i], &perm[i], ops[i], b, h, seq, d,
                                 st[i][0], st[i][1], st[i][2], TILE);
    if (r != CUDA_SUCCESS) return -(int)r;
  }
  const int q_pad = (seq_q + TILE - 1) / TILE * TILE;
  float* delta = static_cast<float*>(scratch);
  float* lse_pad = delta + (size_t)b * h * q_pad;
  DeltaArgs da{o, dout, {st[O][0], st[O][1], st[O][2]},
               {st[DO][0], st[DO][1], st[DO][2]}, static_cast<const float*>(lse),
               delta, lse_pad, h, seq_q, q_pad, d};
  BwdArgs a;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.lse_pad = lse_pad;
  a.delta = delta;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = st[i][j];
  a.h = h; a.seq_q = seq_q; a.seq_k = seq_k; a.q_pad = q_pad;
  a.scale = scale;
  a.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(tm, perm, da, a, b * h, s);
  return launch<128>(tm, perm, da, a, b * h, s);
}

extern "C" const char* dl4j_flash_bwd_wgmma_error_string(int err) {
  if (err < 0) return "cuTensorMapEncodeTiled failed (see the CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
