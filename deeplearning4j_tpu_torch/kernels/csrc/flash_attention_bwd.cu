// Flash-attention backward for Hopper (sm_90a), the mma.sync / FMA path: dq,
// dk, dv of attention from the forward's q, k, v, o, lse and the output
// gradient dO, for f32 at every head dim and bf16 at the head dims the wgmma
// backward does not take (flash_attention_bwd_wgmma.cu has bf16 at 64 and
// 128); any d % 8 == 0 in [8, 256].
//
// Replaces `_bwd_blockwise` (the custom-VJP backward `_flash_bwd` of the Pallas
// kernel, registered with `_flash.defvjp`) in
// deeplearning4j_tpu/kernels/flash_attention.py, and computes the same
// function with the same rounding points:
//   D  = rowsum(f32 dO * f32 O)
//   p  = exp(s * scale - lse) in f32, masked keys (the -1e30 sentinel there)
//        exactly 0: keys past seq_k, k_idx > q_idx when causal, and keys
//        whose byte in the optional key mask (the forward's) is 0
//   dV = bf16(p)^T dO          dP = dO V^T
//   dS = bf16(p * (dP - D))    dQ = scale * dS K     dK = scale * dS^T Q
// with bf16 operands multiplied exactly and f32 accumulation; in f32 the
// roundings to bf16 are no-ops.
//
// Three kernels, FA2's split, one launch each from dl4j_flash_attention_bwd:
//   delta_kernel - D, 8 lanes a row with 16-byte loads (flash_bwd_delta.cuh);
//   dq kernel    - one block per (b*h, query tile), looping over the key
//                  tiles that tile sees (up to the diagonal when causal), dQ
//                  in f32 registers; no atomics, so dq is deterministic, as
//                  the JAX scan is;
//   dkdv kernel  - one block per (b*h, key tile), looping over the query
//                  tiles that see it (from the diagonal on when causal), dK
//                  and dV in f32 registers.
// Each recomputes the scores and dP it needs (7 products in all, where the JAX
// scan does 5), so neither the (T, T) scores nor any cross-block sum reaches
// device memory. Each warp owns 16 rows of its block's own tile (query rows in
// the dq kernel, key rows in the dkdv kernel, which therefore computes S^T and
// dP^T directly); the tiles a block walks over are double-buffered with
// cp.async, so the next tile's copy overlaps this tile's products. Where dK
// and dV together would crowd a lane's registers (from W 192, and f32 from
// W 128), the dkdv block has two groups of warps over the same key rows, one
// for dV and one for dK, each recomputing what it needs. Tiles are W wide
// (flash_mma.cuh), the columns past d zero.
//
// The products (MmaBf16 and FmaF32 below):
// - bf16: mma.sync m16n8k16 (flash_mma.cuh); S and dP stay in the
//   accumulator registers, and P and dS go from there into the A fragments
//   of the next products, so no score tile touches shared memory.
// - f32: fused multiply-adds on the CUDA cores, register-tiled, each sum in
//   the plain version's order and rounding. The f32 rows of the tolerance
//   table hold the backward to the plain version (cuBLAS f32, TF32 off) by
//   a 64-row tile's relative L2 error of 5e-7, which at T 1024 is below that
//   plain version's own distance from f64 (8.3-8.4e-7, PERF.md): a sum taken
//   in another order, on tensor cores (whose f32 sums truncate) or in exact
//   arithmetic, misses it. So the f32 backward keeps FMA for all five
//   products.
//
// What bounds it on the H100: the five products are 10*Tq*Tk*d FLOPs per head
// (about half when causal) against reading q, k, v, o, dO and writing dq, dk,
// dv once, so at the training shape (T 1024, d 64) the arithmetic bounds it:
// in bf16 the 989 TFLOP/s tensor cores, which mma.sync reaches only part of
// (wgmma is the full-rate path); in f32 the 67 TFLOP/s FMA pipes (165 TFLOP/s
// is what the TF32 split could reach). The two recomputed products cost 40 %
// more work than the bound counts.
//
// Operands are strided (B, H, T, d) views with unit stride on d: (b, h, t)
// strides in elements come in as arguments, each a multiple of 16 bytes, and
// every base 16-byte aligned (the Python wrapper checks this), so the fused
// QKV projection's views are read, and its gradient written, in place. lse
// and D are contiguous (B*H, Tq) f32; the key mask, if given, (B, kmask_ld)
// bytes, zero past seq_k. The mask is a template parameter: the unmasked
// instantiations are the kernels as they were; the masked dQ kernel tests
// each key's byte on every tile, the masked dK/dV kernel (whose keys are
// its own rows) reads its rows' bytes once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "flash_bwd_delta.cuh"
#include "flash_mma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// (b, h, t) strides in elements of the eight operands, in this order
enum { Q = 0, K, V, O, DO, DQ, DK, DV };

struct Args {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  const float* lse;
  void* dq; void* dk; void* dv;
  float* delta;
  long long st[8][3];
  int h, seq_q, seq_k, d;
  float scale;
  int causal;
  const uint8_t* kmask;         // (B, kmask_ld) key bytes, or null
  long long kmask_ld;
};

// element offset of head bh's (T, d) matrix in an operand
__device__ __forceinline__ long long head(const Args& a, int which, int bh) {
  return (bh / a.h) * a.st[which][0] + (bh % a.h) * a.st[which][1];
}

__device__ __forceinline__ bool kept(const Args& a, int qi, int ki) {
  return qi < a.seq_q && ki < a.seq_k && (!a.causal || qi >= ki);
}

// the key-mask row of head bh's batch element
__device__ __forceinline__ const uint8_t* mask_row(const Args& a, int bh) {
  return a.kmask + (bh / a.h) * a.kmask_ld;
}

// ------------------------------------------------------------ the products
// A warp's two product shapes (flash_mma.cuh) and the elementwise step
// between them, by dtype: scores C of the warp's 16 own rows against the KT
// rows of a walked tile, and an accumulator Acc of the 16 rows by the head
// dim. Both keep S, dP, P and dS in registers between the products.

// bf16: mma.sync m16n8k16; C in the m16n8 accumulator layout (rows lane / 4
// and + 8, columns 8 j + 2 (lane % 4) and + 1), P and dS rounded to bf16
// into the A fragments of the accumulating products
template <int W, int KT> struct MmaBf16 {
  static constexpr int NT = KT / 8;
  typedef float C[NT][4];
  typedef float Acc[W / 8][4];
  static constexpr int SCRATCH = 0;     // floats of warp scratch
  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  __device__ static void scores(C& c, const bf16* sa, int r0, const bf16* sb,
                                int d, int lane) {
    product_abt<bf16, W, NT>(c, sa, r0, sb, lane);
  }
  // the warp rows (of its 16) a lane holds elements of, by slot
  static constexpr int ROWS = 2;
  __device__ static int row(int lane, int slot) {
    return (lane >> 2) + 8 * slot;
  }
  // f(row slot, column among the tile's KT, x, y) for each element
  template <typename F>
  __device__ static void each(C& x, C& y, int lane, F f) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(e >> 1, j * 8 + 2 * (lane & 3) + (e & 1), x[j][e], y[j][e]);
  }
  // p = exp(s * scale - lse), in base 2; dS = p (dP - D)
  __device__ static float prob(float s, float scale, float lse) {
    return ex2(fmaf(s, scale * LOG2E, -lse * LOG2E));
  }
  __device__ static float dscore(float p, float dp, float dl) {
    return p * (dp - dl);
  }
  __device__ static void accumulate(Acc& acc, const C& x, float*,
                                    const bf16* sb, int lane) {
    product_acc<bf16, W, NT>(acc, x, sb, lane);
  }
  __device__ static void store(const Acc& acc, bf16* dst, long long st,
                               int row0, int n_rows, int d, float scale,
                               int lane) {
    store_rows<bf16, W>(acc, dst, st, row0, n_rows, d, scale, lane);
  }
};

// f32: fused multiply-adds on the CUDA cores, each output's sum taken in
// order (d ascending for S and dP; keys, or queries, ascending for dQ, dK and
// dV, tile after tile), one rounding a term, and the elementwise step
// rounded as the plain version rounds it (s * scale, then - lse, then exp;
// dP - D, then * p). That is the order and rounding of the plain version's
// f32 products on the card (cuBLAS with TF32 off), which the f32 rows of the
// tolerance table hold the kernel to: a 64-row tile's relative L2 error of
// 5e-7 is below what that plain version's own f32 sums are off by at T 1024
// (8.3-8.4e-7 against f64), so a sum in another order, on tensor cores or
// not, cannot meet it. Lane (rg, cg) = (lane / 8, lane % 8) holds score rows
// rg + 4 i and columns cg + 8 c, and accumulator rows rg + 4 i by columns
// 4 cg + 32 q .. + 3: 16-byte shared-memory loads that a quarter warp
// shares or spreads over 8 distinct bank groups, 4 to 10 FMAs a load. The
// score tile goes to the accumulating product through 16 x KT floats of
// warp scratch.
template <int W, int KT> struct FmaF32 {
  static constexpr int NC = KT / 8;
  static constexpr int LDX = KT + 8;    // scratch row stride: 8 banks apart
  typedef float C[4][NC];
  typedef float Acc[4][W / 32][4];
  static constexpr int SCRATCH = 16 * LDX;
  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < W / 32; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.0f;
  }
  __device__ static void scores(C& c, const float* sa, int r0,
                                const float* sb, int d, int lane) {
    constexpr int ld = row_stride<float, W>();
    const int rg = lane >> 3, cg = lane & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < NC; ++n) c[i][n] = 0.0f;
    const float* ar = sa + (r0 + rg) * ld;
    const float* br = sb + cg * ld;
#pragma unroll 1
    for (int k = 0; k < d; k += 4) {
      float4 a[4], b[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(ar + 4 * i * ld + k);
#pragma unroll
      for (int n = 0; n < NC; ++n)
        b[n] = *reinterpret_cast<const float4*>(br + 8 * n * ld + k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          float t = fmaf(a[i].x, b[n].x, c[i][n]);
          t = fmaf(a[i].y, b[n].y, t);
          t = fmaf(a[i].z, b[n].z, t);
          c[i][n] = fmaf(a[i].w, b[n].w, t);
        }
    }
  }
  static constexpr int ROWS = 4;
  __device__ static int row(int lane, int slot) {
    return (lane >> 3) + 4 * slot;
  }
  template <typename F>
  __device__ static void each(C& x, C& y, int lane, F f) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < NC; ++n)
        f(i, (lane & 7) + 8 * n, x[i][n], y[i][n]);
  }
  __device__ static float prob(float s, float scale, float lse) {
    return expf(__fsub_rn(__fmul_rn(s, scale), lse));
  }
  __device__ static float dscore(float p, float dp, float dl) {
    return __fmul_rn(p, __fsub_rn(dp, dl));
  }
  __device__ static void accumulate(Acc& acc, const C& x, float* sx,
                                    const float* sb, int lane) {
    constexpr int ld = row_stride<float, W>();
    const int rg = lane >> 3, cg = lane & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < NC; ++n)
        sx[(rg + 4 * i) * LDX + cg + 8 * n] = x[i][n];
    __syncwarp();
#pragma unroll 1
    for (int k = 0; k < KT; k += 4) {
      float4 xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xv[i] = *reinterpret_cast<const float4*>(sx + (rg + 4 * i) * LDX + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* br = sb + (k + kk) * ld + 4 * cg;
#pragma unroll
        for (int q = 0; q < W / 32; ++q) {
          const float4 b = *reinterpret_cast<const float4*>(br + 32 * q);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float xs = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y
                           : kk == 2 ? xv[i].z : xv[i].w;
            acc[i][q][0] = fmaf(xs, b.x, acc[i][q][0]);
            acc[i][q][1] = fmaf(xs, b.y, acc[i][q][1]);
            acc[i][q][2] = fmaf(xs, b.z, acc[i][q][2]);
            acc[i][q][3] = fmaf(xs, b.w, acc[i][q][3]);
          }
        }
      }
    }
    __syncwarp();             // every lane has read sx before it is rewritten
  }
  __device__ static void store(const Acc& acc, float* dst, long long st,
                               int row0, int n_rows, int d, float scale,
                               int lane) {
    const int rg = lane >> 3, cg = lane & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + rg + 4 * i;
      if (r >= n_rows) continue;
#pragma unroll
      for (int q = 0; q < W / 32; ++q) {
        const int col = 4 * cg + 32 * q;
        if (col >= d) break;
        *reinterpret_cast<float4*>(dst + r * st + col) = make_float4(
            __fmul_rn(acc[i][q][0], scale), __fmul_rn(acc[i][q][1], scale),
            __fmul_rn(acc[i][q][2], scale), __fmul_rn(acc[i][q][3], scale));
      }
    }
  }
};

// tiling of one (dtype, tile width, key mask) instantiation
template <typename T, int W, bool MASK> struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  // rows of a block's own tile (query rows in the dq kernel, key rows in the
  // dkdv kernel), 16 a warp: 64, or 32 for f32 at W 256, where two own tiles
  // of 64 rows and the ring would pass the 227 KB shared-memory opt-in
  static constexpr int BM = F32 && W == 256 ? 32 : 64;
  static constexpr int LD = row_stride<T, W>();
  // rows of each tile a block walks over: 64 for bf16 at W 64, else 32
  // (registers: 64 spills at W 32; for f32, shared memory too)
  static constexpr int KT = !F32 && W == 64 ? 64 : 32;
  // whether a tile's products skip the mask where no key of it is masked:
  // masking every element is the faster code up to W 128 (the branch
  // splits the unrolled loop), but from W 192 the branch is what keeps the
  // dq kernel inside 255 registers
  static constexpr bool SKIP_MASK = W >= 192;
  typedef typename std::conditional<F32, FmaF32<W, KT>, MmaBf16<W, KT>>::type
      M;
  // the dkdv kernel where dK and dV together would crowd a lane's registers
  // (from W 192, and f32 from W 128; bf16 at W 128 under a key mask, whose
  // kept-row bits spill 48 bytes there): two groups of warps over the same
  // key rows, one accumulating dV (it recomputes S^T and P), the other dK
  // (S^T, dP^T, P and dS)
  static constexpr bool SPLIT = W >= 192 || (F32 && W == 128) ||
                                (MASK && W == 128);
  static constexpr int Q_THREADS = BM * 2;
  static constexpr int KV_THREADS = BM * 2 * (SPLIT ? 2 : 1);
  // own pair (Q and dO, or K and V) plus two buffers of the walked pair
  static __host__ __device__ constexpr size_t operand_bytes() {
    return (size_t)(2 * BM + 4 * KT) * LD * sizeof(T);
  }
  static __host__ __device__ constexpr size_t q_bytes() {
    return operand_bytes() + (size_t)Q_THREADS / 32 * M::SCRATCH * 4;
  }
  // the dkdv kernel also stages two buffers of KT rows of lse and D
  static __host__ __device__ constexpr size_t kv_bytes() {
    return operand_bytes() + (size_t)KV_THREADS / 32 * M::SCRATCH * 4 +
           4 * KT * sizeof(float);
  }
};

// lse and D of query rows [q0, q0 + ROWS) (0 past seq_q)
template <int ROWS>
__device__ __forceinline__ void load_rows(float* s_lse, float* s_d,
                                          const Args& a, int bh, int q0,
                                          int nthreads) {
  for (int i = threadIdx.x; i < 2 * ROWS; i += nthreads) {
    const int r = i % ROWS;
    const bool in = q0 + r < a.seq_q;
    const float* src = (i < ROWS ? a.lse : a.delta) + (size_t)bh * a.seq_q;
    cp_async4((i < ROWS ? s_lse : s_d) + r, in ? src + q0 + r : src, in);
  }
}

template <typename T, int W, bool MASK>
__global__ void __launch_bounds__((Cfg<T, W, MASK>::Q_THREADS))
    dq_kernel(Args a) {
  using C = Cfg<T, W, MASK>;
  using M = typename C::M;
  constexpr int BM = C::BM, KT = C::KT, NTH = C::Q_THREADS, ld = C::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + BM * ld;
  T* sK = sDO + BM * ld;                  // two buffers of KT rows
  T* sV = sK + 2 * KT * ld;
  zero_pad(smem, C::operand_bytes(), a.d < W, NTH);

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;   // longest rows first
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, r0 = warp * 16;
  float* sx = reinterpret_cast<float*>(smem + C::operand_bytes()) +
              warp * M::SCRATCH;
  const T* kb = static_cast<const T*>(a.k) + head(a, K, bh);
  const T* vb = static_cast<const T*>(a.v) + head(a, V, bh);
  const int kv_end = a.causal ? min(a.seq_k, q0 + BM) : a.seq_k;
  const int n_tiles = (kv_end + KT - 1) / KT;
  const uint8_t* km = MASK ? mask_row(a, bh) : nullptr;

  load_tile<T, W, BM, NTH>(sQ, static_cast<const T*>(a.q) + head(a, Q, bh),
                           a.st[Q][2], q0, a.seq_q, a.d);
  load_tile<T, W, BM, NTH>(sDO,
                           static_cast<const T*>(a.dout) + head(a, DO, bh),
                           a.st[DO][2], q0, a.seq_q, a.d);
  load_tile<T, W, KT, NTH>(sK, kb, a.st[K][2], 0, a.seq_k, a.d);
  load_tile<T, W, KT, NTH>(sV, vb, a.st[V][2], 0, a.seq_k, a.d);
  cp_async_commit();

  // lse and D of the query rows this lane holds elements of
  int qi[M::ROWS];
  float lse[M::ROWS], dl[M::ROWS];
#pragma unroll
  for (int i = 0; i < M::ROWS; ++i) {
    qi[i] = q0 + r0 + M::row(lane, i);
    const bool in = qi[i] < a.seq_q;
    const size_t at = (size_t)bh * a.seq_q + (in ? qi[i] : 0);
    lse[i] = in ? a.lse[at] : 0.0f;
    dl[i] = in ? a.delta[at] : 0.0f;
  }
  typename M::Acc dq;
  M::zero(dq);
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, k0 = t * KT;
    if (t + 1 < n_tiles) {
      load_tile<T, W, KT, NTH>(sK + (buf ^ 1) * KT * ld, kb, a.st[K][2],
                               k0 + KT, a.seq_k, a.d);
      load_tile<T, W, KT, NTH>(sV + (buf ^ 1) * KT * ld, vb, a.st[V][2],
                               k0 + KT, a.seq_k, a.d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // causal: a key tile past the warp's last row adds nothing to it
    if (!a.causal || k0 <= q0 + r0 + 15) {
      const T* k_s = sK + buf * KT * ld;
      typename M::C s, dp;
      M::scores(s, sQ, r0, k_s, a.d, lane);                      // S
      M::scores(dp, sDO, r0, sV + buf * KT * ld, a.d, lane);     // dP
      const bool edge = !C::SKIP_MASK || MASK || k0 + KT > a.seq_k ||
                        q0 + r0 + 16 > a.seq_q ||
                        (a.causal && k0 + KT - 1 > q0 + r0);
      M::each(s, dp, lane, [&](int i, int c, float& sv, float& dpv) {
        float ds = 0.0f;
        bool keep = !edge || kept(a, qi[i], k0 + c);
        if constexpr (MASK) keep = keep && k0 + c < a.seq_k && km[k0 + c];
        if (keep)
          ds = M::dscore(M::prob(sv, a.scale, lse[i]), dpv, dl[i]);
        sv = ds;
      });
      M::accumulate(dq, s, sx, k_s, lane);                       // += dS K
    }
    __syncthreads();          // every warp is done with buf before its refill
  }
  M::store(dq, static_cast<T*>(a.dq) + head(a, DQ, bh), a.st[DQ][2], q0 + r0,
           a.seq_q, a.d, a.scale, lane);
}

template <typename T, int W, bool MASK>
__global__ void __launch_bounds__((Cfg<T, W, MASK>::KV_THREADS))
    dkdv_kernel(Args a) {
  using C = Cfg<T, W, MASK>;
  using M = typename C::M;
  constexpr int BM = C::BM, KT = C::KT, NTH = C::KV_THREADS, ld = C::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + BM * ld;
  T* sQ = sV + BM * ld;                   // two buffers of KT rows
  T* sDO = sQ + 2 * KT * ld;
  float* sLse = reinterpret_cast<float*>(smem + C::operand_bytes());
  float* sD = sLse + 2 * KT;              // two buffers of KT each
  zero_pad(smem, C::operand_bytes(), a.d < W, NTH);

  const int bh = blockIdx.y, k0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sx = sD + 2 * KT + warp * M::SCRATCH;
  // split: warps [0, BM / 16) accumulate dV, the next BM / 16 dK, each group
  // over all BM key rows; else every warp both, over its own 16
  const int grp = warp / (BM / 16), r0 = warp % (BM / 16) * 16;
  const bool want_ds = !C::SPLIT || grp == 1;
  const T* qb = static_cast<const T*>(a.q) + head(a, Q, bh);
  const T* dob = static_cast<const T*>(a.dout) + head(a, DO, bh);
  // causal: query tiles ending before this key tile see none of it
  const int q_begin = a.causal ? k0 / KT * KT : 0;
  // masked: whether each key row this lane holds elements of is kept (the
  // mask's row is padded past seq_k with zeros)
  bool row_kept[M::ROWS];
#pragma unroll
  for (int i = 0; i < M::ROWS; ++i)
    row_kept[i] = !MASK || mask_row(a, bh)[k0 + r0 + M::row(lane, i)];
  const int n_tiles =
      q_begin < a.seq_q ? (a.seq_q - q_begin + KT - 1) / KT : 0;

  load_tile<T, W, BM, NTH>(sK, static_cast<const T*>(a.k) + head(a, K, bh),
                           a.st[K][2], k0, a.seq_k, a.d);
  load_tile<T, W, BM, NTH>(sV, static_cast<const T*>(a.v) + head(a, V, bh),
                           a.st[V][2], k0, a.seq_k, a.d);
  if (n_tiles > 0) {
    load_tile<T, W, KT, NTH>(sQ, qb, a.st[Q][2], q_begin, a.seq_q, a.d);
    load_tile<T, W, KT, NTH>(sDO, dob, a.st[DO][2], q_begin, a.seq_q, a.d);
    load_rows<KT>(sLse, sD, a, bh, q_begin, NTH);
  }
  cp_async_commit();

  // acc0: dV (dK in the split's second group); acc1: dK (unused when split)
  typename M::Acc acc0, acc1;
  M::zero(acc0);
  if constexpr (!C::SPLIT) M::zero(acc1);

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, q0 = q_begin + t * KT;
    if (t + 1 < n_tiles) {
      const int nb = buf ^ 1;
      load_tile<T, W, KT, NTH>(sQ + nb * KT * ld, qb, a.st[Q][2], q0 + KT,
                               a.seq_q, a.d);
      load_tile<T, W, KT, NTH>(sDO + nb * KT * ld, dob, a.st[DO][2], q0 + KT,
                               a.seq_q, a.d);
      load_rows<KT>(sLse + nb * KT, sD + nb * KT, a, bh, q0 + KT, NTH);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // causal: a query tile ending before the warp's first key row sees none
    // of the warp's keys
    if (!a.causal || q0 + KT - 1 >= k0 + r0) {
      const T* q_s = sQ + buf * KT * ld;
      const T* do_s = sDO + buf * KT * ld;
      const float* lse_s = sLse + buf * KT;
      const float* d_s = sD + buf * KT;
      typename M::C st, dpt;            // S^T and dP^T: key rows, query columns
      M::scores(st, sK, r0, q_s, a.d, lane);
      if (want_ds) M::scores(dpt, sV, r0, do_s, a.d, lane);
      const bool edge = !C::SKIP_MASK || MASK || q0 + KT > a.seq_q ||
                        k0 + r0 + 16 > a.seq_k ||
                        (a.causal && q0 < k0 + r0 + 15);
      M::each(st, dpt, lane, [&](int i, int c, float& sv, float& dpv) {
        float p = 0.0f, ds = 0.0f;
        if ((!edge || kept(a, q0 + c, k0 + r0 + M::row(lane, i))) &&
            row_kept[i]) {
          p = M::prob(sv, a.scale, lse_s[c]);
          if (want_ds) ds = M::dscore(p, dpv, d_s[c]);
        }
        if constexpr (C::SPLIT) {
          sv = want_ds ? ds : p;
        } else {
          dpv = p;                      // P^T, cast to v's type for dV
          sv = ds;                      // dS^T
        }
      });
      if constexpr (C::SPLIT) {
        M::accumulate(acc0, st, sx, want_ds ? q_s : do_s, lane);
      } else {
        M::accumulate(acc0, dpt, sx, do_s, lane);           // += P^T dO
        M::accumulate(acc1, st, sx, q_s, lane);             // += dS^T Q
      }
    }
    __syncthreads();          // every warp is done with buf before its refill
  }
  cp_async_wait<0>();         // no copy outlives the block (n_tiles == 0)
  T* dv = static_cast<T*>(a.dv) + head(a, DV, bh);
  T* dk = static_cast<T*>(a.dk) + head(a, DK, bh);
  if constexpr (C::SPLIT) {
    if (want_ds)
      M::store(acc0, dk, a.st[DK][2], k0 + r0, a.seq_k, a.d, a.scale, lane);
    else
      M::store(acc0, dv, a.st[DV][2], k0 + r0, a.seq_k, a.d, 1.0f, lane);
  } else {
    M::store(acc0, dv, a.st[DV][2], k0 + r0, a.seq_k, a.d, 1.0f, lane);
    M::store(acc1, dk, a.st[DK][2], k0 + r0, a.seq_k, a.d, a.scale, lane);
  }
}

// ==================================================================== launch
// the shared-memory opt-in of a kernel, once per instantiation
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int W, bool MASK>
cudaError_t launch(const Args& a, int bh, cudaStream_t stream) {
  using C = Cfg<T, W, MASK>;
  static_assert(C::q_bytes() <= 232448 && C::kv_bytes() <= 232448,
                "over the 227 KB shared-memory opt-in");
  static const cudaError_t attr_q =
      opt_in(dq_kernel<T, W, MASK>, C::q_bytes());
  static const cudaError_t attr_kv =
      opt_in(dkdv_kernel<T, W, MASK>, C::kv_bytes());
  if (attr_q != cudaSuccess) return attr_q;
  if (attr_kv != cudaSuccess) return attr_kv;
  DeltaArgs da{a.o, a.dout, {a.st[O][0], a.st[O][1], a.st[O][2]},
               {a.st[DO][0], a.st[DO][1], a.st[DO][2]}, a.lse, a.delta,
               nullptr, a.h, a.seq_q, a.seq_q, a.d};
  delta_kernel<T><<<dim3((a.seq_q + 31) / 32, bh), 256, 0, stream>>>(da);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, W, MASK><<<dim3((a.seq_q + C::BM - 1) / C::BM, bh),
                          C::Q_THREADS, C::q_bytes(), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, W, MASK><<<dim3((a.seq_k + C::BM - 1) / C::BM, bh),
                            C::KV_THREADS, C::kv_bytes(), stream>>>(a);
  return cudaGetLastError();
}

// the narrowest width that holds d
template <typename T, bool MASK>
cudaError_t dispatch(const Args& a, int bh, cudaStream_t s) {
  if (a.d <= 32) return launch<T, 32, MASK>(a, bh, s);
  if (a.d <= 64) return launch<T, 64, MASK>(a, bh, s);
  if (a.d <= 96) return launch<T, 96, MASK>(a, bh, s);
  if (a.d <= 128) return launch<T, 128, MASK>(a, bh, s);
  if (a.d <= 192) return launch<T, 192, MASK>(a, bh, s);
  return launch<T, 256, MASK>(a, bh, s);
}

}  // namespace

// Plain C interface, loaded with ctypes. strides: 24 (b, h, t) strides in
// elements of q, k, v, o, dO, dq, dk, dv, in that order. lse and delta (the
// D scratch) are contiguous (b*h, seq_q) f32. dtype: 0 = float32, 1 = bfloat16.
// kmask: null, or (b, kmask_ld) bytes, nonzero where a key is kept.
// Returns the first failing launch's cudaError_t (0 on success); never
// synchronises.
extern "C" int dl4j_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int b, int h, int seq_q, int seq_k, int d,
    const long long* strides, float scale, int causal, int dtype,
    const void* kmask, long long kmask_ld, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || h < 1 || (long long)b * h > 65535 || seq_q < 1 || seq_k < 1 ||
      d < 8 || d > 256 || d % 8)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.delta = static_cast<float*>(delta);
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  a.h = h; a.seq_q = seq_q; a.seq_k = seq_k; a.d = d;
  a.scale = scale;
  a.causal = causal;
  a.kmask = static_cast<const uint8_t*>(kmask);
  a.kmask_ld = kmask_ld;
  if (dtype == 1)
    return (int)(kmask ? dispatch<bf16, true>(a, b * h, s)
                       : dispatch<bf16, false>(a, b * h, s));
  if (dtype == 0)
    return (int)(kmask ? dispatch<float, true>(a, b * h, s)
                       : dispatch<float, false>(a, b * h, s));
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
