// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of attention from
// the forward's q, k, v, o, lse and the output gradient dO.
//
// Replaces `_bwd_blockwise` (the custom-VJP backward `_flash_bwd` of the Pallas
// kernel, registered with `_flash.defvjp`) in
// deeplearning4j_tpu/kernels/flash_attention.py, and computes the same
// function with the same rounding points:
//   D  = rowsum(f32 dO * f32 O)
//   p  = exp(s * scale - lse) in f32, masked keys (the -1e30 sentinel there)
//        exactly 0: keys past seq_k, and k_idx > q_idx when causal
//   dV = bf16(p)^T dO          dP = dO V^T
//   dS = bf16(p * (dP - D))    dQ = scale * dS K     dK = scale * dS^T Q
// with low-precision operands and f32 accumulation (f32 operands: scalar FMA
// in full f32, no TF32 anywhere in the port).
//
// Three kernels, FA2's split, one launch each from dl4j_flash_attention_bwd:
//   delta_kernel - D, 8 lanes a row with 16-byte loads (flash_bwd_delta.cuh);
//   dq kernel    - one block per (b*h, 64-row query tile), looping over the
//                  key tiles that tile sees (up to the diagonal when causal),
//                  dQ in f32 registers; no atomics, so dq is deterministic,
//                  as the JAX scan is;
//   dkdv kernel  - one block per (b*h, 64-row key tile), looping over the
//                  query tiles that see it (from the diagonal on when
//                  causal), dK and dV in f32 registers.
// Each recomputes the scores and dP it needs (7 products in all, where the JAX
// scan does 5), so neither the (T, T) scores nor any cross-block sum reaches
// device memory. Each warp owns 16 rows of its block's own tile (query rows in
// the dq kernel, key rows in the dkdv kernel, which therefore computes S^T and
// dP^T directly).
//
// bf16: mma.sync m16n8k16 with f32 accumulators. S and dP stay in the
// accumulator registers; P and dS are rounded to bf16 straight into the A
// fragments of the next products (the accumulator layout of two neighbouring
// 8-column tiles is the A layout of one 16-deep step), so no score tile
// touches shared memory. Operands come from shared memory through ldmatrix
// (rows padded by 16 bytes: the 8 rows of a fragment load hit 8 distinct bank
// groups), and the tiles a block walks over are double-buffered with cp.async,
// so the next tile's load overlaps this tile's products.
// f32: the scalar path, tiles and scores staged through shared memory.
//
// What bounds it on the H100: the five products are 10*Tq*Tk*d FLOPs per head
// (about half when causal) against reading q, k, v, o, dO and writing dq, dk,
// dv once, so at the training shape (T 1024, d 64, bf16) the tensor cores bound
// it. mma.sync reaches only part of their rate on Hopper (wgmma is the full-rate
// path, left for a redesign), and the two recomputed products cost 40 % more
// work than the bound counts.
//
// Operands are strided (B, H, T, d) views with unit stride on d: (b, h, t)
// strides in elements come in as arguments, each a multiple of 16 bytes, and
// every base 16-byte aligned (the Python wrapper checks this), so the fused
// QKV projection's views are read, and its gradient written, in place. lse
// and D are contiguous (B*H, Tq) f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "flash_bwd_delta.cuh"

namespace {

constexpr int BM = 64;          // rows of a block's own tile (query or key)
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WROWS = 16;       // rows of the block's own tile per warp
constexpr float LOG2E = 1.4426950408889634f;
typedef __nv_bfloat16 bf16;

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
};

// element offset of head bh's (T, d) matrix in an operand
__device__ __forceinline__ long long head(const Args& a, int which, int bh) {
  return (bh / a.h) * a.st[which][0] + (bh % a.h) * a.st[which][1];
}

__device__ __forceinline__ bool kept(const Args& a, int qi, int ki) {
  return qi < a.seq_q && ki < a.seq_k && (!a.causal || qi >= ki);
}

// ====================================================================== bf16
// The tiles a block walks over have KT rows: 64, or 32 above d 64, where the
// dkdv kernel's dK and dV accumulators take twice the registers.
template <int D> struct Tile {
  static constexpr int LD = D + 8;        // shared-memory row stride (bf16)
  static constexpr int KT = D <= 64 ? 64 : 32;
  // own Q and dO (dq) or K and V (dkdv), plus two buffers of the walked pair
  static constexpr size_t OPERAND_BYTES = (size_t)(2 * BM + 4 * KT) * LD * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + ROWS) of a strided (n_rows, D) matrix into shared rows of
// stride LD, zero-filled past n_rows
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long st, int row0, int n_rows) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + r * Tile<D>::LD + c * 8,
               in ? src + (row0 + r) * st + c * 8 : src, in);
  }
}

// lse and D of query rows [q0, q0 + ROWS) (0 past seq_q)
template <int ROWS>
__device__ __forceinline__ void load_rows(float* s_lse, float* s_d,
                                          const Args& a, int bh, int q0) {
  for (int i = threadIdx.x; i < 2 * ROWS; i += NTHREADS) {
    const int r = i % ROWS;
    const bool in = q0 + r < a.seq_q;
    const float* src = (i < ROWS ? a.lse : a.delta) + (size_t)bh * a.seq_q;
    cp_async4((i < ROWS ? s_lse : s_d) + r, in ? src + q0 + r : src, in);
  }
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16) b (16 x 8), bf16 operands
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows r0.., columns k0.. of a row-major shared matrix
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const bf16* s, int r0,
                                       int k0, int lane) {
  ldsm4(f, s + (r0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}
// B fragments of the two 8-column tiles n0.. and n0 + 8.. at depth k0.., from
// a shared matrix stored [n][k] (f[0], f[1] the first tile, f[2], f[3] the
// second)
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t (&f)[4], const bf16* s,
                                          int n0, int k0, int lane) {
  ldsm4(f, s + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 +
               ((lane >> 3) & 1) * 8);
}
// the same from a shared matrix stored [k][n]
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t (&f)[4], const bf16* s,
                                          int k0, int n0, int lane) {
  ldsm4_t(f, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
                 (lane >> 4) * 8);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}
// accumulator tiles j, j + 1 (16 x 8 each) as the A fragment of one 16-deep
// step, rounded to bf16
__device__ __forceinline__ void to_a(uint32_t (&f)[4], const float (&c0)[4],
                                     const float (&c1)[4]) {
  f[0] = pack(c0[0], c0[1]);
  f[1] = pack(c0[2], c0[3]);
  f[2] = pack(c1[0], c1[1]);
  f[3] = pack(c1[2], c1[3]);
}

// c (16 x N) = a-matrix rows r0.. (row-major [m][k], k = D) times the rows
// n0.. of a matrix stored [n][k]: both of the first two products
template <int D, int NT>
__device__ __forceinline__ void product_abt(float (&c)[NT][4], const bf16* sa,
                                            int r0, const bf16* sb, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4];
    frag_a<Tile<D>::LD>(fa, sa, r0, kk * 16, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t fb[4];
      frag_b_nk<Tile<D>::LD>(fb, sb, np * 16, kk * 16, lane);
      mma(c[2 * np], fa, fb[0], fb[1]);
      mma(c[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc (16 x D) += x (16 x KT, in accumulator layout, rounded to bf16) times a
// shared matrix stored [k][n] (KT rows of D)
template <int D, int NT>
__device__ __forceinline__ void product_acc(float (&acc)[D / 8][4],
                                            const float (&x)[NT][4],
                                            const bf16* sb, int lane) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t fa[4];
    to_a(fa, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t fb[4];
      frag_b_kn<Tile<D>::LD>(fb, sb, kk * 16, np * 16, lane);
      mma(acc[2 * np], fa, fb[0], fb[1]);
      mma(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// rows row0 + lane/4 and row0 + lane/4 + 8 (of n_rows, stride st) of dst =
// scale * acc, in bf16
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           bf16* dst, long long st, int row0,
                                           int n_rows, float scale, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + (lane >> 2) + 8 * h;
    if (r >= n_rows) continue;
    bf16* row = dst + r * st + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) dq_kernel_bf16(Args a) {
  constexpr int LD = Tile<D>::LD, KT = Tile<D>::KT, NT = KT / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + BM * LD;
  bf16* sK = sDO + BM * LD;               // two buffers of KT rows
  bf16* sV = sK + 2 * KT * LD;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;   // longest rows first
  const int lane = threadIdx.x % 32, r0 = threadIdx.x / 32 * WROWS;
  const bf16* kb = static_cast<const bf16*>(a.k) + head(a, K, bh);
  const bf16* vb = static_cast<const bf16*>(a.v) + head(a, V, bh);
  const int kv_end = a.causal ? min(a.seq_k, q0 + BM) : a.seq_k;
  const int n_tiles = (kv_end + KT - 1) / KT;

  load_tile<D, BM>(sQ, static_cast<const bf16*>(a.q) + head(a, Q, bh),
                   a.st[Q][2], q0, a.seq_q);
  load_tile<D, BM>(sDO, static_cast<const bf16*>(a.dout) + head(a, DO, bh),
                   a.st[DO][2], q0, a.seq_q);
  load_tile<D, KT>(sK, kb, a.st[K][2], 0, a.seq_k);
  load_tile<D, KT>(sV, vb, a.st[V][2], 0, a.seq_k);
  cp_async_commit();

  // this lane's two query rows, their lse (in log2 units) and D
  int qi[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = q0 + r0 + lane / 4 + 8 * h;
    const bool in = qi[h] < a.seq_q;
    const size_t at = (size_t)bh * a.seq_q + (in ? qi[h] : 0);
    lse2[h] = in ? a.lse[at] * LOG2E : 0.0f;
    dl[h] = in ? a.delta[at] : 0.0f;
  }
  const float scale2 = a.scale * LOG2E;
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, k0 = t * KT;
    if (t + 1 < n_tiles) {
      load_tile<D, KT>(sK + (buf ^ 1) * KT * LD, kb, a.st[K][2], k0 + KT,
                       a.seq_k);
      load_tile<D, KT>(sV + (buf ^ 1) * KT * LD, vb, a.st[V][2], k0 + KT,
                       a.seq_k);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* k_s = sK + buf * KT * LD;
    float s[NT][4], dp[NT][4];
    product_abt<D, NT>(s, sQ, r0, k_s, lane);                   // S
    product_abt<D, NT>(dp, sDO, r0, sV + buf * KT * LD, lane);  // dP
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, ki = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
        float ds = 0.0f;
        if (kept(a, qi[h], ki))
          ds = exp2f(fmaf(s[j][e], scale2, -lse2[h])) * (dp[j][e] - dl[h]);
        s[j][e] = ds;
      }
    product_acc<D, NT>(dq, s, k_s, lane);                       // += dS K
    __syncthreads();          // every warp is done with buf before its refill
  }
  store_rows<D>(dq, static_cast<bf16*>(a.dq) + head(a, DQ, bh), a.st[DQ][2],
                q0 + r0, a.seq_q, a.scale, lane);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) dkdv_kernel_bf16(Args a) {
  constexpr int LD = Tile<D>::LD, KT = Tile<D>::KT, NT = KT / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BM * LD;
  bf16* sQ = sV + BM * LD;                // two buffers of KT rows
  bf16* sDO = sQ + 2 * KT * LD;
  float* sLse = reinterpret_cast<float*>(sDO + 2 * KT * LD);   // two of KT
  float* sD = sLse + 2 * KT;

  const int bh = blockIdx.y, k0 = blockIdx.x * BM;
  const int lane = threadIdx.x % 32, r0 = threadIdx.x / 32 * WROWS;
  const bf16* qb = static_cast<const bf16*>(a.q) + head(a, Q, bh);
  const bf16* dob = static_cast<const bf16*>(a.dout) + head(a, DO, bh);
  // causal: query tiles ending before this key tile see none of it
  const int q_begin = a.causal ? k0 / KT * KT : 0;
  const int n_tiles =
      q_begin < a.seq_q ? (a.seq_q - q_begin + KT - 1) / KT : 0;

  load_tile<D, BM>(sK, static_cast<const bf16*>(a.k) + head(a, K, bh),
                   a.st[K][2], k0, a.seq_k);
  load_tile<D, BM>(sV, static_cast<const bf16*>(a.v) + head(a, V, bh),
                   a.st[V][2], k0, a.seq_k);
  if (n_tiles > 0) {
    load_tile<D, KT>(sQ, qb, a.st[Q][2], q_begin, a.seq_q);
    load_tile<D, KT>(sDO, dob, a.st[DO][2], q_begin, a.seq_q);
    load_rows<KT>(sLse, sD, a, bh, q_begin);
  }
  cp_async_commit();

  int ki[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) ki[h] = k0 + r0 + lane / 4 + 8 * h;
  const float scale2 = a.scale * LOG2E;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, q0 = q_begin + t * KT;
    if (t + 1 < n_tiles) {
      const int nb = buf ^ 1;
      load_tile<D, KT>(sQ + nb * KT * LD, qb, a.st[Q][2], q0 + KT, a.seq_q);
      load_tile<D, KT>(sDO + nb * KT * LD, dob, a.st[DO][2], q0 + KT,
                       a.seq_q);
      load_rows<KT>(sLse + nb * KT, sD + nb * KT, a, bh, q0 + KT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* q_s = sQ + buf * KT * LD;
    const bf16* do_s = sDO + buf * KT * LD;
    const float* lse_s = sLse + buf * KT;
    const float* d_s = sD + buf * KT;
    float st[NT][4], dpt[NT][4];        // S^T and dP^T: key rows, query columns
    product_abt<D, NT>(st, sK, r0, q_s, lane);
    product_abt<D, NT>(dpt, sV, r0, do_s, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = j * 8 + 2 * (lane & 3) + (e & 1);
        float p = 0.0f, ds = 0.0f;
        if (kept(a, q0 + col, ki[h])) {
          p = exp2f(fmaf(st[j][e], scale2, -lse_s[col] * LOG2E));
          ds = p * (dpt[j][e] - d_s[col]);
        }
        dpt[j][e] = p;                  // P^T, cast to v's type for dV
        st[j][e] = ds;                  // dS^T
      }
    product_acc<D, NT>(dv, dpt, do_s, lane);                    // += P^T dO
    product_acc<D, NT>(dk, st, q_s, lane);                      // += dS^T Q
    __syncthreads();          // every warp is done with buf before its refill
  }
  cp_async_wait<0>();         // no copy outlives the block (n_tiles == 0)
  store_rows<D>(dv, static_cast<bf16*>(a.dv) + head(a, DV, bh), a.st[DV][2],
                k0 + r0, a.seq_k, 1.0f, lane);
  store_rows<D>(dk, static_cast<bf16*>(a.dk) + head(a, DK, bh), a.st[DK][2],
                k0 + r0, a.seq_k, a.scale, lane);
}

// ======================================================================= f32
constexpr int LDS = BM + 4;     // f32 score rows
template <int D> constexpr int LDX = D + 4;   // f32 operand rows (+16 bytes)

// rows [row0, row0 + 64) of a strided (n_rows, D) f32 matrix into shared rows
// of stride LDX, zero-filled past n_rows, 16 bytes a thread
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long st, int row0,
                                              int n_rows) {
  constexpr int CHUNKS = D / 4;
  for (int i = threadIdx.x; i < BM * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = reinterpret_cast<const uint4*>(src + (row0 + r) * st)[c];
    reinterpret_cast<uint4*>(dst + r * LDX<D>)[c] = val;
  }
}

// C[16][64] = A[16][D] B[64][D]^T (rows of stride LDS): A is the warp's 16 rows
// of one tile, B a whole other tile
template <int D>
__device__ __forceinline__ void warp_abt_f32(const float* A, const float* B,
                                             float* C, int lane) {
  for (int i = lane; i < WROWS * BM; i += 32) {
    const int r = i / BM, c = i % BM;
    const float* ar = A + r * LDX<D>;
    const float* br = B + c * LDX<D>;
    float acc = 0.0f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) acc = fmaf(ar[d], br[d], acc);
    C[r * LDS + c] = acc;
  }
}

// The warp's f32 accumulator of a [16][D] product, D / 2 registers a lane
// (element lane + 32 e is row (lane + 32 e) / D, column (lane + 32 e) % D)
template <int D> struct AccF32 {
  float v[D / 2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < D / 2; ++e) v[e] = 0.0f;
  }

  // += A[16][64] B[64][D]: A the warp's 16 rows of P^T, dS or dS^T (stride
  // LDS), B a whole operand tile
  __device__ __forceinline__ void mma(const float* A, const float* B,
                                      int lane) {
#pragma unroll
    for (int e = 0; e < D / 2; ++e) {
      const int i = lane + 32 * e, r = i / D, j = i % D;
      float acc = v[e];
#pragma unroll 16
      for (int c = 0; c < BM; ++c)
        acc = fmaf(A[r * LDS + c], B[c * LDX<D> + j], acc);
      v[e] = acc;
    }
  }

  __device__ __forceinline__ void store(float* dst, long long st, int row0,
                                        int n_rows, float scale, int lane) {
#pragma unroll
    for (int e = 0; e < D / 2; ++e) {
      const int i = lane + 32 * e, r = i / D, j = i % D;
      if (row0 + r < n_rows) dst[(row0 + r) * st + j] = v[e] * scale;
    }
  }
};

// lse and D of query rows [q0, q0 + 64) into shared memory (0 past seq_q)
__device__ __forceinline__ void load_rows_f32(float* s_lse, float* s_d,
                                              const Args& a, int bh, int q0) {
  for (int i = threadIdx.x; i < BM; i += NTHREADS) {
    const int qi = q0 + i;
    const bool in = qi < a.seq_q;
    s_lse[i] = in ? a.lse[(size_t)bh * a.seq_q + qi] : 0.0f;
    s_d[i] = in ? a.delta[(size_t)bh * a.seq_q + qi] : 0.0f;
  }
}

// four operand tiles, N_P score-sized tiles of P / dS, S and dP, lse and D
template <int D, int N_P>
constexpr size_t smem_bytes_f32() {
  return (size_t)4 * BM * LDX<D> * 4 + (size_t)(N_P + 2) * BM * LDS * 4 +
         2 * BM * 4;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) dq_kernel_f32(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = sQ + BM * LDX<D>;
  float* sK = sDO + BM * LDX<D>;
  float* sV = sK + BM * LDX<D>;
  float* sDS = sV + BM * LDX<D>;
  float* sS = sDS + BM * LDS;
  float* sDP = sS + BM * LDS;
  float* sLse = sDP + BM * LDS;
  float* sD = sLse + BM;

  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int lane = threadIdx.x % 32, r0 = threadIdx.x / 32 * WROWS;
  const float* kb = static_cast<const float*>(a.k) + head(a, K, bh);
  const float* vb = static_cast<const float*>(a.v) + head(a, V, bh);

  load_tile_f32<D>(sQ, static_cast<const float*>(a.q) + head(a, Q, bh),
                   a.st[Q][2], q0, a.seq_q);
  load_tile_f32<D>(sDO, static_cast<const float*>(a.dout) + head(a, DO, bh),
                   a.st[DO][2], q0, a.seq_q);
  load_rows_f32(sLse, sD, a, bh, q0);
  AccF32<D> dq;
  dq.zero();

  const int kv_end = a.causal ? min(a.seq_k, q0 + BM) : a.seq_k;
  for (int k0 = 0; k0 < kv_end; k0 += BM) {
    __syncthreads();                      // every warp is done with K, V
    load_tile_f32<D>(sK, kb, a.st[K][2], k0, a.seq_k);
    load_tile_f32<D>(sV, vb, a.st[V][2], k0, a.seq_k);
    __syncthreads();

    warp_abt_f32<D>(sQ + r0 * LDX<D>, sK, sS + r0 * LDS, lane);     // S
    warp_abt_f32<D>(sDO + r0 * LDX<D>, sV, sDP + r0 * LDS, lane);   // dP
    __syncwarp();
    for (int i = lane; i < WROWS * BM; i += 32) {
      const int r = r0 + i / BM, c = i % BM;
      float ds = 0.0f;
      if (kept(a, q0 + r, k0 + c)) {
        const float p = expf(sS[r * LDS + c] * a.scale - sLse[r]);
        ds = p * (sDP[r * LDS + c] - sD[r]);
      }
      sDS[r * LDS + c] = ds;
    }
    __syncwarp();
    dq.mma(sDS + r0 * LDS, sK, lane);                             // dS K
    __syncwarp();
  }
  dq.store(static_cast<float*>(a.dq) + head(a, DQ, bh), a.st[DQ][2], q0 + r0,
           a.seq_q, a.scale, lane);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) dkdv_kernel_f32(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = sQ + BM * LDX<D>;
  float* sK = sDO + BM * LDX<D>;
  float* sV = sK + BM * LDX<D>;
  float* sDS = sV + BM * LDX<D>;          // dS^T: row = key, column = query
  float* sP = sDS + BM * LDS;             // P^T
  float* sS = sP + BM * LDS;              // S^T
  float* sDP = sS + BM * LDS;             // dP^T
  float* sLse = sDP + BM * LDS;
  float* sD = sLse + BM;

  const int bh = blockIdx.y, k0 = blockIdx.x * BM;
  const int lane = threadIdx.x % 32, r0 = threadIdx.x / 32 * WROWS;
  const float* qb = static_cast<const float*>(a.q) + head(a, Q, bh);
  const float* dob = static_cast<const float*>(a.dout) + head(a, DO, bh);

  load_tile_f32<D>(sK, static_cast<const float*>(a.k) + head(a, K, bh),
                   a.st[K][2], k0, a.seq_k);
  load_tile_f32<D>(sV, static_cast<const float*>(a.v) + head(a, V, bh),
                   a.st[V][2], k0, a.seq_k);
  AccF32<D> dk, dv;
  dk.zero();
  dv.zero();

  // causal: query tiles ending before this key tile see none of it
  const int q_begin = a.causal ? k0 : 0;
  for (int q0 = q_begin; q0 < a.seq_q; q0 += BM) {
    __syncthreads();                      // every warp is done with Q, dO
    load_tile_f32<D>(sQ, qb, a.st[Q][2], q0, a.seq_q);
    load_tile_f32<D>(sDO, dob, a.st[DO][2], q0, a.seq_q);
    load_rows_f32(sLse, sD, a, bh, q0);
    __syncthreads();

    warp_abt_f32<D>(sK + r0 * LDX<D>, sQ, sS + r0 * LDS, lane);     // S^T
    warp_abt_f32<D>(sV + r0 * LDX<D>, sDO, sDP + r0 * LDS, lane);   // dP^T
    __syncwarp();
    for (int i = lane; i < WROWS * BM; i += 32) {
      const int r = r0 + i / BM, c = i % BM;     // key r, query c
      float p = 0.0f, ds = 0.0f;
      if (kept(a, q0 + c, k0 + r)) {
        p = expf(sS[r * LDS + c] * a.scale - sLse[c]);
        ds = p * (sDP[r * LDS + c] - sD[c]);
      }
      sP[r * LDS + c] = p;
      sDS[r * LDS + c] = ds;
    }
    __syncwarp();
    dv.mma(sP + r0 * LDS, sDO, lane);                             // P^T dO
    dk.mma(sDS + r0 * LDS, sQ, lane);                             // dS^T Q
    __syncwarp();
  }
  dv.store(static_cast<float*>(a.dv) + head(a, DV, bh), a.st[DV][2], k0 + r0,
           a.seq_k, 1.0f, lane);
  dk.store(static_cast<float*>(a.dk) + head(a, DK, bh), a.st[DK][2], k0 + r0,
           a.seq_k, a.scale, lane);
}

// ==================================================================== launch
// the shared-memory opt-in of a kernel, once per instantiation
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t launch(const Args& a, int bh, cudaStream_t stream) {
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  constexpr size_t smem_q =
      BF16 ? Tile<D>::OPERAND_BYTES : smem_bytes_f32<D, 1>();
  constexpr size_t smem_kv =
      BF16 ? Tile<D>::OPERAND_BYTES + 4 * Tile<D>::KT * sizeof(float)
           : smem_bytes_f32<D, 2>();
  static_assert(smem_q <= 232448 && smem_kv <= 232448,
                "over the 227 KB shared-memory opt-in");
  auto dq = BF16 ? (void (*)(Args))dq_kernel_bf16<D> : dq_kernel_f32<D>;
  auto dkdv = BF16 ? (void (*)(Args))dkdv_kernel_bf16<D> : dkdv_kernel_f32<D>;
  static const cudaError_t attr_q = opt_in(dq, smem_q);
  static const cudaError_t attr_kv = opt_in(dkdv, smem_kv);
  if (attr_q != cudaSuccess) return attr_q;
  if (attr_kv != cudaSuccess) return attr_kv;
  DeltaArgs da{a.o, a.dout, {a.st[O][0], a.st[O][1], a.st[O][2]},
               {a.st[DO][0], a.st[DO][1], a.st[DO][2]}, a.lse, a.delta,
               nullptr, a.h, a.seq_q, a.seq_q, a.d};
  delta_kernel<T><<<dim3((a.seq_q + 31) / 32, bh), 256, 0, stream>>>(da);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq<<<dim3((a.seq_q + BM - 1) / BM, bh), NTHREADS, smem_q, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((a.seq_k + BM - 1) / BM, bh), NTHREADS, smem_kv, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int bh, cudaStream_t s) {
  switch (a.d) {
    case 16: return launch<T, 16>(a, bh, s);
    case 32: return launch<T, 32>(a, bh, s);
    case 48: return launch<T, 48>(a, bh, s);
    case 64: return launch<T, 64>(a, bh, s);
    case 80: return launch<T, 80>(a, bh, s);
    case 96: return launch<T, 96>(a, bh, s);
    case 112: return launch<T, 112>(a, bh, s);
    case 128: return launch<T, 128>(a, bh, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. strides: 24 (b, h, t) strides in
// elements of q, k, v, o, dO, dq, dk, dv, in that order. lse and delta (the
// D scratch) are contiguous (b*h, seq_q) f32. dtype: 0 = float32, 1 = bfloat16.
// Returns the first failing launch's cudaError_t (0 on success); never
// synchronises.
extern "C" int dl4j_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int b, int h, int seq_q, int seq_k, int d,
    const long long* strides, float scale, int causal, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || h < 1 || (long long)b * h > 65535 || seq_q < 1 || seq_k < 1)
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
  if (dtype == 1) return (int)dispatch<bf16>(a, b * h, s);
  if (dtype == 0) return (int)dispatch<float>(a, b * h, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
