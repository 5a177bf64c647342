// Warp-level tensor-core products of the flash-attention kernels that run on
// mma.sync (flash_attention_fwd.cu for f32 and bf16, flash_attention_bwd.cu
// for bf16): every product of both is one of two shapes, each computed by one
// warp for 16 rows of its block's own tile, with the f32 accumulators in
// registers:
//
//   product_abt  c (16 x 8 NT)  = A (16 x d, rows of a shared [m][k] tile)
//                                 times B^T (B a shared [n][k] tile)
//                e.g. S = Q K^T, dP = dO V^T
//   product_acc  acc (16 x d)  += X (16 x 8 NT, an accumulator c of the first
//                                 shape, e.g. P or dS, left in its registers)
//                                 times B (a shared [k][n] tile)
//                e.g. O += P V, dQ += dS K
//
// bf16: mma.sync m16n8k16 with f32 accumulation; operands through ldmatrix,
// and X rounded to bf16 straight into A fragments (the accumulator layout of
// two neighbouring 8-column tiles is the A layout of one 16-deep step).
//
// f32 (the forward): mma.sync m16n8k8 on tf32 operands, each f32 operand
// split in two tf32 parts, x = big + small with big = rna(x) and small =
// rna(x - big), and a b ~ big_a big_b + big_a small_b + small_a big_b, all
// three accumulated in f32 (the dropped small_a small_b and the rounding of
// small are below 2^-21 |a b|). No product rounds an operand to TF32 alone.
// The tensor cores' own f32 accumulation truncates, so the sums drift from
// f32 ones by a few 1e-6 relative (o within 5.1e-6 of the plain version at
// T 1024, PERF.md), far inside the forward's tolerance, not the backward's.
// The C fragment of m16n8k8 is laid out as m16n8k16's (row g = lane / 4
// holds columns 2t, 2t + 1, t = lane % 4), but its A fragment wants columns
// t and t + 4 of an 8-deep step; product_acc renumbers the keys instead of
// moving X: its step j takes key 8j + 2t as column t and key 8j + 2t + 1 as
// column t + 4, and reads B's rows to match.
// A sum over keys does not care about their order.
//
// Widths: a kernel is instantiated for a width W (32, 64, 96, 128, 192 or
// 256) and takes any head dim d % 8 == 0 up to W at run time. Its shared
// tiles are W wide, the columns past d zero (written once, never copied
// over), so the products run over all W columns with no branch on d: a
// branch inside the unrolled loops would keep one 8-column tile's loads
// from overlapping the last one's products. The columns past d cost their
// FLOPs (W / d of the work: at most 1.41x from d 72 on, 4x at d 8) and are
// not stored.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

// shared-memory row stride (elements) of an operand tile W wide. f32:
// W + 4, which is 4 mod 8 words for W % 8 == 0, so the warp's scalar
// fragment loads (8 rows by 4 columns, or 4 row pairs by 8 columns) hit 32
// distinct banks. bf16: W + 8, so the 8 rows of an ldmatrix hit 8 distinct
// 16-byte bank groups. Both keep rows 16-byte aligned for cp.async.
template <typename T, int W>
__host__ __device__ constexpr int row_stride() {
  return std::is_same<T, float>::value ? W + 4 : W + 8;
}

// the columns past d of every operand row, zeroed once before any copy (the
// copies write only the first d); a no-op at d == W
__device__ __forceinline__ void zero_pad(unsigned char* smem, size_t bytes,
                                         bool pad, int nthreads) {
  if (pad) {
    for (int i = threadIdx.x; i < (int)(bytes / 16); i += nthreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
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

// rows [row0, row0 + ROWS) of a strided (n_rows, d) matrix into a shared
// tile W wide, 16 bytes a copy by NTH threads, zero-filled past n_rows; the
// columns past d are not written
template <typename T, int W, int ROWS, int NTH>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long st,
                                          int row0, int n_rows, int d) {
  constexpr int VEC = 16 / (int)sizeof(T), CH = W / VEC;
  constexpr int LD = row_stride<T, W>();
  const int chunks = d / VEC;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CH; i += NTH) {
    const int r = i / CH, c = i % CH;
    const bool in = row0 + r < n_rows;
    if (c < chunks)
      cp_async16(dst + r * LD + c * VEC,
                 in ? src + (row0 + r) * st + c * VEC : src, in);
  }
}

// 2^x (relative error about 2^-22), flushing results below 2^-126 to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- bf16
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
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows r0.., columns k0.. of a row-major shared matrix
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const bf16* s, int ld,
                                       int r0, int k0, int lane) {
  ldsm4(f, s + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
// B fragments of the two 8-column tiles n0.. and n0 + 8.. at depth k0.., from
// a shared matrix stored [n][k] (f[0], f[1] the first tile, f[2], f[3] the
// second)
__device__ __forceinline__ void frag_b_nk(uint32_t (&f)[4], const bf16* s,
                                          int ld, int n0, int k0, int lane) {
  ldsm4(f, s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
               ((lane >> 3) & 1) * 8);
}
// the same from a shared matrix stored [k][n]
__device__ __forceinline__ void frag_b_kn(uint32_t (&f)[4], const bf16* s,
                                          int ld, int k0, int n0, int lane) {
  ldsm4_t(f, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
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

// ----------------------------------------------------------------- f32
// x rounded to tf32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from
// zero), in two integer ops where the cvt takes about ten on sm_90: half of
// the dropped 13 bits added to the pattern, which carries into the kept bits
// exactly when rounding away does, then the dropped bits cleared
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = big + small, both tf32 (x - big is exact in f32)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c (16 x 8, f32) += a (16 x 8) b (8 x 8), tf32 operands
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a b from the split parts: the two small products first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

// ------------------------------------------------------------ products
// c (16 x 8 NT) = rows r0.. of sa ([m][k]) times rows 0 .. 8 NT of sb
// ([n][k])^T, over W columns
template <typename T, int W, int NT>
__device__ __forceinline__ void product_abt(float (&c)[NT][4], const T* sa,
                                            int r0, const T* sb, int lane) {
  constexpr int ld = row_stride<T, W>();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      uint32_t fa[4];
      frag_a(fa, sa, ld, r0, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t fb[4];
        frag_b_nk(fb, sb, ld, np * 16, kk * 16, lane);
        mma_bf16(c[2 * np], fa, fb[0], fb[1]);
        mma_bf16(c[2 * np + 1], fa, fb[2], fb[3]);
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < W / 8; ++kk) {
      // a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
      const float* ar = sa + (r0 + g) * ld + kk * 8 + t;
      uint32_t ab[4], as[4];
      split(ar[0], ab[0], as[0]);
      split(ar[8 * ld], ab[1], as[1]);
      split(ar[4], ab[2], as[2]);
      split(ar[8 * ld + 4], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // b0 (k t, n g), b1 (k t + 4, n g) of B^T: row j 8 + g of sb
        const float* br = sb + (j * 8 + g) * ld + kk * 8 + t;
        uint32_t bb0, bs0, bb1, bs1;
        split(br[0], bb0, bs0);
        split(br[4], bb1, bs1);
        mma3(c[j], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }
}

// acc (16 x W) += x (16 x 8 NT in accumulator layout) times rows 0 .. 8 NT
// of sb ([k][n])
template <typename T, int W, int NT>
__device__ __forceinline__ void product_acc(float (&acc)[W / 8][4],
                                            const float (&x)[NT][4],
                                            const T* sb, int lane) {
  constexpr int ld = row_stride<T, W>();
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t fa[4];
      to_a(fa, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < W / 16; ++np) {
        uint32_t fb[4];
        frag_b_kn(fb, sb, ld, kk * 16, np * 16, lane);
        mma_bf16(acc[2 * np], fa, fb[0], fb[1]);
        mma_bf16(acc[2 * np + 1], fa, fb[2], fb[3]);
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // x[j] holds keys 8j + 2t (e 0, 2) and 8j + 2t + 1 (e 1, 3): columns
      // t and t + 4 of this step's A fragment
      uint32_t ab[4], as[4];
      split(x[j][0], ab[0], as[0]);
      split(x[j][2], ab[1], as[1]);
      split(x[j][1], ab[2], as[2]);
      split(x[j][3], ab[3], as[3]);
      const float* br = sb + (j * 8 + 2 * t) * ld + g;
#pragma unroll
      for (int n = 0; n < W / 8; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        split(br[n * 8], bb0, bs0);          // key 8j + 2t, column 8n + g
        split(br[ld + n * 8], bb1, bs1);     // key 8j + 2t + 1
        mma3(acc[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }
}

// rows row0 + lane / 4 and row0 + lane / 4 + 8 (of n_rows, stride st) of
// dst = scale * acc, the first d columns, in T
template <typename T, int W>
__device__ __forceinline__ void store_rows(const float (&acc)[W / 8][4],
                                           T* dst, long long st, int row0,
                                           int n_rows, int d, float scale,
                                           int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + (lane >> 2) + 8 * h;
    if (r >= n_rows) continue;
    T* row = dst + r * st + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      if (j * 8 >= d) break;
      const float lo = acc[j][2 * h] * scale, hi = acc[j][2 * h + 1] * scale;
      if constexpr (std::is_same<T, bf16>::value)
        *reinterpret_cast<__nv_bfloat162*>(row + j * 8) =
            __floats2bfloat162_rn(lo, hi);
      else
        *reinterpret_cast<float2*>(row + j * 8) = make_float2(lo, hi);
    }
  }
}

}  // namespace
