// Chunked LM cross-entropy for Hopper (sm_90a): the forward (K3f) and the
// dlogits pass of the backward (K3b) of the tied head's softmax
// cross-entropy, without the (N, V) logits ever reaching device memory.
// This is the path for f32 and for bf16 at d not a multiple of 64;
// chunked_ce_wgmma.cu takes bf16 at d a multiple of 64 (the model's
// training step).
//
// Replaces `chunked_softmax_xent` of deeplearning4j_tpu/kernels/chunked_ce.py:
// `_forward_pieces` (a lax.scan over vocab chunks: f32 logits x E_c^T, an
// online max and sum, the target logit picked from the chunk that holds it)
// and, per chunk, the dlogits of its custom-VJP backward `_bwd`:
//   dlog = (exp(s - lse) - onehot(target)) * g / N, cast to x's dtype.
// The two products of `_bwd` (dx += dlog E_c, dE_c = dlog^T x) stay plain
// f32-accumulated matrix products in the wrapper, as the reference leaves
// them to `dot_general`.
//
// K3f (ce_fwd_kernel): one block per (128-row tile of x, vocab split). It
// walks the split's 128-column vocab tiles; each tile's logits x E_tile^T
// stay in f32 registers, where the block's threads fold them into a running
// max and sum per row (the flash recurrence on the vocab axis) and pick the
// target logit where it falls. Each split writes its partial (m, l, correct)
// per row; ce_merge_kernel (chunked_ce_merge.cuh, one block) merges the
// splits into lse (saved for the backward) and the mean of lse - correct,
// the loss, in a fixed order.
// K3b (ce_dlogits_kernel): one block per 128 x 128 tile of one ce chunk's
// dlogits: the same product, then the epilogue above, written in x's dtype.
//
// Products: bf16 through mma.sync m16n8k16 with f32 accumulators, operands
// from shared memory through ldmatrix (rows padded by 16 bytes: the 8 rows a
// fragment load reads hit 8 distinct bank groups); f32 by scalar FMA in full
// f32 (the port allows no TF32), in the same accumulator layout, so one
// epilogue serves both. Slabs of x and E arrive by cp.async into a 3-stage
// ring in shared memory, two in flight while one is multiplied; the
// forward's ring runs on across vocab tiles without a break. In bf16 a
// thread gets at most 128 registers, so two blocks (16 warps) share an SM.
// Rows past N and vocab rows past V are zero-filled and masked.
//
// What bounds it on the H100: 2 N V d FLOPs (550 GFLOP at N 8192, V 32768,
// d 1024) against reading x and E once, so the tensor cores: 0.556 ms in
// bf16 at the dense peak. mma.sync reaches only part of that rate on Hopper
// (wgmma is the full-rate path), and each block re-reads its x tile from L2
// for every vocab tile it walks. K3b writes N C dlogits besides (67 MB a
// chunk at C 4096), below its products' time.
//
// x and E are row-major with unit stride along d, row strides and bases
// 16-byte aligned and d * itemsize a multiple of 64 bytes (the wrapper checks
// this); targets are int64; every other buffer is contiguous.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "chunked_ce_merge.cuh"

namespace {

constexpr int BM = 128;          // rows of x in a block tile
constexpr int BN = 128;          // vocab rows of E in a block tile
constexpr int NTHREADS = 256;    // 8 warps: 4 along rows x 2 along columns
constexpr int WM = 32;           // rows of a warp's tile
constexpr int WN = 64;           // columns of a warp's tile
constexpr int SLAB_BYTES = 64;   // depth of a stage: 32 bf16 or 16 f32
constexpr int LD_BYTES = 80;     // shared row stride: the slab + 16 bytes
constexpr int STAGE_BYTES = (BM + BN) * LD_BYTES;
constexpr int STAGES = 3;        // cp.async ring depth
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;   // dynamic, opted in
constexpr float NEG_INF = -INFINITY;
typedef __nv_bfloat16 bf16;

struct Args {
  const void* x;               // (n, d), row stride ldx
  const void* e;               // (v, d), row stride lde: E, or one ce chunk
  const long long* targets;    // (n,) global vocab ids
  long long ldx, lde;
  int n, v, d;
  int col0;                    // global vocab id of e's row 0
  // forward
  int splits, tiles_per_split;
  float* part;                 // (3, splits, n): m, l, correct of each split
  // dlogits
  const float* lse;            // (n,)
  const float* g;              // the loss's cotangent, one f32
  int n_total;                 // the mean's denominator, B * T
  void* dlog;                  // (n, v), row stride ldo, x's dtype
  long long ldo;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// One warp's 32 x 64 accumulator tile in the mma.sync m16n8 layout:
// acc[mt][nt][2 * h + j] is row 16 mt + 8 h + lane / 4 and column
// 8 nt + 2 (lane % 4) + j of the warp's tile.
typedef float Acc[2][8][4];

__device__ __forceinline__ int row_of(int warp, int lane, int mt, int h) {
  return (warp & 3) * WM + mt * 16 + h * 8 + (lane >> 2);
}
__device__ __forceinline__ int col_of(int warp, int lane, int nt, int j) {
  return (warp >> 2) * WN + nt * 8 + 2 * (lane & 3) + j;
}

// one stage: rows [row0, row0 + BM) of x and [vrow0, vrow0 + BN) of e at
// depth k0, SLAB_BYTES of each row
template <typename T>
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const Args& a, int row0, int vrow0,
                                           int k0) {
  constexpr int EPC = 16 / sizeof(T);          // elements per 16 bytes
  const T* x = static_cast<const T*>(a.x);
  const T* e = static_cast<const T*>(a.e);
  for (int i = threadIdx.x; i < (BM + BN) * 4; i += NTHREADS) {
    const int r = i >> 2, c = i & 3;
    const T* src;
    bool in;
    if (r < BM) {
      in = row0 + r < a.n;
      src = in ? x + (row0 + r) * a.ldx + k0 + c * EPC : x;
    } else {
      in = vrow0 + r - BM < a.v;
      src = in ? e + (vrow0 + r - BM) * a.lde + k0 + c * EPC : e;
    }
    cp_async16(stage + r * LD_BYTES + c * 16, src, in);
  }
}

// acc += this stage's x slab times its e slab transposed
__device__ __forceinline__ void stage_product(Acc& acc,
                                              const unsigned char* stage,
                                              const bf16*, int warp,
                                              int lane) {
  constexpr int LD = LD_BYTES / 2;
  const bf16* sa = reinterpret_cast<const bf16*>(stage);
  const bf16* sb = sa + BM * LD;
  const int r0 = (warp & 3) * WM, n0 = (warp >> 2) * WN;
#pragma unroll
  for (int kk = 0; kk < SLAB_BYTES / 32; ++kk) {
    uint32_t fa[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm4(fa[mt], sa + (r0 + mt * 16 + (lane & 15)) * LD + kk * 16 +
                        (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      // two 8-column tiles of e stored [n][k]: f[0], f[1] the first
      uint32_t fb[4];
      ldsm4(fb, sb + (n0 + np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                    kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma(acc[mt][2 * np], fa[mt], fb[0], fb[1]);
        mma(acc[mt][2 * np + 1], fa[mt], fb[2], fb[3]);
      }
    }
  }
}

__device__ __forceinline__ void stage_product(Acc& acc,
                                              const unsigned char* stage,
                                              const float*, int warp,
                                              int lane) {
  constexpr int LD = LD_BYTES / 4;
  const float* sa = reinterpret_cast<const float*>(stage);
  const float* sb = sa + BM * LD;
#pragma unroll 4
  for (int k = 0; k < SLAB_BYTES / 4; ++k) {
    float av[2][2], bv[8][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        av[mt][h] = sa[row_of(warp, lane, mt, h) * LD + k];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        bv[nt][j] = sb[col_of(warp, lane, nt, j) * LD + k];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            acc[mt][nt][2 * h + j] =
                fmaf(av[mt][h], bv[nt][j], acc[mt][nt][2 * h + j]);
  }
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
}

// The logits of rows [row0, row0 + BM) against vocab tiles [t_begin, t_end)
// of e, one tile after another: epi(tile, acc) sees each tile's finished
// accumulators. A ring of STAGES slabs runs on across tiles (tile t + 1's
// first slabs load while tile t's last ones are multiplied), one barrier a
// slab: the one that lets a slab land also frees the slot it refills.
template <typename T, typename Epi>
__device__ __forceinline__ void run_tiles(const Args& a, int row0,
                                          int t_begin, int t_end,
                                          unsigned char* smem, Epi&& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int BK = SLAB_BYTES / sizeof(T);
  const int kt = a.d / BK;
  const int total = (t_end - t_begin) * kt;
  Acc acc;
  zero(acc);
  if (total <= 0) return;
  auto load = [&](int it) {
    // every thread commits a group per slab, empty past the end, so the
    // wait below counts the same groups on every thread
    if (it < total)
      load_stage<T>(smem + (it % STAGES) * STAGE_BYTES, a, row0,
                    (t_begin + it / kt) * BN, (it % kt) * BK);
    cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) load(it);
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();     // slab it has landed, for this thread
    __syncthreads();                 // ... for every thread; and slab
                                     // it - 1's slot is free
    load(it + STAGES - 1);
    stage_product(acc, smem + (it % STAGES) * STAGE_BYTES,
                  static_cast<const T*>(nullptr), warp, lane);
    if (it % kt == kt - 1) {
      epi(t_begin + it / kt, acc);
      zero(acc);
    }
  }
}

// bf16: at most 128 registers a thread, so two blocks share an SM
template <typename T>
constexpr int min_blocks() { return std::is_same<T, bf16>::value ? 2 : 1; }

template <typename T>
__global__ void __launch_bounds__(NTHREADS, min_blocks<T>())
    ce_fwd_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[3][2][BM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM, split = blockIdx.y;
  const int tiles = (a.v + BN - 1) / BN;
  const int t_begin = split * a.tiles_per_split;
  const int t_end = min(t_begin + a.tiles_per_split, tiles);
  long long tgt[2][2];
  float m[2][2], l[2][2], cor[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + row_of(warp, lane, mt, h);
      tgt[mt][h] = r < a.n ? a.targets[r] : -1;
      m[mt][h] = NEG_INF;
      l[mt][h] = 0.0f;
      cor[mt][h] = 0.0f;
    }
  run_tiles<T>(a, row0, t_begin, t_end, smem, [&](int tile, Acc& acc) {
    const int c0 = tile * BN;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (c0 + col_of(warp, lane, nt, j) < a.v)
              mx = fmaxf(mx, acc[mt][nt][2 * h + j]);
        if (mx == NEG_INF) continue;          // every column past V
        const float mn = fmaxf(m[mt][h], mx);
        float s = 0.0f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = c0 + col_of(warp, lane, nt, j);
            if (c < a.v) {
              const float v = acc[mt][nt][2 * h + j];
              s += expf(v - mn);
              if (c + a.col0 == tgt[mt][h]) cor[mt][h] += v;
            }
          }
        l[mt][h] = l[mt][h] * expf(m[mt][h] - mn) + s;
        m[mt][h] = mn;
      }
  });
  // the 4 lanes of a quad hold one row's columns, the 2 column warps the
  // rest: merge the quad by shuffles, then the two warps through shared
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[mt][h], off);
        const float l2 = __shfl_xor_sync(0xffffffffu, l[mt][h], off);
        cor[mt][h] += __shfl_xor_sync(0xffffffffu, cor[mt][h], off);
        merge(m[mt][h], l[mt][h], m2, l2);
      }
      if ((lane & 3) == 0) {
        const int r = row_of(warp, lane, mt, h);
        red[0][warp >> 2][r] = m[mt][h];
        red[1][warp >> 2][r] = l[mt][h];
        red[2][warp >> 2][r] = cor[mt][h];
      }
    }
  __syncthreads();
  if (threadIdx.x < BM && row0 + threadIdx.x < a.n) {
    const int r = threadIdx.x;
    float mm = red[0][0][r], ll = red[1][0][r];
    merge(mm, ll, red[0][1][r], red[1][1][r]);
    const long long at = (long long)split * a.n + row0 + r;
    const long long plane = (long long)a.splits * a.n;
    a.part[at] = mm;
    a.part[plane + at] = ll;
    a.part[2 * plane + at] = red[2][0][r] + red[2][1][r];
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, min_blocks<T>())
    ce_dlogits_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM;
  // the reference's scale (g / (B * T)) in f32
  const float scale = a.g[0] / (float)a.n_total;
  run_tiles<T>(a, row0, blockIdx.y, blockIdx.y + 1, smem,
               [&](int tile, Acc& acc) {
    T* out = static_cast<T*>(a.dlog);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + row_of(warp, lane, mt, h);
        if (r >= a.n) continue;
        const float lse = a.lse[r];
        const long long tgt = a.targets[r];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = tile * BN + col_of(warp, lane, nt, j);
            if (c >= a.v) continue;
            const float p = expf(acc[mt][nt][2 * h + j] - lse);
            const float onehot = c + a.col0 == tgt ? 1.0f : 0.0f;
            store(out + r * a.ldo + c, (p - onehot) * scale);
          }
      }
  });
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

template <typename T>
cudaError_t fwd(const Args& a, float* lse, float* loss, cudaStream_t s) {
  static const cudaError_t attr = opt_in(ce_fwd_kernel<T>);
  if (attr != cudaSuccess) return attr;
  ce_fwd_kernel<T><<<dim3((a.n + BM - 1) / BM, a.splits), NTHREADS,
                     SMEM_BYTES, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(a.part, a.splits, a.n, lse, loss, s);
}

template <typename T>
cudaError_t dlogits(const Args& a, cudaStream_t s) {
  static const cudaError_t attr = opt_in(ce_dlogits_kernel<T>);
  if (attr != cudaSuccess) return attr;
  ce_dlogits_kernel<T>
      <<<dim3((a.n + BM - 1) / BM, (a.v + BN - 1) / BN), NTHREADS,
         SMEM_BYTES, s>>>(a);
  return cudaGetLastError();
}

bool bad_shape(int n, int v, int d, int dtype) {
  const int item = dtype == 1 ? 2 : 4;
  return n < 1 || v < 1 || d < 1 || (d * item) % SLAB_BYTES != 0 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Each returns the first failing launch's cudaError_t (0 on success) and
// never synchronises.

// K3f: lse (n,) f32 and loss (1,) f32 of x (n, d) against e (v, d) and
// targets (n,) int64; part is (3, splits, n) f32 scratch, each split
// tiles_per_split vocab tiles of 128.
extern "C" int dl4j_ce_fwd(const void* x, const void* e,
                           const long long* targets, void* part, void* lse,
                           void* loss, int n, int v, int d, long long ldx,
                           long long lde, int splits, int tiles_per_split,
                           int dtype, void* stream) {
  if (bad_shape(n, v, d, dtype) || splits < 1 || splits > 65535 ||
      tiles_per_split < 1 ||
      (long long)splits * tiles_per_split * BN < (long long)v)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x; a.e = e; a.targets = targets;
  a.ldx = ldx; a.lde = lde;
  a.n = n; a.v = v; a.d = d; a.col0 = 0;
  a.splits = splits; a.tiles_per_split = tiles_per_split;
  a.part = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* o = static_cast<float*>(loss);
  return (int)(dtype == 1 ? fwd<bf16>(a, l, o, s) : fwd<float>(a, l, o, s));
}

// K3b: dlog (n, c) in x's dtype, row stride ldo, for the chunk e (c, d)
// whose row 0 is global vocab id col0: (exp(x e^T - lse) - onehot) * g[0] /
// n_total.
extern "C" int dl4j_ce_dlogits(const void* x, const void* e,
                               const long long* targets, const void* lse,
                               const void* g, void* dlog, int n, int c,
                               int d, long long ldx, long long lde,
                               long long ldo, int col0, int n_total,
                               int dtype, void* stream) {
  if (bad_shape(n, c, d, dtype) || n_total < 1 ||
      (c + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x; a.e = e; a.targets = targets;
  a.ldx = ldx; a.lde = lde;
  a.n = n; a.v = c; a.d = d; a.col0 = col0;
  a.lse = static_cast<const float*>(lse);
  a.g = static_cast<const float*>(g);
  a.n_total = n_total;
  a.dlog = dlog; a.ldo = ldo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? dlogits<bf16>(a, s) : dlogits<float>(a, s));
}

extern "C" const char* dl4j_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
