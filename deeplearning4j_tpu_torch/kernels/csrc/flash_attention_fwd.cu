// Flash-attention forward for Hopper (sm_90a), the mma.sync path: f32 at every
// head dim, bf16 at the head dims the wgmma kernel does not take
// (flash_attention_fwd_wgmma.cu has bf16 at 64 and 128); any d % 8 == 0 in
// [8, 256].
//
// Replaces the Pallas TPU kernel `_attn_fwd_kernel` (launched by `_fwd_pallas`)
// in deeplearning4j_tpu/kernels/flash_attention.py. It computes the same
// function: o = softmax(q k^T * scale) v and lse = m + log l per query row,
// with an online softmax over key tiles (f32 running max, sum and output
// accumulator), causal skip of key tiles past the query tile's last row, the
// ragged key tail masked against seq_k with the -1e30 sentinel, and
// o / max(l, 1e-30) at the end. An optional key mask (one byte a key of each
// batch element, shared by its heads; the attention layers' sequence masks)
// masks a key with the same sentinel where its byte is 0. A row whose first
// tiles keep no key takes P = exp(0) there until its first kept key rescales
// them by exp(-1e30 - m) = 0, so any row that keeps a key is exact; a row
// that keeps none is not defined, and the callers never hand one over
// (ops/standard.py). bf16 operands are multiplied exactly with f32
// accumulation and P is rounded to bf16 before P V, as the reference does;
// f32 products split each operand into two TF32 parts and take three tensor-
// core products (flash_mma.cuh), so no operand is rounded to TF32 alone.
//
// What bounds it on the H100: per head 4 Tq Tk d FLOPs (about half when
// causal) against 2 (Tq + Tk) d itemsize bytes, so above T ~ 200 (f32, whose
// split costs three products at the 495 TFLOP/s TF32 rate: 165 TFLOP/s) or
// T ~ 600 (bf16; twice those when causal) the tensor cores bound it. The
// design, FA2 in registers:
// - a block is 4 warps over 64 query rows; each warp owns 16 rows for the
//   whole key loop, with their S tile, P and O accumulator in registers, and
//   their running max and sum; nothing of S or P touches shared memory;
// - S = Q K^T and O += P V are mma.sync products (product_abt, product_acc);
//   the online softmax runs on S's fragments: each row lives in one quad of
//   lanes, so its max takes two shuffles, and its sum is kept per lane and
//   joined once at the end; scores are scaled by scale * log2(e) in one
//   multiply and exponentiated by ex2;
// - Q is loaded once; K and V tiles of BN rows come through a two-stage
//   cp.async ring (16-byte copies), the next tile's copy in flight while this
//   tile's products run;
// - a warp whose 16 rows see none of a causal key tile skips its products;
//   query tiles are issued longest first.
//
// Layout: q, k, v and o are (B, H, T, d) views of any strides with unit stride
// on d and every other stride, and every base, 16-byte aligned (the Python
// wrapper checks this; a (BH, T, d) tensor comes as (BH, 1, T, d)), so the
// fused QKV projection is read, and o written, in place; lse is contiguous
// (B * H, Tq) f32; the key mask, if given, is (B, kmask_ld) bytes, zero past
// seq_k. The mask is a template parameter: the unmasked instantiations are
// the kernel as it was, the masked ones test it on every tile, a lane's keys
// of a tile read as 16-bit pairs into one word of bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "flash_mma.cuh"

namespace {

constexpr int BM = 64;          // query rows per block
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;    // the reference's finite sentinel
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// key rows a tile: 64, or 32 from W 192, where O takes 96 or 128 registers
// a lane (16 at W 256 for f32, whose split fragments take more, and under a
// key mask, whose bits spilled 160 bytes at 32)
template <typename T, int W, bool MASK>
__host__ __device__ constexpr int key_tile() {
  return W <= 128 ? 64
         : W == 256 && (std::is_same<T, float>::value || MASK) ? 16 : 32;
}

template <typename T, int W, bool MASK>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(BM + 4 * key_tile<T, W, MASK>()) * row_stride<T, W>() *
         sizeof(T);
}

struct Args {
  const void* q; const void* k; const void* v; void* o;
  float* lse;
  long long st[4][3];           // (b, h, t) strides of q, k, v, o
  int h, seq_q, seq_k, d;
  float scale;
  int causal;
  const uint8_t* kmask;         // (B, kmask_ld) key bytes, or null
  long long kmask_ld;
};

template <typename T, int W, bool MASK>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(Args a) {
  constexpr int BN = key_tile<T, W, MASK>(), NT = BN / 8;
  constexpr int ld = row_stride<T, W>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BM * ld;                   // two buffers of BN rows
  T* sV = sK + 2 * BN * ld;

  const int bh = blockIdx.y, b = bh / a.h, hh = bh % a.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;   // longest rows first
  const int lane = threadIdx.x % 32, r0 = threadIdx.x / 32 * 16;
  const T* kb = static_cast<const T*>(a.k) + b * a.st[1][0] + hh * a.st[1][1];
  const T* vb = static_cast<const T*>(a.v) + b * a.st[2][0] + hh * a.st[2][1];
  const uint8_t* km = MASK ? a.kmask + b * a.kmask_ld : nullptr;

  zero_pad(smem, smem_bytes<T, W, MASK>(), a.d < W, NTHREADS);
  const int kv_end = a.causal ? min(a.seq_k, q0 + BM) : a.seq_k;
  const int n_tiles = (kv_end + BN - 1) / BN;
  const T* qb = static_cast<const T*>(a.q) + b * a.st[0][0] + hh * a.st[0][1];
  load_tile<T, W, BM, NTHREADS>(sQ, qb, a.st[0][2], q0, a.seq_q, a.d);
  load_tile<T, W, BN, NTHREADS>(sK, kb, a.st[1][2], 0, a.seq_k, a.d);
  load_tile<T, W, BN, NTHREADS>(sV, vb, a.st[2][2], 0, a.seq_k, a.d);
  cp_async_commit();

  // this lane's two query rows (g and g + 8 of the warp's 16), their running
  // max (base-2 units of the scaled scores) and this lane's part of their sum
  int qi[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = q0 + r0 + lane / 4 + 8 * h;
    m[h] = NEG_INF;
    l[h] = 0.0f;
  }
  const float scale2 = a.scale * LOG2E;
  float o[W / 8][4];
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, kv0 = t * BN;
    if (t + 1 < n_tiles) {
      load_tile<T, W, BN, NTHREADS>(sK + (buf ^ 1) * BN * ld, kb, a.st[1][2],
                                    kv0 + BN, a.seq_k, a.d);
      load_tile<T, W, BN, NTHREADS>(sV + (buf ^ 1) * BN * ld, vb, a.st[2][2],
                                    kv0 + BN, a.seq_k, a.d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // causal: a tile that starts past the warp's last row adds nothing to it
    if (!a.causal || kv0 <= q0 + r0 + 15) {
      float s[NT][4];
      product_abt<T, W, NT>(s, sQ, r0, sK + buf * BN * ld, lane);
      // mask only the tiles that hold a masked key: a branch that pays off
      // in f32, while bf16 runs faster masking every tile; under a key mask
      // every tile
      const bool edge = std::is_same<T, bf16>::value || MASK ||
                        kv0 + BN > a.seq_k ||
                        (a.causal && kv0 + BN - 1 > q0 + r0);
      // masked: this lane's keys of the tile (kv0 + 8 j + 2 (lane % 4) and
      // + 1), two bits a 16-bit load (the mask's rows are 16-bit aligned and
      // padded with zeros past seq_k)
      uint32_t kept = 0;
      if constexpr (MASK) {
        const uint16_t* pairs =
            reinterpret_cast<const uint16_t*>(km + kv0 + 2 * (lane & 3));
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t w = pairs[4 * j];
          kept |= (uint32_t)((w & 0xffu) != 0u) << (2 * j) |
                  (uint32_t)((w >> 8) != 0u) << (2 * j + 1);
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale2;
          if (edge) {
            const int ki = kv0 + j * 8 + 2 * (lane & 3) + (e & 1);
            bool drop = ki >= a.seq_k || (a.causal && ki > qi[e >> 1]);
            if constexpr (MASK)
              drop = drop || !((kept >> (2 * j + (e & 1))) & 1u);
            if (drop) x = NEG_INF;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = ex2(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[j][e] - m[e >> 1]);
          s[j][e] = p;                  // P, rounded to v's type in P V
          l[e >> 1] += p;
        }
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
      product_acc<T, W, NT>(o, s, sV + buf * BN * ld, lane);
    }
    __syncthreads();          // every warp is done with buf before its refill
  }

  // o / max(l, 1e-30) as o times one correctly rounded reciprocal a row (a
  // division an element would call its slow path, spilling O around it)
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
    inv[h] = __frcp_rn(l[h]);
  }
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= inv[e >> 1];
  store_rows<T, W>(o, static_cast<T*>(a.o) + b * a.st[3][0] + hh * a.st[3][1],
                   a.st[3][2], q0 + r0, a.seq_q, a.d, 1.0f, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (qi[h] < a.seq_q)
        a.lse[(size_t)bh * a.seq_q + qi[h]] = m[h] * LN2 + logf(l[h]);
  }
}

template <typename T, int W, bool MASK>
cudaError_t launch(const Args& a, int bh, cudaStream_t stream) {
  // the shared-memory opt-in, once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, W, MASK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T, W, MASK>());
  if (attr != cudaSuccess) return attr;
  static_assert(smem_bytes<T, W, MASK>() <= 232448,
                "over the 227 KB shared-memory opt-in");
  dim3 grid((a.seq_q + BM - 1) / BM, bh);
  flash_fwd_kernel<T, W, MASK>
      <<<grid, NTHREADS, smem_bytes<T, W, MASK>(), stream>>>(a);
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

// Plain C interface, loaded with ctypes: q, k, v, o (B, H, T, d) with (b, h,
// t) strides in elements (unit stride on d), lse (B * H, seq_q) f32; d % 8 ==
// 0 in [8, 256]. dtype: 0 = float32, 1 = bfloat16. kmask: null, or (B,
// kmask_ld) bytes, nonzero where a key is kept, zero past seq_k. Returns the
// launch's cudaError_t (0 on success); never synchronises.
extern "C" int dl4j_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int h, int seq_q, int seq_k, int d, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long o_sb,
    long long o_sh, long long o_st, float scale, int causal, int dtype,
    const void* kmask, long long kmask_ld, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || h < 1 || (long long)b * h > 65535 || seq_q < 1 || seq_k < 1 ||
      d < 8 || d > 256 || d % 8)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, static_cast<float*>(lse),
         {{q_sb, q_sh, q_st}, {k_sb, k_sh, k_st}, {v_sb, v_sh, v_st},
          {o_sb, o_sh, o_st}},
         h, seq_q, seq_k, d, scale, causal,
         static_cast<const uint8_t*>(kmask), kmask_ld};
  if (dtype == 1)
    return (int)(kmask ? dispatch<bf16, true>(a, b * h, s)
                       : dispatch<bf16, false>(a, b * h, s));
  if (dtype == 0)
    return (int)(kmask ? dispatch<float, true>(a, b * h, s)
                       : dispatch<float, false>(a, b * h, s));
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
