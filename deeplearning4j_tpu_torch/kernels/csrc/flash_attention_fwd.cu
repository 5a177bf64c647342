// Flash-attention forward for Hopper (sm_90a), bf16 and f32.
//
// Replaces the Pallas TPU kernel `_attn_fwd_kernel` (launched by `_fwd_pallas`)
// in deeplearning4j_tpu/kernels/flash_attention.py. It computes the same
// function: o = softmax(q k^T * scale) v and lse = m + log l per query row,
// with an online softmax over key tiles (f32 running max, sum and output
// accumulator), low-precision operands with f32 accumulation, causal skip of
// key tiles past the query tile's last row, the ragged key tail masked against
// seq_k with the -1e30 sentinel, and o / max(l, 1e-30) at the end.
//
// What bounds it on the H100: at the prefill shapes (d = 64, T <= 1024) the
// work is 4*T*T*d FLOPs per head against 4*T*d*itemsize bytes, i.e. T/2
// FLOPs per byte, so above T ~ 600 (bf16) the tensor cores bound it and below
// that the memory. This first version is neither: scores and P go through
// shared memory between WMMA (mma.sync) tiles, so it is bound by shared-memory
// traffic and synchronisation. What the design does about the real bounds:
// each block keeps its Q tile and the running statistics on chip for the whole
// key loop, so Q, K and V are read from device memory once per (query tile,
// key tile) pair and O is written once, and the (T, T) score matrix never
// reaches device memory. wgmma, TMA and warp specialisation are later work.
//
// Layout: q (BH, seq_q, D), k and v (BH, seq_k, D), o like q, lse (BH, seq_q)
// f32, all contiguous and 16-byte aligned (the Python wrapper checks this).
// One thread block of 4 warps per (bh, 64-row query tile); warp w owns query
// rows 16w..16w+15 of the tile for the whole kernel, so after the K/V tile is
// staged every step of the key loop is warp-local. The online softmax walks
// the warp's rows one at a time with each lane on two columns (consecutive
// lanes on consecutive addresses, reductions by shuffle), and every lane
// keeps all 16 rows' running max and sum in registers. Shared-memory rows are
// padded by 16 bytes so that the 8-row fragment loads of WMMA do not all land
// in the same banks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int BM = 64;          // query rows per block
constexpr int BN = 64;          // key rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WROWS = BM / NWARPS;   // 16 query rows per warp
constexpr float NEG_INF = -1e30f;    // the reference's finite sentinel
constexpr int LDS = BN + 4;          // f32 score rows
typedef __nv_bfloat16 bf16;

// padded row strides (elements): operand tiles and P in T, O in f32
template <typename T, int D> struct Ld {
  static constexpr int QKV = D + 16 / (int)sizeof(T);
  static constexpr int P = BN + 16 / (int)sizeof(T);
  static constexpr int O = D + 4;
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows [row0, row0 + BM) of a (n_rows, D) matrix into shared memory
// rows of stride LD, zero-filling rows past the end, 16 bytes per thread.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int n_rows) {
  constexpr int CHUNKS = D * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < BM * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D)[c];
    reinterpret_cast<uint4*>(dst + r * LD)[c] = val;
  }
}

// S[16 rows of this warp][BN] = Q K^T (unscaled), f32.
template <typename T, int D>
__device__ __forceinline__ void warp_scores(const T* sQ, const T* sK, float* sS,
                                            int warp, int lane) {
  constexpr int LD = Ld<T, D>::QKV;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
    for (int nt = 0; nt < BN / 16; ++nt) {
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::load_matrix_sync(a, sQ + warp * WROWS * LD + kk * 16, LD);
        // K stored (BN, D) row-major is K^T column-major
        wmma::load_matrix_sync(b, sK + nt * 16 * LD + kk * 16, LD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sS + warp * WROWS * LDS + nt * 16, acc, LDS,
                              wmma::mem_row_major);
    }
  } else {
    // f32 operands: scalar FMA in full f32 (no TF32 anywhere in the port)
    for (int i = lane; i < WROWS * BN; i += 32) {
      const int r = warp * WROWS + i / BN, c = i % BN;
      const float* qr = sQ + r * LD;
      const float* kr = sK + c * LD;
      float acc = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      sS[r * LDS + c] = acc;
    }
  }
}

// O[16 rows of this warp][D] += P V, P in the operand type, f32 accumulation.
template <typename T, int D>
__device__ __forceinline__ void warp_pv(const T* sP, const T* sV, float* sO,
                                        int warp, int lane) {
  constexpr int LD = Ld<T, D>::QKV, LDP = Ld<T, D>::P, LDO = Ld<T, D>::O;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      float* o_tile = sO + warp * WROWS * LDO + dt * 16;
      wmma::load_matrix_sync(acc, o_tile, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::load_matrix_sync(a, sP + warp * WROWS * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(b, sV + kk * 16 * LD + dt * 16, LD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(o_tile, acc, LDO, wmma::mem_row_major);
    }
  } else {
    for (int i = lane; i < WROWS * D; i += 32) {
      const int r = warp * WROWS + i / D, j = i % D;
      float acc = sO[r * LDO + j];
#pragma unroll 16
      for (int c = 0; c < BN; ++c)
        acc = fmaf(sP[r * LDP + c], sV[c * LD + j], acc);
      sO[r * LDO + j] = acc;
    }
  }
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)(3 * BM * Ld<T, D>::QKV + BM * Ld<T, D>::P) * sizeof(T) +
         (size_t)(BM * LDS + BM * Ld<T, D>::O) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seq_q, int seq_k, float scale,
                 int causal) {
  constexpr int LD = Ld<T, D>::QKV, LDP = Ld<T, D>::P, LDO = Ld<T, D>::O;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BM * LD;
  T* sV = sK + BN * LD;
  T* sP = sV + BN * LD;
  float* sS = reinterpret_cast<float*>(sP + BM * LDP);
  float* sO = sS + BM * LDS;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + (size_t)bh * seq_q * D;
  const T* kb = k + (size_t)bh * seq_k * D;
  const T* vb = v + (size_t)bh * seq_k * D;

  load_tile<T, D, LD>(sQ, qb, q0, seq_q);
  for (int i = threadIdx.x; i < BM * LDO; i += NTHREADS) sO[i] = 0.0f;

  // running max and sum of the warp's 16 rows, the same in every lane
  float m_run[WROWS], l_run[WROWS];
#pragma unroll
  for (int r = 0; r < WROWS; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.0f;
  }

  // causal: a key tile starting past the query tile's last row contributes
  // nothing, so the loop stops before it
  const int kv_end = causal ? min(seq_k, q0 + BM) : seq_k;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BN) {
    __syncthreads();                  // every warp is done with the last K/V
    load_tile<T, D, LD>(sK, kb, kv0, seq_k);
    load_tile<T, D, LD>(sV, vb, kv0, seq_k);
    __syncthreads();

    warp_scores<T, D>(sQ, sK, sS, warp, lane);
    __syncwarp();

    // online softmax, one row at a time; this lane holds columns lane and
    // lane + 32 of it
#pragma unroll
    for (int r = 0; r < WROWS; ++r) {
      const int row = warp * WROWS + r;
      const int q_idx = q0 + row;
      const float* s_row = sS + row * LDS;
      float s[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k_idx = kv0 + lane + 32 * h;
        const bool keep = k_idx < seq_k && (!causal || q_idx >= k_idx);
        s[h] = keep ? s_row[lane + 32 * h] * scale : NEG_INF;
      }
      const float m_new = fmaxf(m_run[r], warp_max(fmaxf(s[0], s[1])));
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      T* p_row = sP + row * LDP;
      p_row[lane] = from_float<T>(p0);   // P is cast to v's type before P V
      p_row[lane + 32] = from_float<T>(p1);
      const float alpha = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha + warp_sum(p0 + p1);
      m_run[r] = m_new;
      float* o_row = sO + row * LDO;
      for (int j = lane; j < D; j += 32) o_row[j] *= alpha;
    }
    __syncwarp();

    warp_pv<T, D>(sP, sV, sO, warp, lane);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < WROWS; ++r) {
    const int row = warp * WROWS + r;
    const int q_idx = q0 + row;
    if (q_idx < seq_q) {
      const float l = fmaxf(l_run[r], 1e-30f);
      T* dst = o + ((size_t)bh * seq_q + q_idx) * D;
      for (int j = lane; j < D; j += 32)
        dst[j] = from_float<T>(sO[row * LDO + j] / l);
      if (lane == 0) lse[(size_t)bh * seq_q + q_idx] = m_run[r] + logf(l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int seq_q, int seq_k, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((seq_q + BM - 1) / BM, bh);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      seq_q, seq_k, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* o, void* lse, int bh, int seq_q, int seq_k,
                     float scale, int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, seq_q, seq_k, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, seq_q, seq_k, scale, causal, s);
    case 48: return launch<T, 48>(q, k, v, o, lse, bh, seq_q, seq_k, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, seq_q, seq_k, scale, causal, s);
    case 80: return launch<T, 80>(q, k, v, o, lse, bh, seq_q, seq_k, scale, causal, s);
    case 96: return launch<T, 96>(q, k, v, o, lse, bh, seq_q, seq_k, scale, causal, s);
    case 112: return launch<T, 112>(q, k, v, o, lse, bh, seq_q, seq_k, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, seq_q, seq_k, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t (0 on success); never synchronises.
extern "C" int dl4j_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int bh, int seq_q, int seq_k, int d,
                                        float scale, int causal, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || bh > 65535 || seq_q < 1 || seq_k < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)dispatch<bf16>(d, q, k, v, o, lse, bh, seq_q, seq_k, scale, causal, s);
  if (dtype == 0)
    return (int)dispatch<float>(d, q, k, v, o, lse, bh, seq_q, seq_k, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
