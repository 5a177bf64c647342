// The threshold gradient codec for Hopper (sm_90a): K6e and K6d, the dense
// sign-mask exchange of the compressed data-parallel step, and K6s-enc and
// K6s-dec, the sparse +-(idx+1) wire format.
//
// Replace the lax formulations of deeplearning4j_tpu/parallel/compression.py
// (`encode_dense` :259 and the arithmetic of `exchange_bucket` :266) and of
// deeplearning4j_tpu/kernels/threshold.py (`threshold_encode` :36,
// `threshold_decode` :61, `sparse_from_dense` :79, `dense_from_sparse` :90),
// which XLA fuses on the TPU. Every kernel here is a pass over memory.
//
// K6e  (dl4j_k6_encode)  acc = g + residual; signs = |acc| >= t ? sign(acc)
//      : 0 as int8; per block the fired count and the sum of |acc| * fired
//      (the reference's product, so an unfired inf or NaN poisons the sum as
//      it does there). A second, one-block stage reduces the partials in a
//      fixed order and writes the bucket's three scalars for the all-reduce:
//      (scale_local * has, has, fired / size). No float atomics: the scale
//      repeats bit for bit from run to run. t is read from device memory.
// K6d  (dl4j_k6_decode)  after the all-reduces: scale = p0 / max(p1, 1),
//      decoded = wire * (scale / n), residual' = (g + residual) - sign *
//      scale, and fixed-order partials of sum(residual'^2), reduced by a
//      one-block stage. decoded may be g's own buffer and residual' the old
//      residual's: each element is read before it is written.
// K6s-enc (dl4j_k6s_encode)  an ordered stream compaction of the hits
//      (|x| >= t of an f32 array, or x != 0 of an int8 sign mask): pass one
//      counts each 4096-element chunk's hits, a one-block exclusive scan
//      gives each chunk its offset, pass two places each warp's hits by
//      ballot and popc, keeps the first `capacity` by flat index, writes
//      +-(idx + 1) (0 for a zero hit at t = 0), and for f32 input writes the
//      residual x - (0 + sign * t) at the encoded positions and x elsewhere;
//      slot 0 holds the kept count, the slots past it are zeroed.
// K6s-dec (dl4j_k6s_decode)  zeroes the output and adds +-t (f32) or +-1
//      (int8) at |e| - 1 for each non-zero entry (below slot 0's count when
//      use_n is set); indices past the output are dropped, duplicates add.
//      The f32 sum uses atomicAdd: the order of duplicates is not fixed, so
//      a malformed buffer's sums are exact only where the partial sums of
//      +-t are (the wire format has unique indices).
//
// What bounds them on the H100: memory. K6e moves 9 bytes an element (g and
// the residual read, the sign written), K6d 17 to 18 (g, the residual, the
// sign and the wire read, decoded and residual' written).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1024;      // the dense passes' grid, fixed for n
constexpr int FIN_THREADS = 1024;
constexpr int CHUNK = 4096;           // K6s: elements a block
constexpr int ITEMS = CHUNK / THREADS;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// A block's sum in a fixed order (lanes, then warps); valid in thread 0.
template <typename T>
__device__ T block_sum(T v, T* sh) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  v = warp_sum(v);
  if (l == 0) sh[w] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = threadIdx.x < nw ? sh[threadIdx.x] : T(0);
  if (w == 0) v = warp_sum(v);
  __syncthreads();
  return v;
}

__device__ __forceinline__ int sign_of(float a) {
  return a > 0.f ? 1 : (a < 0.f ? -1 : 0);
}

// the reference's where(|acc| >= t, sign(acc), 0) as int8 (NaN never fires)
__device__ __forceinline__ int encode1(float a, float t) {
  return fabsf(a) >= t ? sign_of(a) : 0;
}

// ------------------------------------------------------------------- K6e
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    k6e_kernel(const float* __restrict__ g, const float* __restrict__ r,
               const float* __restrict__ thr, int8_t* __restrict__ signs,
               long long n, long long* __restrict__ part_k,
               float* __restrict__ part_s) {
  __shared__ long long shk[32];
  __shared__ float shs[32];
  const float t = *thr;
  long long k = 0;
  float s = 0.f;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  long long start = 0;
  if (VEC) {
    const long long n4 = n / 4;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* r4 = reinterpret_cast<const float4*>(r);
    char4* s4 = reinterpret_cast<char4*>(signs);
    for (long long i = tid; i < n4; i += stride) {
      const float4 a = g4[i], b = r4[i];
      const float acc[4] = {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w};
      int q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        q[j] = encode1(acc[j], t);
        const int fired = q[j] != 0;
        k += fired;
        s += fabsf(acc[j]) * (float)fired;
      }
      s4[i] = make_char4((signed char)q[0], (signed char)q[1],
                         (signed char)q[2], (signed char)q[3]);
    }
    start = n4 * 4;
  }
  for (long long i = start + tid; i < n; i += stride) {
    const float acc = g[i] + r[i];
    const int q = encode1(acc, t);
    const int fired = q != 0;
    k += fired;
    s += fabsf(acc) * (float)fired;
    signs[i] = (int8_t)q;
  }
  k = block_sum(k, shk);
  s = block_sum(s, shs);
  if (threadIdx.x == 0) {
    part_k[blockIdx.x] = k;
    part_s[blockIdx.x] = s;
  }
}

// The bucket's all-reduce scalars from the partials, in a fixed order.
__global__ void __launch_bounds__(FIN_THREADS)
    k6e_finalize(const long long* __restrict__ part_k,
                 const float* __restrict__ part_s, int parts, long long n,
                 float* __restrict__ packed) {
  __shared__ long long shk[32];
  __shared__ float shs[32];
  long long k = 0;
  float s = 0.f;
  for (int i = threadIdx.x; i < parts; i += blockDim.x) {
    k += part_k[i];
    s += part_s[i];
  }
  k = block_sum(k, shk);
  s = block_sum(s, shs);
  if (threadIdx.x == 0) {
    const float kf = (float)k;
    const float scale_local = s / fmaxf(kf, 1.0f);
    const float has = kf > 0.f ? 1.f : 0.f;
    packed[0] = scale_local * has;
    packed[1] = has;
    packed[2] = kf / (float)n;
  }
}

// ------------------------------------------------------------------- K6d
template <typename W>
__device__ __forceinline__ float decode_one(const float* g, const float* r,
                                            const int8_t* signs,
                                            const W* wire, float scale,
                                            float step, float* decoded,
                                            float* new_r, long long i) {
  const float acc = g[i] + r[i];
  const float nr = acc - (float)signs[i] * scale;
  const float dec = (float)wire[i] * step;
  decoded[i] = dec;
  new_r[i] = nr;
  return nr * nr;
}

// g/decoded and r/new_r may be the same buffers: no __restrict__ on them.
template <bool VEC, typename W>
__global__ void __launch_bounds__(THREADS)
    k6d_kernel(const float* g, const float* r,
               const int8_t* __restrict__ signs, const W* __restrict__ wire,
               const float* __restrict__ packed, float n_rep, float* decoded,
               float* new_r, long long n, float* __restrict__ part_q) {
  __shared__ float shq[32];
  const float scale = packed[0] / fmaxf(packed[1], 1.0f);
  const float step = scale / n_rep;
  float q = 0.f;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  long long start = 0;
  if (VEC) {
    const long long n4 = n / 4;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* r4 = reinterpret_cast<const float4*>(r);
    const char4* s4 = reinterpret_cast<const char4*>(signs);
    float4* d4 = reinterpret_cast<float4*>(decoded);
    float4* n4p = reinterpret_cast<float4*>(new_r);
    for (long long i = tid; i < n4; i += stride) {
      const float4 a = g4[i], b = r4[i];
      const char4 sg = s4[i];
      const long long e = i * 4;
      const float w0 = (float)wire[e], w1 = (float)wire[e + 1],
                  w2 = (float)wire[e + 2], w3 = (float)wire[e + 3];
      float4 nr, dec;
      nr.x = (a.x + b.x) - (float)sg.x * scale;
      nr.y = (a.y + b.y) - (float)sg.y * scale;
      nr.z = (a.z + b.z) - (float)sg.z * scale;
      nr.w = (a.w + b.w) - (float)sg.w * scale;
      dec.x = w0 * step;
      dec.y = w1 * step;
      dec.z = w2 * step;
      dec.w = w3 * step;
      d4[i] = dec;
      n4p[i] = nr;
      q += nr.x * nr.x;
      q += nr.y * nr.y;
      q += nr.z * nr.z;
      q += nr.w * nr.w;
    }
    start = n4 * 4;
  }
  for (long long i = start + tid; i < n; i += stride)
    q += decode_one(g, r, signs, wire, scale, step, decoded, new_r, i);
  q = block_sum(q, shq);
  if (threadIdx.x == 0) part_q[blockIdx.x] = q;
}

__global__ void __launch_bounds__(FIN_THREADS)
    k6d_finalize(const float* __restrict__ part_q, int parts,
                 float* __restrict__ out) {
  __shared__ float shq[32];
  float q = 0.f;
  for (int i = threadIdx.x; i < parts; i += blockDim.x) q += part_q[i];
  q = block_sum(q, shq);
  if (threadIdx.x == 0) *out = q;
}

// ---------------------------------------------------------------- K6s-enc
template <bool I8>
__device__ __forceinline__ bool hit_at(const void* x, long long i, float t,
                                       int* sgn, float* val) {
  if (I8) {
    const int s = reinterpret_cast<const int8_t*>(x)[i];
    *sgn = s;
    *val = 0.f;
    return s != 0;
  }
  const float v = reinterpret_cast<const float*>(x)[i];
  *sgn = sign_of(v);
  *val = v;
  return fabsf(v) >= t;
}

template <bool I8>
__global__ void __launch_bounds__(THREADS)
    k6s_count(const void* __restrict__ x, float t, long long n,
              int* __restrict__ counts) {
  __shared__ long long sh[32];
  const long long base = (long long)blockIdx.x * CHUNK;
  long long c = 0;
#pragma unroll 4
  for (int it = 0; it < ITEMS; ++it) {
    const long long i = base + it * THREADS + threadIdx.x;
    int sgn;
    float v;
    if (i < n && hit_at<I8>(x, i, t, &sgn, &v)) ++c;
  }
  c = block_sum(c, sh);
  if (threadIdx.x == 0) counts[blockIdx.x] = (int)c;
}

// Exclusive offsets of the chunks' counts (offsets[chunks] = the total) and
// slot 0 = min(total, capacity), in one block.
__global__ void __launch_bounds__(FIN_THREADS)
    k6s_scan(const int* __restrict__ counts, int chunks, long long capacity,
             long long* __restrict__ offsets, int* __restrict__ encoded) {
  __shared__ long long sh[FIN_THREADS];
  const int per = (chunks + FIN_THREADS - 1) / FIN_THREADS;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, chunks);
  long long mine = 0;
  for (int i = lo; i < hi; ++i) mine += counts[i];
  sh[threadIdx.x] = mine;
  __syncthreads();
  // Hillis-Steele inclusive scan over the threads' sums
  for (int o = 1; o < FIN_THREADS; o <<= 1) {
    const long long add = threadIdx.x >= o ? sh[threadIdx.x - o] : 0;
    __syncthreads();
    sh[threadIdx.x] += add;
    __syncthreads();
  }
  long long run = sh[threadIdx.x] - mine;
  for (int i = lo; i < hi; ++i) {
    offsets[i] = run;
    run += counts[i];
  }
  if (threadIdx.x == FIN_THREADS - 1) {
    const long long total = sh[FIN_THREADS - 1];
    offsets[chunks] = total;
    encoded[0] = (int)(total < capacity ? total : capacity);
  }
}

template <bool I8>
__global__ void __launch_bounds__(THREADS)
    k6s_place(const void* __restrict__ x, float t, long long n,
              long long capacity, const long long* __restrict__ offsets,
              int chunks, int* __restrict__ encoded,
              float* __restrict__ residual) {
  __shared__ int warp_hits[THREADS / 32];
  __shared__ long long running;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * CHUNK;
  const long long first = offsets[blockIdx.x];
  if (threadIdx.x == 0) running = 0;
  __syncthreads();
  for (int it = 0; it < ITEMS; ++it) {
    const long long i = base + it * THREADS + threadIdx.x;
    int sgn = 0;
    float v = 0.f;
    const bool hit = i < n && hit_at<I8>(x, i, t, &sgn, &v);
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (l == 0) warp_hits[w] = __popc(mask);
    __syncthreads();
    int before = 0, all = 0;
#pragma unroll
    for (int j = 0; j < THREADS / 32; ++j) {
      before += j < w ? warp_hits[j] : 0;
      all += warp_hits[j];
    }
    const long long pos = first + running + before +
                          __popc(mask & ((1u << l) - 1u));
    if (hit && pos < capacity) {
      encoded[1 + pos] = (int)(i + 1) * sgn;
      if (!I8 && residual != nullptr)
        residual[i] = v - (0.0f + (float)sgn * t);
    } else if (!I8 && residual != nullptr && i < n) {
      residual[i] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) running += all;
    __syncthreads();
  }
  // the slots past the kept count are zero
  const long long total = offsets[chunks];
  const long long kept = total < capacity ? total : capacity;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long j = kept + (long long)blockIdx.x * THREADS + threadIdx.x;
       j < capacity; j += stride)
    encoded[1 + j] = 0;
}

// ---------------------------------------------------------------- K6s-dec
__device__ __forceinline__ void add_i8(int8_t* p, int v) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  unsigned int* word = reinterpret_cast<unsigned int*>(a & ~uintptr_t(3));
  const int shift = (int)(a & 3) * 8;
  unsigned int old = *word, assumed;
  do {
    assumed = old;
    const int8_t b = (int8_t)(((assumed >> shift) & 0xffu)) + (int8_t)v;
    const unsigned int nw = (assumed & ~(0xffu << shift)) |
                            ((unsigned int)(uint8_t)b << shift);
    old = atomicCAS(word, assumed, nw);
  } while (old != assumed);
}

template <bool I8OUT>
__global__ void __launch_bounds__(THREADS)
    k6s_decode_kernel(const int* __restrict__ encoded, long long capacity,
                      int use_n, float t, void* out, long long size) {
  const long long n = encoded[0];
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
       j < capacity; j += stride) {
    const int e = encoded[1 + j];
    if (e == 0 || (use_n && j >= n)) continue;
    const long long idx = llabs((long long)e) - 1;
    if (idx >= size) continue;              // dropped, as JAX's scatter
    if (I8OUT)
      add_i8(reinterpret_cast<int8_t*>(out) + idx, e > 0 ? 1 : -1);
    else
      atomicAdd(reinterpret_cast<float*>(out) + idx,
                (e > 0 ? 1.0f : -1.0f) * t);
  }
}

int dense_blocks(long long n) {
  long long b = (n + THREADS * 4 - 1) / (THREADS * 4);
  if (b < 1) b = 1;
  return (int)(b > MAX_BLOCKS ? MAX_BLOCKS : b);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The partial buffers a dense call needs: MAX_BLOCKS entries.
extern "C" int dl4j_k6_max_blocks() { return MAX_BLOCKS; }
extern "C" int dl4j_k6s_chunk() { return CHUNK; }

// K6e: signs (n) int8 and packed[0..2] from g, residual (n) f32 and *thr.
extern "C" int dl4j_k6_encode(const float* g, const float* r,
                              const float* thr, int8_t* signs, long long n,
                              long long* part_k, float* part_s,
                              float* packed, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = dense_blocks(n);
  const bool vec = aligned16(g) && aligned16(r) && aligned16(signs);
  if (vec)
    k6e_kernel<true><<<blocks, THREADS, 0, s>>>(g, r, thr, signs, n, part_k,
                                               part_s);
  else
    k6e_kernel<false><<<blocks, THREADS, 0, s>>>(g, r, thr, signs, n,
                                                part_k, part_s);
  k6e_finalize<<<1, FIN_THREADS, 0, s>>>(part_k, part_s, blocks, n, packed);
  return (int)cudaGetLastError();
}

// K6d: decoded and residual' (n) f32 and *res_sq; wire int8 (wire_bytes 1)
// or int16 (2).
extern "C" int dl4j_k6_decode(const float* g, const float* r,
                              const int8_t* signs, const void* wire,
                              int wire_bytes, const float* packed,
                              float n_rep, float* decoded, float* new_r,
                              long long n, float* part_q, float* res_sq,
                              void* stream) {
  if (n < 1 || (wire_bytes != 1 && wire_bytes != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = dense_blocks(n);
  const bool vec = aligned16(g) && aligned16(r) && aligned16(signs) &&
                   aligned16(decoded) && aligned16(new_r);
  if (wire_bytes == 1) {
    const int8_t* w = static_cast<const int8_t*>(wire);
    if (vec)
      k6d_kernel<true, int8_t><<<blocks, THREADS, 0, s>>>(
          g, r, signs, w, packed, n_rep, decoded, new_r, n, part_q);
    else
      k6d_kernel<false, int8_t><<<blocks, THREADS, 0, s>>>(
          g, r, signs, w, packed, n_rep, decoded, new_r, n, part_q);
  } else {
    const int16_t* w = static_cast<const int16_t*>(wire);
    if (vec)
      k6d_kernel<true, int16_t><<<blocks, THREADS, 0, s>>>(
          g, r, signs, w, packed, n_rep, decoded, new_r, n, part_q);
    else
      k6d_kernel<false, int16_t><<<blocks, THREADS, 0, s>>>(
          g, r, signs, w, packed, n_rep, decoded, new_r, n, part_q);
  }
  k6d_finalize<<<1, FIN_THREADS, 0, s>>>(part_q, blocks, res_sq);
  return (int)cudaGetLastError();
}

// K6s-enc: encoded (capacity + 1) int32 from x (n) f32 (in_int8 0, hits
// |x| >= t, residual (n) written when non-null) or int8 signs (in_int8 1);
// counts (chunks) int32 and offsets (chunks + 1) int64 are workspace.
extern "C" int dl4j_k6s_encode(const void* x, int in_int8, float t,
                               long long n, long long capacity, int* counts,
                               long long* offsets, int* encoded,
                               float* residual, void* stream) {
  if (n < 1 || n >= 2147483647LL || capacity < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  if (chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int c = (int)chunks;
  if (in_int8) {
    k6s_count<true><<<c, THREADS, 0, s>>>(x, t, n, counts);
    k6s_scan<<<1, FIN_THREADS, 0, s>>>(counts, c, capacity, offsets, encoded);
    k6s_place<true><<<c, THREADS, 0, s>>>(x, t, n, capacity, offsets, c,
                                          encoded, nullptr);
  } else {
    k6s_count<false><<<c, THREADS, 0, s>>>(x, t, n, counts);
    k6s_scan<<<1, FIN_THREADS, 0, s>>>(counts, c, capacity, offsets, encoded);
    k6s_place<false><<<c, THREADS, 0, s>>>(x, t, n, capacity, offsets, c,
                                           encoded, residual);
  }
  return (int)cudaGetLastError();
}

// K6s-dec: out (size) f32 (+-t) or int8 (+-1, out_int8 1; the buffer padded
// to a multiple of 4 bytes) from encoded (capacity + 1); use_n keeps slots
// below encoded[0] only.
extern "C" int dl4j_k6s_decode(const int* encoded, long long capacity,
                               int use_n, float t, void* out, int out_int8,
                               long long size, void* stream) {
  if (size < 1 || capacity < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bytes = out_int8 ? ((size + 3) / 4) * 4 : size * 4;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)bytes, s);
  if (err != cudaSuccess) return (int)err;
  if (capacity == 0) return (int)cudaGetLastError();
  long long b = (capacity + THREADS - 1) / THREADS;
  const int blocks = (int)(b > 4 * MAX_BLOCKS ? 4 * MAX_BLOCKS : b);
  if (out_int8)
    k6s_decode_kernel<true><<<blocks, THREADS, 0, s>>>(encoded, capacity,
                                                      use_n, t, out, size);
  else
    k6s_decode_kernel<false><<<blocks, THREADS, 0, s>>>(encoded, capacity,
                                                       use_n, t, out, size);
  return (int)cudaGetLastError();
}

extern "C" const char* dl4j_k6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
