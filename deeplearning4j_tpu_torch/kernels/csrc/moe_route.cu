// MoE token movement for Hopper (sm_90a): dispatch (K7d) and combine (K7c)
// of the Switch / GShard FFN.
//
// Replace the two one-hot einsums of `moe_ffn` in
// deeplearning4j_tpu/parallel/moe.py: dispatch `ei = einsum("gec,gd->ecd",
// dispatch, x)` and combine `y = einsum("gec,ecd->gd", combine, out_e)`,
// whose (G, E, C) one-hot tensors the TPU multiplies through at full size.
// Here routing (done in plain torch, (G, E) in size) hands the kernels two
// index maps instead:
//   slot (G, K) int32  - expert slot e * C + pos of each (token, choice), or
//                        -1 where the choice was dropped past capacity;
//   src (E * C) int32  - the inverse: g * K + k of the choice that fills each
//                        slot, or -1 for an empty slot.
// Both kernels are gathers, one warp per output row with 16-byte loads and
// stores, so every output row is written exactly once, in a fixed order
// (deterministic, no atomics, no memset):
//   dispatch_kernel  out[s] = x[src[s] / K] (0 for an empty slot); with
//                    gates (combine's backward): out[s] = gate[src[s]] *
//                    dy[g] and d_gate[src[s]] = <dy[g], out_e[s]>;
//   combine_kernel   y[g] = sum over kept k of gate[g, k] * rows[slot[g, k]]
//                    in f32 (0 when every choice dropped); without gates
//                    (unit weights) it is dispatch's backward.
//
// What bounds them on the H100: pure data movement, the kept rows read once
// and every output row written once (dispatch at the bench's large width,
// G 8192, d 1024, E 8, C 1280, bf16: 16.8 MB read, 21.0 MB written, 11 us at
// 3.35 TB/s). Rows are contiguous (stride d), d * itemsize a multiple of 16
// and every base 16-byte aligned (the wrapper checks this).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // output rows a block
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> struct Vec {
  static constexpr int N = 16 / sizeof(T);     // elements in 16 bytes
};

template <typename T>
__device__ __forceinline__ void load16(float (&o)[Vec<T>::N], const T* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) o[i] = to_f(t[i]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float (&o)[Vec<T>::N]) {
  uint4 u;
  T* t = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) t[i] = from_f<T>(o[i]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T, bool GRAD>
__global__ void __launch_bounds__(WARPS * 32)
    dispatch_kernel(const T* x, const int* src, T* out, long long slots,
                    int d, int k, const T* gates, const T* out_e,
                    T* d_gate) {
  constexpr int V = Vec<T>::N;
  const long long s = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= slots) return;
  const int gk = src[s];
  T* dst = out + s * d;
  if (gk < 0) {
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (int c = lane * V; c < d; c += 32 * V)
      *reinterpret_cast<uint4*>(dst + c) = z;
    return;
  }
  const T* row = x + (long long)(gk / k) * d;
  if (!GRAD) {
    for (int c = lane * V; c < d; c += 32 * V)
      *reinterpret_cast<uint4*>(dst + c) =
          *reinterpret_cast<const uint4*>(row + c);
    return;
  }
  const float w = to_f(gates[gk]);
  const T* o = out_e + s * d;
  float dot = 0.0f;
  for (int c = lane * V; c < d; c += 32 * V) {
    float dy[V], oe[V];
    load16<T>(dy, row + c);
    load16<T>(oe, o + c);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      dot = fmaf(dy[i], oe[i], dot);
      dy[i] *= w;
    }
    store16<T>(dst + c, dy);
  }
  for (int off = 16; off > 0; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if (lane == 0) d_gate[gk] = from_f<T>(dot);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    combine_kernel(const T* rows, const int* slot, const T* gates, T* y,
                   long long tokens, int d, int k) {
  constexpr int V = Vec<T>::N;
  const long long g = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= tokens) return;
  const int s0 = slot[g * k], s1 = k > 1 ? slot[g * k + 1] : -1;
  const float w0 = gates ? to_f(gates[g * k]) : 1.0f;
  const float w1 = k > 1 && gates ? to_f(gates[g * k + 1]) : 1.0f;
  for (int c = lane * V; c < d; c += 32 * V) {
    float acc[V], r[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    if (s0 >= 0) {
      load16<T>(r, rows + (long long)s0 * d + c);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(w0, r[i], acc[i]);
    }
    if (s1 >= 0) {
      load16<T>(r, rows + (long long)s1 * d + c);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(w1, r[i], acc[i]);
    }
    store16<T>(y + g * d + c, acc);
  }
}

long long blocks(long long rows) { return (rows + WARPS - 1) / WARPS; }

template <typename T>
cudaError_t dispatch(const void* x, const int* src, void* out,
                     long long slots, int d, int k, const void* gates,
                     const void* out_e, void* d_gate, cudaStream_t s) {
  if (gates == nullptr)
    dispatch_kernel<T, false><<<(unsigned)blocks(slots), WARPS * 32, 0, s>>>(
        static_cast<const T*>(x), src, static_cast<T*>(out), slots, d, k,
        nullptr, nullptr, nullptr);
  else
    dispatch_kernel<T, true><<<(unsigned)blocks(slots), WARPS * 32, 0, s>>>(
        static_cast<const T*>(x), src, static_cast<T*>(out), slots, d, k,
        static_cast<const T*>(gates), static_cast<const T*>(out_e),
        static_cast<T*>(d_gate));
  return cudaGetLastError();
}

template <typename T>
cudaError_t combine(const void* rows, const int* slot, const void* gates,
                    void* y, long long tokens, int d, int k,
                    cudaStream_t s) {
  combine_kernel<T><<<(unsigned)blocks(tokens), WARPS * 32, 0, s>>>(
      static_cast<const T*>(rows), slot, static_cast<const T*>(gates),
      static_cast<T*>(y), tokens, d, k);
  return cudaGetLastError();
}

bool bad(long long rows, int d, int k, int dtype) {
  const int item = dtype == 1 ? 2 : 4;
  return rows < 1 || blocks(rows) > 2147483647LL || d < 1 ||
         (d * item) % 16 != 0 || k < 1 || k > 2 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Each returns the launch's cudaError_t (0 on success) and never
// synchronises.

// K7d: out (slots, d) from x (G, d) through src (slots,). With gates (G, k)
// non-null it is combine's backward: x is dy, out_e (slots, d) the experts'
// outputs, and d_gate (G, k) receives <dy[g], out_e[s]> at each kept choice
// (the caller zeroes it: dropped choices get no write).
extern "C" int dl4j_moe_dispatch(const void* x, const int* src, void* out,
                                 long long slots, int d, int k,
                                 const void* gates, const void* out_e,
                                 void* d_gate, int dtype, void* stream) {
  if (bad(slots, d, k, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? dispatch<bf16>(x, src, out, slots, d, k, gates, out_e,
                                    d_gate, s)
                   : dispatch<float>(x, src, out, slots, d, k, gates, out_e,
                                     d_gate, s));
}

// K7c: y (tokens, d) from rows (slots, d) through slot (tokens, k), weighted
// by gates (tokens, k) or, when gates is null, by 1.
extern "C" int dl4j_moe_combine(const void* rows, const int* slot,
                                const void* gates, void* y, long long tokens,
                                int d, int k, int dtype, void* stream) {
  if (bad(tokens, d, k, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? combine<bf16>(rows, slot, gates, y, tokens, d, k,
                                          s)
                          : combine<float>(rows, slot, gates, y, tokens, d,
                                           k, s));
}

extern "C" const char* dl4j_moe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
