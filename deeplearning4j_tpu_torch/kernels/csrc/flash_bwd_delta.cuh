// D = rowsum(f32 dO * f32 O), the first pass of the flash-attention
// backward, shared by flash_attention_bwd.cu and flash_attention_bwd_wgmma.cu.
//
// It only moves bytes (2 * T * d operand elements read per head, 4 bytes
// written a row), so it reads with 16-byte loads: 8 lanes a row, 4 rows a
// warp, each lane summing its 16-byte chunks of the row (one at d 64 in
// bf16) before three shuffles join the 8 lanes.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct DeltaArgs {
  const void* o;
  const void* dout;
  long long o_st[3], do_st[3];  // (b, h, t) strides in elements, unit on d
  const float* lse;             // (B * H, seq_q), read only for lse_pad
  float* delta;                 // (B * H, rows) out
  float* lse_pad;               // (B * H, rows) out, a copy of lse, or null
  int h, seq_q, rows, d;        // rows >= seq_q; rows past seq_q get 0
};

__device__ __forceinline__ float dot_chunk(uint4 x, uint4 y, float) {
  return __uint_as_float(x.x) * __uint_as_float(y.x) +
         __uint_as_float(x.y) * __uint_as_float(y.y) +
         __uint_as_float(x.z) * __uint_as_float(y.z) +
         __uint_as_float(x.w) * __uint_as_float(y.w);
}

__device__ __forceinline__ float dot_chunk(uint4 x, uint4 y, __nv_bfloat16) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    acc += a.x * b.x + a.y * b.y;
  }
  return acc;
}

// One row of D per 8 lanes; launch with 256 threads and grid
// ((rows + 31) / 32, B * H). Every row start must be 16-byte aligned (the
// wrapper's layout rule) and d a multiple of 16 bytes' worth of elements.
template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(DeltaArgs a) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  const int bh = blockIdx.y;
  const int row = blockIdx.x * 32 + threadIdx.x / 8, sub = threadIdx.x % 8;
  const bool in = row < a.seq_q;
  float acc = 0.0f;
  if (in) {
    const int b = bh / a.h, h = bh % a.h;
    const T* o = static_cast<const T*>(a.o) + b * a.o_st[0] + h * a.o_st[1] +
                 row * a.o_st[2];
    const T* g = static_cast<const T*>(a.dout) + b * a.do_st[0] +
                 h * a.do_st[1] + row * a.do_st[2];
    for (int c = sub * VEC; c < a.d; c += 8 * VEC)
      acc += dot_chunk(*reinterpret_cast<const uint4*>(g + c),
                       *reinterpret_cast<const uint4*>(o + c), T());
  }
  // every lane of the warp takes part, in range or not
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (sub == 0 && row < a.rows) {
    const size_t at = (size_t)bh * a.rows + row;
    a.delta[at] = acc;
    if (a.lse_pad != nullptr)
      a.lse_pad[at] = in ? a.lse[(size_t)bh * a.seq_q + row] : 0.0f;
  }
}

}  // namespace
