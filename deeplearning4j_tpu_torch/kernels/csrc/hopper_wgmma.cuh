// Device and host helpers shared by the port's Hopper (sm_90a) kernels:
// mbarriers, TMA tile loads and stores and bulk loads, wgmma descriptors and
// products (bf16, and TF32 for f32 operands split in two), and the host-side
// encoding of strided (B, H, T, d) bf16 views and of row-major (rows, d) bf16
// and f32 matrices as tensor maps.
//
// Conventions of every kernel that includes this:
// - a tile in shared memory is a stack of 64-column panels (128 bytes a
//   row, bf16), each panel its rows one after another, laid out by TMA with
//   the 128-byte swizzle, every panel aligned to 1024 bytes (one swizzle
//   atom of 8 rows);
// - a K-major operand (rows of the product's M or N, contiguous along the
//   depth) takes `smem_desc(panel + (kk % 4) * 32, 16, 1024)` for depth
//   step kk of 16 columns, panel kk / 4 (in TF32 a panel is 32 f32
//   columns and a depth step 8 of them: the same 32 bytes);
// - an MN-major operand (rows of the depth, contiguous along N) takes
//   `smem_desc(tile + kk * 2048, panel_bytes, 1024)` for depth step kk of
//   16 rows, the next 64 columns of N `panel_bytes` on;
// - the f32 accumulator of an m64nN product gives thread t of the
//   warpgroup rows 16 (t / 32) + (t % 32) / 4 (registers i with i & 2 == 0)
//   and that + 8 (i & 2 != 0), columns 8 (i / 4) + 2 (t % 4) + (i & 1);
//   the same registers taken pairwise in bf16 are the A fragment of the
//   next product's depth steps (16 columns = registers 8kk .. 8kk + 7).
//
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so the build needs no -lcuda; each map is
// passed to a kernel as a `const __grid_constant__ CUtensorMap` parameter.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int PANEL = 64;             // bf16 columns in one 128-byte row
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One 4-D TMA tile load into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// One 2-D TMA tile load into shared memory, completing on `bar`: the box
// at column c0, row c1.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// One 2-D TMA tile store from shared memory (a bulk group of this thread):
// the box at column c0, row c1; what falls outside the tensor is not
// written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until this thread's bulk stores have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Wait until this thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Make this thread's shared-memory writes visible to the async proxy (TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` contiguous bytes global -> shared, completing on `bar`; both
// addresses 16-byte aligned, `bytes` a multiple of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this thread are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across a wgmma
// boundary (the asynchronous product owns these registers in between).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (all >> 4), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

#define ACC8(a, i)                                                        \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]),             \
      "+f"(a[i + 4]), "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B from shared memory, both
// K-major. `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]; A and B from shared memory, both
// K-major. `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32),
        ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#define ACC32(a, i) ACC8(a, i), ACC8(a, i + 8), ACC8(a, i + 16), ACC8(a, i + 24)

// D[64 x 256] (+)= A[64 x 16] B[16 x 256]; A and B from shared memory, both
// K-major. `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d, 0), ACC32(d, 32), ACC32(d, 64), ACC32(d, 96)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 8] B[8 x 128] in TF32: A and B from shared
// memory, both K-major (tf32 takes no transpose), 128-byte rows of 32 f32
// values whose low 13 bits the tensor cores ignore. `accumulate` 0
// overwrites D.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32),
        ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]; A from registers, B from shared
// memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]; A from registers, B MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32),
        ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The RS product of width N (64 or 128): D[64 x N] += A B, B MN-major.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// An accumulator of NK columns as bf16 A fragments, one per 16 columns:
// columns 16kk..16kk+15 are registers 8kk..8kk+7.
template <int NK>
__device__ __forceinline__ void pack_a(uint32_t (&f)[NK / 16][4],
                                       const float (&acc)[NK / 2]) {
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    f[kk][0] = pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);
    f[kk][1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
    f[kk][2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    f[kk][3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// A tensor map's outer dims (t, h, b) in the order they were encoded:
// `perm` holds each one's position (1..3) in 2-bit fields t | h << 2 | b << 4.
__device__ __forceinline__ void outer_coords(int perm, int t, int h, int b,
                                             int& c1, int& c2, int& c3) {
  const int pt = perm & 3, ph = (perm >> 2) & 3;
  c1 = pt == 1 ? t : (ph == 1 ? h : b);
  c2 = pt == 2 ? t : (ph == 2 ? h : b);
  c3 = pt == 3 ? t : (ph == 3 ? h : b);
}

// ------------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// Make the current device's primary context current on the calling thread,
// as a runtime launch would: the driver's encoder fails with
// CUDA_ERROR_INVALID_CONTEXT on a thread that has none yet, such as the
// thread autograd runs a backward on before anything else has touched it.
cudaError_t bind_context() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaSetDevice(dev);
}

EncodeTiledFn encode_fn() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Encode a (B, H, T, d) bf16 view with unit stride on d as a 4-D tensor map
// whose box is 64 columns x `box_rows` rows of T (rows past T arrive
// zero-filled). The outer dims are encoded in ascending order of stride
// (size-1 dims last), as the driver documents strides; `perm` says where t,
// h and b went (see outer_coords).
CUresult encode_4d(CUtensorMap* map, int* perm, const void* ptr, int batch,
                   int heads, int seq, int d, long long sb, long long sh,
                   long long st, int box_rows) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  struct Dim { long long size, stride; int which; };
  Dim dims[3] = {{seq, st, 0}, {heads, sh, 1}, {batch, sb, 2}};
  long long top = (long long)d;   // elements spanned by the real dims
  for (const Dim& x : dims)
    if (x.size > 1 && x.stride * x.size > top) top = x.stride * x.size;
  for (Dim& x : dims)
    if (x.size == 1) x.stride = (top + 7) / 8 * 8;   // any multiple of 16 B
  for (int i = 1; i < 3; ++i)   // insertion sort by stride, size-1 dims last
    for (int k = i; k > 0; --k) {
      const bool later_one = dims[k - 1].size == 1 && dims[k].size > 1;
      if (later_one || (dims[k - 1].size > 1 && dims[k].size > 1 &&
                        dims[k].stride < dims[k - 1].stride)) {
        Dim tmp = dims[k]; dims[k] = dims[k - 1]; dims[k - 1] = tmp;
      }
    }
  cuuint64_t gdim[4] = {(cuuint64_t)d, 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {(cuuint32_t)PANEL, 1, 1, 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  *perm = 0;
  for (int i = 0; i < 3; ++i) {
    gdim[i + 1] = (cuuint64_t)dims[i].size;
    gstride[i] = (cuuint64_t)(dims[i].stride * 2);   // bytes
    if (dims[i].which == 0) box[i + 1] = (cuuint32_t)box_rows;
    *perm |= (i + 1) << (2 * dims[i].which);
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), gdim, gstride, box, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Encode a (rows, d) bf16 matrix with unit stride on d and row stride `ld`
// elements as a 2-D tensor map whose box is 64 columns x `box_rows` rows
// (what lies past the edges arrives zero-filled, and a store there is
// dropped). `ld` * 2 must be a multiple of 16 and the base 16-byte aligned.
CUresult encode_2d(CUtensorMap* map, const void* ptr, long long rows, int d,
                   long long ld, int box_rows) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  cuuint64_t gdim[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  cuuint64_t gstride[1] = {(cuuint64_t)(ld * 2)};   // bytes
  cuuint32_t box[2] = {(cuuint32_t)PANEL, (cuuint32_t)box_rows};
  cuuint32_t estride[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), gdim, gstride, box, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Encode a (rows, d) f32 matrix with unit stride on d and row stride `ld`
// elements as a 2-D tensor map whose box is 32 columns (128 bytes) x
// `box_rows` rows, with the 128-byte swizzle, as encode_2d does for bf16.
CUresult encode_2d_f32(CUtensorMap* map, const void* ptr, long long rows,
                       int d, long long ld, int box_rows) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  cuuint64_t gdim[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  cuuint64_t gstride[1] = {(cuuint64_t)(ld * 4)};   // bytes
  cuuint32_t box[2] = {32u, (cuuint32_t)box_rows};
  cuuint32_t estride[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(ptr), gdim, gstride, box, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace
