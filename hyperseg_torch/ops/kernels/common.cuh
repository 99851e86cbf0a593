// Device helpers shared by the kernels: bf16 <-> float32 by intrinsics only,
// activations in float32.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

namespace hyperseg {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float swish(float v) { return v / (1.f + expf(-v)); }
// swish as v / (1 + 2^(-v log2 e)) by ex2.approx.ftz and rcp.approx.ftz: a
// relative error under 1e-5 wherever swish is a normal float32 (-0 below
// v = -88), far under a bfloat16 output's rounding. Used by the bfloat16
// kernels, where the exact swish's expf and IEEE division took much of the
// time; the ftz forms also skip the subnormal handling of __expf and
// __fdividef.
__device__ __forceinline__ float swish_fast(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-1.4426950408889634f * v));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return v * r;
}
__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

// swish in a kernel's precision: float32's exact one, or for bfloat16 the
// fast one (a few float32 ulps off, far under the output's rounding).
template <typename T>
__device__ __forceinline__ float swish_of(float v) {
  if constexpr (std::is_same<T, float>::value)
    return swish(v);
  else
    return swish_fast(v);
}

// Eval BN folded to y = x * scale + bias, in float32.
__device__ __forceinline__ float bn_scale(const float* w, const float* v, int c, float eps) {
  return w[c] * rsqrtf(v[c] + eps);
}

// sm_80+ building blocks: cp.async into shared memory, ldmatrix, and the
// bf16 tensor-core product mma.m16n8k16 with float32 sums.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; bytes [src_bytes, 16) are zero-filled, and
// src_bytes = 0 reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row-major fragment) * b (16 x 8,
// bf16, column-major fragment).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Strips of 8 columns (K4a, K6): a thread owns 8 consecutive columns of a
// row, [x0, x0 + 8), loaded as one 16-byte word in bfloat16 or two in
// float32, and works on them as 10 floats, columns x0 - 1 .. x0 + 8.
template <typename T>
struct alignas(16) Pack8 {
  T e[8];
};
template <typename T>
constexpr int kPackWords = sizeof(Pack8<T>) / 16;  // 16-byte words in a Pack8

// src 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_pack8(Pack8<T>& p, const T* src) {
#pragma unroll
  for (int i = 0; i < kPackWords<T>; ++i)
    reinterpret_cast<uint4*>(p.e)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
}

// dst 16-byte aligned: v rounded to T, one or two 16-byte stores.
template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&v)[8]) {
  Pack8<T> p;
#pragma unroll
  for (int j = 0; j < 8; ++j) p.e[j] = from_f<T>(v[j]);
#pragma unroll
  for (int i = 0; i < kPackWords<T>; ++i)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(p.e)[i];
}

// One row of a strip as 10 floats: the 8 columns as loaded, and the halo
// columns x0 - 1 and x0 + 8 from the lanes beside this one, which hold the
// strips left and right of it in the same row, or (own_left, own_right) the
// values this lane loaded itself: the warp's edge lanes, and every lane
// where the strips are not whole 16-byte words. A halo column past the
// row's ends (first strip, last strip) is 0, or with Replicate the row's
// end column (edge clamp). Every lane of the warp calls it.
template <bool Replicate, typename T>
__device__ __forceinline__ void strip_row(float (&v)[10], const Pack8<T>& p, float own_l,
                                          float own_r, bool own_left, bool own_right,
                                          bool first, bool last) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[1 + j] = to_f(p.e[j]);
  const float up = __shfl_up_sync(0xffffffffu, v[8], 1);
  const float down = __shfl_down_sync(0xffffffffu, v[1], 1);
  v[0] = own_left ? own_l : first ? (Replicate ? v[1] : 0.f) : up;
  v[9] = own_right ? own_r : last ? (Replicate ? v[8] : 0.f) : down;
}

}  // namespace hyperseg
