// K6: integer-scale bilinear upsample, NCHW.
//
// Replaces hyperseg_tpu/ops/pallas/resize.py:152 (resize_bilinear_kernel,
// its _forward at :120). out[b, c, oy, ox] for a scale s in {2, 3, 4} on both
// axes, half-pixel centres and edge clamp (align_corners=False):
//   src = clamp((o + 0.5) / s - 0.5, 0, n - 1), lo = floor(src),
//   hi = min(lo + 1, n - 1), frac = src - lo.
// The taps are computed in integers, src = (2o + 1 - s) / (2s), so frac is
// the exact fraction r / (2s) (0.25 / 0.75 at s = 2).
//
// Bound: bytes (4 MACs per output element). Blocks cover an output row of
// one plane (blockIdx.y = oy, blockIdx.z = plane), each thread kVec
// outputs kThreads apart: the row taps are uniform over the block, the scale is
// a template constant (no runtime division), the two input rows are read by
// neighbouring threads (L1 hits), and the stores are coalesced. Nothing of
// the TPU kernel's banded one-hot matrices is carried over.
#include "common.cuh"
#include "kernels.h"

namespace hyperseg {
namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // outputs of one row per thread, kThreads apart

struct Tap {
  int lo, hi;
  float frac;
};

// The 1-D tap of output index o for an input of n samples at scale S.
template <int S>
__device__ __forceinline__ Tap tap(int o, int n) {
  const int num = 2 * o + 1 - S;  // src * 2S
  if (num <= 0) return {0, 0, 0.f};
  const int lo = num / (2 * S);
  if (lo >= n - 1) return {n - 1, n - 1, 0.f};
  return {lo, lo + 1, (float)(num - 2 * S * lo) * (1.f / (2 * S))};
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
resize_kernel(const T* __restrict__ x, T* __restrict__ out, int height, int width) {
  const int ow = width * S;
  const int ox0 = blockIdx.x * kThreads * kVec + threadIdx.x;
  const int oy = blockIdx.y;
  const size_t plane = blockIdx.z;
  const Tap ty = tap<S>(oy, height);
  const T* r0 = x + (plane * height + ty.lo) * width;
  const T* r1 = x + (plane * height + ty.hi) * width;
  T* o = out + (plane * height * S + oy) * ow;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int ox = ox0 + j * kThreads;  // each store coalesced over the warp
    if (ox < ow) {
      const Tap tx = tap<S>(ox, width);
      const float a = to_f(r0[tx.lo]), bb = to_f(r0[tx.hi]);
      const float c = to_f(r1[tx.lo]), d = to_f(r1[tx.hi]);
      const float top = fmaf(tx.frac, bb - a, a), bot = fmaf(tx.frac, d - c, c);
      o[ox] = from_f<T>(fmaf(ty.frac, bot - top, top));
    }
  }
}

template <typename T, int S>
void launch(const void* x, void* out, int planes, int height, int width,
            cudaStream_t stream) {
  const int per_block = kThreads * kVec;
  const dim3 grid((width * S + per_block - 1) / per_block, height * S, planes);
  resize_kernel<T, S><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), height, width);
}

template <typename T>
void launch_scale(const void* x, void* out, int planes, int height, int width,
                  int scale, cudaStream_t stream) {
  if (scale == 2)
    launch<T, 2>(x, out, planes, height, width, stream);
  else if (scale == 3)
    launch<T, 3>(x, out, planes, height, width, stream);
  else
    launch<T, 4>(x, out, planes, height, width, stream);
}

}  // namespace

cudaError_t launch_resize_bilinear(DType dt, const void* x, void* out,
                                   int planes, int height, int width, int scale,
                                   cudaStream_t stream) {
  if (scale < 2 || scale > 4 || planes > 65535 || height * scale > 65535)
    return cudaErrorInvalidValue;
  if (dt == DType::kFloat32)
    launch_scale<float>(x, out, planes, height, width, scale, stream);
  else
    launch_scale<__nv_bfloat16>(x, out, planes, height, width, scale, stream);
  return cudaSuccess;
}

}  // namespace hyperseg
