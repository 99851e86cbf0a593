// K3: EfficientNet stem, 3x3/s2 conv + eval BN + swish, NCHW in and out.
//
// Replaces hyperseg_tpu/ops/pallas/stem.py:209 (stem_conv_bn_swish).
// TF-SAME padding (0, 1) on each axis: rows/cols past the bottom/right edge
// read as zero, nothing is padded above or left.
//
// Bound: bytes (27*cout MACs per output pixel on 27 input values). One thread
// per output pixel keeps its 27 inputs in registers and loops over the
// output channels; the BN-folded filter and bias sit in shared memory, where
// every thread of a warp reads the same word (a broadcast). Output stores
// are coalesced along W.
#include "common.cuh"
#include "kernels.h"

namespace hyperseg {
namespace {

constexpr int kCin = 3;
constexpr int kTaps = kCin * 9;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const T* __restrict__ x, const T* __restrict__ w, BNParams bn,
            float eps, T* __restrict__ out, int height, int width, int ho,
            int wo, int cout) {
  extern __shared__ float smem[];
  float* wf = smem;                  // [cout][kTaps], BN scale folded in
  float* bias = smem + cout * kTaps;  // [cout]
  for (int i = threadIdx.x; i < cout * kTaps; i += blockDim.x)
    wf[i] = to_f(w[i]) * bn_scale(bn.w, bn.v, i / kTaps, eps);
  for (int o = threadIdx.x; o < cout; o += blockDim.x)
    bias[o] = bn.b[o] - bn.m[o] * bn_scale(bn.w, bn.v, o, eps);
  __syncthreads();

  const int b = blockIdx.y;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= ho * wo) return;
  const int oy = pix / wo, ox = pix - oy * wo;
  const T* xb = x + (size_t)b * kCin * height * width;
  float in[kTaps];
#pragma unroll
  for (int c = 0; c < kCin; ++c) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int iy = 2 * oy + dy, ix = 2 * ox + dx;
        in[(c * 3 + dy) * 3 + dx] =
            (iy < height && ix < width)
                ? to_f(xb[((size_t)c * height + iy) * width + ix])
                : 0.f;
      }
    }
  }
  T* ob = out + (size_t)b * cout * ho * wo + pix;
  for (int o = 0; o < cout; ++o) {
    const float* wo_ = wf + o * kTaps;
    float acc = bias[o];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) acc = fmaf(wo_[k], in[k], acc);
    ob[(size_t)o * ho * wo] = from_f<T>(swish(acc));
  }
}

template <typename T>
void launch(const void* x, const void* w, BNParams bn, float eps, void* out,
            int batch, int height, int width, int cout, cudaStream_t stream) {
  const int ho = (height - 2) / 2 + 1, wo = (width - 2) / 2 + 1;
  const dim3 grid((ho * wo + kThreads - 1) / kThreads, batch);
  const size_t smem = sizeof(float) * cout * (kTaps + 1);
  stem_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bn, eps,
      static_cast<T*>(out), height, width, ho, wo, cout);
}

}  // namespace

cudaError_t launch_stem(DType dt, const void* x, const void* w, BNParams bn,
                        float eps, void* out, int batch, int height, int width,
                        int cout, cudaStream_t stream) {
  if (dt == DType::kFloat32)
    launch<float>(x, w, bn, eps, out, batch, height, width, cout, stream);
  else
    launch<__nv_bfloat16>(x, w, bn, eps, out, batch, height, width, cout, stream);
  return cudaSuccess;
}

}  // namespace hyperseg
