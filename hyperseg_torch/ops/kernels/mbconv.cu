// K4a and K4b: the two phases of an expand-1 MBConv block with SE, NCHW.
//
// K4a (dw) replaces hyperseg_tpu/ops/pallas/mbconv.py:62 (dw_phase):
//   depthwise 3x3, zero SAME padding (1, 1), eval BN, swish.
// K4b (project) replaces mbconv.py:126 (project_phase):
//   out[b, o] = sum_c (W[o, c] * bn_scale[o] * se[b, c]) * h[b, c] + bn_bias[o]
//               (+ residual[b, o]); the per-image weight is folded here.
//
// Bound: bytes, for both (9 MACs per output element; cin MACs per input
// element). Each thread owns one pixel of one plane (K4a) or one pixel of
// all output channels (K4b), so loads and stores are coalesced along W; the
// nine K4a taps of neighbouring threads overlap and hit L1.
#include "common.cuh"
#include "kernels.h"

namespace hyperseg {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxOut = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ x, const T* __restrict__ w, BNParams bn,
          float eps, T* __restrict__ out, int channels, int height, int width) {
  const int plane = blockIdx.y;  // b * channels + c
  const int c = plane % channels;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= height * width) return;
  const int y = pix / width, xq = pix - y * width;
  const T* xp = x + (size_t)plane * height * width;
  const T* wc = w + c * 9;
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = y + dy - 1;
    if (iy < 0 || iy >= height) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = xq + dx - 1;
      if (ix < 0 || ix >= width) continue;
      acc = fmaf(to_f(wc[dy * 3 + dx]), to_f(xp[iy * width + ix]), acc);
    }
  }
  const float scale = bn_scale(bn.w, bn.v, c, eps);
  const float v = acc * scale + (bn.b[c] - bn.m[c] * scale);
  out[(size_t)plane * height * width + pix] = from_f<T>(swish(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
project_kernel(const T* __restrict__ h, const float* __restrict__ se,
               const T* __restrict__ w, BNParams bn, const T* __restrict__ res,
               float eps, T* __restrict__ out, int cin, int cout, int hw) {
  extern __shared__ float smem[];
  float* wf = smem;                // [cout][cin]: W * bn scale * se[b]
  float* bias = smem + cout * cin;  // [cout]
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < cout * cin; i += blockDim.x) {
    const int o = i / cin, c = i - o * cin;
    wf[i] = to_f(w[i]) * bn_scale(bn.w, bn.v, o, eps) * se[b * cin + c];
  }
  for (int o = threadIdx.x; o < cout; o += blockDim.x)
    bias[o] = bn.b[o] - bn.m[o] * bn_scale(bn.w, bn.v, o, eps);
  __syncthreads();

  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  float acc[kMaxOut];
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) acc[o] = 0.f;
  const T* hp = h + (size_t)b * cin * hw + pix;
  for (int c = 0; c < cin; ++c) {
    const float v = to_f(hp[(size_t)c * hw]);
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o)
      if (o < cout) acc[o] = fmaf(wf[o * cin + c], v, acc[o]);
  }
  T* op = out + (size_t)b * cout * hw + pix;
  const T* rp = res ? res + (size_t)b * cout * hw + pix : nullptr;
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) {
    if (o < cout) {
      float v = acc[o] + bias[o];
      if (rp) v += to_f(rp[(size_t)o * hw]);
      op[(size_t)o * hw] = from_f<T>(v);
    }
  }
}

template <typename T>
void launch_dw(const void* x, const void* w, BNParams bn, float eps, void* out,
               int batch, int channels, int height, int width,
               cudaStream_t stream) {
  const dim3 grid((height * width + kThreads - 1) / kThreads, batch * channels);
  dw_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bn, eps,
      static_cast<T*>(out), channels, height, width);
}

template <typename T>
void launch_project(const void* h, const float* se, const void* w, BNParams bn,
                    const void* res, float eps, void* out, int batch, int cin,
                    int cout, int hw, cudaStream_t stream) {
  const dim3 grid((hw + kThreads - 1) / kThreads, batch);
  const size_t smem = sizeof(float) * cout * (cin + 1);
  project_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), se, static_cast<const T*>(w), bn,
      static_cast<const T*>(res), eps, static_cast<T*>(out), cin, cout, hw);
}

}  // namespace

cudaError_t launch_mbconv_dw(DType dt, const void* x, const void* w,
                             BNParams bn, float eps, void* out, int batch,
                             int channels, int height, int width,
                             cudaStream_t stream) {
  if (dt == DType::kFloat32)
    launch_dw<float>(x, w, bn, eps, out, batch, channels, height, width, stream);
  else
    launch_dw<__nv_bfloat16>(x, w, bn, eps, out, batch, channels, height, width,
                             stream);
  return cudaSuccess;
}

cudaError_t launch_mbconv_project(DType dt, const void* h, const float* se,
                                  const void* w, BNParams bn,
                                  const void* residual, float eps, void* out,
                                  int batch, int cin, int cout, int hw,
                                  cudaStream_t stream) {
  if (cout > kMaxOut) return cudaErrorInvalidValue;
  if (dt == DType::kFloat32)
    launch_project<float>(h, se, w, bn, residual, eps, out, batch, cin, cout,
                          hw, stream);
  else
    launch_project<__nv_bfloat16>(h, se, w, bn, residual, eps, out, batch, cin,
                                  cout, hw, stream);
  return cudaSuccess;
}

}  // namespace hyperseg
