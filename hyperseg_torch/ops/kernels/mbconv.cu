// K4a and K4b: the two phases of an expand-1 MBConv block with SE, and K5:
// the expand + depthwise front half of an expand-ratio block, NCHW.
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
//
// K5 (expand_dw) replaces mbconv.py:231 (expand_dw_phase):
//   e = swish(bn0(W_e . x)), zero outside the image (the depthwise pads the
//   EXPANDED map with zeros, and the expand of a zero pad is swish(bias0),
//   not 0), then out = swish(bn1(depthwise 3x3, stride 1 or 2, of e)).
// Bound: bytes in bfloat16 against the tensor cores (cin MACs per expanded
// element, e.g. 320 at B1 block 22), operations on the CUDA cores where the
// products run in float32. The expanded map never reaches device memory: a
// block takes one tile of output pixels and kCC expanded channels, expands
// the tile's input window (halo included) into shared memory, each thread
// holding 16 sums for two window pixels in registers, then runs the
// depthwise with one output pixel of one channel a thread, stores coalesced
// along W.
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
  extern __shared__ float4 smem4[];
  const int op = (cout + 3) / 4 * 4;
  float* wf = reinterpret_cast<float*>(smem4);  // [cin][op]: W * bn scale * se[b]
  float* bias = wf + cin * op;                   // [cout]
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < cin * op; i += blockDim.x) {
    const int c = i / op, o = i - c * op;
    wf[i] = o < cout ? to_f(w[o * cin + c]) * bn_scale(bn.w, bn.v, o, eps) * se[b * cin + c]
                     : 0.f;
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
  // kUnroll channels' loads in flight before their products (blocks 2-4
  // have 96-144 input channels); a tail of fewer channels loads zeros
  constexpr int kUnroll = 8;
  for (int c = 0; c < cin; c += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      v[j] = c + j < cin ? to_f(hp[(size_t)(c + j) * hw]) : 0.f;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (c + j >= cin) break;
      const float4* wr = reinterpret_cast<const float4*>(wf + (c + j) * op);
#pragma unroll
      for (int o4 = 0; o4 < kMaxOut / 4; ++o4) {
        if (4 * o4 < op) {
          const float4 wv = wr[o4];
          acc[4 * o4] = fmaf(wv.x, v[j], acc[4 * o4]);
          acc[4 * o4 + 1] = fmaf(wv.y, v[j], acc[4 * o4 + 1]);
          acc[4 * o4 + 2] = fmaf(wv.z, v[j], acc[4 * o4 + 2]);
          acc[4 * o4 + 3] = fmaf(wv.w, v[j], acc[4 * o4 + 3]);
        }
      }
    }
  }
  T* optr = out + (size_t)b * cout * hw + pix;
  const T* rp = res ? res + (size_t)b * cout * hw + pix : nullptr;
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) {
    if (o < cout) {
      float v = acc[o] + bias[o];
      if (rp) v += to_f(rp[(size_t)o * hw]);
      optr[(size_t)o * hw] = from_f<T>(v);
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
cudaError_t launch_project(const void* h, const float* se, const void* w,
                           BNParams bn, const void* res, float eps, void* out,
                           int batch, int cin, int cout, int hw,
                           cudaStream_t stream) {
  const dim3 grid((hw + kThreads - 1) / kThreads, batch);
  const size_t smem = sizeof(float) * ((size_t)cin * ((cout + 3) / 4 * 4) + cout);
  const cudaError_t err = cudaFuncSetAttribute(
      project_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  project_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), se, static_cast<const T*>(w), bn,
      static_cast<const T*>(res), eps, static_cast<T*>(out), cin, cout, hw);
  return cudaSuccess;
}

constexpr int kCC = 32;   // expanded channels per block
constexpr int kHalf = kCC / 2;        // expanded channels per thread
constexpr int kLanes = kThreads / 2;  // threads of one channel half
constexpr int kPix = 2;               // window pixels per thread

// Threads [0, 128) expand channels [0, 16) of the block, threads [128, 256)
// channels [16, 32) (four whole warps each, so weight reads stay
// broadcasts); each thread takes kPix window pixels (lane, lane + 128),
// keeps 16 sums for each in registers, and reads each pixel's input
// channels straight from device memory (neighbouring threads, neighbouring
// pixels; the other half's reads of the same pixels hit L1), with the
// block's kCC x cin expand weights in shared memory, so its channel loop
// has no barrier.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
expand_dw_kernel(const T* __restrict__ x, const T* __restrict__ we, BNParams bn0,
                 const T* __restrict__ wd, BNParams bn1, float eps,
                 T* __restrict__ out, int cin, int mid, int height, int width,
                 int out_h, int out_w, int stride, int pad_t, int pad_l,
                 int tile_h, int tile_w, int tiles_x) {
  extern __shared__ float4 smem4[];  // 16-byte aligned for the float4 reads
  float* ws = reinterpret_cast<float*>(smem4);  // [cin][kCC] expand * bn0 scale
  float* s0 = ws + cin * kCC;        // [kCC]
  float* b0 = s0 + kCC;              // [kCC]
  float* wdw = b0 + kCC;             // [kCC][9] depthwise * bn1 scale
  float* b1 = wdw + kCC * 9;         // [kCC]
  float* es = b1 + kCC;              // [kCC][npix] expanded window
  const int win_h = (tile_h - 1) * stride + 3, win_w = (tile_w - 1) * stride + 3;
  const int npix = win_h * win_w;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int c0 = blockIdx.y * kCC, b = blockIdx.z;
  const int oy0 = ty * tile_h, ox0 = tx * tile_w;
  const int gy0 = oy0 * stride - pad_t, gx0 = ox0 * stride - pad_l;

  for (int c = tid; c < kCC; c += nt) {
    const int g = c0 + c;
    float sc0 = 0.f, bi0 = 0.f, sc1 = 0.f, bi1 = 0.f;
    if (g < mid) {
      sc0 = bn_scale(bn0.w, bn0.v, g, eps);
      bi0 = bn0.b[g] - bn0.m[g] * sc0;
      sc1 = bn_scale(bn1.w, bn1.v, g, eps);
      bi1 = bn1.b[g] - bn1.m[g] * sc1;
    }
    s0[c] = sc0;
    b0[c] = bi0;
    b1[c] = bi1;
    for (int t = 0; t < 9; ++t) wdw[c * 9 + t] = g < mid ? to_f(wd[g * 9 + t]) * sc1 : 0.f;
  }
  __syncthreads();
  // rows of W_e are read along cin (coalesced) and stored transposed
  for (int i = tid; i < kCC * cin; i += nt) {
    const int c = i / cin, k = i - c * cin;
    ws[k * kCC + c] = c0 + c < mid ? to_f(we[(size_t)(c0 + c) * cin + k]) * s0[c] : 0.f;
  }
  __syncthreads();

  // 1. expand: 16 sums for each of this thread's window pixels
  const int half = tid / kLanes, lane = tid - half * kLanes;
  const size_t hw = (size_t)height * width;
  const T* xb = x + (size_t)b * cin * hw;
  const T* xp[kPix];
  bool inside[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = lane + j * kLanes;
    const int gy = gy0 + p / win_w, gx = gx0 + p % win_w;
    inside[j] = p < npix && gy >= 0 && gy < height && gx >= 0 && gx < width;
    xp[j] = xb + (inside[j] ? (size_t)gy * width + gx : 0);  // a pixel outside reads pixel 0
  }
  float acc[kPix][kHalf];
#pragma unroll
  for (int j = 0; j < kPix; ++j)
#pragma unroll
    for (int c = 0; c < kHalf; ++c) acc[j][c] = 0.f;
  const float* wh = ws + half * kHalf;
#pragma unroll 4
  for (int k = 0; k < cin; ++k) {
    float v[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) v[j] = to_f(xp[j][k * hw]);
    const float4* wr = reinterpret_cast<const float4*>(wh + k * kCC);
#pragma unroll
    for (int c4 = 0; c4 < kHalf / 4; ++c4) {
      const float4 w4 = wr[c4];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        acc[j][4 * c4] = fmaf(w4.x, v[j], acc[j][4 * c4]);
        acc[j][4 * c4 + 1] = fmaf(w4.y, v[j], acc[j][4 * c4 + 1]);
        acc[j][4 * c4 + 2] = fmaf(w4.z, v[j], acc[j][4 * c4 + 2]);
        acc[j][4 * c4 + 3] = fmaf(w4.w, v[j], acc[j][4 * c4 + 3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = lane + j * kLanes;
    if (p < npix) {
#pragma unroll
      for (int c = 0; c < kHalf; ++c) {
        const int cc = half * kHalf + c;
        es[cc * npix + p] = inside[j] ? swish(acc[j][c] + b0[cc]) : 0.f;
      }
    }
  }
  __syncthreads();

  // 2. depthwise 3x3 + bn1 + swish, one output pixel of one channel a thread
  const int tpix = tile_h * tile_w;
  T* ob = out + ((size_t)b * mid + c0) * out_h * out_w;
  for (int i = tid; i < kCC * tpix; i += nt) {
    const int c = i / tpix, r = i - c * tpix;
    const int py = r / tile_w, px = r - py * tile_w;
    const int oy = oy0 + py, ox = ox0 + px;
    if (c0 + c >= mid || oy >= out_h || ox >= out_w) continue;
    const float* er = es + c * npix + py * stride * win_w + px * stride;
    const float* wk = wdw + c * 9;
    float d = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) d = fmaf(er[dy * win_w + dx], wk[dy * 3 + dx], d);
    ob[((size_t)c * out_h + oy) * out_w + ox] = from_f<T>(swish(d + b1[c]));
  }
}

template <typename T>
cudaError_t launch_expand_dw(const void* x, const void* we, BNParams bn0,
                             const void* wd, BNParams bn1, float eps, void* out,
                             int batch, int cin, int mid, int height, int width,
                             int out_h, int out_w, int stride, int pad_t,
                             int pad_l, int tile_h, int tile_w,
                             cudaStream_t stream) {
  const int npix = ((tile_h - 1) * stride + 3) * ((tile_w - 1) * stride + 3);
  const size_t smem = sizeof(float) * ((size_t)kCC * (cin + npix) + 12 * kCC);
  if (npix > kPix * kLanes || smem > 232448) return cudaErrorInvalidValue;
  auto kern = expand_dw_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_y = (out_h + tile_h - 1) / tile_h, tiles_x = (out_w + tile_w - 1) / tile_w;
  const dim3 grid(tiles_y * tiles_x, (mid + kCC - 1) / kCC, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(we), bn0,
      static_cast<const T*>(wd), bn1, eps, static_cast<T*>(out), cin, mid,
      height, width, out_h, out_w, stride, pad_t, pad_l, tile_h, tile_w, tiles_x);
  return cudaSuccess;
}

}  // namespace

cudaError_t launch_mbconv_expand_dw(DType dt, const void* x, const void* w_expand,
                                    BNParams bn0, const void* w_dw, BNParams bn1,
                                    float eps, void* out, int batch, int cin,
                                    int mid, int height, int width, int out_h,
                                    int out_w, int stride, int pad_t, int pad_l,
                                    int tile_h, int tile_w, cudaStream_t stream) {
  if (stride < 1 || stride > 2 || tile_h < 1 || tile_w < 1 || batch > 65535 ||
      (mid + kCC - 1) / kCC > 65535)
    return cudaErrorInvalidValue;
  if (dt == DType::kFloat32)
    return launch_expand_dw<float>(x, w_expand, bn0, w_dw, bn1, eps, out, batch,
                                   cin, mid, height, width, out_h, out_w, stride,
                                   pad_t, pad_l, tile_h, tile_w, stream);
  return launch_expand_dw<__nv_bfloat16>(x, w_expand, bn0, w_dw, bn1, eps, out,
                                         batch, cin, mid, height, width, out_h,
                                         out_w, stride, pad_t, pad_l, tile_h,
                                         tile_w, stream);
}

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
    return launch_project<float>(h, se, w, bn, residual, eps, out, batch, cin,
                                 cout, hw, stream);
  return launch_project<__nv_bfloat16>(h, se, w, bn, residual, eps, out, batch,
                                       cin, cout, hw, stream);
}

}  // namespace hyperseg
