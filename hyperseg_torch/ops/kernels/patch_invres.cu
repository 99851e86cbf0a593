// K1: signal2weights + patch-wise hyper inverted residual, fused, NCHW.
//
// Replaces hyperseg_tpu/ops/pallas/patch_invres.py:488
// (patch_inverted_residual_s2w_fused). One thread block per patch
// (blockIdx.x = fy * fw + fx, blockIdx.y = b). Everything the unit makes
// stays in shared memory (float32; hp = hidden rounded up to kHT, op = out_ch
// rounded up to 4, padding entries zero so no stage needs a bounds check):
//   w1  [cin][hp]      generated expand weight * bn1 scale, transposed
//   w3  [hp][op]       generated project weight * bn3 scale, transposed
//   w2  [hp][9]        generated depthwise weight * bn2 scale
//   b1, b2 [hp], b3 [op]   folded BN biases
//   s1, s2 [hidden], s3 [out_ch]  BN scales, used while generating
//   ss  [sig]          the patch's signal slice
//   xs  [cin][nh]      the haloed input patch, nh = (ph+2) * (pw+2)
//   hs  [hc][nh]       relu6(bn1(expand)) of one chunk of hc hidden channels
// The wrapper (patch_invres.py, `plan`) picks hc so that two blocks fit on an
// SM, and the unit runs chunk by chunk: expand a chunk, then depthwise and
// project-accumulate it into per-pixel registers. With more pixels than
// threads it keeps the whole hidden map (one chunk) instead.
//
// Weights are generated from the grouped conv weight (n_out, sig/groups):
// w[q] = sum_c W[q, c] * s[(q / (n_out/groups)) * sig/groups + c], never the
// block-diagonal dense matrix. Rows of W with an even fan-in of 32 or more
// are read by kLanes lanes, two elements a lane, so every load fills whole
// 32-byte sectors without help from L1; shorter rows take one lane each, and
// a warp's rows are then contiguous. Halo pixels inside the map are the
// neighbours' pixels; only the image border reflects.
//
// All products run on the CUDA cores in float32: the expand stage gives each
// thread one haloed pixel and kHT hidden channels (one x read, two float4
// weight broadcasts per kHT FMAs); the depthwise + project stage gives each
// thread one output pixel and keeps its out_ch sums in registers.
#include "common.cuh"
#include "kernels.h"

namespace hyperseg {
namespace {

constexpr int kMaxOut = 32;  // output channels held in registers per pixel
constexpr size_t kSmemPerSM = 228 * 1024;  // H100: the largest shared carveout
constexpr int kHT = 8;       // hidden channels per thread in the expand stage
constexpr int kLanes = 8;    // lanes that share one long weight row
constexpr int kRows = 4;     // long weight rows a thread reads at once

// Two adjacent elements (4- or 8-byte aligned) as float32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Reflect index i in [-1, n] into [0, n) (n >= 2), like torch reflect pad.
__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

template <typename T>
__global__ void __launch_bounds__(256, 2)
patch_invres_s2w_kernel(const T* __restrict__ x, const T* __restrict__ s,
                        int64_t s_bstride, const T* __restrict__ ws2w,
                        BNParams bn1, BNParams bn2, BNParams bn3, float eps,
                        T* __restrict__ out, int cin, int height, int width,
                        int fh, int fw, int sig, int opg, int fan_in,
                        int hidden, int out_ch, int hp, int op, int hc) {
  extern __shared__ float4 smem4[];
  float* w1 = reinterpret_cast<float*>(smem4);
  float* w3 = w1 + cin * hp;
  float* w2 = w3 + hp * op;
  float* b1 = w2 + hp * 9;
  float* b2 = b1 + hp;
  float* b3 = b2 + hp;
  float* s1 = b3 + op;
  float* s2 = s1 + hidden;
  float* s3 = s2 + hidden;
  float* ss = s3 + out_ch;
  const int ph = height / fh, pw = width / fw;
  const int hw = pw + 2, nh = (ph + 2) * hw, np = ph * pw;
  float* xs = ss + sig;
  float* hs = xs + cin * nh;
  const int p1 = cin * hidden, p2 = p1 + hidden * 9, p = p2 + hidden * out_ch;

  const int fy = blockIdx.x / fw, fx = blockIdx.x - fy * fw;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < (cin + 9) * hp + hp * op; i += nt) w1[i] = 0.f;
  for (int i = tid; i < hp; i += nt) {
    float sc = 0.f, bias = 0.f;
    if (i < hidden) {
      sc = bn_scale(bn1.w, bn1.v, i, eps);
      bias = bn1.b[i] - bn1.m[i] * sc;
      s1[i] = sc;
    }
    b1[i] = bias;
    sc = bias = 0.f;
    if (i < hidden) {
      sc = bn_scale(bn2.w, bn2.v, i, eps);
      bias = bn2.b[i] - bn2.m[i] * sc;
      s2[i] = sc;
    }
    b2[i] = bias;
  }
  for (int i = tid; i < op; i += nt) {
    float sc = 0.f, bias = 0.f;
    if (i < out_ch) {
      sc = bn_scale(bn3.w, bn3.v, i, eps);
      bias = bn3.b[i] - bn3.m[i] * sc;
      s3[i] = sc;
    }
    b3[i] = bias;
  }
  for (int c = tid; c < sig; c += nt)
    ss[c] = to_f(s[b * s_bstride + ((int64_t)c * fh + fy) * fw + fx]);
  const T* xb = x + (size_t)b * cin * height * width;
  const int y0 = fy * ph - 1, x0 = fx * pw - 1;
  for (int i = tid; i < cin * nh; i += nt) {
    const int c = i / nh, r = i - c * nh;
    const int yy = reflect(y0 + r / hw, height);
    const int xx = reflect(x0 + r % hw, width);
    xs[i] = to_f(xb[((size_t)c * height + yy) * width + xx]);
  }
  __syncthreads();

  // 1. generate this patch's weights, BN scales folded in
  auto put = [&](int q, float v) {
    if (q < p1) {
      const int h = q / cin;
      w1[(q - h * cin) * hp + h] = v * s1[h];
    } else if (q < p2) {
      w2[q - p1] = v * s2[(q - p1) / 9];
    } else {
      const int o = (q - p2) / hidden, h = q - p2 - o * hidden;
      w3[h * op + o] = v * s3[o];
    }
  };
  const bool wide = fan_in >= 32 && fan_in % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(ws2w) % (2 * sizeof(T)) == 0;
  if (wide) {
    // kLanes lanes a row, kRows rows a thread, their loads in flight
    // together (a row past the end re-reads the last one and is dropped); the
    // trip count is the same for every thread, so whole warps reach the
    // shuffles
    const int sub = tid & (kLanes - 1), step = nt / kLanes;
    for (int base = 0; base < p; base += kRows * step) {
      const int q0 = base + tid / kLanes;
      const T* wr[kRows];
      const float* sr[kRows];
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int q = min(q0 + r * step, p - 1);
        wr[r] = ws2w + (size_t)q * fan_in;
        sr[r] = ss + (q / opg) * fan_in;
        acc[r] = 0.f;
      }
      for (int c = 2 * sub; c < fan_in; c += 2 * kLanes) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float2 w = load2(wr[r] + c);
          acc[r] = fmaf(w.x, sr[r][c], fmaf(w.y, sr[r][c + 1], acc[r]));
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int m = kLanes / 2; m > 0; m >>= 1)
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], m);
        if (sub == 0 && q0 + r * step < p) put(q0 + r * step, acc[r]);
      }
    }
  } else {
    for (int q = tid; q < p; q += nt) {
      const T* wr = ws2w + (size_t)q * fan_in;
      const float* sr = ss + (q / opg) * fan_in;
      float acc = 0.f;
      for (int c = 0; c < fan_in; ++c) acc = fmaf(to_f(wr[c]), sr[c], acc);
      put(q, acc);
    }
  }
  __syncthreads();

  T* ob = out + (size_t)b * out_ch * height * width;
  const bool residual = (cin == out_ch);
  float acc[kMaxOut];
  for (int c0 = 0; c0 < hp; c0 += hc) {
    const int nc = min(hc, hp - c0);

    // 2. expand + bn1 + relu6 of hidden channels [c0, c0 + nc), halo included
    for (int i = tid; i < (nc / kHT) * nh; i += nt) {
      const int t = i / nh, r = i - t * nh;
      const float* wc = w1 + c0 + t * kHT;
      float a[kHT];
#pragma unroll
      for (int j = 0; j < kHT; ++j) a[j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < cin; ++c) {
        const float v = xs[c * nh + r];
        const float4 wa = *reinterpret_cast<const float4*>(wc + c * hp);
        const float4 wb = *reinterpret_cast<const float4*>(wc + c * hp + 4);
        a[0] = fmaf(wa.x, v, a[0]);
        a[1] = fmaf(wa.y, v, a[1]);
        a[2] = fmaf(wa.z, v, a[2]);
        a[3] = fmaf(wa.w, v, a[3]);
        a[4] = fmaf(wb.x, v, a[4]);
        a[5] = fmaf(wb.y, v, a[5]);
        a[6] = fmaf(wb.z, v, a[6]);
        a[7] = fmaf(wb.w, v, a[7]);
      }
#pragma unroll
      for (int j = 0; j < kHT; ++j)
        hs[(t * kHT + j) * nh + r] = relu6(a[j] + b1[c0 + t * kHT + j]);
    }
    __syncthreads();

    // 3. depthwise 3x3 + bn2 + relu6, project-accumulate, one pixel a thread;
    // the last chunk adds bn3 (+ x) and writes. More than one chunk only
    // when np <= nt, so a thread's sums stay with its one pixel.
    for (int i = tid; i < np; i += nt) {
      const int py = i / pw, px = i - py * pw;
      if (c0 == 0) {
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) acc[o] = 0.f;
      }
      for (int k = 0; k < nc; ++k) {
        const float* hr = hs + k * nh + py * hw + px;
        const float* wk = w2 + (c0 + k) * 9;
        float d = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) d = fmaf(hr[dy * hw + dx], wk[dy * 3 + dx], d);
        d = relu6(d + b2[c0 + k]);
        const float4* w3r = reinterpret_cast<const float4*>(w3 + (c0 + k) * op);
#pragma unroll
        for (int o4 = 0; o4 < kMaxOut / 4; ++o4) {
          if (4 * o4 < op) {
            const float4 wv = w3r[o4];
            acc[4 * o4] = fmaf(wv.x, d, acc[4 * o4]);
            acc[4 * o4 + 1] = fmaf(wv.y, d, acc[4 * o4 + 1]);
            acc[4 * o4 + 2] = fmaf(wv.z, d, acc[4 * o4 + 2]);
            acc[4 * o4 + 3] = fmaf(wv.w, d, acc[4 * o4 + 3]);
          }
        }
      }
      if (c0 + nc >= hp) {
        const size_t g = (size_t)(fy * ph + py) * width + fx * pw + px;
        const int r = (py + 1) * hw + px + 1;  // the pixel in the haloed patch
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) {
          if (o < out_ch) {
            float v = acc[o] + b3[o];
            if (residual) v += xs[o * nh + r];
            ob[(size_t)o * height * width + g] = from_f<T>(v);
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites hs
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* s, int64_t s_bstride,
                   const void* w_s2w, BNParams bn1, BNParams bn2, BNParams bn3,
                   float eps, void* out, int batch, int cin, int height,
                   int width, int fh, int fw, int sig, int groups, int n_out,
                   int hidden, int out_ch, int hidden_chunk, int threads,
                   cudaStream_t stream) {
  const int ph = height / fh, pw = width / fw;
  const int nh = (ph + 2) * (pw + 2);
  const int hp = (hidden + kHT - 1) / kHT * kHT, op = (out_ch + 3) / 4 * 4;
  const size_t smem = sizeof(float) * ((size_t)(cin + 9 + 2) * hp + hp * op + op +
                                       2 * hidden + out_ch + sig +
                                       (size_t)(cin + hidden_chunk) * nh);
  auto kern = patch_invres_s2w_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // shared carveout: what the blocks that fit on one SM need (1 KB each is
  // reserved); the rest of the SM's unified L1/shared memory stays L1
  size_t blocks = kSmemPerSM / (smem + 1024);
  if (blocks > (size_t)(2048 / threads)) blocks = 2048 / threads;
  const int carveout =
      (int)((100 * blocks * (smem + 1024) + kSmemPerSM - 1) / kSmemPerSM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               carveout < 100 ? carveout : 100);
  if (err != cudaSuccess) return err;
  kern<<<dim3(fh * fw, batch), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(s), s_bstride,
      static_cast<const T*>(w_s2w), bn1, bn2, bn3, eps, static_cast<T*>(out),
      cin, height, width, fh, fw, sig, n_out / groups, sig / groups, hidden,
      out_ch, hp, op, hidden_chunk);
  return cudaSuccess;
}

}  // namespace

cudaError_t launch_patch_invres_s2w(DType dt, const void* x, const void* s,
                                    int64_t s_bstride, const void* w_s2w,
                                    BNParams bn1, BNParams bn2, BNParams bn3,
                                    float eps, void* out, int batch, int cin,
                                    int height, int width, int fh, int fw,
                                    int sig, int groups, int n_out, int hidden,
                                    int out_ch, int hidden_chunk, int threads,
                                    cudaStream_t stream) {
  const int hp = (hidden + kHT - 1) / kHT * kHT;
  const bool one_pixel = (height / fh) * (width / fw) <= threads;
  if (out_ch > kMaxOut || threads % 32 || threads > 256 || hidden_chunk % kHT ||
      hidden_chunk <= 0 || (hidden_chunk < hp && !one_pixel))
    return cudaErrorInvalidValue;
  if (dt == DType::kFloat32)
    return launch<float>(x, s, s_bstride, w_s2w, bn1, bn2, bn3, eps, out, batch,
                         cin, height, width, fh, fw, sig, groups, n_out, hidden,
                         out_ch, hidden_chunk, threads, stream);
  return launch<__nv_bfloat16>(x, s, s_bstride, w_s2w, bn1, bn2, bn3, eps, out,
                               batch, cin, height, width, fh, fw, sig, groups,
                               n_out, hidden, out_ch, hidden_chunk, threads,
                               stream);
}

}  // namespace hyperseg
