// K1: signal2weights + patch-wise hyper inverted residual, fused, NCHW.
//
// Replaces hyperseg_tpu/ops/pallas/patch_invres.py:488
// (patch_inverted_residual_s2w_fused). One thread block per patch
// (blockIdx.x = fy * fw + fx, blockIdx.y = b). Everything the unit makes
// stays in shared memory (float32): the unit's weights (`Unit` below), then
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
//
// K2: the same unit from given per-patch weights, NCHW.
//
// Replaces hyperseg_tpu/ops/pallas/patch_invres.py:870
// (patch_inverted_residual_fused). w is (B, fh, fw, P), each patch's P
// weights contiguous in the reference order w1 (hidden, cin) | w2 (hidden,
// 3, 3) | w3 (out_ch, hidden). One thread block per (band of `band` rows of a
// patch, b): blockIdx.x = (fy * fw + fx) * (ph / band) + band index. The
// block loads its (band+2) x (pw+2) haloed input rows (the neighbours'
// pixels inside the map, reflected at the image border) and the patch's P
// weights, BN scales folded in as K1 folds them, then expands the band and
// its halo rows with this patch's w1 into shared memory (halo rows outside
// the patch are the neighbour's pixels expanded with this patch's weights,
// as in the reference's haloed unfold), and runs depthwise + project with
// each thread looping over output pixels, out_ch sums in registers. Since
// a thread finishes a pixel before the next, a band may hold more pixels
// than threads: a 32x32 patch takes bands of 8 rows (256 pixels), 4 blocks
// of ~100 KB, two to an SM. Bound as K1's stages 2-3: operations on the
// CUDA cores in float32; bytes (x, w, out once) in bfloat16 against the
// tensor cores.
//
// K7: the v0_1 inverted residual from given per-patch weights, NCHW.
//
// Replaces hyperseg_tpu/ops/pallas/patch_invres.py:784
// (patch_inverted_residual_v01). The same arithmetic and blocks as K2, with
// one difference: v0_1 folds each stage back to the full map, so a halo
// pixel of the hidden map is its owner patch's expand, made with the owner's
// w1 (the neighbour above, below, beside, or diagonal), not this patch's.
// The block keeps only its own patch's weights in shared memory; a halo
// pixel owned by another patch reads that patch's w1 rows from the weight
// map in device memory (a level's map is a few MB, resident in the 50 MB L2),
// applies bn1's scale after the sum, and lands in the same hidden tile. A
// reflected pixel at the image border is owned by the patch it reflects
// into. The map may be the first P entries of wider rows (`wstride`), as
// the v0_1 weight mapper's heads leave it.
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

// Length of one patch's weight vector: w1 | w2 | w3.
__host__ __device__ __forceinline__ int hyper_params(int cin, int hidden, int out_ch) {
  return cin * hidden + hidden * 9 + hidden * out_ch;
}

// The unit's weights in shared memory with the BN scales folded in, laid
// out so the expand reads kHT hidden channels and the project 4 outputs per
// float4 broadcast (hp = hidden rounded up to kHT, op = out_ch rounded up to
// 4; padding entries are zero, so no stage needs a bounds check):
//   w1 [cin][hp] expand, transposed      w3 [hp][op] project, transposed
//   w2 [hp][9] depthwise                 b1, b2 [hp], b3 [op] folded biases
//   s1, s2 [hidden], s3 [out_ch] the scales, read while placing weights
// K1 generates the weights, K2 reads them from its weight map; both place
// them with `put` and run the same expand and depthwise + project.
struct Unit {
  int cin, hidden, out_ch, hp, op;
  float *w1, *w3, *w2, *b1, *b2, *b3, *s1, *s2, *s3;

  __device__ Unit(float* base, int cin_, int hidden_, int out_ch_)
      : cin(cin_), hidden(hidden_), out_ch(out_ch_),
        hp((hidden_ + kHT - 1) / kHT * kHT), op((out_ch_ + 3) / 4 * 4) {
    w1 = base;
    w3 = w1 + cin * hp;
    w2 = w3 + hp * op;
    b1 = w2 + hp * 9;
    b2 = b1 + hp;
    b3 = b2 + hp;
    s1 = b3 + op;
    s2 = s1 + hidden;
    s3 = s2 + hidden;
  }

  __device__ float* end() const { return s3 + out_ch; }

  // Zero the weights and fold the three eval BNs; the caller synchronises.
  __device__ void fold_bn(BNParams bn1, BNParams bn2, BNParams bn3, float eps) const {
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
  }

  // Weight q of the reference order w1 (hidden, cin) | w2 (hidden, 3, 3) |
  // w3 (out_ch, hidden), scaled and placed.
  __device__ void put(int q, float v) const {
    const int p1 = cin * hidden, p2 = p1 + hidden * 9;
    if (q < p1) {
      const int h = q / cin;
      w1[(q - h * cin) * hp + h] = v * s1[h];
    } else if (q < p2) {
      w2[q - p1] = v * s2[(q - p1) / 9];
    } else {
      const int o = (q - p2) / hidden, h = q - p2 - o * hidden;
      w3[h * op + o] = v * s3[o];
    }
  }

  // relu6(bn1(expand)) of hidden channels [c0, c0 + nc) (nc a multiple of
  // kHT) at the n pixels of xs [cin][n], into hs [nc][n]: one pixel and kHT
  // channels an item, one x read and two float4 weight broadcasts per kHT
  // FMAs.
  __device__ void expand(const float* xs, float* hs, int n, int c0, int nc) const {
    for (int i = threadIdx.x; i < (nc / kHT) * n; i += blockDim.x) {
      const int t = i / n, r = i - t * n;
      float a[kHT];
      expand_shared(xs + r, n, c0 + t * kHT, a);
#pragma unroll
      for (int j = 0; j < kHT; ++j)
        hs[(t * kHT + j) * n + r] = relu6(a[j] + b1[c0 + t * kHT + j]);
    }
  }

  // a[j] = (s1-scaled w1 . x) of hidden channel h0 + j at the pixel whose
  // cin values are xr[c * n].
  __device__ void expand_shared(const float* xr, int n, int h0, float* a) const {
    const float* wc = w1 + h0;
#pragma unroll
    for (int j = 0; j < kHT; ++j) a[j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < cin; ++c) {
      const float v = xr[c * n];
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
  }

  // K7's expand: relu6(bn1(expand)) of all hidden channels at the n pixels
  // of xs [cin][n], rows `row` pixels wide, whose top-left pixel is map
  // pixel (y0, x0) before the border reflect. A pixel owned by this patch
  // (fy, fx) takes the shared w1 as `expand` does; any other pixel its
  // owner's w1 (hidden, cin), read from wimg, the image's weight map of
  // `wstride` entries per patch.
  template <typename T>
  __device__ void expand_v01(const float* xs, float* hs, int n, int row, const T* wimg,
                             int64_t wstride, int fy, int fx, int y0, int x0, int height,
                             int width, int ph, int pw, int fw) const {
    for (int i = threadIdx.x; i < (hp / kHT) * n; i += blockDim.x) {
      const int t = i / n, r = i - t * n;
      const int yy = reflect(y0 + r / row, height), xx = reflect(x0 + r % row, width);
      const int oy = yy / ph, ox = xx / pw;
      float a[kHT];
      if (oy == fy && ox == fx) {
        expand_shared(xs + r, n, t * kHT, a);
      } else {
        // rows past `hidden` (padding channels) re-read the last row and
        // are dropped by a zero scale
        const T* wo = wimg + ((int64_t)oy * fw + ox) * wstride;
        const T* wr[kHT];
#pragma unroll
        for (int j = 0; j < kHT; ++j) {
          wr[j] = wo + (int64_t)min(t * kHT + j, hidden - 1) * cin;
          a[j] = 0.f;
        }
        for (int c = 0; c < cin; ++c) {
          const float v = xs[c * n + r];
#pragma unroll
          for (int j = 0; j < kHT; ++j) a[j] = fmaf(to_f(wr[j][c]), v, a[j]);
        }
#pragma unroll
        for (int j = 0; j < kHT; ++j) a[j] *= t * kHT + j < hidden ? s1[t * kHT + j] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kHT; ++j) hs[(t * kHT + j) * n + r] = relu6(a[j] + b1[t * kHT + j]);
    }
  }

  // Depthwise 3x3 + bn2 + relu6 of hidden channels [c0, c0 + nc) at one
  // pixel, projected into acc: hr is the pixel's 3x3 window in hs (rows
  // `row` apart, channels n apart).
  __device__ void dw_project(const float* hr, int row, int n, int c0, int nc,
                             float* acc) const {
    for (int k = 0; k < nc; ++k) {
      const float* h = hr + k * n;
      const float* wk = w2 + (c0 + k) * 9;
      float d = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) d = fmaf(h[dy * row + dx], wk[dy * 3 + dx], d);
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
  }

  // out[o, g] = acc[o] + bn3 bias (+ the input pixel xr[o * n] when
  // cin == out_ch), for a pixel g of an (out_ch, plane) output.
  template <typename T>
  __device__ void store(T* ob, size_t plane, size_t g, const float* acc,
                        const float* xr, int n) const {
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      if (o < out_ch) {
        float v = acc[o] + b3[o];
        if (cin == out_ch) v += xr[o * n];
        ob[(size_t)o * plane + g] = from_f<T>(v);
      }
    }
  }
};

// rows x row pixels of the cin planes of xb from (y0, x0) on, reflected at
// the image border (inside the map these are the neighbours' pixels), into
// xs [cin][rows * row].
template <typename T>
__device__ void load_haloed(const T* xb, float* xs, int cin, int height, int width,
                            int y0, int x0, int rows, int row) {
  const int n = rows * row;
  for (int i = threadIdx.x; i < cin * n; i += blockDim.x) {
    const int c = i / n, r = i - c * n;
    const int yy = reflect(y0 + r / row, height), xx = reflect(x0 + r % row, width);
    xs[i] = to_f(xb[((size_t)c * height + yy) * width + xx]);
  }
}

template <typename T>
__global__ void __launch_bounds__(256, 2)
patch_invres_s2w_kernel(const T* __restrict__ x, const T* __restrict__ s,
                        int64_t s_bstride, const T* __restrict__ ws2w,
                        BNParams bn1, BNParams bn2, BNParams bn3, float eps,
                        T* __restrict__ out, int cin, int height, int width,
                        int fh, int fw, int sig, int opg, int fan_in,
                        int hidden, int out_ch, int hc) {
  extern __shared__ float4 smem4[];
  const Unit u(reinterpret_cast<float*>(smem4), cin, hidden, out_ch);
  float* ss = u.end();  // [sig] the patch's signal slice
  const int ph = height / fh, pw = width / fw;
  const int hw = pw + 2, nh = (ph + 2) * hw, np = ph * pw;
  float* xs = ss + sig;       // [cin][nh] the haloed input patch
  float* hs = xs + cin * nh;  // [hc][nh] one chunk of the hidden map
  const int p = hyper_params(cin, hidden, out_ch);

  const int fy = blockIdx.x / fw, fx = blockIdx.x - fy * fw;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;

  u.fold_bn(bn1, bn2, bn3, eps);
  for (int c = tid; c < sig; c += nt)
    ss[c] = to_f(s[b * s_bstride + ((int64_t)c * fh + fy) * fw + fx]);
  load_haloed(x + (size_t)b * cin * height * width, xs, cin, height, width,
              fy * ph - 1, fx * pw - 1, ph + 2, hw);
  __syncthreads();

  // 1. generate this patch's weights, BN scales folded in
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
        if (sub == 0 && q0 + r * step < p) u.put(q0 + r * step, acc[r]);
      }
    }
  } else {
    for (int q = tid; q < p; q += nt) {
      const T* wr = ws2w + (size_t)q * fan_in;
      const float* sr = ss + (q / opg) * fan_in;
      float acc = 0.f;
      for (int c = 0; c < fan_in; ++c) acc = fmaf(to_f(wr[c]), sr[c], acc);
      u.put(q, acc);
    }
  }
  __syncthreads();

  T* ob = out + (size_t)b * out_ch * height * width;
  float acc[kMaxOut];
  for (int c0 = 0; c0 < u.hp; c0 += hc) {
    const int nc = min(hc, u.hp - c0);
    // 2. expand + bn1 + relu6 of hidden channels [c0, c0 + nc), halo included
    u.expand(xs, hs, nh, c0, nc);
    __syncthreads();
    // 3. depthwise + project-accumulate, one pixel a thread; the last chunk
    // adds bn3 (+ x) and writes. More than one chunk only when np <= nt, so
    // a thread's sums stay with its one pixel.
    for (int i = tid; i < np; i += nt) {
      const int py = i / pw, px = i - py * pw;
      if (c0 == 0) {
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) acc[o] = 0.f;
      }
      u.dw_project(hs + py * hw + px, hw, nh, c0, nc, acc);
      if (c0 + nc >= u.hp)
        u.store(ob, (size_t)height * width, (size_t)(fy * ph + py) * width + fx * pw + px,
                acc, xs + (py + 1) * hw + px + 1, nh);
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
      out_ch, hidden_chunk);
  return cudaSuccess;
}

// K2, and K7 with kV01: wmap holds `wstride` entries per patch, the first P
// of them the patch's weights.
template <typename T, bool kV01>
__global__ void __launch_bounds__(256, 2)
patch_invres_kernel(const T* __restrict__ x, const T* __restrict__ wmap, int64_t wstride,
                    BNParams bn1, BNParams bn2, BNParams bn3, float eps,
                    T* __restrict__ out, int cin, int height, int width, int fh,
                    int fw, int hidden, int out_ch, int band) {
  extern __shared__ float4 smem4[];
  const Unit u(reinterpret_cast<float*>(smem4), cin, hidden, out_ch);
  const int ph = height / fh, pw = width / fw;
  const int hw = pw + 2, nb = (band + 2) * hw, npix = band * pw;
  float* xs = u.end();        // [cin][nb] the haloed input band
  float* hs = xs + cin * nb;  // [hp][nb] relu6(bn1(expand)), halo included
  const int p = hyper_params(cin, hidden, out_ch);

  const int nbands = ph / band;
  const int patch = blockIdx.x / nbands, r0 = (blockIdx.x - patch * nbands) * band;
  const int fy = patch / fw, fx = patch - fy * fw;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;

  u.fold_bn(bn1, bn2, bn3, eps);
  load_haloed(x + (size_t)b * cin * height * width, xs, cin, height, width,
              fy * ph + r0 - 1, fx * pw - 1, band + 2, hw);
  __syncthreads();

  // 1. this patch's weights, contiguous in the map, BN scales folded in
  const T* wimg = wmap + (int64_t)b * fh * fw * wstride;
  const T* wp = wimg + ((int64_t)fy * fw + fx) * wstride;
  for (int q = tid; q < p; q += nt) u.put(q, to_f(wp[q]));
  __syncthreads();

  // 2. expand + bn1 + relu6 of all hidden channels, halo included: K2 with
  // this patch's w1 throughout, K7 with each pixel's owner's
  if (kV01)
    u.expand_v01(xs, hs, nb, hw, wimg, wstride, fy, fx, fy * ph + r0 - 1, fx * pw - 1,
                 height, width, ph, pw, fw);
  else
    u.expand(xs, hs, nb, 0, u.hp);
  __syncthreads();

  // 3. depthwise + project + bn3 (+ x), a pixel at a time
  T* ob = out + (size_t)b * out_ch * height * width;
  for (int i = tid; i < npix; i += nt) {
    const int py = i / pw, px = i - py * pw;
    float acc[kMaxOut];
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) acc[o] = 0.f;
    u.dw_project(hs + py * hw + px, hw, nb, 0, hidden, acc);
    u.store(ob, (size_t)height * width,
            (size_t)(fy * ph + r0 + py) * width + fx * pw + px, acc,
            xs + (py + 1) * hw + px + 1, nb);
  }
}

template <typename T, bool kV01>
cudaError_t launch_k2(const void* x, const void* wmap, int64_t wstride, BNParams bn1,
                      BNParams bn2, BNParams bn3, float eps, void* out, int batch,
                      int cin, int height, int width, int fh, int fw, int hidden,
                      int out_ch, int band, cudaStream_t stream) {
  const int ph = height / fh, pw = width / fw;
  const int nb = (band + 2) * (pw + 2);
  const int hp = (hidden + kHT - 1) / kHT * kHT, op = (out_ch + 3) / 4 * 4;
  const size_t smem = sizeof(float) * ((size_t)(cin + 9 + 2) * hp + hp * op + op +
                                       2 * hidden + out_ch + (size_t)(cin + hp) * nb);
  auto kern = patch_invres_kernel<T, kV01>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // the whole shared carveout: the plan sizes blocks so that two fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kern<<<dim3(fh * fw * (ph / band), batch), 256, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wmap), wstride, bn1, bn2, bn3,
      eps, static_cast<T*>(out), cin, height, width, fh, fw, hidden, out_ch, band);
  return cudaSuccess;
}

}  // namespace

cudaError_t launch_patch_invres(DType dt, const void* x, const void* wmap,
                                BNParams bn1, BNParams bn2, BNParams bn3,
                                float eps, void* out, int batch, int cin,
                                int height, int width, int fh, int fw,
                                int hidden, int out_ch, int band,
                                cudaStream_t stream) {
  if (out_ch > kMaxOut || band < 1 || (height / fh) % band || batch > 65535)
    return cudaErrorInvalidValue;
  const int64_t p = hyper_params(cin, hidden, out_ch);
  if (dt == DType::kFloat32)
    return launch_k2<float, false>(x, wmap, p, bn1, bn2, bn3, eps, out, batch, cin,
                                   height, width, fh, fw, hidden, out_ch, band, stream);
  return launch_k2<__nv_bfloat16, false>(x, wmap, p, bn1, bn2, bn3, eps, out, batch,
                                         cin, height, width, fh, fw, hidden, out_ch,
                                         band, stream);
}

cudaError_t launch_patch_invres_v01(DType dt, const void* x, const void* wmap,
                                    int64_t wstride, BNParams bn1, BNParams bn2,
                                    BNParams bn3, float eps, void* out, int batch,
                                    int cin, int height, int width, int fh, int fw,
                                    int hidden, int out_ch, int band,
                                    cudaStream_t stream) {
  if (out_ch > kMaxOut || band < 1 || (height / fh) % band || batch > 65535 ||
      wstride < hyper_params(cin, hidden, out_ch) || height < 2 || width < 2)
    return cudaErrorInvalidValue;
  if (dt == DType::kFloat32)
    return launch_k2<float, true>(x, wmap, wstride, bn1, bn2, bn3, eps, out, batch, cin,
                                  height, width, fh, fw, hidden, out_ch, band, stream);
  return launch_k2<__nv_bfloat16, true>(x, wmap, wstride, bn1, bn2, bn3, eps, out, batch,
                                        cin, height, width, fh, fw, hidden, out_ch, band,
                                        stream);
}

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
