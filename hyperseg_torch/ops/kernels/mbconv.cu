// K4a and K4b: the two phases of an expand-1 MBConv block with SE, and K5:
// the expand + depthwise front half of an expand-ratio block, NCHW.
//
// K4a (dw) replaces hyperseg_tpu/ops/pallas/mbconv.py:62 (dw_phase):
//   depthwise 3x3, zero SAME padding (1, 1), eval BN, swish.
// K4b (project) replaces mbconv.py:126 (project_phase):
//   out[b, o] = sum_c (W[o, c] * bn_scale[o] * se[b, c]) * h[b, c] + bn_bias[o]
//               (+ residual[b, o]); the per-image weight is folded here.
//
// Bound: bytes, for both: 9 MACs per K4a output element, at most cout <= 32
// MACs per K4b input element, far under the card's ~295 flops per byte.
// K4a moved its bytes two at a time (one pixel a thread, nine scalar loads,
// the BN fold in every thread): now a thread walks a strip of 8 columns down
// a band of rows with a three-row window in registers, one 16-byte load per
// input row and one 16-byte store per output row, and a block folds BN into
// the taps once (dw_kernel below; the band from mbconv.py's dw_plan).
// K4b is a per-image GEMM whose time went to latency on an under-filled card
// (one pixel a thread, serial 2-byte loads per channel). Now a block takes
// 64 or 128 pixels (the plan fills 132 SMs twice where the map allows),
// streams the h tile through a 4-stage ring of 16-byte cp.async copies in
// chunks of 32 channels, and in bfloat16 runs mma.m16n8k16 on it; se[b] is
// folded into W once per block in float32 and rounded once, bn in float32
// in the epilogue, which stores 16 bytes a thread along pixels.
//
// K5 (expand_dw) replaces mbconv.py:231 (expand_dw_phase) in its 3x3 form:
//   e = swish(bn0(W_e . x)), zero outside the image (the depthwise pads the
//   EXPANDED map with zeros, and the expand of a zero pad is swish(bias0),
//   not 0), then out = swish(bn1(depthwise KxK, stride 1 or 2, of e)).
// Its 5x5 form replaces no TPU kernel (the JAX package runs the 5x5 blocks
// as XLA convolutions): it takes the place of cuDNN's 1x1 expand, ATen's
// depthwise and their four BN and swish passes, which moved the expanded
// map through device memory four times. K is a template parameter, so the
// 3x3 form compiles as before; the 5x5 form stages a window K - 1 pixels
// wider and taller than the tile's input, and its plans (mbconv.py's
// expand_dw_plan) keep two blocks an SM.
// Bound: bytes in bfloat16 against the tensor cores (cin MACs per expanded
// element, at most 384 on B3), operations in float32, whose expand runs on
// the CUDA cores. The expanded map never reaches device memory: a block
// takes one tile of output pixels and 32 or 64 expanded channels, stages the
// tile's input window (halo included) through a cp.async ring, expands it
// into shared memory (bfloat16: an mma GEMM; float32: FMAs, same tiling),
// then runs the depthwise, each thread walking the rows of one column. More
// channels a block where cin is large and the map small, so one staged
// window serves more of them. Shared-memory layouts of K4b and K5 come from
// the plans in mbconv.py, which hand them to the launch.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "kernels.h"

namespace hyperseg {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxOut = 32;
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory one block may use

// K4a: a thread owns a strip of 8 columns of one plane and walks `rows`
// rows down it, holding rows y - 1, y, y + 1 of the strip (and its two halo
// columns) as a window of floats in registers: each input row arrives as one
// 16-byte load in bfloat16 (two in float32), issued a row ahead, with its
// halo columns from the neighbouring lanes (strip_row); each output row
// leaves as one 16-byte store (two in float32). Units (plane, band of `rows`
// rows, strip) are numbered strip fastest, kDwThreads to a block, so a block
// spans several planes where planes are small; while its first rows load,
// it folds the BN scale into the nine taps of each of its planes' channels,
// once, in float32, into shared memory ([planes][10]: nine taps, bias;
// `smem` bytes as mbconv.py's dw_plan sizes it). vec = 0 (a width not a
// multiple of 8, or a pointer off 16 bytes): element loads and stores in the
// same kernel, each lane loading its own halo columns.
constexpr int kDwThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDwThreads)
dw_kernel(const T* __restrict__ x, const T* __restrict__ w, BNParams bn, float eps,
          T* __restrict__ out, int channels, int planes, int height, int width, int rows,
          int vec) {
  extern __shared__ float taps[];
  const int strips = (width + 7) >> 3, per_plane = strips * ((height + rows - 1) / rows);
  const int total = planes * per_plane, first = blockIdx.x * kDwThreads;  // under 2^31
  // the grid's lanes past the last unit repeat it (they take part in the
  // shuffles) and store nothing
  const bool active = first + (int)threadIdx.x < total;
  const int u = min(first + (int)threadIdx.x, total - 1);
  const int plane = u / per_plane, rem = u - plane * per_plane;
  const int band = rem / strips, x0 = (rem - band * strips) * 8, y0 = band * rows;
  const T* xp = x + (size_t)plane * height * width;
  T* op = out + (size_t)plane * height * width;
  const int lane = threadIdx.x & 31;
  const bool own_left = !vec || lane == 0, own_right = !vec || lane == 31;
  const bool first_strip = x0 == 0, last_strip = x0 + 8 >= width;

  // row iy of the strip (zero outside the plane) and the halo columns this
  // lane loads itself
  auto fetch = [&](int iy, Pack8<T>& p, float& l, float& r) {
    const bool in = iy >= 0 && iy < height;
    const T* src = xp + (size_t)(in ? iy : 0) * width + x0;
    if (vec && in) {
      load_pack8(p, src);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) p.e[j] = from_f<T>(in && x0 + j < width ? to_f(src[j]) : 0.f);
    }
    l = in && own_left && !first_strip ? to_f(src[-1]) : 0.f;
    r = in && own_right && !last_strip ? to_f(src[8]) : 0.f;
  };
  Pack8<T> next;
  float next_l, next_r;
  fetch(y0 - 1, next, next_l, next_r);  // in flight while the block folds BN

  const int p0 = first / per_plane, np = (min(first + kDwThreads, total) - 1) / per_plane - p0 + 1;
  for (int i = threadIdx.x; i < np; i += kDwThreads) {
    const int c = (p0 + i) % channels;
    const float s = bn_scale(bn.w, bn.v, c, eps);
#pragma unroll
    for (int k = 0; k < 9; ++k) taps[i * 10 + k] = to_f(w[c * 9 + k]) * s;
    taps[i * 10 + 9] = bn.b[c] - bn.m[c] * s;
  }
  __syncthreads();
  float tap[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) tap[k] = taps[(plane - p0) * 10 + k];

  float win[3][10];  // rows y - 1, y, y + 1; columns x0 - 1 .. x0 + 8
#pragma unroll 1
  for (int i = 0; i < rows + 2; ++i) {
    const Pack8<T> cur = next;
    const float cur_l = next_l, cur_r = next_r;
    if (i + 1 < rows + 2) fetch(y0 + i, next, next_l, next_r);  // in flight while this row is used
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      win[0][k] = win[1][k];
      win[1][k] = win[2][k];
    }
    strip_row<false>(win[2], cur, cur_l, cur_r, own_left, own_right, first_strip, last_strip);
    const int y = y0 + i - 2;
    if (i < 2 || !active || y >= height) continue;
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float acc = tap[9];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) acc = fmaf(tap[dy * 3 + dx], win[dy][j + dx], acc);
      o[j] = swish_of<T>(acc);
    }
    T* dst = op + (size_t)y * width + x0;
    if (vec) {
      store8(dst, o);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (x0 + j < width) dst[j] = from_f<T>(o[j]);
    }
  }
}

// K4b: the per-image GEMM out[b] (cout x hw) = Wf[b] (cout x cin) . h[b]
// (cin x hw), Wf[b] = W . diag(se[b]). A block takes TP pixels of one image
// and every output channel.
constexpr int kProjThreads = 128;  // four warps
constexpr int kProjKC = 32;        // input channels per pipeline stage
constexpr int kProjStages = 4;     // stages of the cp.async ring

template <typename T>
constexpr int kVec = 16 / sizeof(T);  // elements of T in one 16-byte copy

// bf16: mma.m16n8k16 with the h tile as A (ldmatrix.trans from its
// channel-major rows; each warp 16 * TP / 64 pixels) and Wf as B (cout
// padded to 8 per n-tile); float32: FMAs on the CUDA cores, one pixel and
// kMaxOut * TP / 128 outputs a thread. Both stage h through the same ring of
// 16-byte cp.async copies (`vec`: hw a multiple of 16 bytes and aligned
// pointers), or element by element where a plane's rows are not aligned.
template <typename T, int TP>
__global__ void __launch_bounds__(kProjThreads)
project_kernel(const T* __restrict__ h, const float* __restrict__ se,
               const T* __restrict__ w, BNParams bn, const T* __restrict__ res,
               float eps, T* __restrict__ out, int cin, int cout, int hw, int vec,
               ProjectSmem lay) {
  constexpr bool kMma = !std::is_same<T, float>::value;
  constexpr int V = kVec<T>;
  constexpr int MT = TP / 64;                    // bf16: m-tiles of 16 pixels per warp
  constexpr int G = kProjThreads / TP;           // float32: threads per pixel
  constexpr int CPG = kMaxOut / G;               // float32: outputs per thread
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  T* ring = reinterpret_cast<T*>(base);
  float* otile = reinterpret_cast<float*>(base);  // after the products
  char* wbase = base + lay.w_off;
  float* sc = reinterpret_cast<float*>(base + lay.c_off);
  float* bi = sc + kMaxOut;

  const int tid = threadIdx.x, b = blockIdx.y, p0 = blockIdx.x * TP;
  const int nchunks = (cin + kProjKC - 1) / kProjKC, cin_pad = nchunks * kProjKC;
  const T* hb = h + (size_t)b * cin * hw;

  auto load = [&](int chunk) {
    T* dst = ring + (size_t)(chunk % kProjStages) * kProjKC * lay.row;
    for (int i = tid; i < kProjKC * (TP / V); i += kProjThreads) {
      const int r = i / (TP / V), q = i - r * (TP / V);
      const int c = chunk * kProjKC + r, p = p0 + q * V;
      T* d = dst + r * lay.row + q * V;
      if (vec) {
        const bool ok = c < cin && p < hw;
        cp_async16(d, ok ? hb + (size_t)c * hw + p : hb, ok ? 16 : 0);
      } else {
        for (int e = 0; e < V; ++e)
          d[e] = c < cin && p + e < hw ? hb[(size_t)c * hw + p + e] : from_f<T>(0.f);
      }
    }
  };
  for (int s = 0; s < kProjStages - 1; ++s) {
    if (s < nchunks) load(s);
    cp_async_commit();
  }

  // fold se[b] into W in float32 while the first tiles are in flight; rows
  // of W are read along cin (coalesced). bf16 rounds the product once.
  const int rows = kMma ? (cout + 7) / 8 * 8 : kMaxOut;
  for (int i = tid; i < rows * cin_pad; i += kProjThreads) {
    const int o = i / cin_pad, c = i - o * cin_pad;
    const float v = o < cout && c < cin ? to_f(w[o * cin + c]) * se[b * cin + c] : 0.f;
    if constexpr (kMma)
      reinterpret_cast<T*>(wbase)[o * lay.w_row + c] = from_f<T>(v);
    else
      reinterpret_cast<float*>(wbase)[c * lay.w_row + o] = v;
  }
  if (tid < kMaxOut) {
    const float s = tid < cout ? bn_scale(bn.w, bn.v, tid, eps) : 0.f;
    sc[tid] = s;
    bi[tid] = tid < cout ? bn.b[tid] - bn.m[tid] * s : 0.f;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, r8 = lane & 7;
  const int ntiles = (cout + 7) / 8;
  const int p = tid % TP, o0 = tid / TP * CPG;  // float32: this thread's pixel, outputs
  float acc[MT][kMaxOut / 8][4] = {};
  float facc[CPG] = {};
  for (int j = 0; j < nchunks; ++j) {
    cp_async_wait<kProjStages - 2>();
    __syncthreads();
    if (j + kProjStages - 1 < nchunks) load(j + kProjStages - 1);
    cp_async_commit();
    const T* st = ring + (size_t)(j % kProjStages) * kProjKC * lay.row;
    const int k0 = j * kProjKC;
    if constexpr (kMma) {
      const T* wsm = reinterpret_cast<const T*>(wbase);
#pragma unroll
      for (int ks = 0; ks < kProjKC / 16; ++ks) {
        unsigned a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4_trans(a[mt], st + (ks * 16 + (q >> 1) * 8 + r8) * lay.row +
                                       (warp * MT + mt) * 16 + (q & 1) * 8);
#pragma unroll
        for (int nt = 0; nt < kMaxOut / 8; ++nt) {
          if (nt < ntiles) {
            const T* wr = wsm + (nt * 8 + g) * lay.w_row + k0 + ks * 16 + 2 * t;
            const unsigned b0 = *reinterpret_cast<const unsigned*>(wr);
            const unsigned b1 = *reinterpret_cast<const unsigned*>(wr + 8);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
          }
        }
      }
    } else {
      const float* wf = reinterpret_cast<const float*>(wbase) + k0 * lay.w_row + o0;
#pragma unroll 4
      for (int k = 0; k < kProjKC; ++k) {
        const float v = to_f(st[k * lay.row + p]);
        const float4* wr = reinterpret_cast<const float4*>(wf + k * lay.w_row);
#pragma unroll
        for (int o4 = 0; o4 < CPG / 4; ++o4) {
          const float4 wv = wr[o4];
          facc[4 * o4] = fmaf(wv.x, v, facc[4 * o4]);
          facc[4 * o4 + 1] = fmaf(wv.y, v, facc[4 * o4 + 1]);
          facc[4 * o4 + 2] = fmaf(wv.z, v, facc[4 * o4 + 2]);
          facc[4 * o4 + 3] = fmaf(wv.w, v, facc[4 * o4 + 3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: the sums through shared memory, then bn, residual and 16-byte
  // stores along pixels
  if constexpr (kMma) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kMaxOut / 8; ++nt) {
        if (nt < ntiles) {
          const int px = (warp * MT + mt) * 16 + g, o = nt * 8 + 2 * t;
          otile[o * lay.out_row + px] = acc[mt][nt][0];
          otile[(o + 1) * lay.out_row + px] = acc[mt][nt][1];
          otile[o * lay.out_row + px + 8] = acc[mt][nt][2];
          otile[(o + 1) * lay.out_row + px + 8] = acc[mt][nt][3];
        }
      }
  } else {
#pragma unroll
    for (int o = 0; o < CPG; ++o) otile[(o0 + o) * lay.out_row + p] = facc[o];
  }
  __syncthreads();
  T* ob = out + (size_t)b * cout * hw;
  const T* rb = res ? res + (size_t)b * cout * hw : nullptr;
  for (int i = tid; i < cout * (TP / V); i += kProjThreads) {
    const int o = i / (TP / V), qq = i - o * (TP / V), px = p0 + qq * V;
    if (px >= hw) continue;
    const float* sv = otile + o * lay.out_row + qq * V;
    float v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = sv[e] * sc[o] + bi[o];
    T* op = ob + (size_t)o * hw + px;
    const T* rp = rb ? rb + (size_t)o * hw + px : nullptr;
    if (vec) {  // hw is a multiple of V: the chunk is whole
      if (rp) {
        alignas(16) T r[V];
        *reinterpret_cast<uint4*>(r) = *reinterpret_cast<const uint4*>(rp);
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] += to_f(r[e]);
      }
      alignas(16) T y[V];
#pragma unroll
      for (int e = 0; e < V; ++e) y[e] = from_f<T>(v[e]);
      *reinterpret_cast<uint4*>(op) = *reinterpret_cast<const uint4*>(y);
    } else {
      for (int e = 0; e < V && px + e < hw; ++e)
        op[e] = from_f<T>(v[e] + (rp ? to_f(rp[e]) : 0.f));
    }
  }
}
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch_dw(const void* x, const void* w, BNParams bn, float eps, void* out,
                      int batch, int channels, int height, int width, int rows, int smem,
                      cudaStream_t stream) {
  const long long planes = (long long)batch * channels;
  const long long per_plane = (long long)((width + 7) / 8) * ((height + rows - 1) / rows);
  const long long blocks = (planes * per_plane + kDwThreads - 1) / kDwThreads;
  // the taps of the most planes a block spans
  const long long need =
      10 * (long long)sizeof(float) * std::min(planes, (kDwThreads - 1) / per_plane + 2);
  if (blocks * kDwThreads > INT32_MAX || smem < need || (size_t)smem > kSmemLimit)
    return cudaErrorInvalidValue;
  auto kern = dw_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int vec = width % 8 == 0 && aligned16(x) && aligned16(out);
  kern<<<(unsigned)blocks, kDwThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bn, eps, static_cast<T*>(out),
      channels, (int)planes, height, width, rows, vec);
  return cudaSuccess;
}

template <typename T, int TP>
cudaError_t launch_project_tile(const void* h, const float* se, const void* w,
                                BNParams bn, const void* res, float eps, void* out,
                                int batch, int cin, int cout, int hw, ProjectSmem lay,
                                cudaStream_t stream) {
  if ((size_t)lay.total > kSmemLimit) return cudaErrorInvalidValue;
  auto kern = project_kernel<T, TP>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err != cudaSuccess) return err;
  const int vec = hw % kVec<T> == 0 && aligned16(h) && aligned16(out) && (!res || aligned16(res));
  const dim3 grid((hw + TP - 1) / TP, batch);
  kern<<<grid, kProjThreads, lay.total, stream>>>(
      static_cast<const T*>(h), se, static_cast<const T*>(w), bn,
      static_cast<const T*>(res), eps, static_cast<T*>(out), cin, cout, hw, vec, lay);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_project(const void* h, const float* se, const void* w,
                           BNParams bn, const void* res, float eps, void* out,
                           int batch, int cin, int cout, int hw, int tile,
                           ProjectSmem lay, cudaStream_t stream) {
  if (tile == 64)
    return launch_project_tile<T, 64>(h, se, w, bn, res, eps, out, batch, cin, cout, hw, lay,
                                      stream);
  if (tile == 128)
    return launch_project_tile<T, 128>(h, se, w, bn, res, eps, out, batch, cin, cout, hw, lay,
                                       stream);
  return cudaErrorInvalidValue;
}

// K5: a block takes a tile of output pixels and CC (32 or 64) expanded
// channels. Its input window is staged as whole 8-pixel chunks of each row:
// columns [gx0 - off, gx0 - off + rw), off = gx0 mod 8, the same for every
// tile since tile_w is a multiple of 8. The expand is the GEMM e (CC x staged
// pixels) = W_e (CC x cin) . x window (cin x staged pixels), K in chunks of
// 32 through a ring of cp.async stages that carry both operands' chunks;
// bfloat16 by mma.m16n8k16 with W_e as A (ldmatrix from [channel][cin] rows)
// and the window as B (ldmatrix.trans from its [cin][pixel] rows); float32
// by FMAs on the CUDA cores (its gate admits no TF32 rounding), each thread
// summing the elements an mma fragment would hold, so both share the
// epilogue. The staged pixels left and right of the window are multiplied
// and dropped. The depthwise is K x K (3 or 5), zero padded by (pad_t,
// pad_l) at the top and left, any pad under K (the bottom and right pads are
// implied by out_h, out_w). Shared memory as mbconv.py's expand_dw_layout
// gives it.
constexpr int kExpKC = 32;     // input channels per pipeline stage
constexpr int kExpStages = 4;  // stages of the cp.async ring, at most
constexpr int kExpNW = 8;      // n-tiles (8 staged pixels) per warp at most
static_assert(kThreads / 8 == kExpKC, "a window chunk row is loaded by 8 threads");

__device__ __forceinline__ void cp_async_wait_upto(int n) {  // n < kExpStages pending
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else if (n == 2)
    cp_async_wait<2>();
  else
    cp_async_wait<3>();
}

// K5's 5x5 depthwise + bn1 + swish on the expanded window `es` ([CC][npix],
// rows of win_w): a thread takes two neighbouring output columns of one
// channel's tile and walks their rows, holding the K x (K + S) window they
// share in registers. Against a column a thread it loads K + S window values
// a row for two outputs, not 2K, reads the taps once for both, and keeps two
// independent sums in flight.
template <typename T, int CC, int K, int S>
__device__ __forceinline__ void depthwise_pairs(const float* es, const float* wdw,
                                                const float* b1, T* ob, int npix, int win_w,
                                                int tile_w_log2, int c0, int mid, int ox0,
                                                int out_w, int out_h, int rows) {
  constexpr int W = K + S;  // window columns of two neighbouring outputs
  const int pairs_log2 = tile_w_log2 - 1;
  for (int q = threadIdx.x; q < CC << pairs_log2; q += kThreads) {
    const int c = q >> pairs_log2, px = (q & ((1 << pairs_log2) - 1)) * 2;
    if (c0 + c >= mid || ox0 + px >= out_w) continue;
    const bool second = ox0 + px + 1 < out_w;
    const float* e = es + c * npix + px * S;
    float wk[K * K];
#pragma unroll
    for (int k = 0; k < K * K; ++k) wk[k] = wdw[c * K * K + k];
    const float bias = b1[c];
    T* o = ob + (size_t)c * out_h * out_w + px;
    float win[K][W];
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < W; ++dx) win[dy][dx] = e[dy * win_w + dx];
    for (int py = 0;;) {
      float d0 = bias, d1 = bias;
#pragma unroll
      for (int dy = 0; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          d0 = fmaf(win[dy][dx], wk[dy * K + dx], d0);
          d1 = fmaf(win[dy][dx + S], wk[dy * K + dx], d1);
        }
      o[(size_t)py * out_w] = from_f<T>(swish_of<T>(d0));
      if (second) o[(size_t)py * out_w + 1] = from_f<T>(swish_of<T>(d1));
      if (++py >= rows) break;
      const float* er = e + (py * S + K - S) * win_w;  // the S new bottom rows
#pragma unroll
      for (int dy = 0; dy + S < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < W; ++dx) win[dy][dx] = win[dy + S][dx];
#pragma unroll
      for (int dy = K - S; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < W; ++dx) win[dy][dx] = er[(dy - K + S) * win_w + dx];
    }
  }
}

template <typename T, int CC, int K>
__global__ void __launch_bounds__(kThreads, 2)
expand_dw_kernel(const T* __restrict__ x, const T* __restrict__ we, BNParams bn0,
                 const T* __restrict__ wd, BNParams bn1, float eps, T* __restrict__ out,
                 int cin, int mid, int height, int width, int out_h, int out_w, int stride,
                 int pad_t, int pad_l, int tile_h, int tile_w_log2, int tiles_x, int vec_x,
                 int vec_w, ExpandSmem lay) {
  constexpr bool kMma = !std::is_same<T, float>::value;
  constexpr int V = kVec<T>;              // elements of T in one 16-byte copy
  constexpr int WM = CC / 32;             // warps along channels, 32 channels each
  constexpr int WN = kThreads / 32 / WM;  // warps along staged pixels
  extern __shared__ float4 smem4[];
  const int tile_w = 1 << tile_w_log2;
  const int win_h = (tile_h - 1) * stride + K, win_w = (tile_w - 1) * stride + K;
  const int npix = win_h * win_w, off = (8 - pad_l % 8) % 8;
  const int rw8 = (off + win_w + 7) / 8, ntot = win_h * rw8;  // staged 8-pixel chunks
  const int nchunks = (cin + kExpKC - 1) / kExpKC, ns = lay.stages;
  char* base = reinterpret_cast<char*>(smem4);
  T* ring = reinterpret_cast<T*>(base);
  float* es = reinterpret_cast<float*>(base);  // [CC][npix], after the products
  float* s0 = reinterpret_cast<float*>(base + lay.c_off);
  float* b0 = s0 + CC;
  float* b1 = b0 + CC;
  float* wdw = b1 + CC;  // [CC][K * K] depthwise * bn1 scale
  // per 8-pixel chunk p of the staged window: its image row and column, its
  // row's start in the window (wy * win_w) and its column in the window
  int4* tab = reinterpret_cast<int4*>(base + lay.t_off);

  const int tid = threadIdx.x;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int c0 = blockIdx.y * CC, b = blockIdx.z;
  const int oy0 = ty * tile_h, ox0 = tx * tile_w;
  const int gy0 = oy0 * stride - pad_t, gx0 = ox0 * stride - pad_l;
  const int ax0 = gx0 - off;  // a multiple of 8
  const size_t plane = (size_t)height * width;
  const T* xb = x + (size_t)b * cin * plane;
  const T zero = from_f<T>(0.f);
  for (int p = tid; p < ntot; p += kThreads) {
    const int wy = p / rw8, cx = p - wy * rw8;
    tab[p] = make_int4(gy0 + wy, ax0 + cx * 8, wy * win_w, cx * 8 - off);
  }
  __syncthreads();

  // chunk `chunk` of the window and of the block's W_e rows into its stage;
  // the window's channel rows 8 threads each, 16 bytes a copy
  auto load = [&](int chunk) {
    T* dst = ring + (size_t)(chunk % ns) * lay.stage;
    const int k0 = chunk * kExpKC, r = tid >> 3, c = k0 + r;
    T* drow = dst + r * lay.x_row;
    const T* xc = xb + c * plane;
    for (int p = tid & 7; p < ntot; p += 8) {
      const int4 e = tab[p];
      T* d = drow + p * 8;
      const bool row_ok = c < cin && e.x >= 0 && e.x < height;
      if (vec_x) {  // width is a multiple of V: a copy is all inside or all outside
#pragma unroll
        for (int v = 0; v < 8; v += V) {
          const bool ok = row_ok && e.y + v >= 0 && e.y + v < width;
          cp_async16(d + v, ok ? xc + (size_t)e.x * width + e.y + v : xb, ok ? 16 : 0);
        }
      } else {
        for (int k = 0; k < 8; ++k) {
          const int gx = e.y + k;
          d[k] = row_ok && gx >= 0 && gx < width ? xc[(size_t)e.x * width + gx] : zero;
        }
      }
    }
    T* dw = dst + kExpKC * lay.x_row;
    for (int i = tid; i < CC * (kExpKC / V); i += kThreads) {
      const int c = i / (kExpKC / V), k = (i - c * (kExpKC / V)) * V;
      const int gc = c0 + c, gk = k0 + k;
      T* d = dw + c * lay.w_row + k;
      if (vec_w) {  // cin is a multiple of V
        const bool ok = gc < mid && gk < cin;
        cp_async16(d, ok ? we + (size_t)gc * cin + gk : we, ok ? 16 : 0);
      } else {
        for (int e = 0; e < V; ++e)
          d[e] = gc < mid && gk + e < cin ? we[(size_t)gc * cin + gk + e] : zero;
      }
    }
  };
  for (int s = 0; s < ns - 1; ++s) {
    load(s);
    cp_async_commit();
  }
  for (int c = tid; c < CC; c += kThreads) {
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
    for (int t = 0; t < K * K; ++t)
      wdw[c * K * K + t] = g < mid ? to_f(wd[g * K * K + t]) * sc1 : 0.f;
  }

  // 1. expand: warp (wm, wn) sums channels [32 wm, 32 wm + 32) for the
  // n-tiles wn, wn + WN, ... of the staged window; element [mt][i][2 hh + e]
  // is channel 32 wm + 16 mt + 8 hh + g at staged pixel 8 n + 2 t + e
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, r8 = lane & 7;
  const int wm = warp / WN, wn = warp - wm * WN;
  float acc[2][kExpNW][4] = {};
  for (int j = 0; j < nchunks; ++j) {
    __syncthreads();  // every warp is done with the stage the next load refills
    if (j + ns - 1 < nchunks) load(j + ns - 1);
    cp_async_commit();
    cp_async_wait_upto(ns - 1);  // chunk j has landed
    __syncthreads();
    const T* st = ring + (size_t)(j % ns) * lay.stage;
    const T* sw = st + kExpKC * lay.x_row;
    if constexpr (kMma) {
      unsigned a[2][2][4];  // [k16 step][m-tile]
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[ks][mt], sw + (wm * 32 + mt * 16 + (q & 1) * 8 + r8) * lay.w_row +
                                     ks * 16 + (q >> 1) * 8);
#pragma unroll
      for (int i = 0; i < kExpNW; ++i) {
        const int n = wn + i * WN;
        if (n < ntot) {
          unsigned bq[4];  // k rows 0-7, 8-15, 16-23, 24-31 of the chunk
          ldmatrix_x4_trans(bq, st + (q * 8 + r8) * lay.x_row + n * 8);
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_bf16(acc[mt][i], a[ks][mt], bq[2 * ks], bq[2 * ks + 1]);
        }
      }
    } else {
      const T* wrow = sw + (wm * 32 + g) * lay.w_row;
#pragma unroll 2
      for (int k = 0; k < kExpKC; ++k) {
        float wv[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) wv[mt][hh] = wrow[(mt * 16 + hh * 8) * lay.w_row + k];
        const T* xr = st + k * lay.x_row + 2 * t;
#pragma unroll
        for (int i = 0; i < kExpNW; ++i) {
          const int n = wn + i * WN;
          if (n < ntot) {
            const float2 xv = *reinterpret_cast<const float2*>(xr + n * 8);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                acc[mt][i][2 * hh] = fmaf(wv[mt][hh], xv.x, acc[mt][i][2 * hh]);
                acc[mt][i][2 * hh + 1] = fmaf(wv[mt][hh], xv.y, acc[mt][i][2 * hh + 1]);
              }
          }
        }
      }
    }
  }
  __syncthreads();

  // bn0 + swish into the float32 expanded window; 0 outside the image (the
  // depthwise pads the EXPANDED map with zeros)
  float sc[2][2], bi[2][2];  // this thread's four channels: [m-tile][row half]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ch = wm * 32 + mt * 16 + hh * 8 + g;
      sc[mt][hh] = s0[ch];
      bi[mt][hh] = b0[ch];
    }
#pragma unroll
  for (int i = 0; i < kExpNW; ++i) {
    const int n = wn + i * WN;
    if (n >= ntot) break;
    const int4 tb = tab[n];
    const bool row_in = tb.x >= 0 && tb.x < height;
    float* er = es + (wm * 32 + g) * npix + tb.z;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int wx = tb.w + 2 * t + e, gx = tb.y + 2 * t + e;
      if (wx < 0 || wx >= win_w) continue;
      const bool inside = row_in && gx >= 0 && gx < width;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          er[(mt * 16 + hh * 8) * npix + wx] =
              inside ? swish_of<T>(acc[mt][i][2 * hh + e] * sc[mt][hh] + bi[mt][hh]) : 0.f;
    }
  }
  __syncthreads();

  // 2. depthwise KxK + bn1 + swish
  T* ob = out + ((size_t)b * mid + c0) * out_h * out_w + (size_t)oy0 * out_w + ox0;
  const int rows = out_h - oy0 < tile_h ? out_h - oy0 : tile_h;
  if constexpr (K == 3) {
    // each thread walks the rows of a column of one channel's tile, keeping
    // the window rows it shares with the next output row in registers
    // (stride 1: two of three, stride 2: one)
    for (int q = tid; q < CC * tile_w; q += kThreads) {
      const int c = q >> tile_w_log2, px = q & (tile_w - 1);
      if (c0 + c >= mid || ox0 + px >= out_w) continue;
      const float* e = es + c * npix + px * stride;
      float wk[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) wk[k] = wdw[c * 9 + k];
      const float bias = b1[c];
      T* o = ob + (size_t)c * out_h * out_w + px;
      float win[3][3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) win[dy][dx] = e[dy * win_w + dx];
      for (int py = 0;;) {
        float d = bias;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) d = fmaf(win[dy][dx], wk[dy * 3 + dx], d);
        o[(size_t)py * out_w] = from_f<T>(swish_of<T>(d));
        if (++py >= rows) break;
        const float* er = e + (py * stride + 2) * win_w;  // the new bottom row
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          if (stride == 1) {
            win[0][dx] = win[1][dx];
            win[1][dx] = win[2][dx];
          } else {
            win[0][dx] = win[2][dx];
            win[1][dx] = er[dx - win_w];
          }
          win[2][dx] = er[dx];
        }
      }
    }
  } else if (stride == 1) {
    depthwise_pairs<T, CC, K, 1>(es, wdw, b1, ob, npix, win_w, tile_w_log2, c0, mid, ox0, out_w,
                                 out_h, rows);
  } else {
    depthwise_pairs<T, CC, K, 2>(es, wdw, b1, ob, npix, win_w, tile_w_log2, c0, mid, ox0, out_w,
                                 out_h, rows);
  }
}

template <typename T, int CC, int K>
cudaError_t launch_expand_dw(const void* x, const void* we, BNParams bn0, const void* wd,
                             BNParams bn1, float eps, void* out, int batch, int cin, int mid,
                             int height, int width, int out_h, int out_w, int stride,
                             int pad_t, int pad_l, int tile_h, int tile_w, ExpandSmem lay,
                             cudaStream_t stream) {
  constexpr int WN = kThreads / 32 / (CC / 32);
  int log2w = 3;
  while ((1 << log2w) < tile_w) ++log2w;
  const int win_w = (tile_w - 1) * stride + K, off = (8 - pad_l % 8) % 8;
  const int staged8 = ((tile_h - 1) * stride + K) * ((off + win_w + 7) / 8);
  if ((1 << log2w) != tile_w || log2w > 5 || staged8 > kExpNW * WN ||
      lay.x_row < 8 * staged8 || lay.stages < 1 || lay.stages > kExpStages ||
      (size_t)lay.total > kSmemLimit || pad_t < 0 || pad_t >= K || pad_l < 0 || pad_l >= K)
    return cudaErrorInvalidValue;
  auto kern = expand_dw_kernel<T, CC, K>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err != cudaSuccess) return err;
  const int tiles_y = (out_h + tile_h - 1) / tile_h, tiles_x = (out_w + tile_w - 1) / tile_w;
  const dim3 grid(tiles_y * tiles_x, (mid + CC - 1) / CC, batch);
  const int vec_x = width % kVec<T> == 0 && aligned16(x);
  const int vec_w = cin % kVec<T> == 0 && aligned16(we);
  kern<<<grid, kThreads, lay.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(we), bn0, static_cast<const T*>(wd), bn1,
      eps, static_cast<T*>(out), cin, mid, height, width, out_h, out_w, stride, pad_t, pad_l,
      tile_h, log2w, tiles_x, vec_x, vec_w, lay);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_expand_dw_cc(int kernel, int channels, const void* x, const void* we,
                                BNParams bn0, const void* wd, BNParams bn1, float eps,
                                void* out, int batch, int cin, int mid, int height, int width,
                                int out_h, int out_w, int stride, int pad_t, int pad_l,
                                int tile_h, int tile_w, ExpandSmem lay, cudaStream_t stream) {
  if ((channels != 32 && channels != 64) || (kernel != 3 && kernel != 5))
    return cudaErrorInvalidValue;
  auto launch = kernel == 3 ? (channels == 64 ? launch_expand_dw<T, 64, 3>
                                              : launch_expand_dw<T, 32, 3>)
                            : (channels == 64 ? launch_expand_dw<T, 64, 5>
                                              : launch_expand_dw<T, 32, 5>);
  return launch(x, we, bn0, wd, bn1, eps, out, batch, cin, mid, height, width, out_h, out_w,
                stride, pad_t, pad_l, tile_h, tile_w, lay, stream);
}

}  // namespace

cudaError_t launch_mbconv_expand_dw(DType dt, const void* x, const void* w_expand,
                                    BNParams bn0, const void* w_dw, BNParams bn1,
                                    float eps, void* out, int batch, int cin,
                                    int mid, int height, int width, int out_h,
                                    int out_w, int kernel, int stride, int pad_t, int pad_l,
                                    int tile_h, int tile_w, int channels,
                                    ExpandSmem smem, cudaStream_t stream) {
  if (stride < 1 || stride > 2 || tile_h < 1 || tile_w < 1 || batch > 65535 ||
      (mid + 31) / 32 > 65535)
    return cudaErrorInvalidValue;
  return (dt == DType::kFloat32 ? launch_expand_dw_cc<float>
                                : launch_expand_dw_cc<__nv_bfloat16>)(
      kernel, channels, x, w_expand, bn0, w_dw, bn1, eps, out, batch, cin, mid, height, width,
      out_h, out_w, stride, pad_t, pad_l, tile_h, tile_w, smem, stream);
}

cudaError_t launch_mbconv_dw(DType dt, const void* x, const void* w, BNParams bn, float eps,
                             void* out, int batch, int channels, int height, int width,
                             int rows, int smem, cudaStream_t stream) {
  if (rows < 1 || height < 1 || width < 1 || channels < 1 || batch < 1)
    return cudaErrorInvalidValue;
  return (dt == DType::kFloat32 ? launch_dw<float> : launch_dw<__nv_bfloat16>)(
      x, w, bn, eps, out, batch, channels, height, width, rows, smem, stream);
}

cudaError_t launch_mbconv_project(DType dt, const void* h, const float* se,
                                  const void* w, BNParams bn,
                                  const void* residual, float eps, void* out,
                                  int batch, int cin, int cout, int hw, int tile,
                                  ProjectSmem smem, cudaStream_t stream) {
  if (cout > kMaxOut || batch > 65535) return cudaErrorInvalidValue;
  if (dt == DType::kFloat32)
    return launch_project<float>(h, se, w, bn, residual, eps, out, batch, cin,
                                 cout, hw, tile, smem, stream);
  return launch_project<__nv_bfloat16>(h, se, w, bn, residual, eps, out, batch,
                                       cin, cout, hw, tile, smem, stream);
}

}  // namespace hyperseg
