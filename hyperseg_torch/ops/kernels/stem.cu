// K3: EfficientNet stem, 3x3/s2 conv + eval BN + swish (or the raw conv), NCHW
// in and out.
//
// Replaces hyperseg_tpu/ops/pallas/stem.py:209 (stem_conv_bn_swish), and its
// act=None form, the forward of stem_conv (stem.py:173). TF-SAME padding
// (0, 1) on each axis: rows/cols past the bottom/right edge read as zero,
// nothing is padded above or left.
//
// Bound: bytes (27 * cout MACs per output pixel on 27 inputs; the output is
// about three quarters of the bytes). A block takes a tile of `rows` output
// rows by `cols` output columns of one image (stem.py's stem_plan) and all
// channels. It stages its input band, 3 channels x (2 rows + 1) input rows
// x the 2 cols + 1 input columns the tile reads, into shared memory by
// 16-byte cp.async (zero past the image's edges; element copies where rows
// are not whole 16-byte words), so each input element leaves HBM once.
// While the copies fly, it computes the BN scale and bias of its cout
// channels once, in float32. Then:
//  - bfloat16, on the tensor cores: mma.m16n8k16 with the channels on M and
//    8 pixels of one output row on N; K is the 27 taps (c, dy, dx), zero-
//    padded to 32 in both operands. The raw filter is the A operand, loaded
//    into registers while the band is in flight and held for the whole
//    block; each lane gathers its B fragment (pixel g's taps 2t, 2t+1, 2t+8,
//    2t+9 of each k-step) from the staged band at offsets fixed per lane.
//    Row and channel pitches (stem_layout) make those gathers free of bank
//    conflicts. A warp takes two n-tiles (16 pixels of a row) at a time: BN
//    on the float32 sums, swish, then a quad's words are transposed by
//    shuffles so that each lane stores 8 pixels of one channel as one
//    16-byte word and a quad writes 32 whole bytes of two channels (4-byte
//    stores of each lane's own pairs, the first design, were 1.6x slower
//    at batch 8); element stores where W' is not a multiple of 8.
//  - float32, on the CUDA cores (TF32 would miss float32's tolerance): a
//    thread takes a strip of 8 output columns, holds the 3 x 3 x 17 inputs
//    it reads in registers, and loops over the channels, reading their
//    taps as warp-broadcast float4 (each read serves 8 pixels) and storing
//    16 bytes at a time. The float32 band keeps 4 pad floats after every 16
//    columns, so a warp's float4 reads of neighbouring strips hit distinct
//    banks.
// The products use the weights as the tensor holds them and BN goes on the
// float32 sums: the same arithmetic as the plain twin up to the order of
// the sums.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "kernels.h"

namespace hyperseg {
namespace {

constexpr int kTaps = 27;       // (c, dy, dx) of 3 channels and a 3x3 window
constexpr int kWTaps = 28;      // float32 taps of a channel in shared memory, one pad
constexpr int kThreads = 128;   // four warps
constexpr size_t kSmemLimit = 232448;

// Shared-memory index of staged column x of a row: bfloat16 as is; float32
// with 4 pad floats after every 16 columns.
template <typename T>
__device__ __forceinline__ int scol(int x) {
  if constexpr (std::is_same<T, float>::value)
    return x + 4 * (x >> 4);
  else
    return x;
}

template <bool Swish, typename T>
__device__ __forceinline__ float act(float v) {
  if constexpr (Swish)
    return swish_of<T>(v);
  else
    return v;
}

// 1. The band: rows 2 oy0 .. 2 oy0 + 2 rows of each channel, columns 2 ox0 ..
// 2 ox0 + V * chunks - 1, zero outside the image.
template <typename T>
__device__ __forceinline__ void stage_band(T* band, const T* xb, int height, int width,
                                           int iy0, int ix0, int brows, int vec,
                                           const StemSmem& lay) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = lay.chunks, n = 3 * brows * per_row;
  if (vec) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int row = i / per_row, j = i - row * per_row;
      const int c = row / brows, r = row - c * brows;
      const int iy = iy0 + r, ix = ix0 + j * V;
      const bool in = iy < height && ix < width;  // width % V == 0: whole chunks
      const T* src = in ? xb + ((size_t)c * height + iy) * width + ix : xb;
      cp_async16(band + c * lay.chan + r * lay.row + scol<T>(j * V), src, in ? 16 : 0);
    }
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < n * V; i += kThreads) {
      const int row = i / (per_row * V), j = i - row * (per_row * V);
      const int c = row / brows, r = row - c * brows;
      const int iy = iy0 + r, ix = ix0 + j;
      band[c * lay.chan + r * lay.row + scol<T>(j)] =
          iy < height && ix < width ? xb[((size_t)c * height + iy) * width + ix]
                                    : from_f<T>(0.f);
    }
  }
}

__device__ __forceinline__ unsigned short bits_at(const __nv_bfloat16* p, int i) {
  return reinterpret_cast<const unsigned short*>(p)[i];
}

// 2a. bfloat16: MT m-tiles of 16 channels. The A fragments of the raw
// filter: row o = m * 16 + g (+ 8), columns k = ks * 16 + 2t (+ 1) (+ 8),
// zero past cout and past tap 26. Loaded while the band is in flight.
template <int MT>
__device__ __forceinline__ void load_a(unsigned (&a)[MT][2][4], const __nv_bfloat16* w,
                                       int cout) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = m * 16 + g + (q & 1) * 8, k = ks * 16 + 2 * t + (q >> 1) * 8;
        const unsigned lo = o < cout && k < kTaps ? bits_at(w, o * kTaps + k) : 0u;
        const unsigned hi = o < cout && k + 1 < kTaps ? bits_at(w, o * kTaps + k + 1) : 0u;
        a[m][ks][q] = lo | (hi << 16);
      }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// Warps take the tile's pairs of n-tiles (16 pixels of one output row) in
// turn. store16: a quad's 4 x 4 words transposed by shuffles so each lane
// stores 8 pixels of one channel as one 16-byte word (a quad's 4 lanes: 32
// whole bytes of channel g and of g + 8); else element stores.
template <int MT, bool Swish>
__device__ __forceinline__ void stem_mma(const unsigned (&a)[MT][2][4],
                                         const __nv_bfloat16* band, const float* scale,
                                         const float* bias, __nv_bfloat16* ob, int cout, int ho,
                                         int wo, int oy0, int ox0, int rows, int cols,
                                         int store16, const StemSmem& lay) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // B: this lane's taps, as offsets into the band from pixel g's corner
  int off[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = (j >> 2) * 16 + ((j >> 1) & 1) * 8 + 2 * t + (j & 1);
    const int kk = k < kTaps ? k : 0;  // a pad tap: any staged element, zeroed below
    off[j] = (kk / 9) * lay.chan + (kk % 9 / 3) * lay.row + kk % 3 + 2 * g;
  }
  const bool pad_lo = 24 + 2 * t >= kTaps, pad_hi = 25 + 2 * t >= kTaps;
  float sc[MT][2], bi[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = min(m * 16 + g + h * 8, cout - 1);
      sc[m][h] = scale[o];
      bi[m][h] = bias[o];
    }

  const int per_row = cols >> 4, npairs = rows * per_row;
  const size_t plane = (size_t)ho * wo;
#pragma unroll 1
  for (int p = warp; p < npairs; p += kThreads / 32) {
    const int r = p / per_row, col = (p - r * per_row) * 16;
    const int oy = oy0 + r, ox = ox0 + col;
    if (oy >= ho || ox >= wo) continue;
    float v[2][MT][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int pb = r * 2 * lay.row + 2 * (col + 8 * n);
      unsigned b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned lo = bits_at(band, pb + off[2 * q]);
        const unsigned hi = bits_at(band, pb + off[2 * q + 1]);
        b[q] = lo | (hi << 16);
      }
      if (pad_lo) b[3] &= 0xffff0000u;
      if (pad_hi) b[3] &= 0x0000ffffu;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(acc, a[m][0], b[0], b[1]);
        mma_bf16(acc, a[m][1], b[2], b[3]);
        // acc 0, 1: channel m * 16 + g, pixels 2t, 2t + 1 of n-tile n; 2, 3: channel + 8
#pragma unroll
        for (int q = 0; q < 4; ++q)  // rows past cout (uniform across the warp): no swish
          v[n][m][q] = m * 16 + (q >> 1) * 8 < cout
                           ? act<Swish, __nv_bfloat16>(acc[q] * sc[m][q >> 1] + bi[m][q >> 1])
                           : 0.f;
      }
    }
    if (store16) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        // x[q]: this lane's word of quarter q (q & 1: n-tile, q >> 1: channel
        // g or g + 8); after the transpose lane t holds quarter t, words 0-3
        unsigned x[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          x[q] = pack_bf16(v[q & 1][m][2 * (q >> 1)], v[q & 1][m][2 * (q >> 1) + 1]);
        const bool up = t & 2, odd = t & 1;
        const unsigned r0 = __shfl_xor_sync(0xffffffffu, up ? x[0] : x[2], 2);
        const unsigned r1 = __shfl_xor_sync(0xffffffffu, up ? x[1] : x[3], 2);
        // w[i][k]: quarter (t & 2) + i, word (t & 1) + 2k
        const unsigned w00 = up ? r0 : x[0], w01 = up ? x[2] : r0;
        const unsigned w10 = up ? r1 : x[1], w11 = up ? x[3] : r1;
        const unsigned own0 = odd ? w10 : w00, own1 = odd ? w11 : w01;
        const unsigned s0 = __shfl_xor_sync(0xffffffffu, odd ? w00 : w10, 1);
        const unsigned s1 = __shfl_xor_sync(0xffffffffu, odd ? w01 : w11, 1);
        const uint4 y = odd ? make_uint4(s0, own0, s1, own1) : make_uint4(own0, s0, own1, s1);
        const int o = m * 16 + g + 8 * (t >> 1), px = ox + 8 * (t & 1);
        if (o < cout && px < wo)  // wo % 8 == 0: all 8 pixels
          *reinterpret_cast<uint4*>(ob + o * plane + (size_t)oy * wo + px) = y;
      }
    } else {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int o = m * 16 + g + (q >> 1) * 8, px = ox + 8 * n + 2 * t + (q & 1);
            if (o < cout && px < wo)
              ob[o * plane + (size_t)oy * wo + px] = __float2bfloat16(v[n][m][q]);
          }
    }
  }
}

// 2b. float32: a thread takes a strip of 8 output columns of one row.
template <bool Swish>
__device__ __forceinline__ void stem_fma(const float* band, const float* wsm,
                                         const float* scale, const float* bias, float* ob,
                                         int cout, int ho, int wo, int oy0, int ox0, int rows,
                                         int cols, int store16, const StemSmem& lay) {
  const int strips = cols >> 3, units = rows * strips;
  const size_t plane = (size_t)ho * wo;
#pragma unroll 1
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int r = u / strips, s = u - r * strips;
    const int oy = oy0 + r, ox = ox0 + 8 * s;
    if (oy >= ho || ox >= wo) continue;
    // input columns 16 s .. 16 s + 16 of rows 2r .. 2r + 2 of each channel
    float in[3][3][17];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* src = band + c * lay.chan + (2 * r + dy) * lay.row + 20 * s;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(src)[q];
          in[c][dy][4 * q] = v.x;
          in[c][dy][4 * q + 1] = v.y;
          in[c][dy][4 * q + 2] = v.z;
          in[c][dy][4 * q + 3] = v.w;
        }
        in[c][dy][16] = src[20];
      }
    float* dst = ob + (size_t)oy * wo + ox;
    const bool whole = store16 && ox + 8 <= wo;
#pragma unroll 1
    for (int o = 0; o < cout; ++o) {
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      const float4* wq = reinterpret_cast<const float4*>(wsm + o * kWTaps);
#pragma unroll
      for (int q = 0; q < kWTaps / 4; ++q) {
        const float4 wv = wq[q];
        const float wk[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * q + e;
          if (k >= kTaps) continue;
          const int c = k / 9, dy = k % 9 / 3, dx = k % 3;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] = fmaf(wk[e], in[c][dy][2 * j + dx], acc[j]);
        }
      }
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = act<Swish, float>(acc[j] * scale[o] + bias[o]);
      float* d = dst + o * plane;
      if (whole) {
        reinterpret_cast<float4*>(d)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(d)[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (ox + j < wo) d[j] = v[j];
      }
    }
  }
}

// One block: a tile of `rows` x `cols` output pixels of image blockIdx.y,
// every channel. bn.w null: the identity BN (the raw conv).
// Blocks an SM holds at least, by m-tiles: up to three m-tiles the
// registers are capped at 102 a thread (no spill), five blocks an SM, which
// measured faster than the four that 128 registers allow.
template <int MT>
constexpr int kMinBlocks = MT >= 1 && MT <= 3 ? 5 : 1;

template <typename T, int MT, bool Swish>
__global__ void __launch_bounds__(kThreads, kMinBlocks<MT>)
stem_kernel(const T* __restrict__ x, const T* __restrict__ w, BNParams bn, float eps,
            T* __restrict__ out, int height, int width, int ho, int wo, int cout, int rows,
            int cols, int vec, int store16, StemSmem lay) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  T* band = reinterpret_cast<T*>(base);
  float* scale = reinterpret_cast<float*>(base + lay.bn_off);
  float* bias = scale + cout;
  float* wsm = reinterpret_cast<float*>(base + lay.w_off);  // float32 only

  const int tiles_x = (wo + cols - 1) / cols;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int oy0 = ty * rows, ox0 = tx * cols, b = blockIdx.y;
  stage_band(band, x + (size_t)b * 3 * height * width, height, width, 2 * oy0, 2 * ox0,
             2 * rows + 1, vec, lay);
  // while the band is in flight: BN once for the block's cout channels (and
  // the float32 taps)
  for (int o = threadIdx.x; o < cout; o += kThreads) {
    const float s = bn.w ? bn_scale(bn.w, bn.v, o, eps) : 1.f;
    scale[o] = s;
    bias[o] = bn.w ? bn.b[o] - bn.m[o] * s : 0.f;
  }
  if constexpr (std::is_same<T, float>::value) {
    for (int i = threadIdx.x; i < cout * kWTaps; i += kThreads) {
      const int o = i / kWTaps, k = i - o * kWTaps;
      wsm[i] = k < kTaps ? w[o * kTaps + k] : 0.f;
    }
  }
  T* ob = out + (size_t)b * cout * ho * wo;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) cp_async_wait<0>();
    __syncthreads();
    stem_fma<Swish>(band, wsm, scale, bias, ob, cout, ho, wo, oy0, ox0, rows, cols, store16, lay);
  } else {
    unsigned a[MT][2][4];
    load_a<MT>(a, w, cout);
    if (vec) cp_async_wait<0>();
    __syncthreads();
    stem_mma<MT, Swish>(a, band, scale, bias, ob, cout, ho, wo, oy0, ox0, rows, cols, store16,
                        lay);
  }
}

inline bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename T, int MT, bool Swish>
cudaError_t launch(const void* x, const void* w, BNParams bn, float eps, void* out, int batch,
                   int height, int width, int cout, int rows, int cols, StemSmem lay,
                   cudaStream_t stream) {
  if ((size_t)lay.total > kSmemLimit || rows < 1 || cols < 16 || cols % 16)
    return cudaErrorInvalidValue;
  auto kern = stem_kernel<T, MT, Swish>;
  if (lay.total > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (err != cudaSuccess) return err;
  }
  const int ho = (height - 2) / 2 + 1, wo = (width - 2) / 2 + 1;
  const dim3 grid(((ho + rows - 1) / rows) * ((wo + cols - 1) / cols), batch);
  const int vec = width % (16 / (int)sizeof(T)) == 0 && aligned(x, 16);
  const int store16 = wo % (16 / (int)sizeof(T)) == 0 && aligned(out, 16);
  kern<<<grid, kThreads, lay.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bn, eps, static_cast<T*>(out), height,
      width, ho, wo, cout, rows, cols, vec, store16, lay);
  return cudaSuccess;
}

template <bool Swish>
cudaError_t launch_act(DType dt, const void* x, const void* w, BNParams bn, float eps, void* out,
                       int batch, int height, int width, int cout, int rows, int cols,
                       StemSmem lay, cudaStream_t stream) {
  if (dt == DType::kFloat32)
    return launch<float, 0, Swish>(x, w, bn, eps, out, batch, height, width, cout, rows, cols,
                                   lay, stream);
  switch ((cout + 15) / 16) {
    case 1:
      return launch<__nv_bfloat16, 1, Swish>(x, w, bn, eps, out, batch, height, width, cout,
                                             rows, cols, lay, stream);
    case 2:
      return launch<__nv_bfloat16, 2, Swish>(x, w, bn, eps, out, batch, height, width, cout,
                                             rows, cols, lay, stream);
    case 3:
      return launch<__nv_bfloat16, 3, Swish>(x, w, bn, eps, out, batch, height, width, cout,
                                             rows, cols, lay, stream);
    case 4:
      return launch<__nv_bfloat16, 4, Swish>(x, w, bn, eps, out, batch, height, width, cout,
                                             rows, cols, lay, stream);
    case 5:
      return launch<__nv_bfloat16, 5, Swish>(x, w, bn, eps, out, batch, height, width, cout,
                                             rows, cols, lay, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_stem(DType dt, const void* x, const void* w, BNParams bn, float eps,
                        bool swish, void* out, int batch, int height, int width, int cout,
                        int rows, int cols, StemSmem lay, cudaStream_t stream) {
  if (cout < 1 || cout > kStemMaxOut) return cudaErrorInvalidValue;
  return swish ? launch_act<true>(dt, x, w, bn, eps, out, batch, height, width, cout, rows,
                                  cols, lay, stream)
               : launch_act<false>(dt, x, w, bn, eps, out, batch, height, width, cout, rows,
                                   cols, lay, stream);
}

}  // namespace hyperseg
