// K6: integer-scale bilinear upsample, NCHW.
//
// Replaces hyperseg_tpu/ops/pallas/resize.py:152 (resize_bilinear_kernel,
// its _forward at :120). out[b, c, oy, ox] for a scale s in {2, 3, 4} on both
// axes, half-pixel centres and edge clamp (align_corners=False):
//   src = clamp((o + 0.5) / s - 0.5, 0, n - 1), lo = floor(src),
//   hi = min(lo + 1, n - 1), frac = src - lo.
// In integers src = (2o + 1 - s) / (2s), so frac is the exact fraction
// r / (2s) (0.25 / 0.75 at s = 2).
//
// Bound: bytes (about 4 MACs per output element). The kernel it replaces
// here read four scalar taps and made a 2-byte store per output, a block an
// output row, each input row read again by s blocks. Now a thread owns a
// strip of 8 input columns of one plane, [x0, x0 + 8), which feed exactly
// the 8s outputs [s x0, s x0 + 8s) of each output row: s whole vectors of 8,
// whatever s. Output m of the strip lies between its inputs
// lo = floor((2m + 1 - s) / 2s) and lo + 1 (-1 and 8 are the halo columns),
// at frac = (2m + 1 - s - 2s lo) / 2s: both fixed by m and s alone, so every
// tap is a compile-time constant. The thread walks `rows` input rows down
// the strip with a window of three rows in registers (one 16-byte load per
// row in bfloat16, two in float32, issued a row ahead; halo columns from the
// neighbouring lanes), and each input row r gives the s output rows s r ..
// s r + s - 1, each blended from rows (r - 1, r) or (r, r + 1) by a constant,
// then s 16-byte stores a row (2s in float32). The edge clamp is a
// replicated halo: row -1 is row 0, column n is column n - 1. Units (plane,
// band of rows, strip) are numbered strip fastest, kThreads to a block, so a
// block spans several planes where planes are small; the band comes from
// resize.py's resize_plan. vec = 0 (a width not a multiple of 8, or a
// pointer off 16 bytes): element loads and stores in the same kernel.
// Nothing of the TPU kernel's banded one-hot matrices is carried over.
#include <cstdint>

#include "common.cuh"
#include "kernels.h"

namespace hyperseg {
namespace {

constexpr int kThreads = 256;

__host__ __device__ constexpr int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}
// Output m of an S-times upsampled strip lies between its inputs lo and
// lo + 1 (strip-local, -1 .. 8) at frac.
template <int S>
__host__ __device__ constexpr int tap_lo(int m) {
  return floor_div(2 * m + 1 - S, 2 * S);
}
template <int S>
__host__ __device__ constexpr float tap_frac(int m) {
  return (float)(2 * m + 1 - S - 2 * S * tap_lo<S>(m)) / (float)(2 * S);
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
resize_kernel(const T* __restrict__ x, T* __restrict__ out, int planes, int height, int width,
              int rows, int vec) {
  const int strips = (width + 7) >> 3, bands = (height + rows - 1) / rows;
  const long long per_plane = (long long)strips * bands, total = planes * per_plane;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  // the grid's lanes past the last unit repeat it (they take part in the
  // shuffles) and store nothing
  const bool active = g < total;
  const long long u = min(g, total - 1);
  const int plane = (int)(u / per_plane), rem = (int)(u - plane * per_plane);
  const int band = rem / strips, x0 = (rem - band * strips) * 8, y0 = band * rows;
  const int ow = width * S;
  const T* xp = x + (size_t)plane * height * width;
  T* op = out + (size_t)plane * height * S * ow;
  const int lane = threadIdx.x & 31;
  const bool own_left = !vec || lane == 0, own_right = !vec || lane == 31;
  const bool first_strip = x0 == 0, last_strip = x0 + 8 >= width;

  // row iy of the strip, clamped into the plane, columns past the row's end
  // clamped to it, and the halo columns this lane loads itself
  auto fetch = [&](int iy, Pack8<T>& p, float& l, float& r) {
    const T* src = xp + (size_t)min(max(iy, 0), height - 1) * width;
    if (vec) {
      load_pack8(p, src + x0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) p.e[j] = src[min(x0 + j, width - 1)];
    }
    l = own_left ? to_f(src[max(x0 - 1, 0)]) : 0.f;
    r = own_right ? to_f(src[min(x0 + 8, width - 1)]) : 0.f;
  };

  float win[3][10];  // input rows r - 1, r, r + 1; columns x0 - 1 .. x0 + 8
  Pack8<T> next;
  float next_l, next_r;
  fetch(y0 - 1, next, next_l, next_r);
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
    strip_row<true>(win[2], cur, cur_l, cur_r, own_left, own_right, first_strip, last_strip);
    const int r = y0 + i - 2;
    if (i < 2 || !active || r >= height) continue;
#pragma unroll
    for (int my = 0; my < S; ++my) {
      // output row S r + my: rows (r - 1, r) or (r, r + 1), blended down the
      // strip's 10 columns, then across
      const int lo = tap_lo<S>(my);
      const float fy = tap_frac<S>(my);
      float col[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        const float a = win[lo + 1][k], b = win[lo + 2][k];
        col[k] = fmaf(fy, b - a, a);
      }
      T* dst = op + (size_t)(S * r + my) * ow + S * x0;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int m = 8 * q + j, lx = tap_lo<S>(m);
          o[j] = fmaf(tap_frac<S>(m), col[lx + 2] - col[lx + 1], col[lx + 1]);
        }
        if (vec) {
          store8(dst + 8 * q, o);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (S * x0 + 8 * q + j < ow) dst[8 * q + j] = from_f<T>(o[j]);
        }
      }
    }
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int S>
void launch(const void* x, void* out, int planes, int height, int width, int rows,
            unsigned blocks, cudaStream_t stream) {
  const int vec = width % 8 == 0 && aligned16(x) && aligned16(out);
  resize_kernel<T, S><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), planes, height, width, rows, vec);
}

template <typename T>
void launch_scale(const void* x, void* out, int planes, int height, int width, int scale,
                  int rows, unsigned blocks, cudaStream_t stream) {
  if (scale == 2)
    launch<T, 2>(x, out, planes, height, width, rows, blocks, stream);
  else if (scale == 3)
    launch<T, 3>(x, out, planes, height, width, rows, blocks, stream);
  else
    launch<T, 4>(x, out, planes, height, width, rows, blocks, stream);
}

}  // namespace

cudaError_t launch_resize_bilinear(DType dt, const void* x, void* out, int planes, int height,
                                   int width, int scale, int rows, cudaStream_t stream) {
  if (scale < 2 || scale > 4 || rows < 1 || planes < 1 || height < 1 || width < 1)
    return cudaErrorInvalidValue;
  const long long units = (long long)planes * ((width + 7) / 8) * ((height + rows - 1) / rows);
  const long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  (dt == DType::kFloat32 ? launch_scale<float> : launch_scale<__nv_bfloat16>)(
      x, out, planes, height, width, scale, rows, (unsigned)blocks, stream);
  return cudaSuccess;
}

}  // namespace hyperseg
