// K1: signal2weights + patch-wise hyper inverted residual, NCHW.
//
// Replaces hyperseg_tpu/ops/pallas/patch_invres.py:488
// (patch_inverted_residual_s2w_fused) as two launches:
//   1. s2w_generate_kernel: the weight map (B, fh, fw, P), float32, from the
//      routed signal slice and the grouped signal2weights weight (n_out,
//      sig/groups): per weight group g one GEMM, (patches x fan_in) .
//      (fan_in x n_out/groups), clipped to P. A block takes 64 patches and 64
//      outputs of one group, so each tile of the weight is read once per 64
//      patches, not once per patch; bfloat16 by mma.m16n8k16 (float32 sums),
//      float32 by FMAs. Bound: bytes (the map it writes).
//   2. invres_unit_kernel (K2's, below) on that map. The map stays float32 so
//      that each weight is rounded once, after the BN scale is folded in.
//
// K2: the same unit from given per-patch weights, NCHW.
//
// Replaces hyperseg_tpu/ops/pallas/patch_invres.py:870
// (patch_inverted_residual_fused). w is (B, fh, fw, P), float32 or x's type,
// each patch's P weights contiguous in the reference order w1 (hidden, cin) |
// w2 (hidden, 3, 3) | w3 (out_ch, hidden). One block of 256 threads per
// (band of `band` rows of a patch, b). The block
//   - stages the patch's columns of its band+2 window rows with cp.async as
//     whole 8-pixel chunks from the column rounded down to 8 (the window of
//     a patch is not 16-byte aligned; a chunk at the image's edge is filled
//     element by element), and the window's first and last columns (the
//     neighbours' pixels inside the map, reflected only at the image border)
//     packed 8 to a chunk by plain loads, kHalo in flight a thread, while
//     the copies fly;
//   - folds the three eval BNs into the patch's weights in float32 and, in
//     bfloat16, rounds each product once;
//   - expands every staged pixel: the GEMM (staged pixels x cin) . (cin x
//     hidden), K padded to 16 and N to 16 with zeros, bfloat16 by
//     mma.m16n8k16 (float32 sums); relu6(+ b1) of the window's pixels goes to
//     a float32 hidden map [window pixel][hidden] that stays whole in shared
//     memory (a bfloat16 map, rounded before the depthwise, fails the
//     bfloat16 gate under calibrated BN); the staged pixels beside the window
//     are multiplied and dropped;
//   - runs the depthwise 3x3 on the CUDA cores in float32 from channel pairs,
//     + b2, relu6, rounded as the project's A tile [pixel][hidden];
//   - projects by a second GEMM against w3 (N = out_ch padded to 8, at most
//     32), adds b3 (+ x when cin == out_ch) and stores 16 bytes a thread
//     along the rows through a float32 tile in shared memory.
// The float32 kernel runs the same stages with FMAs on the elements an mma
// fragment would hold (no TF32). Bound: bytes in bfloat16 (x, the map and out
// once); the products run on the tensor cores. patch_invres.py's unit_plan
// picks the band and lays out shared memory (InvresSmem in kernels.h).
//
// K7: the v0_1 inverted residual from given per-patch weights, NCHW.
//
// Replaces hyperseg_tpu/ops/pallas/patch_invres.py:784
// (patch_inverted_residual_v01). One thread block per (band of rows of a
// patch, b), float32 products on the CUDA cores (`Unit` below): the block
// loads its (band+2) x (pw+2) haloed input rows and its patch's weights, BN
// scales folded in, expands the band and its halo rows into shared memory,
// and runs depthwise + project with each thread looping over output pixels,
// out_ch sums in registers. v0_1 folds each stage back to the full map, so a
// halo pixel of the hidden map is its owner patch's expand, made with the
// owner's w1 (the neighbour above, below, beside, or diagonal), not this
// patch's. The block keeps only its own patch's weights in shared memory; a
// halo pixel owned by another patch reads that patch's w1 rows from the
// weight map in device memory (a level's map is a few MB, resident in the 50
// MB L2), applies bn1's scale after the sum, and lands in the same hidden
// tile. A reflected pixel at the image border is owned by the patch it
// reflects into. The map may be the first P entries of wider rows
// (`wstride`), as the v0_1 weight mapper's heads leave it.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "kernels.h"

namespace hyperseg {
namespace {

constexpr int kMaxOut = 32;  // output channels held per pixel
constexpr int kHT = 8;       // K7: hidden channels per thread in the expand stage
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory one block may use

// Two adjacent float32 elements, 8-byte aligned.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// relu6 of (a, b), stored as two adjacent elements; in bfloat16 clamped
// after rounding (the same values: rounding is monotone and 0 and 6 are
// bfloat16 numbers), two packed instructions for the pair.
__device__ __forceinline__ void store2_relu6(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(relu6(a), relu6(b));
}
__device__ __forceinline__ void store2_relu6(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __hmin2(__hmax2(__floats2bfloat162_rn(a, b), __float2bfloat162_rn(0.f)),
              __float2bfloat162_rn(6.f));
}

// Reflect index i in [-1, n] into [0, n) (n >= 2), like torch reflect pad.
__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// Length of one patch's weight vector: w1 | w2 | w3.
__host__ __device__ __forceinline__ int hyper_params(int cin, int hidden, int out_ch) {
  return cin * hidden + hidden * 9 + hidden * out_ch;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The unit's weights in shared memory with the BN scales folded in, laid
// out so the expand reads kHT hidden channels and the project 4 outputs per
// float4 broadcast (hp = hidden rounded up to kHT, op = out_ch rounded up to
// 4; padding entries are zero, so no stage needs a bounds check):
//   w1 [cin][hp] expand, transposed      w3 [hp][op] project, transposed
//   w2 [hp][9] depthwise                 b1, b2 [hp], b3 [op] folded biases
//   s1, s2 [hidden], s3 [out_ch] the scales, read while placing weights
// K7 reads the weights from its weight map, places them with `put` and runs
// expand_v01 and depthwise + project on the CUDA cores.
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

// acc[i] (16 x 8 float32 tiles) += A (16 rows from m0, kk deep) . B^T for the
// n-tiles [n0 / 8, n0 / 8 + ntiles) of B's rows; B is [n][k] with pitch
// b_row. A is [k][m] (kKMajor) or [m][k] with pitch a_row. bfloat16: one
// mma.m16n8k16 per 16 of kk (A by ldmatrix, transposed for [k][m]); float32:
// FMAs on the elements the fragment holds (rows g and g + 8, columns 2t and
// 2t + 1), so both leave the same sums in the same registers.
template <typename T, bool kKMajor, int NT>
__device__ __forceinline__ void tile_product(float (&acc)[NT][4], const T* a, int a_row,
                                             int m0, const T* b, int b_row, int n0,
                                             int ntiles, int kk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
    for (int k = 0; k < kk; ++k) {
      const float a0 = kKMajor ? a[k * a_row + m0 + g] : a[(m0 + g) * a_row + k];
      const float a1 = kKMajor ? a[k * a_row + m0 + g + 8] : a[(m0 + g + 8) * a_row + k];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (i < ntiles) {
          const float* br = b + (n0 + i * 8 + 2 * t) * b_row + k;
          const float b0 = br[0], b1 = br[b_row];
          acc[i][0] = fmaf(a0, b0, acc[i][0]);
          acc[i][1] = fmaf(a0, b1, acc[i][1]);
          acc[i][2] = fmaf(a1, b0, acc[i][2]);
          acc[i][3] = fmaf(a1, b1, acc[i][3]);
        }
      }
    }
  } else {
    const int q = lane >> 3, r8 = lane & 7;
    for (int ks = 0; ks < kk; ks += 16) {
      unsigned fa[4];
      if constexpr (kKMajor)
        ldmatrix_x4_trans(fa, a + (ks + (q >> 1) * 8 + r8) * a_row + m0 + (q & 1) * 8);
      else
        ldmatrix_x4(fa, a + (m0 + (q & 1) * 8 + r8) * a_row + ks + (q >> 1) * 8);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (i < ntiles) {
          const T* br = b + (n0 + i * 8 + g) * b_row + ks + 2 * t;
          mma_bf16(acc[i], fa, *reinterpret_cast<const unsigned*>(br),
                   *reinterpret_cast<const unsigned*>(br + 8));
        }
      }
    }
  }
}

// K1's generation: out[m, g * opg + j] = sum_c s[m, g * fan_in + c] *
// w[g * opg + j, c] for g * opg + j < p, m = b * fhw + patch. A block takes
// kGenM patches and kGenN outputs of one group (blockIdx.z), K in chunks of
// kGenKC whose loads are all in flight at once; four warps, 16 patches each.
// The sums go through shared memory, so that each warp stores whole rows of
// the map, 32 consecutive outputs an instruction.
constexpr int kGenThreads = 128;
constexpr int kGenM = 64, kGenN = 64, kGenKC = 32;

template <typename T>
__global__ void __launch_bounds__(kGenThreads)
s2w_generate_kernel(const T* __restrict__ s, int64_t s_bstride, int fhw, int npatch,
                    const T* __restrict__ w, int fan_in, int opg, int p,
                    float* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);  // row pads: 8 rows of an ldmatrix hit 8 bank groups
  constexpr int kPer = kGenKC * kGenM / kGenThreads;  // elements a thread stages per operand
  __shared__ __align__(16) T as[kGenKC][kGenM + V];  // signal chunk [k][patch]
  __shared__ __align__(16) T bs[kGenN][kGenKC + V];  // weight chunk [output][k]
  __shared__ float cs[kGenM][kGenN + 1];              // the sums, for row-wise stores
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kGenN, m0 = blockIdx.y * kGenM, grp = blockIdx.z;
  // this thread's patch column of the signal chunk (tid % kGenM) and its offset
  const int r = tid % kGenM, m = min(m0 + r, npatch - 1), b = m / fhw;
  const T* srow = s + b * s_bstride + (int64_t)grp * fan_in * fhw + (m - b * fhw);
  const T zero = from_f<T>(0.f);
  float acc[kGenN / 8][4] = {};
  for (int k0 = 0; k0 < fan_in; k0 += kGenKC) {
    // every load of the chunk in flight before the first store
    T va[kPer], vb[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = tid + e * kGenThreads, k = i / kGenM, c = k0 + k;
      va[e] = c < fan_in && m0 + r < npatch ? srow[(int64_t)c * fhw] : zero;
      const int n = i / kGenKC, kb = i % kGenKC, j = n0 + n;
      vb[e] = k0 + kb < fan_in && j < opg ? w[((int64_t)grp * opg + j) * fan_in + k0 + kb] : zero;
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = tid + e * kGenThreads;
      as[i / kGenM][r] = va[e];
      bs[i / kGenKC][i % kGenKC] = vb[e];
    }
    __syncthreads();
    tile_product<T, true, kGenN / 8>(acc, &as[0][0], kGenM + V, warp * 16, &bs[0][0],
                                     kGenKC + V, 0, kGenN / 8, kGenKC);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kGenN / 8; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      cs[warp * 16 + g + 8 * hh][i * 8 + 2 * t] = acc[i][2 * hh];
      cs[warp * 16 + g + 8 * hh][i * 8 + 2 * t + 1] = acc[i][2 * hh + 1];
    }
  __syncwarp();
  // each warp stores its 16 rows, 32 consecutive outputs an instruction
  const int jmax = min(kGenN, min(opg - n0, p - grp * opg - n0));
  for (int rr = 0; rr < 16; ++rr) {
    const int mm = m0 + warp * 16 + rr;
    if (mm >= npatch) break;
    float* orow = out + (int64_t)mm * p + grp * opg + n0;
    for (int j = lane; j < jmax; j += 32) orow[j] = cs[warp * 16 + rr][j];
  }
}

template <typename T>
cudaError_t launch_generate(const void* s, int64_t s_bstride, const void* w, float* out,
                            int npatch, int fhw, int groups, int fan_in, int opg, int p,
                            cudaStream_t stream) {
  const dim3 grid((opg + kGenN - 1) / kGenN, (npatch + kGenM - 1) / kGenM, groups);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  s2w_generate_kernel<T><<<grid, kGenThreads, 0, stream>>>(
      static_cast<const T*>(s), s_bstride, fhw, npatch, static_cast<const T*>(w), fan_in,
      opg, p, out);
  return cudaSuccess;
}

// K1's and K2's unit. Shared memory as patch_invres.py's unit_layout gives
// it: from byte 0 the staged input [kp][x_row] (then the depthwise output
// [pixel][h_row], the project's A); at h_off the patch's P weights as they
// come (then the float32 hidden map [window pixel][h_row], then the float32
// output tile [op][o_row]); folded weights w1 [hk][w1_row] and w3
// [op][w3_row] in T, w2 [hk][9] float32; biases b1, b2 [hk], b3 [op] and
// scales s1, s2 [hk], s3 [op] float32; one int4 per staged 8-pixel chunk.
constexpr int kUnitThreads = 256;
constexpr int kUnitWarps = kUnitThreads / 32;
constexpr int kNG = 10;   // n-tiles of 8 hidden channels a warp expands at once
constexpr int kHalo = 4;  // halo loads a thread keeps in flight while staging

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// 8-pixel chunks of a staged row of a patch's pw columns, from its first
// column rounded down to 8: pw / 8 where every patch starts on a multiple of
// 8, else enough for any start.
__host__ __device__ __forceinline__ int row_chunks(int pw) {
  return pw % 8 == 0 ? pw / 8 : (pw + 14) / 8;
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kUnitThreads, 2)
invres_unit_kernel(const T* __restrict__ x, const TW* __restrict__ wmap, BNParams bn1,
                   BNParams bn2, BNParams bn3, float eps, T* __restrict__ out, int cin,
                   int height, int width, int fh, int fw, int hidden, int out_ch, int band,
                   int vec, InvresSmem lay) {
  constexpr bool kMma = !std::is_same<T, float>::value;
  constexpr int V = 16 / sizeof(T);  // elements of T in one 16-byte copy
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  T* xs = reinterpret_cast<T*>(base);  // staged input, then the depthwise output ds
  T* ds = xs;
  float* hs = reinterpret_cast<float*>(base + lay.h_off);
  float* os = reinterpret_cast<float*>(base + lay.h_off);
  T* w1 = reinterpret_cast<T*>(base + lay.w1_off);
  T* w3 = reinterpret_cast<T*>(base + lay.w3_off);
  float* w2 = reinterpret_cast<float*>(base + lay.w2_off);
  const int kp = round_up(cin, 16), hk = round_up(hidden, 16), op = round_up(out_ch, 8);
  // folded BN biases and scales, float32, zero past the real channels
  float* b1 = reinterpret_cast<float*>(base + lay.v_off);
  float* b2 = b1 + hk;
  float* b3 = b2 + hk;
  float* s1 = b3 + op;
  float* s2 = s1 + hk;
  float* s3 = s2 + hk;
  // the patch's P weights as they come, in the hidden map's space until folded
  TW* raw = reinterpret_cast<TW*>(base + lay.h_off);
  // per staged 8-pixel chunk. Row chunks of the patch's columns: the image
  // row, the image column of the first pixel, that pixel's index in the
  // hidden map and its column in the window (pixels outside columns 1 to pw
  // of the window are dropped). Halo chunks (image row -2): the first of
  // their 8 halo slots, slot s the window's row s / 2, column 0 (s even) or
  // pw + 1. Padding: image row -1.
  int4* tab = reinterpret_cast<int4*>(base + lay.t_off);

  const int ph = height / fh, pw = width / fw, hw = pw + 2, npix = band * pw;
  const int rw8 = row_chunks(pw), nrow = (band + 2) * rw8;
  const int nch = round_up(nrow + (2 * (band + 2) + 7) / 8, 2);
  const int nbands = ph / band;
  const int patch = blockIdx.x / nbands, r0 = (blockIdx.x - patch * nbands) * band;
  const int fy = patch / fw, fx = patch - fy * fw, b = blockIdx.y;
  const int y0 = fy * ph + r0 - 1, x0 = fx * pw;  // the window's top row, the patch's column
  const int ax0 = x0 & ~7, off = x0 - ax0;        // staged from the column rounded down
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int np = hyper_params(cin, hidden, out_ch), p1 = cin * hidden, p2 = p1 + hidden * 9;

  for (int j = tid; j < nch; j += kUnitThreads) {
    const int r = j / rw8, wc = 1 + (j - r * rw8) * 8 - off;
    tab[j] = j < nrow ? make_int4(reflect(y0 + r, height), x0 + wc - 1, r * hw + wc, wc)
                      : make_int4(8 * (j - nrow) < 2 * (band + 2) ? -2 : -1, 8 * (j - nrow), 0, 0);
  }
  __syncthreads();

  // 1. stage the window (a warp a channel row, a lane a chunk; rows past cin
  // are zeros, K's padding) and the patch's weights by cp.async, then the BN
  // parameters and the halo columns by plain loads while the copies fly
  const size_t plane = (size_t)height * width;
  const T* xb = x + (size_t)b * cin * plane;
  const T zero = from_f<T>(0.f);
  for (int c = warp; c < kp; c += kUnitWarps) {
    T* xr = xs + c * lay.x_row;
    const T* xc = xb + (size_t)min(c, cin - 1) * plane;
    for (int j = lane; j < nch; j += 32) {
      const int4 e = tab[j];
      T* d = xr + j * 8;
      if (c < cin && e.x >= 0 && vec && e.y >= 0 && e.y + 8 <= width) {
#pragma unroll
        for (int v = 0; v < 8; v += V) cp_async16(d + v, xc + (size_t)e.x * width + e.y + v, 16);
      } else if (c >= cin || e.x == -1) {
#pragma unroll
        for (int v = 0; v < 8; v += V) *reinterpret_cast<uint4*>(d + v) = make_uint4(0, 0, 0, 0);
      } else if (e.x >= 0) {  // a row chunk at the image's edge, or unaligned
        T vals[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          vals[k] = e.w + k >= 1 && e.w + k <= pw ? xc[(size_t)e.x * width + e.y + k] : zero;
#pragma unroll
        for (int k = 0; k < 8; ++k) d[k] = vals[k];
      }
    }
  }
  const TW* wp = wmap + ((int64_t)b * fh * fw + patch) * np;
  if ((np * sizeof(TW)) % 16 == 0 && reinterpret_cast<uintptr_t>(wp) % 16 == 0) {
    for (int i = tid; i < np * (int)sizeof(TW) / 16; i += kUnitThreads)
      cp_async16(raw + i * 16 / sizeof(TW), wp + i * 16 / sizeof(TW), 16);
  } else {
    for (int i = tid; i < np; i += kUnitThreads) raw[i] = wp[i];
  }
  cp_async_commit();
  for (int i = tid; i < 2 * hk + op; i += kUnitThreads) {  // b1 | b2 | b3, s1 | s2 | s3
    const int k = i < hk ? 0 : (i < 2 * hk ? 1 : 2), c = i - k * hk;
    const BNParams bn = k == 0 ? bn1 : (k == 1 ? bn2 : bn3);
    float sc = 0.f, bias = 0.f;
    if (c < (k < 2 ? hidden : out_ch)) {
      sc = bn_scale(bn.w, bn.v, c, eps);
      bias = bn.b[c] - bn.m[c] * sc;
    }
    b1[i] = bias;
    s1[i] = sc;
  }
  // the halo chunks' slots, every channel's, kHalo loads a thread in flight
  // together: slot sl is the window's row sl / 2, column 0 (sl even) or pw + 1
  const int nslots = 8 * (nch - nrow), nhalo = 2 * (band + 2);
  for (int i0 = tid; i0 < cin * nslots; i0 += kHalo * kUnitThreads) {
    T vals[kHalo];
#pragma unroll
    for (int u = 0; u < kHalo; ++u) {
      const int i = i0 + u * kUnitThreads, c = i / nslots, sl = i - c * nslots;
      vals[u] = i < cin * nslots && sl < nhalo
                    ? xb[(size_t)c * plane + (size_t)reflect(y0 + (sl >> 1), height) * width +
                         reflect(sl & 1 ? x0 + pw : x0 - 1, width)]
                    : zero;
    }
#pragma unroll
    for (int u = 0; u < kHalo; ++u) {
      const int i = i0 + u * kUnitThreads, c = i / nslots;
      if (i < cin * nslots) xs[c * lay.x_row + 8 * nrow + i - c * nslots] = vals[u];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 2. fold the BN scales into the weights in float32 (bfloat16: rounded
  // once): rows of w1 and w3 a warp each
  for (int h = warp; h < hk; h += kUnitWarps)
    for (int c = lane; c < kp; c += 32)
      w1[h * lay.w1_row + c] =
          from_f<T>(h < hidden && c < cin ? to_f(raw[h * cin + c]) * s1[h] : 0.f);
  for (int o = warp; o < op; o += kUnitWarps)
    for (int h = lane; h < hk; h += 32)
      w3[o * lay.w3_row + h] =
          from_f<T>(o < out_ch && h < hidden ? to_f(raw[p2 + o * hidden + h]) * s3[o] : 0.f);
  for (int i = tid; i < hk * 9; i += kUnitThreads) {
    const int h = i / 9;
    w2[i] = h < hidden ? to_f(raw[p1 + i]) * s2[h] : 0.f;
  }
  __syncthreads();

  // 3. expand: a warp takes 16 staged pixels (two chunks) and up to kNG
  // n-tiles; relu6(+ b1) of the window's pixels into the hidden map
  const int ntl = hk / 8, ngroups = (ntl + kNG - 1) / kNG;
  for (int it = warp; it < nch / 2 * ngroups; it += kUnitWarps) {
    const int mt = it / ngroups, n0 = (it - mt * ngroups) * kNG * 8;
    const int nn = min(kNG, ntl - n0 / 8);
    float acc[kNG][4] = {};
    tile_product<T, true, kNG>(acc, xs, lay.x_row, mt * 16, w1, lay.w1_row, n0, nn,
                               kMma ? kp : cin);
    float2 bias[kNG];
#pragma unroll
    for (int i = 0; i < kNG; ++i)
      if (i < nn) bias[i] = *reinterpret_cast<const float2*>(b1 + n0 + i * 8 + 2 * t);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // rows g and g + 8: pixel g of chunks 2 mt, 2 mt + 1
      const int4 e = tab[2 * mt + hh];
      int at = e.z + g;
      if (e.x == -2) {
        const int sl = e.y + g;
        at = sl < 2 * (band + 2) ? (sl >> 1) * hw + (sl & 1 ? pw + 1 : 0) : -1;
      } else if (e.x == -1 || e.w + g < 1 || e.w + g > pw) {
        at = -1;
      }
      if (at < 0) continue;
      float* hr = hs + at * lay.h_row + n0 + 2 * t;
#pragma unroll
      for (int i = 0; i < kNG; ++i)
        if (i < nn)
          store2_relu6(hr + i * 8, acc[i][2 * hh] + bias[i].x, acc[i][2 * hh + 1] + bias[i].y);
    }
  }
  __syncthreads();

  // 4. depthwise 3x3 + b2 + relu6 in float32: a thread takes a channel pair
  // and two adjacent columns of the band and walks their rows, keeping the
  // pair's taps and the window rows it shares with the next output row in
  // registers; the staged input is dead, so the result overwrites it as the
  // project's A tile
  const int npairs = hk / 2, ncol2 = (pw + 1) / 2;
  for (int i = tid; i < npairs * ncol2; i += kUnitThreads) {
    const int q2 = i / npairs, cp = i - q2 * npairs, px = 2 * q2;
    const bool two = px + 1 < pw;
    const int c3 = two ? 3 : 2;  // the fourth window column, if there is a second output
    float2 wk[9], win[3][4];
#pragma unroll
    for (int k = 0; k < 9; ++k) wk[k] = make_float2(w2[2 * cp * 9 + k], w2[(2 * cp + 1) * 9 + k]);
    const float ba = b2[2 * cp], bb = b2[2 * cp + 1];
    const float* hc = hs + px * lay.h_row + 2 * cp;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) win[dy][dx] = load2(hc + (dy * hw + dx) * lay.h_row);
      win[dy][3] = load2(hc + (dy * hw + c3) * lay.h_row);
    }
    for (int py = 0; py < band; ++py) {
      const float* hr = hc + (py + 2) * hw * lay.h_row;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) win[2][dx] = load2(hr + dx * lay.h_row);
      win[2][3] = load2(hr + c3 * lay.h_row);
      float a0 = ba, b0 = bb, a1 = ba, b1v = bb;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float2 u = win[k / 3][k % 3], v = win[k / 3][k % 3 + 1];
        a0 = fmaf(u.x, wk[k].x, a0);
        b0 = fmaf(u.y, wk[k].y, b0);
        a1 = fmaf(v.x, wk[k].x, a1);
        b1v = fmaf(v.y, wk[k].y, b1v);
      }
      T* dr = ds + (py * pw + px) * lay.h_row + 2 * cp;
      store2_relu6(dr, a0, b0);
      if (two) store2_relu6(dr + lay.h_row, a1, b1v);
#pragma unroll
      for (int dx = 0; dx < 4; ++dx) {
        win[0][dx] = win[1][dx];
        win[1][dx] = win[2][dx];
      }
    }
  }
  __syncthreads();

  // 5. project: a warp takes 16 pixels and every output; the sums go to the
  // float32 output tile, which reuses the hidden map's space
  const int ont = op / 8;
  for (int mt = warp; mt * 16 < npix; mt += kUnitWarps) {
    float acc[kMaxOut / 8][4] = {};
    tile_product<T, false, kMaxOut / 8>(acc, ds, lay.h_row, mt * 16, w3, lay.w3_row, 0, ont,
                                        kMma ? hk : hidden);
#pragma unroll
    for (int i = 0; i < kMaxOut / 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = mt * 16 + g + 8 * hh, o = i * 8 + 2 * t;
        if (i < ont && m < npix) {
          os[o * lay.o_row + m] = acc[i][2 * hh];
          os[(o + 1) * lay.o_row + m] = acc[i][2 * hh + 1];
        }
      }
  }
  __syncthreads();

  // 6. + b3 (+ x), 16 bytes a thread along the band's rows where they allow
  T* ob = out + (size_t)b * out_ch * plane + (size_t)(fy * ph + r0) * width + fx * pw;
  const T* xres = cin == out_ch ? xb + (size_t)(fy * ph + r0) * width + fx * pw : nullptr;
  if (vec && pw % V == 0) {
    const int cpr = pw / V;
    for (int i = tid; i < out_ch * band * cpr; i += kUnitThreads) {
      const int row = i / cpr, qq = i - row * cpr, o = row / band, py = row - o * band;
      const float* sv = os + o * lay.o_row + py * pw + qq * V;
      const size_t at = (size_t)o * plane + (size_t)py * width + qq * V;
      float v[V];
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = sv[e] + b3[o];
      if (xres) {
        alignas(16) T r[V];
        *reinterpret_cast<uint4*>(r) = *reinterpret_cast<const uint4*>(xres + at);
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] += to_f(r[e]);
      }
      alignas(16) T y[V];
#pragma unroll
      for (int e = 0; e < V; ++e) y[e] = from_f<T>(v[e]);
      *reinterpret_cast<uint4*>(ob + at) = *reinterpret_cast<const uint4*>(y);
    }
  } else {
    for (int i = tid; i < out_ch * npix; i += kUnitThreads) {
      const int o = i / npix, m = i - o * npix, py = m / pw;
      const size_t at = (size_t)o * plane + (size_t)py * width + (m - py * pw);
      float v = os[o * lay.o_row + m] + b3[o];
      if (xres) v += to_f(xres[at]);
      ob[at] = from_f<T>(v);
    }
  }
}

template <typename T, typename TW>
cudaError_t launch_unit(const void* x, const void* wmap, BNParams bn1, BNParams bn2,
                        BNParams bn3, float eps, void* out, int batch, int cin, int height,
                        int width, int fh, int fw, int hidden, int out_ch, int band,
                        InvresSmem lay, cudaStream_t stream) {
  auto kern = invres_unit_kernel<T, TW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  // the whole shared carveout: the plan sizes blocks so that two fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int vec = width % 8 == 0 && aligned16(x) && aligned16(out);
  kern<<<dim3(fh * fw * (height / fh / band), batch), kUnitThreads, lay.total, stream>>>(
      static_cast<const T*>(x), static_cast<const TW*>(wmap), bn1, bn2, bn3, eps,
      static_cast<T*>(out), cin, height, width, fh, fw, hidden, out_ch, band, vec, lay);
  return cudaSuccess;
}

// K7 with kV01 (launched only so; kV01 false is the v1_0 unit on the CUDA
// cores that invres_unit_kernel replaced): wmap holds `wstride` entries per
// patch, the first P of them the patch's weights.
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

cudaError_t launch_s2w_generate(DType dt, const void* s, int64_t s_bstride, const void* w_s2w,
                                float* out, int batch, int fhw, int groups, int fan_in,
                                int opg, int p, cudaStream_t stream) {
  if (batch < 1 || fhw < 1 || groups < 1 || fan_in < 1 || opg < 1 || p < 1 ||
      (int64_t)opg * groups < p)
    return cudaErrorInvalidValue;
  return (dt == DType::kFloat32 ? launch_generate<float> : launch_generate<__nv_bfloat16>)(
      s, s_bstride, w_s2w, out, batch * fhw, fhw, groups, fan_in, opg, p, stream);
}

cudaError_t launch_patch_invres(DType dt, DType wdt, const void* x, const void* wmap,
                                BNParams bn1, BNParams bn2, BNParams bn3, float eps,
                                void* out, int batch, int cin, int height, int width, int fh,
                                int fw, int hidden, int out_ch, int band, InvresSmem lay,
                                cudaStream_t stream) {
  const int ph = height / fh, pw = width / fw;
  const int nch = round_up((band + 2) * row_chunks(pw) + (2 * (band + 2) + 7) / 8, 2);
  if (out_ch > kMaxOut || hidden > 2 * kUnitThreads || band < 1 || ph % band ||
      batch > 65535 || height < 2 || width < 2 || lay.x_row < 8 * nch ||
      lay.h_row < round_up(hidden, 16) || lay.w1_row < round_up(cin, 16) ||
      lay.w3_row < round_up(hidden, 16) || lay.o_row < band * pw ||
      (size_t)lay.total > kSmemLimit || (dt == DType::kFloat32 && wdt != dt))
    return cudaErrorInvalidValue;
  auto launch = dt == DType::kFloat32 ? launch_unit<float, float>
                : wdt == DType::kFloat32 ? launch_unit<__nv_bfloat16, float>
                                         : launch_unit<__nv_bfloat16, __nv_bfloat16>;
  return launch(x, wmap, bn1, bn2, bn3, eps, out, batch, cin, height, width, fh, fw, hidden,
                out_ch, band, lay, stream);
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

}  // namespace hyperseg
