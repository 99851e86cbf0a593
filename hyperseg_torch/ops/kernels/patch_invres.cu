// K1: signal2weights + patch-wise hyper inverted residual, NCHW.
//
// Replaces hyperseg_tpu/ops/pallas/patch_invres.py:488
// (patch_inverted_residual_s2w_fused) as two launches:
//   1. s2w_generate_kernel: the weight map (B, fh, fw, P) from the routed
//      signal slice and the grouped signal2weights weight (n_out,
//      sig/groups): per weight group g one GEMM, (patches x fan_in) .
//      (fan_in x n_out/groups), clipped to P. A block takes 64 patches and 64
//      outputs of one group, so each tile of the weight is read once per 64
//      patches, not once per patch; bfloat16 by mma.m16n8k16 (float32 sums),
//      float32 by FMAs. The map is float32, or the signal's dtype for the 1x1
//      units that read it as a batched matmul (decoder.py PatchConvUnit), each
//      float32 sum rounded once as it is stored. Bound: bytes (the map it
//      writes).
//   2. invres_unit_kernel (K2's, below) on that map. The map stays float32 so
//      that each weight is rounded once, after the BN scale is folded in.
//
// K2: the same unit from given per-patch weights, NCHW.
//
// Replaces hyperseg_tpu/ops/pallas/patch_invres.py:870
// (patch_inverted_residual_fused). w is (B, fh, fw, P), float32 or x's type,
// each patch's P weights contiguous in the reference order w1 (hidden, cin) |
// w2 (hidden, k, k) | w3 (out_ch, hidden), k = 3 or 5 (R = k / 2). One block
// of 256 threads per (band of `band` rows of a patch, b). The block
//   - stages the patch's columns of its band + 2R window rows with cp.async
//     as whole 8-pixel chunks from the column rounded down to 8 (the window
//     of a patch is not 16-byte aligned; a chunk at the image's edge is
//     filled element by element), and the window's R first and R last
//     columns (the neighbours' pixels inside the map, reflected only at the
//     image border) packed 8 to a chunk by plain loads, kHalo in flight a
//     thread, while the copies fly;
//   - folds the three eval BNs into the patch's weights in float32 and, in
//     bfloat16, rounds each product once;
//   - expands every staged pixel: the GEMM (staged pixels x cin) . (cin x
//     hidden), K padded to 16 and N to 16 with zeros, bfloat16 by
//     mma.m16n8k16 (float32 sums); relu6(+ b1) of the window's pixels goes to
//     a float32 hidden map [window pixel][hidden] that stays whole in shared
//     memory (a bfloat16 map, rounded before the depthwise, fails the
//     bfloat16 gate under calibrated BN); the staged pixels beside the window
//     are multiplied and dropped;
//   - runs the depthwise kxk on the CUDA cores in float32 from channel pairs,
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
// (patch_inverted_residual_v01). v0_1 folds each stage back to the full map,
// so a depthwise halo pixel of the hidden map is the expand output of the
// patch that owns it (the neighbour above, below, beside or diagonal; a pixel
// reflected at the image border belongs to the patch it reflects into), made
// with that patch's w1. v01_unit_kernel runs K2's stages (the device
// functions both kernels call: chunk table, staging, BN, depthwise, project,
// store) at k = 3, with three changes:
//   - the block's staged pixels not owned by its patch (the window's top or
//     bottom row where they lie in another patch row, the halo columns) are
//     grouped by owner into 16-pixel m-tiles of a gathered input tile, and
//     each owner's w1 is staged once beside the patch's own, so the foreign
//     pixels are expanded on the tensor cores like the own ones. Every
//     thread knows the owners from a bit mask of the candidates' owner
//     offsets; one warp groups the pixels by ballots while the copies fly;
//   - the map is x's dtype (`wstride` entries per patch, the first P its
//     weights), so w1 and w3 go into the products as the map holds them,
//     copied to padded pitches by cp.async where rows allow it, and the BN
//     scales s1 and s3 go on the float32 sums with the biases: folding them
//     in would round each weight twice, which fails the bfloat16 gate under
//     calibrated BN; w2 is folded with s2 in float32 as in K2;
//   - the staged pixels' expand keeps only those the patch owns, and makes
//     hidden rounded up to 8 channels (not 16) into a narrower hidden map.
// Bound: bytes, as K2. patch_invres.py's v01_plan picks the band and lays
// out shared memory (V01Smem in kernels.h), with room for the most owners
// and foreign tiles any block of the launch has.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "kernels.h"

namespace hyperseg {
namespace {

constexpr int kMaxOut = 32;  // output channels held per pixel
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

// Reflect index i in [-r, n - 1 + r] into [0, n) (n > r), like torch reflect pad.
__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// Length of one patch's weight vector: w1 | w2 | w3, a ks x ks depthwise.
__host__ __device__ __forceinline__ int hyper_params(int cin, int hidden, int out_ch, int ks) {
  return cin * hidden + hidden * ks * ks + hidden * out_ch;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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
// the map, 32 consecutive outputs an instruction, each float32 sum rounded
// once to the map's type TO (float, or T).
constexpr int kGenThreads = 128;
constexpr int kGenM = 64, kGenN = 64, kGenKC = 32;

template <typename T, typename TO>
__global__ void __launch_bounds__(kGenThreads)
s2w_generate_kernel(const T* __restrict__ s, int64_t s_bstride, int fhw, int npatch,
                    const T* __restrict__ w, int fan_in, int opg, int p,
                    TO* __restrict__ out) {
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
    TO* orow = out + (int64_t)mm * p + grp * opg + n0;
    for (int j = lane; j < jmax; j += 32) orow[j] = from_f<TO>(cs[warp * 16 + rr][j]);
  }
}

template <typename T, typename TO>
cudaError_t launch_generate(const void* s, int64_t s_bstride, const void* w, void* out,
                            int npatch, int fhw, int groups, int fan_in, int opg, int p,
                            cudaStream_t stream) {
  const dim3 grid((opg + kGenN - 1) / kGenN, (npatch + kGenM - 1) / kGenM, groups);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  s2w_generate_kernel<T, TO><<<grid, kGenThreads, 0, stream>>>(
      static_cast<const T*>(s), s_bstride, fhw, npatch, static_cast<const T*>(w), fan_in,
      opg, p, static_cast<TO*>(out));
  return cudaSuccess;
}

// The unit blocks of K1/K2 and K7 share their stages. A block stages the
// band's window - its band + 2R rows of the patch's columns, then the R halo
// columns on each side packed 8 to a chunk - as 8-pixel chunks described by
// one int4 each. Row chunks: the image row, the image column of the first
// pixel, that pixel's index in the hidden map and its column in the window
// (pixels outside columns R to pw + R - 1 of the window are dropped). Halo
// chunks (image row -2): the first of their 8 halo slots. Padding: image
// row -1.
constexpr int kUnitThreads = 256;
constexpr int kUnitWarps = kUnitThreads / 32;
constexpr int kNG = 10;   // n-tiles of 8 hidden channels a warp expands at once
constexpr int kHalo = 4;  // loads a thread keeps in flight while staging by elements

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// 8-pixel chunks of a staged row of a patch's pw columns, from its first
// column rounded down to 8: pw / 8 where every patch starts on a multiple of
// 8, else enough for any start.
__host__ __device__ __forceinline__ int row_chunks(int pw) {
  return pw % 8 == 0 ? pw / 8 : (pw + 14) / 8;
}

// 8-pixel chunks a unit block stages for a band: the rows' chunks, then the
// halo slots, an even count so that they make whole 16-pixel m-tiles.
__host__ __device__ __forceinline__ int unit_chunks(int pw, int band, int r) {
  return round_up((band + 2 * r) * row_chunks(pw) + (2 * r * (band + 2 * r) + 7) / 8, 2);
}

// Halo slot sl of a window with R halo columns a side: (window row, window
// column); the slots of a row go left columns first, then right.
template <int R>
__device__ __forceinline__ int2 halo_slot(int sl, int pw) {
  const int r = (unsigned)sl / (2 * R), c = (unsigned)sl % (2 * R);
  return make_int2(r, c < R ? c : pw + c);
}

// The chunk table of a block whose window's top row is y0 and whose patch
// starts at column x0 (off = x0 % 8).
template <int R>
__device__ __forceinline__ void chunk_table(int4* tab, int nch, int nrow, int rw8, int nhalo,
                                            int y0, int x0, int off, int hw, int height) {
  for (int j = threadIdx.x; j < nch; j += kUnitThreads) {
    const int r = j / rw8, wc = R + (j - r * rw8) * 8 - off;
    tab[j] = j < nrow ? make_int4(reflect(y0 + r, height), x0 + wc - R, r * hw + wc, wc)
                      : make_int4(8 * (j - nrow) < nhalo ? -2 : -1, 8 * (j - nrow), 0, 0);
  }
}

// Stage the window's row chunks into xs [kp][x_row], a warp a channel row and
// a lane a chunk: cp.async where the chunk lies whole in the image and x
// allows, elements at the image's edge, zeros past cin (K's padding) and for
// padding chunks. Halo chunks are left to stage_halo.
template <typename T, int R>
__device__ __forceinline__ void stage_window(T* xs, int x_row, const T* xb, const int4* tab,
                                             int nch, int kp, int cin, size_t plane, int width,
                                             int pw, int vec) {
  constexpr int V = 16 / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T zero = from_f<T>(0.f);
  for (int c = warp; c < kp; c += kUnitWarps) {
    T* xr = xs + c * x_row;
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
          vals[k] = e.w + k >= R && e.w + k < pw + R ? xc[(size_t)e.x * width + e.y + k] : zero;
#pragma unroll
        for (int k = 0; k < 8; ++k) d[k] = vals[k];
      }
    }
  }
}

// Stage the halo chunks' nslots slots of every channel into hx (the first
// halo chunk of channel row 0, pitch x_row), kHalo loads a thread in flight
// together; slots past nhalo take zeros. `between` runs once a thread while
// its first loads fly.
template <typename T, int R, typename F>
__device__ __forceinline__ void stage_halo(T* hx, int x_row, const T* xb, size_t plane, int cin,
                                           int nslots, int nhalo, int y0, int x0, int pw,
                                           int height, int width, F&& between) {
  const int tid = threadIdx.x;
  const T zero = from_f<T>(0.f);
  for (int i0 = tid; i0 < cin * nslots; i0 += kHalo * kUnitThreads) {
    T vals[kHalo];
#pragma unroll
    for (int u = 0; u < kHalo; ++u) {
      const int i = i0 + u * kUnitThreads, c = i / nslots, sl = i - c * nslots;
      const int2 rc = halo_slot<R>(sl, pw);
      vals[u] = i < cin * nslots && sl < nhalo
                    ? xb[(size_t)c * plane + (size_t)reflect(y0 + rc.x, height) * width +
                         reflect(x0 - R + rc.y, width)]
                    : zero;
    }
    if (i0 == tid) between();
#pragma unroll
    for (int u = 0; u < kHalo; ++u) {
      const int i = i0 + u * kUnitThreads, c = i / nslots;
      if (i < cin * nslots) hx[c * x_row + i - c * nslots] = vals[u];
    }
  }
  if (tid >= cin * nslots) between();
}

// The three eval BNs as scale and bias, float32, zero past the real
// channels: b1 | b2 | b3 ([hk], [hk], [op]) at b, s1 | s2 | s3 right after.
__device__ __forceinline__ void fold_bn(float* b, int hk, int op, int hidden, int out_ch,
                                        BNParams bn1, BNParams bn2, BNParams bn3,
                                        float eps) {
  for (int i = threadIdx.x; i < 2 * hk + op; i += kUnitThreads) {
    const int k = i < hk ? 0 : (i < 2 * hk ? 1 : 2), c = i - k * hk;
    const BNParams bn = k == 0 ? bn1 : (k == 1 ? bn2 : bn3);
    float sc = 0.f, bias = 0.f;
    if (c < (k < 2 ? hidden : out_ch)) {
      sc = bn_scale(bn.w, bn.v, c, eps);
      bias = bn.b[c] - bn.m[c] * sc;
    }
    b[i] = bias;
    b[2 * hk + op + i] = sc;
  }
}

// The hidden-map index of pixel g of staged chunk e, or -1 for a pixel
// beside the window or padding.
template <int R>
__device__ __forceinline__ int staged_index(int4 e, int g, int pw, int hw, int nhalo) {
  if (e.x == -2) {
    const int sl = e.y + g;
    if (sl >= nhalo) return -1;
    const int2 rc = halo_slot<R>(sl, pw);
    return rc.x * hw + rc.y;
  }
  return e.x == -1 || e.w + g < R || e.w + g >= pw + R ? -1 : e.z + g;
}

// Depthwise KSxKS + b2 + relu6 in float32 of nc channels (even) of the
// float32 hidden map hs [window pixel][h_row] into ds [pixel][d_row]: a
// thread takes a channel pair and two adjacent columns of the band and walks
// their rows, keeping the pair's taps (w2 [channel][KS * KS], folded) and
// the window rows it shares with the next output row in registers.
template <typename T, int KS>
__device__ __forceinline__ void depthwise(const float* hs, int h_row, T* ds, int d_row,
                                          const float* w2, const float* b2, int nc, int pw,
                                          int band) {
  constexpr int KK = KS * KS;
  const int hw = pw + KS - 1, npairs = nc / 2, ncol2 = (pw + 1) / 2;
  for (int i = threadIdx.x; i < npairs * ncol2; i += kUnitThreads) {
    const int q2 = i / npairs, cp = i - q2 * npairs, px = 2 * q2;
    const bool two = px + 1 < pw;
    const int cl = two ? KS : KS - 1;  // the last window column, if there is a second output
    float2 wk[KK], win[KS][KS + 1];
#pragma unroll
    for (int k = 0; k < KK; ++k)
      wk[k] = make_float2(w2[2 * cp * KK + k], w2[(2 * cp + 1) * KK + k]);
    const float ba = b2[2 * cp], bb = b2[2 * cp + 1];
    const float* hc = hs + px * h_row + 2 * cp;
#pragma unroll
    for (int dy = 0; dy < KS - 1; ++dy) {
#pragma unroll
      for (int dx = 0; dx < KS; ++dx) win[dy][dx] = load2(hc + (dy * hw + dx) * h_row);
      win[dy][KS] = load2(hc + (dy * hw + cl) * h_row);
    }
    for (int py = 0; py < band; ++py) {
      const float* hr = hc + (py + KS - 1) * hw * h_row;
#pragma unroll
      for (int dx = 0; dx < KS; ++dx) win[KS - 1][dx] = load2(hr + dx * h_row);
      win[KS - 1][KS] = load2(hr + cl * h_row);
      float a0 = ba, b0 = bb, a1 = ba, b1v = bb;
#pragma unroll
      for (int k = 0; k < KK; ++k) {
        const float2 u = win[k / KS][k % KS], v = win[k / KS][k % KS + 1];
        a0 = fmaf(u.x, wk[k].x, a0);
        b0 = fmaf(u.y, wk[k].y, b0);
        a1 = fmaf(v.x, wk[k].x, a1);
        b1v = fmaf(v.y, wk[k].y, b1v);
      }
      T* dr = ds + (py * pw + px) * d_row + 2 * cp;
      store2_relu6(dr, a0, b0);
      if (two) store2_relu6(dr + d_row, a1, b1v);
#pragma unroll
      for (int dy = 0; dy < KS - 1; ++dy)
#pragma unroll
        for (int dx = 0; dx <= KS; ++dx) win[dy][dx] = win[dy + 1][dx];
    }
  }
}

// Project: a warp takes 16 of the npix pixels of ds [pixel][d_row] and every
// output (w3 [op][w3_row], ont n-tiles, kk deep); the sums go to the float32
// output tile os [op][o_row].
template <typename T>
__device__ __forceinline__ void project(const T* ds, int d_row, const T* w3, int w3_row,
                                        float* os, int o_row, int npix, int ont, int kk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int mt = warp; mt * 16 < npix; mt += kUnitWarps) {
    float acc[kMaxOut / 8][4] = {};
    tile_product<T, false, kMaxOut / 8>(acc, ds, d_row, mt * 16, w3, w3_row, 0, ont, kk);
#pragma unroll
    for (int i = 0; i < kMaxOut / 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = mt * 16 + g + 8 * hh, o = i * 8 + 2 * t;
        if (i < ont && m < npix) {
          os[o * o_row + m] = acc[i][2 * hh];
          os[(o + 1) * o_row + m] = acc[i][2 * hh + 1];
        }
      }
  }
}

// The band's outputs (kScale: s3 *) sum + b3 (+ the residual xres) from the
// output tile os [op][o_row] to ob (the band's first pixel of output channel
// 0), 16 bytes a thread along the rows where they allow (o_row a multiple of
// 4 there).
template <typename T, bool kScale>
__device__ __forceinline__ void store_out(T* ob, const T* xres, const float* os, int o_row,
                                          const float* s3, const float* b3, int out_ch,
                                          int band, int pw, size_t plane, int width, int vec) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x, npix = band * pw;
  if (vec && pw % V == 0) {
    const int cpr = pw / V;
    for (int i = tid; i < out_ch * band * cpr; i += kUnitThreads) {
      const int row = i / cpr, qq = i - row * cpr, o = row / band, py = row - o * band;
      const float* sv = os + o * o_row + py * pw + qq * V;
      const size_t at = (size_t)o * plane + (size_t)py * width + qq * V;
      const float sc = kScale ? s3[o] : 1.f, bias = b3[o];
      float v[V];
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 q = *reinterpret_cast<const float4*>(sv + e);
        v[e] = kScale ? q.x * sc + bias : q.x + bias;
        v[e + 1] = kScale ? q.y * sc + bias : q.y + bias;
        v[e + 2] = kScale ? q.z * sc + bias : q.z + bias;
        v[e + 3] = kScale ? q.w * sc + bias : q.w + bias;
      }
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
      const float s = os[o * o_row + m];
      float v = (kScale ? s * s3[o] : s) + b3[o];
      if (xres) v += to_f(xres[at]);
      ob[at] = from_f<T>(v);
    }
  }
}

// K1's and K2's unit, KSxKS depthwise (R = KS / 2 halo rows and columns).
// Shared memory as patch_invres.py's unit_layout gives it: from byte 0 the
// staged input [kp][x_row] (then the depthwise output [pixel][h_row], the
// project's A); at h_off the patch's P weights as they come (then the
// float32 hidden map [window pixel][h_row], then the float32 output tile
// [op][o_row]); folded weights w1 [hk][w1_row] and w3 [op][w3_row] in T, w2
// [hk][KS * KS] float32; biases b1, b2 [hk], b3 [op] and scales s1, s2 [hk],
// s3 [op] float32; one int4 per staged 8-pixel chunk.
template <typename T, typename TW, int KS>
__global__ void __launch_bounds__(kUnitThreads, 2)
invres_unit_kernel(const T* __restrict__ x, const TW* __restrict__ wmap, BNParams bn1,
                   BNParams bn2, BNParams bn3, float eps, T* __restrict__ out, int cin,
                   int height, int width, int fh, int fw, int hidden, int out_ch, int band,
                   int vec, InvresSmem lay) {
  constexpr bool kMma = !std::is_same<T, float>::value;
  constexpr int R = KS / 2, KK = KS * KS;
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
  float* b1 = reinterpret_cast<float*>(base + lay.v_off);
  float* b2 = b1 + hk;
  float* b3 = b2 + hk;
  float* s1 = b3 + op;
  float* s2 = s1 + hk;
  float* s3 = s2 + hk;
  // the patch's P weights as they come, in the hidden map's space until folded
  TW* raw = reinterpret_cast<TW*>(base + lay.h_off);
  int4* tab = reinterpret_cast<int4*>(base + lay.t_off);

  const int ph = height / fh, pw = width / fw, hw = pw + 2 * R, npix = band * pw;
  const int rw8 = row_chunks(pw), nrow = (band + 2 * R) * rw8, nhalo = 2 * R * (band + 2 * R);
  const int nch = unit_chunks(pw, band, R);
  const int nbands = ph / band;
  const int patch = blockIdx.x / nbands, r0 = (blockIdx.x - patch * nbands) * band;
  const int fy = patch / fw, fx = patch - fy * fw, b = blockIdx.y;
  const int y0 = fy * ph + r0 - R, x0 = fx * pw;  // the window's top row, the patch's column
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int np = hyper_params(cin, hidden, out_ch, KS), p1 = cin * hidden, p2 = p1 + hidden * KK;

  chunk_table<R>(tab, nch, nrow, rw8, nhalo, y0, x0, x0 & 7, hw, height);
  __syncthreads();

  // 1. stage the window and the patch's weights by cp.async, then the BN
  // parameters and the halo columns by plain loads while the copies fly
  const size_t plane = (size_t)height * width;
  const T* xb = x + (size_t)b * cin * plane;
  stage_window<T, R>(xs, lay.x_row, xb, tab, nch, kp, cin, plane, width, pw, vec);
  const TW* wp = wmap + ((int64_t)b * fh * fw + patch) * np;
  if ((np * sizeof(TW)) % 16 == 0 && reinterpret_cast<uintptr_t>(wp) % 16 == 0) {
    for (int i = tid; i < np * (int)sizeof(TW) / 16; i += kUnitThreads)
      cp_async16(raw + i * 16 / sizeof(TW), wp + i * 16 / sizeof(TW), 16);
  } else {
    for (int i = tid; i < np; i += kUnitThreads) raw[i] = wp[i];
  }
  cp_async_commit();
  stage_halo<T, R>(xs + 8 * nrow, lay.x_row, xb, plane, cin, 8 * (nch - nrow), nhalo, y0, x0,
                   pw, height, width,
                   [&] { fold_bn(b1, hk, op, hidden, out_ch, bn1, bn2, bn3, eps); });
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
  for (int i = tid; i < hk * KK; i += kUnitThreads) {
    const int h = i / KK;
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
      const int at = staged_index<R>(tab[2 * mt + hh], g, pw, hw, nhalo);
      if (at < 0) continue;
      float* hr = hs + at * lay.h_row + n0 + 2 * t;
#pragma unroll
      for (int i = 0; i < kNG; ++i)
        if (i < nn)
          store2_relu6(hr + i * 8, acc[i][2 * hh] + bias[i].x, acc[i][2 * hh + 1] + bias[i].y);
    }
  }
  __syncthreads();

  // 4. depthwise; the staged input is dead, so the result overwrites it as
  // the project's A tile
  depthwise<T, KS>(hs, lay.h_row, ds, lay.h_row, w2, b2, hk, pw, band);
  __syncthreads();

  // 5. project into the float32 output tile, which reuses the hidden map's
  // space
  project<T>(ds, lay.h_row, w3, lay.w3_row, os, lay.o_row, npix, op / 8, kMma ? hk : hidden);
  __syncthreads();

  // 6. + b3 (+ x)
  const size_t first = (size_t)(fy * ph + r0) * width + fx * pw;
  store_out<T, false>(out + (size_t)b * out_ch * plane + first,
                      cin == out_ch ? xb + first : nullptr, os, lay.o_row, s3, b3, out_ch,
                      band, pw, plane, width, vec);
}

template <typename T, typename TW, int KS>
cudaError_t launch_unit(const void* x, const void* wmap, BNParams bn1, BNParams bn2,
                        BNParams bn3, float eps, void* out, int batch, int cin, int height,
                        int width, int fh, int fw, int hidden, int out_ch, int band,
                        InvresSmem lay, cudaStream_t stream) {
  auto kern = invres_unit_kernel<T, TW, KS>;
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

// cp.async of N = 4 or 8 bytes (16 takes cp_async16).
template <int N>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(N));
}

// K7. Shared memory as patch_invres.py's v01_layout gives it: from byte 0
// the staged input [kp][x_row] (K2's), later the depthwise output
// [pixel][d_row]; at h_off the patch's w2 | w3 as the map holds them (and,
// for odd cin in bfloat16, each slot's w1 block), later the float32 hidden
// map [window pixel][h_row] of hn = hidden rounded up to 8 channels, later
// the float32 output tile [op][o_row]; w1 of `slots` patches
// [slot][hn][w1_row] and w3 [op][w3_row] in T, zero past cin, hidden and
// out_ch; w2 [hk][9] folded with s2; b1, b2 [hk], b3 [op], s1, s2 [hk], s3
// [op]; the foreign pixels' input [kp][f_row]; the tables. wmap holds
// `wstride` entries per patch; `wvec` is the alignment in bytes (16, 8, 4 or
// 0) of every patch's first entry.
template <typename T>
__global__ void __launch_bounds__(kUnitThreads, 2)
v01_unit_kernel(const T* __restrict__ x, const T* __restrict__ wmap, int64_t wstride,
                BNParams bn1, BNParams bn2, BNParams bn3, float eps, T* __restrict__ out,
                int cin, int height, int width, int fh, int fw, int hidden, int out_ch,
                int band, int vec, int wvec, V01Smem lay) {
  constexpr bool kMma = !std::is_same<T, float>::value;
  constexpr int V = 16 / sizeof(T);  // elements of T in one 16-byte copy
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  T* xs = reinterpret_cast<T*>(base);  // staged input, then the depthwise output ds
  T* ds = xs;
  float* hs = reinterpret_cast<float*>(base + lay.h_off);
  float* os = hs;
  T* raw = reinterpret_cast<T*>(base + lay.h_off);  // w2 | w3 as they come
  T* w1 = reinterpret_cast<T*>(base + lay.w1_off);
  T* w3 = reinterpret_cast<T*>(base + lay.w3_off);
  float* w2 = reinterpret_cast<float*>(base + lay.w2_off);
  const int kp = round_up(cin, 16), hk = round_up(hidden, 16), op = round_up(out_ch, 8);
  const int hn = round_up(hidden, 8);  // hidden channels the expand and the depthwise make
  float* b1 = reinterpret_cast<float*>(base + lay.v_off);
  float* b2 = b1 + hk;
  float* b3 = b2 + hk;
  float* s1 = b3 + op;
  float* s2 = s1 + hk;
  float* s3 = s2 + hk;
  T* xf = reinterpret_cast<T*>(base + lay.f_off);
  const int ph = height / fh, pw = width / fw, hw = pw + 2, npix = band * pw;
  const int rw8 = row_chunks(pw), nrow = (band + 2) * rw8, nhalo = 2 * (band + 2);
  const int nch = unit_chunks(pw, band, 1);
  const int ncand = 2 * pw + 2 * (band + 2);
  // the chunk table (K2's); per foreign pixel slot its staged column and
  // window index (-1, -1: padding), tile after tile; per candidate pixel
  // its (staged column, window index); per foreign tile its w1 slot; per
  // candidate its owner key; the foreign tile count
  int4* tab = reinterpret_cast<int4*>(base + lay.t_off);
  int2* ftab = reinterpret_cast<int2*>(tab + nch);
  int2* cpix = ftab + 16 * lay.tiles;
  int* tslot = reinterpret_cast<int*>(cpix + ncand);
  int* ckey = tslot + lay.tiles;
  int* counts = ckey + ncand;

  const int nbands = ph / band;
  const int patch = blockIdx.x / nbands, r0 = (blockIdx.x - patch * nbands) * band;
  const int fy = patch / fw, fx = patch - fy * fw, b = blockIdx.y;
  const int y0 = fy * ph + r0 - 1, x0 = fx * pw;  // the window's top row, the patch's column
  const int off = x0 & 7;                         // staged from the column rounded down
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int np = hyper_params(cin, hidden, out_ch, 3), p1 = cin * hidden, p2 = p1 + hidden * 9;
  const int64_t img = (int64_t)b * fh * fw;  // the image's first patch in the map

  chunk_table<1>(tab, nch, nrow, rw8, nhalo, y0, x0, off, hw, height);
  // the candidates for a foreign owner - the window's top and bottom rows
  // (columns 1 to pw), then its left and right columns - each with the key
  // (dy + 1) * 3 + dx + 1 of its owner's offset from the patch (the owner is
  // the patch its reflected image pixel lies in, at most one away)
  for (int c = tid; c < ncand; c += kUnitThreads) {
    int r, xx, col, at;
    if (c < 2 * pw) {
      const int i = c < pw ? c : c - pw;
      r = c < pw ? 0 : band + 1;
      xx = x0 + i;
      col = 8 * r * rw8 + off + i;
      at = r * hw + i + 1;
    } else {
      const int q = c - 2 * pw, side = q >= band + 2;
      r = side ? q - band - 2 : q;
      xx = reflect(side ? x0 + pw : x0 - 1, width);
      col = 8 * nrow + 2 * r + side;
      at = r * hw + (side ? pw + 1 : 0);
    }
    const int yy = reflect(y0 + r, height);
    ckey[c] = (yy < fy * ph ? 0 : (yy < (fy + 1) * ph ? 3 : 6)) +
              (xx < x0 ? 0 : (xx < x0 + pw ? 1 : 2));
    cpix[c] = make_int2(col, at);
  }
  __syncthreads();

  // the foreign owners present: w1 slot s > 0 takes the s-th key in order
  // (slot_keys: 4 bits a slot; slot 0 the patch itself, key 4)
  unsigned keys = 0;
  for (int c0 = 0; c0 < ncand; c0 += 32)
    keys |= __reduce_or_sync(0xffffffffu, c0 + lane < ncand ? 1u << ckey[c0 + lane] : 0u);
  keys &= ~(1u << 4);
  uint64_t slot_keys = 4;
  int nslot = 1;
  for (unsigned m = keys; m; m &= m - 1) slot_keys |= (uint64_t)(__ffs(m) - 1) << (4 * nslot++);
  if (nslot > lay.slots) __trap();  // the plan's room is too small
  auto slot_patch = [&](int sl) {
    const int k = (int)(slot_keys >> (4 * sl)) & 15;
    return patch + (k / 3 - 1) * fw + k % 3 - 1;
  };

  // 1. stage the window, the w1 of every slot and the patch's w2 | w3 by
  // cp.async where aligned, then the BN parameters and the halo columns by
  // plain loads while the copies fly, and the last warp groups the foreign
  // pixels by owner
  const size_t plane = (size_t)height * width;
  const T* xb = x + (size_t)b * cin * plane;
  const T zero = from_f<T>(0.f);
  stage_window<T, 1>(xs, lay.x_row, xb, tab, nch, kp, cin, plane, width, pw, vec);
  // the weights. w1 rows go by copies of the widest of 16, 8, 4 bytes that
  // both the rows and the patches' starts allow, straight to their padded
  // pitch. Where no width fits the rows but the patches start on 16 bytes
  // (odd cin in bfloat16: `packed`), each slot's w1 block goes as it is, 16
  // bytes a copy, behind w2 | w3, and step 2 places it; else elements, kHalo
  // loads a thread in flight. w2 | w3 go 16 bytes a copy from the 16 bytes
  // that hold their first entry where the patches allow, else elements.
  int rw = 0;
  for (int wb = 16; wb >= 4 && !rw; wb /= 2)
    if (wvec >= wb && (cin * (int)sizeof(T)) % wb == 0) rw = wb;
  const bool packed = rw == 0 && wvec == 16;
  const int lead = wvec == 16 ? p1 % V : 0;  // w2's offset in its 16 bytes
  const int nraw = np - p1, pitch1 = round_up(p1, V);
  const T* rw23 = raw + lead;                 // w2 | w3
  T* rw1 = raw + round_up(nraw + lead, V);    // packed: the slots' w1 blocks, pitch1 apart
  const T* wp = wmap + (img + patch) * wstride + p1;
  if (wvec == 16) {
    const int nb = (nraw + lead) * (int)sizeof(T);
    for (int i = tid; i < (nb + 15) / 16; i += kUnitThreads)
      cp_async16(raw + i * V, wp - lead + i * V, min(16, nb - 16 * i));
  } else {
    for (int i0 = tid; i0 < nraw; i0 += kHalo * kUnitThreads) {
      T vals[kHalo];
#pragma unroll
      for (int u = 0; u < kHalo; ++u)
        vals[u] = i0 + u * kUnitThreads < nraw ? wp[i0 + u * kUnitThreads] : zero;
#pragma unroll
      for (int u = 0; u < kHalo; ++u)
        if (i0 + u * kUnitThreads < nraw) raw[i0 + u * kUnitThreads] = vals[u];
    }
  }
  if (rw) {
    const int ne = rw / (int)sizeof(T), per = cin / ne;
    for (int s = 0; s < nslot; ++s) {
      const T* src = wmap + (img + slot_patch(s)) * wstride;
      T* dst = w1 + s * hn * lay.w1_row;
      for (int i = tid; i < hidden * per; i += kUnitThreads) {
        const int h = i / per, j = (i - h * per) * ne;
        if (rw == 16)
          cp_async16(dst + h * lay.w1_row + j, src + h * cin + j, 16);
        else if (rw == 8)
          cp_async_small<8>(dst + h * lay.w1_row + j, src + h * cin + j);
        else
          cp_async_small<4>(dst + h * lay.w1_row + j, src + h * cin + j);
      }
    }
  } else if (packed) {
    const int per = (p1 * (int)sizeof(T) + 15) / 16;
    for (int i = tid; i < nslot * per; i += kUnitThreads) {
      const int s = i / per, j = i - s * per;
      cp_async16(rw1 + s * pitch1 + j * V, wmap + (img + slot_patch(s)) * wstride + j * V,
                 min(16, p1 * (int)sizeof(T) - 16 * j));
    }
  } else {
    for (int i0 = tid; i0 < nslot * p1; i0 += kHalo * kUnitThreads) {
      T vals[kHalo];
#pragma unroll
      for (int u = 0; u < kHalo; ++u) {
        const int i = i0 + u * kUnitThreads, s = i / p1;
        vals[u] = i < nslot * p1 ? wmap[(img + slot_patch(s)) * wstride + i - s * p1] : zero;
      }
#pragma unroll
      for (int u = 0; u < kHalo; ++u) {
        const int i = i0 + u * kUnitThreads, s = i / p1, q = i - s * p1, h = q / cin;
        if (i < nslot * p1) w1[(s * hn + h) * lay.w1_row + q - h * cin] = vals[u];
      }
    }
  }
  cp_async_commit();
  if (!packed) {  // w1's zero padding: columns cin to kp of the real rows, then rows to hn
    const int padc = kp - cin, padr = hn - hidden;
    for (int i = tid; i < nslot * hidden * padc; i += kUnitThreads) {
      const int sh = i / padc, s = sh / hidden;
      w1[(s * hn + sh - s * hidden) * lay.w1_row + cin + i - sh * padc] = zero;
    }
    for (int i = tid; i < nslot * padr * kp; i += kUnitThreads) {
      const int sh = i / kp, s = sh / padr;
      w1[(s * hn + hidden + sh - s * padr) * lay.w1_row + i - sh * kp] = zero;
    }
  }
  stage_halo<T, 1>(xs + 8 * nrow, lay.x_row, xb, plane, cin, 8 * (nch - nrow), nhalo, y0, x0,
                   pw, height, width,
                   [&] { fold_bn(b1, hk, op, hidden, out_ch, bn1, bn2, bn3, eps); });
  // the foreign pixels by owner key, in candidate order, into 16-pixel tiles
  if (warp == kUnitWarps - 1) {
    int ntile = 0, sl = 1;
    for (unsigned m = keys; m; m &= m - 1, ++sl) {
      const int key = __ffs(m) - 1;
      int cnt = 0;
      for (int c0 = 0; c0 < ncand; c0 += 32) {
        const int c = c0 + lane;
        const bool hit = c < ncand && ckey[c] == key;
        const unsigned bal = __ballot_sync(0xffffffffu, hit);
        if (hit) ftab[16 * ntile + cnt + __popc(bal & ((1u << lane) - 1))] = cpix[c];
        cnt += __popc(bal);
      }
      const int nt = (cnt + 15) / 16;
      if (ntile + nt > lay.tiles) __trap();  // the plan's room is too small
      for (int i = cnt + lane; i < 16 * nt; i += 32) ftab[16 * ntile + i] = make_int2(-1, -1);
      for (int i = lane; i < nt; i += 32) tslot[ntile + i] = sl;
      ntile += nt;
    }
    if (lane == 0) counts[0] = ntile;
  }
  cp_async_wait<0>();
  __syncthreads();

  // 2. w3 to its padded pitch, w2 folded with s2 in float32, packed w1
  // blocks to their padded pitch, and the foreign pixels' input gathered
  // tile by tile
  for (int o = warp; o < op; o += kUnitWarps)
    for (int h = lane; h < hk; h += 32)
      w3[o * lay.w3_row + h] = o < out_ch && h < hidden ? rw23[p2 - p1 + o * hidden + h] : zero;
  for (int i = tid; i < hk * 9; i += kUnitThreads) {
    const int h = i / 9;
    w2[i] = h < hidden ? to_f(rw23[i]) * s2[h] : 0.f;
  }
  if (packed) {
    for (int sh = tid; sh < nslot * hn; sh += kUnitThreads) {
      const int s = sh / hn, h = sh - s * hn;
      const T* src = rw1 + s * pitch1 + h * cin;
      T* dst = w1 + sh * lay.w1_row;
      for (int c = 0; c < kp; ++c) dst[c] = h < hidden && c < cin ? src[c] : zero;
    }
  }
  const int ntile = counts[0], nf = 16 * ntile;
  for (int i = tid; i < kp * nf; i += kUnitThreads) {
    const int k = i / nf, m = i - k * nf, col = ftab[m].x;
    xf[k * lay.f_row + m] = col >= 0 ? xs[k * lay.x_row + col] : zero;
  }
  __syncthreads();

  // 3. expand: a warp takes 16 pixels - two staged chunks, or a foreign tile
  // against its owner's w1 - and up to kNG n-tiles; relu6(s1 * sum + b1)
  // into the hidden map of the pixels the tile stands for: a staged chunk's
  // window pixels that the patch owns, a foreign tile's pixels
  const int ntl = hn / 8, ngroups = (ntl + kNG - 1) / kNG, nown = nch / 2;
  for (int it = warp; it < (nown + ntile) * ngroups; it += kUnitWarps) {
    const int mt = it / ngroups, n0 = (it - mt * ngroups) * kNG * 8;
    const int nn = min(kNG, ntl - n0 / 8), ft = mt - nown;
    const bool own = ft < 0;
    float acc[kNG][4] = {};
    tile_product<T, true, kNG>(acc, own ? xs : xf, own ? lay.x_row : lay.f_row,
                               16 * (own ? mt : ft), own ? w1 : w1 + tslot[ft] * hn * lay.w1_row,
                               lay.w1_row, n0, nn, kMma ? kp : cin);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // rows g and g + 8
      int at;
      if (own) {  // pixel g of chunk 2 mt + hh, where the patch owns it
        const int4 e = tab[2 * mt + hh];
        at = staged_index<1>(e, g, pw, hw, nhalo);
        int yy = e.x, xx = x0;  // a row chunk's kept pixels lie in the patch's columns
        if (e.x == -2) {
          const int2 rc = halo_slot<1>(e.y + g, pw);
          yy = reflect(y0 + rc.x, height);
          xx = reflect(x0 - 1 + rc.y, width);
        }
        if (yy < fy * ph || yy >= fy * ph + ph || xx < x0 || xx >= x0 + pw) at = -1;
      } else {
        at = ftab[16 * ft + g + 8 * hh].y;
      }
      if (at < 0) continue;
      float* hr = hs + at * lay.h_row + n0 + 2 * t;
#pragma unroll
      for (int i = 0; i < kNG; ++i)
        if (i < nn) {
          const float2 sc = *reinterpret_cast<const float2*>(s1 + n0 + i * 8 + 2 * t);
          const float2 bias = *reinterpret_cast<const float2*>(b1 + n0 + i * 8 + 2 * t);
          store2_relu6(hr + i * 8, acc[i][2 * hh] * sc.x + bias.x,
                       acc[i][2 * hh + 1] * sc.y + bias.y);
        }
    }
  }
  __syncthreads();

  // 4. depthwise of the hn channels; the result overwrites the staged input
  // as the project's A tile, whose columns hn to hk (bfloat16: K is a
  // multiple of 16) are zeros to meet w3's zero rows, not whatever shared
  // memory held
  if constexpr (kMma) {
    const int zp = (hk - hn) / 2;
    for (int i = tid; i < npix * zp; i += kUnitThreads) {
      const int m = i / zp;
      store2_relu6(ds + m * lay.d_row + hn + 2 * (i - m * zp), 0.f, 0.f);
    }
  }
  depthwise<T, 3>(hs, lay.h_row, ds, lay.d_row, w2, b2, hn, pw, band);
  __syncthreads();

  // 5. project into the float32 output tile, which reuses the hidden map's
  // space
  project<T>(ds, lay.d_row, w3, lay.w3_row, os, lay.o_row, npix, op / 8, kMma ? hk : hidden);
  __syncthreads();

  // 6. s3 * sum + b3 (+ x)
  const size_t first = (size_t)(fy * ph + r0) * width + fx * pw;
  store_out<T, true>(out + (size_t)b * out_ch * plane + first,
                     cin == out_ch ? xb + first : nullptr, os, lay.o_row, s3, b3, out_ch, band,
                     pw, plane, width, vec);
}

template <typename T>
cudaError_t launch_v01(const void* x, const void* wmap, int64_t wstride, BNParams bn1,
                       BNParams bn2, BNParams bn3, float eps, void* out, int batch, int cin,
                       int height, int width, int fh, int fw, int hidden, int out_ch, int band,
                       V01Smem lay, cudaStream_t stream) {
  auto kern = v01_unit_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  // the whole shared carveout: the plan sizes blocks so that two fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int vec = width % 8 == 0 && aligned16(x) && aligned16(out);
  int wvec = 0;
  for (int wb = 16; wb >= 4 && !wvec; wb /= 2)
    if (reinterpret_cast<uintptr_t>(wmap) % wb == 0 && (wstride * (int64_t)sizeof(T)) % wb == 0)
      wvec = wb;
  kern<<<dim3(fh * fw * (height / fh / band), batch), kUnitThreads, lay.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wmap), wstride, bn1, bn2, bn3, eps,
      static_cast<T*>(out), cin, height, width, fh, fw, hidden, out_ch, band, vec, wvec, lay);
  return cudaSuccess;
}

}  // namespace

cudaError_t launch_s2w_generate(DType dt, DType odt, const void* s, int64_t s_bstride,
                                const void* w_s2w, void* out, int batch, int fhw, int groups,
                                int fan_in, int opg, int p, cudaStream_t stream) {
  if (batch < 1 || fhw < 1 || groups < 1 || fan_in < 1 || opg < 1 || p < 1 ||
      (int64_t)opg * groups < p || (odt != DType::kFloat32 && odt != dt))
    return cudaErrorInvalidValue;
  auto launch = dt == DType::kFloat32   ? launch_generate<float, float>
                : odt == DType::kFloat32 ? launch_generate<__nv_bfloat16, float>
                                         : launch_generate<__nv_bfloat16, __nv_bfloat16>;
  return launch(s, s_bstride, w_s2w, out, batch * fhw, fhw, groups, fan_in, opg, p, stream);
}

cudaError_t launch_patch_invres(DType dt, DType wdt, const void* x, const void* wmap,
                                BNParams bn1, BNParams bn2, BNParams bn3, float eps,
                                void* out, int batch, int cin, int height, int width, int fh,
                                int fw, int hidden, int out_ch, int kernel, int band,
                                InvresSmem lay, cudaStream_t stream) {
  const int ph = height / fh, pw = width / fw, r = kernel / 2;
  if ((kernel != 3 && kernel != 5) || out_ch > kMaxOut || hidden > 2 * kUnitThreads ||
      band < 1 || ph % band || batch > 65535 || height <= r || width <= r || ph < 2 || pw < 2 ||
      lay.x_row < 8 * unit_chunks(pw, band, r) || lay.h_row < round_up(hidden, 16) ||
      lay.w1_row < round_up(cin, 16) || lay.w3_row < round_up(hidden, 16) ||
      lay.o_row < band * pw || lay.o_row % 4 || (size_t)lay.total > kSmemLimit ||
      (dt == DType::kFloat32 && wdt != dt))
    return cudaErrorInvalidValue;
  const bool f32 = dt == DType::kFloat32, wf32 = wdt == DType::kFloat32;
  auto launch = kernel == 3 ? (f32    ? launch_unit<float, float, 3>
                               : wf32 ? launch_unit<__nv_bfloat16, float, 3>
                                      : launch_unit<__nv_bfloat16, __nv_bfloat16, 3>)
                            : (f32    ? launch_unit<float, float, 5>
                               : wf32 ? launch_unit<__nv_bfloat16, float, 5>
                                      : launch_unit<__nv_bfloat16, __nv_bfloat16, 5>);
  return launch(x, wmap, bn1, bn2, bn3, eps, out, batch, cin, height, width, fh, fw, hidden,
                out_ch, band, lay, stream);
}

cudaError_t launch_patch_invres_v01(DType dt, const void* x, const void* wmap, int64_t wstride,
                                    BNParams bn1, BNParams bn2, BNParams bn3, float eps,
                                    void* out, int batch, int cin, int height, int width, int fh,
                                    int fw, int hidden, int out_ch, int band, V01Smem lay,
                                    cudaStream_t stream) {
  const int ph = height / fh, pw = width / fw;
  if (out_ch > kMaxOut || band < 1 || ph % band || batch > 65535 || height < 2 || width < 2 ||
      wstride < hyper_params(cin, hidden, out_ch, 3) || lay.x_row < 8 * unit_chunks(pw, band, 1) ||
      lay.h_row < round_up(hidden, 8) || lay.d_row < round_up(hidden, 16) ||
      lay.w1_row < round_up(cin, 16) || lay.w3_row < round_up(hidden, 16) ||
      lay.o_row < band * pw || lay.o_row % 4 || lay.slots < 1 || lay.f_row < 16 * lay.tiles ||
      (size_t)lay.total > kSmemLimit)
    return cudaErrorInvalidValue;
  return (dt == DType::kFloat32 ? launch_v01<float> : launch_v01<__nv_bfloat16>)(
      x, wmap, wstride, bn1, bn2, bn3, eps, out, batch, cin, height, width, fh, fw, hidden,
      out_ch, band, lay, stream);
}

}  // namespace hyperseg
