// Host launchers of the hand-written kernels.
//
// Plain C++ over raw pointers, so the .cu files need no PyTorch header and
// compile in seconds; bindings.cpp checks the tensors and calls these. Each
// launcher enqueues on `stream`, allocates nothing, and returns the error of
// its set-up calls; the caller checks the launch itself right after.
#pragma once

#include <cstdint>
#include <cuda_runtime_api.h>

namespace hyperseg {

enum class DType : int { kFloat32 = 0, kBFloat16 = 1 };

// Eval BatchNorm: float32 (C,) weight, bias, running_mean, running_var.
struct BNParams {
  const float* w;
  const float* b;
  const float* m;
  const float* v;
};

// Shared memory of one K3 block as stem.py's stem_layout lays it out: the
// staged band's row and channel pitches in elements, its 16-byte chunks a
// row; offsets and total in bytes.
struct StemSmem {
  int row, chan, chunks, bn_off, w_off, total;
};
constexpr int kStemMaxOut = 80;  // output channels K3 takes: five m-tiles of 16

// K3. x (B, 3, H, W) -> out (B, cout, (H-2)/2+1, (W-2)/2+1); w (cout, 3, 3, 3).
// bn.w null: the identity BN. swish false: no activation (the raw conv with
// the identity BN). A block takes `rows` x `cols` output pixels, as stem.py's
// stem_plan gives them.
cudaError_t launch_stem(DType dt, const void* x, const void* w, BNParams bn, float eps,
                        bool swish, void* out, int batch, int height, int width, int cout,
                        int rows, int cols, StemSmem lay, cudaStream_t stream);

// K4a. x, out (B, C, H, W); w (C, 1, 3, 3). A thread takes `rows` rows of a
// strip of 8 columns; `smem` bytes of shared memory a block, room for the
// folded taps of the most planes a block spans, as mbconv.py's dw_plan
// gives them.
cudaError_t launch_mbconv_dw(DType dt, const void* x, const void* w, BNParams bn, float eps,
                             void* out, int batch, int channels, int height, int width,
                             int rows, int smem, cudaStream_t stream);

// Shared memory of one K4b block as mbconv.py's project_plan lays it out:
// pitches in elements, offsets and total in bytes.
struct ProjectSmem {
  int row, out_row, w_row, w_off, c_off, total;
};

// K4b. h (B, cin, hw); se float32 (B, cin); w (cout, cin); residual
// (B, cout, hw) or null; out (B, cout, hw). cout <= 32; `tile` pixels a
// block, 64 or 128.
cudaError_t launch_mbconv_project(DType dt, const void* h, const float* se,
                                  const void* w, BNParams bn,
                                  const void* residual, float eps, void* out,
                                  int batch, int cin, int cout, int hw, int tile,
                                  ProjectSmem smem, cudaStream_t stream);

// Shared memory of one K5 block as mbconv.py's expand_dw_layout lays it
// out: pitches and the stage in elements, offsets and total in bytes.
struct ExpandSmem {
  int x_row, w_row, stage, stages, c_off, t_off, total;
};

// K5. x (B, cin, H, W); w_expand (mid, cin); w_dw (mid, K, K), K = `kernel`,
// 3 or 5; out (B, mid, out_h, out_w): depthwise stride 1 or 2 with zero pad
// (pad_t, pad_l) at the top/left, each under K (the rest of the pad is
// implied by out_h, out_w). Tiles of tile_h x tile_w output pixels (tile_w
// 8, 16 or 32) and `channels` (32 or 64) expanded channels a block, as
// mbconv.py's expand_dw_plan gives them.
cudaError_t launch_mbconv_expand_dw(DType dt, const void* x, const void* w_expand,
                                    BNParams bn0, const void* w_dw, BNParams bn1,
                                    float eps, void* out, int batch, int cin,
                                    int mid, int height, int width, int out_h,
                                    int out_w, int kernel, int stride, int pad_t, int pad_l,
                                    int tile_h, int tile_w, int channels,
                                    ExpandSmem smem, cudaStream_t stream);

// K6. x (planes, H, W) -> out (planes, scale*H, scale*W); scale 2, 3 or 4.
// A thread takes `rows` input rows of a strip of 8 columns, as resize.py's
// resize_plan gives them.
cudaError_t launch_resize_bilinear(DType dt, const void* x, void* out, int planes, int height,
                                   int width, int scale, int rows, cudaStream_t stream);

// K1's generation. s: signal slice, element (b, c, patch) at
// s + b*s_bstride + c*fhw + patch, c < groups*fan_in; w_s2w (groups*opg,
// fan_in); out (B, fhw, p) of type odt, float32 or dt, out[b, patch, g*opg +
// j] = sum_c s[b, g*fan_in + c, patch] * w_s2w[g*opg + j, c] for g*opg + j <
// p, summed in float32 and rounded once to odt.
cudaError_t launch_s2w_generate(DType dt, DType odt, const void* s, int64_t s_bstride,
                                const void* w_s2w, void* out, int batch, int fhw, int groups,
                                int fan_in, int opg, int p, cudaStream_t stream);

// Shared memory of one K1/K2 unit block as patch_invres.py's unit_layout
// lays it out: pitches in elements, offsets and total in bytes.
struct InvresSmem {
  int x_row, h_row, w1_row, w3_row, o_row, h_off, w1_off, w3_off, w2_off, v_off, t_off, total;
};

// K2, and K1's unit. x (B, cin, H, W) of type dt; wmap (B, fh, fw, P) of
// type wdt (dt, or float32) per-patch weights w1 (hidden, cin) | w2 (hidden,
// kernel, kernel) | w3 (out_ch, hidden); out (B, out_ch, H, W). kernel 3 or
// 5, out_ch <= 32, hidden <= 512; `band` rows of a patch per block, a
// divisor of H / fh.
cudaError_t launch_patch_invres(DType dt, DType wdt, const void* x, const void* wmap,
                                BNParams bn1, BNParams bn2, BNParams bn3, float eps,
                                void* out, int batch, int cin, int height, int width, int fh,
                                int fw, int hidden, int out_ch, int kernel, int band,
                                InvresSmem lay, cudaStream_t stream);

// Shared memory of one K7 block as patch_invres.py's v01_layout lays it
// out: pitches and counts in elements, offsets and total in bytes. `slots`
// w1 copies (the block's own patch and each foreign owner) and `tiles`
// foreign 16-pixel tiles are the most any block of the launch needs.
struct V01Smem {
  int x_row, h_row, d_row, w1_row, w3_row, o_row, f_row, slots, tiles, h_off, w1_off, w3_off,
      w2_off, v_off, f_off, t_off, total;
};

// K7. As K2 with the v0_1 semantics: a depthwise halo pixel is expanded
// with its owner patch's w1. wmap (B, fh, fw, wstride) of x's type, each
// patch's first P entries its weights; H, W >= 2.
cudaError_t launch_patch_invres_v01(DType dt, const void* x, const void* wmap, int64_t wstride,
                                    BNParams bn1, BNParams bn2, BNParams bn3, float eps,
                                    void* out, int batch, int cin, int height, int width, int fh,
                                    int fw, int hidden, int out_ch, int band, V01Smem lay,
                                    cudaStream_t stream);

}  // namespace hyperseg
