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

// K3. x (B, 3, H, W) -> out (B, cout, (H-2)/2+1, (W-2)/2+1); w (cout, 3, 3, 3).
cudaError_t launch_stem(DType dt, const void* x, const void* w, BNParams bn,
                        float eps, void* out, int batch, int height, int width,
                        int cout, cudaStream_t stream);

// K4a. x, out (B, C, H, W); w (C, 1, 3, 3).
cudaError_t launch_mbconv_dw(DType dt, const void* x, const void* w,
                             BNParams bn, float eps, void* out, int batch,
                             int channels, int height, int width,
                             cudaStream_t stream);

// K4b. h (B, cin, hw); se float32 (B, cin); w (cout, cin); residual
// (B, cout, hw) or null; out (B, cout, hw). cout <= 32.
cudaError_t launch_mbconv_project(DType dt, const void* h, const float* se,
                                  const void* w, BNParams bn,
                                  const void* residual, float eps, void* out,
                                  int batch, int cin, int cout, int hw,
                                  cudaStream_t stream);

// K5. x (B, cin, H, W); w_expand (mid, cin); w_dw (mid, 3, 3); out (B, mid,
// out_h, out_w): depthwise stride 1 or 2 with zero pad (pad_t, pad_l) at the
// top/left (the rest of the TF-SAME pad is implied by out_h, out_w). Tiles
// of tile_h x tile_w output pixels; the tile's input window,
// ((tile_h-1)*stride+3) x ((tile_w-1)*stride+3), holds at most 512 pixels.
cudaError_t launch_mbconv_expand_dw(DType dt, const void* x, const void* w_expand,
                                    BNParams bn0, const void* w_dw, BNParams bn1,
                                    float eps, void* out, int batch, int cin,
                                    int mid, int height, int width, int out_h,
                                    int out_w, int stride, int pad_t, int pad_l,
                                    int tile_h, int tile_w, cudaStream_t stream);

// K6. x (planes, H, W) -> out (planes, scale*H, scale*W); scale 2, 3 or 4.
cudaError_t launch_resize_bilinear(DType dt, const void* x, void* out,
                                   int planes, int height, int width, int scale,
                                   cudaStream_t stream);

// K1. x (B, cin, H, W); s: signal slice, element (b, c, fy, fx) at
// s + b*s_bstride + (c*fh + fy)*fw + fx, c < sig; w_s2w (n_out, sig/groups);
// out (B, out_ch, H, W). out_ch <= 32; `threads` a multiple of 32, at most
// 256; `hidden_chunk` a multiple of 8, and at least the hidden width rounded
// up to 8 unless a patch has at most `threads` pixels.
cudaError_t launch_patch_invres_s2w(DType dt, const void* x, const void* s,
                                    int64_t s_bstride, const void* w_s2w,
                                    BNParams bn1, BNParams bn2, BNParams bn3,
                                    float eps, void* out, int batch, int cin,
                                    int height, int width, int fh, int fw,
                                    int sig, int groups, int n_out, int hidden,
                                    int out_ch, int hidden_chunk, int threads,
                                    cudaStream_t stream);

// K2. x (B, cin, H, W); wmap (B, fh, fw, P) per-patch weights w1 (hidden,
// cin) | w2 (hidden, 3, 3) | w3 (out_ch, hidden); out (B, out_ch, H, W).
// out_ch <= 32; `band` rows of a patch per block, a divisor of H / fh.
cudaError_t launch_patch_invres(DType dt, const void* x, const void* wmap,
                                BNParams bn1, BNParams bn2, BNParams bn3,
                                float eps, void* out, int batch, int cin,
                                int height, int width, int fh, int fw,
                                int hidden, int out_ch, int band,
                                cudaStream_t stream);

}  // namespace hyperseg
