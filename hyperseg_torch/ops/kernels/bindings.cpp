// PyTorch bindings of the kernels as torch.ops.hyperseg_kernels.*.
//
// The only source that includes PyTorch headers, and only the light
// <torch/library.h> ones. The Python wrappers check shapes and allocate the
// outputs; these functions check device, dtype and contiguity again, launch on
// PyTorch's current stream, and check the launch at once.
#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <cstring>
#include <optional>

#include "kernels.h"

namespace {

using at::Tensor;
using hyperseg::BNParams;
using hyperseg::DType;

DType dtype_of(const Tensor& t) {
  TORCH_CHECK(t.is_cuda(), "hyperseg_kernels: expected a CUDA tensor");
  if (t.scalar_type() == at::kFloat) return DType::kFloat32;
  TORCH_CHECK(t.scalar_type() == at::kBFloat16,
              "hyperseg_kernels: expected float32 or bfloat16, got ", t.scalar_type());
  return DType::kBFloat16;
}

void check_like(const Tensor& t, const Tensor& ref, const char* name) {
  TORCH_CHECK(t.is_cuda() && t.device() == ref.device(), name, ": wrong device");
  TORCH_CHECK(t.scalar_type() == ref.scalar_type(), name, ": dtype must match");
  TORCH_CHECK(t.is_contiguous(), name, ": must be contiguous");
}

BNParams bn_of(const Tensor& w, const Tensor& b, const Tensor& m, const Tensor& v) {
  for (const Tensor* t : {&w, &b, &m, &v}) {
    TORCH_CHECK(t->is_cuda() && t->scalar_type() == at::kFloat && t->is_contiguous(),
                "hyperseg_kernels: BN tensors must be contiguous float32 on the card");
  }
  return {w.data_ptr<float>(), b.data_ptr<float>(), m.data_ptr<float>(),
          v.data_ptr<float>()};
}

cudaStream_t stream_of(const Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

// A shared-memory layout of N ints, as the Python plan gives it.
template <typename Smem, size_t N>
Smem smem_of(at::IntArrayRef layout, const char* name) {
  static_assert(sizeof(Smem) == N * sizeof(int), "a layout is N ints");
  TORCH_CHECK(layout.size() == N, name, ": layout takes ", N, " ints");
  int v[N];
  for (size_t i = 0; i < N; ++i) {
    TORCH_CHECK(layout[i] >= 0 && layout[i] <= INT32_MAX, name, ": layout out of range");
    v[i] = static_cast<int>(layout[i]);
  }
  Smem s;
  std::memcpy(&s, v, sizeof(s));
  return s;
}

void stem(const Tensor& x, const Tensor& w, at::TensorList bn, double eps, bool swish,
          int64_t rows, int64_t cols, at::IntArrayRef layout, Tensor& out) {
  c10::cuda::CUDAGuard guard(x.device());
  const DType dt = dtype_of(x);
  check_like(x, x, "stem x");
  check_like(w, x, "stem weight");
  check_like(out, x, "stem out");
  // no BN: the identity (the raw conv)
  TORCH_CHECK(bn.size() == 4 || bn.size() == 0,
              "stem: bn takes (weight, bias, mean, var) or nothing");
  const BNParams params = bn.size() == 4 ? bn_of(bn[0], bn[1], bn[2], bn[3])
                                         : BNParams{nullptr, nullptr, nullptr, nullptr};
  C10_CUDA_CHECK(hyperseg::launch_stem(
      dt, x.data_ptr(), w.data_ptr(), params, static_cast<float>(eps), swish, out.data_ptr(),
      x.size(0), x.size(2), x.size(3), w.size(0), rows, cols,
      smem_of<hyperseg::StemSmem, 6>(layout, "stem"), stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void mbconv_dw(const Tensor& x, const Tensor& w, const Tensor& g, const Tensor& b,
               const Tensor& m, const Tensor& v, double eps, int64_t rows, int64_t smem,
               Tensor& out) {
  c10::cuda::CUDAGuard guard(x.device());
  const DType dt = dtype_of(x);
  check_like(x, x, "mbconv_dw x");
  check_like(w, x, "mbconv_dw weight");
  check_like(out, x, "mbconv_dw out");
  C10_CUDA_CHECK(hyperseg::launch_mbconv_dw(
      dt, x.data_ptr(), w.data_ptr(), bn_of(g, b, m, v), static_cast<float>(eps),
      out.data_ptr(), x.size(0), x.size(1), x.size(2), x.size(3), rows, smem, stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void mbconv_project(const Tensor& h, const Tensor& se, const Tensor& w,
                    const Tensor& g, const Tensor& b, const Tensor& m,
                    const Tensor& v, const std::optional<Tensor>& residual,
                    double eps, int64_t tile, at::IntArrayRef layout, Tensor& out) {
  c10::cuda::CUDAGuard guard(h.device());
  const DType dt = dtype_of(h);
  check_like(h, h, "mbconv_project h");
  check_like(w, h, "mbconv_project weight");
  check_like(out, h, "mbconv_project out");
  TORCH_CHECK(se.is_cuda() && se.scalar_type() == at::kFloat && se.is_contiguous(),
              "mbconv_project se: contiguous float32 on the card");
  const void* res = nullptr;
  if (residual.has_value()) {
    check_like(*residual, h, "mbconv_project residual");
    res = residual->data_ptr();
  }
  C10_CUDA_CHECK(hyperseg::launch_mbconv_project(
      dt, h.data_ptr(), se.data_ptr<float>(), w.data_ptr(), bn_of(g, b, m, v), res,
      static_cast<float>(eps), out.data_ptr(), h.size(0), h.size(1), w.size(0),
      h.size(2) * h.size(3), tile,
      smem_of<hyperseg::ProjectSmem, 6>(layout, "mbconv_project"), stream_of(h)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void mbconv_expand_dw(const Tensor& x, const Tensor& w_expand, at::TensorList bn,
                      const Tensor& w_dw, double eps, int64_t stride, int64_t pad_t,
                      int64_t pad_l, int64_t tile_h, int64_t tile_w, int64_t channels,
                      at::IntArrayRef layout, Tensor& out) {
  c10::cuda::CUDAGuard guard(x.device());
  const DType dt = dtype_of(x);
  check_like(x, x, "mbconv_expand_dw x");
  check_like(w_expand, x, "mbconv_expand_dw w_expand");
  check_like(w_dw, x, "mbconv_expand_dw w_dw");
  check_like(out, x, "mbconv_expand_dw out");
  TORCH_CHECK(bn.size() == 8, "mbconv_expand_dw: bn takes 2 x (weight, bias, mean, var)");
  C10_CUDA_CHECK(hyperseg::launch_mbconv_expand_dw(
      dt, x.data_ptr(), w_expand.data_ptr(), bn_of(bn[0], bn[1], bn[2], bn[3]),
      w_dw.data_ptr(), bn_of(bn[4], bn[5], bn[6], bn[7]), static_cast<float>(eps),
      out.data_ptr(), x.size(0), x.size(1), out.size(1), x.size(2), x.size(3),
      out.size(2), out.size(3), w_dw.size(-1), stride, pad_t, pad_l, tile_h, tile_w, channels,
      smem_of<hyperseg::ExpandSmem, 7>(layout, "mbconv_expand_dw"), stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void resize_bilinear(const Tensor& x, int64_t scale, int64_t rows, Tensor& out) {
  c10::cuda::CUDAGuard guard(x.device());
  const DType dt = dtype_of(x);
  check_like(x, x, "resize_bilinear x");
  check_like(out, x, "resize_bilinear out");
  C10_CUDA_CHECK(hyperseg::launch_resize_bilinear(
      dt, x.data_ptr(), out.data_ptr(), x.size(0) * x.size(1), x.size(2), x.size(3),
      scale, rows, stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void patch_invres(const Tensor& x, const Tensor& wmap, int64_t hidden,
                  at::TensorList bn, double eps, int64_t kernel, int64_t band,
                  at::IntArrayRef layout, Tensor& out) {
  c10::cuda::CUDAGuard guard(x.device());
  const DType dt = dtype_of(x);
  check_like(x, x, "patch_invres x");
  check_like(out, x, "patch_invres out");
  // the map is x's dtype, or float32 (K1's generated map)
  TORCH_CHECK(wmap.is_cuda() && wmap.device() == x.device() && wmap.is_contiguous(),
              "patch_invres w: contiguous, on x's device");
  const DType wdt = dtype_of(wmap);
  TORCH_CHECK(wdt == dt || wdt == DType::kFloat32, "patch_invres w: x's dtype or float32");
  TORCH_CHECK(bn.size() == 12, "patch_invres: bn takes 3 x (weight, bias, mean, var)");
  C10_CUDA_CHECK(hyperseg::launch_patch_invres(
      dt, wdt, x.data_ptr(), wmap.data_ptr(), bn_of(bn[0], bn[1], bn[2], bn[3]),
      bn_of(bn[4], bn[5], bn[6], bn[7]), bn_of(bn[8], bn[9], bn[10], bn[11]),
      static_cast<float>(eps), out.data_ptr(), x.size(0), x.size(1), x.size(2),
      x.size(3), wmap.size(1), wmap.size(2), hidden, out.size(1), kernel, band,
      smem_of<hyperseg::InvresSmem, 12>(layout, "patch_invres"), stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void patch_invres_v01(const Tensor& x, const Tensor& wmap, int64_t wstride,
                      int64_t hidden, at::TensorList bn, double eps, int64_t band,
                      at::IntArrayRef layout, Tensor& out) {
  c10::cuda::CUDAGuard guard(x.device());
  const DType dt = dtype_of(x);
  check_like(x, x, "patch_invres_v01 x");
  check_like(out, x, "patch_invres_v01 out");
  // the map may be the first P entries of wider rows: (B, fh, fw, P) with
  // strides (fh * fw * wstride, fw * wstride, wstride, 1)
  TORCH_CHECK(wmap.is_cuda() && wmap.device() == x.device() &&
                  wmap.scalar_type() == x.scalar_type() && wmap.dim() == 4,
              "patch_invres_v01 w: a 4-d map like x");
  int64_t want = 1;
  for (int d = 3; d >= 0; --d) {
    TORCH_CHECK(wmap.size(d) == 1 || wmap.stride(d) == want,
                "patch_invres_v01 w: rows of wstride entries, patch-major");
    want = d == 3 ? wstride : want * wmap.size(d);
  }
  TORCH_CHECK(bn.size() == 12, "patch_invres_v01: bn takes 3 x (weight, bias, mean, var)");
  C10_CUDA_CHECK(hyperseg::launch_patch_invres_v01(
      dt, x.data_ptr(), wmap.data_ptr(), wstride, bn_of(bn[0], bn[1], bn[2], bn[3]),
      bn_of(bn[4], bn[5], bn[6], bn[7]), bn_of(bn[8], bn[9], bn[10], bn[11]),
      static_cast<float>(eps), out.data_ptr(), x.size(0), x.size(1), x.size(2),
      x.size(3), wmap.size(1), wmap.size(2), hidden, out.size(1), band,
      smem_of<hyperseg::V01Smem, 17>(layout, "patch_invres_v01"), stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void s2w_generate(const Tensor& s, int64_t s_bstride, const Tensor& w_s2w, int64_t groups,
                  Tensor& out) {
  c10::cuda::CUDAGuard guard(s.device());
  const DType dt = dtype_of(s);
  check_like(w_s2w, s, "s2w_generate w_s2w");
  TORCH_CHECK(out.is_cuda() && out.device() == s.device() && out.is_contiguous() &&
                  (out.scalar_type() == at::kFloat || out.scalar_type() == s.scalar_type()) &&
                  out.dim() == 4,
              "s2w_generate out: a contiguous (B, fh, fw, P) map on s's device, float32 or "
              "s's dtype");
  TORCH_CHECK(groups > 0 && s.size(1) % groups == 0 && w_s2w.size(0) % groups == 0,
              "s2w_generate: groups must divide the signal and the weight");
  C10_CUDA_CHECK(hyperseg::launch_s2w_generate(
      dt, dtype_of(out), s.data_ptr(), s_bstride, w_s2w.data_ptr(), out.data_ptr(), s.size(0),
      s.size(2) * s.size(3), groups, s.size(1) / groups, w_s2w.size(0) / groups, out.size(3),
      stream_of(s)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

TORCH_LIBRARY(hyperseg_kernels, m) {
  m.def("stem(Tensor x, Tensor weight, Tensor[] bn, float eps, bool swish, int rows, "
        "int cols, int[] layout, Tensor(a!) out) -> ()");
  m.def("mbconv_dw(Tensor x, Tensor weight, Tensor bn_weight, Tensor bn_bias, "
        "Tensor bn_mean, Tensor bn_var, float eps, int rows, int smem, Tensor(a!) out) -> ()");
  m.def("mbconv_project(Tensor h, Tensor se, Tensor weight, Tensor bn_weight, "
        "Tensor bn_bias, Tensor bn_mean, Tensor bn_var, Tensor? residual, "
        "float eps, int tile, int[] layout, Tensor(a!) out) -> ()");
  m.def("s2w_generate(Tensor s, int s_batch_stride, Tensor w_s2w, int groups, "
        "Tensor(a!) out) -> ()");
  m.def("mbconv_expand_dw(Tensor x, Tensor w_expand, Tensor[] bn, Tensor w_dw, "
        "float eps, int stride, int pad_t, int pad_l, int tile_h, int tile_w, "
        "int channels, int[] layout, Tensor(a!) out) -> ()");
  m.def("resize_bilinear(Tensor x, int scale, int rows, Tensor(a!) out) -> ()");
  m.def("patch_invres(Tensor x, Tensor w, int hidden, Tensor[] bn, float eps, "
        "int kernel, int band, int[] layout, Tensor(a!) out) -> ()");
  m.def("patch_invres_v01(Tensor x, Tensor w, int w_stride, int hidden, Tensor[] bn, "
        "float eps, int band, int[] layout, Tensor(a!) out) -> ()");
}

TORCH_LIBRARY_IMPL(hyperseg_kernels, CUDA, m) {
  m.impl("stem", &stem);
  m.impl("mbconv_dw", &mbconv_dw);
  m.impl("mbconv_project", &mbconv_project);
  m.impl("s2w_generate", &s2w_generate);
  m.impl("mbconv_expand_dw", &mbconv_expand_dw);
  m.impl("resize_bilinear", &resize_bilinear);
  m.impl("patch_invres", &patch_invres);
  m.impl("patch_invres_v01", &patch_invres_v01);
}
