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

void stem(const Tensor& x, const Tensor& w, const Tensor& g, const Tensor& b,
          const Tensor& m, const Tensor& v, double eps, Tensor& out) {
  c10::cuda::CUDAGuard guard(x.device());
  const DType dt = dtype_of(x);
  check_like(x, x, "stem x");
  check_like(w, x, "stem weight");
  check_like(out, x, "stem out");
  C10_CUDA_CHECK(hyperseg::launch_stem(
      dt, x.data_ptr(), w.data_ptr(), bn_of(g, b, m, v), static_cast<float>(eps),
      out.data_ptr(), x.size(0), x.size(2), x.size(3), w.size(0), stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void mbconv_dw(const Tensor& x, const Tensor& w, const Tensor& g, const Tensor& b,
               const Tensor& m, const Tensor& v, double eps, Tensor& out) {
  c10::cuda::CUDAGuard guard(x.device());
  const DType dt = dtype_of(x);
  check_like(x, x, "mbconv_dw x");
  check_like(w, x, "mbconv_dw weight");
  check_like(out, x, "mbconv_dw out");
  C10_CUDA_CHECK(hyperseg::launch_mbconv_dw(
      dt, x.data_ptr(), w.data_ptr(), bn_of(g, b, m, v), static_cast<float>(eps),
      out.data_ptr(), x.size(0), x.size(1), x.size(2), x.size(3), stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void mbconv_project(const Tensor& h, const Tensor& se, const Tensor& w,
                    const Tensor& g, const Tensor& b, const Tensor& m,
                    const Tensor& v, const std::optional<Tensor>& residual,
                    double eps, Tensor& out) {
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
      h.size(2) * h.size(3), stream_of(h)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void mbconv_expand_dw(const Tensor& x, const Tensor& w_expand, at::TensorList bn,
                      const Tensor& w_dw, double eps, int64_t stride, int64_t pad_t,
                      int64_t pad_l, int64_t tile_h, int64_t tile_w, Tensor& out) {
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
      out.size(2), out.size(3), stride, pad_t, pad_l, tile_h, tile_w, stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void resize_bilinear(const Tensor& x, int64_t scale, Tensor& out) {
  c10::cuda::CUDAGuard guard(x.device());
  const DType dt = dtype_of(x);
  check_like(x, x, "resize_bilinear x");
  check_like(out, x, "resize_bilinear out");
  C10_CUDA_CHECK(hyperseg::launch_resize_bilinear(
      dt, x.data_ptr(), out.data_ptr(), x.size(0) * x.size(1), x.size(2), x.size(3),
      scale, stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void patch_invres(const Tensor& x, const Tensor& wmap, int64_t hidden,
                  at::TensorList bn, double eps, int64_t band, Tensor& out) {
  c10::cuda::CUDAGuard guard(x.device());
  const DType dt = dtype_of(x);
  check_like(x, x, "patch_invres x");
  check_like(wmap, x, "patch_invres w");
  check_like(out, x, "patch_invres out");
  TORCH_CHECK(bn.size() == 12, "patch_invres: bn takes 3 x (weight, bias, mean, var)");
  C10_CUDA_CHECK(hyperseg::launch_patch_invres(
      dt, x.data_ptr(), wmap.data_ptr(), bn_of(bn[0], bn[1], bn[2], bn[3]),
      bn_of(bn[4], bn[5], bn[6], bn[7]), bn_of(bn[8], bn[9], bn[10], bn[11]),
      static_cast<float>(eps), out.data_ptr(), x.size(0), x.size(1), x.size(2),
      x.size(3), wmap.size(1), wmap.size(2), hidden, out.size(1), band,
      stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void patch_invres_s2w(const Tensor& x, const Tensor& s, int64_t s_bstride,
                      const Tensor& w_s2w, int64_t groups, int64_t hidden,
                      at::TensorList bn, double eps, int64_t hidden_chunk,
                      int64_t threads, Tensor& out) {
  c10::cuda::CUDAGuard guard(x.device());
  const DType dt = dtype_of(x);
  check_like(x, x, "patch_invres_s2w x");
  check_like(w_s2w, x, "patch_invres_s2w w_s2w");
  check_like(out, x, "patch_invres_s2w out");
  TORCH_CHECK(s.is_cuda() && s.device() == x.device() && s.scalar_type() == x.scalar_type(),
              "patch_invres_s2w s: must match x");
  TORCH_CHECK(bn.size() == 12, "patch_invres_s2w: bn takes 3 x (weight, bias, mean, var)");
  C10_CUDA_CHECK(hyperseg::launch_patch_invres_s2w(
      dt, x.data_ptr(), s.data_ptr(), s_bstride, w_s2w.data_ptr(),
      bn_of(bn[0], bn[1], bn[2], bn[3]), bn_of(bn[4], bn[5], bn[6], bn[7]),
      bn_of(bn[8], bn[9], bn[10], bn[11]), static_cast<float>(eps), out.data_ptr(),
      x.size(0), x.size(1), x.size(2), x.size(3), s.size(2), s.size(3), s.size(1),
      groups, w_s2w.size(0), hidden, out.size(1), hidden_chunk, threads,
      stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

TORCH_LIBRARY(hyperseg_kernels, m) {
  m.def("stem(Tensor x, Tensor weight, Tensor bn_weight, Tensor bn_bias, "
        "Tensor bn_mean, Tensor bn_var, float eps, Tensor(a!) out) -> ()");
  m.def("mbconv_dw(Tensor x, Tensor weight, Tensor bn_weight, Tensor bn_bias, "
        "Tensor bn_mean, Tensor bn_var, float eps, Tensor(a!) out) -> ()");
  m.def("mbconv_project(Tensor h, Tensor se, Tensor weight, Tensor bn_weight, "
        "Tensor bn_bias, Tensor bn_mean, Tensor bn_var, Tensor? residual, "
        "float eps, Tensor(a!) out) -> ()");
  m.def("patch_invres_s2w(Tensor x, Tensor s, int s_batch_stride, Tensor w_s2w, "
        "int groups, int hidden, Tensor[] bn, float eps, int hidden_chunk, "
        "int threads, Tensor(a!) out) -> ()");
  m.def("mbconv_expand_dw(Tensor x, Tensor w_expand, Tensor[] bn, Tensor w_dw, "
        "float eps, int stride, int pad_t, int pad_l, int tile_h, int tile_w, "
        "Tensor(a!) out) -> ()");
  m.def("resize_bilinear(Tensor x, int scale, Tensor(a!) out) -> ()");
  m.def("patch_invres(Tensor x, Tensor w, int hidden, Tensor[] bn, float eps, "
        "int band, Tensor(a!) out) -> ()");
}

TORCH_LIBRARY_IMPL(hyperseg_kernels, CUDA, m) {
  m.impl("stem", &stem);
  m.impl("mbconv_dw", &mbconv_dw);
  m.impl("mbconv_project", &mbconv_project);
  m.impl("patch_invres_s2w", &patch_invres_s2w);
  m.impl("mbconv_expand_dw", &mbconv_expand_dw);
  m.impl("resize_bilinear", &resize_bilinear);
  m.impl("patch_invres", &patch_invres);
}
