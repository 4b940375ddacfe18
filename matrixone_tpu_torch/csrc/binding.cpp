// PyTorch binding of the port's CUDA kernels: the only source that
// includes PyTorch's headers.  It registers each kernel as an operator
// of the `mo_torch` library (called as torch.ops.mo_torch.<name>), so
// it needs no pybind11 and none of torch/extension.h's Python-module
// machinery, which keeps the one slow compile of a build small.  The
// kernel sources (*.cu) see plain pointers and a stream only.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/zeros.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

void mo_l2_distance_sq_launch(const float* x, const float* q,
                              const float* q2, const bool* mask,
                              float* out, int64_t n, int64_t b, int64_t d,
                              cudaStream_t stream);
cudaError_t mo_adc_score_launch(const void* codes, bool codes_i32,
                                const float* lut, float* out, int64_t G,
                                int64_t P, int64_t M, cudaStream_t stream);
void mo_sorted_search_launch(const int64_t* sorted, int64_t n,
                             const int64_t* queries, int64_t m,
                             int32_t* out, cudaStream_t stream);
void mo_segment_sum_launch(const float* values, const int32_t* gids,
                           const bool* mask, int64_t n, int64_t G,
                           float* out, cudaStream_t stream);

namespace {

void check_f32_cuda(const at::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == at::kFloat, name, " must be float32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

at::Tensor l2_distance_sq_impl(const at::Tensor& x, const at::Tensor& q,
                               const at::Tensor& q2, const bool* mask) {
  check_f32_cuda(x, "x");
  check_f32_cuda(q, "q");
  check_f32_cuda(q2, "q2");
  TORCH_CHECK(x.dim() == 2 && q.dim() == 2 && q2.dim() == 1,
              "expected x [n, d], q [b, d], q2 [b]");
  TORCH_CHECK(x.size(1) == q.size(1), "x and q differ in d");
  TORCH_CHECK(q2.size(0) == q.size(0), "q2 must have one entry per query");
  TORCH_CHECK(x.device() == q.device() && q.device() == q2.device(),
              "x, q and q2 must be on one device");
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t n = x.size(0), b = q.size(0), d = x.size(1);
  at::Tensor out = at::empty({n, b}, x.options());
  if (n == 0 || b == 0) return out;
  mo_l2_distance_sq_launch(x.data_ptr<float>(), q.data_ptr<float>(),
                           q2.data_ptr<float>(), mask,
                           out.data_ptr<float>(), n, b, d,
                           c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

at::Tensor l2_distance_sq(const at::Tensor& x, const at::Tensor& q,
                          const at::Tensor& q2) {
  return l2_distance_sq_impl(x, q, q2, nullptr);
}

at::Tensor l2_distance_sq_masked(const at::Tensor& x, const at::Tensor& q,
                                 const at::Tensor& q2,
                                 const at::Tensor& mask) {
  TORCH_CHECK(mask.is_cuda() && mask.device() == x.device(),
              "mask must be a CUDA tensor on x's device");
  TORCH_CHECK(mask.scalar_type() == at::kBool, "mask must be bool");
  TORCH_CHECK(mask.dim() == 1 && mask.size(0) == x.size(0),
              "mask must be [n]");
  TORCH_CHECK(mask.is_contiguous(), "mask must be contiguous");
  return l2_distance_sq_impl(x, q, q2, mask.data_ptr<bool>());
}

at::Tensor adc_score(const at::Tensor& codes, const at::Tensor& lut) {
  TORCH_CHECK(codes.is_cuda() && lut.is_cuda(),
              "codes and lut must be CUDA tensors");
  TORCH_CHECK(codes.device() == lut.device(),
              "codes and lut must be on one device");
  TORCH_CHECK(codes.scalar_type() == at::kByte ||
                  codes.scalar_type() == at::kInt,
              "codes must be uint8 or int32");
  TORCH_CHECK(lut.scalar_type() == at::kFloat, "lut must be float32");
  TORCH_CHECK(codes.is_contiguous() && lut.is_contiguous(),
              "codes and lut must be contiguous");
  TORCH_CHECK(codes.dim() == 3 && lut.dim() == 3,
              "expected codes [G, P, M], lut [G, M, 256]");
  const int64_t G = codes.size(0), P = codes.size(1), M = codes.size(2);
  TORCH_CHECK(M >= 1, "codes need at least one subspace");
  TORCH_CHECK(lut.size(0) == G && lut.size(1) == M && lut.size(2) == 256,
              "lut must be [G, M, 256] for codes [G, P, M]");
  constexpr int64_t kMaxBlocks = 2147483647LL;  // the kernel's int grid
  TORCH_CHECK(M <= kMaxBlocks && G * ((P + 1023) / 1024) <= kMaxBlocks,
              "adc_score: grid too large");
  const c10::cuda::CUDAGuard guard(codes.device());
  at::Tensor out = at::empty({G, P}, lut.options());
  if (G == 0 || P == 0) return out;
  C10_CUDA_CHECK(mo_adc_score_launch(
      codes.data_ptr(), codes.scalar_type() == at::kInt,
      lut.data_ptr<float>(), out.data_ptr<float>(), G, P, M,
      c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

at::Tensor sorted_search(const at::Tensor& sorted,
                         const at::Tensor& queries) {
  TORCH_CHECK(sorted.is_cuda() && queries.is_cuda(),
              "sorted and queries must be CUDA tensors");
  TORCH_CHECK(sorted.device() == queries.device(),
              "sorted and queries must be on one device");
  TORCH_CHECK(sorted.scalar_type() == at::kLong &&
                  queries.scalar_type() == at::kLong,
              "sorted and queries must be int64 (uint64 bit patterns)");
  TORCH_CHECK(sorted.dim() == 1 && queries.dim() == 1,
              "expected sorted [n] and queries [m]");
  TORCH_CHECK(sorted.is_contiguous() && queries.is_contiguous(),
              "sorted and queries must be contiguous");
  TORCH_CHECK(sorted.size(0) < 2147483647LL,
              "sorted_search: n must fit an int32 position");
  const c10::cuda::CUDAGuard guard(queries.device());
  const int64_t n = sorted.size(0), m = queries.size(0);
  at::Tensor out = at::empty({m}, queries.options().dtype(at::kInt));
  if (m == 0) return out;
  mo_sorted_search_launch(sorted.data_ptr<int64_t>(), n,
                          queries.data_ptr<int64_t>(), m,
                          out.data_ptr<int32_t>(),
                          c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

at::Tensor segment_sum(const at::Tensor& values, const at::Tensor& gids,
                       const at::Tensor& mask, int64_t num_segments) {
  TORCH_CHECK(values.is_cuda() && gids.is_cuda() && mask.is_cuda(),
              "values, gids and mask must be CUDA tensors");
  TORCH_CHECK(values.device() == gids.device() &&
                  gids.device() == mask.device(),
              "values, gids and mask must be on one device");
  TORCH_CHECK(values.scalar_type() == at::kFloat, "values must be float32");
  TORCH_CHECK(gids.scalar_type() == at::kInt, "gids must be int32");
  TORCH_CHECK(mask.scalar_type() == at::kBool, "mask must be bool");
  TORCH_CHECK(values.dim() == 1 && gids.dim() == 1 && mask.dim() == 1 &&
                  gids.size(0) == values.size(0) &&
                  mask.size(0) == values.size(0),
              "expected values, gids and mask of one length [n]");
  TORCH_CHECK(values.is_contiguous() && gids.is_contiguous() &&
                  mask.is_contiguous(),
              "values, gids and mask must be contiguous");
  TORCH_CHECK(num_segments >= 1 && num_segments <= 4096,
              "segment_sum takes 1 <= num_segments <= 4096");
  const c10::cuda::CUDAGuard guard(values.device());
  at::Tensor out = at::zeros({num_segments}, values.options());
  const int64_t n = values.size(0);
  if (n == 0) return out;
  mo_segment_sum_launch(values.data_ptr<float>(), gids.data_ptr<int32_t>(),
                        mask.data_ptr<bool>(), n, num_segments,
                        out.data_ptr<float>(),
                        c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

}  // namespace

TORCH_LIBRARY(mo_torch, m) {
  m.def("l2_distance_sq(Tensor x, Tensor q, Tensor q2) -> Tensor");
  m.def("l2_distance_sq_masked(Tensor x, Tensor q, Tensor q2, Tensor mask)"
        " -> Tensor");
  m.def("adc_score(Tensor codes, Tensor lut) -> Tensor");
  m.def("sorted_search(Tensor sorted, Tensor queries) -> Tensor");
  m.def("segment_sum(Tensor values, Tensor gids, Tensor mask,"
        " int num_segments) -> Tensor");
}

TORCH_LIBRARY_IMPL(mo_torch, CUDA, m) {
  m.impl("l2_distance_sq", &l2_distance_sq);
  m.impl("l2_distance_sq_masked", &l2_distance_sq_masked);
  m.impl("adc_score", &adc_score);
  m.impl("sorted_search", &sorted_search);
  m.impl("segment_sum", &segment_sum);
}
