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

#include <tuple>

int64_t mo_l2_distance_sq_workspace(int64_t n, int64_t b, int64_t d);
cudaError_t mo_l2_distance_sq_launch(const float* x, const float* q,
                                     const float* q2, const bool* mask,
                                     float* out, float* workspace, int64_t n,
                                     int64_t b, int64_t d,
                                     cudaStream_t stream);
int mo_l2_kernel_attributes(int64_t* rows, int cap);
cudaError_t mo_adc_score_launch(const void* codes, bool codes_i32,
                                const int32_t* starts, const int32_t* ends,
                                int64_t rows, const float* lut, float* out,
                                int64_t G, int64_t pad, int64_t M,
                                cudaStream_t stream);
cudaError_t mo_sorted_search_launch(const int64_t* sorted, int64_t n,
                                    const int64_t* queries, int64_t m,
                                    int32_t* out, int64_t stride,
                                    int64_t samples, int64_t levels,
                                    int64_t* tree, cudaStream_t stream);
int64_t mo_segment_sum_workspace(int64_t n, int64_t G, int64_t head);
cudaError_t mo_segment_sum_launch(const float* values, const int32_t* gids,
                                  const bool* mask, int64_t n, int64_t G,
                                  int64_t head, float* scratch, float* out,
                                  cudaStream_t stream);

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
  // the split-K parts and their partial norms, when the depth is split
  const int64_t ws_floats = mo_l2_distance_sq_workspace(n, b, d);
  at::Tensor ws = at::empty({ws_floats}, x.options());
  C10_CUDA_CHECK(mo_l2_distance_sq_launch(
      x.data_ptr<float>(), q.data_ptr<float>(), q2.data_ptr<float>(), mask,
      out.data_ptr<float>(), ws_floats ? ws.data_ptr<float>() : nullptr, n,
      b, d, c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

// [kernels, 6] int64 on the CPU: deep, 16-byte loads,
// registers, static shared bytes, local (spill) bytes, max threads of
// each L2 tile kernel
at::Tensor l2_kernel_attributes() {
  constexpr int kCap = 16;
  at::Tensor rows = at::zeros({kCap, 6}, at::dtype(at::kLong));
  const int k = mo_l2_kernel_attributes(rows.data_ptr<int64_t>(), kCap);
  TORCH_CHECK(k >= 0, "cudaFuncGetAttributes failed on an L2 kernel");
  return rows.narrow(0, 0, k).clone();
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

// codes' checks shared by both ADC forms
void check_adc_inputs(const at::Tensor& codes, const at::Tensor& lut) {
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
  TORCH_CHECK(lut.dim() == 3 && lut.size(2) == 256,
              "lut must be [G, M, 256]");
  TORCH_CHECK(lut.size(1) >= 1 && lut.size(1) <= 65535,
              "adc_score takes 1 <= M <= 65535");
}

at::Tensor adc_launch(const at::Tensor& codes, const int32_t* starts,
                      const int32_t* ends, int64_t rows, at::Tensor lut,
                      int64_t pad) {
  const int64_t G = lut.size(0), M = lut.size(1);
  constexpr int64_t kMaxBlocks = 2147483647LL;  // the kernel's grid
  TORCH_CHECK(G * ((pad + 2047) / 2048) <= kMaxBlocks,
              "adc_score: grid too large");
  const c10::cuda::CUDAGuard guard(codes.device());
  at::Tensor out = at::empty({G, pad}, lut.options());
  if (G == 0 || pad == 0) return out;
  // the kernel copies the LUT 16 bytes at a time
  if (reinterpret_cast<uintptr_t>(lut.data_ptr()) % 16) lut = lut.clone();
  C10_CUDA_CHECK(mo_adc_score_launch(
      codes.data_ptr(), codes.scalar_type() == at::kInt, starts, ends, rows,
      lut.data_ptr<float>(), out.data_ptr<float>(), G, pad, M,
      c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

at::Tensor adc_score(const at::Tensor& codes, const at::Tensor& lut) {
  check_adc_inputs(codes, lut);
  TORCH_CHECK(codes.dim() == 3, "expected codes [G, P, M]");
  TORCH_CHECK(lut.size(0) == codes.size(0) && lut.size(1) == codes.size(2),
              "lut must be [G, M, 256] for codes [G, P, M]");
  return adc_launch(codes, nullptr, nullptr, codes.size(1), lut,
                    codes.size(1));
}

at::Tensor adc_score_lists(const at::Tensor& codes, const at::Tensor& starts,
                           const at::Tensor& ends, const at::Tensor& lut,
                           int64_t pad) {
  check_adc_inputs(codes, lut);
  TORCH_CHECK(codes.dim() == 2 && codes.size(1) == lut.size(1),
              "expected codes [n, M] for lut [G, M, 256]");
  TORCH_CHECK(starts.is_cuda() && ends.is_cuda() &&
                  starts.device() == codes.device() &&
                  ends.device() == codes.device(),
              "starts and ends must be CUDA tensors on codes' device");
  TORCH_CHECK(starts.scalar_type() == at::kInt &&
                  ends.scalar_type() == at::kInt,
              "starts and ends must be int32");
  TORCH_CHECK(starts.dim() == 1 && ends.dim() == 1 &&
                  starts.size(0) == lut.size(0) &&
                  ends.size(0) == lut.size(0),
              "starts and ends must be [G] for lut [G, M, 256]");
  TORCH_CHECK(starts.is_contiguous() && ends.is_contiguous(),
              "starts and ends must be contiguous");
  TORCH_CHECK(pad >= 0, "pad must be >= 0");
  return adc_launch(codes, starts.data_ptr<int32_t>(),
                    ends.data_ptr<int32_t>(), codes.size(0), lut, pad);
}

at::Tensor sorted_search(const at::Tensor& sorted, const at::Tensor& queries,
                         int64_t stride, int64_t samples, int64_t levels) {
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
  const int64_t n = sorted.size(0), m = queries.size(0);
  // the plan: samples = ceil(n / stride), every sample inside the array,
  // in a tree of 2^levels - 1 >= samples slots
  TORCH_CHECK(stride >= 1 && samples == (n + stride - 1) / stride,
              "sorted_search: samples must be ceil(n / stride)");
  TORCH_CHECK(levels >= 0 && levels <= 14 &&
                  samples <= (int64_t{1} << levels) - 1,
              "sorted_search: the tree of 2^levels - 1 slots must hold "
              "the samples, levels <= 14");
  const c10::cuda::CUDAGuard guard(queries.device());
  at::Tensor out = at::empty({m}, queries.options().dtype(at::kInt));
  if (m == 0) return out;
  at::Tensor tree = at::empty({int64_t{1} << levels}, sorted.options());
  C10_CUDA_CHECK(mo_sorted_search_launch(
      sorted.data_ptr<int64_t>(), n, queries.data_ptr<int64_t>(), m,
      out.data_ptr<int32_t>(), stride, samples, levels,
      tree.data_ptr<int64_t>(), c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

// The rows (0-3) before the first row where values and gids lie on 16
// bytes and the mask on 4, when one row serves all three: from there the
// kernel loads 4 rows at a time.  -1 when the three are misaligned by
// different amounts: every row then takes the kernel's scalar walk.
int64_t vector_head(const at::Tensor& values, const at::Tensor& gids,
                    const at::Tensor& mask) {
  const auto rows_to = [](const at::Tensor& t, uintptr_t align) {
    const uintptr_t p = reinterpret_cast<uintptr_t>(t.data_ptr());
    return (int64_t)((align - p % align) % align / t.element_size());
  };
  const int64_t h = rows_to(values, 16);
  return h == rows_to(gids, 16) && h == rows_to(mask, 4) ? h : -1;
}

// -> (out [num_segments], the head row of the walk launched: 0-3 for
// the vector walk, -1 for the scalar one)
std::tuple<at::Tensor, int64_t> segment_sum(const at::Tensor& values,
                                            const at::Tensor& gids,
                                            const at::Tensor& mask,
                                            int64_t num_segments) {
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
  const int64_t n = values.size(0);
  if (n == 0) return {at::zeros({num_segments}, values.options()), -1};
  const int64_t head = vector_head(values, gids, mask);
  at::Tensor out = at::empty({num_segments}, values.options());
  const int64_t ws = mo_segment_sum_workspace(n, num_segments, head);
  TORCH_CHECK(ws >= 0, "segment_sum: cannot read the device's SM count");
  at::Tensor scratch = at::empty({ws}, values.options());
  C10_CUDA_CHECK(mo_segment_sum_launch(
      values.data_ptr<float>(), gids.data_ptr<int32_t>(),
      mask.data_ptr<bool>(), n, num_segments, head,
      ws ? scratch.data_ptr<float>() : nullptr, out.data_ptr<float>(),
      c10::cuda::getCurrentCUDAStream().stream()));
  return {out, head};
}

}  // namespace

TORCH_LIBRARY(mo_torch, m) {
  m.def("l2_distance_sq(Tensor x, Tensor q, Tensor q2) -> Tensor");
  m.def("l2_distance_sq_masked(Tensor x, Tensor q, Tensor q2, Tensor mask)"
        " -> Tensor");
  m.def("l2_kernel_attributes() -> Tensor", &l2_kernel_attributes);
  m.def("adc_score(Tensor codes, Tensor lut) -> Tensor");
  m.def("adc_score_lists(Tensor codes, Tensor starts, Tensor ends,"
        " Tensor lut, int pad) -> Tensor");
  m.def("sorted_search(Tensor sorted, Tensor queries, int stride,"
        " int samples, int levels) -> Tensor");
  m.def("segment_sum(Tensor values, Tensor gids, Tensor mask,"
        " int num_segments) -> (Tensor, int)");
}

TORCH_LIBRARY_IMPL(mo_torch, CUDA, m) {
  m.impl("l2_distance_sq", &l2_distance_sq);
  m.impl("l2_distance_sq_masked", &l2_distance_sq_masked);
  m.impl("adc_score", &adc_score);
  m.impl("adc_score_lists", &adc_score_lists);
  m.impl("sorted_search", &sorted_search);
  m.impl("segment_sum", &segment_sum);
}
