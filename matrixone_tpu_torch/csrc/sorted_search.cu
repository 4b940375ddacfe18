// Hash-join probe sorted search, for Hopper.
//
// Replaces the Pallas TPU kernel `sorted_search_pallas`
// (matrixone_tpu/ops/pallas_kernels.py, body `_sorted_search_kernel`):
//
//     out[i] = #{ j : sorted[j] < queries[i] }     (unsigned 64-bit order)
//
// which is searchsorted(sorted, queries, side='left'), as int32.  sorted
// [n] and queries [m] are 64-bit hashes; PyTorch has no usable uint64, so
// they travel as int64 bit patterns and are compared here as
// `unsigned long long`.  Any n and m, no padding (the TPU version pads
// with UINT64_MAX to its tiles); n = 0 gives zeros.
//
// The TPU kernel counts with a dense [tile, tile] compare over (hi, lo)
// sign-flipped int32 halves, O(n * m), because VMEM has no 64-bit
// integers and a TPU has no per-lane gather for a binary search.  Hopper
// has both, so each thread runs one lower-bound binary search over
// global memory: O(m log n) work, and the same integer, bit for bit.
//
// What bounds it: by bytes, 12 * m + 8 * n (each query read and each
// position written once, the sorted array read once) at 3.35 TB/s on an
// H100 SXM.  In practice the ceil(log2 n) dependent loads of each search
// are the limit: the first levels of every search hit the same few
// lines, which L2 keeps, and the last levels are scattered.  Staging the
// top levels of the search tree in shared memory is a later version's
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
sorted_search_kernel(const unsigned long long* __restrict__ sorted,
                     int64_t n,
                     const unsigned long long* __restrict__ queries,
                     int64_t m, int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  const unsigned long long q = queries[i];
  // invariant: sorted[j] < q for j < lo, sorted[j] >= q for j >= hi
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (sorted[mid] < q)
      lo = mid + 1;
    else
      hi = mid;
  }
  out[i] = (int32_t)lo;
}

}  // namespace

// Launches on `stream` and returns at once; the caller checks the launch.
// The caller keeps n below 2^31 (the result is int32) and m >= 1.
void mo_sorted_search_launch(const int64_t* sorted, int64_t n,
                             const int64_t* queries, int64_t m,
                             int32_t* out, cudaStream_t stream) {
  const int64_t blocks = (m + THREADS - 1) / THREADS;
  sorted_search_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      reinterpret_cast<const unsigned long long*>(sorted), n,
      reinterpret_cast<const unsigned long long*>(queries), m, out);
}
