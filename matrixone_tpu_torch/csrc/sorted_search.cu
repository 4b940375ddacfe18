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
// `unsigned long long`.  Any n < 2^31 and any m, no padding (the TPU
// version pads with UINT64_MAX to its tiles); n = 0 gives zeros.
//
// The TPU kernel counts with a dense [tile, tile] compare over (hi, lo)
// sign-flipped int32 halves, O(n * m), because VMEM has no 64-bit
// integers and a TPU has no per-lane gather for a binary search.  Hopper
// has both, so each query runs a lower-bound search: O(m log n) work,
// and the same integer, bit for bit.
//
// What bounds it: by bytes, 12 * m + 8 * n (each query read and each
// position written once, the sorted array read once) at 3.35 TB/s on an
// H100 SXM.  A plain binary search over device memory is bound instead
// by its ceil(log2 n) dependent loads a query: the top levels hit the
// same few L2 lines for every query, and their power-of-two strides put
// every probe of a level on one shared-memory or L1 bank.
//
// Design: two levels, the top one in shared memory.
//  * The sample: every stride-th key, samples = ceil(n / stride) <=
//    16383 of them (when n fits, all of n: stride 1), laid out as a
//    perfect binary tree in BFS order (Eytzinger), 2^levels slots of 8
//    bytes (128 KB at 14 levels, dynamic shared memory above the 48 KB
//    default), the slots past the samples UINT64_MAX.  Each level of the
//    tree is contiguous, so the first five levels a warp reads never
//    conflict on banks, and the descent has no branch: levels steps of
//    k = 2k + (tree[k] < q), after which k - 2^levels is j, the number of
//    samples below q.
//  * The finish: sample j - 1 is below q and sample j is not, so the
//    answer lies in ((j - 1) * stride, min(j * stride, n)]: a branchless
//    binary search of those at most stride - 1 keys in device memory
//    (four loads at n = 196608, from one or two lines).  Runs of equal
//    keys need nothing special: the interval argument uses only sorted
//    order, so the first of a run is found even when the run crosses a
//    sample.  The plan (stride, samples, levels) is made by the caller,
//    `sorted_search_plan` in ops/cuda_kernels.py, which the CPU tests
//    emulate with this file's arithmetic.
//  * Staging: a first small kernel writes the tree once to a scratch
//    buffer in device memory; each block of the search then copies it
//    whole into shared memory with coalesced 16-byte loads.  Reading the
//    samples straight from the sorted array would cost every block one
//    32-byte sector a sample (67 MB from L2 at 132 blocks and 16383
//    samples, against 17 MB for the copies).
//  * Blocks persist: one block of 1024 threads per SM that its shared
//    memory allows (one at 128 KB), each walking queries with a grid
//    stride, so the copy is paid once per SM and not once per 1024
//    queries.  A thread carries 4 queries at once, each step of their
//    searches independent, so that it keeps 4 loads in flight; a query's
//    own bytes are 12, and a group of threads a query would only split
//    the two short searches.  What remains is the finish's L2 sectors (a
//    few 32-byte sectors a distinct query), the descent's shared-memory
//    loads (14 a query, random banks below the fifth level), and the
//    tree's build and copy; chip_smoke.py times the kernel at each path
//    shape.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int Q = 4;             // queries a thread carries at once
constexpr int MAX_LEVELS = 14;   // 2^14 tree slots of 8 bytes: 128 KB

// The sample slot in BFS order k (1 .. 2^levels - 1) holds, of the
// perfect tree, in-order slot i = (2p + 1) 2^(levels - 1 - d) - 1, where
// d = floor(log2 k) and p = k - 2^d: sample i, or UINT64_MAX past the
// samples (never below a query, so it changes no count).
__global__ void __launch_bounds__(256)
sorted_search_tree(const unsigned long long* __restrict__ sorted,
                   int64_t stride, int samples, int levels,
                   unsigned long long* __restrict__ tree) {
  const int k = blockIdx.x * 256 + threadIdx.x;
  if (k < 1 || k >= (1 << levels)) return;
  const int d = 31 - __clz(k);
  const int i = ((2 * (k - (1 << d)) + 1) << (levels - 1 - d)) - 1;
  tree[k] = i < samples ? sorted[(int64_t)i * stride] : ~0ull;
}

__global__ void __launch_bounds__(THREADS)
sorted_search_kernel(const unsigned long long* __restrict__ sorted,
                     int64_t n,
                     const unsigned long long* __restrict__ queries,
                     int64_t m, int32_t* __restrict__ out, int64_t stride,
                     int levels,
                     const unsigned long long* __restrict__ tree_g) {
  extern __shared__ __align__(16) unsigned long long tree[];  // [2^levels]
  const int slots = 1 << levels;
  {
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(tree_g);
    ulonglong2* dst = reinterpret_cast<ulonglong2*>(tree);
#pragma unroll 8
    for (int k = threadIdx.x; k < slots / 2; k += THREADS) dst[k] = src[k];
  }
  __syncthreads();

  // finish: at most bit_length(stride - 1) halvings of an interval of
  // stride - 1 keys
  const int fin =
      stride > 1 ? 64 - __clzll((unsigned long long)(stride - 1)) : 0;
  constexpr int64_t CHUNK = (int64_t)THREADS * Q;
  for (int64_t c0 = (int64_t)blockIdx.x * CHUNK; c0 < m;
       c0 += (int64_t)gridDim.x * CHUNK) {
    unsigned long long q[Q];
    int k[Q];
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int64_t i = c0 + u * THREADS + threadIdx.x;
      q[u] = i < m ? queries[i] : 0;
      k[u] = 1;
    }
    // descend the perfect tree: the path's bits count the samples below q
    for (int l = 0; l < levels; ++l) {
#pragma unroll
      for (int u = 0; u < Q; ++u)
        k[u] = 2 * k[u] + (tree[k[u]] < q[u] ? 1 : 0);
    }
    int64_t a[Q], span[Q];
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int64_t j = k[u] - slots;
      const int64_t end = j * stride;
      // the answer lies in [a, a + span]: sorted[a - 1] < q <= sorted[a +
      // span] (j = 0: position 0; stride 1: span 0, position j)
      a[u] = j > 0 ? end - stride + 1 : 0;
      span[u] = j > 0 ? (end < n ? end : n) - a[u] : 0;
    }
    for (int it = 0; it < fin; ++it) {
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        if (span[u] > 0) {
          const int64_t half = span[u] >> 1;
          const bool below = sorted[a[u] + half] < q[u];
          a[u] = below ? a[u] + half + 1 : a[u];
          span[u] = below ? span[u] - half - 1 : half;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int64_t i = c0 + u * THREADS + threadIdx.x;
      if (i < m) out[i] = (int32_t)a[u];
    }
  }
}

// Blocks of the search kernel that fit on the card at `levels`, asked of
// the occupancy API once per (device, levels) and kept.
cudaError_t grid_cap(int levels, size_t smem, int64_t* cap) {
  constexpr int kDevices = 16;
  static int64_t known[kDevices][MAX_LEVELS + 1] = {};
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kDevices && known[device][levels] > 0) {
    *cap = known[device][levels];
    return cudaSuccess;
  }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, sorted_search_kernel, THREADS, smem)) != cudaSuccess)
    return err;
  *cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (device < kDevices) known[device][levels] = *cap;
  return cudaSuccess;
}

}  // namespace

// Launches on `stream` and returns at once; the caller checks the launch
// (the returned error is the shared-memory opt-in's or the occupancy
// query's).  The caller keeps n below 2^31 (the result is int32), m >= 1,
// stride >= 1, samples = ceil(n / stride) <= 2^levels - 1, levels <= 14,
// and hands 2^levels int64 of scratch in `tree`.  Two launches: the tree,
// then the search.
cudaError_t mo_sorted_search_launch(const int64_t* sorted, int64_t n,
                                    const int64_t* queries, int64_t m,
                                    int32_t* out, int64_t stride,
                                    int64_t samples, int64_t levels,
                                    int64_t* tree, cudaStream_t stream) {
  if (levels < 0 || levels > MAX_LEVELS || samples > (1LL << levels) - 1)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(unsigned long long) << levels;
  // a launch asking for more than 48 KB of dynamic shared memory without
  // this opt-in is refused
  cudaError_t err = cudaFuncSetAttribute(
      sorted_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int64_t cap = 0;
  if ((err = grid_cap((int)levels, smem, &cap)) != cudaSuccess) return err;
  const auto* s = reinterpret_cast<const unsigned long long*>(sorted);
  auto* t = reinterpret_cast<unsigned long long*>(tree);
  sorted_search_tree<<<(unsigned)(((1 << levels) + 255) / 256), 256, 0,
                       stream>>>(s, stride, (int)samples, (int)levels, t);
  const int64_t need = (m + (int64_t)THREADS * Q - 1) / ((int64_t)THREADS * Q);
  const int64_t blocks = need < cap ? need : cap;
  sorted_search_kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      s, n, reinterpret_cast<const unsigned long long*>(queries), m, out,
      stride, (int)levels, t);
  return cudaSuccess;
}
