// GROUP BY float segment sum, for Hopper.
//
// Replaces the Pallas TPU kernel `segment_sum_pallas`
// (matrixone_tpu/ops/pallas_kernels.py, body `_segsum_kernel`):
//
//     out[g] = sum of values[i] over the rows i with mask[i] and
//              gids[i] == g,  for 0 <= g < G
//
// values [n] f32, gids [n] int32, mask [n] bool, out [G] f32, G <= 4096.
// A masked row never lands anywhere, whatever its gid (the TPU kernel's
// id-G rule), and an unmasked row whose gid lies outside [0, G) is
// dropped, as XLA's segment_sum drops it.  Any n: the TPU kernel's
// padding to its 512-row tile is a rule of its tiling.
//
// The TPU kernel builds a one-hot [tile, G] matrix per tile and reduces
// it with one MXU matmul, accumulated over a sequential grid, because a
// TPU has no scatter.  Hopper blocks run in parallel and in no order, and
// have fast shared-memory atomics, so: a grid-stride loop in which each
// block keeps G f32 partials in shared memory (16 KB at G = 4096) and
// atomicAdds its unmasked rows into them; then each block adds its
// non-zero partials into the zeroed output with one global atomicAdd
// each.  The grid is at most MAX_BLOCKS blocks, so the second step costs
// at most MAX_BLOCKS * G global atomics whatever n is.
//
// Summation order: float atomics add in no fixed order, so the result
// may differ from a sequential sum in the last bits from run to run.
// Integer-valued inputs stay exact while every partial stays below 2^24.
//
// What bounds it: by bytes, 9 * n + 4 * G (each value, gid and mask byte
// read once, each output written once) at 3.35 TB/s on an H100 SXM.
// Contention on the shared atomics of a hot group is the expected limit
// when the rows of a warp share a few groups.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
// two blocks on each of an H100's 132 SMs: enough rows in flight to hide
// memory latency, and a bounded flush of the block partials
constexpr int MAX_BLOCKS = 264;

__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const float* __restrict__ values,
                   const int32_t* __restrict__ gids,
                   const bool* __restrict__ mask, int64_t n, int G,
                   float* __restrict__ out) {
  extern __shared__ float part[];                 // [G]
  for (int g = threadIdx.x; g < G; g += THREADS) part[g] = 0.f;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    if (mask[i]) {
      const int32_t g = gids[i];
      if ((uint32_t)g < (uint32_t)G) atomicAdd(&part[g], values[i]);
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += THREADS) {
    const float p = part[g];
    if (p != 0.f) atomicAdd(&out[g], p);
  }
}

}  // namespace

// Launches on `stream` and returns at once; the caller checks the launch.
// `out` must hold G zeros.  The caller keeps 1 <= G <= 4096 and n >= 1.
void mo_segment_sum_launch(const float* values, const int32_t* gids,
                           const bool* mask, int64_t n, int64_t G,
                           float* out, cudaStream_t stream) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const size_t smem = (size_t)G * sizeof(float);  // <= 16 KB: no opt-in
  segment_sum_kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      values, gids, mask, n, (int)G, out);
}
