// Pairwise squared L2 distance with the norm epilogue fused, for Hopper,
// with an optional row mask in the same epilogue.
//
// Replaces two Pallas TPU kernels (matrixone_tpu/ops/pallas_kernels.py):
// `l2_distance_sq_pallas` (body `_l2_kernel`)
//
//     out[i, j] = max(||x_i||^2 + q2[j] - 2 * x_i . q_j, 0)
//
// and `l2_distance_sq_masked_pallas` (body `_l2_masked_kernel`), which
// writes +inf instead where mask[i] is false (a filtered-search
// prefilter).  Both share this one tile: the mask is a nullable pointer
// read only in the epilogue, so an all-true mask gives the unmasked
// bits and a fully masked tile is all +inf.  The mask adds n bytes to the
// traffic and nothing to the operations.
//
// x [n, d] f32, q [b, d] f32, q2 [b] f32 (||q_j||^2, computed by the
// caller as the TPU version does), mask [n] bool or null, out [n, b]
// f32, all row-major and contiguous.  Any n, b and d: every load and
// store is bounds-checked (the TPU version needs n % 1024 == 0; the IVF
// probe's n is the split nlist, which is not aligned).
//
// What bounds it: at the search shapes (b = 256, d = 768) the work is
// 2*n*b*d FLOPs against 4*(n*d + b*d + n*b) bytes, ~110 FLOPs a byte,
// so it is bound by operations.  This first version runs them as IEEE
// f32 FMAs on the CUDA cores (no TF32, no tensor cores), which keeps it
// within the reference's rtol 1e-5 of an exact product.
//
// Design: one block computes a 64 x 64 tile of `out`.  The d axis is
// walked in steps of 16: each step stages a [64 x 16] slice of x and of
// q in shared memory (transposed, k-major, so the inner loop reads a
// column of each), and each of the 256 threads accumulates a 4 x 4
// register block of x.q.  ||x||^2 is accumulated from the same x loads
// (each thread keeps a partial for the rows it loaded) and reduced
// across the 16 lanes that loaded each row once the d loop ends, so x
// is read from device memory once per column tile.  The epilogue adds
// q2, clamps at 0 and applies the mask before the only store.  Threads
// own rows ty + 16 i and columns tx + 16 j, so neighbouring lanes store
// neighbouring columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows of x per block
constexpr int BN = 64;        // rows of q per block
constexpr int BK = 16;        // depth of one shared-memory step
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // columns per thread
constexpr int THREADS = 256;  // (BM / TM) * (BN / TN)
constexpr int LOADS = BM * BK / THREADS;  // elements each thread loads per tile

static_assert(BM == BN, "x and q tiles share one loader");
static_assert(LOADS * THREADS == BM * BK, "tile must split evenly");

__global__ void __launch_bounds__(THREADS)
l2_distance_sq_kernel(const float* __restrict__ x,
                      const float* __restrict__ q,
                      const float* __restrict__ q2,
                      const bool* __restrict__ mask,
                      float* __restrict__ out,
                      int64_t n, int64_t b, int64_t d) {
  __shared__ float xs[BK][BM + 1];
  __shared__ float qs[BK][BN + 1];
  __shared__ float x2s[BM];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  // row tiles on x (up to 2^31 - 1 of them), column tiles on y
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int64_t col0 = (int64_t)blockIdx.y * BN;

  // loader mapping: element e of this thread is tile entry
  // (r, k) = ((e * THREADS + tid) / BK, tid % BK); 16 consecutive lanes
  // read 16 consecutive floats of one row
  const int lk = tid % BK;
  const int lr = tid / BK;  // 0..15; row of element e is lr + 16 * e

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float x2p[LOADS];
#pragma unroll
  for (int e = 0; e < LOADS; ++e) x2p[e] = 0.f;

  for (int64_t k0 = 0; k0 < d; k0 += BK) {
    const int64_t k = k0 + lk;
#pragma unroll
    for (int e = 0; e < LOADS; ++e) {
      const int r = lr + (THREADS / BK) * e;
      const int64_t xr = row0 + r;
      const int64_t qr = col0 + r;
      const float xv = (xr < n && k < d) ? x[xr * d + k] : 0.f;
      const float qv = (qr < b && k < d) ? q[qr * d + k] : 0.f;
      xs[lk][r] = xv;
      qs[lk][r] = qv;
      x2p[e] = fmaf(xv, xv, x2p[e]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], c[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + (BM / TM) * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) c[j] = qs[kk][tx + (BN / TN) * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the 16 lanes that loaded a row sit in one aligned half-warp
#pragma unroll
  for (int e = 0; e < LOADS; ++e) {
    float v = x2p[e];
#pragma unroll
    for (int off = BK / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lk == 0) x2s[lr + (THREADS / BK) * e] = v;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + (BM / TM) * i;
    const int64_t row = row0 + r;
    if (row >= n) continue;
    const float x2 = x2s[r];
    const bool keep = mask == nullptr || mask[row];
    const float inf = __int_as_float(0x7f800000);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t col = col0 + tx + (BN / TN) * j;
      if (col < b) {
        const float v = (x2 + q2[col]) - 2.f * acc[i][j];
        out[row * b + col] = keep ? fmaxf(v, 0.f) : inf;
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns at once; the caller checks the launch.
// `mask` [n] may be null (no row masked).
void mo_l2_distance_sq_launch(const float* x, const float* q,
                              const float* q2, const bool* mask,
                              float* out, int64_t n, int64_t b, int64_t d,
                              cudaStream_t stream) {
  if (n == 0 || b == 0) return;
  const dim3 grid((unsigned)((n + BM - 1) / BM), (unsigned)((b + BN - 1) / BN));
  l2_distance_sq_kernel<<<grid, THREADS, 0, stream>>>(x, q, q2, mask, out,
                                                      n, b, d);
}
