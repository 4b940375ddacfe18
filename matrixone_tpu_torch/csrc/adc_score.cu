// IVF-PQ asymmetric-distance (ADC) scoring, for Hopper.
//
// Replaces the Pallas TPU kernel `adc_score_pallas`
// (matrixone_tpu/ops/pallas_kernels.py, body `_adc_kernel`):
//
//     out[g, p] = sum_m lut[g, m, codes[g, p, m]]
//
// codes [G, P, M] uint8 or int32 (values in [0, 256)), lut [G, M, 256]
// f32, out [G, P] f32, all row-major and contiguous.  Any G, P and M:
// the TPU kernel's P % tile_c == 0 is a rule of its tiling, and here
// every candidate is bounds-checked.  The TPU kernel scores a tile as a
// one-hot [tile, M*256] @ [M*256] matmul, because a TPU has no per-lane
// gather; Hopper has one, so each thread gathers its candidate's M
// entries from the group's LUT in shared memory and sums them in m
// order, in f32.
//
// What bounds it: G*P*M adds against G*P*M code bytes (4x that for
// int32), G*M*1024 LUT bytes and G*P*4 output bytes, under one
// operation a byte, so it is bound by bytes (3.35 TB/s on an H100 SXM).
// The design reads every code and output byte once, coalesced along p
// between neighbouring threads, and each group's LUT once per block
// from device memory (mostly from L2, since a group's blocks run close
// together).  What it leaves on the table, for a later version: each
// thread reads its candidate's M codes with an M-byte stride to its
// neighbour, and the random gathers from shared memory conflict on
// banks; at M = 96 a 96 KB LUT also limits an SM to two blocks.
//
// Design: one block per (g, tile of TILE_P candidates); each of its
// THREADS threads owns PER_THREAD candidates p0 + tid + THREADS * i and
// keeps their sums in registers.  The block stages lut[g] in dynamic
// shared memory, in m-tiles of at most MT_MAX * 1 KB, so any M runs:
// for M <= MT_MAX there is one tile (96 KB at M = 96, which needs the
// cudaFuncAttributeMaxDynamicSharedMemorySize opt-in above 48 KB), and a
// larger M loops over tiles with the sums carried across them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int TILE_P = THREADS * PER_THREAD;  // candidates per block
constexpr int LUT_W = 256;                    // entries per subspace
constexpr int MT_MAX = 224;                   // subspaces per LUT tile: 224 KB

template <typename CodeT>
__global__ void __launch_bounds__(THREADS)
adc_score_kernel(const CodeT* __restrict__ codes,
                 const float* __restrict__ lut,
                 float* __restrict__ out,
                 int64_t P, int M, int64_t p_tiles, int mt) {
  extern __shared__ float lut_s[];            // [mt][256]
  const int tid = threadIdx.x;
  const int64_t g = (int64_t)blockIdx.x / p_tiles;
  const int64_t p0 = ((int64_t)blockIdx.x % p_tiles) * TILE_P;
  const float* lut_g = lut + g * (int64_t)M * LUT_W;

  float acc[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) acc[i] = 0.f;

  for (int m0 = 0; m0 < M; m0 += mt) {
    const int mc = min(mt, M - m0);
    __syncthreads();                           // the previous tile is read
    for (int e = tid; e < mc * LUT_W; e += THREADS)
      lut_s[e] = lut_g[(int64_t)m0 * LUT_W + e];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int64_t p = p0 + tid + (int64_t)THREADS * i;
      if (p >= P) continue;
      const CodeT* c = codes + (g * P + p) * (int64_t)M + m0;
      float a = acc[i];
      for (int m = 0; m < mc; ++m)
        a += lut_s[m * LUT_W + (int)c[m]];
      acc[i] = a;
    }
  }

#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int64_t p = p0 + tid + (int64_t)THREADS * i;
    if (p < P) out[g * P + p] = acc[i];
  }
}

template <typename CodeT>
cudaError_t launch(const CodeT* codes, const float* lut, float* out,
                   int64_t G, int64_t P, int M, cudaStream_t stream) {
  const int mt = M < MT_MAX ? M : MT_MAX;
  const size_t smem = (size_t)mt * LUT_W * sizeof(float);
  // a launch asking for more than 48 KB of dynamic shared memory without
  // this opt-in is refused
  cudaError_t err = cudaFuncSetAttribute(
      adc_score_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t p_tiles = (P + TILE_P - 1) / TILE_P;
  adc_score_kernel<CodeT><<<(unsigned)(G * p_tiles), THREADS, smem,
                            stream>>>(codes, lut, out, P, M, p_tiles, mt);
  return cudaSuccess;
}

}  // namespace

// Launches on `stream` and returns at once; the caller checks the launch
// (the returned error is the shared-memory opt-in's).  The caller keeps
// G * ceil(P / 1024) within a grid's 2^31 - 1 blocks and M >= 1.
cudaError_t mo_adc_score_launch(const void* codes, bool codes_i32,
                                const float* lut, float* out, int64_t G,
                                int64_t P, int64_t M, cudaStream_t stream) {
  if (G == 0 || P == 0) return cudaSuccess;
  if (codes_i32)
    return launch(static_cast<const int32_t*>(codes), lut, out, G, P,
                  (int)M, stream);
  return launch(static_cast<const uint8_t*>(codes), lut, out, G, P, (int)M,
                stream);
}
