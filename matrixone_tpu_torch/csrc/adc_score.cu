// IVF-PQ asymmetric-distance (ADC) scoring, for Hopper.
//
// Replaces the Pallas TPU kernel `adc_score_pallas`
// (matrixone_tpu/ops/pallas_kernels.py, body `_adc_kernel`):
//
//     out[g, p] = sum_m lut[g, m, codes[g, p, m]]
//
// in two forms that share one kernel body:
//
//  * dense, the TPU kernel's signature: codes [G, P, M] uint8 or int32
//    (values in [0, 256)), lut [G, M, 256] f32 -> out [G, P] f32;
//  * lists, what the IVF-PQ search needs: codes [n, M] are the index's
//    inverted lists, contiguous and cluster-major, group g scores rows
//    starts[g] .. ends[g] - 1 into lanes 0 .. len - 1 of out [G, pad],
//    and lanes len .. pad - 1 are +inf.  That is
//    where(valid, dense(codes[cand], lut), inf) of the search's padded
//    candidate gather, without the gather: the rows are read where they
//    lie, and the pad lanes are written without being scored.
//
// Each candidate's M entries are summed in m order in f32, one thread a
// candidate, so the two forms give the same bits on every scored lane.
// Lists longer than pad are cut to pad.
// The TPU kernel scores a tile as a one-hot [tile, M*256] @ [M*256]
// matmul, because a TPU has no per-lane gather; Hopper has one.
//
// What bounds it: the bytes, read once: the scored rows' codes, the LUT
// (4 * G * M * 256) and the output (4 * G * pad), against one f32 add a
// code, at 3.35 TB/s on an H100 SXM.  The LUT lookups come next: each is
// a 4-byte shared-memory load at a random bank (bank = code % 32), so a
// warp's 32 lookups take about 3.5 passes of the 32 banks on random
// codes.  chip_smoke.py measures that cost at the search's shape by
// timing codes whose lookups never share a bank; nothing here works
// around the conflicts.
//
// Design: a block of 512 threads owns one group's share of up to 2048
// lanes (four tiles of 512 rows, one row a thread a tile).  A share
// past the list's end only writes its +inf lanes and exits, so the grid
// (G * ceil(pad / 2048) blocks) needs no lengths on the host.  A block
// with rows stages the group's LUT in dynamic shared memory once, then
// streams its code tiles through a ring of two: every copy a 16-byte
// `cp.async`, the LUT and each tile in a commit group of their own, each
// tile scored as it lands while the next one loads.  The code rows are
// contiguous [rows, M] bytes, so the copies are coalesced; in shared
// memory each row sits at a stride of an odd number of 16-byte chunks
// (112 bytes at M = 96), so the 16-byte reads a thread makes of its row
// hit every bank once per quarter warp.  At M = 96 with uint8 codes that
// is 96 KB of LUT + 112 KB of codes, 208 KB, one block an SM.  A larger
// M is scored in m-tiles, as many subspaces as fit beside the code tiles
// (112 of uint8 codes, 44 of int32), with the sums carried in registers,
// the same order.  Rows whose bytes are not 16-byte aligned (M *
// sizeof(code) % 16 != 0, or a base off 16 bytes) take a plain-load path
// into a layout of odd 4-byte words and read one code at a time; it sums
// in the same order.
//
// The block shape trades two costs.  The search's probed lists run
// close to the cap (about 3700 rows at pad 3968): a share of 1024 lanes
// stages such a group's 96 KB LUT four times over (as many bytes again
// as its codes), while one block a group (a share of 4096) leaves an SM
// a whole group's serial work with no other block to overlap it.  512
// threads and a share of 2048 sit between the two.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int LUT_W = 256;                 // entries per subspace
constexpr int MAX_SMEM = 227 * 1024;       // a block's shared memory

// The block shape: THREADS threads, one row a thread a tile; a block owns
// TILES tiles (a share of THREADS * TILES lanes) and keeps STAGES of them
// in shared memory at once.
constexpr int THREADS = 512;
constexpr int TILES = 4;
constexpr int STAGES = 2;
constexpr int SHARE = THREADS * TILES;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory row stride in bytes of a code tile with `row_bytes`
// bytes a row: an odd number of 16-byte chunks for the 16-byte path, an
// odd number of 4-byte words for the plain path.
__host__ __device__ inline int tile_stride(int row_bytes, bool vec) {
  const int unit = vec ? 16 : 4;
  int units = (row_bytes + unit - 1) / unit;
  if (units % 2 == 0) ++units;
  return units * unit;
}

struct Args {
  const void* codes;        // dense: [G, P, M]; lists: [n, M]
  const int32_t* starts;    // lists: [G]; dense: null
  const int32_t* ends;      // lists: [G]
  int64_t rows;             // dense: P; lists: n
  const float* lut;         // [G, M, 256]
  float* out;               // [G, pad]
  int64_t pad;              // dense: P
  int M, mt, shares, stride;
};

template <typename CodeT, bool VEC>
__global__ void __launch_bounds__(THREADS) adc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);           // [mt][256]
  // [STAGES][THREADS][stride]
  unsigned char* code_s = smem + (size_t)a.mt * LUT_W * 4;
  const int tid = threadIdx.x;
  const int64_t g = blockIdx.x / a.shares;
  const int64_t lane0 = (int64_t)(blockIdx.x % a.shares) * SHARE;

  int64_t base, len;
  if (a.starts != nullptr) {
    int64_t s = a.starts[g], e = a.ends[g];
    s = s < 0 ? 0 : s;
    e = e > a.rows ? a.rows : e;
    base = s;
    len = e > s ? e - s : 0;
  } else {
    base = g * a.rows;
    len = a.rows;
  }
  len = len < a.pad ? len : a.pad;  // a list longer than pad is cut to it
  float* out_g = a.out + g * a.pad;
  const int64_t lane_end =
      lane0 + SHARE < a.pad ? lane0 + SHARE : a.pad;
  for (int64_t p = (len > lane0 ? len : lane0) + tid; p < lane_end;
       p += THREADS)
    out_g[p] = CUDART_INF_F;
  if (lane0 >= len) return;

  const int rows = (int)(len - lane0 < SHARE ? len - lane0 : SHARE);
  const CodeT* src =
      static_cast<const CodeT*>(a.codes) + (base + lane0) * (int64_t)a.M;
  const float* lut_g = a.lut + g * (int64_t)a.M * LUT_W;
  const int tile_bytes = THREADS * a.stride;

  float acc[TILES];
#pragma unroll
  for (int t = 0; t < TILES; ++t) acc[t] = 0.f;

  for (int m0 = 0; m0 < a.M; m0 += a.mt) {
    const int mc = a.mt < a.M - m0 ? a.mt : a.M - m0;
    const int cpr = mc * (int)sizeof(CodeT) / 16;  // 16-byte chunks a row
    // rows r0 .. r0 + THREADS - 1 of this m-tile into buffer `buf`
    auto load_tile = [&](int t, int buf) {
      const int r0 = t * THREADS;
      const int nr = rows - r0 < THREADS ? rows - r0 : THREADS;
      unsigned char* dst = code_s + (size_t)buf * tile_bytes;
      if (VEC) {
        for (int e = tid; e < nr * cpr; e += THREADS) {
          const int r = e / cpr, c = e - r * cpr;
          const CodeT* row = src + (int64_t)(r0 + r) * a.M + m0;
          cp_async16(dst + r * a.stride + c * 16,
                     reinterpret_cast<const unsigned char*>(row) + c * 16);
        }
      } else {
        CodeT* cs = reinterpret_cast<CodeT*>(dst);
        const int es = a.stride / (int)sizeof(CodeT);  // elements a row
        for (int e = tid; e < nr * mc; e += THREADS) {
          const int r = e / mc, c = e - r * mc;
          cs[r * es + c] = src[(int64_t)(r0 + r) * a.M + m0 + c];
        }
      }
    };

    __syncthreads();  // the previous m-tile's LUT and codes are read
    // the LUT tile (mc KB) in one commit group, then STAGES code tiles,
    // each in its own group (empty groups are fine)
    if (VEC) {
      const float4* lsrc = reinterpret_cast<const float4*>(lut_g + m0 * LUT_W);
      float4* ldst = reinterpret_cast<float4*>(lut_s);
      for (int e = tid; e < mc * (LUT_W / 4); e += THREADS)
        cp_async16(ldst + e, lsrc + e);
    } else {
      for (int e = tid; e < mc * LUT_W; e += THREADS)
        lut_s[e] = lut_g[m0 * LUT_W + e];
    }
    cp_async_commit();
#pragma unroll
    for (int t = 0; t < STAGES; ++t) {
      if (t < TILES && t * THREADS < rows) load_tile(t, t);
      cp_async_commit();
    }

#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      // after tile t, STAGES - 1 groups may still be in flight
      cp_async_wait<STAGES - 1>();
      __syncthreads();
      const int r = t * THREADS + tid;
      if (r < rows) {
        float s = acc[t];
        const unsigned char* row =
            code_s + (size_t)(t % STAGES) * tile_bytes + (size_t)tid * a.stride;
        if (VEC) {
          constexpr int PER = 16 / (int)sizeof(CodeT);  // codes a chunk
          const int chunks = mc / PER;
          for (int c = 0; c < chunks; ++c) {
            const uint4 v = *reinterpret_cast<const uint4*>(row + c * 16);
            const CodeT* cv = reinterpret_cast<const CodeT*>(&v);
            const float* l = lut_s + c * PER * LUT_W;
#pragma unroll
            for (int k = 0; k < PER; ++k)
              s += l[k * LUT_W + (int)cv[k]];
          }
        } else {
          const CodeT* cv = reinterpret_cast<const CodeT*>(row);
          for (int k = 0; k < mc; ++k) s += lut_s[k * LUT_W + (int)cv[k]];
        }
        acc[t] = s;
      }
      // one group an iteration, empty or not, keeps the count of groups
      // after tile t + 1 at STAGES - 1
      if (STAGES < TILES) {
        __syncthreads();  // buffer t % STAGES is read: refill it
        const int nt = t + STAGES;
        if (nt < TILES && nt * THREADS < rows) load_tile(nt, t % STAGES);
      }
      cp_async_commit();
    }
  }

#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    const int r = t * THREADS + tid;
    if (r < rows) out_g[lane0 + r] = acc[t];
  }
}

template <typename CodeT, bool VEC>
size_t smem_bytes(int mt) {
  return (size_t)mt * LUT_W * 4 +
         (size_t)STAGES * THREADS *
             tile_stride(mt * (int)sizeof(CodeT), VEC);
}

// The m-tile: as many subspaces as fit beside the code tiles, a multiple
// of 16 bytes of codes.
template <typename CodeT, bool VEC>
int pick_mt(int M) {
  const int step = 16 / (int)sizeof(CodeT);
  int mt = M;
  while (mt > step && smem_bytes<CodeT, VEC>(mt) > (size_t)MAX_SMEM)
    mt = (mt - 1) / step * step;
  return mt;
}

template <typename CodeT, bool VEC>
cudaError_t launch(Args a, int64_t G, cudaStream_t stream) {
  a.shares = (int)((a.pad + SHARE - 1) / SHARE);
  a.mt = pick_mt<CodeT, VEC>(a.M);
  a.stride = tile_stride(a.mt * (int)sizeof(CodeT), VEC);
  const size_t smem = smem_bytes<CodeT, VEC>(a.mt);
  // a launch asking for more than 48 KB of dynamic shared memory without
  // this opt-in is refused
  cudaError_t err = cudaFuncSetAttribute(
      adc_kernel<CodeT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  adc_kernel<CodeT, VEC>
      <<<(unsigned)(G * a.shares), THREADS, smem, stream>>>(a);
  return cudaSuccess;
}

template <typename CodeT>
cudaError_t dispatch(Args a, int64_t G, cudaStream_t stream) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(a.codes) % 16 == 0) &&
      ((int64_t)a.M * (int64_t)sizeof(CodeT)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(a.lut) % 16 == 0);
  if (aligned) return launch<CodeT, true>(a, G, stream);
  return launch<CodeT, false>(a, G, stream);
}

}  // namespace

// Launches on `stream` and returns at once; the caller checks the launch
// (the returned error is the shared-memory opt-in's).  Dense form:
// starts = ends = null, rows = P, pad = P.  List form: rows = n, and the
// caller keeps 0 <= starts[g] <= ends[g] <= n (the kernel clamps to that
// range rather than read outside it).  The caller keeps M >= 1, pad >= 1
// and G * ceil(pad / 2048) within a grid's 2^31 - 1 blocks.
cudaError_t mo_adc_score_launch(const void* codes, bool codes_i32,
                                const int32_t* starts, const int32_t* ends,
                                int64_t rows, const float* lut, float* out,
                                int64_t G, int64_t pad, int64_t M,
                                cudaStream_t stream) {
  if (G == 0 || pad == 0) return cudaSuccess;
  Args a;
  a.codes = codes;
  a.starts = starts;
  a.ends = ends;
  a.rows = rows;
  a.lut = lut;
  a.out = out;
  a.pad = pad;
  a.M = (int)M;
  if (codes_i32) return dispatch<int32_t>(a, G, stream);
  return dispatch<uint8_t>(a, G, stream);
}
