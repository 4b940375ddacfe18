// Pairwise squared L2 distance with the norm epilogue fused, for Hopper,
// with an optional row mask in the same epilogue.
//
// Replaces two Pallas TPU kernels (matrixone_tpu/ops/pallas_kernels.py):
// `l2_distance_sq_pallas` (body `_l2_kernel`)
//
//     out[i, j] = max((||x_i||^2 + q2[j]) - 2 * x_i . q_j, 0)
//
// and `l2_distance_sq_masked_pallas` (body `_l2_masked_kernel`), which
// writes +inf instead where mask[i] is false (a filtered-search
// prefilter).  Both share this one tile: the mask is a nullable pointer
// read only in the epilogue, so an all-true mask gives the unmasked bits.
//
// x [n, d] f32, q [b, d] f32, q2 [b] f32 (||q_j||^2, computed by the
// caller as the TPU version does), mask [n] bool or null, out [n, b]
// f32, all row-major and contiguous.  Any n, b and d, 0 included.
//
// What bounds it, by regime, and what the design does about it:
//
//  * d = 768 (exact truth, IVF probes): 2*n*b*d operations against
//    4*(n*d + b*d + n*b) bytes, ~110 a byte, so operations bound it.
//    IEEE f32 FMAs on the CUDA cores top out at 67 TFLOP/s; the product
//    runs on the tensor cores instead, in TF32 (495 TFLOP/s dense), with
//    each operand split so that the result keeps f32 accuracy (3xTF32):
//
//        v_big = tf32(v),  v_small = tf32(v - v_big)
//        x.q ~= x_small.q_big + x_big.q_small + x_big.q_big
//
//    tf32() rounds the 13 low mantissa bits to nearest, ties away (the
//    bits of `cvt.rna.tf32.f32`, formed with two integer operations:
//    the cvt compiles to a longer sequence that also handles NaN and
//    infinity); v - v_big is exact in f32.  The three products are
//    accumulated in f32 in that order at every depth-8 step.  The
//    dropped x_small.q_small is ~2^-22 of |x||q| and each kept product
//    is exact to ~2^-21, so at d = 768 the error stays well inside the
//    gate 1e-5*(x2+q2) + 1e-4 (chip_smoke.py prints it), where one TF32
//    pass (~2^-11 per product, ~0.027 at d = 768 against a gate of
//    ~0.017) would not; tests/test_torch_l2_split.py holds an emulation
//    of this arithmetic against f64.  ||x||^2 stays a true f32 sum of
//    v*v on the CUDA cores, taken from the x values of the A fragments
//    (never from the TF32 pieces); the epilogue keeps the reference's
//    order: (x2 + q2) - 2*acc, clamp at 0, then the mask.
//
//    The deep tile (d > 32) runs on `wgmma` (m64n128k8 TF32, async):
//    a block is two warpgroups, 128 rows of x by 128 rows of q.  A comes
//    from registers: each thread splits its own fragment values, so each
//    x value is split once.  B must come from shared memory: the q rows
//    of each stage are split by all threads into v_big and v_small
//    buffers in the 128-byte swizzle behind a matrix descriptor (depth
//    permuted within each 8 so that A's float2 loads line up), two
//    buffer pairs so that one stage's split overlaps the products of
//    the previous one.  The loads are a 3-stage `cp.async` ring, not
//    TMA: every value passes through a thread for its split anyway, and
//    the 4-byte path below needs the same layout.  The products of each
//    stage run into a fresh partial that is added to the running sum in
//    f32 once they have landed: the tensor cores truncate where they
//    accumulate, and at x ~ q (the exact truth's nearest rows) a single
//    running sum of ~||x||^2 truncated at each of 3 * d / 8 steps took
//    most of the gate.
//
//  * d = 8 (the IVF-PQ sub-k-means, the most launched shape): the work
//    is writing the [n, b] output (134 MB at n = 131072), so bytes bound
//    it.  The shallow tile (d <= 32) is the warp-level `mma.sync.m16n8k8`
//    TF32 with the same split, one stage and one depth-8 step at d = 8,
//    a 64 x 128 block of four warps in few registers (three blocks an
//    SM); the accumulator goes out through a per-warp shared-memory
//    staging tile as 16-byte streaming stores, whole 128-byte lines.
//
//  * small grids ((1024, 256, 768), (1024, 32, 768), (5226, 256, 768)):
//    too few output tiles to fill 132 SMs.  The depth is split over
//    `splits` blocks (blockIdx.y), each writing its partial products and
//    partial ||x||^2 into a workspace the caller allocates; a second
//    pass sums the parts in split order and applies the epilogue.  No
//    float atomics: two calls on the same inputs return the same bits.
//
// Both tiles load a stage as [BM + BN] rows of depth 32 (x rows, then q
// rows), 16-byte chunks swizzled by row (chunk ^ 2*(row % 4)) so that
// the fragment loads (float2 at depth 2t of row g: the mma's k = t and
// t + 4, the same permutation of depth on both operands) are free of
// bank conflicts.  Two load paths fill the same layout: 16-byte
// cp.async when d % 4 == 0 and x and q start on 16 bytes, else 4-byte
// cp.async (d = 65, 100, a slice x[s:] of odd d); out-of-range rows and
// depth are zero-filled.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BK = 32;          // depth of one pipeline stage, floats
constexpr int MAX_SPLITS = 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// zero-fills the 16 (4) bytes at dst without reading src when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// round to TF32 (nearest, ties away), low 13 bits cleared: the bits of
// `cvt.rna.tf32.f32` for every finite v, in two integer operations
// where the cvt compiles to a longer sequence that also handles NaN and
// infinity (a NaN input makes x2 NaN in any case)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));  // v - big is exact
}

__device__ __forceinline__ float epilogue(float x2, float q2, float acc,
                                          bool keep) {
  const float v = (x2 + q2) - 2.f * acc;
  return keep ? fmaxf(v, 0.f) : __int_as_float(0x7f800000);
}

// float offset of (row r, depth k) in a loaded stage: 16-byte chunk
// k / 4 swizzled by 2 * (r % 4)
__device__ __forceinline__ int swz(int r, int k) {
  return r * BK + ((((k >> 2) ^ ((r & 3) << 1))) << 2) + (k & 3);
}

// The block's output tile and depth range: rows [row0, row0 + BM) of x,
// rows [col0, col0 + BN) of q, depth tiles [kt_begin, + ktiles) of the
// split blockIdx.y.
struct BlockRange {
  int64_t row0, col0, k_base;
  int ktiles;
  __device__ BlockRange(int bm, int bn, int64_t d, int64_t col_tiles,
                        int kt_per_split) {
    row0 = ((int64_t)blockIdx.x / col_tiles) * bm;
    col0 = ((int64_t)blockIdx.x % col_tiles) * bn;
    const int64_t kt_total = (d + BK - 1) / BK;
    const int64_t kt_begin = (int64_t)blockIdx.y * kt_per_split;
    const int64_t left = kt_total - kt_begin;
    ktiles =
        (int)(left <= 0 ? 0 : (left < kt_per_split ? left : kt_per_split));
    k_base = kt_begin * BK;
  }
};

// Copies one stage, [BM + BN] rows of depth BK (x rows, then q rows),
// into shared memory in the swizzled layout of `swz`.  A thread copies
// the same depth slot (W floats at kw) of rows rfirst + i * RSTEP at
// every stage; rows past n or b and depth past d are zero-filled.
template <int BM, int BN, int THREADS, bool VEC>
struct StageLoader {
  static constexpr int W = VEC ? 4 : 1;
  static constexpr int PER_ROW = BK / W;
  static constexpr int RSTEP = THREADS / PER_ROW;
  static constexpr int XLOADS = BM / RSTEP, LOADS = (BM + BN) / RSTEP;
  static_assert(THREADS % PER_ROW == 0 && BM % RSTEP == 0 &&
                    BN % RSTEP == 0 && RSTEP % 4 == 0,
                "stage must split evenly, rows keeping their swizzle");
  const float* x;
  const float* xsrc;
  const float* qsrc;
  int64_t x_left, q_left, row_step, d;
  int kw, dst0;

  __device__ StageLoader(const float* x_, const float* q, int64_t n,
                         int64_t b, int64_t d_, const BlockRange& r)
      : x(x_), d(d_) {
    const int tid = threadIdx.x;
    kw = (tid % PER_ROW) * W;
    const int rfirst = tid / PER_ROW;
    x_left = n - r.row0 - rfirst;
    q_left = b - r.col0 - rfirst;
    row_step = (int64_t)RSTEP * d;
    xsrc = x + (r.row0 + rfirst) * d + kw;
    qsrc = q + (r.col0 + rfirst) * d + kw;
    dst0 = swz(rfirst, kw);  // + i * RSTEP * BK: the same swizzle
  }

  __device__ __forceinline__ void load(float* stage, int64_t k0) const {
    float* s = stage + dst0;
    const bool k_ok = k0 + kw < d;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const bool is_x = i < XLOADS;
      const int ii = is_x ? i : i - XLOADS;
      const bool ok = k_ok && (int64_t)ii * RSTEP < (is_x ? x_left : q_left);
      const float* src = ok ? (is_x ? xsrc : qsrc) + ii * row_step + k0 : x;
      if constexpr (VEC)
        cp_async16(smem_u32(s + i * RSTEP * BK), src, ok);
      else
        cp_async4(smem_u32(s + i * RSTEP * BK), src, ok);
    }
  }
};

// ------------------------------------------------------------ deep tile
namespace deep {

constexpr int WGS = 2;                      // warpgroups, 64 rows each
constexpr int THREADS = 128 * WGS;
constexpr int BM = 64 * WGS;
constexpr int BN = 128;                     // the wgmma's N
constexpr int STAGES = 3;
constexpr int RAW_FLOATS = (BM + BN) * BK;  // one loaded stage
constexpr int B_FLOATS = BN * BK;           // one split B buffer, 16 KB
constexpr int B_BYTES = B_FLOATS * 4;
// [2 stages in flight][v_big, v_small] B buffers (1024-byte aligned for
// the 128-byte swizzle), then the ring of loaded stages
constexpr int SMEM_BYTES = 4 * B_BYTES + STAGES * RAW_FLOATS * 4;
constexpr int SSTG = BN + 8;                // staging row stride, floats
static_assert(THREADS / 32 * 16 * SSTG * 4 <= SMEM_BYTES, "staging fits");

// shared-memory matrix descriptor of a K-major B tile of BN rows of 128
// bytes in the 128-byte swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// orders the compiler's use of the accumulator after a wait
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B for a 64 x 128 tile of depth 8: A from registers (the
// m16n8k8 fragment layout, one 16-row slice a warp), B from shared
// memory; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// One block: a BM x BN tile of out (or, with `x2_part` set, of split
// blockIdx.y's partial products in `out` and partial ||x||^2 in
// `x2_part`).
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
l2_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ q,
                const float* __restrict__ q2, const bool* __restrict__ mask,
                float* __restrict__ out, float* __restrict__ x2_part,
                int64_t n, int64_t b, int64_t d, int64_t col_tiles,
                int kt_per_split) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* bufs = reinterpret_cast<float*>(smem);
  float* ring = reinterpret_cast<float*>(smem + 4 * B_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const BlockRange br(BM, BN, d, col_tiles, kt_per_split);
  const bool raw = x2_part != nullptr;
  if (raw) {
    out += (int64_t)blockIdx.y * n * b;
    x2_part += (int64_t)blockIdx.y * n;
  }
  const StageLoader<BM, BN, THREADS, VEC> loader(x, q, n, b, d, br);

  // the running sum, and the products of the stage in flight: the
  // tensor cores truncate where they accumulate, so each stage sums
  // apart and is added in f32 once it has landed (at x ~ q, acc ~
  // ||x||^2 would lose up to 2^-23 of itself at each of 3 * d / 8 steps)
  float total[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = part[i] = 0.f;
  float x2p[2] = {0.f, 0.f};
  const int ra = 16 * warp + g;  // rows ra and ra + 8 of the A fragments

  // Stage kt: split its q rows into the B buffers and its x rows into
  // A registers while the products of stage kt - 1 run, then add those
  // to the total and issue this stage's.
  auto stage = [&](int kt, uint32_t (&ab)[4][4], uint32_t (&as)[4][4]) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free
    const int pf = kt + STAGES - 1;
    if (pf < br.ktiles)
      loader.load(ring + (pf % STAGES) * RAW_FLOATS,
                  br.k_base + (int64_t)pf * BK);
    cp_async_commit();
    const float* st = ring + (kt % STAGES) * RAW_FLOATS;
    const int64_t k0 = br.k_base + (int64_t)kt * BK;

    // B: v_big and v_small of each q row in the 128-byte swizzle, the
    // depth of each 8 permuted (0, 2, 4, 6, 1, 3, 5, 7) so that A's
    // float2 at depth (2t, 2t + 1) is the wgmma's k = (t, t + 4); the
    // buffers of stage kt - 2 are free (its products have landed)
    float* bb = bufs + (kt & 1) * 2 * B_FLOATS;
    float* bs = bb + B_FLOATS;
#pragma unroll
    for (int gi = 0; gi < BN * (BK / 8) / THREADS; ++gi) {
      const int gid = gi * THREADS + tid, qn = gid >> 2, G = gid & 3;
      const int r = BM + qn;
      const float4 lo = *reinterpret_cast<const float4*>(st + swz(r, 8 * G));
      const float4 hi =
          *reinterpret_cast<const float4*>(st + swz(r, 8 * G + 4));
      const float v[8] = {lo.x, lo.z, hi.x, hi.z, lo.y, lo.w, hi.y, hi.w};
      uint32_t vb[8], vs[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) split_tf32(v[e], vb[e], vs[e]);
      const int c0 = ((2 * G) ^ (qn & 7)) << 2;
      const int c1 = ((2 * G + 1) ^ (qn & 7)) << 2;
      *reinterpret_cast<uint4*>(bb + qn * BK + c0) =
          make_uint4(vb[0], vb[1], vb[2], vb[3]);
      *reinterpret_cast<uint4*>(bb + qn * BK + c1) =
          make_uint4(vb[4], vb[5], vb[6], vb[7]);
      *reinterpret_cast<uint4*>(bs + qn * BK + c0) =
          make_uint4(vs[0], vs[1], vs[2], vs[3]);
      *reinterpret_cast<uint4*>(bs + qn * BK + c1) =
          make_uint4(vs[4], vs[5], vs[6], vs[7]);
    }
    // A: this thread's fragments of the stage, split in registers (rows
    // ra and ra + 8 are g modulo 4, so one offset serves both);
    // ||x||^2 from the same values
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const int off = swz(g, kk * 8 + 2 * t) - g * BK;
      const float2 lo = *reinterpret_cast<const float2*>(st + ra * BK + off);
      const float2 hi =
          *reinterpret_cast<const float2*>(st + (ra + 8) * BK + off);
      x2p[0] = fmaf(lo.x, lo.x, x2p[0]);
      x2p[0] = fmaf(lo.y, lo.y, x2p[0]);
      x2p[1] = fmaf(hi.x, hi.x, x2p[1]);
      x2p[1] = fmaf(hi.y, hi.y, x2p[1]);
      split_tf32(lo.x, ab[kk][0], as[kk][0]);  // (g,     k = t)
      split_tf32(hi.x, ab[kk][1], as[kk][1]);  // (g + 8, k = t)
      split_tf32(lo.y, ab[kk][2], as[kk][2]);  // (g,     k = t + 4)
      split_tf32(hi.y, ab[kk][3], as[kk][3]);  // (g + 8, k = t + 4)
    }
    // the generic-proxy stores to B, visible to the tensor cores
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    wgmma_wait_all();  // stage kt - 1's products have landed
    fence_regs(part);
    if (kt > 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += part[i];
    }
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      if (k0 + kk * 8 >= d) break;  // zero-filled depth
      const uint64_t db = desc_sw128(bb + kk * 8);
      const uint64_t ds = desc_sw128(bs + kk * 8);
      wgmma_tf32(part, as[kk], db, kk);  // kk = 0: a fresh partial
      wgmma_tf32(part, ab[kk], ds, 1);
      wgmma_tf32(part, ab[kk], db, 1);
    }
    wgmma_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < br.ktiles)
      loader.load(ring + s * RAW_FLOATS, br.k_base + (int64_t)s * BK);
    cp_async_commit();
  }
  // two register sets for A: one feeds the products in flight while the
  // next stage fills the other
  uint32_t ab0[4][4], as0[4][4], ab1[4][4], as1[4][4];
  for (int kt = 0; kt < br.ktiles; kt += 2) {
    stage(kt, ab0, as0);
    if (kt + 1 < br.ktiles) stage(kt + 1, ab1, as1);
  }
  wgmma_wait_all();
  fence_regs(part);
  if (br.ktiles > 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] += part[i];
  }
  cp_async_wait<0>();
  __syncthreads();  // every buffer is free: the staging tiles reuse them

  // ||x||^2: the four lanes t of a quad hold partial sums of rows g and
  // g + 8 of this warp's 16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    x2p[h] += __shfl_xor_sync(0xffffffffu, x2p[h], 1);
    x2p[h] += __shfl_xor_sync(0xffffffffu, x2p[h], 2);
  }
  const int64_t wrow0 = br.row0 + 16 * warp;
  if (raw && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = wrow0 + g + 8 * h;
      if (row < n) x2_part[row] = x2p[h];
    }
  }
  // the warp's 16 x 128 accumulator tile (element 4j + 2h + e at row
  // g + 8h, column 8j + 2t + e) through shared memory, then whole rows
  float* stg = reinterpret_cast<float*>(smem) + warp * 16 * SSTG;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = wrow0 + g + 8 * h;
    const bool keep = raw || mask == nullptr || (row < n && mask[row]);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t;
      float v0 = total[4 * j + 2 * h], v1 = total[4 * j + 2 * h + 1];
      if (!raw) {
        const int64_t col = br.col0 + c;
        v0 = epilogue(x2p[h], col < b ? q2[col] : 0.f, v0, keep);
        v1 = epilogue(x2p[h], col + 1 < b ? q2[col + 1] : 0.f, v1, keep);
      }
      *reinterpret_cast<float2*>(stg + (g + 8 * h) * SSTG + c) =
          make_float2(v0, v1);
    }
  }
  __syncwarp();
  if ((b & 3) == 0) {
    // 32 lanes x 16 bytes: one 512-byte row a store instruction; the
    // output streams past the L2, a split's parts stay there
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      const int64_t row = wrow0 + r, col = br.col0 + 4 * lane;
      if (row >= n || col >= b) continue;
      const float4 v =
          *reinterpret_cast<const float4*>(stg + r * SSTG + 4 * lane);
      if (raw)
        *reinterpret_cast<float4*>(out + row * b + col) = v;
      else
        __stcs(reinterpret_cast<float4*>(out + row * b + col), v);
    }
  } else {
    for (int r = 0; r < 16; ++r) {
      const int64_t row = wrow0 + r;
      if (row >= n) break;
#pragma unroll
      for (int c = lane; c < BN; c += 32)
        if (br.col0 + c < b) out[row * b + br.col0 + c] = stg[r * SSTG + c];
    }
  }
}

}  // namespace deep

// --------------------------------------------------------- shallow tile
namespace shallow {

constexpr int WM = 64;          // rows of x per warp
constexpr int WN = 32;          // rows of q per warp
constexpr int MT = WM / 16;     // m16 fragments per warp
constexpr int NT = WN / 8;      // n8 fragments per warp
constexpr int WARPS = 4;        // side by side
constexpr int THREADS = 32 * WARPS;
constexpr int BM = WM;
constexpr int BN = WN * WARPS;
constexpr int STG = WN + 8;     // staging row stride, floats
constexpr int STAGE_BYTES = (BM + BN) * BK * 4;
// the per-warp staging tiles of the epilogue, then ||x||^2 of BM rows
constexpr int STAGING_BYTES = WARPS * 16 * STG * 4;
constexpr int SMEM_BYTES =
    STAGE_BYTES > STAGING_BYTES + BM * 4 ? STAGE_BYTES
                                         : STAGING_BYTES + BM * 4;

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d <= 32: one stage, one block a BM x BN tile of out; each warp the
// 64 x 32 block of its column band as 4 x 4 m16n8 fragments (a warp
// whose band lies past b idles)
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 3)
l2_mma_kernel(const float* __restrict__ x, const float* __restrict__ q,
              const float* __restrict__ q2, const bool* __restrict__ mask,
              float* __restrict__ out, int64_t n, int64_t b, int64_t d,
              int64_t col_tiles) {
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const BlockRange br(BM, BN, d, col_tiles, 1);
  const bool active = br.col0 + warp * WN < b;
  if (br.ktiles > 0) {
    StageLoader<BM, BN, THREADS, VEC>(x, q, n, b, d, br).load(smem, 0);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  float acc[MT][NT][4];
  float x2p[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    x2p[i][0] = x2p[i][1] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
  const float* xs = smem;
  const float* qs = smem + (BM + warp * WN) * BK;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    if (!active || kk * 8 >= d) break;  // zero-filled depth
    // (row g, depth 2t and 2t + 1 of the step): the mma's k = t and
    // t + 4; every row below is g modulo 4, so one offset serves all
    const int off = swz(g, kk * 8 + 2 * t) - g * BK;
    uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float2 lo =
          *reinterpret_cast<const float2*>(xs + (i * 16 + g) * BK + off);
      const float2 hi =
          *reinterpret_cast<const float2*>(xs + (i * 16 + g + 8) * BK + off);
      if (warp == 0) {  // one warp sums ||x||^2
        x2p[i][0] = fmaf(lo.x, lo.x, x2p[i][0]);
        x2p[i][0] = fmaf(lo.y, lo.y, x2p[i][0]);
        x2p[i][1] = fmaf(hi.x, hi.x, x2p[i][1]);
        x2p[i][1] = fmaf(hi.y, hi.y, x2p[i][1]);
      }
      split_tf32(lo.x, ab[i][0], as[i][0]);  // (g,     k = t)
      split_tf32(hi.x, ab[i][1], as[i][1]);  // (g + 8, k = t)
      split_tf32(lo.y, ab[i][2], as[i][2]);  // (g,     k = t + 4)
      split_tf32(hi.y, ab[i][3], as[i][3]);  // (g + 8, k = t + 4)
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 v =
          *reinterpret_cast<const float2*>(qs + (j * 8 + g) * BK + off);
      split_tf32(v.x, bb[j][0], bs[j][0]);  // (k = t,     n = g)
      split_tf32(v.y, bb[j][1], bs[j][1]);  // (k = t + 4, n = g)
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], as[i], bb[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ab[i], bs[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ab[i], bb[j]);
  }
  __syncthreads();  // the stage is free: the staging tiles reuse it

  // ||x||^2: the four lanes t of a quad of warp 0 hold the partial sums
  // of rows g and g + 8 of each fragment; they pass them on through
  // shared memory past the staging tiles
  float* x2s = smem + STAGING_BYTES / 4;
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = x2p[i][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) x2s[i * 16 + g + 8 * h] = v;
      }
  }
  __syncthreads();
  if (!active) return;

  const int64_t wcol0 = br.col0 + warp * WN;
  float q2v[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int64_t col = wcol0 + j * 8 + 2 * t + e;
      q2v[j][e] = col < b ? q2[col] : 0.f;
    }
  float* stg = smem + warp * 16 * STG;
  const bool vec_out = (b & 3) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = br.row0 + i * 16 + g + 8 * h;
      const bool keep = mask == nullptr || (row < n && mask[row]);
      const float x2 = x2s[i * 16 + g + 8 * h];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(stg + (g + 8 * h) * STG + j * 8 + 2 * t) =
            make_float2(epilogue(x2, q2v[j][0], acc[i][j][2 * h], keep),
                        epilogue(x2, q2v[j][1], acc[i][j][2 * h + 1], keep));
    }
    __syncwarp();
    const int64_t frow0 = br.row0 + i * 16;
    if (vec_out) {
      // 8 lanes to a row: each store instruction writes 4 whole rows of
      // 32 floats (128-byte lines), streaming past the L2
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int r = (lane >> 3) + 4 * p, c = (lane & 7) * 4;
        const int64_t row = frow0 + r, col = wcol0 + c;
        if (row < n && col < b)
          __stcs(reinterpret_cast<float4*>(out + row * b + col),
                 *reinterpret_cast<const float4*>(stg + r * STG + c));
      }
    } else {
      const int64_t col = wcol0 + lane;
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        const int64_t row = frow0 + r;
        if (row < n && col < b) out[row * b + col] = stg[r * STG + lane];
      }
    }
    __syncwarp();
  }
}

}  // namespace shallow

// The split-K second pass: out = epilogue(sum of the parts, in split
// order), V consecutive outputs of one row a thread (V = 4 when b % 4
// == 0: 16-byte loads and stores).
template <int V>
__global__ void __launch_bounds__(256)
l2_split_reduce_kernel(const float* __restrict__ part,
                       const float* __restrict__ x2_part,
                       const float* __restrict__ q2,
                       const bool* __restrict__ mask, float* __restrict__ out,
                       int64_t n, int64_t b, int splits) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int64_t nb = n * b;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
       i < nb; i += (int64_t)gridDim.x * blockDim.x * V) {
    const int64_t row = i / b, col = i - row * b;
    float x2 = 0.f, acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    for (int s = 0; s < splits; ++s) {
      const Vec p = *reinterpret_cast<const Vec*>(part + s * nb + i);
      const float* pv = reinterpret_cast<const float*>(&p);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] += pv[e];
      x2 += x2_part[s * n + row];
    }
    const bool keep = mask == nullptr || mask[row];
    Vec o;
    float* ov = reinterpret_cast<float*>(&o);
#pragma unroll
    for (int e = 0; e < V; ++e)
      ov[e] = epilogue(x2, q2[col + e], acc[e], keep);
    __stcs(reinterpret_cast<Vec*>(out + i), o);
  }
}

// ---------------------------------------------------------------- plan
constexpr int MAX_DEVICES = 64;

int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    dev = 0;
  return dev;
}

// the SM count of the current device, asked once a device
int sm_count() {
  static int cached[MAX_DEVICES];
  const int dev = current_device();
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
    cached[dev] = sms;
  }
  return cached[dev];
}

// d <= BK runs the shallow tile, one block a tile; deeper d the deep
// tile, the depth split while the tiles fill under two blocks an SM,
// each split keeping at least two depth tiles
struct Plan {
  bool deep;
  int64_t col_tiles, tiles;
  int splits, kt_per_split;
};

Plan make_plan(int64_t n, int64_t b, int64_t d, int sms) {
  Plan p{};
  p.deep = d > BK;
  const int bm = p.deep ? deep::BM : shallow::BM;
  const int bn = p.deep ? deep::BN : shallow::BN;
  p.col_tiles = (b + bn - 1) / bn;
  p.tiles = ((n + bm - 1) / bm) * p.col_tiles;
  const int64_t kt_total = (d + BK - 1) / BK;
  int splits = 1;
  while (p.deep && splits < MAX_SPLITS && p.tiles * splits < 2 * sms &&
         kt_total >= 4 * (int64_t)splits)
    splits *= 2;
  p.kt_per_split = kt_total == 0 ? 1 : (int)((kt_total + splits - 1) / splits);
  p.splits = (int)((kt_total + p.kt_per_split - 1) / p.kt_per_split);
  if (p.splits < 1) p.splits = 1;  // d = 0
  return p;
}

// above 48 KB of dynamic shared memory a launch needs the opt-in, once a
// kernel and device (without it the launch is refused)
template <typename K>
cudaError_t opt_in(K kernel, int slot, int bytes) {
  static bool done[MAX_DEVICES][4];
  bool& d = done[current_device()][slot];
  if (d) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  d = err == cudaSuccess;
  return err;
}

cudaError_t launch_plan(const Plan& p, const float* x, const float* q,
                        const float* q2, const bool* mask, float* out,
                        float* workspace, int64_t n, int64_t b, int64_t d,
                        int sms, cudaStream_t stream) {
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  cudaError_t err;
  if (!p.deep) {
    auto kernel = vec ? shallow::l2_mma_kernel<true>
                      : shallow::l2_mma_kernel<false>;
    if ((err = opt_in(kernel, vec ? 1 : 0, shallow::SMEM_BYTES)))
      return err;
    kernel<<<(unsigned)p.tiles, shallow::THREADS, shallow::SMEM_BYTES,
             stream>>>(x, q, q2, mask, out, n, b, d, p.col_tiles);
    return cudaGetLastError();
  }
  float* part = p.splits > 1 ? workspace : out;
  float* x2_part = p.splits > 1 ? workspace + (int64_t)p.splits * n * b
                                : nullptr;
  auto kernel = vec ? deep::l2_wgmma_kernel<true>
                    : deep::l2_wgmma_kernel<false>;
  if ((err = opt_in(kernel, vec ? 3 : 2, deep::SMEM_BYTES))) return err;
  kernel<<<dim3((unsigned)p.tiles, (unsigned)p.splits), deep::THREADS,
           deep::SMEM_BYTES, stream>>>(x, q, q2, mask, part, x2_part, n, b,
                                       d, p.col_tiles, p.kt_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const bool vec_out = b % 4 == 0;
  const int64_t groups = n * b / (vec_out ? 4 : 1);
  int64_t blocks = (groups + 255) / 256;
  if (blocks > 8 * (int64_t)sms) blocks = 8 * (int64_t)sms;
  if (vec_out)
    l2_split_reduce_kernel<4><<<(unsigned)blocks, 256, 0, stream>>>(
        part, x2_part, q2, mask, out, n, b, p.splits);
  else
    l2_split_reduce_kernel<1><<<(unsigned)blocks, 256, 0, stream>>>(
        part, x2_part, q2, mask, out, n, b, p.splits);
  return cudaGetLastError();
}

}  // namespace

// Floats of workspace a call at (n, b, d) needs on the current device:
// 0, or splits * (n * b + n) when the depth is split.
int64_t mo_l2_distance_sq_workspace(int64_t n, int64_t b, int64_t d) {
  if (n == 0 || b == 0) return 0;
  const Plan p = make_plan(n, b, d, sm_count());
  return p.splits > 1 ? (int64_t)p.splits * (n * b + n) : 0;
}

// Launches on `stream` and returns at once with the launch's error.
// `mask` [n] may be null (no row masked); `workspace` holds
// mo_l2_distance_sq_workspace(n, b, d) floats (null when that is 0).
cudaError_t mo_l2_distance_sq_launch(const float* x, const float* q,
                                     const float* q2, const bool* mask,
                                     float* out, float* workspace, int64_t n,
                                     int64_t b, int64_t d,
                                     cudaStream_t stream) {
  if (n == 0 || b == 0) return cudaSuccess;
  const int sms = sm_count();
  return launch_plan(make_plan(n, b, d, sms), x, q, q2, mask, out, workspace,
                     n, b, d, sms, stream);
}

// Registers, static and local (spill) bytes of each tile kernel, 6
// int64 each: deep (the wgmma tile, d > 32), 16-byte loads, registers,
// static shared bytes, local bytes, max threads.  Returns the number of
// kernels written (at most `cap`), or -1.
int mo_l2_kernel_attributes(int64_t* rows, int cap) {
  struct K {
    const void* fn;
    int deep, vec;
  } ks[] = {
      {(const void*)deep::l2_wgmma_kernel<true>, 1, 1},
      {(const void*)deep::l2_wgmma_kernel<false>, 1, 0},
      {(const void*)shallow::l2_mma_kernel<true>, 0, 1},
      {(const void*)shallow::l2_mma_kernel<false>, 0, 0},
  };
  int k = 0;
  for (const K& e : ks) {
    if (k == cap) break;
    cudaFuncAttributes a{};
    if (cudaFuncGetAttributes(&a, e.fn) != cudaSuccess) return -1;
    int64_t* r = rows + 6 * k++;
    r[0] = e.deep; r[1] = e.vec; r[2] = a.numRegs;
    r[3] = (int64_t)a.sharedSizeBytes; r[4] = (int64_t)a.localSizeBytes;
    r[5] = a.maxThreadsPerBlock;
  }
  return k;
}
