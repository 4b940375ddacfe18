// GROUP BY float segment sum, for Hopper.
//
// Replaces the Pallas TPU kernel `segment_sum_pallas`
// (matrixone_tpu/ops/pallas_kernels.py, body `_segsum_kernel`):
//
//     out[g] = sum of values[i] over the rows i with mask[i] and
//              gids[i] == g,  for 0 <= g < G
//
// values [n] f32, gids [n] int32, mask [n] bool, out [G] f32, G <= 4096.
// A masked row never lands anywhere, whatever its gid or value (the TPU
// kernel's id-G rule), and an unmasked row whose gid lies outside [0, G)
// is dropped, as XLA's segment_sum drops it.  An unmasked NaN or inf
// lands in its own group only.  Any n: the TPU kernel's padding to its
// 512-row tile is a rule of its tiling.
//
// The TPU kernel builds a one-hot [tile, G] matrix per tile and reduces
// it with one MXU matmul, accumulated over a sequential grid, so it gives
// the same bits on every run.  Hopper blocks run in parallel and in no
// order, and float atomics add in no fixed order, so nothing here adds
// with an atomic: every sum is taken in an order fixed by n, G, the
// alignment and the SM count, and the same inputs give the same bits on
// every launch.  One launch (`segsum`), in one of two plans:
//
//  * by rows (the GROUP BY path: n = 2^20, G = 4096): P blocks, one an
//    SM, each owning a contiguous range of rows and partials of every
//    group, written to row b of a scratch [P, G]; then a grid-wide barrier
//    (a cooperative launch), and block b sums the P rows of its share of
//    the groups in a fixed order into `out`;
//  * by groups (n <= GROUP_ROWS and G > LANE_GROUPS): block b owns about
//    G / SMs groups, reads every row (few, from L2) and writes its groups
//    of `out`: no scratch, no barrier.
//
// A warp walks its rows LOAD_SETS sets a step: a 16-byte load of 4 values,
// one of 4 gids and one 32-bit word of 4 mask bytes a lane and set, all
// issued before any is used, and the next step's issued before this one
// is added, so several sets are in flight per lane (the first while the
// partials are zeroed).  A row's value is selected (`mask ? v : 0`), never
// multiplied by the mask, so a masked inf never becomes a NaN.  Each warp
// keeps its own partials in shared memory, in one of two layouts:
//  * up to LANE_GROUPS groups, a column of partials per lane: each lane
//    the only writer of its column, all 32 columns on their own banks, so
//    a hot group (G = 1) costs no more than any other;
//  * more groups, one row of partials per warp and a byte tag per group.
//    For each row the lanes write their lane number to their group's tag
//    and read it back, with the partial: when every lane reads its own
//    number, the lanes' groups differ and each adds its row.  Otherwise
//    (one row in nine at 4096 uniform groups; most rows of a skewed gid
//    column) the lanes that read one number share the group that lane
//    wrote: five ballots on the number's bits find them, they are summed
//    as a pairwise tree in lane order by shuffles, and the lowest adds the
//    sum.  A lane's consecutive rows of one group are folded first.
// The block then sums its partials in lane and warp order.
//
// Every slot of `out` is written, so the caller allocates it without a
// memset.  The vector loads need values, gids and mask to share one
// misalignment: `head` rows (0-3) before the first row where all three
// are aligned, which the binding reads off the pointers; the rows before
// it and after the last whole quad take the scalar step.  Views misaligned
// by different amounts get head < 0, and every row takes it.
//
// Integer-valued inputs stay exact while every partial stays below 2^24.
//
// What bounds it: by bytes, 9 * n + 4 * G (each value, gid and mask byte
// read once, each output written once) at 3.35 TB/s on an H100 SXM; the
// scratch (4 P G bytes written and read) stays in the 50 MB L2.  What
// holds it back (`time_segment_sum.py --parts` times copies with one part
// taken out): at the GROUP BY shape the row walk is about a third of a
// call, the chain of shared-memory round trips of each row (tag write,
// tag and partial read, partial write), serial in a warp, with the
// partials capping the warps an SM holds; the rest is fixed a call, the
// launch, the grid barrier, the second pass and the blocks' partials, and
// below about 2^18 rows it costs more than the atomics it replaced.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// 16-byte load sets a lane has in flight each step of pass 1
constexpr int LOAD_SETS = 4;
// the lane-column layout up to this many groups (16 KB a warp)
constexpr int LANE_GROUPS = 128;
// blocks of at most MAX_WARPS warps, whose partials (and tags) take at
// most PARTIAL_BYTES of shared memory: 8 warps at G = 4096
constexpr int MAX_WARPS = 8;
constexpr int PARTIAL_BYTES = 160 * 1024;
// a block's least rows when blocks own rows, and a warp's: below them,
// fewer of each
constexpr int64_t BLOCK_ROWS = 4096;
constexpr int64_t WARP_ROWS = 256;
// up to this many rows (and above LANE_GROUPS groups) blocks own groups
constexpr int64_t GROUP_ROWS = 24576;

// One lane's rows of one set: ROWS consecutive rows, the mask as the word
// of ROWS bytes it was loaded as.
template <int ROWS>
struct Rows {
  float v[ROWS];
  int32_t g[ROWS];
  uint32_t m;
};

// Rows [4 q + head, 4 q + head + 4): two 16-byte loads and one word.
__device__ __forceinline__ Rows<4> load_quad(const float* values,
                                              const int32_t* gids,
                                              const bool* mask, int head,
                                              int64_t q) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(values + head) + q);
  const int4 g = __ldg(reinterpret_cast<const int4*>(gids + head) + q);
  Rows<4> r;
  r.m = __ldg(reinterpret_cast<const unsigned int*>(mask + head) + q);
  r.v[0] = v.x; r.v[1] = v.y; r.v[2] = v.z; r.v[3] = v.w;
  r.g[0] = g.x; r.g[1] = g.y; r.g[2] = g.z; r.g[3] = g.w;
  return r;
}

__device__ __forceinline__ Rows<1> load_row(const float* values,
                                            const int32_t* gids,
                                            const bool* mask, int64_t i) {
  Rows<1> r;
  r.v[0] = __ldg(values + i);
  r.g[0] = __ldg(gids + i);
  r.m = __ldg(reinterpret_cast<const unsigned char*>(mask) + i);
  return r;
}

template <int ROWS>
__device__ __forceinline__ Rows<ROWS> no_rows() {
  Rows<ROWS> r;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    r.v[k] = 0.f;
    r.g[k] = 0;
  }
  r.m = 0u;
  return r;
}

// The LOAD_SETS sets of one step from item `base`: lane l takes item
// base + s * 32 + l of set s, if it lies below `hi`.
template <bool QUADS>
__device__ __forceinline__ void load_step(
    Rows<QUADS ? 4 : 1> (&r)[LOAD_SETS], const float* values,
    const int32_t* gids, const bool* mask, int head, int64_t base,
    int64_t hi, unsigned lane) {
#pragma unroll
  for (int s = 0; s < LOAD_SETS; ++s) {
    const int64_t i = base + s * 32 + lane;
    if constexpr (QUADS)
      r[s] = i < hi ? load_quad(values, gids, mask, head, i) : no_rows<4>();
    else
      r[s] = i < hi ? load_row(values, gids, mask, i) : no_rows<1>();
  }
}

// The sum of x over the lanes of this lane's group (`peers`, a mask of
// them), taken as a pairwise tree in lane order (ranks 0+1, 2+3, ...,
// then (0+1)+(2+3), ...), lands in the group's lowest lane.  Every lane
// of the warp must call it.
__device__ __forceinline__ float group_sum(float x, unsigned peers,
                                           unsigned lane) {
  const unsigned below = (1u << lane) - 1u;
  unsigned rank = __popc(peers & below);
  peers &= ~below & ~(1u << lane);                // the peers above
  while (__any_sync(FULL, peers != 0u)) {
    const int next = __ffs(peers);                // 1-based; 0: none
    const float t = __shfl_sync(FULL, x, (next - 1) & 31);
    if (next) x += t;
    // the odd ranks were just taken by the lane below them
    peers &= __ballot_sync(FULL, (rank & 1u) == 0u);
    rank >>= 1;
  }
  return x;
}

// The partials of one warp, in one of the two layouts, and how a lane's
// R rows (key < 0: dropped) are added into them.
struct LaneColumns {            // G <= LANE_GROUPS: part[g * 32 + lane]
  float* col;                   // this lane's column: col[g * 32]

  template <int R>
  __device__ __forceinline__ void add(int (&key)[R], float (&x)[R],
                                      unsigned) {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (key[j] >= 0) col[key[j] * 32] += x[j];
  }
};

struct TaggedRow {              // larger G: part[g], tag[g]
  float* part;
  uint8_t* tag;

  // One row: the lanes write their lane number to their group's tag and
  // read it back, with the group's partial.  When every lane reads its
  // own number, the groups differ and each adds its row.  Otherwise the
  // lanes that read one number share the group that lane wrote: five
  // ballots on the number's bits find them, `group_sum` sums them, and
  // the lowest adds the sum.  The vote of the row before (or the block's
  // barrier) ordered every lane's reads of the tags before these writes.
  __device__ __forceinline__ void add_row(int key, float x, unsigned lane) {
    const bool live = key >= 0;
    if (live) tag[key] = (uint8_t)lane;
    __syncwarp();
    const unsigned won = live ? tag[key] : lane;
    const float old = live ? part[key] : 0.f;
    if (__all_sync(FULL, won == lane)) {
      if (live) part[key] = old + x;
      return;
    }
    unsigned peers = __ballot_sync(FULL, live);
    if (!live) peers = ~peers;
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      const unsigned bit = __ballot_sync(FULL, (won >> b) & 1u);
      peers &= (won >> b) & 1u ? bit : ~bit;
    }
    const float s = group_sum(x, peers, lane);
    if (live && (peers & ((1u << lane) - 1u)) == 0u) part[key] = old + s;
  }

  template <int R>
  __device__ __forceinline__ void add(int (&key)[R], float (&x)[R],
                                      unsigned lane) {
    // a lane's consecutive rows of one group fold into the last of them
#pragma unroll
    for (int j = 1; j < R; ++j) {
      if (key[j] >= 0 && key[j] == key[j - 1]) {
        x[j] = x[j - 1] + x[j];
        key[j - 1] = -1 - (int)lane;
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) add_row(key[j], x[j], lane);
  }
};

// A lane's rows of one step as keys and values: a live row (unmasked,
// gid among the block's groups [key_lo, key_lo + keys)) keys by its gid
// less key_lo; any other row by a key of its own below 0, which joins no
// group.  The value is selected, never multiplied by the mask.
template <int ROWS, int SETS, typename Partials>
__device__ __forceinline__ void add_step(Partials& p,
                                         const Rows<ROWS> (&r)[SETS],
                                         int key_lo, int keys,
                                         unsigned lane) {
  int key[ROWS * SETS];
  float x[ROWS * SETS];
#pragma unroll
  for (int s = 0; s < SETS; ++s) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int g = r[s].g[k] - key_lo;
      const bool live = ((r[s].m >> (8 * k)) & 0xffu) != 0u &&
                        (uint32_t)g < (uint32_t)keys;
      key[s * ROWS + k] = live ? g : -1 - (int)lane;
      x[s * ROWS + k] = live ? r[s].v[k] : 0.f;
    }
  }
  p.add(key, x, lane);
}

// The whole segment sum, one launch.  A block owns rows and groups in one
// of two ways:
//  * by groups (slots < G: few rows): block b owns groups [b * slots,
//    (b + 1) * slots), reads every row, keeps those of its groups in
//    lane columns and writes its groups of `out`;
//  * by rows (slots == G): block b owns items [b * per_block,
//    (b + 1) * per_block) and every group, and writes its sums to row b of
//    the scratch [P, G] (to `out` when P = 1); then, after a grid-wide
//    barrier (a cooperative launch), block b sums the P rows of groups
//    [b * span, (b + 1) * span), span = ceil(G / P), in a fixed order.
// Items are quads of rows from row `head` when QUADS, else single rows
// (head is then 0).  Warp w takes steps w, w + W, ... of 32 * LOAD_SETS
// items of its block's range, and loads each step before it adds the one
// before.  The rows outside the quads go to warp 0 of the last block (of
// every block, by groups).  Shared memory: LANES, [W][stride][32] floats; else
// [W][stride] floats, then [W][stride] tag bytes; stride = slots rounded
// up to 4.
template <bool QUADS, bool LANES>
__global__ void __launch_bounds__(MAX_WARPS * 32)
segsum(const float* __restrict__ values, const int32_t* __restrict__ gids,
       const bool* __restrict__ mask, int64_t n, int head, int64_t items,
       int64_t per_block, int G, int slots, int stride,
       float* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const unsigned lane = threadIdx.x & 31u;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const bool by_groups = slots < G;
  const int key_lo = by_groups ? blockIdx.x * slots : 0;
  const int keys = G - key_lo < slots ? G - key_lo : slots;
  const int width = LANES ? stride * 32 : stride;    // floats a warp
  typename std::conditional<LANES, LaneColumns, TaggedRow>::type p;
  if constexpr (LANES) {
    p.col = smem + warp * width + lane;
  } else {
    p.part = smem + warp * width;
    p.tag = reinterpret_cast<uint8_t*>(smem + warps * width) + warp * width;
  }
  const int64_t lo = by_groups ? 0 : (int64_t)blockIdx.x * per_block;
  const int64_t hi = lo + per_block < items ? lo + per_block : items;
  const int64_t step = (int64_t)warps * 32 * LOAD_SETS;

  Rows<QUADS ? 4 : 1> r[LOAD_SETS];
  int64_t base = lo + (int64_t)warp * 32 * LOAD_SETS;
  load_step<QUADS>(r, values, gids, mask, head, base, hi, lane);
  for (int i = threadIdx.x; i < warps * width / 4; i += blockDim.x)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (; base < hi; base += step) {
    Rows<QUADS ? 4 : 1> next[LOAD_SETS];
    load_step<QUADS>(next, values, gids, mask, head, base + step, hi, lane);
    add_step(p, r, key_lo, keys, lane);
#pragma unroll
    for (int s = 0; s < LOAD_SETS; ++s) r[s] = next[s];
  }
  if (QUADS && (by_groups || blockIdx.x == gridDim.x - 1) && warp == 0) {
    // rows [0, head) and [head + 4 items, n): at most 3 + 3
    const int64_t i = (int)lane < head
                          ? (int64_t)lane
                          : head + 4 * items + ((int)lane - head);
    const Rows<1> extra[1] = {i < n ? load_row(values, gids, mask, i)
                                    : no_rows<1>()};
    add_step(p, extra, key_lo, keys, lane);
  }

  float* row = by_groups ? out + key_lo
                         : (gridDim.x == 1 ? out
                                           : scratch + (int64_t)blockIdx.x * G);
  if constexpr (LANES) {
    // each warp's 32 columns in lane order into column 0, then the warps'
    // in warp order
    __syncwarp();
    float* wcols = smem + warp * width;
    for (int g = lane; g < keys; g += 32) {
      const float4* c = reinterpret_cast<const float4*>(wcols + g * 32);
      float4 q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) q[k] = c[k];
      float s = q[0].x;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k) s += q[k].x;
        s += q[k].y;
        s += q[k].z;
        s += q[k].w;
      }
      wcols[g * 32] = s;
    }
    __syncthreads();
    for (int g = threadIdx.x; g < keys; g += blockDim.x) {
      float s = smem[g * 32];
      for (int w = 1; w < warps; ++w) s += smem[w * width + g * 32];
      row[g] = s;
    }
  } else {
    // the warps' rows in warp order, 4 slots a thread, every load of a
    // column issued before the adds
    __syncthreads();
    for (int c = threadIdx.x; c < stride / 4; c += blockDim.x) {
      float4 q[MAX_WARPS];
#pragma unroll
      for (int w = 0; w < MAX_WARPS; ++w)
        if (w < warps) q[w] = smem4[w * (width / 4) + c];
      float4 s = q[0];
#pragma unroll
      for (int w = 1; w < MAX_WARPS; ++w) {
        if (w < warps) {
          s.x += q[w].x;
          s.y += q[w].y;
          s.z += q[w].z;
          s.w += q[w].w;
        }
      }
      const float out4[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * c + k < keys) row[4 * c + k] = out4[k];
    }
  }
  if (by_groups || gridDim.x == 1) return;

  // every block's scratch row written and visible
  cooperative_groups::this_grid().sync();
  // groups [g_lo, g_hi) of `out`: the threads as [Q][C], thread (q, c)
  // summing scratch rows q, q + Q, ... of group g0 + c, 32 loads in
  // flight, then the Q sums of each group in q order
  const int P = gridDim.x;
  const int span = (G + P - 1) / P;
  const int g_lo = blockIdx.x * span;
  const int g_hi = G < g_lo + span ? G : g_lo + span;
  const int C = (int)blockDim.x < ((span + 31) & ~31) ? (int)blockDim.x
                                                      : ((span + 31) & ~31);
  const int Q = blockDim.x / C;
  const int q = threadIdx.x / C, c = threadIdx.x % C;
  for (int g0 = g_lo; g0 < g_hi; g0 += C) {
    const int g = g0 + c;
    if (q < Q) {
      float s = 0.f;
      if (g < g_hi) {
        for (int p0 = q; p0 < P; p0 += 32 * Q) {
          float v[32];
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const int pr = p0 + k * Q;
            v[k] = pr < P ? __ldcg(scratch + (int64_t)pr * G + g) : 0.f;
          }
#pragma unroll
          for (int k = 0; k < 32; ++k) s += v[k];
        }
      }
      smem[q * C + c] = s;
    }
    __syncthreads();
    if (q == 0 && g < g_hi) {
      float t = smem[c];
      for (int k = 1; k < Q; ++k) t += smem[k * C + c];
      out[g] = t;
    }
    __syncthreads();
  }
}

struct Plan {
  bool lanes;         // the lane-column layout
  int warps;          // warps a block
  int blocks;         // P
  int slots;          // groups a block owns: G, or fewer by groups
  int stride;         // slots rounded up to 4
  int64_t items;      // quads (or rows) of the vector (or scalar) walk
  int64_t per_block;  // items a block
  size_t smem;        // shared bytes a block
};

// The plan for `sms` blocks at most.  Up to GROUP_ROWS
// rows, and G above LANE_GROUPS, blocks own groups (about G / sms each,
// lane columns) and read every row; else they own rows (at least
// BLOCK_ROWS a block), lane columns up to LANE_GROUPS groups and tagged
// rows above.  A warp at least WARP_ROWS rows; at most MAX_WARPS warps,
// and the warps whose partials fit PARTIAL_BYTES.
Plan make_plan(int64_t n, int64_t G, int head, int64_t sms) {
  Plan p;
  p.items = head >= 0 ? (n - head) / 4 : n;
  if (p.items < 0) p.items = 0;
  const bool by_groups = n <= GROUP_ROWS && G > LANE_GROUPS;
  int64_t blocks;
  if (by_groups) {
    p.slots = (int)((G + sms - 1) / sms);
    blocks = (G + p.slots - 1) / p.slots;
    p.per_block = p.items;
  } else {
    p.slots = (int)G;
    blocks = (n + BLOCK_ROWS - 1) / BLOCK_ROWS;
    if (blocks > sms) blocks = sms;
    if (blocks < 1) blocks = 1;
    // whole steps of 32 items a block, so each warp's loads start aligned
    p.per_block = ((p.items + blocks - 1) / blocks + 31) / 32 * 32;
    if (p.per_block < 32) p.per_block = 32;
    blocks = (p.items + p.per_block - 1) / p.per_block;
    if (blocks < 1) blocks = 1;
  }
  p.blocks = (int)blocks;
  p.stride = (p.slots + 3) & ~3;
  p.lanes = p.slots <= LANE_GROUPS;
  const int64_t warp_bytes =
      p.lanes ? (int64_t)p.stride * 32 * 4 : (int64_t)p.stride * 5;
  int64_t warps = PARTIAL_BYTES / warp_bytes;
  if (warps > MAX_WARPS) warps = MAX_WARPS;
  const int64_t rows = (by_groups ? n : p.per_block * (head >= 0 ? 4 : 1));
  const int64_t need = (rows + WARP_ROWS - 1) / WARP_ROWS;
  if (warps > need) warps = need;
  p.warps = (int)(warps < 1 ? 1 : warps);
  p.smem = (size_t)p.warps * warp_bytes;
  return p;
}

template <bool QUADS, bool LANES>
cudaError_t launch_kernel(const Plan& p, const float* values,
                          const int32_t* gids, const bool* mask, int64_t n,
                          int head, int G, float* scratch, float* out,
                          cudaStream_t stream) {
  const auto kernel = segsum<QUADS, LANES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.blocks);
  cfg.blockDim = dim3((unsigned)p.warps * 32);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  // the grid-wide barrier of the by-rows form needs every block resident
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.slots == G && p.blocks > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, values, gids, mask, n,
                           QUADS ? head : 0, p.items, p.per_block, G,
                           p.slots, p.stride, scratch, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_plan(const Plan& p, const float* values,
                        const int32_t* gids, const bool* mask, int64_t n,
                        int head, int G, float* scratch, float* out,
                        cudaStream_t stream) {
  const auto launch = head >= 0 ? (p.lanes ? launch_kernel<true, true>
                                           : launch_kernel<true, false>)
                                : (p.lanes ? launch_kernel<false, true>
                                           : launch_kernel<false, false>);
  return launch(p, values, gids, mask, n, head, G, scratch, out, stream);
}

cudaError_t device_plan(int64_t n, int64_t G, int64_t head, Plan* p) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *p = make_plan(n, G, (int)head, sms);
  return cudaSuccess;
}

}  // namespace

// Floats of scratch the launch needs (P * G; 0 when P = 1, where pass 1
// writes `out` itself), or -1 when the device cannot be read.
int64_t mo_segment_sum_workspace(int64_t n, int64_t G, int64_t head) {
  Plan p;
  if (device_plan(n, G, head, &p) != cudaSuccess) return -1;
  return p.slots < G || p.blocks == 1 ? 0 : (int64_t)p.blocks * G;
}

// Launches on `stream` and returns at once with the launches' error.
// Every slot of out [G] is written.  `head` (0-3: the rows before the
// first row where values, gids and mask lie on 16, 16 and 4 bytes)
// selects the vector walk; -1 the scalar one.  The caller keeps
// 1 <= G <= 4096, n >= 1, and gives `mo_segment_sum_workspace` floats of
// scratch.
cudaError_t mo_segment_sum_launch(const float* values, const int32_t* gids,
                                  const bool* mask, int64_t n, int64_t G,
                                  int64_t head, float* scratch, float* out,
                                  cudaStream_t stream) {
  Plan p;
  const cudaError_t err = device_plan(n, G, head, &p);
  if (err != cudaSuccess) return err;
  return launch_plan(p, values, gids, mask, n, (int)head, (int)G, scratch,
                     out, stream);
}
