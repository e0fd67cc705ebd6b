// K3: the cell-list flocking channel sums, written by hand for Hopper (sm_90a).
//
// Replaces gym_flock_tpu/ops/sparse_flocking.py:_sparse_kernel (launched by
// _sparse_sums_pallas).  Its operands are sorted: xs [B,N,4] (px,py,vx,vy) in
// Hilbert order, N a multiple of 128, and table [B,n_b,k_max] int32, which
// lists for each 128-agent row block the column blocks that can hold a
// neighbour (-1 pads).  For each row agent it reduces over the agents of the
// listed column blocks whose sorted id differs from its own, with d* = row
// minus column, exactly K1's terms:
//   adj = r2 < cr2,  inv = 1/r2,  gfac = (r2 > cr) ? 0 : 2 inv (1 - inv)
//   0 sum adj*dvx   1 sum adj*dx*inv^2   2 sum adj*dx*inv
//   3-5 the same for y   6/7 sum dx*gfac, dy*gfac   8 degree (sum adj)
//   "expert" adds 10/11 sum adj*dx*gfac, adj*dy*gfac and writes 9 = 0;
//   "full" also writes 9 = min r2 over the listed pairs (+inf if none).
// Output [B,N,16] f32 in sorted order; unused channels are written as zeros.
//
// What bounds it: the pair test on every listed pair (about 8 instructions,
// 5 flops) and the body (one IEEE divide, ~30 flops, f64 adds) on the ~0.3%
// of listed pairs within reach on bench metric 4's Verlet table.  At
// N=65,536, B=1 the table rows are uneven (14 slots against a mean of 8), so
// one block walking a whole row would let the longest rows set the time.  It
// reads each listed column block (2 KB) once per row warp, so the bytes are
// few.  Left for later work: the gather of xs through the permutation and the
// scatter of the result back to agent order run outside the kernel, as two
// more passes.
//
// Design (the pair loop is csrc/flocking_pairs.cuh, shared with K1): a warp
// owns 32 sorted row agents of one row block, one a lane, and walks the
// column blocks its table row lists, each staged in shared memory by
// cp.async, double-buffered: a test pass over every listed pair sets a hit
// mask, a body pass runs the arithmetic on the hits only.  When the batch is
// too small to fill the card (B=1 at N=65,536), a row's listed blocks are
// dealt round-robin to `groups` warps of the block, so the longest row walks
// ceil(14 / groups) blocks; the partials are added in group order in shared
// memory.  Pad slots (and any entry outside [0, n_b)) are skipped, uniformly
// across the warp.  No atomics, so the result is deterministic.
// * The self pair (same sorted id: same block, same lane) is skipped: the
//   Pallas kernel's r2 := inf, zero in every sum and absent from the min.
// * r2 is formed with __fmul_rn/__fadd_rn, so no FMA contraction moves it
//   across the radius: the degree equals the plain version's exactly.  The
//   divide stays IEEE (built without --use_fast_math, -prec-div=true).
// * Each pair term is formed in f32 as in the JAX kernel; the sums
//   accumulate in f64, as in K1's port.
#include "flocking_pairs.cuh"

namespace {

using gft::kTile;
using gft::kWarp;

enum ChannelSet { kCore = 0, kExpert = 1, kFull = 2 };

template <int kSet>
__global__ void __launch_bounds__(gft::kMaxThreads, 4)
sparse_sums_kernel(const float4* __restrict__ xs, const int* __restrict__ table,
                   float4* __restrict__ out, int n, int k_max, gft::Reach reach, int groups) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int group = warp % groups;
  const int row_warps = blockDim.x / (kWarp * groups);
  const int row0 = (blockIdx.x * row_warps + warp / groups) * kWarp;
  const int b = blockIdx.y;
  const int n_b = n / kTile;
  const bool active = row0 < n;  // warp-uniform: n is a multiple of 128
  const int i = row0 + lane;

  gft::PairSums<kSet != kCore, kSet == kFull> acc;
  if (active) {
    const float4* xb = xs + static_cast<size_t>(b) * n;
    const int blk = i / kTile;
    const gft::ListedBlocks seq{xb, table + (static_cast<size_t>(b) * n_b + blk) * k_max,
                           k_max, n_b, group, groups, blk, i % kTile};
    gft::run_tiles(acc, xb[i], true, smem + warp * decltype(acc)::kWarpFloat4s, lane, seq, reach);
  }
  gft::combine_and_store(acc, smem, warp, group, groups, lane, active,
                         out + (static_cast<size_t>(b) * n + i) * (gft::kOut / 4));
}

gft::Plan sparse_sums_plan(int b, int n, int k_max) {
  return gft::plan_split(b, n / kWarp, k_max);
}

// Launches K3 with the geometry `p`; returns cudaGetLastError().
int launch_sparse_sums(const void* xs, const void* table, void* out, int b, int n, int k_max,
                       float cr, float cr2, int set, const gft::Plan& p, void* stream) {
  const int row_warps = n / kWarp;
  const dim3 grid((row_warps + p.row_warps - 1) / p.row_warps, b);
  const int threads = p.warps() * kWarp;
  const size_t smem = p.smem_bytes(2 * gft::kTile);  // two tiles of float4 rows
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* x = static_cast<const float4*>(xs);
  const int* tb = static_cast<const int*>(table);
  float4* o = static_cast<float4*>(out);
  const gft::Reach reach = gft::make_reach(cr, cr2);
  switch (set) {
    case kCore:
      sparse_sums_kernel<kCore><<<grid, threads, smem, st>>>(x, tb, o, n, k_max, reach, p.groups);
      break;
    case kExpert:
      sparse_sums_kernel<kExpert><<<grid, threads, smem, st>>>(x, tb, o, n, k_max, reach,
                                                               p.groups);
      break;
    case kFull:
      sparse_sums_kernel<kFull><<<grid, threads, smem, st>>>(x, tb, o, n, k_max, reach, p.groups);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K3 on `stream` and returns cudaGetLastError() (0 on success).
// xs [b,n,4] f32 (16-byte aligned), table [b,n/128,k_max] int32 and out
// [b,n,16] f32 (16-byte aligned) are contiguous device buffers; n is a
// multiple of 128 and b <= 65535.  set: 0 = "core", 1 = "expert", 2 = "full".
extern "C" int gft_sparse_sums(const void* xs, const void* table, void* out, int b, int n,
                               int k_max, float cr, float cr2, int set, void* stream) {
  if (b == 0 || n == 0) return 0;
  return launch_sparse_sums(xs, table, out, b, n, k_max, cr, cr2, set,
                            sparse_sums_plan(b, n, k_max), stream);
}

// The launch geometry gft_sparse_sums takes at this shape: grid[0] blocks,
// grid[1] threads a block, grid[2] warps that split a row's listed blocks.
extern "C" void gft_sparse_sums_grid(int b, int n, int k_max, int* grid) {
  const gft::Plan p = sparse_sums_plan(b, n, k_max);
  const int row_warps = n / kWarp;
  grid[0] = b * ((row_warps + p.row_warps - 1) / p.row_warps);
  grid[1] = p.warps() * kWarp;
  grid[2] = p.groups;
}
