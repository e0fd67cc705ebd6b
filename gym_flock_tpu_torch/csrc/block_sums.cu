// K1: the flocking pairwise channel sums, written by hand for Hopper (sm_90a).
//
// Replaces gym_flock_tpu/ops/pallas_flocking.py:_block_sums_kernel.  For each
// row agent i of xr [B,m,4] (px,py,vx,vy) it reduces over the column agents j
// of xc [B,k,4] whose global id (col_offset + j) differs from its own
// (row_offset + i), with d* = row minus column:
//   adj = r2 < cr2,  inv = 1/r2,  gfac = (r2 > cr) ? 0 : 2 inv (1 - inv)
//   0 sum adj*dvx   1 sum adj*dx*inv^2   2 sum adj*dx*inv
//   3-5 the same for y   6/7 sum dx*gfac, dy*gfac   8 degree (sum adj)
//   "full" adds 9 min r2 and 10/11 sum adj*dx*gfac, adj*dy*gfac.
// The cutoff of gfac compares r2 with the UNSQUARED radius cr, as the
// reference does.  Output [B,m,16] f32; unused channels are written as zeros.
//
// What bounds it: the pair test, about 8 instructions on every pair (5
// flops), and the body (one IEEE divide, ~30 flops, 8 or 10 f32->f64
// conversions and f64 adds) on the few pairs within reach: ~1.4% of
// FlockingLarge's draws, ~8% of FlockingRelative's.  Run on every pair, the
// divide and the conversions (16 a clock on an SM, against 128 f32
// operations) would set the time; on the hits only, the test leads, and at
// N=100 the body still does (a warp runs it as often as its busiest lane
// has hits).  It reads O(N) bytes per swarm.  wgmma and TMA do not apply:
// there is no matrix product and few bytes.
//
// Design (the pair loop is csrc/flocking_pairs.cuh): a warp owns 32 row
// agents, one a lane, and walks column tiles of 128 agents, each staged in
// shared memory by cp.async, double-buffered: a test pass over every pair
// sets a hit mask, a body pass runs K1's arithmetic on the hits only.  The
// tiles of a row warp are split round-robin across `groups` warps of the
// block when the batch is too small to fill the card (B=4 at N=4096 runs 8
// groups); the groups' partials are added in group order in shared memory.
// Grid (ceil(row warps / row warps a block), B).  No atomics, so the result
// is deterministic; channel 9 is a running fminf.
// * The self pair (equal global ids) is skipped: the Pallas kernel's
//   r2 := inf, zero in every sum and absent from the min.
// * The ragged edge is masked by bounds and by +inf padding columns (no
//   far-away finite padding agents).  A row with no other agent gets
//   channel 9 = +inf.
// * r2 is formed with __fmul_rn/__fadd_rn, so no FMA contraction moves it
//   across the radius: the degree equals the plain version's exactly.  The
//   divide stays IEEE (built without --use_fast_math, -prec-div=true).
// * Two distinct agents at r2 = 0 give NaN (0 * inf), as in JAX.  Inputs are
//   finite positions and velocities; a skipped pair adds exact zeros only
//   then.
// * Each pair term is formed in f32 as in the JAX kernel; the sums
//   accumulate in f64.  At N=4096 two f32 summation orders of the 1/r^4
//   channels differ by up to 7e-5 relative to (1 + |sum|), too close to the
//   1e-4 bound the kernel is held to.
#include "flocking_pairs.cuh"

namespace {

using gft::kTile;
using gft::kWarp;

template <bool kFull>
__global__ void __launch_bounds__(gft::kMaxThreads, 4)
block_sums_kernel(const float4* __restrict__ xr, const float4* __restrict__ xc,
                  float4* __restrict__ out, int m, int k, int row_offset, int col_offset,
                  gft::Reach reach, int groups) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int group = warp % groups;
  const int row_warps = blockDim.x / (kWarp * groups);
  const int row0 = (blockIdx.x * row_warps + warp / groups) * kWarp;
  const int b = blockIdx.y;
  const int i = row0 + lane;
  const bool active = i < m;

  gft::PairSums<kFull, kFull> acc;
  if (row0 < m) {  // warp-uniform
    const float4 me = active ? xr[static_cast<size_t>(b) * m + i] : make_float4(0.f, 0.f, 0.f, 0.f);
    const long long self_first = static_cast<long long>(row_offset) + row0 - col_offset;
    const gft::ColumnTiles seq{xc + static_cast<size_t>(b) * k, k, group, groups,
                          self_first + lane, self_first, min(kWarp, m - row0)};
    gft::run_tiles(acc, me, active, smem + warp * decltype(acc)::kWarpFloat4s, lane, seq, reach);
  }
  gft::combine_and_store(acc, smem, warp, group, groups, lane, active,
                         out + (static_cast<size_t>(b) * m + i) * (gft::kOut / 4));
}

gft::Plan block_sums_plan(int b, int m, int k) {
  return gft::plan_split(b, (m + kWarp - 1) / kWarp, (k + kTile - 1) / kTile);
}

// Launches K1 with the geometry `p`; returns cudaGetLastError().
int launch_block_sums(const void* xr, const void* xc, void* out, int b, int m, int k,
                      int row_offset, int col_offset, float cr, float cr2, int full,
                      const gft::Plan& p, void* stream) {
  const int row_warps = (m + kWarp - 1) / kWarp;
  const dim3 grid((row_warps + p.row_warps - 1) / p.row_warps, b);
  const int threads = p.warps() * kWarp;
  const size_t smem = p.smem_bytes(2 * gft::kTile);  // two tiles of float4 rows
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* r = static_cast<const float4*>(xr);
  const float4* c = static_cast<const float4*>(xc);
  float4* o = static_cast<float4*>(out);
  const gft::Reach reach = gft::make_reach(cr, cr2);
  if (full) {
    block_sums_kernel<true><<<grid, threads, smem, s>>>(r, c, o, m, k, row_offset, col_offset,
                                                        reach, p.groups);
  } else {
    block_sums_kernel<false><<<grid, threads, smem, s>>>(r, c, o, m, k, row_offset, col_offset,
                                                         reach, p.groups);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// xr [b,m,4], xc [b,k,4] and out [b,m,16] are contiguous f32 device buffers,
// 16-byte aligned; b <= 65535.  full: 0 = "core", 1 = "full".
extern "C" int gft_block_sums(const void* xr, const void* xc, void* out, int b, int m, int k,
                              int row_offset, int col_offset, float cr, float cr2, int full,
                              void* stream) {
  if (b == 0 || m == 0) return 0;
  return launch_block_sums(xr, xc, out, b, m, k, row_offset, col_offset, cr, cr2, full,
                           block_sums_plan(b, m, k), stream);
}

// The launch geometry gft_block_sums takes at this shape: grid[0] blocks,
// grid[1] threads a block, grid[2] warps that split a row's columns.
extern "C" void gft_block_sums_grid(int b, int m, int k, int* grid) {
  const gft::Plan p = block_sums_plan(b, m, k);
  const int row_warps = (m + kWarp - 1) / kWarp;
  grid[0] = b * ((row_warps + p.row_warps - 1) / p.row_warps);
  grid[1] = p.warps() * kWarp;
  grid[2] = p.groups;
}
