// K4: the cell-list GNN aggregation, K2 over the block pairs of K3's table,
// written by hand for Hopper (sm_90a).
//
// Replaces gym_flock_tpu/ops/sparse_flocking.py:_sparse_adj_kernel (launched
// by _sparse_adj_pallas).  Its operands are sorted: xs [B,N,4] (px,py,vx,vy)
// in Hilbert order, N a multiple of 128, hs [B,N,F] in the same order, and
// table [B,n_b,k_max] int32, which lists for each 128-agent row block the
// column blocks that can hold a neighbour (-1 pads).  For each row agent i it
// sums the rows of hs over the agents j of the listed column blocks that are
// its neighbours:
//   dx = xs_x[j] - xs_x[i],  dy likewise,  r2 = dx*dx + dy*dy   (f32)
//   adj = r2 < cr2  and  j != i   (sorted ids)
//   out[i] = sum_j adj * hs[j]     deg[i] = sum_j adj
// Outputs out [B,N,F] f32 and deg [B,N] f32 in sorted order.  The backward
// pass is this kernel again on the cotangent (the adjacency and the table
// are symmetric), composed by the wrapper in ops/sparse_flocking.py.
//
// What bounds it: the pair test on every listed pair (about 6
// instructions, 5 flops) and F f32->f64 conversions and adds on the
// neighbour pairs only (~0.3% of the listed pairs of bench metric 4's
// table).  At N=65,536 and B=1 the table rows are uneven (14 slots against
// a mean of 8), so one block walking a whole row would let the longest rows
// set the time.  It reads each listed column block ((4 + F) * 4 bytes an
// agent) once per row warp, so the bytes are few.  The old design (grid
// (n_b, B), one row a thread, a block-synchronous staging of each slot's
// positions and 8 features, 8 f64 adds on every column where some lane hit)
// put ~15 warps on an SM and walked each row serially.  Left for later work:
// the gathers of xs and hs through the permutation and the scatter of the
// result back to agent order run outside the kernel, as further passes.
//
// Design (the pair loop of csrc/flocking_pairs.cuh, K3's table walk and K2's
// tile pass): a warp owns 32 sorted row agents of one row block, one a lane,
// and walks the column blocks its table row lists, each staged in shared
// memory by cp.async, double-buffered: a test pass over every listed pair
// (r2 < cr2) sets the lane's hit mask, the self pair (same block, same lane)
// is cleared, the degree is the mask's popcount, and the body adds the kF
// features of each hit's hs row in f64, in increasing column order, from
// shared memory: a listed block's 128 rows of hs are staged beside its
// positions (K2's tiles, 8 KB a warp at F = 6).  When the batch is too small to fill the card
// (B=1 at N=65,536), a row's listed blocks are dealt round-robin to 1-8
// warps of the block; the partials are added in group order in shared
// memory.  Pad slots (and any entry outside [0, n_b)) are skipped, uniformly
// across the warp.  No atomics, so the result is deterministic.  F > 8 runs
// one launch for each chunk of 8 features.
// * r2 is formed with __fmul_rn/__fadd_rn, so no FMA contraction moves it
//   across the radius: the degree equals the plain version's exactly.
// * The sums accumulate in f64 (the TPU kernel's MXU accumulates in f32), as
//   the plain version's do, and are rounded to f32 once at the end.
#include "flocking_pairs.cuh"

namespace {

using gft::kTile;
using gft::kWarp;

constexpr int kFeat = 8;  // features summed by one launch

template <int kF>
__global__ void __launch_bounds__(gft::kMaxThreads, 3)
sparse_adj_kernel(const float4* __restrict__ xs, const float* __restrict__ hs,
                  const int* __restrict__ table, float* __restrict__ out,
                  float* __restrict__ deg, int n, int k_max, int f, int f0, float cr2,
                  bool whole_rows, int groups) {
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

  gft::AdjSums<kF> acc;
  if (active) {
    const float4* xb = xs + static_cast<size_t>(b) * n;
    const int blk = i / kTile;
    const gft::ListedBlocks seq{xb, table + (static_cast<size_t>(b) * n_b + blk) * k_max,
                                k_max, n_b, group, groups, blk, i % kTile};
    const gft::AdjArgs args{hs + static_cast<size_t>(b) * n * f, f, f0, cr2, whole_rows};
    gft::run_tiles(acc, xb[i], true, smem + warp * decltype(acc)::kWarpFloat4s, lane, seq,
                   args);
  }
  const size_t row = static_cast<size_t>(b) * n + i;
  gft::combine_and_store(acc, smem, warp, group, groups, lane, active,
                         gft::AdjOut{out + row * f + f0, f0 == 0 ? deg + row : nullptr});
}

gft::Plan sparse_adj_plan(int b, int n, int k_max) {
  return gft::plan_split(b, n / kWarp, k_max);
}

template <int kF>
int launch_chunk(const gft::Plan& p, const dim3& grid, cudaStream_t s, const float4* x,
                 const float* h, const int* tb, float* o, float* d, int n, int k_max, int f,
                 int f0, float cr2, bool whole_rows) {
  const size_t smem = p.smem_bytes(gft::AdjSums<kF>::kWarpFloat4s);
  const int e =
      gft::allow_smem<sparse_adj_kernel<kF>>(gft::kMaxWarps * gft::AdjSums<kF>::kWarpFloat4s);
  if (e != 0) return e;
  sparse_adj_kernel<kF><<<grid, p.warps() * kWarp, smem, s>>>(x, h, tb, o, d, n, k_max, f, f0,
                                                              cr2, whole_rows, p.groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K4 on `stream` and returns cudaGetLastError() (0 on success).
// xs [b,n,4] f32 (16-byte aligned), hs [b,n,f] f32, table [b,n/128,k_max]
// int32, out [b,n,f] f32 and deg [b,n] f32 are contiguous device buffers; n is
// a multiple of 128 and b <= 65535.  One kernel launch for each chunk of 8
// features.
extern "C" int gft_sparse_adj(const void* xs, const void* hs, const void* table, void* out,
                              void* deg, int b, int n, int k_max, int f, float cr2,
                              void* stream) {
  if (b == 0 || n == 0 || f == 0) return 0;
  const gft::Plan p = sparse_adj_plan(b, n, k_max);
  const int row_warps = n / kWarp;
  const dim3 grid((row_warps + p.row_warps - 1) / p.row_warps, b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* x = static_cast<const float4*>(xs);
  const float* h = static_cast<const float*>(hs);
  const int* tb = static_cast<const int*>(table);
  float* o = static_cast<float*>(out);
  float* d = static_cast<float*>(deg);
  // one run of 16-byte words a tile: a single chunk and hs 16-byte aligned
  // (n is a multiple of 128, so every swarm's and block's rows are too)
  const bool whole_rows = f <= kFeat && reinterpret_cast<uintptr_t>(hs) % 16 == 0;
  for (int f0 = 0; f0 < f; f0 += kFeat) {
    int rc = 0;
    switch (std::min(kFeat, f - f0)) {
#define GFT_CHUNK(nf)                                                                   \
  case nf:                                                                              \
    rc = launch_chunk<nf>(p, grid, s, x, h, tb, o, d, n, k_max, f, f0, cr2, whole_rows); \
    break;
      GFT_CHUNK(1) GFT_CHUNK(2) GFT_CHUNK(3) GFT_CHUNK(4)
      GFT_CHUNK(5) GFT_CHUNK(6) GFT_CHUNK(7) GFT_CHUNK(8)
#undef GFT_CHUNK
    }
    if (rc != 0) return rc;
  }
  return 0;
}

// The launch geometry gft_sparse_adj takes at this shape: grid[0] blocks,
// grid[1] threads a block, grid[2] warps that split a row's listed blocks,
// each launch (one for each chunk of 8 features).
extern "C" void gft_sparse_adj_grid(int b, int n, int k_max, int* grid) {
  const gft::Plan p = sparse_adj_plan(b, n, k_max);
  const int row_warps = n / kWarp;
  grid[0] = b * ((row_warps + p.row_warps - 1) / p.row_warps);
  grid[1] = p.warps() * kWarp;
  grid[2] = p.groups;
}
