// K2: the GNN aggregation A(xr, xc) @ H with the radius adjacency built on the
// fly, written by hand for Hopper (sm_90a).
//
// Replaces gym_flock_tpu/ops/pallas_flocking.py:_adj_matmul_kernel (launched
// by _adj_matmul_impl).  For each row agent i of xr [B,m,4] (positions in
// columns 0 and 1) it sums the rows of h [B,k,F] over the column agents j of
// xc [B,k,4] that are its neighbours:
//   dx = xc_x - xr_x,  dy = xc_y - xr_y,  r2 = dx*dx + dy*dy   (f32)
//   adj = r2 < cr2  and  row_offset + i != col_offset + j    (global ids)
//   out[i] = sum_j adj * h[j]     deg[i] = sum_j adj
// Outputs out [B,m,F] f32 and deg [B,m] f32, both raw: the mean pooling and
// the backward pass (the same kernel with operands and offsets swapped, or
// run on dy / deg) are composed by the wrapper, ops/adjacency_matmul.py,
// which also packs positions of another width into [B,n,4].
//
// What bounds it: the pair test on every pair (about 6 instructions, 5
// flops) and, on the neighbour pairs only (1.3% of FlockingLarge's draws),
// F f32->f64 conversions and adds (16 conversions a clock on an SM, against
// 128 f32 operations).  The bytes are few: positions and H, (4 + F) * 4
// bytes an agent, read once per row warp.  Tensor cores wait: at F = 6 a
// 128-wide tile product would waste most of each wgmma, the adjacency tile
// would have to be written to shared memory first, and the Gram form of r2
// would move pairs across the radius.  The old design (one row a thread,
// 8 features summed on every column where some lane of the warp hit, a
// block-wide synchronous staging of each tile, grid (m/128, B)) ran the body
// on ~35% of the warp-columns and put ~15 warps on an SM.
//
// Design (the pair loop of K1, csrc/flocking_pairs.cuh): a warp owns 32 row
// agents, one a lane, and walks column tiles of 128 agents.  Each tile's
// positions (as float2) and its rows of H beside them (3 KB at F = 6, one
// run of 16-byte words) are staged in shared memory by cp.async,
// double-buffered: 8 KB a warp at F = 6, so 3 blocks of 8 warps a SM.  A
// test pass over every pair (r2 < cr2 alone: a NaN position is nobody's
// neighbour) sets the lane's 128-bit hit mask; the self pair is cleared by
// global id (its column may lie in any tile, or outside [0, k)); the degree
// is the mask's popcount; the body walks each lane's hits in increasing
// column order and adds the hit's kF features from shared memory in f64.
// (Reading them through the read-only cache instead, with 4 KB a warp, took
// 6-8% longer at B=16, N=4096 on an H100: tools/probe_adj_kernels.py.)  The
// tiles of a row warp are split round-robin across 1-8 warps of the block
// when the batch is too small to fill the card; their partials are added
// in group order in shared memory.  No atomics, so the result is
// deterministic.  F > 8 runs one launch for each chunk of 8 features, each
// repeating the test pass.
// * r2 is formed with __fmul_rn/__fadd_rn, so no FMA contraction moves it
//   across the radius: the degree equals the plain version's exactly.
// * The sums accumulate in f64 (the TPU kernel's MXU accumulates in f32), as
//   the plain version's do, and are rounded to f32 once at the end.
// * A non-finite H row of a column that is not a neighbour is skipped, where
//   the plain version's matmul adds 0 * NaN = NaN (a known deviation).
#include "flocking_pairs.cuh"

namespace {

using gft::kTile;
using gft::kWarp;

constexpr int kFeat = 8;  // features summed by one launch

template <int kF>
__global__ void __launch_bounds__(gft::kMaxThreads, 3)
adj_matmul_kernel(const float4* __restrict__ xr, const float4* __restrict__ xc,
                  const float* __restrict__ h, float* __restrict__ out, float* __restrict__ deg,
                  int m, int k, int f, int f0, int row_offset, int col_offset, float cr2,
                  bool whole_rows, int groups) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int group = warp % groups;
  const int row_warps = blockDim.x / (kWarp * groups);
  const int row0 = (blockIdx.x * row_warps + warp / groups) * kWarp;
  const int b = blockIdx.y;
  const int i = row0 + lane;
  const bool active = i < m;

  gft::AdjSums<kF> acc;
  if (row0 < m) {  // warp-uniform
    const float4 me = active ? xr[static_cast<size_t>(b) * m + i] : make_float4(0.f, 0.f, 0.f, 0.f);
    const long long self_first = static_cast<long long>(row_offset) + row0 - col_offset;
    const gft::ColumnTiles seq{xc + static_cast<size_t>(b) * k, k, group, groups,
                               self_first + lane, self_first, min(kWarp, m - row0)};
    const gft::AdjArgs args{h + static_cast<size_t>(b) * k * f, f, f0, cr2, whole_rows};
    gft::run_tiles(acc, me, active, smem + warp * decltype(acc)::kWarpFloat4s, lane, seq, args);
  }
  const size_t row = static_cast<size_t>(b) * m + i;
  gft::combine_and_store(acc, smem, warp, group, groups, lane, active,
                         gft::AdjOut{out + row * f + f0, f0 == 0 ? deg + row : nullptr});
}

gft::Plan adj_matmul_plan(int b, int m, int k) {
  return gft::plan_split(b, (m + kWarp - 1) / kWarp, (k + kTile - 1) / kTile);
}

template <int kF>
int launch_chunk(const gft::Plan& p, const dim3& grid, cudaStream_t s, const float4* r,
                 const float4* c, const float* h, float* o, float* d, int m, int k, int f, int f0,
                 int row_offset, int col_offset, float cr2, bool whole_rows) {
  const size_t smem = p.smem_bytes(gft::AdjSums<kF>::kWarpFloat4s);
  const int e =
      gft::allow_smem<adj_matmul_kernel<kF>>(gft::kMaxWarps * gft::AdjSums<kF>::kWarpFloat4s);
  if (e != 0) return e;
  adj_matmul_kernel<kF><<<grid, p.warps() * kWarp, smem, s>>>(
      r, c, h, o, d, m, k, f, f0, row_offset, col_offset, cr2, whole_rows, p.groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K2 on `stream` and returns cudaGetLastError() (0 on success).
// xr [b,m,4] and xc [b,k,4] (positions in columns 0 and 1) are contiguous f32
// device buffers, 16-byte aligned; h [b,k,f], out [b,m,f] and deg [b,m] are
// contiguous f32 device buffers; b <= 65535.  One kernel launch for each
// chunk of 8 features.
extern "C" int gft_adj_matmul(const void* xr, const void* xc, const void* h, void* out,
                              void* deg, int b, int m, int k, int f, int row_offset,
                              int col_offset, float cr2, void* stream) {
  if (b == 0 || m == 0 || f == 0) return 0;
  const gft::Plan p = adj_matmul_plan(b, m, k);
  const int row_warps = (m + kWarp - 1) / kWarp;
  const dim3 grid((row_warps + p.row_warps - 1) / p.row_warps, b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* r = static_cast<const float4*>(xr);
  const float4* c = static_cast<const float4*>(xc);
  const float* hh = static_cast<const float*>(h);
  float* o = static_cast<float*>(out);
  float* d = static_cast<float*>(deg);
  // one run of 16-byte words a tile: a single chunk, and every swarm's H
  // 16-byte aligned
  const bool whole_rows = f <= kFeat && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                          (static_cast<long long>(k) * f) % 4 == 0;
  for (int f0 = 0; f0 < f; f0 += kFeat) {
    int rc = 0;
    switch (std::min(kFeat, f - f0)) {
#define GFT_CHUNK(n)                                                                    \
  case n:                                                                               \
    rc = launch_chunk<n>(p, grid, s, r, c, hh, o, d, m, k, f, f0, row_offset, col_offset, \
                         cr2, whole_rows);                                              \
    break;
      GFT_CHUNK(1) GFT_CHUNK(2) GFT_CHUNK(3) GFT_CHUNK(4)
      GFT_CHUNK(5) GFT_CHUNK(6) GFT_CHUNK(7) GFT_CHUNK(8)
#undef GFT_CHUNK
    }
    if (rc != 0) return rc;
  }
  return 0;
}

// The launch geometry gft_adj_matmul takes at this shape: grid[0] blocks,
// grid[1] threads a block, grid[2] warps that split a row's columns, each
// launch (one for each chunk of 8 features).
extern "C" void gft_adj_matmul_grid(int b, int m, int k, int* grid) {
  const gft::Plan p = adj_matmul_plan(b, m, k);
  const int row_warps = (m + kWarp - 1) / kWarp;
  grid[0] = b * ((row_warps + p.row_warps - 1) / p.row_warps);
  grid[1] = p.warps() * kWarp;
  grid[2] = p.groups;
}
