// K2: the GNN aggregation A(xr, xc) @ H with the radius adjacency built on the
// fly, written by hand for Hopper (sm_90a).
//
// Replaces gym_flock_tpu/ops/pallas_flocking.py:_adj_matmul_kernel (launched
// by _adj_matmul_impl).  For each row agent i of xr [B,m,sr] (positions in
// columns 0 and 1) it sums the rows of h [B,k,F] over the column agents j of
// xc [B,k,sc] that are its neighbours:
//   dx = xc_x - xr_x,  dy = xc_y - xr_y,  r2 = dx*dx + dy*dy   (f32)
//   adj = r2 < cr2  and  row_offset + i != col_offset + j    (global ids)
//   out[i] = sum_j adj * h[j]     deg[i] = sum_j adj
// Outputs out [B,m,F] f32 and deg [B,m] f32, both raw: the mean pooling and
// the backward pass (the same kernel with operands and offsets swapped, or
// run on dy / deg) are composed by the wrapper, ops/adjacency_matmul.py.
//
// What bounds it: the pair test, about 6 f32 operations on every pair, and
// the F adds of each neighbour pair (a few percent of the pairs at the
// swarms' densities).  The bytes are few: each column tile (positions and H,
// (2 + F) * 4 bytes an agent) is read once per 128 rows.  Tensor cores wait:
// at F = 6 a 128-wide tile product would waste most of each wgmma, and the
// adjacency tile would have to be written to shared memory first.  Known
// limits, left for later work: one row per thread (no register tiling), and
// for F > 8 each further chunk of 8 features repeats the pair test.
//
// Design.  Grid (ceil(m/128), B, ceil(F/8)), 128 threads; each thread owns
// one row agent and keeps 8 feature sums in registers.  The block walks over
// column tiles of 128 agents staged in shared memory (positions as SoA, and
// the tile's 8 feature columns of H): this loop replaces the TPU's sequential
// column grid axis.  No atomics, so the result is deterministic.
// * The ragged edges (m, k and F not multiples of the tiles) are masked by
//   bounds, not by far-away padding agents.
// * The self pair (equal global ids) is skipped, as the Pallas kernel masks it.
// * r2 is formed with __fmul_rn/__fadd_rn, so no FMA contraction moves it
//   across the radius: the degree equals the plain version's exactly.
// * The sums accumulate in f64 (the TPU kernel's MXU accumulates in f32), as
//   the plain version's do, and are rounded to f32 once at the end.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;  // threads per block, one row agent each
constexpr int kTile = 128;  // column agents staged per shared-memory tile
constexpr int kFeat = 8;    // feature columns per block; grid z walks over F

__global__ void __launch_bounds__(kRows)
adj_matmul_kernel(const float* __restrict__ xr, int sr, const float* __restrict__ xc,
                  int sc, const float* __restrict__ h, float* __restrict__ out,
                  float* __restrict__ deg, int m, int k, int f, int row_offset,
                  int col_offset, float cr2) {
  __shared__ float spx[kTile], spy[kTile];
  __shared__ float sh[kTile][kFeat];
  const int b = blockIdx.y;
  const int f0 = blockIdx.z * kFeat;
  const int nf = min(kFeat, f - f0);
  const int i = blockIdx.x * kRows + threadIdx.x;
  const bool active = i < m;
  // local column index of this row's own global id (may lie outside [0, k))
  const long long self_j =
      static_cast<long long>(row_offset) + i - static_cast<long long>(col_offset);

  float px = 0.f, py = 0.f;
  if (active) {
    const float* r = xr + (static_cast<size_t>(b) * m + i) * sr;
    px = r[0];
    py = r[1];
  }
  const float* xcb = xc + static_cast<size_t>(b) * k * sc;
  const float* hb = h + static_cast<size_t>(b) * k * f;

  double acc[kFeat];
#pragma unroll
  for (int c = 0; c < kFeat; ++c) acc[c] = 0.0;
  int d = 0;

  for (int j0 = 0; j0 < k; j0 += kTile) {
    const int nt = min(kTile, k - j0);
    if (threadIdx.x < nt) {
      const float* c = xcb + static_cast<size_t>(j0 + threadIdx.x) * sc;
      spx[threadIdx.x] = c[0];
      spy[threadIdx.x] = c[1];
    }
    for (int e = threadIdx.x; e < kTile * kFeat; e += kRows) {
      const int t = e / kFeat;
      const int c = e % kFeat;
      sh[t][c] = (t < nt && c < nf) ? hb[static_cast<size_t>(j0 + t) * f + f0 + c] : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int t = 0; t < nt; ++t) {
        const float dx = spx[t] - px;
        const float dy = spy[t] - py;
        const float r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        if (r2 < cr2 && j0 + t != self_j) {
          ++d;
#pragma unroll
          for (int c = 0; c < kFeat; ++c) acc[c] += static_cast<double>(sh[t][c]);
        }
      }
    }
    __syncthreads();
  }

  if (active) {
    float* o = out + (static_cast<size_t>(b) * m + i) * f + f0;
#pragma unroll
    for (int c = 0; c < kFeat; ++c) {
      if (c < nf) o[c] = static_cast<float>(acc[c]);
    }
    if (blockIdx.z == 0) deg[static_cast<size_t>(b) * m + i] = static_cast<float>(d);
  }
}

}  // namespace

// Launches K2 on `stream` and returns cudaGetLastError() (0 on success).
// xr [b,m,sr], xc [b,k,sc] (positions in columns 0, 1; sr, sc >= 2), h [b,k,f],
// out [b,m,f] and deg [b,m] are contiguous f32 device buffers; b <= 65535 and
// ceil(f/8) <= 65535.
extern "C" int gft_adj_matmul(const void* xr, int sr, const void* xc, int sc,
                              const void* h, void* out, void* deg, int b, int m,
                              int k, int f, int row_offset, int col_offset, float cr2,
                              void* stream) {
  if (b == 0 || m == 0 || f == 0) return 0;
  const dim3 grid((m + kRows - 1) / kRows, b, (f + kFeat - 1) / kFeat);
  adj_matmul_kernel<<<grid, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), sr, static_cast<const float*>(xc), sc,
      static_cast<const float*>(h), static_cast<float*>(out), static_cast<float*>(deg),
      m, k, f, row_offset, col_offset, cr2);
  return static_cast<int>(cudaGetLastError());
}
