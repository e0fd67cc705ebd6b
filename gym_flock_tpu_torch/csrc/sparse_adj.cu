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
// What bounds it: the pair test on every listed pair (about 6 f32
// operations) and F adds per neighbour pair.  It reads each listed column
// block ((2 + F) * 4 bytes an agent) once per row block, so the bytes are
// few.  Known limits, left for later work:
// * at N=65,536 and B=1 the grid has only 512 blocks of 128 threads for
//   132 SMs;
// * the gathers of xs and hs through the permutation and the scatter of the
//   result back to agent order run outside the kernel, as further passes.
//
// Design.  Grid (n_b, B, ceil(F/8)), 128 threads; each thread owns one sorted
// row agent and keeps 8 feature sums in registers.  The block walks over its
// row of the table: this loop replaces the TPU's sequential k grid axis and
// its scalar prefetch.  A slot is block-uniform, so a pad slot (or any entry
// outside [0, n_b)) is skipped whole, and __syncthreads stays uniform.  A
// listed column block is staged in shared memory: positions as SoA and the
// block's 8 feature columns of hs.  No atomics, so the result is
// deterministic.
// * r2 is formed with __fmul_rn/__fadd_rn, so no FMA contraction moves it
//   across the radius: the degree equals the plain version's exactly.
// * The sums accumulate in f64 (the TPU kernel's MXU accumulates in f32), as
//   the plain version's do, and are rounded to f32 once at the end.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // agents per block of the table = threads per block
constexpr int kFeat = 8;     // feature columns per block; grid z walks over F

__global__ void __launch_bounds__(kBlock)
sparse_adj_kernel(const float* __restrict__ xs, const float* __restrict__ hs,
                  const int* __restrict__ table, float* __restrict__ out,
                  float* __restrict__ deg, int n, int k_max, int f, float cr2) {
  __shared__ float spx[kBlock], spy[kBlock];
  __shared__ float sh[kBlock][kFeat];
  const int n_b = n / kBlock;
  const int b = blockIdx.y;
  const int i = blockIdx.x;
  const int f0 = blockIdx.z * kFeat;
  const int nf = min(kFeat, f - f0);
  const int tid = threadIdx.x;
  const float4* xb = reinterpret_cast<const float4*>(xs) + static_cast<size_t>(b) * n;
  const float* hb = hs + static_cast<size_t>(b) * n * f;
  const int* slots = table + (static_cast<size_t>(b) * n_b + i) * k_max;

  const float4 me = xb[static_cast<size_t>(i) * kBlock + tid];
  double acc[kFeat];
#pragma unroll
  for (int c = 0; c < kFeat; ++c) acc[c] = 0.0;
  int d = 0;

  for (int s = 0; s < k_max; ++s) {
    const int j = slots[s];
    if (j < 0 || j >= n_b) continue;  // block-uniform: the whole block skips
    const float4 c = xb[static_cast<size_t>(j) * kBlock + tid];
    spx[tid] = c.x;
    spy[tid] = c.y;
    const float* hj = hb + static_cast<size_t>(j) * kBlock * f;
    for (int e = tid; e < kBlock * kFeat; e += kBlock) {
      const int t = e / kFeat;
      const int q = e % kFeat;
      sh[t][q] = q < nf ? hj[static_cast<size_t>(t) * f + f0 + q] : 0.f;
    }
    __syncthreads();
    const int self_t = (j == i) ? tid : -1;
    for (int t = 0; t < kBlock; ++t) {
      const float dx = spx[t] - me.x;
      const float dy = spy[t] - me.y;
      const float r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      if (r2 < cr2 && t != self_t) {
        ++d;
#pragma unroll
        for (int q = 0; q < kFeat; ++q) acc[q] += static_cast<double>(sh[t][q]);
      }
    }
    __syncthreads();
  }

  const size_t row = static_cast<size_t>(b) * n + static_cast<size_t>(i) * kBlock + tid;
  float* o = out + row * f + f0;
#pragma unroll
  for (int q = 0; q < kFeat; ++q) {
    if (q < nf) o[q] = static_cast<float>(acc[q]);
  }
  if (blockIdx.z == 0) deg[row] = static_cast<float>(d);
}

}  // namespace

// Launches K4 on `stream` and returns cudaGetLastError() (0 on success).
// xs [b,n,4] f32 (16-byte aligned), hs [b,n,f] f32, table [b,n/128,k_max]
// int32, out [b,n,f] f32 and deg [b,n] f32 are contiguous device buffers; n is
// a multiple of 128, b <= 65535 and ceil(f/8) <= 65535.
extern "C" int gft_sparse_adj(const void* xs, const void* hs, const void* table, void* out,
                              void* deg, int b, int n, int k_max, int f, float cr2,
                              void* stream) {
  if (b == 0 || n == 0 || f == 0) return 0;
  const dim3 grid(n / kBlock, b, (f + kFeat - 1) / kFeat);
  sparse_adj_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(hs),
      static_cast<const int*>(table), static_cast<float*>(out), static_cast<float*>(deg), n,
      k_max, f, cr2);
  return static_cast<int>(cudaGetLastError());
}
