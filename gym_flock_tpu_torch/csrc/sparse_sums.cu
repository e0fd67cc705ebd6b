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
// What bounds it: f32 divide and FMA throughput, at about 30 flops and one
// IEEE divide per listed pair; it reads each listed column block (2 KB) once
// per row block, so the bytes are few.  Known limits, left for later work:
// * at N=65,536 and B=1 the grid has only 512 blocks of 128 threads for
//   132 SMs, under four waves of small blocks;
// * the gather of xs through the permutation and the scatter of the result
//   back to agent order run outside the kernel, as two more passes.
//
// Design.  Grid (n_b, B), 128 threads; each thread owns one sorted row agent
// and keeps its accumulators in registers.  The block walks over its row of
// the table: this loop replaces the TPU's sequential k grid axis and its
// scalar prefetch.  A slot is block-uniform, so a pad slot (or any entry
// outside [0, n_b)) is skipped whole, and __syncthreads stays uniform.  A
// listed column block is staged in shared memory as SoA px,py,vx,vy (2 KB).
// No atomics, so the result is deterministic.
// * The self pair (same sorted id) is skipped: the Pallas kernel's r2 := inf,
//   zero in every sum and absent from the min.
// * r2 is formed with __fmul_rn/__fadd_rn, so no FMA contraction moves it
//   across the radius: the degree equals the plain version's exactly.  The
//   divide stays IEEE (built without --use_fast_math, -prec-div=true).
// * Each pair term is formed in f32 as in the JAX kernel; the sums
//   accumulate in f64, as in K1's port.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 128;  // agents per block of the table = threads per block
constexpr int kOut = 16;     // output channels per agent

enum ChannelSet { kCore = 0, kExpert = 1, kFull = 2 };

template <int kSet>
__global__ void __launch_bounds__(kBlock)
sparse_sums_kernel(const float* __restrict__ xs, const int* __restrict__ table,
                   float* __restrict__ out, int n, int k_max, float cr, float cr2) {
  constexpr bool kMasked = kSet != kCore;  // channels 10/11
  constexpr bool kMin = kSet == kFull;     // channel 9
  __shared__ float spx[kBlock], spy[kBlock], svx[kBlock], svy[kBlock];
  const int n_b = n / kBlock;
  const int b = blockIdx.y;
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const float4* xb = reinterpret_cast<const float4*>(xs) + static_cast<size_t>(b) * n;
  const int* slots = table + (static_cast<size_t>(b) * n_b + i) * k_max;

  const float4 me = xb[static_cast<size_t>(i) * kBlock + tid];
  double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0, s4 = 0.0, s5 = 0.0;
  double s6 = 0.0, s7 = 0.0, s10 = 0.0, s11 = 0.0;
  int deg = 0;
  float rmin = CUDART_INF_F;

  for (int s = 0; s < k_max; ++s) {
    const int j = slots[s];
    if (j < 0 || j >= n_b) continue;  // block-uniform: the whole block skips
    const float4 c = xb[static_cast<size_t>(j) * kBlock + tid];
    spx[tid] = c.x;
    spy[tid] = c.y;
    svx[tid] = c.z;
    svy[tid] = c.w;
    __syncthreads();
    const int self_t = (j == i) ? tid : -1;
    for (int t = 0; t < kBlock; ++t) {
      if (t == self_t) continue;
      const float dx = me.x - spx[t];
      const float dy = me.y - spy[t];
      const float dvx = me.z - svx[t];
      const float dvy = me.w - svy[t];
      const float r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const float adj = r2 < cr2 ? 1.0f : 0.0f;
      const float inv = 1.0f / r2;
      const float inv2 = inv * inv;
      const float gfac = r2 > cr ? 0.0f : 2.0f * inv * (1.0f - inv);
      const float gx = dx * gfac;
      const float gy = dy * gfac;
      s0 += dvx * adj;
      s1 += dx * inv2 * adj;
      s2 += dx * inv * adj;
      s3 += dvy * adj;
      s4 += dy * inv2 * adj;
      s5 += dy * inv * adj;
      s6 += gx;
      s7 += gy;
      deg += r2 < cr2;
      if (kMasked) {
        s10 += gx * adj;
        s11 += gy * adj;
      }
      if (kMin) rmin = fminf(rmin, r2);
    }
    __syncthreads();
  }

  float4* o = reinterpret_cast<float4*>(
      out + (static_cast<size_t>(b) * n + static_cast<size_t>(i) * kBlock + tid) * kOut);
  o[0] = make_float4(static_cast<float>(s0), static_cast<float>(s1),
                     static_cast<float>(s2), static_cast<float>(s3));
  o[1] = make_float4(static_cast<float>(s4), static_cast<float>(s5),
                     static_cast<float>(s6), static_cast<float>(s7));
  if (kMasked) {
    o[2] = make_float4(static_cast<float>(deg), kMin ? rmin : 0.f,
                       static_cast<float>(s10), static_cast<float>(s11));
  } else {
    o[2] = make_float4(static_cast<float>(deg), 0.f, 0.f, 0.f);
  }
  o[3] = make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace

// Launches K3 on `stream` and returns cudaGetLastError() (0 on success).
// xs [b,n,4] f32 (16-byte aligned), table [b,n/128,k_max] int32 and out
// [b,n,16] f32 (16-byte aligned) are contiguous device buffers; n is a
// multiple of 128 and b <= 65535.  set: 0 = "core", 1 = "expert", 2 = "full".
extern "C" int gft_sparse_sums(const void* xs, const void* table, void* out, int b,
                               int n, int k_max, float cr, float cr2, int set,
                               void* stream) {
  if (b == 0 || n == 0) return 0;
  const dim3 grid(n / kBlock, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xs);
  const int* tb = static_cast<const int*>(table);
  float* o = static_cast<float*>(out);
  switch (set) {
    case kCore:
      sparse_sums_kernel<kCore><<<grid, kBlock, 0, st>>>(x, tb, o, n, k_max, cr, cr2);
      break;
    case kExpert:
      sparse_sums_kernel<kExpert><<<grid, kBlock, 0, st>>>(x, tb, o, n, k_max, cr, cr2);
      break;
    case kFull:
      sparse_sums_kernel<kFull><<<grid, kBlock, 0, st>>>(x, tb, o, n, k_max, cr, cr2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
