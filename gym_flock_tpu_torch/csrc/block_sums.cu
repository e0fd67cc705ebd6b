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
// What bounds it: f32 divide and FMA throughput, at about 30 flops and one
// IEEE divide per pair; it reads O(N) bytes per swarm (each column tile once
// per 128 rows).  wgmma and TMA do not apply: there is no matrix product and
// few bytes.  The later speed-up is occupancy, several rows per thread
// (register tiling, so that each staged column feeds more pairs), and rcp in
// place of the IEEE divide.
//
// Design.  Grid (ceil(m/128), B), 128 threads; each thread owns one row
// agent and keeps its accumulators in registers.  The block walks over
// column tiles of xc staged in shared memory as SoA px,py,vx,vy: this loop
// replaces the TPU's sequential column grid axis.  No atomics, so the result
// is deterministic; channel 9 is a running fminf.
// * The self pair (equal global ids) is skipped: the Pallas kernel's
//   r2 := inf, zero in every sum and absent from the min.
// * The ragged edge is masked by bounds (no far-away padding agents).  A row
//   with no other agent gets channel 9 = +inf.
// * r2 is formed with __fmul_rn/__fadd_rn, so no FMA contraction moves it
//   across the radius: the degree equals the plain version's exactly.  The
//   divide stays IEEE (built without --use_fast_math, -prec-div=true).
// * Two distinct agents at r2 = 0 give NaN (0 * inf), as in JAX.
// * Each pair term is formed in f32 as in the JAX kernel; the sums
//   accumulate in f64.  At N=4096 two f32 summation orders of the 1/r^4
//   channels differ by up to 7e-5 relative to (1 + |sum|), too close to the
//   1e-4 bound the kernel is held to.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRows = 128;  // threads per block, one row agent each
constexpr int kTile = 128;  // column agents staged per shared-memory tile
constexpr int kOut = 16;    // output channels per agent

template <bool kFull>
__global__ void __launch_bounds__(kRows)
block_sums_kernel(const float* __restrict__ xr, const float* __restrict__ xc,
                  float* __restrict__ out, int m, int k, int row_offset,
                  int col_offset, float cr, float cr2) {
  __shared__ float spx[kTile], spy[kTile], svx[kTile], svy[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kRows + threadIdx.x;
  const bool active = i < m;
  // local column index of this row's own global id (may lie outside [0, k))
  const long long self_j =
      static_cast<long long>(row_offset) + i - static_cast<long long>(col_offset);

  float px = 0.f, py = 0.f, vx = 0.f, vy = 0.f;
  if (active) {
    const float* r = xr + (static_cast<size_t>(b) * m + i) * 4;
    px = r[0];
    py = r[1];
    vx = r[2];
    vy = r[3];
  }
  const float* xcb = xc + static_cast<size_t>(b) * k * 4;

  double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0, s4 = 0.0, s5 = 0.0;
  double s6 = 0.0, s7 = 0.0, s10 = 0.0, s11 = 0.0;
  int deg = 0;
  float rmin = CUDART_INF_F;

  for (int j0 = 0; j0 < k; j0 += kTile) {
    const int jl = j0 + threadIdx.x;
    if (jl < k) {
      const float* c = xcb + static_cast<size_t>(jl) * 4;
      spx[threadIdx.x] = c[0];
      spy[threadIdx.x] = c[1];
      svx[threadIdx.x] = c[2];
      svy[threadIdx.x] = c[3];
    }
    __syncthreads();
    const int nt = min(kTile, k - j0);
    if (active) {
      for (int t = 0; t < nt; ++t) {
        if (j0 + t == self_j) continue;
        const float dx = px - spx[t];
        const float dy = py - spy[t];
        const float dvx = vx - svx[t];
        const float dvy = vy - svy[t];
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
        if (kFull) {
          rmin = fminf(rmin, r2);
          s10 += gx * adj;
          s11 += gy * adj;
        }
      }
    }
    __syncthreads();
  }

  if (active) {
    float4* o = reinterpret_cast<float4*>(out + (static_cast<size_t>(b) * m + i) * kOut);
    o[0] = make_float4(static_cast<float>(s0), static_cast<float>(s1),
                       static_cast<float>(s2), static_cast<float>(s3));
    o[1] = make_float4(static_cast<float>(s4), static_cast<float>(s5),
                       static_cast<float>(s6), static_cast<float>(s7));
    if (kFull) {
      o[2] = make_float4(static_cast<float>(deg), rmin, static_cast<float>(s10),
                         static_cast<float>(s11));
    } else {
      o[2] = make_float4(static_cast<float>(deg), 0.f, 0.f, 0.f);
    }
    o[3] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// xr [b,m,4], xc [b,k,4] and out [b,m,16] are contiguous f32 device buffers,
// out 16-byte aligned; b <= 65535.  full: 0 = "core", 1 = "full".
extern "C" int gft_block_sums(const void* xr, const void* xc, void* out, int b,
                              int m, int k, int row_offset, int col_offset,
                              float cr, float cr2, int full, void* stream) {
  if (b == 0 || m == 0) return 0;
  const dim3 grid((m + kRows - 1) / kRows, b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(xr);
  const float* c = static_cast<const float*>(xc);
  float* o = static_cast<float*>(out);
  if (full) {
    block_sums_kernel<true><<<grid, kRows, 0, s>>>(r, c, o, m, k, row_offset,
                                                   col_offset, cr, cr2);
  } else {
    block_sums_kernel<false><<<grid, kRows, 0, s>>>(r, c, o, m, k, row_offset,
                                                    col_offset, cr, cr2);
  }
  return static_cast<int>(cudaGetLastError());
}
