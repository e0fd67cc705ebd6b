// K5: the greedy coverage expert's row gather + packed min, written by hand
// for Hopper (sm_90a).
//
// Replaces gym_flock_tpu/ops/rowmin.py:_rowmin_kernel.  For each env b and
// robot r it reads the cost row C[rowidx[b,r], :] (bf16, row index g*T + cur
// into the flattened [G*T, Tp] cost operand) and writes
//   out[b,r] = min over t < T of  where(blocked[b,t], 1024, C[row,t]) * 8192 + t
// as f32.  The product and the sum are rounded separately (__fmul_rn,
// __fadd_rn; no FMA contraction), as the plain PyTorch version rounds them,
// so any non-negative cost gives the plain version's f32 result bit for bit.
// On the coverage banks the costs are integers <= 256 plus 1024 for
// unreachable and T <= 8192, so every value is an integer below 2^24 and the
// whole computation is exact.  Decode: loc = m mod 8192; unreachable when the
// cost part is >= 1000.
//
// What bounds it: device-memory bytes.  It reads B*R*Tp*2 bytes of cost rows
// per call (about 590 MB at B=512, R=100, Tp=5696, from a 64 MB operand that
// exceeds the 50 MB L2) and does a few operations per element.  Later speed-up
// is reuse of a row across envs whose robots stand on the same node and L2
// residency of the operand, not tensor cores.
//
// Design.  One block per env with min(R, 8) warps.  The block stages its
// env's blocked[b, :T] bytes in shared memory (at most 8 KB), then each warp
// takes robot rows r = warp, warp + nwarps, ...  The lanes walk the row with
// 16-byte loads (8 bf16), neighbouring lanes on neighbouring addresses, four
// loads in flight per lane.  A packed value is a non-negative float, and
// non-negative floats order like their bit patterns, so the warp reduces the
// bits with __reduce_min_sync.  No atomics: the result is deterministic.
// * The ragged edge is masked by bounds (t < T).  The operand's pad columns
//   (T <= t < Tp, holding 1024) are never read; they could never win the min
//   anyway, since 1024 * 8192 + t > 1024 * 8192 + (T - 1) for t >= T.
// * A fully blocked env gives 1024 * 8192 + 0 for every robot.
// * A row index outside [0, n_rows) reads nothing and writes NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kVec = 8;     // bf16 per 16-byte load
constexpr int kUnroll = 4;  // 16-byte loads in flight per lane

__device__ __forceinline__ unsigned packed_min8(const uint4& q, int t0, int T,
                                                const unsigned char* sblk,
                                                unsigned best) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int t = t0 + j;
    if (t < T) {
      const float c = sblk[t] ? 1024.0f : __bfloat162float(h[j]);
      const float p = __fadd_rn(__fmul_rn(c, 8192.0f), static_cast<float>(t));
      best = min(best, __float_as_uint(p));
    }
  }
  return best;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
rowmin_kernel(const int* __restrict__ rowidx,
              const unsigned char* __restrict__ blocked,
              const __nv_bfloat16* __restrict__ cost, float* __restrict__ out,
              int R, int T, int Tp, int n_rows) {
  extern __shared__ unsigned char sblk[];  // blocked[b, :T]
  const int b = blockIdx.x;
  const unsigned char* bb = blocked + static_cast<size_t>(b) * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) sblk[t] = bb[t];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nvec = (T + kVec - 1) / kVec;  // 16-byte vectors covering [0, T)
  for (int r = warp; r < R; r += nwarps) {
    const size_t o = static_cast<size_t>(b) * R + r;
    const int row = rowidx[o];
    if (row < 0 || row >= n_rows) {
      if (lane == 0) out[o] = CUDART_NAN_F;
      continue;
    }
    const uint4* src = reinterpret_cast<const uint4*>(cost + static_cast<size_t>(row) * Tp);
    unsigned best = 0xffffffffu;
    for (int v0 = lane; v0 < nvec; v0 += 32 * kUnroll) {
      uint4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + u * 32;
        q[u] = v < nvec ? __ldg(src + v) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + u * 32;
        if (v < nvec) best = packed_min8(q[u], v * kVec, T, sblk, best);
      }
    }
    best = __reduce_min_sync(0xffffffffu, best);
    if (lane == 0) out[o] = __uint_as_float(best);
  }
}

}  // namespace

// Launches K5 on `stream` and returns cudaGetLastError() (0 on success).
// rowidx [b,r] int32, blocked [b,t] bytes (0/1), cost [n_rows,tp] bf16 with
// 16-byte aligned rows (tp a multiple of 8, tp >= t) and out [b,r] f32 are
// contiguous device buffers; 1 <= t <= 8192.
extern "C" int gft_rowmin(const void* rowidx, const void* blocked, const void* cost,
                          void* out, int b, int r, int t, int tp, int n_rows,
                          void* stream) {
  if (b == 0 || r == 0) return 0;
  const int warps = r < kMaxWarps ? r : kMaxWarps;
  rowmin_kernel<<<b, warps * 32, t, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rowidx), static_cast<const unsigned char*>(blocked),
      static_cast<const __nv_bfloat16*>(cost), static_cast<float*>(out), r, t, tp,
      n_rows);
  return static_cast<int>(cudaGetLastError());
}
