// K8: the fused flocking rollout's step tail, a warp or a block a swarm,
// written by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this tail of its rollout
// step (gym_flock_tpu/envs/flocking.py: the expert's action, _integrate and
// _instant_cost after the fused pass) to XLA's fusion.  Run as PyTorch ops
// it was about thirty small launches a step (a stack, a clamp and a divide;
// some eighteen elementwise kernels over strided [B,N] views ending in a
// stack; a var, a sum and a multiply; two slot copies).  For each agent of
// swarm b, from the state x [B,N,4] (px,py,vx,vy) and the expert's four
// sums gx, gy, dvx, dvy [B,N] (any element and batch stride):
//   u  = clamp((-gx - dvx, -dvy - gy), -10, 10) / action_scalar
//   a  = u * action_scale, times the integration mask where there is one
//   x' = (px + vx dt + ax dt dt 0.5, py + vy dt + ay dt dt 0.5,
//         vx + ax dt, vy + ay dt)
// and for the swarm the reward -(var(vx') + var(vy')) over its agents
// (ddof 0).  u goes into a trajectory's [B,N,2] slot (rows contiguous, any
// batch stride), the reward into a [B] slot (any stride), x' into a fresh
// contiguous [B,N,4].
//
// What bounds it: bytes.  x and the four sums are read (32 B an agent), x'
// and u written (24 B) and the reward (4 B a swarm): 56 B N + 4 B, 367 MB
// at B=65,535, N=100 (0.110 ms at 3.35 TB/s).  The arithmetic is a few
// dozen flops an agent.
//
// Design.
// * u and x' are PyTorch's own f32 sequence, operation for operation, so
//   they equal the plain version's bit for bit: __fmul_rn/__fadd_rn/
//   __fsub_rn keep nvcc from contracting a*b+c into an FMA; the divide by
//   the host scalar action_scalar is PyTorch's, a multiply by its f32
//   reciprocal rounded on the host; the clamp passes NaN through, as
//   PyTorch's does.
// * The reward needs a whole swarm, so a swarm belongs to one group of
//   threads: a warp (8 swarms a block) when N <= 128, else a block of
//   32 ceil(N/128) threads (at most 1024), each thread walking its agents
//   at a stride of the group.  Consecutive threads take consecutive agents:
//   x and x' move as 16-byte loads and stores, u as 8-byte stores, and the
//   sums as one 16-byte load an agent where they are K6's interleaved
//   [B,N,4] (gx, gy, dvx, dvy at one address), else as four 4-byte loads.
// * The variance reads nothing twice: each thread sums its agents' new
//   velocities and their squares as f64 deviations from agent 0's new
//   velocity (which every thread computes alike), and the group adds them
//   (warp shuffles, then shared memory across a block's warps) in a fixed
//   order: var = E[d^2] - E[d]^2.  f64 keeps the cancellation far below the
//   f32 result's rounding, and the shift makes a swarm of equal velocities
//   read exactly 0.  The plain version's torch.var sums in f32 in another
//   order, so the reward agrees with it to within its rounding, not bit for
//   bit.
// * The batch is on grid x (up to 2^31 - 1 blocks), so K8 adds no limit on
//   B; no atomics, deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAgentsPerThread = 4;   // sizes a block-mode group
constexpr int kWarpSwarms = 8;        // swarms a block in warp mode
constexpr int kMaxThreads = 1024;

struct Sums {
  const float* p[4];  // gx, gy, dvx, dvy
  long long es[4];    // element strides, in floats
  long long bs[4];    // batch strides, in floats
};

struct Coef {
  float inv_scalar;  // 1 / action_scalar, rounded in f32 on the host
  float scale;       // action_scale
  float dt;
};

__device__ __forceinline__ float clamp10(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, -10.f), 10.f);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <bool kPacked>
__device__ __forceinline__ float4 load_sums(const Sums& s, long long b, int j) {
  if (kPacked) {
    return reinterpret_cast<const float4*>(s.p[0] + b * s.bs[0])[j];
  }
  return make_float4(s.p[0][b * s.bs[0] + j * s.es[0]], s.p[1][b * s.bs[1] + j * s.es[1]],
                     s.p[2][b * s.bs[2] + j * s.es[2]], s.p[3][b * s.bs[3] + j * s.es[3]]);
}

// One agent: its action u and its next state, in PyTorch's order.
__device__ __forceinline__ void tail_agent(const float4 xi, const float4 q, float m,
                                           const Coef& c, float2& u, float4& xn) {
  u.x = __fmul_rn(clamp10(__fsub_rn(-q.x, q.z)), c.inv_scalar);  // (-gx - dvx)
  u.y = __fmul_rn(clamp10(__fsub_rn(-q.w, q.y)), c.inv_scalar);  // (-dvy - gy)
  const float ax = __fmul_rn(__fmul_rn(u.x, c.scale), m);
  const float ay = __fmul_rn(__fmul_rn(u.y, c.scale), m);
  xn.x = __fadd_rn(__fadd_rn(xi.x, __fmul_rn(xi.z, c.dt)),
                   __fmul_rn(__fmul_rn(__fmul_rn(ax, c.dt), c.dt), 0.5f));
  xn.y = __fadd_rn(__fadd_rn(xi.y, __fmul_rn(xi.w, c.dt)),
                   __fmul_rn(__fmul_rn(__fmul_rn(ay, c.dt), c.dt), 0.5f));
  xn.z = __fadd_rn(xi.z, __fmul_rn(ax, c.dt));
  xn.w = __fadd_rn(xi.w, __fmul_rn(ay, c.dt));
}

template <bool kPacked>
__global__ void __launch_bounds__(kMaxThreads)
step_tail_kernel(const float4* __restrict__ x, Sums s, const float* __restrict__ mask, int B,
                 int n, int group, Coef c, float2* __restrict__ u, long long u_stride,
                 float* __restrict__ reward, long long reward_stride,
                 float4* __restrict__ x_next) {
  const int t = threadIdx.x % group;
  const long long b =
      static_cast<long long>(blockIdx.x) * (blockDim.x / group) + threadIdx.x / group;
  if (b >= B) return;  // a whole group leaves: a warp, or the block
  const float4* xb = x + b * n;
  float4* xnb = x_next + b * n;
  float2* ub = u + b * u_stride;

  // the shift: agent 0's new velocity (without a mask the multiply is by
  // 1, exact, where PyTorch's sequence has none)
  float2 u0;
  float4 x0;
  tail_agent(xb[0], load_sums<kPacked>(s, b, 0), mask ? mask[0] : 1.f, c, u0, x0);
  const double kx = x0.z, ky = x0.w;

  double sx = 0.0, sy = 0.0, qx = 0.0, qy = 0.0;
  for (int j = t; j < n; j += group) {
    float2 uj;
    float4 xn;
    tail_agent(xb[j], load_sums<kPacked>(s, b, j), mask ? mask[j] : 1.f, c, uj, xn);
    ub[j] = uj;
    xnb[j] = xn;
    const double dx = static_cast<double>(xn.z) - kx;
    const double dy = static_cast<double>(xn.w) - ky;
    sx += dx;
    sy += dy;
    qx += dx * dx;
    qy += dy * dy;
  }
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  qx = warp_sum(qx);
  qy = warp_sum(qy);
  if (group > kWarp) {  // block mode: one swarm a block, its warps' partials
    __shared__ double part[4][kMaxThreads / kWarp];
    const int w = threadIdx.x / kWarp;
    const int lane = threadIdx.x % kWarp;
    if (lane == 0) {
      part[0][w] = sx;
      part[1][w] = sy;
      part[2][w] = qx;
      part[3][w] = qy;
    }
    __syncthreads();
    if (w != 0) return;
    const int warps = group / kWarp;
    sx = warp_sum(lane < warps ? part[0][lane] : 0.0);
    sy = warp_sum(lane < warps ? part[1][lane] : 0.0);
    qx = warp_sum(lane < warps ? part[2][lane] : 0.0);
    qy = warp_sum(lane < warps ? part[3][lane] : 0.0);
  }
  if (t == 0) {
    const double mx = sx / n, my = sy / n;
    double vx = qx / n - mx * mx, vy = qy / n - my * my;
    vx = vx < 0.0 ? 0.0 : vx;  // rounding below 0; NaN stays NaN
    vy = vy < 0.0 ? 0.0 : vy;
    reward[b * reward_stride] = static_cast<float>(-(vx + vy));
  }
}

template <bool kPacked>
int launch(const void* x, const Sums& s, const void* mask, int b, int n, const Coef& c, void* u,
           long long u_stride, void* reward, long long reward_stride, void* x_next,
           cudaStream_t stream) {
  int group, threads;
  if (n <= kWarp * kAgentsPerThread) {
    group = kWarp;
    threads = kWarp * kWarpSwarms;
  } else {
    const int per = (n + kAgentsPerThread - 1) / kAgentsPerThread;
    group = ((per + kWarp - 1) / kWarp) * kWarp;
    if (group > kMaxThreads) group = kMaxThreads;
    threads = group;
  }
  const int swarms = threads / group;
  const long long blocks = (static_cast<long long>(b) + swarms - 1) / swarms;
  step_tail_kernel<kPacked><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const float4*>(x), s, static_cast<const float*>(mask), b, n, group, c,
      static_cast<float2*>(u), u_stride / 2, static_cast<float*>(reward), reward_stride,
      static_cast<float4*>(x_next));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K8 on `stream` of card `device` (made current for the launch and
// restored) and returns a cudaError_t (0 on success).  x [b,n,4] and x_next
// [b,n,4] are contiguous f32 device buffers, 16-byte aligned.  gx, gy, dvx,
// dvy are f32 [b,n] views; strides holds each one's element and batch
// stride in floats, in that order (8 values).  Where the four are K6's
// interleaved sums (element stride 4, one batch stride that is a multiple
// of 4, gy..dvy at gx + 1..3, gx 16-byte aligned) one 16-byte load reads an
// agent's four.  mask is a contiguous f32 [n] device buffer, or null for
// none.  u is an f32 [b,n,2] view whose rows are contiguous, 8-byte aligned,
// swarms u_stride floats apart (even); reward an f32 [b] view, entries
// reward_stride floats apart.
extern "C" int gft_step_tail(const void* x, const void* gx, const void* gy, const void* dvx,
                             const void* dvy, const long long* strides, const void* mask, int b,
                             int n, float action_scalar, float action_scale, float dt, void* u,
                             long long u_stride, void* reward, long long reward_stride,
                             void* x_next, int device, void* stream) {
  if (b == 0 || n == 0) return 0;
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Sums s;
  const void* p[4] = {gx, gy, dvx, dvy};
  bool packed = reinterpret_cast<unsigned long long>(gx) % 16 == 0;
  for (int k = 0; k < 4; ++k) {
    s.p[k] = static_cast<const float*>(p[k]);
    s.es[k] = strides[2 * k];
    s.bs[k] = strides[2 * k + 1];
    packed = packed && s.p[k] == s.p[0] + k && (n == 1 || s.es[k] == 4) &&
             (b == 1 || (s.bs[k] == s.bs[0] && s.bs[k] % 4 == 0));
  }
  // PyTorch divides by a host scalar as a multiply by its f32 reciprocal
  const Coef c{1.0f / action_scalar, action_scale, dt};
  const auto st = static_cast<cudaStream_t>(stream);
  const int rc = packed ? launch<true>(x, s, mask, b, n, c, u, u_stride, reward, reward_stride,
                                       x_next, st)
                        : launch<false>(x, s, mask, b, n, c, u, u_stride, reward, reward_stride,
                                        x_next, st);
  if (current != device) cudaSetDevice(current);
  return rc;
}
