// K6: the dense flocking pass of the small-N envs, one block a swarm,
// written by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this pass
// (gym_flock_tpu/envs/flocking.py:flocking_obs_expert_pass) as dense [B,N,N]
// ops and leaves their fusion to XLA.  Run as separate PyTorch ops, the pass
// wrote and read back a dozen [B,N,N] temporaries a step.  For each row
// agent i of swarm b of x [B,N,4] (px,py,vx,vy), over the other agents j,
// with d* = row minus column, adj = r2 < cr2, inv = 1/r2:
//   values [N,6]: sum adj*dvx, adj*dx*inv^2, adj*dx*inv, and the same for y
//   network [N,N]: adj * (1/deg) mean-pooled (deg = 0 read as 1), else adj
//   sums [N,4]: the Turner expert's gradient sums gx, gy over the pairs with
//     !(r2 > cr) (the UNSQUARED radius, as the reference cuts), masked by adj
//     when decentralized; and its velocity-difference sums, by the closed
//     form N v_i - sum_j v_j when centralized, else values 0 and 3.
// An obstacle mask (FlockingObstacle-v0; bool [N], shared by the batch)
// zeroes the velocity differences of obstacle rows and columns, and the
// centralized velocity sums are then the masked row sums over every column.
// values and network go into caller-given views with any batch stride (a
// rollout's trajectory slot); an output whose pointer is null is not
// written.
//
// What bounds it: the bytes of the network, B*N*N*4 (328 MB at B=8192,
// N=100, 0.098 ms at 3.35 TB/s); the state, values and sums are 1/10 of
// that.
//
// Design.  A block of 32*ceil(N/32) threads owns swarm b; thread i owns row
// agent i.  The swarm's rows are staged in shared memory once.  Pass 1 walks
// the columns in chunks of 32, each a broadcast shared load: (a) a test pass
// over every column sets bit k of a hit mask where !(r2 > cut) (cut folds
// r2 < cr2 and, centralized, !(r2 > cr) into one compare, as K1 does; NaN
// pairs hit) and bit k of the adjacency word where r2 < cr2; (b) the body,
// over the hit bits in column order, is K1's pair step
// (gft::PairSums::add, flocking_pairs.cuh): the same f32 terms and f64
// sums, its degree exact.  Every pair it skips adds exact zeros (with finite
// velocities), as in K1.  The adjacency words go to shared memory; pass 2
// writes the network: a warp a row, 16-byte stores of four columns where the
// row and the view are 16-byte aligned (N % 4 == 0), else 4-byte stores;
// each entry is the row's reciprocal or 0.
// * r2 is formed with __fmul_rn/__fadd_rn and the reciprocal with
//   __frcp_rn, so no FMA contraction moves a pair across the radius: the
//   adjacency, the degree and the network equal the plain version's bit for
//   bit (its 1.0 / deg is PyTorch's IEEE reciprocal times 1).
// * The diagonal is excluded by index.  Two distinct agents at r2 = 0 give
//   the plain version's NaN (0 * inf) in the sums.
// * The value terms equal the plain version's bit for bit and are summed in
//   another order and in f64; the gradient is K1's 2 inv (1 - inv) d, the
//   plain version's -2 d inv^2 + 2 d inv in another rounding: within
//   ~2e-6 of the terms' summed magnitudes at the envs' radius (r2 <= cr <
//   1), against the 1e-5 it is held to.
// * An obstacle pair's velocity difference is zeroed by handing the pair
//   step a column with the row's own velocity (v_i - v_i = +0, the plain
//   version's zero).
// * The closed form's total sum_j v_j is summed in f64 by every warp in the
//   same order and rounded to f32: deterministic, no atomics anywhere.
// N <= kMaxAgents = 512: the rows (16 B an agent), the adjacency words
// (N*ceil(N/32)*4 B), the row reciprocals (4 B an agent) and the obstacle
// flags (1 B an agent) take at most 43 KB, inside the 48 KB a block gets
// without opting in.
#include "flocking_pairs.cuh"

#include <cstdint>

namespace {

using gft::kWarp;

constexpr int kMaxAgents = 512;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kCentral, bool kObstacle, bool kVec4>
__global__ void __launch_bounds__(kMaxAgents)
dense_pass_kernel(const float4* __restrict__ x, const bool* __restrict__ obstacle, int n,
                  gft::Reach reach, int mean_pool, float* __restrict__ values,
                  long long values_stride, float* __restrict__ network,
                  long long network_stride, float4* __restrict__ sums) {
  extern __shared__ float4 smem[];
  const int chunks = (n + kWarp - 1) / kWarp;
  float4* sx = smem;                                         // [n]
  unsigned* adj_words = reinterpret_cast<unsigned*>(sx + n); // [chunks][n]
  float* row_scale = reinterpret_cast<float*>(adj_words + chunks * n);  // [n]
  bool* skip = reinterpret_cast<bool*>(row_scale + n);       // [n] obstacle flags
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i % kWarp;
  const float4* xb = x + static_cast<size_t>(b) * n;
  for (int j = i; j < n; j += blockDim.x) {
    sx[j] = xb[j];
    if (kObstacle) skip[j] = obstacle[j];
  }
  __syncthreads();
  // centralized: every lane of every warp sums the swarm's velocities in
  // the same order, so each row subtracts the same total
  float tx = 0.f, ty = 0.f;
  if (kCentral && !kObstacle) {
    double ax = 0.0, ay = 0.0;
    for (int j = lane; j < n; j += kWarp) {
      ax += static_cast<double>(sx[j].z);
      ay += static_cast<double>(sx[j].w);
    }
    tx = static_cast<float>(warp_sum(ax));
    ty = static_cast<float>(warp_sum(ay));
  }

  if (i < n) {
    const float4 me = sx[i];
    const bool obstacle_row = kObstacle && skip[i];
    gft::PairSums<!kCentral, false> acc;  // decentralized: masked gradients too
    double mx = 0.0, my = 0.0;            // centralized under a mask: the row sums
    for (int c = 0; c < chunks; ++c) {
      const int j0 = c * kWarp;
      const int cols = min(kWarp, n - j0);
      unsigned hits = 0, adj = 0;
      // (a) the test pass: no divide, no f64 but under a mask
#pragma unroll 8
      for (int k = 0; k < cols; ++k) {
        const float4 o = sx[j0 + k];
        const float dx = me.x - o.x;
        const float dy = me.y - o.y;
        const float r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        hits |= (r2 > reach.cut ? 0u : 1u) << k;
        adj |= (r2 < reach.cr2 ? 1u : 0u) << k;
        if (kCentral && kObstacle && !obstacle_row && !skip[j0 + k]) {
          mx += static_cast<double>(me.z - o.z);
          my += static_cast<double>(me.w - o.w);
        }
      }
      if (i >= j0 && i < j0 + cols) {  // the diagonal, by index
        hits &= ~(1u << (i - j0));
        adj &= ~(1u << (i - j0));
      }
      // (b) the body pass, over this lane's hits in column order
      while (hits) {
        const int k = __ffs(hits) - 1;
        hits &= hits - 1;
        float4 o = sx[j0 + k];
        if (kObstacle && (obstacle_row || skip[j0 + k])) {
          o.z = me.z;
          o.w = me.w;
        }
        acc.add(me, o, reach.cr, reach.cr2);
      }
      if (network) adj_words[c * n + i] = adj;
    }
    if (network) {
      const float d = acc.deg == 0 ? 1.f : static_cast<float>(acc.deg);
      row_scale[i] = mean_pool ? __fmul_rn(1.f, __frcp_rn(d)) : 1.f;
    }
    float vals[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) vals[q] = static_cast<float>(acc.s[q]);
    if (values) {
      float* row = values + static_cast<size_t>(b) * values_stride + static_cast<size_t>(i) * 6;
#pragma unroll
      for (int q = 0; q < 6; ++q) row[q] = vals[q];
    }
    float dvx = vals[0], dvy = vals[3];
    if (kCentral && kObstacle) {
      dvx = static_cast<float>(mx);
      dvy = static_cast<float>(my);
    } else if (kCentral) {
      const float fn = static_cast<float>(n);
      dvx = __fsub_rn(__fmul_rn(fn, me.z), tx);
      dvy = __fsub_rn(__fmul_rn(fn, me.w), ty);
    }
    // the gradient sums: channels 6/7, or 10/11 (adjacency-masked)
    const int g = kCentral ? 6 : 8;
    sums[static_cast<size_t>(b) * n + i] = make_float4(
        static_cast<float>(acc.s[g]), static_cast<float>(acc.s[g + 1]), dvx, dvy);
  }

  if (!network) return;  // uniform across the block
  __syncthreads();
  // pass 2: a warp a row
  const int warp = i / kWarp;
  const int warps = blockDim.x / kWarp;
  float* net = network + static_cast<size_t>(b) * network_stride;
  for (int r = warp; r < n; r += warps) {
    const float v = row_scale[r];
    float* row = net + static_cast<size_t>(r) * n;
    if (kVec4) {
      for (int q = lane; 4 * q < n; q += kWarp) {
        const int col = 4 * q;
        const unsigned nib = adj_words[(col / kWarp) * n + r] >> (col % kWarp);
        reinterpret_cast<float4*>(row)[q] = make_float4(
            nib & 1u ? v : 0.f, nib & 2u ? v : 0.f, nib & 4u ? v : 0.f, nib & 8u ? v : 0.f);
      }
    } else {
      for (int col = lane; col < n; col += kWarp) {
        const unsigned bit = adj_words[(col / kWarp) * n + r] >> (col % kWarp);
        row[col] = bit & 1u ? v : 0.f;
      }
    }
  }
}

template <bool kCentral, bool kObstacle, bool kVec4>
int launch(const void* x, const void* obstacle, int b, int n, const gft::Reach& reach,
           int mean_pool, void* values, long long values_stride, void* network,
           long long network_stride, void* sums, size_t smem, cudaStream_t s) {
  const int threads = ((n + kWarp - 1) / kWarp) * kWarp;
  dense_pass_kernel<kCentral, kObstacle, kVec4><<<b, threads, smem, s>>>(
      static_cast<const float4*>(x), static_cast<const bool*>(obstacle), n, reach, mean_pool,
      static_cast<float*>(values), values_stride, static_cast<float*>(network), network_stride,
      static_cast<float4*>(sums));
  return static_cast<int>(cudaGetLastError());
}

template <bool kCentral, bool kObstacle>
int launch_mode(bool vec4, const void* x, const void* obstacle, int b, int n,
                const gft::Reach& reach, int mean_pool, void* values, long long values_stride,
                void* network, long long network_stride, void* sums, size_t smem,
                cudaStream_t s) {
  return vec4 ? launch<kCentral, kObstacle, true>(x, obstacle, b, n, reach, mean_pool, values,
                                                  values_stride, network, network_stride, sums,
                                                  smem, s)
              : launch<kCentral, kObstacle, false>(x, obstacle, b, n, reach, mean_pool, values,
                                                   values_stride, network, network_stride, sums,
                                                   smem, s);
}

}  // namespace

// Launches K6 on `stream` of card `device` (made current for the launch and
// restored) and returns a cudaError_t (0 on success), cudaErrorInvalidValue
// for n > gft_dense_pass_max_agents().  x [b,n,4] and sums [b,n,4] are
// contiguous f32 device buffers, 16-byte aligned; obstacle is a bool [n]
// device buffer (true = obstacle agent), or null for none.  values [b,n,6]
// and network [b,n,n] are f32 views whose rows are contiguous and whose
// swarms lie values_stride / network_stride floats apart; null leaves that
// output unwritten.  centralized, mean_pool: 0 or 1.
extern "C" int gft_dense_pass(const void* x, const void* obstacle, int b, int n, float cr,
                              float cr2, int centralized, int mean_pool, void* values,
                              long long values_stride, void* network, long long network_stride,
                              void* sums, int device, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (n > kMaxAgents) return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t chunks = (n + kWarp - 1) / kWarp;
  const size_t smem = n * (sizeof(float4) + chunks * sizeof(unsigned) + sizeof(float) + 1);
  // !(r2 > cut): centralized, r2 < cr2 || !(r2 > cr); else r2 < cr2 alone,
  // as only the adjacent pairs add to the masked sums
  gft::Reach reach = gft::make_reach(cr, cr2);
  if (!centralized) reach.cut = std::nextafter(cr2, -std::numeric_limits<float>::infinity());
  const bool vec4 = network != nullptr && n % 4 == 0 &&
                    reinterpret_cast<std::uintptr_t>(network) % 16 == 0 &&
                    network_stride % 4 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  int rc;
  if (centralized) {
    rc = obstacle ? launch_mode<true, true>(vec4, x, obstacle, b, n, reach, mean_pool, values,
                                            values_stride, network, network_stride, sums, smem, s)
                  : launch_mode<true, false>(vec4, x, obstacle, b, n, reach, mean_pool, values,
                                             values_stride, network, network_stride, sums, smem,
                                             s);
  } else {
    rc = obstacle ? launch_mode<false, true>(vec4, x, obstacle, b, n, reach, mean_pool, values,
                                             values_stride, network, network_stride, sums, smem,
                                             s)
                  : launch_mode<false, false>(vec4, x, obstacle, b, n, reach, mean_pool, values,
                                              values_stride, network, network_stride, sums, smem,
                                              s);
  }
  if (current != device) cudaSetDevice(current);
  return rc;
}

// The largest swarm K6 takes.
extern "C" int gft_dense_pass_max_agents() { return kMaxAgents; }
