// K7: the coverage step's movement-conflict resolution, one warp a world,
// written by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes the resolution
// (gym_flock_tpu/envs/coverage.py:_resolve_conflicts) as a vectorized fixed
// point under XLA's while_loop, on the device.  Run as PyTorch ops, that
// fixed point takes a host read a round (about 18 rounds a step at R=100) and
// a dozen small [B,R,R] bool ops each.  This kernel computes upstream's two
// sequential passes (gym-flock coverage.py:186-201) directly, once a step:
//   pass 1: out[j] = chosen[j] == cur[j] ? cur[j] : -1
//   pass 2: for i in index order with out[i] == -1:
//             out[i] = chosen[i] appears in out ? cur[i] : chosen[i]
// cur and chosen are node ids >= 0 (the neighbour table is self-padded), so
// -1 marks an unset entry, as in the passes.  The result is exact int32.
//
// What bounds it: latency, not bytes.  Pass 2 is a chain of up to R
// dependent steps per world; each compares one id with the R entries of
// out, ceil(R/32) compares a lane (R*ceil(R/32) = 400 a world at R=100,
// whatever the map's size).  The bytes are 12*B*R (cur, chosen read, out
// written: 0.61 MB, 0.18 us at 3.35 TB/s, at B=512, R=100).
//
// Design.  A warp owns world b, kWarps worlds to a block, so B=512 is 128
// blocks, about one wave on 132 SMs.  out[R] lives in shared memory (4*R
// bytes a warp).  Pass 1 is parallel over the lanes.  Pass 2 walks the
// robots a word of 32 at a time: the lanes hold their robot's cur and chosen
// in registers, a ballot names the word's unset robots, and for each in
// index order the warp broadcasts its chosen id (__shfl_sync), every lane
// compares it with its slice of out, __any_sync decides "taken", the
// robot's own lane writes its entry, and __syncwarp orders that write before
// the next robot's compares.  No atomics, no rounds, no host read; the
// result is deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // worlds a block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
resolve_conflicts_kernel(const int* __restrict__ cur, const int* __restrict__ chosen,
                         int* __restrict__ out, int B, int R) {
  extern __shared__ int s_all[];  // [kWarps, R]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp leaves; nothing below syncs the block
  int* s_out = s_all + warp * R;
  const size_t base = static_cast<size_t>(b) * R;

  // pass 1: robots that choose their own node claim it
  for (int j = lane; j < R; j += 32) {
    const int c = cur[base + j];
    s_out[j] = chosen[base + j] == c ? c : -1;
  }
  __syncwarp();

  // pass 2: the unset robots in index order
  for (int w0 = 0; w0 < R; w0 += 32) {
    const int j = w0 + lane;
    const bool real = j < R;
    const int my_cur = real ? cur[base + j] : 0;
    const int my_chosen = real ? chosen[base + j] : 0;
    unsigned unset = __ballot_sync(kFull, real && s_out[j] == -1);
    while (unset) {
      const int k = __ffs(unset) - 1;
      unset &= unset - 1;
      const int want = __shfl_sync(kFull, my_chosen, k);
      bool hit = false;
      for (int t = lane; t < R; t += 32) hit |= s_out[t] == want;
      const bool taken = __any_sync(kFull, hit);
      if (lane == k) s_out[j] = taken ? my_cur : my_chosen;
      __syncwarp();
    }
  }

  for (int j = lane; j < R; j += 32) out[base + j] = s_out[j];
}

}  // namespace

// Launches K7 on `stream` and returns cudaGetLastError() (0 on success).
// cur, chosen and out are contiguous [b, r] int32 device buffers;
// 1 <= r <= 1024 (ops/conflicts.py:MAX_ROBOTS; 16 KB of shared memory a
// block).
extern "C" int gft_resolve_conflicts(const void* cur, const void* chosen, void* out, int b,
                                     int r, void* stream) {
  if (b == 0 || r == 0) return 0;
  const int blocks = (b + kWarps - 1) / kWarps;
  const size_t smem = static_cast<size_t>(kWarps) * r * sizeof(int);
  resolve_conflicts_kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cur), static_cast<const int*>(chosen), static_cast<int*>(out), b,
      r);
  return static_cast<int>(cudaGetLastError());
}
