// A variant of K2 (csrc/adj_matmul.cu) for tools/probe_adj_kernels.py, which
// measures where H should live; it is not part of the library.
//
// The tiles stage only the columns' float4 positions (K1's staging, 4 KB a
// warp); the body reads a hit's H row through the read-only cache instead of
// from shared memory.  Everything else is K2's: the test pass, the self
// pair, the degree, the split across warps and the f64 sums.  Takes F = 6.
#include "flocking_pairs.cuh"

namespace {

using gft::kTile;
using gft::kWarp;

constexpr int kF = 6;

struct CachedAdj : gft::AdjSums<kF> {
  static constexpr int kTileFloat4s = kTile;
  static constexpr int kWarpFloat4s = 2 * kTileFloat4s;

  template <class Seq>
  __device__ __forceinline__ void stage(float4* dst, const Seq& seq, int cur, const gft::AdjArgs&,
                                        int lane) const {
    gft::stage_tile(dst, seq.src(cur), seq.cols(cur), lane);
  }

  template <class Seq>
  __device__ __forceinline__ void tile(const float4 me, const float4* t, const Seq& seq, int cur,
                                       const gft::AdjArgs& a) {
    const int nt = seq.cols(cur);
    unsigned long long lo = 0ull, hi = 0ull;
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
      if (c * 16 < nt) {
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int j = c * 16 + u;
          const float2 q = *reinterpret_cast<const float2*>(t + j);
          const float dx = q.x - me.x;
          const float dy = q.y - me.y;
          const float r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          if (r2 < a.cr2) {
            if (j < 64) {
              lo |= 1ull << j;
            } else {
              hi |= 1ull << (j - 64);
            }
          }
        }
      }
    }
    gft::clear_bit(lo, hi, seq.self(cur));
    deg += __popcll(lo) + __popcll(hi);
    const float* rows = a.h + static_cast<size_t>(seq.col0(cur)) * a.f + a.f0;
    while (lo | hi) {
      const float* r = rows + static_cast<size_t>(gft::pop_hit(lo, hi)) * a.f;
#pragma unroll
      for (int c = 0; c < kF; ++c) s[c] += static_cast<double>(__ldg(r + c));
    }
  }
};

__global__ void __launch_bounds__(gft::kMaxThreads, 4)
adj_cached_kernel(const float4* __restrict__ xr, const float4* __restrict__ xc,
                  const float* __restrict__ h, float* __restrict__ out, float* __restrict__ deg,
                  int m, int k, int row_offset, int col_offset, float cr2, int groups) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int group = warp % groups;
  const int row_warps = blockDim.x / (kWarp * groups);
  const int row0 = (blockIdx.x * row_warps + warp / groups) * kWarp;
  const int b = blockIdx.y;
  const int i = row0 + lane;
  const bool active = i < m;

  CachedAdj acc;
  if (row0 < m) {
    const float4 me = active ? xr[static_cast<size_t>(b) * m + i] : make_float4(0.f, 0.f, 0.f, 0.f);
    const long long self_first = static_cast<long long>(row_offset) + row0 - col_offset;
    const gft::ColumnTiles seq{xc + static_cast<size_t>(b) * k, k, group, groups,
                               self_first + lane, self_first, min(kWarp, m - row0)};
    const gft::AdjArgs args{h + static_cast<size_t>(b) * k * kF, kF, 0, cr2, false};
    gft::run_tiles(acc, me, active, smem + warp * CachedAdj::kWarpFloat4s, lane, seq, args);
  }
  const size_t row = static_cast<size_t>(b) * m + i;
  gft::combine_and_store(acc, smem, warp, group, groups, lane, active,
                         gft::AdjOut{out + row * kF, deg + row});
}

}  // namespace

// K2's contract (csrc/adj_matmul.cu) for f == 6; returns cudaGetLastError(),
// or cudaErrorInvalidValue for another width.
extern "C" int probe_adj_cached(const void* xr, const void* xc, const void* h, void* out,
                                void* deg, int b, int m, int k, int f, int row_offset,
                                int col_offset, float cr2, void* stream) {
  if (f != kF) return static_cast<int>(cudaErrorInvalidValue);
  const gft::Plan p = gft::plan_split(b, (m + kWarp - 1) / kWarp, (k + kTile - 1) / kTile);
  const int row_warps = (m + kWarp - 1) / kWarp;
  const dim3 grid((row_warps + p.row_warps - 1) / p.row_warps, b);
  adj_cached_kernel<<<grid, p.warps() * kWarp, p.smem_bytes(CachedAdj::kWarpFloat4s),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(xr), static_cast<const float4*>(xc),
      static_cast<const float*>(h), static_cast<float*>(out), static_cast<float*>(deg), m, k,
      row_offset, col_offset, cr2, p.groups);
  return static_cast<int>(cudaGetLastError());
}
