// The pair loop of K1 (block_sums.cu) and K3 (sparse_sums.cu), written by
// hand for Hopper (sm_90a).
//
// Both kernels reduce, for each row agent, the flocking channel terms over a
// stream of 128-column tiles: K1 over its column range in order, K3 over the
// column blocks that the row block's table row lists.  A warp owns 32 row
// agents (one a lane) and a share of the tiles; its accumulators live in
// registers.  For each staged tile:
// (a) the test pass, over every column: r2 from a broadcast shared load of
//     the column's position, the running min r2 (channel 9), and bit t of a
//     128-bit mask where  r2 < cr2 || !(r2 > cr).  Every other pair adds
//     exact zeros to every sum (adj = 0 and gfac = 0 with finite dx, dvx), so
//     skipping it leaves the f64 sums unchanged bit for bit.  The test keeps
//     NaN pairs, so NaN positions propagate as before.  It is one compare,
//     !(r2 > cut) with cut = max(cr, the float below cr2), formed on the
//     host.  No divide and no f64 here: about 8 instructions a pair.
// (b) the body pass, over the set bits in increasing column order, each lane
//     walking its own hits: the IEEE divide, the f32 terms and the f64 adds,
//     the arithmetic of the TPU kernel.  A warp runs the body as often as its
//     busiest lane has hits in the tile (~5-6 at FlockingLarge's density,
//     against 128 when every pair paid for it).
// Within one warp's share of the columns the sums are bitwise those of the
// loop that visits every pair.
//
// Tensor cores do not apply: the Gram form of r2 (|p_i|^2 + |p_j|^2 -
// 2 p_i.p_j) rounds differently from the plain version, moves pairs across
// the radius and breaks the exact degree, and its contraction depth is 2.
//
// Filling the card.  A row warp's tiles can be split round-robin across
// `groups` warps of one block (a power of two up to 8), chosen on the host
// from the shape: the split doubles while the launch holds fewer than
// kFillWarps warps and every warp keeps at least two tiles.  The groups'
// partial sums meet in shared memory and are added in group order, so the
// result is deterministic; no atomics.  Each warp double-buffers its tiles
// with cp.async (16-byte copies, one column a lane), so the next tile's
// load overlaps the current tile's passes; warps never wait on each other
// until the final combine.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cmath>
#include <limits>

namespace gft {

constexpr int kWarp = 32;
constexpr int kTile = 128;                  // columns per staged tile
constexpr int kMaxWarps = 8;                // warps per block
constexpr int kMaxThreads = kMaxWarps * kWarp;
constexpr int kWarpSmem = 2 * kTile;        // float4s a warp stages: two tiles
constexpr int kOut = 16;                    // output channels per agent
// the split stops once the launch holds this many warps: 32 a SM on 132 SMs
constexpr long long kFillWarps = 132LL * 32;

// ---------------------------------------------------------------- host

// Launch geometry: `groups` warps split each row warp's tiles, `row_warps`
// row warps share a block.
struct Plan {
  int groups;
  int row_warps;
  int warps() const { return groups * row_warps; }
  size_t smem_bytes() const { return static_cast<size_t>(warps()) * kWarpSmem * sizeof(float4); }
};

// `swarms` batches of `row_warps` warps of 32 rows, each over `tiles` tiles.
inline Plan plan_split(int swarms, int row_warps, int tiles) {
  const long long total = static_cast<long long>(swarms) * row_warps;
  int groups = 1;
  while (groups < kMaxWarps && 2 * groups <= tiles && total * groups < kFillWarps) groups *= 2;
  return Plan{groups, std::max(1, std::min(kMaxWarps / groups, row_warps))};
}

// The test threshold: !(r2 > cut)  <=>  r2 < cr2 || !(r2 > cr).
inline float hit_cut(float cr, float cr2) {
  return std::fmax(cr, std::nextafter(cr2, -std::numeric_limits<float>::infinity()));
}

// -------------------------------------------------------------- device

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// +inf in device code (CUDART_INF_F is not visible to the host pass of a
// template).
__device__ __forceinline__ float inf_f() { return CUDART_INF_F; }

// Copies columns [0, nt) of `src` into the shared tile `dst`, one column a
// lane at a time; the rest of the tile gets positions at +inf, which no row
// reaches (r2 = inf).
__device__ __forceinline__ void stage_tile(float4* dst, const float4* src, int nt, int lane) {
#pragma unroll
  for (int q = 0; q < kTile / kWarp; ++q) {
    const int t = q * kWarp + lane;
    if (t < nt) {
      cp_async16(dst + t, src + t);
    } else {
      dst[t] = make_float4(inf_f(), inf_f(), 0.f, 0.f);
    }
  }
  cp_async_commit();
}

// One row agent's channel sums.  kMasked adds channels 10/11, kMin channel 9.
template <bool kMasked, bool kMin>
struct PairSums {
  static constexpr int kSums = kMasked ? 10 : 8;  // channels 0-7, then 10, 11
  double s[kSums];
  int deg;
  float rmin;

  __device__ __forceinline__ PairSums() : deg(0), rmin(inf_f()) {
#pragma unroll
    for (int c = 0; c < kSums; ++c) s[c] = 0.0;
  }

  // One pair's terms, d* = row minus column, formed in f32 as the TPU kernel
  // forms them; the sums accumulate in f64.
  __device__ __forceinline__ void add(const float4 me, const float4 c, float cr, float cr2) {
    const float dx = me.x - c.x;
    const float dy = me.y - c.y;
    const float dvx = me.z - c.z;
    const float dvy = me.w - c.w;
    const float r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float adj = r2 < cr2 ? 1.0f : 0.0f;
    const float inv = 1.0f / r2;
    const float inv2 = inv * inv;
    const float gfac = r2 > cr ? 0.0f : 2.0f * inv * (1.0f - inv);
    const float gx = dx * gfac;
    const float gy = dy * gfac;
    s[0] += dvx * adj;
    s[1] += dx * inv2 * adj;
    s[2] += dx * inv * adj;
    s[3] += dvy * adj;
    s[4] += dy * inv2 * adj;
    s[5] += dy * inv * adj;
    s[6] += gx;
    s[7] += gy;
    deg += r2 < cr2;
    if constexpr (kMasked) {
      s[8] += gx * adj;
      s[9] += gy * adj;
    }
  }

  // The test pass: the running min ("full") and the hit mask of the staged
  // tile `t`.  kSelf: some lane's own agent lies in the tile, so the min
  // must skip column self_t; elsewhere the check is left out.
  template <bool kSelf>
  __device__ __forceinline__ void test(const float4 me, const float4* t, int nt, int self_t,
                                       float cut, unsigned long long& lo,
                                       unsigned long long& hi) {
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
      if (c * 16 < nt) {  // warp-uniform; the columns past nt are at +inf
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int j = c * 16 + u;
          const float2 q = *reinterpret_cast<const float2*>(t + j);
          const float dx = me.x - q.x;
          const float dy = me.y - q.y;
          float r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          if constexpr (kMin) {
            if (kSelf && j == self_t) r2 = inf_f();  // the self pair is not in the min
            rmin = fminf(rmin, r2);
          }
          if (!(r2 > cut)) {
            if (j < 64) {
              lo |= 1ull << j;
            } else {
              hi |= 1ull << (j - 64);
            }
          }
        }
      }
    }
  }

  // Both passes over the staged tile `t` of `nt` columns; `self_t` is the
  // tile column of the row's own agent, or -1, and `any_self` (uniform across
  // the warp) says whether some lane has one.
  __device__ __forceinline__ void tile(const float4 me, const float4* t, int nt, int self_t,
                                       bool any_self, float cr, float cr2, float cut) {
    unsigned long long lo = 0ull, hi = 0ull;
    if (kMin && any_self) {
      test<true>(me, t, nt, self_t, cut, lo, hi);
    } else {
      test<false>(me, t, nt, self_t, cut, lo, hi);
    }
    if (self_t >= 0) {  // the self pair adds nothing
      if (self_t < 64) {
        lo &= ~(1ull << self_t);
      } else {
        hi &= ~(1ull << (self_t - 64));
      }
    }
    while (lo | hi) {
      int j;
      if (lo) {
        j = __ffsll(static_cast<long long>(lo)) - 1;
        lo &= lo - 1;
      } else {
        j = 63 + __ffsll(static_cast<long long>(hi));
        hi &= hi - 1;
      }
      add(me, t[j], cr, cr2);
    }
  }

  // This warp's partial sums into its shared region, lane-major.
  __device__ __forceinline__ void save(float4* region, int lane) const {
    double* d = reinterpret_cast<double*>(region);
#pragma unroll
    for (int c = 0; c < kSums; ++c) d[c * kWarp + lane] = s[c];
    reinterpret_cast<int*>(d + kSums * kWarp)[lane] = deg;
    reinterpret_cast<float*>(d + kSums * kWarp)[kWarp + lane] = rmin;
  }

  __device__ __forceinline__ void merge(const float4* region, int lane) {
    const double* d = reinterpret_cast<const double*>(region);
#pragma unroll
    for (int c = 0; c < kSums; ++c) s[c] += d[c * kWarp + lane];
    deg += reinterpret_cast<const int*>(d + kSums * kWarp)[lane];
    rmin = fminf(rmin, reinterpret_cast<const float*>(d + kSums * kWarp)[kWarp + lane]);
  }

  // The row's 16 output channels; unused ones are zero.
  __device__ __forceinline__ void store(float4* o) const {
    o[0] = make_float4(static_cast<float>(s[0]), static_cast<float>(s[1]),
                       static_cast<float>(s[2]), static_cast<float>(s[3]));
    o[1] = make_float4(static_cast<float>(s[4]), static_cast<float>(s[5]),
                       static_cast<float>(s[6]), static_cast<float>(s[7]));
    if constexpr (kMasked) {
      o[2] = make_float4(static_cast<float>(deg), kMin ? rmin : 0.f,
                         static_cast<float>(s[8]), static_cast<float>(s[9]));
    } else {
      o[2] = make_float4(static_cast<float>(deg), 0.f, 0.f, 0.f);
    }
    o[3] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

// Runs this warp's tiles through `acc`, double-buffered in `buf` (kWarpSmem
// float4s): the copy of the next tile is in flight while the current one is
// tested.  `seq` names the tiles: first(), next(cursor), valid(cursor),
// src(cursor), cols(cursor), self(cursor), any_self(cursor).  Lanes that are not `active`
// copy but skip the passes.  Warp-uniform.
template <class Sums, class Seq>
__device__ __forceinline__ void run_tiles(Sums& acc, const float4 me, bool active, float4* buf,
                                          int lane, const Seq& seq, float cr, float cr2,
                                          float cut) {
  int cur = seq.first();
  if (!seq.valid(cur)) return;
  stage_tile(buf, seq.src(cur), seq.cols(cur), lane);
  for (int n = 0; seq.valid(cur); ++n) {
    const int nxt = seq.next(cur);
    if (seq.valid(nxt)) {
      stage_tile(buf + ((n + 1) & 1) * kTile, seq.src(nxt), seq.cols(nxt), lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    if (active) {
      acc.tile(me, buf + (n & 1) * kTile, seq.cols(cur), seq.self(cur), seq.any_self(cur), cr,
               cr2, cut);
    }
    __syncwarp();
    cur = nxt;
  }
}

// Adds the partials of the `groups` warps that share this warp's rows, in
// group order, and stores the row from group 0 (`o` is null for a row past
// the end).  Every thread of the block calls it.
template <class Sums>
__device__ __forceinline__ void combine_and_store(Sums& acc, float4* smem, int warp, int group,
                                                  int groups, int lane, float4* o) {
  if (groups > 1) {
    if (group > 0) acc.save(smem + warp * kWarpSmem, lane);
    __syncthreads();
    if (group == 0) {
      for (int q = 1; q < groups; ++q) acc.merge(smem + (warp + q) * kWarpSmem, lane);
    }
  }
  if (group == 0 && o != nullptr) acc.store(o);
}

}  // namespace gft
