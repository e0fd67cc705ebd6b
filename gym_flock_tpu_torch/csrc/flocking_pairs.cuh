// The pair loop of K1 (block_sums.cu), K2 (adj_matmul.cu), K3
// (sparse_sums.cu) and K4 (sparse_adj.cu), written by hand for Hopper
// (sm_90a).
//
// The four kernels reduce, for each row agent, terms of its pairs over a
// stream of 128-column tiles: K1 and K2 over their column range in order
// (ColumnTiles), K3 and K4 over the column blocks that the row block's table
// row lists (ListedBlocks).  A warp owns 32 row agents (one a lane) and a
// share of the tiles; its accumulators live in registers.  K1 and K3 sum
// the flocking channels (PairSums below) over tiles of float4 rows; K2 and
// K4 sum the rows of H over the neighbours (AdjSums): tiles of float2
// positions with the columns' H rows beside them, the same two passes with
// the test r2 < cr2, and a body of F f64 adds of the hit's H row.  Each
// Sums type says how it stages a tile (stage) and how much shared memory a
// tile takes.  For each staged tile of K1/K3:
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
// with cp.async, so the next tile's load overlaps the current tile's
// passes; warps never wait on each other until the final combine.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>

namespace gft {

constexpr int kWarp = 32;
constexpr int kTile = 128;                  // columns per staged tile
constexpr int kMaxWarps = 8;                // warps per block
constexpr int kMaxThreads = kMaxWarps * kWarp;
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
  // dynamic shared memory of a block whose warps stage `warp_float4s` each
  size_t smem_bytes(int warp_float4s) const {
    return static_cast<size_t>(warps()) * warp_float4s * sizeof(float4);
  }
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

// K1's and K3's radii, as the tile passes take them.
struct Reach {
  float cr;
  float cr2;
  float cut;
};

inline Reach make_reach(float cr, float cr2) { return Reach{cr, cr2, hit_cut(cr, cr2)}; }

// Lets `kKernel` take up to `float4s` of dynamic shared memory a block
// (above the default 48 KB), once per device; returns a cudaError_t, 0 on
// success.
template <auto kKernel>
int allow_smem(int float4s) {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= kDevices || !done[dev])) {
    e = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             float4s * static_cast<int>(sizeof(float4)));
    if (e == cudaSuccess && dev < kDevices) done[dev] = true;
  }
  return static_cast<int>(e);
}

// -------------------------------------------------------------- device

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// 8- and 4-byte copies (K2's and K4's positions and H)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
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

// The tiles of K1 and K2: the column range in order, tiles g, g + groups,
// ... of a row warp's `groups` warps.  A cursor is a tile index.
struct ColumnTiles {
  const float4* xc;  // this swarm's columns
  int k;
  int group;
  int groups;
  long long self_j;      // local column index of the row's own global id
  long long self_first;  // ... of the warp's first row
  int rows;              // the warp's rows (lanes past m have none)

  __device__ int first() const { return group; }
  __device__ int next(int it) const { return it + groups; }
  __device__ bool valid(int it) const { return it < (k + kTile - 1) / kTile; }
  // the swarm's column index of the tile's first column
  __device__ int col0(int it) const { return it * kTile; }
  __device__ const float4* src(int it) const { return xc + static_cast<size_t>(col0(it)); }
  __device__ int cols(int it) const { return min(kTile, k - it * kTile); }
  __device__ int self(int it) const {
    const long long d = self_j - static_cast<long long>(it) * kTile;
    return (d >= 0 && d < kTile) ? static_cast<int>(d) : -1;
  }
  // the warp's own columns are consecutive: does tile it hold one of them?
  __device__ bool any_self(int it) const {
    const long long d = self_first - static_cast<long long>(it) * kTile;
    return d < kTile && d + rows > 0;
  }
};

// The tiles of K3 and K4: the listed slots of one table row, the group-th,
// then every groups-th.  A cursor is a slot index; k_max ends the walk.  Pad
// slots (and any entry outside [0, n_b)) are skipped, uniformly across the
// warp.
struct ListedBlocks {
  const float4* xb;  // this swarm's sorted agents
  const int* slots;  // the row block's table row
  int k_max;
  int n_b;
  int group;
  int groups;
  int row_block;
  int self_lane;  // the row's lane within its block

  // the slot of the (skip + 1)-th listed block after slot s, or k_max
  __device__ int after(int s, int skip) const {
    for (++s; s < k_max; ++s) {
      const int j = __ldg(slots + s);
      if (j >= 0 && j < n_b && skip-- == 0) break;
    }
    return s;
  }
  __device__ int first() const { return after(-1, group); }
  __device__ int next(int s) const { return after(s, groups - 1); }
  __device__ bool valid(int s) const { return s < k_max; }
  __device__ int col0(int s) const { return __ldg(slots + s) * kTile; }
  __device__ const float4* src(int s) const { return xb + static_cast<size_t>(col0(s)); }
  __device__ int cols(int) const { return kTile; }
  __device__ int self(int s) const { return any_self(s) ? self_lane : -1; }
  __device__ bool any_self(int s) const { return __ldg(slots + s) == row_block; }
};

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

// Clears bit t (0..127; none when t < 0) of the hit mask (lo, hi).
__device__ __forceinline__ void clear_bit(unsigned long long& lo, unsigned long long& hi, int t) {
  if (t >= 0) {
    if (t < 64) {
      lo &= ~(1ull << t);
    } else {
      hi &= ~(1ull << (t - 64));
    }
  }
}

// Pops the lowest set bit of the non-empty hit mask (lo, hi): the body
// walks a lane's hits in increasing column order.
__device__ __forceinline__ int pop_hit(unsigned long long& lo, unsigned long long& hi) {
  int j;
  if (lo) {
    j = __ffsll(static_cast<long long>(lo)) - 1;
    lo &= lo - 1;
  } else {
    j = 63 + __ffsll(static_cast<long long>(hi));
    hi &= hi - 1;
  }
  return j;
}

// One row agent's channel sums.  kMasked adds channels 10/11, kMin channel 9.
template <bool kMasked, bool kMin>
struct PairSums {
  static constexpr int kSums = kMasked ? 10 : 8;  // channels 0-7, then 10, 11
  // shared memory of one staged tile (its columns' float4 rows), of a warp
  static constexpr int kTileFloat4s = kTile;
  static constexpr int kWarpFloat4s = 2 * kTileFloat4s;
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

  template <class Seq>
  __device__ __forceinline__ void stage(float4* dst, const Seq& seq, int cur, const Reach&,
                                        int lane) const {
    stage_tile(dst, seq.src(cur), seq.cols(cur), lane);
  }

  // Both passes over the staged tile `t` of the sequence's tile `cur`: its
  // `nt` columns, `self_t` the tile column of the row's own agent or -1, and
  // `any_self` (uniform across the warp) whether some lane has one.
  template <class Seq>
  __device__ __forceinline__ void tile(const float4 me, const float4* t, const Seq& seq, int cur,
                                       const Reach& r) {
    const int nt = seq.cols(cur);
    const int self_t = seq.self(cur);
    unsigned long long lo = 0ull, hi = 0ull;
    if (kMin && seq.any_self(cur)) {
      test<true>(me, t, nt, self_t, r.cut, lo, hi);
    } else {
      test<false>(me, t, nt, self_t, r.cut, lo, hi);
    }
    clear_bit(lo, hi, self_t);  // the self pair adds nothing
    while (lo | hi) add(me, t[pop_hit(lo, hi)], r.cr, r.cr2);
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

// K2's and K4's arguments of a tile pass: the radius and this swarm's H rows
// (f floats a column agent), of which the features [f0, f0 + kF) are summed.
// `whole_rows`: f == kF and the swarm's H is 16-byte aligned, so a full
// tile's H is one run of 16-byte words.
struct AdjArgs {
  const float* h;
  int f;
  int f0;
  float cr2;
  bool whole_rows;
};

// Where a row's aggregation goes: its kF outputs, and its degree (null but
// in the first chunk of features).
struct AdjOut {
  float* o;
  float* d;
};

// One row agent's aggregation for K2 and K4: the sums of kF features of H
// over its neighbours, and its degree.  A staged tile holds its columns'
// positions as float2 and their kF features beside them (column t's at
// t * kF), so the body reads a hit's H row from shared memory.
template <int kF>
struct AdjSums {
  static constexpr int kTileFloat4s = (2 * kTile + kTile * kF + 3) / 4;
  static constexpr int kWarpFloat4s = 2 * kTileFloat4s;
  double s[kF];
  int deg;

  __device__ __forceinline__ AdjSums() : deg(0) {
#pragma unroll
    for (int c = 0; c < kF; ++c) s[c] = 0.0;
  }

  // Copies the tile's positions (columns past nt at +inf) and its nt rows
  // of H into `dst`, one commit group.  A full tile whose H is one run of
  // 16-byte words takes kF of them a lane.
  template <class Seq>
  __device__ __forceinline__ void stage(float4* dst, const Seq& seq, int cur, const AdjArgs& a,
                                        int lane) const {
    float* d = reinterpret_cast<float*>(dst);
    float* hd = d + 2 * kTile;
    const int nt = seq.cols(cur);
    const float4* src = seq.src(cur);
    const float* hs = a.h + static_cast<size_t>(seq.col0(cur)) * a.f + a.f0;
    if (nt == kTile && a.whole_rows) {  // warp-uniform
#pragma unroll
      for (int q = 0; q < kTile / kWarp; ++q) {
        const int t = q * kWarp + lane;
        cp_async8(d + 2 * t, src + t);
      }
#pragma unroll
      for (int q = 0; q < kF; ++q) {
        cp_async16(reinterpret_cast<float4*>(hd) + q * kWarp + lane,
                   reinterpret_cast<const float4*>(hs) + q * kWarp + lane);
      }
    } else {
#pragma unroll
      for (int q = 0; q < kTile / kWarp; ++q) {
        const int t = q * kWarp + lane;
        if (t < nt) {
          cp_async8(d + 2 * t, src + t);
        } else {
          d[2 * t] = d[2 * t + 1] = inf_f();
        }
      }
      for (int e = lane; e < nt * kF; e += kWarp) {
        const int t = e / kF;
        cp_async4(hd + e, hs + static_cast<size_t>(t) * a.f + (e - t * kF));
      }
    }
    cp_async_commit();
  }

  // Both passes over the staged tile `t` of the sequence's tile `cur`.  The
  // test is r2 < cr2 alone (a NaN position is no neighbour), r2 formed from
  // dx = column minus row as the JAX kernel forms it.
  template <class Seq>
  __device__ __forceinline__ void tile(const float4 me, const float4* t, const Seq& seq, int cur,
                                       const AdjArgs& a) {
    const float2* pos = reinterpret_cast<const float2*>(t);
    const float* hb = reinterpret_cast<const float*>(t) + 2 * kTile;
    const int nt = seq.cols(cur);
    unsigned long long lo = 0ull, hi = 0ull;
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
      if (c * 16 < nt) {  // warp-uniform; the columns past nt are at +inf
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int j = c * 16 + u;
          const float2 q = pos[j];
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
    clear_bit(lo, hi, seq.self(cur));  // the self pair is no neighbour
    deg += __popcll(lo) + __popcll(hi);
    while (lo | hi) {
      const float* r = hb + pop_hit(lo, hi) * kF;
#pragma unroll
      for (int c = 0; c < kF; ++c) s[c] += static_cast<double>(r[c]);
    }
  }

  __device__ __forceinline__ void save(float4* region, int lane) const {
    double* d = reinterpret_cast<double*>(region);
#pragma unroll
    for (int c = 0; c < kF; ++c) d[c * kWarp + lane] = s[c];
    reinterpret_cast<int*>(d + kF * kWarp)[lane] = deg;
  }

  __device__ __forceinline__ void merge(const float4* region, int lane) {
    const double* d = reinterpret_cast<const double*>(region);
#pragma unroll
    for (int c = 0; c < kF; ++c) s[c] += d[c * kWarp + lane];
    deg += reinterpret_cast<const int*>(d + kF * kWarp)[lane];
  }

  __device__ __forceinline__ void store(const AdjOut& out) const {
#pragma unroll
    for (int c = 0; c < kF; ++c) out.o[c] = static_cast<float>(s[c]);
    if (out.d != nullptr) *out.d = static_cast<float>(deg);
  }
};

// Runs this warp's tiles through `acc`, double-buffered in `buf`
// (Sums::kWarpFloat4s float4s, two tiles): the copy of the next tile is in
// flight while the current one is tested.  `seq` names the tiles
// (ColumnTiles, ListedBlocks): first(), next(cursor), valid(cursor),
// src(cursor), col0(cursor), cols(cursor), self(cursor), any_self(cursor);
// `args` are the tile pass's (Reach or AdjArgs).  Lanes that are not
// `active` copy but skip the passes.  Warp-uniform.
template <class Sums, class Seq, class Args>
__device__ __forceinline__ void run_tiles(Sums& acc, const float4 me, bool active, float4* buf,
                                          int lane, const Seq& seq, const Args& args) {
  constexpr int kStride = Sums::kTileFloat4s;
  int cur = seq.first();
  if (!seq.valid(cur)) return;
  acc.stage(buf, seq, cur, args, lane);
  for (int n = 0; seq.valid(cur); ++n) {
    const int nxt = seq.next(cur);
    if (seq.valid(nxt)) {
      acc.stage(buf + ((n + 1) & 1) * kStride, seq, nxt, args, lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    if (active) acc.tile(me, buf + (n & 1) * kStride, seq, cur, args);
    __syncwarp();
    cur = nxt;
  }
}

// Adds the partials of the `groups` warps that share this warp's rows, in
// group order, and stores the row from group 0 where it is `active` (a row
// before the end) into `o`.  Every thread of the block calls it.
template <class Sums, class Out>
__device__ __forceinline__ void combine_and_store(Sums& acc, float4* smem, int warp, int group,
                                                  int groups, int lane, bool active,
                                                  const Out& o) {
  if (groups > 1) {
    if (group > 0) acc.save(smem + warp * Sums::kWarpFloat4s, lane);
    __syncthreads();
    if (group == 0) {
      for (int q = 1; q < groups; ++q) acc.merge(smem + (warp + q) * Sums::kWarpFloat4s, lane);
    }
  }
  if (group == 0 && active) acc.store(o);
}

}  // namespace gft
