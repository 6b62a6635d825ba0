// Kernel L: frame 0's surface extraction and node sampling.
//
// Replaces dynamicfusion_tpu/ops/tsdf.py:669 extract_cloud (the +x/+y/+z
// zero crossings of the volume, concatenated axis-major, each axis in
// raster order of its (d-1, d, d) / (d, d-1, d) / (d, d, d-1) array, and
// jnp.nonzero(size=max_points) over the 3 (d-1) d^2 flags) and
// dynamicfusion_tpu/models/warpfield.py:105 init_from_cloud (every
// step-th row of the capped cloud, permuted by the fixed fair permutation,
// the first max_nodes valid candidates). On the TPU both are cumsum
// compactions; the port's plain version scans ~50 M int64 entries.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700.00 W: 3.35 TB/s; measured
// times in PERF.md): bytes. extract_cloud reads the tsdf and weight once
// (2 x 33.5 MB at 256^3 as i16 + u16 codes, 2 x 67 MB as f32) and writes
// (max_points, 3) float32
// points and a bool flag each (12.6 + 1 MB at 1 << 20): ~0.024 ms. The
// sampling reads ~21 k candidate flags and rows: latency.
//
// Design of extract_cloud: a warp owns a k-row (i, j) of d voxels, a lane
// d / 32 consecutive voxels (d = 32 V, V a power of two up to 16: the
// volume's side a compile-time constant, so a row's (i, j) is a shift and
// a mask and no test decodes an index). Row (i, j) holds the +x tests of
// axis 0's row (i, j) (i < d - 1), the +y tests of axis 1's (j < d - 1)
// and axis 2's row (i, j), so a block owning kRowsPerBlock consecutive
// rows writes one contiguous run in each axis. Two launches.
// row_count_kernel reads the volume once: a warp takes kRounds
// consecutive rows of one plane, the lane reads its run of row (i, j), of
// row (i + 1, j) for the +x tests and of row (i, j + 1) for the +y tests
// (the next row's own run) in vector loads of up to 16 bytes, and the +z
// test at its last voxel takes the neighbour from the next lane by a
// shuffle. It keeps each row's crossing bits (3 bits a voxel: 6.3 MB at
// 256^3) and counts each block's crossings of each axis; the last block
// to finish (a ticket in device memory, back at zero after it) scans the
// three count arrays with warp shuffles and a scan of warp totals into
// each block's three offsets (axis a's past the totals of the axes
// before it) and writes the uncapped count. row_write_kernel, a
// programmatic dependent launch whose blocks start during pass 1's last
// blocks and wait for it, reads the bits, not the volume: in each of its
// rounds the block's warps take consecutive rows, and a crossing's row
// is its block offset, the rows of the rounds before, the warps before
// (shared memory), the lanes before (shuffles) and the bits before in
// its lane: (row, lane, voxel) order, the raster order. It reads t0 and
// t1 at each crossing below max_points and writes its point, then the
// flags and the NaN rows past the count. The i16/u16 pair tests two
// voxels a 32-bit word on their codes (PairLanes), the other pairs decode
// to float32 (FloatLanes); both are the plain version's test exactly, and
// the points' arithmetic is the plain version's (-fmad=false, a true
// division for alpha), so they are bit-equal to it. Instantiated for each
// (tsdf, weight) storage pair (common.cuh) and d = 32, 64, 128, 256 and
// 512. The alternatives (the second pass re-reading the rows instead of
// the bits, other rows a block, the scan in a launch of its own, the
// defaults written by pass 1, the i16/u16 pair through the per-voxel float
// tests, other load paths) are timed in
// scripts/torch_extract_bilateral_variants.py (PERF.md).
//
// The design before, kept as the reference mode (reference = 1) and for
// any other d: a tile is 16 x 256 consecutive crossing tests of the
// concatenated order, each decoded from its linear index by divisions;
// count_kernel counts a tile's crossings; scan_kernel (one block) takes
// the exclusive scan of the tile counts and the uncapped total;
// write_kernel tests its tile again and writes each crossing at the
// tile's offset plus its rank in the tile (warp ballots, then a scan of
// the 16 x 8 warp counts in the same (iteration, warp, lane) order as the
// linear index), rows below max_points only; fill_kernel writes the flags
// and NaN-fills the rows past the count.
//
// The sampling is one block: a block scan over per-thread chunks of the
// permuted validity.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kIters = 16;
constexpr int kTile = kThreads * kIters;
constexpr int kWarps = kThreads / 32;
constexpr int kScan = 1024;
static_assert(kIters * kWarps == 4 * 32, "write_kernel scans the warp counts four to a lane");

// 32-bit indices throughout: the wrapper refuses volumes with 3 (d-1) d^2
// >= 2^31 crossing tests
template <typename T, typename W>
struct Vol {
  const T* tsdf;
  const W* weight;
  int d;
  int per_axis;  // (d - 1) d d
  int total;     // 3 per_axis
  float scale;   // the tsdf decode factor: 1 / 32767 as float32 for the i16 codes, 1 for the float storages
  float min_weight;
};

// the crossing test q of the concatenated order: voxel a and its + axis
// neighbour b, (i, j, k) of a
struct Edge {
  int axis, i, j, k, a, b;
};

template <typename T, typename W>
__device__ __forceinline__ Edge edge_at(const Vol<T, W>& v, int q) {
  const int axis = q / v.per_axis;
  const int rem = q - axis * v.per_axis;
  const int d = v.d;
  // the axis's own extent is d - 1, the other two d
  const int nk = axis == 2 ? d - 1 : d;
  const int nj = axis == 1 ? d - 1 : d;
  const int rj = rem / nk;
  Edge e;
  e.axis = axis;
  e.k = rem - rj * nk;
  e.i = rj / nj;
  e.j = rj - e.i * nj;
  e.a = (e.i * d + e.j) * d + e.k;
  e.b = e.a + (axis == 0 ? d * d : (axis == 1 ? d : 1));
  return e;
}

template <typename T, typename W>
__device__ __forceinline__ bool crosses(const Vol<T, W>& v, int q, Edge* e, float* t0) {
  if (q >= v.total) return false;
  *e = edge_at(v, q);
  const float ta = dfk::code_value(v.tsdf[e->a]) * v.scale;
  const float tb = dfk::code_value(v.tsdf[e->b]) * v.scale;
  *t0 = ta;
  return dfk::decode_weight(v.weight[e->a]) >= v.min_weight && dfk::decode_weight(v.weight[e->b]) >= v.min_weight &&
         ta * tb < 0.0f;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads) count_kernel(Vol<T, W> v, int* __restrict__ tile_count) {
  __shared__ int sm[kWarps];
  const int base = blockIdx.x * kTile;
  int c = 0;
  for (int it = 0; it < kIters; ++it) {
    Edge e;
    float t0;
    c += crosses(v, base + it * kThreads + static_cast<int>(threadIdx.x), &e, &t0);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) sm[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += sm[w];
    tile_count[blockIdx.x] = s;
  }
}

// inclusive scan of one int per thread over the block (Hillis-Steele)
__device__ int block_scan(int v, int* sm) {
  sm[threadIdx.x] = v;
  __syncthreads();
  for (int o = 1; o < blockDim.x; o <<= 1) {
    const int add = threadIdx.x >= o ? sm[threadIdx.x - o] : 0;
    __syncthreads();
    sm[threadIdx.x] += add;
    __syncthreads();
  }
  const int out = sm[threadIdx.x];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kScan)
scan_kernel(const int* __restrict__ tile_count, int ntiles, int* __restrict__ tile_off, int* __restrict__ count) {
  __shared__ int sm[kScan];
  const int per = (ntiles + kScan - 1) / kScan;
  const int lo = min(ntiles, static_cast<int>(threadIdx.x) * per), hi = min(ntiles, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += tile_count[i];
  const int incl = block_scan(s, sm);
  int run = incl - s;
  for (int i = lo; i < hi; ++i) {
    tile_off[i] = run;
    run += tile_count[i];
  }
  if (threadIdx.x == kScan - 1) count[0] = incl;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
write_kernel(Vol<T, W> v, const int* __restrict__ tile_off, int max_points, float vs, float ox, float oy, float oz,
             float* __restrict__ points) {
  __shared__ int wcount[kIters * kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kTile;
  unsigned mask[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    Edge e;
    float t0;
    mask[it] = __ballot_sync(0xffffffffu, crosses(v, base + it * kThreads + static_cast<int>(threadIdx.x), &e, &t0));
    if (lane == 0) wcount[it * kWarps + warp] = __popc(mask[it]);
  }
  __syncthreads();
  // exclusive scan of the (iteration, warp) counts in place: warp 0, four
  // consecutive entries a lane (static_assert above)
  if (warp == 0) {
    int c[4], s = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      c[q] = wcount[4 * lane + q];
      s += c[q];
    }
    int incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int add = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += add;
    }
    int run = incl - s;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      wcount[4 * lane + q] = run;
      run += c[q];
    }
  }
  __syncthreads();
  const int off = tile_off[blockIdx.x];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    if (!((mask[it] >> lane) & 1u)) continue;
    const int rank = off + wcount[it * kWarps + warp] + __popc(mask[it] & below);
    if (rank >= max_points) continue;
    Edge e;
    float t0;
    crosses(v, base + it * kThreads + static_cast<int>(threadIdx.x), &e, &t0);
    const float t1 = dfk::code_value(v.tsdf[e.b]) * v.scale;
    const float den = t0 - t1;
    const float alpha = t0 / (fabsf(den) > 1e-12f ? den : 1e-12f);
    // idx + e_axis alpha, then * voxel + origin (the off-axis terms add 0)
    const float fi = static_cast<float>(e.i) + (e.axis == 0 ? alpha : 0.0f);
    const float fj = static_cast<float>(e.j) + (e.axis == 1 ? alpha : 0.0f);
    const float fk = static_cast<float>(e.k) + (e.axis == 2 ? alpha : 0.0f);
    float* p = points + 3 * static_cast<size_t>(rank);
    p[0] = fi * vs + ox;
    p[1] = fj * vs + oy;
    p[2] = fk * vs + oz;
  }
}

__global__ void fill_kernel(const int* __restrict__ count, int max_points, float* __restrict__ points,
                            bool* __restrict__ valid) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= max_points) return;
  const int n = min(count[0], max_points);
  valid[r] = r < n;
  if (r >= n) {
    const float nan = __int_as_float(0x7fc00000);
    points[3 * static_cast<size_t>(r)] = nan;
    points[3 * static_cast<size_t>(r) + 1] = nan;
    points[3 * static_cast<size_t>(r) + 2] = nan;
  }
}

// ---------------------------------------------------------------- the row listing

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowsPerBlock = 64;  // (i, j) rows a block
constexpr int kRounds = kRowsPerBlock / kRowWarps;  // rows a warp
static_assert(kRowsPerBlock % 32 == 0 && 32 % kRounds == 0,
              "whole rounds and offset scans; a warp's rows in one (i) plane of any d = 32 V");
constexpr unsigned kFull = 0xffffffffu;

// a lane's run of V codes of one row, moved in accesses of up to 16 bytes
template <typename T, int V>
struct alignas(V * sizeof(T) < 16 ? V * sizeof(T) : 16) Run {
  T v[V];
};

// a lane's V crossing bits of one row and axis
template <int V>
using Bits = typename std::conditional<(V <= 8), uint8_t, uint16_t>::type;

template <typename T, typename W>
struct RowVol {
  const T* tsdf;
  const W* weight;
  float scale;  // the tsdf decode factor (as Vol's)
  float min_weight;
  int weight_code_min;  // u16 weights: the least code whose weight (code / 512) is >= min_weight; 65536: none
};

__device__ __forceinline__ bool weight_ok(uint16_t c, float, int code_min) { return c >= code_min; }
__device__ __forceinline__ bool weight_ok(float w, float mw, int) { return w >= mw; }

// The tests of any storage pair: a lane's run as decoded tsdf values and
// the bits of its voxels that weigh enough; voxel q crosses voxel q' of
// the other run where both weigh enough and t t' < 0 in float32, the
// plain version's test.
template <typename T, typename W, int V>
struct FloatLanes {
  struct State {
    float t[V];
    unsigned w;
  };
  static __device__ __forceinline__ State load(const RowVol<T, W>& v, int at) {
    const Run<T, V> rt = *reinterpret_cast<const Run<T, V>*>(v.tsdf + at);
    const Run<W, V> rw = *reinterpret_cast<const Run<W, V>*>(v.weight + at);
    State s;
    s.w = 0u;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      s.t[q] = dfk::code_value(rt.v[q]) * v.scale;
      s.w |= static_cast<unsigned>(weight_ok(rw.v[q], v.min_weight, v.weight_code_min)) << q;
    }
    return s;
  }
  static __device__ __forceinline__ unsigned cross(const State& a, const State& b) {
    unsigned m = 0u;
#pragma unroll
    for (int q = 0; q < V; ++q) m |= static_cast<unsigned>(a.t[q] * b.t[q] < 0.0f) << q;
    return m & a.w & b.w;
  }
  // the +z tests: voxel q against q + 1, the last against the next lane's first
  static __device__ __forceinline__ unsigned cross_z(const State& a, int lane) {
    State z;
#pragma unroll
    for (int q = 0; q < V - 1; ++q) z.t[q] = a.t[q + 1];
    z.t[V - 1] = __shfl_down_sync(kFull, a.t[0], 1);
    z.w = (a.w >> 1) | ((__shfl_down_sync(kFull, a.w, 1) & 1u) << (V - 1));
    return cross(a, z) & (lane < 31 ? kFull : ~(1u << (V - 1)));
  }
};

// The tests of the i16/u16 pair, two voxels a 32-bit word (V even): a
// voxel's sign is its code's top bit, and it can cross where its code is
// not 0 and its weight code is at least weight_code_min. Exactly the
// plain version's test: the i16 decode scale is positive and a product
// of two nonzero decoded codes is at least 2^-30 in magnitude, so t t' <
// 0 iff the codes are nonzero with different signs; and code / 512 >=
// min_weight iff code >= weight_code_min.
template <int V>
struct PairLanes {
  static constexpr int kWords = V / 2;
  static constexpr unsigned kTop = 0x80008000u;  // a word's two sign bits
  struct alignas(4 * kWords < 16 ? 4 * kWords : 16) Words {
    unsigned v[kWords];
  };
  struct State {
    unsigned s[kWords];   // the codes (the signs at bits 15 and 31)
    unsigned ok[kWords];  // bits 15 and 31: the voxel can cross
  };
  static __device__ __forceinline__ State load(const RowVol<int16_t, uint16_t>& v, int at) {
    const Words t = *reinterpret_cast<const Words*>(v.tsdf + at);
    const Words w = *reinterpret_cast<const Words*>(v.weight + at);
    const unsigned thr = static_cast<unsigned>(v.weight_code_min) * 0x10001u;
    const bool none = v.weight_code_min > 0xffff;
    State s;
#pragma unroll
    for (int p = 0; p < kWords; ++p) {
      const unsigned c = t.v[p], u = w.v[p];
      // a half is not 0: its low 15 bits carry into bit 15, or bit 15 is set
      const unsigned nonzero = (((c & ~kTop) + ~kTop) | c) & kTop;
      // u >= thr in each half: the low 15 bits' difference never borrows
      // across the halves, then the top bits decide
      const unsigned d = (u | kTop) - (thr & ~kTop);
      const unsigned ge = ((u & ~thr) | (~(u ^ thr) & d)) & kTop;
      s.s[p] = c;
      s.ok[p] = none ? 0u : nonzero & ge;
    }
    return s;
  }
  // bits 15 and 31 of the words into V bits in voxel order
  static __device__ __forceinline__ unsigned compact(const unsigned (&x)[kWords]) {
    unsigned acc = 0u;
#pragma unroll
    for (int p = 0; p < kWords; ++p) acc |= x[p] >> (15 - 2 * p);
    return (acc & 0x5555u) | ((acc >> 15) & 0xaaaau);
  }
  static __device__ __forceinline__ unsigned cross(const State& a, const State& b) {
    unsigned x[kWords];
#pragma unroll
    for (int p = 0; p < kWords; ++p) x[p] = (a.s[p] ^ b.s[p]) & a.ok[p] & b.ok[p];
    return compact(x);
  }
  static __device__ __forceinline__ unsigned cross_z(const State& a, int lane) {
    State z;
    const unsigned sn = __shfl_down_sync(kFull, a.s[0], 1), on = __shfl_down_sync(kFull, a.ok[0], 1);
#pragma unroll
    for (int p = 0; p < kWords; ++p) {
      z.s[p] = __funnelshift_r(a.s[p], p + 1 < kWords ? a.s[p + 1 < kWords ? p + 1 : p] : sn, 16);
      z.ok[p] = __funnelshift_r(a.ok[p], p + 1 < kWords ? a.ok[p + 1 < kWords ? p + 1 : p] : on, 16);
    }
    return cross(a, z) & (lane < 31 ? kFull : ~(1u << (V - 1)));
  }
};

template <typename T, typename W, int V>
struct LanesOf {
  using type = typename std::conditional<std::is_same<T, int16_t>::value && std::is_same<W, uint16_t>::value &&
                                             (V >= 2),
                                         PairLanes<(V >= 2 ? V : 2)>, FloatLanes<T, W, V>>::type;
};

__device__ __forceinline__ int warp_incl_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int add = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += add;
  }
  return x;
}

// the last block: each block's three offsets (axis a's past the totals of
// the axes before it; blocks in order) and the uncapped total. A thread
// sums a contiguous segment of blocks in each axis; a warp's shuffle scan
// of its lanes' sums, a scan of the warp totals in shared memory; then
// the thread walks its segment again writing the offsets.
__device__ void scan_block_counts(const int* __restrict__ counts, int* __restrict__ offsets, int nblocks,
                                  int* __restrict__ count) {
  __shared__ int wsum[3][kRowWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (nblocks + kRowThreads - 1) / kRowThreads;
  const int lo = min(nblocks, static_cast<int>(threadIdx.x) * per), hi = min(nblocks, lo + per);
  int s[3] = {0, 0, 0}, incl[3];
  for (int b = lo; b < hi; ++b) {
#pragma unroll
    for (int a = 0; a < 3; ++a) s[a] += __ldcg(counts + a * nblocks + b);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    incl[a] = warp_incl_scan(s[a], lane);
    if (lane == 31) wsum[a][warp] = incl[a];
  }
  __syncthreads();
  int before[3] = {0, 0, 0}, total[3] = {0, 0, 0};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) {
      before[a] += w < warp ? wsum[a][w] : 0;
      total[a] += wsum[a][w];
    }
  }
  int run[3] = {before[0] + incl[0] - s[0], total[0] + before[1] + incl[1] - s[1],
                total[0] + total[1] + before[2] + incl[2] - s[2]};
  for (int b = lo; b < hi; ++b) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      offsets[a * nblocks + b] = run[a];
      run[a] += __ldcg(counts + a * nblocks + b);
    }
  }
  if (threadIdx.x == 0) count[0] = total[0] + total[1] + total[2];
}

// NaN in the floats of rows [n, max_points) of points: a head and a tail
// alone, 16-byte stores between
__device__ __forceinline__ void nan_rows(float* __restrict__ points, int n, int max_points, int nthreads, int tid) {
  const float nan = __int_as_float(0x7fc00000);
  const int e0 = 3 * n, e1 = 3 * max_points;
  const int a0 = min(e1, (e0 + 3) & ~3), a1 = max(a0, e1 & ~3);
  if (tid < a0 - e0) points[e0 + tid] = nan;
  if (tid < e1 - a1) points[a1 + tid] = nan;
  for (int f = a0 / 4 + tid; f < a1 / 4; f += nthreads) {
    reinterpret_cast<float4*>(points)[f] = make_float4(nan, nan, nan, nan);
  }
}

// four flags from row r on: 1 below n
__device__ __forceinline__ unsigned flag_word(int r, int n) {
  unsigned w = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) w |= static_cast<unsigned>(r + q < n) << (8 * q);
  return w;
}

// the flags, 1 below n, 16 a thread
__device__ __forceinline__ void flag_rows(bool* __restrict__ valid, int n, int max_points, int nthreads, int tid) {
  for (int r0 = 16 * tid; r0 < max_points; r0 += 16 * nthreads) {
    if (r0 + 16 <= max_points) {
      *reinterpret_cast<uint4*>(valid + r0) =
          make_uint4(flag_word(r0, n), flag_word(r0 + 4, n), flag_word(r0 + 8, n), flag_word(r0 + 12, n));
    } else {
      for (int r = r0; r < max_points; ++r) valid[r] = r < n;
    }
  }
}

// pass 1: a warp tests kRounds consecutive rows of one plane (row (i, j +
// 1)'s run, read for the +y tests, is the next row's own), keeps each
// row's crossing bits (masks[(a d^2 + row) 32 + lane]) and counts each
// block's crossings of each axis into counts[a nblocks + b], then lets
// pass 2 launch; the last block to finish scans the counts
template <typename T, typename W, int V>
__global__ void __launch_bounds__(kRowThreads)
row_count_kernel(RowVol<T, W> v, Bits<V>* __restrict__ masks, int* __restrict__ counts, int* __restrict__ offsets,
                 int nblocks, unsigned int* __restrict__ ticket, int* __restrict__ count) {
  using L = typename LanesOf<T, W, V>::type;
  constexpr int D = 32 * V;
  constexpr int kRows = D * D;
  __shared__ int sm[3][kRowWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRowsPerBlock + warp * kRounds;
  const int i = r0 / D, j0 = r0 % D;  // D a power of two: a shift and a mask
  typename L::State own = L::load(v, r0 * D + lane * V);
  int c[3] = {0, 0, 0};
#pragma unroll 4
  for (int k = 0; k < kRounds; ++k) {
    const int r = r0 + k, at = r * D + lane * V;
    unsigned m[3] = {0u, 0u, 0u};
    if (i < D - 1) m[0] = L::cross(own, L::load(v, at + D * D));  // the warp's plane: a uniform branch
    typename L::State next;
    if (j0 + k < D - 1) {
      next = L::load(v, at + D);
      m[1] = L::cross(own, next);
    }
    m[2] = L::cross_z(own, lane);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      masks[(a * kRows + r) * 32 + lane] = static_cast<Bits<V>>(m[a]);
      c[a] += __popc(m[a]);
    }
    own = next;
  }
  asm volatile("griddepcontrol.launch_dependents;");
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c[a] += __shfl_down_sync(kFull, c[a], o);
    if (lane == 0) sm[a][warp] = c[a];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) s += sm[threadIdx.x][w];
    counts[threadIdx.x * nblocks + blockIdx.x] = s;
    __threadfence();  // this block's counts (and masks) before its ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(nblocks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  scan_block_counts(counts, offsets, nblocks, count);
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next launch on this stream
}

// a crossing's point: idx + e_axis alpha, then * voxel + origin (the
// off-axis terms add 0), as write_kernel; t0 and t1 decoded from the two
// voxels' codes
template <typename T>
struct Place {
  const T* tsdf;
  float scale;
  int max_points;
  float vs, ox, oy, oz;
  float* points;
};

template <typename T>
__device__ __forceinline__ void put(const Place<T>& p, int rank, int axis, int i, int j, int k, int a, int b) {
  if (rank >= p.max_points) return;
  const float t0 = dfk::load_code(p.tsdf + a) * p.scale;
  const float t1 = dfk::load_code(p.tsdf + b) * p.scale;
  const float den = t0 - t1;
  const float alpha = t0 / (fabsf(den) > 1e-12f ? den : 1e-12f);
  const float fi = static_cast<float>(i) + (axis == 0 ? alpha : 0.0f);
  const float fj = static_cast<float>(j) + (axis == 1 ? alpha : 0.0f);
  const float fk = static_cast<float>(k) + (axis == 2 ? alpha : 0.0f);
  float* q = p.points + 3 * static_cast<size_t>(rank);
  q[0] = fi * p.vs + p.ox;
  q[1] = fj * p.vs + p.oy;
  q[2] = fk * p.vs + p.oz;
}

// pass 2: in round k the block's warps take its rows k kRowWarps + w. A
// lane's three counts of a row go through one shuffle scan (10-bit
// fields: a warp's row holds at most 32 V <= 512 crossings an axis); the
// (round, warp) totals are scanned once in shared memory, in (round,
// warp) order; so a crossing's rank is the block's offset, the rows of
// the block before its own, the lanes before and its bits before. The
// bits are read again for the writes (L1 hits), and the crossings' t0
// and t1 where they are written. Then the flags (16 a thread) and the
// NaN rows past the count (16-byte stores).
template <typename T, int V>
__global__ void __launch_bounds__(kRowThreads)
row_write_kernel(Place<T> p, const Bits<V>* __restrict__ masks, const int* __restrict__ offsets, int nblocks,
                 const int* __restrict__ count, bool* __restrict__ valid) {
  constexpr int D = 32 * V;
  constexpr int kRows = D * D;
  constexpr int kE = kRowsPerBlock / 32;  // (round, warp) totals a lane of the offset scan
  __shared__ int sm[3][kRowsPerBlock];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const Bits<V>* bits = masks + (row0 + warp) * 32 + lane;  // (axis a, round k) at a kRows 32 + k kRowWarps 32
  asm volatile("griddepcontrol.wait;" ::: "memory");  // pass 1's bits, offsets and count
  int before[kRounds];  // the lanes before, three 10-bit fields
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int c = __popc(bits[k * kRowWarps * 32]) | __popc(bits[(kRows + k * kRowWarps) * 32]) << 10 |
                  __popc(bits[(2 * kRows + k * kRowWarps) * 32]) << 20;
    const int incl = warp_incl_scan(c, lane);
    before[k] = incl - c;
    if (lane == 31) {
#pragma unroll
      for (int a = 0; a < 3; ++a) sm[a][k * kRowWarps + warp] = (incl >> (10 * a)) & 1023;
    }
  }
  __syncthreads();
  if (warp < 3) {  // warp a: axis a's (round, warp) totals, exclusively scanned
    int e[kE], s = 0;
#pragma unroll
    for (int q = 0; q < kE; ++q) {
      e[q] = sm[warp][lane * kE + q];
      s += e[q];
    }
    int run = warp_incl_scan(s, lane) - s;
#pragma unroll
    for (int q = 0; q < kE; ++q) {
      sm[warp][lane * kE + q] = run;
      run += e[q];
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int base = offsets[a * nblocks + blockIdx.x];
    const int step = a == 0 ? D * D : (a == 1 ? D : 1);
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int r = row0 + k * kRowWarps + warp;
      const int i = r / D, j = r % D, k0 = lane * V, at = r * D + k0;
      int rank = base + sm[a][k * kRowWarps + warp] + ((before[k] >> (10 * a)) & 1023);
      for (unsigned m = bits[(a * kRows + k * kRowWarps) * 32]; m; m &= m - 1u) {
        const int q = __ffs(m) - 1;
        put(p, rank++, a, i, j, k0 + q, at + q, at + q + step);
      }
    }
  }
  const int n = min(count[0], p.max_points);
  const int nthreads = nblocks * kRowThreads, tid = blockIdx.x * kRowThreads + threadIdx.x;
  flag_rows(valid, n, p.max_points, nthreads, tid);
  nan_rows(p.points, n, p.max_points, nthreads, tid);
}

// pass 2 as a programmatic dependent launch: its blocks start while pass
// 1's last blocks run and wait for it (griddepcontrol.wait)
template <typename T, int V>
int launch_write(const Place<T>& p, const Bits<V>* bits, const int* offsets, int nblocks, const int* count,
                 bool* valid, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(nblocks, 1, 1);
  cfg.blockDim = dim3(kRowThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, row_write_kernel<T, V>, p, bits, offsets, nblocks, count, valid));
}

template <int V>
struct Lanes {
  static constexpr int value = V;
};

// f(Lanes<d / 32>{}) for the sides the row listing is compiled for
template <typename F>
int dispatch_side(int d, F&& f) {
  switch (d) {
    case 32: return f(Lanes<1>{});
    case 64: return f(Lanes<2>{});
    case 128: return f(Lanes<4>{});
    case 256: return f(Lanes<8>{});
    case 512: return f(Lanes<16>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

__global__ void __launch_bounds__(kScan)
sample_nodes_kernel(const float* __restrict__ points, const bool* __restrict__ valid, int step,
                    const int64_t* __restrict__ perm, int mc, int n, float* __restrict__ pos, bool* __restrict__ active,
                    int* __restrict__ count) {
  __shared__ int sm[kScan];
  __shared__ int total;
  const int per = (mc + kScan - 1) / kScan;
  const int lo = min(mc, static_cast<int>(threadIdx.x) * per), hi = min(mc, lo + per);
  int c = 0;
  for (int r = lo; r < hi; ++r) c += valid[perm[r] * step];
  const int incl = block_scan(c, sm);
  if (threadIdx.x == kScan - 1) total = incl;
  int rank = incl - c;
  for (int r = lo; r < hi && rank < n; ++r) {
    const int64_t row = perm[r] * step;
    if (!valid[row]) continue;
    pos[3 * rank] = points[3 * row];
    pos[3 * rank + 1] = points[3 * row + 1];
    pos[3 * rank + 2] = points[3 * row + 2];
    ++rank;
  }
  __syncthreads();
  const int nsel = min(total, n);
  for (int s = threadIdx.x; s < n; s += kScan) {
    active[s] = s < nsel;
    if (s >= nsel) {
      pos[3 * s] = 0.0f;
      pos[3 * s + 1] = 0.0f;
      pos[3 * s + 2] = 0.0f;
    }
  }
  if (threadIdx.x == 0) count[0] = nsel;
}

}  // namespace

// tsdf and weight stored as the storage code says (common.cuh). The row
// listing (reference 0; d one of dispatch_side's): counts and offsets
// (3 nblocks ints each) with nblocks = d^2 / kRowsPerBlock, masks 3 d^2 32
// crossing words (a byte each for d <= 256, two bytes for 512), ticket
// the device's (1,) zero-between-launches word. The reference mode:
// counts and offsets the tile counts and offsets with nblocks the tile
// count; masks and ticket unused. *ran: the device kernels launched.
extern "C" int df_extract_cloud(const void* tsdf, const void* weight, int storage, int d, float scale, float min_weight,
                                int weight_code_min, int max_points, float vs, float ox, float oy, float oz,
                                void* counts, void* offsets, int nblocks, void* masks, void* ticket, int reference,
                                void* points, void* valid, void* count, int* ran, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long per_axis = static_cast<long long>(d - 1) * d * d;
  *ran = 0;
  if (d < 2 || 3 * per_axis >= (1LL << 31) || max_points < 1 || 3LL * max_points >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!reference) {
    if (ticket == nullptr || masks == nullptr ||
        static_cast<long long>(d) * d != static_cast<long long>(nblocks) * kRowsPerBlock) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return dfk::dispatch_storage(storage, [&](auto tt, auto wt) {
      using T = typename decltype(tt)::type;
      using W = typename decltype(wt)::type;
      return dispatch_side(d, [&](auto lanes) {
        constexpr int V = decltype(lanes)::value;
        const RowVol<T, W> v{static_cast<const T*>(tsdf), static_cast<const W*>(weight), scale, min_weight,
                             weight_code_min};
        Bits<V>* bits = static_cast<Bits<V>*>(masks);
        row_count_kernel<T, W, V><<<nblocks, kRowThreads, 0, st>>>(
            v, bits, static_cast<int*>(counts), static_cast<int*>(offsets), nblocks,
            static_cast<unsigned int*>(ticket), static_cast<int*>(count));
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        ++*ran;
        const Place<T> p{static_cast<const T*>(tsdf), scale, max_points, vs, ox, oy, oz, static_cast<float*>(points)};
        const int rc = launch_write<T, V>(p, bits, static_cast<const int*>(offsets), nblocks,
                                          static_cast<const int*>(count), static_cast<bool*>(valid), st);
        if (rc == 0) ++*ran;
        return rc;
      });
    });
  }
  if (nblocks != static_cast<int>((3 * per_axis + kTile - 1) / kTile)) return static_cast<int>(cudaErrorInvalidValue);
  return dfk::dispatch_storage(storage, [&](auto tt, auto wt) {
    using T = typename decltype(tt)::type;
    using W = typename decltype(wt)::type;
    const Vol<T, W> v{static_cast<const T*>(tsdf), static_cast<const W*>(weight), d,
                      static_cast<int>(per_axis), static_cast<int>(3 * per_axis), scale, min_weight};
    count_kernel<T, W><<<nblocks, kThreads, 0, st>>>(v, static_cast<int*>(counts));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    scan_kernel<<<1, kScan, 0, st>>>(static_cast<const int*>(counts), nblocks, static_cast<int*>(offsets),
                                     static_cast<int*>(count));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    write_kernel<T, W><<<nblocks, kThreads, 0, st>>>(v, static_cast<const int*>(offsets), max_points, vs, ox, oy,
                                                     oz, static_cast<float*>(points));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fill_kernel<<<(max_points + 255) / 256, 256, 0, st>>>(static_cast<const int*>(count), max_points,
                                                          static_cast<float*>(points), static_cast<bool*>(valid));
    err = cudaGetLastError();
    if (err == cudaSuccess) *ran = 4;
    return static_cast<int>(err);
  });
}

extern "C" int df_sample_nodes(const void* points, const void* valid, int step, const void* perm, int mc, int n,
                               void* pos, void* active, void* count, void* stream) {
  sample_nodes_kernel<<<1, kScan, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const bool*>(valid), step, static_cast<const int64_t*>(perm), mc,
      n, static_cast<float*>(pos), static_cast<bool*>(active), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}
