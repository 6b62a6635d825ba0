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
// times in PERF.md): bytes. extract_cloud reads the int16 tsdf and uint16
// weight once (2 x 33.5 MB at 256^3) and writes (max_points, 3) float32
// points and a bool flag each (12.6 + 1 MB at 1 << 20): ~0.024 ms. The
// sampling reads ~21 k candidate flags and rows: latency.
// Design. extract_cloud: a tile is 16 x 256 consecutive crossing tests of
// the concatenated order; pass 1 counts a tile's crossings; pass 2 (one
// block) takes the exclusive scan of the tile counts and the uncapped
// total; pass 3 tests its tile again and writes each crossing at the
// tile's offset plus its rank in the tile (warp ballots, then a scan of
// the 16 x 8 warp counts in the same (iteration, warp, lane) order as the
// linear index), rows below max_points only; a last pass writes the flags
// and NaN-fills the rows past the count. No CUB: the scans are written
// here. The arithmetic is the plain version's (-fmad=false, a true
// division for alpha), so the points are bit-equal to it. The sampling is
// one block: a block scan over per-thread chunks of the permuted validity.
#include <cstdint>

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
struct Vol {
  const int16_t* tsdf;
  const uint16_t* weight;
  int d;
  int per_axis;  // (d - 1) d d
  int total;     // 3 per_axis
  float scale;   // the tsdf decode factor, 1 / 32767 as float32
  float min_weight;
};

// the crossing test q of the concatenated order: voxel a and its + axis
// neighbour b, (i, j, k) of a
struct Edge {
  int axis, i, j, k, a, b;
};

__device__ __forceinline__ Edge edge_at(const Vol& v, int q) {
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

__device__ __forceinline__ bool crosses(const Vol& v, int q, Edge* e, float* t0) {
  if (q >= v.total) return false;
  *e = edge_at(v, q);
  const float ta = static_cast<float>(v.tsdf[e->a]) * v.scale;
  const float tb = static_cast<float>(v.tsdf[e->b]) * v.scale;
  *t0 = ta;
  return dfk::decode_weight(v.weight[e->a]) >= v.min_weight && dfk::decode_weight(v.weight[e->b]) >= v.min_weight &&
         ta * tb < 0.0f;
}

__global__ void __launch_bounds__(kThreads) count_kernel(Vol v, int* __restrict__ tile_count) {
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

__global__ void __launch_bounds__(kThreads)
write_kernel(Vol v, const int* __restrict__ tile_off, int max_points, float vs, float ox, float oy, float oz,
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
    const float t1 = static_cast<float>(v.tsdf[e.b]) * v.scale;
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

extern "C" int df_extract_cloud(const void* tsdf, const void* weight, int d, float scale, float min_weight,
                                int max_points, float vs, float ox, float oy, float oz, void* tile_count,
                                void* tile_off, int ntiles, void* points, void* valid, void* count, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long per_axis = static_cast<long long>(d - 1) * d * d;
  if (d < 2 || 3 * per_axis >= (1LL << 31) || ntiles != static_cast<int>((3 * per_axis + kTile - 1) / kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Vol v{static_cast<const int16_t*>(tsdf), static_cast<const uint16_t*>(weight), d,
              static_cast<int>(per_axis), static_cast<int>(3 * per_axis), scale, min_weight};
  count_kernel<<<ntiles, kThreads, 0, st>>>(v, static_cast<int*>(tile_count));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, kScan, 0, st>>>(static_cast<const int*>(tile_count), ntiles, static_cast<int*>(tile_off),
                                   static_cast<int*>(count));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  write_kernel<<<ntiles, kThreads, 0, st>>>(v, static_cast<const int*>(tile_off), max_points, vs, ox, oy, oz,
                                            static_cast<float*>(points));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_points > 0) {
    fill_kernel<<<(max_points + 255) / 256, 256, 0, st>>>(static_cast<const int*>(count), max_points,
                                                          static_cast<float*>(points), static_cast<bool*>(valid));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int df_sample_nodes(const void* points, const void* valid, int step, const void* perm, int mc, int n,
                               void* pos, void* active, void* count, void* stream) {
  sample_nodes_kernel<<<1, kScan, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const bool*>(valid), step, static_cast<const int64_t*>(perm), mc,
      n, static_cast<float*>(pos), static_cast<bool*>(active), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}
