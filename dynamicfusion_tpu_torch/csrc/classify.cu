// Kernel K: brick classification and the fusion's work list.
//
// Replaces dynamicfusion_tpu/ops/bricks.py:103 build_depth_pyramid (the
// min / max / all-valid mip of the dists image), :143 query_rect, :213
// classify (skip / front / band / wide from the camera-frame corner grid)
// and the work list of integrate_bricks :617-649 (every front brick, then
// band bricks up to the cap with the surface bricks first in x-major
// order and the rest in the fixed permutation's order, then wide bricks up
// to theirs; the counts (band, wide, dropped)). On the TPU these are
// reduce_window passes, gathers and cumsum compactions that XLA fuses; the
// port's plain version is ~150 small PyTorch kernels.
//
// Bound on the H100: latency. The mip reads the 640x480 dists once (1.2 MB)
// and writes 1.6 MB; classification reads 27 corner points for each of
// 4 096 bricks (33^3 x 12 B = 0.4 MB) and 16 mip cells; the work list is a
// scan over 4 096 entries. A few microseconds of work on any part of the
// card, so the design cuts the chain of dependent steps and spreads the
// bricks over many SMs.
// Design: two launches. (1) one block of 16x16 threads per 32x32 tile of
// the image, a 2x2 quad of pixels a thread, builds mip levels 0-5 of its
// tile (level 1 in registers, 2-5 in shared memory; cells outside a
// level's extent carry the neutral +inf / -inf / 0, as the plain
// version's padding). (2) one thread-block cluster of kPlanCluster CTAs
// (the non-portable size 16, as kernel G's PCG), launched as a
// programmatic dependent launch: it starts while the tiles run, reads the
// first bricks' corner grids, and waits for the tiles
// (griddepcontrol.wait) before it touches the mip. Each CTA owns a
// contiguous x-major range of bricks; it builds mip levels 6.. from
// level 5 in its own shared memory (CTA 0 writes them out) and classifies
// its bricks, a brick by a group of up to 4 lanes (the corner points and
// the mip cells split over the lanes, the pools reduced with shuffles;
// the corner loop unrolled for the grids the repo runs, w = 1 and 2),
// keeping each brick's class and surface flag in shared memory. After a
// cluster barrier each CTA counts its four lists (front, surface band,
// the permuted rest of the band, wide; the permuted list reads the codes
// of other CTAs' bricks through distributed shared memory), writes its
// counts into every CTA's shared memory, and after another barrier scans
// them exclusively in CTA order; inside a CTA the ranks come from warp
// ballots and a shuffle scan of the warps' totals, a round of blockDim.x
// bricks at a time, so the list keeps x-major (and permuted) order. The
// count stays on the device. The design before (one block of 1024 threads
// for everything after the tiles, Hillis-Steele block scans) stays as the
// reference mode (``one_block``), held bit for bit against this one.
// The float arithmetic repeats the plain version's operation for
// operation (-fmad=false, true divisions, the level from log(x) / log(2)
// as jnp.log2 computes it); every pool and window is a min or a max,
// exact, so classes, windows and the work list equal the plain version's
// bit for bit.
// The gate: with the device flag ``ok`` false both launches return at
// once, and the plan writes only count = 0 and counts = (0, 0, 0), as
// the JAX package skips the whole integrate (pipeline/kinfu.py:646).
//
// Slab mode (the sharded fusion's classification, dynamicfusion_tpu/
// parallel/sharded_fusion.py:133-154): the grid is one shard's x-slab of
// corner points, (nbx w + 1, G, G) with its +1 overlap plane, and the
// bricks are the slab's nbx x nb x nb local ones (local id ((bi nb) + bj)
// nb + bk, as the whole volume's); the phase split tests the GLOBAL brick
// x-plane bx0 + bi. The caps are the caller's: the sharded fusion lists
// every front and band brick (1 024 local bricks at 256^3 over 4 shards)
// and the wide ones up to its cap, in local-id order.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;
constexpr int kQuad = kTile / 2;  // a tile's threads a side, a 2x2 quad of pixels each
constexpr int kTileLevels = 5;    // a 32x32 tile holds mip levels 0..5
constexpr int kBlock = 1024;    // the one-block reference mode's block
constexpr int kNcells = 4;      // query_rect's ncells
constexpr int SKIP = 0, FRONT = 1, BAND = 2, WIDE = 3;
// the cluster: CTAs, most and fewest threads a CTA, most lanes a brick's
// classification (the most of 1, 2 and 4 with a CTA's bricks x lanes
// within kPlanMinThreads: the slab mode's 64 bricks a CTA take 4, the
// preset's 256 one; a CTA has its bricks x lanes threads, rounded up to a
// warp, within those bounds); scripts/torch_plan_fuse_variants.py times
// the alternatives
constexpr int kPlanCluster = 16;
constexpr int kPlanThreads = 1024;
constexpr int kPlanMinThreads = 256;
constexpr int kMaxBrickLanes = 4;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

struct Mip {
  float* dmin;
  float* dmax;
  float* av;
  int rows, cols, levels;
};

// extent and start offset of mip level l (ceil halving, as the padded pools)
__device__ void level_dims(const Mip& m, int l, int* h, int* w, int* off) {
  int hh = m.rows, ww = m.cols, o = 0;
  for (int k = 0; k < l; ++k) {
    o += hh * ww;
    hh = (hh + 1) / 2;
    ww = (ww + 1) / 2;
  }
  *h = hh;
  *w = ww;
  *off = o;
}

// mip levels 6.. from level 5, by the nt threads t of one block (their
// loads through L2: level 5 was written by other blocks)
__device__ void build_top_levels(const Mip& m, int t, int nt) {
  for (int l = kTileLevels + 1; l < m.levels; ++l) {
    int ph, pw, poff, h, w, off;
    level_dims(m, l - 1, &ph, &pw, &poff);
    level_dims(m, l, &h, &w, &off);
    for (int c = t; c < h * w; c += nt) {
      const int y = c / w, x = c % w;
      float lo = inf_f(), hi = -inf_f(), av = 1.0f;
      for (int dy = 0; dy < 2; ++dy) {
        for (int dx = 0; dx < 2; ++dx) {
          const int yy = 2 * y + dy, xx = 2 * x + dx;
          const bool pin = yy < ph && xx < pw;
          const int p = poff + yy * pw + xx;
          lo = fminf(lo, pin ? __ldcg(m.dmin + p) : inf_f());
          hi = fmaxf(hi, pin ? __ldcg(m.dmax + p) : -inf_f());
          av = fminf(av, pin ? __ldcg(m.av + p) : 0.0f);
        }
      }
      m.dmin[off + c] = lo;
      m.dmax[off + c] = hi;
      m.av[off + c] = av;
    }
    __syncthreads();
  }
}

// one 32x32 tile of the image a block of 16x16 threads, a 2x2 quad of
// pixels a thread: levels 0 and 1 in registers, 2..5 in shared memory
__global__ void __launch_bounds__(kQuad* kQuad)
mip_tiles_kernel(const float* __restrict__ dists, Mip m, const bool* __restrict__ ok) {
  // the cluster kernel (a programmatic dependent launch) may start now: it
  // waits for this grid before it reads the mip
  asm volatile("griddepcontrol.launch_dependents;");
  if (ok != nullptr && !*ok) return;
  __shared__ float smin[kQuad][kQuad + 1], smax[kQuad][kQuad + 1], sav[kQuad][kQuad + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  float lo = inf_f(), hi = -inf_f(), av = 1.0f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int x = blockIdx.x * kTile + 2 * tx + dx, y = blockIdx.y * kTile + 2 * ty + dy;
      const bool in = x < m.cols && y < m.rows;
      const float d = in ? dists[y * m.cols + x] : 0.0f;
      const bool valid = d > 0.0f;
      const float l0 = valid ? d : inf_f(), h0 = valid ? d : -inf_f(), a0 = valid ? 1.0f : 0.0f;
      if (in) {
        m.dmin[y * m.cols + x] = l0;
        m.dmax[y * m.cols + x] = h0;
        m.av[y * m.cols + x] = a0;
      }
      lo = fminf(lo, l0);
      hi = fmaxf(hi, h0);
      av = fminf(av, a0);
    }
  }
  const int top = min(kTileLevels, m.levels - 1);
  for (int l = 1; l <= top; ++l) {
    const int s = kTile >> l;
    const bool act = tx < s && ty < s;
    if (l > 1) {
      __syncthreads();
      if (act) {
        const int cy = 2 * ty, cx = 2 * tx;
        lo = fminf(fminf(smin[cy][cx], smin[cy][cx + 1]), fminf(smin[cy + 1][cx], smin[cy + 1][cx + 1]));
        hi = fmaxf(fmaxf(smax[cy][cx], smax[cy][cx + 1]), fmaxf(smax[cy + 1][cx], smax[cy + 1][cx + 1]));
        av = fminf(fminf(sav[cy][cx], sav[cy][cx + 1]), fminf(sav[cy + 1][cx], sav[cy + 1][cx + 1]));
      }
      __syncthreads();
    }
    if (act) {
      smin[ty][tx] = lo;
      smax[ty][tx] = hi;
      sav[ty][tx] = av;
      int h, w, off;
      level_dims(m, l, &h, &w, &off);
      const int gy = blockIdx.y * s + ty, gx = blockIdx.x * s + tx;
      if (gy < h && gx < w) {
        m.dmin[off + gy * w + gx] = lo;
        m.dmax[off + gy * w + gx] = hi;
        m.av[off + gy * w + gx] = av;
      }
    }
  }
}

struct Geo {
  const float* cam;  // (nbx w + 1, G, G, 3) camera-frame grid points at voxel stride g
  int g_pts, w, nb;  // G, grid points per brick per axis, bricks along y and z
  int nbx, bx0;      // bricks along x, the global x-plane of the first
  float fx, fy, cx, cy;
  int rows, cols, rect;
  float trunc, zeps, two;  // two: 2.0f, a run-time value so log(2) is the library's
};

// mip levels kTileLevels.. in shared memory: (3, cells) from mip offset off
struct Top {
  const float* cells;  // nullptr: read every level from device memory
  int n, off;
};

// query_rect: conservative (dmin, dmax, allvalid) over [u0,u1]x[v0,v1];
// the cells sub, sub + L, ... of a group of L neighbouring lanes, reduced
// with shuffles (every pool is a min or a max: exact in any order)
template <int L>
__device__ void query_rect(const Mip& m, int total, const Geo& k, const Top& top, int sub, float u0, float u1,
                           float v0, float v1, float* dmin, float* dmax, float* av) {
  const float ext = fmaxf(u1 - u0, v1 - v0);
  const float xq = fmaxf(ext, 1.0f) / static_cast<float>(kNcells - 1);
  const float lf = fminf(fmaxf(ceilf(logf(xq) / logf(k.two)), 0.0f), static_cast<float>(m.levels - 1));
  const int l = static_cast<int>(lf);
  int h, w, off;
  level_dims(m, l, &h, &w, &off);
  const float cell = ldexpf(1.0f, l);
  const int i0 = static_cast<int>(floorf(u0 / cell)), j0 = static_cast<int>(floorf(v0 / cell));
  const int i1 = static_cast<int>(floorf(u1 / cell)), j1 = static_cast<int>(floorf(v1 / cell));
  float lo = inf_f(), hi = -inf_f(), a = 1.0f;
  // a level above the tiles' from shared memory (flat >= off >= top.off)
  const bool shared = top.cells != nullptr && l > kTileLevels;
  const float* src0 = shared ? top.cells : m.dmin;
  const float* src1 = shared ? top.cells + top.n : m.dmax;
  const float* src2 = shared ? top.cells + 2 * top.n : m.av;
  const int base = shared ? top.off : 0;
  static_assert(kNcells * kNcells % L == 0, "whole cells a lane");
#pragma unroll
  for (int r = 0; r < kNcells * kNcells / L; ++r) {
    const int cidx = r * L + sub, dj = cidx / kNcells, di = cidx % kNcells;
    if (i0 + di > i1 || j0 + dj > j1) continue;
    const int flat = min(max(off + (j0 + dj) * w + (i0 + di), 0), total - 1);
    lo = fminf(lo, src0[flat - base]);
    hi = fmaxf(hi, src1[flat - base]);
    a = fminf(a, src2[flat - base]);
  }
#pragma unroll
  for (int o = 1; o < L; o <<= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    a = fminf(a, __shfl_xor_sync(0xffffffffu, a, o));
  }
  *dmin = lo;
  *dmax = hi;
  *av = a;
}

// a brick's footprint: the image-space and depth extents of its corner grid
struct Extent {
  float umin, umax, vmin, vmax, zmin, zmax, rmax, rmin;
};

// the extent of brick b from its (w + 1)^3 corner points, the points sub,
// sub + L, ... (x-major) by each of a group of L neighbouring lanes, reduced with
// shuffles (every pool is a min or a max: exact in any order); W > 0 the
// grid points per brick per axis at compile time (k.w == W), 0 read from
// k.w. Every lane of the warp calls it.
template <int W, int L>
__device__ __forceinline__ Extent brick_extent(const Geo& k, int b, int sub) {
  const int w = W > 0 ? W : k.w;
  const int n1 = w + 1;
  const int bi = b / (k.nb * k.nb), bj = (b / k.nb) % k.nb, bk = b % k.nb;
  float umin = inf_f(), umax = -inf_f(), vmin = inf_f(), vmax = -inf_f();
  float zmin = inf_f(), zmax = -inf_f(), rmax = -inf_f();
  float xmin = inf_f(), xmax = -inf_f(), ymin = inf_f(), ymax = -inf_f();
  auto point = [&](int a, int c, int e) {
    const int gi = bi * w + a, gj = bj * w + c, gk = bk * w + e;
    const float* p = k.cam + 3 * ((static_cast<size_t>(gi) * k.g_pts + gj) * k.g_pts + gk);
    const float x = __ldg(p), y = __ldg(p + 1), z = __ldg(p + 2);
    const bool zok = z > k.zeps;
    const float zs = zok ? z : 1.0f;
    const float u = x * k.fx / zs + k.cx;
    const float v = y * k.fy / zs + k.cy;
    umin = fminf(umin, zok ? u : inf_f());
    umax = fmaxf(umax, zok ? u : -inf_f());
    vmin = fminf(vmin, zok ? v : inf_f());
    vmax = fmaxf(vmax, zok ? v : -inf_f());
    zmin = fminf(zmin, z);
    zmax = fmaxf(zmax, z);
    rmax = fmaxf(rmax, sqrtf(x * x + y * y + z * z));
    xmin = fminf(xmin, x);
    xmax = fmaxf(xmax, x);
    ymin = fminf(ymin, y);
    ymax = fmaxf(ymax, y);
  };
  if (W > 0) {
    // a lane's points sub, sub + L, ...: whole rounds of L, unrolled
    constexpr int kN = W + 1, kRounds = (kN * kN * kN + L - 1) / L;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int q = r * L + sub;
      if (q < kN * kN * kN) point(q / (kN * kN), (q / kN) % kN, q % kN);
    }
  } else {
    for (int a = 0; a <= w; ++a)
      for (int c = 0; c <= w; ++c)
        for (int e = 0; e <= w; ++e)
          if (L == 1 || ((a * n1 + c) * n1 + e) % L == sub) point(a, c, e);
  }
#pragma unroll
  for (int o = 1; o < L; o <<= 1) {
    umin = fminf(umin, __shfl_xor_sync(0xffffffffu, umin, o));
    umax = fmaxf(umax, __shfl_xor_sync(0xffffffffu, umax, o));
    vmin = fminf(vmin, __shfl_xor_sync(0xffffffffu, vmin, o));
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
    zmin = fminf(zmin, __shfl_xor_sync(0xffffffffu, zmin, o));
    zmax = fmaxf(zmax, __shfl_xor_sync(0xffffffffu, zmax, o));
    rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
    xmin = fminf(xmin, __shfl_xor_sync(0xffffffffu, xmin, o));
    xmax = fmaxf(xmax, __shfl_xor_sync(0xffffffffu, xmax, o));
    ymin = fminf(ymin, __shfl_xor_sync(0xffffffffu, ymin, o));
    ymax = fmaxf(ymax, __shfl_xor_sync(0xffffffffu, ymax, o));
  }
  // lower bound on |p|: distance from the camera to the AABB of the grid points
  const float ex = fmaxf(fmaxf(xmin, -xmax), 0.0f);
  const float ey = fmaxf(fmaxf(ymin, -ymax), 0.0f);
  const float ez = fmaxf(fmaxf(zmin, -zmax), 0.0f);
  return Extent{umin, umax, vmin, vmax, zmin, zmax, rmax, sqrtf(ex * ex + ey * ey + ez * ez)};
}

// brick b's class, window origin and surface flag from its extent (the mip
// query by the same group of L lanes; every lane of the warp calls it)
template <int L>
__device__ __forceinline__ void classify_extent(const Mip& m, int total, const Geo& k, const Top& top, int ph_sel,
                                                int split, int b, int sub, const Extent& x, int* cls, int* u0,
                                                int* v0, bool* surf) {
  const bool zfront = x.zmin > k.zeps;
  const float colsm1 = static_cast<float>(k.cols) - 1.0f, rowsm1 = static_cast<float>(k.rows) - 1.0f;
  float dminv, dmaxv, allvalid;
  query_rect<L>(m, total, k, top, sub, fminf(fmaxf(x.umin, 0.0f), colsm1), fminf(fmaxf(x.umax, 0.0f), colsm1),
                fminf(fmaxf(x.vmin, 0.0f), rowsm1), fminf(fmaxf(x.vmax, 0.0f), rowsm1), &dminv, &dmaxv, &allvalid);
  const bool visible = x.zmax > k.zeps && x.umax >= 0.0f && x.umin <= colsm1 && x.vmax >= 0.0f && x.vmin <= rowsm1;
  const bool no_band = dmaxv < x.rmin - k.trunc;
  const bool inside = x.umin >= 0.0f && x.umax <= colsm1 && x.vmin >= 0.0f && x.vmax <= rowsm1;
  const bool is_front = inside && allvalid > 0.5f && dminv > x.rmax + k.trunc && zfront;
  const float side = static_cast<float>(k.rect - 2);
  const bool narrow = (x.umax - x.umin) <= side && (x.vmax - x.vmin) <= side && zfront;
  int c = (!visible || (zfront && no_band)) ? SKIP : (is_front ? FRONT : (narrow ? BAND : WIDE));
  const int bi = b / (k.nb * k.nb);
  if (split > 1 && (k.bx0 + bi) % split != ph_sel) c = SKIP;
  *cls = c;
  *u0 = dfk::floor_clamp(x.umin, max(k.cols - k.rect, 0));
  *v0 = dfk::floor_clamp(x.vmin, max(k.rows - k.rect, 0));
  *surf = (dmaxv + k.trunc >= x.rmin) && (dminv - k.trunc <= x.rmax);
}

__device__ int mip_total(const Mip& m) {
  int h_last, w_last, total;
  level_dims(m, m.levels - 1, &h_last, &w_last, &total);
  return total + h_last * w_last;
}

// the plan's inputs and outputs past the mip and the grid
struct Plan {
  const int* phase;
  int split;
  const int64_t* perm;
  int band_cap, wide_cap;
  int64_t* cls;
  int* u0;
  int* v0;
  bool* surf;
  int* ids;
  int* kind;
  int* count;
  int* counts;
};

// the gate: count 0 and counts (0, 0, 0), nothing else written
__device__ __forceinline__ void write_gated(const Plan& p) {
  p.count[0] = 0;
  p.counts[0] = 0;
  p.counts[1] = 0;
  p.counts[2] = 0;
}

// mip levels kTileLevels.. into this block's shared memory: level
// kTileLevels loaded from device memory (through L2: the tiles' grid wrote
// it), the rest built there; where ``out`` also written to device memory
// (levels kTileLevels + 1..)
__device__ void shared_top_levels(const Mip& m, float* cells, int n, bool out) {
  int h5, w5, off5;
  level_dims(m, kTileLevels, &h5, &w5, &off5);
  for (int c = threadIdx.x; c < h5 * w5; c += blockDim.x) {
    cells[c] = __ldcg(m.dmin + off5 + c);
    cells[n + c] = __ldcg(m.dmax + off5 + c);
    cells[2 * n + c] = __ldcg(m.av + off5 + c);
  }
  for (int l = kTileLevels + 1; l < m.levels; ++l) {
    __syncthreads();
    int ph, pw, poff, h, w, off;
    level_dims(m, l - 1, &ph, &pw, &poff);
    level_dims(m, l, &h, &w, &off);
    for (int c = threadIdx.x; c < h * w; c += blockDim.x) {
      const int y = c / w, x = c % w;
      float lo = inf_f(), hi = -inf_f(), av = 1.0f;
      for (int dy = 0; dy < 2; ++dy) {
        for (int dx = 0; dx < 2; ++dx) {
          const int yy = 2 * y + dy, xx = 2 * x + dx;
          const bool pin = yy < ph && xx < pw;
          const int q = poff - off5 + yy * pw + xx;
          lo = fminf(lo, pin ? cells[q] : inf_f());
          hi = fmaxf(hi, pin ? cells[n + q] : -inf_f());
          av = fminf(av, pin ? cells[2 * n + q] : 0.0f);
        }
      }
      cells[off - off5 + c] = lo;
      cells[n + off - off5 + c] = hi;
      cells[2 * n + off - off5 + c] = av;
      if (out) {
        m.dmin[off + c] = lo;
        m.dmax[off + c] = hi;
        m.av[off + c] = av;
      }
    }
  }
  __syncthreads();
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

// the reference mode: one block of 1024 threads builds mip levels 6..,
// classifies every brick and lists the work with per-thread chunks and
// block scans (the design before the cluster)
__global__ void __launch_bounds__(kBlock)
classify_plan_kernel(Mip m, Geo k, const bool* __restrict__ ok, Plan p) {
  if (ok != nullptr && !*ok) {
    if (threadIdx.x == 0) write_gated(p);
    return;
  }
  __shared__ int sm[kBlock];
  __shared__ int tot[4];
  // 1. mip levels 6.. from level 5 (the tiles' last level)
  build_top_levels(m, threadIdx.x, blockDim.x);
  const int total = mip_total(m);
  // 2. classify
  const int nbr = k.nbx * k.nb * k.nb;
  const int ph_sel = p.phase != nullptr ? *p.phase : 0;
  for (int b = threadIdx.x; b < nbr; b += blockDim.x) {
    int c, u0, v0;
    bool sf;
    classify_extent<1>(m, total, k, Top{nullptr, 0, 0}, ph_sel, p.split, b, 0, brick_extent<0, 1>(k, b, 0), &c,
                       &u0, &v0, &sf);
    p.cls[b] = c;
    p.u0[b] = u0;
    p.v0[b] = v0;
    p.surf[b] = sf;
  }
  __syncthreads();
  // 3. the work list: each thread a contiguous chunk of the x-major (and of
  // the permuted) order; block scans give each chunk's first rank
  const int per = (nbr + blockDim.x - 1) / blockDim.x;
  const int lo = min(nbr, static_cast<int>(threadIdx.x) * per), hi = min(nbr, lo + per);
  int n_f = 0, n_h = 0, n_l = 0, n_w = 0;
  for (int i = lo; i < hi; ++i) {
    const int64_t c = p.cls[i];
    n_f += c == FRONT;
    n_h += c == BAND && p.surf[i];
    n_w += c == WIDE;
    const int64_t j = p.perm[i];
    n_l += p.cls[j] == BAND && !p.surf[j];
  }
  int r_f = block_scan(n_f, sm) - n_f;
  if (threadIdx.x == blockDim.x - 1) tot[0] = r_f + n_f;
  int r_h = block_scan(n_h, sm) - n_h;
  if (threadIdx.x == blockDim.x - 1) tot[1] = r_h + n_h;
  int r_l = block_scan(n_l, sm) - n_l;
  if (threadIdx.x == blockDim.x - 1) tot[2] = r_l + n_l;
  int r_w = block_scan(n_w, sm) - n_w;
  if (threadIdx.x == blockDim.x - 1) tot[3] = r_w + n_w;
  for (int i = threadIdx.x; i < nbr; i += blockDim.x) {
    p.ids[i] = nbr;
    p.kind[i] = 0;
  }
  __syncthreads();
  const int n_front = tot[0], n_band = tot[1] + tot[2], n_wide = tot[3];
  const int n_hi = min(tot[1], p.band_cap);
  const int n_band_sel = min(n_band, p.band_cap);
  for (int i = lo; i < hi; ++i) {
    const int64_t c = p.cls[i];
    if (c == FRONT) {
      p.ids[r_f] = i;
      p.kind[r_f] = FRONT;
      ++r_f;
    } else if (c == BAND && p.surf[i]) {
      if (r_h < p.band_cap) {
        p.ids[n_front + r_h] = i;
        p.kind[n_front + r_h] = BAND;
      }
      ++r_h;
    } else if (c == WIDE) {
      if (r_w < p.wide_cap) {
        p.ids[n_front + n_band_sel + r_w] = i;
        p.kind[n_front + n_band_sel + r_w] = WIDE;
      }
      ++r_w;
    }
    const int j = static_cast<int>(p.perm[i]);
    if (p.cls[j] == BAND && !p.surf[j]) {
      const int slot = n_hi + r_l;
      if (slot < p.band_cap) {
        p.ids[n_front + slot] = j;
        p.kind[n_front + slot] = BAND;
      }
      ++r_l;
    }
  }
  if (threadIdx.x == 0) {
    p.count[0] = n_front + n_band_sel + min(n_wide, p.wide_cap);
    p.counts[0] = n_band;
    p.counts[1] = n_wide;
    p.counts[2] = max(n_band - p.band_cap, 0) + max(n_wide - p.wide_cap, 0);
  }
}

// a brick's code in its CTA's shared memory: class | surface flag << 2
__device__ __forceinline__ bool is_front(unsigned c) { return (c & 3u) == FRONT; }
__device__ __forceinline__ bool is_hi(unsigned c) { return c == (BAND | 4u); }
__device__ __forceinline__ bool is_lo(unsigned c) { return c == BAND; }
__device__ __forceinline__ bool is_wide(unsigned c) { return (c & 3u) == WIDE; }

// the code of brick j, kept by the CTA that owns it (``per`` bricks a CTA)
__device__ __forceinline__ unsigned code_of(cg::cluster_group& cl, unsigned char* codes, int j, int per) {
  const int r = j / per;
  return *cl.map_shared_rank(codes + (j - r * per), r);
}

// the cluster kernel: CTA r owns bricks [r per, min(nbr, (r + 1) per));
// shared memory: the codes of its bricks (per bytes, rounded up to 16),
// then mip levels kTileLevels.. (3 x top_n floats)
template <int W, int L>
__global__ void __launch_bounds__(kPlanThreads, 1)
classify_plan_cluster_kernel(Mip m, Geo k, const bool* __restrict__ ok, Plan p, int per, int top_n) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  if (ok != nullptr && !*ok) {
    if (rank == 0 && threadIdx.x == 0) write_gated(p);
    return;
  }
  extern __shared__ unsigned char codes[];   // this CTA's bricks' codes
  __shared__ int slots[kPlanCluster][4];      // every CTA's four counts, in CTA order
  __shared__ int wtot[4][kPlanThreads / 32];  // a round's warp totals, then their exclusive scan
  __shared__ int base[4], rtot[4];            // the CTA's running ranks, a round's totals
  const int nbr = k.nbx * k.nb * k.nb;
  const int b0 = min(nbr, rank * per), b1 = min(nbr, b0 + per);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = (blockDim.x + 31) >> 5;
  // 1. classify, a brick a group of L lanes at a time; the first
  // round's corner extents before the wait for the mip tiles (this is a
  // programmatic dependent launch) and mip levels 6.. in every CTA's
  // shared memory (CTA 0 writes them out)
  const int groups = static_cast<int>(blockDim.x) / L, grp = tid / L, sub = tid % L;
  const int total = mip_total(m);
  const int ph_sel = p.phase != nullptr ? *p.phase : 0;
  Top top{nullptr, 0, 0};
  for (int r0 = b0; r0 < b1; r0 += groups) {
    const int b = r0 + grp;
    const bool in = b < b1;
    const Extent x = brick_extent<W, L>(k, in ? b : b0, sub);
    if (r0 == b0) {
      asm volatile("griddepcontrol.wait;" ::: "memory");
      if (m.levels > kTileLevels + 1) {
        int h5, w5;
        level_dims(m, kTileLevels, &h5, &w5, &top.off);
        float* cells = reinterpret_cast<float*>(codes + (per + 15) / 16 * 16);
        shared_top_levels(m, cells, top_n, rank == 0);
        top.cells = cells;
        top.n = top_n;
      }
    }
    int c, u0, v0;
    bool sf;
    classify_extent<L>(m, total, k, top, ph_sel, p.split, in ? b : b0, sub, x, &c, &u0, &v0, &sf);
    if (in && sub == 0) {
      p.cls[b] = c;
      p.u0[b] = u0;
      p.v0[b] = v0;
      p.surf[b] = sf;
      codes[b - b0] = static_cast<unsigned char>(c | (sf ? 4 : 0));
    }
  }
  cl.sync();  // every CTA's codes, for the permuted band list
  // 2. this CTA's four counts, into every CTA's slots
  int n[4] = {0, 0, 0, 0};
  for (int b = b0 + tid; b < b1; b += blockDim.x) {
    const unsigned c = codes[b - b0];
    n[0] += is_front(c);
    n[1] += is_hi(c);
    n[2] += is_lo(code_of(cl, codes, static_cast<int>(p.perm[b]), per));
    n[3] += is_wide(c);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    n[q] = __reduce_add_sync(0xffffffffu, n[q]);
    if (lane == 0) wtot[q][warp] = n[q];
  }
  __syncthreads();
  if (tid < 4) {
    int s = 0;
    for (int w = 0; w < nwarps; ++w) s += wtot[tid][w];
    for (int r = 0; r < kPlanCluster; ++r) cl.map_shared_rank(&slots[0][0], r)[rank * 4 + tid] = s;
  }
  cl.sync();
  // 3. exclusive scan in CTA order, the totals
  int tot[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int before = 0, all = 0;
    for (int r = 0; r < kPlanCluster; ++r) {
      const int v = slots[r][q];
      before += r < rank ? v : 0;
      all += v;
    }
    tot[q] = all;
    if (tid == q) base[q] = before;
  }
  const int n_front = tot[0], n_band = tot[1] + tot[2], n_wide = tot[3];
  const int n_hi = min(tot[1], p.band_cap);
  const int n_band_sel = min(n_band, p.band_cap);
  const int n_list = n_front + n_band_sel + min(n_wide, p.wide_cap);
  if (rank == 0 && tid == 0) {
    p.count[0] = n_list;
    p.counts[0] = n_band;
    p.counts[1] = n_wide;
    p.counts[2] = max(n_band - p.band_cap, 0) + max(n_wide - p.wide_cap, 0);
  }
  // the padding past the list, over this CTA's range of slots
  for (int i = max(b0, n_list) + tid; i < b1; i += blockDim.x) {
    p.ids[i] = nbr;
    p.kind[i] = 0;
  }
  __syncthreads();
  // 4. the lists, a round of blockDim.x bricks at a time: a brick's rank is
  // the CTA's running rank, its warp's offset and its rank in the warp
  const unsigned lt = (1u << lane) - 1u;
  for (int r0 = b0; r0 < b1; r0 += blockDim.x) {
    const int b = r0 + tid;
    const bool in = b < b1;
    const unsigned c = in ? codes[b - b0] : 0u;
    const int j = in ? static_cast<int>(p.perm[b]) : 0;
    const bool f[4] = {in && is_front(c), in && is_hi(c), in && is_lo(code_of(cl, codes, j, per)),
                       in && is_wide(c)};
    unsigned mask[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mask[q] = __ballot_sync(0xffffffffu, f[q]);
      if (lane == 0) wtot[q][warp] = __popc(mask[q]);
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int v = lane < nwarps ? wtot[q][lane] : 0;
        int incl = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += u;
        }
        if (lane < nwarps) wtot[q][lane] = incl - v;
        if (lane == 31) rtot[q] = incl;
      }
    }
    __syncthreads();
    int rk[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) rk[q] = base[q] + wtot[q][warp] + __popc(mask[q] & lt);
    if (f[0]) {
      p.ids[rk[0]] = b;
      p.kind[rk[0]] = FRONT;
    }
    if (f[1] && rk[1] < p.band_cap) {
      p.ids[n_front + rk[1]] = b;
      p.kind[n_front + rk[1]] = BAND;
    }
    if (f[2] && n_hi + rk[2] < p.band_cap) {
      p.ids[n_front + n_hi + rk[2]] = j;
      p.kind[n_front + n_hi + rk[2]] = BAND;
    }
    if (f[3] && rk[3] < p.wide_cap) {
      p.ids[n_front + n_band_sel + rk[3]] = b;
      p.kind[n_front + n_band_sel + rk[3]] = WIDE;
    }
    __syncthreads();
    if (tid < 4) base[tid] += rtot[tid];
    __syncthreads();
  }
  cl.sync();  // no CTA leaves while another reads its codes
}

// the cluster attributes (non-portable size, dynamic shared memory) of a
// kernel on the current device, set once a (kernel, device)
cudaError_t cluster_setup(const void* fn) {
  constexpr int kDone = 64;
  static const void* done_fn[kDone];
  static int done_dev[kDone];
  static int count = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < count; ++i)
    if (done_fn[i] == fn && done_dev[i] == dev) return cudaSuccess;
  if (kPlanCluster > 8) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  if (count < kDone) {
    done_fn[count] = fn;
    done_dev[count] = dev;
    ++count;
  }
  return cudaSuccess;
}

template <int W, int L>
cudaError_t launch_cluster(const Mip& m, const Geo& k, const bool* ok, const Plan& p, cudaStream_t st) {
  const int nbr = k.nbx * k.nb * k.nb;
  const int per = (nbr + kPlanCluster - 1) / kPlanCluster;
  const int want = per * L;
  const int threads = min(kPlanThreads, max(kPlanMinThreads, (want + 31) / 32 * 32));
  auto fn = classify_plan_cluster_kernel<W, L>;
  cudaError_t err = cluster_setup(reinterpret_cast<const void*>(fn));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  cfg.gridDim = dim3(kPlanCluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  // mip levels kTileLevels..
  int top_n = 0;
  if (m.levels > kTileLevels + 1) {
    int hh = m.rows, ww = m.cols;
    for (int l = 0; l < m.levels; ++l) {
      if (l >= kTileLevels) top_n += hh * ww;
      hh = (hh + 1) / 2;
      ww = (ww + 1) / 2;
    }
  }
  cfg.dynamicSmemBytes = (per + 15) / 16 * 16 + sizeof(float) * 3 * top_n;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kPlanCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // a programmatic dependent launch: the cluster starts before the mip
  // tiles end and waits for them (griddepcontrol.wait) before it reads them
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  if (cfg.dynamicSmemBytes > 48 * 1024) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cfg.dynamicSmemBytes));
    if (err != cudaSuccess) return err;
  }
  return cudaLaunchKernelEx(&cfg, fn, m, k, ok, p, per, top_n);
}

template <int W>
cudaError_t launch_plan(bool one_block, const Mip& m, const Geo& k, const bool* ok, const Plan& p, cudaStream_t st) {
  if (one_block) {
    classify_plan_kernel<<<1, kBlock, 0, st>>>(m, k, ok, p);
    return cudaGetLastError();
  }
  const int per = (k.nbx * k.nb * k.nb + kPlanCluster - 1) / kPlanCluster;
  if (kMaxBrickLanes >= 4 && per * 4 <= kPlanMinThreads) return launch_cluster<W, 4>(m, k, ok, p, st);
  if (kMaxBrickLanes >= 2 && per * 2 <= kPlanMinThreads) return launch_cluster<W, 2>(m, k, ok, p, st);
  return launch_cluster<W, 1>(m, k, ok, p, st);
}

}  // namespace

// ok: the device flag of the gate (nullptr: always); one_block: the
// reference mode; *launched: the device kernels this call launched
extern "C" int df_brick_plan(const void* dists, int rows, int cols, int levels, void* dmin, void* dmax, void* av,
                             const void* cam, int g_pts, int w, int nb, int nbx, int bx0, float fx, float fy,
                             float cx, float cy,
                             int rect, float trunc, float zeps, const void* phase, int split, const void* perm,
                             int band_cap, int wide_cap, void* cls, void* u0, void* v0, void* surf, void* ids,
                             void* kind, void* count, void* counts, const void* ok, int one_block, int* launched,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  Mip m{static_cast<float*>(dmin), static_cast<float*>(dmax), static_cast<float*>(av), rows, cols, levels};
  const bool* okp = static_cast<const bool*>(ok);
  const dim3 tile(kQuad, kQuad);
  const dim3 grid((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
  mip_tiles_kernel<<<grid, tile, 0, st>>>(static_cast<const float*>(dists), m, okp);
  ++*launched;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Geo k{static_cast<const float*>(cam), g_pts, w, nb, nbx, bx0, fx, fy, cx, cy, rows, cols, rect, trunc, zeps, 2.0f};
  Plan p{static_cast<const int*>(phase), split, static_cast<const int64_t*>(perm), band_cap, wide_cap,
         static_cast<int64_t*>(cls), static_cast<int*>(u0), static_cast<int*>(v0), static_cast<bool*>(surf),
         static_cast<int*>(ids), static_cast<int*>(kind), static_cast<int*>(count), static_cast<int*>(counts)};
  if (w == 1)
    err = launch_plan<1>(one_block != 0, m, k, okp, p, st);
  else if (w == 2)
    err = launch_plan<2>(one_block != 0, m, k, okp, p, st);
  else
    err = launch_plan<0>(one_block != 0, m, k, okp, p, st);
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}
