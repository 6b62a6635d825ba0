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
// card. default_kinfu()'s 512^3 volume has 32^3 = 32 768 bricks: the one
// block classifies 32 a thread and scans 32 entries a thread, ~7x the 16^3
// grid's time (PERF.md).
// Design: two launches. (1) one block per 32x32 tile of the image builds
// mip levels 0-5 of its tile in shared memory (cells outside a level's
// extent carry the neutral +inf / -inf / 0, as the plain version's
// padding). (2) one block of 1024 threads builds the remaining levels from
// level 5, classifies the bricks (a thread a brick at a time), and lists
// the work with per-thread chunks and block scans, so the count stays on
// the device. The float arithmetic repeats the plain version's operation
// for operation (-fmad=false, true divisions, the level from
// log(x) / log(2) as jnp.log2 computes it); every pool and window is a min
// or a max, exact, so classes, windows and the work list equal the plain
// version's bit for bit.
//
// Slab mode (the sharded fusion's classification, dynamicfusion_tpu/
// parallel/sharded_fusion.py:133-154): the grid is one shard's x-slab of
// corner points, (nbx w + 1, G, G) with its +1 overlap plane, and the
// bricks are the slab's nbx x nb x nb local ones (local id ((bi nb) + bj)
// nb + bk, as the whole volume's); the phase split tests the GLOBAL brick
// x-plane bx0 + bi. The caps are the caller's: the sharded fusion lists
// every front and band brick (1 024 local bricks at 256^3 over 4 shards,
// one a thread of the second launch) and the wide ones up to its cap, in
// local-id order.
#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kTileLevels = 5;  // a 32x32 tile holds mip levels 0..5
constexpr int kBlock = 1024;
constexpr int kNcells = 4;      // query_rect's ncells
constexpr int SKIP = 0, FRONT = 1, BAND = 2, WIDE = 3;

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

__global__ void __launch_bounds__(kTile* kTile) mip_tiles_kernel(const float* __restrict__ dists, Mip m) {
  __shared__ float smin[kTile][kTile + 1], smax[kTile][kTile + 1], sav[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * kTile + tx, y = blockIdx.y * kTile + ty;
  const bool in = x < m.cols && y < m.rows;
  const float d = in ? dists[y * m.cols + x] : 0.0f;
  const bool valid = d > 0.0f;
  float lo = valid ? d : inf_f(), hi = valid ? d : -inf_f(), av = valid ? 1.0f : 0.0f;
  if (in) {
    m.dmin[y * m.cols + x] = lo;
    m.dmax[y * m.cols + x] = hi;
    m.av[y * m.cols + x] = av;
  }
  smin[ty][tx] = lo;
  smax[ty][tx] = hi;
  sav[ty][tx] = av;
  const int top = min(kTileLevels, m.levels - 1);
  for (int l = 1; l <= top; ++l) {
    const int s = kTile >> l;
    const bool act = tx < s && ty < s;
    __syncthreads();
    if (act) {
      const int cy = 2 * ty, cx = 2 * tx;
      lo = fminf(fminf(smin[cy][cx], smin[cy][cx + 1]), fminf(smin[cy + 1][cx], smin[cy + 1][cx + 1]));
      hi = fmaxf(fmaxf(smax[cy][cx], smax[cy][cx + 1]), fmaxf(smax[cy + 1][cx], smax[cy + 1][cx + 1]));
      av = fminf(fminf(sav[cy][cx], sav[cy][cx + 1]), fminf(sav[cy + 1][cx], sav[cy + 1][cx + 1]));
    }
    __syncthreads();
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

// query_rect: conservative (dmin, dmax, allvalid) over [u0,u1]x[v0,v1]
__device__ void query_rect(const Mip& m, int total, const Geo& k, float u0, float u1, float v0, float v1,
                           float* dmin, float* dmax, float* av) {
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
  for (int dj = 0; dj < kNcells; ++dj) {
    for (int di = 0; di < kNcells; ++di) {
      if (i0 + di > i1 || j0 + dj > j1) continue;
      const int flat = min(max(off + (j0 + dj) * w + (i0 + di), 0), total - 1);
      lo = fminf(lo, m.dmin[flat]);
      hi = fmaxf(hi, m.dmax[flat]);
      a = fminf(a, m.av[flat]);
    }
  }
  *dmin = lo;
  *dmax = hi;
  *av = a;
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

__global__ void __launch_bounds__(kBlock)
classify_plan_kernel(Mip m, Geo k, const int* phase, int split, const int64_t* __restrict__ perm, int band_cap,
                     int wide_cap, int64_t* cls, int* __restrict__ u0_out, int* __restrict__ v0_out, bool* surf,
                     int* __restrict__ ids, int* __restrict__ kind, int* __restrict__ count,
                     int* __restrict__ counts) {
  __shared__ int sm[kBlock];
  __shared__ int tot[4];
  // 1. mip levels 6.. from level 5 (the tiles' last level)
  for (int l = kTileLevels + 1; l < m.levels; ++l) {
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
          const int p = poff + yy * pw + xx;
          lo = fminf(lo, pin ? m.dmin[p] : inf_f());
          hi = fmaxf(hi, pin ? m.dmax[p] : -inf_f());
          av = fminf(av, pin ? m.av[p] : 0.0f);
        }
      }
      m.dmin[off + c] = lo;
      m.dmax[off + c] = hi;
      m.av[off + c] = av;
    }
    __syncthreads();
  }
  int h_last, w_last, total;
  level_dims(m, m.levels - 1, &h_last, &w_last, &total);
  total += h_last * w_last;
  // 2. classify
  const int nbr = k.nbx * k.nb * k.nb;
  const int ph_sel = phase != nullptr ? *phase : 0;
  for (int b = threadIdx.x; b < nbr; b += blockDim.x) {
    const int bi = b / (k.nb * k.nb), bj = (b / k.nb) % k.nb, bk = b % k.nb;
    float umin = inf_f(), umax = -inf_f(), vmin = inf_f(), vmax = -inf_f();
    float zmin = inf_f(), zmax = -inf_f(), rmax = -inf_f();
    float xmin = inf_f(), xmax = -inf_f(), ymin = inf_f(), ymax = -inf_f();
    for (int a = 0; a <= k.w; ++a) {
      for (int c = 0; c <= k.w; ++c) {
        for (int e = 0; e <= k.w; ++e) {
          const int gi = bi * k.w + a, gj = bj * k.w + c, gk = bk * k.w + e;
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
        }
      }
    }
    // lower bound on |p|: distance from the camera to the AABB of the grid points
    const float ex = fmaxf(fmaxf(xmin, -xmax), 0.0f);
    const float ey = fmaxf(fmaxf(ymin, -ymax), 0.0f);
    const float ez = fmaxf(fmaxf(zmin, -zmax), 0.0f);
    const float rmin = sqrtf(ex * ex + ey * ey + ez * ez);
    const bool zfront = zmin > k.zeps;
    const float colsm1 = static_cast<float>(k.cols) - 1.0f, rowsm1 = static_cast<float>(k.rows) - 1.0f;
    float dminv, dmaxv, allvalid;
    query_rect(m, total, k, fminf(fmaxf(umin, 0.0f), colsm1), fminf(fmaxf(umax, 0.0f), colsm1),
               fminf(fmaxf(vmin, 0.0f), rowsm1), fminf(fmaxf(vmax, 0.0f), rowsm1), &dminv, &dmaxv, &allvalid);
    const bool visible = zmax > k.zeps && umax >= 0.0f && umin <= colsm1 && vmax >= 0.0f && vmin <= rowsm1;
    const bool no_band = dmaxv < rmin - k.trunc;
    const bool inside = umin >= 0.0f && umax <= colsm1 && vmin >= 0.0f && vmax <= rowsm1;
    const bool is_front = inside && allvalid > 0.5f && dminv > rmax + k.trunc && zfront;
    const float side = static_cast<float>(k.rect - 2);
    const bool narrow = (umax - umin) <= side && (vmax - vmin) <= side && zfront;
    int c = (!visible || (zfront && no_band)) ? SKIP : (is_front ? FRONT : (narrow ? BAND : WIDE));
    if (split > 1 && (k.bx0 + bi) % split != ph_sel) c = SKIP;
    cls[b] = c;
    u0_out[b] = dfk::floor_clamp(umin, max(k.cols - k.rect, 0));
    v0_out[b] = dfk::floor_clamp(vmin, max(k.rows - k.rect, 0));
    surf[b] = (dmaxv + k.trunc >= rmin) && (dminv - k.trunc <= rmax);
  }
  __syncthreads();
  // 3. the work list: each thread a contiguous chunk of the x-major (and of
  // the permuted) order; block scans give each chunk's first rank
  const int per = (nbr + blockDim.x - 1) / blockDim.x;
  const int lo = min(nbr, static_cast<int>(threadIdx.x) * per), hi = min(nbr, lo + per);
  int n_f = 0, n_h = 0, n_l = 0, n_w = 0;
  for (int i = lo; i < hi; ++i) {
    const int64_t c = cls[i];
    n_f += c == FRONT;
    n_h += c == BAND && surf[i];
    n_w += c == WIDE;
    const int64_t j = perm[i];
    n_l += cls[j] == BAND && !surf[j];
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
    ids[i] = nbr;
    kind[i] = 0;
  }
  __syncthreads();
  const int n_front = tot[0], n_band = tot[1] + tot[2], n_wide = tot[3];
  const int n_hi = min(tot[1], band_cap);
  const int n_band_sel = min(n_band, band_cap);
  for (int i = lo; i < hi; ++i) {
    const int64_t c = cls[i];
    if (c == FRONT) {
      ids[r_f] = i;
      kind[r_f] = FRONT;
      ++r_f;
    } else if (c == BAND && surf[i]) {
      if (r_h < band_cap) {
        ids[n_front + r_h] = i;
        kind[n_front + r_h] = BAND;
      }
      ++r_h;
    } else if (c == WIDE) {
      if (r_w < wide_cap) {
        ids[n_front + n_band_sel + r_w] = i;
        kind[n_front + n_band_sel + r_w] = WIDE;
      }
      ++r_w;
    }
    const int j = static_cast<int>(perm[i]);
    if (cls[j] == BAND && !surf[j]) {
      const int slot = n_hi + r_l;
      if (slot < band_cap) {
        ids[n_front + slot] = j;
        kind[n_front + slot] = BAND;
      }
      ++r_l;
    }
  }
  if (threadIdx.x == 0) {
    count[0] = n_front + n_band_sel + min(n_wide, wide_cap);
    counts[0] = n_band;
    counts[1] = n_wide;
    counts[2] = max(n_band - band_cap, 0) + max(n_wide - wide_cap, 0);
  }
}

}  // namespace

extern "C" int df_brick_plan(const void* dists, int rows, int cols, int levels, void* dmin, void* dmax, void* av,
                             const void* cam, int g_pts, int w, int nb, int nbx, int bx0, float fx, float fy,
                             float cx, float cy,
                             int rect, float trunc, float zeps, const void* phase, int split, const void* perm,
                             int band_cap, int wide_cap, void* cls, void* u0, void* v0, void* surf, void* ids,
                             void* kind, void* count, void* counts, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Mip m{static_cast<float*>(dmin), static_cast<float*>(dmax), static_cast<float*>(av), rows, cols, levels};
  const dim3 tile(kTile, kTile);
  const dim3 grid((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
  mip_tiles_kernel<<<grid, tile, 0, st>>>(static_cast<const float*>(dists), m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Geo k{static_cast<const float*>(cam), g_pts, w, nb, nbx, bx0, fx, fy, cx, cy, rows, cols, rect, trunc, zeps, 2.0f};
  classify_plan_kernel<<<1, kBlock, 0, st>>>(
      m, k, static_cast<const int*>(phase), split, static_cast<const int64_t*>(perm), band_cap, wide_cap,
      static_cast<int64_t*>(cls), static_cast<int*>(u0), static_cast<int*>(v0), static_cast<bool*>(surf),
      static_cast<int*>(ids), static_cast<int*>(kind), static_cast<int*>(count), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}
