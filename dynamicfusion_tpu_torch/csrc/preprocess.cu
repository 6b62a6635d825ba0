// Kernel I: the per-frame preprocessing stencils.
//
// Replaces dynamicfusion_tpu/ops/preprocess.py:165 compute_dists and :81
// truncate_depth (one launch, df_depth_dists), :91 depth_pyramid_down
// applied once a level by :197 build_frame_pyramid (every level of a frame
// in one launch, df_depth_pyramid; df_pyramid_down, one level a launch, is
// its reference mode), :124 compute_points_normals with the fusion's incidence
// confidence of dynamicfusion_tpu/pipeline/kinfu.py:634-636 as an optional
// output (df_points_normals), and :172 resize_points_normals
// (df_resize_maps). On the TPU each is a set of shifted whole-image passes
// that XLA fuses; in the port's plain version each is tens of small
// PyTorch kernels. The frame's point/normal maps are one launch
// (df_frame_maps): up to kMapTasks tasks (a depth image, its stride and
// intrinsics, and which of points, normals and confidence to write), a
// block finding its task from the tasks' prefix counts of blocks, so a
// preset frame's four maps (level 0's confidence, levels 2 and 3, the
// solve's raw stride-4 points) take one launch, and a map that no step
// reads is not written (the level-0 maps of a frame tracked from level 2:
// 7.4 MB of the 9.2 MB the single-map launches wrote). A thread takes a
// pixel: the maps are bound by their true divisions and square roots (12
// and 2 a pixel; as products by reciprocals a preset frame's maps take
// two thirds of the time) and by the launch, not by their 2.9 MB, and 2
// or 4 consecutive pixels a thread with vector loads and float4 stores
// only lengthened each thread's chain (a warp's strip of rows sharing its
// back-projections by shuffles was within 5%:
// scripts/torch_spd6_maps_variants.py). Each pixel repeats the
// single-map kernel's arithmetic (pixel_maps, the same device function),
// so every map is bit-equal to it; df_points_normals, one map a launch,
// stays as the reference mode.
#include "common.cuh"

namespace {

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

struct Intr {
  float fx, fy, cx, cy;
};

__global__ void dists_kernel(const uint16_t* __restrict__ raw, int rows, int cols, Intr k,
                             const uint16_t* __restrict__ filt, float max_mm, float* __restrict__ dists,
                             uint16_t* __restrict__ trunc) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= cols || y >= rows) return;
  const int i = y * cols + x;
  const float xl = (static_cast<float>(x) - k.cx) / k.fx;
  const float yl = (static_cast<float>(y) - k.cy) / k.fy;
  const float lam = sqrtf(xl * xl + yl * yl + 1.0f);
  dists[i] = static_cast<float>(raw[i]) * lam * 0.001f;
  if (filt != nullptr) {
    const uint16_t d = filt[i];
    trunc[i] = static_cast<float>(d) > max_mm ? static_cast<uint16_t>(0) : d;
  }
}

__global__ void pyramid_down_kernel(const uint16_t* __restrict__ in, int h, int w, float thresh,
                                    uint16_t* __restrict__ out) {
  const int ow = w / 2, oh = h / 2;
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= ow || oy >= oh) return;
  const int y = 2 * oy, x = 2 * ox;
  const float d = static_cast<float>(in[y * w + x]);
  float s = 0.0f, cnt = 0.0f;
  for (int dy = -2; dy <= 2; ++dy) {
    const int yy = y + dy;
    for (int dx = -2; dx <= 2; ++dx) {
      const int xx = x + dx;
      if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
      const float nbr = static_cast<float>(__ldg(in + yy * w + xx));
      if (fabsf(nbr - d) < thresh) {
        s = s + nbr;
        cnt = cnt + 1.0f;
      }
    }
  }
  const float mean = cnt > 0.0f ? s / fmaxf(cnt, 1.0f) : 0.0f;
  out[oy * ow + ox] = static_cast<uint16_t>(static_cast<int>(mean));
}

// The whole depth pyramid in one launch. The levels are 2x downsamples of
// one another (level k is (h_{k-1} // 2, w_{k-1} // 2)), so a block owns a
// T x T tile of the deepest level D and, at each level k above it, the
// (T 2^(D-k))^2 pixels that tile covers; the last row and column of blocks
// also own what an odd level size leaves over. A block needs the region of
// level k that the 5x5 windows of its region of level k + 1 reach: n_D = T
// pixels a side, n_k = 2 n_{k+1} + 3, starting H_k = 2 H_{k+1} + 2 pixels
// before its owned tile (H_D = 0): 8T + 21 at level 0 for three levels
// down. The block reads that level-0 region once into shared memory,
// computes each coarser level over its region there (the halos that
// neighbouring blocks compute too, recomputed), and writes only the pixels
// it owns. The regions hold float, a NaN outside the image, so a tap needs
// no bounds test and no conversion: |NaN - d| < thresh is false, as the
// one-level kernel's skipped tap. Each pixel repeats pyramid_down_kernel's
// arithmetic: its sums add at most 25 integers below 2^16, exact in
// float32 in any order, then one true division and the truncations to int
// and uint16, so every level equals the one-level-a-launch kernel's bit
// for bit. Bound on the H100: the launch and the recomputed halos; the
// 640x480 frame is 0.6 MB in, 0.2 MB out. At the preset the plan takes
// T = 7, 108 blocks of 512 threads, one an SM, 1.9x the level-1 pixels
// (scripts/torch_pyramid_bands_variants.py on an H100 80GB HBM3 at 700 W:
// 0.0084 ms, 0.0086 with 12 level-0 loads a thread in flight; T = 4 in
// 300 blocks of 256 threads 0.0092; uint16 regions with a bounds test and
// a conversion a tap 0.0091; the three one-level launches 0.0136-0.0142;
// the empty launch 0.0020, to the level-0 region read 0.0038, to level 1
// 0.0068).
constexpr int kPyrMaxDown = 5;      // downsamples a launch (levels - 1)
constexpr int kPyrMaxTile = 8;      // T, the owned side at the deepest level, at most
constexpr int kPyrMaxThreads = 1024;  // threads a block at most
constexpr int kPyrBatch = 4;        // level-0 loads a thread in flight
constexpr int kPyrSmem = 98304;    // shared bytes a block at most (96 KB; past 48 KB by opt-in)

struct PyramidArgs {
  const uint16_t* in;
  uint16_t* out[kPyrMaxDown];  // level k + 1's (h[k + 1], w[k + 1]) image
  int h[kPyrMaxDown + 1], w[kPyrMaxDown + 1];
  int n[kPyrMaxDown + 1];      // region side at each level
  int halo[kPyrMaxDown + 1];   // region start before the owned tile
  int off[kPyrMaxDown + 1];    // region offset in shared memory (floats)
  int tile;                    // T, the owned side at the deepest level
  int down;                    // D
  float thresh;
};

// (row, column) of the flat index i of an n-wide region, stepped by the
// block's threads with one division at the start, not one a step
struct RowCol {
  int i, r, c, dr, dc, n;
  __device__ RowCol(int start, int step, int n_) : i(start), r(start / n_), c(start % n_), dr(step / n_),
                                                   dc(step % n_), n(n_) {}
  __device__ void next() {
    i += dr * n + dc;
    r += dr;
    c += dc;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
};

__global__ void __launch_bounds__(kPyrMaxThreads) depth_pyramid_kernel(const PyramidArgs a) {
  extern __shared__ float s_lv[];
  const int tid = threadIdx.x, nt = blockDim.x;
  // level 0's region, read once; kPyrBatch loads a thread in flight before
  // their stores, so that a block waits about one memory latency for its
  // region, not one a load
  {
    const int n = a.n[0], nn = n * n, span = a.tile << a.down;
    const int y0 = blockIdx.y * span - a.halo[0], x0 = blockIdx.x * span - a.halo[0];
    float* dst = s_lv + a.off[0];
    RowCol rc(tid, nt, n);
#pragma unroll 1
    for (int base = tid; base < nn; base += nt * kPyrBatch) {
      float v[kPyrBatch];
#pragma unroll
      for (int j = 0; j < kPyrBatch; ++j) {
        const int i = base + j * nt;
        const int y = y0 + rc.r, x = x0 + rc.c;
        v[j] = (i < nn && y >= 0 && y < a.h[0] && x >= 0 && x < a.w[0])
                   ? static_cast<float>(__ldg(a.in + y * a.w[0] + x)) : nan_f();
        rc.next();
      }
#pragma unroll
      for (int j = 0; j < kPyrBatch; ++j) {
        const int i = base + j * nt;
        if (i < nn) dst[i] = v[j];
      }
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int k = 1; k <= a.down; ++k) {
    const int n = a.n[k], np = a.n[k - 1], span = a.tile << (a.down - k);
    const int h = a.h[k], w = a.w[k];
    const int oy = blockIdx.y * span, ox = blockIdx.x * span;
    const int y0 = oy - a.halo[k], x0 = ox - a.halo[k];
    const float* src = s_lv + a.off[k - 1];
    float* dst = s_lv + a.off[k];
    uint16_t* out = a.out[k - 1];
#pragma unroll 1
    for (RowCol rc(tid, nt, n); rc.i < n * n; rc.next()) {
      const int i = rc.i, r = rc.r, c = rc.c;
      const int y = y0 + r, x = x0 + c;
      float v = nan_f();
      if (y >= 0 && y < h && x >= 0 && x < w) {
        // the centre (2y, 2x) of level k - 1 sits at (2r + 2, 2c + 2) of its region
        const float* ctr = src + (2 * r + 2) * np + (2 * c + 2);
        const float d = *ctr;
        float s = 0.0f, cnt = 0.0f;
#pragma unroll
        for (int dy = -2; dy <= 2; ++dy) {
#pragma unroll
          for (int dx = -2; dx <= 2; ++dx) {
            const float nbr = ctr[dy * np + dx];
            if (fabsf(nbr - d) < a.thresh) {
              s = s + nbr;
              cnt = cnt + 1.0f;
            }
          }
        }
        const float mean = cnt > 0.0f ? s / fmaxf(cnt, 1.0f) : 0.0f;
        const uint16_t q = static_cast<uint16_t>(static_cast<int>(mean));
        v = static_cast<float>(q);
        // the owned pixels: the tile's, and the last block's to the image's end
        const bool own_y = y >= oy && (y < oy + span || blockIdx.y + 1 == gridDim.y);
        const bool own_x = x >= ox && (x < ox + span || blockIdx.x + 1 == gridDim.x);
        if (own_y && own_x) out[y * w + x] = q;
      }
      if (k < a.down) dst[i] = v;
    }
    __syncthreads();
  }
}

// camera-space point of pixel (u, v) at depth z (core/camera.backproject)
__device__ __forceinline__ void backproject(const Intr& k, float u, float v, float z, float p[3]) {
  p[0] = z * (u - k.cx) / k.fx;
  p[1] = z * (v - k.cy) / k.fy;
  p[2] = z;
}

// depth at (y, x) of depth[::stride, ::stride], in metres; 0 outside
__device__ __forceinline__ float depth_m(const uint16_t* __restrict__ depth, int y, int x, int h, int w,
                                         int stride, int src_cols) {
  if (y >= h || x >= w) return 0.0f;
  return static_cast<float>(__ldg(depth + static_cast<size_t>(y) * stride * src_cols + x * stride)) * 0.001f;
}

// pixel (x, y)'s point, and with want_n or want_c its normal and incidence
// confidence, from its depth and its right and lower neighbours' (m)
__device__ __forceinline__ void pixel_maps(const Intr& k, int x, int y, int h, int w, float z00, float z01, float z10,
                                           bool want_n, bool want_c, float p[3], float nr[3], float& c) {
  const float u = static_cast<float>(x), v = static_cast<float>(y);
  float v00[3], v01[3], v10[3];
  backproject(k, u, v, z00, v00);
  backproject(k, u + 1.0f, v, z01, v01);
  backproject(k, u, v + 1.0f, z10, v10);
  const bool valid = (z00 * z01 * z10) != 0.0f && x < w - 1 && y < h - 1;
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = valid ? v00[a] : nan_f();
  if (!want_n && !want_c) return;
  const float a0 = v01[0] - v00[0], a1 = v01[1] - v00[1], a2 = v01[2] - v00[2];
  const float b0 = v10[0] - v00[0], b1 = v10[1] - v00[1], b2 = v10[2] - v00[2];
  float n[3] = {a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0};
  const float nn = fmaxf(sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]), 1e-12f);
#pragma unroll
  for (int a = 0; a < 3; ++a) n[a] = -(n[a] / nn);
#pragma unroll
  for (int a = 0; a < 3; ++a) nr[a] = valid ? n[a] : nan_f();
  if (want_c) {
    // |cos| of the normal against the viewing ray, 0 where invalid
    c = 0.0f;
    if (valid) {
      const float pn = fmaxf(sqrtf(v00[0] * v00[0] + v00[1] * v00[1] + v00[2] * v00[2]), 1e-9f);
      c = fabsf(n[0] * (v00[0] / pn) + n[1] * (v00[1] / pn) + n[2] * (v00[2] / pn));
      if (isnan(c)) c = 0.0f;
    }
  }
}

// the reference mode: a thread a pixel of one map
__global__ void points_normals_kernel(const uint16_t* __restrict__ depth, int h, int w, int stride, int src_cols,
                                      Intr k, float* __restrict__ points, float* __restrict__ normals,
                                      float* __restrict__ conf) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int i = y * w + x;
  float p[3], n[3], c;
  pixel_maps(k, x, y, h, w, depth_m(depth, y, x, h, w, stride, src_cols), depth_m(depth, y, x + 1, h, w, stride, src_cols),
             depth_m(depth, y + 1, x, h, w, stride, src_cols), normals != nullptr, conf != nullptr, p, n, c);
#pragma unroll
  for (int a = 0; a < 3; ++a) points[3 * i + a] = p[a];
  if (normals != nullptr) {
#pragma unroll
    for (int a = 0; a < 3; ++a) normals[3 * i + a] = n[a];
  }
  if (conf != nullptr) conf[i] = c;
}

constexpr int kMapTasks = 8;      // tasks a launch
constexpr int kMapThreads = 128;  // threads a block, a pixel a thread

// a task as the wrapper lays it out: the maps of depth[::stride, ::stride]
// ((h, w) of a (rows, src_cols) image); a null output is not written
struct MapTaskArgs {
  const void* depth;
  void* points;
  void* normals;
  void* conf;
  float fx, fy, cx, cy;
  int h, w, stride, src_cols;
};

struct MapLaunch {
  MapTaskArgs t[kMapTasks];
  int first_block[kMapTasks];  // the tasks' prefix counts of blocks
  int n;
};

__global__ void __launch_bounds__(kMapThreads) frame_maps_kernel(const MapLaunch launch) {
  int ti = 0;
#pragma unroll 1
  while (ti + 1 < launch.n && static_cast<int>(blockIdx.x) >= launch.first_block[ti + 1]) ++ti;
  const MapTaskArgs& t = launch.t[ti];
  const int h = t.h, w = t.w;
  const int i = (static_cast<int>(blockIdx.x) - launch.first_block[ti]) * kMapThreads + threadIdx.x;
  if (i >= h * w) return;
  const int y = i / w, x = i - y * w;
  const uint16_t* depth = static_cast<const uint16_t*>(t.depth);
  float* const points = static_cast<float*>(t.points);
  float* const normals = static_cast<float*>(t.normals);
  float* const conf = static_cast<float*>(t.conf);
  float p[3], n[3], c;
  pixel_maps(Intr{t.fx, t.fy, t.cx, t.cy}, x, y, h, w, depth_m(depth, y, x, h, w, t.stride, t.src_cols),
             depth_m(depth, y, x + 1, h, w, t.stride, t.src_cols), depth_m(depth, y + 1, x, h, w, t.stride, t.src_cols),
             normals != nullptr, conf != nullptr, p, n, c);
  if (points != nullptr) {
#pragma unroll
    for (int a = 0; a < 3; ++a) points[3 * static_cast<size_t>(i) + a] = p[a];
  }
  if (normals != nullptr) {
#pragma unroll
    for (int a = 0; a < 3; ++a) normals[3 * static_cast<size_t>(i) + a] = n[a];
  }
  if (conf != nullptr) conf[i] = c;
}

__global__ void resize_maps_kernel(const float* __restrict__ pts, const float* __restrict__ nrm, int h, int w,
                                   float* __restrict__ out_p, float* __restrict__ out_n) {
  const int ow = w / 2, oh = h / 2;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= ow || y >= oh) return;
  const int i00 = (2 * y) * w + 2 * x, i01 = i00 + 1, i10 = i00 + w, i11 = i10 + 1;
  const bool valid = !isnan(pts[3 * i00]) && !isnan(pts[3 * i01]) && !isnan(pts[3 * i10]) && !isnan(pts[3 * i11]);
  const int o = y * ow + x;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = ((pts[3 * i00 + a] + pts[3 * i01 + a]) + pts[3 * i10 + a]) + pts[3 * i11 + a];
    const float q = ((nrm[3 * i00 + a] + nrm[3 * i01 + a]) + nrm[3 * i10 + a]) + nrm[3 * i11 + a];
    out_p[3 * o + a] = valid ? p / 4.0f : nan_f();
    out_n[3 * o + a] = valid ? q / 4.0f : nan_f();
  }
}

dim3 grid_of(int cols, int rows, dim3 block) {
  return dim3((cols + block.x - 1) / block.x, (rows + block.y - 1) / block.y);
}

}  // namespace

extern "C" int df_depth_dists(const void* raw, int rows, int cols, float fx, float fy, float cx, float cy,
                              const void* filt, float max_mm, void* dists, void* trunc, void* stream) {
  const dim3 block(32, 8);
  if (rows > 0 && cols > 0) {
    dists_kernel<<<grid_of(cols, rows, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(raw), rows, cols, Intr{fx, fy, cx, cy}, static_cast<const uint16_t*>(filt),
        max_mm, static_cast<float*>(dists), static_cast<uint16_t*>(trunc));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int df_pyramid_down(const void* in, int h, int w, float thresh, void* out, void* stream) {
  const dim3 block(32, 8);
  if (h >= 2 && w >= 2) {
    pyramid_down_kernel<<<grid_of(w / 2, h / 2, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(in), h, w, thresh, static_cast<uint16_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// the one-launch pyramid's plan: the tile T (1..kPyrMaxTile) whose busiest
// SM computes the fewest level-1 pixels, ceil(blocks / SMs) x n_1^2 (the
// level-1 region is the largest a block computes), among those whose
// regions fit kPyrSmem, the larger T on a tie; 512 threads a block where
// every block has an SM of its own, else 256. tile and threads > 0 force
// them (scripts/torch_pyramid_bands_variants.py). Fills the args' region
// sizes and offsets and returns the shared bytes (0: no tile fits).
static int pyramid_plan(PyramidArgs& a, int sms, int tile, int threads, dim3& grid, int& block) {
  auto regions = [&a](int t) {  // the sides, halos and offsets of tile t; its bytes
    a.tile = t;
    a.n[a.down] = t;
    a.halo[a.down] = 0;
    for (int k = a.down - 1; k >= 0; --k) {
      a.n[k] = 2 * a.n[k + 1] + 3;
      a.halo[k] = 2 * a.halo[k + 1] + 2;
    }
    int total = 0;
    for (int k = 0; k < a.down; ++k) {  // the deepest level is not staged
      a.off[k] = total;
      total += a.n[k] * a.n[k];
    }
    a.off[a.down] = total;
    return total * static_cast<int>(sizeof(float));
  };
  auto cover = [&a](int t) {  // blocks to cover every level: the deepest
    int gy = 0, gx = 0;       // level's tiles, or one more where an odd
    for (int k = 1; k <= a.down; ++k) {  // level leaves a row past them
      const int span = t << (a.down - k);
      gy = max(gy, (a.h[k] + span - 1) / span);
      gx = max(gx, (a.w[k] + span - 1) / span);
    }
    return dim3(max(gx, 1), max(gy, 1));
  };
  int best = 0;
  long long best_cost = 0;
  for (int t = 1; t <= kPyrMaxTile; ++t) {
    if (regions(t) > kPyrSmem || (tile > 0 && t != tile)) continue;
    const dim3 g = cover(t);
    const long long waves = (static_cast<long long>(g.x) * g.y + sms - 1) / sms;
    const long long cost = waves * a.n[1] * a.n[1];
    if (best == 0 || cost <= best_cost) {
      best = t;
      best_cost = cost;
    }
  }
  if (best == 0) return 0;
  const int bytes = regions(best);
  grid = cover(best);
  block = threads > 0 ? threads : (static_cast<long long>(grid.x) * grid.y <= sms ? 512 : 256);
  return bytes;
}

// levels 1..down of the pyramid of the (h, w) uint16 image in, one launch;
// outs[k - 1] receives level k; *tile and *threads, where positive, force
// the plan's tile and threads a block and receive the plan's; *launched
// receives the device kernels launched (0 where the levels are empty)
extern "C" int df_depth_pyramid(const void* in, int h, int w, int down, float thresh, void* const* outs, int sms,
                                int* tile, int* threads, int* launched, void* stream) {
  *launched = 0;
  if (down < 1 || down > kPyrMaxDown || h < 0 || w < 0 || *threads < 0 || *threads > kPyrMaxThreads ||
      *threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PyramidArgs a{};
  a.in = static_cast<const uint16_t*>(in);
  a.down = down;
  a.thresh = thresh;
  a.h[0] = h;
  a.w[0] = w;
  for (int k = 1; k <= down; ++k) {
    a.h[k] = a.h[k - 1] / 2;
    a.w[k] = a.w[k - 1] / 2;
    a.out[k - 1] = static_cast<uint16_t*>(outs[k - 1]);
  }
  if (a.h[1] < 1 || a.w[1] < 1) return 0;
  dim3 grid;
  int block = 0;
  const int bytes = pyramid_plan(a, sms, *tile, *threads, grid, block);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  *tile = a.tile;
  *threads = block;
  if (bytes > (48 << 10)) {
    const cudaError_t e =
        cudaFuncSetAttribute(depth_pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  depth_pyramid_kernel<<<grid, block, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  *launched = 1;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int df_points_normals(const void* depth, int h, int w, int stride, int src_cols, float fx, float fy,
                                 float cx, float cy, void* points, void* normals, void* conf, void* stream) {
  const dim3 block(32, 8);
  if (h > 0 && w > 0) {
    points_normals_kernel<<<grid_of(w, h, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(depth), h, w, stride, src_cols, Intr{fx, fy, cx, cy},
        static_cast<float*>(points), static_cast<float*>(normals), static_cast<float*>(conf));
  }
  return static_cast<int>(cudaGetLastError());
}

// one launch of the maps of n <= kMapTasks tasks; *launched receives the
// device kernels launched (0 where no task has a pixel)
extern "C" int df_frame_maps(const void* tasks, int n, int* launched, void* stream) {
  *launched = 0;
  if (n < 1 || n > kMapTasks) return static_cast<int>(cudaErrorInvalidValue);
  const MapTaskArgs* in = static_cast<const MapTaskArgs*>(tasks);
  MapLaunch launch{};
  long long blocks = 0;
  for (int j = 0; j < n; ++j) {
    const MapTaskArgs& t = in[j];
    if (t.h < 0 || t.w < 0 || t.stride < 1 || static_cast<long long>(t.h) * t.w > (1ll << 30)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    launch.t[j] = t;
    launch.first_block[j] = static_cast<int>(blocks);
    blocks += (static_cast<long long>(t.h) * t.w + kMapThreads - 1) / kMapThreads;
  }
  launch.n = n;
  if (blocks == 0) return 0;
  frame_maps_kernel<<<static_cast<unsigned int>(blocks), kMapThreads, 0, static_cast<cudaStream_t>(stream)>>>(launch);
  *launched = 1;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int df_resize_maps(const void* pts, const void* nrm, int h, int w, void* out_p, void* out_n,
                              void* stream) {
  const dim3 block(32, 8);
  if (h >= 2 && w >= 2) {
    resize_maps_kernel<<<grid_of(w / 2, h / 2, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), static_cast<const float*>(nrm), h, w, static_cast<float*>(out_p),
        static_cast<float*>(out_n));
  }
  return static_cast<int>(cudaGetLastError());
}
