// Kernel I: the per-frame preprocessing stencils.
//
// Replaces dynamicfusion_tpu/ops/preprocess.py:165 compute_dists and :81
// truncate_depth (one launch, df_depth_dists), :91 depth_pyramid_down
// (df_pyramid_down), :124 compute_points_normals with the fusion's incidence
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
