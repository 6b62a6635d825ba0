// Kernel I: the per-frame preprocessing stencils.
//
// Replaces dynamicfusion_tpu/ops/preprocess.py:165 compute_dists and :81
// truncate_depth (one launch, df_depth_dists), :91 depth_pyramid_down
// (df_pyramid_down), :124 compute_points_normals with the fusion's incidence
// confidence of dynamicfusion_tpu/pipeline/kinfu.py:634-636 as an optional
// output (df_points_normals), and :172 resize_points_normals
// (df_resize_maps). On the TPU each is a set of shifted whole-image passes
// that XLA fuses; in the port's plain version each is tens of small
// PyTorch kernels.
//
// Bound on the H100: bytes, and at these sizes launch latency. The largest
// pass reads the 640x480 uint16 frame (0.6 MB) and writes 640x480x3 float32
// points and normals (7.4 MB); the arithmetic is a few dozen operations a
// pixel.
// Design: one thread per output pixel, 32x8 blocks so a warp reads a row;
// a stencil's neighbours come from L1/L2. Each entry repeats its plain
// version's float32 arithmetic operation for operation (-fmad=false, true
// divisions as the JAX package divides, the window sums in the plain
// loop's order); the pyramid's window sums are sums of whole millimetres
// (exact), its mean truncates to integer mm; uint16 is read and written
// directly. The last row and column of a point map are invalid, as the
// reference's forward differences leave them.
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

__global__ void points_normals_kernel(const uint16_t* __restrict__ depth, int h, int w, int stride, int src_cols,
                                      Intr k, float* __restrict__ points, float* __restrict__ normals,
                                      float* __restrict__ conf) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int i = y * w + x;
  const float u = static_cast<float>(x), v = static_cast<float>(y);
  const float z00 = depth_m(depth, y, x, h, w, stride, src_cols);
  const float z01 = depth_m(depth, y, x + 1, h, w, stride, src_cols);
  const float z10 = depth_m(depth, y + 1, x, h, w, stride, src_cols);
  float v00[3], v01[3], v10[3];
  backproject(k, u, v, z00, v00);
  backproject(k, u + 1.0f, v, z01, v01);
  backproject(k, u, v + 1.0f, z10, v10);
  const bool valid = (z00 * z01 * z10) != 0.0f && x < w - 1 && y < h - 1;
#pragma unroll
  for (int a = 0; a < 3; ++a) points[3 * i + a] = valid ? v00[a] : nan_f();
  if (normals == nullptr && conf == nullptr) return;
  const float a0 = v01[0] - v00[0], a1 = v01[1] - v00[1], a2 = v01[2] - v00[2];
  const float b0 = v10[0] - v00[0], b1 = v10[1] - v00[1], b2 = v10[2] - v00[2];
  float n[3] = {a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0};
  const float nn = fmaxf(sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]), 1e-12f);
#pragma unroll
  for (int a = 0; a < 3; ++a) n[a] = -(n[a] / nn);
  if (normals != nullptr) {
#pragma unroll
    for (int a = 0; a < 3; ++a) normals[3 * i + a] = valid ? n[a] : nan_f();
  }
  if (conf != nullptr) {
    // |cos| of the normal against the viewing ray, 0 where invalid
    float c = 0.0f;
    if (valid) {
      const float pn = fmaxf(sqrtf(v00[0] * v00[0] + v00[1] * v00[1] + v00[2] * v00[2]), 1e-9f);
      c = fabsf(n[0] * (v00[0] / pn) + n[1] * (v00[1] / pn) + n[2] * (v00[2] / pn));
      if (isnan(c)) c = 0.0f;
    }
    conf[i] = c;
  }
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
