// Kernel B: projective ICP association + 6x6 normal-equation reduction.
//
// Replaces dynamicfusion_tpu/solvers/icp.py:38 _build_system (masked
// (H, W, 6) rows and an einsum on the TPU's matrix unit).
//
// Bound on the H100: bytes and latency. One pass reads the current
// point/normal maps (24 B/pixel) and one random 24 B model-map fetch per
// pixel, and does ~80 flops per pixel: at 160x120 that is ~1 MB, a few
// microseconds of memory time, so launch latency and the reduction's
// synchronisation dominate.
// Design: one thread per current pixel forms its 6-row and accumulates the
// 21 upper-triangle products of JᵀJ and the 6 of Jᵀr in registers; a block
// reduces them with warp shuffles and one shared-memory pass into 27
// partial sums. A second single-block pass sums the partials in block
// order. There are no float atomics, so the system, and the pose after
// it, is bit-stable from run to run. Both passes read a device-side
// `active` flag and skip their work when the ICP level has converged,
// which keeps the Gauss-Newton loop free of host syncs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;

__global__ void __launch_bounds__(kThreads)
icp_rows_kernel(const float* __restrict__ T, const float* __restrict__ cp,
                const float* __restrict__ cn, const float* __restrict__ pp,
                const float* __restrict__ pn, const bool* __restrict__ active,
                float* __restrict__ partial, int n, int rows, int cols, float fx, float fy,
                float cx, float cy, float dist2_thres, float min_cos) {
  if (!*active) return;
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const float px = cp[3 * i], py = cp[3 * i + 1], pz = cp[3 * i + 2];
    const float qx = cn[3 * i], qy = cn[3 * i + 1], qz = cn[3 * i + 2];
    // s = R p + t ; ns = R n
    const float sx = px * T[0] + py * T[1] + pz * T[2] + T[3];
    const float sy = px * T[4] + py * T[5] + pz * T[6] + T[7];
    const float sz = px * T[8] + py * T[9] + pz * T[10] + T[11];
    const float u = sx * fx / sz + cx;
    const float v = sy * fy / sz + cy;
    const bool inb = (sz > 0.0f) && (u >= 0.0f) && (v >= 0.0f) && (u < cols) && (v < rows);
    const int ui = dfk::floor_clamp(u, cols - 1);
    const int vi = dfk::floor_clamp(v, rows - 1);
    const int j = vi * cols + ui;
    const float dx = pp[3 * j], dy = pp[3 * j + 1], dz = pp[3 * j + 2];
    const float nx = pn[3 * j], ny = pn[3 * j + 1], nz = pn[3 * j + 2];
    const bool valid = !isnan(px) && inb && !isnan(dx) && !isnan(nx);
    const float ex = sx - dx, ey = sy - dy, ez = sz - dz;
    const float dist2 = ex * ex + ey * ey + ez * ez;
    const float nsx = qx * T[0] + qy * T[1] + qz * T[2];
    const float nsy = qx * T[4] + qy * T[5] + qz * T[6];
    const float nsz = qx * T[8] + qy * T[9] + qz * T[10];
    const float cosine = fabsf(nsx * nx + nsy * ny + nsz * nz);
    if (valid && dist2 < dist2_thres && cosine > min_cos) {
      const float row[6] = {sy * nz - sz * ny, sz * nx - sx * nz, sx * ny - sy * nx, nx, ny, nz};
      const float rhs = nx * (dx - sx) + ny * (dy - sy) + nz * (dz - sz);
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b) acc[k++] = row[a] * row[b];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] = row[a] * rhs;
    }
  }

  __shared__ float sm[kSums][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) sm[k][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sm[threadIdx.x][w];
    partial[blockIdx.x * kSums + threadIdx.x] = s;
  }
}

__global__ void icp_finalize_kernel(const float* __restrict__ partial, int nblocks,
                                    const bool* __restrict__ active, float* __restrict__ out) {
  const int k = threadIdx.x;
  if (k >= kSums) return;
  float s = 0.0f;
  if (*active) {
    for (int b = 0; b < nblocks; ++b) s += partial[b * kSums + k];
  }
  out[k] = s;
}

}  // namespace

extern "C" int df_icp_reduce(const void* T, const void* cp, const void* cn, const void* pp,
                             const void* pn, const void* active, void* partial, void* out, int n,
                             int rows, int cols, int nblocks, float fx, float fy, float cx,
                             float cy, float dist2_thres, float min_cos, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  icp_rows_kernel<<<nblocks, kThreads, 0, s>>>(
      static_cast<const float*>(T), static_cast<const float*>(cp), static_cast<const float*>(cn),
      static_cast<const float*>(pp), static_cast<const float*>(pn),
      static_cast<const bool*>(active), static_cast<float*>(partial), n, rows, cols, fx, fy, cx,
      cy, dist2_thres, min_cos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  icp_finalize_kernel<<<1, 32, 0, s>>>(static_cast<const float*>(partial), nblocks,
                                       static_cast<const bool*>(active),
                                       static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
