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
// Design: one launch a call. One thread per current pixel forms its 6-row
// and accumulates the 21 upper-triangle products of JᵀJ and the 6 of Jᵀr
// in registers; a block of 256 pixels reduces them with warp shuffles
// (16, 8, 4, 2, 1) and adds its warps' sums in warp order into 27 partial
// sums. The last block to finish (a ticket in device memory) sums the
// partials in block order, staging them through shared memory with all
// its threads so that the loads are coalesced and in flight together, and
// writes the full symmetric A and b. There are no float atomics and the
// order is fixed, so the system, and the pose after it, is bit-stable from
// run to run. A device-side `active` flag skips all work (zeros out) when
// the ICP level has converged, which keeps the Gauss-Newton loop free of
// host syncs. The two-pass mode (the partials, then one 32-thread block
// whose 27 threads each walk them) sums in the same order: it stays as the
// reference the one-launch kernel is held against bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;
constexpr int kOut = 42;     // A (6x6, row major), then b (6)
constexpr int kStage = 256;  // blocks whose partials the finishing block stages at a time

struct Args {
  const float* T;
  const float* cp;
  const float* cn;
  const float* pp;
  const float* pn;
  int n, rows, cols;
  float fx, fy, cx, cy, dist2_thres, min_cos;
};

// the 27 sums of pixel group g (kThreads pixels) into dst[0:27]; every
// thread of the block calls it
__device__ __forceinline__ void group_sums(const Args& a, int g, float* __restrict__ dst) {
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;

  const float* T = a.T;
  const int i = g * kThreads + threadIdx.x;
  if (i < a.n) {
    const float px = __ldg(a.cp + 3 * i), py = __ldg(a.cp + 3 * i + 1), pz = __ldg(a.cp + 3 * i + 2);
    const float qx = __ldg(a.cn + 3 * i), qy = __ldg(a.cn + 3 * i + 1), qz = __ldg(a.cn + 3 * i + 2);
    // s = R p + t ; ns = R n
    const float sx = px * T[0] + py * T[1] + pz * T[2] + T[3];
    const float sy = px * T[4] + py * T[5] + pz * T[6] + T[7];
    const float sz = px * T[8] + py * T[9] + pz * T[10] + T[11];
    const float u = sx * a.fx / sz + a.cx;
    const float v = sy * a.fy / sz + a.cy;
    const bool inb = (sz > 0.0f) && (u >= 0.0f) && (v >= 0.0f) && (u < a.cols) && (v < a.rows);
    const int ui = dfk::floor_clamp(u, a.cols - 1);
    const int vi = dfk::floor_clamp(v, a.rows - 1);
    const int j = vi * a.cols + ui;
    const float dx = __ldg(a.pp + 3 * j), dy = __ldg(a.pp + 3 * j + 1), dz = __ldg(a.pp + 3 * j + 2);
    const float nx = __ldg(a.pn + 3 * j), ny = __ldg(a.pn + 3 * j + 1), nz = __ldg(a.pn + 3 * j + 2);
    const bool valid = !isnan(px) && inb && !isnan(dx) && !isnan(nx);
    const float ex = sx - dx, ey = sy - dy, ez = sz - dz;
    const float dist2 = ex * ex + ey * ey + ez * ez;
    const float nsx = qx * T[0] + qy * T[1] + qz * T[2];
    const float nsy = qx * T[4] + qy * T[5] + qz * T[6];
    const float nsz = qx * T[8] + qy * T[9] + qz * T[10];
    const float cosine = fabsf(nsx * nx + nsy * ny + nsz * nz);
    if (valid && dist2 < a.dist2_thres && cosine > a.min_cos) {
      const float row[6] = {sy * nz - sz * ny, sz * nx - sx * nz, sx * ny - sy * nx, nx, ny, nz};
      const float rhs = nx * (dx - sx) + ny * (dy - sy) + nz * (dz - sz);
      int k = 0;
#pragma unroll
      for (int p = 0; p < 6; ++p) {
#pragma unroll
        for (int q = p; q < 6; ++q) acc[k++] = row[p] * row[q];
      }
#pragma unroll
      for (int p = 0; p < 6; ++p) acc[21 + p] = row[p] * rhs;
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
    dst[threadIdx.x] = s;
  }
  __syncthreads();
}

// A (the 21 upper-triangle sums mirrored) and b from the 27 sums
__device__ __forceinline__ void write_system(const float* __restrict__ s, float* __restrict__ out) {
  for (int e = threadIdx.x; e < kOut; e += blockDim.x) {
    if (e < 36) {
      const int r = min(e / 6, e % 6), c = max(e / 6, e % 6);
      out[e] = s[r * 6 - r * (r - 1) / 2 + (c - r)];
    } else {
      out[e] = s[21 + e - 36];
    }
  }
}

// the block that finds every partial out adds them in block order, kStage
// blocks at a time through shared memory: every thread holds its share of
// the next stage in registers while 27 threads add the current one (8
// loads ahead of the dependent adds), so each stage costs about one L2
// round trip or its kStage adds, whichever is longer; then A and b
__device__ void ordered_finish(const float* partial, int nblocks, float* __restrict__ out) {
  constexpr int kPer = (kStage * kSums + kThreads - 1) / kThreads;
  __shared__ float stage[kStage * kSums];
  __shared__ float sums[kSums];
  float next[kPer];
  auto fetch = [&](int b0) {
    const int ne = min(kStage, nblocks - b0) * kSums;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = q * kThreads + threadIdx.x;
      next[q] = e < ne ? __ldcg(partial + b0 * kSums + e) : 0.0f;
    }
  };
  float s = 0.0f;
  fetch(0);
  for (int b0 = 0; b0 < nblocks; b0 += kStage) {
    const int nb = min(kStage, nblocks - b0);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = q * kThreads + threadIdx.x;
      if (e < kStage * kSums) stage[e] = next[q];
    }
    __syncthreads();
    if (b0 + kStage < nblocks) fetch(b0 + kStage);
    if (threadIdx.x < kSums) {
      int b = 0;
      for (; b + 8 <= nb; b += 8) {
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = stage[(b + q) * kSums + threadIdx.x];
#pragma unroll
        for (int q = 0; q < 8; ++q) s += v[q];
      }
      for (; b < nb; ++b) s += stage[b * kSums + threadIdx.x];
    }
    __syncthreads();
  }
  if (threadIdx.x < kSums) sums[threadIdx.x] = s;
  __syncthreads();
  write_system(sums, out);
}

// the one-launch kernel: partials, a ticket, and the last block's finish
__global__ void __launch_bounds__(kThreads)
icp_reduce_kernel(Args a, const bool* __restrict__ active, float* __restrict__ partial,
                  unsigned int* __restrict__ ticket, float* __restrict__ out, int nblocks) {
  if (!*active) {
    if (blockIdx.x == 0) {
      for (int e = threadIdx.x; e < kOut; e += blockDim.x) out[e] = 0.0f;
    }
    return;
  }
  group_sums(a, blockIdx.x, partial + static_cast<size_t>(blockIdx.x) * kSums);
  __shared__ bool last;
  __threadfence();  // this block's partials before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(nblocks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  ordered_finish(partial, nblocks, out);
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next launch on this stream
}

// the two-pass mode: the partials ...
__global__ void __launch_bounds__(kThreads)
icp_rows_kernel(Args a, const bool* __restrict__ active, float* __restrict__ partial) {
  if (!*active) return;
  group_sums(a, blockIdx.x, partial + static_cast<size_t>(blockIdx.x) * kSums);
}

// ... then one block: thread k < 27 adds the partials of sum k in block order
__global__ void icp_finalize_kernel(const float* __restrict__ partial, int nblocks,
                                    const bool* __restrict__ active, float* __restrict__ out) {
  __shared__ float sums[kSums];
  const int k = threadIdx.x;
  float s = 0.0f;
  if (k < kSums && *active) {
    for (int b = 0; b < nblocks; ++b) s += partial[b * kSums + k];
  }
  if (k < kSums) sums[k] = s;
  __syncthreads();
  write_system(sums, out);
}

}  // namespace

// out: (42,) A then b. ticket: the device's (1,) zero-between-launches
// counter (one-launch mode; the port issues every kernel on one stream, so
// no two launches hold it at once). two_pass: the rows pass and the
// one-block sum as two launches (the reference mode; ticket unused).
extern "C" int df_icp_reduce(const void* T, const void* cp, const void* cn, const void* pp,
                             const void* pn, const void* active, void* partial, void* ticket, void* out,
                             int n, int rows, int cols, int nblocks, float fx, float fy, float cx,
                             float cy, float dist2_thres, float min_cos, int two_pass, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(T), static_cast<const float*>(cp), static_cast<const float*>(cn),
               static_cast<const float*>(pp), static_cast<const float*>(pn), n, rows, cols,
               fx, fy, cx, cy, dist2_thres, min_cos};
  const bool* act = static_cast<const bool*>(active);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (!two_pass) {
    if (ticket == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    icp_reduce_kernel<<<nblocks, kThreads, 0, s>>>(a, act, part, static_cast<unsigned int*>(ticket), o, nblocks);
    return static_cast<int>(cudaGetLastError());
  }
  icp_rows_kernel<<<nblocks, kThreads, 0, s>>>(a, act, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  icp_finalize_kernel<<<1, 32, 0, s>>>(part, nblocks, act, o);
  return static_cast<int>(cudaGetLastError());
}
