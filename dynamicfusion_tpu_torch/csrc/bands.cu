// Kernel J: the model raycast's march bands and seed.
//
// df_march_bands replaces dynamicfusion_tpu/pipeline/kinfu.py:107
// _temporal_band and :91 _raycast_seed: from the live dists read at the
// raycast's stride and the
// previous frame's canonical model map, the per-pixel interval
// [min - m, max + m] of the ray distances over a 5x5 window (SAME, +-inf
// outside the image) and the expected distance (the live dists, holes
// filled with the window's positive minimum). On the TPU these are
// reduce_window passes that XLA fuses; the port's plain version is ~20
// small PyTorch kernels (strided copy, norm, wheres, two max_pool2d).
//
// Bound on the H100: bytes, and at 160x120 launch latency. The pass reads
// 19 200 dists and 19 200 map points (0.3 MB) and writes three 160x120
// float maps (0.2 MB); each pixel does 25 window taps of a few operations.
// Design: one launch, one thread per output pixel in 32x8 blocks; each
// tap recomputes its neighbour's sources (a strided dists load, the
// neighbour point's |p|) from L1/L2 instead of staging them in shared
// memory. |p| is sqrt((x*x + y*y) + z*z) in the plain version's order
// (-fmad=false), the window min/max are exact, so the band and seed equal
// the plain version's bit for bit.
//
// df_coarse_band replaces the band half of dynamicfusion_tpu/ops/tsdf.py:620
// raycast_coarse_band (its coarse march is kernel C's full march at 1/f
// resolution): the interval [min - m, max + m] of the coarse hits' ray
// distances |p| over a 3x3 window of coarse pixels (SAME, +-inf outside),
// empty where no neighbour hit, repeated f x f to the fine grid. On the
// TPU a reduce_window pair and two repeats; the plain version is a dozen
// small PyTorch kernels, the upsampling two copies. Bound: bytes and
// latency, the 160x120 coarse map in (0.2 MB) and the two 640x480 float
// maps out (2.5 MB).
// Design: one launch, one thread per FINE pixel, which reads its coarse
// cell's 3x3 window (from L1/L2: f x f threads share it) and writes its lo
// and hi directly, so no upsampling copy is made. |p| is
// sqrt((x*x + y*y) + z*z) in the plain order, the window min/max exact:
// the band equals the plain version's bit for bit.
#include "common.cuh"

namespace {

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__global__ void bands_kernel(const float* __restrict__ dists, int src_cols, int stride, int rows, int cols,
                             const float* __restrict__ prev, float margin, float* __restrict__ lo_out,
                             float* __restrict__ hi_out, float* __restrict__ seed_out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= cols || y >= rows) return;
  float lo = inf_f(), hi = -inf_f(), near = inf_f();
  for (int dy = -2; dy <= 2; ++dy) {
    const int yy = y + dy;
    if (yy < 0 || yy >= rows) continue;
    for (int dx = -2; dx <= 2; ++dx) {
      const int xx = x + dx;
      if (xx < 0 || xx >= cols) continue;
      const float live = __ldg(dists + static_cast<size_t>(yy) * stride * src_cols + xx * stride);
      const bool pos = live > 0.0f;
      near = fminf(near, pos ? live : inf_f());
      if (prev != nullptr) {
        const float* p = prev + 3 * (yy * cols + xx);
        const float px = __ldg(p), py = __ldg(p + 1), pz = __ldg(p + 2);
        const float t = sqrtf(px * px + py * py + pz * pz);
        const bool miss = isnan(t);
        lo = fminf(lo, fminf(miss ? inf_f() : t, pos ? live : inf_f()));
        hi = fmaxf(hi, fmaxf(miss ? -inf_f() : t, pos ? live : -inf_f()));
      }
    }
  }
  const int i = y * cols + x;
  if (prev != nullptr) {
    const bool any_hit = isfinite(lo);
    lo_out[i] = any_hit ? fmaxf(lo - margin, 0.0f) : 0.0f;
    hi_out[i] = any_hit ? hi + margin : 0.0f;
  }
  if (seed_out != nullptr) {
    const float d = dists[static_cast<size_t>(y) * stride * src_cols + x * stride];
    seed_out[i] = d > 0.0f ? d : (isfinite(near) ? near : 0.0f);
  }
}

__global__ void coarse_band_kernel(const float* __restrict__ pts, int rows_c, int cols_c, int f, float margin,
                                   float* __restrict__ lo_out, float* __restrict__ hi_out) {
  const int cols = cols_c * f;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= cols || y >= rows_c * f) return;
  const int cx = x / f, cy = y / f;
  float lo = inf_f(), hi = -inf_f();
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = cy + dy;
    if (yy < 0 || yy >= rows_c) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = cx + dx;
      if (xx < 0 || xx >= cols_c) continue;
      const float* p = pts + 3 * (yy * cols_c + xx);
      const float px = __ldg(p), py = __ldg(p + 1), pz = __ldg(p + 2);
      const float t = sqrtf(px * px + py * py + pz * pz);
      if (!isnan(t)) {  // a miss is +inf in the min and -inf in the max
        lo = fminf(lo, t);
        hi = fmaxf(hi, t);
      }
    }
  }
  const int i = y * cols + x;
  const bool any_hit = isfinite(lo);
  lo_out[i] = any_hit ? fmaxf(lo - margin, 0.0f) : 0.0f;
  hi_out[i] = any_hit ? hi + margin : 0.0f;
}

}  // namespace

extern "C" int df_coarse_band(const void* pts, int rows_c, int cols_c, int f, float margin, void* lo, void* hi,
                              void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((cols_c * f + block.x - 1) / block.x, (rows_c * f + block.y - 1) / block.y);
  if (rows_c > 0 && cols_c > 0) {
    coarse_band_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), rows_c, cols_c, f, margin, static_cast<float*>(lo), static_cast<float*>(hi));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int df_march_bands(const void* dists, int src_cols, int stride, int rows, int cols, const void* prev,
                              float margin, void* lo, void* hi, void* seed, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((cols + block.x - 1) / block.x, (rows + block.y - 1) / block.y);
  if (rows > 0 && cols > 0) {
    bands_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dists), src_cols, stride, rows, cols, static_cast<const float*>(prev), margin,
        static_cast<float*>(lo), static_cast<float*>(hi), static_cast<float*>(seed));
  }
  return static_cast<int>(cudaGetLastError());
}
