// Kernel M: the adaptive aperture gate of the tangential data term.
//
// Replaces dynamicfusion_tpu/pipeline/kinfu.py:205 _p2p_gate (with :198
// _box_sum), reached through solver_p2p_adaptive (kinfu.py:540-556). Per
// pixel of the model-map grid (160x120 at full width): 11 features
// [S, nx², ny², nz², nxny, nxnz, nynz, nx b, ny b, nz b, b²] of the live
// normal n and the apparent motion b = n . (live - previous model), summed
// over a w x w window (w = 41) restricted to the pixel's depth bin and the
// bins beside it (16 bins of 0.1 m from 0.3 m), then the closed-form
// regularised 3x3 det and adjugate solve and the two clipped ratios. On the
// TPU the bins are a one-hot reshape to 176 channels box-summed by two
// reduce_window passes; the port's plain version sums the same 176
// channels tap by tap.
//
// Bound on the H100: bytes, and at 160x120 launch latency. The inputs are
// 19 200 x (3 points + 3 normals + 3 model points + depth) floats (0.8 MB);
// the 16 x 11 horizontal sums are 13.5 MB written once and read once
// (27 MB, ~8 us at 3.35 TB/s, and they stay in the 50 MB L2); the output
// is the 160x120 gate and its bins. The arithmetic is ~176 x 41 adds a
// pixel each way.
// Design, two launches:
// 1. one block per image row computes the row's features and depth bins
//    once into shared memory (12 floats a pixel) and writes the horizontal
//    window sums of every (bin, channel), laid out [bin][channel][row][col]
//    so that a warp writes and later reads consecutive columns. A pixel
//    only feeds its own bin, so a sum of (bin, channel) adds the taps of
//    that bin and skips the rest: the skipped taps are the plain version's
//    exact zeros, and a sum that starts from +0 never becomes -0, so
//    skipping them rounds alike.
// 2. one thread per pixel sums its three bins' vertical taps channel by
//    channel and runs the closed form. It writes the gate directly.
// Every sum runs tap by tap from zero in image order (the plain version's
// order: along the row first, then down the column), the closed form
// follows the plain version operation for operation under -fmad=false with
// true divisions, and the clips propagate NaN as torch.clamp does: the
// gate and the bins equal the plain version's bit for bit.
#include "common.cuh"

namespace {

constexpr int kBins = 16;
constexpr int kCh = 11;
constexpr int kThreads = 256;

__device__ __forceinline__ bool finite3(float a, float b, float c) {
  return isfinite(a) && isfinite(b) && isfinite(c);
}

// torch.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX
__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? 3.402823466e38f : -3.402823466e38f;
  return x;
}

// torch.clamp(x, lo, hi), NaN propagating
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float max_nan(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

struct GateArgs {
  const float* live;   // (rows, cols, 3) live points, world frame
  const float* nrm;    // (rows, cols, 3) live normals, world frame
  const float* prev;   // (rows, cols, 3) previous model map, world frame
  const float* cam_z;  // (rows, cols) live camera-frame depth
  int rows, cols, lo, hi;  // window taps [x - lo, x + hi]
  float z_lo, bin_w;
};

__global__ void __launch_bounds__(kThreads)
gate_rows_kernel(GateArgs a, int* __restrict__ bins, float* __restrict__ hsum) {
  extern __shared__ float sm[];
  float* feat = sm;                                              // [cols][kCh]
  int* sbin = reinterpret_cast<int*>(sm + static_cast<size_t>(a.cols) * kCh);  // [cols]
  const int y = blockIdx.x;
  for (int x = threadIdx.x; x < a.cols; x += blockDim.x) {
    const int i = y * a.cols + x;
    const float dx = a.live[3 * i] - a.prev[3 * i];
    const float dy = a.live[3 * i + 1] - a.prev[3 * i + 1];
    const float dz = a.live[3 * i + 2] - a.prev[3 * i + 2];
    const float n0 = a.nrm[3 * i], n1 = a.nrm[3 * i + 1], n2 = a.nrm[3 * i + 2];
    const bool valid = finite3(dx, dy, dz) && finite3(n0, n1, n2);
    const float nx = valid ? nan_to_num(n0) : 0.0f;
    const float ny = valid ? nan_to_num(n1) : 0.0f;
    const float nz = valid ? nan_to_num(n2) : 0.0f;
    const float b = valid ? nx * nan_to_num(dx) + ny * nan_to_num(dy) + nz * nan_to_num(dz) : 0.0f;
    float* f = feat + x * kCh;
    f[0] = valid ? 1.0f : 0.0f;
    f[1] = nx * nx;
    f[2] = ny * ny;
    f[3] = nz * nz;
    f[4] = nx * ny;
    f[5] = nx * nz;
    f[6] = ny * nz;
    f[7] = nx * b;
    f[8] = ny * b;
    f[9] = nz * b;
    f[10] = b * b;
    const float cz = a.cam_z[i];
    const float z = isnan(cz) ? -1.0f : cz;
    const int zb = static_cast<int>(fminf(fmaxf(floorf((z - a.z_lo) / a.bin_w), 0.0f), static_cast<float>(kBins - 1)));
    bins[i] = zb;
    // an invalid pixel's one-hot row is zero: it feeds no bin
    sbin[x] = valid ? zb : -1;
  }
  __syncthreads();
  const int per_row = kBins * kCh * a.cols;
  for (int o = threadIdx.x; o < per_row; o += blockDim.x) {
    const int x = o % a.cols;
    const int bc = o / a.cols;  // bin * kCh + channel
    const int bin = bc / kCh, c = bc % kCh;
    float s = 0.0f;
    const int x0 = max(x - a.lo, 0), x1 = min(x + a.hi, a.cols - 1);
    for (int xx = x0; xx <= x1; ++xx) {
      if (sbin[xx] == bin) s = s + feat[xx * kCh + c];
    }
    hsum[(static_cast<size_t>(bc) * a.rows + y) * a.cols + x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
gate_pixels_kernel(GateArgs a, const int* __restrict__ bins, const float* __restrict__ hsum, float reg_scale,
                   float cond0, float fit0, float fit_den, float gain, float min_count, float* __restrict__ gate) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.rows * a.cols) return;
  const int y = i / a.cols, x = i % a.cols;
  const int zb = bins[i];
  const int y0 = max(y - a.lo, 0), y1 = min(y + a.hi, a.rows - 1);
  float s[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) s[c] = 0.0f;
  // gather(zb - 1) + gather(zb) + gather(zb + 1); a bin past either end adds 0
  for (int k = 0; k < 3; ++k) {
    const int bin = zb - 1 + k;
    if (bin < 0 || bin >= kBins) continue;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const float* col = hsum + (static_cast<size_t>(bin * kCh + c) * a.rows) * a.cols + x;
      float v = 0.0f;
      for (int yy = y0; yy <= y1; ++yy) v = v + __ldg(col + static_cast<size_t>(yy) * a.cols);
      s[c] = s[c] + v;
    }
  }
  const float cnt = s[0];
  const float g1 = s[7], g2 = s[8], g3 = s[9], bb = s[10];
  const float cnt1 = max_nan(cnt, 1.0f);
  const float reg = reg_scale * cnt1;
  const float a11 = s[1] + reg, a22 = s[2] + reg, a33 = s[3] + reg;
  const float a12 = s[4], a13 = s[5], a23 = s[6];
  const float c11 = a22 * a33 - a23 * a23;
  const float c12 = a13 * a23 - a12 * a33;
  const float c13 = a12 * a23 - a13 * a22;
  const float c22 = a11 * a33 - a13 * a13;
  const float c23 = a12 * a13 - a11 * a23;
  const float c33 = a11 * a22 - a12 * a12;
  const float det_r = a11 * c11 + a12 * c12 + a13 * c13;
  const float inv_det = 1.0f / max_nan(det_r, 1e-30f);
  const float t1 = (c11 * g1 + c12 * g2 + c13 * g3) * inv_det;
  const float t2 = (c12 * g1 + c22 * g2 + c23 * g3) * inv_det;
  const float t3 = (c13 * g1 + c23 * g2 + c33 * g3) * inv_det;
  const float expl = (t1 * g1 + t2 * g2 + t3 * g3) / max_nan(bb, 1e-12f);
  const float b11 = s[1], b22 = s[2], b33 = s[3];
  const float cond = (b11 * (b22 * b33 - a23 * a23) + a12 * (a13 * a23 - a12 * b33) + a13 * (a12 * a23 - a13 * b22)) /
                     (cnt1 * cnt1 * cnt1);
  const float gate_cond = clamp_nan(cond / cond0, 0.0f, 1.0f);
  const float gate_fit = clamp_nan((expl - fit0) / fit_den, 0.0f, 1.0f);
  const float g = clamp_nan(gain * gate_cond * gate_fit, 0.0f, 1.0f);
  gate[i] = cnt > min_count ? g : 0.0f;
}

}  // namespace

// n_bins and n_ch are the caller's layout of hsum ([n_bins][n_ch][rows][cols]);
// they must equal the kernel's own.
extern "C" int df_p2p_gate(const void* live, const void* nrm, const void* prev, const void* cam_z, int rows,
                           int cols, int lo, int hi, int n_bins, int n_ch, float z_lo, float bin_w,
                           float reg_scale, float cond0, float fit0, float fit_den, float gain, float min_count,
                           void* bins, void* hsum, void* gate, void* stream) {
  if (n_bins != kBins || n_ch != kCh) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || cols <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GateArgs a{static_cast<const float*>(live), static_cast<const float*>(nrm), static_cast<const float*>(prev),
             static_cast<const float*>(cam_z), rows, cols, lo, hi, z_lo, bin_w};
  const size_t smem = static_cast<size_t>(cols) * (kCh + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gate_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gate_rows_kernel<<<rows, kThreads, smem, s>>>(a, static_cast<int*>(bins), static_cast<float*>(hsum));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = rows * cols;
  gate_pixels_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      a, static_cast<const int*>(bins), static_cast<const float*>(hsum), reg_scale, cond0, fit0, fit_den, gain,
      min_count, static_cast<float*>(gate));
  return static_cast<int>(cudaGetLastError());
}
