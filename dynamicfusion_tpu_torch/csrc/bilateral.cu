// Kernel A: 7x7 bilateral filter on uint16 millimetre depth.
//
// Replaces dynamicfusion_tpu/ops/preprocess.py:43 bilateral_filter (49
// shifted whole-image passes that XLA fuses on the TPU).
//
// Bound on the H100: operations, not bytes. The frame is 640x480 uint16
// (0.6 MB in, 0.6 MB out), but every pixel takes 49 taps, each an expf
// and a handful of multiply-adds (~15 M expf a frame); the window's
// neighbours come from L1/L2, not from device memory.
// Design: one thread per pixel in 32x8 blocks, so a warp reads a row of
// 32 consecutive pixels and the window's rows are shared through L1. The
// window is clamped to the image exactly as the JAX mask clamps it (a
// neighbour outside contributes nothing), expf is the full-precision
// libdevice one (no fast math), the spatial term is formed in double and
// rounded once (as the JAX Python-float constant is), and the result is
// rounded half-to-even with rintf.
#include "common.cuh"

namespace {

__global__ void bilateral_kernel(const uint16_t* __restrict__ in, uint16_t* __restrict__ out,
                                 int rows, int cols, int half, double inv_sp, float inv_sd) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= cols || y >= rows) return;
  const float d = static_cast<float>(in[y * cols + x]);
  float num = 0.0f;
  float den = 0.0f;
  for (int dy = -half; dy <= half; ++dy) {
    const int yy = y + dy;
    for (int dx = -half; dx <= half; ++dx) {
      const int xx = x + dx;
      if (yy < 0 || yy >= rows || xx < 0 || xx >= cols) continue;
      const float nbr = static_cast<float>(__ldg(in + yy * cols + xx));
      const float space = static_cast<float>(static_cast<double>(dy * dy + dx * dx) * inv_sp);
      const float diff = d - nbr;
      const float w = expf(-(space + diff * diff * inv_sd));
      num = num + nbr * w;
      den = den + w;
    }
  }
  out[y * cols + x] = static_cast<uint16_t>(rintf(num / fmaxf(den, 1e-12f)));
}

}  // namespace

extern "C" int df_bilateral(const void* in, void* out, int rows, int cols, int half,
                            double inv_sp, float inv_sd, void* stream) {
  dim3 block(32, 8);
  dim3 grid((cols + block.x - 1) / block.x, (rows + block.y - 1) / block.y);
  bilateral_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(in), static_cast<uint16_t*>(out), rows, cols, half, inv_sp,
      inv_sd);
  return static_cast<int>(cudaGetLastError());
}
