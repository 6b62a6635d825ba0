// Kernel R: the normals of an extracted point list.
//
// Replaces dynamicfusion_tpu/ops/tsdf.py:724 extract_normals (with :152
// gradient): at each world-frame point, the six-sample central difference
// of the trilinear TSDF at +-gradient_delta_factor voxels along each axis,
// divided by max(|g|, 1e-12). The demo asks for it at extract_cloud's
// 1 << 20 rows (kernel L's output), most of them the NaN tail past the
// crossing count.
//
// Bound on the H100 (3.35 TB/s; measured times in PERF.md): bytes. Each
// row reads 12 B and writes 12 B (25 MB at 1 << 20 rows, ~0.0075 ms); a
// valid row gathers 48 stored values (six samples of 8 corners; 2 B each
// for the i16 and bf16 tsdf, 4 B for f32), which neighbouring surface
// points share, so they come mostly from L1/L2.
// Design: one thread a row. A NaN row writes NaN normals and loads nothing,
// so the tail costs its 24 bytes; a row with a sample outside the volume
// gets NaN in all three components, as the plain version. The six samples are dfk::Vol::grad6
// (volume.cuh, the samplers of kernel C's six-sample normal), instantiated
// for the tsdf storage that the storage code names. The norm's
// sum of squares is the JAX package's: XLA takes jnp.linalg.norm as
// fma(gz, gz, fma(gy, gy, gx gx)), written here with explicit fused
// multiply-adds (-fmad=false contracts nothing else); the division is a
// true one. The normals are bit-equal to the plain version
// (ops/tsdf.py extract_normals_plain).
#include "volume.cuh"

namespace {

using dfk::Vol;

template <typename T>
__global__ void normals_kernel(Vol<T> vol, const float* __restrict__ pts, int n, float ox, float oy, float oz,
                               float vs, float delta, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = pts[3 * i + 0], py = pts[3 * i + 1], pz = pts[3 * i + 2];
  if (isnan(px) || isnan(py) || isnan(pz)) {
    const float nan = __int_as_float(0x7fc00000);
    out[3 * i + 0] = nan;
    out[3 * i + 1] = nan;
    out[3 * i + 2] = nan;
    return;
  }
  float g[3];
  vol.grad6((px - ox) / vs, (py - oy) / vs, (pz - oz) / vs, delta, g);
  const float norm = sqrtf(__fmaf_rn(g[2], g[2], __fmaf_rn(g[1], g[1], g[0] * g[0])));
  // max(norm, 1e-12) with a NaN norm kept NaN, as torch.clamp and
  // jnp.maximum keep it (fmaxf would return 1e-12 where one axis's sample
  // left the volume, and the other two components would stay finite)
  const float den = norm < 1e-12f ? 1e-12f : norm;
  out[3 * i + 0] = g[0] / den;
  out[3 * i + 1] = g[1] / den;
  out[3 * i + 2] = g[2] / den;
}

}  // namespace

extern "C" int df_extract_normals(const void* tsdf, int storage, int d, float decode_scale, const void* pts, int n, float ox,
                                  float oy, float oz, float vs, float delta, void* out, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  return dfk::dispatch_tsdf(storage, [&](auto tt) {
    using T = typename decltype(tt)::type;
    const Vol<T> vol{static_cast<const T*>(tsdf), d, decode_scale, 0, d};
    normals_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        vol, static_cast<const float*>(pts), n, ox, oy, oz, vs, delta, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
  });
}
