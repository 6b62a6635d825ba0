// The TSDF volume's samplers, shared by the kernels that read the volume
// at fractional voxel coordinates: nearest fetch, trilinear value,
// trilinear value + in-cell gradient, and the six-sample central
// difference. Each repeats its plain PyTorch version in ops/tsdf.py
// (fetch_nearest, interpolate, interpolate_with_gradient, _grad6)
// operation for operation. Vol<T> reads the tsdf stored as T (int16_t
// codes, float or __nv_bfloat16; common.cuh): values are loaded through
// the read-only path, turned into float32 exactly (code_value), and the
// decode scale (1/32767 for the i16 codes, 1 for the float storages) is
// applied after the load and after the trilinear sum, as the plain
// versions apply it.
#pragma once

#include "common.cuh"

namespace dfk {

// The volume, or an x-slab of it (kernel C's slab mode, the sharded
// raycast's extended slab of dynamicfusion_tpu/parallel/sharded_raycast.py:57):
// v holds dx planes of D x D codes, its first plane the global x-plane
// x_off. Every sampler clips its indices on the global [0, d-1] (or the
// cell origin on [0, d-2]) first, as on the whole volume, and only then
// the x index into the slab; the whole volume is x_off = 0, dx = d, where
// that second clip changes nothing.
template <typename T>
struct Vol {
  const T* __restrict__ v;
  int d;
  float sc;  // decode scale: float32(1/32767) for the i16 codes, 1 for the float storages
  int x_off;
  int dx;

  __device__ __forceinline__ float code(int x, int y, int z) const {
    const int xs = min(max(x - x_off, 0), dx - 1);
    return load_code(v + (static_cast<size_t>(xs) * d + y) * d + z);
  }

  __device__ __forceinline__ float nearest(float px, float py, float pz) const {
    const float hi = static_cast<float>(d - 1);
    const int x = static_cast<int>(fminf(fmaxf(rintf(px), 0.0f), hi));
    const int y = static_cast<int>(fminf(fmaxf(rintf(py), 0.0f), hi));
    const int z = static_cast<int>(fminf(fmaxf(rintf(pz), 0.0f), hi));
    return code(x, y, z) * sc;
  }

  // cell origin + fraction; false when the cell leaves [0, d-1)
  __device__ __forceinline__ bool cell(float px, float py, float pz, int g[3], float f[3]) const {
    const float p[3] = {px, py, pz};
    bool oob = false;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float fl = floorf(p[a]);
      f[a] = p[a] - fl;
      oob = oob || !(fl >= 0.0f) || fl >= static_cast<float>(d - 1);
      g[a] = static_cast<int>(fminf(fmaxf(fl, 0.0f), static_cast<float>(d - 2)));
    }
    return !oob;
  }

  // trilinear value, NaN outside (tsdf.py:55 interpolate)
  __device__ float interp(float px, float py, float pz) const {
    int g[3];
    float f[3];
    const bool in = cell(px, py, pz, g, f);
    float out = 0.0f;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float wx = dx ? f[0] : (1.0f - f[0]);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float wy = dy ? f[1] : (1.0f - f[1]);
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {
          const float wz = dz ? f[2] : (1.0f - f[2]);
          out = out + code(g[0] + dx, g[1] + dy, g[2] + dz) * (wx * wy * wz);
        }
      }
    }
    out = out * sc;
    return in ? out : __int_as_float(0x7fc00000);
  }

  // trilinear value and in-cell gradient from one set of corners
  // (tsdf.py:88 interpolate_with_gradient)
  __device__ float interp_grad(float px, float py, float pz, float grad[3]) const {
    int g[3];
    float f[3];
    const bool in = cell(px, py, pz, g, f);
    float c[2][2][2];
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) c[dx][dy][dz] = code(g[0] + dx, g[1] + dy, g[2] + dz);
    const float wa0 = 1.0f - f[0], wa1 = f[0];
    const float wb0 = 1.0f - f[1], wb1 = f[1];
    const float wc0 = 1.0f - f[2], wc1 = f[2];
    const float val =
        wa0 * (wb0 * (wc0 * c[0][0][0] + wc1 * c[0][0][1]) + wb1 * (wc0 * c[0][1][0] + wc1 * c[0][1][1])) +
        wa1 * (wb0 * (wc0 * c[1][0][0] + wc1 * c[1][0][1]) + wb1 * (wc0 * c[1][1][0] + wc1 * c[1][1][1]));
    const float gx =
        wb0 * (wc0 * (c[1][0][0] - c[0][0][0]) + wc1 * (c[1][0][1] - c[0][0][1])) +
        wb1 * (wc0 * (c[1][1][0] - c[0][1][0]) + wc1 * (c[1][1][1] - c[0][1][1]));
    const float gy =
        wa0 * (wc0 * (c[0][1][0] - c[0][0][0]) + wc1 * (c[0][1][1] - c[0][0][1])) +
        wa1 * (wc0 * (c[1][1][0] - c[1][0][0]) + wc1 * (c[1][1][1] - c[1][0][1]));
    const float gz =
        wa0 * (wb0 * (c[0][0][1] - c[0][0][0]) + wb1 * (c[0][1][1] - c[0][1][0])) +
        wa1 * (wb0 * (c[1][0][1] - c[1][0][0]) + wb1 * (c[1][1][1] - c[1][1][0]));
    const float nanv = in ? 0.0f : __int_as_float(0x7fc00000);
    grad[0] = gx * sc + nanv;
    grad[1] = gy * sc + nanv;
    grad[2] = gz * sc + nanv;
    return val * sc + nanv;
  }

  // six-sample central difference at +-delta voxels per axis, each sample
  // trilinear (NaN outside): the reference's normal (tsdf_volume.cu:408-426),
  // dynamicfusion_tpu/ops/tsdf.py:610 _grad6 and :340 gradient (the one
  // extract_normals takes at a point list)
  __device__ void grad6(float px, float py, float pz, float delta, float g[3]) const {
    g[0] = interp(px + delta, py, pz) - interp(px - delta, py, pz);
    g[1] = interp(px, py + delta, pz) - interp(px, py - delta, pz);
    g[2] = interp(px, py, pz + delta) - interp(px, py, pz - delta);
  }
};

}  // namespace dfk
