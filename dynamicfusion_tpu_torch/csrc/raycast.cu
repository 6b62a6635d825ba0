// Kernel C: per-ray TSDF march + secant refine + Newton polish.
//
// Replaces dynamicfusion_tpu/ops/tsdf.py:386 march_and_refine (secant
// branch :570-607), called by raycast :281. On the TPU every ray marches
// in lockstep (a while_loop over the whole image, finished rays masked),
// so each trip costs as much as the slowest ray.
//
// Bound on the H100: memory latency. A ray takes up to 60 dependent
// nearest-voxel int16 loads scattered through a 33.5 MB volume, then 24
// trilinear corner loads; at 160x120 rays the bytes are small (a few MB,
// mostly from L2: the volume fits the 50 MB L2), so the dependent-load
// chain of the longest rays sets the time.
// Design: one thread per ray with its own early exit, so a ray that hits
// early stops loading; int16 codes are loaded through the read-only path
// and decoded after the load. The march keeps the JAX semantics exactly:
// nearest fetch rounded half-to-even (rintf) and clipped, step doubled
// where the previous sample is > 0.99, the step cap is n_steps rounded up
// to even (the JAX loop runs two steps per trip), and the bracket, secant
// and Newton arithmetic with its 1e-12 guards follow :581-606 operation
// for operation. The normal is the unnormalized trilinear gradient.
#include "common.cuh"

namespace {

struct Vol {
  const int16_t* __restrict__ v;
  int d;
  float sc;  // decode scale, float32(1/32767)

  __device__ __forceinline__ float code(int x, int y, int z) const {
    return static_cast<float>(__ldg(v + (static_cast<size_t>(x) * d + y) * d + z));
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
};

__global__ void raycast_kernel(Vol vol, const float* __restrict__ org_p,
                               const float* __restrict__ dirs, const float* __restrict__ tmin_p,
                               const float* __restrict__ tmax_p, int n, float inv_vs, float step,
                               int max_steps, int adaptive, bool* __restrict__ found_out,
                               float* __restrict__ vertex_out, float* __restrict__ normal_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float ox = org_p[0], oy = org_p[1], oz = org_p[2];
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float tmax = tmax_p[r];
  float t = tmin_p[r];
  bool done = t >= tmax;
  bool found = false;
  float t_hit = 0.0f, dt_hit = step;
  float prev = vol.nearest((ox + dx * t) * inv_vs, (oy + dy * t) * inv_vs, (oz + dz * t) * inv_vs);
  for (int i = 0; i < max_steps && !done; ++i) {
    if (!(t < tmax)) break;  // the JAX `active` test (only NaN bounds reach it)
    const float dt = (adaptive && prev > 0.99f) ? 2.0f * step : step;
    const float tn = t + dt;
    const float next =
        vol.nearest((ox + dx * tn) * inv_vs, (oy + dy * tn) * inv_vs, (oz + dz * tn) * inv_vs);
    const bool crossing = prev > 0.0f && next < 0.0f;
    const bool behind = prev < 0.0f && next > 0.0f;
    if (crossing) {
      found = true;
      t_hit = t;
      dt_hit = dt;
    }
    t = tn;
    prev = next;
    done = crossing || behind || tn >= tmax;
  }
  found_out[r] = found;
  if (!found) {
    const float nan = __int_as_float(0x7fc00000);
#pragma unroll
    for (int a = 0; a < 3; ++a) vertex_out[3 * r + a] = normal_out[3 * r + a] = nan;
    return;
  }
  // secant between the trilinear values at the bracket ends
  const float t1 = t_hit + dt_hit;
  const float ft = vol.interp((ox + dx * t_hit) * inv_vs, (oy + dy * t_hit) * inv_vs,
                              (oz + dz * t_hit) * inv_vs);
  const float ftdt =
      vol.interp((ox + dx * t1) * inv_vs, (oy + dy * t1) * inv_vs, (oz + dz * t1) * inv_vs);
  const float denom = ftdt - ft;
  float ts = t_hit - dt_hit * ft / (fabsf(denom) > 1e-12f ? denom : 1e-12f);
  if (isnan(ft) || isnan(ftdt)) ts = t_hit;
  // Newton polish with the fused value + gradient fetch
  float grad[3];
  const float fv =
      vol.interp_grad((ox + dx * ts) * inv_vs, (oy + dy * ts) * inv_vs, (oz + dz * ts) * inv_vs, grad);
  const float dfdt = (grad[0] * dx + grad[1] * dy + grad[2] * dz) * inv_vs;
  const float ts2 = ts - fv / (fabsf(dfdt) > 1e-12f ? dfdt : 1e-12f);
  if (isfinite(ts2) && fabsf(ts2 - ts) < dt_hit && !isnan(fv)) ts = ts2;
  vertex_out[3 * r] = ox + dx * ts;
  vertex_out[3 * r + 1] = oy + dy * ts;
  vertex_out[3 * r + 2] = oz + dz * ts;
  normal_out[3 * r] = grad[0];
  normal_out[3 * r + 1] = grad[1];
  normal_out[3 * r + 2] = grad[2];
}

}  // namespace

extern "C" int df_raycast(const void* tsdf, int d, const void* ray_org, const void* dirs,
                          const void* tmin, const void* tmax, int n, float inv_vs, float step,
                          int max_steps, int adaptive, float decode_scale, void* found,
                          void* vertex, void* normal, void* stream) {
  Vol vol{static_cast<const int16_t*>(tsdf), d, decode_scale};
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    raycast_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        vol, static_cast<const float*>(ray_org), static_cast<const float*>(dirs),
        static_cast<const float*>(tmin), static_cast<const float*>(tmax), n, inv_vs, step,
        max_steps, adaptive, static_cast<bool*>(found), static_cast<float*>(vertex),
        static_cast<float*>(normal));
  }
  return static_cast<int>(cudaGetLastError());
}
