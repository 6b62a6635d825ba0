// Kernel C: per-ray TSDF march + refine (secant + Newton polish, newton8,
// newton16 or hybrid16), with the in-cell or the six-sample normal.
//
// Replaces dynamicfusion_tpu/ops/tsdf.py:386 march_and_refine, called by
// raycast :281: the secant branch :570-607 (refine 0), the newton8 and
// newton16 branch :529-569 (refine 1, the dynamicfusion preset's, and
// refine 2), the hybrid16 branch :475-528 (refine 3), and the six-sample
// normal _grad6 :610 of raycast_smooth_normals (:526, :567, :590). On the
// TPU every ray marches in lockstep (a while_loop over the whole image,
// finished rays masked), so each trip costs as much as the slowest ray.
//
// Bound on the H100: memory latency. A ray takes up to 60 dependent
// nearest-voxel loads (2 B for the i16 and bf16 tsdf, 4 B for f32)
// scattered through a 33.5 MB volume (67 MB as f32; 256^3), then the
// refine's trilinear corner loads (24 for secant: two values and one fused
// value + gradient; 8 for newton8; 16 for newton16 and hybrid16: two fused
// fetches; the six-sample normal adds 48, and under it the secant drops its
// fused fetch); at 160x120 rays the bytes are small (a few MB, mostly from
// L2: the volume fits the 50 MB L2), so the dependent-load chain of the
// longest rays sets the time.
// Design: one thread per ray with its own early exit, so a ray that hits
// early stops loading; the stored values are loaded through the read-only
// path and decoded after the load (dfk::Vol, volume.cuh). The kernel is
// instantiated for each tsdf storage (i16 codes, f32, bf16; the storage
// code of df_raycast picks one), with one body: a float storage decodes
// by 1, so its samples are the plain version's bit for bit. The march keeps the
// JAX semantics exactly: nearest fetch rounded half-to-even (rintf) and
// clipped, step doubled where the previous sample is > 0.99, the step cap
// is n_steps rounded up to even (the JAX loop runs two steps per trip).
// The march keeps the nearest-fetched bracket values f0/f1 of the crossing
// in registers for the Newton and hybrid refines. Each refine follows its
// JAX branch operation for operation, with the same 1e-12 / 1e-6 guards:
// newton8/newton16 the clipped secant alpha of f0/f1, then one or two
// fused fetches each with a clamped Newton step (the normal is the
// gradient of the last fetch, at that step's start point); hybrid16 the
// fused fetch at the clipped alpha point, the march-slope step clipped to
// +-dt, the second fused fetch, the two-point secant slope (the march
// slope where the two points coincide), the local gradient where it is
// healthy, and the clamped update; secant the trilinear secant of the
// bracket ends and one Newton polish. The refine code and the normal mode
// are runtime arguments: they branch once a ray, after the march loop, so
// the loop compiles as before. With the six-sample normal the normal is
// taken at the final vertex, and the secant refine keeps its secant point
// (no polish), as in JAX.
//
// Slab mode (the sharded raycast, dynamicfusion_tpu/parallel/
// sharded_raycast.py:57-127 and :176-260, with the core's extra outputs of
// ops/tsdf.py:386-470): the volume is one shard's extended x-slab (its
// D/n planes and a halo each side, the first plane the global plane
// x_off), every fetch clipped globally first and then into the slab
// (dfk::Vol); the march is fixed-step inside each ray's slab window
// (tmin/tmax, snapped to the global step grid by the caller), and the
// kernel also writes the refined ray distance ts (NaN where nothing was
// found) and the bracket start of the first exit-geometry event t_behind
// (+inf where none), which decide which shard owns a crossing. The work is
// the whole-volume march's, cut into n windows: each shard's launch reads
// only its slab, about 1/n of each ray's samples.
#include "volume.cuh"

namespace {

using dfk::Vol;

template <typename T>
__global__ void raycast_kernel(Vol<T> vol, const float* __restrict__ org_p,
                               const float* __restrict__ dirs, const float* __restrict__ tmin_p,
                               const float* __restrict__ tmax_p, int n, float inv_vs, float step,
                               int max_steps, int adaptive, int refine, int smooth, float delta,
                               bool* __restrict__ found_out, float* __restrict__ vertex_out,
                               float* __restrict__ normal_out, float* __restrict__ ts_out,
                               float* __restrict__ behind_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float ox = org_p[0], oy = org_p[1], oz = org_p[2];
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float tmax = tmax_p[r];
  float t = tmin_p[r];
  bool done = t >= tmax;
  bool found = false;
  float t_hit = 0.0f, dt_hit = step;
  float f0 = 1.0f, f1 = -1.0f;  // nearest-fetched bracket values
  float t_behind = __int_as_float(0x7f800000);
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
      f0 = prev;
      f1 = next;
    }
    if (behind) t_behind = t;
    t = tn;
    prev = next;
    done = crossing || behind || tn >= tmax;
  }
  found_out[r] = found;
  if (behind_out != nullptr) behind_out[r] = t_behind;
  if (!found) {
    const float nan = __int_as_float(0x7fc00000);
#pragma unroll
    for (int a = 0; a < 3; ++a) vertex_out[3 * r + a] = normal_out[3 * r + a] = nan;
    if (ts_out != nullptr) ts_out[r] = nan;
    return;
  }
  float ts;
  float grad[3];
  if (refine == 1 || refine == 2) {
    // newton8 / newton16: the secant of the nearest-fetched bracket values,
    // clipped, then one (two) fused fetch(es) with a clamped Newton step
    const float denom0 = f0 - f1;
    const float alpha = fminf(fmaxf(f0 / (fabsf(denom0) > 1e-12f ? denom0 : 1e-12f), 0.0f), 1.0f);
    ts = t_hit + dt_hit * alpha;
    for (int it = 0; it < refine; ++it) {
      const float fv = vol.interp_grad((ox + dx * ts) * inv_vs, (oy + dy * ts) * inv_vs,
                                       (oz + dz * ts) * inv_vs, grad);
      const float dfdt = (grad[0] * dx + grad[1] * dy + grad[2] * dz) * inv_vs;
      const float ts2 = ts - fv / (fabsf(dfdt) > 1e-12f ? dfdt : 1e-12f);
      if (isfinite(ts2) && fabsf(ts2 - ts) < dt_hit && !isnan(fv)) ts = ts2;
    }
  } else if (refine == 3) {
    // hybrid16: two fused fetches anchored on exact trilinear values
    const float slope_march = fminf((f1 - f0) / dt_hit, -1e-6f);
    const float d0 = f0 - f1;
    const float alpha0 = fminf(fmaxf(f0 / (fabsf(d0) > 1e-12f ? d0 : 1e-12f), 0.0f), 1.0f);
    const float t_m = t_hit + dt_hit * alpha0;
    float gm[3];
    const float f_m = vol.interp_grad((ox + dx * t_m) * inv_vs, (oy + dy * t_m) * inv_vs,
                                      (oz + dz * t_m) * inv_vs, gm);
    const float f_m0 = isnan(f_m) ? 0.0f : f_m;
    const float d1 = fminf(fmaxf(-f_m0 / slope_march, -dt_hit), dt_hit);
    const float t_c = t_m + d1;
    const float f_c = vol.interp_grad((ox + dx * t_c) * inv_vs, (oy + dy * t_c) * inv_vs,
                                      (oz + dz * t_c) * inv_vs, grad);
    const float f_c0 = isnan(f_c) ? 0.0f : f_c;
    const float dt_sec = t_c - t_m;
    float slope_sec = fabsf(dt_sec) > 1e-6f * dt_hit ? (f_c0 - f_m0) / dt_sec : slope_march;
    slope_sec = fminf(slope_sec, -1e-6f);
    const float dfdt = (grad[0] * dx + grad[1] * dy + grad[2] * dz) * inv_vs;
    const bool use_local = fabsf(dfdt) > 0.25f * fabsf(slope_sec);
    const float denom = (use_local && dfdt < -1e-12f) ? dfdt : slope_sec;
    const float ts2 = t_c - f_c0 / denom;
    ts = (isfinite(ts2) && fabsf(ts2 - t_c) < dt_hit && !isnan(f_c)) ? ts2 : t_c;
  } else {
    // secant between the trilinear values at the bracket ends
    const float t1 = t_hit + dt_hit;
    const float ft = vol.interp((ox + dx * t_hit) * inv_vs, (oy + dy * t_hit) * inv_vs,
                                (oz + dz * t_hit) * inv_vs);
    const float ftdt =
        vol.interp((ox + dx * t1) * inv_vs, (oy + dy * t1) * inv_vs, (oz + dz * t1) * inv_vs);
    const float denom = ftdt - ft;
    ts = t_hit - dt_hit * ft / (fabsf(denom) > 1e-12f ? denom : 1e-12f);
    if (isnan(ft) || isnan(ftdt)) ts = t_hit;
    if (!smooth) {
      // one clamped Newton polish with the fused value + gradient fetch
      const float fv = vol.interp_grad((ox + dx * ts) * inv_vs, (oy + dy * ts) * inv_vs,
                                       (oz + dz * ts) * inv_vs, grad);
      const float dfdt = (grad[0] * dx + grad[1] * dy + grad[2] * dz) * inv_vs;
      const float ts2 = ts - fv / (fabsf(dfdt) > 1e-12f ? dfdt : 1e-12f);
      if (isfinite(ts2) && fabsf(ts2 - ts) < dt_hit && !isnan(fv)) ts = ts2;
    }
  }
  if (ts_out != nullptr) ts_out[r] = ts;
  const float vx = ox + dx * ts, vy = oy + dy * ts, vz = oz + dz * ts;
  if (smooth) vol.grad6(vx * inv_vs, vy * inv_vs, vz * inv_vs, delta, grad);
  vertex_out[3 * r] = vx;
  vertex_out[3 * r + 1] = vy;
  vertex_out[3 * r + 2] = vz;
  normal_out[3 * r] = grad[0];
  normal_out[3 * r + 1] = grad[1];
  normal_out[3 * r + 2] = grad[2];
}

}  // namespace

// tsdf holds dx planes of d x d values from the global plane x_off (the
// whole volume: x_off 0, dx d), stored as the storage code says
// (common.cuh; the weight code is ignored); ts and t_behind may be null
extern "C" int df_raycast(const void* tsdf, int storage, int d, int x_off, int dx, const void* ray_org, const void* dirs,
                          const void* tmin, const void* tmax, int n, float inv_vs, float step,
                          int max_steps, int adaptive, int refine, int smooth, float delta,
                          float decode_scale, void* found, void* vertex, void* normal, void* ts,
                          void* t_behind, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  return dfk::dispatch_tsdf(storage, [&](auto tt) {
    using T = typename decltype(tt)::type;
    if (blocks > 0) {
      const Vol<T> vol{static_cast<const T*>(tsdf), d, decode_scale, x_off, dx};
      raycast_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          vol, static_cast<const float*>(ray_org), static_cast<const float*>(dirs),
          static_cast<const float*>(tmin), static_cast<const float*>(tmax), n, inv_vs, step,
          max_steps, adaptive, refine, smooth, delta, static_cast<bool*>(found),
          static_cast<float*>(vertex), static_cast<float*>(normal), static_cast<float*>(ts),
          static_cast<float*>(t_behind));
    }
    return static_cast<int>(cudaGetLastError());
  });
}
