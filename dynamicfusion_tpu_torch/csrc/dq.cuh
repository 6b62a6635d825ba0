// Quaternion and dual-quaternion helpers of kernels E, F, G and H (and
// the closed-form Jacobians of F and G).
//
// Each function repeats its plain PyTorch counterpart in
// dynamicfusion_tpu_torch/core/quat.py and core/dualquat.py operation for
// operation (same association of every sum, divisions as divisions), so
// that with -fmad=false a kernel and its plain version round alike.
// Quaternions are (w, x, y, z); a dual quaternion is real then dual.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace dfk {

struct Quat {
  float w, x, y, z;
};

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? FLT_MAX : -FLT_MAX;
  return v;
}

__device__ __forceinline__ float sum4(float a, float b, float c, float d) { return ((a + b) + c) + d; }

__device__ __forceinline__ float dot4(Quat a, Quat b) {
  return sum4(a.w * b.w, a.x * b.x, a.y * b.y, a.z * b.z);
}

__device__ __forceinline__ float dot3(Vec3 a, Vec3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }

__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ Quat qmul(Quat p, Quat q) {
  return {p.w * q.w - p.x * q.x - p.y * q.y - p.z * q.z,
          p.w * q.x + p.x * q.w + p.y * q.z - p.z * q.y,
          p.w * q.y - p.x * q.z + p.y * q.w + p.z * q.x,
          p.w * q.z + p.x * q.y - p.y * q.x + p.z * q.w};
}

__device__ __forceinline__ Quat qconj(Quat q) { return {q.w, -q.x, -q.y, -q.z}; }

__device__ __forceinline__ Quat qscale(Quat q, float s) { return {q.w * s, q.x * s, q.y * s, q.z * s}; }

__device__ __forceinline__ Quat qdiv(Quat q, float s) { return {q.w / s, q.x / s, q.y / s, q.z / s}; }

__device__ __forceinline__ Quat qsub(Quat a, Quat b) { return {a.w - b.w, a.x - b.x, a.y - b.y, a.z - b.z}; }

__device__ __forceinline__ Quat qadd(Quat a, Quat b) { return {a.w + b.w, a.x + b.x, a.y + b.y, a.z + b.z}; }

// q / |q|, unchanged where |q|^2 < 1e-12 (quat.normalize)
__device__ __forceinline__ Quat qnormalize(Quat q) {
  const float n2 = dot4(q, q);
  return qdiv(q, sqrtf(n2 < 1e-12f ? 1.0f : n2));
}

// v + 2 u x (u x v + w v) (quat.rotate)
__device__ __forceinline__ Vec3 qrotate(Quat q, Vec3 v) {
  const Vec3 u = {q.x, q.y, q.z};
  const Vec3 uv = cross(u, v);
  const Vec3 t = {uv.x + q.w * v.x, uv.y + q.w * v.y, uv.z + q.w * v.z};
  const Vec3 c = cross(u, t);
  return {v.x + 2.0f * c.x, v.y + 2.0f * c.y, v.z + 2.0f * c.z};
}

struct DualQuat {
  Quat r, d;
};

__device__ __forceinline__ DualQuat load_dq(const float* p) {
  return {{p[0], p[1], p[2], p[3]}, {p[4], p[5], p[6], p[7]}};
}

__device__ __forceinline__ void store_dq(float* p, DualQuat a) {
  p[0] = a.r.w; p[1] = a.r.x; p[2] = a.r.y; p[3] = a.r.z;
  p[4] = a.d.w; p[5] = a.d.x; p[6] = a.d.y; p[7] = a.d.z;
}

// 2 vec(dual ⊗ conj(normalize(real))) (dualquat.translation)
__device__ __forceinline__ Vec3 dq_translation(DualQuat a) {
  const Quat m = qmul(a.d, qconj(qnormalize(a.r)));
  return {2.0f * m.x, 2.0f * m.y, 2.0f * m.z};
}

__device__ __forceinline__ Vec3 dq_transform(DualQuat a, Vec3 p) {
  const Vec3 r = qrotate(qnormalize(a.r), p);
  const Vec3 t = dq_translation(a);
  return {r.x + t.x, r.y + t.y, r.z + t.z};
}

__device__ __forceinline__ Vec3 dq_rotate(DualQuat a, Vec3 v) { return qrotate(qnormalize(a.r), v); }

// dualquat.normalize: divide by |real| (guarded), remove the real·dual part
__device__ __forceinline__ DualQuat dq_normalize(DualQuat b) {
  const float n2 = dot4(b.r, b.r);
  const float n = sqrtf(n2 < 1e-12f ? 1.0f : n2);
  const Quat r = qdiv(b.r, n);
  const Quat d0 = qdiv(b.d, n);
  return {r, qsub(d0, qscale(r, dot4(r, d0)))};
}

// dualquat.blend_signs: sign of real·pivot real, 0 counted as +1
__device__ __forceinline__ float blend_sign(Quat r, Quat pivot) {
  const float s = dot4(r, pivot);
  return s > 0.0f ? 1.0f : (s < 0.0f ? -1.0f : 1.0f);
}

// accumulate (w * dq) * s into acc, one component at a time
__device__ __forceinline__ void blend_add(DualQuat& acc, DualQuat a, float w, float s, bool first) {
  const float t[8] = {w * a.r.w * s, w * a.r.x * s, w * a.r.y * s, w * a.r.z * s,
                      w * a.d.w * s, w * a.d.x * s, w * a.d.y * s, w * a.d.z * s};
  if (first) {
    acc = {{t[0], t[1], t[2], t[3]}, {t[4], t[5], t[6], t[7]}};
  } else {
    acc = {{acc.r.w + t[0], acc.r.x + t[1], acc.r.y + t[2], acc.r.z + t[3]},
           {acc.d.w + t[4], acc.d.x + t[5], acc.d.y + t[6], acc.d.z + t[7]}};
  }
}

// e_i ⊗ q for the pure unit quaternion e_i = (0, unit axis i)
__device__ __forceinline__ Quat pure_mul(int i, Quat q) {
  if (i == 0) return {-q.x, q.w, -q.z, q.y};
  if (i == 1) return {-q.y, q.z, q.w, -q.x};
  return {-q.z, -q.y, q.x, q.w};
}

// Gradient of n · y, y = rotate(r'', v) + 2 vec(d ⊗ conj(r'')) with
// r'' = normalize(r) (guarded), with respect to r (gr) and d (gd): the
// derivative of dualquat.transform at (r, d), taken literally.
__device__ __forceinline__ void grad_transform(Quat rin, Quat d, Vec3 v, Vec3 n, Quat& gr, Quat& gd) {
  const float n2 = dot4(rin, rin);
  const bool small = n2 < 1e-12f;
  const float s = sqrtf(small ? 1.0f : n2);
  const Quat r = qdiv(rin, s);
  const float w = r.w;
  const Vec3 u = {r.x, r.y, r.z};
  const Vec3 dv = {d.x, d.y, d.z};
  const float uv = dot3(u, v), nu = dot3(n, u), nv = dot3(n, v);
  const Vec3 uxv = cross(u, v), nxv = cross(n, v), nxdv = cross(n, dv), nxu = cross(n, u);
  const float gw = 2.0f * dot3(n, uxv) + 2.0f * dot3(n, dv);
  const Vec3 gu = {
      2.0f * (uv * n.x + nu * v.x - 2.0f * nv * u.x) - 2.0f * w * nxv.x - 2.0f * d.w * n.x - 2.0f * nxdv.x,
      2.0f * (uv * n.y + nu * v.y - 2.0f * nv * u.y) - 2.0f * w * nxv.y - 2.0f * d.w * n.y - 2.0f * nxdv.y,
      2.0f * (uv * n.z + nu * v.z - 2.0f * nv * u.z) - 2.0f * w * nxv.z - 2.0f * d.w * n.z - 2.0f * nxdv.z};
  gr = {gw, gu.x, gu.y, gu.z};
  gd = {-2.0f * nu, 2.0f * (w * n.x + nxu.x), 2.0f * (w * n.y + nxu.y), 2.0f * (w * n.z + nxu.z)};
  if (!small) gr = qdiv(qsub(gr, qscale(r, dot4(r, gr))), s);
}

// Gradient of u · transform(normalize(b), v) with respect to the blend b,
// as its real (gq) and dual (ge) parts: grad_transform along u, chained
// through dualquat.normalize (r = b_r / s, d = d0 - (r·d0) r, d0 = b_d /
// s). Linear in u, so a data row's direction (n, sw t1 or sw t2) takes it
// directly, as the residual's reverse-mode Jacobian does.
__device__ __forceinline__ void grad_blend_transform(DualQuat b, Vec3 v, Vec3 u, Quat& gq, Quat& ge) {
  const float n2 = dot4(b.r, b.r);
  const bool small = n2 < 1e-12f;
  const float sn = sqrtf(small ? 1.0f : n2);
  const Quat r = qdiv(b.r, sn);
  const Quat d0 = qdiv(b.d, sn);
  const float rd0 = dot4(r, d0);
  const Quat d = qsub(d0, qscale(r, rd0));
  Quat gr, gd;
  grad_transform(r, d, v, u, gr, gd);
  const float rgd = dot4(r, gd);
  const Quat h = qsub(gd, qscale(r, rgd));
  const Quat g = qsub(qsub(gr, qscale(gd, rd0)), qscale(d0, rgd));
  if (small) {
    gq = g;
    ge = h;
  } else {
    gq = qsub(qdiv(qsub(g, qscale(r, dot4(r, g))), sn), qdiv(qscale(r, dot4(d0, h)), sn));
    ge = qdiv(h, sn);
  }
}

// Row of the twist Jacobian: d(g · (from_twist(eps) ⊗ a))/d eps at eps = 0,
// for the gradient (gq, ge) with respect to a's real and dual parts.
__device__ __forceinline__ void twist_row(Quat gq, Quat ge, DualQuat a, float coef, float out[6]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const Quat lr = pure_mul(i, a.r);
    const Quat ld = pure_mul(i, a.d);
    out[i] = coef * (dot4(gq, lr) + dot4(ge, ld));
    out[3 + i] = coef * (0.5f * dot4(ge, lr));
  }
}

}  // namespace dfk
