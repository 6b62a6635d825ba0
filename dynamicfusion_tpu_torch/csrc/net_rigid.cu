// Kernel Q: the removal of the net rigid motion from one frame's warp-field
// increment (a leaky gauge anchor of the non-rigid solve).
//
// Replaces dynamicfusion_tpu/models/warpfield.py:463 remove_net_rigid: a
// weighted Kabsch fit over the active nodes of the pre-solve against the
// post-solve live node positions (centroids, the 3x3 cross-covariance H,
// jnp.linalg.svd with the det fix), the inverse of the fitted G as a dual
// quaternion (quat.from_matrix), blended toward the identity by alpha, and
// left-multiplied into every active node's transform, guarded by ok (at
// least three active nodes, everything finite).
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700.00 W: 3.35 TB/s, 67 TFLOP/s
// float32, data-sheet peaks; measured times in PERF.md): latency. At 1024
// nodes the pass reads ~82 KB (positions, two transform sets, the masks)
// and writes 32 KB; ~200 flops a node and a few thousand for the SVD are
// nanoseconds of the card's rates. What costs is the chain of dependent
// steps (sum, fit, apply), which a library route pays as a dozen launches
// and a host read of cuSOLVER's status (torch.linalg.svd syncs).
// Design: ONE launch of one 1024-thread block. Each thread owns the nodes
// i = tid, tid + 1024, ...; the block sums the weight, the weighted live
// positions and then H in a fixed order (per-thread sums in node order, a
// warp shuffle tree, the warps in order), so the result is the same in
// every run. Thread 0 takes the SVD of H in double precision by one-sided
// Jacobi rotations (a 3x3 converges in a few sweeps), R = v1 u1ᵀ + v2 u2ᵀ
// + det(V) v3 (u1 x u2)ᵀ (the JAX package's V diag(1, 1, det(V Uᵀ)) Uᵀ,
// which does not depend on the sign of the third left vector, so a rank-2
// H is handled), then R and t in float32 and the rest in the plain
// version's float32 order (dq.cuh). Every thread then forms its nodes'
// cleaned transforms; a block AND of their finiteness completes ok, and
// each active node takes its cleaned transform where ok holds.
#include "common.cuh"
#include "dq.cuh"

namespace {

constexpr int kBlock = 1024;
constexpr int kWarps = kBlock / 32;

// fixed-order block sum of M values a thread: every thread gets the totals
template <int M>
__device__ void block_sums(float (&v)[M], float (*red)[kWarps]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[m] += __shfl_down_sync(0xffffffffu, v[m], o);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) red[m][threadIdx.x >> 5] = v[m];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float t = red[m][threadIdx.x];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
      if (threadIdx.x == 0) red[m][0] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < M; ++m) v[m] = red[m][0];
  __syncthreads();
}

__device__ dfk::DualQuat dq_mul(dfk::DualQuat a, dfk::DualQuat b) {
  return {dfk::qmul(a.r, b.r), dfk::qadd(dfk::qmul(a.r, b.d), dfk::qmul(a.d, b.r))};
}

__device__ bool dq_finite(dfk::DualQuat a) {
  return isfinite(a.r.w) && isfinite(a.r.x) && isfinite(a.r.y) && isfinite(a.r.z) && isfinite(a.d.w) &&
         isfinite(a.d.x) && isfinite(a.d.y) && isfinite(a.d.z);
}

// quat.from_matrix: all four Shepperd candidates, the one of the largest
// trace term (the first on ties), normalized
__device__ dfk::Quat quat_from_matrix(const float m[3][3]) {
  const float tw = ((1.0f + m[0][0]) + m[1][1]) + m[2][2];
  const float tx = ((1.0f + m[0][0]) - m[1][1]) - m[2][2];
  const float ty = ((1.0f - m[0][0]) + m[1][1]) - m[2][2];
  const float tz = ((1.0f - m[0][0]) - m[1][1]) + m[2][2];
  int best = 0;
  float top = tw;
  if (tx > top) { best = 1; top = tx; }
  if (ty > top) { best = 2; top = ty; }
  if (tz > top) { best = 3; top = tz; }
  dfk::Quat q;
  if (best == 0) {
    const float s = sqrtf(fmaxf(tw, 1e-12f)) * 2.0f;
    q = {0.25f * s, (m[2][1] - m[1][2]) / s, (m[0][2] - m[2][0]) / s, (m[1][0] - m[0][1]) / s};
  } else if (best == 1) {
    const float s = sqrtf(fmaxf(tx, 1e-12f)) * 2.0f;
    q = {(m[2][1] - m[1][2]) / s, 0.25f * s, (m[0][1] + m[1][0]) / s, (m[0][2] + m[2][0]) / s};
  } else if (best == 2) {
    const float s = sqrtf(fmaxf(ty, 1e-12f)) * 2.0f;
    q = {(m[0][2] - m[2][0]) / s, (m[0][1] + m[1][0]) / s, 0.25f * s, (m[1][2] + m[2][1]) / s};
  } else {
    const float s = sqrtf(fmaxf(tz, 1e-12f)) * 2.0f;
    q = {(m[1][0] - m[0][1]) / s, (m[0][2] + m[2][0]) / s, (m[1][2] + m[2][1]) / s, 0.25f * s};
  }
  return dfk::qnormalize(q);
}

__device__ double det3(const double m[3][3]) {
  return m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1]) - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0]) +
         m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]);
}

// The Kabsch rotation of H = sum w (a - ca)(b - cb)ᵀ: one-sided Jacobi on
// the columns of H (H V has orthogonal columns s_i u_i), sorted by
// decreasing s_i, R = v1 u1ᵀ + v2 u2ᵀ + det(V) v3 (u1 x u2)ᵀ.
__device__ void kabsch_rotation(const float hf[3][3], float r[3][3]) {
  double a[3][3], v[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      a[i][j] = hf[i][j];
      v[i][j] = i == j ? 1.0 : 0.0;
    }
  const int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  for (int sweep = 0; sweep < 30; ++sweep) {
    bool rotated = false;
    for (int k = 0; k < 3; ++k) {
      const int p = pairs[k][0], q = pairs[k][1];
      double al = 0.0, be = 0.0, ga = 0.0;
      for (int i = 0; i < 3; ++i) {
        al += a[i][p] * a[i][p];
        be += a[i][q] * a[i][q];
        ga += a[i][p] * a[i][q];
      }
      if (ga == 0.0 || fabs(ga) <= 1e-15 * sqrt(al * be)) continue;
      rotated = true;
      const double zeta = (be - al) / (2.0 * ga);
      const double t = (zeta >= 0.0 ? 1.0 : -1.0) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      const double c = 1.0 / sqrt(1.0 + t * t);
      const double s = c * t;
      for (int i = 0; i < 3; ++i) {
        const double ap = a[i][p], aq = a[i][q];
        a[i][p] = c * ap - s * aq;
        a[i][q] = s * ap + c * aq;
        const double vp = v[i][p], vq = v[i][q];
        v[i][p] = c * vp - s * vq;
        v[i][q] = s * vp + c * vq;
      }
    }
    if (!rotated) break;
  }
  double sv[3];
  int ord[3] = {0, 1, 2};
  for (int j = 0; j < 3; ++j) sv[j] = sqrt(a[0][j] * a[0][j] + a[1][j] * a[1][j] + a[2][j] * a[2][j]);
  for (int i = 0; i < 3; ++i)  // descending singular values
    for (int j = i + 1; j < 3; ++j)
      if (sv[ord[j]] > sv[ord[i]]) {
        const int t = ord[i];
        ord[i] = ord[j];
        ord[j] = t;
      }
  double u[2][3], vs[3][3];
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < 3; ++i) vs[c][i] = v[i][ord[c]];
  for (int c = 0; c < 2; ++c) {
    const double s = sv[ord[c]];
    for (int i = 0; i < 3; ++i) u[c][i] = s > 0.0 ? a[i][ord[c]] / s : 0.0;
  }
  const double u3[3] = {u[0][1] * u[1][2] - u[0][2] * u[1][1], u[0][2] * u[1][0] - u[0][0] * u[1][2],
                        u[0][0] * u[1][1] - u[0][1] * u[1][0]};
  double vm[3][3];
  for (int i = 0; i < 3; ++i)
    for (int c = 0; c < 3; ++c) vm[i][c] = vs[c][i];
  const double dv = det3(vm);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r[i][j] = static_cast<float>(vs[0][i] * u[0][j] + vs[1][i] * u[1][j] + dv * vs[2][i] * u3[j]);
}

__global__ void __launch_bounds__(kBlock)
net_rigid_kernel(const float* __restrict__ pos, const float* __restrict__ prev_dq,
                 const bool* __restrict__ prev_active, const float* __restrict__ new_dq,
                 const bool* __restrict__ new_active, int n, float alpha, float one_minus_alpha,
                 float* __restrict__ out_dq, float* __restrict__ out_g) {
  __shared__ float red[9][kWarps];
  __shared__ float g_sm[8];
  __shared__ int ok_sm;
  // centroids: sum w, sum w a, sum w b
  float s7[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float w = prev_active[i] ? 1.0f : 0.0f;
    const dfk::Vec3 p = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
    const dfk::Vec3 a = dfk::dq_transform(dfk::load_dq(prev_dq + 8 * static_cast<size_t>(i)), p);
    const dfk::Vec3 b = dfk::dq_transform(dfk::load_dq(new_dq + 8 * static_cast<size_t>(i)), p);
    s7[0] += w;
    s7[1] += a.x * w;
    s7[2] += a.y * w;
    s7[3] += a.z * w;
    s7[4] += b.x * w;
    s7[5] += b.y * w;
    s7[6] += b.z * w;
  }
  block_sums<7>(s7, red);
  const float wsum = s7[0];
  const float cnt = fmaxf(wsum, 1.0f);
  const float ca[3] = {s7[1] / cnt, s7[2] / cnt, s7[3] / cnt};
  const float cb[3] = {s7[4] / cnt, s7[5] / cnt, s7[6] / cnt};
  // H = sum ((a - ca) w)(b - cb)ᵀ
  float h[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float w = prev_active[i] ? 1.0f : 0.0f;
    const dfk::Vec3 p = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
    const dfk::Vec3 a = dfk::dq_transform(dfk::load_dq(prev_dq + 8 * static_cast<size_t>(i)), p);
    const dfk::Vec3 b = dfk::dq_transform(dfk::load_dq(new_dq + 8 * static_cast<size_t>(i)), p);
    const float da[3] = {(a.x - ca[0]) * w, (a.y - ca[1]) * w, (a.z - ca[2]) * w};
    const float db[3] = {b.x - cb[0], b.y - cb[1], b.z - cb[2]};
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) h[3 * r + c] += da[r] * db[c];
  }
  block_sums<9>(h, red);
  if (threadIdx.x == 0) {
    const float hm[3][3] = {{h[0], h[1], h[2]}, {h[3], h[4], h[5]}, {h[6], h[7], h[8]}};
    float r[3][3];
    kabsch_rotation(hm, r);
    // t = cb - R ca; G⁻¹ = (Rᵀ, -Rᵀ t)
    float t[3], rt[3][3], ti[3];
    for (int i = 0; i < 3; ++i) t[i] = cb[i] - ((r[i][0] * ca[0] + r[i][1] * ca[1]) + r[i][2] * ca[2]);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) rt[i][j] = r[j][i];
    for (int i = 0; i < 3; ++i) ti[i] = -((rt[i][0] * t[0] + rt[i][1] * t[1]) + rt[i][2] * t[2]);
    bool finite = true;
    for (int i = 0; i < 3; ++i) {
      finite = finite && isfinite(t[i]);
      for (int j = 0; j < 3; ++j) finite = finite && isfinite(r[i][j]);
    }
    const dfk::Quat q = quat_from_matrix(rt);
    dfk::DualQuat g = {q, dfk::qscale(dfk::qmul({0.0f, ti[0], ti[1], ti[2]}, q), 0.5f)};
    if (alpha < 1.0f) {
      const dfk::DualQuat id = {{1.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      const dfk::DualQuat mix = {dfk::qadd(dfk::qscale(g.r, alpha), dfk::qscale(id.r, one_minus_alpha)),
                                 dfk::qadd(dfk::qscale(g.d, alpha), dfk::qscale(id.d, one_minus_alpha))};
      g = dfk::dq_normalize(mix);
    }
    dfk::store_dq(g_sm, g);
    ok_sm = (wsum >= 3.0f && finite) ? 1 : 0;
  }
  __syncthreads();
  const dfk::DualQuat g = dfk::load_dq(g_sm);
  if (out_g != nullptr && threadIdx.x == 0) dfk::store_dq(out_g, g);
  // ok also needs every node's cleaned transform finite
  int bad = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const dfk::DualQuat c = dfk::dq_normalize(dq_mul(g, dfk::load_dq(new_dq + 8 * static_cast<size_t>(i))));
    bad |= dq_finite(c) ? 0 : 1;
  }
  bad = __syncthreads_or(bad);
  const bool ok = ok_sm != 0 && bad == 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const dfk::DualQuat d = dfk::load_dq(new_dq + 8 * static_cast<size_t>(i));
    dfk::store_dq(out_dq + 8 * static_cast<size_t>(i),
                  ok && new_active[i] ? dfk::dq_normalize(dq_mul(g, d)) : d);
  }
}

}  // namespace

// out_dq (N, 8) the cleaned transforms; out_g (8,) the applied G⁻¹ (or null)
extern "C" int df_net_rigid(const void* pos, const void* prev_dq, const void* prev_active, const void* new_dq,
                            const void* new_active, int n, float alpha, float one_minus_alpha, void* out_dq,
                            void* out_g, void* stream) {
  if (n <= 0) return 0;
  net_rigid_kernel<<<1, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(prev_dq), static_cast<const bool*>(prev_active),
      static_cast<const float*>(new_dq), static_cast<const bool*>(new_active), n, alpha, one_minus_alpha,
      static_cast<float*>(out_dq), static_cast<float*>(out_g));
  return static_cast<int>(cudaGetLastError());
}
