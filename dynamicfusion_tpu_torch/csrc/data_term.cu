// Kernel F: the warp solver's data term at eps = 0, point-to-plane (one
// residual row), with the tangential point terms (three rows) or
// point-to-point (three rows).
//
// Replaces dynamicfusion_tpu/solvers/warp_solver.py:299
// data_residual_and_jac (vmap(jacrev) of the residual :82, :88 with
// :122 tangent_basis, or :76), :403 data_grad_cost and :545 data_jtr with :391
// _scatter_jtr (bf16 hi+lo one-hot matmuls), and the rows and blocks_d of
// the factored system_fn (:1049-1089, one-hot einsums on the MXU).
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700.00 W: 3.35 TB/s, 67 TFLOP/s
// float32, data-sheet peaks; measured times in PERF.md): bytes and latency. At
// the preset's 3 200 solve points and 8 neighbours the pass reads ~0.3 MB
// (points, neighbour ids and weights, 8 dual quaternions a point from a 32 KB
// node table) and writes the (P, R, 8, 6) rows in float32 and bf16 (~0.9 MB
// a row); ~1 500 flops a point and row are ~5-15 MFLOP. Both are
// microseconds: launch latency dominates.
// Design: pass 1, one thread per point: the DQB blend of its neighbours,
// the transform, the residual rows [n·d] or [n·d, sw t1·d, sw t2·d] (d =
// W(p) - l, sw a per-point weight), the Tukey weight and cost on their
// joint norm, and the closed-form Jacobian: each row's g (1x8), the
// gradient of u·transform(normalize(b)) at the blend b along its direction
// u = n, sw t1 or sw t2, or for the point-to-point rows [d.x, d.y, d.z]
// the world axes (dq.cuh grad_blend_transform; one gradient for the
// point-to-plane term, as before the tangential rows); jac_k = w_k s_k g M(dq_k),
// M(dq_k) the fixed 8x6 derivative of from_twist(eps) ⊗ dq_k at eps = 0
// (dq.cuh twist_row). Pass 2, one thread per node: Jᵀr and (for the
// system) the 6x6 diagonal block, summed over the node's (point,
// neighbour) entries in the order of a per-solve node-sorted list (the
// rows of an entry first): no float atomics, so the result is the same in
// every run. Pass 3, one block: the cost, summed in a fixed tree.
#include <cuda_bf16.h>

#include "common.cuh"
#include "dq.cuh"
#include "reduce.cuh"

namespace {

constexpr int kK = 8;
constexpr int kThreads = 128;

template <int R, bool kPoint>
__global__ void __launch_bounds__(kThreads)
data_points_kernel(const float* __restrict__ p_can, const float* __restrict__ p_live,
                   const float* __restrict__ n_live, const float* __restrict__ t1v, const float* __restrict__ t2v,
                   const float* __restrict__ psw, const bool* __restrict__ valid,
                   const int64_t* __restrict__ knn_idx, const float* __restrict__ w_knn,
                   const float* __restrict__ dqs, int np, float c, float cc6,
                   float* __restrict__ jac, __nv_bfloat16* __restrict__ rows, float* __restrict__ rw,
                   float* __restrict__ rho_v) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= np) return;
  dfk::DualQuat a[kK];
  float w[kK], sg[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    a[k] = dfk::load_dq(dqs + 8 * knn_idx[static_cast<size_t>(i) * kK + k]);
    w[k] = w_knn[static_cast<size_t>(i) * kK + k];
  }
  dfk::DualQuat b;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    sg[k] = dfk::blend_sign(a[k].r, a[0].r);
    dfk::blend_add(b, a[k], w[k], sg[k], k == 0);
  }
  const dfk::Vec3 p = {p_can[3 * i], p_can[3 * i + 1], p_can[3 * i + 2]};
  const dfk::Vec3 l = {p_live[3 * i], p_live[3 * i + 1], p_live[3 * i + 2]};
  const dfk::Vec3 y = dfk::dq_transform(dfk::dq_normalize(b), p);
  const dfk::Vec3 d = {y.x - l.x, y.y - l.y, y.z - l.z};
  // the rows' directions and residuals: n, then sw t1 and sw t2; or the
  // axes and d itself
  dfk::Vec3 dir[R];
  float res[R];
  if constexpr (kPoint) {
    static_assert(R == 3, "point-to-point has three rows");
    dir[0] = {1.0f, 0.0f, 0.0f};
    dir[1] = {0.0f, 1.0f, 0.0f};
    dir[2] = {0.0f, 0.0f, 1.0f};
    res[0] = d.x;
    res[1] = d.y;
    res[2] = d.z;
  } else {
    dir[0] = {n_live[3 * i], n_live[3 * i + 1], n_live[3 * i + 2]};
    res[0] = dfk::dot3(dir[0], d);
  }
  if constexpr (R == 3 && !kPoint) {
    const float sw = psw[i];
    const dfk::Vec3 t1 = {t1v[3 * i], t1v[3 * i + 1], t1v[3 * i + 2]};
    const dfk::Vec3 t2 = {t2v[3 * i], t2v[3 * i + 1], t2v[3 * i + 2]};
    res[1] = sw * dfk::dot3(t1, d);
    res[2] = sw * dfk::dot3(t2, d);
    dir[1] = {t1.x * sw, t1.y * sw, t1.z * sw};
    dir[2] = {t2.x * sw, t2.y * sw, t2.z * sw};
  }
  float rr = res[0] * res[0];
#pragma unroll
  for (int j = 1; j < R; ++j) rr = rr + res[j] * res[j];
  const float rn = sqrtf(rr);
  const float x = rn / c;
  const bool ok = valid[i];
  const float tw = ok ? (fabsf(x) <= 1.0f ? 1.0f - x * x : 0.0f) : 0.0f;
  const float x2 = (rn / c) * (rn / c);
  const float t = 1.0f - x2;
  const float rho = x2 <= 1.0f ? cc6 * (1.0f - (t * t) * t) : cc6;
  rho_v[i] = ok ? rho : 0.0f;
#pragma unroll
  for (int j = 0; j < R; ++j) rw[i * R + j] = res[j] * tw;
  float* jrow = jac + static_cast<size_t>(i) * R * kK * 6;
  __nv_bfloat16* brow = rows == nullptr ? nullptr : rows + static_cast<size_t>(i) * R * kK * 6;
  if (tw == 0.0f) {
    for (int e = 0; e < R * kK * 6; ++e) {
      jrow[e] = 0.0f;
      if (brow != nullptr) brow[e] = __float2bfloat16_rn(0.0f);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    dfk::Quat gq, ge;
    dfk::grad_blend_transform(b, p, dir[j], gq, ge);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float row[6];
      dfk::twist_row(gq, ge, a[k], w[k] * sg[k], row);
#pragma unroll
      for (int e = 0; e < 6; ++e) {
        const float v = row[e] * tw;
        jrow[(j * kK + k) * 6 + e] = v;
        if (brow != nullptr) brow[(j * kK + k) * 6 + e] = __float2bfloat16_rn(v);
      }
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
data_nodes_kernel(const float* __restrict__ jac, const float* __restrict__ rw, const int* __restrict__ order,
                  const int* __restrict__ off, int n, float* __restrict__ jtr, float* __restrict__ blocks) {
  const int nd = blockIdx.x * blockDim.x + threadIdx.x;
  if (nd >= n) return;
  float g[6] = {0, 0, 0, 0, 0, 0};
  float h[21];
#pragma unroll
  for (int e = 0; e < 21; ++e) h[e] = 0.0f;
  for (int q = off[nd]; q < off[nd + 1]; ++q) {
    const int ent = order[q];
    const int pt = ent / kK;
    // row j of entry (pt, k) of the (P, R, K, 6) Jacobian: ent + (pt (R - 1) + j) K
    const size_t e0 = static_cast<size_t>(ent) + static_cast<size_t>(pt) * (R - 1) * kK;
    float v[R][6], r[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float* jr = jac + (e0 + j * kK) * 6;
      r[j] = rw[pt * R + j];
#pragma unroll
      for (int a = 0; a < 6; ++a) v[j][a] = jr[a];
    }
    // an entry's rows are summed first, as the plain version does
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      float s = v[0][a] * r[0];
#pragma unroll
      for (int j = 1; j < R; ++j) s = s + v[j][a] * r[j];
      g[a] += s;
    }
    if (blocks != nullptr) {
      int e = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b2 = a; b2 < 6; ++b2) {
          float s = v[0][a] * v[0][b2];
#pragma unroll
          for (int j = 1; j < R; ++j) s = s + v[j][a] * v[j][b2];
          h[e++] += s;
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) jtr[nd * 6 + a] = g[a];
  if (blocks != nullptr) {
    float* blk = blocks + static_cast<size_t>(nd) * 36;
    int e = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b2 = a; b2 < 6; ++b2) {
        blk[a * 6 + b2] = h[e];
        blk[b2 * 6 + a] = h[e];
        ++e;
      }
    }
  }
}

template <int R, bool kPoint>
cudaError_t launch(const void* p_can, const void* p_live, const void* n_live, const void* t1, const void* t2,
                   const void* sw, const void* valid, const void* knn_idx, const void* w_knn, const void* dqs, int np,
                   int n, const void* order, const void* off, float c, float cc6, void* jac, void* rows, void* rw,
                   void* rho_v, void* jtr, void* blocks, cudaStream_t s) {
  if (np > 0) {
    data_points_kernel<R, kPoint><<<(np + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const float*>(p_can), static_cast<const float*>(p_live), static_cast<const float*>(n_live),
        static_cast<const float*>(t1), static_cast<const float*>(t2), static_cast<const float*>(sw),
        static_cast<const bool*>(valid), static_cast<const int64_t*>(knn_idx), static_cast<const float*>(w_knn),
        static_cast<const float*>(dqs), np, c, cc6, static_cast<float*>(jac),
        static_cast<__nv_bfloat16*>(rows), static_cast<float*>(rw), static_cast<float*>(rho_v));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  data_nodes_kernel<R><<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(jac), static_cast<const float*>(rw), static_cast<const int*>(order),
      static_cast<const int*>(off), n, static_cast<float*>(jtr), static_cast<float*>(blocks));
  return cudaGetLastError();
}

}  // namespace

// nrows 1: point-to-plane (t1, t2, sw unused); 3: with the tangential rows,
// or with ``point`` the point-to-point rows (n_live, t1, t2, sw unused)
extern "C" int df_data_term(const void* p_can, const void* p_live, const void* n_live, const void* t1,
                            const void* t2, const void* sw, const void* valid, const void* knn_idx, const void* w_knn,
                            const void* dqs, int np, int n, int nrows, int point, const void* order, const void* off,
                            float c, float cc6, void* jac, void* rows, void* rw, void* rho_v, void* jtr, void* blocks,
                            void* cost, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (point && nrows == 3) {
    err = launch<3, true>(p_can, p_live, n_live, t1, t2, sw, valid, knn_idx, w_knn, dqs, np, n, order, off, c, cc6,
                          jac, rows, rw, rho_v, jtr, blocks, s);
  } else if (point) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (nrows == 1) {
    err = launch<1, false>(p_can, p_live, n_live, t1, t2, sw, valid, knn_idx, w_knn, dqs, np, n, order, off, c,
                           cc6, jac, rows, rw, rho_v, jtr, blocks, s);
  } else if (nrows == 3) {
    err = launch<3, false>(p_can, p_live, n_live, t1, t2, sw, valid, knn_idx, w_knn, dqs, np, n, order, off, c,
                           cc6, jac, rows, rw, rho_v, jtr, blocks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_kernel<<<1, kReduceThreads, 0, s>>>(static_cast<const float*>(rho_v), np, static_cast<float*>(cost));
  return static_cast<int>(cudaGetLastError());
}
