// Kernel F: the warp solver's point-to-plane data term at eps = 0.
//
// Replaces dynamicfusion_tpu/solvers/warp_solver.py:299
// data_residual_and_jac (vmap(jacrev) of the residual), :403
// data_grad_cost and :545 data_jtr with :391 _scatter_jtr (bf16 hi+lo
// one-hot matmuls), and the rows and blocks_d of the factored system_fn
// (:1049-1089, one-hot einsums on the MXU).
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700.00 W: 3.35 TB/s, 67 TFLOP/s
// float32, data-sheet peaks; measured times in PERF.md): bytes and latency. At
// the slice's 3 200 solve points and 8 neighbours the pass reads ~0.3 MB
// (points, neighbour ids and weights, 8 dual quaternions a point from a 32 KB
// node table) and writes the (P, 8, 6) rows in float32 and bf16 (~0.9 MB); ~1
// 500 flops a point are ~5 MFLOP. Both are microseconds: launch latency
// dominates.
// Design: pass 1, one thread per point: the DQB blend of its neighbours,
// the transform, the residual n·(W(p) - l), Tukey weight and cost, and the
// closed-form Jacobian jac_k = w_k s_k g M(dq_k): g (1x8) is the gradient
// of n·transform(normalize(b)) at the blended b (dq.cuh grad_transform,
// chained through the dual-quaternion normalize), M(dq_k) the fixed 8x6
// derivative of from_twist(eps) ⊗ dq_k at eps = 0 (dq.cuh twist_row).
// Pass 2, one thread per node: Jᵀr and (for the system) the 6x6 diagonal
// block, summed over the node's (point, neighbour) entries in the order of
// a per-solve node-sorted list: no float atomics, so the result is the
// same in every run. Pass 3, one block: the cost, summed in a fixed tree.
#include <cuda_bf16.h>

#include "common.cuh"
#include "dq.cuh"
#include "reduce.cuh"

namespace {

constexpr int kK = 8;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
data_points_kernel(const float* __restrict__ p_can, const float* __restrict__ p_live,
                   const float* __restrict__ n_live, const bool* __restrict__ valid,
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
  // dual-quaternion normalize, keeping its intermediates for the chain rule
  const float n2 = dfk::dot4(b.r, b.r);
  const bool small = n2 < 1e-12f;
  const float sn = sqrtf(small ? 1.0f : n2);
  const dfk::Quat r = dfk::qdiv(b.r, sn);
  const dfk::Quat d0 = dfk::qdiv(b.d, sn);
  const float rd0 = dfk::dot4(r, d0);
  const dfk::Quat d = dfk::qsub(d0, dfk::qscale(r, rd0));
  const dfk::Vec3 p = {p_can[3 * i], p_can[3 * i + 1], p_can[3 * i + 2]};
  const dfk::Vec3 l = {p_live[3 * i], p_live[3 * i + 1], p_live[3 * i + 2]};
  const dfk::Vec3 nl = {n_live[3 * i], n_live[3 * i + 1], n_live[3 * i + 2]};
  const dfk::Vec3 y = dfk::dq_transform({r, d}, p);
  const float res = (nl.x * (y.x - l.x) + nl.y * (y.y - l.y)) + nl.z * (y.z - l.z);
  const float rn = sqrtf(res * res);
  const float x = rn / c;
  const bool ok = valid[i];
  const float sw = ok ? (fabsf(x) <= 1.0f ? 1.0f - x * x : 0.0f) : 0.0f;
  const float x2 = (rn / c) * (rn / c);
  const float t = 1.0f - x2;
  const float rho = x2 <= 1.0f ? cc6 * (1.0f - (t * t) * t) : cc6;
  rho_v[i] = ok ? rho : 0.0f;
  rw[i] = res * sw;
  float* jrow = jac + static_cast<size_t>(i) * kK * 6;
  __nv_bfloat16* brow = rows == nullptr ? nullptr : rows + static_cast<size_t>(i) * kK * 6;
  if (sw == 0.0f) {
    for (int e = 0; e < kK * 6; ++e) {
      jrow[e] = 0.0f;
      if (brow != nullptr) brow[e] = __float2bfloat16_rn(0.0f);
    }
    return;
  }
  dfk::Quat gr, gd;
  dfk::grad_transform(r, d, p, nl, gr, gd);
  // chain through d = d0 - (r·d0) r, d0 = b_d / s, r = b_r / s
  const float rgd = dfk::dot4(r, gd);
  const dfk::Quat h = dfk::qsub(gd, dfk::qscale(r, rgd));
  const dfk::Quat G = dfk::qsub(dfk::qsub(gr, dfk::qscale(gd, rd0)), dfk::qscale(d0, rgd));
  dfk::Quat gq, ge;
  if (small) {
    gq = G;
    ge = h;
  } else {
    gq = dfk::qsub(dfk::qdiv(dfk::qsub(G, dfk::qscale(r, dfk::dot4(r, G))), sn),
                   dfk::qdiv(dfk::qscale(r, dfk::dot4(d0, h)), sn));
    ge = dfk::qdiv(h, sn);
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    float row[6];
    dfk::twist_row(gq, ge, a[k], w[k] * sg[k], row);
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const float v = row[e] * sw;
      jrow[k * 6 + e] = v;
      if (brow != nullptr) brow[k * 6 + e] = __float2bfloat16_rn(v);
    }
  }
}

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
    const float* j = jac + static_cast<size_t>(ent) * 6;
    const float r = rw[ent / kK];
    float v[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      v[a] = j[a];
      g[a] += v[a] * r;
    }
    if (blocks != nullptr) {
      int e = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b2 = a; b2 < 6; ++b2) h[e++] += v[a] * v[b2];
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

}  // namespace

extern "C" int df_data_term(const void* p_can, const void* p_live, const void* n_live, const void* valid,
                            const void* knn_idx, const void* w_knn, const void* dqs, int np, int n,
                            const void* order, const void* off, float c, float cc6, void* jac, void* rows,
                            void* rw, void* rho_v, void* jtr, void* blocks, void* cost, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (np > 0) {
    data_points_kernel<<<(np + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const float*>(p_can), static_cast<const float*>(p_live), static_cast<const float*>(n_live),
        static_cast<const bool*>(valid), static_cast<const int64_t*>(knn_idx), static_cast<const float*>(w_knn),
        static_cast<const float*>(dqs), np, c, cc6, static_cast<float*>(jac),
        static_cast<__nv_bfloat16*>(rows), static_cast<float*>(rw), static_cast<float*>(rho_v));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  data_nodes_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(jac), static_cast<const float*>(rw), static_cast<const int*>(order),
      static_cast<const int*>(off), n, static_cast<float*>(jtr), static_cast<float*>(blocks));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_kernel<<<1, kReduceThreads, 0, s>>>(static_cast<const float*>(rho_v), np, static_cast<float*>(cost));
  return static_cast<int>(cudaGetLastError());
}
