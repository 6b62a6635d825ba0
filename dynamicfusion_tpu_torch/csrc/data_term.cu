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
// Design: pass 1, for each point: the DQB blend of its neighbours,
// the transform, the residual rows [n·d] or [n·d, sw t1·d, sw t2·d] (d =
// W(p) - l, sw a per-point weight), the Tukey weight and cost on their
// joint norm, and the closed-form Jacobian: each row's g (1x8), the
// gradient of u·transform(normalize(b)) at the blend b along its direction
// u = n, sw t1 or sw t2, or for the point-to-point rows [d.x, d.y, d.z]
// the world axes (dq.cuh grad_blend_transform; one gradient for the
// point-to-plane term, as before the tangential rows); jac_k = w_k s_k g M(dq_k),
// M(dq_k) the fixed 8x6 derivative of from_twist(eps) ⊗ dq_k at eps = 0
// (dq.cuh twist_row). With solver_p2p_hessian_stride = s (:1063-1071)
// pass 1 writes the bf16 tangential rows of the points i % s == 0 as
// bf16(sqrt(s) jac), the rows the factored PCG's matvec reads (kernel G's
// row mode); the float32 Jacobian, Jᵀr and the blocks keep every row
// unscaled.
// Pass 1 gives a point kPointLanes lanes: every lane repeats the blend,
// the residual and the rows' gradients in the same order (so every lane
// holds the same bits), and lane k computes and writes neighbour k's 6·R
// values, so a point's rows are written by neighbouring lanes (the old
// design, a thread a point, wrote 48·R values from one thread and gave the
// preset's 3 200 points 25 blocks on 132 SMs).
// Pass 2 sums Jᵀr and (for the system) the 6x6 diagonal block of every
// node over its (point, neighbour) entries in a per-solve node-sorted list
// (the rows of an entry first), with kNodeLanes lanes a node (a warp; 64
// and 128 lanes were faster on the card but moved the sharded base
// config's first LM step past a hold, PERF.md): lane l adds the entries l,
// l + kNodeLanes, ... in list order, a shuffle tree (16, 8, 4, 2, 1) adds
// each warp's 32 lanes, then a halving tree the node's warps. The same
// tree in every run and no float atomics, so the result is the same in
// every run (warp_solver.data_sums_ordered is this order in PyTorch). The
// preset's lists are skewed (the heaviest node holds ~1 280 of 25 600
// entries): a thread a node, as before, walked them serially. Pass 2's
// grid has one more block, which sums the points' Tukey costs in the
// order of one 1024-thread block (reduce.cuh ordered_sum).
#include <cuda_bf16.h>

#include "common.cuh"
#include "dq.cuh"
#include "reduce.cuh"

namespace {

constexpr int kK = 8;
constexpr int kThreads = 128;
// lanes a point in pass 1: 1 or 8 (lane k writes neighbour k's rows)
constexpr int kPointLanes = 8;
// lanes a node in pass 2: 32, 64 or 128 (whole warps, dividing kThreads)
constexpr int kNodeLanes = 32;
static_assert(kPointLanes == 1 || kPointLanes == kK, "a point's lanes: 1 or one a neighbour");
static_assert(kNodeLanes % 32 == 0 && kThreads % kNodeLanes == 0, "a node's lanes: whole warps of a block");

template <int R, bool kPoint>
__global__ void __launch_bounds__(kThreads)
data_points_kernel(const float* __restrict__ p_can, const float* __restrict__ p_live,
                   const float* __restrict__ n_live, const float* __restrict__ t1v, const float* __restrict__ t2v,
                   const float* __restrict__ psw, const bool* __restrict__ valid,
                   const int64_t* __restrict__ knn_idx, const float* __restrict__ w_knn,
                   const float* __restrict__ dqs, int np, float c, float cc6, int hstride, float hscale,
                   float* __restrict__ jac, __nv_bfloat16* __restrict__ rows, float* __restrict__ rw,
                   float* __restrict__ rho_v) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t / kPointLanes;
  const int lane = t % kPointLanes;
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
  if (lane == 0) {
    const float x2 = (rn / c) * (rn / c);
    const float tt = 1.0f - x2;
    const float rho = x2 <= 1.0f ? cc6 * (1.0f - (tt * tt) * tt) : cc6;
    rho_v[i] = ok ? rho : 0.0f;
#pragma unroll
    for (int j = 0; j < R; ++j) rw[i * R + j] = res[j] * tw;
  }
  // this lane's neighbours: all eight, or neighbour ``lane``, its operands
  // picked by selects (no divergent branch)
  constexpr int kMine = kK / kPointLanes;
  dfk::DualQuat am[kMine];
  float cm[kMine];
#pragma unroll
  for (int m = 0; m < kMine; ++m) {
    am[m] = a[m];
    cm[m] = w[m] * sg[m];
  }
  if constexpr (kPointLanes > 1) {
#pragma unroll
    for (int k = 1; k < kK; ++k) {
      if (k == lane) {
        am[0] = a[k];
        cm[0] = w[k] * sg[k];
      }
    }
  }
  float* jrow = jac + static_cast<size_t>(i) * R * kK * 6;
  __nv_bfloat16* brow = rows == nullptr ? nullptr : rows + static_cast<size_t>(i) * R * kK * 6;
  if (tw == 0.0f) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int m = 0; m < kMine; ++m) {
        const int k = kPointLanes > 1 ? lane : m;
#pragma unroll
        for (int e = 0; e < 6; ++e) {
          jrow[(j * kK + k) * 6 + e] = 0.0f;
          if (brow != nullptr) brow[(j * kK + k) * 6 + e] = __float2bfloat16_rn(0.0f);
        }
      }
    }
    return;
  }
  // the strided tangential rows of the PCG matrix: bf16(sqrt(s) jac)
  const bool scaled = hstride > 1 && i % hstride == 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    dfk::Quat gq, ge;
    dfk::grad_blend_transform(b, p, dir[j], gq, ge);
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const int k = kPointLanes > 1 ? lane : m;
      float row[6];
      dfk::twist_row(gq, ge, am[m], cm[m], row);
#pragma unroll
      for (int e = 0; e < 6; ++e) {
        const float v = row[e] * tw;
        jrow[(j * kK + k) * 6 + e] = v;
        if (brow != nullptr) brow[(j * kK + k) * 6 + e] = __float2bfloat16_rn(j > 0 && scaled ? v * hscale : v);
      }
    }
  }
}

// the 21 upper entries (a, b >= a) of a 6x6 block, row by row
__device__ __forceinline__ void upper_pair(int e, int& a, int& b) {
  a = 0;
  while (e >= 6 - a) {
    e -= 6 - a;
    ++a;
  }
  b = a + e;
}

template <int R, bool kSys>
__global__ void __launch_bounds__(kThreads)
data_nodes_kernel(const float* __restrict__ jac, const float* __restrict__ rw, const int* __restrict__ order,
                  const int* __restrict__ off, int n, const float* __restrict__ rho_v, int np,
                  float* __restrict__ jtr, float* __restrict__ blocks, float* __restrict__ cost) {
  constexpr int kV = kSys ? 27 : 6;  // Jᵀr, then the block's upper entries
  constexpr int kWarps = kNodeLanes / 32;
  constexpr int kNodes = kThreads / kNodeLanes;
  __shared__ float part[kThreads / 32][kV];
  if (blockIdx.x == gridDim.x - 1) {  // the extra block: the cost
    const float total = ordered_sum(rho_v, np);
    if (threadIdx.x == 0) cost[0] = total;
    return;
  }
  const int nd = blockIdx.x * kNodes + threadIdx.x / kNodeLanes;
  const int lane = threadIdx.x % kNodeLanes;
  float acc[kV];
#pragma unroll
  for (int v = 0; v < kV; ++v) acc[v] = 0.0f;
  if (nd < n) {
    const int q1 = off[nd + 1];
    for (int q = off[nd] + lane; q < q1; q += kNodeLanes) {
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
        acc[a] += s;
      }
      if constexpr (kSys) {
        int e = 6;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int b2 = a; b2 < 6; ++b2) {
            float s = v[0][a] * v[0][b2];
#pragma unroll
            for (int j = 1; j < R; ++j) s = s + v[j][a] * v[j][b2];
            acc[e++] += s;
          }
        }
      }
    }
  }
  // each warp's 32 lanes by a shuffle tree, then the node's warps by a
  // halving tree, one value a thread
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    float s = acc[v];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    acc[v] = s;
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int v = 0; v < kV; ++v) part[threadIdx.x >> 5][v] = acc[v];
  }
  __syncthreads();
  if (nd >= n || lane >= kV) return;
  const int w0 = (threadIdx.x / kNodeLanes) * kWarps;
  float h[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) h[w] = part[w0 + w][lane];
#pragma unroll
  for (int half = kWarps / 2; half > 0; half >>= 1) {
#pragma unroll
    for (int w = 0; w < half; ++w) h[w] = h[w] + h[w + half];
  }
  if (lane < 6) {
    jtr[nd * 6 + lane] = h[0];
  } else {
    int a, b2;
    upper_pair(lane - 6, a, b2);
    float* blk = blocks + static_cast<size_t>(nd) * 36;
    blk[a * 6 + b2] = h[0];
    blk[b2 * 6 + a] = h[0];
  }
}

template <int R, bool kPoint>
cudaError_t launch(const void* p_can, const void* p_live, const void* n_live, const void* t1, const void* t2,
                   const void* sw, const void* valid, const void* knn_idx, const void* w_knn, const void* dqs, int np,
                   int n, const void* order, const void* off, float c, float cc6, int hstride, float hscale,
                   void* jac, void* rows, void* rw, void* rho_v, void* jtr, void* blocks, void* cost, cudaStream_t s) {
  if (np > 0) {
    const long long threads = static_cast<long long>(np) * kPointLanes;
    data_points_kernel<R, kPoint><<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        static_cast<const float*>(p_can), static_cast<const float*>(p_live), static_cast<const float*>(n_live),
        static_cast<const float*>(t1), static_cast<const float*>(t2), static_cast<const float*>(sw),
        static_cast<const bool*>(valid), static_cast<const int64_t*>(knn_idx), static_cast<const float*>(w_knn),
        static_cast<const float*>(dqs), np, c, cc6, hstride, hscale, static_cast<float*>(jac),
        static_cast<__nv_bfloat16*>(rows), static_cast<float*>(rw), static_cast<float*>(rho_v));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  constexpr int kNodes = kThreads / kNodeLanes;
  const int grid = (n + kNodes - 1) / kNodes + 1;  // + the cost's block
#define DF_NODES(SYS)                                                                                              \
  data_nodes_kernel<R, SYS><<<grid, kThreads, 0, s>>>(                                                              \
      static_cast<const float*>(jac), static_cast<const float*>(rw), static_cast<const int*>(order),                \
      static_cast<const int*>(off), n, static_cast<const float*>(rho_v), np, static_cast<float*>(jtr),              \
      static_cast<float*>(blocks), static_cast<float*>(cost))
  if (blocks != nullptr) {
    DF_NODES(true);
  } else {
    DF_NODES(false);
  }
#undef DF_NODES
  return cudaGetLastError();
}

}  // namespace

// the lanes a point (pass 1) and a node (pass 2) of this build: the order
// of warp_solver.data_sums_ordered's lanes
extern "C" int df_data_term_lanes(void* out) {
  static_cast<int*>(out)[0] = kPointLanes;
  static_cast<int*>(out)[1] = kNodeLanes;
  return 0;
}

// nrows 1: point-to-plane (t1, t2, sw unused); 3: with the tangential rows,
// or with ``point`` the point-to-point rows (n_live, t1, t2, sw unused);
// hstride > 1 (tangential rows only): the bf16 rows 1 and 2 of the points
// i % hstride == 0 are bf16(hscale jac), hscale = sqrt(hstride)
extern "C" int df_data_term(const void* p_can, const void* p_live, const void* n_live, const void* t1,
                            const void* t2, const void* sw, const void* valid, const void* knn_idx, const void* w_knn,
                            const void* dqs, int np, int n, int nrows, int point, const void* order, const void* off,
                            float c, float cc6, int hstride, float hscale, void* jac, void* rows, void* rw, void* rho_v,
                            void* jtr, void* blocks, void* cost, void* stream) {
  if (hstride < 1 || (hstride > 1 && (point || nrows != 3))) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (point && nrows == 3) {
    err = launch<3, true>(p_can, p_live, n_live, t1, t2, sw, valid, knn_idx, w_knn, dqs, np, n, order, off, c, cc6,
                          hstride, hscale, jac, rows, rw, rho_v, jtr, blocks, cost, s);
  } else if (point) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (nrows == 1) {
    err = launch<1, false>(p_can, p_live, n_live, t1, t2, sw, valid, knn_idx, w_knn, dqs, np, n, order, off, c,
                           cc6, hstride, hscale, jac, rows, rw, rho_v, jtr, blocks, cost, s);
  } else if (nrows == 3) {
    err = launch<3, false>(p_can, p_live, n_live, t1, t2, sw, valid, knn_idx, w_knn, dqs, np, n, order, off, c,
                           cc6, hstride, hscale, jac, rows, rw, rho_v, jtr, blocks, cost, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
