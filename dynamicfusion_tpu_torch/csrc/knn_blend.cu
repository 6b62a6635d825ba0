// Kernel E: exact KNN over the warp-field nodes, Gaussian weights, DQB
// blend, blend quality and the DQB warp of points and normals; the
// mutual-nearest distances of node insertion; the trilinear warp through
// the coarse dual-quaternion grid.
//
// Replaces dynamicfusion_tpu/models/warpfield.py:148 knn, :199
// nearest_dist2, :225 weights_from_dist2, :233 warp_points, :267
// _mutual_nearest, :529 warp_dq_at, :78 _adaptive_radius; solvers/warp_solver.py:159 build_edges'
// KNN; ops/fusion.py:77 coarse_field, :109 warp_points_trilinear, :153
// warp_coarse_grid. On the TPU the (queries, nodes) distance matrix is an
// MXU matmul followed by lax.top_k; here the matrix is never formed.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700.00 W: 3.35 TB/s, 67 TFLOP/s
// float32, data-sheet peaks; measured times in PERF.md): operations. A query
// against N nodes costs ~9 flops a node plus the insertion compare; the
// frame's largest call (35 937 coarse corners against 1024 nodes) is ~3.3e8
// flops, ~5 us at the float32 peak, while its bytes (queries in, 8 neighbours
// and a blend out) are ~2 MB. The node set (16 B a node) stays in shared
// memory.
// Design: one thread per query; the block stages the node positions,
// their |n|^2 and the inactive offset in shared memory tile by tile, and
// each thread keeps its K best (distance, index) pairs sorted in registers
// (ascending distance, ties to the lower index: lax.top_k's order). The
// squared distance is the JAX package's expansion (|q|^2 - 2 q.n) + |n|^2
// (+1e9 for inactive nodes), clamped at 0 after the selection. The blend,
// the sign pivot (first neighbour) and the transform follow dq.cuh, which
// mirrors the plain PyTorch version.
// _adaptive_radius (warpfield.py:78, the per-node radius of
// node_radius_adaptive) is one thread per query too: the expansion against
// the staged reference nodes with its three-term sums as the JAX package's
// jitted graph on the CPU computes them, chains of fused multiply-adds
// (x2 y2 + (x1 y1 + x0 y0), each rounded once: __fmaf_rn, which
// -fmad=false leaves alone), so that the k-th value, and through the
// cancellation of the expansion the radius, come out bit for bit; the k
// smallest squared distances kept in registers (only the k-th enters the
// radius, so ties need no order), then clip(scale sqrt(max(d2_k, 0)),
// min, max).
// _mutual_nearest's per-node minimum over valid candidates is reduced in
// shared memory and then across blocks with an integer atomicMin on the
// bits of the (clamped, non-negative) float: a min does not depend on the
// order, so the result is deterministic.
#include "common.cuh"
#include "dq.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;
constexpr float kBig = 1e9f;

__device__ __forceinline__ void stage_nodes(const float* __restrict__ pos, const bool* __restrict__ active,
                                            int n, int base, float* sx, float* sy, float* sz, float* snn,
                                            float* sbig) {
  for (int j = threadIdx.x; j < kTile && base + j < n; j += blockDim.x) {
    const float px = pos[3 * (base + j)], py = pos[3 * (base + j) + 1], pz = pos[3 * (base + j) + 2];
    sx[j] = px;
    sy[j] = py;
    sz[j] = pz;
    snn[j] = (px * px + py * py) + pz * pz;
    sbig[j] = active[base + j] ? 0.0f : kBig;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_blend_kernel(const float* __restrict__ pos, const bool* __restrict__ active,
                 const float* __restrict__ radius, const float* __restrict__ dq, int n,
                 const float* __restrict__ queries, const float* __restrict__ normals, int nq,
                 float* __restrict__ d2_out, int64_t* __restrict__ idx_out, float* __restrict__ w_out,
                 float* __restrict__ blend_out, float* __restrict__ qual_out,
                 float* __restrict__ pts_out, float* __restrict__ nrm_out) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile], snn[kTile], sbig[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < nq;
  const float qx = live ? dfk::nan_to_num(queries[3 * i]) : 0.0f;
  const float qy = live ? dfk::nan_to_num(queries[3 * i + 1]) : 0.0f;
  const float qz = live ? dfk::nan_to_num(queries[3 * i + 2]) : 0.0f;
  const float qq = (qx * qx + qy * qy) + qz * qz;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0x7fffffff;
  }
  for (int base = 0; base < n; base += kTile) {
    __syncthreads();
    stage_nodes(pos, active, n, base, sx, sy, sz, snn, sbig);
    __syncthreads();
    if (!live) continue;
    const int m = min(kTile, n - base);
    for (int j = 0; j < m; ++j) {
      const float qn = (qx * sx[j] + qy * sy[j]) + qz * sz[j];
      float cd = ((qq - 2.0f * qn) + snn[j]) + sbig[j];
      if (!(cd < bd[K - 1])) continue;
      int ci = base + j;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (cd < bd[s] || (cd == bd[s] && ci < bi[s])) {
          const float td = bd[s];
          const int ti = bi[s];
          bd[s] = cd;
          bi[s] = ci;
          cd = td;
          ci = ti;
        }
      }
    }
  }
  if (!live) return;
  float w[K];
  dfk::DualQuat nb[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const float d2 = fmaxf(bd[s], 0.0f);
    const float r = radius[bi[s]];
    w[s] = expf(-d2 / (2.0f * r * r));
    d2_out[static_cast<size_t>(i) * K + s] = d2;
    idx_out[static_cast<size_t>(i) * K + s] = bi[s];
    w_out[static_cast<size_t>(i) * K + s] = w[s];
  }
  if (qual_out != nullptr) {
    float acc = w[0];
#pragma unroll
    for (int s = 1; s < K; ++s) acc = acc + w[s];
    qual_out[i] = fminf(fmaxf(acc / static_cast<float>(K), 0.0f), 1.0f);
  }
  if (blend_out == nullptr && pts_out == nullptr) return;
#pragma unroll
  for (int s = 0; s < K; ++s) nb[s] = dfk::load_dq(dq + 8 * static_cast<size_t>(bi[s]));
  dfk::DualQuat acc;
#pragma unroll
  for (int s = 0; s < K; ++s) dfk::blend_add(acc, nb[s], w[s], dfk::blend_sign(nb[s].r, nb[0].r), s == 0);
  const dfk::DualQuat b = dfk::dq_normalize(acc);
  if (blend_out != nullptr) dfk::store_dq(blend_out + 8 * static_cast<size_t>(i), b);
  if (pts_out != nullptr) {
    const float px = queries[3 * i];
    const dfk::Vec3 y = dfk::dq_transform(b, {qx, qy, qz});
    const bool bad = isnan(px);
    pts_out[3 * i] = bad ? NAN : y.x;
    pts_out[3 * i + 1] = bad ? NAN : y.y;
    pts_out[3 * i + 2] = bad ? NAN : y.z;
    if (nrm_out != nullptr) {
      const float nx = normals[3 * i];
      const dfk::Vec3 v = {dfk::nan_to_num(nx), dfk::nan_to_num(normals[3 * i + 1]),
                           dfk::nan_to_num(normals[3 * i + 2])};
      const dfk::Vec3 rn = dfk::dq_rotate(b, v);
      const bool nbad = isnan(nx);
      nrm_out[3 * i] = nbad ? NAN : rn.x;
      nrm_out[3 * i + 1] = nbad ? NAN : rn.y;
      nrm_out[3 * i + 2] = nbad ? NAN : rn.z;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mutual_nearest_kernel(const float* __restrict__ pos, const bool* __restrict__ active, int n,
                      const float* __restrict__ cand, const bool* __restrict__ valid, int nc,
                      float* __restrict__ cand_d2, int* __restrict__ node_bits) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile], snn[kTile], sbig[kTile];
  __shared__ int smin[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < nc;
  const bool ok = live && valid[i];
  const float qx = live ? dfk::nan_to_num(cand[3 * i]) : 0.0f;
  const float qy = live ? dfk::nan_to_num(cand[3 * i + 1]) : 0.0f;
  const float qz = live ? dfk::nan_to_num(cand[3 * i + 2]) : 0.0f;
  const float qq = (qx * qx + qy * qy) + qz * qz;
  float best = INFINITY;
  for (int base = 0; base < n; base += kTile) {
    __syncthreads();
    stage_nodes(pos, active, n, base, sx, sy, sz, snn, sbig);
    for (int j = threadIdx.x; j < kTile; j += blockDim.x) smin[j] = __float_as_int(kBig);
    __syncthreads();
    const int m = min(kTile, n - base);
    if (live) {
      for (int j = 0; j < m; ++j) {
        const float qn = (qx * sx[j] + qy * sy[j]) + qz * sz[j];
        const float d = ((qq - 2.0f * qn) + snn[j]) + sbig[j];
        best = fminf(best, d);
        // non-negative floats order as their bit patterns
        if (ok) atomicMin(&smin[j], __float_as_int(fmaxf(d, 0.0f)));
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) atomicMin(&node_bits[base + j], smin[j]);
  }
  if (live) cand_d2[i] = fmaxf(best, 0.0f);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
node_radius_kernel(const float* __restrict__ ref, const bool* __restrict__ ref_ok, int n,
                   const float* __restrict__ queries, int nq, float scale, float rmin, float rmax,
                   float* __restrict__ out) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile], snn[kTile], sbig[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < nq;
  const float qx = live ? queries[3 * i] : 0.0f;
  const float qy = live ? queries[3 * i + 1] : 0.0f;
  const float qz = live ? queries[3 * i + 2] : 0.0f;
  const float qq = __fmaf_rn(qz, qz, __fmaf_rn(qy, qy, qx * qx));
  float bd[K];
#pragma unroll
  for (int s = 0; s < K; ++s) bd[s] = INFINITY;
  for (int base = 0; base < n; base += kTile) {
    __syncthreads();
    for (int j = threadIdx.x; j < kTile && base + j < n; j += blockDim.x) {
      const float px = ref[3 * (base + j)], py = ref[3 * (base + j) + 1], pz = ref[3 * (base + j) + 2];
      sx[j] = px;
      sy[j] = py;
      sz[j] = pz;
      snn[j] = __fmaf_rn(pz, pz, __fmaf_rn(py, py, px * px));
      sbig[j] = ref_ok[base + j] ? 0.0f : kBig;
    }
    __syncthreads();
    if (!live) continue;
    const int m = min(kTile, n - base);
    for (int j = 0; j < m; ++j) {
      const float qn = __fmaf_rn(qz, sz[j], __fmaf_rn(qy, sy[j], qx * sx[j]));
      float cd = ((qq - 2.0f * qn) + snn[j]) + sbig[j];
      if (!(cd < bd[K - 1])) continue;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (cd < bd[s]) {
          const float t = bd[s];
          bd[s] = cd;
          cd = t;
        }
      }
    }
  }
  if (!live) return;
  float r = scale * sqrtf(fmaxf(bd[K - 1], 0.0f));
  r = r < rmin ? rmin : r;
  out[i] = r > rmax ? rmax : r;
}

__global__ void fill_bits_kernel(int* __restrict__ bits, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) bits[i] = __float_as_int(kBig);
}

__global__ void bits_to_float_kernel(const int* __restrict__ bits, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __int_as_float(bits[i]);
}

__global__ void __launch_bounds__(kThreads)
warp_trilinear_kernel(const float* __restrict__ grid, int dc, const float* __restrict__ pts,
                      const float* __restrict__ nrm, int nq, float ox, float oy, float oz, float cell,
                      float* __restrict__ pts_out, float* __restrict__ nrm_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const dfk::Vec3 p = {dfk::nan_to_num(pts[3 * i]), dfk::nan_to_num(pts[3 * i + 1]),
                       dfk::nan_to_num(pts[3 * i + 2])};
  const float g[3] = {(p.x - ox) / cell, (p.y - oy) / cell, (p.z - oz) / cell};
  float f[3];
  int gi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float fl = fminf(fmaxf(floorf(g[a]), 0.0f), static_cast<float>(dc - 2));
    f[a] = fminf(fmaxf(g[a] - fl, 0.0f), 1.0f);
    gi[a] = static_cast<int>(fl);
  }
  const size_t base = (static_cast<size_t>(gi[0]) * dc + gi[1]) * dc + gi[2];
  dfk::DualQuat pivot, acc;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const float wx = dx ? f[0] : 1.0f - f[0];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wy = dy ? f[1] : 1.0f - f[1];
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const float wz = dz ? f[2] : 1.0f - f[2];
        const int s = dx * 4 + dy * 2 + dz;
        const dfk::DualQuat a = dfk::load_dq(grid + 8 * (base + (static_cast<size_t>(dx) * dc + dy) * dc + dz));
        if (s == 0) pivot = a;
        dfk::blend_add(acc, a, (wx * wy) * wz, dfk::blend_sign(a.r, pivot.r), s == 0);
      }
    }
  }
  const dfk::DualQuat b = dfk::dq_normalize(acc);
  const dfk::Vec3 y = dfk::dq_transform(b, p);
  const bool bad = isnan(pts[3 * i]);
  pts_out[3 * i] = bad ? NAN : y.x;
  pts_out[3 * i + 1] = bad ? NAN : y.y;
  pts_out[3 * i + 2] = bad ? NAN : y.z;
  const dfk::Vec3 v = {dfk::nan_to_num(nrm[3 * i]), dfk::nan_to_num(nrm[3 * i + 1]), dfk::nan_to_num(nrm[3 * i + 2])};
  const dfk::Vec3 rn = dfk::dq_rotate(b, v);
  const bool nbad = isnan(nrm[3 * i]);
  nrm_out[3 * i] = nbad ? NAN : rn.x;
  nrm_out[3 * i + 1] = nbad ? NAN : rn.y;
  nrm_out[3 * i + 2] = nbad ? NAN : rn.z;
}

}  // namespace

extern "C" int df_knn_blend(const void* pos, const void* active, const void* radius, const void* dq, int n,
                            const void* queries, const void* normals, int nq, int k, void* d2, void* idx,
                            void* w, void* blend, void* qual, void* pts_out, void* nrm_out, void* stream) {
  if (nq <= 0) return 0;
  const int blocks = (nq + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DF_KNN_ARGS                                                                                   \
  static_cast<const float*>(pos), static_cast<const bool*>(active), static_cast<const float*>(radius), \
      static_cast<const float*>(dq), n, static_cast<const float*>(queries),                            \
      static_cast<const float*>(normals), nq, static_cast<float*>(d2), static_cast<int64_t*>(idx),      \
      static_cast<float*>(w), static_cast<float*>(blend), static_cast<float*>(qual),                    \
      static_cast<float*>(pts_out), static_cast<float*>(nrm_out)
  if (k == 8) {
    knn_blend_kernel<8><<<blocks, kThreads, 0, s>>>(DF_KNN_ARGS);
  } else if (k == 5) {
    knn_blend_kernel<5><<<blocks, kThreads, 0, s>>>(DF_KNN_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DF_KNN_ARGS
  return static_cast<int>(cudaGetLastError());
}

extern "C" int df_mutual_nearest(const void* pos, const void* active, int n, const void* cand, const void* valid,
                                 int nc, void* cand_d2, void* node_bits, void* node_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_bits_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<int*>(node_bits), n);
  if (nc > 0) {
    mutual_nearest_kernel<<<(nc + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const float*>(pos), static_cast<const bool*>(active), n, static_cast<const float*>(cand),
        static_cast<const bool*>(valid), nc, static_cast<float*>(cand_d2), static_cast<int*>(node_bits));
  }
  bits_to_float_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const int*>(node_bits),
                                                        static_cast<float*>(node_d2), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int df_warp_trilinear(const void* grid, int dc, const void* pts, const void* nrm, int nq, float ox,
                                 float oy, float oz, float cell, void* pts_out, void* nrm_out, void* stream) {
  if (nq <= 0) return 0;
  warp_trilinear_kernel<<<(nq + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), dc, static_cast<const float*>(pts), static_cast<const float*>(nrm), nq,
      ox, oy, oz, cell, static_cast<float*>(pts_out), static_cast<float*>(nrm_out));
  return static_cast<int>(cudaGetLastError());
}

// radius (Q,) of each query: clip(scale x the k-th smallest squared
// distance's root, rmin, rmax) over the active reference nodes (1 <= k <= 16)
extern "C" int df_node_radius(const void* ref, const void* ref_ok, int n, const void* queries, int nq, int k,
                              float scale, float rmin, float rmax, void* out, void* stream) {
  if (nq <= 0) return 0;
  const int blocks = (nq + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DF_RADIUS(K)                                                                                        \
  case K:                                                                                                   \
    node_radius_kernel<K><<<blocks, kThreads, 0, s>>>(static_cast<const float*>(ref),                       \
                                                      static_cast<const bool*>(ref_ok), n,                  \
                                                      static_cast<const float*>(queries), nq, scale, rmin, \
                                                      rmax, static_cast<float*>(out));                      \
    break;
  switch (k) {
    DF_RADIUS(1) DF_RADIUS(2) DF_RADIUS(3) DF_RADIUS(4) DF_RADIUS(5) DF_RADIUS(6) DF_RADIUS(7) DF_RADIUS(8)
    DF_RADIUS(9) DF_RADIUS(10) DF_RADIUS(11) DF_RADIUS(12) DF_RADIUS(13) DF_RADIUS(14) DF_RADIUS(15) DF_RADIUS(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DF_RADIUS
  return static_cast<int>(cudaGetLastError());
}
