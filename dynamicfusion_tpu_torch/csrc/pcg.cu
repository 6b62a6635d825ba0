// Kernel G: the warp solver's ARAP edge term and its factored linear
// solve: edge residuals, Jacobians and blocks, the factored matvec,
// spd6_inv, the block-Jacobi apply and the whole PCG solve.
//
// Replaces dynamicfusion_tpu/solvers/warp_solver.py:133 _edge_residual
// with :341 edge_residual_and_jac (vmap(jacrev)), :685 edge_blocks, :663
// edge_jtr, :714 edge_matvec, :772 _sym3_inv, :792 spd6_inv, :823 _pcg and
// the factored matvec mv of solve (:1228-1240: two bf16 matmuls of the
// (P, 6N) one-hot-expanded row matrix on the MXU).
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700.00 W: 3.35 TB/s, 67 TFLOP/s
// float32, data-sheet peaks; measured times in PERF.md): latency. One matvec
// at the preset's shapes reads the bf16 rows (3 200 x R x 8 x 6 x 2 B = 0.3 MB
// a residual row; R = 3 with the tangential term),
// the per-edge blocks (4 096 x 3 x 144 B = 1.8 MB) and a few 6 144-long
// vectors, and does ~1.3 MFLOP; twelve PCG iterations are ~25 MB and ~16
// MFLOP, a few microseconds of bandwidth on the whole card. The iterations are
// sequential and each needs three global dot products, so a multi-kernel PCG
// would pay ~40 launches and a host round trip per early-exit test.
// Design: the whole PCG solve is ONE launch of one 1024-thread block.
// Each thread owns whole nodes (their 6 dofs) for every vector update;
// the matvec runs in two phases (one thread per (point, row): t =
// bf16(row · bf16(p)); one thread per node: the node's data entries from the
// per-solve node-sorted list, its source-side edges (edge e = node * k +
// c) and its destination-side edges from a second sorted list, plus the
// damping); dot products are fixed-order block reductions. The early exit
// on rᵀr <= rtol² bᵀb is a uniform branch inside the kernel, and an
// `active` flag in device memory turns the launch into x = 0, so an LM
// iteration that is past convergence costs nothing and the host never
// reads a value. The bf16 rounding points are the JAX package's: the
// vector and the intermediate t are rounded, sums run in float32. The row
// modes of the tangential term (:1035-1085) are arguments of the matvec:
// solver_p2p_lag_hessian reads only the plane row of each point, and
// solver_p2p_hessian_stride = s the plane row of every point and the two
// tangential rows of the points pt % s == 0 (pt in the solve structure's
// order, JAX's jac[::s]), which kernel F wrote as bf16(sqrt(s) jac); rows
// out of the matrix are neither read nor summed.
// The edge entry is one thread per edge (closed-form Jacobians from
// dq.cuh) and one thread per node for its share of Jᵀr and of the
// diagonal blocks, again in list order; spd6_inv is one thread per node,
// the Schur-complement closed form of the plain version.
#include <cuda_bf16.h>

#include "common.cuh"
#include "dq.cuh"
#include "reduce.cuh"

namespace {

constexpr int kK = 8;
constexpr int kThreads = 128;
constexpr int kBlock = 1024;

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// ---------------------------------------------------------------- edges

__global__ void __launch_bounds__(kThreads)
edge_kernel(const float* __restrict__ dqs, const int64_t* __restrict__ src, const int64_t* __restrict__ dst,
            const bool* __restrict__ valid, const float* __restrict__ v_dst, const float* __restrict__ alpha,
            int ne, float lam, float delta, float* __restrict__ h_ii, float* __restrict__ h_jj,
            float* __restrict__ h_ij, float* __restrict__ g_i, float* __restrict__ g_j,
            float* __restrict__ cost_e) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ne) return;
  const dfk::DualQuat ai = dfk::load_dq(dqs + 8 * src[e]);
  const dfk::DualQuat aj = dfk::load_dq(dqs + 8 * dst[e]);
  const dfk::Vec3 v = {v_dst[3 * e], v_dst[3 * e + 1], v_dst[3 * e + 2]};
  const dfk::Vec3 ti = dfk::dq_transform(ai, v);
  const dfk::Vec3 tj = dfk::dq_transform(aj, v);
  const float re[3] = {ti.x - tj.x, ti.y - tj.y, ti.z - tj.z};
  const float ren = sqrtf((re[0] * re[0] + re[1] * re[1]) + re[2] * re[2]);
  const float la = lam * alpha[e];
  const float ok = valid[e] ? 1.0f : 0.0f;
  const float hub = ren <= delta ? 1.0f : sqrtf(delta / fmaxf(ren, 1e-20f));
  const float swe = (hub * ok) * sqrtf(la);
  const float rho = ren <= delta ? 0.5f * ren * ren : delta * (ren - 0.5f * delta);
  cost_e[e] = (rho * ok) * la;
  float ji[3][6], jj[3][6];
  const dfk::Vec3 axes[3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dfk::Quat gr, gd;
    dfk::grad_transform(ai.r, ai.d, v, axes[c], gr, gd);
    dfk::twist_row(gr, gd, ai, swe, ji[c]);
    dfk::grad_transform(aj.r, aj.d, v, axes[c], gr, gd);
    dfk::twist_row(gr, gd, aj, -swe, jj[c]);
  }
  const float rw[3] = {re[0] * swe, re[1] * swe, re[2] * swe};
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    g_i[6 * e + a] = (ji[0][a] * rw[0] + ji[1][a] * rw[1]) + ji[2][a] * rw[2];
    g_j[6 * e + a] = (jj[0][a] * rw[0] + jj[1][a] * rw[1]) + jj[2][a] * rw[2];
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      h_ii[36 * e + 6 * a + b] = (ji[0][a] * ji[0][b] + ji[1][a] * ji[1][b]) + ji[2][a] * ji[2][b];
      h_jj[36 * e + 6 * a + b] = (jj[0][a] * jj[0][b] + jj[1][a] * jj[1][b]) + jj[2][a] * jj[2][b];
      h_ij[36 * e + 6 * a + b] = (ji[0][a] * jj[0][b] + ji[1][a] * jj[1][b]) + ji[2][a] * jj[2][b];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
edge_nodes_kernel(const float* __restrict__ h_ii, const float* __restrict__ h_jj, const float* __restrict__ g_i,
                  const float* __restrict__ g_j, const int* __restrict__ e_order, const int* __restrict__ e_off,
                  int n, int kc, float* __restrict__ jtr, float* __restrict__ diag) {
  const int nd = blockIdx.x * blockDim.x + threadIdx.x;
  if (nd >= n) return;
  float g[6], h[36];
#pragma unroll
  for (int a = 0; a < 6; ++a) g[a] = 0.0f;
#pragma unroll
  for (int a = 0; a < 36; ++a) h[a] = 0.0f;
  for (int c = 0; c < kc; ++c) {
    const int e = nd * kc + c;
#pragma unroll
    for (int a = 0; a < 6; ++a) g[a] += g_i[6 * e + a];
#pragma unroll
    for (int a = 0; a < 36; ++a) h[a] += h_ii[36 * e + a];
  }
  for (int q = e_off[nd]; q < e_off[nd + 1]; ++q) {
    const int e = e_order[q];
#pragma unroll
    for (int a = 0; a < 6; ++a) g[a] += g_j[6 * e + a];
#pragma unroll
    for (int a = 0; a < 36; ++a) h[a] += h_jj[36 * e + a];
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) jtr[6 * nd + a] = g[a];
  if (diag != nullptr) {
#pragma unroll
    for (int a = 0; a < 36; ++a) diag[36 * nd + a] = h[a];
  }
}

// ---------------------------------------------------------------- spd6_inv

struct Sym3 {
  float m[3][3];
};

__device__ __forceinline__ Sym3 sym3_inv(const float a[3][3]) {
  const float a11 = a[0][0], a12 = a[0][1], a13 = a[0][2];
  const float a22 = a[1][1], a23 = a[1][2], a33 = a[2][2];
  const float c11 = a22 * a33 - a23 * a23;
  const float c12 = a13 * a23 - a12 * a33;
  const float c13 = a12 * a23 - a13 * a22;
  const float c22 = a11 * a33 - a13 * a13;
  const float c23 = a12 * a13 - a11 * a23;
  const float c33 = a11 * a22 - a12 * a12;
  const float det = a11 * c11 + a12 * c12 + a13 * c13;
  const float sg = det > 0.0f ? 1.0f : (det < 0.0f ? -1.0f : 0.0f);
  const float inv = sg / fmaxf(fabsf(det), 1e-30f);
  return {{{c11 * inv, c12 * inv, c13 * inv}, {c12 * inv, c22 * inv, c23 * inv}, {c13 * inv, c23 * inv, c33 * inv}}};
}

__device__ __forceinline__ void spd6_inv_one(const float* __restrict__ m, float* __restrict__ out) {
  float a[3][3], b[3][3], c[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = m[6 * i + j];
      b[i][j] = m[6 * i + 3 + j];
      c[i][j] = m[6 * (3 + i) + 3 + j];
    }
  }
  const Sym3 ai = sym3_inv(a);
  float aib[3][3], schur[3][3], sym[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) aib[i][j] = (ai.m[i][0] * b[0][j] + ai.m[i][1] * b[1][j]) + ai.m[i][2] * b[2][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      schur[i][j] = c[i][j] - ((b[0][i] * aib[0][j] + b[1][i] * aib[1][j]) + b[2][i] * aib[2][j]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) sym[i][j] = 0.5f * (schur[i][j] + schur[j][i]);
  const Sym3 si = sym3_inv(sym);
  float t[3][3];  // aib @ si
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) t[i][j] = (aib[i][0] * si.m[0][j] + aib[i][1] * si.m[1][j]) + aib[i][2] * si.m[2][j];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[6 * i + j] = ai.m[i][j] + ((t[i][0] * aib[j][0] + t[i][1] * aib[j][1]) + t[i][2] * aib[j][2]);
      out[6 * i + 3 + j] = -t[i][j];
      out[6 * (3 + i) + j] = -t[j][i];
      out[6 * (3 + i) + 3 + j] = si.m[i][j];
    }
  }
}

__global__ void spd6_inv_kernel(const float* __restrict__ m, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) spd6_inv_one(m + 36 * static_cast<size_t>(i), out + 36 * static_cast<size_t>(i));
}

// ---------------------------------------------------------------- matvec and PCG

struct Sys {
  const __nv_bfloat16* rows;  // (P, R, K, 6): R = 1 point-to-plane, 3 with the tangential rows
  const int* idx;             // (P, K)
  const int* pt_order;        // (P K,) entries sorted by node
  const int* pt_off;          // (N + 1,)
  const float* h_ii;          // (E, 36)
  const float* h_jj;
  const float* h_ij;
  const int* e_dst;   // (E,)
  const int* e_order;  // (E,) edges sorted by dst
  const int* e_off;    // (N + 1,)
  const float* damp;   // (6N,)
  int np, n, kc;
  // the tangential rows' stride of the strided row mode
  int stride;
};

// the row modes of the matvec, template arguments so that the three-row
// matrix keeps its own code: every row of every point; the plane rows only
// (solver_p2p_lag_hessian); the plane row of every point and the
// tangential rows of the points pt % stride == 0 (solver_p2p_hessian_stride,
// rows kernel F wrote scaled by sqrt(stride))
enum RowMode { kAllRows = 0, kPlaneRows = 1, kStridedRows = 2 };

// the rows of point pt in the matrix
template <int R, int M>
__device__ __forceinline__ int rows_in(const Sys& S, int pt) {
  if constexpr (M == kAllRows) return R;
  else if constexpr (M == kPlaneRows) return 1;
  else return pt % S.stride == 0 ? R : 1;
}

// ap = A p for the whole block, R residual rows a point; t is (P R,)
// scratch, one entry per (point, row). Ends synchronized.
template <int R, int M>
__device__ void block_matvec(const Sys& S, const float* __restrict__ p, float* __restrict__ ap,
                             float* __restrict__ t) {
  // (point, row) pairs; the plane-rows mode walks the points' plane rows only
  const int nq = M == kPlaneRows ? S.np : S.np * R;
  for (int i = threadIdx.x; i < nq; i += blockDim.x) {
    const int q = M == kPlaneRows ? i * R : i;
    const int pt = q / R;
    if constexpr (M == kStridedRows) {
      if (q - pt * R >= rows_in<R, M>(S, pt)) continue;
    }
    float acc = 0.0f;
    for (int k = 0; k < kK; ++k) {
      const int nd = S.idx[pt * kK + k];
      const __nv_bfloat16* r = S.rows + (static_cast<size_t>(q) * kK + k) * 6;
#pragma unroll
      for (int d = 0; d < 6; ++d) acc += __bfloat162float(r[d]) * bf16r(p[6 * nd + d]);
    }
    t[q] = bf16r(acc);
  }
  __syncthreads();
  for (int nd = threadIdx.x; nd < S.n; nd += blockDim.x) {
    float dat[6] = {0, 0, 0, 0, 0, 0}, edg[6] = {0, 0, 0, 0, 0, 0};
    for (int q = S.pt_off[nd]; q < S.pt_off[nd + 1]; ++q) {
      const int ent = S.pt_order[q];
      const int pt = ent / kK;
      // row j of entry (pt, k) of the (P, R, K, 6) rows: ent + (pt (R - 1) + j) K
      const size_t e0 = static_cast<size_t>(ent) + static_cast<size_t>(pt) * (R - 1) * kK;
      // an entry's rows are summed first, as the plain version does
      const int nrow = rows_in<R, M>(S, pt);
      float s[6];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (M != kAllRows && j >= nrow) continue;
        const float tv = t[pt * R + j];
        const __nv_bfloat16* r = S.rows + (e0 + j * kK) * 6;
#pragma unroll
        for (int d = 0; d < 6; ++d) s[d] = j == 0 ? __bfloat162float(r[d]) * tv : s[d] + __bfloat162float(r[d]) * tv;
      }
#pragma unroll
      for (int d = 0; d < 6; ++d) dat[d] += s[d];
    }
    float pn[6];
#pragma unroll
    for (int d = 0; d < 6; ++d) pn[d] = p[6 * nd + d];
    for (int c = 0; c < S.kc; ++c) {  // source side: q_i = h_ii p_i + h_ij p_j
      const int e = nd * S.kc + c;
      const int j = S.e_dst[e];
      const float* hii = S.h_ii + 36 * static_cast<size_t>(e);
      const float* hij = S.h_ij + 36 * static_cast<size_t>(e);
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        float s = 0.0f;
#pragma unroll
        for (int b = 0; b < 6; ++b) s += hii[6 * a + b] * pn[b];
#pragma unroll
        for (int b = 0; b < 6; ++b) s += hij[6 * a + b] * p[6 * j + b];
        edg[a] += s;
      }
    }
    for (int q = S.e_off[nd]; q < S.e_off[nd + 1]; ++q) {  // dst side: q_j = h_ijᵀ p_i + h_jj p_j
      const int e = S.e_order[q];
      const int i = e / S.kc;
      const float* hjj = S.h_jj + 36 * static_cast<size_t>(e);
      const float* hij = S.h_ij + 36 * static_cast<size_t>(e);
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        float s = 0.0f;
#pragma unroll
        for (int b = 0; b < 6; ++b) s += hij[6 * b + a] * p[6 * i + b];
#pragma unroll
        for (int b = 0; b < 6; ++b) s += hjj[6 * a + b] * pn[b];
        edg[a] += s;
      }
    }
#pragma unroll
    for (int d = 0; d < 6; ++d) ap[6 * nd + d] = (dat[d] + edg[d]) + S.damp[6 * nd + d] * pn[d];
  }
  __syncthreads();
}

// sum over the thread's nodes of a·b
__device__ float node_dot(const float* a, const float* b, int n) {
  float s = 0.0f;
  for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
#pragma unroll
    for (int d = 0; d < 6; ++d) s += a[6 * nd + d] * b[6 * nd + d];
  }
  return s;
}

__device__ void apply_m(const float* __restrict__ minv, const float* __restrict__ r, float* __restrict__ z, int n) {
  for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
    const float* m = minv + 36 * static_cast<size_t>(nd);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      float s = 0.0f;
#pragma unroll
      for (int b = 0; b < 6; ++b) s += m[6 * a + b] * r[6 * nd + b];
      z[6 * nd + a] = s;
    }
  }
}

template <int R, int M>
__global__ void __launch_bounds__(kBlock) matvec_kernel(Sys S, const float* __restrict__ p, float* __restrict__ ap,
                                                        float* __restrict__ t) {
  block_matvec<R, M>(S, p, ap, t);
}

template <int R, int M>
__global__ void __launch_bounds__(kBlock)
pcg_kernel(Sys S, const float* __restrict__ minv, const float* __restrict__ b, int iters, float rtol2,
           const bool* __restrict__ active, float* __restrict__ x, float* __restrict__ work) {
  __shared__ float red[33];
  const int n = S.n;
  const int dof = 6 * n;
  if (!*active) {
    for (int i = threadIdx.x; i < dof; i += blockDim.x) x[i] = 0.0f;
    return;
  }
  float* r = work;
  float* p = work + dof;
  float* z = work + 2 * dof;
  float* ap = work + 3 * dof;
  float* t = work + 4 * dof;
  // every vector update below is done by the thread that owns the node
  for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      x[6 * nd + d] = 0.0f;
      r[6 * nd + d] = b[6 * nd + d];
    }
  }
  apply_m(minv, b, z, n);
  for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
#pragma unroll
    for (int d = 0; d < 6; ++d) p[6 * nd + d] = z[6 * nd + d];
  }
  const float stop2 = rtol2 * block_sum(node_dot(b, b, n), red);
  float rz = block_sum(node_dot(b, z, n), red);  // r = b here
  for (int it = 0; it < iters; ++it) {
    const float rr = block_sum(node_dot(r, r, n), red);
    if (!(rr > stop2)) break;
    block_matvec<R, M>(S, p, ap, t);
    const float alpha = rz / fmaxf(block_sum(node_dot(p, ap, n), red), 1e-30f);
    for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        const int i = 6 * nd + d;
        x[i] = x[i] + alpha * p[i];
        r[i] = r[i] - alpha * ap[i];
      }
    }
    apply_m(minv, r, z, n);
    const float rz_new = block_sum(node_dot(r, z, n), red);
    const float beta = rz_new / fmaxf(rz, 1e-30f);
    for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
#pragma unroll
      for (int d = 0; d < 6; ++d) p[6 * nd + d] = z[6 * nd + d] + beta * p[6 * nd + d];
    }
    rz = rz_new;
    __syncthreads();
  }
}

Sys make_sys(const void* rows, const void* idx, const void* pt_order, const void* pt_off, const void* h_ii,
             const void* h_jj, const void* h_ij, const void* e_dst, const void* e_order, const void* e_off,
             const void* damp, int np, int n, int kc, int stride) {
  return {static_cast<const __nv_bfloat16*>(rows), static_cast<const int*>(idx), static_cast<const int*>(pt_order),
          static_cast<const int*>(pt_off), static_cast<const float*>(h_ii), static_cast<const float*>(h_jj),
          static_cast<const float*>(h_ij), static_cast<const int*>(e_dst), static_cast<const int*>(e_order),
          static_cast<const int*>(e_off), static_cast<const float*>(damp), np, n, kc, stride};
}

// the row mode of (R rows, ``used`` of them, tangential ``stride``), -1 if invalid
int row_mode(int nrows, int used, int stride) {
  if (!(nrows == 1 || nrows == 3) || !(used == 1 || used == nrows) || stride < 1) return -1;
  if (nrows == 1 || (used == nrows && stride == 1)) return kAllRows;
  if (used == 1) return stride == 1 ? kPlaneRows : -1;
  return kStridedRows;
}

}  // namespace

extern "C" int df_edge_term(const void* dqs, const void* src, const void* dst, const void* valid, const void* v_dst,
                            const void* alpha, int ne, int n, const void* e_order, const void* e_off, float lam,
                            float delta, void* h_ii, void* h_jj, void* h_ij, void* g_i, void* g_j, void* cost_e,
                            void* jtr, void* diag, void* cost, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ne % n != 0) return static_cast<int>(cudaErrorInvalidValue);
  edge_kernel<<<(ne + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(dqs), static_cast<const int64_t*>(src), static_cast<const int64_t*>(dst),
      static_cast<const bool*>(valid), static_cast<const float*>(v_dst), static_cast<const float*>(alpha), ne, lam,
      delta, static_cast<float*>(h_ii), static_cast<float*>(h_jj), static_cast<float*>(h_ij),
      static_cast<float*>(g_i), static_cast<float*>(g_j), static_cast<float*>(cost_e));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_nodes_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(h_ii), static_cast<const float*>(h_jj), static_cast<const float*>(g_i),
      static_cast<const float*>(g_j), static_cast<const int*>(e_order), static_cast<const int*>(e_off), n, ne / n,
      static_cast<float*>(jtr), static_cast<float*>(diag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_kernel<<<1, kReduceThreads, 0, s>>>(static_cast<const float*>(cost_e), ne, static_cast<float*>(cost));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int df_spd6_inv(const void* m, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  spd6_inv_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int df_matvec(const void* rows, const void* idx, const void* pt_order, const void* pt_off, const void* h_ii,
                         const void* h_jj, const void* h_ij, const void* e_dst, const void* e_order, const void* e_off,
                         const void* damp, int np, int n, int kc, int nrows, int used, int stride, const void* p,
                         void* ap, void* t, void* stream) {
  const int mode = row_mode(nrows, used, stride);
  if (mode < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Sys S = make_sys(rows, idx, pt_order, pt_off, h_ii, h_jj, h_ij, e_dst, e_order, e_off, damp, np, n, kc, stride);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pp = static_cast<const float*>(p);
  float* a = static_cast<float*>(ap);
  float* tt = static_cast<float*>(t);
  if (nrows == 1) {
    matvec_kernel<1, kAllRows><<<1, kBlock, 0, st>>>(S, pp, a, tt);
  } else if (mode == kAllRows) {
    matvec_kernel<3, kAllRows><<<1, kBlock, 0, st>>>(S, pp, a, tt);
  } else if (mode == kPlaneRows) {
    matvec_kernel<3, kPlaneRows><<<1, kBlock, 0, st>>>(S, pp, a, tt);
  } else {
    matvec_kernel<3, kStridedRows><<<1, kBlock, 0, st>>>(S, pp, a, tt);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int df_pcg(const void* rows, const void* idx, const void* pt_order, const void* pt_off, const void* h_ii,
                      const void* h_jj, const void* h_ij, const void* e_dst, const void* e_order, const void* e_off,
                      const void* damp, int np, int n, int kc, int nrows, int used, int stride, const void* minv,
                      const void* b, int iters, float rtol2, const void* active, void* x, void* work, void* stream) {
  const int mode = row_mode(nrows, used, stride);
  if (mode < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Sys S = make_sys(rows, idx, pt_order, pt_off, h_ii, h_jj, h_ij, e_dst, e_order, e_off, damp, np, n, kc, stride);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(minv);
  const float* bb = static_cast<const float*>(b);
  const bool* on = static_cast<const bool*>(active);
  float* xv = static_cast<float*>(x);
  float* w = static_cast<float*>(work);
  if (nrows == 1) {
    pcg_kernel<1, kAllRows><<<1, kBlock, 0, st>>>(S, m, bb, iters, rtol2, on, xv, w);
  } else if (mode == kAllRows) {
    pcg_kernel<3, kAllRows><<<1, kBlock, 0, st>>>(S, m, bb, iters, rtol2, on, xv, w);
  } else if (mode == kPlaneRows) {
    pcg_kernel<3, kPlaneRows><<<1, kBlock, 0, st>>>(S, m, bb, iters, rtol2, on, xv, w);
  } else {
    pcg_kernel<3, kStridedRows><<<1, kBlock, 0, st>>>(S, m, bb, iters, rtol2, on, xv, w);
  }
  return static_cast<int>(cudaGetLastError());
}
