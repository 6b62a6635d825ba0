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
// would pay ~40 launches and a host round trip per early-exit test; and
// the node lists are skewed (the base config's largest node holds 1 151
// entries, the mean is 25), so one thread walking a node's list serially
// waits on the heaviest node every iteration.
// Design: the whole PCG solve is ONE launch of a thread-block cluster of
// kPcgCluster = 16 CTAs (the non-portable maximum) of kPcgThreads = 512
// threads (the wrapper refuses a cluster the card cannot schedule),
// phases separated by the cluster's hardware barrier. Each CTA owns a
// contiguous range of nodes for the vector updates (x, r, z, p) and the
// block-Jacobi apply. After each
// update of p every CTA writes its slice of p into every CTA's copy of p in
// shared memory (distributed shared memory), so the matvec's gathers read
// local shared memory; where 6N values and a CTA's r, z and x do not fit
// in shared memory (~8 500 nodes), the same kernel (template
// flag) keeps them in device memory. The matvec runs in two phases: one thread per
// (point, row) over the cluster: t = bf16(row · bf16(p)); then one WARP per
// node, nodes taken heaviest first (the per-solve order ``heavy``): lane l
// walks the node's data entries l, l + 32, ... of the per-solve
// node-sorted list (each entry's rows summed first) and its edge items
// (the kc source-side edges e = node * kc + c, then the destination-side
// edges of a second sorted list), and a fixed shuffle tree (16, 8, 4, 2, 1)
// adds the lanes, so a 1 151-entry node takes 36 steps and one warp, not
// one thread, sums each node. Dot products are deterministic and the same
// in every CTA: each CTA sums its share in a fixed order (threads, a
// shuffle tree, warps in order), writes the partial into a slot of every
// CTA, and after the barrier every CTA adds the C partials in rank order;
// rᵀr and rᵀz of one update share one exchange. So the early exit on rᵀr
// <= rtol² bᵀb branches alike in every CTA, no CTA waits at a barrier the
// others skipped, and a launch gives the same bits every run. An `active`
// flag in device memory turns the launch into x = 0, so an LM iteration
// that is past convergence costs nothing and the host never reads a value.
// A last cluster barrier keeps every CTA resident until no other can write
// into its shared memory. The bf16 rounding points are the JAX package's:
// the vector and the intermediate t are rounded, and everything runs in
// float32, as the JAX package's solve does (float64 would change the
// solve's behaviour, not only its bits: PERF.md §6). The
// row modes of the tangential term (:1035-1085) are arguments of the
// matvec: solver_p2p_lag_hessian reads only the plane row of each point,
// and solver_p2p_hessian_stride = s the plane row of every point and the
// two tangential rows of the points pt % s == 0 (pt in the solve
// structure's order, JAX's jac[::s]), which kernel F wrote as bf16(sqrt(s)
// jac); rows out of the matrix are neither read nor summed. The single
// matvec entry is the same cluster's two phases.
// The distributed PCG's data-only matvec of a shard (two launches: a
// thread per (point, row), then a warp per node, heaviest first, with the
// PCG's per-lane walk and shuffle tree) and its edge step (a thread per
// node, the serial walk) are below.
// The edge entry (closed-form Jacobians from dq.cuh) is one launch: a
// block owns eight nodes and their source edges, six threads an edge
// (side x residual axis) write the two 3x6 Jacobians to shared memory,
// the block writes the edges' three 6x6 blocks and two gradients with
// neighbouring threads on neighbouring addresses (the design before, a
// thread an edge, stored at a 144 B stride a lane from 32 blocks at the
// preset's 4 096 edges), and a thread a (node, entry) sums its node's 42
// entries in list order. A node's destination-side edges belong to other
// blocks; the block evaluates them again (~2 000 operations an edge)
// rather than order a node phase after a grid-wide edge phase: the same
// code under the same flags gives the same bits, so no block waits on
// another, and the only cross-block step is the cost's ordered sum,
// which the last block to finish takes (a ticket). spd6_inv is one
// thread per node, the Schur-complement closed form of the plain version.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"
#include "dq.cuh"
#include "reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kK = 8;
constexpr int kThreads = 128;

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// ---------------------------------------------------------------- edges

struct EdgeArgs {
  const float* dqs;
  const int64_t* src;
  const int64_t* dst;
  const bool* valid;
  const float* v_dst;
  const float* alpha;
  float lam, delta;
};

// edge e's endpoints, its Huber- and alpha-weighted residual scale swe and
// its cost: the same operations wherever an edge is evaluated, so every
// thread that evaluates edge e gets the same bits
struct EdgeEval {
  dfk::DualQuat ai, aj;
  dfk::Vec3 v;
  float re[3];
  float swe, cost;
};

__device__ __forceinline__ EdgeEval edge_eval(const EdgeArgs& a, int e) {
  EdgeEval r;
  r.ai = dfk::load_dq(a.dqs + 8 * a.src[e]);
  r.aj = dfk::load_dq(a.dqs + 8 * a.dst[e]);
  r.v = {a.v_dst[3 * e], a.v_dst[3 * e + 1], a.v_dst[3 * e + 2]};
  const dfk::Vec3 ti = dfk::dq_transform(r.ai, r.v);
  const dfk::Vec3 tj = dfk::dq_transform(r.aj, r.v);
  r.re[0] = ti.x - tj.x;
  r.re[1] = ti.y - tj.y;
  r.re[2] = ti.z - tj.z;
  const float ren = sqrtf((r.re[0] * r.re[0] + r.re[1] * r.re[1]) + r.re[2] * r.re[2]);
  const float la = a.lam * a.alpha[e];
  const float ok = a.valid[e] ? 1.0f : 0.0f;
  const float hub = ren <= a.delta ? 1.0f : sqrtf(a.delta / fmaxf(ren, 1e-20f));
  r.swe = (hub * ok) * sqrtf(la);
  const float rho = ren <= a.delta ? 0.5f * ren * ren : a.delta * (ren - 0.5f * a.delta);
  r.cost = (rho * ok) * la;
  return r;
}

// row c (the residual's axis c) of the weighted Jacobian of side 0 (J_i,
// the source node's twist) or side 1 (J_j, the destination's)
__device__ __forceinline__ void edge_row(const EdgeEval& r, int side, int c, float out[6]) {
  const dfk::Vec3 axis = {c == 0 ? 1.0f : 0.0f, c == 1 ? 1.0f : 0.0f, c == 2 ? 1.0f : 0.0f};
  const dfk::DualQuat a = side == 0 ? r.ai : r.aj;  // a copy: a reference would put r in local memory
  dfk::Quat gr, gd;
  dfk::grad_transform(a.r, a.d, r.v, axis, gr, gd);
  dfk::twist_row(gr, gd, a, side == 0 ? r.swe : -r.swe, out);
}

// (J_xᵀ J_y)[p][q] and (J_xᵀ r_w)[p] from the rows, summed over the three
// residual axes in order
__device__ __forceinline__ float jtj_entry(const float (*x)[6], const float (*y)[6], int p, int q) {
  return (x[0][p] * y[0][q] + x[1][p] * y[1][q]) + x[2][p] * y[2][q];
}

__device__ __forceinline__ float jtr_entry(const float (*x)[6], const float* rw, int p) {
  return (x[0][p] * rw[0] + x[1][p] * rw[1]) + x[2][p] * rw[2];
}

// the one-launch edge term. Block b owns the nodes [b kEdgeNodes, ...) and
// their source edges e = node * kc + c. Its jobs, in order: those source
// edges (both sides), then the destination-side edges of its nodes in
// e_order (side 1 only, evaluated again here: the edge's owner is another
// block, and the same code gives the same bits). A round takes
// kEdgeSlots jobs, six threads a job (side x residual axis) writing the
// rows to shared memory; then the block writes the source edges' blocks
// and gradients with neighbouring threads on neighbouring addresses, and
// thread (node, entry) adds the round's terms of its node to its one sum
// (36 diagonal entries, then 6 of Jᵀr) in job order: the kc source edges,
// then the destination edges in list order, from zero, one add at a time,
// as edge_nodes_kernel sums them. The last block to finish (a ticket, back
// at zero after) sums the per-edge costs in sum_kernel's order.
constexpr int kEdgeThreads = 512;
constexpr int kEdgeNodes = 8;
constexpr int kEdgeSlots = 85;
constexpr int kEntries = 42;
static_assert(kEdgeNodes * kEntries <= kEdgeThreads && 6 * kEdgeSlots <= kEdgeThreads, "a thread an item");

__global__ void __launch_bounds__(kEdgeThreads)
edge_term_kernel(EdgeArgs a, const int* __restrict__ e_order, const int* __restrict__ e_off, int n, int kc,
                 float* __restrict__ h_ii, float* __restrict__ h_jj, float* __restrict__ h_ij,
                 float* __restrict__ g_i, float* __restrict__ g_j, float* __restrict__ cost_e,
                 float* __restrict__ jtr_out, float* __restrict__ diag, float* __restrict__ cost,
                 unsigned int* __restrict__ ticket) {
  __shared__ float rows[kEdgeSlots][2][3][6];
  __shared__ float rws[kEdgeSlots][3];
  __shared__ bool last;
  const int n0 = blockIdx.x * kEdgeNodes;
  const int nb = min(kEdgeNodes, n - n0);
  const int ns = nb * kc, q0 = e_off[n0];
  const int jobs = ns + (e_off[n0 + nb] - q0);
  const int e0 = n0 * kc;
  const int node = threadIdx.x / kEntries, entry = threadIdx.x % kEntries;
  const bool summing = node < nb;
  int src_lo = 0, src_hi = 0, dst_lo = 0, dst_hi = 0;
  if (summing) {
    src_lo = node * kc;
    src_hi = src_lo + kc;
    dst_lo = ns + (e_off[n0 + node] - q0);
    dst_hi = ns + (e_off[n0 + node + 1] - q0);
  }
  float acc = 0.0f;
  for (int j0 = 0; j0 < jobs; j0 += kEdgeSlots) {
    const int m = min(kEdgeSlots, jobs - j0);
    {
      const int slot = threadIdx.x / 6, side = (threadIdx.x % 6) / 3, c = threadIdx.x % 3;
      const int j = j0 + slot;
      if (slot < m && (j < ns || side == 1)) {
        const int e = j < ns ? e0 + j : e_order[q0 + j - ns];
        const EdgeEval r = edge_eval(a, e);
        edge_row(r, side, c, rows[slot][side][c]);
        if (side == 1 && c == 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) rws[slot][k] = r.re[k] * r.swe;
        }
        if (j < ns && side == 0 && c == 0) cost_e[e0 + j] = r.cost;
      }
    }
    __syncthreads();
    // the round's source edges: rows j0 .. j0 + ms - 1 are edges e0 + j0 ...
    const int ms = max(min(m, ns - j0), 0);
    const size_t eb = static_cast<size_t>(e0 + j0);
    for (int f = threadIdx.x; f < ms * 36; f += blockDim.x) {
      const int slot = f / 36, p = (f % 36) / 6, q = f % 6;
      const float(*ji)[6] = rows[slot][0];
      const float(*jj)[6] = rows[slot][1];
      h_ii[36 * eb + f] = jtj_entry(ji, ji, p, q);
      h_jj[36 * eb + f] = jtj_entry(jj, jj, p, q);
      h_ij[36 * eb + f] = jtj_entry(ji, jj, p, q);
    }
    for (int f = threadIdx.x; f < ms * 6; f += blockDim.x) {
      const int slot = f / 6, p = f % 6;
      g_i[6 * eb + f] = jtr_entry(rows[slot][0], rws[slot], p);
      g_j[6 * eb + f] = jtr_entry(rows[slot][1], rws[slot], p);
    }
    if (summing) {
      const int p = entry < 36 ? entry / 6 : entry - 36, q = entry % 6;
      for (int j = max(src_lo, j0); j < min(src_hi, j0 + m); ++j) {
        const float(*ji)[6] = rows[j - j0][0];
        acc += entry < 36 ? jtj_entry(ji, ji, p, q) : jtr_entry(ji, rws[j - j0], p);
      }
      for (int j = max(dst_lo, j0); j < min(dst_hi, j0 + m); ++j) {
        const float(*jj)[6] = rows[j - j0][1];
        acc += entry < 36 ? jtj_entry(jj, jj, p, q) : jtr_entry(jj, rws[j - j0], p);
      }
    }
    __syncthreads();
  }
  if (summing) {
    const int nd = n0 + node;
    if (entry >= 36) {
      jtr_out[6 * nd + entry - 36] = acc;
    } else if (diag != nullptr) {
      diag[36 * nd + entry] = acc;
    }
  }
  __threadfence();  // this block's costs before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float total = ordered_sum(cost_e, n * kc);
  if (threadIdx.x == 0) {
    *cost = total;
    *ticket = 0u;  // ready for the next launch on this stream
  }
}

// the three-launch design before (the reference the one launch is held
// against bit for bit; no path of the port asks for it): a thread an
// edge, ...
__global__ void __launch_bounds__(kThreads)
edge_kernel(EdgeArgs a, int ne, float* __restrict__ h_ii, float* __restrict__ h_jj, float* __restrict__ h_ij,
            float* __restrict__ g_i, float* __restrict__ g_j, float* __restrict__ cost_e) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ne) return;
  const EdgeEval r = edge_eval(a, e);
  cost_e[e] = r.cost;
  float ji[3][6], jj[3][6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    edge_row(r, 0, c, ji[c]);
    edge_row(r, 1, c, jj[c]);
  }
  const float rw[3] = {r.re[0] * r.swe, r.re[1] * r.swe, r.re[2] * r.swe};
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    g_i[6 * e + p] = jtr_entry(ji, rw, p);
    g_j[6 * e + p] = jtr_entry(jj, rw, p);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      h_ii[36 * e + 6 * p + q] = jtj_entry(ji, ji, p, q);
      h_jj[36 * e + 6 * p + q] = jtj_entry(jj, jj, p, q);
      h_ij[36 * e + 6 * p + q] = jtj_entry(ji, jj, p, q);
    }
  }
}

// ... a thread a node walking its edges serially, then sum_kernel's cost
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
  const int64_t* heavy;       // (N,) nodes by descending entry count, ties by index
  const float* h_ii;          // (E, 36)
  const float* h_jj;
  const float* h_ij;
  const int* e_dst;    // (E,)
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

// p as the matvec reads it: from this CTA's shared copy, or (kSharedP
// false) from device memory written by other CTAs of the cluster, past
// this SM's L1
template <bool kSharedP>
__device__ __forceinline__ float load_p(const float* p) {
  if constexpr (kSharedP) return *p;
  else return __ldcg(p);
}

// six bf16 values at a 4-byte aligned address, as float32
__device__ __forceinline__ void load_row(const __nv_bfloat16* r, float v[6]) {
  const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(r);
#pragma unroll
  for (int h = 0; h < 3; ++h) {
    const __nv_bfloat162 w = r2[h];
    v[2 * h] = __bfloat162float(w.x);
    v[2 * h + 1] = __bfloat162float(w.y);
  }
}

// t[q] = bf16(row q · bf16(p)) of (point, row) q = pt R + j, where the row
// is in the matrix under the row mode
template <int R, int M, bool kSharedP>
__device__ __forceinline__ void row_t(const Sys& S, const float* __restrict__ p, float* __restrict__ t, int q) {
  const int pt = q / R;
  if constexpr (M == kStridedRows) {
    if (q - pt * R >= rows_in<R, M>(S, pt)) return;
  }
  float acc = 0.0f;
  for (int k = 0; k < kK; ++k) {
    const int nd = S.idx[pt * kK + k];
    float r[6];
    load_row(S.rows + (static_cast<size_t>(q) * kK + k) * 6, r);
#pragma unroll
    for (int d = 0; d < 6; ++d) acc += r[d] * bf16r(load_p<kSharedP>(p + 6 * nd + d));
  }
  t[q] = bf16r(acc);
}

// entry ent = (pt, k)'s rows times their point's t, the rows summed first
// (as the plain version does); t is read past L1 (other CTAs wrote it)
template <int R, int M>
__device__ __forceinline__ void entry_sum(const Sys& S, const float* __restrict__ t, int ent, float s[6]) {
  const int pt = ent / kK;
  // row j of entry (pt, k) of the (P, R, K, 6) rows: ent + (pt (R - 1) + j) K
  const size_t e0 = static_cast<size_t>(ent) + static_cast<size_t>(pt) * (R - 1) * kK;
  const int nrow = rows_in<R, M>(S, pt);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (M != kAllRows && j >= nrow) continue;
    const float tv = __ldcg(t + pt * R + j);
    float r[6];
    load_row(S.rows + (e0 + j * kK) * 6, r);
#pragma unroll
    for (int d = 0; d < 6; ++d) s[d] = j == 0 ? r[d] * tv : s[d] + r[d] * tv;
  }
}

// lane's share of node nd's data product: the node's entries lane, lane
// + 32, ... added in list order
template <int R, int M>
__device__ __forceinline__ void lane_data(const Sys& S, const float* __restrict__ t, int nd, int lane, float dat[6]) {
#pragma unroll
  for (int d = 0; d < 6; ++d) dat[d] = 0.0f;
  const int q1 = S.pt_off[nd + 1];
#pragma unroll 2
  for (int q = S.pt_off[nd] + lane; q < q1; q += 32) {
    float s[6];
    entry_sum<R, M>(S, t, S.pt_order[q], s);
#pragma unroll
    for (int d = 0; d < 6; ++d) dat[d] += s[d];
  }
}

// lane's share of node nd's edge product: its edge items lane, lane + 32,
// ...: the kc source-side edges (q_i = h_ii p_i + h_ij p_j), then its
// destination-side edges in list order (q_j = h_ijᵀ p_i + h_jj p_j)
template <bool kSharedP>
__device__ __forceinline__ void lane_edge(const Sys& S, const float* __restrict__ p, int nd, const float pn[6],
                                          int lane, float edg[6]) {
#pragma unroll
  for (int d = 0; d < 6; ++d) edg[d] = 0.0f;
  const int q0 = S.e_off[nd];
  const int items = S.kc + S.e_off[nd + 1] - q0;
  for (int i = lane; i < items; i += 32) {
    float po[6];
    if (i < S.kc) {
      const int e = nd * S.kc + i;
      const int j = S.e_dst[e];
      const float* hii = S.h_ii + 36 * static_cast<size_t>(e);
      const float* hij = S.h_ij + 36 * static_cast<size_t>(e);
#pragma unroll
      for (int b = 0; b < 6; ++b) po[b] = load_p<kSharedP>(p + 6 * j + b);
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        float s = 0.0f;
#pragma unroll
        for (int b = 0; b < 6; ++b) s += hii[6 * a + b] * pn[b];
#pragma unroll
        for (int b = 0; b < 6; ++b) s += hij[6 * a + b] * po[b];
        edg[a] += s;
      }
    } else {
      const int e = S.e_order[q0 + i - S.kc];
      const int src = e / S.kc;
      const float* hjj = S.h_jj + 36 * static_cast<size_t>(e);
      const float* hij = S.h_ij + 36 * static_cast<size_t>(e);
#pragma unroll
      for (int b = 0; b < 6; ++b) po[b] = load_p<kSharedP>(p + 6 * src + b);
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        float s = 0.0f;
#pragma unroll
        for (int b = 0; b < 6; ++b) s += hij[6 * b + a] * po[b];
#pragma unroll
        for (int b = 0; b < 6; ++b) s += hjj[6 * a + b] * pn[b];
        edg[a] += s;
      }
    }
  }
}

// the warp's lanes added into lane 0 by a fixed halving tree
__device__ __forceinline__ void warp_sum6(float v[6]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int d = 0; d < 6; ++d) v[d] += __shfl_down_sync(0xffffffffu, v[d], o);
  }
}

__device__ __forceinline__ float floor30(float v) { return fmaxf(v, 1e-30f); }

// (Ap)_nd = (data + edges) + damp p_nd by one warp; lane 0 writes it and
// returns p_ndᵀ(Ap)_nd (the other lanes 0)
template <int R, int M, bool kSharedP>
__device__ __forceinline__ float warp_ap(const Sys& S, const float* __restrict__ p, const float* __restrict__ t,
                                         int nd, int lane, float* __restrict__ ap) {
  float pn[6], dat[6], edg[6];
#pragma unroll
  for (int d = 0; d < 6; ++d) pn[d] = load_p<kSharedP>(p + 6 * nd + d);
  lane_data<R, M>(S, t, nd, lane, dat);
  lane_edge<kSharedP>(S, p, nd, pn, lane, edg);
  warp_sum6(dat);
  warp_sum6(edg);
  float pap = 0.0f;
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const float a = (dat[d] + edg[d]) + S.damp[6 * nd + d] * pn[d];
      ap[6 * nd + d] = a;
      pap += pn[d] * a;
    }
  }
  return pap;
}

// 512 threads a CTA (up to 128 registers a thread), the faster of 512
// and 1024 (scripts/torch_pcg_variants.py, ``threads1024``)
constexpr int kPcgThreads = 512;
// CTAs a cluster: the fastest of 4, 8 and 16 (the same script), 16 being
// the non-portable maximum
constexpr int kPcgCluster = 16;
constexpr int kStaticSmem = 2048;  // room kept for the kernels' static shared memory

// the dot products' exchange slots, one row of kPcgCluster a use
enum Slot { kSlotBB = 0, kSlotBZ, kSlotPAP, kSlotRR, kSlotRZ, kSlots };

// the cluster as the PCG uses it: its barrier, the slots of the dot
// products' partials and the copies of p, in every CTA's shared memory
struct Cluster {
  cg::cluster_group g;
  float* slots;  // (kSlots, kPcgCluster) of this CTA
  __device__ int rank() const { return static_cast<int>(g.block_rank()); }
  __device__ void sync() { g.sync(); }
  // this CTA's partial into its slot of use s in every CTA
  __device__ void put(int s, float v) {
    for (int c = 0; c < kPcgCluster; ++c) g.map_shared_rank(slots, c)[s * kPcgCluster + rank()] = v;
  }
  // the partials of use s added in rank order (after a barrier)
  __device__ float total(int s) const {
    float t = 0.0f;
    for (int c = 0; c < kPcgCluster; ++c) t += slots[s * kPcgCluster + c];
    return t;
  }
  // p[i] = v in every CTA's copy
  __device__ void put_p(float* p, int i, float v) {
    for (int c = 0; c < kPcgCluster; ++c) g.map_shared_rank(p, c)[i] = v;
  }
};

// fixed-order sums of a and b over the block (a halving shuffle tree in
// each warp, then one over the warps' sums in warp order): thread 0's
__device__ __forceinline__ void block_sum2(float& a, float& b, float (*red)[32]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = a;
    red[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const bool in = threadIdx.x < (blockDim.x >> 5);
    a = in ? red[0][threadIdx.x] : 0.0f;
    b = in ? red[1][threadIdx.x] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o);
      b += __shfl_down_sync(0xffffffffu, b, o);
    }
  }
}

// the matvec's two phases over the cluster: t for every (point, row),
// barrier, then Ap a warp a node, heaviest first; returns this thread's
// share of pᵀAp (lane 0s')
template <int R, int M, bool kSharedP>
__device__ __forceinline__ float cluster_matvec(Cluster& grp, const Sys& S, const float* __restrict__ p,
                                                float* __restrict__ t, float* __restrict__ ap) {
  const int nq = M == kPlaneRows ? S.np : S.np * R;  // the plane-rows mode walks the plane rows only
  for (int i = grp.rank() * blockDim.x + threadIdx.x; i < nq; i += kPcgCluster * blockDim.x)
    row_t<R, M, kSharedP>(S, p, t, M == kPlaneRows ? i * R : i);
  grp.sync();
  const int warps = blockDim.x >> 5;
  float pap = 0.0f;
  for (int k = grp.rank() * warps + (threadIdx.x >> 5); k < S.n; k += kPcgCluster * warps)
    pap += warp_ap<R, M, kSharedP>(S, p, t, static_cast<int>(S.heavy[k]), threadIdx.x & 31, ap);
  return pap;
}

// the dynamic shared memory of both cluster kernels
__device__ __forceinline__ float* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<float*>(smem_raw);
}

template <int R, int M, bool kSharedP>
__global__ void __launch_bounds__(kPcgThreads, 1)
matvec_kernel(Sys S, const float* __restrict__ p_in, float* __restrict__ ap, float* __restrict__ t) {
  __shared__ float slots[kSlots * kPcgCluster];
  Cluster grp{cg::this_cluster(), slots};
  if constexpr (kSharedP) {  // p into this CTA's shared memory
    float* p = dynamic_smem();
    for (int i = threadIdx.x; i < 6 * S.n; i += blockDim.x) p[i] = p_in[i];
    __syncthreads();
    cluster_matvec<R, M, true>(grp, S, p, t, ap);
  } else {
    cluster_matvec<R, M, false>(grp, S, p_in, t, ap);
  }
}

// x solves A x = b by block-Jacobi PCG from x = 0: at most ``iters``
// iterations while rᵀr > rtol2 bᵀb; work: r, z, p (device-memory mode),
// Ap and x (6N each), then t (P R floats)
template <int R, int M, bool kSharedP>
__global__ void __launch_bounds__(kPcgThreads, 1)
pcg_kernel(Sys S, const float* __restrict__ minv, const float* __restrict__ b, int iters, float rtol2,
           const bool* __restrict__ active, float* __restrict__ x, float* __restrict__ work) {
  __shared__ float red[2][32];
  __shared__ float slots[kSlots * kPcgCluster];
  Cluster grp{cg::this_cluster(), slots};
  const int n = S.n;
  const int dof = 6 * n;
  const int per = (n + kPcgCluster - 1) / kPcgCluster;  // nodes a CTA owns
  const int d0 = 6 * min(n, grp.rank() * per), d1 = 6 * min(n, (grp.rank() + 1) * per);
  const int tid = threadIdx.x;
  if (!*active) {
    for (int i = d0 + tid; i < d1; i += blockDim.x) x[i] = 0.0f;
    grp.sync();
    return;
  }
  // kSharedP: p (6N), then this CTA's r, z and x, indexed i - d0; else
  // the same in device memory
  float* smem = dynamic_smem();
  float* r = kSharedP ? smem + dof : work + d0;
  float* z = kSharedP ? smem + dof + 6 * per : work + dof + d0;
  float* xs = kSharedP ? smem + dof + 12 * per : work + 4 * dof + d0;
  float* p = kSharedP ? smem : work + 2 * dof;
  float* ap = work + 3 * dof;
  float* t = work + 5 * dof;
  auto set_p = [&](int i, float v) {
    if constexpr (kSharedP) grp.put_p(p, i, v);
    else p[i] = v;
  };
  // x = 0, r = b, z = p = M b on the owned dofs; bᵀb and bᵀz
  float s0 = 0.0f, s1 = 0.0f;
  for (int i = d0 + tid; i < d1; i += blockDim.x) {
    const int nd = i / 6;
    const float* m = minv + 36 * static_cast<size_t>(nd) + 6 * (i - 6 * nd);
    float zi = 0.0f;
#pragma unroll
    for (int c = 0; c < 6; ++c) zi += m[c] * b[6 * nd + c];
    const float bi = b[i];
    xs[i - d0] = 0.0f;
    r[i - d0] = bi;
    z[i - d0] = zi;
    set_p(i, zi);
    s0 += bi * bi;
    s1 += bi * zi;
  }
  block_sum2(s0, s1, red);
  if (tid == 0) {
    grp.put(kSlotBB, s0);
    grp.put(kSlotBZ, s1);
  }
  grp.sync();
  float rr = grp.total(kSlotBB);  // r = b here
  const float stop2 = rtol2 * rr;
  float rz = grp.total(kSlotBZ);
  for (int it = 0; it < iters && rr > stop2; ++it) {
    float pap = cluster_matvec<R, M, kSharedP>(grp, S, p, t, ap);
    float none = 0.0f;
    block_sum2(pap, none, red);
    if (tid == 0) grp.put(kSlotPAP, pap);
    grp.sync();
    const float alpha = rz / floor30(grp.total(kSlotPAP));
    for (int i = d0 + tid; i < d1; i += blockDim.x) {
      xs[i - d0] = xs[i - d0] + alpha * load_p<kSharedP>(p + i);
      r[i - d0] = r[i - d0] - alpha * __ldcg(ap + i);
    }
    __syncthreads();
    float s_rr = 0.0f, s_rz = 0.0f;
    for (int i = d0 + tid; i < d1; i += blockDim.x) {
      const int nd = i / 6;
      const float* m = minv + 36 * static_cast<size_t>(nd) + 6 * (i - 6 * nd);
      const float* rn = r + 6 * nd - d0;
      float zi = 0.0f;
#pragma unroll
      for (int c = 0; c < 6; ++c) zi += m[c] * rn[c];
      z[i - d0] = zi;
      const float ri = r[i - d0];
      s_rr += ri * ri;
      s_rz += ri * zi;
    }
    block_sum2(s_rr, s_rz, red);
    if (tid == 0) {
      grp.put(kSlotRR, s_rr);
      grp.put(kSlotRZ, s_rz);
    }
    grp.sync();
    rr = grp.total(kSlotRR);
    const float rz_new = grp.total(kSlotRZ);
    const float beta = rz_new / floor30(rz);
    for (int i = d0 + tid; i < d1; i += blockDim.x) set_p(i, z[i - d0] + beta * load_p<kSharedP>(p + i));
    rz = rz_new;
    grp.sync();
  }
  for (int i = d0 + tid; i < d1; i += blockDim.x) x[i] = xs[i - d0];
  grp.sync();  // no CTA leaves while another may still write into its shared memory
}

// ---------------------------------------------------------------- the distributed PCG
//
// dynamicfusion_tpu/solvers/warp_solver.py:1228-1240 under axis_name: each
// shard's matvec is its own points' data product only (psum'd across the
// shards by the caller), then the edge blocks and the damping are applied
// once to the sum, and the PCG update runs on it (kernel P's init and
// update entries, csrc/dense_pcg.cu, whose loop state carries the stop
// flag in device memory; every launch here reads it first and returns once
// the loop is done).

using LoopState = dfk::PcgState;  // kernel P's loop state

template <int R, int M>
__global__ void __launch_bounds__(kThreads)
data_rows_kernel(Sys S, const float* __restrict__ p, float* __restrict__ t, const LoopState* __restrict__ st) {
  if (st != nullptr && st->done) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nq = M == kPlaneRows ? S.np : S.np * R;
  if (i < nq) row_t<R, M, true>(S, p, t, M == kPlaneRows ? i * R : i);
}

// a warp a node, heaviest first: the PCG's per-lane walk and shuffle tree
template <int R, int M>
__global__ void __launch_bounds__(kThreads)
data_nodes_kernel(Sys S, const float* __restrict__ t, float* __restrict__ ap, const LoopState* __restrict__ st) {
  if (st != nullptr && st->done) return;
  const int k = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (k >= S.n) return;  // the whole warp
  const int nd = static_cast<int>(S.heavy[k]);
  float dat[6];
  lane_data<R, M>(S, t, nd, threadIdx.x & 31, dat);
  warp_sum6(dat);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int d = 0; d < 6; ++d) ap[6 * nd + d] = dat[d];
  }
}

// node nd's edge product, one thread: its source-side blocks in edge
// order, then its destination-side blocks in list order
__device__ __forceinline__ void node_edge(const Sys& S, const float* __restrict__ p, int nd, const float pn[6],
                                          float edg[6]) {
#pragma unroll
  for (int d = 0; d < 6; ++d) edg[d] = 0.0f;
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
}

// ap = (apd + edge blocks p) + damp p, the matvec's sum order
__global__ void __launch_bounds__(kThreads)
edge_apply_kernel(Sys S, const float* __restrict__ p, const float* __restrict__ apd, float* __restrict__ ap,
                  const LoopState* __restrict__ st) {
  if (st != nullptr && st->done) return;
  const int nd = blockIdx.x * blockDim.x + threadIdx.x;
  if (nd >= S.n) return;
  float edg[6], pn[6];
#pragma unroll
  for (int d = 0; d < 6; ++d) pn[d] = p[6 * nd + d];
  node_edge(S, p, nd, pn, edg);
#pragma unroll
  for (int d = 0; d < 6; ++d) ap[6 * nd + d] = (apd[6 * nd + d] + edg[d]) + S.damp[6 * nd + d] * pn[d];
}

// ---------------------------------------------------------------- host side

Sys make_sys(const void* rows, const void* idx, const void* pt_order, const void* pt_off, const void* heavy,
             const void* h_ii, const void* h_jj, const void* h_ij, const void* e_dst, const void* e_order,
             const void* e_off, const void* damp, int np, int n, int kc, int stride) {
  return {static_cast<const __nv_bfloat16*>(rows), static_cast<const int*>(idx), static_cast<const int*>(pt_order),
          static_cast<const int*>(pt_off), static_cast<const int64_t*>(heavy), static_cast<const float*>(h_ii),
          static_cast<const float*>(h_jj), static_cast<const float*>(h_ij), static_cast<const int*>(e_dst),
          static_cast<const int*>(e_order), static_cast<const int*>(e_off), static_cast<const float*>(damp), np, n,
          kc, stride};
}

// the row mode of (R rows, ``used`` of them, tangential ``stride``), -1 if invalid
int row_mode(int nrows, int used, int stride) {
  if (!(nrows == 1 || nrows == 3) || !(used == 1 || used == nrows) || stride < 1) return -1;
  if (nrows == 1 || (used == nrows && stride == 1)) return kAllRows;
  if (used == 1) return stride == 1 ? kPlaneRows : -1;
  return kStridedRows;
}

// the instantiation of a cluster kernel for (R, row mode, p's place)
template <template <int, int, bool> class K>
typename K<1, kAllRows, true>::Fn pick(int nrows, int mode, bool shared_p) {
  if (shared_p) {
    if (nrows == 1) return K<1, kAllRows, true>::fn();
    if (mode == kAllRows) return K<3, kAllRows, true>::fn();
    if (mode == kPlaneRows) return K<3, kPlaneRows, true>::fn();
    return K<3, kStridedRows, true>::fn();
  }
  if (nrows == 1) return K<1, kAllRows, false>::fn();
  if (mode == kAllRows) return K<3, kAllRows, false>::fn();
  if (mode == kPlaneRows) return K<3, kPlaneRows, false>::fn();
  return K<3, kStridedRows, false>::fn();
}

template <int R, int M, bool kS>
struct PcgK {
  using Fn = decltype(&pcg_kernel<1, kAllRows, true>);
  static Fn fn() { return pcg_kernel<R, M, kS>; }
};
template <int R, int M, bool kS>
struct MatvecK {
  using Fn = decltype(&matvec_kernel<1, kAllRows, true>);
  static Fn fn() { return matvec_kernel<R, M, kS>; }
};

// dynamic shared memory of a cluster kernel: the PCG's p copy and its
// CTA's r, z and x, the matvec's p copy; 0 when p stays in device memory
size_t cluster_smem(bool pcg, int n, bool shared_p) {
  if (!shared_p) return 0;
  const size_t per = (static_cast<size_t>(n) + kPcgCluster - 1) / kPcgCluster;
  return sizeof(float) * (6 * static_cast<size_t>(n) + (pcg ? 18 * per : 0));
}

// the current device's opt-in shared memory a block (0 if unknown)
int smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

// p's place: -1 shared memory where it fits, else device memory; 0 device
// memory; 1 shared memory (refused where it does not fit). 1 or 0, or -1
// if refused
int resolve_shared(bool pcg, int n, int want) {
  const bool fits = cluster_smem(pcg, n, true) + kStaticSmem <= static_cast<size_t>(smem_optin());
  if (want < 0) return fits ? 1 : 0;
  if (want == 1 && !fits) return -1;
  return want;
}

// the attributes a launch needs, which belong to the current device's
// context: set once a (kernel, device) and raised as needed
cudaError_t setup(const void* fn, size_t smem) {
  struct Done {
    const void* fn;
    int dev;
    size_t smem;
    bool wide;
  };
  constexpr int kDone = 128;  // the 16 cluster kernels on 8 devices
  static Done done[kDone];
  static int count = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int k = 0;
  while (k < count && (done[k].fn != fn || done[k].dev != dev)) ++k;
  if (k == count) {
    if (count == kDone) return cudaErrorUnknown;
    done[count++] = {fn, dev, 0, false};
  }
  if (smem > done[k].smem) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    done[k].smem = smem;
  }
  if (kPcgCluster > 8 && !done[k].wide) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    done[k].wide = true;
  }
  return err;
}

void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, size_t smem, cudaStream_t st) {
  cfg = {};
  cfg.gridDim = dim3(kPcgCluster, 1, 1);
  cfg.blockDim = dim3(kPcgThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kPcgCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), size_t smem, cudaStream_t st, Args... args) {
  cudaError_t err = setup(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, smem, st);
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

}  // namespace

// ticket: the device's (1,) zero-between-launches counter of the one
// launch; three_launch: the design before (edge_kernel, edge_nodes_kernel,
// sum_kernel; the reference mode, ticket unused); *launched: the kernels
// this call launched
extern "C" int df_edge_term(const void* dqs, const void* src, const void* dst, const void* valid, const void* v_dst,
                            const void* alpha, int ne, int n, const void* e_order, const void* e_off, float lam,
                            float delta, void* h_ii, void* h_jj, void* h_ij, void* g_i, void* g_j, void* cost_e,
                            void* jtr, void* diag, void* cost, void* ticket, int three_launch, int* launched,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || ne % n != 0) return static_cast<int>(cudaErrorInvalidValue);
  const EdgeArgs a{static_cast<const float*>(dqs), static_cast<const int64_t*>(src),
                   static_cast<const int64_t*>(dst), static_cast<const bool*>(valid),
                   static_cast<const float*>(v_dst), static_cast<const float*>(alpha), lam, delta};
  const int* order = static_cast<const int*>(e_order);
  const int* off = static_cast<const int*>(e_off);
  if (!three_launch) {
    if (ticket == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    edge_term_kernel<<<(n + kEdgeNodes - 1) / kEdgeNodes, kEdgeThreads, 0, s>>>(
        a, order, off, n, ne / n, static_cast<float*>(h_ii), static_cast<float*>(h_jj), static_cast<float*>(h_ij),
        static_cast<float*>(g_i), static_cast<float*>(g_j), static_cast<float*>(cost_e), static_cast<float*>(jtr),
        static_cast<float*>(diag), static_cast<float*>(cost), static_cast<unsigned int*>(ticket));
    *launched = 1;
    return static_cast<int>(cudaGetLastError());
  }
  *launched = 0;
  if (ne > 0) {
    edge_kernel<<<(ne + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        a, ne, static_cast<float*>(h_ii), static_cast<float*>(h_jj), static_cast<float*>(h_ij),
        static_cast<float*>(g_i), static_cast<float*>(g_j), static_cast<float*>(cost_e));
    ++*launched;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  edge_nodes_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(h_ii), static_cast<const float*>(h_jj), static_cast<const float*>(g_i),
      static_cast<const float*>(g_j), order, off, n, ne / n, static_cast<float*>(jtr), static_cast<float*>(diag));
  ++*launched;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_kernel<<<1, kReduceThreads, 0, s>>>(static_cast<const float*>(cost_e), ne, static_cast<float*>(cost));
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int df_spd6_inv(const void* m, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  spd6_inv_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// the cluster launch of the PCG (``pcg`` 1) or the single matvec at n
// nodes on the current device: out = (CTAs a cluster, dynamic shared
// memory bytes, p in shared memory 1 / device memory 0, clusters the card
// can hold at once) for p's place (``resolve_shared``); returns an error
// code where it is refused
extern "C" int df_pcg_plan(int pcg, int n, int nrows, int used, int stride, int shared_p, int* out) {
  const int mode = row_mode(nrows, used, stride);
  if (mode < 0 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int sh = resolve_shared(pcg != 0, n, shared_p);
  if (sh < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = cluster_smem(pcg != 0, n, sh == 1);
  const void* fn = pcg ? reinterpret_cast<const void*>(pick<PcgK>(nrows, mode, sh == 1))
                       : reinterpret_cast<const void*>(pick<MatvecK>(nrows, mode, sh == 1));
  cudaError_t err = setup(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, smem, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kPcgCluster;
  out[1] = static_cast<int>(smem);
  out[2] = sh;
  out[3] = clusters;
  return 0;
}

extern "C" int df_matvec(const void* rows, const void* idx, const void* pt_order, const void* pt_off, const void* heavy,
                         const void* h_ii, const void* h_jj, const void* h_ij, const void* e_dst, const void* e_order,
                         const void* e_off, const void* damp, int np, int n, int kc, int nrows, int used, int stride,
                         int shared_p, const void* p, void* ap, void* t, void* stream) {
  const int mode = row_mode(nrows, used, stride);
  if (mode < 0 || (shared_p != 0 && shared_p != 1) || resolve_shared(false, n, shared_p) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Sys S = make_sys(rows, idx, pt_order, pt_off, heavy, h_ii, h_jj, h_ij, e_dst, e_order, e_off, damp, np, n, kc,
                         stride);
  return static_cast<int>(launch_cluster(pick<MatvecK>(nrows, mode, shared_p == 1),
                                         cluster_smem(false, n, shared_p == 1), static_cast<cudaStream_t>(stream), S,
                                         p, ap, t));
}

extern "C" int df_pcg(const void* rows, const void* idx, const void* pt_order, const void* pt_off, const void* heavy,
                      const void* h_ii, const void* h_jj, const void* h_ij, const void* e_dst, const void* e_order,
                      const void* e_off, const void* damp, int np, int n, int kc, int nrows, int used, int stride,
                      int shared_p, const void* minv, const void* b, int iters, float rtol2, const void* active,
                      void* x, void* work, void* stream) {
  const int mode = row_mode(nrows, used, stride);
  if (mode < 0 || (shared_p != 0 && shared_p != 1) || resolve_shared(true, n, shared_p) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Sys S = make_sys(rows, idx, pt_order, pt_off, heavy, h_ii, h_jj, h_ij, e_dst, e_order, e_off, damp, np, n, kc,
                         stride);
  return static_cast<int>(launch_cluster(pick<PcgK>(nrows, mode, shared_p == 1), cluster_smem(true, n, shared_p == 1),
                                         static_cast<cudaStream_t>(stream), S, minv, b, iters, rtol2, active, x,
                                         work));
}

// the data-only matvec of one shard's rows: ap = rowsᵀ bf16(rows bf16(p)),
// no edge blocks, no damping; t (P R,) scratch; st (kernel P's loop state)
// may be null, else a done loop makes both launches return at once
extern "C" int df_data_matvec(const void* rows, const void* idx, const void* pt_order, const void* pt_off,
                              const void* heavy, int np, int n, int nrows, int used, int stride, const void* p,
                              void* ap, void* t, const void* st, void* stream) {
  const int mode = row_mode(nrows, used, stride);
  if (mode < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Sys S = make_sys(rows, idx, pt_order, pt_off, heavy, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, np, n, 1, stride);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pp = static_cast<const float*>(p);
  float* a = static_cast<float*>(ap);
  float* tt = static_cast<float*>(t);
  const LoopState* ls = static_cast<const LoopState*>(st);
  const int nq = (mode == kPlaneRows ? np : np * nrows);
  const int gq = (nq + kThreads - 1) / kThreads, gn = (32 * n + kThreads - 1) / kThreads;
  if (gq > 0) {
    if (nrows == 1) {
      data_rows_kernel<1, kAllRows><<<gq, kThreads, 0, s>>>(S, pp, tt, ls);
    } else if (mode == kAllRows) {
      data_rows_kernel<3, kAllRows><<<gq, kThreads, 0, s>>>(S, pp, tt, ls);
    } else if (mode == kPlaneRows) {
      data_rows_kernel<3, kPlaneRows><<<gq, kThreads, 0, s>>>(S, pp, tt, ls);
    } else {
      data_rows_kernel<3, kStridedRows><<<gq, kThreads, 0, s>>>(S, pp, tt, ls);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (nrows == 1) {
    data_nodes_kernel<1, kAllRows><<<gn, kThreads, 0, s>>>(S, tt, a, ls);
  } else if (mode == kAllRows) {
    data_nodes_kernel<3, kAllRows><<<gn, kThreads, 0, s>>>(S, tt, a, ls);
  } else if (mode == kPlaneRows) {
    data_nodes_kernel<3, kPlaneRows><<<gn, kThreads, 0, s>>>(S, tt, a, ls);
  } else {
    data_nodes_kernel<3, kStridedRows><<<gn, kThreads, 0, s>>>(S, tt, a, ls);
  }
  return static_cast<int>(cudaGetLastError());
}

// ap = (apd + edge blocks p) + damp p for the distributed PCG's step
extern "C" int df_edge_apply(const void* h_ii, const void* h_jj, const void* h_ij, const void* e_dst,
                             const void* e_order, const void* e_off, const void* damp, int n, int kc, const void* p,
                             const void* apd, void* ap, const void* st, void* stream) {
  const Sys S = make_sys(nullptr, nullptr, nullptr, nullptr, nullptr, h_ii, h_jj, h_ij, e_dst, e_order, e_off, damp, 0,
                         n, kc, 1);
  edge_apply_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      S, static_cast<const float*>(p), static_cast<const float*>(apd), static_cast<float*>(ap),
      static_cast<const LoopState*>(st));
  return static_cast<int>(cudaGetLastError());
}
