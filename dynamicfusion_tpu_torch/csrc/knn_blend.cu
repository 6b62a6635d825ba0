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
// Design: a query's scan is split over S lanes (kernels.knn_lanes picks S
// from the query count: 16 for the solve points and the nodes, 2 for the
// coarse corners, 1 for a mesh's vertices; a few queries need more lanes
// to fill the card, many need fewer to keep the insertions rare): the
// block stages the nodes as one float4 each, (x, y, z, |n|^2) with an
// inactive node's |n|^2 stored negated, in shared memory tile by tile;
// lane s tests the staged nodes s, s + S, ... four at a time and keeps its
// K best (distance, index) pairs sorted in registers, a candidate waiting
// in a small buffer until its warp inserts the buffers together; K rounds
// of a shuffle butterfly then merge the S lists under the one total order
// that the selection has (ascending distance, ties to the lower index:
// lax.top_k's order), which does not depend on how the nodes are split.
// The squared distance is the JAX package's expansion (|q|^2 - 2 q.n) +
// |n|^2 (+1e9 for inactive nodes) with the same operands in every lane,
// clamped at 0 after the selection, so the neighbours, their distances
// and all that follows equal the one-thread-a-query scan's bit for bit
// (knn_serial_kernel, the design before the split, kept for that hold and
// for timing; no caller of the port asks for it). Lane 0 of each query
// then computes the weights, the blend, the sign pivot (first neighbour)
// and the transform as dq.cuh does, which mirrors the plain PyTorch
// version. With one thread a query the preset's 3 200 solve points gave 25
// blocks, each thread walking all 1 024 nodes; at 16 lanes a query each
// lane walks 64. The time of the large calls (the 35 937 coarse corners, a
// mesh's ~270 000 vertices) is the brute-force scan itself: a
// spatial grid that skips far nodes is the next step.
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
// _mutual_nearest is one launch: a candidate's scan split over kMnLanes
// = 32 lanes, a warp a candidate (the fastest of 1-32 at both the preset's
// 4 800 candidates and reference_parity()'s 19 200; PERF.md gives the
// other counts' times), so each lane's node gets one shared atomicMin on
// the bits of the (clamped, non-negative) float a warp (at fewer lanes a
// shuffle tree first takes the minimum over the warp's candidates), one
// global atomicMin a block, and the last block converts the bits (a
// ticket). The design before (a fill, a one-thread-a-candidate
// scan whose every valid thread took atomicMin on one shared word in the
// same step, 32 ways contended, and a conversion: three launches) stays
// as the reference. A min does not depend on the order, so both give the
// same bits every run.
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

// the nodes of a tile as (x, y, z, |n|^2), an inactive node's |n|^2 stored
// negated (-|n|^2, -0 for a node at the origin): its sign says to add the
// 1e9 offset, so that a node is one 16-byte load
__device__ __forceinline__ void stage_packed(const float* __restrict__ pos, const bool* __restrict__ active, int n,
                                             int base, float4* sp) {
  for (int j = threadIdx.x; j < kTile && base + j < n; j += blockDim.x) {
    const float px = pos[3 * (base + j)], py = pos[3 * (base + j) + 1], pz = pos[3 * (base + j) + 2];
    const float nn = (px * px + py * py) + pz * pz;
    sp[j] = make_float4(px, py, pz, active[base + j] ? nn : -nn);
  }
}

// insert (cd, ci) into the ascending list (bd, bi) under (distance, index)
template <int K>
__device__ __forceinline__ void insert_sorted(float (&bd)[K], int (&bi)[K], float cd, int ci) {
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

// query i's outputs from its K nearest (squared distance, index) pairs:
// the clamped distances, the Gaussian weights, the quality, the blend and
// the warped query (and normal)
template <int K>
__device__ __forceinline__ void knn_outputs(const float (&bd)[K], const int (&bi)[K], int i, float qx, float qy,
                                            float qz, const float* __restrict__ radius,
                                            const float* __restrict__ dq, const float* __restrict__ queries,
                                            const float* __restrict__ normals, float* __restrict__ d2_out,
                                            int64_t* __restrict__ idx_out, float* __restrict__ w_out,
                                            float* __restrict__ blend_out, float* __restrict__ qual_out,
                                            float* __restrict__ pts_out, float* __restrict__ nrm_out) {
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

#define DF_KNN_PARAMS                                                                                       \
  const float *__restrict__ pos, const bool *__restrict__ active, const float *__restrict__ radius,         \
      const float *__restrict__ dq, int n, const float *__restrict__ queries,                               \
      const float *__restrict__ normals, int nq, float *__restrict__ d2_out, int64_t *__restrict__ idx_out, \
      float *__restrict__ w_out, float *__restrict__ blend_out, float *__restrict__ qual_out,               \
      float *__restrict__ pts_out, float *__restrict__ nrm_out
#define DF_KNN_OUTPUTS radius, dq, queries, normals, d2_out, idx_out, w_out, blend_out, qual_out, pts_out, nrm_out

// the one-thread-a-query scan (the design before the split): the hold and
// the timing of knn_blend_kernel call it, the port does not
template <int K>
__global__ void __launch_bounds__(kThreads) knn_serial_kernel(DF_KNN_PARAMS) {
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
      const float cd = ((qq - 2.0f * qn) + snn[j]) + sbig[j];
      if (cd < bd[K - 1]) insert_sorted(bd, bi, cd, base + j);
    }
  }
  if (live) knn_outputs<K>(bd, bi, i, qx, qy, qz, DF_KNN_OUTPUTS);
}

// a lane tests kUnroll nodes between two looks at its warp's buffers, and
// holds up to kBuffer candidates (in shared memory) before its warp
// inserts them
constexpr int kUnroll = 4;
constexpr int kBuffer = 8;

// S lanes a query (S = 1 keeps one lane a query): lane s takes the staged
// nodes s, s + S, ... (the tile padded with NaN nodes to a multiple of S
// kUnroll, which never pass). A node that beats the lane's K-th goes to
// its buffer, and when a lane of the warp may not have room for the next
// kUnroll, every lane inserts its buffer in order (the insertion is a
// branch: taken node by node, the whole warp waits for it whenever any
// lane inserts). The K-th a node is tested against may lag behind the
// buffer, which only lets more nodes in: the lists come out as
// one-at-a-time insertion in scan order gives them. Then K rounds of a
// butterfly over the S lanes merge the lists.
template <int K, int S>
__global__ void __launch_bounds__(kThreads) knn_blend_kernel(DF_KNN_PARAMS) {
  static_assert(S >= 1 && S <= 32 && (S & (S - 1)) == 0, "a query's lanes: a power of two in a warp");
  static_assert(kTile % (S * kUnroll) == 0 && kBuffer >= kUnroll, "whole steps in a tile, room for a step");
  __shared__ float4 sp[kTile];
  __shared__ float held_d[kBuffer][kThreads];
  __shared__ int held_i[kBuffer][kThreads];
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int i = static_cast<int>(t / S);
  const int lane = static_cast<int>(t % S);
  const bool live = i < nq;
  const float qx = live ? dfk::nan_to_num(queries[3 * i]) : 0.0f;
  const float qy = live ? dfk::nan_to_num(queries[3 * i + 1]) : 0.0f;
  const float qz = live ? dfk::nan_to_num(queries[3 * i + 2]) : 0.0f;
  const float qq = (qx * qx + qy * qy) + qz * qz;
  // a lane past the queries takes part in the warp's votes and shuffles
  // but lets no node in (-inf)
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = live ? INFINITY : -INFINITY;
    bi[s] = 0x7fffffff;
  }
  int held = 0;
  for (int base = 0; base < n; base += kTile) {
    __syncthreads();
    stage_packed(pos, active, n, base, sp);
    const int m = min(kTile, n - base);
    const int mp = (m + S * kUnroll - 1) / (S * kUnroll) * (S * kUnroll);
    for (int j = m + threadIdx.x; j < mp; j += blockDim.x) sp[j] = make_float4(NAN, NAN, NAN, NAN);
    __syncthreads();
    for (int j0 = lane; j0 < mp; j0 += S * kUnroll) {
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        const int j = j0 + r * S;
        const float4 p = sp[j];
        const float qn = (qx * p.x + qy * p.y) + qz * p.z;
        // ((qq - 2 qn) + |n|^2) + 0 or 1e9: the sum before the offset is
        // never -0, so for an active node adding 0 would change no bit
        const float u = (qq - 2.0f * qn) + fabsf(p.w);
        if (u < bd[K - 1]) {
          const float cd = signbit(p.w) ? u + kBig : u;
          if (cd < bd[K - 1]) {
            held_d[held][threadIdx.x] = cd;
            held_i[held][threadIdx.x] = base + j;
            ++held;
          }
        }
      }
      if (__any_sync(0xffffffffu, held > kBuffer - kUnroll)) {
        for (int b = 0; b < held; ++b) insert_sorted(bd, bi, held_d[b][threadIdx.x], held_i[b][threadIdx.x]);
        held = 0;
      }
    }
  }
  for (int b = 0; b < held; ++b) insert_sorted(bd, bi, held_d[b][threadIdx.x], held_i[b][threadIdx.x]);
  if constexpr (S > 1) {
    // each round the group's least head under (distance, index) goes to
    // the output and leaves its lane's list (an index is in one lane's
    // slice only; the empty slots (inf, INT_MAX) sort after every node)
    float md[K];
    int mi[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      float cd = bd[0];
      int ci = bi[0];
#pragma unroll
      for (int o = 1; o < S; o <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, cd, o);
        const int oi = __shfl_xor_sync(0xffffffffu, ci, o);
        if (od < cd || (od == cd && oi < ci)) {
          cd = od;
          ci = oi;
        }
      }
      md[r] = cd;
      mi[r] = ci;
      if (bi[0] == ci && bd[0] == cd) {
#pragma unroll
        for (int s = 0; s + 1 < K; ++s) {
          bd[s] = bd[s + 1];
          bi[s] = bi[s + 1];
        }
        bd[K - 1] = INFINITY;
        bi[K - 1] = 0x7fffffff;
      }
    }
    if (live && lane == 0) knn_outputs<K>(md, mi, i, qx, qy, qz, DF_KNN_OUTPUTS);
  } else {
    if (live) knn_outputs<K>(bd, bi, i, qx, qy, qz, DF_KNN_OUTPUTS);
  }
}

// the one-launch mutual-nearest pass: S = kMnLanes lanes a candidate, lane
// s taking the staged nodes s, s + S, ... A warp's lanes l, l + S, ... test
// the same node for the warp's 32 / S candidates in the same step, so the
// node's minimum over them is an xor-shuffle tree (one redux at S = 1,
// none at S = 32) and one shared atomicMin from the first candidate's
// lane, kMnUnroll
// steps at a time; the block's minima go to node_bits with one global
// atomicMin a node a tile. node_bits holds kBig's bits at every entry
// between launches: the last block to finish (a ticket) converts each
// entry to node_d2 and puts kBig back. A candidate's minimum (fminf,
// which skips a NaN as the one-thread scan's did) merges its S lanes by
// a shuffle tree.
constexpr int kMnLanes = 32;
constexpr int kMnThreads = 512;
constexpr int kMnUnroll = 4;

__global__ void __launch_bounds__(kMnThreads)
mutual_nearest_one_kernel(const float* __restrict__ pos, const bool* __restrict__ active, int n,
                          const float* __restrict__ cand, const bool* __restrict__ valid, int nc,
                          float* __restrict__ cand_d2, int* __restrict__ node_bits, float* __restrict__ node_d2,
                          unsigned int* __restrict__ ticket) {
  constexpr int S = kMnLanes;
  static_assert(S >= 1 && S <= 32 && (S & (S - 1)) == 0, "a candidate's lanes: a power of two in a warp");
  constexpr int kBigBits = 0x4e6e6b28;  // __float_as_int(1e9f)
  __shared__ float4 sp[kTile];
  __shared__ int smin[kTile];
  __shared__ bool last;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int i = static_cast<int>(t / S);
  const int s = static_cast<int>(t % S);
  const int lane = threadIdx.x & 31;
  const bool live = i < nc;
  const bool ok = live && valid[i];
  const float qx = live ? dfk::nan_to_num(cand[3 * i]) : 0.0f;
  const float qy = live ? dfk::nan_to_num(cand[3 * i + 1]) : 0.0f;
  const float qz = live ? dfk::nan_to_num(cand[3 * i + 2]) : 0.0f;
  const float qq = (qx * qx + qy * qy) + qz * qz;
  float best = INFINITY;
  // the block holds a candidate (the same for all its threads)
  if (static_cast<long long>(blockIdx.x) * (blockDim.x / S) < nc) {
    for (int base = 0; base < n; base += kTile) {
      __syncthreads();
      stage_packed(pos, active, n, base, sp);
      for (int j = threadIdx.x; j < kTile; j += blockDim.x) smin[j] = kBigBits;
      __syncthreads();
      const int m = min(kTile, n - base);
      // kMnUnroll steps at a time: their loads, distances, trees and
      // atomics each issued together
      for (int j0 = 0; j0 < m; j0 += S * kMnUnroll) {
        float4 p[kMnUnroll];
        int v[kMnUnroll];
#pragma unroll
        for (int u = 0; u < kMnUnroll; ++u) {
          const int j = j0 + u * S + s;
          p[u] = sp[j < m ? j : 0];
        }
#pragma unroll
        for (int u = 0; u < kMnUnroll; ++u) {
          v[u] = kBigBits;
          if (j0 + u * S + s < m) {
            const float qn = (qx * p[u].x + qy * p[u].y) + qz * p[u].z;
            // ((qq - 2 qn) + |n|^2) + 0 or 1e9, as stage_nodes' two arrays
            // give it: the sum before the offset is never -0
            const float du = (qq - 2.0f * qn) + fabsf(p[u].w);
            const float d = signbit(p[u].w) ? du + kBig : du;
            best = fminf(best, d);
            // non-negative floats order as their bit patterns
            if (ok) v[u] = __float_as_int(fmaxf(d, 0.0f));
          }
        }
#pragma unroll
        for (int u = 0; u < kMnUnroll; ++u) {
          if constexpr (S == 1) {
            v[u] = __reduce_min_sync(0xffffffffu, v[u]);
          } else {
#pragma unroll
            for (int o = S; o < 32; o <<= 1) v[u] = min(v[u], __shfl_xor_sync(0xffffffffu, v[u], o));
          }
        }
#pragma unroll
        for (int u = 0; u < kMnUnroll; ++u) {
          const int j = j0 + u * S + s;
          if (lane < S && j < m && v[u] != kBigBits) atomicMin(&smin[j], v[u]);
        }
      }
      __syncthreads();
      for (int j = threadIdx.x; j < m; j += blockDim.x) {
        if (smin[j] != kBigBits) atomicMin(&node_bits[base + j], smin[j]);
      }
    }
  }
#pragma unroll
  for (int o = 1; o < S; o <<= 1) best = fminf(best, __shfl_xor_sync(0xffffffffu, best, o));
  if (live && s == 0) cand_d2[i] = fmaxf(best, 0.0f);
  __threadfence();  // this block's minima before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll 4
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int b = __ldcg(node_bits + j);
    node_bits[j] = kBigBits;
    node_d2[j] = __int_as_float(b);
  }
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next launch on this stream
}

// the three-launch design before (a fill of node_bits, this scan, a
// conversion): one thread a candidate walking every node, every valid
// thread of the block taking atomicMin on the node's shared word in the
// same step; the reference the one launch is held against bit for bit,
// no path of the port asks for it
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

template <int K, int S>
cudaError_t launch_knn(DF_KNN_PARAMS, cudaStream_t s) {
  const long long threads = static_cast<long long>(nq) * S;
  knn_blend_kernel<K, S><<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      pos, active, radius, dq, n, queries, normals, nq, d2_out, idx_out, w_out, blend_out, qual_out, pts_out, nrm_out);
  return cudaGetLastError();
}

#undef DF_KNN_OUTPUTS
#undef DF_KNN_PARAMS

}  // namespace

// lanes: the lanes a query's scan is split over (1, 2, 4, 8 or 16), or 0
// for the one-thread-a-query kernel (the design before the split)
extern "C" int df_knn_blend(const void* pos, const void* active, const void* radius, const void* dq, int n,
                            const void* queries, const void* normals, int nq, int k, int lanes, void* d2, void* idx,
                            void* w, void* blend, void* qual, void* pts_out, void* nrm_out, void* stream) {
  if (nq <= 0) return 0;
  if (k != 5 && k != 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DF_KNN_ARGS                                                                                   \
  static_cast<const float*>(pos), static_cast<const bool*>(active), static_cast<const float*>(radius), \
      static_cast<const float*>(dq), n, static_cast<const float*>(queries),                            \
      static_cast<const float*>(normals), nq, static_cast<float*>(d2), static_cast<int64_t*>(idx),      \
      static_cast<float*>(w), static_cast<float*>(blend), static_cast<float*>(qual),                    \
      static_cast<float*>(pts_out), static_cast<float*>(nrm_out)
  cudaError_t err;
  switch (lanes) {
    case 0: {
      const unsigned blocks = static_cast<unsigned>((nq + kThreads - 1) / kThreads);
      if (k == 8) {
        knn_serial_kernel<8><<<blocks, kThreads, 0, s>>>(DF_KNN_ARGS);
      } else {
        knn_serial_kernel<5><<<blocks, kThreads, 0, s>>>(DF_KNN_ARGS);
      }
      err = cudaGetLastError();
      break;
    }
#define DF_KNN_SPLIT(S)                                                               \
  case S:                                                                             \
    err = k == 8 ? launch_knn<8, S>(DF_KNN_ARGS, s) : launch_knn<5, S>(DF_KNN_ARGS, s); \
    break;
    DF_KNN_SPLIT(1) DF_KNN_SPLIT(2) DF_KNN_SPLIT(4) DF_KNN_SPLIT(8) DF_KNN_SPLIT(16)
#undef DF_KNN_SPLIT
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DF_KNN_ARGS
  return static_cast<int>(err);
}

// the one launch: node_bits is the device's scratch at kBig between
// launches and ticket its zero-between-launches counter; three_launch: the
// design before (node_bits any scratch of n, ticket unused); *launched:
// the kernels this call launched
extern "C" int df_mutual_nearest(const void* pos, const void* active, int n, const void* cand, const void* valid,
                                 int nc, void* cand_d2, void* node_bits, void* node_d2, void* ticket,
                                 int three_launch, int* launched, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const bool* act = static_cast<const bool*>(active);
  const float* c = static_cast<const float*>(cand);
  const bool* ok = static_cast<const bool*>(valid);
  float* cd = static_cast<float*>(cand_d2);
  int* bits = static_cast<int*>(node_bits);
  float* nd = static_cast<float*>(node_d2);
  if (!three_launch) {
    if (ticket == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    unsigned int* tk = static_cast<unsigned int*>(ticket);
    const long long threads = static_cast<long long>(nc) * kMnLanes;
    const unsigned blocks = static_cast<unsigned>(threads > 0 ? (threads + kMnThreads - 1) / kMnThreads : 1);
    mutual_nearest_one_kernel<<<blocks, kMnThreads, 0, s>>>(p, act, n, c, ok, nc, cd, bits, nd, tk);
    *launched = 1;
    return static_cast<int>(cudaGetLastError());
  }
  fill_bits_kernel<<<(n + 255) / 256, 256, 0, s>>>(bits, n);
  *launched = 1;
  if (nc > 0) {
    mutual_nearest_kernel<<<(nc + kThreads - 1) / kThreads, kThreads, 0, s>>>(p, act, n, c, ok, nc, cd, bits);
    ++*launched;
  }
  bits_to_float_kernel<<<(n + 255) / 256, 256, 0, s>>>(bits, nd, n);
  ++*launched;
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
