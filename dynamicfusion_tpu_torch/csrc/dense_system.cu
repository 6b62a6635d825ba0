// Kernels N and O: the dense normal equations of the direct (Cholesky)
// warp solve, and their LM damping.
//
// Kernel N replaces dynamicfusion_tpu/solvers/warp_solver.py:505 data_jtj
// (the int8 or bf16 syrk of the one-hot-expanded Jacobian rows) and :613
// edge_jtj (the ARAP blocks placed in the dense matrix by one-hot einsums),
// summed as :479 gn_system_dense sums them. Kernel O replaces the damping
// of :1182 _damped_system. The factor and its solve (:872 _solve_linear)
// are cuSOLVER's, called from PyTorch, as the JAX package leaves them to
// its linear-algebra library.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700.00 W: 3.35 TB/s, 67 TFLOP/s
// float32, 1 979 TOP/s int8, data-sheet peaks; measured times in PERF.md):
// bytes. At 1024 nodes the (6N)^2 float32 matrix is 151 MB: N writes it
// once (45 us at 3.35 TB/s), O reads and writes it (90 us). The products
// are few: a point's 8 neighbours make 8 x 8 6x6 blocks, 3 200 points
// ~0.7 M int8 products a row.
//
// Design of N (entry dense_gram): one thread block owns the 6 rows of one
// node and keeps their 6 x 6N sums in shared memory (int32 for the int8
// Gram, float32 for the bf16 one: 147 KB at 1024 nodes, the H100's 227 KB
// with the opt-in). The block walks its node's (point, neighbour) entries
// in the order of the per-solve node-sorted list kernels F and G use; for
// an entry (p, k_n) a thread per (k, a, b) adds sum_r q[p,r,k_n,a]
// q[p,r,k,b] into column 6 knn[p,k] + b. A point's neighbours are
// distinct, so the threads of one entry never meet; entries are separated
// by a barrier. No atomics and no zeroing pass over device memory: the
// int32 sums are exact in any order, the float32 ones are summed in a
// fixed order, and the matrix is written once, coalesced, with the edge
// share added in the JAX order: data + ((h_ij placed + h_ji placed) +
// diagonal blocks). Entry gram_scales (one block a node) takes the int8
// column scales c = max(max |row|, 1e-12) x float32(1 / 127) over the
// node's entries (a max, exact in any order; the product is what XLA makes
// of the jitted JAX package's division by the constant 127); q =
// clip(rint(row / c), +-127), a true division, as XLA keeps it.
//
// Shard mode (the base config's sharded step, dynamicfusion_tpu/parallel/
// distributed_gn.py:96-108 with warp_solver.py:505-545's col_scale_reduce):
// the rows are one shard's points, the column scales are given (the pmax
// of every shard's gram_scales, so that each shard quantizes alike and the
// int32 sums of the shards add up to the whole Gram's), and the edge share
// is left out (the caller adds the ARAP blocks once, after the psum).
//
// Design of O (entry dense_damp): one block sums the diagonal over the
// active dofs in a fixed tree (reduce.cuh's order) and writes the floor;
// then a block per row copies the matrix, adding (d + lambda d_eff) + unit
// on the diagonal, with lambda read from device memory.
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kK = 8;
constexpr int kScaleThreads = 192;  // 6 columns x 32 lanes
constexpr int kGramThreads = 512;
constexpr int kEntryItems = kK * 36;  // (k, a, b) of one entry
constexpr int kDampThreads = 1024;
constexpr int kCopyThreads = 256;
// the jitted JAX package's c = cmax / 127: XLA folds the division by the
// constant into a product with its float32 reciprocal
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float quantize(float v, float c) {
  return fminf(fmaxf(rintf(v / c), -127.0f), 127.0f);
}

__global__ void __launch_bounds__(kScaleThreads)
gram_scales_kernel(const __nv_bfloat16* __restrict__ rows, int nrows, const int* __restrict__ order,
                   const int* __restrict__ off, float* __restrict__ scale) {
  __shared__ float sm[kScaleThreads];
  const int node = blockIdx.x;
  const int d = threadIdx.x % 6;
  float m = 0.0f;
  for (int q = off[node] + threadIdx.x / 6; q < off[node + 1]; q += kScaleThreads / 6) {
    const int ent = order[q];
    const int pt = ent / kK, k = ent % kK;
    for (int r = 0; r < nrows; ++r) {
      const float v = __bfloat162float(rows[((static_cast<size_t>(pt) * nrows + r) * kK + k) * 6 + d]);
      m = fmaxf(m, fabsf(v));
    }
  }
  sm[threadIdx.x] = m;
  __syncthreads();
  if (threadIdx.x < 6) {
    for (int t = threadIdx.x + 6; t < kScaleThreads; t += 6) m = fmaxf(m, sm[t]);
    scale[6 * node + threadIdx.x] = fmaxf(m, 1e-12f) * kInv127;
  }
}

template <bool kInt8>
__global__ void __launch_bounds__(kGramThreads)
dense_gram_kernel(const __nv_bfloat16* __restrict__ rows, int nrows, const int* __restrict__ knn,
                  const int* __restrict__ order, const int* __restrict__ off, const float* __restrict__ scale,
                  const float* __restrict__ h_ij, const float* __restrict__ diag, const int* __restrict__ e_dst,
                  const int* __restrict__ e_order, const int* __restrict__ e_off, int ce, int n, int with_edges,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  using Acc = typename std::conditional<kInt8, int, float>::type;
  Acc* acc = reinterpret_cast<Acc*>(smem4);
  float* val = reinterpret_cast<float*>(smem4);
  const int node = blockIdx.x;
  const int ncols = 6 * n;
  for (int i = threadIdx.x; i < 6 * ncols; i += blockDim.x) acc[i] = Acc(0);
  __syncthreads();

  // the data Gram: the node's entries in list order
  const int w = threadIdx.x;
  const int k = w / 36, a = (w % 36) / 6, b = w % 6;
  for (int q = off[node]; q < off[node + 1]; ++q) {
    if (w < kEntryItems) {
      const int ent = order[q];
      const int pt = ent / kK, kn = ent % kK;
      const int col = 6 * knn[pt * kK + k] + b;
      Acc s = Acc(0);
      for (int r = 0; r < nrows; ++r) {
        const size_t base = (static_cast<size_t>(pt) * nrows + r) * kK;
        const float va = __bfloat162float(rows[(base + kn) * 6 + a]);
        const float vb = __bfloat162float(rows[(base + k) * 6 + b]);
        if constexpr (kInt8) {
          s += static_cast<int>(quantize(va, scale[6 * node + a])) * static_cast<int>(quantize(vb, scale[col]));
        } else {
          s = s + va * vb;
        }
      }
      acc[a * ncols + col] += s;
    }
    __syncthreads();
  }
  if constexpr (kInt8) {
    for (int i = threadIdx.x; i < 6 * ncols; i += blockDim.x) {
      const int col = i % ncols;
      const float g = __int2float_rn(acc[i]);
      val[i] = g * (scale[6 * node + i / ncols] * scale[col]);
    }
    __syncthreads();
  }

  // the edge share: out-edges n -> m put h_ij at (n, m), in-edges m -> n
  // put h_ijᵀ there, the diagonal block at (n, n); data + ((A + B) + D)
  const int o0 = node * ce;
  const int i0 = with_edges ? e_off[node] : 0, i1 = with_edges ? e_off[node + 1] : 0;
  const int items = with_edges ? (ce + (i1 - i0) + 1) * 36 : 0;
  for (int t = threadIdx.x; t < items; t += blockDim.x) {
    const int slot = t / 36, ab = t % 36, ea = ab / 6, eb = ab % 6;
    int m;
    if (slot < ce) {
      m = e_dst[o0 + slot];
    } else if (slot < ce + (i1 - i0)) {
      m = e_order[i0 + slot - ce] / ce;  // the in-edge's source
      bool dup = false;
      for (int j = 0; j < ce; ++j) dup = dup || e_dst[o0 + j] == m;
      if (dup) continue;  // written by the out-edge's item
    } else {
      m = node;
    }
    if (m == node && slot < ce + (i1 - i0)) continue;  // written by the diagonal item
    float ev = 0.0f, bv = 0.0f;
    for (int j = 0; j < ce; ++j) {
      if (e_dst[o0 + j] == m) ev = h_ij[(static_cast<size_t>(o0 + j) * 6 + ea) * 6 + eb];
    }
    for (int q = i0; q < i1; ++q) {
      const int e = e_order[q];
      if (e / ce == m) bv = h_ij[(static_cast<size_t>(e) * 6 + eb) * 6 + ea];
    }
    float sum = ev + bv;
    if (m == node) sum = sum + diag[(static_cast<size_t>(node) * 6 + ea) * 6 + eb];
    float* cell = val + ea * ncols + 6 * m + eb;
    *cell = *cell + sum;
  }
  __syncthreads();
  float* dst = out + static_cast<size_t>(6 * node) * ncols;
  for (int i = threadIdx.x; i < 6 * ncols; i += blockDim.x) dst[i] = val[i];
}

__global__ void __launch_bounds__(kDampThreads)
damp_floor_kernel(const float* __restrict__ jtj, const bool* __restrict__ active, int n, float floor,
                  float* __restrict__ thresh) {
  __shared__ float sm[kDampThreads / 32];
  __shared__ int cnt[kDampThreads / 32];
  const int dof = 6 * n;
  float s = 0.0f;
  int c = 0;
  for (int i = threadIdx.x; i < dof; i += blockDim.x) {
    const bool on = active[i / 6];
    s += on ? jtj[static_cast<size_t>(i) * (dof + 1)] : 0.0f;
    c += on ? 1 : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, o);
    c += __shfl_down_sync(0xffffffffu, c, o);
  }
  if ((threadIdx.x & 31) == 0) {
    sm[threadIdx.x >> 5] = s;
    cnt[threadIdx.x >> 5] = c;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = sm[threadIdx.x];
    int u = cnt[threadIdx.x];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      t += __shfl_down_sync(0xffffffffu, t, o);
      u += __shfl_down_sync(0xffffffffu, u, o);
    }
    if (threadIdx.x == 0) thresh[0] = floor * (t / fmaxf(static_cast<float>(u), 1.0f));
  }
}

// one block a row
__global__ void __launch_bounds__(kCopyThreads)
damp_copy_kernel(const float* __restrict__ jtj, const bool* __restrict__ active, const float* __restrict__ lam,
                 const float* __restrict__ thresh, int n, float* __restrict__ out) {
  const int dof = 6 * n;
  const int r = blockIdx.x;
  const float* src = jtj + static_cast<size_t>(r) * dof;
  float* dst = out + static_cast<size_t>(r) * dof;
  for (int c = threadIdx.x; c < dof; c += blockDim.x) {
    const float v = src[c];
    if (c == r) {
      const float eff = fmaxf(v, thresh[0]);
      const float unit = (active[r / 6] && v > 1e-12f) ? 1e-8f : 1.0f;
      dst[c] = (v + lam[0] * eff) + unit;
    } else {
      dst[c] = v;
    }
  }
}

}  // namespace

// scale (6N,) per-column int8 scales of the rows (P, R, 8, 6) bf16
extern "C" int df_gram_scales(const void* rows, int nrows, const void* order, const void* off, int n, void* scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gram_scales_kernel<<<n, kScaleThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(rows), nrows,
                                                  static_cast<const int*>(order), static_cast<const int*>(off),
                                                  static_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
}

// out (6N, 6N) float32: the data Gram (int8 with ``scale``, or bf16 when
// int8 is 0) plus, with with_edges, the edge blocks; ce = E / N out-edges a
// node (the edge arguments are not read without with_edges)
extern "C" int df_dense_gram(const void* rows, int nrows, const void* knn, const void* order, const void* off,
                             const void* scale, const void* h_ij, const void* diag, const void* e_dst,
                             const void* e_order, const void* e_off, int ce, int n, int int8, int with_edges,
                             void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(36) * n * sizeof(float);
  auto* rw = static_cast<const __nv_bfloat16*>(rows);
  auto* kn = static_cast<const int*>(knn);
  auto* od = static_cast<const int*>(order);
  auto* of = static_cast<const int*>(off);
  auto* sc = static_cast<const float*>(scale);
  auto* h = static_cast<const float*>(h_ij);
  auto* dg = static_cast<const float*>(diag);
  auto* ed = static_cast<const int*>(e_dst);
  auto* eo = static_cast<const int*>(e_order);
  auto* ef = static_cast<const int*>(e_off);
  auto* o = static_cast<float*>(out);
  cudaError_t err;
  if (int8) {
    err = cudaFuncSetAttribute(dense_gram_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dense_gram_kernel<true><<<n, kGramThreads, smem, s>>>(rw, nrows, kn, od, of, sc, h, dg, ed, eo, ef, ce, n,
                                                          with_edges, o);
  } else {
    err = cudaFuncSetAttribute(dense_gram_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dense_gram_kernel<false><<<n, kGramThreads, smem, s>>>(rw, nrows, kn, od, of, sc, h, dg, ed, eo, ef, ce, n,
                                                           with_edges, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// out = jtj with (d + lam d_eff) + unit on the diagonal; thresh (1,) scratch
extern "C" int df_dense_damp(const void* jtj, const void* active, const void* lam, int n, float floor, void* thresh,
                             void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  damp_floor_kernel<<<1, kDampThreads, 0, s>>>(static_cast<const float*>(jtj), static_cast<const bool*>(active), n,
                                               floor, static_cast<float*>(thresh));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  damp_copy_kernel<<<6 * n, kCopyThreads, 0, s>>>(static_cast<const float*>(jtj), static_cast<const bool*>(active),
                                            static_cast<const float*>(lam), static_cast<const float*>(thresh), n,
                                            static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
