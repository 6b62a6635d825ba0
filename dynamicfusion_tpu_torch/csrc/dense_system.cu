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
// are few (a point's 8 neighbours make 8 x 8 6x6 blocks: 3 200 points,
// ~7 M products) and the rows small (0.3 MB), so N is its write.
//
// Design of N (entry dense_gram). The data Gram is nonzero only at the
// 6x6 blocks (i, m) of two nodes that share a point. N sums those blocks
// on chip and writes the dense matrix once, zeros and all:
// - Quantize once (int8): a pass writes the int8 code of every row value,
//   q = clip(rint(v / c), +-127) with c the column scale of the value's
//   node (a true division, as XLA keeps it): P x R x 48 codes, after the
//   scales are complete (entry gram_scales, or the given ones).
// - A block per (node i, tile of kTile = 128 column nodes): N x
//   ceil(N / 128) blocks of 288 threads, each with a 128 x 36 accumulator
//   (18 KB of int32, 37 KB of float64) and the rows of 64 staged entries
//   (32 at R = 3 in bf16; static shared memory under 48 KB), whatever N
//   is. Shared memory does not grow with N, so N has no node limit of its
//   own: the (6N)^2 float32 matrix must fit in device memory (~23 500
//   nodes on 80 GB) and the grid stay below 2^31 blocks (entry
//   gram_launch gives the grid and refuses past it).
// - The blocks start with the nodes of the most entries (a one-block pass
//   orders the nodes by the bit length of their entry counts): the
//   heaviest walks, which each of that node's ceil(N / 128) blocks
//   repeats, then run beside the light nodes' blocks, not after them.
// - A block walks its node's (point, neighbour) entries in the order of
//   the node-sorted list kernels F and G use, a chunk at a time: thread e
//   of the first warps takes entry e (its id and its point's neighbour ids
//   loaded a chunk ahead), and, if a neighbour falls in the tile, stages
//   its slots and its point's codes (or bf16 rows, in 16-byte pieces) and
//   marks it, by ballot, for each thread group with a cell in it. Two
//   barriers a chunk, none an entry.
// - Thread (g, a, b) owns the cells (s, a, b) of the tile's slots s with
//   s mod 8 = g. It visits only its group's marked entries, in list order,
//   adding sum_r v[p,r,kn,a] v[p,r,k,b] for each neighbour k whose slot is
//   its own. No two threads share a cell: no atomics. The int32 sums are
//   exact; the bf16 products, exact in float32, are summed in float64 in
//   list order and rounded once, as the plain version rounds its float64
//   product (a float32 sum over a node of thousands of entries parts from
//   it by ~3e-6 of the largest entry), the same in every run.
// - The node's own block (i, i) takes a term from every one of its
//   entries, so in the tile that holds it the one group that owns its slot
//   walks them all. Sharing that block across the eight groups (each
//   summing in registers, added in group order) cuts the time of a very
//   skewed node (one node in 60% of the points) but slows int8 at the base
//   config's own spread of entries, even where only its heaviest node
//   shares, and does not help the shard mode, so it is not done
//   (scripts/torch_gram_variants.py times it; PERF.md).
// - The epilogue turns the int32 sums into float32 in place, g (c_i c_j)
//   with the tile's scales staged at the start, adds the node's edge share
//   in the JAX order, data + ((h_ij placed + h_ji placed) + diagonal
//   blocks), and streams the block's 6 rows x 768 columns out, the
//   float64 sums rounded as they go: in int8 with 16-byte stores where 6N
//   and the tile allow (the shard mode, a quarter of the entries and the
//   whole write, gains most), else with 8-byte ones (bf16 was slower with
//   16-byte ones; scripts/torch_gram_variants.py). Four blocks fit on an
//   SM in int8 (by registers), five in bf16 at R = 1 (by shared memory)
//   and three at R = 3 (by registers), so one block's stores overlap the
//   others' walks.
// What limits it: the write, and the latency of the walks (two barriers
// and a gather of rows a chunk); the heaviest node's blocks walk longest,
// its self tile's owning group longest of all.
// The blocks' order does not change the result: a (node, tile) is one
// block's, and its sums run in a fixed order.
// Entry gram_scales (one block a node) takes the int8 column scales
// c = max(max |row|, 1e-12) x float32(1 / 127) over the node's entries (a
// max, exact in any order; the product is what XLA makes of the jitted JAX
// package's division by the constant 127).
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

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kK = 8;
constexpr int kScaleThreads = 192;  // 6 columns x 32 lanes
constexpr int kCodeThreads = 256;
constexpr int kOrderThreads = 1024;
constexpr int kTile = 128;                 // column nodes a Gram block; a slot fits a signed char
constexpr int kGroups = 8;                 // slot s belongs to thread group s % kGroups
constexpr int kGramThreads = kGroups * 36;  // a group: one thread a (a, b)
constexpr int kAccStride = 6 * kTile + 8;  // an accumulator row: 16-byte aligned, 8 banks on
constexpr int kDampThreads = 1024;
constexpr int kCopyThreads = 256;
// the jitted JAX package's c = cmax / 127: XLA folds the division by the
// constant into a product with its float32 reciprocal
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float quantize(float v, float c) {
  return fminf(fmaxf(rintf(v / c), -127.0f), 127.0f);
}

__device__ __forceinline__ int value_of(int8_t v) { return v; }
__device__ __forceinline__ float value_of(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// codes (P, R, 8, 6): each row value quantized once, with the scale of its
// column 6 knn[p, k] + d
__global__ void __launch_bounds__(kCodeThreads)
gram_codes_kernel(const __nv_bfloat16* __restrict__ rows, int nrows, const int* __restrict__ knn,
                  const float* __restrict__ scale, int total, int8_t* __restrict__ codes) {
  const int i = blockIdx.x * kCodeThreads + threadIdx.x;
  if (i >= total) return;
  const int d = i % 6, k = (i / 6) % kK, pt = i / (nrows * kK * 6);
  codes[i] = static_cast<int8_t>(quantize(__bfloat162float(rows[i]), scale[6 * knn[pt * kK + k] + d]));
}

// perm (N,): the nodes by descending bit length of their entry counts (ties
// in atomic order: the Gram's result does not depend on its blocks' order),
// so that the longest walks start first
__global__ void __launch_bounds__(kOrderThreads)
gram_order_kernel(const int* __restrict__ off, int n, int* __restrict__ perm) {
  __shared__ int next[33];
  if (threadIdx.x < 33) next[threadIdx.x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kOrderThreads) atomicAdd(&next[32 - __clz(off[i + 1] - off[i])], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int start = 0;
    for (int b = 32; b >= 0; --b) {
      const int c = next[b];
      next[b] = start;
      start += c;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kOrderThreads) perm[atomicAdd(&next[32 - __clz(off[i + 1] - off[i])], 1)] = i;
}

// one block a (node, column tile); vals the int8 codes or the bf16 rows
// (P, kR, 8, 6), 16-byte aligned
template <bool kInt8, int kR>
__global__ void __launch_bounds__(kGramThreads)
dense_gram_kernel(const void* __restrict__ vals, const int* __restrict__ knn, const int* __restrict__ order,
                  const int* __restrict__ off, const float* __restrict__ scale, const float* __restrict__ h_ij,
                  const float* __restrict__ diag, const int* __restrict__ e_dst, const int* __restrict__ e_order,
                  const int* __restrict__ e_off, const int* __restrict__ perm, int ce, int n, int tiles,
                  int with_edges, float* __restrict__ out) {
  using Val = typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type;
  using Left = typename std::conditional<kInt8, int, float>::type;
  // the int8 sums exact in int32; the bf16 products (exact in float32)
  // summed in float64 and rounded once, as the plain version's
  using Acc = typename std::conditional<kInt8, int, double>::type;
  constexpr int kPer = kR * kK * 6;                                  // values a point
  constexpr int kVecs = kPer * static_cast<int>(sizeof(Val)) / 16;  // 16-byte pieces a point
  // entries staged at a time, one a thread of the first warps; static
  // shared memory stays under 48 KB
  constexpr int kChunk = (kInt8 || kR == 1) ? 64 : 32;
  constexpr int kWarps = kChunk / 32;
  __shared__ __align__(16) Acc acc[6 * kAccStride];
  __shared__ __align__(16) Val staged[kChunk * kPer];
  __shared__ int s_kn[kChunk];
  __shared__ signed char s_slot[kChunk][kK];
  __shared__ unsigned long long s_gmask[kChunk];  // an entry's neighbours in the tile, 8 bits a group
  __shared__ unsigned s_hits[kGroups][kWarps];    // a group's entries of the chunk, a bit each
  __shared__ float s_scale[kInt8 ? 6 * kTile + 6 : 1];  // the tile's column scales, then the node's
  float* accf = reinterpret_cast<float*>(acc);

  const int nb = blockIdx.x / tiles;
  const int node = perm[nb];
  const int t0 = (blockIdx.x - nb * tiles) * kTile;
  const int tw = min(kTile, n - t0);
  const int tid = threadIdx.x;
  const int g = tid / 36, a = (tid / 6) % 6, b = tid % 6;
  for (int i = tid; i < 6 * kAccStride; i += kGramThreads) acc[i] = Acc(0);
  if constexpr (kInt8) {
    for (int i = tid; i < 6 * tw; i += kGramThreads) s_scale[i] = scale[6 * t0 + i];
    if (tid < 6) s_scale[6 * kTile + tid] = scale[6 * node + tid];
  }
  const uint4* src = static_cast<const uint4*>(vals);
  uint4* dst = reinterpret_cast<uint4*>(staged);
  const int q0 = off[node], q1 = off[node + 1];
  if (q0 == q1) __syncthreads();  // else the first chunk's barriers order the above

  // an entry and its point's neighbour ids, loaded a chunk ahead
  int ent = -1;
  int4 lo = make_int4(0, 0, 0, 0), hi = lo;
  auto fetch = [&](int base) {
    ent = -1;
    if (tid < kChunk && base + tid < q1) {
      ent = order[base + tid];
      const int4* ids = reinterpret_cast<const int4*>(knn) + 2 * static_cast<size_t>(ent / kK);
      lo = ids[0];
      hi = ids[1];
    }
  };
  fetch(q0);
  for (int base = q0; base < q1; base += kChunk) {
    // thread e stages entry e of the chunk if its point has a neighbour in
    // the tile: the slots, the groups they fall to, the point's codes (or
    // bf16 rows) in 16-byte pieces
    if (tid < kChunk) {
      unsigned long long gm = 0;
      if (ent >= 0) {
        const int id[kK] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          const int s = id[k] - t0;
          if (static_cast<unsigned>(s) < static_cast<unsigned>(tw)) {
            s_slot[tid][k] = static_cast<signed char>(s);
            gm |= 1ull << (8 * (s % kGroups) + k);
          }
        }
        if (gm) {
          s_gmask[tid] = gm;
          s_kn[tid] = ent % kK;
          const uint4* from = src + static_cast<size_t>(ent / kK) * kVecs;
#pragma unroll
          for (int j = 0; j < kVecs; ++j) dst[tid * kVecs + j] = __ldg(from + j);
        }
      }
#pragma unroll
      for (int h = 0; h < kGroups; ++h) {
        const unsigned bits = __ballot_sync(0xffffffffu, ((gm >> (8 * h)) & 0xffu) != 0);
        if ((tid & 31) == 0) s_hits[h][tid >> 5] = bits;
      }
    }
    fetch(base + kChunk);
    __syncthreads();
    // thread (g, a, b): its group's entries, in list order
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      for (unsigned hit = s_hits[g][w]; hit; hit &= hit - 1) {
        const int e = 32 * w + __ffs(hit) - 1;
        unsigned m = static_cast<unsigned>(s_gmask[e] >> (8 * g)) & 0xffu;
        const Val* v = staged + e * kPer;
        const int ke = s_kn[e];
        Left left[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) left[r] = value_of(v[(r * kK + ke) * 6 + a]);
        do {
          const int k = __ffs(m) - 1;
          m &= m - 1;
          const int s = s_slot[e][k];
          Acc sum = Acc(0);
#pragma unroll
          for (int r = 0; r < kR; ++r) sum = sum + static_cast<Acc>(left[r] * value_of(v[(r * kK + k) * 6 + b]));
          acc[a * kAccStride + 6 * s + b] += sum;
        } while (m);
      }
    }
    __syncthreads();
  }

  // the int8 sums as float32, g (c_i c_j), in place (the float64 sums are
  // rounded as they are written)
  const int wcols = 6 * tw;
  if constexpr (kInt8) {
    for (int ra = 0; ra < 6; ++ra) {
      const float rs = s_scale[6 * kTile + ra];
      for (int c = tid; c < wcols; c += kGramThreads) {
        const int at = ra * kAccStride + c;
        accf[at] = __int2float_rn(acc[at]) * (rs * s_scale[c]);
      }
    }
    __syncthreads();
  }

  // the edge share in the tile: out-edges n -> m put h_ij at (n, m),
  // in-edges m -> n put h_ijᵀ there, the diagonal block at (n, n);
  // data + ((A + B) + D); one item a cell (a repeated edge is written by
  // its first item, with the last one's block, as the dense placement)
  if (with_edges) {
    const int o0 = node * ce;
    const int i0 = e_off[node], i1 = e_off[node + 1];
    const int items = (ce + (i1 - i0) + 1) * 36;
    for (int t = tid; t < items; t += kGramThreads) {
      const int slot = t / 36, ea = (t % 36) / 6, eb = t % 6;
      int m;
      bool skip = false;
      if (slot < ce) {
        m = e_dst[o0 + slot];
        for (int j = 0; j < slot; ++j) skip = skip || e_dst[o0 + j] == m;
      } else if (slot < ce + (i1 - i0)) {
        m = e_order[i0 + slot - ce] / ce;  // the in-edge's source
        for (int j = 0; j < ce; ++j) skip = skip || e_dst[o0 + j] == m;  // the out-edge's item writes it
        for (int q = i0; q < i0 + slot - ce; ++q) skip = skip || e_order[q] / ce == m;
      } else {
        m = node;
      }
      if (m == node && slot < ce + (i1 - i0)) skip = true;  // the diagonal item writes it
      if (skip || static_cast<unsigned>(m - t0) >= static_cast<unsigned>(tw)) continue;
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
      const int at = ea * kAccStride + 6 * (m - t0) + eb;
      if constexpr (kInt8) {
        accf[at] = accf[at] + sum;
      } else {
        acc[at] = static_cast<double>(static_cast<float>(acc[at]) + sum);
      }
    }
    __syncthreads();
  }

  // the block's 6 rows x wcols columns, written once
  auto value = [&](int at) -> float {
    if constexpr (kInt8) {
      return accf[at];
    } else {
      return static_cast<float>(acc[at]);
    }
  };
  const size_t ld = static_cast<size_t>(6) * n;
  float* row0 = out + static_cast<size_t>(6) * node * ld + 6 * t0;
  if (kInt8 && (n & 1) == 0 && (tw & 1) == 0) {  // 16-byte aligned rows and tiles
    for (int ra = 0; ra < 6; ++ra) {
      for (int c = 4 * tid; c < wcols; c += 4 * kGramThreads) {
        const int at = ra * kAccStride + c;
        __stcs(reinterpret_cast<float4*>(row0 + ra * ld + c),
               make_float4(value(at), value(at + 1), value(at + 2), value(at + 3)));
      }
    }
  } else {  // 8-byte pieces: 6N and a tile's 6 tw columns are even
    for (int ra = 0; ra < 6; ++ra) {
      for (int c = 2 * tid; c < wcols; c += 2 * kGramThreads) {
        const int at = ra * kAccStride + c;
        __stcs(reinterpret_cast<float2*>(row0 + ra * ld + c), make_float2(value(at), value(at + 1)));
      }
    }
  }
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

// geom (3,) int32: kernel N's launch at n nodes, its blocks, threads a
// block and column nodes a block; cudaErrorInvalidValue where n < 1 or the
// grid, n x ceil(n / kTile) blocks, would pass 2^31 - 1 (its one limit)
extern "C" int df_gram_launch(int n, void* geom) {
  int* g = static_cast<int*>(geom);
  const long long blocks = static_cast<long long>(n) * ((static_cast<long long>(n) + kTile - 1) / kTile);
  const bool ok = n >= 1 && blocks <= INT_MAX;
  g[0] = ok ? static_cast<int>(blocks) : 0;
  g[1] = kGramThreads;
  g[2] = kTile;
  return static_cast<int>(ok ? cudaSuccess : cudaErrorInvalidValue);
}

// out (6N, 6N) float32: the data Gram of the rows (P, R, 8, 6) bf16, 16-byte
// aligned (int8 with ``scale``, its codes written to ``codes`` (P R 48)
// first, or bf16 when int8 is 0) plus, with with_edges, the edge blocks;
// knn (P, 8) int32; ce = E / N out-edges a node (the edge arguments are not
// read without with_edges)
extern "C" int df_dense_gram(const void* rows, int nrows, int npts, const void* knn, const void* order,
                             const void* off, const void* scale, const void* h_ij, const void* diag,
                             const void* e_dst, const void* e_order, const void* e_off, int ce, int n, int int8,
                             int with_edges, void* codes, void* perm, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int geom[3];
  if (df_gram_launch(n, geom) != cudaSuccess || (nrows != 1 && nrows != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (n + kTile - 1) / kTile;
  auto* kn = static_cast<const int*>(knn);
  const void* vals = rows;
  if (int8 && npts > 0) {
    const int total = npts * nrows * kK * 6;
    gram_codes_kernel<<<(total + kCodeThreads - 1) / kCodeThreads, kCodeThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(rows), nrows, kn, static_cast<const float*>(scale), total,
        static_cast<int8_t*>(codes));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    vals = codes;
  }
  gram_order_kernel<<<1, kOrderThreads, 0, s>>>(static_cast<const int*>(off), n, static_cast<int*>(perm));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto launch = [&](auto kernel) {
    kernel<<<n * tiles, kGramThreads, 0, s>>>(
        vals, kn, static_cast<const int*>(order), static_cast<const int*>(off), static_cast<const float*>(scale),
        static_cast<const float*>(h_ij), static_cast<const float*>(diag), static_cast<const int*>(e_dst),
        static_cast<const int*>(e_order), static_cast<const int*>(e_off), static_cast<const int*>(perm), ce, n, tiles,
        with_edges, static_cast<float*>(out));
  };
  if (int8) {
    nrows == 3 ? launch(dense_gram_kernel<true, 3>) : launch(dense_gram_kernel<true, 1>);
  } else {
    nrows == 3 ? launch(dense_gram_kernel<false, 3>) : launch(dense_gram_kernel<false, 1>);
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
