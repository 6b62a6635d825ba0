// Kernel H: node insertion into the warp field.
//
// Replaces dynamicfusion_tpu/models/warpfield.py:372 _insert_nodes_impl
// (behind the lax.cond of insert_nodes :365-369): the coverage-cell hash
// decimation (a stable argsort of the cell ids, first occurrence wins),
// the farthest-first ranking (lax.top_k of the kept candidates' squared
// distance to their nearest node), the free-slot list (jnp.nonzero of the
// inactive slots) and the delta scatter of the new nodes.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700.00 W: 3.35 TB/s, 67 TFLOP/s
// float32, data-sheet peaks; measured times in PERF.md): latency. The slice's
// call sorts 4 800 candidates twice (64 KB of keys) and writes at most 1 024
// nodes: ~0.2 MB and a few hundred thousand compare-exchanges, single
// microseconds of work.
// Design: one block of 1024 threads, everything in shared memory up to
// 16 384 candidates; above that (the 19 200 of reference_parity()'s
// 640x480 maps) the sort keys live in a device-memory scratch the wrapper
// allocates, the rest stays in shared memory. Pass 1
// (select): each candidate becomes a 64-bit key (cell id in the order of
// its int32 value, then the candidate index) and a bitonic sort orders
// them: the lowest index of each cell comes first, as with the stable
// argsort. The kept candidates then become keys (the bits of their
// non-negative squared distance inverted, then the index) and a second
// sort gives farthest first, ties to the lower index (lax.top_k's order).
// A block scan lists the free slots in ascending order. A device flag
// (count < cap) gates the whole insertion, so the frame never syncs. The
// seed dual quaternions of the new nodes come from kernel E (warp_dq_at)
// between the two passes, and their radii (node_radius, or kernel E's
// adaptive radius against the field after the retirement). Pass 2 (apply):
// each new node is written into its slot as old + (new - old), the JAX
// package's delta scatter, and the count grows by a fixed-order block sum.
#include "common.cuh"
#include "dq.cuh"

namespace {

constexpr int kBlock = 1024;
constexpr unsigned long long kNone = ~0ull;

__device__ void bitonic_sort(unsigned long long* a, int np2) {
  for (int k = 2; k <= np2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < np2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = (i & k) == 0;
          const unsigned long long x = a[i], y = a[ixj];
          if ((x > y) == up) {
            a[i] = y;
            a[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// inclusive scan of one int per thread over the block (Hillis-Steele)
__device__ int block_scan(int v, int* sm) {
  sm[threadIdx.x] = v;
  __syncthreads();
  for (int o = 1; o < blockDim.x; o <<= 1) {
    const int add = threadIdx.x >= o ? sm[threadIdx.x - o] : 0;
    __syncthreads();
    sm[threadIdx.x] += add;
    __syncthreads();
  }
  const int out = sm[threadIdx.x];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kBlock)
insert_select_kernel(const float* __restrict__ cand, const float* __restrict__ cand_d2,
                     const bool* __restrict__ valid, int nc, int np2, const bool* __restrict__ active,
                     const int* __restrict__ count, const bool* __restrict__ gate, int cap, float cov,
                     float cov2, int64_t* __restrict__ slots, float* __restrict__ new_pos,
                     unsigned long long* __restrict__ gkeys) {
  extern __shared__ unsigned long long smem[];
  // np2 keys in shared memory, or in the device-memory scratch gkeys
  unsigned long long* keys = gkeys != nullptr ? gkeys : smem;
  unsigned char* keep = reinterpret_cast<unsigned char*>(gkeys != nullptr ? smem : smem + np2);  // np2
  int* free_idx = reinterpret_cast<int*>(keep + np2);                // cap
  int* scan = free_idx + cap;                                        // blockDim
  // 1. decimation: lowest candidate index of each coverage cell
  for (int i = threadIdx.x; i < np2; i += blockDim.x) {
    unsigned long long key = kNone;
    if (i < nc) {
      const unsigned int c0 = static_cast<unsigned int>(static_cast<int>(floorf(dfk::nan_to_num(cand[3 * i]) / cov)));
      const unsigned int c1 = static_cast<unsigned int>(static_cast<int>(floorf(dfk::nan_to_num(cand[3 * i + 1]) / cov)));
      const unsigned int c2 = static_cast<unsigned int>(static_cast<int>(floorf(dfk::nan_to_num(cand[3 * i + 2]) / cov)));
      const unsigned int h = (c0 * 73856093u) ^ (c1 * 19349663u) ^ (c2 * 83492791u);
      key = (static_cast<unsigned long long>(h ^ 0x80000000u) << 32) | static_cast<unsigned int>(i);
    }
    keys[i] = key;
    keep[i] = 0;
  }
  __syncthreads();
  bitonic_sort(keys, np2);
  for (int i = threadIdx.x; i < nc; i += blockDim.x) {
    const int c = static_cast<int>(keys[i] & 0xffffffffull);
    const bool first = i == 0 || (keys[i] >> 32) != (keys[i - 1] >> 32);
    keep[c] = (first && valid[c] && cand_d2[c] > cov2) ? 1 : 0;
  }
  __syncthreads();
  // 2. farthest first among the kept candidates
  for (int i = threadIdx.x; i < np2; i += blockDim.x) {
    unsigned long long key = kNone;
    if (i < nc && keep[i]) {
      const float d = fmaxf(cand_d2[i], 0.0f) + 0.0f;
      key = (static_cast<unsigned long long>(~__float_as_uint(d)) << 32) | static_cast<unsigned int>(i);
    }
    keys[i] = key;
  }
  __syncthreads();
  bitonic_sort(keys, np2);
  // 3. the free slots in ascending order
  const int per = (cap + blockDim.x - 1) / blockDim.x;
  const int lo = min(cap, static_cast<int>(threadIdx.x) * per), hi = min(cap, lo + per);
  int mine = 0;
  for (int s = lo; s < hi; ++s) mine += active[s] ? 0 : 1;
  int at = block_scan(mine, scan) - mine;
  for (int s = lo; s < hi; ++s) {
    if (!active[s]) free_idx[at++] = s;
  }
  __syncthreads();
  const int n_free = max(cap - *count, 0);
  const bool open = *gate;
  for (int r = threadIdx.x; r < cap; r += blockDim.x) {
    const int sel = (r < nc && keys[r] != kNone) ? static_cast<int>(keys[r] & 0xffffffffull) : -1;
    const bool ok = open && sel >= 0 && r < n_free;
    slots[r] = ok ? free_idx[r] : cap;
    const int c = max(sel, 0);
    new_pos[3 * r] = cand[3 * c];
    new_pos[3 * r + 1] = cand[3 * c + 1];
    new_pos[3 * r + 2] = cand[3 * c + 2];
  }
}

__global__ void __launch_bounds__(kBlock)
insert_apply_kernel(float* __restrict__ pos, float* __restrict__ dq, float* __restrict__ radius,
                    bool* __restrict__ active, int* __restrict__ count, int* __restrict__ last_support,
                    const int64_t* __restrict__ slots, const float* __restrict__ new_pos,
                    const float* __restrict__ seed_dq, const int* __restrict__ frame_idx,
                    const float* __restrict__ new_radius, int cap) {
  __shared__ int sm[kBlock];
  const int fi = *frame_idx;
  int added = 0;
  for (int r = threadIdx.x; r < cap; r += blockDim.x) {
    const int64_t s = slots[r];
    if (s >= cap) continue;
#pragma unroll
    for (int a = 0; a < 3; ++a) pos[3 * s + a] = pos[3 * s + a] + (new_pos[3 * r + a] - pos[3 * s + a]);
#pragma unroll
    for (int a = 0; a < 8; ++a) dq[8 * s + a] = dq[8 * s + a] + (seed_dq[8 * r + a] - dq[8 * s + a]);
    radius[s] = radius[s] + (new_radius[r] - radius[s]);
    active[s] = true;
    last_support[s] = last_support[s] + (fi - last_support[s]);
    ++added;
  }
  const int total = block_scan(added, sm);
  if (threadIdx.x == blockDim.x - 1) count[0] = count[0] + total;
}

}  // namespace

// gkeys: null (the keys in shared memory) or a (np2,) 64-bit device scratch
extern "C" int df_insert_select(const void* cand, const void* cand_d2, const void* valid, int nc, int np2,
                                const void* active, const void* count, const void* gate, int cap, float cov,
                                float cov2, void* slots, void* new_pos, void* gkeys, void* stream) {
  const size_t key_bytes = gkeys != nullptr ? 0 : static_cast<size_t>(np2) * 8;
  const size_t smem = key_bytes + static_cast<size_t>(np2) + static_cast<size_t>(cap) * 4 + kBlock * 4;
  cudaError_t err = cudaFuncSetAttribute(insert_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  insert_select_kernel<<<1, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand), static_cast<const float*>(cand_d2), static_cast<const bool*>(valid), nc, np2,
      static_cast<const bool*>(active), static_cast<const int*>(count), static_cast<const bool*>(gate), cap, cov,
      cov2, static_cast<int64_t*>(slots), static_cast<float*>(new_pos), static_cast<unsigned long long*>(gkeys));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int df_insert_apply(void* pos, void* dq, void* radius, void* active, void* count, void* last_support,
                               const void* slots, const void* new_pos, const void* seed_dq, const void* frame_idx,
                               const void* new_radius, int cap, void* stream) {
  insert_apply_kernel<<<1, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(pos), static_cast<float*>(dq), static_cast<float*>(radius), static_cast<bool*>(active),
      static_cast<int*>(count), static_cast<int*>(last_support), static_cast<const int64_t*>(slots),
      static_cast<const float*>(new_pos), static_cast<const float*>(seed_dq), static_cast<const int*>(frame_idx),
      static_cast<const float*>(new_radius), cap);
  return static_cast<int>(cudaGetLastError());
}
