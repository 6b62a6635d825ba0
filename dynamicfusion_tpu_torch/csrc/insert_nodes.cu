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
// float32, data-sheet peaks; measured times in PERF.md): latency. The
// preset's call reads 4 800 candidates (~80 KB) and writes at most 1 024
// nodes: tens of nanoseconds of memory time, so the select's time is its
// chain of block-wide steps.
// Design of the select: one block of 1024 threads, one launch, no sort of
// the candidates. (1) Decimation: an open-addressed hash table keyed by
// the candidate's 32-bit cell hash h holds (h, lowest index) as one 64-bit
// word; a candidate claims an empty word with atomicCAS and otherwise
// takes the atomicMin of the word that holds its h, so the table holds
// the stable argsort's first occurrence of every h whatever the order of
// the atomics. Every value of h can occur; the empty word (index
// 0xffffffff) is no entry's, as no index reaches it. Invalid and covered
// candidates claim their cell too, as JAX computes `first` over all
// candidates. The table lives in shared memory while it fits (to 0.9 load
// at worst: every 19 200 candidates of reference_parity()'s maps), else in
// a device-memory scratch the wrapper allocates. (2) The kept candidates
// (valid, uncovered, first of their cell: a bit each) become 48-bit keys
// (the bits of their squared distance inverted, then the index: d2
// descending, ties to the lower index, lax.top_k's order) written over the
// table. (3) Only the first min(cap, k) of the k keys are ever read: where
// k > cap a radix select (6 digits of 8 bits, a shared histogram a digit)
// finds the cap-th key, and the keys up to it go to a list of at most cap
// keys that a bitonic sort orders (a key a thread in registers up to 1 024
// keys: shuffles within a warp, shared memory across warps); a key whose
// distance is infinite selects nothing, as top_k's non-finite values do.
// (4) A block scan lists the free slots in ascending order. A device flag (count < cap) gates the
// whole insertion, so the frame never syncs. The seed dual quaternions of
// the new nodes come from kernel E (warp_dq_at) between the two passes,
// and their radii (node_radius, or kernel E's adaptive radius against the
// field after the retirement). Pass 2 (apply, dynamicfusion_tpu/models/
// warpfield.py:433-445): ONE launch writes the new field out of place, a
// thread a slot in blocks of kApplyThreads = 128 (8 blocks, so 8 SMs, at
// the preset's 1 024 slots): each block reads the whole plan (cap slot
// numbers, 8 KB from L2) to learn which new node, if any, lands in each of
// its slots, then each slot is copied or written as old + (new - old), the
// JAX package's delta scatter; block 0 also counts the new nodes (an
// integer sum, in any order) into the count. The design before (six
// device copies of the field, then one block of 1 024 threads writing the
// new nodes in place and the count by a block scan) stays as the
// reference mode.
#include "common.cuh"
#include "dq.cuh"

namespace {

constexpr int kBlock = 1024;
constexpr unsigned long long kEmpty = ~0ull;  // a table word no (h, index) entry has
constexpr unsigned long long kPad = ~0ull;    // sorts after every key
constexpr int kBins = 256;                    // a radix digit of 8 bits
constexpr int kDigits = 6;                    // 48-bit keys
constexpr unsigned long long kKeyMask = (1ull << 48) - 1;

// inclusive scan of one int per thread over the block: shuffles within a
// warp, then over the warps' totals (sm holds at least 32 ints)
__device__ int block_scan(int v, int* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) sm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < static_cast<int>(blockDim.x >> 5) ? sm[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    sm[lane] = w;
  }
  __syncthreads();
  const int out = v + (warp > 0 ? sm[warp - 1] : 0);
  __syncthreads();
  return out;
}

// ascending bitonic sort of a[0:n], n a power of two. Up to one key a
// thread the keys stay in registers: partners within a warp by shuffles,
// farther ones through a (the only block-wide barriers); past that, one
// compare-exchange a pair and stage in shared memory.
__device__ void bitonic_sort(unsigned long long* a, int n) {
  const int t = threadIdx.x;
  if (n <= static_cast<int>(blockDim.x)) {
    unsigned long long x = t < n ? a[t] : kPad;
    for (int k = 2; k <= n; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        unsigned long long y;
        if (j >= 32) {
          __syncthreads();
          if (t < n) a[t] = x;
          __syncthreads();
          y = t < n ? a[t ^ j] : kPad;
        } else {
          y = __shfl_xor_sync(0xffffffffu, x, j);
        }
        const bool up = (t & k) == 0, lower = (t & j) == 0;
        x = (lower == up) ? (x < y ? x : y) : (x < y ? y : x);
      }
    }
    __syncthreads();
    if (t < n) a[t] = x;
    __syncthreads();
    return;
  }
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = t; p < (n >> 1); p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const bool up = (i & k) == 0;
        const unsigned long long x = a[i], y = a[i + j];
        if ((x > y) == up) {
          a[i] = y;
          a[i + j] = x;
        }
      }
      __syncthreads();
    }
  }
}

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// the JAX package's int32 coverage-cell hash of candidate i
__device__ __forceinline__ unsigned int cell_hash(const float* __restrict__ cand, int i, float cov) {
  const unsigned int c0 = static_cast<unsigned int>(static_cast<int>(floorf(dfk::nan_to_num(cand[3 * i]) / cov)));
  const unsigned int c1 = static_cast<unsigned int>(static_cast<int>(floorf(dfk::nan_to_num(cand[3 * i + 1]) / cov)));
  const unsigned int c2 = static_cast<unsigned int>(static_cast<int>(floorf(dfk::nan_to_num(cand[3 * i + 2]) / cov)));
  return (c0 * 73856093u) ^ (c1 * 19349663u) ^ (c2 * 83492791u);
}

// the first table word to probe for h (multiplicative hashing onto [0, T))
__device__ __forceinline__ unsigned int home(unsigned int h, unsigned int t) {
  return static_cast<unsigned int>((static_cast<unsigned long long>(h * 2654435761u) * t) >> 32);
}

// a table word as the other threads' atomics left it: shared memory read
// as volatile, device memory from L2 (the atomics act there)
template <bool kDev>
__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  if constexpr (kDev) return __ldcg(p);
  else return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// (h, i) into the table: claim an empty word or lower the index of h's
template <bool kDev>
__device__ __forceinline__ void table_insert(unsigned long long* table, unsigned int t, unsigned int h, int i) {
  const unsigned long long mine = (static_cast<unsigned long long>(h) << 32) | static_cast<unsigned int>(i);
  unsigned int s = home(h, t);
  for (;;) {
    unsigned long long cur = load_word<kDev>(table + s);
    if (cur == kEmpty) {
      cur = atomicCAS(table + s, kEmpty, mine);
      if (cur == kEmpty) return;
    }
    if ((cur >> 32) == h) {
      atomicMin(table + s, mine);
      return;
    }
    s = s + 1 == t ? 0 : s + 1;
  }
}

// the lowest index of h (present: inserted before the last barrier)
template <bool kDev>
__device__ __forceinline__ int table_lowest(const unsigned long long* table, unsigned int t, unsigned int h) {
  unsigned int s = home(h, t);
  for (;;) {
    const unsigned long long cur = load_word<kDev>(table + s);
    if (cur != kEmpty && (cur >> 32) == h) return static_cast<int>(cur & 0xffffffffull);
    s = s + 1 == t ? 0 : s + 1;
  }
}

// this lane's place among the lanes of its warp that append (their
// leader reserves the warp's places with one atomic)
__device__ __forceinline__ unsigned int append_at(unsigned int* counter, bool in) {
  const unsigned int lane = threadIdx.x & 31;
  const unsigned int b = __ballot_sync(0xffffffffu, in);
  unsigned int base = 0;
  if (lane == 0 && b != 0) base = atomicAdd(counter, static_cast<unsigned int>(__popc(b)));
  base = __shfl_sync(0xffffffffu, base, 0);
  return base + static_cast<unsigned int>(__popc(b & ((1u << lane) - 1u)));
}

// the select's dynamic shared memory: [table (T words, shared mode)] |
// list (capp words) | prefix word | 4 counters | free_idx (cap) | scan
// (kBlock) | hist (kBins) | keep bits (one a candidate)
struct Layout {
  size_t list, cnt, free_idx, scan, hist, bits, bytes;
};

__host__ __device__ inline Layout layout(int nc, int cap, int table_words) {
  Layout l;
  l.list = static_cast<size_t>(table_words) * 8;
  l.cnt = l.list + static_cast<size_t>(pow2_at_least(cap)) * 8 + 8;
  l.free_idx = l.cnt + 4 * 4;
  l.scan = l.free_idx + static_cast<size_t>(cap) * 4;
  l.hist = l.scan + static_cast<size_t>(kBlock) * 4;
  l.bits = l.hist + static_cast<size_t>(kBins) * 4;
  l.bytes = l.bits + static_cast<size_t>((nc + 31) / 32) * 4;
  return l;
}

template <bool kDev>
__global__ void __launch_bounds__(kBlock)
insert_select_kernel(const float* __restrict__ cand, const float* __restrict__ cand_d2,
                     const bool* __restrict__ valid, int nc, const bool* __restrict__ active,
                     const int* __restrict__ count, const bool* __restrict__ gate, int cap, float cov, float cov2,
                     int t, int64_t* __restrict__ slots, float* __restrict__ new_pos,
                     unsigned long long* dtable, int* __restrict__ kept) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(nc, cap, kDev ? 0 : t);
  unsigned long long* table = kDev ? dtable : reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* list = reinterpret_cast<unsigned long long*>(smem + l.list);
  unsigned long long* prefix_sh = reinterpret_cast<unsigned long long*>(smem + l.cnt - 8);
  unsigned int* cnt = reinterpret_cast<unsigned int*>(smem + l.cnt);  // kept, keys, list, need
  int* free_idx = reinterpret_cast<int*>(smem + l.free_idx);
  int* scan = reinterpret_cast<int*>(smem + l.scan);
  unsigned int* hist = reinterpret_cast<unsigned int*>(smem + l.hist);
  unsigned int* bits = reinterpret_cast<unsigned int*>(smem + l.bits);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 0. an empty table, counters at zero
  for (int s = threadIdx.x; s < t; s += kBlock) table[s] = kEmpty;
  if (threadIdx.x < 4) cnt[threadIdx.x] = 0;
  // 1. the free slots in ascending order (its barriers publish step 0)
  const int per = (cap + kBlock - 1) / kBlock;
  const int lo = min(cap, static_cast<int>(threadIdx.x) * per), hi = min(cap, lo + per);
  int mine = 0;
  for (int s = lo; s < hi; ++s) mine += active[s] ? 0 : 1;
  int at = block_scan(mine, scan) - mine;
  for (int s = lo; s < hi; ++s) {
    if (!active[s]) free_idx[at++] = s;
  }
  // 2. the lowest index of every cell hash, over all candidates
  for (int i = threadIdx.x; i < nc; i += kBlock) table_insert<kDev>(table, t, cell_hash(cand, i, cov), i);
  __syncthreads();
  // 3. kept: valid, uncovered and first of its cell, a bit each
  for (int base = 0; base < nc; base += kBlock) {
    const int i = base + threadIdx.x;
    bool keep = false;
    if (i < nc && valid[i] && cand_d2[i] > cov2) keep = table_lowest<kDev>(table, t, cell_hash(cand, i, cov)) == i;
    const unsigned int b = __ballot_sync(0xffffffffu, keep);
    if (lane == 0 && base + warp * 32 < nc) {
      bits[(base >> 5) + warp] = b;
      if (b != 0) atomicAdd(&cnt[0], static_cast<unsigned int>(__popc(b)));
    }
  }
  __syncthreads();
  const int k = static_cast<int>(cnt[0]);
  // 4. the kept keys over the table: (~bits(d2)) << 16 | index
  for (int base = 0; base < nc; base += kBlock) {
    const int i = base + threadIdx.x;
    const bool in = i < nc && ((bits[i >> 5] >> (i & 31)) & 1u);
    const unsigned int at_key = append_at(&cnt[1], in);
    if (in) {
      const float d = fmaxf(cand_d2[i], 0.0f) + 0.0f;
      table[at_key] = (static_cast<unsigned long long>(~__float_as_uint(d)) << 16) | static_cast<unsigned int>(i);
    }
  }
  // 5. the cut: the m-th smallest key, m = min(cap, k), by radix select
  const int m = min(cap, k);
  unsigned long long cut = kPad;  // every kept key while k <= cap
  if (k > cap) {
    if (threadIdx.x == 0) {
      *prefix_sh = 0;
      cnt[3] = static_cast<unsigned int>(m);
    }
    for (int d = kDigits - 1; d >= 0; --d) {
      const int shift = 8 * d;
      for (int b = threadIdx.x; b < kBins; b += kBlock) hist[b] = 0;
      __syncthreads();
      const unsigned long long prefix = *prefix_sh;
      const unsigned long long mask = (~0ull << (shift + 8)) & kKeyMask;
      for (int base = 0; base < k; base += kBlock) {
        const int j = base + threadIdx.x;
        unsigned int bin = 0xffffffffu;
        if (j < k) {
          const unsigned long long key = load_word<kDev>(table + j);
          if ((key & mask) == prefix) bin = static_cast<unsigned int>(key >> shift) & (kBins - 1);
        }
        const unsigned int peers = __match_any_sync(0xffffffffu, bin);
        if (bin != 0xffffffffu && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], static_cast<unsigned int>(__popc(peers)));
      }
      __syncthreads();
      if (warp == 0) {
        // the bin that holds the need-th key of this prefix: 8 bins a lane
        const unsigned int need = cnt[3];
        unsigned int c[kBins / 32], sum = 0;
#pragma unroll
        for (int q = 0; q < kBins / 32; ++q) {
          c[q] = hist[lane * (kBins / 32) + q];
          sum += c[q];
        }
        unsigned int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned int v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        const unsigned int excl = incl - sum;
        if (excl < need && need <= incl) {
          unsigned int run = excl;
          bool found = false;
#pragma unroll
          for (int q = 0; q < kBins / 32; ++q) {
            if (!found && run + c[q] >= need) {
              found = true;
              *prefix_sh = prefix | (static_cast<unsigned long long>(lane * (kBins / 32) + q) << shift);
              cnt[3] = need - run;
            }
            run += c[q];
          }
        }
      }
      __syncthreads();
    }
    cut = *prefix_sh;
  } else {
    __syncthreads();
  }
  // 6. the keys up to the cut (m of them) into the list, padded to a power of two
  const int mp = m > 0 ? pow2_at_least(m) : 0;
  for (int base = 0; base < k; base += kBlock) {
    const int j = base + threadIdx.x;
    const unsigned long long key = j < k ? load_word<kDev>(table + j) : kPad;
    const bool in = j < k && key <= cut;
    const unsigned int at_list = append_at(&cnt[2], in);
    if (in) list[at_list] = key;
  }
  for (int j = m + threadIdx.x; j < mp; j += kBlock) list[j] = kPad;
  __syncthreads();
  // 7. farthest first
  bitonic_sort(list, mp);
  // 8. rank r takes the r-th free slot while the gate is open and a slot is free
  const int n_free = max(cap - *count, 0);
  const bool open = *gate;
  for (int r = threadIdx.x; r < cap; r += kBlock) {
    int sel = r < m ? static_cast<int>(list[r] & 0xffffull) : -1;
    if (sel >= 0 && isinf(cand_d2[sel])) sel = -1;  // a non-finite top_k value selects nothing
    const bool ok = open && sel >= 0 && r < n_free;
    slots[r] = ok ? free_idx[r] : cap;
    const int c = max(sel, 0);
    new_pos[3 * r] = cand[3 * c];
    new_pos[3 * r + 1] = cand[3 * c + 1];
    new_pos[3 * r + 2] = cand[3 * c + 2];
  }
  if (kept != nullptr && threadIdx.x == 0) *kept = k;
}

// the current device's opt-in shared memory a block (0 if unknown)
int smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
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

// the apply, a thread a slot: src[j] the rank whose node lands in the
// block's slot j (-1 where none)
constexpr int kApplyThreads = 128;

__global__ void __launch_bounds__(kApplyThreads)
insert_write_kernel(const float* __restrict__ pos, const float* __restrict__ dq, const float* __restrict__ radius,
                    const bool* __restrict__ active, const int* __restrict__ count,
                    const int* __restrict__ last_support, float* __restrict__ pos_o, float* __restrict__ dq_o,
                    float* __restrict__ radius_o, bool* __restrict__ active_o, int* __restrict__ count_o,
                    int* __restrict__ ls_o, const int64_t* __restrict__ slots, const float* __restrict__ new_pos,
                    const float* __restrict__ seed_dq, const int* __restrict__ frame_idx,
                    const float* __restrict__ new_radius, int cap) {
  __shared__ int src[kApplyThreads];
  __shared__ int added;
  const int s0 = blockIdx.x * kApplyThreads;
  src[threadIdx.x] = -1;
  if (threadIdx.x == 0) added = 0;
  __syncthreads();
  int mine = 0;
  for (int r = threadIdx.x; r < cap; r += kApplyThreads) {
    const int64_t s = slots[r];
    if (s >= cap) continue;
    ++mine;
    if (s >= s0 && s < s0 + kApplyThreads) src[s - s0] = r;
  }
  if (blockIdx.x == 0 && mine > 0) atomicAdd(&added, mine);
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) count_o[0] = count[0] + added;
  const int s = s0 + threadIdx.x;
  if (s >= cap) return;
  const int r = src[threadIdx.x];
  if (r < 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) pos_o[3 * s + a] = pos[3 * s + a];
#pragma unroll
    for (int a = 0; a < 8; ++a) dq_o[8 * s + a] = dq[8 * s + a];
    radius_o[s] = radius[s];
    active_o[s] = active[s];
    ls_o[s] = last_support[s];
    return;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) pos_o[3 * s + a] = pos[3 * s + a] + (new_pos[3 * r + a] - pos[3 * s + a]);
#pragma unroll
  for (int a = 0; a < 8; ++a) dq_o[8 * s + a] = dq[8 * s + a] + (seed_dq[8 * r + a] - dq[8 * s + a]);
  radius_o[s] = radius[s] + (new_radius[r] - radius[s]);
  active_o[s] = true;
  const int fi = *frame_idx;
  ls_o[s] = last_support[s] + (fi - last_support[s]);
}

}  // namespace

// the select's table: {words, 1 if in device memory, dynamic shared bytes}.
// The table takes 2 nc words rounded up to a power of two (load 0.5 at
// worst), fewer in shared memory down to 9/8 nc (load 0.9), else the
// device-memory scratch; device_table 1 forces the scratch. Refused
// (cudaErrorInvalidValue) past 65 536 candidates or where the rest of the
// shared memory does not fit.
extern "C" int df_insert_plan(int nc, int cap, int device_table, int* out) {
  if (nc < 1 || nc > 65536 || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t limit = static_cast<size_t>(smem_optin());
  const size_t rest = layout(nc, cap, 0).bytes;
  if (rest > limit) return static_cast<int>(cudaErrorInvalidValue);
  const int want = pow2_at_least(2 * nc);
  const long long room = static_cast<long long>((limit - rest) / 8);
  const bool shared = device_table == 0 && room >= nc + nc / 8 + 1;
  out[0] = shared ? static_cast<int>(room < want ? room : want) : want;
  out[1] = shared ? 0 : 1;
  out[2] = static_cast<int>(layout(nc, cap, shared ? out[0] : 0).bytes);
  return 0;
}

// one launch; plan: df_insert_plan's; dtable: null (shared mode) or a
// (plan[0],) 64-bit device scratch; kept: null or an int32 that receives k
extern "C" int df_insert_select(const void* cand, const void* cand_d2, const void* valid, int nc, const void* active,
                                const void* count, const void* gate, int cap, float cov, float cov2, const int* plan,
                                void* slots, void* new_pos, void* dtable, void* kept, void* stream) {
  const bool dev = plan[1] != 0;
  if (dev != (dtable != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(plan[2]);
  auto fn = dev ? insert_select_kernel<true> : insert_select_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<1, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand), static_cast<const float*>(cand_d2), static_cast<const bool*>(valid), nc,
      static_cast<const bool*>(active), static_cast<const int*>(count), static_cast<const bool*>(gate), cap, cov,
      cov2, plan[0], static_cast<int64_t*>(slots), static_cast<float*>(new_pos),
      static_cast<unsigned long long*>(dtable), static_cast<int*>(kept));
  return static_cast<int>(cudaGetLastError());
}

// the new field (pos_o .. ls_o) from the old one and the plan, one launch;
// reference 1: the design before, the one-block kernel in place on the
// outputs, which the caller filled with copies of the old field (the
// inputs are then not read); *launched receives the kernels launched
extern "C" int df_insert_apply(const void* pos, const void* dq, const void* radius, const void* active,
                               const void* count, const void* last_support, void* pos_o, void* dq_o, void* radius_o,
                               void* active_o, void* count_o, void* ls_o, const void* slots, const void* new_pos,
                               const void* seed_dq, const void* frame_idx, const void* new_radius, int cap,
                               int reference, int* launched, void* stream) {
  *launched = 0;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reference) {
    insert_apply_kernel<<<1, kBlock, 0, st>>>(
        static_cast<float*>(pos_o), static_cast<float*>(dq_o), static_cast<float*>(radius_o),
        static_cast<bool*>(active_o), static_cast<int*>(count_o), static_cast<int*>(ls_o),
        static_cast<const int64_t*>(slots), static_cast<const float*>(new_pos), static_cast<const float*>(seed_dq),
        static_cast<const int*>(frame_idx), static_cast<const float*>(new_radius), cap);
  } else {
    insert_write_kernel<<<(cap + kApplyThreads - 1) / kApplyThreads, kApplyThreads, 0, st>>>(
        static_cast<const float*>(pos), static_cast<const float*>(dq), static_cast<const float*>(radius),
        static_cast<const bool*>(active), static_cast<const int*>(count), static_cast<const int*>(last_support),
        static_cast<float*>(pos_o), static_cast<float*>(dq_o), static_cast<float*>(radius_o),
        static_cast<bool*>(active_o), static_cast<int*>(count_o), static_cast<int*>(ls_o),
        static_cast<const int64_t*>(slots), static_cast<const float*>(new_pos), static_cast<const float*>(seed_dq),
        static_cast<const int*>(frame_idx), static_cast<const float*>(new_radius), cap);
  }
  *launched = 1;
  return static_cast<int>(cudaGetLastError());
}
