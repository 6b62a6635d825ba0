// Kernel D: brick-sparse projective TSDF fusion, in place.
//
// Replaces the fuse of dynamicfusion_tpu/ops/bricks.py:552
// integrate_bricks (front rows :665-670, the band loop :685-725 with its
// one-hot window matmuls :509-549, the wide gather :727-753) and its row
// update _fuse_rows :400-432 with the non-rigid arguments q_grid (:575,
// :654) and conf (:363-397), _fuse_front_rows :435 and _voxel_positions
// :334; the phase split (:598-618) selects bricks in ops/bricks.py plan.
// On the TPU the listed bricks are transposed out of the volume into
// brick-major rows, fused and transposed back; band depths are selected
// from a 128x128 window by one-hot matmuls.
//
// Bound on the H100: bytes. Each listed voxel reads and writes its tsdf
// and weight (8 B as i16 + u16 codes, 16 B as f32 + f32) and a band voxel
// loads one float depth; with ~2-3 thousand listed bricks of 4096 voxels
// that is tens of MB a frame, against ~40 flops a voxel.
// Design: a persistent grid of kBlocksPerSm blocks an SM walks the slots
// of the compacted work list (front, then band, then wide) up to the
// device-side count, a brick a block at a time; with the device-side flag
// false every block returns at once, so the launch is the same size every
// frame and never syncs with the host. A band or wide brick's corner grid
// ((b/g + 1)^3 points x 3 or 4 channels) is staged in shared memory once;
// the x-contraction is computed once for each (voxel x, grid j, grid k),
// then the y-contraction once for each (voxel x, voxel y, grid k), both
// into shared memory, so each voxel does only the z lerp: the same
// float32 operations on the same operands as bricks._voxel_positions (x,
// then y, then z; p0 * (1 - f) + p1 * f), so positions and q keep their
// bits. A thread takes a z-run of kRun voxels and moves their codes in
// 16-byte loads and stores (8 i16 or u16 codes, or 4 f32, an access); the
// brick and grid strides b and g are compile-time for the shapes the repo
// runs (b 16 with g 8, 16 and 2), so no voxel index divides at run time.
// A band voxel fetches dists[v, u] directly (the one-hot window lookup
// selects exactly that value) under the same `inb & inw` window mask; the
// update rule and the encodes are bricks._fuse_rows / _fuse_front_rows:
// the kernel is instantiated for each (tsdf, weight) storage pair (the
// storage code of df_fuse_bricks; common.cuh), the i16/u16 codes rounded
// half to even and clipped, f32 stored as computed, bf16 rounded to
// nearest even. The design before (a block a slot, scalar voxel access,
// every voxel reloading its 8 corners a channel; any b and g) stays as
// the reference mode and as the path of any other b and g or a volume
// not 16-byte aligned; the two are bit-equal.
// Non-rigid fusion passes three more inputs: a per-grid-point observation
// weight (the warp's blend quality), prolonged as a fourth channel with
// the positions and gating the voxel at > q_min; a lookup image that
// packs depth and incidence confidence into one exact-integer float
// (bricks.pack_depth_conf: the voxel sees the depth quantized to 0.25 mm
// and 16 confidence levels, as in the JAX package), unpacked per voxel
// into the incidence weight max(conf, floor) and the SDF scale
// clip(conf, 0.25, 1). Without them the weight is 1 and the update is the
// rigid one, bit for bit.
//
// Slab mode (the sharded fusion, dynamicfusion_tpu/parallel/
// sharded_fusion.py:156-212): the volume is one shard's (D/n, D, D) x-slab,
// the grid its (D/n / g + 1, G, G) corner slab and the work list holds
// local brick ids ((bi nb) + bj) nb + bk with nb = D / b along y and z. A
// voxel's address and its grid corners are computed from the local brick
// id with the y and z strides of the whole volume (D, G), so the same code
// serves a slab and the whole volume (n = 1); ``dx`` is checked against
// the list and the ``ok`` flag is the sharded step's fusion gate.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kFront = 1;
constexpr int kBand = 2;
constexpr int kWide = 3;
constexpr int kThreads = 256;  // the reference mode's block
// the persistent grid: blocks an SM, threads a block and voxels a
// thread's z-run; scripts/torch_plan_fuse_variants.py times the
// alternatives
constexpr int kBlocksPerSm = 4;
constexpr int kFuseThreads = 256;
constexpr int kRun = 8;

struct Args {
  const float* dists;  // the lookup image (dists, or the packed depth + confidence)
  const float* grid;   // (gx, G, G, 3) camera-frame corners
  const float* qgrid;  // (gx, G, G) observation weight, or nullptr
  const int* ids;
  const int* kinds;
  const int* count;
  const bool* ok;
  const int* u0s;
  const int* v0s;
  int dx, d, rows, cols;
  float fx, fy, cx, cy;
  int rect;
  float trunc, max_w, tsdf_decode, q_min;
  int packed;
  float inc_floor;
  int sdf_scale;
};

// a front voxel: tsdf_obs = 1 with weight 1 (bricks._fuse_front_rows)
template <typename T, typename W>
__device__ __forceinline__ void fuse_front(const Args& a, T& t, W& w) {
  const float t32 = dfk::code_value(t) * a.tsdf_decode;
  const float w32 = dfk::decode_weight(w);
  t = dfk::encode_tsdf<T>((t32 * w32 + 1.0f) / (w32 + 1.0f));
  w = dfk::encode_weight<W>(fminf(w32 + 1.0f, a.max_w));
}

// a band or wide voxel at camera position pos (pos[3] its observation
// weight where a.qgrid is given): bricks._fuse_rows; t and w change only
// where the voxel updates, which it returns
template <typename T, typename W>
__device__ __forceinline__ bool fuse_band(const Args& a, bool band, int u0, int v0, const float* pos, T& t, W& w) {
  const float t32 = dfk::code_value(t) * a.tsdf_decode;
  const float w32 = dfk::decode_weight(w);
  const float x = pos[0], y = pos[1], z = pos[2];
  const float zs = z > 0.0f ? z : 1.0f;
  const float u = x * a.fx / zs + a.cx;
  const float v = y * a.fy / zs + a.cy;
  const bool inb = (z > 0.0f) && (u >= 0.0f) && (v >= 0.0f) && (u < a.cols) && (v < a.rows);
  const int ui = dfk::floor_clamp(u, a.cols - 1);
  const int vi = dfk::floor_clamp(v, a.rows - 1);
  bool inw = true;
  if (band) {
    const int ri = min(max(vi - v0, 0), a.rect - 1);
    const int cj2 = min(max(ui - u0, 0), a.rect - 1);
    inw = (vi - v0 == ri) && (ui - u0 == cj2);
  }
  const float rdist = sqrtf(x * x + y * y + z * z);
  const float look = __ldg(a.dists + vi * a.cols + ui);
  float dp = look, conf = 0.0f;
  if (a.packed) {
    const float dq = floorf(look / 16.0f);
    conf = (look - dq * 16.0f) * dfk::kInvConf;
    dp = dq * dfk::kInvDepth;
  }
  const float psdf = dp - rdist;
  bool update = inb && inw && dp != 0.0f && psdf >= -a.trunc;
  float q = 1.0f;
  if (a.qgrid != nullptr) {
    update = update && pos[3] > a.q_min;
    q = pos[3];
  }
  float scale = 1.0f;
  if (a.packed) {
    q = q * (conf > 0.0f ? fmaxf(conf, a.inc_floor) : 0.0f);
    if (a.sdf_scale) scale = conf > 0.0f ? fminf(fmaxf(conf, 0.25f), 1.0f) : 1.0f;
  }
  if (update) {
    const float obs = fminf(psdf * scale / a.trunc, 1.0f);
    const float wq = w32 + q;
    if (wq > 1e-12f) t = dfk::encode_tsdf<T>((t32 * w32 + obs * q) / fmaxf(wq, 1e-12f));
    w = dfk::encode_weight<W>(fminf(wq, a.max_w));
  }
  return update;
}

// the reference mode (the design before): one block per slot, a thread a
// voxel at a time, each voxel contracting its cell's 8 corners a channel
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
fuse_bricks_kernel(T* __restrict__ tsdf, W* __restrict__ weight, Args a, int b, int g) {
  if (!*a.ok || static_cast<int>(blockIdx.x) >= *a.count) return;
  const int brick = a.ids[blockIdx.x];
  const int kind = a.kinds[blockIdx.x];
  const int d = a.d;
  const int nb = d / b;
  const int bi = brick / (nb * nb), bj = (brick / nb) % nb, bk = brick % nb;
  if ((bi + 1) * b > a.dx) return;  // not a brick of this slab
  const int gp = d / g + 1;     // grid points per axis
  const int per = b / g;        // grid cells per brick per axis
  const int u0 = a.u0s[brick], v0 = a.v0s[brick];
  const int bv = b * b * b;

  for (int o = threadIdx.x; o < bv; o += blockDim.x) {
    const int vx = o / (b * b), vy = (o / b) % b, vz = o % b;
    const size_t addr =
        (static_cast<size_t>(bi * b + vx) * d + (bj * b + vy)) * d + (bk * b + vz);
    T t = tsdf[addr];
    W w = weight[addr];
    if (kind == kFront) {
      fuse_front(a, t, w);
      tsdf[addr] = t;
      weight[addr] = w;
      continue;
    }
    // trilinear prolongation of the grid corners of the voxel's cell
    const int ci = vx / g, cj = vy / g, ck = vz / g;
    const float fi = static_cast<float>(vx % g) / static_cast<float>(g);
    const float fj = static_cast<float>(vy % g) / static_cast<float>(g);
    const float fk = static_cast<float>(vz % g) / static_cast<float>(g);
    const int gi = bi * per + ci, gj = bj * per + cj, gk = bk * per + ck;
    const int nch = a.qgrid != nullptr ? 4 : 3;
    float pos[4] = {0.0f, 0.0f, 0.0f, 1.0f};
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      if (ch >= nch) break;
      const float* src = ch < 3 ? a.grid : a.qgrid;
      const int stride = ch < 3 ? 3 : 1;
      const int off = ch < 3 ? ch : 0;
      float f2[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float f1[2];
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const float p0 = __ldg(src + ((static_cast<size_t>(gi) * gp + gj + bb) * gp + gk + c) * stride + off);
          const float p1 = __ldg(src + ((static_cast<size_t>(gi + 1) * gp + gj + bb) * gp + gk + c) * stride + off);
          f1[bb] = p0 * (1.0f - fi) + p1 * fi;
        }
        f2[c] = f1[0] * (1.0f - fj) + f1[1] * fj;
      }
      pos[ch] = f2[0] * (1.0f - fk) + f2[1] * fk;
    }
    if (fuse_band(a, kind == kBand, u0, v0, pos, t, w)) {
      tsdf[addr] = t;
      weight[addr] = w;
    }
  }
}

// a thread's z-run of kRun codes, moved in 16-byte accesses (8-byte for
// a run of 4 two-byte codes)
template <typename V>
struct alignas(kRun * sizeof(V) < 16 ? kRun * sizeof(V) : 16) Run {
  V v[kRun];
};

// the brick's shape at compile time: B voxels a side, grid stride G
template <int B, int G>
struct Shape {
  static constexpr int kC = B / G + 1;         // grid points a side
  static constexpr int kCorners = kC * kC * kC;  // a channel
  static constexpr int kX = B * kC * kC;       // x-contracted values a channel: (vx, grid j, grid k)
  static constexpr int kY = B * B * kC;        // y-contracted values a channel: (vx, vy, grid k)
  static constexpr int kRunsRow = B / kRun;
  static constexpr int kRuns = B * B * kRunsRow;
  // floats of shared memory: the x-contraction, then the y-contraction
  // over the staged corners
  static constexpr int kSmem = 4 * (kX + (kY > kCorners ? kY : kCorners));
  static_assert(B % G == 0 && B % kRun == 0, "a brick of whole cells and runs");
};

template <typename T, typename W, int B, int G>
__global__ void __launch_bounds__(kFuseThreads, kBlocksPerSm)
fuse_bricks_persistent_kernel(T* __restrict__ tsdf, W* __restrict__ weight, Args a) {
  using S = Shape<B, G>;
  constexpr int kC = S::kC;
  if (!*a.ok) return;
  extern __shared__ float sm[];
  float* xs = sm;              // (nch, B, C, C)
  float* ys = sm + 4 * S::kX;  // (nch, B, B, C); first the corners (nch, C, C, C)
  const int n = *a.count;
  const int d = a.d;
  const int nb = d / B;
  const int gp = d / G + 1;
  const int nch = a.qgrid != nullptr ? 4 : 3;
  for (int s = blockIdx.x; s < n; s += gridDim.x) {
    const int brick = a.ids[s];
    const int kind = a.kinds[s];
    const int bi = brick / (nb * nb), bj = (brick / nb) % nb, bk = brick % nb;
    if ((bi + 1) * B > a.dx) continue;  // not a brick of this slab (the whole block alike)
    const size_t base = (static_cast<size_t>(bi * B) * d + bj * B) * d + bk * B;
    if (kind == kFront) {
      for (int r = threadIdx.x; r < S::kRuns; r += kFuseThreads) {
        const int vx = r / (B * S::kRunsRow), vy = (r / S::kRunsRow) % B, vz0 = (r % S::kRunsRow) * kRun;
        const size_t addr = base + (static_cast<size_t>(vx) * d + vy) * d + vz0;
        Run<T> t = *reinterpret_cast<const Run<T>*>(tsdf + addr);
        Run<W> w = *reinterpret_cast<const Run<W>*>(weight + addr);
#pragma unroll
        for (int i = 0; i < kRun; ++i) fuse_front(a, t.v[i], w.v[i]);
        *reinterpret_cast<Run<T>*>(tsdf + addr) = t;
        *reinterpret_cast<Run<W>*>(weight + addr) = w;
      }
      continue;  // shared memory untouched
    }
    const int u0 = a.u0s[brick], v0 = a.v0s[brick];
    // the brick's corner grid, once
    const int gi0 = bi * (B / G), gj0 = bj * (B / G), gk0 = bk * (B / G);
    for (int e = threadIdx.x; e < nch * S::kCorners; e += kFuseThreads) {
      const int ch = e / S::kCorners, q = e % S::kCorners;
      const int ci = q / (kC * kC), cj = (q / kC) % kC, ck = q % kC;
      const size_t gidx = (static_cast<size_t>(gi0 + ci) * gp + gj0 + cj) * gp + gk0 + ck;
      ys[e] = ch < 3 ? __ldg(a.grid + gidx * 3 + ch) : __ldg(a.qgrid + gidx);
    }
    __syncthreads();
    // x, once for each (vx, grid j, grid k)
    for (int e = threadIdx.x; e < nch * S::kX; e += kFuseThreads) {
      const int ch = e / S::kX, q = e % S::kX;
      const int vx = q / (kC * kC), jk = q % (kC * kC);
      const float fi = static_cast<float>(vx % G) / static_cast<float>(G);
      const float* c = ys + ch * S::kCorners + (vx / G) * kC * kC + jk;
      xs[e] = c[0] * (1.0f - fi) + c[kC * kC] * fi;
    }
    __syncthreads();
    // y, once for each (vx, vy, grid k), over the corners: a thread a
    // (vx, vy), its channels and grid k in turn
    for (int e = threadIdx.x; e < B * B; e += kFuseThreads) {
      const int vx = e / B, vy = e % B;
      const float fj = static_cast<float>(vy % G) / static_cast<float>(G);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        if (ch >= nch) break;
        const float* x = xs + ch * S::kX + (vx * kC + vy / G) * kC;
#pragma unroll
        for (int kk = 0; kk < kC; ++kk) ys[ch * S::kY + e * kC + kk] = x[kk] * (1.0f - fj) + x[kC + kk] * fj;
      }
    }
    __syncthreads();  // the y-contraction, for the voxels
    for (int r = threadIdx.x; r < S::kRuns; r += kFuseThreads) {
      const int vx = r / (B * S::kRunsRow), vy = (r / S::kRunsRow) % B, vz0 = (r % S::kRunsRow) * kRun;
      const size_t addr = base + (static_cast<size_t>(vx) * d + vy) * d + vz0;
      Run<T> t = *reinterpret_cast<const Run<T>*>(tsdf + addr);
      Run<W> w = *reinterpret_cast<const Run<W>*>(weight + addr);
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int vz = vz0 + i;
        const int ck = vz / G;
        const float fk = static_cast<float>(vz % G) / static_cast<float>(G);
        float pos[4] = {0.0f, 0.0f, 0.0f, 1.0f};
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          if (ch >= nch) break;
          const float* y = ys + ch * S::kY + (vx * B + vy) * kC + ck;
          pos[ch] = y[0] * (1.0f - fk) + y[1] * fk;
        }
        fuse_band(a, kind == kBand, u0, v0, pos, t.v[i], w.v[i]);
      }
      *reinterpret_cast<Run<T>*>(tsdf + addr) = t;
      *reinterpret_cast<Run<W>*>(weight + addr) = w;
    }
    __syncthreads();  // the next brick's staging waits for every voxel
  }
}

template <typename T, typename W, int B, int G>
cudaError_t launch_persistent(T* tsdf, W* weight, const Args& a, int nbr, int sms, cudaStream_t st) {
  auto fn = fuse_bricks_persistent_kernel<T, W, B, G>;
  constexpr size_t smem = sizeof(float) * Shape<B, G>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = min(nbr, kBlocksPerSm * sms);
  fn<<<blocks, kFuseThreads, smem, st>>>(tsdf, weight, a);
  return cudaGetLastError();
}

}  // namespace

// tsdf and weight stored as the storage code says (common.cuh); sms: the
// card's SM count (the persistent grid is kBlocksPerSm of them);
// reference: the design before, which also takes any other b and g (the
// persistent kernel refuses them, and a volume not 16-byte aligned);
// *launched: the device kernels this call launched
extern "C" int df_fuse_bricks(void* tsdf, void* weight, int storage, const void* dists, const void* grid,
                              const void* ids, const void* kinds, const void* count,
                              const void* ok, const void* u0, const void* v0, int dx, int d, int b,
                              int g, int rows, int cols, int nbr, float fx, float fy, float cx,
                              float cy, int rect, float trunc, float max_w, float tsdf_decode,
                              const void* qgrid, float q_min, int packed, float inc_floor, int sdf_scale,
                              int sms, int reference, int* launched, void* stream) {
  *launched = 0;
  if (nbr <= 0) return 0;
  const Args a{static_cast<const float*>(dists), static_cast<const float*>(grid), static_cast<const float*>(qgrid),
               static_cast<const int*>(ids), static_cast<const int*>(kinds), static_cast<const int*>(count),
               static_cast<const bool*>(ok), static_cast<const int*>(u0), static_cast<const int*>(v0),
               dx, d, rows, cols, fx, fy, cx, cy, rect, trunc, max_w, tsdf_decode, q_min, packed, inc_floor,
               sdf_scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(tsdf) | reinterpret_cast<uintptr_t>(weight)) % 16 == 0;
  return dfk::dispatch_storage(storage, [&](auto tt, auto wt) {
    using T = typename decltype(tt)::type;
    using W = typename decltype(wt)::type;
    T* t = static_cast<T*>(tsdf);
    W* w = static_cast<W*>(weight);
    cudaError_t err = cudaErrorInvalidValue;
    if (reference) {
      fuse_bricks_kernel<T, W><<<nbr, kThreads, 0, st>>>(t, w, a, b, g);
      err = cudaGetLastError();
    } else if (aligned && b == 16 && g == 8) {
      err = launch_persistent<T, W, 16, 8>(t, w, a, nbr, sms, st);
    } else if (aligned && b == 16 && g == 16) {
      err = launch_persistent<T, W, 16, 16>(t, w, a, nbr, sms, st);
    } else if (aligned && b == 16 && g == 2) {
      err = launch_persistent<T, W, 16, 2>(t, w, a, nbr, sms, st);
    }
    if (err == cudaSuccess) *launched = 1;
    return static_cast<int>(err);
  });
}
