// Kernels F1 and F2: dense projective TSDF fusion of every voxel, in place.
//
// F1 replaces the dense branch of dynamicfusion_tpu/ops/tsdf.py:169
// integrate (:214-256, integrate_mode="dense"): the camera-frame position of
// each voxel corner, its projection, the nearest depth and the running
// average. F2 replaces the dense branch of dynamicfusion_tpu/ops/fusion.py:199
// integrate_nonrigid (:263-322) with warp_voxel_field (:174-196): every
// voxel's warped world position is the separable linear prolongation of
// the warped (D/stride + 1)^3 coarse corners (three einsums with a
// (D, Dc) band matrix, contracted x, then y, then z; the blend quality q
// the same way), put into the camera frame, projected and fused with the
// observation weight q (times the incidence weight of the packed
// depth+confidence image), on the brick x-planes of this frame's phase.
// On the TPU the voxel positions come from matmuls (no gathers) and the
// depth from one big gather isolated by optimization barriers.
//
// Bound on the H100: bytes. Each voxel reads and writes its tsdf and weight
// (8 B as i16 + u16 codes, 134 MB at 256^3, ~0.04 ms at 3.35 TB/s; 16 B as
// f32 + f32), but only the updated voxels (those within the truncation
// band of the surface, in the image) need to move; the 640x480 float image
// (1.2 MB) and F2's coarse grid (33^3 x 4 floats, 0.57 MB) stay in L2 and
// are read through the read-only path. What F1 spends is instructions: its
// design before (the reference mode, fuse_dense_kernel) gave every voxel a
// thread that decodes its index with integer divisions, loads the pose,
// projects with two true divisions and a square root, and writes nothing
// for most voxels.
// F1's design (fuse_dense_tiles_kernel): the side is a compile-time
// constant (df_fuse_dense_sides: 32 to 512; another side takes the
// reference mode). A warp owns a tile of one plane along i, J rows along j
// and K = min(64, side) voxels along k (J = 32 kRun / K: a lane a run of
// kRun = 8 voxels along k, moved in 16-byte accesses), a block of 128
// threads four such tiles stacked along j; each thread keeps the pose in
// registers and computes a run's partial r0 fi + r1 fj once (exact: the
// order is ((r0 fi + r1 fj) + r2 fk) + t without FMA, as before). Every
// voxel runs the exact tests of the design before, in its order, cheapest
// first (z, then u, then v, the pixel, the band), and only a run with an
// updated voxel reads and writes its codes (the others rewritten with
// their own bits), so the volume keeps the reference mode's bits. What is
// left is instructions: the two true divisions, the square root and the
// update's division of every voxel in the frustum. No tile is culled: a
// conservative test of a block's corners (scripts/
// torch_gate_dense_variants.py, "cull") skips the blocks outside the
// frustum but costs more than it saves at the tracked pose.
// F2 (fuse_dense_nonrigid_kernel): one thread per voxel, z fastest, so a
// warp reads and writes 64 contiguous bytes of each volume and
// neighbouring threads share the depth pixels and the grid corners they
// gather; a voxel that is not updated writes nothing (its re-encoded code
// equals the stored one, as in JAX).
// The pixel index is clipped before the gather and the result masked after
// it, as in JAX: u is inf or NaN where z <= 0 and nothing is read outside
// the image. The arithmetic repeats the plain versions
// (ops/tsdf.dense_update_plain, ops/fusion.prolong) operation for
// operation under -fmad=false, with the codecs of kernel D (common.cuh:
// both kernels are instantiated for each (tsdf, weight) storage pair); the
// prolongation's two-term dots are fused multiply-adds, fma(w1, x1, w0 x0),
// because XLA's dot takes them so on the CPU (the plain version rounds an
// exact float64 product-sum).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Proj {
  float fx, fy, cx, cy;
  int rows, cols;
  float trunc, max_w, tsdf_decode;
};

// the update of one voxel from its camera-frame position (x, y, z): the
// rigid one with q = 1 and no packed image, as dense_update_plain
template <typename T, typename W>
__device__ __forceinline__ void update_voxel(T* __restrict__ tsdf, W* __restrict__ weight,
                                             size_t addr, const float* __restrict__ lookup,
                                             const Proj& p, float x, float y, float z, float q,
                                             bool gate, int packed, float inc_floor, int sdf_scale) {
  const float u = x * p.fx / z + p.cx;
  const float v = y * p.fy / z + p.cy;
  const bool inb = (u >= 0.0f) && (v >= 0.0f) && (u < p.cols) && (v < p.rows) && (z > 0.0f);
  const int ui = dfk::floor_clamp(u, p.cols - 1);
  const int vi = dfk::floor_clamp(v, p.rows - 1);
  const float look = __ldg(lookup + static_cast<size_t>(vi) * p.cols + ui);
  float dp = look, conf = 0.0f;
  if (packed) {
    const float dq = floorf(look / 16.0f);
    conf = (look - dq * 16.0f) * dfk::kInvConf;
    dp = dq * dfk::kInvDepth;
  }
  const float psdf = dp - sqrtf(x * x + y * y + z * z);
  const bool update = gate && inb && dp != 0.0f && psdf >= -p.trunc;
  if (!update) return;
  float scale = 1.0f;
  if (packed) {
    q = q * (conf > 0.0f ? fmaxf(conf, inc_floor) : 0.0f);
    if (sdf_scale) scale = conf > 0.0f ? fminf(fmaxf(conf, 0.25f), 1.0f) : 1.0f;
  }
  const float t32 = dfk::code_value(tsdf[addr]) * p.tsdf_decode;
  const float w32 = dfk::decode_weight(weight[addr]);
  const float obs = fminf(psdf * scale / p.trunc, 1.0f);
  const float wq = w32 + q;
  if (wq > 1e-12f) tsdf[addr] = dfk::encode_tsdf<T>((t32 * w32 + obs * q) / fmaxf(wq, 1e-12f));
  weight[addr] = dfk::encode_weight<W>(fminf(wq, p.max_w));
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
fuse_dense_kernel(T* __restrict__ tsdf, W* __restrict__ weight, const float* __restrict__ dists,
                  const float* __restrict__ rt, const bool* __restrict__ ok, int d, Proj p) {
  if (!*ok) return;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // d^3 < 2^31 for d <= 1290
  if (idx >= d * d * d) return;
  const size_t addr = static_cast<size_t>(idx);
  const float fi = static_cast<float>(idx / (d * d));
  const float fj = static_cast<float>((idx / d) % d);
  const float fk = static_cast<float>(idx % d);
  float c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    c[a] = __ldg(rt + 3 * a) * fi + __ldg(rt + 3 * a + 1) * fj + __ldg(rt + 3 * a + 2) * fk + __ldg(rt + 9 + a);
  update_voxel(tsdf, weight, addr, dists, p, c[0], c[1], c[2], 1.0f, true, 0, 0.0f, 0);
}

// ---------------------------------------------------------------------------
// F1's tiled design
// ---------------------------------------------------------------------------

constexpr int kRun = 8;          // voxels a lane along k
constexpr int kTileThreads = 128;

// a warp's tile: one plane, kJ rows, kK voxels along k; a block's kWarps
// tiles stacked along j
template <int D>
struct Tiles {
  static constexpr int kWarps = kTileThreads / 32;
  static constexpr int kK = D < 64 ? D : 64;
  static constexpr int kLanesK = kK / kRun;
  static constexpr int kJ = 32 / kLanesK;
  static constexpr int kBlockJ = kWarps * kJ;
  static constexpr int kBlocksK = D / kK, kBlocksJ = D / kBlockJ;
  static constexpr int kBlocks = kBlocksK * kBlocksJ * D;
  static_assert(kK % kRun == 0 && 32 % kLanesK == 0 && D % kBlockJ == 0, "whole tiles");
};

// a lane's run of kRun codes, moved in 16-byte accesses (8-byte for a
// run of 8 one-byte codes, none here)
template <typename V>
struct alignas(kRun * sizeof(V) < 16 ? kRun * sizeof(V) : 16) Run {
  V v[kRun];
};

// the rigid update's observation of a voxel at camera-frame (x, y, z), or
// false where the design before writes nothing: its tests in its order
__device__ __forceinline__ bool rigid_obs(const float* __restrict__ dists, const Proj& p, float x, float y, float z,
                                          float& obs) {
  if (!(z > 0.0f)) return false;
  const float u = x * p.fx / z + p.cx;
  if (!(u >= 0.0f && u < p.cols)) return false;
  const float v = y * p.fy / z + p.cy;
  if (!(v >= 0.0f && v < p.rows)) return false;
  // 0 <= u < cols: the clamped floor of the design before is the truncation
  const int ui = __float2int_rz(u);
  const int vi = __float2int_rz(v);
  const float dp = __ldg(dists + static_cast<size_t>(vi) * p.cols + ui);
  if (!(dp != 0.0f)) return false;
  const float psdf = dp - sqrtf(x * x + y * y + z * z);
  if (!(psdf >= -p.trunc)) return false;
  const float scale = 1.0f;
  obs = fminf(psdf * scale / p.trunc, 1.0f);
  return true;
}

template <typename T, typename W, int D>
__global__ void __launch_bounds__(kTileThreads)
fuse_dense_tiles_kernel(T* __restrict__ tsdf, W* __restrict__ weight, const float* __restrict__ dists,
                        const float* __restrict__ rt, const bool* __restrict__ ok, Proj p) {
  using S = Tiles<D>;
  if (!*ok) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float r[12];
#pragma unroll
  for (int a = 0; a < 12; ++a) r[a] = __ldg(rt + a);
  const int b = blockIdx.x;
  const int kt = b % S::kBlocksK, jb = (b / S::kBlocksK) % S::kBlocksJ, i = b / (S::kBlocksK * S::kBlocksJ);
  const int j = jb * S::kBlockJ + warp * S::kJ + lane / S::kLanesK;
  const int kb = kt * S::kK + (lane % S::kLanesK) * kRun;
  const float fi = static_cast<float>(i), fj = static_cast<float>(j);
  // the run's partial r0 fi + r1 fj, then + r2 fk, then + t, as before
  const float px = r[0] * fi + r[1] * fj, py = r[3] * fi + r[4] * fj, pz = r[6] * fi + r[7] * fj;
  unsigned upd = 0;
  float obs[kRun];
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    const float fk = static_cast<float>(kb + e);
    const float x = (px + r[2] * fk) + r[9];
    const float y = (py + r[5] * fk) + r[10];
    const float z = (pz + r[8] * fk) + r[11];
    obs[e] = 0.0f;
    if (rigid_obs(dists, p, x, y, z, obs[e])) upd |= 1u << e;
  }
  if (!upd) return;
  const size_t addr = (static_cast<size_t>(i) * D + j) * D + kb;
  Run<T> tc = *reinterpret_cast<const Run<T>*>(tsdf + addr);
  Run<W> wc = *reinterpret_cast<const Run<W>*>(weight + addr);
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    if (!(upd >> e & 1u)) continue;
    const float q = 1.0f;
    const float t32 = dfk::code_value(tc.v[e]) * p.tsdf_decode;
    const float w32 = dfk::decode_weight(wc.v[e]);
    const float wq = w32 + q;
    if (wq > 1e-12f) tc.v[e] = dfk::encode_tsdf<T>((t32 * w32 + obs[e] * q) / fmaxf(wq, 1e-12f));
    wc.v[e] = dfk::encode_weight<W>(fminf(wq, p.max_w));
  }
  *reinterpret_cast<Run<T>*>(tsdf + addr) = tc;
  *reinterpret_cast<Run<W>*>(weight + addr) = wc;
}

template <typename T, typename W>
cudaError_t launch_tiles(T* tsdf, W* weight, const float* dists, const float* rt, const bool* ok, int d,
                         const Proj& p, cudaStream_t st) {
#define DF_TILES_CASE(side)                                                                                  \
  case side:                                                                                                 \
    fuse_dense_tiles_kernel<T, W, side><<<Tiles<side>::kBlocks, kTileThreads, 0, st>>>(tsdf, weight, dists, rt, \
                                                                                    ok, p);                  \
    return cudaGetLastError();
  switch (d) {
    DF_TILES_CASE(32)
    DF_TILES_CASE(64)
    DF_TILES_CASE(128)
    DF_TILES_CASE(256)
    DF_TILES_CASE(512)
    default:
      return cudaErrorInvalidValue;
  }
#undef DF_TILES_CASE
}

// w0 x0 + w1 x1 as XLA's dot sums it: fma(w1, x1, w0 * x0)
__device__ __forceinline__ float lerp_dot(float w0, float x0, float w1, float x1) {
  return __fmaf_rn(w1, x1, w0 * x0);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
fuse_dense_nonrigid_kernel(T* __restrict__ tsdf, W* __restrict__ weight,
                           const float* __restrict__ lookup, const float* __restrict__ warped,
                           const float* __restrict__ qgrid, const float* __restrict__ rt,
                           const bool* __restrict__ ok, const int* __restrict__ phase, int d, int stride,
                           int brick, int split, Proj p, float q_min, int packed, float inc_floor,
                           int sdf_scale) {
  if (!*ok) return;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= d * d * d) return;
  const size_t addr = static_cast<size_t>(idx);
  const int i = idx / (d * d);
  const int j = (idx / d) % d;
  const int k = idx % d;
  if (split > 1 && (i / brick) % split != *phase) return;
  const int dc = d / stride + 1;
  const int ci = i / stride, cj = j / stride, ck = k / stride;
  const float fs = static_cast<float>(stride);
  const float ri = static_cast<float>(i % stride) / fs;
  const float rj = static_cast<float>(j % stride) / fs;
  const float rk = static_cast<float>(k % stride) / fs;
  const int nch = qgrid != nullptr ? 4 : 3;
  float val[4] = {0.0f, 0.0f, 0.0f, 1.0f};
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    if (ch >= nch) break;
    const float* src = ch < 3 ? warped : qgrid;
    const int cs = ch < 3 ? 3 : 1;
    const int off = ch < 3 ? ch : 0;
    float fy[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float fx[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float x0 = __ldg(src + ((static_cast<size_t>(ci) * dc + cj + b) * dc + ck + c) * cs + off);
        const float x1 = __ldg(src + ((static_cast<size_t>(ci + 1) * dc + cj + b) * dc + ck + c) * cs + off);
        fx[b] = lerp_dot(1.0f - ri, x0, ri, x1);
      }
      fy[c] = lerp_dot(1.0f - rj, fx[0], rj, fx[1]);
    }
    val[ch] = lerp_dot(1.0f - rk, fy[0], rk, fy[1]);
  }
  float c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    c[a] = __ldg(rt + 3 * a) * val[0] + __ldg(rt + 3 * a + 1) * val[1] + __ldg(rt + 3 * a + 2) * val[2] +
           __ldg(rt + 9 + a);
  const bool gate = qgrid == nullptr || val[3] > q_min;
  update_voxel(tsdf, weight, addr, lookup, p, c[0], c[1], c[2], val[3], gate, packed, inc_floor, sdf_scale);
}

}  // namespace

// The volume sides F1's tiled design is compiled for (the caller's choice
// of mode: kernels.integrate_dense_tiled); *n receives their count, and
// sides their first min(*n, cap) values.
extern "C" int df_fuse_dense_sides(int* sides, int cap, int* n) {
  constexpr int kSides[] = {32, 64, 128, 256, 512};
  *n = static_cast<int>(sizeof(kSides) / sizeof(kSides[0]));
  for (int i = 0; i < *n && i < cap; ++i) sides[i] = kSides[i];
  return 0;
}

// tsdf and weight stored as the storage code says (common.cuh); reference:
// the design before, a thread a voxel (any side); else the tiled design,
// for a side of df_fuse_dense_sides and volumes 16-byte aligned
extern "C" int df_fuse_dense(void* tsdf, void* weight, int storage, const void* dists, const void* rt, const void* ok, int d,
                             int rows, int cols, float fx, float fy, float cx, float cy, float trunc, float max_w,
                             float tsdf_decode, int reference, void* stream) {
  const Proj p{fx, fy, cx, cy, rows, cols, trunc, max_w, tsdf_decode};
  const size_t n = static_cast<size_t>(d) * d * d;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dfk::dispatch_storage(storage, [&](auto tt, auto wt) {
    using T = typename decltype(tt)::type;
    using W = typename decltype(wt)::type;
    if (!reference) {
      if (reinterpret_cast<uintptr_t>(tsdf) % 16 || reinterpret_cast<uintptr_t>(weight) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_tiles(static_cast<T*>(tsdf), static_cast<W*>(weight),
                                           static_cast<const float*>(dists), static_cast<const float*>(rt),
                                           static_cast<const bool*>(ok), d, p, st));
    }
    if (blocks > 0) {
      fuse_dense_kernel<T, W><<<blocks, kThreads, 0, st>>>(
          static_cast<T*>(tsdf), static_cast<W*>(weight), static_cast<const float*>(dists),
          static_cast<const float*>(rt), static_cast<const bool*>(ok), d, p);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int df_fuse_dense_nonrigid(void* tsdf, void* weight, int storage, const void* lookup, const void* warped,
                                      const void* qgrid, const void* rt, const void* ok, const void* phase, int d,
                                      int stride, int brick, int split, int rows, int cols, float fx, float fy,
                                      float cx, float cy, float trunc, float max_w, float tsdf_decode, float q_min,
                                      int packed, float inc_floor, int sdf_scale, void* stream) {
  const Proj p{fx, fy, cx, cy, rows, cols, trunc, max_w, tsdf_decode};
  const size_t n = static_cast<size_t>(d) * d * d;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  return dfk::dispatch_storage(storage, [&](auto tt, auto wt) {
    using T = typename decltype(tt)::type;
    using W = typename decltype(wt)::type;
    if (blocks > 0) {
      fuse_dense_nonrigid_kernel<T, W><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<T*>(tsdf), static_cast<W*>(weight), static_cast<const float*>(lookup),
          static_cast<const float*>(warped), static_cast<const float*>(qgrid), static_cast<const float*>(rt),
          static_cast<const bool*>(ok), static_cast<const int*>(phase), d, stride, brick, split, p, q_min, packed,
          inc_floor, sdf_scale);
    }
    return static_cast<int>(cudaGetLastError());
  });
}
