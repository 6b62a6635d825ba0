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
// f32 + f32); the 640x480
// float image (1.2 MB) and F2's coarse grid (33^3 x 4 floats, 0.57 MB) stay
// in L2 and are read through the read-only path.
// Design: one thread per voxel, z fastest, so a warp reads and writes 64
// contiguous bytes of each volume and neighbouring threads share the depth
// pixels and the grid corners they gather; a voxel that is not updated
// writes nothing (its re-encoded code equals the stored one, as in JAX).
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

// tsdf and weight stored as the storage code says (common.cuh)
extern "C" int df_fuse_dense(void* tsdf, void* weight, int storage, const void* dists, const void* rt, const void* ok, int d,
                             int rows, int cols, float fx, float fy, float cx, float cy, float trunc, float max_w,
                             float tsdf_decode, void* stream) {
  const Proj p{fx, fy, cx, cy, rows, cols, trunc, max_w, tsdf_decode};
  const size_t n = static_cast<size_t>(d) * d * d;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  return dfk::dispatch_storage(storage, [&](auto tt, auto wt) {
    using T = typename decltype(tt)::type;
    using W = typename decltype(wt)::type;
    if (blocks > 0) {
      fuse_dense_kernel<T, W><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
