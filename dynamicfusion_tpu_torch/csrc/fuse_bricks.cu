// Kernel D: brick-sparse projective TSDF fusion, in place.
//
// Replaces the fuse of dynamicfusion_tpu/ops/bricks.py:552
// integrate_bricks (front rows :665-670, the band loop :685-725 with its
// one-hot window matmuls :509-549, the wide gather :727-753) and its row
// update _fuse_rows :400-432 with the non-rigid arguments q_grid (:575,
// :654) and conf (:363-397); the phase split (:598-618) selects bricks in
// ops/bricks.py plan. On the TPU
// the listed bricks are transposed out of the volume into brick-major
// rows, fused and transposed back; band depths are selected from a
// 128x128 window by one-hot matmuls.
//
// Bound on the H100: bytes. Each listed voxel reads and writes its tsdf
// and weight (8 B as i16 + u16 codes, 16 B as f32 + f32) and a band voxel
// loads one float depth; with ~2-3 thousand listed bricks of 4096 voxels
// that is tens of MB a frame, against ~40 flops a voxel.
// Design: one block per slot of the compacted work list (front, then
// band, then wide); a block past the device-side count, or every block
// when the device-side ICP flag is false, exits at once, so the launch is
// the same size every frame and never syncs with the host. Threads walk
// the brick's voxels z-fastest, so a warp touches two contiguous 32-byte
// z-runs. Voxel addresses come straight from the brick id (no brick-major
// transposes). Voxel positions are the trilinear prolongation of the
// brick's camera-frame grid corners, contracted x, then y, then z in
// float32 as bricks._voxel_positions does; a band voxel fetches
// dists[v, u] directly (the one-hot window lookup selects exactly that
// value) under the same `inb & inw` window mask; the update rule and the
// encodes are bricks._fuse_rows / _fuse_front_rows: the kernel is
// instantiated for each (tsdf, weight) storage pair (the storage code of
// df_fuse_bricks; common.cuh), the i16/u16 codes rounded half to even and
// clipped, f32 stored as computed, bf16 rounded to nearest even.
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
#include "common.cuh"

namespace {

constexpr int kFront = 1;
constexpr int kBand = 2;
constexpr int kWide = 3;
constexpr int kThreads = 256;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
fuse_bricks_kernel(T* __restrict__ tsdf, W* __restrict__ weight,
                   const float* __restrict__ dists, const float* __restrict__ grid,
                   const int* __restrict__ ids, const int* __restrict__ kinds,
                   const int* __restrict__ count, const bool* __restrict__ ok,
                   const int* __restrict__ u0s, const int* __restrict__ v0s, int dx, int d, int b,
                   int g, int rows, int cols, float fx, float fy, float cx, float cy, int rect,
                   float trunc, float max_w, float tsdf_decode, const float* __restrict__ qgrid,
                   float q_min, int packed, float inc_floor, int sdf_scale) {
  if (!*ok || static_cast<int>(blockIdx.x) >= *count) return;
  const int brick = ids[blockIdx.x];
  const int kind = kinds[blockIdx.x];
  const int nb = d / b;
  const int bi = brick / (nb * nb), bj = (brick / nb) % nb, bk = brick % nb;
  if ((bi + 1) * b > dx) return;  // not a brick of this slab
  const int gp = d / g + 1;     // grid points per axis
  const int per = b / g;        // grid cells per brick per axis
  const int u0 = u0s[brick], v0 = v0s[brick];
  const int bv = b * b * b;

  for (int o = threadIdx.x; o < bv; o += blockDim.x) {
    const int vx = o / (b * b), vy = (o / b) % b, vz = o % b;
    const size_t addr =
        (static_cast<size_t>(bi * b + vx) * d + (bj * b + vy)) * d + (bk * b + vz);
    const float t32 = dfk::code_value(tsdf[addr]) * tsdf_decode;
    const float w32 = dfk::decode_weight(weight[addr]);
    if (kind == kFront) {
      tsdf[addr] = dfk::encode_tsdf<T>((t32 * w32 + 1.0f) / (w32 + 1.0f));
      weight[addr] = dfk::encode_weight<W>(fminf(w32 + 1.0f, max_w));
      continue;
    }
    // trilinear prolongation of the grid corners of the voxel's cell
    const int ci = vx / g, cj = vy / g, ck = vz / g;
    const float fi = static_cast<float>(vx % g) / static_cast<float>(g);
    const float fj = static_cast<float>(vy % g) / static_cast<float>(g);
    const float fk = static_cast<float>(vz % g) / static_cast<float>(g);
    const int gi = bi * per + ci, gj = bj * per + cj, gk = bk * per + ck;
    const int nch = qgrid != nullptr ? 4 : 3;
    float pos[4] = {0.0f, 0.0f, 0.0f, 1.0f};
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      if (ch >= nch) break;
      const float* src = ch < 3 ? grid : qgrid;
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
    const float x = pos[0], y = pos[1], z = pos[2];
    const float zs = z > 0.0f ? z : 1.0f;
    const float u = x * fx / zs + cx;
    const float v = y * fy / zs + cy;
    const bool inb = (z > 0.0f) && (u >= 0.0f) && (v >= 0.0f) && (u < cols) && (v < rows);
    const int ui = dfk::floor_clamp(u, cols - 1);
    const int vi = dfk::floor_clamp(v, rows - 1);
    bool inw = true;
    if (kind == kBand) {
      const int ri = min(max(vi - v0, 0), rect - 1);
      const int cj2 = min(max(ui - u0, 0), rect - 1);
      inw = (vi - v0 == ri) && (ui - u0 == cj2);
    }
    const float rdist = sqrtf(x * x + y * y + z * z);
    const float look = __ldg(dists + vi * cols + ui);
    float dp = look, conf = 0.0f;
    if (packed) {
      const float dq = floorf(look / 16.0f);
      conf = (look - dq * 16.0f) * dfk::kInvConf;
      dp = dq * dfk::kInvDepth;
    }
    const float psdf = dp - rdist;
    bool update = inb && inw && dp != 0.0f && psdf >= -trunc;
    float q = 1.0f;
    if (qgrid != nullptr) {
      update = update && pos[3] > q_min;
      q = pos[3];
    }
    float scale = 1.0f;
    if (packed) {
      q = q * (conf > 0.0f ? fmaxf(conf, inc_floor) : 0.0f);
      if (sdf_scale) scale = conf > 0.0f ? fminf(fmaxf(conf, 0.25f), 1.0f) : 1.0f;
    }
    if (update) {
      const float obs = fminf(psdf * scale / trunc, 1.0f);
      const float wq = w32 + q;
      if (wq > 1e-12f) tsdf[addr] = dfk::encode_tsdf<T>((t32 * w32 + obs * q) / fmaxf(wq, 1e-12f));
      weight[addr] = dfk::encode_weight<W>(fminf(wq, max_w));
    }
  }
}

}  // namespace

// tsdf and weight stored as the storage code says (common.cuh)
extern "C" int df_fuse_bricks(void* tsdf, void* weight, int storage, const void* dists, const void* grid,
                              const void* ids, const void* kinds, const void* count,
                              const void* ok, const void* u0, const void* v0, int dx, int d, int b,
                              int g, int rows, int cols, int nbr, float fx, float fy, float cx,
                              float cy, int rect, float trunc, float max_w, float tsdf_decode,
                              const void* qgrid, float q_min, int packed, float inc_floor, int sdf_scale,
                              void* stream) {
  return dfk::dispatch_storage(storage, [&](auto tt, auto wt) {
    using T = typename decltype(tt)::type;
    using W = typename decltype(wt)::type;
    if (nbr > 0) {
      fuse_bricks_kernel<T, W><<<nbr, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<T*>(tsdf), static_cast<W*>(weight), static_cast<const float*>(dists),
          static_cast<const float*>(grid), static_cast<const int*>(ids), static_cast<const int*>(kinds),
          static_cast<const int*>(count), static_cast<const bool*>(ok), static_cast<const int*>(u0),
          static_cast<const int*>(v0), dx, d, b, g, rows, cols, fx, fy, cx, cy, rect, trunc, max_w, tsdf_decode,
          static_cast<const float*>(qgrid), q_min, packed, inc_floor, sdf_scale);
    }
    return static_cast<int>(cudaGetLastError());
  });
}
