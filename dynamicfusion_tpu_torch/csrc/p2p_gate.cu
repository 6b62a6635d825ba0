// Kernel M: the adaptive aperture gate of the tangential data term.
//
// Replaces dynamicfusion_tpu/pipeline/kinfu.py:205 _p2p_gate (with :198
// _box_sum), reached through solver_p2p_adaptive (kinfu.py:540-556). Per
// pixel of the model-map grid (160x120 at full width): 11 features
// [S, nx², ny², nz², nxny, nxnz, nynz, nx b, ny b, nz b, b²] of the live
// normal n and the apparent motion b = n . (live - previous model), summed
// over a w x w window (w = 41) restricted to the pixel's depth bin and the
// bins beside it (16 bins of 0.1 m from 0.3 m), then the closed-form
// regularised 3x3 det and adjugate solve and the two clipped ratios. On the
// TPU the bins are a one-hot reshape to 176 channels box-summed by two
// reduce_window passes; the port's plain version sums the same 176
// channels tap by tap.
//
// Bound on the H100: bytes, and at 160x120 launch latency. The inputs are
// 19 200 x (3 points + 3 normals + 3 model points + depth) floats (0.8 MB);
// the output is the 160x120 gate and its bins. The arithmetic is 41 adds a
// (pixel, channel, bin) along the row and 41 down the column.
//
// Every sum runs tap by tap from zero in image order (the plain version's
// order: along the row first, then down the column), the closed form
// follows the plain version operation for operation under -fmad=false with
// true divisions, and the clips propagate NaN as torch.clamp does: the
// gate and the bins equal the plain version's bit for bit. A pixel only
// feeds its own bin, so a sum of (bin, channel) adds the taps of that bin
// and skips the rest: the skipped taps are the plain version's exact
// zeros, and a sum that starts from +0 never becomes -0, so skipping them
// rounds alike.
//
// Design, two launches:
// 1. gate_features_kernel, a thread a pixel: its 11 features
//    (channel-major), its bin and its bin code (+ kBins where the pixel is
//    not valid).
// 2. gate_cluster_kernel, a programmatic dependent launch (it starts while
//    the first runs and waits for it before it reads): a thread-block
//    cluster of kCh = 11 CTAs owns a strip of kStrip = 4 columns and every
//    row, CTA c channel c. Each CTA stages its channel's feature and the
//    codes over the strip's region (its columns and the window's halo) in
//    shared memory and takes the bins its pixels read (each pixel's bin
//    and the two beside it) in passes of kSlots = 8, in ascending order:
//    - horizontal sums: a thread a (row, column) walks its window's taps
//      once a pass, each tap added into the register of its own bin (a
//      compare with each of the pass's bins; a tap of no bin of the pass,
//      or not valid, into none), the sums then to shared memory;
//    - vertical sums: a thread a pixel sums, for each of its bins in the
//      pass in ascending order, the bin's window rows in the image from
//      +0 and adds the result to the pixel's sum.
//    Each CTA then writes its pixels' sums into the shared memory of the
//    CTA that runs their closed form (pixel p: CTA p mod 11) through
//    distributed shared memory, and after a cluster barrier each runs the
//    closed form on its pixels' 11 sums. The strip is narrow and a CTA
//    small (~50 KB of shared memory at 120 rows, at most 64 registers a
//    thread: four CTAs an SM) so that the work spreads over every SM.
// The design before (two launches, kept as the reference mode: df_p2p_gate
// with reference = 1) writes the 16 x 11 horizontal sums of each pixel to
// a 13.5 MB buffer, a block a row testing every tap against every bin, and
// a thread a pixel sums its three bins' 1 353 vertical taps from it.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 16;
constexpr int kCh = 11;
constexpr int kThreads = 256;
// the cluster design: columns a cluster, the widest window it takes, the
// region's row stride in shared memory (>= kStrip + kMaxWin - 1; a warp's
// eight rows of four taps, 20 mod 32 words apart, fall on distinct groups
// of four banks), the bins a pass keeps horizontal sums of, threads a CTA
constexpr int kStrip = 4;
constexpr int kMaxWin = 49;
constexpr int kRegion = 52;
constexpr int kSlots = 8;
constexpr int kGateThreads = 256;
static_assert(kStrip + kMaxWin - 1 <= kRegion, "the region row holds a strip and its window");
static_assert(32 % kStrip == 0, "a warp holds whole strip rows");
__device__ __forceinline__ bool finite3(float a, float b, float c) {
  return isfinite(a) && isfinite(b) && isfinite(c);
}

// torch.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX
__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? 3.402823466e38f : -3.402823466e38f;
  return x;
}

// torch.clamp(x, lo, hi), NaN propagating
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float max_nan(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

struct GateArgs {
  const float* live;   // (rows, cols, 3) live points, world frame
  const float* nrm;    // (rows, cols, 3) live normals, world frame
  const float* prev;   // (rows, cols, 3) previous model map, world frame
  const float* cam_z;  // (rows, cols) live camera-frame depth
  int rows, cols, lo, hi;  // window taps [x - lo, x + hi]
  float z_lo, bin_w;
};

// the closed form's constants
struct GateConsts {
  float reg_scale, cond0, fit0, fit_den, gain, min_count;
};

// pixel i's 11 features (zero where it is not valid), its depth bin and
// whether it is valid (finite motion and normal)
__device__ __forceinline__ void pixel_features(const GateArgs& a, int i, float* f, int& zb, bool& valid) {
  const float dx = a.live[3 * i] - a.prev[3 * i];
  const float dy = a.live[3 * i + 1] - a.prev[3 * i + 1];
  const float dz = a.live[3 * i + 2] - a.prev[3 * i + 2];
  const float n0 = a.nrm[3 * i], n1 = a.nrm[3 * i + 1], n2 = a.nrm[3 * i + 2];
  valid = finite3(dx, dy, dz) && finite3(n0, n1, n2);
  const float nx = valid ? nan_to_num(n0) : 0.0f;
  const float ny = valid ? nan_to_num(n1) : 0.0f;
  const float nz = valid ? nan_to_num(n2) : 0.0f;
  const float b = valid ? nx * nan_to_num(dx) + ny * nan_to_num(dy) + nz * nan_to_num(dz) : 0.0f;
  f[0] = valid ? 1.0f : 0.0f;
  f[1] = nx * nx;
  f[2] = ny * ny;
  f[3] = nz * nz;
  f[4] = nx * ny;
  f[5] = nx * nz;
  f[6] = ny * nz;
  f[7] = nx * b;
  f[8] = ny * b;
  f[9] = nz * b;
  f[10] = b * b;
  const float cz = a.cam_z[i];
  const float z = isnan(cz) ? -1.0f : cz;
  zb = static_cast<int>(fminf(fmaxf(floorf((z - a.z_lo) / a.bin_w), 0.0f), static_cast<float>(kBins - 1)));
}

// the slot of bin b among a pass's bins grp: its rank in grp
__device__ __forceinline__ int slot_of(unsigned grp, int b) { return __popc(grp & ((1u << b) - 1u)); }

// the gate of a pixel from its 11 three-bin window sums
__device__ __forceinline__ float gate_value(const float* s, const GateConsts& k) {
  const float cnt = s[0];
  const float g1 = s[7], g2 = s[8], g3 = s[9], bb = s[10];
  const float cnt1 = max_nan(cnt, 1.0f);
  const float reg = k.reg_scale * cnt1;
  const float a11 = s[1] + reg, a22 = s[2] + reg, a33 = s[3] + reg;
  const float a12 = s[4], a13 = s[5], a23 = s[6];
  const float c11 = a22 * a33 - a23 * a23;
  const float c12 = a13 * a23 - a12 * a33;
  const float c13 = a12 * a23 - a13 * a22;
  const float c22 = a11 * a33 - a13 * a13;
  const float c23 = a12 * a13 - a11 * a23;
  const float c33 = a11 * a22 - a12 * a12;
  const float det_r = a11 * c11 + a12 * c12 + a13 * c13;
  const float inv_det = 1.0f / max_nan(det_r, 1e-30f);
  const float t1 = (c11 * g1 + c12 * g2 + c13 * g3) * inv_det;
  const float t2 = (c12 * g1 + c22 * g2 + c23 * g3) * inv_det;
  const float t3 = (c13 * g1 + c23 * g2 + c33 * g3) * inv_det;
  const float expl = (t1 * g1 + t2 * g2 + t3 * g3) / max_nan(bb, 1e-12f);
  const float b11 = s[1], b22 = s[2], b33 = s[3];
  const float cond = (b11 * (b22 * b33 - a23 * a23) + a12 * (a13 * a23 - a12 * b33) + a13 * (a12 * a23 - a13 * b22)) /
                     (cnt1 * cnt1 * cnt1);
  const float gate_cond = clamp_nan(cond / k.cond0, 0.0f, 1.0f);
  const float gate_fit = clamp_nan((expl - k.fit0) / k.fit_den, 0.0f, 1.0f);
  const float g = clamp_nan(k.gain * gate_cond * gate_fit, 0.0f, 1.0f);
  return cnt > k.min_count ? g : 0.0f;
}

// ---------------------------------------------------------------------------
// the cluster design (two launches)
// ---------------------------------------------------------------------------

// shared memory of a CTA: feat [rows][kRegion] its channel's feature over
// the strip's region, hs [kSlots][rows][kStrip] the horizontal sums of a
// pass's bins, vs [rows][kStrip] the three-bin sums of its channel, own
// [kCh][ceil(rows kStrip / kCh)] the 11 channels' sums of the pixels whose
// closed form it runs (pixel p goes to CTA p % kCh), the mask of the bins
// the strip reads, code [rows][kRegion] the region's bin codes (the bin,
// + kBins where the pixel is not valid)
__host__ __device__ constexpr int gate_own(int rows) { return (rows * kStrip + kCh - 1) / kCh; }
__host__ __device__ constexpr size_t gate_smem(int rows) {
  return sizeof(float) * (static_cast<size_t>(rows) * (kRegion + kSlots * kStrip + kStrip) + kCh * gate_own(rows)) +
         sizeof(unsigned) + static_cast<size_t>(rows) * kRegion;
}

// the first launch: every pixel's 11 features (channel-major), bin code
// (the bin, + kBins where the pixel is not valid) and bin
__global__ void __launch_bounds__(kGateThreads)
gate_features_kernel(GateArgs a, float* __restrict__ feat, unsigned char* __restrict__ code, int* __restrict__ bins) {
  // the cluster launch may start now: it waits for this grid before it reads
  asm volatile("griddepcontrol.launch_dependents;");
  const int n = a.rows * a.cols;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float f[kCh];
  int zb;
  bool valid;
  pixel_features(a, i, f, zb, valid);
#pragma unroll
  for (int r = 0; r < kCh; ++r) feat[static_cast<size_t>(r) * n + i] = f[r];
  code[i] = static_cast<unsigned char>(valid ? zb : zb + kBins);
  bins[i] = zb;
}

// the second launch, in clusters of kCh CTAs along x (the non-portable
// size 11), a programmatic dependent launch of the first
__global__ void __launch_bounds__(kGateThreads, 4)
gate_cluster_kernel(GateArgs a, GateConsts k, const float* __restrict__ feat_in,
                    const unsigned char* __restrict__ code_in, float* __restrict__ gate) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ float sm[];
  const int rows = a.rows, cols = a.cols;
  float* feat = sm;
  float* hs = feat + rows * kRegion;
  float* vs = hs + kSlots * rows * kStrip;
  float* own = vs + rows * kStrip;
  const int per_own = gate_own(rows);
  unsigned& s_need = *reinterpret_cast<unsigned*>(own + kCh * per_own);
  unsigned char* code = reinterpret_cast<unsigned char*>(&s_need + 1);
  const int c = static_cast<int>(cl.block_rank());  // this CTA's channel
  const int x0 = (blockIdx.x / kCh) * kStrip;
  const int rx0 = max(x0 - a.lo, 0);
  const int rw = min(x0 + kStrip - 1 + a.hi, cols - 1) - rx0 + 1;
  const int tid = threadIdx.x;
  if (tid == 0) s_need = 0u;
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // 1. the strip's region of channel c's features and of the bin codes,
  // staged from the first launch's output
  {
    const float* fc = feat_in + static_cast<size_t>(c) * rows * cols;
#pragma unroll 8
    for (int q = tid; q < rows * rw; q += kGateThreads) {
      const int y = q / rw, xr = q - y * rw;
      feat[y * kRegion + xr] = __ldg(fc + y * cols + rx0 + xr);
      code[y * kRegion + xr] = __ldg(code_in + y * cols + rx0 + xr);
    }
  }
  __syncthreads();

  // the bins the strip's pixels read: each pixel's bin and the two beside it
  {
    unsigned need = 0u;
    for (int o = tid; o < rows * kStrip; o += kGateThreads) {
      const int y = o / kStrip, x = x0 + o % kStrip;
      if (x >= cols) continue;
      const int zb = code[y * kRegion + (x - rx0)] % kBins;
      need |= (7u << zb >> 1) & ((1u << kBins) - 1u);
    }
    need = __reduce_or_sync(0xffffffffu, need);
    if ((tid & 31) == 0 && need) atomicOr(&s_need, need);
  }
  for (int o = tid; o < rows * kStrip; o += kGateThreads) vs[o] = 0.0f;
  __syncthreads();
  const unsigned need = s_need;

  // the needed bins in passes of kSlots, in ascending order
  for (unsigned left = need; left;) {
    unsigned grp = 0u;
    for (int n = 0; n < kSlots && left; ++n) {
      grp |= left & (0u - left);
      left &= left - 1u;
    }

    // 2. horizontal sums of channel c for the pass's bins: each tap once,
    // added into its own bin's register (a tap of another bin, or of a
    // pixel that is not valid, into none)
    int sb[kSlots];
    {
      unsigned g = grp;
#pragma unroll
      for (int n = 0; n < kSlots; ++n) {
        sb[n] = g ? __ffs(g) - 1 : -1;
        g &= g - 1u;
      }
    }
    for (int o = tid; o < rows * kStrip; o += kGateThreads) {
      const int y = o / kStrip, xl = o % kStrip;
      const int x = x0 + xl;
      if (x >= cols) continue;
      float acc[kSlots];
#pragma unroll
      for (int n = 0; n < kSlots; ++n) acc[n] = 0.0f;
      const float* fr = feat + y * kRegion;
      const unsigned char* cr = code + y * kRegion;
      const int t1 = min(x + a.hi, cols - 1) - rx0;
#pragma unroll 1
      for (int t = max(x - a.lo, 0) - rx0; t <= t1; ++t) {
        const int cd = cr[t];
        const float f = fr[t];
#pragma unroll
        for (int n = 0; n < kSlots; ++n)
          if (cd == sb[n]) acc[n] = acc[n] + f;
      }
      float* h = hs + y * kStrip + xl;  // slot n at h[n * rows * kStrip]
#pragma unroll
      for (int n = 0; n < kSlots; ++n) h[n * rows * kStrip] = acc[n];
    }
    __syncthreads();

    // 3. vertical sums: a thread a pixel adds, for each of its three bins in
    // the pass in ascending order, the bin's window rows from +0
    for (int o = tid; o < rows * kStrip; o += kGateThreads) {
      const int y = o / kStrip, xl = o % kStrip;
      if (x0 + xl >= cols) continue;
      const int zb = code[y * kRegion + (x0 + xl - rx0)] % kBins;
      const unsigned mine = (7u << zb >> 1) & grp;
      if (!mine) continue;
      const int y1 = min(y + a.hi, rows - 1);
      float s = vs[o];
#pragma unroll 1
      for (unsigned m = mine; m; m &= m - 1u) {
        const float* col = hs + slot_of(grp, __ffs(m) - 1) * rows * kStrip + xl;
        float acc = 0.0f;
#pragma unroll 4
        for (int yy = max(y - a.lo, 0); yy <= y1; ++yy) acc = acc + col[yy * kStrip];
        s = s + acc;
      }
      vs[o] = s;
    }
    __syncthreads();
  }

  // 4. each pixel's sum of channel c to the CTA that runs its closed form,
  // then the closed form on the 11 channels' sums
  cl.sync();  // every CTA of the cluster runs before any writes into its shared memory
  for (int o = tid; o < rows * kStrip; o += kGateThreads)
    cl.map_shared_rank(own, o % kCh)[c * per_own + o / kCh] = vs[o];
  cl.sync();
  for (int m = tid; m < per_own; m += kGateThreads) {
    const int p = m * kCh + c;
    const int y = p / kStrip, x = x0 + p % kStrip;
    if (y >= rows || x >= cols) continue;
    float s[kCh];
#pragma unroll
    for (int r = 0; r < kCh; ++r) s[r] = own[r * per_own + m];
    gate[y * cols + x] = gate_value(s, k);
  }
}

// ---------------------------------------------------------------------------
// the reference mode: the design before (two launches)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
gate_rows_kernel(GateArgs a, int* __restrict__ bins, float* __restrict__ hsum) {
  extern __shared__ float sm[];
  float* feat = sm;                                              // [cols][kCh]
  int* sbin = reinterpret_cast<int*>(sm + static_cast<size_t>(a.cols) * kCh);  // [cols]
  const int y = blockIdx.x;
  for (int x = threadIdx.x; x < a.cols; x += blockDim.x) {
    const int i = y * a.cols + x;
    int zb;
    bool valid;
    pixel_features(a, i, feat + x * kCh, zb, valid);
    bins[i] = zb;
    // an invalid pixel's one-hot row is zero: it feeds no bin
    sbin[x] = valid ? zb : -1;
  }
  __syncthreads();
  const int per_row = kBins * kCh * a.cols;
  for (int o = threadIdx.x; o < per_row; o += blockDim.x) {
    const int x = o % a.cols;
    const int bc = o / a.cols;  // bin * kCh + channel
    const int bin = bc / kCh, c = bc % kCh;
    float s = 0.0f;
    const int x0 = max(x - a.lo, 0), x1 = min(x + a.hi, a.cols - 1);
    for (int xx = x0; xx <= x1; ++xx) {
      if (sbin[xx] == bin) s = s + feat[xx * kCh + c];
    }
    hsum[(static_cast<size_t>(bc) * a.rows + y) * a.cols + x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
gate_pixels_kernel(GateArgs a, const int* __restrict__ bins, const float* __restrict__ hsum, GateConsts k,
                   float* __restrict__ gate) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.rows * a.cols) return;
  const int y = i / a.cols, x = i % a.cols;
  const int zb = bins[i];
  const int y0 = max(y - a.lo, 0), y1 = min(y + a.hi, a.rows - 1);
  float s[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) s[c] = 0.0f;
  // gather(zb - 1) + gather(zb) + gather(zb + 1); a bin past either end adds 0
  for (int k = 0; k < 3; ++k) {
    const int bin = zb - 1 + k;
    if (bin < 0 || bin >= kBins) continue;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const float* col = hsum + (static_cast<size_t>(bin * kCh + c) * a.rows) * a.cols + x;
      float v = 0.0f;
      for (int yy = y0; yy <= y1; ++yy) v = v + __ldg(col + static_cast<size_t>(yy) * a.cols);
      s[c] = s[c] + v;
    }
  }
  gate[i] = gate_value(s, k);
}

// the cluster kernel's attributes (non-portable cluster size, the most
// dynamic shared memory a CTA may take) on the current device, set once a
// device
cudaError_t cluster_setup() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && done[dev])) return e;
  e = cudaFuncSetAttribute(gate_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gate_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

// the cluster launch, a programmatic dependent launch of the features
cudaError_t launch_cluster(const GateArgs& a, const GateConsts& k, const float* feat, const unsigned char* code,
                           float* gate, cudaStream_t st) {
  cudaError_t e = cluster_setup();
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(gate_cluster_kernel);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  cfg.gridDim = dim3(((a.cols + kStrip - 1) / kStrip) * kCh, 1, 1);
  cfg.blockDim = dim3(kGateThreads, 1, 1);
  cfg.dynamicSmemBytes = gate_smem(a.rows);
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCh;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  void* args[] = {const_cast<GateArgs*>(&a), const_cast<GateConsts*>(&k), &feat, &code, &gate};
  return cudaLaunchKernelExC(&cfg, fn, args);
}

}  // namespace

// The most rows the cluster design takes (its shared memory grows with
// the rows: about 600 bytes a row), the widest window it takes and its strip of
// columns: the caller's choice of mode (kernels.p2p_gate_cluster).
extern "C" int df_p2p_gate_plan(int* max_rows, int* max_window, int* strip) {
  int r = 0;
  while (gate_smem(r + 1) <= 227 * 1024) ++r;
  *max_rows = r;
  *max_window = kMaxWin;
  *strip = kStrip;
  return 0;
}

// n_bins and n_ch are the caller's layout ([n_bins][n_ch]); they must equal
// the kernel's own. scratch: the reference mode's [n_bins * n_ch][rows]
// [cols] horizontal sums, else the features ([n_ch][rows][cols] floats)
// and the bin codes (rows x cols bytes); *launched: the device kernels
// this call launched.
extern "C" int df_p2p_gate(const void* live, const void* nrm, const void* prev, const void* cam_z, int rows,
                           int cols, int lo, int hi, int n_bins, int n_ch, float z_lo, float bin_w,
                           float reg_scale, float cond0, float fit0, float fit_den, float gain, float min_count,
                           void* bins, void* scratch, void* gate, int reference, int* launched, void* stream) {
  *launched = 0;
  if (n_bins != kBins || n_ch != kCh) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || cols <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GateArgs a{static_cast<const float*>(live), static_cast<const float*>(nrm), static_cast<const float*>(prev),
                   static_cast<const float*>(cam_z), rows, cols, lo, hi, z_lo, bin_w};
  const GateConsts k{reg_scale, cond0, fit0, fit_den, gain, min_count};
  if (!reference) {
    if (lo + hi + 1 > kMaxWin || gate_smem(rows) > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    float* feat = static_cast<float*>(scratch);
    unsigned char* code = reinterpret_cast<unsigned char*>(feat + static_cast<size_t>(kCh) * rows * cols);
    const int n = rows * cols;
    gate_features_kernel<<<(n + kGateThreads - 1) / kGateThreads, kGateThreads, 0, s>>>(a, feat, code,
                                                                                     static_cast<int*>(bins));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    *launched = 1;
    e = launch_cluster(a, k, feat, code, static_cast<float*>(gate), s);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e == cudaSuccess) *launched = 2;
    return static_cast<int>(e);
  }
  float* hsum = static_cast<float*>(scratch);
  const size_t smem = static_cast<size_t>(cols) * (kCh + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gate_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gate_rows_kernel<<<rows, kThreads, smem, s>>>(a, static_cast<int*>(bins), hsum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *launched = 1;
  const int n = rows * cols;
  gate_pixels_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      a, static_cast<const int*>(bins), hsum, k, static_cast<float*>(gate));
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 2;
  return static_cast<int>(err);
}
