// Kernel A: 7x7 bilateral filter on uint16 millimetre depth.
//
// Replaces dynamicfusion_tpu/ops/preprocess.py:43 bilateral_filter (49
// shifted whole-image passes that XLA fuses on the TPU).
//
// Bound on the H100: operations, not bytes. The frame is 640x480 uint16
// (0.6 MB in, 0.6 MB out), but every pixel takes 49 taps, each an expf
// (one ex2 on the special-function units, 16 a clock on each SM) and a
// handful of multiply-adds (~15 M expf a frame).
//
// Design: a block of 32x4 threads owns 32 kPx x 4 outputs, a thread kPx
// consecutive pixels of a row (1: at 640x480 that is 2 400 blocks, 18 to
// 19 an SM; 2 or 4 pixels, whose window rows serve several outputs, and
// 32x8 blocks were slower, scripts/torch_extract_bilateral_variants.py).
// The block loads its tile and halo once, coalesced, into shared memory
// as float depths, a marker (-1) outside the image; a thread reads each
// window row's 2 half + kPx values once. The spatial term is a table the host fills,
// float32(float64(dy^2 + dx^2) inv_sp) as the JAX weak-typed constant
// rounds it, passed as a kernel argument (a uniform read of the constant
// bank in the tap loop). Blocks whose window stays inside the image take
// the tap loop without the marker test; border blocks skip the marked
// taps (a neighbour outside contributes nothing, as the JAX mask). The
// arithmetic and its order are the plain version's: dy outer, dx inner,
// expf the full-precision libdevice one (no fast math), num + nbr w then
// den + w, rounded half-to-even with rintf; so the kernel is bit-equal to
// the reference mode below.
//
// The design before, kept as the reference mode (and for a half window
// past kMaxHalf): a thread a pixel in 32x8 blocks, each tap a bounds test
// and a read through L1, the spatial term formed in double in the loop.
#include "common.cuh"

namespace {

constexpr int kBx = 32, kBy = 4;  // threads of a block
constexpr int kPx = 1;            // consecutive pixels a thread
constexpr int kMaxHalf = 5;       // the tiled kernel's windows: 3x3 to 11x11
constexpr float kOutside = -1.0f;  // the tile's marker past the image (depths are >= 0)

// the spatial term of tap (dy, dx) at (dy + half) (2 half + 1) + dx + half
struct SpaceTable {
  float v[(2 * kMaxHalf + 1) * (2 * kMaxHalf + 1)];
};

template <int H, bool kBorder>
__device__ __forceinline__ void filter_px(float (*tile)[kBx * kPx + 2 * H], int tx, int ty, float inv_sd,
                                          const SpaceTable& sp, float (&num)[kPx], float (&den)[kPx]) {
  constexpr int kWin = 2 * H + kPx;  // a window row's values for the thread's kPx outputs
  float d[kPx];
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    d[p] = tile[ty + H][tx * kPx + H + p];
    num[p] = 0.0f;
    den[p] = 0.0f;
  }
#pragma unroll
  for (int dy = -H; dy <= H; ++dy) {
    float win[kWin];
#pragma unroll
    for (int c = 0; c < kWin; ++c) win[c] = tile[ty + H + dy][tx * kPx + c];
#pragma unroll
    for (int dx = -H; dx <= H; ++dx) {
      const float space = sp.v[(dy + H) * (2 * H + 1) + dx + H];
#pragma unroll
      for (int p = 0; p < kPx; ++p) {
        const float nbr = win[p + dx + H];
        if (kBorder && nbr == kOutside) continue;
        const float diff = d[p] - nbr;
        const float w = expf(-(space + diff * diff * inv_sd));
        num[p] = num[p] + nbr * w;
        den[p] = den[p] + w;
      }
    }
  }
}

template <int H>
__global__ void __launch_bounds__(kBx* kBy)
bilateral_tile_kernel(const uint16_t* __restrict__ in, uint16_t* __restrict__ out, int rows, int cols, float inv_sd,
                      SpaceTable sp) {
  constexpr int kTw = kBx * kPx + 2 * H, kTh = kBy + 2 * H;
  __shared__ float tile[kTh][kTw];
  const int x0 = blockIdx.x * kBx * kPx, y0 = blockIdx.y * kBy;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int q = ty * kBx + tx; q < kTh * kTw; q += kBx * kBy) {
    const int r = q / kTw, c = q - r * kTw;  // a compile-time divisor
    const int yy = y0 - H + r, xx = x0 - H + c;
    tile[r][c] = yy >= 0 && yy < rows && xx >= 0 && xx < cols ? static_cast<float>(in[yy * cols + xx]) : kOutside;
  }
  __syncthreads();
  float num[kPx], den[kPx];
  const bool interior = x0 >= H && y0 >= H && x0 + kBx * kPx + H <= cols && y0 + kBy + H <= rows;
  if (interior) {
    filter_px<H, false>(tile, tx, ty, inv_sd, sp, num, den);
  } else {
    filter_px<H, true>(tile, tx, ty, inv_sd, sp, num, den);
  }
  const int y = y0 + ty;
  if (y >= rows) return;
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    const int x = x0 + tx * kPx + p;
    if (x < cols) out[y * cols + x] = static_cast<uint16_t>(rintf(num[p] / fmaxf(den[p], 1e-12f)));
  }
}

__global__ void bilateral_kernel(const uint16_t* __restrict__ in, uint16_t* __restrict__ out,
                                 int rows, int cols, int half, double inv_sp, float inv_sd) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= cols || y >= rows) return;
  const float d = static_cast<float>(in[y * cols + x]);
  float num = 0.0f;
  float den = 0.0f;
  for (int dy = -half; dy <= half; ++dy) {
    const int yy = y + dy;
    for (int dx = -half; dx <= half; ++dx) {
      const int xx = x + dx;
      if (yy < 0 || yy >= rows || xx < 0 || xx >= cols) continue;
      const float nbr = static_cast<float>(__ldg(in + yy * cols + xx));
      const float space = static_cast<float>(static_cast<double>(dy * dy + dx * dx) * inv_sp);
      const float diff = d - nbr;
      const float w = expf(-(space + diff * diff * inv_sd));
      num = num + nbr * w;
      den = den + w;
    }
  }
  out[y * cols + x] = static_cast<uint16_t>(rintf(num / fmaxf(den, 1e-12f)));
}

template <int H>
int launch_tiled(const uint16_t* in, uint16_t* out, int rows, int cols, float inv_sd, const SpaceTable& sp,
                 cudaStream_t st) {
  const dim3 block(kBx, kBy);
  const dim3 grid((cols + kBx * kPx - 1) / (kBx * kPx), (rows + kBy - 1) / kBy);
  bilateral_tile_kernel<H><<<grid, block, 0, st>>>(in, out, rows, cols, inv_sd, sp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// space: the (2 half + 1)^2 spatial terms, row-major in (dy, dx), read by
// the tiled kernel (reference 0, 1 <= half <= kMaxHalf); inv_sp is the
// reference mode's
extern "C" int df_bilateral(const void* in, void* out, int rows, int cols, int half, double inv_sp, float inv_sd,
                            const float* space, int reference, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint16_t* src = static_cast<const uint16_t*>(in);
  uint16_t* dst = static_cast<uint16_t*>(out);
  if (!reference) {
    if (half < 1 || half > kMaxHalf || space == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    SpaceTable sp{};
    for (int t = 0; t < (2 * half + 1) * (2 * half + 1); ++t) sp.v[t] = space[t];
    switch (half) {
      case 1: return launch_tiled<1>(src, dst, rows, cols, inv_sd, sp, st);
      case 2: return launch_tiled<2>(src, dst, rows, cols, inv_sd, sp, st);
      case 3: return launch_tiled<3>(src, dst, rows, cols, inv_sd, sp, st);
      case 4: return launch_tiled<4>(src, dst, rows, cols, inv_sd, sp, st);
      default: return launch_tiled<5>(src, dst, rows, cols, inv_sd, sp, st);
    }
  }
  dim3 block(32, 8);
  dim3 grid((cols + block.x - 1) / block.x, (rows + block.y - 1) / block.y);
  bilateral_kernel<<<grid, block, 0, st>>>(src, dst, rows, cols, half, inv_sp, inv_sd);
  return static_cast<int>(cudaGetLastError());
}
