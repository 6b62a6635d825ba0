// Shared helpers of the port's CUDA kernels: volume codec and index clamps.
//
// Every kernel is compiled with -fmad=false and repeats the arithmetic of
// its plain PyTorch version operation for operation (same association,
// same float32 constants), so that the two round alike.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dfk {

constexpr float kTsdfScale = 32767.0f;       // i16 tsdf code = round(tsdf * 32767)
constexpr float kWeightScale = 512.0f;       // u16 weight code = round(weight * 512)
constexpr float kWeightDecode = 1.0f / 512.0f;  // exact
constexpr float kWeightMax = 65535.0f / 512.0f; // exact
// the packed depth + confidence image (bricks.unpack_depth_conf): XLA
// compiles the JAX package's divisions by 15 and 4000 there as products
// with these float32 reciprocals
constexpr float kInvConf = 1.0f / 15.0f;
constexpr float kInvDepth = 1.0f / 4000.0f;

// round half to even, as torch.round / jnp.round
__device__ __forceinline__ int16_t encode_tsdf(float x) {
  return static_cast<int16_t>(rintf(fminf(fmaxf(x, -1.0f), 1.0f) * kTsdfScale));
}

__device__ __forceinline__ uint16_t encode_weight(float x) {
  return static_cast<uint16_t>(rintf(fminf(fmaxf(x, 0.0f), kWeightMax) * kWeightScale));
}

__device__ __forceinline__ float decode_weight(uint16_t w) {
  return static_cast<float>(w) * kWeightDecode;
}

// the loop state of kernel P's PCG (csrc/dense_pcg.cu), the last three
// words of its work; kernel G's distributed PCG (csrc/pcg.cu) reads it too
struct PcgState {
  float rz;     // rᵀz of the current residual
  float stop2;  // rtol² bᵀb
  int done;     // the loop has ended
};

// floor(x) clamped into [0, hi] before the integer conversion (NaN -> 0)
__device__ __forceinline__ int floor_clamp(float x, int hi) {
  return static_cast<int>(fminf(fmaxf(floorf(x), 0.0f), static_cast<float>(hi)));
}

}  // namespace dfk
