// Shared helpers of the port's CUDA kernels: the volume codecs of every
// storage, the storage dispatch and index clamps.
//
// Every kernel is compiled with -fmad=false and repeats the arithmetic of
// its plain PyTorch version operation for operation (same association,
// same float32 constants), so that the two round alike.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
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

// The volume's storages (dynamicfusion_tpu/models/volume.py:73-95): the
// tsdf as i16 codes (x 32767, clipped to [-1, 1]), float32 or bfloat16;
// the weight as u16 codes (x 512, clipped to [0, 65535 / 512]) or
// float32. A kernel's entry point takes one storage code, tsdf code |
// weight code << 2 (kernels/__init__.py _storage_code), and
// dispatch_storage instantiates the kernel for that pair of types. The
// float storages decode by 1 (the caller's decode scale) and encode
// without a clip; bf16 rounds to nearest even, as torch's and JAX's
// float32 -> bfloat16 conversions do.
constexpr int kTsdfI16 = 0, kTsdfF32 = 1, kTsdfBf16 = 2;
constexpr int kWeightU16 = 0, kWeightF32 = 1;

// a stored tsdf value as float32 (before the decode scale), exact
__device__ __forceinline__ float code_value(int16_t c) { return static_cast<float>(c); }
__device__ __forceinline__ float code_value(float c) { return c; }
__device__ __forceinline__ float code_value(__nv_bfloat16 c) { return __bfloat162float(c); }

// the same through the read-only path (bf16 loaded as its 16 bits)
__device__ __forceinline__ float load_code(const int16_t* p) { return static_cast<float>(__ldg(p)); }
__device__ __forceinline__ float load_code(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_code(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// round half to even, as torch.round / jnp.round
template <typename T>
__device__ __forceinline__ T encode_tsdf(float x);
template <>
__device__ __forceinline__ int16_t encode_tsdf<int16_t>(float x) {
  return static_cast<int16_t>(rintf(fminf(fmaxf(x, -1.0f), 1.0f) * kTsdfScale));
}
template <>
__device__ __forceinline__ float encode_tsdf<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 encode_tsdf<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename W>
__device__ __forceinline__ W encode_weight(float x);
template <>
__device__ __forceinline__ uint16_t encode_weight<uint16_t>(float x) {
  return static_cast<uint16_t>(rintf(fminf(fmaxf(x, 0.0f), kWeightMax) * kWeightScale));
}
template <>
__device__ __forceinline__ float encode_weight<float>(float x) {
  return x;
}

__device__ __forceinline__ float decode_weight(uint16_t w) {
  return static_cast<float>(w) * kWeightDecode;
}
__device__ __forceinline__ float decode_weight(float w) { return w; }

template <typename T>
struct Type {
  using type = T;
};

// f(Type<tsdf type>{}, Type<weight type>{}) for the storage code; an
// unknown code is cudaErrorInvalidValue
template <typename F>
int dispatch_storage(int storage, F&& f) {
  const int t = storage & 3, w = storage >> 2;
  if (w == kWeightU16) {
    if (t == kTsdfI16) return f(Type<int16_t>{}, Type<uint16_t>{});
    if (t == kTsdfF32) return f(Type<float>{}, Type<uint16_t>{});
    if (t == kTsdfBf16) return f(Type<__nv_bfloat16>{}, Type<uint16_t>{});
  } else if (w == kWeightF32) {
    if (t == kTsdfI16) return f(Type<int16_t>{}, Type<float>{});
    if (t == kTsdfF32) return f(Type<float>{}, Type<float>{});
    if (t == kTsdfBf16) return f(Type<__nv_bfloat16>{}, Type<float>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// f(Type<tsdf type>{}) for a kernel that reads the tsdf only (the weight
// code is ignored)
template <typename F>
int dispatch_tsdf(int storage, F&& f) {
  const int t = storage & 3;
  if (t == kTsdfI16) return f(Type<int16_t>{});
  if (t == kTsdfF32) return f(Type<float>{});
  if (t == kTsdfBf16) return f(Type<__nv_bfloat16>{});
  return static_cast<int>(cudaErrorInvalidValue);
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
