// Device helpers shared by the port's hand-written kernels (moe_dispatch.cu,
// rms_norm.cu, causal_conv1d.cu, swiglu.cu, ...): a host guard that makes a
// device current for a launch, the bf16/f32 element moves and roundings of
// the elementwise kernels, and SiLU as `F.silu` computes it. kernels/build.py compiles each source with this
// directory on the include path and keys its library on this file too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Makes `dev` current for the launch and restores the caller's device.
struct OnDevice {
  int prev = -1;
  explicit OnDevice(int dev) {
    if (cudaGetDevice(&prev) == cudaSuccess && prev != dev) cudaSetDevice(dev);
    else prev = -1;
  }
  ~OnDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
}

// SiLU as PyTorch's `F.silu` computes it: x / (1 + expf(-x)) in f32 with
// the exact expf and IEEE division (a build without fast math)
__device__ __forceinline__ float silu_exact(float v) { return v / (1.0f + expf(-v)); }

// f rounded to T and widened back
template <typename T> __device__ __forceinline__ float rnd(float f);
template <> __device__ __forceinline__ float rnd<float>(float f) { return f; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

// V elements of T (f32 or bf16) at p into f, in one load of V * sizeof(T)
// bytes: one element, 4 bytes (a bf16 pair), 8 bytes, or whole 16-byte
// pieces
template <typename T, int V>
__device__ __forceinline__ void load_unit(const T* p, float* f) {
  constexpr int BYTES = V * int(sizeof(T));
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 2) f[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
    else f[0] = *reinterpret_cast<const float*>(p);
  } else if constexpr (BYTES == 4) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    f[0] = bf16_lo(u); f[1] = bf16_hi(u);
  } else if constexpr (BYTES == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    if constexpr (sizeof(T) == 2) {
      f[0] = bf16_lo(u.x); f[1] = bf16_hi(u.x); f[2] = bf16_lo(u.y); f[3] = bf16_hi(u.y);
    } else {
      f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    }
  } else {
    static_assert(BYTES % 16 == 0, "a unit is 1 element, 4 or 8 bytes, or 16-byte pieces");
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[k];
      if constexpr (sizeof(T) == 2) {
        f[8 * k + 0] = bf16_lo(u.x); f[8 * k + 1] = bf16_hi(u.x);
        f[8 * k + 2] = bf16_lo(u.y); f[8 * k + 3] = bf16_hi(u.y);
        f[8 * k + 4] = bf16_lo(u.z); f[8 * k + 5] = bf16_hi(u.z);
        f[8 * k + 6] = bf16_lo(u.w); f[8 * k + 7] = bf16_hi(u.w);
      } else {
        f[4 * k + 0] = __uint_as_float(u.x); f[4 * k + 1] = __uint_as_float(u.y);
        f[4 * k + 2] = __uint_as_float(u.z); f[4 * k + 3] = __uint_as_float(u.w);
      }
    }
  }
}

// f rounded to T, stored as V elements at p in one store (the units of
// load_unit)
template <typename T, int V>
__device__ __forceinline__ void store_unit(T* p, const float* f) {
  constexpr int BYTES = V * int(sizeof(T));
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 2) *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(f[0]);
    else *reinterpret_cast<float*>(p) = f[0];
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<uint32_t*>(p) = bf16_bits(f[0]) | (bf16_bits(f[1]) << 16);
  } else if constexpr (BYTES == 8) {
    uint2 u;
    if constexpr (sizeof(T) == 2) {
      u.x = bf16_bits(f[0]) | (bf16_bits(f[1]) << 16);
      u.y = bf16_bits(f[2]) | (bf16_bits(f[3]) << 16);
    } else {
      u.x = __float_as_uint(f[0]); u.y = __float_as_uint(f[1]);
    }
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    static_assert(BYTES % 16 == 0, "a unit is 1 element, 4 or 8 bytes, or 16-byte pieces");
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k) {
      uint4 u;
      if constexpr (sizeof(T) == 2) {
        u.x = bf16_bits(f[8 * k + 0]) | (bf16_bits(f[8 * k + 1]) << 16);
        u.y = bf16_bits(f[8 * k + 2]) | (bf16_bits(f[8 * k + 3]) << 16);
        u.z = bf16_bits(f[8 * k + 4]) | (bf16_bits(f[8 * k + 5]) << 16);
        u.w = bf16_bits(f[8 * k + 6]) | (bf16_bits(f[8 * k + 7]) << 16);
      } else {
        u.x = __float_as_uint(f[4 * k + 0]); u.y = __float_as_uint(f[4 * k + 1]);
        u.z = __float_as_uint(f[4 * k + 2]); u.w = __float_as_uint(f[4 * k + 3]);
      }
      reinterpret_cast<uint4*>(p)[k] = u;
    }
  }
}

}  // namespace
