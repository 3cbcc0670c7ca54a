// Row-wise symmetric int8 quantization on the CUDA cores (sm_90a), CUDA C++:
// the `simt` route.
//
// Replaces the Pallas TPU kernel `_quant_kernel` driven by `quantize_int8`
// (src/repro/kernels/int8_quant.py) for the shapes that int8_quant_sm90.cu
// does not take: rows that are not whole 16-byte pieces, rows over 48 KB,
// or x or out not 16-byte aligned. Same function: x (R, C) f32 or bf16;
// per row, absmax = max |x| in f32, scale = max(absmax, 1e-8) / 127 and
// q = clip(round(x / scale), -127, 127) as int8, rounding half to even.
// Outputs q (R, C) int8 and scale (R,) f32. The division is IEEE (`/`,
// never a reciprocal multiply or __fdividef: nvcc runs without fast math)
// and the rounding is rintf, so q and scale equal the plain PyTorch
// version's bit for bit: a max and one correctly rounded division do not
// depend on the order of the reduction. The max propagates NaN, as the
// plain version's amax and the reference's jnp.max do (fmaxf would drop
// it): a row that holds a NaN gets a NaN scale, one that holds an inf an
// inf scale. q is defined only on rows whose scale is finite; elsewhere
// every version casts a NaN to int8, which no two define alike. With `out`
// (bf16 or f32, shaped like x) the second pass also writes out = q * scale,
// one f32 product rounded once to out's type, as torch.mul(q, scale[:, None],
// out=out) does.
//
// What bounds it on this card: every element is read once and written once
// as one byte, with a handful of operations each, so bytes bound it. At the
// runtime's boundary shape (640, 5120) bf16 that is 9.83 MB, ~2.9 us at
// 3.35 TB/s; a launch costs a few microseconds, so launch latency is of the
// same order as the work. What the design does about that:
// * one block of 256 threads per row when the row has at least 2048
//   elements, else one warp per row (8 rows per block), so short rows still
//   fill the warps;
// * 16-byte loads (4 f32 or 8 bf16 per thread) and 4- or 8-byte stores of q
//   where the row length and the pointers allow it, else one element a
//   thread; no padding of a ragged edge;
// * absmax by warp shuffles, then across the block's 8 warps through shared
//   memory; the second pass reads the row again, from L2 (a row is at most a
//   few tens of KB and the whole boundary tensor fits the 50 MB L2).
// The TPU kernel's 256-row blocks and its padding of the tail with 1.0 are
// not carried over.
//
// Entry point: `int8_quant_rows`, a plain C function that launches on the
// given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NTHREADS = 256;
constexpr int WARP = 32;
constexpr int BLOCK_ROW_MIN_COLS = 2048;   // rows this long get a whole block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// max that returns NaN when either side is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// float(q) for q = clip(rint(v / scale), -127, 127); + 0: rint gives -0
// where q is 0, and float(q) is +0
__device__ __forceinline__ float quantize(float v, float scale) {
  return fminf(fmaxf(rintf(v / scale), -127.0f), 127.0f) + 0.0f;
}

template <typename O> __device__ __forceinline__ O from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// q values of one 16-byte load of x
template <int N>
struct alignas(N) QPack {
  signed char v[N];
};

// Max over the GROUP threads that share a row: shuffles inside a warp, then
// shared memory across the warps of a block (GROUP == NTHREADS).
template <int GROUP>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = WARP / 2; off > 0; off >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  if constexpr (GROUP > WARP) {
    __shared__ float part[GROUP / WARP];
    if (threadIdx.x % WARP == 0) part[threadIdx.x / WARP] = v;
    __syncthreads();
    v = part[0];
#pragma unroll
    for (int w = 1; w < GROUP / WARP; ++w) v = nan_max(v, part[w]);
  }
  return v;
}

// GROUP threads per row; VEC: 16-byte loads (cols % (16 / sizeof(T)) == 0
// and aligned pointers); O: out's element type, void for none.
template <typename T, int GROUP, bool VEC, typename O>
__global__ void __launch_bounds__(NTHREADS)
    quant_rows_kernel(const T* __restrict__ x, signed char* __restrict__ q,
                      float* __restrict__ scale, O* __restrict__ out, int rows, int cols) {
  constexpr int N = 16 / sizeof(T);
  const int row = blockIdx.x * (NTHREADS / GROUP) + threadIdx.x / GROUP;
  const int lane = threadIdx.x % GROUP;
  // a warp-per-row block may hang past the last row; the warp leaves whole.
  // A block-per-row grid has exactly `rows` blocks.
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * cols;
  signed char* qr = q + static_cast<size_t>(row) * cols;
  O* outr = nullptr;
  if constexpr (!std::is_void_v<O>) outr = out + static_cast<size_t>(row) * cols;

  float amax = 0.0f;
  if constexpr (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < cols / N; i += GROUP) {
      const uint4 raw = __ldg(xv + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < N; ++k) amax = nan_max(amax, fabsf(to_float(e[k])));
    }
  } else {
    for (int i = lane; i < cols; i += GROUP) amax = nan_max(amax, fabsf(to_float(xr[i])));
  }
  amax = group_max<GROUP>(amax);
  const float s = nan_max(amax, 1e-8f) / 127.0f;
  if (lane == 0) scale[row] = s;

  if constexpr (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    QPack<N>* qv = reinterpret_cast<QPack<N>*>(qr);
    for (int i = lane; i < cols / N; i += GROUP) {
      const uint4 raw = __ldg(xv + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      QPack<N> pack;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float t = quantize(to_float(e[k]), s);
        pack.v[k] = static_cast<signed char>(static_cast<int>(t));
        if constexpr (!std::is_void_v<O>) outr[i * N + k] = from_float<O>(t * s);
      }
      qv[i] = pack;
    }
  } else {
    for (int i = lane; i < cols; i += GROUP) {
      const float t = quantize(to_float(xr[i]), s);
      qr[i] = static_cast<signed char>(static_cast<int>(t));
      if constexpr (!std::is_void_v<O>) outr[i] = from_float<O>(t * s);
    }
  }
}

template <typename T, int GROUP, typename O>
void launch_group(const T* x, signed char* q, float* scale, O* out, int rows, int cols,
                  bool vec, cudaStream_t stream) {
  const dim3 grid((rows + NTHREADS / GROUP - 1) / (NTHREADS / GROUP));
  if (vec) {
    quant_rows_kernel<T, GROUP, true, O><<<grid, NTHREADS, 0, stream>>>(x, q, scale, out, rows,
                                                                         cols);
  } else {
    quant_rows_kernel<T, GROUP, false, O><<<grid, NTHREADS, 0, stream>>>(x, q, scale, out, rows,
                                                                          cols);
  }
}

template <typename T, typename O>
cudaError_t launch(const void* x, void* q, void* scale, void* out, int rows, int cols,
                   cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const bool vec = cols % N == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % N == 0;
  const T* xs = static_cast<const T*>(x);
  signed char* qs = static_cast<signed char*>(q);
  float* ss = static_cast<float*>(scale);
  O* os = static_cast<O*>(out);
  if (cols >= BLOCK_ROW_MIN_COLS) {
    launch_group<T, NTHREADS>(xs, qs, ss, os, rows, cols, vec, stream);
  } else {
    launch_group<T, WARP>(xs, qs, ss, os, rows, cols, vec, stream);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_out(const void* x, void* q, void* scale, void* out, int out_dtype, int rows,
                       int cols, cudaStream_t stream) {
  if (out == nullptr) return launch<T, void>(x, q, scale, out, rows, cols, stream);
  switch (out_dtype) {
    case 0: return launch<T, float>(x, q, scale, out, rows, cols, stream);
    case 1: return launch<T, __nv_bfloat16>(x, q, scale, out, rows, cols, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x); out_dtype likewise (out), read only
// when out is not null. x (rows, cols) contiguous; q (rows, cols) int8,
// scale (rows,) f32 and out (rows, cols), all contiguous.
extern "C" int int8_quant_rows(const void* x, void* q, void* scale, void* out, int dtype,
                               int out_dtype, int rows, int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_out<float>(x, q, scale, out, out_dtype, rows, cols, st);
    case 1: return launch_out<__nv_bfloat16>(x, q, scale, out, out_dtype, rows, cols, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* int8_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
