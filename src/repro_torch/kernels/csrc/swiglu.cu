// SwiGLU's gate h = silu(g) · u, forward and adjoint (sm_90a), CUDA C++: B8.
//
// Replaces no Pallas kernel. The kernels stand for what XLA fuses under the
// reference's `jax.jit` out of `jax.nn.silu(g) * u` in `swiglu`
// (src/repro/models/layers.py:28) and in `moe_ffn`'s expert block
// (src/repro/models/moe.py:115), and out of that product's autodiff. The
// port's eager chain (kernels/swiglu.py `swiglu_plain`, `F.silu(g) * u`)
// runs two passes forward, writing silu(g) and reading it back, and three
// in its backward (mul's two products, then `silu_backward`).
//
// Bits: every step rounds where the eager chain and its autograd round,
// so the outputs equal theirs bit for bit (T the dtype, bf16 or f32):
//   forward:  s = T(silu(g)),  h = T(s · u),
//             silu(g) = g / (1 + expf(-g)) in f32 (`silu_exact`: the exact
//             expf and IEEE division, F.silu's own expression);
//   adjoint:  ds = T(dh · u),  du = T(dh · s),
//             dg = T((ds · σ) · (1 + g · (1 − σ))),  σ = 1 / (1 + expf(-g)),
//             ATen's `silu_backward` on the rounded ds. 1 + expf(-g) is
//             written as F.silu and `silu_backward` write it, and formed
//             once for s and σ (ATen forms the same value in each of its
//             two kernels). nvcc contracts ATen's `1 + g · (1 − σ)` into
//             one fma, found on the card: examples/swiglu_dsilu_probe_torch.py
//             builds this source with each form of that term (`dsilu`) and
//             holds both against `silu_backward` on every bf16 g with eight
//             dh each (NVIDIA H100 80GB HBM3, torch 2.11.0+cu128): the fma
//             form equals it everywhere, in f32 and bf16; the product and
//             sum rounded apart differ in f32 on 2,026 of 524,288 elements
//             (bf16's rounding hides them). 1 + expf(-g) reads the same
//             written as here or as `__fadd_rn`. Every other product and sum
//             is `__f*_rn`, so nvcc contracts nothing else; the build uses
//             no fast math.
//
// Layout: g, u (and dh) are read as (rows, cols) at their row strides, the
// last dim contiguous; the outputs are contiguous. One pass: a thread takes
// NI units in flight, each 16 bytes of every input (8 bf16 or 4 f32: the
// `vector` route, where cols is whole units and every row stride and pointer
// is 16-byte aligned) or one element (`scalar`), its units a grid's width
// apart, and strides over the grid. No shared memory, no atomics.
//
// What bounds it on this card: bytes. phi4-mini-3.8b's training shape
// (4096 × 8192 bf16): the forward reads g and u and writes h, 201 MB,
// 0.060 ms at 3.35 TB/s; the adjoint reads g, u, dh and writes dg, du,
// 336 MB, 0.100 ms. The arithmetic (an expf and a division or two an
// element, ~25–40 instructions) is about half the bytes' time at the
// card's issue rate, so the design keeps enough bytes in flight (NI
// 16-byte units of each input a thread, a grid of the card's residency)
// and touches each byte once: s is never written, the adjoint recomputes it.
#include "common.cuh"

namespace {

constexpr int MODE_VECTOR = 1, MODE_DTYPE = 2, MODE_DEVICE_SHIFT = 8;
constexpr int THREADS = 256;      // a block
constexpr int NI = 4;             // units a thread has in flight

struct Args {
  const void* g;
  const void* u;
  const void* dh;                 // adjoint only
  void* h;                        // forward: h; adjoint: dg
  void* du;                       // adjoint only
  long long units;                // rows × units a row
  long long gs, us, hs;           // row strides of g, u, dh in elements
  int upr;                        // units a row
  int flat;                       // every input's rows contiguous: unit i at i·V
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// SiLU's derivative term 1 + g·(1 − σ) as ATen's compiled `silu_backward`
// forms it: one fma (see the header)
__device__ __forceinline__ float dsilu(float g, float sig) {
  return __fmaf_rn(g, __fsub_rn(1.0f, sig), 1.0f);
}

// The element offsets of unit `it` in an input of row stride `rs`
__device__ __forceinline__ long long offset(const Args& a, long long it, long long rs, int v) {
  if (a.flat) return it * v;
  const long long row = it / a.upr;
  return row * rs + (it - row * a.upr) * v;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS) swiglu_fwd_kernel(const Args a) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long base = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       base < a.units; base += stride * NI) {
    float g[NI][V], u[NI][V];
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const long long it = base + n * stride;
      if (it >= a.units) continue;
      load_unit<T, V>(static_cast<const T*>(a.g) + offset(a, it, a.gs, V), g[n]);
      load_unit<T, V>(static_cast<const T*>(a.u) + offset(a, it, a.us, V), u[n]);
    }
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const long long it = base + n * stride;
      if (it >= a.units) continue;
      float h[V];
#pragma unroll
      for (int i = 0; i < V; ++i) h[i] = __fmul_rn(rnd<T>(silu_exact(g[n][i])), u[n][i]);
      store_unit<T, V>(static_cast<T*>(a.h) + it * V, h);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS) swiglu_bwd_kernel(const Args a) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long base = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       base < a.units; base += stride * NI) {
    float g[NI][V], u[NI][V], d[NI][V];
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const long long it = base + n * stride;
      if (it >= a.units) continue;
      load_unit<T, V>(static_cast<const T*>(a.g) + offset(a, it, a.gs, V), g[n]);
      load_unit<T, V>(static_cast<const T*>(a.u) + offset(a, it, a.us, V), u[n]);
      load_unit<T, V>(static_cast<const T*>(a.dh) + offset(a, it, a.hs, V), d[n]);
    }
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const long long it = base + n * stride;
      if (it >= a.units) continue;
      float dg[V], du[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float x = g[n][i];
        const float den = 1.0f + expf(-x);                   // as F.silu and silu_backward
        const float s = rnd<T>(x / den);                     // silu_exact(x), rounded
        const float sig = 1.0f / den;                        // IEEE: a build without fast math
        const float ds = rnd<T>(__fmul_rn(d[n][i], u[n][i]));
        du[i] = __fmul_rn(d[n][i], s);
        dg[i] = __fmul_rn(__fmul_rn(ds, sig), dsilu(x, sig));
      }
      store_unit<T, V>(static_cast<T*>(a.h) + it * V, dg);
      store_unit<T, V>(static_cast<T*>(a.du) + it * V, du);
    }
  }
}

template <typename T, int V>
const void* pick(bool bwd) {
  return bwd ? (const void*)swiglu_bwd_kernel<T, V> : (const void*)swiglu_fwd_kernel<T, V>;
}

const void* kernel_for(int mode, bool bwd) {
  const bool vector = mode & MODE_VECTOR, bf16 = mode & MODE_DTYPE;
  if (bf16) return vector ? pick<__nv_bfloat16, 8>(bwd) : pick<__nv_bfloat16, 1>(bwd);
  return vector ? pick<float, 4>(bwd) : pick<float, 1>(bwd);
}

// Blocks a grid: one a THREADS units up to the card's residency for the
// kernel (SMs × blocks an SM, each kernel's read once), so a small call
// spreads its units over threads and a large one runs one wave that
// strides NI units in flight a thread.
cudaError_t grid_for(int mode, bool bwd, int dev, long long units, int* blocks) {
  static int per_sm[8];            // by bwd, bf16, vector; 0 until read
  int& r = per_sm[(bwd ? 4 : 0) | (mode & (MODE_VECTOR | MODE_DTYPE))];
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && !r) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel_for(mode, bwd), THREADS, 0);
    r = n > 0 ? n : 1;
  }
  if (err != cudaSuccess) return err;
  const long long want = (units + THREADS - 1) / THREADS, most = static_cast<long long>(sms) * r;
  *blocks = static_cast<int>(want < most ? want : most);
  return cudaSuccess;
}

int launch(int mode, bool bwd, Args& a, long long rows, long long cols, void* stream) {
  const bool vector = mode & MODE_VECTOR, bf16 = mode & MODE_DTYPE;
  const int esize = bf16 ? 2 : 4, v = vector ? 16 / esize : 1;
  if (rows < 0 || cols < 0 || cols % v != 0 || cols / v > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return cudaSuccess;
  if (!a.g || !a.u || !a.h || (bwd && (!a.dh || !a.du))) return cudaErrorInvalidValue;
  if (vector) {
    if (!aligned16(a.g) || !aligned16(a.u) || !aligned16(a.h) ||
        (bwd && (!aligned16(a.dh) || !aligned16(a.du))))
      return cudaErrorInvalidValue;
    if ((a.gs * esize) % 16 || (a.us * esize) % 16 || (bwd && (a.hs * esize) % 16))
      return cudaErrorInvalidValue;
  }
  a.upr = static_cast<int>(cols / v);
  a.units = rows * a.upr;
  a.flat = a.gs == cols && a.us == cols && (!bwd || a.hs == cols);
  const int dev = mode >> MODE_DEVICE_SHIFT;
  OnDevice on(dev);
  int blocks = 0;
  cudaError_t err = grid_for(mode, bwd, dev, a.units, &blocks);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  err = cudaLaunchKernel(kernel_for(mode, bwd), dim3(blocks), dim3(THREADS), params, 0,
                         static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// h = silu(g) · u. mode: bit 0 the vector route, bit 1 bf16 (else f32), the
// device from bit 8. g and u (rows, cols) at row strides gs and us in
// elements, the last dim contiguous; h contiguous.
extern "C" int swiglu_fwd(int mode, const void* g, const void* u, void* h, long long rows,
                          long long cols, long long gs, long long us, void* stream) {
  Args a = {};
  a.g = g; a.u = u; a.h = h; a.gs = gs; a.us = us;
  return launch(mode, false, a, rows, cols, stream);
}

// dg and du for h's gradient dh: the mode and layouts as swiglu_fwd's, dh at
// row stride hs; dg and du contiguous.
extern "C" int swiglu_bwd(int mode, const void* g, const void* u, const void* dh, void* dg,
                          void* du, long long rows, long long cols, long long gs, long long us,
                          long long hs, void* stream) {
  Args a = {};
  a.g = g; a.u = u; a.dh = dh; a.h = dg; a.du = du; a.gs = gs; a.us = us; a.hs = hs;
  return launch(mode, true, a, rows, cols, stream);
}

// The registers a thread and the local memory (stack frame, spills
// included) of the forward (bwd 0) or adjoint kernel for mode's dtype and
// route, from the runtime.
extern "C" int swiglu_attributes(int mode, int bwd, int* regs, int* local_bytes) {
  if (!regs || !local_bytes) return cudaErrorInvalidValue;
  OnDevice on(mode >> MODE_DEVICE_SHIFT);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel_for(mode, bwd != 0));
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return err;
}

extern "C" const char* swiglu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
