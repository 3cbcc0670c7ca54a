// The training loss, softmax cross-entropy over the vocabulary, forward and
// adjoint (sm_90a), CUDA C++: B6.
//
// Replaces no Pallas kernel. The kernels stand for what XLA fuses under the
// reference's `jax.jit` out of `cross_entropy_loss`
// (src/repro/train/loop.py:41): the f32 cast of the logits, `log_softmax`,
// the label's `take_along_axis` and the mean, and their autodiff inside the
// jitted step's `jax.value_and_grad`. The port's eager chain
// (kernels/cross_entropy.py `cross_entropy_plain`) writes an f32 copy of the
// (rows, V) logits and an f32 log-softmax, which autograd keeps; its
// backward makes an f32 one-hot scatter, an f32 gradient and a cast.
//
// * `ce_fwd_kernel`: a block a row. Its threads read the row once in
//   16-byte units (8 bf16 or 4 f32; the `vector` route, where the width and
//   every row start are whole units) or element by element (`scalar`), four
//   units in flight a thread, and keep an online max m and sum s of
//   exp(x - m) in f32 (exp by `ex2.approx` of x·log2(e) - m·log2(e), one
//   fma); the block combines the threads' (m, s) in a fixed order (xor
//   shuffles, then the warps in order) and writes the row's
//   lse = m + logf(s) and nll = lse - x[label], both f32. The loss is the
//   mean of the rows' nll, taken by `torch.mean` in the wrapper: one small
//   launch, deterministic, where a fixed-order sum in this kernel would need
//   a second pass or a last-block ticket.
// * `ce_bwd_kernel`: a block a chunk of 1024 units of a row. Each element's
//   gradient is (exp(x - lse) - [j == label]) · (g / rows), with g the
//   loss's gradient read on the device: the subtraction, `expf` (the precise
//   one: built without `--use_fast_math`, so the same function as PyTorch's
//   `torch.exp`), the one-hot subtraction and the product each rounded on
//   its own (`__fsub_rn`, `__fmul_rn`), and the result rounded once to the
//   logits' dtype: the plain adjoint's (`cross_entropy_bwd_plain`) eager
//   ops, so the two agree bit for bit at the same lse.
// Labels are taken to lie in [0, V) (the data makes them so; the wrapper
// makes no device sync to check): a label outside gives the row a NaN nll,
// and no element of it the one-hot term, where the plain chain's gather
// raises.
//
// What bounds both on this card: bytes. phi4-mini-3.8b's training batch,
// 4 x 1024 rows of 200,064 bf16 logits: the forward reads them once,
// 1.639 GB, 0.489 ms at 3.35 TB/s; the adjoint reads them and writes their
// gradient, 3.278 GB, 0.979 ms. Per element the forward does an fma, an
// ex2 and an add, the adjoint the precise expf (~10 instructions) and two
// rounded ops: under the bytes at the H100's 67 TFLOP/s of f32. What the
// design does about it: one read of the logits a pass in whole 16-byte
// units, four in flight a thread (the forward's 256-thread block holds 64
// B of loads a thread in flight, 2048 threads an SM); nothing of size V
// is written but the gradient, and nothing kept for the backward but the
// rows' lse.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int MODE_VECTOR = 1, MODE_DTYPE = 2, MODE_DEVICE_SHIFT = 8;
constexpr int THREADS = 256;       // a block of either kernel
constexpr int UNROLL = 4;          // units a thread has in flight
constexpr int BWD_UNITS = THREADS * UNROLL;   // units a block of the adjoint
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

struct FwdArgs {
  const void* x;
  const long long* labels;
  float* lse;
  float* nll;
  long long V, row_stride, label_stride;
};

struct BwdArgs {
  const void* x;
  const long long* labels;
  const float* lse;
  const float* grad;
  void* dx;
  long long rows, V, row_stride, label_stride;
};

// (m, s) += E elements f: s rescaled where the max grows
template <int E>
__device__ __forceinline__ void absorb(const float* f, float& m, float& s) {
  float lm = f[0];
#pragma unroll
  for (int i = 1; i < E; ++i) lm = fmaxf(lm, f[i]);
  if (lm == -INFINITY) return;                 // every element -inf: adds nothing
  if (lm > m) {
    s *= ex2((m - lm) * LOG2E);
    m = lm;
  }
  const float mb = m * LOG2E;
#pragma unroll
  for (int i = 0; i < E; ++i) s += ex2(fmaf(f[i], LOG2E, -mb));
}

__device__ __forceinline__ void combine(float& m, float& s, float m2, float s2) {
  const float M = fmaxf(m, m2);
  if (M == -INFINITY) return;
  s = s * ex2((m - M) * LOG2E) + s2 * ex2((m2 - M) * LOG2E);
  m = M;
}

template <typename T>
__device__ __forceinline__ float element(const T* p) {
  float f;
  load_unit<T, 1>(p, &f);
  return f;
}

template <typename T, int E>
__global__ void __launch_bounds__(THREADS) ce_fwd_kernel(FwdArgs a) {
  const long long row = blockIdx.x;
  const T* xr = static_cast<const T*>(a.x) + row * a.row_stride;
  const long long units = a.V / E;
  float m = -INFINITY, s = 0.0f;
  for (long long base = threadIdx.x; base < units; base += THREADS * UNROLL) {
    float f[UNROLL][E];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long u = base + k * THREADS;
      if (u < units) load_unit<T, E>(xr + u * E, f[k]);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      if (base + k * THREADS < units) absorb<E>(f[k], m, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    combine(m, s, m2, s2);
  }
  __shared__ float wm[THREADS / 32], ws[THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    wm[warp] = m;
    ws[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = wm[0];
    s = ws[0];
    for (int w = 1; w < THREADS / 32; ++w) combine(m, s, wm[w], ws[w]);
    const float lse = m + logf(s);
    const long long label = a.labels[row * a.label_stride];
    const float xl = (label >= 0 && label < a.V) ? element<T>(xr + label) : NAN;
    a.lse[row] = lse;
    a.nll[row] = __fsub_rn(lse, xl);
  }
}

template <typename T, int E>
__global__ void __launch_bounds__(THREADS) ce_bwd_kernel(BwdArgs a) {
  const long long row = blockIdx.x;
  const T* xr = static_cast<const T*>(a.x) + row * a.row_stride;
  T* dr = static_cast<T*>(a.dx) + row * a.V;
  const long long units = a.V / E;
  const float scale = __fdiv_rn(*a.grad, static_cast<float>(a.rows));
  const float lse = a.lse[row];
  const long long label = a.labels[row * a.label_stride];
  const long long base = static_cast<long long>(blockIdx.y) * BWD_UNITS + threadIdx.x;
  float f[UNROLL][E];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const long long u = base + k * THREADS;
    if (u < units) load_unit<T, E>(xr + u * E, f[k]);
  }
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const long long u = base + k * THREADS;
    if (u >= units) continue;
    float o[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float p = expf(__fsub_rn(f[k][i], lse));
      o[i] = __fmul_rn(u * E + i == label ? __fsub_rn(p, 1.0f) : p, scale);
    }
    store_unit<T, E>(dr + u * E, o);
  }
}

template <typename T, int E>
const void* pick(bool bwd) {
  return bwd ? (const void*)ce_bwd_kernel<T, E> : (const void*)ce_fwd_kernel<T, E>;
}

// the kernel for mode's dtype and route, the forward or the adjoint
const void* kernel_for(int mode, bool bwd) {
  const bool vector = mode & MODE_VECTOR, bf16 = mode & MODE_DTYPE;
  if (bf16) return vector ? pick<__nv_bfloat16, 8>(bwd) : pick<__nv_bfloat16, 1>(bwd);
  return vector ? pick<float, 4>(bwd) : pick<float, 1>(bwd);
}

}  // namespace

// The forward. mode: bit 0 the vector route, bit 1 bf16 (else f32), the
// device from bit 8. x (rows, V) at row_stride elements apart, its last dim
// contiguous; labels int64 at label_stride; writes lse and nll (rows,) f32.
extern "C" int cross_entropy_fwd(int mode, const void* x, const long long* labels, float* lse,
                                 float* nll, long long rows, long long V, long long row_stride,
                                 long long label_stride, void* stream) {
  const bool vector = mode & MODE_VECTOR, bf16 = mode & MODE_DTYPE;
  const int esize = bf16 ? 2 : 4, e = vector ? 16 / esize : 1;
  if (rows < 0 || rows > 0x7fffffffLL || V < 1 || V % e != 0 || row_stride < V ||
      (rows > 0 && (!x || !labels || !lse || !nll)))
    return cudaErrorInvalidValue;
  if (vector && (!aligned16(x) || (row_stride * esize) % 16 != 0)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  FwdArgs a = {x, labels, lse, nll, V, row_stride, label_stride};
  OnDevice on(mode >> MODE_DEVICE_SHIFT);
  void* params[] = {&a};
  const cudaError_t err =
      cudaLaunchKernel(kernel_for(mode, false), dim3(static_cast<unsigned>(rows)), dim3(THREADS),
                       params, 0, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The adjoint. mode and x as the forward's; lse (rows,) f32 the forward's;
// grad the loss's gradient, one f32 on the device; writes dx (rows, V)
// contiguous in x's dtype.
extern "C" int cross_entropy_bwd(int mode, const void* x, const long long* labels,
                                 const float* lse, const float* grad, void* dx, long long rows,
                                 long long V, long long row_stride, long long label_stride,
                                 void* stream) {
  const bool vector = mode & MODE_VECTOR, bf16 = mode & MODE_DTYPE;
  const int esize = bf16 ? 2 : 4, e = vector ? 16 / esize : 1;
  if (rows < 0 || rows > 0x7fffffffLL || V < 1 || V % e != 0 || row_stride < V ||
      (rows > 0 && (!x || !labels || !lse || !grad || !dx)))
    return cudaErrorInvalidValue;
  if (vector && (!aligned16(x) || !aligned16(dx) || (row_stride * esize) % 16 != 0))
    return cudaErrorInvalidValue;
  const long long chunks = (V / e + BWD_UNITS - 1) / BWD_UNITS;
  if (chunks > 65535) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  BwdArgs a = {x, labels, lse, grad, dx, rows, V, row_stride, label_stride};
  OnDevice on(mode >> MODE_DEVICE_SHIFT);
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchKernel(
      kernel_for(mode, true), dim3(static_cast<unsigned>(rows), static_cast<unsigned>(chunks)),
      dim3(THREADS), params, 0, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The registers a thread and the local memory (stack frame, spills
// included) of the forward (bwd 0) or the adjoint (bwd 1) on mode's dtype
// and route, from the runtime.
extern "C" int cross_entropy_attributes(int mode, int bwd, int* regs, int* local_bytes) {
  if (!regs || !local_bytes) return cudaErrorInvalidValue;
  OnDevice on(mode >> MODE_DEVICE_SHIFT);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel_for(mode, bwd != 0));
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return err;
}

extern "C" const char* cross_entropy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
