// AdamW's update over a list of tensors in one pass (sm_90a), CUDA C++: B3.
//
// Replaces no Pallas kernel. It stands for what XLA makes of the
// reference's AdamW update (`upd` in `adamw`, src/repro/train/optimizer.py:72)
// when the reference's train step runs under `jax.jit`: one fused pass over
// p, g, m and v instead of the eager chain of elementwise ops. Per element,
// in f32, every step rounded on its own (`__fmul_rn`, `__fadd_rn`,
// `__fdiv_rn`, `__fsqrt_rn`: nvcc's default `-fmad=true` would contract a
// product and a sum into one fma):
//
//   m'    = b1*m + (1-b1)*g
//   v'    = b2*v + ((1-b2)*g)*g
//   den   = sqrt(v'/bc2) + eps
//   delta = (m'/bc1)/den + wd*p
//   p'    = p - lr*delta, rounded to p's dtype (bf16 to nearest even)
//
// which is what PyTorch's eager ops on the card compute for the plain
// version (`adamw_update_plain`): a Python scalar enters as its f32
// rounding, the division by the 0-dim tensors bc1 and bc2 is IEEE, and the
// bias corrections are read from those device tensors, never from the
// host. So p, m and v equal the plain version's bit for bit.
//
// What bounds it on this card: bytes. Each element reads p and g (2 B each
// in bf16, 4 B in f32) and m and v (4 B each) and writes p, m and v: 22 B
// an element for bf16 parameters, 28 B for f32, against ~15 f32 operations.
// phi4-mini-3.8b's 4,450,615,296 parameters move 97.9 GB: 29.2 ms at
// 3.35 TB/s. What the design does about it:
// * one launch takes up to MAX_TENSORS tensors of one dtype; their pointers,
//   sizes and the prefix of their work units travel in the kernel's
//   parameters (up to 32,764 bytes since CUDA 12.1), so nothing is copied to
//   the device before a launch and nothing synchronises;
// * a work unit is NTHREADS x VEC x ILP elements of one tensor; the blocks
//   walk the units of the whole list with a grid stride, so a large tensor
//   and a small one cost the same per element; the grid is two waves of
//   the blocks the card holds at once;
// * each thread moves 16 bytes of p and of g at a time (8 bf16 or 4 f32)
//   and the matching 32 or 16 bytes of m and v, ILP vectors in flight, when
//   the tensor's four pointers are 16-byte aligned; the unit's ragged end
//   and any tensor that is not aligned go element by element;
// * g is read once, so it is loaded with the streaming hint (`__ldcs`);
// * no shared memory, no tensor cores: there is no reuse to stage.
//
// Entry point: `adamw_update`, a plain C function that launches on the
// given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int ILP = 4;              // vectors in flight per thread
constexpr int MAX_TENSORS = 640;    // tensors per launch
constexpr int WAVES = 2;

struct Consts {
  float lr, b1, omb1, b2, omb2, eps, wd;   // omb1 = f32(1 - b1), omb2 = f32(1 - b2)
};

struct TensorList {
  const float* bc1;                       // 0-dim f32 on the device: 1 - b1**t
  const float* bc2;                       // 1 - b2**t
  Consts c;
  int count;
  int64_t unit_start[MAX_TENSORS + 1];    // tensor i owns units [unit_start[i], unit_start[i+1])
  void* p[MAX_TENSORS];
  const void* g[MAX_TENSORS];
  float* m[MAX_TENSORS];
  float* v[MAX_TENSORS];
  int64_t n[MAX_TENSORS];
};
static_assert(sizeof(TensorList) == 30776, "the binding's LIST_BYTES");
static_assert(sizeof(TensorList) <= 32764, "kernel parameters are limited to 32,764 bytes");

template <typename T> struct Traits;

template <> struct Traits<float> {
  static constexpr int VEC = 4;           // elements in 16 bytes of p
  __device__ static float get(const uint4& r, int e) { return __uint_as_float((&r.x)[e]); }
  __device__ static void put(uint4& r, int e, float x) { (&r.x)[e] = __float_as_uint(x); }
  __device__ static float load(const void* p, int64_t i) { return static_cast<const float*>(p)[i]; }
  __device__ static float load_cs(const void* p, int64_t i) {
    return __ldcs(static_cast<const float*>(p) + i);
  }
  __device__ static void store(void* p, int64_t i, float x) { static_cast<float*>(p)[i] = x; }
};

template <> struct Traits<__nv_bfloat16> {
  static constexpr int VEC = 8;
  // element e of 8 bf16 in a uint4: the low half of word e/2 for even e
  __device__ static float get(const uint4& r, int e) {
    const uint32_t w = (&r.x)[e / 2];
    return __uint_as_float(e % 2 ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ static void put(uint4& r, int e, float x) {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(x));
    uint32_t& w = (&r.x)[e / 2];
    w = e % 2 ? ((w & 0x0000ffffu) | (b << 16)) : ((w & 0xffff0000u) | b);
  }
  __device__ static float load(const void* p, int64_t i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  __device__ static float load_cs(const void* p, int64_t i) {
    const unsigned short b = __ldcs(static_cast<const unsigned short*>(p) + i);
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  __device__ static void store(void* p, int64_t i, float x) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  }
};

// one element, in place: the plain version's ops in its order
__device__ __forceinline__ void adamw_step(float& p, float g, float& m, float& v, float bc1,
                                           float bc2, const Consts& c) {
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(__fmul_rn(c.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), c.eps);
  const float delta = __fadd_rn(__fdiv_rn(__fdiv_rn(m, bc1), den), __fmul_rn(c.wd, p));
  p = __fsub_rn(p, __fmul_rn(c.lr, delta));
}

template <typename T>
__device__ __forceinline__ void scalar_range(const TensorList& list, int t, int64_t from,
                                             int64_t to, float bc1, float bc2) {
  using Tr = Traits<T>;
  for (int64_t i = from + threadIdx.x; i < to; i += NTHREADS) {
    float p = Tr::load(list.p[t], i), m = list.m[t][i], v = list.v[t][i];
    adamw_step(p, Tr::load_cs(list.g[t], i), m, v, bc1, bc2, list.c);
    Tr::store(list.p[t], i, p);
    list.m[t][i] = m;
    list.v[t][i] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) adamw_kernel(const __grid_constant__ TensorList list) {
  using Tr = Traits<T>;
  constexpr int VEC = Tr::VEC;
  constexpr int MV = VEC / 4;             // float4s of m (and of v) per vector
  constexpr int64_t UNIT = int64_t(NTHREADS) * VEC * ILP;
  const float bc1 = *list.bc1, bc2 = *list.bc2;
  const int64_t units = list.unit_start[list.count];
  int t = 0;
  for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
    while (u >= list.unit_start[t + 1]) ++t;   // units rise, so t only moves forward
    const int64_t begin = (u - list.unit_start[t]) * UNIT;
    const int64_t end = begin + UNIT < list.n[t] ? begin + UNIT : list.n[t];
    const bool aligned = ((reinterpret_cast<uintptr_t>(list.p[t]) |
                           reinterpret_cast<uintptr_t>(list.g[t]) |
                           reinterpret_cast<uintptr_t>(list.m[t]) |
                           reinterpret_cast<uintptr_t>(list.v[t])) & 15) == 0;
    if (!aligned) {
      scalar_range<T>(list, t, begin, end, bc1, bc2);
      continue;
    }
    const int64_t nvec = (end - begin) / VEC;   // whole vectors; begin is a multiple of VEC
    uint4* p = reinterpret_cast<uint4*>(static_cast<T*>(list.p[t]) + begin);
    const uint4* g = reinterpret_cast<const uint4*>(static_cast<const T*>(list.g[t]) + begin);
    float4* m = reinterpret_cast<float4*>(list.m[t] + begin);
    float4* v = reinterpret_cast<float4*>(list.v[t] + begin);
    uint4 pr[ILP], gr[ILP];
    float4 mr[ILP][MV], vr[ILP][MV];
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const int64_t j = threadIdx.x + k * NTHREADS;
      if (j < nvec) {
        pr[k] = p[j];
        gr[k] = __ldcs(g + j);
#pragma unroll
        for (int h = 0; h < MV; ++h) {
          mr[k][h] = m[j * MV + h];
          vr[k][h] = v[j * MV + h];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const int64_t j = threadIdx.x + k * NTHREADS;
      if (j < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float pe = Tr::get(pr[k], e);
          float& me = (&mr[k][e / 4].x)[e % 4];
          float& ve = (&vr[k][e / 4].x)[e % 4];
          adamw_step(pe, Tr::get(gr[k], e), me, ve, bc1, bc2, list.c);
          Tr::put(pr[k], e, pe);
        }
        p[j] = pr[k];
#pragma unroll
        for (int h = 0; h < MV; ++h) {
          m[j * MV + h] = mr[k][h];
          v[j * MV + h] = vr[k][h];
        }
      }
    }
    scalar_range<T>(list, t, begin + nvec * VEC, end, bc1, bc2);
  }
}

// elements a work unit, for dtype 0 (f32 p and g) or 1 (bf16)
constexpr int64_t unit_of(int dtype) { return int64_t(NTHREADS) * ILP * (dtype == 1 ? 8 : 4); }

template <typename T>
int launch(const TensorList& list, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adamw_kernel<T>, NTHREADS, 0);
  if (err != cudaSuccess) return err;
  const int64_t units = list.unit_start[list.count];
  if (units == 0) return cudaSuccess;
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = units < WAVES * wave ? units : WAVES * wave;
  adamw_kernel<T><<<static_cast<unsigned>(blocks), NTHREADS, 0, stream>>>(list);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: p and g f32; 1: p and g bf16. m and v are f32. `unit_start` has
// count + 1 entries, from 0, tensor i owning ceil(n[i] / unit) units
// (`adamw_unit`). consts: lr, b1, 1-b1, b2, 1-b2, eps, weight decay, each
// already rounded to f32.
extern "C" int adamw_update(int dtype, int count, void* const* p, void* const* g,
                            void* const* m, void* const* v, const int64_t* n,
                            const int64_t* unit_start, const void* bc1, const void* bc2,
                            const float* consts, void* stream) {
  if (count < 1 || count > MAX_TENSORS || bc1 == nullptr || bc2 == nullptr || unit_start[0] != 0)
    return cudaErrorInvalidValue;
  const int64_t unit = unit_of(dtype);
  static thread_local TensorList list;    // 30 KB: off the caller's stack
  list.bc1 = static_cast<const float*>(bc1);
  list.bc2 = static_cast<const float*>(bc2);
  list.c = Consts{consts[0], consts[1], consts[2], consts[3], consts[4], consts[5], consts[6]};
  list.count = count;
  list.unit_start[0] = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 0 || unit_start[i + 1] - unit_start[i] != (n[i] + unit - 1) / unit ||
        (n[i] > 0 && (!p[i] || !g[i] || !m[i] || !v[i])))
      return cudaErrorInvalidValue;
    list.p[i] = p[i];
    list.g[i] = g[i];
    list.m[i] = static_cast<float*>(m[i]);
    list.v[i] = static_cast<float*>(v[i]);
    list.n[i] = n[i];
    list.unit_start[i + 1] = unit_start[i + 1];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(list, st);
    case 1: return launch<__nv_bfloat16>(list, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int adamw_max_tensors() { return MAX_TENSORS; }

extern "C" long long adamw_list_bytes() { return sizeof(TensorList); }

extern "C" long long adamw_unit(int dtype) { return unit_of(dtype); }

extern "C" const char* adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
