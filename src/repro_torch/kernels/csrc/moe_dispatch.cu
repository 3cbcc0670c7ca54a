// The MoE layer's dispatch and combine (sm_90a), CUDA C++: B2.
//
// Replaces no Pallas kernel. The two kernels stand for what XLA makes of
// the reference's sort dispatch in `moe_ffn` (src/repro/models/moe.py:67):
//
// * moe_fill_kernel, the buffer's scatter (:108-110),
//   `zeros((E, C+1, D)).at[sorted_expert, slot].set(x[sorted_token])[:, :C]`:
//   one pass writes every row of the (E, C, D) buffer, row (e, c) from
//   `rows[src[e, c]]`, or zeros where `src[e, c]` is the sentinel `fill`
//   (= the number of rows). It takes the place of the zeros, the gather,
//   the index_put and the waste slot C;
// * moe_combine_kernel, the combine's gather-scale-mask and scatter-add
//   (:121-124): token t's output row is the sum of its k assignments'
//   `y[e, slot] * gate`, added as the plain version (`moe_combine_plain`)
//   adds them: the gate rounded to y's dtype, each product rounded, a
//   dropped assignment the +0.0 of the `where` that still takes part in the
//   sum (the sign of a zero sum depends on it), the partial sums in
//   ascending sorted position (ascending expert id), each sum rounded. bf16
//   works through f32 with `__float2bfloat16_rn` after every op; f32 uses
//   `__fmul_rn` and `__fadd_rn`, so that nvcc contracts nothing into an fma.
//   No atomics: one warp writes each piece of a token's row. So the output
//   equals the plain version's bit for bit.
//
// The combine reads the plan as the sort dispatch left it: its sorted
// entries (expert, slot, keep, gate) and, built by torch ops, `inverse`,
// the argsort's inverse permutation, so that token t's k assignments sit
// at sorted positions inverse[t*k .. t*k+k-1]. A warp puts them in
// ascending order itself.
//
// What bounds both on this card: bytes. They are copies with a multiply
// and an add; neither does an operation a byte worth counting.
// * fill: write E*C*D elements, read each referenced row of `rows` once:
//   olmoe-1b-7b's prefill (T 4096, E 64, C 640, D 2048, bf16) writes
//   167.8 MB and reads x's 16.8 MB, 0.055 ms at 3.35 TB/s. A token's row is
//   read by up to k slots; at olmoe's prefill x fits the 50 MB L2, so the
//   repeats should hit it. kimi-k2's x (T 4096, D 7168) is 58.7 MB and does
//   not fit: its repeats go back to device memory;
// * combine: read each kept assignment's row of y and the plan's T*k
//   entries once and write T*D: at most T*k*D elements read (134.2 MB at
//   olmoe's prefill) and 16.8 MB written, 0.045 ms.
// What the design does about it: a warp a slot row (fill) or a chunk of
// 32 x ILP units of a token's row (combine), a grid stride over them; each
// lane moves 16 bytes at a time (8 bf16 or 4 f32) where D and the pointers
// allow (`vector`), ILP of them in flight from a row, of JB rows at once in
// the combine; any other D takes an element at a time (`scalar`), the same
// arithmetic. The fill streams its stores (`__stcs`): the buffer is not
// read again before it leaves the L2, the rows are. Splitting a token's
// row into chunks gives decode's few tokens several warps each. No shared
// memory and no tensor cores: nothing is reused within a block.
//
// Entry points: `moe_fill` and `moe_combine`, plain C functions that
// launch on the given stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int WARPS = NTHREADS / 32;
constexpr int ILP = 4;                  // units of a row in flight a lane
constexpr int JB = 2;                   // rows in flight at once (combine)
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_K = 32;               // a token's assignments, one a lane

template <typename T> struct Traits;

template <> struct Traits<float> {
  static constexpr int VEC = 4;
  __device__ static float get(const uint4& r, int e) { return __uint_as_float((&r.x)[e]); }
  __device__ static void put(uint4& r, int e, float x) { (&r.x)[e] = __float_as_uint(x); }
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float x) { *p = x; }
  __device__ static float round(float x) { return x; }
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
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

// ---------------------------------------------------------------------------
// fill: a byte copy, so one kernel serves both dtypes; U is the unit a lane
// moves (uint4: 16 bytes; uint16_t or uint32_t: one element)
// ---------------------------------------------------------------------------

template <typename U>
__global__ void __launch_bounds__(NTHREADS)
moe_fill_kernel(const U* __restrict__ rows, const int32_t* __restrict__ src, U* __restrict__ out,
                int64_t slots, int64_t n_rows, int64_t units) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = int64_t(gridDim.x) * WARPS;
  for (int64_t r = int64_t(blockIdx.x) * WARPS + threadIdx.x / 32; r < slots; r += stride) {
    const int32_t s = src[r];
    U* o = out + r * units;
    if (s == n_rows) {                  // the sentinel: an empty slot
      for (int64_t j = lane; j < units; j += 32) __stcs(o + j, U{});
      continue;
    }
    if (s < 0 || s > n_rows) __trap();  // as an index kernel's device assert
    const U* in = rows + int64_t(s) * units;
    for (int64_t j = lane; j < units; j += 32 * ILP) {
      U v[ILP];
#pragma unroll
      for (int u = 0; u < ILP; ++u)
        if (j + u * 32 < units) v[u] = in[j + u * 32];
#pragma unroll
      for (int u = 0; u < ILP; ++u)
        if (j + u * 32 < units) __stcs(o + j + u * 32, v[u]);
    }
  }
}

// ---------------------------------------------------------------------------
// combine
// ---------------------------------------------------------------------------

// Adds v into acc as the plain version does: the first term as it is, each
// later one by a rounded sum.
template <typename T>
__device__ __forceinline__ float accumulate(float acc, float v, bool first) {
  return first ? v : Traits<T>::round(__fadd_rn(acc, v));
}

// The gated contribution of y element yv: the product rounded to T, or the
// +0.0 of a dropped assignment.
template <typename T>
__device__ __forceinline__ float contribution(float yv, float g, bool kept) {
  return kept ? Traits<T>::round(__fmul_rn(yv, g)) : 0.0f;
}

// What a lane moves of a row of y: 16 bytes (VECTOR) or one element.
template <typename T, bool VECTOR> struct Unit;

template <typename T> struct Unit<T, true> {
  static constexpr int N = Traits<T>::VEC;
  uint4 raw = {};
  __device__ void load(const T* row, int64_t u) { raw = reinterpret_cast<const uint4*>(row)[u]; }
  __device__ float get(int e) const { return Traits<T>::get(raw, e); }
  __device__ static void store(T* row, int64_t u, const float (&x)[N]) {
    uint4 w;
#pragma unroll
    for (int e = 0; e < N; ++e) Traits<T>::put(w, e, x[e]);
    reinterpret_cast<uint4*>(row)[u] = w;
  }
};

template <typename T> struct Unit<T, false> {
  static constexpr int N = 1;
  float raw = 0.0f;
  __device__ void load(const T* row, int64_t u) { raw = Traits<T>::load(row + u); }
  __device__ float get(int) const { return raw; }
  __device__ static void store(T* row, int64_t u, const float (&x)[1]) {
    Traits<T>::store(row + u, x[0]);
  }
};

// A work item is one chunk of a token's output row, CHUNK = 32 x ILP
// units, a warp an item: lane l takes units l, l+32, l+64, l+96 of the
// chunk. The warp reads the token's k sorted positions (`inverse`, the
// argsort's inverse permutation, at t*k .. t*k+k-1) and the plan's entries
// at them, one assignment a lane, and orders them by position (ranks by
// shuffles: the positions are distinct). Then it walks them in that order,
// JB rows at a time: each lane loads its ILP units of each row (the warp
// 2 KB contiguous of a bf16 row), and adds their gated contributions.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(NTHREADS)
moe_combine_kernel(const T* __restrict__ y, const int64_t* __restrict__ inverse,
                   const int64_t* __restrict__ expert, const int64_t* __restrict__ slot,
                   const bool* __restrict__ keep, const float* __restrict__ gate,
                   T* __restrict__ out, int64_t tokens, int k, int64_t d, int64_t experts,
                   int64_t cap) {
  using U = Unit<T, VECTOR>;
  constexpr int N = U::N;
  const int lane = threadIdx.x & 31;
  const int64_t units = d / N;
  const int64_t chunks = (units + 32 * ILP - 1) / (32 * ILP);
  const int64_t n = tokens * k;
  const int64_t stride = int64_t(gridDim.x) * WARPS;
  for (int64_t item = int64_t(blockIdx.x) * WARPS + threadIdx.x / 32; item < tokens * chunks;
       item += stride) {
    const int64_t t = item / chunks;
    const int64_t base = (item - t * chunks) * 32 * ILP + lane;
    int64_t p = INT64_MAX;
    int32_t row = -1;
    float g = 0.0f;
    if (lane < k) {
      p = inverse[t * k + lane];
      if (p < 0 || p >= n) __trap();
      if (keep[p]) {
        const int64_t e = expert[p], s = slot[p];
        if (e < 0 || e >= experts || s < 0 || s >= cap) __trap();
        row = static_cast<int32_t>(e * cap + s);
      }
      g = Traits<T>::round(gate[p]);
    }
    // every lane runs the shuffles: k is the same across the warp
    int rank = 0;
    for (int l = 0; l < k; ++l) rank += __shfl_sync(FULL, p, l) < p;
    int src = 0;
    for (int l = 0; l < k; ++l) src = __shfl_sync(FULL, rank, l) == lane ? l : src;
    row = __shfl_sync(FULL, row, src);     // lane j < k: the j-th in sorted position
    g = __shfl_sync(FULL, g, src);
    float acc[ILP][N] = {};
    for (int j0 = 0; j0 < k; j0 += JB) {
      U v[JB][ILP];
      int32_t r[JB];
      float gj[JB];
#pragma unroll
      for (int b = 0; b < JB; ++b) {
        r[b] = __shfl_sync(FULL, row, (j0 + b) & 31);
        gj[b] = __shfl_sync(FULL, g, (j0 + b) & 31);
        if (j0 + b < k && r[b] >= 0) {
          const T* in = y + int64_t(r[b]) * d;
#pragma unroll
          for (int i = 0; i < ILP; ++i)
            if (base + i * 32 < units) v[b][i].load(in, base + i * 32);
        }
      }
#pragma unroll
      for (int b = 0; b < JB; ++b) {
        if (j0 + b < k) {
#pragma unroll
          for (int i = 0; i < ILP; ++i)
#pragma unroll
            for (int e = 0; e < N; ++e)
              acc[i][e] = accumulate<T>(acc[i][e],
                                        contribution<T>(v[b][i].get(e), gj[b], r[b] >= 0),
                                        j0 + b == 0);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ILP; ++i)
      if (base + i * 32 < units) U::store(out + t * d, base + i * 32, acc[i]);
  }
}

// blocks for `items` warps' work: one warp an item, capped at 32 waves of
// full blocks (a grid stride covers the rest)
int grid_for(int64_t items) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    sms = 132;
  const int64_t want = (items + WARPS - 1) / WARPS;
  const int64_t cap = int64_t(sms) * 32;
  return static_cast<int>(want < cap ? want : cap);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype 0: f32, 1: bf16. vector 1: 16-byte vectors (D a multiple of 16
// bytes' elements, rows and out 16-byte aligned), 0: an element at a time.
// src (slots,) int32, each a row of `rows` (n_rows, D) or n_rows for zeros.
extern "C" int moe_fill(int dtype, int vector, const void* rows, const int32_t* src, void* out,
                        long long slots, long long n_rows, long long d, void* stream) {
  if ((dtype != 0 && dtype != 1) || slots < 0 || n_rows < 0 || d < 0 ||
      (slots > 0 && (src == nullptr || out == nullptr)) || n_rows > INT32_MAX)
    return cudaErrorInvalidValue;
  if (slots == 0 || d == 0) return cudaSuccess;
  const int64_t bytes = d * (dtype == 0 ? 4 : 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(slots);
  if (vector) {
    if (bytes % 16 != 0 || !aligned16(rows) || !aligned16(out)) return cudaErrorInvalidValue;
    moe_fill_kernel<uint4><<<blocks, NTHREADS, 0, st>>>(
        static_cast<const uint4*>(rows), src, static_cast<uint4*>(out), slots, n_rows, bytes / 16);
  } else if (dtype == 0) {
    moe_fill_kernel<uint32_t><<<blocks, NTHREADS, 0, st>>>(
        static_cast<const uint32_t*>(rows), src, static_cast<uint32_t*>(out), slots, n_rows, d);
  } else {
    moe_fill_kernel<uint16_t><<<blocks, NTHREADS, 0, st>>>(
        static_cast<const uint16_t*>(rows), src, static_cast<uint16_t*>(out), slots, n_rows, d);
  }
  return cudaGetLastError();
}

// y (experts, cap, D) in dtype; inverse, expert, slot (tokens*k,) int64, keep
// bool and gate f32: the inverse of the plan's argsort and the plan's
// sorted entries; out (tokens, D) in dtype.
extern "C" int moe_combine(int dtype, int vector, const void* y, const int64_t* inverse,
                           const int64_t* expert, const int64_t* slot, const bool* keep,
                           const float* gate, void* out, long long tokens, int k, long long d,
                           long long experts, long long cap, void* stream) {
  if ((dtype != 0 && dtype != 1) || tokens < 0 || d < 0 || experts < 0 || cap < 0 || k < 1 ||
      k > MAX_K || experts * cap > INT32_MAX ||
      (tokens > 0 && (!inverse || !expert || !slot || !keep || !gate || !out)))
    return cudaErrorInvalidValue;
  if (tokens == 0 || d == 0) return cudaSuccess;
  const int64_t bytes = d * (dtype == 0 ? 4 : 2);
  if (vector && (bytes % 16 != 0 || !aligned16(y) || !aligned16(out)))
    return cudaErrorInvalidValue;
  const int64_t units = vector ? bytes / 16 : d;
  const int blocks = grid_for(tokens * ((units + 32 * ILP - 1) / (32 * ILP)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define B2_COMBINE(T, V)                                                                    \
  moe_combine_kernel<T, V><<<blocks, NTHREADS, 0, st>>>(                                     \
      static_cast<const T*>(y), inverse, expert, slot, keep, gate, static_cast<T*>(out),    \
      tokens, k, d, experts, cap)
  if (dtype == 0) {
    if (vector) B2_COMBINE(float, true); else B2_COMBINE(float, false);
  } else {
    if (vector) B2_COMBINE(__nv_bfloat16, true); else B2_COMBINE(__nv_bfloat16, false);
  }
#undef B2_COMBINE
  return cudaGetLastError();
}

extern "C" const char* moe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
