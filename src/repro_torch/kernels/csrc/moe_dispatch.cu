// The MoE layer's dispatch and combine (sm_90a), CUDA C++: B2.
//
// Replaces no Pallas kernel. The kernels stand for what XLA makes of the
// reference's sort dispatch in `moe_ffn` (src/repro/models/moe.py:67):
//
// * the fill, the buffer's scatter (:108-110),
//   `zeros((E, C+1, D)).at[sorted_expert, slot].set(x[sorted_token])[:, :C]`:
//   one pass writes every row of the (E, C, D) buffer, token t's row of x
//   to each of its kept destinations and zeros to every slot past its
//   expert's kept count. It takes the place of the zeros, the gather, the
//   index_put and the waste slot C;
// * moe_combine_kernel, the combine's gather-scale-mask and scatter-add
//   (:121-124): token t's output row is the sum of its k assignments'
//   `y[e, slot] * gate`, added as the plain version (`moe_combine_plain`)
//   adds them: the gate rounded to y's dtype, each product rounded, a
//   dropped assignment the +0.0 of the `where` that still takes part in the
//   sum (the sign of a zero sum depends on it), the partial sums in
//   ascending expert id, each sum rounded. bf16 works through f32 with
//   `__float2bfloat16_rn` after every op; f32 uses `__fmul_rn` and
//   `__fadd_rn`, so that nvcc contracts nothing into an fma. No atomics:
//   one warp writes each piece of a token's row. So the output equals the
//   plain version's bit for bit.
//
// Both read one token-major route table, made once a layer by torch ops
// (`route_table` in models/moe.py): dest (T, k) int32, token t's j-th
// destination row `e * C + slot` of the buffer, or `-1 - e` where the
// assignment is dropped (the expert id kept, for the combine's order);
// kept (E,) int32, the slots of each expert that are filled (its first
// kept[e]: the count of its rows in dest, which the fill trusts); gate
// (T, k) f32.
//
// What bounds both on this card: bytes. They are copies with a multiply
// and an add; neither does an operation a byte worth counting.
// * fill: write E*C*D elements and read each token's row of x once:
//   kimi-k2's prefill (T 4096, E 384, C 107, D 7168, bf16) writes 589 MB
//   and reads x's 58.7 MB, 0.193 ms at 3.35 TB/s. x does not fit the 50 MB
//   L2, so a slot-major fill, which reads a token's row once for each of
//   its k slots, goes back to device memory for the repeats;
// * combine: read each kept assignment's row of y and the table's T*k
//   (dest, gate) pairs once and write T*D: at most T*k*D elements read
//   (134.2 MB at olmoe-1b-7b's prefill) and 16.8 MB written, 0.045 ms.
// What the design does about it:
// * the fill is token-major (`moe_fill_kernel`): a warp a token, lane j < k
//   holding its j-th destination; the warp reads the token's row once into
//   registers, 4 units a lane in flight (16 bytes on `vector`, one element
//   on `scalar`), and stores them to each kept destination, streamed
//   (`__stcs`). x is read once. The grid's warps first zero the empty
//   slots, streamed 16-byte stores of whole rows: each warp tests 32 slot
//   rows at once against `kept`, rows a grid's worth of warps apart, and
//   zeroes those past it. An expert's empty slots are one run of rows:
//   given to warps in runs of 32, jamba-1.5-large's 2048 empty rows of 16 KB
//   fall to the warps of 46 blocks, and the fill loses to `index_select`.
//   `examples/moe_fill_probe_torch.py` times this kernel against those runs
//   of 32 and against a bulk-copy design (the row staged in a shared-memory
//   ring by 1-D bulk copies and bulk-stored to its slots), which it keeps;
// * the combine: a warp a chunk of 32 x CILP units of a token's row (16
//   bytes, 8 bf16 or 4 f32, on `vector`, one element on `scalar`). Lane j < k
//   reads the token's j-th (dest, gate) pair (two 32-byte reads a token),
//   the warp ranks the k pairs by expert id (stable, by shuffles) and loads
//   its rows' units, JB rows in flight, before it adds them in that order:
//   16 units a lane in flight, 2 of each of 8 rows (k 5-8; olmoe, kimi-k2)
//   or 4 of each of 4 (k <= 4; jamba's 2), or 1 of each of 8 rows where the
//   tokens are few (decode's 4 tokens at D 2048 make 32 warps over 8 blocks
//   of 4 warps), so small calls spread over SMs. No shared memory: nothing
//   is reused within a block.
//
// The adjoints, for training (`MoeFillFn` and `MoeCombineFn` in
// kernels/moe_dispatch.py; XLA's autodiff of the same lines in the
// reference). Each equals its plain version (`moe_fill_bwd_plain`,
// `moe_combine_bwd_plain`) bit for bit, but for dgate's f32 order; no
// atomics: one warp writes each piece of an output.
// * moe_fill_bwd_kernel, the fill's adjoint, has the combine's shape (the
//   same ranking and loads, `combine_rows` with GATED false): token t's
//   gradient is the sum of its kept slots' rows of the buffer's gradient,
//   in f32 from +0.0 in ascending expert id, rounded once to the dtype; a
//   dropped route adds nothing. Bound by bytes: each kept route's row read,
//   T*D written and the table's dest: at olmoe-1b-7b's training shape (T
//   4096, k 8, E 64, C 640, D 2048, bf16) ~151 MB, 0.045 ms at 3.35 TB/s.
// * moe_combine_bwd_kernel, the combine's adjoint, has the fill's shape: a
//   warp a token reads grad_out's row once and, for each kept route, stores
//   grad_out * gate (the gate rounded to the dtype, the product rounded)
//   to the route's slot of dy and forms the route's dot with y's row (the
//   products rounded to the dtype, an f32 sum by lanes, then xor shuffles
//   in a fixed order), rounded to the dtype and widened to f32 as dgate; a
//   dropped route's dgate is 0. The empty slots of dy are zeroed first,
//   streamed, as the fill zeroes them. Bound by bytes: E*C*D written, the
//   kept routes' rows of y and T*D of grad_out read, the table read and
//   dgate written: ~319 MB at olmoe's training shape, 0.095 ms.
//
// Entry points: `moe_fill`, `moe_combine`, `moe_fill_bwd` and
// `moe_combine_bwd`, plain C functions that launch on the given stream of
// the given device and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

#include <algorithm>

namespace {

constexpr int FILL_THREADS = 256;
constexpr int FILL_WARPS = FILL_THREADS / 32;
constexpr int COMBINE_THREADS = 128;
constexpr int COMBINE_WARPS = COMBINE_THREADS / 32;
constexpr int ILP = 4;                  // units of a row in flight a lane (fill)
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_K = 32;               // a token's assignments, one a lane
constexpr int MAX_DEVICES = 64;

// An entry point's small arguments in one int (each argument of a ctypes
// call costs host time, and decode's calls are host-paced): bit 0 the
// route (1 for 16-byte units, 0 for an element at a time), bit 1 the dtype
// (0 f32, 1 bf16), bits 2-7 k, the bits from 8 the device.
constexpr int MODE_DTYPE_SHIFT = 1;
constexpr int MODE_K_SHIFT = 2;
constexpr int MODE_DEVICE_SHIFT = 8;

struct Mode {
  int vector, dtype, k, device;
  explicit Mode(int m)
      : vector(m & 1), dtype((m >> MODE_DTYPE_SHIFT) & 1), k((m >> MODE_K_SHIFT) & 63),
        device(m >> MODE_DEVICE_SHIFT) {}
};

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

// Zeroes the buffer's empty slots (row r = e * cap + c with c >= kept[e]):
// warp `w` of `warps` takes rows w, w + warps, w + 2 warps, ..., tests 32 of
// them at a time (one a lane) and zeroes the empty ones with the whole warp,
// streamed stores. The stride spreads an expert's empty tail, consecutive
// rows, over as many warps (and SMs) as it has rows.
template <typename U>
__device__ __forceinline__ void zero_empty_slots(U* __restrict__ out,
                                                 const int32_t* __restrict__ kept, int64_t slots,
                                                 int64_t cap, int64_t units, int64_t w,
                                                 int64_t warps, int lane) {
  for (int64_t first = w; first < slots; first += 32 * warps) {
    const int64_t r = first + lane * warps;
    bool empty = false;
    if (r < slots) {
      const int64_t e = r / cap;
      empty = r - e * cap >= kept[e];
    }
    for (unsigned m = __ballot_sync(FULL, empty); m; m &= m - 1) {
      U* o = out + (first + (__ffs(m) - 1) * warps) * units;
      for (int64_t j = lane; j < units; j += 32) __stcs(o + j, U{});
    }
  }
}

// A warp a token, lane j < k holding its j-th destination; ILP units of
// the row a lane in flight, each stored to every kept destination. The
// grid's warps first zero the empty slots.
template <typename U>
__global__ void __launch_bounds__(FILL_THREADS)
moe_fill_kernel(const U* __restrict__ rows, const int32_t* __restrict__ dest,
                const int32_t* __restrict__ kept, U* __restrict__ out, int64_t tokens, int k,
                int64_t slots, int64_t cap, int64_t units) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = int64_t(blockIdx.x) * FILL_WARPS + threadIdx.x / 32;
  const int64_t warps = int64_t(gridDim.x) * FILL_WARPS;
  zero_empty_slots(out, kept, slots, cap, units, warp, warps, lane);
  for (int64_t t = warp; t < tokens; t += warps) {
    const int32_t d = lane < k ? dest[t * k + lane] : -1;
    if (d >= slots) __trap();           // as an index kernel's device assert
    const unsigned live = __ballot_sync(FULL, d >= 0);
    const U* in = rows + t * units;
    // the same trip count on every lane: the shuffles below take the whole warp
    for (int64_t j0 = 0; j0 < units; j0 += 32 * ILP) {
      const int64_t j = j0 + lane;
      U v[ILP];
#pragma unroll
      for (int u = 0; u < ILP; ++u)
        if (j + u * 32 < units) v[u] = in[j + u * 32];
      for (unsigned m = live; m; m &= m - 1) {
        U* o = out + int64_t(__shfl_sync(FULL, d, __ffs(m) - 1)) * units + j;
#pragma unroll
        for (int u = 0; u < ILP; ++u)
          if (j + u * 32 < units) __stcs(o + u * 32, v[u]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// combine
// ---------------------------------------------------------------------------

// Adds v into acc. GATED (the combine), as moe_combine_plain does: the
// first term as it is, each later one by a rounded sum. Otherwise (the
// fill's adjoint, moe_fill_bwd_plain): an f32 sum from +0.0, rounded once
// at the store.
template <typename T, bool GATED>
__device__ __forceinline__ float accumulate(float acc, float v, bool first) {
  if (!GATED) return __fadd_rn(acc, v);
  return first ? v : Traits<T>::round(__fadd_rn(acc, v));
}

// A route's term of element yv: GATED, the product by the gate rounded to
// T; otherwise yv itself; the +0.0 of a dropped assignment either way
// (which leaves the adjoint's sum from +0.0 as it is).
template <typename T, bool GATED>
__device__ __forceinline__ float contribution(float yv, float g, bool kept) {
  if (!GATED) return kept ? yv : 0.0f;
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

// A work item is one chunk of a token's output row, CHUNK = 32 x CILP
// units, a warp an item: lane l takes units l, l+32, ... of the chunk.
// Lane j < k reads the token's j-th (dest, gate); the warp ranks them by
// expert id, ties by j (the plain version's stable order), so that lane r
// then holds the r-th. It walks them in that order, JB rows at a time:
// each lane loads its CILP units of each of the JB rows, then adds their
// gated contributions (GATED: the combine) or the rows themselves (the
// fill's adjoint, which reads no gate). CILP x JB units a lane are in
// flight.
template <typename T, bool VECTOR, int CILP, int JB, bool GATED>
__device__ __forceinline__ void combine_rows(const T* __restrict__ y,
                                             const int32_t* __restrict__ dest,
                                             const float* __restrict__ gate, T* __restrict__ out,
                                             int64_t tokens, int k, int64_t d, int64_t rows_y,
                                             int64_t cap, int64_t expert0) {
  using U = Unit<T, VECTOR>;
  constexpr int N = U::N;
  const int lane = threadIdx.x & 31;
  const int64_t units = d / N;
  const int64_t chunks = (units + 32 * CILP - 1) / (32 * CILP);
  const int64_t stride = int64_t(gridDim.x) * COMBINE_WARPS;
  for (int64_t item = int64_t(blockIdx.x) * COMBINE_WARPS + threadIdx.x / 32;
       item < tokens * chunks; item += stride) {
    const int64_t t = item / chunks;
    const int64_t base = (item - t * chunks) * 32 * CILP + lane;
    int32_t row = -1;
    int64_t key = INT64_MAX;            // the expert id; lanes >= k sort last
    float g = 0.0f;
    if (lane < k) {
      row = dest[t * k + lane];
      if (row >= rows_y) __trap();
      key = row >= 0 ? expert0 + row / cap : -1 - int64_t(row);
      if (GATED) g = Traits<T>::round(gate[t * k + lane]);
    }
    // every lane runs the shuffles: k is the same across the warp
    int rank = 0;
    for (int l = 0; l < k; ++l) {
      const int64_t kl = __shfl_sync(FULL, key, l);
      rank += kl < key || (kl == key && l < lane);
    }
    int src = 0;
    for (int l = 0; l < k; ++l) src = __shfl_sync(FULL, rank, l) == lane ? l : src;
    row = __shfl_sync(FULL, row, src);     // lane j < k: the j-th in expert order
    g = __shfl_sync(FULL, g, src);
    float acc[CILP][N] = {};
    for (int j0 = 0; j0 < k; j0 += JB) {
      U v[JB][CILP];
      int32_t r[JB];
      float gj[JB];
#pragma unroll
      for (int b = 0; b < JB; ++b) {
        r[b] = __shfl_sync(FULL, row, (j0 + b) & 31);
        gj[b] = __shfl_sync(FULL, g, (j0 + b) & 31);
        if (j0 + b < k && r[b] >= 0) {
          const T* in = y + int64_t(r[b]) * d;
#pragma unroll
          for (int i = 0; i < CILP; ++i)
            if (base + i * 32 < units) v[b][i].load(in, base + i * 32);
        }
      }
#pragma unroll
      for (int b = 0; b < JB; ++b) {
        if (j0 + b < k) {
#pragma unroll
          for (int i = 0; i < CILP; ++i)
#pragma unroll
            for (int e = 0; e < N; ++e)
              acc[i][e] = accumulate<T, GATED>(
                  acc[i][e], contribution<T, GATED>(v[b][i].get(e), gj[b], r[b] >= 0),
                  j0 + b == 0);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < CILP; ++i)
      if (base + i * 32 < units) U::store(out + t * d, base + i * 32, acc[i]);
  }
}

template <typename T, bool VECTOR, int CILP, int JB>
__global__ void __launch_bounds__(COMBINE_THREADS)
moe_combine_kernel(const T* __restrict__ y, const int32_t* __restrict__ dest,
                   const float* __restrict__ gate, T* __restrict__ out, int64_t tokens, int k,
                   int64_t d, int64_t rows_y, int64_t cap, int64_t expert0) {
  combine_rows<T, VECTOR, CILP, JB, true>(y, dest, gate, out, tokens, k, d, rows_y, cap,
                                          expert0);
}

// ---------------------------------------------------------------------------
// the adjoints
// ---------------------------------------------------------------------------

// The fill's adjoint: token t's gradient is the f32 sum of its kept slots'
// rows of the buffer's gradient, in ascending expert id, rounded once.
template <typename T, bool VECTOR, int CILP, int JB>
__global__ void __launch_bounds__(COMBINE_THREADS)
moe_fill_bwd_kernel(const T* __restrict__ grad_buf, const int32_t* __restrict__ dest,
                    T* __restrict__ out, int64_t tokens, int k, int64_t d, int64_t rows_y,
                    int64_t cap) {
  combine_rows<T, VECTOR, CILP, JB, false>(grad_buf, dest, nullptr, out, tokens, k, d, rows_y,
                                           cap, 0);
}

// The raw unit zero_empty_slots stores: 16 bytes, or one element of T.
template <typename T, bool VECTOR> struct Raw { using type = uint4; };
template <> struct Raw<float, false> { using type = uint32_t; };
template <> struct Raw<__nv_bfloat16, false> { using type = uint16_t; };

// The combine's adjoint, shaped as the fill: a warp a token, lane j < k
// holding its j-th (dest, gate). The warp reads ILP units of grad_out's
// row a lane at a time, once, and for each kept route stores their
// products by the gate (rounded to T, as the combine rounds it) to the
// route's slot of dy and forms its part of the route's dot with y's row:
// each product grad_out * y rounded to T, the lane's sum in f32, then the
// warp's by xor shuffles (every lane the same value, the same order each
// run), added to the route's lane in chunk order. The route's dgate is
// that sum rounded to T and widened to f32; a dropped route's is 0. The
// grid's warps first zero dy's empty slots, as the fill zeroes them.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(FILL_THREADS)
moe_combine_bwd_kernel(const T* __restrict__ grad_out, const T* __restrict__ y,
                       const int32_t* __restrict__ dest, const float* __restrict__ gate,
                       const int32_t* __restrict__ kept, T* __restrict__ dy,
                       float* __restrict__ dgate, int64_t tokens, int k, int64_t slots,
                       int64_t cap, int64_t d) {
  using U = Unit<T, VECTOR>;
  constexpr int N = U::N;
  const int lane = threadIdx.x & 31;
  const int64_t warp = int64_t(blockIdx.x) * FILL_WARPS + threadIdx.x / 32;
  const int64_t warps = int64_t(gridDim.x) * FILL_WARPS;
  const int64_t units = d / N;
  zero_empty_slots(reinterpret_cast<typename Raw<T, VECTOR>::type*>(dy), kept, slots, cap,
                   units, warp, warps, lane);
  for (int64_t t = warp; t < tokens; t += warps) {
    int32_t r = -1;
    float g = 0.0f;
    if (lane < k) {
      r = dest[t * k + lane];
      if (r >= slots) __trap();
      g = Traits<T>::round(gate[t * k + lane]);
    }
    const unsigned live = __ballot_sync(FULL, r >= 0);
    const T* go_row = grad_out + t * d;
    float dg = 0.0f;                    // lane j: route j's dot
    // the same trip count on every lane: the shuffles below take the whole warp
    for (int64_t j0 = 0; j0 < units; j0 += 32 * ILP) {
      const int64_t j = j0 + lane;
      U go[ILP];
#pragma unroll
      for (int u = 0; u < ILP; ++u)
        if (j + u * 32 < units) go[u].load(go_row, j + u * 32);
      for (unsigned m = live; m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const int64_t row = __shfl_sync(FULL, r, src);
        const float gj = __shfl_sync(FULL, g, src);
        const T* y_row = y + row * d;
        U yv[ILP];
#pragma unroll
        for (int u = 0; u < ILP; ++u)
          if (j + u * 32 < units) yv[u].load(y_row, j + u * 32);
        float p = 0.0f;
#pragma unroll
        for (int u = 0; u < ILP; ++u) {
          if (j + u * 32 < units) {
            float x[N];
#pragma unroll
            for (int e = 0; e < N; ++e) {
              const float o = go[u].get(e);
              x[e] = Traits<T>::round(__fmul_rn(o, gj));
              p = __fadd_rn(p, Traits<T>::round(__fmul_rn(o, yv[u].get(e))));
            }
            U::store(dy + row * d, j + u * 32, x);
          }
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) p = __fadd_rn(p, __shfl_xor_sync(FULL, p, s));
        if (lane == src) dg = __fadd_rn(dg, p);
      }
    }
    if (lane < k) dgate[t * k + lane] = r >= 0 ? Traits<T>::round(dg) : 0.0f;
  }
}

// ---- host side -------------------------------------------------------------

// The device's SM count, asked once a device.
int sm_count(int dev) {
  static int counts[MAX_DEVICES] = {};
  if (dev < 0 || dev >= MAX_DEVICES) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      return 132;
    counts[dev] = n;
  }
  return counts[dev];
}

// blocks of `warps_a_block` warps for `items` warps' work, capped at
// `per_sm` blocks an SM (a grid stride covers the rest)
int grid_for(int64_t items, int warps_a_block, int per_sm, int dev) {
  const int64_t want = (items + warps_a_block - 1) / warps_a_block;
  const int64_t cap = int64_t(sm_count(dev)) * per_sm;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The combine's (and the fill adjoint's) units in flight and grid: 16 units
// a lane, 4 of each of 4 rows where k <= 4, else 2 of each of 8; 1 of each
// of 8 where that would give fewer than 8 warps an SM
void combine_grid(int64_t tokens, int64_t units, int k, int dev, int& cilp, int& blocks) {
  cilp = k <= 4 ? 4 : 2;
  if (tokens * ((units + 32 * cilp - 1) / (32 * cilp)) < int64_t(sm_count(dev)) * 8) cilp = 1;
  const int64_t items = tokens * ((units + 32 * cilp - 1) / (32 * cilp));
  blocks = grid_for(items, COMBINE_WARPS, 32, dev);
}

// The fill's grid (and the combine adjoint's): a warp for each token, and
// enough warps to spread the zeros: one for each 32 slot rows, and a block
// an SM where there are that many rows (decode's few tokens would leave the
// zeros to a block or two)
int fill_grid(int64_t tokens, int64_t slots, int dev) {
  const int64_t spread = std::min<int64_t>(slots, int64_t(sm_count(dev)) * FILL_WARPS);
  const int64_t warps = std::max<int64_t>({tokens, slots / 32, spread});
  return grid_for(warps, FILL_WARPS, 32, dev);
}

}  // namespace

// mode (Mode): the route, 1 for 16-byte units (D a multiple of 16 bytes'
// elements, rows and out 16-byte aligned) or 0 for an element at a time,
// the dtype, k and the device. rows (tokens, D); dest (tokens, k) int32,
// each a row of out (experts * cap, D) or negative for none; kept
// (experts,) int32, the count of each expert's rows in dest: the kernel
// zeroes the rest of its slots and trusts the count (`route_table` makes it
// from the same plan).
extern "C" int moe_fill(int mode, const void* rows, const int32_t* dest, const int32_t* kept,
                        void* out, long long tokens, long long experts, long long cap,
                        long long d, void* stream) {
  const Mode m(mode);
  const int vector = m.vector, dtype = m.dtype, k = m.k, device = m.device;
  const long long slots = experts * cap;
  if (tokens < 0 || experts < 0 || cap < 0 || d < 0 || k < 1 || k > MAX_K || slots > INT32_MAX ||
      (slots > 0 && d > 0 && (!out || !kept || (tokens > 0 && (!rows || !dest)))))
    return cudaErrorInvalidValue;
  if (slots == 0 || d == 0) return cudaSuccess;
  const int64_t bytes = d * (dtype == 0 ? 4 : 2);
  if (vector && (bytes % 16 != 0 || !aligned16(rows) || !aligned16(out)))
    return cudaErrorInvalidValue;
  OnDevice on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = fill_grid(tokens, slots, device);
  if (vector) {
    moe_fill_kernel<uint4><<<blocks, FILL_THREADS, 0, st>>>(
        static_cast<const uint4*>(rows), dest, kept, static_cast<uint4*>(out), tokens, k, slots,
        cap, bytes / 16);
  } else if (dtype == 0) {
    moe_fill_kernel<uint32_t><<<blocks, FILL_THREADS, 0, st>>>(
        static_cast<const uint32_t*>(rows), dest, kept, static_cast<uint32_t*>(out), tokens, k,
        slots, cap, d);
  } else {
    moe_fill_kernel<uint16_t><<<blocks, FILL_THREADS, 0, st>>>(
        static_cast<const uint16_t*>(rows), dest, kept, static_cast<uint16_t*>(out), tokens, k,
        slots, cap, d);
  }
  return cudaGetLastError();
}

// mode (Mode): the route, 1 for 16-byte units (D a multiple of 16 bytes'
// elements, y and out 16-byte aligned) or 0 for an element at a time, the
// dtype, k and the device. y (experts, cap, D); dest, gate (tokens, k) int32
// and f32, a row of y or negative for a dropped assignment of expert
// -1 - dest; out (tokens, D). y's first expert is expert `expert0` of the
// layer.
extern "C" int moe_combine(int mode, const void* y, const int32_t* dest, const float* gate,
                           void* out, long long tokens, long long experts, long long cap,
                           long long d, long long expert0, void* stream) {
  const Mode m(mode);
  const int vector = m.vector, dtype = m.dtype, k = m.k, device = m.device;
  if (tokens < 0 || d < 0 || experts < 0 || cap < 0 || k < 1 ||
      k > MAX_K || experts * cap > INT32_MAX || expert0 < 0 || (cap == 0 && experts > 0) ||
      (tokens > 0 && d > 0 && (!dest || !gate || !out || (experts * cap > 0 && !y))))
    return cudaErrorInvalidValue;
  if (tokens == 0 || d == 0) return cudaSuccess;
  const int64_t bytes = d * (dtype == 0 ? 4 : 2);
  if (vector && (bytes % 16 != 0 || !aligned16(y) || !aligned16(out)))
    return cudaErrorInvalidValue;
  const int64_t units = vector ? bytes / 16 : d;
  const int64_t rows_y = experts * cap;
  const int64_t cap1 = cap > 0 ? cap : 1;   // no kept row without a slot: any divisor
  OnDevice on(device);
  int cilp, blocks;
  combine_grid(tokens, units, k, device, cilp, blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define B2_COMBINE(T, V, I, J)                                                               \
  moe_combine_kernel<T, V, I, J><<<blocks, COMBINE_THREADS, 0, st>>>(                       \
      static_cast<const T*>(y), dest, gate, static_cast<T*>(out), tokens, k, d, rows_y, cap1, \
      expert0)
#define B2_COMBINE_ILP(T, V)                       \
  if (cilp == 1) B2_COMBINE(T, V, 1, 8);           \
  else if (cilp == 2) B2_COMBINE(T, V, 2, 8);      \
  else B2_COMBINE(T, V, 4, 4)
  if (dtype == 0) {
    if (vector) { B2_COMBINE_ILP(float, true); } else { B2_COMBINE_ILP(float, false); }
  } else {
    if (vector) { B2_COMBINE_ILP(__nv_bfloat16, true); } else { B2_COMBINE_ILP(__nv_bfloat16, false); }
  }
#undef B2_COMBINE_ILP
#undef B2_COMBINE
  return cudaGetLastError();
}

// The fill's adjoint. mode (Mode) as moe_fill's; grad_buf (experts, cap, D)
// the gradient of the fill's buffer; dest (tokens, k) int32 as moe_fill
// reads it; out (tokens, D) the rows' gradient, in grad_buf's dtype.
extern "C" int moe_fill_bwd(int mode, const void* grad_buf, const int32_t* dest, void* out,
                            long long tokens, long long experts, long long cap, long long d,
                            void* stream) {
  const Mode m(mode);
  const int vector = m.vector, dtype = m.dtype, k = m.k, device = m.device;
  if (tokens < 0 || d < 0 || experts < 0 || cap < 0 || k < 1 || k > MAX_K ||
      experts * cap > INT32_MAX || (cap == 0 && experts > 0) ||
      (tokens > 0 && d > 0 && (!dest || !out || (experts * cap > 0 && !grad_buf))))
    return cudaErrorInvalidValue;
  if (tokens == 0 || d == 0) return cudaSuccess;
  const int64_t bytes = d * (dtype == 0 ? 4 : 2);
  if (vector && (bytes % 16 != 0 || !aligned16(grad_buf) || !aligned16(out)))
    return cudaErrorInvalidValue;
  const int64_t units = vector ? bytes / 16 : d;
  const int64_t rows_y = experts * cap;
  const int64_t cap1 = cap > 0 ? cap : 1;
  OnDevice on(device);
  int cilp, blocks;
  combine_grid(tokens, units, k, device, cilp, blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define B2_FILL_BWD(T, V, I, J)                                                         \
  moe_fill_bwd_kernel<T, V, I, J><<<blocks, COMBINE_THREADS, 0, st>>>(                 \
      static_cast<const T*>(grad_buf), dest, static_cast<T*>(out), tokens, k, d, rows_y, \
      cap1)
#define B2_FILL_BWD_ILP(T, V)                      \
  if (cilp == 1) B2_FILL_BWD(T, V, 1, 8);          \
  else if (cilp == 2) B2_FILL_BWD(T, V, 2, 8);     \
  else B2_FILL_BWD(T, V, 4, 4)
  if (dtype == 0) {
    if (vector) { B2_FILL_BWD_ILP(float, true); } else { B2_FILL_BWD_ILP(float, false); }
  } else {
    if (vector) { B2_FILL_BWD_ILP(__nv_bfloat16, true); } else { B2_FILL_BWD_ILP(__nv_bfloat16, false); }
  }
#undef B2_FILL_BWD_ILP
#undef B2_FILL_BWD
  return cudaGetLastError();
}

// The combine's adjoint. mode (Mode) as moe_combine's; grad_out (tokens, D)
// the gradient of the combine's output and y (experts, cap, D), both of the
// dtype; dest, gate (tokens, k) as moe_combine reads them; kept (experts,)
// int32 as moe_fill reads it: dy's slots past it are zeroed. Writes dy
// (experts, cap, D) and dgate (tokens, k) f32.
extern "C" int moe_combine_bwd(int mode, const void* grad_out, const void* y,
                               const int32_t* dest, const float* gate, const int32_t* kept,
                               void* dy, float* dgate, long long tokens, long long experts,
                               long long cap, long long d, void* stream) {
  const Mode m(mode);
  const int vector = m.vector, dtype = m.dtype, k = m.k, device = m.device;
  const long long slots = experts * cap;
  if (tokens < 0 || d < 0 || experts < 0 || cap < 0 || k < 1 || k > MAX_K ||
      slots > INT32_MAX ||
      (tokens > 0 && (!dest || !gate || !dgate || (d > 0 && !grad_out))) ||
      (slots > 0 && d > 0 && (!y || !dy || !kept)))
    return cudaErrorInvalidValue;
  if (tokens == 0 && (slots == 0 || d == 0)) return cudaSuccess;
  const int64_t bytes = d * (dtype == 0 ? 4 : 2);
  if (vector && (bytes % 16 != 0 || !aligned16(grad_out) || !aligned16(y) || !aligned16(dy)))
    return cudaErrorInvalidValue;
  OnDevice on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = fill_grid(tokens, slots, device);
#define B2_COMBINE_BWD(T, V)                                                                  \
  moe_combine_bwd_kernel<T, V><<<blocks, FILL_THREADS, 0, st>>>(                             \
      static_cast<const T*>(grad_out), static_cast<const T*>(y), dest, gate, kept,            \
      static_cast<T*>(dy), dgate, tokens, k, slots, cap > 0 ? cap : 1, d)
  if (dtype == 0) {
    if (vector) { B2_COMBINE_BWD(float, true); } else { B2_COMBINE_BWD(float, false); }
  } else {
    if (vector) { B2_COMBINE_BWD(__nv_bfloat16, true); } else { B2_COMBINE_BWD(__nv_bfloat16, false); }
  }
#undef B2_COMBINE_BWD
  return cudaGetLastError();
}

extern "C" const char* moe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
