// RMSNorm, plain and Mamba2's gated form, forward and adjoint (sm_90a),
// CUDA C++: B4.
//
// Replaces no Pallas kernel. The kernels stand for what XLA fuses under the
// reference's `jax.jit` out of two elementwise chains with a row reduction:
// * plain, `rms_norm` (src/repro/models/layers.py:17): f32 statistics over
//   the last dim, `x * rsqrt(mean(x*x) + eps)` rounded to x's dtype, *then*
//   times `scale` in x's dtype;
// * gated, the tail of `mamba2_mixer` (src/repro/models/ssm.py:200-202):
//   `pre = y + xh * D` in f32 (y the SSD scan's output, xh its input, D a
//   head's skip weight), rounded to the model's dtype; times `silu(z)`,
//   silu rounded first, the product rounded; then the plain form.
// Every step is rounded where PyTorch's eager ops round it in the plain
// versions (kernels/rms_norm.py `rms_norm_plain`, `gated_rms_norm_plain`):
// bf16 works through f32 with `__float2bfloat16_rn` after each op, f32 with
// `__fmul_rn` and `__fadd_rn` (nvcc's default `-fmad=true` would contract a
// product and a sum), SiLU as `x / (1 + expf(-x))` (IEEE division: built
// without `--use_fast_math`), the statistic
// `rsqrtf(mean + eps)` with the mean as the row's f32 sum of the rounded
// squares times the f32 `1 / d` (PyTorch's mean). So the output equals the
// eager chain's bit for bit wherever the row's sum comes out equal; the
// order of the sum is the kernel's own (each thread's elements in order,
// then xor shuffles, then the warps of a row in order).
//
// The adjoints (`RmsNormFn`, `GatedRmsNormFn` in kernels/rms_norm.py) take
// the forward's f32 rstd a row (the forward keeps it when asked) and
// recompute the rest. With n = x * r, r = rstd, G the output's gradient:
//   dscale = sum over rows of G * round(n)          (f32 partials)
//   dn     = G * scale,  dot = sum over the row of dn * x
//   dx     = r * dn - x * (r^3 * dot / d)
// and for the gated form, x being the gated product g = round(yT * sz):
//   dpre = dx * sz,  dz = dx * yT * silu'(z),  dy = dpre,  dxh = dpre * D,
//   dD   = sum over a head's elements and rows of dpre * xh  (f32 partials)
// Each block sums its rows' dscale and dD in f32 (its row groups in order;
// dD a head's units too), writes one partial row, and a second kernel
// (`norm_sum_partials`) adds the partial rows in a fixed order (32 warps a
// column, each over every 32nd row, 8 rows' loads in flight, then the
// warps in order) and rounds once.
//
// Layouts: the plain form reads rows of x at a row stride (the last dim
// contiguous); the gated form reads y at its (b, s, h) strides (the SSD
// kernel's (B, H, S, P) buffer seen as (B, S, H, P)), xh and z at their
// row strides inside the convolution's output and the input projection,
// and writes dy at y's strides, so the SSD kernel's adjoint takes it as it
// is. No copy is made of any input.
//
// What bounds both on this card: bytes. A row is read once with ~10
// (forward) to ~60 (gated adjoint: SiLU's exact exp and division for the
// bits of silu(z), a fast sigmoid for its derivative) f32 operations an
// element. mamba2-1.3b's training shape (4 x 1024 rows): the gated forward
// reads y, xh and z and writes the output (4096 wide, bf16) and rstd:
// 134 MB, 0.040 ms at 3.35 TB/s; its adjoint reads y, xh, z and G and
// writes dy, dxh and dz: 235 MB, 0.070 ms. What the design does about it:
// * the forward: a row is split over TPR threads (a power of two, 4 at
//   width 128, 512 at 16384), each holding at most ELEMS elements in
//   registers, moved in 16-byte units (8 bf16 or 4 f32, the `vector` route)
//   where every row start and stride is 16-byte aligned and the width (and
//   a head, for the gated form) a whole number of units, else element by
//   element (the `scalar` route). A thread's units are TPR units apart, so
//   the warp's loads are contiguous; a block of max(256, TPR) threads holds
//   256 / TPR rows at once, so rows of 128 fill whole warps; the row stays
//   in registers between its sum and its output;
// * the adjoint (`rms_norm_bwd_kernel`) reads each row once from device
//   memory: a thread owns NU 16-byte units of it (NU 2 for the plain form:
//   a 128-wide row on 8 threads, a quarter-warp, whose sum needs no shared
//   memory, 2048 on 128, 3072 on 192; NU 1 for the gated form: 4096 on 512
//   threads; wider rows NU 2 or 4) and copies them by cp.async into its
//   own shared slots, the next row's before this row's dot and sum, so a
//   row's loads are in flight while the one before is computed, no barrier
//   guards the slots, and the row stays on chip between its dot and its
//   outputs (wider rows, whose slots do not fit, read it again from L1/L2).
//   The gated product's exact exp and division run once an element (silu(z)
//   kept rounded in registers); the row's rstd is loaded a row ahead; a
//   row's sum meets at the row's own named barrier, once;
// * dscale and dD build up in shared f32 rows, one a row group, each thread
//   on its own columns (a float4 a quad, no barrier), not in 32 registers
//   a thread: at most 64 registers a thread, 32 warps an SM: two blocks
//   of 512 threads, BWD_ROW_BLOCK / tpr
//   rows each (four 2048-wide rows; the gated form a row), half the partial
//   rows of blocks of 256 (8% faster at 2048,
//   examples/norm_conv_variants_torch.py);
// * the grid is persistent: as many blocks as the card holds at once
//   (`cudaOccupancyMaxActiveBlocksPerMultiprocessor` for the built kernel
//   and its shared memory, times the SMs; `bwd_blocks` in
//   kernels/rms_norm.py), the rows a grid's worth of row groups apart, so
//   the card runs one wave and the partial rows stay few.
//
// Entry points: `rms_norm_fwd`, `rms_norm_bwd`, and `rms_norm_bwd_residency`
// and `rms_norm_bwd_attributes` (what the runtime reports of the adjoint's
// kernels), plain C functions that launch on the given stream of the given
// device and return cudaGetLastError() (the residency its blocks an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int ELEMS = 32;          // elements of a row a thread holds, at most
constexpr int MAX_TPR = 512;       // threads of a row, at most: widths to 16384
constexpr int ROW_BLOCK = 256;     // threads a block where a row takes fewer
constexpr int MAX_BLOCK = 512;
constexpr int BWD_MAX_TPR = 1024;  // the one-pass adjoint: threads of a row, at most
constexpr int BWD_MAX_BLOCK = 1024;
constexpr int BWD_ROW_BLOCK = 512; // one-pass adjoint: threads a block of rows under 512
constexpr int BWD_STAGES = 2;      // the one-pass adjoint's rows in shared memory at once
constexpr unsigned FULL = 0xffffffffu;

// An entry point's small arguments in one int: bit 0 the route (1 for
// 16-byte units), bit 1 the dtype (0 f32, 1 bf16), bit 2 the gated form,
// bit 3 y in f32 (the gated form's decode step, whose y is f32), the bits
// from 8 the device.
constexpr int MODE_DTYPE = 1 << 1;
constexpr int MODE_GATED = 1 << 2;
constexpr int MODE_Y_F32 = 1 << 3;
constexpr int MODE_DEVICE_SHIFT = 8;

struct Args {
  const void* x;          // plain: the rows
  const void* y;          // gated: the scan's output, (b, s, h) strides
  const void* xh;         // gated: the scan's input, row strides
  const void* z;          // gated: the gate, row strides
  const float* D;         // gated: (H,) f32
  const void* scale;      // (d,)
  const void* g;          // adjoint: the output's gradient, contiguous rows
  const float* rstd_in;   // adjoint: the forward's rstd
  void* out;              // forward: the output, contiguous rows; adjoint: dx (plain)
  float* rstd;            // forward: (rows,) f32, or null
  void* dy;               // adjoint, gated: at dy's (b, s, h) strides
  void* dxh;              // adjoint, gated: contiguous (rows, d)
  void* dz;               // adjoint, gated: contiguous (rows, d)
  float* part;            // adjoint: (blocks, d) f32 partial dscale
  float* part_d;          // adjoint, gated: (blocks, H) f32 partial dD a head
  long long rows, d, x_stride;
  long long S, P;                          // gated: rows = B * S, heads of P
  long long ysb, yss, ysh, xsb, xss, zsb, zss, dysb, dyss, dysh;
  float eps;
  int tpr;
};

// The sum of v over a row's tpr threads (a power of two), the same value in
// every one of them: xor shuffles within a warp, then the row's warps in
// order through `red` (one slot a warp of the block). Every thread of the
// block calls it.
__device__ __forceinline__ float row_sum(float v, int tpr, float* red) {
  const int width = tpr < 32 ? tpr : 32;
  for (int off = width / 2; off > 0; off /= 2) v += __shfl_xor_sync(FULL, v, off);
  if (tpr <= 32) return v;
  const int warp = threadIdx.x / 32;
  __syncthreads();                       // red's earlier readers are done
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  const int first = (threadIdx.x / tpr) * (tpr / 32);
  float s = 0.0f;
  for (int w = 0; w < tpr / 32; ++w) s += red[first + w];
  return s;
}

// row_sum for the one-pass adjoint: the row's warps meet at their own named
// barrier (1 + the row group), and the warp slots alternate between two
// sets a row (`parity`), so one barrier a row, of the row's warps only
__device__ __forceinline__ float row_sum_group(float v, int tpr, float* red, int parity) {
  const int width = tpr < 32 ? tpr : 32;
  for (int off = width / 2; off > 0; off /= 2) v += __shfl_xor_sync(FULL, v, off);
  if (tpr <= 32) return v;
  const int warp = threadIdx.x / 32, rg = threadIdx.x / tpr;
  float* slots = red + parity * 32;
  if (threadIdx.x % 32 == 0) slots[warp] = v;
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "r"(tpr) : "memory");
  const int first = rg * (tpr / 32);
  float s = 0.0f;
  for (int w = 0; w < tpr / 32; ++w) s += slots[first + w];
  return s;
}

// The gated form's inputs of one unit (element e of a row, e < d <= 16384):
// pre = y + xh * D (f32), then yT = round(pre), sz = round(silu(z)),
// g = round(yT * sz); returns g in gv
template <typename T, typename TY, int V>
__device__ __forceinline__ void gated_unit(const Args& a, long long b, long long s, int e,
                                           float* gv) {
  const int P = static_cast<int>(a.P);
  const int h = e / P, p = e - h * P;
  float yv[V], xv[V], zz[V];
  load_unit<TY, V>(static_cast<const TY*>(a.y) + b * a.ysb + s * a.yss + h * a.ysh + p, yv);
  load_unit<T, V>(static_cast<const T*>(a.xh) + b * a.xsb + s * a.xss + e, xv);
  load_unit<T, V>(static_cast<const T*>(a.z) + b * a.zsb + s * a.zss + e, zz);
  const float dh = a.D[h];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float yT = rnd<T>(__fadd_rn(yv[j], __fmul_rn(xv[j], dh)));
    const float t = 1.0f + expf(-zz[j]);
    const float sz = rnd<T>(zz[j] / t);            // silu, as PyTorch computes it
    gv[j] = rnd<T>(__fmul_rn(yT, sz));
  }
}

template <typename T, typename TY, int V, bool GATED>
__global__ void __launch_bounds__(MAX_BLOCK) rms_norm_fwd_kernel(const Args a) {
  constexpr int UPT = ELEMS / V;
  __shared__ float red[MAX_BLOCK / 32];
  const int tpr = a.tpr;
  const int lane = threadIdx.x % tpr;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < a.rows;
  const long long units = a.d / V;
  const long long b = GATED ? row / a.S : 0, s = GATED ? row - b * a.S : 0;
  float xv[UPT][V];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < UPT; ++k) {
    const long long u = lane + static_cast<long long>(k) * tpr;
    if (live && u < units) {
      if constexpr (GATED) {
        gated_unit<T, TY, V>(a, b, s, static_cast<int>(u) * V, xv[k]);
      } else {
        load_unit<T, V>(static_cast<const T*>(a.x) + row * a.x_stride + u * V, xv[k]);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) ss = __fadd_rn(ss, __fmul_rn(xv[k][j], xv[k][j]));
    }
  }
  ss = row_sum(ss, tpr, red);
  if (!live) return;
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / static_cast<float>(a.d)), a.eps));
  if (a.rstd && lane == 0) a.rstd[row] = r;
  T* out = static_cast<T*>(a.out) + row * a.d;
#pragma unroll
  for (int k = 0; k < UPT; ++k) {
    const long long u = lane + static_cast<long long>(k) * tpr;
    if (u < units) {
      float sc[V], o[V];
      load_unit<T, V>(static_cast<const T*>(a.scale) + u * V, sc);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = __fmul_rn(rnd<T>(__fmul_rn(xv[k][j], r)), sc[j]);
      store_unit<T, V>(out + u * V, o);
    }
  }
}

// out1[c] = round(sum over g < blocks of part1[g][c]) for c < n1, in the
// dtype `bf16` says; out2[q] = sum over g < blocks of part2[g][q] (f32) for
// q < n2. A block takes SUM_COLS outputs, its SUM_WARPS warps the partial
// rows g congruent to the warp mod SUM_WARPS, each in order from +0.0,
// SUM_BATCH rows' loads in flight at a time; then the warps' sums are added
// in warp order: a fixed order, whatever the timing.
constexpr int SUM_COLS = 32, SUM_WARPS = 32, SUM_BATCH = 8;
__global__ void __launch_bounds__(SUM_COLS * SUM_WARPS) norm_sum_partials(
    const float* part1, long long n1, int bf16, void* out1, const float* part2, long long n2,
    float* out2, long long blocks) {
  __shared__ float acc_w[SUM_WARPS][SUM_COLS];
  const int lane = threadIdx.x % SUM_COLS, w = threadIdx.x / SUM_COLS;
  const long long o = static_cast<long long>(blockIdx.x) * SUM_COLS + lane;
  float acc = 0.0f;
  if (o < n1 + n2) {
    const bool first = o < n1;
    const float* base = first ? part1 + o : part2 + (o - n1);
    const long long row = first ? n1 : n2;
    for (long long g0 = w; g0 < blocks; g0 += SUM_WARPS * SUM_BATCH) {
      float v[SUM_BATCH];
#pragma unroll
      for (int i = 0; i < SUM_BATCH; ++i) {
        const long long g = g0 + static_cast<long long>(i) * SUM_WARPS;
        v[i] = g < blocks ? base[g * row] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < SUM_BATCH; ++i)
        if (g0 + static_cast<long long>(i) * SUM_WARPS < blocks) acc = __fadd_rn(acc, v[i]);
    }
  }
  acc_w[w][lane] = acc;
  __syncthreads();
  if (w != 0 || o >= n1 + n2) return;
  float sum = 0.0f;
  for (int i = 0; i < SUM_WARPS; ++i) sum = __fadd_rn(sum, acc_w[i][lane]);
  if (o < n1) {
    if (bf16) static_cast<__nv_bfloat16*>(out1)[o] = __float2bfloat16_rn(sum);
    else static_cast<float*>(out1)[o] = sum;
  } else {
    out2[o - n1] = sum;
  }
}

// ---- the one-pass adjoint ----------------------------------------------------

// A unit's raw words: 16 bytes on the vector route, one element (in a word)
// on the scalar route
template <typename T, int V>
struct Raw {
  static constexpr int WORDS = V * int(sizeof(T)) >= 4 ? V * int(sizeof(T)) / 4 : 1;
};

template <typename T, int V>
__device__ __forceinline__ void load_raw(const T* p, uint32_t* r) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    r[0] = u.x; r[1] = u.y; r[2] = u.z; r[3] = u.w;
  } else if constexpr (sizeof(T) == 2) {
    r[0] = *reinterpret_cast<const unsigned short*>(p);
  } else {
    r[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// element j of a unit's raw words, widened to f32
template <typename T, int V>
__device__ __forceinline__ float elem(const uint32_t* r, int j) {
  if constexpr (sizeof(T) == 2) {
    if constexpr (V == 1) return __uint_as_float(r[0] << 16);
    else return (j & 1) ? bf16_hi(r[j / 2]) : bf16_lo(r[j / 2]);
  } else {
    return __uint_as_float(r[j]);
  }
}

// EPW elements a word (2 for bf16 units of 16 bytes, else 1), the word's
// elements packed back to T
template <typename T, int V>
struct Words {
  static constexpr int EPW = sizeof(T) == 2 && V > 1 ? 2 : 1;
};

template <typename T, int EPW>
__device__ __forceinline__ uint32_t pack_word(const float* f) {
  if constexpr (sizeof(T) == 2) {
    if constexpr (EPW == 2) return bf16_bits(f[0]) | (bf16_bits(f[1]) << 16);
    else return bf16_bits(f[0]);
  } else {
    return __float_as_uint(f[0]);
  }
}

// a unit's raw words stored at p in one store
template <typename T, int V>
__device__ __forceinline__ void store_raw(T* p, const uint32_t* r) {
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r[0], r[1], r[2], r[3]);
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(r[0]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = r[0];
  }
}

// The one-pass adjoint keeps a row's units in shared memory (its
// `staged` kernels: 16-byte units where the slots fit, NU 1 or 2 plain, 1
// gated), each thread's own slots, BWD_STAGES rows of them, filled by
// 16-byte cp.async; else it loads them from device memory for the dot and
// again, from L1/L2, for the outputs
template <typename T, int V, int NU, bool GATED>
struct Staged {
  static constexpr bool value = V * sizeof(T) == 16 && (GATED ? NU == 1 : NU <= 2);
};

// The one-pass adjoint's shared memory, in floats: the row sums' warp
// slots (two sets), a block's f32 dscale rows (one a row group, `span` =
// NU x V x tpr wide: column (lane + k * tpr) * V + j at ((k * V / Q + j / Q)
// * tpr + lane) * Q + j % Q, Q = 4 on the vector route, so a warp's quads
// of one unit are 512 contiguous bytes, one a lane) and, gated, its dD rows
// (one a row group, a value a unit); then, 16-byte aligned, the staged
// kernels' slots (BWD_STAGES x inputs x NU x the block's threads x 16 bytes)
__host__ __device__ constexpr long long bwd_acc_floats(long long span, long long units,
                                                       int groups, bool gated) {
  return (64 + groups * span + (gated ? groups * units : 0) + 3) / 4 * 4;
}
__host__ __device__ constexpr long long bwd_smem_bytes(long long span, long long units,
                                                       int groups, bool gated, bool staged,
                                                       int nu, int block) {
  return 4 * bwd_acc_floats(span, units, groups, gated) +
         (staged ? static_cast<long long>(BWD_STAGES) * (gated ? 4 : 2) * nu * block * 16 : 0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Every row's inputs are read once from device memory: a row takes tpr
// threads, NU units each (unit lane + k * tpr), a block `groups` rows at
// once. On the staged kernels each thread copies its units of the row
// BWD_STAGES - 1 ahead into its own shared slots (cp.async) before this
// row's dot and sum, and reads this row's from its slots for the dot and
// again for the outputs, so no barrier guards them. dscale and dD build up in shared f32 rows, one
// a row group, each thread adding to its own columns, and the block adds
// its row groups in order at its end into one partial row.
template <typename T, int V, int NU, bool GATED>
__global__ void __launch_bounds__(BWD_MAX_BLOCK) rms_norm_bwd_kernel(const Args a) {
  constexpr int RW = Raw<T, V>::WORDS;
  constexpr int NIN = GATED ? 4 : 2;         // g, then x (plain) or y, xh, z (gated)
  constexpr int EPW = Words<T, V>::EPW;
  constexpr bool STAGED = Staged<T, V, NU, GATED>::value;
  extern __shared__ __align__(16) float sm[];
  const int tpr = a.tpr;
  const int groups = blockDim.x / tpr, rg = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  const long long d = a.d, units = d / V;
  constexpr int Q = V % 4 == 0 ? 4 : 1;    // dscale accumulators a lane holds side by side
  const long long span = static_cast<long long>(NU) * V * tpr;
  float* red = sm;
  float* acc_s = sm + 64;
  float* acc_d = acc_s + groups * span;
  uint4* slots = reinterpret_cast<uint4*>(sm + bwd_acc_floats(span, units, groups, GATED));
  for (long long i = threadIdx.x; i < groups * (span + (GATED ? units : 0)); i += blockDim.x)
    acc_s[i] = 0.0f;
  __syncthreads();
  float* my_s = acc_s + rg * span + lane * Q;     // see bwd_acc_floats
  // the accumulators of quad qd of a unit: a float4 on the vector route
  auto acc_load = [&](const float* p, float (&aq)[Q]) {
    if constexpr (Q == 4) {
      const float4 v4 = *reinterpret_cast<const float4*>(p);
      aq[0] = v4.x; aq[1] = v4.y; aq[2] = v4.z; aq[3] = v4.w;
    } else {
      aq[0] = *p;
    }
  };
  auto acc_store = [&](float* p, const float (&aq)[Q]) {
    if constexpr (Q == 4) *reinterpret_cast<float4*>(p) = make_float4(aq[0], aq[1], aq[2], aq[3]);
    else *p = aq[0];
  };
  float* my_d = acc_d + rg * units;
  const float inv_d = 1.0f / static_cast<float>(d);
  const int P = static_cast<int>(a.P);

  const long long nrg = (a.rows + groups - 1) / groups;
  const long long iters = blockIdx.x < nrg ? (nrg - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto row_of = [&](long long it) { return (blockIdx.x + it * gridDim.x) * groups + rg; };
  // the thread's units: element e[k] of every row (for the gated form its
  // offsets in y's and dy's (h, p) layout, yo[k] and dyo[k], and its head's
  // D)
  long long e[NU], yo[NU], dyo[NU];
  float dhk[NU];
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    e[k] = (lane + static_cast<long long>(k) * tpr) * V;
    yo[k] = dyo[k] = 0;
    dhk[k] = 0.0f;
    if constexpr (GATED) {
      if (e[k] < d) {
        const int h = static_cast<int>(e[k]) / P, p = static_cast<int>(e[k]) - h * P;
        yo[k] = h * a.ysh + p;
        dyo[k] = h * a.dysh + p;
        dhk[k] = a.D[h];
      }
    }
  }
  // a row's (b, s) for the gated form's strided inputs (rows < 2^31)
  auto split = [&](long long row, long long& b, long long& s) {
    b = GATED ? static_cast<long long>(static_cast<uint32_t>(row) / static_cast<uint32_t>(a.S))
              : 0;
    s = GATED ? row - b * a.S : 0;
  };
  // input `in` of a row (at (b, s)) at the thread's unit k
  auto src = [&](int in, long long row, long long b, long long s, int k) -> const T* {
    if (in == 0) return static_cast<const T*>(a.g) + row * d + e[k];
    if constexpr (GATED) {
      if (in == 1) return static_cast<const T*>(a.y) + b * a.ysb + s * a.yss + yo[k];
      if (in == 2) return static_cast<const T*>(a.xh) + b * a.xsb + s * a.xss + e[k];
      return static_cast<const T*>(a.z) + b * a.zsb + s * a.zss + e[k];
    } else {
      return static_cast<const T*>(a.x) + row * a.x_stride + e[k];
    }
  };
  auto slot = [&](int st, int in, int k) -> uint4* {
    return slots + ((st * NIN + in) * NU + k) * static_cast<int>(blockDim.x) + threadIdx.x;
  };
  auto issue = [&](long long row, int st) {
    if (row >= a.rows) return;
    long long b, s;
    split(row, b, s);
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      if (e[k] < d) {
#pragma unroll
        for (int in = 0; in < NIN; ++in) cp_async16(slot(st, in, k), src(in, row, b, s, k));
      }
    }
  };
  // the raw words of input `in`, unit k, of the current row
  auto fetch = [&](int in, int k, long long row, long long b, long long s, int st, uint32_t* w) {
    if constexpr (STAGED) {
      const uint4 v = *slot(st, in, k);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
      load_raw<T, V>(src(in, row, b, s, k), w);
    }
  };

  if constexpr (STAGED) {
#pragma unroll
    for (int q = 0; q + 1 < BWD_STAGES; ++q) {
      if (q < iters) issue(row_of(q), q);
      cp_async_commit();
    }
  }
  // each row's rstd is loaded an iteration ahead, off the path after its sum
  auto rstd_of = [&](long long it) {
    const long long row = row_of(it);
    return it < iters && row < a.rows ? a.rstd_in[row] : 0.0f;
  };
  float r_next = rstd_of(0);
  for (long long it = 0; it < iters; ++it) {
    const int st = static_cast<int>(it % BWD_STAGES);
    const long long row = row_of(it);
    const bool live = row < a.rows;
    const float r = r_next;
    r_next = rstd_of(it + 1);
    if constexpr (STAGED) {
      cp_async_wait<BWD_STAGES - 2>();     // this row's slots
      const long long ahead = it + BWD_STAGES - 1;
      if (ahead < iters) issue(row_of(ahead), static_cast<int>(ahead % BWD_STAGES));
      cp_async_commit();
    }
    long long b, s;
    split(row, b, s);
    uint32_t szr[GATED ? NU : 1][RW];        // gated: silu(z) rounded, kept for the outputs
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      if (live && e[k] < d) {
        uint32_t scr[RW], gw[RW], xw[RW];
        load_raw<T, V>(static_cast<const T*>(a.scale) + e[k], scr);
        fetch(0, k, row, b, s, st, gw);
        if constexpr (GATED) {
          uint32_t yw[RW], xhw[RW], zw[RW];
          fetch(1, k, row, b, s, st, yw);
          fetch(2, k, row, b, s, st, xhw);
          fetch(3, k, row, b, s, st, zw);
          const float dh = dhk[k];
#pragma unroll
          for (int w = 0; w < RW; ++w) {
            float szf[EPW], gp[EPW];
#pragma unroll
            for (int q = 0; q < EPW; ++q) {
              const int j = w * EPW + q;
              const float yT =
                  rnd<T>(__fadd_rn(elem<T, V>(yw, j), __fmul_rn(elem<T, V>(xhw, j), dh)));
              const float zz = elem<T, V>(zw, j);
              szf[q] = rnd<T>(zz / (1.0f + expf(-zz)));     // silu, as PyTorch computes it
              gp[q] = rnd<T>(__fmul_rn(yT, szf[q]));
              dot = fmaf(__fmul_rn(elem<T, V>(gw, j), elem<T, V>(scr, j)), gp[q], dot);
            }
            szr[k][w] = pack_word<T, EPW>(szf);
          }
        } else {
          fetch(1, k, row, b, s, st, xw);
#pragma unroll
          for (int j = 0; j < V; ++j)
            dot = fmaf(__fmul_rn(elem<T, V>(gw, j), elem<T, V>(scr, j)), elem<T, V>(xw, j), dot);
        }
      }
    }
    dot = row_sum_group(dot, tpr, red, static_cast<int>(it & 1));
    if (!live) continue;
    const float c = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(r, r), r), dot), inv_d);
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      if (e[k] >= d) continue;
      uint32_t scr[RW], gw[RW];
      load_raw<T, V>(static_cast<const T*>(a.scale) + e[k], scr);
      fetch(0, k, row, b, s, st, gw);
      float* acc = my_s + k * (V / Q) * tpr * Q;   // quad qd at acc + qd * tpr * Q
      float aq[Q];
      if constexpr (GATED) {
        uint32_t yw[RW], xhw[RW], zw[RW];
        fetch(1, k, row, b, s, st, yw);
        fetch(2, k, row, b, s, st, xhw);
        fetch(3, k, row, b, s, st, zw);
        const float dh = dhk[k];
        T* dy = static_cast<T*>(a.dy) + b * a.dysb + s * a.dyss + dyo[k];
        uint32_t o_dy[RW], o_dxh[RW], o_dz[RW];
        float part = 0.0f;
#pragma unroll
        for (int w = 0; w < RW; ++w) {
          float f_dy[EPW], f_dxh[EPW], f_dz[EPW];
#pragma unroll
          for (int q = 0; q < EPW; ++q) {
            const int j = w * EPW + q;
            const float gv = elem<T, V>(gw, j), xh = elem<T, V>(xhw, j);
            const float zz = elem<T, V>(zw, j), sz = elem<T, V>(szr[k], j);
            const float yT = rnd<T>(__fadd_rn(elem<T, V>(yw, j), __fmul_rn(xh, dh)));
            const float xv = rnd<T>(__fmul_rn(yT, sz));
            if (j % Q == 0) acc_load(acc + (j / Q) * tpr * Q, aq);
            aq[j % Q] = __fadd_rn(aq[j % Q], __fmul_rn(gv, rnd<T>(__fmul_rn(xv, r))));
            if (j % Q == Q - 1) acc_store(acc + (j / Q) * tpr * Q, aq);
            const float dn = __fmul_rn(gv, elem<T, V>(scr, j));
            const float dx = __fsub_rn(__fmul_rn(r, dn), __fmul_rn(xv, c));
            f_dy[q] = __fmul_rn(dx, sz);
            f_dxh[q] = __fmul_rn(f_dy[q], dh);
            part = fmaf(f_dy[q], xh, part);
            const float sg = __fdividef(1.0f, 1.0f + __expf(-zz));
            const float ds = __fmul_rn(sg, fmaf(zz, __fsub_rn(1.0f, sg), 1.0f));
            f_dz[q] = __fmul_rn(__fmul_rn(dx, yT), ds);
          }
          o_dy[w] = pack_word<T, EPW>(f_dy);
          o_dxh[w] = pack_word<T, EPW>(f_dxh);
          o_dz[w] = pack_word<T, EPW>(f_dz);
        }
        my_d[e[k] / V] = __fadd_rn(my_d[e[k] / V], part);
        store_raw<T, V>(dy, o_dy);
        store_raw<T, V>(static_cast<T*>(a.dxh) + row * d + e[k], o_dxh);
        store_raw<T, V>(static_cast<T*>(a.dz) + row * d + e[k], o_dz);
      } else {
        uint32_t xw[RW], out[RW];
        fetch(1, k, row, b, s, st, xw);
#pragma unroll
        for (int w = 0; w < RW; ++w) {
          float o[EPW];
#pragma unroll
          for (int q = 0; q < EPW; ++q) {
            const int j = w * EPW + q;
            const float gv = elem<T, V>(gw, j), xv = elem<T, V>(xw, j);
            if (j % Q == 0) acc_load(acc + (j / Q) * tpr * Q, aq);
            aq[j % Q] = __fadd_rn(aq[j % Q], __fmul_rn(gv, rnd<T>(__fmul_rn(xv, r))));
            if (j % Q == Q - 1) acc_store(acc + (j / Q) * tpr * Q, aq);
            const float dn = __fmul_rn(gv, elem<T, V>(scr, j));
            o[q] = __fsub_rn(__fmul_rn(r, dn), __fmul_rn(xv, c));
          }
          out[w] = pack_word<T, EPW>(o);
        }
        store_raw<T, V>(static_cast<T*>(a.out) + row * d + e[k], out);
      }
    }
  }
  // this block's partial rows: its row groups added in order
  __syncthreads();
  float* part = a.part + static_cast<long long>(blockIdx.x) * d;
  for (long long col = threadIdx.x; col < d; col += blockDim.x) {
    const long long u = col / V, k = u / tpr, j = col - u * V;
    const long long at = ((k * (V / Q) + j / Q) * tpr + (u - k * tpr)) * Q + j % Q;
    float v = acc_s[at];
    for (int q = 1; q < groups; ++q) v = __fadd_rn(v, acc_s[q * span + at]);
    part[col] = v;
  }
  if constexpr (GATED) {                     // dD: a head's units, row groups first
    const long long heads = d / P, per = P / V;
    float* part_d = a.part_d + static_cast<long long>(blockIdx.x) * heads;
    for (long long h = threadIdx.x; h < heads; h += blockDim.x) {
      float v = acc_d[h * per];
      for (int q = 0; q < groups; ++q)
        for (long long j = q == 0 ? 1 : 0; j < per; ++j)
          v = __fadd_rn(v, acc_d[q * units + h * per + j]);
      part_d[h] = v;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The launch's shape checks: tpr a power of two no larger than MAX_TPR whose
// threads hold the row, the block max(ROW_BLOCK, tpr)
bool plan_ok(long long d, int v, int tpr) {
  if (tpr < 1 || tpr > MAX_TPR || (tpr & (tpr - 1)) != 0) return false;
  if (d % v != 0) return false;
  return static_cast<long long>(tpr) * (ELEMS / v) >= d / v;
}

int block_for(int tpr) { return tpr > ROW_BLOCK ? tpr : ROW_BLOCK; }

// The one-pass adjoint's shape checks: NU units a thread (1, 2 or 4 on the
// vector route, 16 elements on the scalar), tpr a power of two up to 32 or
// a multiple of 32 up to BWD_MAX_TPR, whose threads hold the row; the block
// holds BWD_ROW_BLOCK / tpr rows where tpr < BWD_ROW_BLOCK, else one
bool bwd_plan_ok(long long d, int v, int nu, int tpr) {
  if (v > 1 ? nu != 1 && nu != 2 && nu != 4 : nu != 16) return false;
  if (tpr < 1 || tpr > BWD_MAX_TPR || d % v != 0) return false;
  if (tpr <= 32 ? (tpr & (tpr - 1)) != 0 : tpr % 32 != 0) return false;
  return static_cast<long long>(tpr) * nu >= d / v;
}

int bwd_block(int tpr) { return tpr >= BWD_ROW_BLOCK ? tpr : BWD_ROW_BLOCK / tpr * tpr; }

// The one-pass adjoint's kernel for (dtype, route, NU, form)
template <typename T, int V>
const void* bwd_kernel_of(int nu, bool gated) {
  if constexpr (V == 1) {
    return gated ? reinterpret_cast<const void*>(rms_norm_bwd_kernel<T, 1, 16, true>)
                 : reinterpret_cast<const void*>(rms_norm_bwd_kernel<T, 1, 16, false>);
  } else {
    switch (nu) {
      case 1:
        return gated ? reinterpret_cast<const void*>(rms_norm_bwd_kernel<T, V, 1, true>)
                     : reinterpret_cast<const void*>(rms_norm_bwd_kernel<T, V, 1, false>);
      case 2:
        return gated ? reinterpret_cast<const void*>(rms_norm_bwd_kernel<T, V, 2, true>)
                     : reinterpret_cast<const void*>(rms_norm_bwd_kernel<T, V, 2, false>);
      default:
        return gated ? reinterpret_cast<const void*>(rms_norm_bwd_kernel<T, V, 4, true>)
                     : reinterpret_cast<const void*>(rms_norm_bwd_kernel<T, V, 4, false>);
    }
  }
}

const void* bwd_kernel(bool bf16, bool vector, int nu, bool gated) {
  if (bf16) return vector ? bwd_kernel_of<__nv_bfloat16, 8>(nu, gated)
                          : bwd_kernel_of<__nv_bfloat16, 1>(nu, gated);
  return vector ? bwd_kernel_of<float, 4>(nu, gated) : bwd_kernel_of<float, 1>(nu, gated);
}

// The one-pass adjoint's kernel, block and shared memory for a plan; its
// shared memory allowed where it exceeds the default 48 KB
cudaError_t bwd_launch_shape(bool bf16, bool vector, int nu, bool gated, long long d, int tpr,
                             const void** fn, int* block, size_t* smem) {
  const int v = vector ? 16 / (bf16 ? 2 : 4) : 1;
  *fn = bwd_kernel(bf16, vector, nu, gated);
  *block = bwd_block(tpr);
  const bool staged = vector && (gated ? nu == 1 : nu <= 2);
  const long long span = static_cast<long long>(nu) * v * tpr;
  *smem = static_cast<size_t>(bwd_smem_bytes(span, d / v, *block / tpr, gated, staged, nu,
                                             *block));
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// The forward. mode as above; for the plain form x (rows, d) at row stride
// x_stride; for the gated form y, xh, z, D as `Args` says, rows = B * S,
// heads of P elements; scale (d,); out (rows, d) contiguous; rstd (rows,)
// f32 or null; tpr the threads of a row (`plan` in kernels/rms_norm.py).
// The grid holds every row, 256 / tpr rows a block (one where tpr >= 256).
extern "C" int rms_norm_fwd(int mode, const void* x, const void* y, const void* xh, const void* z,
                            const float* D, const void* scale, void* out, float* rstd,
                            long long rows, long long d, long long x_stride, long long S,
                            long long P, const long long* strides, float eps, int tpr,
                            void* stream) {
  const bool vector = mode & 1, bf16 = mode & MODE_DTYPE, gated = mode & MODE_GATED,
             y_f32 = mode & MODE_Y_F32;
  const int device = mode >> MODE_DEVICE_SHIFT;
  const int esize = bf16 ? 2 : 4;
  const int v = vector ? 16 / esize : 1;
  if (rows < 0 || d < 1 || !plan_ok(d, v, tpr) || !scale || (rows > 0 && !out) ||
      (gated && (S < 1 || P < 1 || P % v != 0 || d % P != 0 || !y || !xh || !z || !D || !strides)) ||
      (!gated && rows > 0 && !x) || (y_f32 && (!gated || !bf16)))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (vector && (!aligned16(scale) || !aligned16(out) ||
                 (gated ? !aligned16(y) || !aligned16(xh) || !aligned16(z)
                        : !aligned16(x) || (x_stride * esize) % 16 != 0)))
    return cudaErrorInvalidValue;
  Args a = {};
  a.x = x; a.y = y; a.xh = xh; a.z = z; a.D = D; a.scale = scale; a.out = out; a.rstd = rstd;
  a.rows = rows; a.d = d; a.x_stride = x_stride; a.S = S; a.P = P; a.eps = eps; a.tpr = tpr;
  if (gated) {
    a.ysb = strides[0]; a.yss = strides[1]; a.ysh = strides[2];
    a.xsb = strides[3]; a.xss = strides[4]; a.zsb = strides[5]; a.zss = strides[6];
    if (vector) {
      const int ysize = y_f32 ? 4 : esize;
      for (int i = 0; i < 3; ++i)
        if ((strides[i] * ysize) % 16 != 0) return cudaErrorInvalidValue;
      for (int i = 3; i < 7; ++i)
        if ((strides[i] * esize) % 16 != 0) return cudaErrorInvalidValue;
    }
  }
  const int block = block_for(tpr);
  const long long groups = block / tpr;
  const long long blocks = (rows + groups - 1) / groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  OnDevice on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
#define B4_FWD(T, TY, V, G) rms_norm_fwd_kernel<T, TY, V, G><<<grid, block, 0, st>>>(a)
  if (bf16) {
    if (gated) {
      if (y_f32) {
        if (vector) B4_FWD(__nv_bfloat16, float, 8, true); else B4_FWD(__nv_bfloat16, float, 1, true);
      } else {
        if (vector) B4_FWD(__nv_bfloat16, __nv_bfloat16, 8, true);
        else B4_FWD(__nv_bfloat16, __nv_bfloat16, 1, true);
      }
    } else {
      if (vector) B4_FWD(__nv_bfloat16, __nv_bfloat16, 8, false);
      else B4_FWD(__nv_bfloat16, __nv_bfloat16, 1, false);
    }
  } else {
    if (gated) {
      if (vector) B4_FWD(float, float, 4, true); else B4_FWD(float, float, 1, true);
    } else {
      if (vector) B4_FWD(float, float, 4, false); else B4_FWD(float, float, 1, false);
    }
  }
#undef B4_FWD
  return cudaGetLastError();
}

// Blocks of the one-pass adjoint for (mode's dtype, route and form, nu,
// tpr, d) that an SM of the current device holds at once, its shared
// memory included, or minus the error.
extern "C" int rms_norm_bwd_residency(int mode, int nu, int tpr, long long d) {
  const bool vector = mode & 1, bf16 = mode & MODE_DTYPE, gated = mode & MODE_GATED;
  const int v = vector ? 16 / (bf16 ? 2 : 4) : 1;
  if (d < 1 || !bwd_plan_ok(d, v, nu, tpr)) return -cudaErrorInvalidValue;
  OnDevice on(mode >> MODE_DEVICE_SHIFT);
  const void* fn;
  int block, n = 0;
  size_t smem;
  cudaError_t err = bwd_launch_shape(bf16, vector, nu, gated, d, tpr, &fn, &block, &smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, block, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The registers a thread and the local memory (stack frame, spills
// included) of the adjoint's kernel for (mode's dtype, route and form, nu),
// from the runtime.
extern "C" int rms_norm_bwd_attributes(int mode, int nu, int* regs, int* local_bytes) {
  const bool vector = mode & 1, bf16 = mode & MODE_DTYPE, gated = mode & MODE_GATED;
  if (!regs || !local_bytes) return cudaErrorInvalidValue;
  if (vector ? nu != 1 && nu != 2 && nu != 4 : nu != 16) return cudaErrorInvalidValue;
  const void* fn = bwd_kernel(bf16, vector, nu, gated);
  OnDevice on(mode >> MODE_DEVICE_SHIFT);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return err;
}

// The adjoint. mode as the forward's (y of the dtype); g (rows, d) the output's
// gradient, contiguous; rstd_in (rows,) the forward's; the plain form
// writes dx (rows, d) contiguous into out; the gated form writes dy at y's
// strides (strides[7..9]), dxh and dz (rows, d) contiguous and dD (H,) f32;
// both write dscale (d,) in the dtype. tpr and nu the one-pass plan
// (`bwd_plan` in kernels/rms_norm.py); part (blocks, d) and, gated, part_d
// (blocks, H) f32 scratch, blocks the grid (`bwd_blocks`).
extern "C" int rms_norm_bwd(int mode, const void* x, const void* y, const void* xh, const void* z,
                            const float* D, const void* scale, const void* g,
                            const float* rstd_in, void* dx, void* dy, void* dxh, void* dz,
                            float* dD, void* dscale, float* part, float* part_d,
                            long long rows, long long d, long long x_stride, long long S,
                            long long P, const long long* strides, int tpr, int nu,
                            long long blocks, void* stream) {
  const bool vector = mode & 1, bf16 = mode & MODE_DTYPE, gated = mode & MODE_GATED;
  const int device = mode >> MODE_DEVICE_SHIFT;
  const int esize = bf16 ? 2 : 4;
  const int v = vector ? 16 / esize : 1;
  if (rows < 0 || rows > 0x7fffffffLL || d < 1 || !bwd_plan_ok(d, v, nu, tpr) || blocks < 1 ||
      blocks > 0x7fffffffLL || !scale || !dscale || !part || (mode & MODE_Y_F32) ||
      (rows > 0 && (!g || !rstd_in)) ||
      (gated && (S < 1 || P < 1 || P % v != 0 || d % P != 0 || !y || !xh || !z || !D || !dD ||
                 !strides || !part_d || (rows > 0 && (!dy || !dxh || !dz)))) ||
      (!gated && rows > 0 && (!x || !dx)))
    return cudaErrorInvalidValue;
  if (vector && (!aligned16(scale) || !aligned16(g) ||
                 (gated ? !aligned16(y) || !aligned16(xh) || !aligned16(z) || !aligned16(dy) ||
                              !aligned16(dxh) || !aligned16(dz)
                        : !aligned16(x) || !aligned16(dx) || (x_stride * esize) % 16 != 0)))
    return cudaErrorInvalidValue;
  Args a = {};
  a.x = x; a.y = y; a.xh = xh; a.z = z; a.D = D; a.scale = scale; a.g = g; a.rstd_in = rstd_in;
  a.out = dx; a.dy = dy; a.dxh = dxh; a.dz = dz; a.part = part; a.part_d = part_d;
  a.rows = rows; a.d = d; a.x_stride = x_stride; a.S = S; a.P = P; a.tpr = tpr;
  if (gated) {
    a.ysb = strides[0]; a.yss = strides[1]; a.ysh = strides[2];
    a.xsb = strides[3]; a.xss = strides[4]; a.zsb = strides[5]; a.zss = strides[6];
    a.dysb = strides[7]; a.dyss = strides[8]; a.dysh = strides[9];
    if (vector)
      for (int i = 0; i < 10; ++i)
        if ((strides[i] * esize) % 16 != 0) return cudaErrorInvalidValue;
  }
  OnDevice on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  const void* fn;
  int block;
  size_t smem;
  cudaError_t err = bwd_launch_shape(bf16, vector, nu, gated, d, tpr, &fn, &block, &smem);
  void* params[] = {&a};
  if (err == cudaSuccess) err = cudaLaunchKernel(fn, grid, dim3(block), params, smem, st);
  if (err != cudaSuccess) return err;
  const long long n2 = gated ? d / P : 0;
  const unsigned sum_blocks = static_cast<unsigned>((d + n2 + SUM_COLS - 1) / SUM_COLS);
  norm_sum_partials<<<sum_blocks, SUM_COLS * SUM_WARPS, 0, st>>>(part, d, bf16 ? 1 : 0, dscale,
                                                                 part_d, n2, dD, blocks);
  return cudaGetLastError();
}

extern "C" const char* rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
