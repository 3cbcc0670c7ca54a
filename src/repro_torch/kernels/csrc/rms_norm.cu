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
// Each block sums its rows' dscale and dD in f32 (its row groups in order),
// writes one partial row, and a second kernel (`norm_sum_partials`) adds the
// partial rows in a fixed order (8 warps a column, each over every 8th
// row, 8 rows' loads in flight, then the warps in order) and rounds once.
//
// Layouts: the plain form reads rows of x at a row stride (the last dim
// contiguous); the gated form reads y at its (b, s, h) strides (the SSD
// kernel's (B, H, S, P) buffer seen as (B, S, H, P)), xh and z at their
// row strides inside the convolution's output and the input projection,
// and writes dy at y's strides, so the SSD kernel's adjoint takes it as it
// is. No copy is made of any input.
//
// What bounds both on this card: bytes. A row is read once (twice by the
// adjoint, the second time from L2) with ~10 (forward) to ~40 (gated
// adjoint, SiLU's exp twice) f32 operations an element. mamba2-1.3b's
// training shape (4 x 1024 rows): the gated forward reads y, xh and z and
// writes the output (4096 wide, bf16) and rstd: 134 MB, 0.040 ms at
// 3.35 TB/s; its adjoint reads y, xh, z and G and writes dy, dxh and dz:
// 235 MB, 0.070 ms. What the design does about it:
// * a row is split over TPR threads (a power of two, 4 at width 128, 512 at
//   16384), each holding at most ELEMS elements in registers, moved in
//   16-byte units (8 bf16 or 4 f32, the `vector` route) where every row
//   start and stride is 16-byte aligned and the width (and a head, for the
//   gated form) a whole number of units, else element by element (the
//   `scalar` route). A thread's units are TPR units apart, so the warp's
//   loads are contiguous;
// * a block of max(256, TPR) threads holds 256 / TPR rows at once, so rows
//   of 128 fill whole warps;
// * the forward keeps the row in registers between the sum and the output;
//   the adjoint makes two passes over the row (the dot, then the outputs),
//   the second read from L2, so its registers hold only the dscale and dD
//   accumulators; its blocks walk the rows with a grid stride, at most 2
//   blocks an SM (what its registers hold; `bwd_blocks` in
//   kernels/rms_norm.py), so the partial rows stay few (264 x d f32: 8% of
//   the adjoint's bytes at mamba2's d 2048, 2% for the gated form at 4096).
//
// Entry points: `rms_norm_fwd` and `rms_norm_bwd`, plain C functions that
// launch on the given stream of the given device and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int ELEMS = 32;          // elements of a row a thread holds, at most
constexpr int MAX_TPR = 512;       // threads of a row, at most: widths to 16384
constexpr int ROW_BLOCK = 256;     // threads a block where a row takes fewer
constexpr int MAX_BLOCK = 512;
constexpr int SMEM_WIDTH = (ROW_BLOCK / 2) * ELEMS;   // widest row a block holds two of
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
  float* part_d;          // adjoint, gated: (blocks, d / V) f32 partial dD a unit
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

// The gated form's inputs of one unit (element e of a row, e < d <= 16384):
// pre = y + xh * D (f32), then yT = round(pre), sz = round(silu(z)),
// g = round(yT * sz); returns g in gv, and yT, sz, z, xh and sigmoid(z)
// (for the adjoint; a fast reciprocal of the same 1 + exp(-z)) where asked
template <typename T, typename TY, int V>
__device__ __forceinline__ void gated_unit(const Args& a, long long b, long long s, int e,
                                           float* gv, float* yt, float* szv, float* zv,
                                           float* xhv, float* sig) {
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
    if (yt) yt[j] = yT;
    if (szv) szv[j] = sz;
    if (zv) zv[j] = zz[j];
    if (xhv) xhv[j] = xv[j];
    if (sig) sig[j] = __fdividef(1.0f, t);
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
        gated_unit<T, TY, V>(a, b, s, static_cast<int>(u) * V, xv[k], nullptr, nullptr, nullptr,
                               nullptr, nullptr);
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

// Adds `acc`, a row group's values for its columns (the k-th at column
// (lane + (k / per) * tpr) * per + k % per), over the block's row groups in
// order into `dst` through `buf`, or writes them straight there where the
// block holds one row group. Every thread of the block calls it.
template <int N>
__device__ __forceinline__ void block_columns(const float (&acc)[N], int lane, int tpr, int per,
                                              long long ncols, float* buf, float* dst) {
  const int groups = blockDim.x / tpr, rg = threadIdx.x / tpr;
  if (groups == 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const long long c = (lane + static_cast<long long>(k / per) * tpr) * per + k % per;
      if (c < ncols) dst[c] = acc[k];
    }
    return;
  }
  for (int q = 0; q < groups; ++q) {
    if (rg == q) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const long long c = (lane + static_cast<long long>(k / per) * tpr) * per + k % per;
        if (c < ncols) buf[c] = q == 0 ? acc[k] : __fadd_rn(buf[c], acc[k]);
      }
    }
    __syncthreads();
  }
  for (long long c = threadIdx.x; c < ncols; c += blockDim.x) dst[c] = buf[c];
  __syncthreads();
}

template <typename T, int V, bool GATED>
__global__ void __launch_bounds__(MAX_BLOCK) rms_norm_bwd_kernel(const Args a) {
  constexpr int UPT = ELEMS / V;
  __shared__ float red[MAX_BLOCK / 32];
  __shared__ float buf[SMEM_WIDTH];
  const int tpr = a.tpr;
  const int lane = threadIdx.x % tpr;
  const int groups = blockDim.x / tpr;
  const long long units = a.d / V;
  const float inv_d = 1.0f / static_cast<float>(a.d);
  float acc_s[UPT * V];                  // dscale of this thread's columns
  float acc_d[UPT];                      // dD of this thread's units
#pragma unroll
  for (int k = 0; k < UPT * V; ++k) acc_s[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < UPT; ++k) acc_d[k] = 0.0f;
  // every row group walks rows a grid's worth apart; the block runs its
  // row groups' loops together (row_sum syncs the block)
  const long long stride = static_cast<long long>(gridDim.x) * groups;
  const long long first = static_cast<long long>(blockIdx.x) * groups;
  for (long long base = first; base < a.rows; base += stride) {
    const long long row = base + threadIdx.x / tpr;
    const bool live = row < a.rows;
    const long long b = GATED ? row / a.S : 0, s = GATED ? row - b * a.S : 0;
    const T* grow = static_cast<const T*>(a.g) + row * a.d;
    // pass 1: dot = sum of (G * scale) * x over the row
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < UPT; ++k) {
      const long long u = lane + static_cast<long long>(k) * tpr;
      if (live && u < units) {
        float xv[V], gv[V], sc[V];
        if constexpr (GATED) {
          gated_unit<T, T, V>(a, b, s, static_cast<int>(u) * V, xv, nullptr, nullptr, nullptr,
                              nullptr, nullptr);
        } else {
          load_unit<T, V>(static_cast<const T*>(a.x) + row * a.x_stride + u * V, xv);
        }
        load_unit<T, V>(grow + u * V, gv);
        load_unit<T, V>(static_cast<const T*>(a.scale) + u * V, sc);
#pragma unroll
        for (int j = 0; j < V; ++j) dot = __fadd_rn(dot, __fmul_rn(__fmul_rn(gv[j], sc[j]), xv[j]));
      }
    }
    dot = row_sum(dot, tpr, red);
    if (!live) continue;
    const float r = a.rstd_in[row];
    const float c = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(r, r), r), dot), inv_d);
    // pass 2: the outputs and the accumulators
#pragma unroll
    for (int k = 0; k < UPT; ++k) {
      const long long u = lane + static_cast<long long>(k) * tpr;
      if (u >= units) continue;
      const long long e = u * V;
      float xv[V], gv[V], sc[V], yt[V], szv[V], zv[V], xhv[V], sg[V], dx[V];
      if constexpr (GATED) {
        gated_unit<T, T, V>(a, b, s, static_cast<int>(e), xv, yt, szv, zv, xhv, sg);
      } else {
        load_unit<T, V>(static_cast<const T*>(a.x) + row * a.x_stride + e, xv);
      }
      load_unit<T, V>(grow + e, gv);
      load_unit<T, V>(static_cast<const T*>(a.scale) + e, sc);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc_s[k * V + j] = __fadd_rn(acc_s[k * V + j], __fmul_rn(gv[j], rnd<T>(__fmul_rn(xv[j], r))));
        const float dn = __fmul_rn(gv[j], sc[j]);
        dx[j] = __fsub_rn(__fmul_rn(r, dn), __fmul_rn(xv[j], c));
      }
      if constexpr (GATED) {
        const int P = static_cast<int>(a.P);
        const int h = static_cast<int>(e) / P, p = static_cast<int>(e) - h * P;
        const float dh = a.D[h];
        float dpre[V], dxh[V], dzv[V];
        float part = 0.0f;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          dpre[j] = __fmul_rn(dx[j], szv[j]);
          dxh[j] = __fmul_rn(dpre[j], dh);
          part = __fadd_rn(part, __fmul_rn(dpre[j], xhv[j]));
          const float ds = __fmul_rn(sg[j], __fadd_rn(1.0f, __fmul_rn(zv[j], __fsub_rn(1.0f, sg[j]))));
          dzv[j] = __fmul_rn(__fmul_rn(dx[j], yt[j]), ds);
        }
        acc_d[k] = __fadd_rn(acc_d[k], part);
        store_unit<T, V>(static_cast<T*>(a.dy) + b * a.dysb + s * a.dyss + h * a.dysh + p, dpre);
        store_unit<T, V>(static_cast<T*>(a.dxh) + row * a.d + e, dxh);
        store_unit<T, V>(static_cast<T*>(a.dz) + row * a.d + e, dzv);
      } else {
        store_unit<T, V>(static_cast<T*>(a.out) + row * a.d + e, dx);
      }
    }
  }
  // this block's partial row of dscale (and of dD a unit)
  block_columns<UPT * V>(acc_s, lane, tpr, V, a.d, buf,
                         a.part + static_cast<long long>(blockIdx.x) * a.d);
  if constexpr (GATED) {
    block_columns<UPT>(acc_d, lane, tpr, 1, units, buf,
                       a.part_d + static_cast<long long>(blockIdx.x) * units);
  }
}

// out1[c] = round(sum over g < blocks of part1[g][c]) for c < n1, in the
// dtype `bf16` says; out2[q] = sum over g and k < group of
// part2[g][q * group + k] (f32) for q < n2, part2's rows `units` long. A
// block takes SUM_COLS outputs, its SUM_WARPS warps the partial rows g
// congruent to the warp mod SUM_WARPS, each in order from +0.0, SUM_BATCH
// rows' loads in flight at a time; then the warps' sums are added in warp
// order: a fixed order, whatever the timing.
constexpr int SUM_COLS = 32, SUM_WARPS = 8, SUM_BATCH = 8;
__global__ void __launch_bounds__(SUM_COLS * SUM_WARPS) norm_sum_partials(
    const float* part1, long long n1, int bf16, void* out1, const float* part2, long long units,
    long long group, long long n2, float* out2, long long blocks) {
  __shared__ float acc_w[SUM_WARPS][SUM_COLS];
  const int lane = threadIdx.x % SUM_COLS, w = threadIdx.x / SUM_COLS;
  const long long o = static_cast<long long>(blockIdx.x) * SUM_COLS + lane;
  float acc = 0.0f;
  if (o < n1 + n2) {
    const bool first = o < n1;
    const float* base = first ? part1 + o : part2 + (o - n1) * group;
    const long long row = first ? n1 : units, per = first ? 1 : group;
    for (long long g0 = w; g0 < blocks; g0 += SUM_WARPS * SUM_BATCH) {
      for (long long k = 0; k < per; ++k) {
        float v[SUM_BATCH];
#pragma unroll
        for (int i = 0; i < SUM_BATCH; ++i) {
          const long long g = g0 + static_cast<long long>(i) * SUM_WARPS;
          v[i] = g < blocks ? base[g * row + k] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < SUM_BATCH; ++i)
          if (g0 + static_cast<long long>(i) * SUM_WARPS < blocks) acc = __fadd_rn(acc, v[i]);
      }
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The launch's shape checks: tpr a power of two no larger than MAX_TPR whose
// threads hold the row, the block max(ROW_BLOCK, tpr)
bool plan_ok(long long d, int v, int tpr) {
  if (tpr < 1 || tpr > MAX_TPR || (tpr & (tpr - 1)) != 0) return false;
  if (d % v != 0) return false;
  return static_cast<long long>(tpr) * (ELEMS / v) >= d / v;
}

int block_for(int tpr) { return tpr > ROW_BLOCK ? tpr : ROW_BLOCK; }

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

// The adjoint. mode as the forward's (y of the dtype); g (rows, d) the
// output's gradient, contiguous; rstd_in (rows,) the forward's; the plain
// form writes dx (rows, d) contiguous into out; the gated form writes dy at
// y's strides (strides[7..9]), dxh and dz (rows, d) contiguous and dD (H,)
// f32; both write dscale (d,) in the dtype. part (blocks, d) and, gated,
// part_d (blocks, d / V) f32 scratch, blocks the grid (`plan`).
extern "C" int rms_norm_bwd(int mode, const void* x, const void* y, const void* xh, const void* z,
                            const float* D, const void* scale, const void* g,
                            const float* rstd_in, void* dx, void* dy, void* dxh, void* dz,
                            float* dD, void* dscale, float* part, float* part_d,
                            long long rows, long long d, long long x_stride, long long S,
                            long long P, const long long* strides, int tpr, long long blocks,
                            void* stream) {
  const bool vector = mode & 1, bf16 = mode & MODE_DTYPE, gated = mode & MODE_GATED;
  const int device = mode >> MODE_DEVICE_SHIFT;
  const int esize = bf16 ? 2 : 4;
  const int v = vector ? 16 / esize : 1;
  if (rows < 0 || d < 1 || !plan_ok(d, v, tpr) || blocks < 1 || blocks > 0x7fffffffLL ||
      !scale || !dscale || !part || (mode & MODE_Y_F32) ||
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
  const int block = block_for(tpr);
  OnDevice on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
#define B4_BWD(T, V, G) rms_norm_bwd_kernel<T, V, G><<<grid, block, 0, st>>>(a)
  if (bf16) {
    if (gated) {
      if (vector) B4_BWD(__nv_bfloat16, 8, true); else B4_BWD(__nv_bfloat16, 1, true);
    } else {
      if (vector) B4_BWD(__nv_bfloat16, 8, false); else B4_BWD(__nv_bfloat16, 1, false);
    }
  } else {
    if (gated) {
      if (vector) B4_BWD(float, 4, true); else B4_BWD(float, 1, true);
    } else {
      if (vector) B4_BWD(float, 4, false); else B4_BWD(float, 1, false);
    }
  }
#undef B4_BWD
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long units = d / v;
  const long long n2 = gated ? d / P : 0;
  const long long total = d + n2;
  norm_sum_partials<<<static_cast<unsigned>((total + SUM_COLS - 1) / SUM_COLS),
                      SUM_COLS * SUM_WARPS, 0, st>>>(
      part, d, bf16 ? 1 : 0, dscale, part_d, units, gated ? P / v : 1, n2, dD, blocks);
  return cudaGetLastError();
}

extern "C" const char* rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
