// Mamba2's causal depthwise convolution, forward and adjoint (sm_90a),
// CUDA C++: B5.
//
// Replaces no Pallas kernel. The kernels stand for what XLA fuses under the
// reference's `jax.jit` out of `causal_conv1d` (src/repro/models/ssm.py:76):
// the history's concatenation, W taps over (B, S, C), the bias, then SiLU:
//   xin = [state, x]  (state the W-1 inputs before t = 0, zeros by default)
//   out[t] = silu(((0 + xin[t] * w[0]) + xin[t+1] * w[1] + ...) + b)
//   new_state = xin[S : S + W - 1]
// Every step is rounded where PyTorch's eager ops round it in the plain
// version (kernels/causal_conv.py `causal_conv1d_plain`): each tap's product
// rounded to x's dtype, then each add, the bias add, SiLU as
// `x / (1 + expf(-x))` rounded (bf16 through f32 with
// `__float2bfloat16_rn` after each op; f32 with `__fmul_rn` and `__fadd_rn`,
// so nvcc contracts nothing into an fma). So the output and the new state
// equal the plain version's bit for bit.
//
// The adjoint (`CausalConv1dFn` in kernels/causal_conv.py) recomputes the
// pre-activation with the same roundings and, in f32, with G the output's
// gradient:
//   dpre[u] = G[u] * silu'(pre[u]),  silu'(v) = s * (1 + v * (1 - s)), s = sigmoid(v)
//   dx[t]   = sum over taps i of dpre[t + W - 1 - i] * w[i]   (i ascending)
//   dw[i]   = sum over (b, u) of dpre[u] * xin[u + i],  db = sum over (b, u) of dpre[u]
//   dstate[j] = sum over i of dpre[j - i] * w[i] (j < W - 1), where asked
// dx is written in one (B, S, C) pass; dw and db go as f32 partials of
// blocks of rows (each block's row groups added in order) to a second
// kernel (`causal_conv_sum_partials`) that adds them in a fixed order and rounds
// once to w's dtype, as K3's backward has its sum pass.
//
// Layouts: x is read at its (b, s) strides with the channels contiguous:
// the model hands it the x|B|C columns of the input projection in place (one
// slice; the reference's concatenation of three). The state, w, b and every
// output are contiguous.
//
// What bounds both on this card: bytes. A channel's taps are W products and
// adds an element, SiLU one exp; the inputs are read once but for the W-1
// history rows a tile of L time steps reads again (L = 16: 19%). At
// mamba2-1.3b's training shape (4 x 1024 steps, 4352 channels, bf16) the
// forward reads x and writes the output: 71 MB, 0.021 ms at 3.35 TB/s; the
// adjoint reads x and G and writes dx: 107 MB, 0.032 ms. What the design
// does about it:
// * a thread owns a unit of channels over a tile of L time steps: 8 bytes
//   forward (4 bf16 or 2 f32), 4 bytes in the adjoint (2 bf16 or 1 f32;
//   with 8, its 128 registers spilled 760 bytes a thread), on the `vector`
//   route, where C and every row start are 8-byte aligned; else a channel,
//   the `scalar` route. A warp's 32 threads read 256 (128) contiguous bytes
//   of a row; a block is 32 units by 8 tiles;
// * the taps slide over the tile in registers, a row loaded a step (the
//   forward's tile loaded whole first ran 15% slower at mamba2's shape);
//   the adjoint's loop is unrolled over the tile's L + W - 1 steps, so each
//   value lives only as long as its taps, at most 128 registers a thread
//   (two blocks an SM or more);
// * both are held as much by instructions as by bytes: every tap's product
//   and sum is rounded to bf16 and SiLU's exp and division are the exact
//   ones (PyTorch's bits), some 60 instructions an element forward and 95
//   backward, 0.036 and 0.057 ms of issue at mamba2's shape;
// * the adjoint's blocks walk the tiles with a grid stride (about
//   CONV_BWD_BLOCKS a card's SM, `plan` in kernels/causal_conv.py), so the
//   f32 partials of dw and db stay few (16 x 5 x C at mamba2's shape,
//   1.4 MB).
//
// Entry points: `causal_conv1d_fwd` and `causal_conv1d_bwd`, plain C
// functions that launch on the given stream of the given device and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int L = 16;              // time steps a thread
constexpr int UNITS_X = 32;        // channel units a block (threadIdx.x)
constexpr int TILES_Y = 8;         // tiles a block (threadIdx.y)
constexpr int MAX_W = 4;

// An entry point's small arguments in one int: bit 0 the route (1 for
// 8-byte units), bit 1 the dtype (0 f32, 1 bf16), bits 2-4 the width W, the
// bits from 8 the device.
constexpr int MODE_DTYPE = 1 << 1;
constexpr int MODE_W_SHIFT = 2;
constexpr int MODE_DEVICE_SHIFT = 8;

struct Args {
  const void* x;          // (B, S, C) at (xsb, xss, 1)
  const void* state;      // (B, W-1, C) contiguous, or null (zeros)
  const void* w;          // (W, C)
  const void* b;          // (C,)
  const void* g;          // adjoint: (B, S, C) contiguous
  void* out;              // forward: (B, S, C); adjoint: dx (B, S, C)
  void* new_state;        // forward: (B, W-1, C), or null
  void* dstate;           // adjoint: (B, W-1, C), or null
  float* part;            // adjoint: (grid.y, W + 1, C) f32
  long long B, S, C, xsb, xss;
};

// xin[b][t + W - 1]'s unit at channel c: x[b][t] for 0 <= t < S, the state's
// row W - 1 + t for t < 0 (zeros without a state); t < S always
template <typename T, int V, int W>
__device__ __forceinline__ void load_in(const Args& a, long long b, long long t, long long c,
                                        float* f) {
  if (t >= 0) {
    load_unit<T, V>(static_cast<const T*>(a.x) + b * a.xsb + t * a.xss + c, f);
  } else if (a.state) {
    load_unit<T, V>(static_cast<const T*>(a.state) + (b * (W - 1) + (W - 1 + t)) * a.C + c, f);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = 0.0f;
  }
}

// The pre-activation of one unit: ((0 + x0 * w0) + x1 * w1 ...) + b, each
// product and sum rounded to T; xs the W inputs xin[t .. t + W - 1]
template <typename T, int V, int W>
__device__ __forceinline__ void pre_act(const float (&xs)[W][V], const float (&wv)[W][V],
                                        const float (&bv)[V], float* pre) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < W; ++i) acc = rnd<T>(__fadd_rn(acc, rnd<T>(__fmul_rn(xs[i][j], wv[i][j]))));
    pre[j] = rnd<T>(__fadd_rn(acc, bv[j]));
  }
}

// the adjoint's sigmoid: a fast reciprocal (2 ulps), within its tolerance
__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.0f, 1.0f + expf(-v)); }

template <typename T, int V, int W>
__global__ void __launch_bounds__(UNITS_X * TILES_Y) causal_conv_fwd_kernel(const Args a) {
  const long long units = a.C / V;
  const long long cu = static_cast<long long>(blockIdx.x) * UNITS_X + threadIdx.x;
  const long long tiles = (a.S + L - 1) / L;
  const long long q = static_cast<long long>(blockIdx.y) * TILES_Y + threadIdx.y;
  if (cu >= units || q >= a.B * tiles) return;
  const long long b = q / tiles, t0 = (q - b * tiles) * L, c = cu * V;
  float wv[W][V], bv[V];
#pragma unroll
  for (int i = 0; i < W; ++i) load_unit<T, V>(static_cast<const T*>(a.w) + i * a.C + c, wv[i]);
  load_unit<T, V>(static_cast<const T*>(a.b) + c, bv);
  float xs[W][V];                       // xin[t .. t + W - 1], the newest last
#pragma unroll
  for (int i = 0; i < W - 1; ++i) load_in<T, V, W>(a, b, t0 - (W - 1) + i, c, xs[i + 1]);
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const long long t = t0 + k;
    if (t < a.S) {
#pragma unroll
      for (int i = 0; i < W - 1; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) xs[i][j] = xs[i + 1][j];
      load_in<T, V, W>(a, b, t, c, xs[W - 1]);
      float pre[V], o[V];
      pre_act<T, V, W>(xs, wv, bv, pre);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = pre[j] / (1.0f + expf(-pre[j]));
      store_unit<T, V>(out + (b * a.S + t) * a.C + c, o);
    }
  }
  // the new state, xin[S .. S + W - 2], from the tile holding t = S - 1
  if (a.new_state && t0 + L >= a.S) {
#pragma unroll
    for (int k = 0; k < W - 1; ++k) {
      float f[V];
      load_in<T, V, W>(a, b, a.S - (W - 1) + k, c, f);
      store_unit<T, V>(static_cast<T*>(a.new_state) + (b * (W - 1) + k) * a.C + c, f);
    }
  }
}

template <typename T, int V, int W>
__global__ void __launch_bounds__(UNITS_X * TILES_Y, 2) causal_conv_bwd_kernel(const Args a) {
  __shared__ float buf[(MAX_W + 1) * UNITS_X * 4];
  const long long units = a.C / V;
  const long long cu = static_cast<long long>(blockIdx.x) * UNITS_X + threadIdx.x;
  const long long tiles = (a.S + L - 1) / L;
  const bool live_unit = cu < units;
  const long long c = cu * V;
  float wv[W][V], bv[V];
  float acc[W + 1][V];                  // dw[0..W-1], then db
#pragma unroll
  for (int i = 0; i <= W; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[i][j] = 0.0f;
  if (live_unit) {
#pragma unroll
    for (int i = 0; i < W; ++i) load_unit<T, V>(static_cast<const T*>(a.w) + i * a.C + c, wv[i]);
    load_unit<T, V>(static_cast<const T*>(a.b) + c, bv);
  }
  const long long step = static_cast<long long>(gridDim.y) * TILES_Y;
  for (long long q = static_cast<long long>(blockIdx.y) * TILES_Y + threadIdx.y;
       live_unit && q < a.B * tiles; q += step) {
    const long long b = q / tiles, t0 = (q - b * tiles) * L;
    // one pass over u = t0 .. t0 + L + W - 2 (u < S): xs[k] holds xin at
    // t0 + k (x at t0 - (W-1) + k), dp[k] dpre at t0 + k; dx[t] is written
    // once dp[t - t0 .. t - t0 + W - 1] are known. The loop is unrolled, so
    // each value lives in a register only as long as its taps need it.
    float xs[L + 2 * (W - 1)][V];
    float dp[L + W - 1][V];
#pragma unroll
    for (int k = 0; k < W - 1; ++k) load_in<T, V, W>(a, b, t0 - (W - 1) + k, c, xs[k]);
    T* dx = static_cast<T*>(a.out);
#pragma unroll
    for (int k = 0; k < L + W - 1; ++k) {
      const long long u = t0 + k;
      if (u < a.S) load_in<T, V, W>(a, b, u, c, xs[k + W - 1]);
#pragma unroll
      for (int j = 0; j < V; ++j) dp[k][j] = 0.0f;
      if (u < a.S) {
        float win[W][V], pre[V], gv[V];
#pragma unroll
        for (int i = 0; i < W; ++i)
#pragma unroll
          for (int j = 0; j < V; ++j) win[i][j] = xs[k + i][j];
        pre_act<T, V, W>(win, wv, bv, pre);
        load_unit<T, V>(static_cast<const T*>(a.g) + (b * a.S + u) * a.C + c, gv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float s = sigmoid(pre[j]);
          const float ds = __fmul_rn(s, __fadd_rn(1.0f, __fmul_rn(pre[j], __fsub_rn(1.0f, s))));
          dp[k][j] = __fmul_rn(gv[j], ds);
        }
        if (k < L) {                      // this tile's own steps: dw and db
#pragma unroll
          for (int j = 0; j < V; ++j) {
#pragma unroll
            for (int i = 0; i < W; ++i)
              acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(dp[k][j], xs[k + i][j]));
            acc[W][j] = __fadd_rn(acc[W][j], dp[k][j]);
          }
        }
      }
      // dx at t = t0 + k - (W-1): the sum over taps i of dp[k - i] * w[i]
      if (k >= W - 1 && t0 + k - (W - 1) < a.S) {
        float o[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float s = 0.0f;
#pragma unroll
          for (int i = 0; i < W; ++i) s = __fadd_rn(s, __fmul_rn(dp[k - i][j], wv[i][j]));
          o[j] = s;
        }
        store_unit<T, V>(dx + (b * a.S + t0 + k - (W - 1)) * a.C + c, o);
      }
      // the state's row k (k < W-1) of the first tile: dp[k - i] * w[i], i <= k
      if (k < W - 1 && a.dstate && t0 == 0) {
        float o[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float s = 0.0f;
#pragma unroll
          for (int i = 0; i <= k; ++i) s = __fadd_rn(s, __fmul_rn(dp[k - i][j], wv[i][j]));
          o[j] = s;
        }
        store_unit<T, V>(static_cast<T*>(a.dstate) + (b * (W - 1) + k) * a.C + c, o);
      }
    }
  }
  // the block's partial rows: its TILES_Y row groups added in order
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = 0; r < TILES_Y; ++r) {
    if (ty == r) {
#pragma unroll
      for (int i = 0; i <= W; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float& slot = buf[(i * UNITS_X + tx) * V + j];
          slot = r == 0 ? acc[i][j] : __fadd_rn(slot, acc[i][j]);
        }
    }
    __syncthreads();
  }
  if (ty == 0 && live_unit) {
    float* part = a.part + static_cast<long long>(blockIdx.y) * (W + 1) * a.C;
#pragma unroll
    for (int i = 0; i <= W; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) part[i * a.C + c + j] = buf[(i * UNITS_X + tx) * V + j];
  }
}

// out[o] = round(sum over g < rows of part[g][o]) for o < n, in order from +0.0
template <typename T>
__global__ void causal_conv_sum_partials(const float* part, long long n, long long rows, T* out) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= n) return;
  float acc = 0.0f;
  for (long long g = 0; g < rows; ++g) acc = __fadd_rn(acc, part[g * n + o]);
  if constexpr (sizeof(T) == 2) out[o] = __float2bfloat16_rn(acc);
  else out[o] = acc;
}

bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

// Shape, pointer and alignment checks shared by both entry points
bool args_ok(const Args& a, int w, bool vector, int esize, bool bwd) {
  if (a.B < 0 || a.S < 0 || a.C < 1 || w < 1 || w > MAX_W || !a.w || !a.b) return false;
  if (a.B * a.S > 0 && (!a.x || !a.out || (bwd && !a.g))) return false;
  if (!vector) return true;
  const int v = 8 / esize;
  const void* ptrs[] = {a.x, a.state, a.w, a.b, a.g, a.out, a.new_state, a.dstate};
  for (const void* p : ptrs)
    if (p && !aligned8(p)) return false;
  return a.C % v == 0 && (a.xsb * esize) % 8 == 0 && (a.xss * esize) % 8 == 0;
}

}  // namespace

// The forward. mode as above; x (B, S, C) at strides (xsb, xss, 1); state
// (B, W-1, C) or null; w (W, C), b (C,); out (B, S, C) and new_state
// (B, W-1, C) or null, contiguous.
extern "C" int causal_conv1d_fwd(int mode, const void* x, const void* state, const void* w,
                                 const void* b, void* out, void* new_state, long long B,
                                 long long S, long long C, long long xsb, long long xss,
                                 void* stream) {
  const bool vector = mode & 1, bf16 = mode & MODE_DTYPE;
  const int width = (mode >> MODE_W_SHIFT) & 7, device = mode >> MODE_DEVICE_SHIFT;
  Args a = {};
  a.x = x; a.state = state; a.w = w; a.b = b; a.out = out; a.new_state = new_state;
  a.B = B; a.S = S; a.C = C; a.xsb = xsb; a.xss = xss;
  const int esize = bf16 ? 2 : 4;
  if (!args_ok(a, width, vector, esize, false) || S < 1 || (width > 1 && B > 0 && !new_state))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int v = vector ? 8 / esize : 1;
  const long long units = C / v, tiles = (S + L - 1) / L;
  const long long gy = (B * tiles + TILES_Y - 1) / TILES_Y;
  if (gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((units + UNITS_X - 1) / UNITS_X), static_cast<unsigned>(gy));
  const dim3 block(UNITS_X, TILES_Y);
  OnDevice on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define B5_FWD(T, V, W) causal_conv_fwd_kernel<T, V, W><<<grid, block, 0, st>>>(a)
#define B5_FWD_W(T, V)                                                         \
  switch (width) {                                                             \
    case 1: B5_FWD(T, V, 1); break;                                            \
    case 2: B5_FWD(T, V, 2); break;                                            \
    case 3: B5_FWD(T, V, 3); break;                                            \
    default: B5_FWD(T, V, 4); break;                                           \
  }
  if (bf16) {
    if (vector) { B5_FWD_W(__nv_bfloat16, 4) } else { B5_FWD_W(__nv_bfloat16, 1) }
  } else {
    if (vector) { B5_FWD_W(float, 2) } else { B5_FWD_W(float, 1) }
  }
#undef B5_FWD_W
#undef B5_FWD
  return cudaGetLastError();
}

// The adjoint. mode, x, state, w, b as the forward's; g (B, S, C) the
// output's gradient, contiguous; writes dx (B, S, C), dstate (B, W-1, C)
// where not null, and dwb (W + 1, C): dw's W rows, then db, in w's dtype.
// part (grid_y, W + 1, C) f32 scratch, grid_y the blocks over the tiles
// (`plan` in kernels/causal_conv.py).
extern "C" int causal_conv1d_bwd(int mode, const void* x, const void* state, const void* w,
                                 const void* b, const void* g, void* dx, void* dstate, void* dwb,
                                 float* part, long long B, long long S, long long C,
                                 long long xsb, long long xss, long long grid_y, void* stream) {
  const bool vector = mode & 1, bf16 = mode & MODE_DTYPE;
  const int width = (mode >> MODE_W_SHIFT) & 7, device = mode >> MODE_DEVICE_SHIFT;
  Args a = {};
  a.x = x; a.state = state; a.w = w; a.b = b; a.g = g; a.out = dx; a.dstate = dstate;
  a.part = part; a.B = B; a.S = S; a.C = C; a.xsb = xsb; a.xss = xss;
  const int esize = bf16 ? 2 : 4;
  if (!args_ok(a, width, vector, esize, true) || S < 1 || !dwb || !part || grid_y < 1 ||
      grid_y > 65535 || (dstate && !state))
    return cudaErrorInvalidValue;
  const int v = vector ? 4 / esize : 1;            // 4-byte units: half the registers
  const long long units = C / v;
  const dim3 grid(static_cast<unsigned>((units + UNITS_X - 1) / UNITS_X),
                  static_cast<unsigned>(grid_y));
  const dim3 block(UNITS_X, TILES_Y);
  OnDevice on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define B5_BWD(T, V, W) causal_conv_bwd_kernel<T, V, W><<<grid, block, 0, st>>>(a)
#define B5_BWD_W(T, V)                                                         \
  switch (width) {                                                             \
    case 1: B5_BWD(T, V, 1); break;                                            \
    case 2: B5_BWD(T, V, 2); break;                                            \
    case 3: B5_BWD(T, V, 3); break;                                            \
    default: B5_BWD(T, V, 4); break;                                           \
  }
  if (bf16) {
    if (vector) { B5_BWD_W(__nv_bfloat16, 2) } else { B5_BWD_W(__nv_bfloat16, 1) }
  } else {
    B5_BWD_W(float, 1)
  }
#undef B5_BWD_W
#undef B5_BWD
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (width + 1) * C;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  if (bf16) causal_conv_sum_partials<<<blocks, 256, 0, st>>>(part, n, grid_y, static_cast<__nv_bfloat16*>(dwb));
  else causal_conv_sum_partials<<<blocks, 256, 0, st>>>(part, n, grid_y, static_cast<float*>(dwb));
  return cudaGetLastError();
}

extern "C" const char* causal_conv1d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
