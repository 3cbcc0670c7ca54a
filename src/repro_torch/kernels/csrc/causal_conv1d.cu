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
// dx is written in one (B, S, C) pass; dw and db go as f32 partial rows to
// a second kernel (`causal_conv_sum_partials`) that adds them in a fixed
// order and rounds once to w's dtype, as K3's backward has its sum pass.
//
// Layouts: x is read at its (b, s) strides with the channels contiguous:
// the model hands it the x|B|C columns of the input projection in place (one
// slice; the reference's concatenation of three). The state, w, b and every
// output are contiguous.
//
// What bounds both on this card: bytes. At mamba2-1.3b's training shape
// (4 x 1024 steps, 4352 channels, bf16) the forward reads x and writes the
// output: 71 MB, 0.021 ms at 3.35 TB/s; the adjoint reads x and G and
// writes dx: 107 MB, 0.032 ms. Both are held as much by instructions and
// their latency as by bytes: every tap's product and sum is rounded to the
// dtype, and the forward's SiLU is PyTorch's own, the exact expf and an IEEE
// division (~20 instructions an element, two of them on the SFU).
//
// The forward's routes, by layout (kernels/causal_conv.py `fwd_route`):
// * `staged` (`causal_conv_fwd_kernel`): every layout TMA takes with more
//   than one step: x, out, the state and every pointer and row stride
//   16-byte aligned, C a whole number of 16 bytes (the model's x|B|C slice
//   of the projection, at training and prefill). A tile is 64 time steps of
//   one sequence by 256 bytes of channels (128 bf16, 64 f32). TMA boxes at
//   x's strides bring its 3 history rows (zero before t = 0) and one box a
//   segment of 8 steps (zero past S and C) into a ring of two stages on
//   mbarriers, 17 KB a stage. A warp forms one segment, a lane 8 bytes of
//   the chunk: two words, each a bf16 pair (or one f32) whose pre-activation
//   is packed `mul.rn.bf16x2`/`add.rn.bf16x2` (the adjoint's `pre_word`, each
//   rounding the exact result once, so the plain chain's bits); a warp
//   stores a step as 256 contiguous bytes. The segment's eight steps run
//   straight-line. SiLU, in bf16: a fast form (ex2.approx, rcp.approx)
//   wherever its f32 lies more than 32 ulps from a bf16 rounding boundary,
//   where it rounds as the exact chain does; the few elements it does not
//   settle are formed again after the loop by the exact chain (see the
//   kernel); f32 takes the exact chain. Rows before t = 0 come from the
//   state where one is given; the warp holding t = S - 1 writes the new
//   state. The grid is persistent: the SMs times the blocks an SM holds
//   (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`; `fwd_plan`), each over
//   a contiguous range of (chunk, sequence, segment) units, so the blocks'
//   work differs by one segment at most and the card runs one wave.
//   `__launch_bounds__(256, 3)`: 80 registers (bf16, W = 4), no local
//   memory, three blocks an SM. Held against the first design (8-byte
//   units over 16 steps a thread, one row in flight, every tap rounded in
//   f32, the exact SiLU) and against variants of its own in
//   examples/norm_conv_variants_torch.py: 16-byte lanes (which spill), four
//   blocks an SM (64 registers), one ring stage and the exact SiLU alone
//   were slower; three stages, two blocks an SM or 32-step tiles no faster;
//   left out, its SiLU costs a sixth of its time and its stores none.
// * `vector` (`causal_conv_fwd_window_kernel`, 8-byte units): a decode step
//   (S = 1, with the cache's state), where there is no tile to stage and
//   this kernel timed faster, and layouts 8-byte but not 16-byte aligned. A
//   thread owns 8 bytes of channels over 16 steps, a row loaded a step, the
//   taps sliding in registers; 32 units by 8 tiles a block.
// * `scalar`: the same kernel a channel a thread, for any other layout.
// The route follows the layout alone; a launch or build error raises.
//
// The adjoint (`causal_conv_bwd_kernel`, the `vector` route) stages its
// inputs in shared memory:
// * a tile is TL = 64 time steps of one sequence by a chunk of 128 bytes of
//   channels (64 bf16, 32 f32). Two TMA boxes bring it: x's rows t0 - 3 ..
//   t0 + 66 (the three history rows before the tile and the three after,
//   whose dpre the tile's last dx rows need; 70 rows, x read at its
//   strides, the rows before t = 0 and past S zero-filled) and G's rows
//   t0 .. t0 + 66, through a ring of two stages on mbarriers, so a block's
//   next tile is in flight while it computes this one. The halo reads
//   6 rows of 70 again (9%) and recomputes 3 dpre rows of 67 (4.5%);
// * a warp owns SEG = 8 steps of the tile, a lane one 4-byte word of the
//   chunk (a bf16 pair or one f32). The pre-activation is recomputed from
//   the words with packed `mul.rn.bf16x2` and `add.rn.bf16x2`: each rounds
//   the exact result once, as PyTorch's bf16 ops round their f32 result
//   (f32's 24 bits are at least 2 x 8 + 2, so the two roundings agree), so
//   it equals the forward's bit for bit (the `pre` output, tested). SiLU's
//   derivative, dx, dw and db stay f32. A warp writes dx for its steps as
//   soon as their four dpre are known; the last three need the next warp's
//   first three dpre, which each warp leaves in shared memory (`heads`)
//   before the block's one barrier a tile. The three steps after the tile
//   are formed one a warp by warps 0-2, into the slot after the last
//   segment's, so no warp forms more than 9 of a tile's 67 dpre;
// * the grid is persistent: as many blocks as the card holds at once
//   (`cudaOccupancyMaxActiveBlocksPerMultiprocessor` for this kernel times
//   the SMs; `plan` in kernels/causal_conv.py), each over a contiguous
//   range of the (chunk, sequence, 8-step segment) units, so every block
//   gets the same work within one segment and the card runs one wave.
//   `__launch_bounds__(256, 3)`: three blocks, 24 warps, an SM, its 80
//   registers unspilled (held to 64 for four blocks it spilled 272 bytes a
//   thread and ran 13% slower, examples/norm_conv_variants_torch.py);
// * dw and db: a lane adds its steps' terms in f32 registers; where its
//   range leaves a chunk, the block adds its warps in order and writes one
//   partial row for the chunk. A chunk's partial rows come from the few
//   blocks whose ranges cover it (`slots` of them at most), and the sum
//   pass finds them from the same arithmetic, so no atomics and a fixed
//   order.
// Shapes the staged route does not take (x, G or a row stride not 16-byte
// aligned, C not a whole number of 16 bytes) take the `scalar` route: the
// register-window kernel (`causal_conv_bwd_scalar_kernel`) a channel a
// thread, with its own sum pass (`causal_conv_sum_rows`).
//
// Entry points: `causal_conv1d_fwd`, `causal_conv1d_bwd`, and
// `causal_conv1d_{fwd,bwd}_residency` and `causal_conv1d_{fwd,bwd}_attributes`
// (what the runtime reports of each direction's kernels), plain C functions that
// launch on the given stream of the given device and return 0 or an error
// code that `causal_conv1d_error_string` names.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "common.cuh"

namespace {

constexpr int L = 16;              // window forward and scalar adjoint: time steps a thread
constexpr int UNITS_X = 32;        // channel units a block (threadIdx.x)
constexpr int TILES_Y = 8;         // tiles a block (threadIdx.y)
constexpr int MAX_W = 4;

// the staged adjoint's layout
constexpr int TL = 64;                     // time steps a tile
constexpr int SEG = 8;                     // time steps a warp
constexpr int WARPS = TL / SEG;            // a block's warps
constexpr int HALO = MAX_W - 1;            // the rows a tile reads beyond its steps, each side
constexpr int ROW_BYTES = 128;             // a tile's chunk of channels: a 4-byte word a lane
constexpr int X_ROWS = TL + 2 * HALO;      // x: t0 - HALO .. t0 + TL + HALO - 1
constexpr int G_ROWS = TL + HALO;          // G: t0 .. t0 + TL + HALO - 1
constexpr int NSTAGES = 2;
constexpr int STAGE_BYTES = (X_ROWS + G_ROWS) * ROW_BYTES;
constexpr int HEAD_FLOATS = (WARPS + 1) * HALO * 64;    // a tile's heads: [slot][row][lane][2]
constexpr int FLUSH_FLOATS = (MAX_W + 1) * 64;          // dw, db of a block: [row][lane][2]
constexpr int SMEM_BYTES = 128 + NSTAGES * STAGE_BYTES + (2 * HEAD_FLOATS + FLUSH_FLOATS) * 4 +
                           8 * NSTAGES;

// the staged forward's layout: a tile is FWD_WARPS segments of FWD_SEG steps
// (a warp each) by FWD_ROW_BYTES of channels (8 bytes a lane)
constexpr int FWD_SEG = 8;
constexpr int FWD_WARPS = 8;
constexpr int FWD_ROW_BYTES = 256;
constexpr int FWD_STAGES = 2;
constexpr int FWD_MIN_BLOCKS = 3;          // blocks an SM, for __launch_bounds__
constexpr int FWD_STAGE_BYTES = (HALO + FWD_WARPS * FWD_SEG) * FWD_ROW_BYTES;
// the forward's SiLU for bf16: the fast form where |x| < SILU_FAST_MAX and its
// f32 lies more than SILU_SLACK ulps from a bf16 rounding boundary
constexpr float SILU_FAST_MAX = 16.0f;
constexpr unsigned SILU_SLACK = 32;
constexpr int FWD_SMEM_BYTES = 128 + FWD_STAGES * FWD_STAGE_BYTES + 8 * FWD_STAGES;

// An entry point's small arguments in one int: bits 0-1 the route (the
// forward's: FWD_*; the adjoint's: ROUTE_*), bit 2 the dtype (0 f32, 1
// bf16), bits 3-5 the width W, the bits from 8 the device.
constexpr int MODE_ROUTE = 3;
constexpr int FWD_SCALAR = 0, FWD_VECTOR = 1, FWD_STAGED = 2;
constexpr int ROUTE_SCALAR = 0, ROUTE_STAGED = 1;
constexpr int MODE_DTYPE = 1 << 2;
constexpr int MODE_W_SHIFT = 3;
constexpr int MODE_DEVICE_SHIFT = 8;
constexpr int ERR_ENTRY_POINT = 100000;    // cudaGetDriverEntryPoint failed
constexpr int ERR_ENCODE = 200000;         // + CUresult of cuTensorMapEncodeTiled

struct Args {
  const void* x;          // (B, S, C) at (xsb, xss, 1)
  const void* state;      // (B, W-1, C) contiguous, or null (zeros)
  const void* w;          // (W, C)
  const void* b;          // (C,)
  const void* g;          // adjoint: (B, S, C) contiguous
  void* out;              // forward: (B, S, C); adjoint: dx (B, S, C)
  void* new_state;        // forward: (B, W-1, C), or null
  void* dstate;           // adjoint: (B, W-1, C), or null
  void* pre;              // staged adjoint: the recomputed pre-activation (B, S, C), or null
  float* part;            // adjoint: (slots, W + 1, C) f32
  long long B, S, C, xsb, xss;
  long long units;        // staged kernels: chunks x B x segments
  long long nseg;         // staged kernels: segments a sequence
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

// The register-window forward: a thread owns a unit of channels (V
// elements) over a tile of L steps, a row loaded a step, the taps sliding in
// registers; 32 units by 8 tiles a block. The `vector` (V = 8 bytes) and
// `scalar` (V = 1) routes.
template <typename T, int V, int W>
__global__ void __launch_bounds__(UNITS_X * TILES_Y) causal_conv_fwd_window_kernel(const Args a) {
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

// The register-window adjoint: a thread owns a unit of channels (V
// elements) over a tile of L steps, the taps sliding in registers, blocks of
// UNITS_X units by TILES_Y tiles walking the tiles with a grid stride, each
// block's f32 dw and db one partial row (grid.y of them): the `scalar`
// route, at V = 1.
template <typename T, int V, int W>
__global__ void __launch_bounds__(UNITS_X * TILES_Y, 2)
    causal_conv_bwd_scalar_kernel(const Args a) {
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
__global__ void causal_conv_sum_rows(const float* part, long long n, long long rows, T* out) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= n) return;
  float acc = 0.0f;
  for (long long g = 0; g < rows; ++g) acc = __fadd_rn(acc, part[g * n + o]);
  if constexpr (sizeof(T) == 2) out[o] = __float2bfloat16_rn(acc);
  else out[o] = acc;
}


// ---- the staged adjoint ----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`. Rows outside the tensor
// (negative or past its extent) come back zero.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// packed bf16 pairs: the exact product or sum rounded once (no contraction)
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t badd2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// a 4-byte word of T as its NE = 4 / sizeof(T) elements, and back (rounded)
template <typename T>
__device__ __forceinline__ void unpack(uint32_t w, float* f) {
  if constexpr (sizeof(T) == 2) {
    f[0] = bf16_lo(w);
    f[1] = bf16_hi(w);
  } else {
    f[0] = __uint_as_float(w);
  }
}
template <typename T>
__device__ __forceinline__ uint32_t pack(const float* f) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[0], f[1]);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    return __float_as_uint(f[0]);
  }
}

// The pre-activation of a word, ((0 + x0 * w0) + x1 * w1 ...) + b with every
// product and sum rounded to T, from the W words xin[u .. u + W - 1]
template <typename T, int W>
__device__ __forceinline__ uint32_t pre_word(const uint32_t (&xw)[W], const uint32_t (&ww)[W],
                                             uint32_t bw) {
  if constexpr (sizeof(T) == 2) {
    uint32_t acc = 0u;                     // +0.0 in both halves, as the plain version starts
#pragma unroll
    for (int i = 0; i < W; ++i) acc = badd2(acc, bmul2(xw[i], ww[i]));
    return badd2(acc, bw);
  } else {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < W; ++i)
      acc = __fadd_rn(acc, __fmul_rn(__uint_as_float(xw[i]), __uint_as_float(ww[i])));
    return __float_as_uint(__fadd_rn(acc, __uint_as_float(bw)));
  }
}

// The block holding unit r when `units` are split over `grid` blocks, block
// g taking [g * units / grid, (g + 1) * units / grid)
__device__ __forceinline__ long long block_of(long long r, long long units, long long grid) {
  return ((r + 1) * grid - 1) / units;
}

// A block's walk over its range [lo, hi) of (chunk, sequence, segment)
// units (`nseg` segments of SEGL steps a sequence, `upc` = B x nseg units a
// chunk), a tile of at most TILE segments of one sequence at a time: the
// chunk, the sequence and the segment of the cursor, advanced without
// dividing (the units fewer than 2^31: the entry points check)
template <int SEGL, int TILE>
struct Walk {
  int unit, chunk, b, sg;
  __device__ __forceinline__ void start(long long lo, long long upc, long long nseg) {
    unit = static_cast<int>(lo);
    chunk = static_cast<int>(lo / upc);
    const int rem = static_cast<int>(lo - chunk * upc);
    b = rem / static_cast<int>(nseg);
    sg = rem - b * static_cast<int>(nseg);
  }
  // the tile at the cursor: its chunk, sequence and steps [t_lo, t_hi);
  // then the cursor moves past it
  __device__ __forceinline__ void next(long long hi, long long nseg, long long B, long long S,
                                       long long& c, long long& bb, long long& t_lo,
                                       long long& t_hi) {
    const int n = min(TILE, min(static_cast<int>(hi) - unit, static_cast<int>(nseg) - sg));
    c = chunk;
    bb = b;
    t_lo = static_cast<long long>(sg) * SEGL;
    t_hi = min(static_cast<long long>(sg + n) * SEGL, S);
    unit += n;
    sg += n;
    if (sg == nseg) {
      sg = 0;
      if (++b == B) {
        b = 0;
        ++chunk;
      }
    }
  }
};

// A cheaper SiLU for bf16 outputs: 2^(-x log2 e) by ex2.approx and the
// reciprocal by rcp.approx, each product and sum rounded on its own (no
// contraction, so one result an input wherever it is compiled)
__device__ __forceinline__ float silu_fast(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(__fmul_rn(v, -1.4426950408889634f)));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(__fadd_rn(1.0f, e)));
  return __fmul_rn(v, r);
}

// A lane's LW 4-byte words at p, in one load or store of 8 or 16 bytes
template <int LW>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[LW]) {
  if constexpr (LW == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else {
    static_assert(LW == 2, "a lane holds 8 or 16 bytes");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  }
}
template <int LW>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[LW]) {
  if constexpr (LW == 4) *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// The staged forward: a block walks its range of (chunk, sequence, segment)
// units a tile at a time. Thread 0 keeps FWD_STAGES tiles in flight, each
// brought by TMA boxes at x's strides: the HALO rows before the tile (zero
// before t = 0) and one box a segment (zero past S and C). A warp forms its
// segment's steps, a lane LW words of the chunk, the taps sliding in
// registers over rows read from shared memory; a warp's store of a step is
// FWD_ROW_BYTES contiguous bytes of out. The rows before t = 0 come from the
// state where one is given. The warp holding step S - 1 writes the new state.
//
// SiLU: each element rounded once to T from silu_exact's f32, as `F.silu`
// gives it. For bf16 the segment's loop is straight-line and takes the fast
// form everywhere, noting the elements where |x| >= SILU_FAST_MAX or its f32
// lies within SILU_SLACK ulps of a bf16 rounding boundary (the low 16 bits
// that near 0x8000): elsewhere it rounds as the exact chain does. After the
// loop a lane forms those few elements again from the stage by the exact
// chain and stores them over the fast ones. What a bf16 pre-activation
// gives is a function of it alone, so checking each of the 65,536 inputs
// on the card (the `cuda` tests, chip_smoke.py) shows the output equal to
// F.silu's everywhere.
template <typename T, int W>
__global__ void __launch_bounds__(FWD_WARPS * 32, FWD_MIN_BLOCKS)
    causal_conv_fwd_kernel(const __grid_constant__ CUtensorMap tm_halo,
                           const __grid_constant__ CUtensorMap tm_seg, const Args a) {
  constexpr int NE = 4 / int(sizeof(T));                   // elements a word
  constexpr int LW = FWD_ROW_BYTES / 128;                  // words a lane
  constexpr int EPL = LW * NE;                             // elements a lane
  constexpr int CH = FWD_ROW_BYTES / int(sizeof(T));       // channels a chunk
  constexpr bool FAST = sizeof(T) == 2;
  static_assert(FWD_SEG * EPL <= 64, "a segment's notes fit 64 bits");
  extern __shared__ unsigned char smem_raw[];
  // 128-byte aligned for TMA, as an offset into the array, so the rows are
  // read with shared-memory loads
  unsigned char* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + FWD_STAGES * FWD_STAGE_BYTES);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long S = a.S, C = a.C, nseg = a.nseg, upc = a.B * nseg;
  const long long grid = gridDim.x, g = blockIdx.x;
  const long long lo = g * a.units / grid, hi = (g + 1) * a.units / grid;
  if (lo >= hi) return;

  Walk<FWD_SEG, FWD_WARPS> load{};         // thread 0: the next tile to load
  auto issue = [&](int s) {
    long long chunk, b, t_lo, t_hi;
    load.next(hi, nseg, a.B, S, chunk, b, t_lo, t_hi);
    const int n = static_cast<int>((t_hi - t_lo + FWD_SEG - 1) / FWD_SEG);
    const uint32_t bar = smem_u32(&full[s]);
    const uint32_t dst = smem_u32(smem + s * FWD_STAGE_BYTES);
    const int c0 = static_cast<int>(chunk * CH), bi = static_cast<int>(b);
    mbar_expect_tx(bar, (HALO + n * FWD_SEG) * FWD_ROW_BYTES);
    tma_load_3d(dst, &tm_halo, bar, c0, static_cast<int>(t_lo - HALO), bi);
    for (int j = 0; j < n; ++j)
      tma_load_3d(dst + (HALO + j * FWD_SEG) * FWD_ROW_BYTES, &tm_seg, bar, c0,
                  static_cast<int>(t_lo + j * FWD_SEG), bi);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < FWD_STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load.start(lo, upc, nseg);
    for (int s = 0; s < FWD_STAGES && load.unit < hi; ++s) issue(s);
  }
  __syncthreads();

  // the lane's channels in the current chunk and their weights, word-major
  long long cur_chunk = -1, c = 0;
  bool live = false;
  uint32_t ww[LW][W], bw[LW];
  const T* state = static_cast<const T*>(a.state);
  Walk<FWD_SEG, FWD_WARPS> walk;
  walk.start(lo, upc, nseg);
  for (int it = 0; walk.unit < hi; ++it) {
    long long chunk, b, t_lo, t_hi;
    walk.next(hi, nseg, a.B, S, chunk, b, t_lo, t_hi);
    if (chunk != cur_chunk) {
      cur_chunk = chunk;
      c = chunk * CH + lane * EPL;
      live = c < C;
      if (live) {
#pragma unroll
        for (int i = 0; i < W; ++i) {
          uint32_t u[LW];
          load_words<LW>(static_cast<const T*>(a.w) + i * C + c, u);
#pragma unroll
          for (int q = 0; q < LW; ++q) ww[q][i] = u[q];
        }
        load_words<LW>(static_cast<const T*>(a.b) + c, bw);
      }
    }
    const int s = it % FWD_STAGES;
    mbar_wait(smem_u32(&full[s]), (it / FWD_STAGES) & 1);
    const long long seg_lo = t_lo + warp * FWD_SEG;
    const int own =
        static_cast<int>(max(0LL, min(static_cast<long long>(FWD_SEG), t_hi - seg_lo)));
    if (own > 0 && live) {
      // the lane's words of x at seg_lo + k, k from -HALO: in the stage, or
      // in the state before t = 0 where one is given
      const unsigned char* rows =
          smem + s * FWD_STAGE_BYTES + (warp * FWD_SEG + HALO) * FWD_ROW_BYTES + lane * 4 * LW;
      auto x_words = [&](int k, uint32_t (&u)[LW]) {
        const long long t = seg_lo + k;
        if (t < 0 && state != nullptr)
          load_words<LW>(state + (b * (W - 1) + (W - 1) + t) * C + c, u);
        else
          load_words<LW>(rows + k * FWD_ROW_BYTES, u);
      };
      uint32_t xw[LW][W];                  // a word's inputs xin at t .. t + W - 1
#pragma unroll
      for (int i = 0; i + 1 < W; ++i) {
        uint32_t u[LW];
        x_words(i - (W - 1), u);
#pragma unroll
        for (int q = 0; q < LW; ++q) xw[q][i + 1] = u[q];
      }
      // every step of the segment is formed (its rows are in the stage: zero
      // past S), so the loop is straight-line; steps past the tile are not
      // stored
      T* out = static_cast<T*>(a.out) + (b * S + seg_lo) * C + c;
      unsigned long long redo = 0;         // bit k * EPL + j: element j of step k
#pragma unroll
      for (int k = 0; k < FWD_SEG; ++k) {
        uint32_t u[LW], o[LW];
        load_words<LW>(rows + k * FWD_ROW_BYTES, u);
#pragma unroll
        for (int q = 0; q < LW; ++q) {
#pragma unroll
          for (int i = 0; i + 1 < W; ++i) xw[q][i] = xw[q][i + 1];
          xw[q][W - 1] = u[q];
          float f[NE];
          unpack<T>(pre_word<T, W>(xw[q], ww[q], bw[q]), f);
#pragma unroll
          for (int e = 0; e < NE; ++e) {
            if constexpr (FAST) {
              const float r = silu_fast(f[e]);
              const bool ok = fabsf(f[e]) < SILU_FAST_MAX &&
                              (__float_as_uint(r) & 0xffffu) - (0x8000u - SILU_SLACK) >
                                  2u * SILU_SLACK;
              redo |= static_cast<unsigned long long>(!ok) << (k * EPL + q * NE + e);
              f[e] = r;
            } else {
              f[e] = silu_exact(f[e]);
            }
          }
          o[q] = pack<T>(f);
        }
        if (k < own) store_words<LW>(out + k * C, o);
      }
      // the noted elements again, by the exact chain
      if constexpr (FAST) {
        while (redo != 0) {
          const int j = __ffsll(static_cast<long long>(redo)) - 1;
          redo &= redo - 1;
          const int k = j / EPL, q = (j % EPL) / NE, e = j % NE;
          if (k >= own) break;             // the notes go by step: the rest are not stored
          uint32_t xv[W], wv[W], bv = 0;
#pragma unroll
          for (int i = 0; i < W; ++i) {
            uint32_t u[LW];
            x_words(k - (W - 1) + i, u);
#pragma unroll
            for (int r = 0; r < LW; ++r)
              if (r == q) {
                xv[i] = u[r];
                wv[i] = ww[r][i];
                bv = bw[r];
              }
          }
          float f[NE];
          unpack<T>(pre_word<T, W>(xv, wv, bv), f);
          out[k * C + q * NE + e] = __float2bfloat16_rn(silu_exact(e == 0 ? f[0] : f[NE - 1]));
        }
      }
      // the new state, xin[S .. S + W - 2]: x's rows S - W + 1 .. S - 1, the
      // state's rows where those are before t = 0
      if (a.new_state != nullptr && seg_lo + own == S) {
        T* ns = static_cast<T*>(a.new_state) + b * (W - 1) * C + c;
#pragma unroll
        for (int k = 0; k + 1 < W; ++k) {
          uint32_t u[LW];
          x_words(static_cast<int>(S - (W - 1) + k - seg_lo), u);
          store_words<LW>(ns + k * C, u);
        }
      }
    }
    __syncthreads();                       // the stage is read
    if (threadIdx.x == 0 && load.unit < hi) issue(s);
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(WARPS * 32, 3)
    causal_conv_bwd_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_g, const Args a) {
  constexpr int NE = 4 / int(sizeof(T));             // elements a word
  constexpr int CH = ROW_BYTES / int(sizeof(T));     // channels a chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const uint32_t* ring = reinterpret_cast<const uint32_t*>(smem);
  float* heads = reinterpret_cast<float*>(smem + NSTAGES * STAGE_BYTES);
  float* fbuf = heads + 2 * HEAD_FLOATS;
  uint64_t* full = reinterpret_cast<uint64_t*>(fbuf + FLUSH_FLOATS);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long S = a.S, C = a.C, nseg = a.nseg, upc = a.B * nseg;
  const long long grid = gridDim.x, g = blockIdx.x;
  const long long lo = g * a.units / grid, hi = (g + 1) * a.units / grid;
  if (lo >= hi) return;

  Walk<SEG, WARPS> load{};                 // thread 0: the next tile to load
  auto issue = [&](int s) {
    long long chunk, b, t_lo, t_hi;
    load.next(hi, nseg, a.B, S, chunk, b, t_lo, t_hi);
    const uint32_t bar = smem_u32(&full[s]);
    const uint32_t dst = smem_u32(smem + s * STAGE_BYTES);
    mbar_expect_tx(bar, STAGE_BYTES);
    tma_load_3d(dst, &tm_x, bar, static_cast<int>(chunk * CH), static_cast<int>(t_lo - HALO),
                static_cast<int>(b));
    tma_load_3d(dst + X_ROWS * ROW_BYTES, &tm_g, bar, static_cast<int>(chunk * CH),
                static_cast<int>(t_lo), static_cast<int>(b));
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NSTAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load.start(lo, upc, nseg);
    for (int s = 0; s < NSTAGES && load.unit < hi; ++s) issue(s);
  }
  __syncthreads();

  // the lane's channels in the current chunk, its weights and accumulators
  long long cur_chunk = lo / upc;
  long long c = 0;
  bool live = false;
  uint32_t ww[W], bw = 0;
  float acc[W + 1][NE];                    // dw[0..W-1], then db
  auto take_chunk = [&](long long chunk) {
    cur_chunk = chunk;
    c = chunk * CH + lane * NE;
    live = c < C;
#pragma unroll
    for (int i = 0; i < W; ++i)
      ww[i] = live ? *reinterpret_cast<const uint32_t*>(static_cast<const T*>(a.w) + i * C + c)
                   : 0u;
    bw = live ? *reinterpret_cast<const uint32_t*>(static_cast<const T*>(a.b) + c) : 0u;
#pragma unroll
    for (int i = 0; i <= W; ++i)
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[i][e] = 0.0f;
  };
  // the block's warps added in order into one partial row of the chunk
  auto flush = [&]() {
    const long long slot = g - block_of(cur_chunk * upc, a.units, grid);
    for (int r = 0; r < WARPS; ++r) {
      if (warp == r) {
#pragma unroll
        for (int i = 0; i <= W; ++i)
#pragma unroll
          for (int e = 0; e < NE; ++e) {
            float& f = fbuf[(i * 32 + lane) * NE + e];
            f = r == 0 ? acc[i][e] : __fadd_rn(f, acc[i][e]);
          }
      }
      __syncthreads();
    }
    if (warp == 0 && live) {
#pragma unroll
      for (int i = 0; i <= W; ++i)
#pragma unroll
        for (int e = 0; e < NE; ++e)
          a.part[(slot * (W + 1) + i) * C + c + e] = fbuf[(i * 32 + lane) * NE + e];
    }
  };
  // sum over taps i of d[i] * w[i], from +0.0, i ascending
  auto taps = [&](const float (&d)[W][NE], uint32_t* out_word) {
    float o[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) o[e] = 0.0f;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      float wv[NE];
      unpack<T>(ww[i], wv);
#pragma unroll
      for (int e = 0; e < NE; ++e) o[e] = fmaf(d[i][e], wv[e], o[e]);
    }
    *out_word = pack<T>(o);
  };
  take_chunk(cur_chunk);

  Walk<SEG, WARPS> walk;
  walk.start(lo, upc, nseg);
  for (int it = 0; walk.unit < hi; ++it) {
    long long chunk, b, t_lo, t_hi;
    walk.next(hi, nseg, a.B, S, chunk, b, t_lo, t_hi);
    if (chunk != cur_chunk) {
      flush();
      take_chunk(chunk);
    }
    const int s = it % NSTAGES;
    mbar_wait(smem_u32(&full[s]), (it / NSTAGES) & 1);
    // this warp's steps seg_lo + k, k < own (none past the tile or S)
    const long long seg_lo = t_lo + warp * SEG;
    const int own = static_cast<int>(max(0LL, min(static_cast<long long>(SEG), t_hi - seg_lo)));
    const int segs = static_cast<int>((t_hi - t_lo + SEG - 1) / SEG);   // the tile's segments
    const uint32_t* stage = ring + s * (STAGE_BYTES / 4);
    // x's row t at stage[(t - t_lo + HALO) * 32], G's row u at stage[(X_ROWS + u - t_lo) * 32]
    const uint32_t* xrow = stage + (warp * SEG + HALO - (W - 1)) * 32 + lane;
    const uint32_t* grow = stage + (X_ROWS + warp * SEG) * 32 + lane;
    // heads: slot w holds dpre at warp w's first W-1 steps, slot `segs` the
    // W-1 steps after the tile (formed by warps 0 .. W-2, zero past S)
    float* hd = heads + (it & 1) * HEAD_FLOATS;
    const long long row0 = (b * S + seg_lo) * C + c;       // (b, seg_lo, c) in dx, pre
    uint32_t* dxw = reinterpret_cast<uint32_t*>(static_cast<T*>(a.out) + row0);
    const long long cw = C / NE;                            // a row's words
    auto dpre_of = [&](uint32_t pw, uint32_t gw, float* dp) {
      float pre[NE], gv[NE];
      unpack<T>(pw, pre);
      unpack<T>(gw, gv);
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const float sg = __fdividef(1.0f, 1.0f + __expf(-pre[e]));
        dp[e] = gv[e] * (sg * fmaf(pre[e], 1.0f - sg, 1.0f));
      }
    };

    // phase A: the warp's own steps, a row at a time
    uint32_t xw[W];                        // x words at seg_lo + k - (W-1) .. seg_lo + k
    float dq[W][NE];                       // dpre at the same steps
#pragma unroll
    for (int i = 0; i < W; ++i) {
      xw[i] = 0u;
#pragma unroll
      for (int e = 0; e < NE; ++e) dq[i][e] = 0.0f;
    }
    if (own > 0) {
      const T* state = static_cast<const T*>(a.state);
#pragma unroll
      for (int i = 0; i + 1 < W; ++i) {
        const long long t = seg_lo - (W - 1) + i;
        xw[i + 1] = (t < 0 && state != nullptr)
                        ? (live ? *reinterpret_cast<const uint32_t*>(
                                      state + (b * (W - 1) + (W - 1) + t) * C + c)
                                : 0u)
                        : xrow[i * 32];
      }
    }
#pragma unroll
    for (int k = 0; k < SEG; ++k) {
      float dp[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) dp[e] = 0.0f;
      if (k < own) {
#pragma unroll
        for (int i = 0; i + 1 < W; ++i) xw[i] = xw[i + 1];
        xw[W - 1] = xrow[(k + W - 1) * 32];
        const uint32_t pw = pre_word<T, W>(xw, ww, bw);
        dpre_of(pw, grow[k * 32], dp);
#pragma unroll
        for (int i = 0; i < W; ++i) {       // dw and db
          float xv[NE];
          unpack<T>(xw[i], xv);
#pragma unroll
          for (int e = 0; e < NE; ++e) acc[i][e] = fmaf(dp[e], xv[e], acc[i][e]);
        }
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[W][e] += dp[e];
        if (a.pre != nullptr && live)
          reinterpret_cast<uint32_t*>(static_cast<T*>(a.pre) + row0)[k * cw] = pw;
#pragma unroll
        for (int i = 0; i + 1 < W; ++i)
#pragma unroll
          for (int e = 0; e < NE; ++e) dq[i][e] = dq[i + 1][e];
#pragma unroll
        for (int e = 0; e < NE; ++e) dq[W - 1][e] = dp[e];
        // dx at step k - (W-1), whose dpre are all this warp's
        if (live && k >= W - 1) {
          float d[W][NE];
#pragma unroll
          for (int i = 0; i < W; ++i)
#pragma unroll
            for (int e = 0; e < NE; ++e) d[i][e] = dq[W - 1 - i][e];
          taps(d, dxw + (k - (W - 1)) * cw);
        }
      }
      if (k < W - 1 && own > 0) {
#pragma unroll
        for (int e = 0; e < NE; ++e) hd[((warp * HALO + k) * 32 + lane) * NE + e] = dp[e];
      }
    }
    // the W-1 steps after the tile, one a warp of warps 0 .. W-2
    if (warp < W - 1) {
      const long long u = t_hi + warp;
      float dp[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) dp[e] = 0.0f;
      if (u < S) {                         // then t_hi is a whole tile's: u - (W-1) >= 0
        const int r = static_cast<int>(u - t_lo);
        uint32_t xv[W];
#pragma unroll
        for (int i = 0; i < W; ++i) xv[i] = stage[(r - (W - 1) + i + HALO) * 32 + lane];
        dpre_of(pre_word<T, W>(xv, ww, bw), stage[(X_ROWS + r) * 32 + lane], dp);
      }
#pragma unroll
      for (int e = 0; e < NE; ++e) hd[((segs * HALO + warp) * 32 + lane) * NE + e] = dp[e];
    }
    __syncthreads();                       // the heads are written; the stage is read
    if (threadIdx.x == 0 && load.unit < hi) issue(s);

    // phase B: the warp's last W-1 steps, with the next slot's dpre; and the
    // state's rows, from the first slot's
    if (W > 1 && own > 0 && live) {
      const float* nh = hd + ((warp + 1) * HALO * 32 + lane) * NE;
#pragma unroll
      for (int j = 0; j + 1 < W; ++j) {
        const int t = own - (W - 1) + j;
        if (t < 0) continue;
        float d[W][NE];                    // dpre at t + W-1 - i = own + j - i
#pragma unroll
        for (int i = 0; i < W; ++i)
#pragma unroll
          for (int e = 0; e < NE; ++e)
            d[i][e] = i <= j ? nh[(j - i) * 32 * NE + e] : dq[W + j - i][e];
        taps(d, dxw + t * cw);
      }
      if (seg_lo == 0 && a.dstate != nullptr) {
        const float* mh = hd + (warp * HALO * 32 + lane) * NE;
        uint32_t* dsw = reinterpret_cast<uint32_t*>(static_cast<T*>(a.dstate) +
                                                    b * (W - 1) * C + c);
#pragma unroll
        for (int j = 0; j + 1 < W; ++j) {
          float d[W][NE];                  // dpre at j - i for i <= j, zero past j
#pragma unroll
          for (int i = 0; i < W; ++i)
#pragma unroll
            for (int e = 0; e < NE; ++e) d[i][e] = i <= j ? mh[(j - i) * 32 * NE + e] : 0.0f;
          taps(d, dsw + j * cw);
        }
      }
    }
  }
  flush();
}

// out[o] = round(sum over the chunk's slots j of part[j][o]) for o < rows * C
// (rows = W + 1), in slot order from +0.0: the slots of column c's chunk are
// the blocks from the one holding the chunk's first unit to the one holding
// its last (`block_of`), each of which wrote the chunk's partial row at slot
// g - (the first)
template <typename T>
__global__ void causal_conv_sum_partials(const float* part, long long C, int rows,
                                         long long units, long long grid, long long upc, int ch,
                                         T* out) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= rows * C) return;
  const long long i = o / C, c = o - i * C, chunk = c / ch;
  const long long g0 = block_of(chunk * upc, units, grid);
  const long long g1 = block_of(chunk * upc + upc - 1, units, grid);
  float acc = 0.0f;
  for (long long j = 0; j <= g1 - g0; ++j) acc = __fadd_rn(acc, part[(j * rows + i) * C + c]);
  if constexpr (sizeof(T) == 2) out[o] = __float2bfloat16_rn(acc);
  else out[o] = acc;
}

bool aligned(const void* p, int n) { return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0; }

// Shape and pointer checks shared by both entry points; `unit` the bytes the
// route moves at once (an element, 8 or 16 bytes: every pointer, C and the strides of x
// whole units of it; the staged adjoint's 16-byte TMA conditions on top)
bool args_ok(const Args& a, int w, int unit, int esize, bool bwd) {
  if (a.B < 0 || a.S < 0 || a.C < 1 || w < 1 || w > MAX_W || !a.w || !a.b) return false;
  if (a.B * a.S > 0 && (!a.x || !a.out || (bwd && !a.g))) return false;
  if (unit <= esize) return true;
  const void* ptrs[] = {a.x, a.state, a.w, a.b, a.g, a.out, a.new_state, a.dstate, a.pre};
  for (const void* p : ptrs)
    if (p && !aligned(p, unit)) return false;
  return (a.C * esize) % unit == 0 && (a.xsb * esize) % unit == 0 &&
         (a.xss * esize) % unit == 0;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    return (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// A (C, S, B) tensor (channels innermost) at byte strides (ss, sb), read in
// boxes of `row_bytes` of channels by `rows` steps of one sequence; boxes
// past its edges come back zero-filled
int encode(CUtensorMap* map, const void* ptr, bool bf16, long long B, long long S, long long C,
           long long ss, long long sb, int rows, int row_bytes) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ERR_ENTRY_POINT;
  const int esize = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ss), static_cast<cuuint64_t>(sb)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(row_bytes / esize),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res =
      fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
         const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(res);
}

// The staged adjoint's kernel for (T, W)
template <typename T>
const void* staged_kernel(int width) {
  switch (width) {
    case 1: return reinterpret_cast<const void*>(causal_conv_bwd_kernel<T, 1>);
    case 2: return reinterpret_cast<const void*>(causal_conv_bwd_kernel<T, 2>);
    case 3: return reinterpret_cast<const void*>(causal_conv_bwd_kernel<T, 3>);
    default: return reinterpret_cast<const void*>(causal_conv_bwd_kernel<T, 4>);
  }
}

// The scalar route's kernel for (T, W)
template <typename T>
const void* scalar_kernel(int width) {
  switch (width) {
    case 1: return reinterpret_cast<const void*>(causal_conv_bwd_scalar_kernel<T, 1, 1>);
    case 2: return reinterpret_cast<const void*>(causal_conv_bwd_scalar_kernel<T, 1, 2>);
    case 3: return reinterpret_cast<const void*>(causal_conv_bwd_scalar_kernel<T, 1, 3>);
    default: return reinterpret_cast<const void*>(causal_conv_bwd_scalar_kernel<T, 1, 4>);
  }
}

// The forward's kernel of a route for (dtype, W), its block and its dynamic
// shared memory
template <typename T>
const void* fwd_kernel_of(int route, int width) {
#define B5_FWD_OF(W)                                                                          \
  (route == FWD_STAGED ? reinterpret_cast<const void*>(causal_conv_fwd_kernel<T, W>)          \
   : route == FWD_VECTOR                                                                      \
       ? reinterpret_cast<const void*>(causal_conv_fwd_window_kernel<T, 8 / int(sizeof(T)), W>) \
       : reinterpret_cast<const void*>(causal_conv_fwd_window_kernel<T, 1, W>))
  switch (width) {
    case 1: return B5_FWD_OF(1);
    case 2: return B5_FWD_OF(2);
    case 3: return B5_FWD_OF(3);
    default: return B5_FWD_OF(4);
  }
#undef B5_FWD_OF
}

const void* fwd_kernel(int route, bool bf16, int width, int* block, int* smem) {
  *block = route == FWD_STAGED ? FWD_WARPS * 32 : UNITS_X * TILES_Y;
  *smem = route == FWD_STAGED ? FWD_SMEM_BYTES : 0;
  return bf16 ? fwd_kernel_of<__nv_bfloat16>(route, width) : fwd_kernel_of<float>(route, width);
}

// The adjoint's kernel of a route, its block and its dynamic shared memory
const void* bwd_kernel(int route, bool bf16, int width, int* block, int* smem) {
  *block = route == ROUTE_STAGED ? WARPS * 32 : UNITS_X * TILES_Y;
  *smem = route == ROUTE_STAGED ? SMEM_BYTES : 0;
  if (route == ROUTE_STAGED)
    return bf16 ? staged_kernel<__nv_bfloat16>(width) : staged_kernel<float>(width);
  return bf16 ? scalar_kernel<__nv_bfloat16>(width) : scalar_kernel<float>(width);
}

}  // namespace

// The forward. mode as above (the route one of FWD_*); x (B, S, C) at
// strides (xsb, xss, 1); state (B, W-1, C) or null; w (W, C), b (C,); out
// (B, S, C) and new_state (B, W-1, C) or null, contiguous. On the staged
// route `grid` persistent blocks over the (chunk, sequence, segment) units
// (`fwd_plan` in kernels/causal_conv.py); the other routes ignore it.
extern "C" int causal_conv1d_fwd(int mode, const void* x, const void* state, const void* w,
                                 const void* b, void* out, void* new_state, long long B,
                                 long long S, long long C, long long xsb, long long xss,
                                 long long grid, void* stream) {
  const int route = mode & MODE_ROUTE;
  const bool bf16 = mode & MODE_DTYPE;
  const int width = (mode >> MODE_W_SHIFT) & 7, device = mode >> MODE_DEVICE_SHIFT;
  Args a = {};
  a.x = x; a.state = state; a.w = w; a.b = b; a.out = out; a.new_state = new_state;
  a.B = B; a.S = S; a.C = C; a.xsb = xsb; a.xss = xss;
  const int esize = bf16 ? 2 : 4;
  const int unit = route == FWD_STAGED ? 16 : route == FWD_VECTOR ? 8 : esize;
  if (route > FWD_STAGED || !args_ok(a, width, unit, esize, false) || S < 1 ||
      (width > 1 && B > 0 && !new_state))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  OnDevice on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int block, smem;
  const void* fn = fwd_kernel(route, bf16, width, &block, &smem);
  if (route == FWD_STAGED) {
    a.nseg = (S + FWD_SEG - 1) / FWD_SEG;
    a.units = (C * esize + FWD_ROW_BYTES - 1) / FWD_ROW_BYTES * B * a.nseg;
    if (grid < 1 || grid > a.units || a.units > 0x7fffffffLL) return cudaErrorInvalidValue;
    // cuTensorMapEncodeTiled needs a current context (see the adjoint)
    const cudaError_t bound = cudaSetDevice(device);
    if (bound != cudaSuccess) return bound;
    CUtensorMap tm_halo, tm_seg;
    const long long ss = xss * esize, sb = (B > 1 ? xsb : S * xss) * esize;
    int err = encode(&tm_halo, x, bf16, B, S, C, ss, sb, HALO, FWD_ROW_BYTES);
    if (err == 0) err = encode(&tm_seg, x, bf16, B, S, C, ss, sb, FWD_SEG, FWD_ROW_BYTES);
    if (err != 0) return err;
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    void* params[] = {&tm_halo, &tm_seg, &a};
    e = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(block), params,
                         static_cast<size_t>(smem), st);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  const int v = route == FWD_VECTOR ? 8 / esize : 1;
  const long long units = C / v, tiles = (S + L - 1) / L;
  const long long gy = (B * tiles + TILES_Y - 1) / TILES_Y;
  if (gy > 65535) return cudaErrorInvalidValue;
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchKernel(
      fn, dim3(static_cast<unsigned>((units + UNITS_X - 1) / UNITS_X), static_cast<unsigned>(gy)),
      dim3(UNITS_X, TILES_Y), params, 0, st);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Blocks of the forward's kernel for (route, dtype, W) that an SM of the
// current device holds at once, or minus the error.
extern "C" int causal_conv1d_fwd_residency(int mode) {
  const int route = mode & MODE_ROUTE, width = (mode >> MODE_W_SHIFT) & 7;
  if (route > FWD_STAGED || width < 1 || width > MAX_W) return -cudaErrorInvalidValue;
  OnDevice on(mode >> MODE_DEVICE_SHIFT);
  int block, smem, n = 0;
  const void* fn = fwd_kernel(route, mode & MODE_DTYPE, width, &block, &smem);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, block, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The registers a thread and the local memory (stack frame, spills
// included) of the forward's kernel for (route, dtype, W), from the runtime.
extern "C" int causal_conv1d_fwd_attributes(int mode, int* regs, int* local_bytes) {
  const int route = mode & MODE_ROUTE, width = (mode >> MODE_W_SHIFT) & 7;
  if (route > FWD_STAGED || width < 1 || width > MAX_W || !regs || !local_bytes)
    return cudaErrorInvalidValue;
  OnDevice on(mode >> MODE_DEVICE_SHIFT);
  int block, smem;
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, fwd_kernel(route, mode & MODE_DTYPE, width, &block, &smem));
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return err;
}

// Blocks of the adjoint's kernel for (route, dtype, W) that an SM of the
// current device holds at once, or minus the error.
extern "C" int causal_conv1d_bwd_residency(int mode) {
  const int route = mode & MODE_ROUTE, width = (mode >> MODE_W_SHIFT) & 7;
  if (route > ROUTE_STAGED || width < 1 || width > MAX_W) return -cudaErrorInvalidValue;
  OnDevice on(mode >> MODE_DEVICE_SHIFT);
  int block, smem, n = 0;
  const void* fn = bwd_kernel(route, mode & MODE_DTYPE, width, &block, &smem);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, block, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The registers a thread and the local memory (stack frame, spills
// included) of the adjoint's kernel for (route, dtype, W), from the runtime.
extern "C" int causal_conv1d_bwd_attributes(int mode, int* regs, int* local_bytes) {
  const int route = mode & MODE_ROUTE, width = (mode >> MODE_W_SHIFT) & 7;
  if (route > ROUTE_STAGED || width < 1 || width > MAX_W || !regs || !local_bytes)
    return cudaErrorInvalidValue;
  OnDevice on(mode >> MODE_DEVICE_SHIFT);
  int block, smem;
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, bwd_kernel(route, mode & MODE_DTYPE, width, &block, &smem));
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return err;
}

// The adjoint. mode, x, state, w, b as the forward's, the route one of
// ROUTE_*; g (B, S, C) the output's gradient, contiguous; writes dx (B, S,
// C), dstate (B, W-1, C) where not null, dwb (W + 1, C): dw's W rows, then
// db, in w's dtype, and on the staged route the recomputed pre-activation
// (B, S, C) where `pre` is not null. part (slots, W + 1, C) f32 scratch:
// on the staged route `grid` persistent blocks over the (chunk, sequence,
// segment) units, at most `slots` of them on a chunk; on the scalar route
// `grid` blocks over the tiles (grid.y) and slots == grid (`plan` in
// kernels/causal_conv.py).
extern "C" int causal_conv1d_bwd(int mode, const void* x, const void* state, const void* w,
                                 const void* b, const void* g, void* dx, void* dstate, void* dwb,
                                 float* part, void* pre, long long B, long long S, long long C,
                                 long long xsb, long long xss, long long grid, long long slots,
                                 void* stream) {
  const int route = mode & MODE_ROUTE;
  const bool bf16 = mode & MODE_DTYPE;
  const int width = (mode >> MODE_W_SHIFT) & 7, device = mode >> MODE_DEVICE_SHIFT;
  Args a = {};
  a.x = x; a.state = state; a.w = w; a.b = b; a.g = g; a.out = dx; a.dstate = dstate;
  a.part = part; a.pre = pre; a.B = B; a.S = S; a.C = C; a.xsb = xsb; a.xss = xss;
  const int esize = bf16 ? 2 : 4;
  const int unit = route == ROUTE_STAGED ? 16 : esize;
  if (route > ROUTE_STAGED || !args_ok(a, width, unit, esize, true) || S < 1 || !dwb || !part ||
      grid < 1 || (dstate && !state) || (pre && route != ROUTE_STAGED))
    return cudaErrorInvalidValue;
  OnDevice on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (width + 1) * C;
  if (route == ROUTE_STAGED) {
    const long long nseg = (S + SEG - 1) / SEG, upc = B * nseg;
    const int ch = ROW_BYTES / esize;
    a.nseg = nseg;
    a.units = (C + ch - 1) / ch * upc;
    if (a.units == 0) return cudaSuccess;
    if (grid > a.units || a.units > 0x7fffffffLL) return cudaErrorInvalidValue;
    // blocks take at least `per` units each, so a chunk's upc units meet at
    // most ceil(upc / per) + 1 of them
    const long long per = a.units / grid;
    const long long need = (upc + per - 1) / per + 1;
    if (slots < (need < grid ? need : grid)) return cudaErrorInvalidValue;
    // The tensor maps are encoded through the driver API, which needs a
    // current context: a thread that has made no runtime call yet
    // (autograd's worker thread can be one) has none until cudaSetDevice
    // binds its device's primary context.
    const cudaError_t bound = cudaSetDevice(device);
    if (bound != cudaSuccess) return bound;
    CUtensorMap tm_x, tm_g;
    int err = encode(&tm_x, x, bf16, B, S, C, xss * esize, (B > 1 ? xsb : S * xss) * esize,
                     X_ROWS, ROW_BYTES);
    if (err == 0)
      err = encode(&tm_g, g, bf16, B, S, C, C * esize, S * C * esize, G_ROWS, ROW_BYTES);
    if (err != 0) return err;
    int block, smem;
    const void* fn = bwd_kernel(route, bf16, width, &block, &smem);
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    void* params[] = {&tm_x, &tm_g, &a};
    e = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(block), params,
                         static_cast<size_t>(smem), st);
    if (e != cudaSuccess) return e;
    const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
    if (bf16)
      causal_conv_sum_partials<<<blocks, 256, 0, st>>>(part, C, width + 1, a.units, grid, upc, ch,
                                                       static_cast<__nv_bfloat16*>(dwb));
    else
      causal_conv_sum_partials<<<blocks, 256, 0, st>>>(part, C, width + 1, a.units, grid, upc, ch,
                                                       static_cast<float*>(dwb));
    return cudaGetLastError();
  }
  if (grid > 65535 || slots != grid) return cudaErrorInvalidValue;
  const dim3 dgrid(static_cast<unsigned>((C + UNITS_X - 1) / UNITS_X),
                   static_cast<unsigned>(grid));
  int block, smem;
  const void* fn = bwd_kernel(route, bf16, width, &block, &smem);
  void* params[] = {&a};
  cudaError_t err = cudaLaunchKernel(fn, dgrid, dim3(UNITS_X, TILES_Y), params, 0, st);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  if (bf16)
    causal_conv_sum_rows<<<blocks, 256, 0, st>>>(part, n, grid, static_cast<__nv_bfloat16*>(dwb));
  else
    causal_conv_sum_rows<<<blocks, 256, 0, st>>>(part, n, grid, static_cast<float*>(dwb));
  return cudaGetLastError();
}

extern "C" const char* causal_conv1d_error_string(int err) {
  static thread_local char buf[96];
  if (err == ERR_ENTRY_POINT) return "cudaGetDriverEntryPoint(cuTensorMapEncodeTiled) failed";
  if (err >= ERR_ENCODE) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed with CUresult %d",
             err - ERR_ENCODE);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
