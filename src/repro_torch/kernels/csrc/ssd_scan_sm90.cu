// Mamba2 SSD chunk scan for bf16 on Hopper (sm_90a): wgmma fed by TMA.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` driven by `ssd_scan`
// (src/repro/kernels/ssd_scan.py) for bf16 inputs; f32 inputs keep the
// CUDA-core kernel of ssd_scan.cu. Same function as that file's header and
// `ssd_scan_plain`, reading the model's layout in place: x (B, S, H, P) bf16
// and B, C (B, S, G, N) bf16 at any strides a tensor map takes (unit stride
// in P and N, the others multiples of 16 bytes: in mamba2 they are views of
// the convolution's output at its token stride), dt (B, S, H) f32 at its
// strides, A (B*H,) f32; y (B*H, S, P) bf16, row b*H + h (the layout the
// gated norm reads in place), and the final state (B*H, N, P) f32. Per
// chunk of Q tokens, with an (N, P) f32 state carried
// from chunk to chunk:
//   cum = cumsum(dt * A)                   (restarts at 0 in every chunk)
//   W[i][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for j <= i, else 0
//   y = W X + exp(cum) * (C state)
//   state' = exp(total) * state + B^T (exp(total - cum) * dt * X)
// Head h reads group h / heads_per_group of B and C; the groups are never
// broadcast in memory. A null initial state means zeros. Q is any
// length from 1 to 128; N and P are multiples of 8 up to 128 (16-byte rows
// for TMA).
//
// Rounding points: C, B and X are bf16 as given; W, the bf16 copy of the
// state that C.state reads, and exp(total - cum) * dt * X are rounded to
// bf16 before their products, as the published Mamba2 GPU kernels do (their
// chunk scan casts the carried state to the inputs' type before C.state).
// Every product accumulates in f32 and the state itself stays f32. cum is a
// warp scan (a sequential sum of 4, then shuffles), another order of
// summation than the plain version's cumsum; the difference is orders of
// magnitude inside the bf16 tolerance.
//
// What bounds it on this card: at the serving shape (BH 256, S 1024, P 64,
// N 128, Q 128, 64 heads per group) the function is 21.5 GFLOP against 78.6
// MB of traffic, so with tensor cores the bytes bound it (~23.5 us at 3.35
// TB/s). What the design does about that:
// * all four products run on wgmma with bf16 operands and f32 accumulators:
//   S = C.B^T in SS form (both K-major as stored); y = C.state in SS form
//   with the state copy MN-major (transpose-B); y += W.X in RS form, W built
//   from S's accumulator fragment in registers and X read MN-major with the
//   transpose-B bit; state += B^T.(wd.X) in SS form with the B tile read
//   MN-major through the transpose-A bit and wd.X MN-major;
// * C, B and X stay bf16 in shared memory and arrive by TMA from 5-D tensor
//   maps (width, chunk, S / chunk, heads, batch) at the operands' own strides
//   (no layout copy precedes the kernel), with boxes of 64 columns by 64 or
//   128 tokens and 128-byte swizzle: tokens past the chunk are out of bounds
//   and come as zeros, so any chunk from 1 to 128 works and no box reads
//   the next chunk; N or P wider than 64 is two panels;
// * warp specialisation: one producer warp issues the loads of the next
//   chunks into a ring of mbarrier stages (full / empty); two consumer
//   warpgroups of 64 chunk rows (and 64 state rows) each wait on `full`,
//   run the products and arrive on `empty`. setmaxnreg moves registers from
//   the producer warpgroup to the consumers;
// * the state lives in f32 accumulator registers for the whole loop, N rows
//   split over the two warpgroups; each chunk writes a bf16 copy of it into
//   shared memory for the next chunk's C.state (named barrier between the
//   two halves), and only the last chunk writes the state to memory;
// * y = C.state goes into the y accumulator first, its rows are scaled by
//   exp(cum_i) in registers, then W.X accumulates on top; y leaves through
//   shared memory (the warpgroup's rows of the state tile, free at that
//   point) in 16-byte pieces, whole 128-byte rows per 8 threads, instead of
//   the accumulator layout's scattered 4-byte stores;
// * wd.X is written while S = C.B^T runs on the tensor cores;
// * no serial bottleneck: every warp computes cum with shuffles; masked
//   entries of W are selected to 0, never multiplied by a 0/1 mask
//   (exp(cum_i - cum_j) overflows above the diagonal), and every exponent
//   is formed from a difference; the warpgroup of rows 0-63 uses only
//   columns 0-63 of S and W (the causal half it needs);
// * one block per row, neighbouring blocks on one group, so B and C come
//   from L2 for all but the first head of a group.
// Not done here: sharing S = C.B^T between the heads of a group, a
// chunk-parallel formulation, a persistent grid, a TMA store of y.
//
// Entry point: `ssd_scan_sm90_fwd`, a plain C function that builds the
// tensor maps (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so no -lcuda), launches on the given stream and
// returns 0 or an error code that `ssd_scan_sm90_error_string` names.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int QMAX = 128;               // longest chunk: rows of a tile
constexpr int PANEL = QMAX * 128;       // one 64-column panel of 128 rows, 128-byte swizzle
constexpr int NCONSUMERS = 2;           // consumer warpgroups
constexpr int NTHREADS = 128 * (NCONSUMERS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;      // 128 * 40 + 256 * 232 <= 65536
constexpr int WARP_BYTES = 1024;        // each consumer warp's cum (log2 units) and dt
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ERR_ENTRY_POINT = 100000;  // cudaGetDriverEntryPoint failed
constexpr int ERR_ENCODE = 200000;       // + CUresult of cuTensorMapEncodeTiled

// NPAN panels of N (C and B), PPAN panels of P (X, y, the state).
template <int NPAN, int PPAN>
struct Cfg {
  static constexpr int PP = 64 * PPAN;                         // padded P: the products' n
  static constexpr int NSTAGES = NPAN + PPAN > 3 ? 1 : 2;      // ring depth that fits
  static constexpr int STAGE = (2 * NPAN + PPAN) * PANEL;      // C, B, X of one chunk
  // offsets from the 1024-byte aligned base: the ring, wd.X, the bf16 state
  // copy, each consumer warp's cum and dt, then the barriers
  static constexpr int XW_OFF = NSTAGES * STAGE;
  static constexpr int ST_OFF = XW_OFF + PPAN * PANEL;
  static constexpr int WARP_OFF = ST_OFF + PPAN * PANEL;
  static constexpr int BAR_OFF = WARP_OFF + NCONSUMERS * 4 * WARP_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 16 * NSTAGES;
};

struct Params {
  int seq;
  int p;
  int n;
  int chunk;
  int group;       // heads per group
  int heads;       // H
  int n_chunks;    // seq / chunk
  int qb;          // tokens per box: 64 if chunk <= 64, else 128
  long long dt_sb, dt_ss, dt_sh;  // dt's batch, sequence and head strides (elements)
  const float* dt;
  const float* A;
  const float* init;
  __nv_bfloat16* y;
  float* state_out;
};

// ---- shared memory, mbarriers, TMA -----------------------------------------

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// One box of a 5-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

// Makes the threads' writes to shared memory visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier over the 256 consumer threads only.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONSUMERS * 128) : "memory");
}

// Barrier over the 128 threads of consumer warpgroup wg.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle (layout 1 in bits 62-63).
// K-major tiles: SBO = 8 rows x 128 B. MN-major tiles: LBO = the stride
// between 64-element panels, SBO = 8 rows x 128 B along K.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins registers in place around wgmma: no read or write of them moves
// across this point, so reads of an accumulator stay after the wait and
// writes to it (a row scale, W) stay before the fence.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define ACC8(d, i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32(d) ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
#define ACC64(d) ACC32(d), ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
#define REGS32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"              \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define REGS64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"              \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"    \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"    \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x N) (+)= A (64 x 16) * B (16 x N), both from shared memory; TA and
// TB are the transpose bits (0: K-major, 1: MN-major).
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  static_assert(N == 64 || N == 128, "n 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
        ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : ACC32(d)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
        ", %64, %65, p, 1, 1, %67, %68;\n}\n"
        : ACC64(d)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  }
}

// d (64 x N) += A (64 x 16, registers) * B (16 x N, shared memory, MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "n 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// ---- helpers ---------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of (row, col) in a tile of 64-column bf16 panels of 128 rows
// with 128-byte swizzle: the 16-byte chunk index is XORed with row % 8.
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  const int pc = col % 64;
  return (col / 64) * PANEL + row * 128 + ((((pc / 8) ^ (row % 8))) * 16) + (pc % 8) * 2;
}


// bf16 copy of a thread's accumulator fragment (rows k0 and k0 + 8, the
// columns 8j + c0 and + 1) into a swizzled tile: the state copy that C.state
// reads, or y on its way out.
template <int PP>
__device__ __forceinline__ void store_fragment(uint8_t* tile, const float (&d)[PP / 2], int k0,
                                               int c0) {
#pragma unroll
  for (int jj = 0; jj < PP / 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(tile + swizzled(k0 + 8 * h, 8 * jj + c0)) =
          pack_bf16(d[4 * jj + 2 * h], d[4 * jj + 2 * h + 1]);
}

// Rows wg*64 .. wg*64+63 of a swizzled bf16 tile out to y's rows of the
// chunk (`out` points at its first token), 16 bytes a thread and step; rows
// past the chunk and columns past P stay unwritten.
template <int PPAN>
__device__ __forceinline__ void copy_out_y(const uint8_t* tile, __nv_bfloat16* out, int wg,
                                           int t, int chunk, int p) {
#pragma unroll
  for (int idx = t; idx < PPAN * 512; idx += 128) {
    const int i = wg * 64 + (idx % 512) / 8;
    const int c = idx % 8;
    const int col = (idx / 512) * 64 + 8 * c;
    if (i < chunk && col < p)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(i) * p + col) =
          *reinterpret_cast<const uint4*>(tile + (idx / 512) * PANEL + i * 128 +
                                          ((c ^ (i % 8)) * 16));
  }
}

// wd X into its own tile, in the swizzled layout of X (a 16-byte piece
// keeps its row): every consumer thread takes 16-byte pieces;
// wd_j = exp(total - cum_j) * dt_j, in bf16.
template <int PPAN>
__device__ __forceinline__ void write_decayed_x(const uint8_t* x, uint8_t* xw, int qb, float tot2,
                                                const float* wcum, const float* wdt) {
  const int pieces = PPAN * qb * 8;
  for (int idx = threadIdx.x; idx < pieces; idx += NCONSUMERS * 128) {
    const int rem = idx % (qb * 8);
    const int j = rem / 8;
    const uint32_t off = (idx / (qb * 8)) * PANEL + rem * 16;
    const float wd = ex2(tot2 - wcum[j]) * wdt[j];
    uint4 v = *reinterpret_cast<const uint4*>(x + off);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      h[e] = __floats2bfloat162_rn(f.x * wd, f.y * wd);
    }
    *reinterpret_cast<uint4*>(xw + off) = v;
  }
}

// Issues y = C state: C's 64 rows of this warpgroup at `c` (K-major), the
// bf16 state copy at `st` (MN-major). Committed, not waited.
template <int PP, int NPAN>
__device__ __forceinline__ void c_state(float (&y)[PP / 2], uint32_t c, uint32_t st) {
#pragma unroll
  for (int i = 0; i < PP / 2; ++i) y[i] = 0.f;
  reg_fence(y);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NPAN * 4; ++kk)
    wgmma_ss<PP, 0, 1>(y, make_desc(c + (kk / 4) * PANEL + (kk % 4) * 32, 16, 1024),
                       make_desc(st + kk * 16 * 128, PANEL, 1024), kk > 0);
  wgmma_commit();
}

// ---- the consumer ----------------------------------------------------------
//
// Accumulator fragment of wgmma m64nNk16 (f32), per thread of a warpgroup
// (warp w, lane l): register r holds row 16w + l/4 + 8*((r >> 1) & 1) and
// column 8*(r >> 2) + 2*(l % 4) + (r & 1). Registers 8kk .. 8kk+7 of S, as
// bf16 pairs, are the A fragment of the k16 step kk of W.X.
//
// Consumer warpgroup wg holds chunk rows wg*64 .. wg*64+63 and state rows
// wg*64 .. wg*64+63. NS: the chunk columns its rows use (64 for rows 0-63,
// 128 for rows 64-127), or 0 when its rows lie past the chunk.

template <int NS, int NPAN, int PPAN>
__device__ __forceinline__ void consumer(const Params& p, uint8_t* gbase, uint32_t base,
                                         int row, int wg) {
  using Cf = Cfg<NPAN, PPAN>;
  constexpr int PP = Cf::PP;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int c0 = 2 * (lane % 4);
  const int r0 = wg * 64 + warp * 16 + lane / 4;  // this thread's rows r0 and r0 + 8
  const bool has_state = wg < NPAN;               // state rows past N are not held
  float* wcum = reinterpret_cast<float*>(gbase + Cf::WARP_OFF + (wg * 4 + warp) * WARP_BYTES);
  float* wdt = wcum + QMAX;
  uint8_t* g_st = gbase + Cf::ST_OFF;
  const uint32_t s_xw = base + Cf::XW_OFF;
  const uint32_t s_st = base + Cf::ST_OFF;
  const uint32_t bar_full = base + Cf::BAR_OFF;
  const uint32_t bar_empty = bar_full + 8 * Cf::NSTAGES;
  const float a = p.A[row];
  // this head's dt, token t at dtr[t * dt_ss]
  const float* dtr = p.dt + (row / p.heads) * p.dt_sb + (row % p.heads) * p.dt_sh;
  const long long dss = p.dt_ss;

  // the state, f32 in registers for the whole loop
  float st[PP / 2];
#pragma unroll
  for (int jj = 0; jj < PP / 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = r0 + 8 * h;
      const int col = 8 * jj + c0;
      float v0 = 0.f, v1 = 0.f;
      if (has_state && p.init != nullptr && k < p.n && col < p.p) {
        const float* src = p.init + (static_cast<size_t>(row) * p.n + k) * p.p + col;
        v0 = src[0];
        v1 = src[1];
      }
      st[4 * jj + 2 * h] = v0;
      st[4 * jj + 2 * h + 1] = v1;
    }
  if (has_state) store_fragment<PP>(g_st, st, r0, c0);
  fence_proxy_async();
  consumers_sync();

  // dt of the next chunk, prefetched: lane holds tokens 4*lane .. 4*lane+3
  float dtn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) dtn[i] = 4 * lane + i < p.chunk ? dtr[(4 * lane + i) * dss] : 0.f;

  for (int ci = 0; ci < p.n_chunks; ++ci) {
    const int s = ci % Cf::NSTAGES;
    const uint32_t phase = (ci / Cf::NSTAGES) & 1;
    const int t0 = ci * p.chunk;

    // cum = cumsum(dt * A) over the chunk, in every warp: a sum of 4 in each
    // lane, then an inclusive scan over the lanes; tokens past the chunk add
    // 0, so cum[127] is the chunk's total. Kept in log2 units.
    float cs[4];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      run = __fadd_rn(run, __fmul_rn(dtn[i], a));
      cs[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, u);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    __syncwarp();  // the last chunk's reads of wcum and wdt are done
    *reinterpret_cast<float4*>(wcum + 4 * lane) =
        make_float4(__fadd_rn(excl, cs[0]) * LOG2E, __fadd_rn(excl, cs[1]) * LOG2E,
                    __fadd_rn(excl, cs[2]) * LOG2E, __fadd_rn(excl, cs[3]) * LOG2E);
    *reinterpret_cast<float4*>(wdt + 4 * lane) = make_float4(dtn[0], dtn[1], dtn[2], dtn[3]);
    __syncwarp();
    if (ci + 1 < p.n_chunks) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dtn[i] = 4 * lane + i < p.chunk ? dtr[(t0 + p.chunk + 4 * lane + i) * dss] : 0.f;
    }
    const float tot2 = wcum[QMAX - 1];
    // the state decays by exp(total) before this chunk's update; scaled here,
    // before any product of the chunk is in flight, so that no wgmma waits
    // on it (its bf16 copy for C.state was written from the previous value)
    if (has_state) {
      const float et = ex2(tot2);
#pragma unroll
      for (int r = 0; r < PP / 2; ++r) st[r] *= et;
      reg_fence(st);
    }

    mbar_wait(bar_full + 8 * s, phase);
    const uint32_t s_c = base + s * Cf::STAGE;
    const uint32_t s_b = s_c + NPAN * PANEL;
    const uint32_t s_x = s_b + NPAN * PANEL;

    float y[PP / 2];
    uint32_t pa[NS > 0 ? NS / 16 : 1][4];
    if constexpr (NS > 0) {
      // S = C B^T over N in k16 steps: 32 bytes along a panel, then the next
      // panel; wd X is written while it runs
      float sc[NS / 2];
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) sc[i] = 0.f;
      reg_fence(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NPAN * 4; ++kk) {
        const uint32_t in = (kk / 4) * PANEL + (kk % 4) * 32;
        wgmma_ss<NS, 0, 0>(sc, make_desc(s_c + wg * 64 * 128 + in, 16, 1024),
                           make_desc(s_b + in, 16, 1024), kk > 0);
      }
      wgmma_commit();
      write_decayed_x<PPAN>(gbase + (s_x - base), gbase + Cf::XW_OFF, p.qb, tot2, wcum, wdt);
      wgmma_wait_all();
      reg_fence(sc);

      // W = S * exp(cum_i - cum_j) * dt_j where j <= i, selected to 0 elsewhere
      const float cum0 = wcum[r0], cum1 = wcum[r0 + 8];
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 8 * kk + 2 * j;      // rows alternate r0, r0 + 8 with j
          const int i = (j & 1) ? r0 + 8 : r0;
          const float ci_ = (j & 1) ? cum1 : cum0;
          const int col = 8 * (r >> 2) + c0;
          const float w0 = col <= i ? sc[r] * ex2(ci_ - wcum[col]) * wdt[col] : 0.f;
          const float w1 = col + 1 <= i ? sc[r + 1] * ex2(ci_ - wcum[col + 1]) * wdt[col + 1] : 0.f;
          pa[kk][j] = pack_bf16(w0, w1);
        }
      }

      // y = C state (the bf16 copy, MN-major), then rows scaled by exp(cum_i)
      c_state<PP, NPAN>(y, s_c + wg * 64 * 128, s_st);
      wgmma_wait_all();
      reg_fence(y);
      const float e0 = ex2(cum0), e1 = ex2(cum1);
#pragma unroll
      for (int r = 0; r < PP / 2; ++r) y[r] *= (r & 2) ? e1 : e0;

      // y += W X over the chunk's columns in k16 steps (X MN-major); waited below
      reg_fence(y);
      reg_fence(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk)
        wgmma_rs<PP>(y, pa[kk], make_desc(s_x + kk * 16 * 128, PANEL, 1024));
      wgmma_commit();
    } else {
      write_decayed_x<PPAN>(gbase + (s_x - base), gbase + Cf::XW_OFF, p.qb, tot2, wcum, wdt);
    }
    fence_proxy_async();
    consumers_sync();  // wd X is whole; every read of the state copy is done

    // state (decayed above) += B^T (wd X): B read MN-major (transpose-A),
    // this warpgroup's 64 state rows are panel wg of the B tile
    if (has_state) {
      wgmma_fence();
      const int ksteps = p.qb / 16;
      for (int kk = 0; kk < ksteps; ++kk)
        wgmma_ss<PP, 1, 1>(st, make_desc(s_b + wg * PANEL + kk * 16 * 128, PANEL, 1024),
                           make_desc(s_xw + kk * 16 * 128, PANEL, 1024), 1);
      wgmma_commit();
    }
    wgmma_wait_all();
    reg_fence(st);
    if constexpr (NS > 0) {
      reg_fence(y);
      reg_fence(pa);
    }
    mbar_arrive(bar_empty + 8 * s);  // this thread reads stage s no more

    if constexpr (NS > 0) {
      // y goes out through this warpgroup's rows of the state tile (nothing
      // reads them until the state copy below), in 16-byte pieces: eight
      // threads write one 128-byte row
      store_fragment<PP>(g_st, y, r0, c0);
      warpgroup_sync(wg);
      copy_out_y<PPAN>(g_st, p.y + (static_cast<size_t>(row) * p.seq + t0) * p.p, wg, t,
                       p.chunk, p.p);
      warpgroup_sync(wg);
    }
    if (has_state) store_fragment<PP>(g_st, st, r0, c0);
    fence_proxy_async();
    consumers_sync();  // the state copy is whole; every read of wd X is done
  }

  if (has_state) {
#pragma unroll
    for (int jj = 0; jj < PP / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = r0 + 8 * h;
        const int col = 8 * jj + c0;
        if (k < p.n && col < p.p)
          *reinterpret_cast<float2*>(p.state_out + (static_cast<size_t>(row) * p.n + k) * p.p +
                                     col) = make_float2(st[4 * jj + 2 * h], st[4 * jj + 2 * h + 1]);
      }
  }
}

// ---- the kernel ------------------------------------------------------------

template <int NPAN, int PPAN>
__global__ void __launch_bounds__(NTHREADS, 1)
    ssd_scan_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_b,
                         const __grid_constant__ CUtensorMap tm_c, const Params p) {
  using Cf = Cfg<NPAN, PPAN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bar_full = base + Cf::BAR_OFF;        // stage s: C, B and X arrived
  const uint32_t bar_empty = bar_full + 8 * Cf::NSTAGES;  // stage s: read by every consumer
  const int row = blockIdx.x;                          // neighbouring rows share a group

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < Cf::NSTAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NCONSUMERS) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NCONSUMERS * 128) {
      const int bi = row / p.heads, h = row % p.heads, gi = h / p.group;
      const uint32_t bytes = (2 * NPAN + PPAN) * p.qb * 128;
      for (int ci = 0; ci < p.n_chunks; ++ci) {
        const int s = ci % Cf::NSTAGES;
        const uint32_t phase = (ci / Cf::NSTAGES) & 1;
        const uint32_t stage = base + s * Cf::STAGE;
        mbar_wait(bar_empty + 8 * s, phase ^ 1);  // the first pass finds the stage free
        mbar_expect_tx(bar_full + 8 * s, bytes);
#pragma unroll
        for (int pn = 0; pn < NPAN; ++pn) {
          tma_load_5d(stage + pn * PANEL, &tm_c, bar_full + 8 * s, pn * 64, 0, ci, gi, bi);
          tma_load_5d(stage + (NPAN + pn) * PANEL, &tm_b, bar_full + 8 * s, pn * 64, 0, ci,
                      gi, bi);
        }
#pragma unroll
        for (int pp = 0; pp < PPAN; ++pp)
          tma_load_5d(stage + (2 * NPAN + pp) * PANEL, &tm_x, bar_full + 8 * s, pp * 64, 0, ci,
                      h, bi);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    if (wg == 0) consumer<64, NPAN, PPAN>(p, gbase, base, row, wg);
    else if (p.qb == 128) consumer<128, NPAN, PPAN>(p, gbase, base, row, wg);
    else consumer<0, NPAN, PPAN>(p, gbase, base, row, wg);
  }
}

// ---- host side -------------------------------------------------------------

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

// (width, chunk, seq / chunk, heads, batch) bf16 at the strides st =
// {batch, token, head} in elements (width's is 1); boxes of 64 columns x qb
// tokens of one chunk. Columns past `width` and tokens past the chunk are
// out of bounds and arrive as zeros.
int encode(CUtensorMap* map, const void* ptr, int width, int chunk, int n_chunks, int heads,
           int batch, const long long* st, int qb) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ERR_ENTRY_POINT;
  const cuuint64_t tok = static_cast<cuuint64_t>(st[1]) * 2;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(chunk),
                              static_cast<cuuint64_t>(n_chunks), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[4] = {tok, tok * chunk, static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[5] = {64, static_cast<cuuint32_t>(qb), 1, 1, 1};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims,
                          strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(res);
}

template <int NPAN, int PPAN>
int launch(const CUtensorMap& tx, const CUtensorMap& tb, const CUtensorMap& tc, int bh,
           const Params& p, cudaStream_t stream) {
  constexpr int smem = Cfg<NPAN, PPAN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_sm90_kernel<NPAN, PPAN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_scan_sm90_kernel<NPAN, PPAN><<<bh, NTHREADS, smem, stream>>>(tx, tb, tc, p);
  return cudaGetLastError();
}

}  // namespace

// x (batch, seq, heads, p) and B, C (batch, seq, heads / heads_per_group,
// n): bf16, 16-byte aligned, the last dim contiguous; dt (batch, seq, heads)
// f32; `strides` holds the batch, sequence and head strides in elements of
// x, B, C and dt in that order (12 values), x's, B's and C's multiples of 8.
// A (batch * heads,) f32; init_state null or (batch * heads, n, p) f32; y
// (batch * heads, seq, p) bf16 and state_out (batch * heads, n, p) f32,
// contiguous. seq a multiple of chunk (1 .. 128); n and p multiples of 8 up
// to 128.
extern "C" int ssd_scan_sm90_fwd(const void* x, const void* dt, const void* A, const void* B,
                                 const void* C, const void* init_state, void* y,
                                 void* state_out, const long long* strides, int batch,
                                 int heads, int seq, int p, int n, int chunk,
                                 int heads_per_group, void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || chunk <= 0 || chunk > QMAX || seq % chunk ||
      p <= 0 || p > 128 || p % 8 || n <= 0 || n > 128 || n % 8 || heads_per_group <= 0 ||
      heads % heads_per_group) {
    return cudaErrorInvalidValue;
  }
  // cuTensorMapEncodeTiled, which encodes the tensor maps, needs a current
  // context. A thread that has made no runtime call yet (autograd's worker
  // thread can be one) has none until cudaSetDevice binds its device's
  // primary context.
  int device = 0;
  cudaError_t cerr = cudaGetDevice(&device);
  if (cerr == cudaSuccess) cerr = cudaSetDevice(device);
  if (cerr != cudaSuccess) return cerr;
  const int bh = batch * heads;
  const int groups = heads / heads_per_group;
  const int qb = chunk <= 64 ? 64 : 128;
  const int n_chunks = seq / chunk;
  CUtensorMap tx, tb, tc;
  int err = encode(&tx, x, p, chunk, n_chunks, heads, batch, strides, qb);
  if (err == 0) err = encode(&tb, B, n, chunk, n_chunks, groups, batch, strides + 3, qb);
  if (err == 0) err = encode(&tc, C, n, chunk, n_chunks, groups, batch, strides + 6, qb);
  if (err != 0) return err;
  const Params prm{seq, p, n, chunk, heads_per_group, heads, n_chunks, qb,
                   strides[9], strides[10], strides[11],
                   static_cast<const float*>(dt), static_cast<const float*>(A),
                   static_cast<const float*>(init_state), static_cast<__nv_bfloat16*>(y),
                   static_cast<float*>(state_out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool n2 = n > 64, p2 = p > 64;
  if (n2 && p2) return launch<2, 2>(tx, tb, tc, bh, prm, st);
  if (n2) return launch<2, 1>(tx, tb, tc, bh, prm, st);
  if (p2) return launch<1, 2>(tx, tb, tc, bh, prm, st);
  return launch<1, 1>(tx, tb, tc, bh, prm, st);
}

extern "C" const char* ssd_scan_sm90_error_string(int err) {
  static thread_local char buf[96];
  if (err == ERR_ENTRY_POINT) return "cudaGetDriverEntryPoint(cuTensorMapEncodeTiled) failed";
  if (err >= ERR_ENCODE) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed with CUresult %d",
             err - ERR_ENCODE);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
