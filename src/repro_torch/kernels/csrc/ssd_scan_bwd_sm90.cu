// Backward of the Mamba2 SSD chunk scan for bf16 on Hopper (sm_90a):
// wgmma fed by TMA, the chunks in parallel.
//
// No Pallas kernel is replaced: the reference trains through XLA's autodiff
// of its pure-jnp `ssd_chunked` (src/repro/models/ssm.py:106). This is the
// gradient of K3's forward (csrc/ssd_scan_sm90.cu) for bf16 inputs whose N
// and P are multiples of 8 with P <= 128, the shapes that forward takes; f32
// and every other bf16 shape keep the CUDA-core backward of ssd_scan_bwd.cu.
// Same function as that file's header and `ssd_scan_bwd_plain`, in the
// model's layout as the forward takes it: x, dy (B, S, H, P) and B, C (B, S,
// G, N) bf16 read through tensor maps at their own strides, dt (B, S, H) f32
// at its strides; dx (B, S, H, P), dB, dC (B, S, G, N) and ddt (B, S, H)
// written at the strides of the tensors the wrapper allocates; A, dA (B*H,)
// and the states (B*H, N, P), row b*H + h. Per row and
// chunk of Q steps, with s_in the state entering the chunk, cum the
// within-chunk cumulative sum of dt * A, T = cum[Q-1], L[i][j] = exp(cum_i -
// cum_j) for j <= i, G = C B^T, W = G o L o dt_j, u = exp(T - cum) o dt:
//   dX    = W^T dY + diag(u) B dS_out
//   dG    = (dY X^T) o L o dt_j        dC += dG B       dB += dG^T C
//   dC   += diag(exp(cum)) dY s_in^T   dB += diag(u) X dS_out^T
//   dS_in = exp(T) dS_out + C^T diag(exp(cum)) dY
// and the gradient of cum folds into ddt and dA through the within-chunk
// reverse cumulative sum.
//
// The decomposition. Only two (N, P) f32 matrices carry across chunks: the
// state s_in[c + 1] = exp(T_c) s_in[c] + B^T diag(u) X and, going back,
// dS_out[c - 1] = exp(T_c) dS_out[c] + C^T diag(exp(cum)) dY. Their
// per-chunk terms need nothing from other chunks, so five launches:
// 1. `ssd_bwd_terms_sm90_kernel`, one block per (chunk, block of HB heads of
//    one group): B^T diag(u) X and C^T diag(exp(cum)) dY of every row and
//    chunk (f32), and exp(T) per (row, chunk);
// 2. `ssd_bwd_states_sm90_kernel`, elementwise over (row, N x P): carries
//    both recurrences over the chunks, the loads of four chunks in flight at
//    a time; writes bf16 copies of s_in and dS_out for the products, the
//    initial state's gradient, and sum(dS_out o s_in) per (row, chunk)
//    (exp(T)'s gradient) as partial sums per block of 1024 entries, summed in
//    a fixed order. Up to 16 chunks each thread keeps its f32 s_in in
//    registers for that sum; past 16 s_in goes to memory in place of its
//    term and is read back;
// 3. `ssd_bwd_dx_sm90_kernel`, per (chunk, block of HB heads): dX, ddt and
//    dA's partial per (row, chunk). Works in the transposed frame, 64 rows j
//    per consumer warpgroup: G^T = B C^T once per block (a group's heads
//    read the same B and C), then per head dW^T = X dY^T (SS, 64 columns at a
//    time), W^T, the row sums of dW o W and of dW o G o L in registers, their
//    column sums by warp shuffles and a fixed-order sum over warps;
//    acc = B dS_out (SS), u's gradient v from it and X, acc *= u,
//    acc += W^T dY (RS: the bf16 A fragment straight from the accumulator);
//    C s_in (SS) for exp(cum)'s gradient; then one warp takes cum's
//    gradient, its reverse cumulative sum (a warp scan in f64), ddt and dA's
//    partial (f64), while the others go on to the next head (the sums it
//    reads are double-buffered);
// 4. `ssd_bwd_dbc_sm90_kernel`, per (chunk, block of HB heads): dB and dC.
//    Phase 1 sums dG over the block's heads in f32 registers (dW = dY X^T
//    per head, SS); phase 2 runs dC = (sum dG) B (RS) and dB = (sum dG)^T C
//    (SS, the bf16 sum through shared memory with the transpose bit) once
//    for all of them; phase 3 adds each head's diag(exp(cum)) dY s_in^T and
//    diag(u) X dS_out^T (SS) into the same two f32 accumulators. dB and dC
//    leave one f32 partial per block of heads (1/HB of a per-head partial);
// 5. `ssd_bwd_sum_sm90_kernel`: the partials of dB and dC over a group's
//    blocks, and dA over the chunks, each in a fixed order. No atomics: two
//    calls give the same bits.
// Why dX and dB/dC are two kernels: a block would have to hold G, dW and the
// running sum of dG (64 f32 registers each, per thread, for 64 rows x 128
// columns) beside the (Q, N) dB and dC accumulators (64 each at N = 128);
// 320 registers do not fit in the 168 that ptxas gives a consumer thread
// here. Split, the dX kernel peaks near 128 (G^T, half of dW^T and W's bf16
// fragment) and the dB/dC kernel near 160 (the two accumulators and the
// summed dG's fragment). This is the dK/dV-dQ split of K2's backward;
// dW = dY X^T is formed in both kernels (2 Q^2 P per row and chunk more than
// one pass needs).
//
// Rounding points against the plain version: X o u and dY o exp(cum) are
// rounded to bf16 before their products (the forward rounds X o wd the same
// way), as are s_in and dS_out (the forward rounds the state before C.state),
// W before W^T dY and sum_h dG_h before its two products. Every product
// accumulates in f32; the carried states, ddt, dA and the initial state's
// gradient stay f32. cum is summed in f64 and rounded once to f32 (in log2
// units), as `_cum`; the reverse cumulative sum of cum's gradient and dA are
// f64 sums.
//
// What bounds it on this card: at mamba2-1.3b's training shape (BH 256,
// S 1024, P 64, N 128, Q 128, 64 heads a group) the least work is 26.0
// GFLOP (0.0263 ms at 989 TFLOP/s: the Q x Q products over the kept pairs,
// C B^T and the two dG products once per group row) against 107.0 MB of
// inputs and gradients (0.0319 ms at 3.35 TB/s), so the bytes bound it. The
// decomposition adds its own traffic at that shape: the chunk terms, 134 MB
// of f32 written and read back; the bf16 states, 67 MB written and read
// twice; X and dY read four times and C and B once a block; 34 MB of dB/dC
// partials. What the design does about it:
// * 2,048 (row, chunk) pairs run in parallel instead of 256 serial rows;
//   the states pass is one coalesced, elementwise sweep (16-byte loads);
// * every product runs on the tensor cores with bf16 operands;
// * C, B, X and dY arrive by TMA from 5-D tensor maps (width, chunk,
//   chunks, heads, batch) at their own strides, so no layout copy precedes
//   the kernels, and the bf16 states from 4-D maps (width, N, chunks, rows)
//   of their scratch; boxes of 64 columns by 64 or 128 rows
//   and 128-byte swizzle; rows past the chunk or past N are out of bounds
//   and come as zeros, so any chunk from 1 to 128 works; a producer warp
//   keeps the next head's tiles in flight through a ring of mbarrier stages
//   while two consumer warpgroups compute; C and B load once per block,
//   each head's dt a head ahead;
// * the causal half: a warpgroup's products cover only the columns its rows
//   keep (64 of 128 for one of the two), masked entries are selected to 0
//   and exp is never taken above the diagonal; every exponent is a
//   difference;
// * no serial thread: cum is a warp scan in every consumer warp; the
//   reverse cumulative sum and dA are a warp scan and a warp sum.
// Not done here: fp8 products, a persistent grid, the chunk terms kept out
// of device memory (a look-back scan), TMA stores of dX, balancing the two
// warpgroups' columns (128 and 64).
//
// Entry point: `ssd_scan_bwd_sm90`, a plain C function that builds the
// tensor maps (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so no -lcuda), launches the five kernels on the
// given stream and returns 0 or an error code that
// `ssd_scan_bwd_sm90_error_string` names.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int QMAX = 128;               // longest chunk: rows of a token tile
constexpr int PANEL = QMAX * 128;       // one 64-column panel of 128 rows, 128-byte swizzle
constexpr int NCONSUMERS = 2;           // consumer warpgroups
constexpr int NTHREADS = 128 * (NCONSUMERS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;      // 128 * 40 + 256 * 232 <= 65536
constexpr int WARP_BYTES = 1024;        // each consumer warp's cum (log2 units) and dt
constexpr int WARPS_OFF_BYTES = NCONSUMERS * 4 * WARP_BYTES;
constexpr int DG_BYTES = 24 * 1024;     // sum of dG in bf16: panel 0 whole, panel 1's rows 64-127
constexpr int STATE_THREADS = 256;      // ssd_bwd_states_sm90_kernel: 4 entries a thread
constexpr int STATE_BLOCK = 4 * STATE_THREADS;
constexpr int STATE_GROUP = 4;          // chunks whose loads a thread of it keeps in flight
static_assert(128 * 128 / STATE_BLOCK <= 32, "a lane per states block of a row");
constexpr double LOG2E = 1.4426950408889634;
constexpr int ERR_ENTRY_POINT = 100000;  // cudaGetDriverEntryPoint failed
constexpr int ERR_ENCODE = 200000;       // + CUresult of cuTensorMapEncodeTiled

// Shared memory of the three TMA kernels, offsets from the 1024-byte
// aligned base. NPAN panels of N (C and B), PPAN panels of P (X, dY and the
// states). C and B first, then the ring of stages (terms: X, dY; dx and
// dbc: X, dY, s_in, dS_out), then per kernel what follows.
template <int NPAN, int PPAN>
struct Cfg {
  static constexpr int PP = 64 * PPAN;       // padded P: a product's n
  static constexpr int NP = 64 * NPAN;       // padded N
  static constexpr int CB = 2 * NPAN * PANEL;
  // ssd_bwd_terms_sm90_kernel
  static constexpr int T_STAGE = 2 * PPAN * PANEL;
  static constexpr int T_NSTAGES = 2;
  static constexpr int T_WARP_OFF = CB + T_NSTAGES * T_STAGE;
  static constexpr int T_BAR_OFF = T_WARP_OFF + WARPS_OFF_BYTES;
  static constexpr int T_SMEM = 1024 + T_BAR_OFF + 8 * (1 + 2 * T_NSTAGES);
  // ssd_bwd_dx_sm90_kernel and ssd_bwd_dbc_sm90_kernel: a stage holds X, dY, s_in, dS_out
  static constexpr int STAGE = 4 * PPAN * PANEL;
  static constexpr int NSTAGES = PPAN == 1 ? 2 : 1;
  static constexpr int RING_END = CB + NSTAGES * STAGE;
  // ssd_bwd_dx_sm90_kernel: the warps' cum and dt, then two buffers (by the
  // head's parity: the next head fills one while a warp reads the other) of
  // each warp's column sums of dW o W (8 x 128 f32) and colR, ddtL, v,
  // inter (4 x 128 f32)
  static constexpr int X_WARP_OFF = RING_END;
  static constexpr int X_SUMS_OFF = X_WARP_OFF + WARPS_OFF_BYTES;
  static constexpr int X_SUMS = 12 * QMAX * 4;
  static constexpr int X_BAR_OFF = X_SUMS_OFF + 2 * X_SUMS;
  static constexpr int X_SMEM = 1024 + X_BAR_OFF + 8 * (1 + 2 * NSTAGES);
  // ssd_bwd_dbc_sm90_kernel: the summed dG in bf16, then the warps' cum and dt
  static constexpr int D_DG_OFF = RING_END;
  static constexpr int D_WARP_OFF = D_DG_OFF + DG_BYTES;
  static constexpr int D_BAR_OFF = D_WARP_OFF + WARPS_OFF_BYTES;
  static constexpr int D_SMEM = 1024 + D_BAR_OFF + 8 * (1 + 2 * NSTAGES);
  static_assert(T_SMEM <= 232448 && X_SMEM <= 232448 && D_SMEM <= 232448, "shared memory");
};

// Batch, sequence and head strides of a (B, S, H, W) tensor, in elements.
struct Strides {
  long long b, s, h;
};

struct Params {
  int bh;
  int heads;       // H
  int seq;
  int p;
  int n;
  int chunk;
  int group;       // heads per group
  int hb;          // heads per block (divides group)
  int n_chunks;    // seq / chunk
  int qb;          // tokens per box: 64 if chunk <= 64, else 128
  int nb;          // state rows per box: 64 if n <= 64, else 128
  int yb;          // ssd_bwd_states_sm90_kernel blocks per row
  const float* dt;
  const float* A;
  const float* init;
  const float* dfinal;
  __nv_bfloat16* dx;
  float* ddt;
  float* dA;
  __nv_bfloat16* dB;
  __nv_bfloat16* dC;
  float* dinit;
  float* sx;               // (bh, nc, n, p): B^T diag(u) X, then s_in
  float* sy;               // (bh, nc, n, p): C^T diag(exp(cum)) dY
  __nv_bfloat16* sin16;    // (bh, nc, n, p)
  __nv_bfloat16* ds16;     // (bh, nc, n, p)
  float* decay;            // (bh, nc): exp(T)
  float* ts;               // (bh, yb, nc): partial sums of dS_out o s_in
  float* part;             // (2, bh / hb, seq, n): dB, then dC
  double* pda;             // (bh, nc)
  Strides s_dt, s_ddt, s_dx, s_db, s_dc;
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

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
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

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle (layout 1 in bits 62-63).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A K-major operand: rows from `row0` of a tile whose columns (K) run in
// 64-column panels; k16 step kk is 32 bytes along a panel, then the next.
__device__ __forceinline__ uint64_t kmaj(uint32_t tile, int row0, int kk) {
  return make_desc(tile + row0 * 128 + (kk / 4) * PANEL + (kk % 4) * 32, 16, 1024);
}

// An MN-major operand: K runs down the tile's rows (k16 step kk is 16 rows),
// M or N across the columns, panel `panel` first, the next at +PANEL.
__device__ __forceinline__ uint64_t mnmaj(uint32_t tile, int panel, int kk) {
  return make_desc(tile + panel * PANEL + kk * 16 * 128, PANEL, 1024);
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
// across this point.
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

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
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

// (col, col + 1) of a row of a swizzled bf16 tile, as f32.
__device__ __forceinline__ float2 tile_pair(const uint8_t* tile, int row, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + swizzled(row, col)));
}

// Sum over the four lanes of a quad (one accumulator row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// One row's dt over a chunk and its A, read a head ahead of their use: lane
// l holds tokens 4l .. 4l+3, 0 past the chunk.
struct RowDt {
  float d[4];
  float a;
};

__device__ __forceinline__ RowDt load_dt(const Params& p, int row, int c, int lane) {
  const Strides& st = p.s_dt;
  const float* dtr = p.dt + (row / p.heads) * st.b + (row % p.heads) * st.h +
                     static_cast<long long>(c) * p.chunk * st.s;
  RowDt r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.d[i] = 4 * lane + i < p.chunk ? dtr[(4 * lane + i) * st.s] : 0.f;
  r.a = p.A[row];
  return r;
}

// cum (log2 units) and dt of one row's chunk into this warp's arrays: dt * A
// rounded to f32 as the plain version's product, summed in f64 (in the
// lane, then a warp scan), each entry rounded once to f32. Tokens past the
// chunk add 0, so entry QMAX - 1 is the total.
__device__ __forceinline__ void chunk_scalars(const RowDt& r, int lane, float* wcum,
                                              float* wdt) {
  double cs[4];
  double run = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    run += static_cast<double>(__fmul_rn(r.d[i], r.a));
    cs[i] = run;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  __syncwarp();  // this warp's reads of the previous row's arrays are done
  *reinterpret_cast<float4*>(wcum + 4 * lane) = make_float4(
      static_cast<float>((excl + cs[0]) * LOG2E), static_cast<float>((excl + cs[1]) * LOG2E),
      static_cast<float>((excl + cs[2]) * LOG2E), static_cast<float>((excl + cs[3]) * LOG2E));
  *reinterpret_cast<float4*>(wdt + 4 * lane) = make_float4(r.d[0], r.d[1], r.d[2], r.d[3]);
  __syncwarp();
}

// X rows j times u_j = exp(T - cum_j) dt_j and dY rows i times exp(cum_i),
// in place and rounded to bf16, 16-byte pieces (a piece keeps its row under
// the swizzle); every consumer thread takes pieces. Ends before any fence.
template <int PPAN>
__device__ __forceinline__ void scale_x_dy(uint8_t* xs, uint8_t* dys, int qb, float tot2,
                                           const float* wcum, const float* wdt) {
  const int per = PPAN * qb * 8;  // pieces of one tile
  for (int idx = threadIdx.x; idx < 2 * per; idx += NCONSUMERS * 128) {
    const bool is_dy = idx >= per;
    const int rem = is_dy ? idx - per : idx;
    const int r = (rem % (qb * 8)) / 8;
    const uint32_t off = (rem / (qb * 8)) * PANEL + (rem % (qb * 8)) * 16;
    const float f = is_dy ? ex2(wcum[r]) : ex2(tot2 - wcum[r]) * wdt[r];
    uint8_t* ptr = (is_dy ? dys : xs) + off;
    uint4 v = *reinterpret_cast<const uint4*>(ptr);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(h[e]);
      h[e] = __floats2bfloat162_rn(x.x * f, x.y * f);
    }
    *reinterpret_cast<uint4*>(ptr) = v;
  }
}

// Loads C and B of (the group row row reads, chunk) onto `bar` (once per block).
template <int NPAN>
__device__ __forceinline__ void load_cb(uint32_t base, uint32_t bar, const CUtensorMap* tc,
                                        const CUtensorMap* tb, int c, int row, const Params& p) {
  const int bi = row / p.heads, gi = (row % p.heads) / p.group;
  mbar_expect_tx(bar, 2 * NPAN * p.qb * 128);
#pragma unroll
  for (int pn = 0; pn < NPAN; ++pn) {
    tma_load_5d(base + pn * PANEL, tc, bar, pn * 64, 0, c, gi, bi);
    tma_load_5d(base + (NPAN + pn) * PANEL, tb, bar, pn * 64, 0, c, gi, bi);
  }
}

// Loads X and dY of (row, chunk), and s_in and dS_out when `states`, into a
// stage laid out X, dY, s_in, dS_out.
template <int PPAN>
__device__ __forceinline__ void load_head(uint32_t stage, uint32_t bar, const CUtensorMap* tx,
                                          const CUtensorMap* tdy, const CUtensorMap* tsin,
                                          const CUtensorMap* tds, int c, int row, const Params& p,
                                          bool states) {
  const int bi = row / p.heads, h = row % p.heads;
  mbar_expect_tx(bar, 2 * PPAN * p.qb * 128 + (states ? 2 * PPAN * p.nb * 128 : 0));
#pragma unroll
  for (int pp = 0; pp < PPAN; ++pp) {
    tma_load_5d(stage + pp * PANEL, tx, bar, pp * 64, 0, c, h, bi);
    tma_load_5d(stage + (PPAN + pp) * PANEL, tdy, bar, pp * 64, 0, c, h, bi);
    if (states) {
      tma_load_4d(stage + (2 * PPAN + pp) * PANEL, tsin, bar, pp * 64, 0, c, row);
      tma_load_4d(stage + (3 * PPAN + pp) * PANEL, tds, bar, pp * 64, 0, c, row);
    }
  }
}

__device__ __forceinline__ uint8_t* aligned_base(uint8_t* smem_raw, uint32_t* base) {
  const uint32_t raw = smem_u32(smem_raw);
  *base = (raw + 1023u) & ~1023u;
  return smem_raw + (*base - raw);
}

// Accumulator fragment of wgmma m64nNk16 (f32), per thread of a warpgroup
// (warp w, lane l): register r holds row 16w + l/4 + 8*((r >> 1) & 1) and
// column 8*(r >> 2) + 2*(l % 4) + (r & 1). Registers 8kk .. 8kk+7, as bf16
// pairs, are the A fragment of k16 step kk of an RS product.

// ---- 1. the per-chunk state terms -------------------------------------------

template <int NPAN, int PPAN>
__global__ void __launch_bounds__(NTHREADS, 1)
    ssd_bwd_terms_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                              const __grid_constant__ CUtensorMap tm_dy,
                              const __grid_constant__ CUtensorMap tm_b,
                              const __grid_constant__ CUtensorMap tm_c, const Params p) {
  using Cf = Cfg<NPAN, PPAN>;
  constexpr int PP = Cf::PP;
  constexpr int NST = Cf::T_NSTAGES;
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* gbase = aligned_base(smem_raw, &base);
  const uint32_t bar_cb = base + Cf::T_BAR_OFF;
  const uint32_t bar_full = bar_cb + 8;
  const uint32_t bar_empty = bar_full + 8 * NST;
  const int c = blockIdx.x;
  const int row0 = blockIdx.y * p.hb;

  if (threadIdx.x == 0) {
    mbar_init(bar_cb, 1);
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NCONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NCONSUMERS * 128) {
      load_cb<NPAN>(base, bar_cb, &tm_c, &tm_b, c, row0, p);
      for (int k = 0; k < p.hb; ++k) {
        const int s = k % NST;
        mbar_wait(bar_empty + 8 * s, ((k / NST) & 1) ^ 1);
        load_head<PPAN>(base + Cf::CB + s * Cf::T_STAGE, bar_full + 8 * s, &tm_x, &tm_dy,
                        nullptr, nullptr, c, row0 + k, p, false);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int c0 = 2 * (lane % 4);
  const int r0 = wg * 64 + warp * 16 + lane / 4;  // state rows n: r0 and r0 + 8
  float* wcum = reinterpret_cast<float*>(gbase + Cf::T_WARP_OFF + (wg * 4 + warp) * WARP_BYTES);
  float* wdt = wcum + QMAX;
  const uint32_t s_c = base;
  const uint32_t s_b = base + NPAN * PANEL;
  mbar_wait(bar_cb, 0);

  RowDt next = load_dt(p, row0, c, lane);
  for (int k = 0; k < p.hb; ++k) {
    const int row = row0 + k;
    const int s = k % NST;
    chunk_scalars(next, lane, wcum, wdt);
    if (k + 1 < p.hb) next = load_dt(p, row + 1, c, lane);
    const float tot2 = wcum[QMAX - 1];
    mbar_wait(bar_full + 8 * s, (k / NST) & 1);
    const uint32_t s_x = base + Cf::CB + s * Cf::T_STAGE;
    const uint32_t s_dy = s_x + PPAN * PANEL;
    scale_x_dy<PPAN>(gbase + (s_x - base), gbase + (s_dy - base), p.qb, tot2, wcum, wdt);
    fence_proxy_async();
    consumers_sync();  // X o u and dY o exp(cum) are whole

    float sx[PP / 2], sy[PP / 2];
    const bool rows = wg < NPAN;  // state rows past N are not held
    if (rows) {
      zero(sx);
      zero(sy);
      reg_fence(sx);
      reg_fence(sy);
      wgmma_fence();
      // B^T (X o u) and C^T (dY o exp(cum)): B and C read MN-major
      // (transpose-A), this warpgroup's 64 state rows are their panel wg
      for (int kk = 0; kk < p.qb / 16; ++kk) {
        wgmma_ss<PP, 1, 1>(sx, mnmaj(s_b, wg, kk), mnmaj(s_x, 0, kk), 1);
        wgmma_ss<PP, 1, 1>(sy, mnmaj(s_c, wg, kk), mnmaj(s_dy, 0, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sx);
      reg_fence(sy);
    }
    mbar_arrive(bar_empty + 8 * s);
    if (rows) {
      const size_t plane = (static_cast<size_t>(row) * p.n_chunks + c) * p.n;
#pragma unroll
      for (int jj = 0; jj < PP / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nn = r0 + 8 * h;
          const int col = 8 * jj + c0;
          if (nn < p.n && col < p.p) {
            const size_t off = (plane + nn) * p.p + col;
            *reinterpret_cast<float2*>(p.sx + off) =
                make_float2(sx[4 * jj + 2 * h], sx[4 * jj + 2 * h + 1]);
            *reinterpret_cast<float2*>(p.sy + off) =
                make_float2(sy[4 * jj + 2 * h], sy[4 * jj + 2 * h + 1]);
          }
        }
    }
    if (threadIdx.x == 0) p.decay[static_cast<size_t>(row) * p.n_chunks + c] = ex2(tot2);
  }
}

// ---- 2. the states pass -------------------------------------------------------

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float4 v) {
  uint2 w;
  w.x = pack_bf16(v.x, v.y);
  w.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) = w;
}

// sum(dS_out o s_in) of up to STATE_GROUP chunks, c1, c1 - 1, ..: each
// thread's part in v, a warp sum, then the block's warps in a fixed order.
__device__ __forceinline__ void state_sums(const Params& p, float (&v)[STATE_GROUP],
                                           float (*red)[STATE_THREADS / 32], int row, int c1) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < STATE_GROUP; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
    if (lane == 0) red[k][warp] = v[k];
  }
  __syncthreads();
  const int k = threadIdx.x;
  if (k < STATE_GROUP && c1 - k >= 0 && c1 - k < p.n_chunks) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < STATE_THREADS / 32; ++w) sum += red[k][w];
    p.ts[(static_cast<size_t>(row) * p.yb + blockIdx.x) * p.n_chunks + (c1 - k)] = sum;
  }
  __syncthreads();
}

// One thread per 4 entries of a row's (N, P) state; blockIdx.x the block of
// entries, blockIdx.y the row, so that the blocks in flight cover whole rows.
// STATE_GROUP chunks at a time: their loads are issued before any of their
// stores. With NCR > 0 (at most NCR chunks) each thread keeps its entries of
// s_in in registers for the reverse pass's sum(dS_out o s_in); with NCR = 0
// s_in goes to memory in place of its term and is read back.
template <int NCR>
__global__ void __launch_bounds__(STATE_THREADS)
    ssd_bwd_states_sm90_kernel(const Params p) {
  __shared__ float red[STATE_GROUP][STATE_THREADS / 32];
  const int row = blockIdx.y;
  const int np = p.n * p.p;
  const int e = (blockIdx.x * STATE_THREADS + threadIdx.x) * 4;
  const bool mine = e < np;
  const int nc = p.n_chunks;
  const float* dec = p.decay + static_cast<size_t>(row) * nc;
  const size_t first = static_cast<size_t>(row) * nc * np + e;  // chunk 0's entry
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 keep[NCR > 0 ? NCR : 1];
  float4 st = (mine && p.init != nullptr)
                  ? *reinterpret_cast<const float4*>(p.init + static_cast<size_t>(row) * np + e)
                  : zero4;
  // s_in forward: s_in[c + 1] = exp(T_c) s_in[c] + term[c]
  auto forward = [&](int c0, auto&& put) {
    float4 term[STATE_GROUP];
    float et[STATE_GROUP];
#pragma unroll
    for (int k = 0; k < STATE_GROUP; ++k)
      if (c0 + k < nc) {
        term[k] = *reinterpret_cast<const float4*>(p.sx + first + static_cast<size_t>(c0 + k) * np);
        et[k] = dec[c0 + k];
      }
#pragma unroll
    for (int k = 0; k < STATE_GROUP; ++k)
      if (c0 + k < nc) {
        const size_t off = first + static_cast<size_t>(c0 + k) * np;
        put(k, off, st);
        store_bf16x4(p.sin16 + off, st);
        st = fma4(et[k], st, term[k]);
      }
  };
  if constexpr (NCR > 0) {
#pragma unroll
    for (int c0 = 0; c0 < NCR; c0 += STATE_GROUP)
      if (c0 < nc && mine) forward(c0, [&](int k, size_t, float4 v) { keep[c0 + k] = v; });
  } else {
    for (int c0 = 0; c0 < nc && mine; c0 += STATE_GROUP)
      forward(c0, [&](int, size_t off, float4 v) {
        *reinterpret_cast<float4*>(p.sx + off) = v;  // s_in[c], in place of its term
      });
  }
  // dS_out back: dS_out[c - 1] = exp(T_c) dS_out[c] + term[c]; sum(dS_out o s_in)
  float4 d = (mine && p.dfinal != nullptr)
                 ? *reinterpret_cast<const float4*>(p.dfinal + static_cast<size_t>(row) * np + e)
                 : zero4;
  auto back = [&](int c1, auto&& s_in_of) {
    float4 s_in[STATE_GROUP], term[STATE_GROUP];
    float et[STATE_GROUP], v[STATE_GROUP];
#pragma unroll
    for (int k = 0; k < STATE_GROUP; ++k)
      if (mine && c1 - k >= 0 && c1 - k < nc) {
        const size_t off = first + static_cast<size_t>(c1 - k) * np;
        s_in[k] = s_in_of(k, off);
        term[k] = *reinterpret_cast<const float4*>(p.sy + off);
        et[k] = dec[c1 - k];
      }
#pragma unroll
    for (int k = 0; k < STATE_GROUP; ++k) {
      v[k] = 0.f;
      if (mine && c1 - k >= 0 && c1 - k < nc) {
        store_bf16x4(p.ds16 + first + static_cast<size_t>(c1 - k) * np, d);
        v[k] = d.x * s_in[k].x + d.y * s_in[k].y + d.z * s_in[k].z + d.w * s_in[k].w;
        d = fma4(et[k], d, term[k]);
      }
    }
    state_sums(p, v, red, row, c1);
  };
  if constexpr (NCR > 0) {
#pragma unroll
    for (int c1 = NCR - 1; c1 >= 0; c1 -= STATE_GROUP)
      if (c1 - (STATE_GROUP - 1) < nc)  // the same for every thread
        back(c1, [&](int k, size_t) { return keep[c1 - k]; });
  } else {
    for (int c1 = nc - 1; c1 >= 0; c1 -= STATE_GROUP)
      back(c1, [&](int, size_t off) { return *reinterpret_cast<const float4*>(p.sx + off); });
  }
  if (mine && p.dinit != nullptr)
    *reinterpret_cast<float4*>(p.dinit + static_cast<size_t>(row) * np + e) = d;
}

// ---- 3. dX, ddt and dA's partials --------------------------------------------
//
// Warpgroup wg holds rows j = wg*64 .. wg*64+63 of G^T, dW^T, W^T and dX
// (and rows i of C s_in), and the columns i those rows keep: NW columns from
// I0 (wg 0: 128 from 0, or 64 when the chunk fits in 64; wg 1: 64 from 64).

// Lane b's partial of sum(dS_out o s_in) of (row, chunk), 0 past the
// states pass's blocks (at most 16); read a head ahead of its use.
__device__ __forceinline__ float load_ts(const Params& p, int row, int c, int lane) {
  return lane < p.yb ? p.ts[(static_cast<size_t>(row) * p.yb + lane) * p.n_chunks + c] : 0.f;
}

// cum's gradient, its reverse cumulative sum, ddt and dA's partial of one
// (row, chunk), by one warp: lane l takes tokens 4l .. 4l+3; `ts_part` is
// the lane's partial of sum(dS_out o s_in).
__device__ __forceinline__ void dx_epilogue(const Params& p, const float* wcum, const float* wdt,
                                            const float* rpart, const float* colR,
                                            const float* ddtL, const float* vv,
                                            const float* inter, float ts_part, int row, int c,
                                            int lane) {
  const float a = p.A[row];
  const float tot2 = wcum[QMAX - 1];
  const int nc = p.n_chunks;
  float ts = ts_part;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ts += __shfl_xor_sync(0xffffffffu, ts, o);
  float dcum[4], uv = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 4 * lane + q;
    dcum[q] = 0.f;
    if (i < p.chunk) {
      float rr = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) rr += rpart[w * QMAX + i];
      if (p.qb == QMAX && i >= 64) {
#pragma unroll
        for (int w = 4; w < 8; ++w) rr += rpart[w * QMAX + i];
      }
      const float u = ex2(tot2 - wcum[i]) * wdt[i];
      dcum[q] = rr - colR[i] + inter[i] - u * vv[i];
      uv += u * vv[i];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) uv += __shfl_xor_sync(0xffffffffu, uv, o);
  const float dT = ex2(tot2) * ts + uv;
  if ((p.chunk - 1) / 4 == lane) dcum[(p.chunk - 1) % 4] += dT;
  // reverse cumulative sum in f64: in the lane, then a suffix scan over lanes
  double sfx[4];
  double run = 0.0;
#pragma unroll
  for (int q = 3; q >= 0; --q) {
    run += static_cast<double>(dcum[q]);
    sfx[q] = run;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += u;
  }
  double excl = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) excl = 0.0;
  double da = 0.0;
  const Strides& sd = p.s_ddt;
  float* ddt = p.ddt + (row / p.heads) * sd.b + (row % p.heads) * sd.h +
               static_cast<long long>(c) * p.chunk * sd.s;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 4 * lane + q;
    if (i < p.chunk) {
      const double rc = sfx[q] + excl;
      ddt[i * sd.s] = ddtL[i] + ex2(tot2 - wcum[i]) * vv[i] + a * static_cast<float>(rc);
      da += static_cast<double>(wdt[i]) * rc;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
  if (lane == 0) p.pda[static_cast<size_t>(row) * nc + c] = da;
}

template <int NW, int I0, int NPAN, int PPAN>
__device__ __forceinline__ void dx_consumer(const Params& p, uint8_t* gbase, uint32_t base,
                                            int wg) {
  using Cf = Cfg<NPAN, PPAN>;
  constexpr int PP = Cf::PP;
  constexpr int NST = Cf::NSTAGES;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int c0 = 2 * (lane % 4);
  const int r0 = wg * 64 + warp * 16 + lane / 4;  // this thread's rows r0 and r0 + 8
  const int c = blockIdx.x;
  const int row0 = blockIdx.y * p.hb;
  float* wcum = reinterpret_cast<float*>(gbase + Cf::X_WARP_OFF + (wg * 4 + warp) * WARP_BYTES);
  float* wdt = wcum + QMAX;
  const uint32_t s_c = base;
  const uint32_t s_b = base + NPAN * PANEL;
  const uint32_t bar_cb = base + Cf::X_BAR_OFF;
  const uint32_t bar_full = bar_cb + 8;
  const uint32_t bar_empty = bar_full + 8 * NST;

  // G^T = B C^T over N, once for the block's heads
  float gt[NW / 2];
  mbar_wait(bar_cb, 0);
  zero(gt);
  reg_fence(gt);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NPAN * 4; ++kk)
    wgmma_ss<NW, 0, 0>(gt, kmaj(s_b, wg * 64, kk), kmaj(s_c, I0, kk), 1);
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(gt);

  const bool epilogue = wg == 0 && warp == 0;  // the warp that takes cum's gradient
  RowDt next = load_dt(p, row0, c, lane);
  float ts_next = epilogue ? load_ts(p, row0, c, lane) : 0.f;
  for (int k = 0; k < p.hb; ++k) {
    const int row = row0 + k;
    const int s = k % NST;
    chunk_scalars(next, lane, wcum, wdt);
    const float ts_part = ts_next;
    if (k + 1 < p.hb) {
      next = load_dt(p, row + 1, c, lane);
      if (epilogue) ts_next = load_ts(p, row + 1, c, lane);
    }
    const float tot2 = wcum[QMAX - 1];
    float* rpart = reinterpret_cast<float*>(gbase + Cf::X_SUMS_OFF + (k & 1) * Cf::X_SUMS);
    float* colR = rpart + 8 * QMAX;
    float* ddtL = colR + QMAX;
    float* vv = ddtL + QMAX;
    float* inter = vv + QMAX;
    float* my_rpart = rpart + (wg * 4 + warp) * QMAX;
    mbar_wait(bar_full + 8 * s, (k / NST) & 1);
    const uint32_t s_x = base + Cf::CB + s * Cf::STAGE;
    const uint32_t s_dy = s_x + PPAN * PANEL;
    const uint32_t s_sin = s_dy + PPAN * PANEL;
    const uint32_t s_ds = s_sin + PPAN * PANEL;
    const uint8_t* g_x = gbase + (s_x - base);
    const uint8_t* g_dy = gbase + (s_dy - base);

    // W^T = G^T o L^T o dt_j where i >= j, selected to 0 elsewhere; the row
    // sums of dW o W and dW o G o L; the column sums of dW o W per warp.
    // dW^T = X dY^T over P, 64 columns at a time, so that G^T, one half of
    // dW^T and W's fragment fit the registers together
    const float cj[2] = {wcum[r0], wcum[r0 + 8]};
    const float dtj[2] = {wdt[r0], wdt[r0 + 8]};
    uint32_t pa[NW / 16][4];
    float colr[2] = {0.f, 0.f}, ddl[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < NW / 64; ++half) {
      float dw[32];
      zero(dw);
      reg_fence(dw);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PPAN * 4; ++kk)
        wgmma_ss<64, 0, 0>(dw, kmaj(s_x, wg * 64, kk), kmaj(s_dy, I0 + 64 * half, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(dw);
#pragma unroll
      for (int jl = 0; jl < 8; ++jl) {
        const int jj = 8 * half + jl;
        float w[2][2], cp[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 4 * jj + 2 * h + e;
            const float dwv = dw[4 * jl + 2 * h + e];
            const int i = I0 + 8 * jj + c0 + e;
            float gl = 0.f;
            if (i >= r0 + 8 * h) gl = gt[r] * ex2(wcum[i] - cj[h]);
            const float wv = gl * dtj[h];
            const float rr = dwv * wv;
            colr[h] += rr;
            ddl[h] += dwv * gl;
            cp[e] += rr;
            w[h][e] = wv;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) pa[jj / 2][2 * (jj % 2) + h] = pack_bf16(w[h][0], w[h][1]);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          cp[0] += __shfl_xor_sync(0xffffffffu, cp[0], o);
          cp[1] += __shfl_xor_sync(0xffffffffu, cp[1], o);
        }
        if (lane < 4)
          *reinterpret_cast<float2*>(my_rpart + I0 + 8 * jj + 2 * lane) =
              make_float2(cp[0], cp[1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      colr[h] = quad_sum(colr[h]);
      ddl[h] = quad_sum(ddl[h]);
      if (lane % 4 == 0) {
        colR[r0 + 8 * h] = colr[h];
        ddtL[r0 + 8 * h] = ddl[h];
      }
    }

    // acc = B dS_out (dS_out MN-major); v = rowsum(X o acc); acc *= u;
    // acc += W^T dY (RS, dY MN-major from row I0)
    float acc[PP / 2];
    zero(acc);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NPAN * 4; ++kk)
      wgmma_ss<PP, 0, 1>(acc, kmaj(s_b, wg * 64, kk), mnmaj(s_ds, 0, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = 0.f;
#pragma unroll
      for (int jj = 0; jj < PP / 8; ++jj) {
        const float2 xv = tile_pair(g_x, r0 + 8 * h, 8 * jj + c0);
        v += xv.x * acc[4 * jj + 2 * h] + xv.y * acc[4 * jj + 2 * h + 1];
      }
      v = quad_sum(v);
      if (lane % 4 == 0) vv[r0 + 8 * h] = v;
      const float u = ex2(tot2 - cj[h]) * dtj[h];
#pragma unroll
      for (int jj = 0; jj < PP / 8; ++jj) {
        acc[4 * jj + 2 * h] *= u;
        acc[4 * jj + 2 * h + 1] *= u;
      }
    }
    reg_fence(acc);
    reg_fence(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NW / 16; ++kk) wgmma_rs<PP>(acc, pa[kk], mnmaj(s_dy, 0, I0 / 16 + kk));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
    reg_fence(pa);
    {
      const Strides& sx = p.s_dx;
      __nv_bfloat16* out = p.dx + (row / p.heads) * sx.b + (row % p.heads) * sx.h +
                           static_cast<long long>(c) * p.chunk * sx.s;
#pragma unroll
      for (int jj = 0; jj < PP / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = r0 + 8 * h;
          const int col = 8 * jj + c0;
          if (j < p.chunk && col < p.p)
            *reinterpret_cast<uint32_t*>(out + j * sx.s + col) =
                pack_bf16(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
        }
    }

    // C s_in (s_in MN-major), rows i of this warpgroup: exp(cum)'s gradient
    // sum_p dY o (C s_in), times exp(cum_i)
    zero(acc);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NPAN * 4; ++kk)
      wgmma_ss<PP, 0, 1>(acc, kmaj(s_c, wg * 64, kk), mnmaj(s_sin, 0, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = 0.f;
#pragma unroll
      for (int jj = 0; jj < PP / 8; ++jj) {
        const float2 dv = tile_pair(g_dy, r0 + 8 * h, 8 * jj + c0);
        v += dv.x * acc[4 * jj + 2 * h] + dv.y * acc[4 * jj + 2 * h + 1];
      }
      v = quad_sum(v);
      if (lane % 4 == 0) inter[r0 + 8 * h] = ex2(cj[h]) * v;
    }
    mbar_arrive(bar_empty + 8 * s);  // this thread reads stage s no more
    // the sums of this row are whole; the next head fills the other buffer,
    // and the one after waits at this barrier for the epilogue's reads
    consumers_sync();
    if (epilogue)
      dx_epilogue(p, wcum, wdt, rpart, colR, ddtL, vv, inter, ts_part, row, c, lane);
  }
}

// A warpgroup with no rows (the chunk fits in 64): keeps the ring and the
// barriers in step.
template <int NST>
__device__ __forceinline__ void idle_consumer(uint32_t bar_full, uint32_t bar_empty, int items) {
  for (int k = 0; k < items; ++k) {
    const int s = k % NST;
    mbar_wait(bar_full + 8 * s, (k / NST) & 1);
    mbar_arrive(bar_empty + 8 * s);
    consumers_sync();
  }
}

template <int NPAN, int PPAN>
__global__ void __launch_bounds__(NTHREADS, 1)
    ssd_bwd_dx_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_dy,
                           const __grid_constant__ CUtensorMap tm_b,
                           const __grid_constant__ CUtensorMap tm_c,
                           const __grid_constant__ CUtensorMap tm_sin,
                           const __grid_constant__ CUtensorMap tm_ds, const Params p) {
  using Cf = Cfg<NPAN, PPAN>;
  constexpr int NST = Cf::NSTAGES;
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* gbase = aligned_base(smem_raw, &base);
  const uint32_t bar_cb = base + Cf::X_BAR_OFF;
  const uint32_t bar_full = bar_cb + 8;
  const uint32_t bar_empty = bar_full + 8 * NST;
  const int c = blockIdx.x;
  const int row0 = blockIdx.y * p.hb;

  if (threadIdx.x == 0) {
    mbar_init(bar_cb, 1);
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NCONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NCONSUMERS * 128) {
      load_cb<NPAN>(base, bar_cb, &tm_c, &tm_b, c, row0, p);
      for (int k = 0; k < p.hb; ++k) {
        const int s = k % NST;
        mbar_wait(bar_empty + 8 * s, ((k / NST) & 1) ^ 1);
        load_head<PPAN>(base + Cf::CB + s * Cf::STAGE, bar_full + 8 * s, &tm_x, &tm_dy,
                        &tm_sin, &tm_ds, c, row0 + k, p, true);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  if (p.qb == QMAX) {
    if (wg == 0) dx_consumer<128, 0, NPAN, PPAN>(p, gbase, base, wg);
    else dx_consumer<64, 64, NPAN, PPAN>(p, gbase, base, wg);
  } else {
    if (wg == 0) dx_consumer<64, 0, NPAN, PPAN>(p, gbase, base, wg);
    else idle_consumer<NST>(bar_full, bar_empty, p.hb);
  }
}

// ---- 4. dB and dC --------------------------------------------------------------
//
// Warpgroup wg holds rows i = wg*64 .. wg*64+63 of dW, the summed dG and dC,
// and rows j = wg*64 .. of dB; NS: the columns j its rows i keep (64 for
// rows 0-63, 128 for rows 64-127).

// Byte offset of (i, j) in the summed dG's tile: panel j / 64 of 64 columns,
// panel 1 based 8 KB in, so that only its rows 64-127 (those j >= 64 keeps)
// take room.
__device__ __forceinline__ uint32_t dg_offset(int i, int j) {
  const int pc = j % 64;
  return (j / 64) * 8192 + i * 128 + (((pc / 8) ^ (i % 8)) * 16) + (pc % 8) * 2;
}

template <int NS, int NPAN, int PPAN>
__device__ __forceinline__ void dbc_consumer(const Params& p, uint8_t* gbase, uint32_t base,
                                             int wg) {
  using Cf = Cfg<NPAN, PPAN>;
  constexpr int NP = Cf::NP;
  constexpr int NST = Cf::NSTAGES;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int c0 = 2 * (lane % 4);
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  const int c = blockIdx.x;
  const int row0 = blockIdx.y * p.hb;
  float* wcum = reinterpret_cast<float*>(gbase + Cf::D_WARP_OFF + (wg * 4 + warp) * WARP_BYTES);
  float* wdt = wcum + QMAX;
  const uint32_t s_c = base;
  const uint32_t s_b = base + NPAN * PANEL;
  const uint32_t s_dg = base + Cf::D_DG_OFF;
  const uint32_t bar_cb = base + Cf::D_BAR_OFF;
  const uint32_t bar_full = bar_cb + 8;
  const uint32_t bar_empty = bar_full + 8 * NST;
  constexpr int NSA = NS > 0 ? NS : 64;   // register arrays of a warpgroup with no rows unused
  mbar_wait(bar_cb, 0);

  // phase 1: sum over the block's heads of dG = (dY X^T) o L o dt_j
  float sdg[NSA / 2];
  zero(sdg);
  // dt a head ahead, over phase 1's heads and then phase 3's
  RowDt next = load_dt(p, row0, c, lane);
  for (int k = 0; k < p.hb; ++k) {
    const int s = k % NST;
    chunk_scalars(next, lane, wcum, wdt);
    next = load_dt(p, row0 + (k + 1) % p.hb, c, lane);
    mbar_wait(bar_full + 8 * s, (k / NST) & 1);
    const uint32_t s_x = base + Cf::CB + s * Cf::STAGE;
    const uint32_t s_dy = s_x + PPAN * PANEL;
    if constexpr (NS > 0) {
      float dw[NS / 2];
      zero(dw);
      reg_fence(dw);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PPAN * 4; ++kk)
        wgmma_ss<NS, 0, 0>(dw, kmaj(s_dy, wg * 64, kk), kmaj(s_x, 0, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(dw);
      mbar_arrive(bar_empty + 8 * s);
      const float ci[2] = {wcum[r0], wcum[r0 + 8]};
#pragma unroll
      for (int r = 0; r < NS / 2; ++r) {
        const int h = (r >> 1) & 1;
        const int j = 8 * (r >> 2) + c0 + (r & 1);
        if (j <= r0 + 8 * h) sdg[r] += dw[r] * ex2(ci[h] - wcum[j]) * wdt[j];
      }
    } else {
      mbar_arrive(bar_empty + 8 * s);
    }
  }

  // phase 2: dC = (sum dG) B (RS, B MN-major), the bf16 sum to shared memory
  // for dB = (sum dG)^T C (SS, the sum read MN-major through transpose-A)
  float dc[NP / 2], db[NP / 2];
  zero(dc);
  zero(db);
  if constexpr (NS > 0) {
    uint32_t pdg[NS / 16][4];
    uint8_t* g_dg = gbase + Cf::D_DG_OFF;
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk)
#pragma unroll
      for (int jq = 0; jq < 4; ++jq) {
        const int r = 8 * kk + 2 * jq;
        pdg[kk][jq] = pack_bf16(sdg[r], sdg[r + 1]);
        const int i = r0 + 8 * (jq & 1);
        const int j = 8 * (r >> 2) + c0;
        *reinterpret_cast<uint32_t*>(g_dg + dg_offset(i, j)) = pdg[kk][jq];
      }
    reg_fence(dc);
    reg_fence(pdg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk) wgmma_rs<NP>(dc, pdg[kk], mnmaj(s_b, 0, kk));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dc);
    reg_fence(pdg);
  }
  fence_proxy_async();
  consumers_sync();  // the summed dG is whole in shared memory
  if constexpr (NS > 0) {
    // rows j of this warpgroup keep i >= j: from i = wg*64 to the box's end
    reg_fence(db);
    wgmma_fence();
    for (int kk = wg * 4; kk < p.qb / 16; ++kk)
      wgmma_ss<NP, 1, 1>(db, make_desc(s_dg + wg * 8192 + kk * 16 * 128, PANEL, 1024),
                         mnmaj(s_c, 0, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(db);
  }

  // phase 3: each head's diag(exp(cum)) dY s_in^T and diag(u) X dS_out^T
  for (int k = 0; k < p.hb; ++k) {
    const int item = p.hb + k;
    const int s = item % NST;
    chunk_scalars(next, lane, wcum, wdt);
    if (k + 1 < p.hb) next = load_dt(p, row0 + k + 1, c, lane);
    mbar_wait(bar_full + 8 * s, (item / NST) & 1);
    const uint32_t s_x = base + Cf::CB + s * Cf::STAGE;
    const uint32_t s_dy = s_x + PPAN * PANEL;
    const uint32_t s_sin = s_dy + PPAN * PANEL;
    const uint32_t s_ds = s_sin + PPAN * PANEL;
    scale_x_dy<PPAN>(gbase + (s_x - base), gbase + (s_dy - base), p.qb, wcum[QMAX - 1], wcum,
                     wdt);
    fence_proxy_async();
    consumers_sync();  // X o u and dY o exp(cum) are whole
    if constexpr (NS > 0) {
      reg_fence(dc);
      reg_fence(db);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PPAN * 4; ++kk) {
        wgmma_ss<NP, 0, 0>(dc, kmaj(s_dy, wg * 64, kk), kmaj(s_sin, 0, kk), 1);
        wgmma_ss<NP, 0, 0>(db, kmaj(s_x, wg * 64, kk), kmaj(s_ds, 0, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(dc);
      reg_fence(db);
    }
    mbar_arrive(bar_empty + 8 * s);
  }

  if constexpr (NS > 0) {
    const size_t per = static_cast<size_t>(p.seq) * p.n;
    float* pb = p.part + static_cast<size_t>(blockIdx.y) * per +
                static_cast<size_t>(c) * p.chunk * p.n;
    float* pc = pb + static_cast<size_t>(p.bh / p.hb) * per;
#pragma unroll
    for (int jj = 0; jj < NP / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const int col = 8 * jj + c0;
        if (r < p.chunk && col < p.n) {
          const size_t off = static_cast<size_t>(r) * p.n + col;
          *reinterpret_cast<float2*>(pb + off) = make_float2(db[4 * jj + 2 * h],
                                                             db[4 * jj + 2 * h + 1]);
          *reinterpret_cast<float2*>(pc + off) = make_float2(dc[4 * jj + 2 * h],
                                                             dc[4 * jj + 2 * h + 1]);
        }
      }
  }
}

template <int NPAN, int PPAN>
__global__ void __launch_bounds__(NTHREADS, 1)
    ssd_bwd_dbc_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_dy,
                            const __grid_constant__ CUtensorMap tm_b,
                            const __grid_constant__ CUtensorMap tm_c,
                            const __grid_constant__ CUtensorMap tm_sin,
                            const __grid_constant__ CUtensorMap tm_ds, const Params p) {
  using Cf = Cfg<NPAN, PPAN>;
  constexpr int NST = Cf::NSTAGES;
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* gbase = aligned_base(smem_raw, &base);
  const uint32_t bar_cb = base + Cf::D_BAR_OFF;
  const uint32_t bar_full = bar_cb + 8;
  const uint32_t bar_empty = bar_full + 8 * NST;
  const int c = blockIdx.x;
  const int row0 = blockIdx.y * p.hb;

  if (threadIdx.x == 0) {
    mbar_init(bar_cb, 1);
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NCONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NCONSUMERS * 128) {
      load_cb<NPAN>(base, bar_cb, &tm_c, &tm_b, c, row0, p);
      // items 0 .. hb-1: X and dY of each head (phase 1); hb .. 2hb-1: X,
      // dY, s_in and dS_out of each head (phase 3)
      for (int item = 0; item < 2 * p.hb; ++item) {
        const int s = item % NST;
        mbar_wait(bar_empty + 8 * s, ((item / NST) & 1) ^ 1);
        load_head<PPAN>(base + Cf::CB + s * Cf::STAGE, bar_full + 8 * s, &tm_x, &tm_dy,
                        &tm_sin, &tm_ds, c, row0 + item % p.hb, p, item >= p.hb);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  if (wg == 0) dbc_consumer<64, NPAN, PPAN>(p, gbase, base, wg);
  else if (p.qb == QMAX) dbc_consumer<128, NPAN, PPAN>(p, gbase, base, wg);
  else dbc_consumer<0, NPAN, PPAN>(p, gbase, base, wg);
}

// ---- 5. the fixed-order sums ----------------------------------------------------

__global__ void ssd_bwd_sum_sm90_kernel(const Params p) {
  const int blocks = p.group / p.hb;                     // partials of one group row
  const size_t per = static_cast<size_t>(p.seq) * p.n;  // one row's (S, N)
  const size_t bc = static_cast<size_t>(p.bh / p.group) * per;
  const size_t part_one = static_cast<size_t>(p.bh / p.hb) * per;
  const size_t total = 2 * bc + p.bh;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    if (idx < 2 * bc) {
      const size_t which = idx / bc;   // 0: dB, 1: dC
      const size_t rem = idx % bc;
      const size_t grow = rem / per;
      const float* src = p.part + which * part_one + grow * blocks * per + rem % per;
      float s = 0.f;
      for (int k = 0; k < blocks; ++k) s += src[static_cast<size_t>(k) * per];
      // (group row, token, state entry) of rem, at dB's or dC's strides
      const Strides& so = which ? p.s_dc : p.s_db;
      const long long groups = p.heads / p.group;
      const long long t = static_cast<long long>(rem % per) / p.n;
      const long long gr = static_cast<long long>(grow);
      (which ? p.dC : p.dB)[(gr / groups) * so.b + (gr % groups) * so.h + t * so.s +
                            static_cast<long long>(rem % p.n)] = __float2bfloat16(s);
    } else {
      const size_t row = idx - 2 * bc;
      double s = 0.0;
      for (int c = 0; c < p.n_chunks; ++c) s += p.pda[row * p.n_chunks + c];
      p.dA[row] = static_cast<float>(s);
    }
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

// (width, chunk, chunks, heads, batch) bf16 at the strides st = {batch,
// token, head} in elements (width's is 1); boxes of 64 columns x qb tokens
// of one chunk. Columns past `width` and tokens past the chunk are out of
// bounds and arrive as zeros.
int encode_bshw(CUtensorMap* map, const void* ptr, int width, int chunk, int n_chunks, int heads,
                int batch, Strides st, int qb) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ERR_ENTRY_POINT;
  const cuuint64_t tok = static_cast<cuuint64_t>(st.s) * 2;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(chunk),
                              static_cast<cuuint64_t>(n_chunks), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[4] = {tok, tok * chunk, static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t boxd[5] = {64, static_cast<cuuint32_t>(qb), 1, 1, 1};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims,
                          strides, boxd, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(res);
}

// (width, rows, chunks, heads) bf16, contiguous (the states' scratch); boxes of 64 columns x
// `box` rows of one chunk. Columns past `width` and rows past `rows` are
// out of bounds and arrive as zeros.
int encode(CUtensorMap* map, const void* ptr, int width, int rows, int n_chunks, int heads,
           int box) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ERR_ENTRY_POINT;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(width) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n_chunks), static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[3] = {row_bytes, row_bytes * rows, row_bytes * rows * n_chunks};
  const cuuint32_t boxd[4] = {64, static_cast<cuuint32_t>(box), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                          strides, boxd, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(res);
}

struct Maps {
  CUtensorMap x, dy, b, c, sin, ds;
};

template <typename K>
int set_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int NPAN, int PPAN>
int launch(const Maps& m, const Params& p, cudaStream_t stream) {
  using Cf = Cfg<NPAN, PPAN>;
  const dim3 grid(p.n_chunks, p.bh / p.hb);
  int err = set_smem(ssd_bwd_terms_sm90_kernel<NPAN, PPAN>, Cf::T_SMEM);
  if (err) return err;
  ssd_bwd_terms_sm90_kernel<NPAN, PPAN><<<grid, NTHREADS, Cf::T_SMEM, stream>>>(m.x, m.dy, m.b,
                                                                               m.c, p);
  if ((err = cudaGetLastError())) return err;
  const dim3 sgrid(p.yb, p.bh);
  if (p.n_chunks <= 8) ssd_bwd_states_sm90_kernel<8><<<sgrid, STATE_THREADS, 0, stream>>>(p);
  else if (p.n_chunks <= 16) ssd_bwd_states_sm90_kernel<16><<<sgrid, STATE_THREADS, 0, stream>>>(p);
  else ssd_bwd_states_sm90_kernel<0><<<sgrid, STATE_THREADS, 0, stream>>>(p);
  if ((err = cudaGetLastError())) return err;
  if ((err = set_smem(ssd_bwd_dx_sm90_kernel<NPAN, PPAN>, Cf::X_SMEM))) return err;
  ssd_bwd_dx_sm90_kernel<NPAN, PPAN><<<grid, NTHREADS, Cf::X_SMEM, stream>>>(
      m.x, m.dy, m.b, m.c, m.sin, m.ds, p);
  if ((err = cudaGetLastError())) return err;
  if ((err = set_smem(ssd_bwd_dbc_sm90_kernel<NPAN, PPAN>, Cf::D_SMEM))) return err;
  ssd_bwd_dbc_sm90_kernel<NPAN, PPAN><<<grid, NTHREADS, Cf::D_SMEM, stream>>>(
      m.x, m.dy, m.b, m.c, m.sin, m.ds, p);
  if ((err = cudaGetLastError())) return err;
  ssd_bwd_sum_sm90_kernel<<<132 * 8, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Blocks of the states pass per row (and the second dimension of `ts`).
extern "C" int ssd_scan_bwd_sm90_state_blocks(int n, int p) {
  return (n * p + STATE_BLOCK - 1) / STATE_BLOCK;
}

// x, dy, dx (batch, seq, heads, p) and B, C, dB, dC (batch, seq, heads /
// heads_per_group, n): bf16, 16-byte aligned, the last dim contiguous; dt,
// ddt (batch, seq, heads) f32; `strides` holds the batch, sequence and head
// strides in elements of x, dy, B, C, dt, dx, ddt, dB and dC in that order
// (27 values), each bf16 tensor's a multiple of 8. A, dA (bh,) f32, bh =
// batch * heads; init and dinit null or (bh, n, p) f32, both or neither;
// dfinal null (zero) or (bh, n, p) f32.
// Scratch: states f32 (2, bh, seq / chunk, n, p), states16 bf16 (the same),
// decay f32 (bh, seq / chunk), ts f32 (bh, state_blocks, seq / chunk), part
// f32 (2, bh / heads_per_block, seq, n), pda f64 (bh, seq / chunk), all
// contiguous. seq a multiple of chunk
// (1 .. 128); n and p multiples of 8 up to 128; heads_per_block divides
// heads_per_group.
extern "C" int ssd_scan_bwd_sm90(const void* x, const void* dt, const void* A, const void* B,
                                 const void* C, const void* init_state, const void* dy,
                                 const void* dfinal, void* dx, void* ddt, void* dA, void* dB,
                                 void* dC, void* dinit, void* states, void* states16,
                                 void* decay, void* ts, void* part, void* pda,
                                 const long long* strides, int batch, int heads, int seq,
                                 int p, int n, int chunk, int heads_per_group,
                                 int heads_per_block, void* stream) {
  const int bh = batch * heads;
  if (batch <= 0 || heads <= 0 || seq <= 0 || chunk <= 0 || chunk > QMAX || seq % chunk ||
      p <= 0 || p > 128 || p % 8 || n <= 0 || n > 128 || n % 8 || heads_per_group <= 0 ||
      heads % heads_per_group || heads_per_block <= 0 || heads_per_group % heads_per_block ||
      bh > 65535 || (init_state == nullptr) != (dinit == nullptr)) {
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
  Strides st[9];
  for (int i = 0; i < 9; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int groups = heads / heads_per_group;
  const int nc = seq / chunk;
  const int qb = chunk <= 64 ? 64 : 128;
  const int nb = n <= 64 ? 64 : 128;
  const size_t plane = static_cast<size_t>(bh) * nc * n * p;
  Maps m;
  int err = encode_bshw(&m.x, x, p, chunk, nc, heads, batch, st[0], qb);
  if (err == 0) err = encode_bshw(&m.dy, dy, p, chunk, nc, heads, batch, st[1], qb);
  if (err == 0) err = encode_bshw(&m.b, B, n, chunk, nc, groups, batch, st[2], qb);
  if (err == 0) err = encode_bshw(&m.c, C, n, chunk, nc, groups, batch, st[3], qb);
  if (err == 0) err = encode(&m.sin, states16, p, n, nc, bh, nb);
  if (err == 0)
    err = encode(&m.ds, static_cast<const __nv_bfloat16*>(states16) + plane, p, n, nc, bh, nb);
  if (err != 0) return err;
  Params prm{};
  prm.bh = bh;
  prm.heads = heads;
  prm.seq = seq;
  prm.p = p;
  prm.n = n;
  prm.chunk = chunk;
  prm.group = heads_per_group;
  prm.hb = heads_per_block;
  prm.n_chunks = nc;
  prm.qb = qb;
  prm.nb = nb;
  prm.yb = ssd_scan_bwd_sm90_state_blocks(n, p);
  prm.dt = static_cast<const float*>(dt);
  prm.A = static_cast<const float*>(A);
  prm.init = static_cast<const float*>(init_state);
  prm.dfinal = static_cast<const float*>(dfinal);
  prm.dx = static_cast<__nv_bfloat16*>(dx);
  prm.ddt = static_cast<float*>(ddt);
  prm.dA = static_cast<float*>(dA);
  prm.dB = static_cast<__nv_bfloat16*>(dB);
  prm.dC = static_cast<__nv_bfloat16*>(dC);
  prm.dinit = static_cast<float*>(dinit);
  prm.sx = static_cast<float*>(states);
  prm.sy = static_cast<float*>(states) + plane;
  prm.sin16 = static_cast<__nv_bfloat16*>(states16);
  prm.ds16 = static_cast<__nv_bfloat16*>(states16) + plane;
  prm.decay = static_cast<float*>(decay);
  prm.ts = static_cast<float*>(ts);
  prm.part = static_cast<float*>(part);
  prm.pda = static_cast<double*>(pda);
  prm.s_dt = st[4];
  prm.s_dx = st[5];
  prm.s_ddt = st[6];
  prm.s_db = st[7];
  prm.s_dc = st[8];
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const bool n2 = n > 64, p2 = p > 64;
  if (n2 && p2) return launch<2, 2>(m, prm, cs);
  if (n2) return launch<2, 1>(m, prm, cs);
  if (p2) return launch<1, 2>(m, prm, cs);
  return launch<1, 1>(m, prm, cs);
}

extern "C" const char* ssd_scan_bwd_sm90_error_string(int err) {
  static thread_local char buf[96];
  if (err == ERR_ENTRY_POINT) return "cudaGetDriverEntryPoint(cuTensorMapEncodeTiled) failed";
  if (err >= ERR_ENCODE) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed with CUresult %d",
             err - ERR_ENCODE);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
