// Flash attention forward for bf16 on Hopper (sm_90a): wgmma fed by TMA.
//
// Replaces the Pallas TPU kernel `_flash_kernel` driven by `flash_attention`
// (src/repro/kernels/flash_attention.py) for bf16 inputs; f32 inputs keep
// the CUDA-core kernel of flash_attention.cu. Same function as that file's
// header and `flash_attention_plain`, in the model's layout: q (B, Sq, H, hd)
// and k/v (B, Sk, H/g, hd) at any strides a tensor map takes (unit stride in
// hd, the others multiples of 16 bytes), o (B, Sq, H, hd) at its own strides;
// query head h reads kv head h / g (GQA); scale hd^-0.5; causal masking with q_offset
// (may be negative) and an optional sliding window, with or without causal;
// ragged Sq and Sk; f32 m, l and acc; masked scores are the finite -1e30, so
// a row whose keys are all masked averages V over all Sk keys; keys past Sk
// do not exist (p = 0); out = acc / max(l, 1e-30), rounded once to bf16.
// Head dims 32, 64, 112 and 128. A head of 112 sits in shared memory at a
// padded width of 128, two 64-column panels: its tensor maps keep the true
// inner extent (224-byte rows, a multiple of TMA's 16), so TMA zero-fills
// columns 112-127 of every Q, K and V box. Q.K^T takes the 7 k16 steps of
// the real columns; P.V runs at n128 over the zero columns, and the
// epilogue stores the 112 real ones. A partly out-of-bounds box still
// completes its full box bytes on the mbarrier, so expect_tx counts the
// padded width.
//
// One new rounding point: P = exp(S - m) is rounded to bf16 before P.V, as
// FlashAttention-2/3 and PyTorch's SDPA do; the row sum l is taken over the
// f32 P. Everything else is f32 as in the plain version.
//
// What bounds it on this card: at the serving shape (q 160x1024x128 bf16,
// k/v 32x1024x128, GQA 5, causal) the work is ~43 GFLOP of products against
// ~100 MB of traffic, above the H100's ridge, so the bf16 tensor-core rate
// bounds it (~43 us at 989 TFLOP/s). What the design does about that:
// * both products run on the tensor cores: S = Q.K^T as wgmma SS (Q and K
//   from shared memory, K-major as stored), O += P.V as wgmma RS: P goes
//   from the f32 S accumulator to bf16 registers in wgmma's A-fragment
//   layout (the m64nNk16 accumulator fragment of S is that layout), and V
//   is the B operand as stored, (BK, hd) with hd contiguous: MN-major, read
//   with the transpose-B bit, never transposed in memory;
// * tiles stay bf16 in shared memory and arrive by TMA from 4-D tensor maps
//   (hd, S, H, B) at the operands' own strides, so q, k and v are read where
//   the model made them (slices of a fused projection, transposed views) and
//   no layout copy precedes the kernel; hd and S keep their real extents, so
//   the ragged S edge and hd 112's columns 112-127 are zero-filled and never
//   read the next token's or head's elements. 128-byte swizzle (64-byte at hd
//   32); a row wider than the swizzle span is two 64-column panels, two
//   boxes per tile;
// * warp specialisation: one producer warp issues the TMA loads of Q once
//   and of K and V into a ring of NSTAGES stages with full/empty mbarriers;
//   two consumer warpgroups of 64 query rows each wait on `full`, run both
//   products and the online softmax, and arrive on `empty`. setmaxnreg
//   moves registers from the producer warpgroup to the consumers;
// * softmax in registers: row max and row sum within each quad of the
//   accumulator layout (shfl.xor 1 and 2), exp2 with scale*log2(e) folded
//   in. Masks apply only on tiles that straddle the causal, window or ragged
//   edge; kv tiles that every row of the block masks are skipped, unless a
//   row of the block has no unmasked key at all;
// * work order: blockIdx walks the last (heaviest, under causal) q tiles
//   of every row first; neighbouring blocks are neighbouring rows, so the
//   g query heads of one kv head read its K/V tiles from L2.
// Not done here: ping-pong between the consumer warpgroups, overlap of the
// softmax with the next product inside a warpgroup, persistent blocks, a
// TMA store of O.
//
// Optional output for training: the log-sum-exp of each query row, f32
// (B*H, Sq) (row b*H + h), m * ln 2 + log(l) in the natural-log domain, written by the
// quad's first lane only when its pointer is not null (the serving path
// passes null). A row with no unmasked key keeps m = -1e30 and gets
// exactly -1e30, which the backward (flash_attention_bwd.cu) reads as
// "every key masked": the forward's average over all Sk keys.
//
// Entry point: `flash_attention_sm90_fwd`, a plain C function that builds
// the tensor maps (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so no -lcuda), launches on the given stream and
// returns 0 or an error code that `flash_attention_sm90_error_string` names.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int BQ = 128;                 // query rows per block: two consumer warpgroups
constexpr int BK = 128;                 // keys per kv tile
constexpr int NSTAGES = 2;              // K/V ring depth
constexpr int NCONSUMERS = 2;           // consumer warpgroups
constexpr int NTHREADS = 128 * (NCONSUMERS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;      // 128 * 40 + 256 * 232 <= 65536
constexpr float NEG_INF = -1e30f;       // a masked score, as in the reference
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int ERR_ENTRY_POINT = 100000;  // cudaGetDriverEntryPoint failed
constexpr int ERR_ENCODE = 200000;       // + CUresult of cuTensorMapEncodeTiled

template <int HD>
struct Cfg {
  static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;  // swizzle span (bytes) = panel row
  static constexpr int PANEL = SW / 2;                     // columns per panel
  static constexpr int NPANEL = (HD + PANEL - 1) / PANEL;  // the last one may be partial
  static constexpr int HDP = NPANEL * PANEL;               // padded width in shared memory
  static constexpr int KSTEPS_PER_PANEL = SW / 32;         // k16 steps of 32 bytes
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;   // wgmma descriptor: B128, B64
  // whole boxes: TMA counts a box's zero-filled columns and rows too
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int KV_BYTES = BK * HDP * 2;
  static constexpr int BAR_BYTES = 8 * (1 + 3 * NSTAGES);
  // tiles from a 1024-byte aligned base (the swizzle atom), then the barriers
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * NSTAGES * KV_BYTES + BAR_BYTES;
};

struct Params {
  int seq_q;
  int seq_k;
  int group;       // query heads per kv head
  int heads;       // H: query heads
  int rows;        // B * H
  int q_tiles;     // ceil(seq_q / BQ)
  int causal;
  int has_window;
  long long window;
  long long q_offset;
  float scale_log2;  // hd^-0.5 * log2(e)
  __nv_bfloat16* o;
  long long o_sb, o_ss, o_sh;  // o's batch, sequence and head strides (elements)
  float* lse;        // (rows, seq_q) or null
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

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
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
// writes to it (the rescale by alpha, P) stay before the fence.
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

// d (64 x 128) (+)= A (64 x 16) * B (128 x 16)^T, both in shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 32) += A (64 x 16, registers) * B (16 x 32, shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128) += A (64 x 16, registers) * B (16 x 128, shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// N is the padded width: 32, 64 or 128
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, desc_b);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, desc_b);
  else wgmma_rs_n128(d, a, desc_b);
}

// ---- softmax helpers -------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Unmasked keys [lo, hi] of the query at absolute position qpos; false when
// it has none. lo and hi never decrease as qpos grows, and the positions
// with a key form one interval, so two rows bound a whole block.
__device__ __forceinline__ bool key_range(const Params& p, long long qpos, long long& lo,
                                          long long& hi) {
  lo = 0;
  hi = p.seq_k - 1;
  if (p.causal) hi = min(hi, qpos);
  if (p.has_window) lo = max(lo, qpos - p.window + 1);
  return lo <= hi;
}

// ---- the kernel ------------------------------------------------------------
//
// Accumulator fragment of wgmma m64nNk16 (f32), per thread of a warpgroup
// (warp w, lane l): register r holds row 16w + l/4 + 8*((r >> 1) & 1) and
// column 8*(r >> 2) + 2*(l % 4) + (r & 1). Registers 8kk .. 8kk+7 of S, as
// bf16 pairs, are the A fragment of the k16 step kk of P.V.

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                          // NPANEL panels of BQ rows x SW bytes
  const uint32_t sK = sQ + C::Q_BYTES;               // stage s: + s * KV_BYTES
  const uint32_t sV = sK + NSTAGES * C::KV_BYTES;
  const uint32_t bar_q = sV + NSTAGES * C::KV_BYTES;
  const uint32_t bar_k = bar_q + 8;                  // full: K of stage s arrived
  const uint32_t bar_v = bar_k + 8 * NSTAGES;        // full: V of stage s arrived
  const uint32_t bar_e = bar_v + 8 * NSTAGES;        // empty: stage s read by both consumers

  // heaviest q tiles first; neighbouring blocks share a kv head
  const int row = blockIdx.x % p.rows;
  const int q0 = (p.q_tiles - 1 - static_cast<int>(blockIdx.x / p.rows)) * BQ;
  const int bi = row / p.heads;     // batch
  const int hq = row % p.heads;     // query head
  const int hk = hq / p.group;      // its kv head
  const int q_valid = min(BQ, p.seq_q - q0);

  const long long qpos_first = p.q_offset + q0;
  long long lo_first, hi_first, lo_last, hi_last;
  const bool live_first = key_range(p, qpos_first, lo_first, hi_first);
  const bool live_last = key_range(p, qpos_first + q_valid - 1, lo_last, hi_last);
  int kt_begin = 0;
  int kt_end = (p.seq_k + BK - 1) / BK;
  if (live_first && live_last) {  // every row has a key: skip tiles all rows mask
    kt_begin = static_cast<int>(lo_first / BK);
    kt_end = static_cast<int>(hi_last / BK) + 1;
  }
  const int n_tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < NSTAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, NCONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NCONSUMERS) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NCONSUMERS * 128) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::NPANEL; ++pn)
        tma_load_4d(sQ + pn * BQ * C::SW, &tm_q, bar_q, pn * C::PANEL, q0, hq, bi);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NSTAGES;
        const uint32_t phase = (it / NSTAGES) & 1;
        const int k0 = (kt_begin + it) * BK;
        mbar_wait(bar_e + 8 * s, phase ^ 1);  // the first pass finds the stage free
        mbar_expect_tx(bar_k + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::NPANEL; ++pn)
          tma_load_4d(sK + s * C::KV_BYTES + pn * BK * C::SW, &tm_k, bar_k + 8 * s,
                      pn * C::PANEL, k0, hk, bi);
        mbar_expect_tx(bar_v + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::NPANEL; ++pn)
          tma_load_4d(sV + s * C::KV_BYTES + pn * BK * C::SW, &tm_v, bar_v + 8 * s,
                      pn * C::PANEL, k0, hk, bi);
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows wg*64 .. wg*64+63 of the block ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r0 = wg * 64 + (t / 32) * 16 + lane / 4;  // this thread's rows r0 and r0 + 8
    const int c0 = 2 * (lane % 4);                      // and columns 8j + c0, +1
    const long long qpos0 = p.q_offset + q0 + r0;
    const long long qpos1 = qpos0 + 8;
    const long long wg_qlo = p.q_offset + q0 + wg * 64;
    const long long wg_qhi = wg_qlo + 63;

    float o[C::HDP / 2];
#pragma unroll
    for (int i = 0; i < C::HDP / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

    const uint32_t q_wg = sQ + wg * 64 * C::SW;
    mbar_wait(bar_q, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % NSTAGES;
      const uint32_t phase = (it / NSTAGES) & 1;
      const int k0 = (kt_begin + it) * BK;
      const uint32_t k_st = sK + s * C::KV_BYTES;
      const uint32_t v_st = sV + s * C::KV_BYTES;

      // S = Q K^T over the real hd in k16 steps: 32 bytes along a panel, then the next panel
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      mbar_wait(bar_k + 8 * s, phase);
      reg_fence(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int pn = kk / C::KSTEPS_PER_PANEL;
        const int in = (kk % C::KSTEPS_PER_PANEL) * 32;
        const uint64_t da = make_desc(q_wg + pn * BQ * C::SW + in, 16, 8 * C::SW, C::LAYOUT);
        const uint64_t db = make_desc(k_st + pn * BK * C::SW + in, 16, 8 * C::SW, C::LAYOUT);
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);

      // scale into the log2 domain; mask only a tile on an edge
      const bool edge = (k0 + BK > p.seq_k) || (p.causal && k0 + BK - 1 > wg_qlo) ||
                        (p.has_window && wg_qhi - k0 >= p.window);
      if (edge) {
#pragma unroll
        for (int r = 0; r < BK / 2; ++r) {
          const int key = k0 + 8 * (r >> 2) + c0 + (r & 1);
          const long long qpos = (r & 2) ? qpos1 : qpos0;
          const bool keep = (!p.causal || qpos >= key) && (!p.has_window || qpos - key < p.window);
          sc[r] = key >= p.seq_k ? -INFINITY : (keep ? sc[r] * p.scale_log2 : NEG_INF);
        }
      } else {
#pragma unroll
        for (int r = 0; r < BK / 2; ++r) sc[r] *= p.scale_log2;
      }

      // online softmax: row max over the quad, rescale, P in bf16
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) {
        if (r & 2) mx1 = fmaxf(mx1, sc[r]);
        else mx0 = fmaxf(mx0, sc[r]);
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float alpha0 = ex2(m0 - mx0), alpha1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      uint32_t pa[BK / 16][4];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 8 * kk + 2 * j;  // rows alternate r0, r0 + 8 with j
          const float mr = (j & 1) ? m1 : m0;
          const float e0 = ex2(sc[r] - mr), e1 = ex2(sc[r + 1] - mr);
          pa[kk][j] = pack_bf16(e0, e1);
          if (j & 1) sum1 += e0 + e1;
          else sum0 += e0 + e1;
        }
      }
      l0 = l0 * alpha0 + sum0;  // per-thread partial sums; the quad adds them at the end
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int r = 0; r < C::HDP / 2; ++r) o[r] *= (r & 2) ? alpha1 : alpha0;

      // O += P V over the tile's keys in k16 steps: 16 rows of V, two swizzle atoms
      mbar_wait(bar_v + 8 * s, phase);
      reg_fence(o);
      reg_fence(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = make_desc(v_st + kk * 16 * C::SW, BK * C::SW, 8 * C::SW, C::LAYOUT);
        wgmma_pv<C::HDP>(o, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(o);
      mbar_arrive(bar_e + 8 * s);
    }

    const float tot0 = quad_sum(l0), tot1 = quad_sum(l1);
    const float den0 = fmaxf(tot0, 1e-30f);
    const float den1 = fmaxf(tot1, 1e-30f);
    if (p.lse != nullptr && (lane & 3) == 0) {
      float* lse = p.lse + static_cast<size_t>(row) * p.seq_q + q0;
      if (r0 < q_valid) lse[r0] = m0 < 0.5f * NEG_INF ? NEG_INF : m0 * LN2 + logf(tot0);
      if (r0 + 8 < q_valid) lse[r0 + 8] = m1 < 0.5f * NEG_INF ? NEG_INF : m1 * LN2 + logf(tot1);
    }
    // the block's rows of o at its strides; rows past Sq are not stored
    __nv_bfloat16* out = p.o + bi * p.o_sb + hq * p.o_sh + q0 * p.o_ss;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {  // the real columns only
      const int col = 8 * j + c0;
      if (r0 < q_valid)
        *reinterpret_cast<__nv_bfloat162*>(out + r0 * p.o_ss + col) =
            __floats2bfloat162_rn(o[4 * j] / den0, o[4 * j + 1] / den0);
      if (r0 + 8 < q_valid)
        *reinterpret_cast<__nv_bfloat162*>(out + (r0 + 8) * p.o_ss + col) =
            __floats2bfloat162_rn(o[4 * j + 2] / den1, o[4 * j + 3] / den1);
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

// (hd, seq, heads, batch) bf16 at the strides st = {batch, seq, head} in
// elements (hd's is 1); boxes of one panel x box_rows x 1 x 1. The extents
// are the real hd and seq: a box past either comes back zero-filled.
template <int HD>
int encode(CUtensorMap* map, const void* ptr, int seq, int heads, int batch,
           const long long* st, int box_rows) {
  using C = Cfg<HD>;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ERR_ENTRY_POINT;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(C::PANEL), static_cast<cuuint32_t>(box_rows),
                             1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                          strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(res);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const long long* st, int batch,
           const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int kv_heads = p.heads / p.group;
  int err = encode<HD>(&tq, q, p.seq_q, p.heads, batch, st, BQ);
  if (err == 0) err = encode<HD>(&tk, k, p.seq_k, kv_heads, batch, st + 3, BK);
  if (err == 0) err = encode<HD>(&tv, v, p.seq_k, kv_heads, batch, st + 6, BK);
  if (err != 0) return err;
  constexpr int smem = Cfg<HD>::SMEM;
  cudaError_t cerr = cudaFuncSetAttribute(flash_fwd_sm90_kernel<HD>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return cerr;
  flash_fwd_sm90_kernel<HD><<<p.rows * p.q_tiles, NTHREADS, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

// q (batch, seq_q, heads, head_dim), k and v (batch, seq_k, heads / group,
// head_dim), o (batch, seq_q, heads, head_dim): bf16, 16-byte aligned, hd
// contiguous; `strides` holds the batch, sequence and head strides in
// elements of q, k, v and o in that order (12 values), each but o's a
// multiple of 8. scale is hd^-0.5. lse: f32 (batch * heads, seq_q), or null.
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                        float* lse, const long long* strides, int batch,
                                        int heads, int seq_q, int seq_k, int head_dim, int group,
                                        int causal, int has_window, long long window,
                                        long long q_offset, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_q <= 0 || seq_k <= 0 || group <= 0 || heads % group) {
    return cudaErrorInvalidValue;
  }
  const int bh = batch * heads;
  const int q_tiles = (seq_q + BQ - 1) / BQ;
  // The tensor maps are encoded through the driver API, which needs a current
  // context. A thread that has made no runtime call yet (autograd's worker
  // thread can be one) has none until cudaSetDevice binds its device's
  // primary context.
  int device = 0;
  cudaError_t cerr = cudaGetDevice(&device);
  if (cerr == cudaSuccess) cerr = cudaSetDevice(device);
  if (cerr != cudaSuccess) return cerr;
  if (static_cast<long long>(bh) * q_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  Params p{seq_q, seq_k, group, heads, bh, q_tiles, causal, has_window, window, q_offset,
           scale * LOG2E, static_cast<__nv_bfloat16*>(o), strides[9], strides[10],
           strides[11], lse};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch<32>(q, k, v, strides, batch, p, st);
    case 64: return launch<64>(q, k, v, strides, batch, p, st);
    case 112: return launch<112>(q, k, v, strides, batch, p, st);
    case 128: return launch<128>(q, k, v, strides, batch, p, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_sm90_error_string(int err) {
  static thread_local char buf[96];
  if (err == ERR_ENTRY_POINT) return "cudaGetDriverEntryPoint(cuTensorMapEncodeTiled) failed";
  if (err >= ERR_ENCODE) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed with CUresult %d",
             err - ERR_ENCODE);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
