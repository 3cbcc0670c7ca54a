// Flash attention backward for bf16 on Hopper (sm_90a): wgmma fed by TMA.
//
// The gradient of the function K2 computes: the Pallas TPU kernel
// `_flash_kernel` driven by `flash_attention` (src/repro/kernels/
// flash_attention.py), ported to flash_attention_sm90.cu for bf16. The TPU
// package has no backward kernel; XLA differentiates its pure-jnp
// `blockwise_attention` (src/repro/models/attention.py). f32 inputs keep the
// CUDA-core kernel of flash_attention_bwd.cu.
//
// Same contract as flash_attention_bwd.cu and `flash_attention_bwd_plain`,
// in the model's layout: q, o, dO (B, Sq, H, hd) and k/v (B, Sk, H/g, hd) at
// any strides a tensor map takes (unit stride in hd, the others multiples
// of 16 bytes), dq, dk and dv written at the strides of the tensors the
// wrapper allocates; query head h reads kv head h / g (GQA); scale
// hd^-0.5; causal masking with q_offset (may be negative), an optional
// sliding window with or without causal, ragged Sq and Sk, Sq != Sk; head
// dims 32, 64, 112 and 128. From the forward it takes o and the log-sum-exp
// `lse` (f32, natural log and recomputes P = exp(S * scale - lse);
// (B*H, Sq), row b*H + h) with D = rowsum(dO * O):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
// Every sum is f32; each gradient is rounded once to bf16. A masked score is
// the constant -1e30, so dS is 0 there. A row with no unmasked key (lse =
// -1e30) averaged V over all Sk keys: its P is 1/Sk on every key, which
// reaches dV, and its dS is 0.
//
// New rounding points against the plain version, as in FlashAttention-2/3
// and PyTorch's SDPA: P is rounded to bf16 before dV += P^T dO, and dS before
// dK += dS^T Q and dQ += dS K.
//
// Three launches and no atomics, so two runs give the same bits:
// 1. `bwd_prep_sm90_kernel`: a few lanes per query row write lse * log2(e)
//    and D = rowsum(dO * O) into rows padded to a multiple of PAD. A padded
//    row (q >= Sq) gets lse = +inf and D = 0, so its P and dS are 0 even
//    though TMA hands the kernels below a zero Q and dO row there (S = 0);
// 2. `dkdv_sm90_kernel`: one block per (kv row, BKV-key tile) holds K and V
//    in shared memory and streams Q, dO, lse and D tiles of all g query
//    heads of its kv head, so GQA's sum over heads stays in registers;
// 3. `dq_sm90_kernel`: one block per (q row, BQ2-query tile) holds Q and dO
//    and streams K and V tiles.
// S and dP are computed in both 2 and 3: 7 products of (Sq x Sk x hd) per
// unmasked (q, k) pair where a one-pass kernel with ordered dQ sums does 5.
// That is 1.4x the operations, paid to stay deterministic without atomics.
//
// What bounds it on this card: at phi4-mini's training shape (q 96 x 1024 x
// 128 bf16, k/v 32 x 1024 x 128, GQA 3, causal) the backward needs ~64 GFLOP
// of products (2.5x the forward's) against ~135 MB of traffic, far above the
// H100's ridge, so the bf16 tensor-core rate bounds it: 0.0652 ms at 989
// TFLOP/s. What the design does about that:
// * every product runs on the tensor cores. The dK/dV kernel works in the
//   transposed frame, 64 kv rows per consumer warpgroup: S^T = K Q^T and
//   dP^T = V dO^T as wgmma SS (K, V, Q and dO all K-major as stored);
//   P^T and dS^T = P^T * (dP^T - D) in registers, with lse and D per column;
//   dV += P^T dO and dK += dS^T Q as wgmma RS: the bf16 A fragment comes
//   straight from the f32 accumulator fragment (the m64nNk16 accumulator
//   fragment is the A-fragment layout, as the forward feeds P.V), and the B
//   operand (dO, Q: (q, hd) with hd contiguous) is MN-major, read with the
//   transpose-B bit. The dQ kernel: S = Q K^T and dP = dO V^T (SS), dS in
//   registers, dQ += dS K (RS, K MN-major). Nothing is transposed in memory
//   and dS never goes through shared memory;
// * tiles stay bf16 in shared memory and arrive by TMA from 4-D tensor maps
//   (hd, S, H, B) at the operands' own strides, so nothing is transposed or
//   copied before the kernel; the real extents of hd and S zero-fill the
//   ragged S edge and hd 112's padding. 128-byte swizzle
//   (64-byte at hd 32); a row wider than the swizzle span is two 64-column
//   panels. hd 112 sits at a padded width of 128 as in the forward: its maps
//   keep the true inner extent (224-byte rows), expect_tx counts the padded
//   box bytes, the SS products take the 7 k16 steps of the real columns,
//   the RS products run at n128 over the zero columns, and only the 112 real
//   columns are stored. lse and D come by 1-D bulk copies beside their tile;
// * warp specialisation: one producer thread issues every load, the
//   streamed tiles through a ring of NSTAGES stages with full/empty
//   mbarriers; two consumer warpgroups wait on `full`, run the products and
//   the elementwise work, and arrive on `empty`. setmaxnreg moves registers
//   from the producer warpgroup to the consumers (dK, dV: 2 x 64 f32 at hd
//   128, S^T and dP^T: 2 x 32);
// * masks apply only on tiles that straddle the causal, window or ragged
//   edge; a tile that the masks remove whole is skipped, by the block when
//   every row has a key and none is in the block, and by one warpgroup when
//   its own 64 rows see nothing, but never a tile that holds a row with no
//   unmasked key (its 1/Sk reaches every key's dV);
// * work order: the dK/dV grid walks the lowest kv tiles (the most q tiles
//   under causal) first, the dQ grid the last q tiles first.
// Not done here: one pass with a deterministic dQ reduction, ping-pong
// between the consumer warpgroups, overlap of the elementwise work with the
// next products, persistent blocks, TMA stores.
//
// Entry point: `flash_attention_bwd_sm90`, a plain C function that builds
// the tensor maps (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so no -lcuda), launches the three kernels on the
// given stream and returns 0 or an error code that
// `flash_attention_bwd_sm90_error_string` names.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int BKV = 128;                // dK/dV: keys per block, two consumer warpgroups of 64
constexpr int BQ = 64;                  // dK/dV: query rows per streamed tile
constexpr int BQ2 = 128;                // dQ: query rows per block, two warpgroups of 64
constexpr int BK2 = 64;                 // dQ: keys per streamed tile
constexpr int PAD = 128;                // lse and D rows padded to a multiple of BQ and BQ2
constexpr int NSTAGES = 2;              // ring depth
constexpr int NCONSUMERS = 2;           // consumer warpgroups
constexpr int NTHREADS = 128 * (NCONSUMERS + 1);
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;      // 128 * 24 + 256 * 240 <= 65536
constexpr float NEG_INF = -1e30f;       // a masked score, as in the reference
constexpr float LOG2E = 1.4426950408889634f;
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
  static constexpr int KV_BYTES = BKV * HDP * 2;           // dK/dV: K or V of the block
  static constexpr int QT_BYTES = BQ * HDP * 2;            // dK/dV: Q or dO of one tile
  static constexpr int VEC_BYTES = BQ * 4;                 // dK/dV: lse or D of one tile
  // stage: Q, dO, lse, D; padded to the 1024-byte swizzle atom
  static constexpr int STAGE1 = (2 * QT_BYTES + 2 * VEC_BYTES + 1023) / 1024 * 1024;
  static constexpr int SMEM1 = 1024 + 2 * KV_BYTES + NSTAGES * STAGE1 + 8 * (1 + 2 * NSTAGES);
  static constexpr int Q2_BYTES = BQ2 * HDP * 2;           // dQ: Q or dO of the block
  static constexpr int KT_BYTES = BK2 * HDP * 2;           // dQ: K or V of one tile
  static constexpr int SMEM2 = 1024 + 2 * Q2_BYTES + 2 * NSTAGES * KT_BYTES + 8 * (1 + 2 * NSTAGES);
};

// Batch, sequence and head strides of a (B, S, H, hd) tensor, in elements.
struct Strides {
  long long b, s, h;
};

struct Params {
  int seq_q;
  int seq_k;
  int seq_q_pad;   // row stride of lse2 and dsum
  int group;       // query heads per kv head
  int heads;       // H: query heads
  int kv_heads;    // H / group
  int rows;        // B * H
  int kv_rows;     // B * H / group
  int q_tiles;     // ceil(seq_q / BQ): the dK/dV kernel's streamed tiles per head
  int q_blocks;    // ceil(seq_q / BQ2): the dQ kernel's blocks per row
  int causal;
  int has_window;
  long long window;
  long long q_offset;
  float scale;       // hd^-0.5
  float scale_log2;  // hd^-0.5 * log2(e)
  float inv_sk;      // 1 / Sk: P of a row with no unmasked key
  const float* lse2; // (rows, seq_q_pad): lse * log2(e); +inf past Sq; -1e30 for a dead row
  const float* dsum; // (rows, seq_q_pad): rowsum(dO * O); 0 past Sq
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  Strides s_dq, s_dk, s_dv;  // where the three gradients are written
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

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
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
// writes to it stay before the fence.
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

// d (64 x 64) (+)= A (64 x 16) * B (64 x 16)^T, both in shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
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
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, desc_b);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, desc_b);
  else wgmma_rs_n128(d, a, desc_b);
}

// ---- elementwise helpers ---------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Unmasked keys [lo, hi] of the query at absolute position qpos; false when
// it has none. lo and hi never decrease as qpos grows, and the positions
// with a key form one interval, so two rows bound a whole tile.
__device__ __forceinline__ bool key_range(const Params& p, long long qpos, long long& lo,
                                          long long& hi) {
  lo = 0;
  hi = p.seq_k - 1;
  if (p.causal) hi = min(hi, qpos);
  if (p.has_window) lo = max(lo, qpos - p.window + 1);
  return lo <= hi;
}

// The query at qpos sees the existing key `key`.
__device__ __forceinline__ bool keep(const Params& p, long long qpos, long long key) {
  return key < p.seq_k && (!p.causal || qpos >= key) && (!p.has_window || qpos - key < p.window);
}

// Every row of the q tile [q0, q0 + valid) has a key and none of those keys
// is in [k0, k0 + k_valid): the tile adds nothing to the kv tile.
__device__ __forceinline__ bool q_tile_skipped(const Params& p, int q0, int valid, int k0,
                                               int k_valid) {
  long long lo_first, hi_first, lo_last, hi_last;
  const bool live_first = key_range(p, p.q_offset + q0, lo_first, hi_first);
  const bool live_last = key_range(p, p.q_offset + q0 + valid - 1, lo_last, hi_last);
  return live_first && live_last && (hi_last < k0 || lo_first > k0 + k_valid - 1);
}

// ---- 1. lse in the log2 domain and D = rowsum(dO * O), padded rows ---------
//
// A row of hd bf16 is hd / 8 16-byte pieces, read by prep_lanes<HD>() lanes
// (the next power of two); a warp of 32 lanes takes 32 / prep_lanes rows.
template <int HD>
__host__ __device__ constexpr int prep_lanes() {
  return HD / 8 > 8 ? 16 : HD / 8 > 4 ? 8 : 4;
}

template <int HD>
__global__ void __launch_bounds__(256)
    bwd_prep_sm90_kernel(const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ lse2, float* __restrict__ dsum, int rows, int seq_q,
                         int seq_q_pad, int heads, Strides so, Strides sdo) {
  constexpr int PIECES = HD / 8;
  constexpr int LPR = prep_lanes<HD>();
  const int lane = threadIdx.x % 32;
  const long long r =
      (static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32) * (32 / LPR) + lane / LPR;
  const int piece = lane % LPR;
  const bool in = r < static_cast<long long>(rows) * seq_q_pad;
  const long long row = r / seq_q_pad;
  const int q = static_cast<int>(r % seq_q_pad);
  float acc = 0.f;
  if (in && q < seq_q && piece < PIECES) {
    const long long bi = row / heads, hq = row % heads;
    const uint4 a = *reinterpret_cast<const uint4*>(o + bi * so.b + hq * so.h + q * so.s +
                                                    piece * 8);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + bi * sdo.b + hq * sdo.h +
                                                    q * sdo.s + piece * 8);
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 xf = __bfloat1622float2(x[i]), yf = __bfloat1622float2(y[i]);
      acc = fmaf(xf.x, yf.x, acc);
      acc = fmaf(xf.y, yf.y, acc);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (!in || piece != 0) return;
  if (q >= seq_q) {
    lse2[r] = INFINITY;  // P = exp2(S - inf) = 0 on the zero-filled rows
    dsum[r] = 0.f;
    return;
  }
  const float l = lse[row * seq_q + q];
  lse2[r] = l < 0.5f * NEG_INF ? NEG_INF : l * LOG2E;
  dsum[r] = acc;
}

// ---- the two product kernels ------------------------------------------------
//
// Accumulator fragment of wgmma m64nNk16 (f32), per thread of a warpgroup
// (warp w, lane l): register r holds row 16w + l/4 + 8*((r >> 1) & 1) and
// column 8*(r >> 2) + 2*(l % 4) + (r & 1). Registers 8kk .. 8kk+7, as bf16
// pairs, are the A fragment of the k16 step kk of a product that takes this
// accumulator's columns as its K dimension.

// ---- 2. dK and dV ----------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
    dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base;                          // NPANEL panels of BKV rows x SW bytes
  const uint32_t sV = sK + C::KV_BYTES;
  const uint32_t sRing = sV + C::KV_BYTES;           // stage s at + s * STAGE1: Q, dO, lse, D
  const uint32_t bar_kv = sRing + NSTAGES * C::STAGE1;
  const uint32_t bar_f = bar_kv + 8;                 // full: stage s arrived
  const uint32_t bar_e = bar_f + 8 * NSTAGES;        // empty: stage s read by both consumers

  // the lowest kv tiles first (under causal the most q tiles reach them)
  const int kt = blockIdx.x / p.kv_rows;
  const int kv_row = blockIdx.x % p.kv_rows;
  const int bi = kv_row / p.kv_heads;  // batch
  const int hk = kv_row % p.kv_heads;  // kv head
  const int k0 = kt * BKV;
  const int k_valid = min(BKV, p.seq_k - k0);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < NSTAGES; ++s) {
      mbar_init(bar_f + 8 * s, 1);
      mbar_init(bar_e + 8 * s, NCONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NCONSUMERS) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NCONSUMERS * 128) {
      mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::NPANEL; ++pn) {
        tma_load_4d(sK + pn * BKV * C::SW, &tm_k, bar_kv, pn * C::PANEL, k0, hk, bi);
        tma_load_4d(sV + pn * BKV * C::SW, &tm_v, bar_kv, pn * C::PANEL, k0, hk, bi);
      }
      int it = 0;
      for (int h = 0; h < p.group; ++h) {
        const int row = kv_row * p.group + h;
        for (int qt = 0; qt < p.q_tiles; ++qt) {
          const int q0 = qt * BQ;
          if (q_tile_skipped(p, q0, min(BQ, p.seq_q - q0), k0, k_valid)) continue;
          const int s = it % NSTAGES;
          const uint32_t phase = (it / NSTAGES) & 1;
          const uint32_t st = sRing + s * C::STAGE1;
          mbar_wait(bar_e + 8 * s, phase ^ 1);  // the first pass finds the stage free
          mbar_expect_tx(bar_f + 8 * s, 2 * C::QT_BYTES + 2 * C::VEC_BYTES);
#pragma unroll
          for (int pn = 0; pn < C::NPANEL; ++pn) {
            tma_load_4d(st + pn * BQ * C::SW, &tm_q, bar_f + 8 * s, pn * C::PANEL, q0,
                        hk * p.group + h, bi);
            tma_load_4d(st + C::QT_BYTES + pn * BQ * C::SW, &tm_do, bar_f + 8 * s,
                        pn * C::PANEL, q0, hk * p.group + h, bi);
          }
          const size_t vec = static_cast<size_t>(row) * p.seq_q_pad + q0;
          bulk_load(st + 2 * C::QT_BYTES, p.lse2 + vec, C::VEC_BYTES, bar_f + 8 * s);
          bulk_load(st + 2 * C::QT_BYTES + C::VEC_BYTES, p.dsum + vec, C::VEC_BYTES,
                    bar_f + 8 * s);
          ++it;
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: keys k0 + wg*64 .. +63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int rk = (t / 32) * 16 + lane / 4;  // this thread's keys kw0 + rk and kw0 + rk + 8
    const int c0 = 2 * (lane % 4);            // and query columns 8j + c0, +1
    const int kw0 = k0 + wg * 64;
    const long long key0 = kw0 + rk;
    const long long key1 = key0 + 8;

    float dk[C::HDP / 2], dv[C::HDP / 2];
#pragma unroll
    for (int i = 0; i < C::HDP / 2; ++i) dk[i] = dv[i] = 0.f;

    const uint32_t k_wg = sK + wg * 64 * C::SW;
    const uint32_t v_wg = sV + wg * 64 * C::SW;
    mbar_wait(bar_kv, 0);

    int it = 0;
    for (int h = 0; h < p.group; ++h) {
      for (int qt = 0; qt < p.q_tiles; ++qt) {
        const int q0 = qt * BQ;
        const int q_valid = min(BQ, p.seq_q - q0);
        if (q_tile_skipped(p, q0, q_valid, k0, k_valid)) continue;
        const int s = it % NSTAGES;
        const uint32_t phase = (it / NSTAGES) & 1;
        const uint32_t st = sRing + s * C::STAGE1;
        ++it;
        const long long qlo = p.q_offset + q0;
        const long long qhi = qlo + BQ - 1;
        mbar_wait(bar_f + 8 * s, phase);

        // every row has a key and none of them is among these 64
        if (q_tile_skipped(p, q0, q_valid, kw0, 64)) {
          mbar_arrive(bar_e + 8 * s);
          continue;
        }

        // S^T = K Q^T and dP^T = V dO^T over the real hd, k16 steps of 32 bytes
        float sT[BQ / 2], dpT[BQ / 2];
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) sT[i] = dpT[i] = 0.f;
        reg_fence(sT);
        reg_fence(dpT);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int pn = kk / C::KSTEPS_PER_PANEL;
          const int in = (kk % C::KSTEPS_PER_PANEL) * 32;
          const uint64_t da = make_desc(k_wg + pn * BKV * C::SW + in, 16, 8 * C::SW, C::LAYOUT);
          const uint64_t db = make_desc(st + pn * BQ * C::SW + in, 16, 8 * C::SW, C::LAYOUT);
          wgmma_ss_n64(sT, da, db, kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int pn = kk / C::KSTEPS_PER_PANEL;
          const int in = (kk % C::KSTEPS_PER_PANEL) * 32;
          const uint64_t da = make_desc(v_wg + pn * BKV * C::SW + in, 16, 8 * C::SW, C::LAYOUT);
          const uint64_t db =
              make_desc(st + C::QT_BYTES + pn * BQ * C::SW + in, 16, 8 * C::SW, C::LAYOUT);
          wgmma_ss_n64(dpT, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sT);
        reg_fence(dpT);

        // P^T and dS^T, lse and D per column; masks only on a tile on an edge
        const float* lse_s = reinterpret_cast<const float*>(smem_raw + (st + 2 * C::QT_BYTES - raw));
        const float* d_s = lse_s + BQ;
        const bool full = kw0 + 63 < p.seq_k && (!p.causal || qlo >= kw0 + 63) &&
                          (!p.has_window || qhi - kw0 < p.window);
        uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = 8 * kk + 2 * j;  // keys alternate key0, key1 with j
            const int col = 16 * kk + 8 * (j >> 1) + c0;
            const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
            const float2 dd = *reinterpret_cast<const float2*>(d_s + col);
            float p0 = ex2(sT[r] * p.scale_log2 - l2.x);
            float p1 = ex2(sT[r + 1] * p.scale_log2 - l2.y);
            float ds0 = p0 * (dpT[r] - dd.x);
            float ds1 = p1 * (dpT[r + 1] - dd.y);
            if (!full) {
              const long long key = (j & 1) ? key1 : key0;
              const bool exists = key < p.seq_k;
              if (!keep(p, qlo + col, key)) {
                p0 = exists && l2.x < 0.5f * NEG_INF ? p.inv_sk : 0.f;
                ds0 = 0.f;
              }
              if (!keep(p, qlo + col + 1, key)) {
                p1 = exists && l2.y < 0.5f * NEG_INF ? p.inv_sk : 0.f;
                ds1 = 0.f;
              }
            }
            pa[kk][j] = pack_bf16(p0, p1);
            sa[kk][j] = pack_bf16(ds0, ds1);
          }
        }

        // dV += P^T dO, dK += dS^T Q over the tile's rows: 16 rows, two swizzle atoms a step
        reg_fence(dv);
        reg_fence(dk);
        reg_fence(pa);
        reg_fence(sa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint64_t db =
              make_desc(st + C::QT_BYTES + kk * 16 * C::SW, BQ * C::SW, 8 * C::SW, C::LAYOUT);
          wgmma_rs<C::HDP>(dv, pa[kk], db);
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint64_t db = make_desc(st + kk * 16 * C::SW, BQ * C::SW, 8 * C::SW, C::LAYOUT);
          wgmma_rs<C::HDP>(dk, sa[kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(dv);
        reg_fence(dk);
        mbar_arrive(bar_e + 8 * s);
      }
    }

    // the real columns of the existing keys, at dk's and dv's strides
    __nv_bfloat16* dkp = p.dk + bi * p.s_dk.b + hk * p.s_dk.h;
    __nv_bfloat16* dvp = p.dv + bi * p.s_dv.b + hk * p.s_dv.h;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + c0;
      if (key0 < p.seq_k) {
        *reinterpret_cast<__nv_bfloat162*>(dkp + key0 * p.s_dk.s + col) =
            __floats2bfloat162_rn(dk[4 * j] * p.scale, dk[4 * j + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvp + key0 * p.s_dv.s + col) =
            __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
      }
      if (key1 < p.seq_k) {
        *reinterpret_cast<__nv_bfloat162*>(dkp + key1 * p.s_dk.s + col) =
            __floats2bfloat162_rn(dk[4 * j + 2] * p.scale, dk[4 * j + 3] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvp + key1 * p.s_dv.s + col) =
            __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

// ---- 3. dQ -----------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
    dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                          // NPANEL panels of BQ2 rows x SW bytes
  const uint32_t sdO = sQ + C::Q2_BYTES;
  const uint32_t sK = sdO + C::Q2_BYTES;             // stage s: + s * KT_BYTES
  const uint32_t sV = sK + NSTAGES * C::KT_BYTES;
  const uint32_t bar_q = sV + NSTAGES * C::KT_BYTES;
  const uint32_t bar_f = bar_q + 8;                  // full: K and V of stage s arrived
  const uint32_t bar_e = bar_f + 8 * NSTAGES;        // empty: stage s read by both consumers

  // the last (heaviest, under causal) q tiles of every row first
  const int row = blockIdx.x % p.rows;
  const int q0 = (p.q_blocks - 1 - static_cast<int>(blockIdx.x / p.rows)) * BQ2;
  const int bi = row / p.heads;     // batch
  const int hq = row % p.heads;     // query head
  const int hk = hq / p.group;      // its kv head
  const int q_valid = min(BQ2, p.seq_q - q0);

  // a row with no unmasked key has dS = 0 everywhere, so only the tiles the
  // live rows reach matter; with a dead row in the block take every tile
  const long long qpos_first = p.q_offset + q0;
  long long lo_first, hi_first, lo_last, hi_last;
  const bool live_first = key_range(p, qpos_first, lo_first, hi_first);
  const bool live_last = key_range(p, qpos_first + q_valid - 1, lo_last, hi_last);
  int kt_begin = 0;
  int kt_end = (p.seq_k + BK2 - 1) / BK2;
  if (live_first && live_last) {
    kt_begin = static_cast<int>(lo_first / BK2);
    kt_end = static_cast<int>(hi_last / BK2) + 1;
  }
  const int n_tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < NSTAGES; ++s) {
      mbar_init(bar_f + 8 * s, 1);
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
      mbar_expect_tx(bar_q, 2 * C::Q2_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::NPANEL; ++pn) {
        tma_load_4d(sQ + pn * BQ2 * C::SW, &tm_q, bar_q, pn * C::PANEL, q0, hq, bi);
        tma_load_4d(sdO + pn * BQ2 * C::SW, &tm_do, bar_q, pn * C::PANEL, q0, hq, bi);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NSTAGES;
        const uint32_t phase = (it / NSTAGES) & 1;
        const int k0 = (kt_begin + it) * BK2;
        mbar_wait(bar_e + 8 * s, phase ^ 1);
        mbar_expect_tx(bar_f + 8 * s, 2 * C::KT_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::NPANEL; ++pn) {
          tma_load_4d(sK + s * C::KT_BYTES + pn * BK2 * C::SW, &tm_k, bar_f + 8 * s,
                      pn * C::PANEL, k0, hk, bi);
          tma_load_4d(sV + s * C::KT_BYTES + pn * BK2 * C::SW, &tm_v, bar_f + 8 * s,
                      pn * C::PANEL, k0, hk, bi);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows wg*64 .. wg*64+63 of the block ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r0 = wg * 64 + (t / 32) * 16 + lane / 4;  // this thread's rows r0 and r0 + 8
    const int c0 = 2 * (lane % 4);                      // and keys 8j + c0, +1 of a tile
    const long long qpos0 = p.q_offset + q0 + r0;
    const long long qpos1 = qpos0 + 8;
    const long long wg_qlo = p.q_offset + q0 + wg * 64;
    const long long wg_qhi = wg_qlo + 63;
    const size_t vec = static_cast<size_t>(row) * p.seq_q_pad + q0 + r0;  // padded: in range
    const float l2_0 = p.lse2[vec], l2_1 = p.lse2[vec + 8];
    const float d_0 = p.dsum[vec], d_1 = p.dsum[vec + 8];

    float dq[C::HDP / 2];
#pragma unroll
    for (int i = 0; i < C::HDP / 2; ++i) dq[i] = 0.f;

    const uint32_t q_wg = sQ + wg * 64 * C::SW;
    const uint32_t do_wg = sdO + wg * 64 * C::SW;
    mbar_wait(bar_q, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % NSTAGES;
      const uint32_t phase = (it / NSTAGES) & 1;
      const int k0 = (kt_begin + it) * BK2;
      const uint32_t k_st = sK + s * C::KT_BYTES;
      const uint32_t v_st = sV + s * C::KT_BYTES;
      mbar_wait(bar_f + 8 * s, phase);

      // no row of this warpgroup sees a key of the tile
      if (k0 >= p.seq_k || (p.causal && k0 > wg_qhi) ||
          (p.has_window && wg_qlo - (k0 + BK2 - 1) >= p.window)) {
        mbar_arrive(bar_e + 8 * s);
        continue;
      }

      // S = Q K^T and dP = dO V^T over the real hd
      float sc[BK2 / 2], dp[BK2 / 2];
#pragma unroll
      for (int i = 0; i < BK2 / 2; ++i) sc[i] = dp[i] = 0.f;
      reg_fence(sc);
      reg_fence(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int pn = kk / C::KSTEPS_PER_PANEL;
        const int in = (kk % C::KSTEPS_PER_PANEL) * 32;
        const uint64_t da = make_desc(q_wg + pn * BQ2 * C::SW + in, 16, 8 * C::SW, C::LAYOUT);
        const uint64_t db = make_desc(k_st + pn * BK2 * C::SW + in, 16, 8 * C::SW, C::LAYOUT);
        wgmma_ss_n64(sc, da, db, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int pn = kk / C::KSTEPS_PER_PANEL;
        const int in = (kk % C::KSTEPS_PER_PANEL) * 32;
        const uint64_t da = make_desc(do_wg + pn * BQ2 * C::SW + in, 16, 8 * C::SW, C::LAYOUT);
        const uint64_t db = make_desc(v_st + pn * BK2 * C::SW + in, 16, 8 * C::SW, C::LAYOUT);
        wgmma_ss_n64(dp, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);
      reg_fence(dp);

      // dS in registers; masks only on a tile on an edge (a dead row is always on one)
      const bool edge = (k0 + BK2 > p.seq_k) || (p.causal && k0 + BK2 - 1 > wg_qlo) ||
                        (p.has_window && wg_qhi - k0 >= p.window);
      uint32_t sa[BK2 / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK2 / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 8 * kk + 2 * j;  // rows alternate r0, r0 + 8 with j
          const float l2 = (j & 1) ? l2_1 : l2_0;
          const float dd = (j & 1) ? d_1 : d_0;
          float ds0 = ex2(sc[r] * p.scale_log2 - l2) * (dp[r] - dd);
          float ds1 = ex2(sc[r + 1] * p.scale_log2 - l2) * (dp[r + 1] - dd);
          if (edge) {
            const long long qpos = (j & 1) ? qpos1 : qpos0;
            const long long key = k0 + 16 * kk + 8 * (j >> 1) + c0;
            if (!keep(p, qpos, key)) ds0 = 0.f;
            if (!keep(p, qpos, key + 1)) ds1 = 0.f;
          }
          sa[kk][j] = pack_bf16(ds0, ds1);
        }
      }

      // dQ += dS K over the tile's keys: K is MN-major here
      reg_fence(dq);
      reg_fence(sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK2 / 16; ++kk) {
        const uint64_t db = make_desc(k_st + kk * 16 * C::SW, BK2 * C::SW, 8 * C::SW, C::LAYOUT);
        wgmma_rs<C::HDP>(dq, sa[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(dq);
      mbar_arrive(bar_e + 8 * s);
    }

    // the block's rows of dq at its strides; rows past Sq are not stored
    __nv_bfloat16* out = p.dq + bi * p.s_dq.b + hq * p.s_dq.h + q0 * p.s_dq.s;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {  // the real columns only
      const int col = 8 * j + c0;
      if (r0 < q_valid)
        *reinterpret_cast<__nv_bfloat162*>(out + r0 * p.s_dq.s + col) =
            __floats2bfloat162_rn(dq[4 * j] * p.scale, dq[4 * j + 1] * p.scale);
      if (r0 + 8 < q_valid)
        *reinterpret_cast<__nv_bfloat162*>(out + (r0 + 8) * p.s_dq.s + col) =
            __floats2bfloat162_rn(dq[4 * j + 2] * p.scale, dq[4 * j + 3] * p.scale);
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

// (hd, seq, heads, batch) bf16 at the strides `st` in elements (hd's is 1);
// boxes of one panel x box_rows x 1 x 1. The extents are the real hd and
// seq: a box past either comes back zero-filled.
template <int HD>
int encode(CUtensorMap* map, const void* ptr, int seq, int heads, int batch, Strides st,
           int box_rows) {
  using C = Cfg<HD>;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ERR_ENTRY_POINT;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(C::PANEL), static_cast<cuuint32_t>(box_rows),
                             1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                          strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(res);
}

// st: the strides of q, k, v, o and dout in that order.
template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* aux, const Strides* st, int batch, const Params& p,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap tq1, tdo1, tk1, tv1, tq2, tdo2, tk2, tv2;
  const int h = p.heads, hk = p.kv_heads;
  int err = encode<HD>(&tq1, q, p.seq_q, h, batch, st[0], BQ);
  if (err == 0) err = encode<HD>(&tdo1, dout, p.seq_q, h, batch, st[4], BQ);
  if (err == 0) err = encode<HD>(&tk1, k, p.seq_k, hk, batch, st[1], BKV);
  if (err == 0) err = encode<HD>(&tv1, v, p.seq_k, hk, batch, st[2], BKV);
  if (err == 0) err = encode<HD>(&tq2, q, p.seq_q, h, batch, st[0], BQ2);
  if (err == 0) err = encode<HD>(&tdo2, dout, p.seq_q, h, batch, st[4], BQ2);
  if (err == 0) err = encode<HD>(&tk2, k, p.seq_k, hk, batch, st[1], BK2);
  if (err == 0) err = encode<HD>(&tv2, v, p.seq_k, hk, batch, st[2], BK2);
  if (err != 0) return err;

  constexpr int PREP_ROWS_PER_BLOCK = 8 * 32 / prep_lanes<HD>();  // 8 warps
  const long long prep_rows = static_cast<long long>(p.rows) * p.seq_q_pad;
  bwd_prep_sm90_kernel<HD><<<static_cast<unsigned>((prep_rows + PREP_ROWS_PER_BLOCK - 1) /
                                                   PREP_ROWS_PER_BLOCK),
                             256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse, aux,
      aux + prep_rows, p.rows, p.seq_q, p.seq_q_pad, p.heads, st[3], st[4]);
  cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return cerr;

  cerr = cudaFuncSetAttribute(dkdv_sm90_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              C::SMEM1);
  if (cerr != cudaSuccess) return cerr;
  const int kv_tiles = (p.seq_k + BKV - 1) / BKV;
  dkdv_sm90_kernel<HD><<<p.kv_rows * kv_tiles, NTHREADS, C::SMEM1, stream>>>(tq1, tdo1, tk1, tv1,
                                                                             p);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return cerr;

  cerr = cudaFuncSetAttribute(dq_sm90_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              C::SMEM2);
  if (cerr != cudaSuccess) return cerr;
  dq_sm90_kernel<HD><<<p.rows * p.q_blocks, NTHREADS, C::SMEM2, stream>>>(tq2, tdo2, tk2, tv2, p);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (batch, seq_q, heads, head_dim); k, v, dk, dv (batch,
// seq_k, heads / group, head_dim): bf16, 16-byte aligned, hd contiguous;
// `strides` holds the batch, sequence and head strides in elements of q, k,
// v, o, dout, dq, dk and dv in that order (24 values), each a multiple of 8.
// lse f32 (batch * heads, seq_q). aux: f32 scratch of 2 * batch * heads *
// seq_q_pad, 16-byte aligned, seq_q_pad = seq_q rounded up to a multiple of
// flash_attention_bwd_sm90_pad(). scale is hd^-0.5.
extern "C" int flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const float* lse,
                                        float* aux, void* dq, void* dk, void* dv,
                                        const long long* strides, int batch, int heads,
                                        int seq_q, int seq_k, int head_dim, int group,
                                        int causal, int has_window, long long window,
                                        long long q_offset, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_q <= 0 || seq_k <= 0 || group <= 0 || heads % group) {
    return cudaErrorInvalidValue;
  }
  const int bh = batch * heads;
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int seq_q_pad = (seq_q + PAD - 1) / PAD * PAD;
  // The tensor maps are encoded through the driver API, which needs a current
  // context. A thread that has made no runtime call yet (autograd's worker
  // thread can be one) has none until cudaSetDevice binds its device's
  // primary context.
  int device = 0;
  cudaError_t cerr = cudaGetDevice(&device);
  if (cerr == cudaSuccess) cerr = cudaSetDevice(device);
  if (cerr != cudaSuccess) return cerr;
  const int q_blocks = seq_q_pad / BQ2;
  const int kv_tiles = (seq_k + BKV - 1) / BKV;
  if (static_cast<long long>(bh) * q_blocks > 0x7fffffffLL ||
      static_cast<long long>(bh / group) * kv_tiles > 0x7fffffffLL ||
      static_cast<long long>(bh) * seq_q_pad / 8 > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  Params p{seq_q, seq_k, seq_q_pad, group, heads, heads / group, bh, bh / group,
           (seq_q + BQ - 1) / BQ, q_blocks, causal, has_window, window, q_offset, scale,
           scale * LOG2E, 1.f / static_cast<float>(seq_k), aux,
           aux + static_cast<size_t>(bh) * seq_q_pad, static_cast<__nv_bfloat16*>(dq),
           static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), st[5], st[6], st[7]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch<32>(q, k, v, o, dout, lse, aux, st, batch, p, cs);
    case 64: return launch<64>(q, k, v, o, dout, lse, aux, st, batch, p, cs);
    case 112: return launch<112>(q, k, v, o, dout, lse, aux, st, batch, p, cs);
    case 128: return launch<128>(q, k, v, o, dout, lse, aux, st, batch, p, cs);
    default: return cudaErrorInvalidValue;
  }
}

// The multiple to which aux's rows are padded.
extern "C" int flash_attention_bwd_sm90_pad() { return PAD; }

extern "C" const char* flash_attention_bwd_sm90_error_string(int err) {
  static thread_local char buf[96];
  if (err == ERR_ENTRY_POINT) return "cudaGetDriverEntryPoint(cuTensorMapEncodeTiled) failed";
  if (err >= ERR_ENCODE) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed with CUresult %d",
             err - ERR_ENCODE);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
