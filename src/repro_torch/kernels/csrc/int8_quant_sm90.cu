// Row-wise symmetric int8 quantization for Hopper (sm_90a): persistent
// blocks fed by 1-D bulk copies through an mbarrier ring.
//
// Replaces the Pallas TPU kernel `_quant_kernel` driven by `quantize_int8`
// (src/repro/kernels/int8_quant.py) on every shape whose rows are whole
// 16-byte pieces that fit one stage; int8_quant.cu takes the others. Same
// function: x (R, C) f32 or bf16; per row, absmax = max |x| in f32,
// scale = max(absmax, 1e-8) / 127 (one IEEE division) and
// q = clip(rint(x / scale), -127, 127) as int8, half to even. A row that
// holds a NaN gets a NaN scale, one that holds an inf an inf scale; q is
// defined only on rows whose scale is finite. q and scale equal the plain
// PyTorch version's bit for bit. With `out` (bf16 or f32, shaped like x) the
// same pass also writes out = q * scale, the single f32 product that
// torch.mul(q, scale[:, None], out=out) computes, rounded once to out's type.
//
// What bounds it on this card: bytes. At the runtime's boundary shape
// (640, 5120) bf16, x is read once (6.55 MB) and q and scale written once
// (3.28 MB), ~2.9 us at 3.35 TB/s; with a bf16 `out` 16.39 MB, ~4.9 us.
// Each SM's share is only ~50 KB of x, about what it must keep in flight to
// cover the memory latency, so the kernel lives or dies by how early every
// SM has all its loads in flight, and by how little it does per element after
// they land. What the design does about that:
// * a grid sized to what the card holds: as many blocks an SM as a full
//   4-stage ring lets it keep (at most 8, 64 warps), each walking over tiles
//   of whole consecutive rows (one contiguous range of x) with only as many
//   stages as it has tiles. One thread starts the bulk copy of every
//   stage's first tile at once (cp.async.bulk, complete_tx on an mbarrier),
//   and the copy of a stage's next tile as soon as every thread is done with
//   the one before. Rows per tile grow up to 12 KB when there are more rows
//   than the card's rings hold. At the boundary shape each of 640 blocks
//   takes one row and all are resident at once: the second pass is bound
//   by instruction throughput, and warps, more than a deep ring, hide it;
// * x is read from device memory once; both passes over a row read shared
//   memory, 16 bytes a thread, conflict-free;
// * absmax on the bit patterns: |x| as an unsigned integer orders like the
//   float and puts every NaN above inf, so an integer max (packed u16x2 for
//   bf16) propagates NaN, as the reference's max does; a warp's max is one
//   redux.sync. A row shorter than 2048 elements takes one warp (eight rows
//   at a time); a longer one the block's eight warps, through shared memory;
// * the IEEE quotient without a division: with r = RN(1 / scale), once a
//   row, q0 = x * r and two corrections q <- q + (x - scale * q) * r, each
//   two fma. The first makes the quotient faithful (q0 is within 2 ulp, and
//   the correction's own error is ~2^-23 of that); the second is
//   Markstein's step, which rounds a faithful quotient correctly when the
//   reciprocal is RN(1 / scale): the result is the division's bit for bit
//   (|x / scale| <= 127.0001, so nothing overflows, and a quotient small
//   enough to underflow rounds to q = 0 either way). Five instructions an
//   element and no branch. The division itself compiles to a check and a
//   call to its slow path, which slowed the whole pass; a test near each
//   .5 step instead costs more than the two corrections: in bf16 rows the
//   quotient falls exactly on a .5 step often (x and the absmax carry 8
//   bits), so an exact path behind a branch is taken by most warps. The
//   clip to +-127 never binds on a row whose scale is finite (|x / scale|
//   <= 127.00001), so it is left out;
// * stores straight from registers, one per 16-byte piece of x: q as 8 (bf16
//   x) or 4 (f32 x) bytes, `out` as 16 or 32 (two 16-byte stores); a warp's
//   q store covers 256 or 128 contiguous bytes, whole sectors. Staging q and
//   `out` in shared memory for a bulk store (cp.async.bulk, after a proxy
//   fence and a barrier) timed slower at the boundary shape, with and
//   without `out`: the staging writes and the barrier sit on each tile's
//   path, where register stores let each thread go once its piece is done.
// The TPU kernel's 256-row blocks and its padding of the tail with 1.0 are
// not carried over.
//
// Entry point: `int8_quant_sm90_rows`, a plain C function that launches on
// the given stream and returns cudaGetLastError(), or cudaErrorInvalidValue
// for a shape or pointer this kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int STAGES = 4;                      // the most a ring holds
constexpr int MAX_STAGE_BYTES = 48 * 1024;     // a row must fit one stage
constexpr int TILE_TARGET_BYTES = 12 * 1024;   // rows per tile grow up to this
constexpr int BLOCK_ROW_MIN_COLS = 2048;       // rows this long take the whole block
constexpr int BLOCKS_PER_SM = 8;               // the most resident: 64 warps
constexpr int SMEM_PER_SM = 220 * 1024;        // of 228 KB, leaving each block's 1 KB
constexpr int MAX_DEVICES = 64;

enum OutKind { OUT_NONE = 0, OUT_F32 = 1, OUT_BF16 = 2 };

struct Params {
  const uint8_t* x;
  signed char* q;
  float* scale;
  void* out;
  int rows;
  int cols;
  int tile_rows;
  int n_tiles;
  int stages;      // the ring's depth, at most STAGES
  uint32_t row_bytes;
  uint32_t stage_bytes;
};

// ---- shared memory, mbarriers, bulk copies --------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
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

// `bytes` contiguous bytes of global memory into shared memory; completion
// is counted in bytes on `bar`, whose phase this arrival opens.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- arithmetic -------------------------------------------------------------

// max that returns NaN when either side is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// max |x| of a 16-byte piece as an f32 bit pattern (NaN above inf)
__device__ __forceinline__ uint32_t piece_absmax(uint4 raw, float) {
  const uint32_t a = max(raw.x & 0x7fffffffu, raw.y & 0x7fffffffu);
  const uint32_t b = max(raw.z & 0x7fffffffu, raw.w & 0x7fffffffu);
  return max(a, b);
}
__device__ __forceinline__ uint32_t piece_absmax(uint4 raw, __nv_bfloat16) {
  const uint32_t m = __vmaxu2(__vmaxu2(raw.x & 0x7fff7fffu, raw.y & 0x7fff7fffu),
                              __vmaxu2(raw.z & 0x7fff7fffu, raw.w & 0x7fff7fffu));
  return max(m << 16, m & 0xffff0000u);   // the two bf16 as f32 patterns
}

// the piece's elements as f32
__device__ __forceinline__ void unpack(uint4 raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(uint4 raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// fl(v / s), the IEEE quotient, from r = RN(1 / s) and no division (the
// header says why it is exact)
__device__ __forceinline__ float quotient(float v, float s, float r) {
  float q = v * r;
  q = __fmaf_rn(__fmaf_rn(-s, q, v), r, q);
  return __fmaf_rn(__fmaf_rn(-s, q, v), r, q);
}

// float(q) for q = clip(rint(fl(v / s)), -127, 127). The clip never binds
// where s is finite: |v| <= absmax and s >= RN(absmax / 127), so
// |fl(v / s)| <= 127.00001 and rint stays within 127. + 0: rint gives -0
// where q is 0, and float(q) is +0.
__device__ __forceinline__ float quantized(float v, float s, float r) {
  return rintf(quotient(v, s, r)) + 0.0f;
}

__device__ __forceinline__ uint32_t pack_q4(const float* t) {
  return (static_cast<uint32_t>(static_cast<int>(t[0])) & 0xffu) |
         ((static_cast<uint32_t>(static_cast<int>(t[1])) & 0xffu) << 8) |
         ((static_cast<uint32_t>(static_cast<int>(t[2])) & 0xffu) << 16) |
         (static_cast<uint32_t>(static_cast<int>(t[3])) << 24);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// q (and out) of the N elements of one piece at element offset `at` of row
// `row`: N is 4 (f32 x) or 8 (bf16 x)
template <int N, int OUT>
__device__ __forceinline__ void store_piece(const Params& p, size_t at, const float (&t)[N],
                                            float s) {
  if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(p.q + at) = make_uint2(pack_q4(t), pack_q4(t + 4));
  } else {
    *reinterpret_cast<uint32_t*>(p.q + at) = pack_q4(t);
  }
  if constexpr (OUT == OUT_BF16) {
    uint32_t w[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) w[i] = pack_bf16(t[2 * i] * s, t[2 * i + 1] * s);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + at;
    if constexpr (N == 8) *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
    else *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
  } else if constexpr (OUT == OUT_F32) {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(p.out) + at);
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      o[i] = make_float4(t[4 * i] * s, t[4 * i + 1] * s, t[4 * i + 2] * s, t[4 * i + 3] * s);
  }
}

// ---- the kernel ------------------------------------------------------------
//
// WPR warps share a row: 1 (a warp per row, eight rows at a time) or NWARPS
// (the block per row).

template <typename T, int OUT, int WPR>
__global__ void __launch_bounds__(NTHREADS)
    quant_rows_sm90_kernel(const Params p) {
  constexpr int N = 16 / sizeof(T);            // elements per 16-byte piece
  constexpr int GROUP = WPR * 32;              // threads per row
  constexpr int ROWS_AT_ONCE = NWARPS / WPR;
  extern __shared__ __align__(128) uint8_t ring[];   // stages x stage_bytes
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ uint32_t part[2][NWARPS];               // block per row: each warp's max

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = warp / WPR;                  // which of the rows at once
  const int gl = threadIdx.x % GROUP;          // thread within the row's group
  const int pieces = p.cols / N;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_tile = [&](int s, int tile) {
    const int row0 = tile * p.tile_rows;
    const uint32_t bytes = static_cast<uint32_t>(min(p.tile_rows, p.rows - row0)) * p.row_bytes;
    bulk_load(smem_u32(ring + s * p.stage_bytes),
              p.x + static_cast<size_t>(row0) * p.row_bytes, bytes, smem_u32(&full[s]));
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      const int tile = blockIdx.x + s * gridDim.x;
      if (tile < p.n_tiles) load_tile(s, tile);
    }
  }

  int block_rows_done = 0;                     // picks the half of `part`
  for (int it = 0, tile = blockIdx.x; tile < p.n_tiles; ++it, tile += gridDim.x) {
    const int s = it % p.stages;
    mbar_wait(smem_u32(&full[s]), (it / p.stages) & 1);
    const int row0 = tile * p.tile_rows;
    const int nr = min(p.tile_rows, p.rows - row0);
    const uint8_t* stage = ring + s * p.stage_bytes;
    for (int rr = sub; rr < nr; rr += ROWS_AT_ONCE) {
      const uint4* xr = reinterpret_cast<const uint4*>(stage + rr * p.row_bytes);
      uint32_t m = 0;
#pragma unroll 4
      for (int i = gl; i < pieces; i += GROUP) m = max(m, piece_absmax(xr[i], T()));
      m = __reduce_max_sync(0xffffffffu, m);
      if constexpr (WPR > 1) {
        uint32_t* mine = part[block_rows_done & 1];
        if (lane == 0) mine[warp] = m;
        __syncthreads();
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) m = max(m, mine[w]);
        ++block_rows_done;
      }
      const float sc = nan_max(__uint_as_float(m), 1e-8f) / 127.0f;
      const float r = 1.0f / sc;
      const size_t row = static_cast<size_t>(row0 + rr);
      if (gl == 0) p.scale[row] = sc;
#pragma unroll 2
      for (int i = gl; i < pieces; i += GROUP) {
        float v[N], t[N];
        unpack(xr[i], v);
#pragma unroll
        for (int k = 0; k < N; ++k) t[k] = quantized(v[k], sc, r);
        store_piece<N, OUT>(p, row * p.cols + static_cast<size_t>(i) * N, t, sc);
      }
    }
    __syncthreads();                           // every thread is done with stage s
    const int next = tile + p.stages * static_cast<int>(gridDim.x);
    if (threadIdx.x == 0 && next < p.n_tiles) load_tile(s, next);
  }
}

// ---- host side -------------------------------------------------------------

int sm_count() {
  static int counts[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return 0;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    counts[dev] = n;
  }
  return counts[dev];
}

template <typename T, int OUT, int WPR>
cudaError_t launch_kernel(const Params& p, int grid, cudaStream_t stream) {
  static bool attribute_set = false;   // once per kernel; a repeat sets the same value
  if (!attribute_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(quant_rows_sm90_kernel<T, OUT, WPR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, STAGES * MAX_STAGE_BYTES);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  quant_rows_sm90_kernel<T, OUT, WPR>
      <<<grid, NTHREADS, p.stages * p.stage_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int OUT>
cudaError_t launch_out(const Params& p, int grid, cudaStream_t stream) {
  return p.cols >= BLOCK_ROW_MIN_COLS ? launch_kernel<T, OUT, NWARPS>(p, grid, stream)
                                      : launch_kernel<T, OUT, 1>(p, grid, stream);
}

template <typename T>
cudaError_t launch(Params p, int out_dtype, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  // rows per tile: enough tiles to fill every resident block's ring, each
  // at most TILE_TARGET_BYTES, and at least a row for each warp of a
  // warp-per-row block
  const int fit = max(1, TILE_TARGET_BYTES / static_cast<int>(p.row_bytes));
  const int spread = p.rows / (sms * BLOCKS_PER_SM * STAGES);
  const int least = p.cols >= BLOCK_ROW_MIN_COLS ? 1 : min(NWARPS, fit);
  p.tile_rows = min(max(spread, least), fit);
  p.n_tiles = (p.rows + p.tile_rows - 1) / p.tile_rows;
  p.stage_bytes = static_cast<uint32_t>(p.tile_rows) * p.row_bytes;
  // as many blocks as a full ring lets an SM hold, each with only as many
  // stages as it has tiles
  const int per_sm = min(BLOCKS_PER_SM,
                         max(1, SMEM_PER_SM / static_cast<int>(STAGES * p.stage_bytes)));
  const int grid = min(p.n_tiles, sms * per_sm);
  p.stages = min(STAGES, (p.n_tiles + grid - 1) / grid);
  if (p.out == nullptr) return launch_out<T, OUT_NONE>(p, grid, stream);
  return out_dtype == 0 ? launch_out<T, OUT_F32>(p, grid, stream)
                        : launch_out<T, OUT_BF16>(p, grid, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x); out_dtype likewise (out), read only
// when out is not null. x (rows, cols) contiguous and 16-byte aligned, with
// cols * sizeof(x) a multiple of 16 and at most 48 KB; q (rows, cols) int8,
// scale (rows,) f32 and out (rows, cols), contiguous; q 8-byte and out
// 16-byte aligned.
extern "C" int int8_quant_sm90_rows(const void* x, void* q, void* scale, void* out, int dtype,
                                    int out_dtype, int rows, int cols, void* stream) {
  if (rows <= 0 || cols <= 0 || (dtype != 0 && dtype != 1) ||
      (out != nullptr && out_dtype != 0 && out_dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  const size_t row_bytes = static_cast<size_t>(cols) * (dtype == 0 ? 4 : 2);
  if (row_bytes % 16 || row_bytes > MAX_STAGE_BYTES || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 8 || reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorInvalidValue;
  }
  Params p{static_cast<const uint8_t*>(x), static_cast<signed char*>(q),
           static_cast<float*>(scale), out, rows, cols, 0, 0, 0,
           static_cast<uint32_t>(row_bytes), 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, out_dtype, st) : launch<__nv_bfloat16>(p, out_dtype, st);
}

extern "C" const char* int8_quant_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
