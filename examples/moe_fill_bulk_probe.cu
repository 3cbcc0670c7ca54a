// B2's fill as 1-D bulk copies through a shared-memory ring (sm_90a), CUDA
// C++: a design alternative to `moe_fill_kernel` in
// src/repro_torch/kernels/csrc/moe_dispatch.cu, kept for timing only by
// `moe_fill_probe_torch.py` beside this file; nothing on the port's path
// builds it. It exports the same `moe_fill` entry point, on the `vector`
// widths only (rows of whole 16-byte pieces, rows and out 16-byte aligned),
// and writes the same buffer bit for bit.
//
// A block's first warp walks its tokens; one thread copies a token's row
// (in pieces of at most MAX_PIECE bytes) into a stage of a STAGES-deep ring
// by a 1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx::bytes), and
// once it has landed each lane that holds a kept destination stores the
// stage there by a bulk store (cp.async.bulk.global.shared::cta.bulk_group).
// A stage is loaded again once the stores of the token before have read it
// (cp.async.bulk.wait_group.read 1). The block's other seven warps zero the
// empty slots as `moe_fill_kernel`'s warps do. STAGES and MAX_PIECE may be
// set by -D.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef STAGES
#define STAGES 4
#endif
#ifndef MAX_PIECE
#define MAX_PIECE (16 * 1024)
#endif

namespace {

constexpr int FILL_THREADS = 256;
constexpr int FILL_WARPS = FILL_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_K = 32;
constexpr int FILL_BLOCKS_PER_SM = 8;   // the most resident: 64 warps
constexpr int SMEM_PER_SM = 200 * 1024; // of 228 KB: what the rings may take
constexpr int MAX_DEVICES = 64;
// moe_dispatch.cu's mode: bit 0 the route, bit 1 the dtype, bits 2-7 k, the device from bit 8
constexpr int MODE_DTYPE_SHIFT = 1, MODE_K_SHIFT = 2, MODE_DEVICE_SHIFT = 8;

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

// ---- shared memory, mbarriers, bulk copies ---------------------------------

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

// `bytes` of shared memory to global memory, in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's newest bulk groups still read shared memory.
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Until every bulk group of this thread has completed its writes.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

struct BulkFill {
  const uint8_t* rows;
  const int32_t* dest;
  const int32_t* kept;
  uint8_t* out;
  int64_t tokens;
  int64_t slots;
  int64_t cap;
  int64_t row_bytes;       // a multiple of 16
  int k;
  int pieces;              // of a row, each at most `piece` bytes
  uint32_t piece;          // a multiple of 16: a stage
};

// The bulk design: warp 0 walks the block's items (token, piece) through a
// STAGES-deep ring, lane 0 issuing the loads and lane j < k the store to
// the token's j-th destination; warps 1.. zero the empty slots.
__global__ void __launch_bounds__(FILL_THREADS) moe_fill_bulk_kernel(const BulkFill p) {
  extern __shared__ __align__(128) uint8_t ring[];   // STAGES x piece
  __shared__ __align__(8) uint64_t full[STAGES];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp > 0) {
    zero_empty_slots(reinterpret_cast<uint4*>(p.out), p.kept, p.slots, p.cap, p.row_bytes / 16,
                     int64_t(blockIdx.x) * (FILL_WARPS - 1) + warp - 1,
                     int64_t(gridDim.x) * (FILL_WARPS - 1), lane);
    return;
  }
  const int64_t items = p.tokens * p.pieces;
  const int64_t n_mine =
      items > blockIdx.x ? (items - blockIdx.x - 1) / gridDim.x + 1 : 0;
  // the n-th item of this block: its token, and its piece's offset and bytes
  auto item = [&](int64_t n, int64_t& t, int64_t& off, uint32_t& bytes) {
    const int64_t i = blockIdx.x + n * gridDim.x;
    t = i / p.pieces;
    off = (i - t * p.pieces) * int64_t(p.piece);
    const int64_t left = p.row_bytes - off;
    bytes = static_cast<uint32_t>(left < int64_t(p.piece) ? left : int64_t(p.piece));
  };
  auto load = [&](int64_t n) {
    int64_t t, off;
    uint32_t bytes;
    item(n, t, off, bytes);
    const int s = static_cast<int>(n % STAGES);
    bulk_load(smem_u32(ring + s * p.piece), p.rows + t * p.row_bytes + off, bytes,
              smem_u32(&full[s]));
  };
  if (lane == 0)
    for (int64_t n = 0; n < n_mine && n < STAGES; ++n) load(n);
  for (int64_t n = 0; n < n_mine; ++n) {
    int64_t t, off;
    uint32_t bytes;
    item(n, t, off, bytes);
    const int32_t d = lane < p.k ? p.dest[t * p.k + lane] : -1;   // read before the wait
    if (d >= p.slots) __trap();
    const int s = static_cast<int>(n % STAGES);
    mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>((n / STAGES) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (d >= 0) bulk_store(p.out + int64_t(d) * p.row_bytes + off, smem_u32(ring + s * p.piece),
                           bytes);
    bulk_commit();
    // stage of item n-1 takes item n-1+STAGES once item n-1's stores have read it
    if (n >= 1 && n - 1 + STAGES < n_mine) {
      bulk_wait_read<1>();
      __syncwarp();
      if (lane == 0) load(n - 1 + STAGES);
    }
  }
  bulk_wait_all();                      // the ring stays until every store is done
}

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

// Makes `dev` current for the launch and restores the caller's device.
struct OnDevice {
  int prev = -1;
  explicit OnDevice(int dev) {
    if (cudaGetDevice(&prev) == cudaSuccess && prev != dev) cudaSetDevice(dev);
    else prev = -1;
  }
  ~OnDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

cudaError_t launch_bulk_fill(BulkFill p, int dev, cudaStream_t st) {
  static bool attribute_set[MAX_DEVICES] = {};
  if (dev >= 0 && dev < MAX_DEVICES && !attribute_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_fill_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, STAGES * MAX_PIECE);
    if (err != cudaSuccess) return err;
    attribute_set[dev] = true;
  }
  p.pieces = static_cast<int>((p.row_bytes + MAX_PIECE - 1) / MAX_PIECE);
  p.piece = static_cast<uint32_t>(((p.row_bytes + p.pieces - 1) / p.pieces + 15) / 16 * 16);
  const int smem = STAGES * static_cast<int>(p.piece);
  const int per_sm = max(1, min(FILL_BLOCKS_PER_SM, SMEM_PER_SM / smem));
  // a block for each item, or for each 32 x 7 slot rows where the zeros are
  // the larger part (decode: few tokens)
  const int64_t items = p.tokens * p.pieces;
  const int64_t zero_blocks = (p.slots + 32 * (FILL_WARPS - 1) - 1) / (32 * (FILL_WARPS - 1));
  const int grid = grid_for(items > zero_blocks ? items : zero_blocks, 1, per_sm, dev);
  moe_fill_bulk_kernel<<<grid, FILL_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int moe_fill(int mode, const void* rows, const int32_t* dest, const int32_t* kept,
                        void* out, long long tokens, long long experts, long long cap,
                        long long d, void* stream) {
  const int vector = mode & 1, dtype = (mode >> MODE_DTYPE_SHIFT) & 1;
  const int k = (mode >> MODE_K_SHIFT) & 63, device = mode >> MODE_DEVICE_SHIFT;
  const long long slots = experts * cap;
  const int64_t bytes = d * (dtype == 0 ? 4 : 2);
  if (!vector || tokens < 0 || experts < 0 || cap < 0 || d < 0 || k < 1 || k > MAX_K ||
      slots > INT32_MAX || bytes % 16 != 0 || (reinterpret_cast<uintptr_t>(rows) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return cudaErrorInvalidValue;
  if (slots == 0 || d == 0) return cudaSuccess;
  OnDevice on(device);
  BulkFill p{static_cast<const uint8_t*>(rows), dest, kept, static_cast<uint8_t*>(out),
             tokens, slots, cap, bytes, k, 0, 0};
  return launch_bulk_fill(p, device, static_cast<cudaStream_t>(stream));
}

extern "C" const char* moe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
