// Flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel` driven by `flash_attention`
// (src/repro/kernels/flash_attention.py). Same function: online-softmax
// attention over the flattened (batch*heads, S, hd) layout, f32 m/l/acc
// state, scale hd^-0.5, masks for the ragged kv edge, causal (with q_offset)
// and sliding window, GQA row map `kv_row = row / group`. Masked scores are
// the finite -1e30, so a row with every key masked averages V over all keys
// exactly as the oracle `attention_ref` does; keys past the ragged edge are
// excluded outright (p = 0) because the oracle has no padding.
//
// What bounds it on this card: at the serving shape (q 160x1024x128 bf16,
// causal) the work is ~43 GFLOP against ~100 MB of traffic, ~430 FLOP/byte,
// above the H100's ~295 FLOP/byte ridge, so the tensor-core rate bounds the
// best possible kernel (~43 us). This first version does its products on
// the CUDA cores in f32 (one code path for f32 and bf16 inputs, no
// tensor-core rounding), so it is bounded by the f32 FMA rate and the
// shared-memory reads feeding it. What the design does about that:
// * one block per (row, 64-query tile) loops over 64-key tiles, so nothing
//   carries across blocks and the (Sq, Sk) scores never reach device memory;
// * Q, K, V and P tiles sit in shared memory as f32 (dynamic, > 48 KB), rows
//   padded by one word so the column walks hit distinct banks;
// * each thread owns a 4x4 block of scores and a 4x(hd/16) block of the
//   output, so every shared-memory read feeds 4 FMAs;
// * kv tiles that every row of the block masks are skipped (causal halves
//   the work), unless a row of the block has no unmasked key at all.
// wgmma, TMA and warp specialisation are for a later version.
//
// Optional output for training: the log-sum-exp of each query row, f32
// (BH, Sq), m + log(l) in the natural-log domain, written only when its
// pointer is not null (the serving path passes null). A row with no
// unmasked key keeps m = -1e30 and gets exactly -1e30: the backward
// (flash_attention_bwd.cu) reads that value as "every key masked" and gives
// the row the forward's average over all Sk keys.
//
// Entry point: `flash_attention_fwd`, a plain C function that launches on
// the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per kv tile
constexpr int NTHREADS = 256;  // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

struct Params {
  int seq_q;
  int seq_k;
  int group;        // query heads per kv head
  int causal;
  int has_window;
  long long window;
  long long q_offset;
  float scale;
  float* lse;       // (BH, seq_q) or null
};

// Copies `valid` rows of hd elements (contiguous, 16-byte aligned) into
// shared memory as f32 with row stride `ld`; rows valid..rows-1 become 0.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int rows,
                                          int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = HD / VEC;
  for (int idx = threadIdx.x; idx < rows * VPR; idx += NTHREADS) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * VEC;
    float* d = dst + r * ld + c;
    if (r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)r * HD + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int t = 0; t < VEC; ++t) d[t] = to_float(e[t]);
    } else {
#pragma unroll
      for (int t = 0; t < VEC; ++t) d[t] = 0.f;
    }
  }
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

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, Params p) {
  constexpr int LDQ = HD + 1;
  constexpr int LDK = HD + 1;
  constexpr int LDV = HD;
  constexpr int LDP = BK + 1;
  constexpr int DC = HD / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDK;
  float* Ps = Vs + BK * LDV;

  const int row = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int kv_row = row / p.group;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // owns query rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // owns key columns / output columns tx + 16*j
  const int q_valid = min(BQ, p.seq_q - q0);

  const T* kb = k + (size_t)kv_row * p.seq_k * HD;
  const T* vb = v + (size_t)kv_row * p.seq_k * HD;
  load_tile<T, HD>(Qs, LDQ, q + ((size_t)row * p.seq_q + q0) * HD, BQ, q_valid);

  const long long qpos_first = p.q_offset + q0;
  const long long qpos_last = qpos_first + q_valid - 1;
  long long lo_first, hi_first, lo_last, hi_last;
  const bool live_first = key_range(p, qpos_first, lo_first, hi_first);
  const bool live_last = key_range(p, qpos_last, lo_last, hi_last);
  int kt_begin = 0;
  int kt_end = (p.seq_k + BK - 1) / BK;
  if (live_first && live_last) {  // every row has a key: skip tiles all rows mask
    kt_begin = (int)(lo_first / BK);
    kt_end = (int)(hi_last / BK) + 1;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const int k_valid = min(BK, p.seq_k - k0);
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, HD>(Ks, LDK, kb + (size_t)k0 * HD, BK, k_valid);
    load_tile<T, HD>(Vs, LDV, vb + (size_t)k0 * HD, BK, k_valid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = qpos_first + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + tx + 16 * j;
        if (kk < p.seq_k) {
          const bool keep = (!p.causal || qpos >= kk) && (!p.has_window || qpos - kk < p.window);
          s[i][j] = keep ? s[i][j] * p.scale : NEG_INF;
          mx = fmaxf(mx, s[i][j]);
        }
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + tx + 16 * j;
        const float pv = kk < p.seq_k ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * LDP + tx + 16 * j] = pv;
        sum += pv;
      }
      l[i] = l[i] * alpha + group16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < k_valid; ++c) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) vv[jd] = Vs[c * LDV + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jd = 0; jd < DC; ++jd) acc[i][jd] = fmaf(pv[i], vv[jd], acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < q_valid) {
      const float denom = fmaxf(l[i], 1e-30f);
      T* out = o + ((size_t)row * p.seq_q + q0 + r) * HD;
#pragma unroll
      for (int c = 0; c < DC; ++c) out[tx + 16 * c] = from_float<T>(acc[i][c] / denom);
      if (p.lse != nullptr && tx == 0)
        p.lse[(size_t)row * p.seq_q + q0 + r] =
            m[i] < 0.5f * NEG_INF ? NEG_INF : m[i] + logf(l[i]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh,
                   const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.seq_q + BQ - 1) / BQ);
  flash_fwd_kernel<T, HD><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int head_dim, const void* q, const void* k, const void* v, void* o,
                      int bh, const Params& p, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, k, v, o, bh, p, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, p, stream);
    case 112: return launch<T, 112>(q, k, v, o, bh, p, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (bh, seq_q, head_dim); k, v
// (bh / group, seq_k, head_dim); o like q. All contiguous, 16-byte aligned.
// lse: f32 (bh, seq_q), or null.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int dtype, int bh, int seq_q, int seq_k, int head_dim,
                                   int group, int causal, int has_window, long long window,
                                   long long q_offset, float scale, void* stream) {
  if (bh <= 0 || seq_q <= 0 || seq_k <= 0 || group <= 0 || bh % group) {
    return cudaErrorInvalidValue;
  }
  if ((seq_q + BQ - 1) / BQ > 65535) return cudaErrorInvalidValue;
  Params p{seq_q, seq_k, group, causal, has_window, window, q_offset, scale, lse};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_hd<float>(head_dim, q, k, v, o, bh, p, st);
    case 1: return launch_hd<__nv_bfloat16>(head_dim, q, k, v, o, bh, p, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
