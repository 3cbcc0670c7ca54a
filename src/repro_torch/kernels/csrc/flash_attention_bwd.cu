// Flash attention backward for Hopper (sm_90a), CUDA C++.
//
// The gradient of the function K2 computes (flash_attention.cu,
// flash_attention_sm90.cu; the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py). The TPU package has no backward
// kernel: it trains through the pure-jnp `blockwise_attention`
// (src/repro/models/attention.py) and XLA differentiates that loop. Here the
// forward is a kernel that autograd cannot see, so its gradient is a kernel
// too, behind `FlashAttentionFn` (kernels/flash_attention.py).
//
// Same contract as the forward: q (BH, Sq, hd), k/v (BH/g, Sk, hd), GQA row
// i reads kv row i / g; scale hd^-0.5; causal masking with q_offset (may be
// negative), an optional sliding window, ragged Sq and Sk, Sq != Sk; head
// dims 32, 64, 112, 128; f32 or bf16 inputs, every sum in f32, each
// gradient rounded once to the input dtype. From the forward it takes o and
// the log-sum-exp `lse` (f32 (BH, Sq), natural log) and recomputes
// P = exp(S * scale - lse); with D = rowsum(dO * O):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
// A masked score is the constant -1e30, so dS is 0 there. A row with no
// unmasked key (lse = -1e30, see the forward) averaged V over all Sk keys:
// its P is 1/Sk on every key, which reaches dV, and its dS is 0.
//
// Three launches, no atomics, so every run gives the same bits:
// 1. `dot_kernel`: D = rowsum(dO * O), one warp per query row;
// 2. `dkdv_kernel`: one block per (kv row, 64-key tile) keeps K and V in
//    shared memory and walks the q tiles of all g query heads of its kv
//    head, summing dK and dV in registers (GQA's sum over heads included);
// 3. `dq_kernel`: one block per (q row, 64-query tile) keeps Q and dO and
//    walks the kv tiles, summing dQ in registers.
// S and dP are computed twice (once in 2, once in 3): 14 products of
// (Sq x Sk x hd) where a fused kernel with atomics does 10.
//
// What bounds it on this card: at phi4-mini's training shape (q 96 x 1024 x
// 128 bf16, k/v 32 x 1024 x 128, GQA 3, causal) the backward needs ~64
// GFLOP (2.5x the forward's) against ~150 MB of traffic, far above the
// ridge, so the best kernel is bound by the bf16 tensor-core rate (~65 us).
// This first version does every product on the CUDA cores in f32, as the
// forward's first version did, so the f32 FMA rate and the shared-memory
// reads feeding it bound it. What the design does about that:
// * tiles of 64 rows sit in shared memory as f32, rows padded by one word
//   so the column walks hit distinct banks; each thread owns a 4 x 4 block
//   of S and dP (one pass over hd computes both, 32 FMAs for 16 reads) and a
//   4 x (hd/16) block of its gradients;
// * q tiles (in 2) and kv tiles (in 3) that the masks remove from the whole
//   tile are skipped, so a causal backward does about half the work;
//   a tile that holds a row with no unmasked key is never skipped.
// wgmma, TMA and warp specialisation are for a later version.
//
// Entry point: `flash_attention_bwd`, a plain C function that launches the
// three kernels on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 256;  // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
};

// `valid` rows of HD elements (contiguous, 16-byte aligned) into shared
// memory as f32 with row stride `ld`; rows valid..rows-1 become 0.
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

__device__ __forceinline__ bool keep(const Params& p, long long qpos, long long key) {
  return (!p.causal || qpos >= key) && (!p.has_window || qpos - key < p.window);
}

template <int HD>
constexpr size_t smem_dkdv() {  // K, V, Q, dO, P, dS, lse, D
  return sizeof(float) * (2 * (BK + BQ) * (HD + 1) + 2 * BQ * (BK + 1) + 2 * BQ);
}

template <int HD>
constexpr size_t smem_dq() {    // Q, dO, K, V, dS, lse, D
  return sizeof(float) * (2 * (BQ + BK) * (HD + 1) + BQ * (BK + 1) + 2 * BQ);
}

// ---- 1. D = rowsum(dO * O) -------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
    dot_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dsum,
               long long n_rows) {
  const long long r = (long long)blockIdx.x * (NTHREADS / 32) + threadIdx.x / 32;
  if (r >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const T* a = o + r * HD;
  const T* b = dout + r * HD;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc = fmaf(to_float(a[d]), to_float(b[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[r] = acc;
}

// S = Q K^T and dP = dO V^T for this thread's 4 x 4 block: query rows
// ty*4 + i of (Qs, dOs), keys tx + 16 j of (Ks, Vs).
template <int HD>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs, const float* Ks,
                                       const float* Vs, int ty, int tx, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int LD = HD + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty * 4 + i) * LD + d];
      gv[i] = dOs[(ty * 4 + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * LD + d];
      vv[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
}

// P and dS of the 4 x 4 block from S, dP, the rows' lse and D; query rows
// q0 + ty*4 + i, keys k0 + tx + 16 j.
__device__ __forceinline__ void softmax_grad(const Params& p, int q0, int k0, int ty, int tx,
                                             const float* lse_s, const float* d_s,
                                             const float (&s)[4][4], const float (&dp)[4][4],
                                             float (&pr)[4][4], float (&ds)[4][4]) {
  const float inv_sk = 1.f / (float)p.seq_k;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const long long qpos = p.q_offset + q0 + r;
    const float lse = lse_s[r];
    const bool row_ok = q0 + r < p.seq_q;
    const bool dead = lse < 0.5f * NEG_INF;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      float pv = 0.f, dv = 0.f;
      if (row_ok && key < p.seq_k) {
        if (keep(p, qpos, key)) {
          pv = expf(s[i][j] * p.scale - lse);
          dv = pv * (dp[i][j] - d_s[r]);
        } else if (dead) {
          pv = inv_sk;
        }
      }
      pr[i][j] = pv;
      ds[i][j] = dv;
    }
  }
}

// ---- 2. dK and dV ----------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
                Params p) {
  constexpr int LD = HD + 1;
  constexpr int LDP = BK + 1;
  constexpr int DC = HD / 16;

  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDP;
  float* lse_s = dSs + BQ * LDP;
  float* d_s = lse_s + BQ;

  const int kv_row = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int k_valid = min(BK, p.seq_k - k0);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // keys ty*4 .. ty*4+3 of dK, dV; query rows of S
  const int tx = tid & 15;  // columns tx + 16*c of dK, dV; keys of S

  load_tile<T, HD>(Ks, LD, k + ((size_t)kv_row * p.seq_k + k0) * HD, BK, k_valid);
  load_tile<T, HD>(Vs, LD, v + ((size_t)kv_row * p.seq_k + k0) * HD, BK, k_valid);

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  const int q_tiles = (p.seq_q + BQ - 1) / BQ;
  for (int h = 0; h < p.group; ++h) {
    const int row = kv_row * p.group + h;
    for (int qt = 0; qt < q_tiles; ++qt) {
      const int q0 = qt * BQ;
      const int q_valid = min(BQ, p.seq_q - q0);
      long long lo_first, hi_first, lo_last, hi_last;
      const bool live_first = key_range(p, p.q_offset + q0, lo_first, hi_first);
      const bool live_last = key_range(p, p.q_offset + q0 + q_valid - 1, lo_last, hi_last);
      // every row has a key and none of them is in this tile: nothing to add
      if (live_first && live_last && (hi_last < k0 || lo_first > k0 + k_valid - 1)) continue;

      __syncthreads();  // the previous q tile is no longer read
      const size_t base = (size_t)row * p.seq_q + q0;
      load_tile<T, HD>(Qs, LD, q + base * HD, BQ, q_valid);
      load_tile<T, HD>(dOs, LD, dout + base * HD, BQ, q_valid);
      for (int r = tid; r < BQ; r += NTHREADS) {
        lse_s[r] = r < q_valid ? lse[base + r] : 0.f;
        d_s[r] = r < q_valid ? dsum[base + r] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4], pr[4][4], ds[4][4];
      scores<HD>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
      softmax_grad(p, q0, k0, ty, tx, lse_s, d_s, s, dp, pr, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(ty * 4 + i) * LDP + tx + 16 * j] = pr[i][j];
          dSs[(ty * 4 + i) * LDP + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's query rows
#pragma unroll 4
      for (int i = 0; i < q_valid; ++i) {
        float pv[4], sv[4], gv[DC], qv[DC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = Ps[i * LDP + ty * 4 + a];
          sv[a] = dSs[i * LDP + ty * 4 + a];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          gv[c] = dOs[i * LD + tx + 16 * c];
          qv[c] = Qs[i * LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            acc_v[a][c] = fmaf(pv[a], gv[c], acc_v[a][c]);
            acc_k[a][c] = fmaf(sv[a], qv[c], acc_k[a][c]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty * 4 + a;
    if (r < k_valid) {
      const size_t off = ((size_t)kv_row * p.seq_k + k0 + r) * HD;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dk[off + tx + 16 * c] = from_float<T>(acc_k[a][c] * p.scale);
        dv[off + tx + 16 * c] = from_float<T>(acc_v[a][c]);
      }
    }
  }
}

// ---- 3. dQ -----------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ dsum, T* __restrict__ dq, Params p) {
  constexpr int LD = HD + 1;
  constexpr int LDP = BK + 1;
  constexpr int DC = HD / 16;

  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* lse_s = dSs + BQ * LDP;
  float* d_s = lse_s + BQ;

  const int row = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int kv_row = row / p.group;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // query rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // keys tx + 16*j of S; columns tx + 16*c of dQ
  const int q_valid = min(BQ, p.seq_q - q0);

  const size_t base = (size_t)row * p.seq_q + q0;
  load_tile<T, HD>(Qs, LD, q + base * HD, BQ, q_valid);
  load_tile<T, HD>(dOs, LD, dout + base * HD, BQ, q_valid);
  for (int r = tid; r < BQ; r += NTHREADS) {
    lse_s[r] = r < q_valid ? lse[base + r] : 0.f;
    d_s[r] = r < q_valid ? dsum[base + r] : 0.f;
  }

  // a row with no unmasked key has dS = 0 everywhere, so only the tiles the
  // live rows reach matter; with every row dead there is nothing to add
  const long long qpos_first = p.q_offset + q0;
  long long lo_first, hi_first, lo_last, hi_last;
  const bool live_first = key_range(p, qpos_first, lo_first, hi_first);
  const bool live_last = key_range(p, qpos_first + q_valid - 1, lo_last, hi_last);
  int kt_begin = 0;
  int kt_end = (p.seq_k + BK - 1) / BK;
  if (live_first && live_last) {
    kt_begin = (int)(lo_first / BK);
    kt_end = (int)(hi_last / BK) + 1;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const T* kb = k + (size_t)kv_row * p.seq_k * HD;
  const T* vb = v + (size_t)kv_row * p.seq_k * HD;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const int k_valid = min(BK, p.seq_k - k0);
    __syncthreads();  // the previous tile's K and dS are no longer read
    load_tile<T, HD>(Ks, LD, kb + (size_t)k0 * HD, BK, k_valid);
    load_tile<T, HD>(Vs, LD, vb + (size_t)k0 * HD, BK, k_valid);
    __syncthreads();

    float s[4][4], dp[4][4], pr[4][4], ds[4][4];
    scores<HD>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    softmax_grad(p, q0, k0, ty, tx, lse_s, d_s, s, dp, pr, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(ty * 4 + i) * LDP + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // dQ += dS K over the tile's keys
#pragma unroll 4
    for (int j = 0; j < k_valid; ++j) {
      float sv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty * 4 + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < q_valid) {
      T* out = dq + (base + r) * HD;
#pragma unroll
      for (int c = 0; c < DC; ++c) out[tx + 16 * c] = from_float<T>(acc[i][c] * p.scale);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* dsum, void* dq, void* dk, void* dv, int bh,
                   const Params& p, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const long long n_rows = (long long)bh * p.seq_q;
  const long long dot_blocks = (n_rows + NTHREADS / 32 - 1) / (NTHREADS / 32);
  dot_kernel<T, HD><<<(unsigned)dot_blocks, NTHREADS, 0, stream>>>(
      static_cast<const T*>(o), tdo, dsum, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_kv = smem_dkdv<HD>();
  err = cudaFuncSetAttribute(dkdv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(bh / p.group, (p.seq_k + BK - 1) / BK);
  dkdv_kernel<T, HD><<<grid_kv, NTHREADS, smem_kv, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_q = smem_dq<HD>();
  err = cudaFuncSetAttribute(dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q(bh, (p.seq_q + BQ - 1) / BQ);
  dq_kernel<T, HD><<<grid_q, NTHREADS, smem_q, stream>>>(tq, tk, tv, tdo, lse, dsum,
                                                         static_cast<T*>(dq), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int head_dim, const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* dsum, void* dq, void* dk,
                      void* dv, int bh, const Params& p, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, bh, p, stream);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, bh, p, stream);
    case 112: return launch<T, 112>(q, k, v, o, dout, lse, dsum, dq, dk, dv, bh, p, stream);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, bh, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, o, dout, dq (bh, seq_q, head_dim);
// k, v, dk, dv (bh / group, seq_k, head_dim); lse and the scratch dsum f32
// (bh, seq_q). All contiguous, 16-byte aligned.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* dsum, void* dq,
                                   void* dk, void* dv, int dtype, int bh, int seq_q, int seq_k,
                                   int head_dim, int group, int causal, int has_window,
                                   long long window, long long q_offset, float scale,
                                   void* stream) {
  if (bh <= 0 || seq_q <= 0 || seq_k <= 0 || group <= 0 || bh % group) {
    return cudaErrorInvalidValue;
  }
  if ((seq_q + BQ - 1) / BQ > 65535 || (seq_k + BK - 1) / BK > 65535) {
    return cudaErrorInvalidValue;
  }
  Params p{seq_q, seq_k, group, causal, has_window, window, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_hd<float>(head_dim, q, k, v, o, dout, lse, dsum, dq, dk, dv, bh, p, st);
    case 1:
      return launch_hd<__nv_bfloat16>(head_dim, q, k, v, o, dout, lse, dsum, dq, dk, dv, bh, p,
                                      st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
