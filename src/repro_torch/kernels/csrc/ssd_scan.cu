// Mamba2 SSD chunk scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` driven by `ssd_scan`
// (src/repro/kernels/ssd_scan.py). Same function: x (BH, S, P), dt (BH, S)
// f32, A (BH,) f32, B and C (BH / heads_per_group, S, N); y (BH, S, P) in
// x's dtype and the final state (BH, N, P) f32. Per chunk of Q tokens, with
// an (N, P) f32 state carried from chunk to chunk:
//   cum = cumsum(dt * A)                   (restarts at 0 in every chunk)
//   W[i][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for j <= i, else 0
//   y = W X + exp(cum) * (C state)
//   state' = exp(total) * state + B^T (exp(total - cum) * dt * X)
// Row `bh` reads group row `bh / heads_per_group` of B and C, so the
// per-head broadcast of the groups is never materialised. A null initial
// state means zeros. Q is any length from 1 to 128, N at most 128, P any.
//
// What bounds it on this card: at the serving shape (BH 256, S 1024, P 64,
// N 128, Q 128, bf16) the function is 21.5 GFLOP against 78.6 MB of traffic
// (x and y, B and C once per group, dt, the state), so with tensor cores
// the bytes bound it (~23.5 us at 3.35 TB/s). This first version does its
// products in f32 on the CUDA cores (one code path for f32 and bf16 inputs),
// so it is bounded by the f32 FMA rate (~0.3 ms for the work at 67 TFLOP/s)
// and the shared-memory reads that feed it. What the design does about that:
// * one block per (row, 64-column P-tile) loops over the chunks itself and
//   keeps the state in shared memory for the whole loop; nothing carries
//   across blocks and only the last chunk writes the state out. A P-tile
//   recomputes the Q x Q scores C.B^T of its row;
// * a chunk's B (Q x N) and X tile (Q x 64) sit in shared memory as f32; C
//   and the weights W are walked in strips of 32 rows, so shared memory
//   stays at 162 KB (Q = N = 128) instead of the 256 KB of whole tiles;
// * each strip computes only the column groups of W that its rows keep
//   (j <= i), which skips about 3/8 of C.B^T and of W X;
// * masked entries of W are selected to 0, never multiplied by a 0/1 mask:
//   exp(cum_i - cum_j) overflows to inf for j > i, and inf * 0 is NaN;
// * exp(cum_i - cum_j) and exp(total - cum_j) are formed from differences,
//   never as products of exp(cum_i) and exp(-cum_j), which overflow;
// * cum is a sequential f32 sum without FMA contraction, the order of the
//   plain version's cumsum on the CPU.
// wgmma, TMA and a split of P-tiles that shares the scores are for a later
// version.
//
// Entry point: `ssd_scan_fwd`, a plain C function that launches on the
// given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int QMAX = 128;       // longest chunk
constexpr int NMAX = 128;       // largest state size N
constexpr int PT = 64;          // P columns per block
constexpr int RS = 32;          // rows of C and W per strip
constexpr int NTHREADS = 256;   // 8 warps: ty = warp, tx = lane
constexpr int NROW = NMAX / 8;  // state rows per thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

struct Params {
  int seq;
  int p;
  int n;
  int chunk;
  int heads_per_group;
};

// Shared memory, in floats: B (Q x (N+1)), X (Q x PT), state (N x PT),
// a strip of C (RS x N) and of W (RS x Q), and dt, cum, the state-update
// weights and exp(cum) (QMAX each).
size_t smem_bytes(int q, int n) {
  return sizeof(float) *
         ((size_t)q * (n + 1) + (size_t)q * PT + (size_t)n * PT + RS * n + RS * q + 4 * QMAX);
}

// W for one strip of rows i0 .. i0+31, column groups 0 .. KM-1 (columns
// tx + 32k): thread (ty, tx) owns rows ty*4 .. ty*4+3.
template <int KM>
__device__ __forceinline__ void strip_weights(const float* Bs, int ldb, const float* Cs,
                                              float* Ws, const float* cum, const float* dts,
                                              int n, int q, int i0, int rows, int jmax,
                                              int ty, int tx) {
  float s[4][KM];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < KM; ++k) s[i][k] = 0.f;
  const float* brow[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) brow[k] = Bs + min(tx + 32 * k, q - 1) * ldb;
#pragma unroll 4
  for (int kk = 0; kk < n; ++kk) {
    float cv[4], bv[KM];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * n + kk];  // broadcast
#pragma unroll
    for (int k = 0; k < KM; ++k) bv[k] = brow[k][kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < KM; ++k) s[i][k] = fmaf(cv[i], bv[k], s[i][k]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int gi = i0 + r;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      const int j = tx + 32 * k;
      if (j < jmax) {
        float w = 0.f;
        if (r < rows && j <= gi) w = s[i][k] * expf(cum[gi] - cum[j]) * dts[j];
        Ws[r * q + j] = w;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ init,
                    T* __restrict__ y, float* __restrict__ state_out, Params p) {
  const int q = p.chunk;
  const int n = p.n;
  const int ldb = n + 1;  // odd pitch: lanes reading B rows hit distinct banks

  extern __shared__ float smem[];
  float* Bs = smem;
  float* Xs = Bs + q * ldb;
  float* Ss = Xs + q * PT;
  float* Cs = Ss + n * PT;
  float* Ws = Cs + RS * n;
  float* dts = Ws + RS * q;
  float* cum = dts + QMAX;
  float* wd = cum + QMAX;
  float* ecum = wd + QMAX;

  const int row = blockIdx.x;
  const int p0 = blockIdx.y * PT;
  const int pw = min(PT, p.p - p0);  // valid columns of this tile
  const int tid = threadIdx.x;
  const int ty = tid >> 5;
  const int tx = tid & 31;
  const float a = A[row];

  const size_t row_off = (size_t)row * p.seq * p.p + p0;
  const T* xr = x + row_off;
  T* yr = y + row_off;
  const float* dtr = dt + (size_t)row * p.seq;
  const size_t grow = row / p.heads_per_group;
  const T* br = Bm + grow * p.seq * n;
  const T* cr = Cm + grow * p.seq * n;

  for (int idx = tid; idx < n * PT; idx += NTHREADS) {
    const int r = idx / PT;
    const int c = idx % PT;
    Ss[idx] = (init != nullptr && c < pw) ? init[((size_t)row * n + r) * p.p + p0 + c] : 0.f;
  }

  const int nc = p.seq / q;
  for (int ci = 0; ci < nc; ++ci) {
    const size_t t0 = (size_t)ci * q;
    __syncthreads();  // the previous chunk no longer reads B, X or the scalars
    for (int idx = tid; idx < q * n; idx += NTHREADS) {
      Bs[(idx / n) * ldb + idx % n] = to_float(br[t0 * n + idx]);
    }
    for (int idx = tid; idx < q * PT; idx += NTHREADS) {
      const int j = idx / PT;
      const int c = idx % PT;
      Xs[idx] = c < pw ? to_float(xr[(t0 + j) * p.p + c]) : 0.f;
    }
    if (tid < q) dts[tid] = dtr[t0 + tid];
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int j = 0; j < q; ++j) {
        s = __fadd_rn(s, __fmul_rn(dts[j], a));
        cum[j] = s;
      }
    }
    __syncthreads();
    const float total = cum[q - 1];
    if (tid < q) {
      wd[tid] = expf(total - cum[tid]) * dts[tid];
      ecum[tid] = expf(cum[tid]);
    }

    // y, one strip of 32 rows at a time (reads the state before the update)
    for (int i0 = 0; i0 < q; i0 += RS) {
      const int rows = min(RS, q - i0);
      const int jmax = min(q, i0 + RS);  // columns any row of the strip keeps
      for (int idx = tid; idx < RS * n; idx += NTHREADS) {
        Cs[idx] = idx < rows * n ? to_float(cr[(t0 + i0) * n + idx]) : 0.f;
      }
      __syncthreads();
      switch ((jmax + 31) / 32) {
        case 1: strip_weights<1>(Bs, ldb, Cs, Ws, cum, dts, n, q, i0, rows, jmax, ty, tx); break;
        case 2: strip_weights<2>(Bs, ldb, Cs, Ws, cum, dts, n, q, i0, rows, jmax, ty, tx); break;
        case 3: strip_weights<3>(Bs, ldb, Cs, Ws, cum, dts, n, q, i0, rows, jmax, ty, tx); break;
        default: strip_weights<4>(Bs, ldb, Cs, Ws, cum, dts, n, q, i0, rows, jmax, ty, tx); break;
      }
      __syncthreads();

      float acc[4][2], sc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < 2; ++m) acc[i][m] = sc[i][m] = 0.f;
#pragma unroll 4
      for (int j = 0; j < jmax; ++j) {
        float wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = Ws[(ty * 4 + i) * q + j];  // broadcast
        const float x0 = Xs[j * PT + tx];
        const float x1 = Xs[j * PT + tx + 32];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(wv[i], x0, acc[i][0]);
          acc[i][1] = fmaf(wv[i], x1, acc[i][1]);
        }
      }
#pragma unroll 4
      for (int kk = 0; kk < n; ++kk) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * n + kk];  // broadcast
        const float s0 = Ss[kk * PT + tx];
        const float s1 = Ss[kk * PT + tx + 32];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[i][0] = fmaf(cv[i], s0, sc[i][0]);
          sc[i][1] = fmaf(cv[i], s1, sc[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r < rows) {
          const float e = ecum[i0 + r];
          T* out = yr + (t0 + i0 + r) * p.p;
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int c = tx + 32 * m;
            if (c < pw) out[c] = from_float<T>(acc[i][m] + sc[i][m] * e);
          }
        }
      }
      __syncthreads();  // the strip's C and W, and the state, are read
    }

    // state' = exp(total) * state + B^T (wd * X): thread owns rows ty + 8a
    float st[NROW][2];
#pragma unroll
    for (int r = 0; r < NROW; ++r) st[r][0] = st[r][1] = 0.f;
#pragma unroll 2
    for (int j = 0; j < q; ++j) {
      const float w = wd[j];
      const float x0 = Xs[j * PT + tx] * w;
      const float x1 = Xs[j * PT + tx + 32] * w;
      const float* bj = Bs + j * ldb;
#pragma unroll
      for (int r = 0; r < NROW; ++r) {
        const int kk = ty + 8 * r;
        if (kk < n) {
          const float bv = bj[kk];  // broadcast
          st[r][0] = fmaf(bv, x0, st[r][0]);
          st[r][1] = fmaf(bv, x1, st[r][1]);
        }
      }
    }
    const float et = expf(total);
    const bool last = ci == nc - 1;
#pragma unroll
    for (int r = 0; r < NROW; ++r) {
      const int kk = ty + 8 * r;
      if (kk < n) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int c = tx + 32 * m;
          const float v = st[r][m] + et * Ss[kk * PT + c];
          Ss[kk * PT + c] = v;
          if (last && c < pw) state_out[((size_t)row * n + kk) * p.p + p0 + c] = v;
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* init, void* y, void* state, int bh, const Params& p,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(p.chunk, p.n);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.p + PT - 1) / PT);
  ssd_scan_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(state), p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y). x (bh, seq, p); dt
// (bh, seq) f32; A (bh,) f32; B, C (bh / heads_per_group, seq, n);
// init_state null or (bh, n, p) f32; y like x; state_out (bh, n, p) f32.
// All contiguous. seq must be a multiple of chunk.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, const void* init_state, void* y, void* state_out,
                            int dtype, int bh, int seq, int p, int n, int chunk,
                            int heads_per_group, void* stream) {
  if (bh <= 0 || seq <= 0 || p <= 0 || n <= 0 || n > NMAX || chunk <= 0 || chunk > QMAX ||
      seq % chunk || heads_per_group <= 0 || bh % heads_per_group) {
    return cudaErrorInvalidValue;
  }
  if ((p + PT - 1) / PT > 65535) return cudaErrorInvalidValue;
  const Params prm{seq, p, n, chunk, heads_per_group};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, dt, A, B, C, init_state, y, state_out, bh, prm, st);
    case 1: return launch<__nv_bfloat16>(x, dt, A, B, C, init_state, y, state_out, bh, prm, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
