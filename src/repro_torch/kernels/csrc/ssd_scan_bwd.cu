// Backward of the Mamba2 SSD chunk scan for Hopper (sm_90a), CUDA C++.
//
// No Pallas kernel is replaced: the reference trains through XLA's autodiff
// of its pure-jnp `ssd_chunked` (src/repro/models/ssm.py:106). This is the
// gradient of K3's forward (csrc/ssd_scan.cu, csrc/ssd_scan_sm90.cu) written
// out by hand; `ssd_scan_bwd_plain` in kernels/ssd_scan.py is the same
// arithmetic in PyTorch. Per row, per chunk of Q steps with s_in the state
// entering it, cum = cumsum(dt * A), T = cum[Q-1], L[i][j] = exp(cum_i -
// cum_j) for j <= i, G = C B^T, W = G o L o dt_j and u = exp(T - cum) o dt:
//   y     = W X + diag(exp(cum)) C s_in
//   s_out = exp(T) s_in + B^T diag(u) X
// and, carrying dS from the last chunk to the first:
//   dX    = W^T dY + diag(u) B dS_out
//   dG    = (dY X^T) o L o dt_j        dC += dG B       dB += dG^T C
//   dC   += diag(exp(cum)) dY s_in^T   dB += diag(u) X dS_out^T
//   dS_in = exp(T) dS_out + C^T diag(exp(cum)) dY
// The gradient of cum (from L, exp(cum), u and exp(T)) folds into ddt and dA
// through the within-chunk reverse cumulative sum; ddt also takes W's dt_j
// and u's dt.
//
// What bounds it on this card: at mamba2-1.3b's training shape (BH 256,
// S 1024, P 64, N 128, Q 128, 64 heads a group) the least work is 34.5
// GFLOP (the Q x Q products over the Q(Q+1)/2 pairs the mask keeps, C B^T
// once per group row, plus 10 Q N P per row and chunk) against ~107 MB of
// inputs and gradients, so with tensor cores the operations bound it
// (~0.035 ms at 989 TFLOP/s). This first version does every product in f32
// on the CUDA cores, one code path for f32 and bf16, so the f32 FMA rate and
// the shared-memory reads that feed it bound it. What the design does:
// * one block per (row, 64-column P-tile) runs the forward state pass
//   (states entering each chunk to an f32 scratch, the state itself in
//   registers), then walks the chunks in reverse with dS (N x 64) in shared
//   memory; nothing carries across blocks;
// * each chunk is two phases over strips of 32 rows. Phase R keeps B and X
//   resident and walks strips of rows i of C and dY: it recomputes G and
//   dY X^T for the strip, forms dG, and finishes dC's rows and the row sums
//   of dL o L. Phase C keeps C and dY resident and walks strips of rows j of
//   B and X: it recomputes the transposed strip, finishes dX's and dB's rows,
//   the column sums of dL o L and W's part of ddt. Each phase reduces over
//   the dimension it holds whole, so no Q x Q matrix is kept and no sum
//   crosses threads other than by warp shuffles in a fixed order; the price
//   is C B^T and dY X^T formed twice (~23% more than forming each once);
// * shared memory is the larger phase plus dS and the per-step scalars:
//   212 KB at Q = N = 128, under the 227 KB a block may take;
// * dB, dC, ddt and dA leave as f32 partials per (row, P-tile); a second
//   pass sums them over the P-tiles and the heads_per_group rows that read
//   each group row, in a fixed order, and rounds to the inputs' dtype. No
//   atomics: two runs give the same bits;
// * masked entries are selected to 0 and exp is never evaluated there:
//   exp(cum_i - cum_j) overflows to inf above the diagonal at A of -1..-16,
//   and inf * 0 is NaN. Every exponential is of a difference (<= 0);
// * cum is summed in f64 and rounded once to f32 (the plain version's
//   `_cum`): at |cum| of a few thousand (A to -16 over 128 steps) the order
//   of an f32 sum alone moves ddt by ~1e-4 of its largest entry. The
//   reverse cumulative sum of cum's gradient and dA, whose terms cancel,
//   are f64 sums too (one thread, Q steps a chunk).
// wgmma, TMA and sharing C B^T across a group's heads are for a later
// version.
//
// Entry point: `ssd_scan_bwd`, a plain C function that launches both passes
// on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int QMAX = 128;       // longest chunk
constexpr int NMAX = 128;       // largest state size N
constexpr int PT = 64;          // P columns per block
constexpr int LDP = PT + 1;     // pitch of a P-tile read down its rows
constexpr int RS = 32;          // rows per strip
constexpr int NTHREADS = 256;   // 8 warps: ty = warp, tx = lane
constexpr int NROW = NMAX / 8;  // state rows per thread
constexpr int NSCALAR = 10;     // per-step scalar vectors of QMAX

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Params {
  int bh;
  int seq;
  int p;
  int n;
  int chunk;
  int heads_per_group;
  int tiles;
};

// Shared memory, in floats: dS (N x LDP), the scalar vectors and 32 words
// for block sums, then the larger of the two phases' buffers.
size_t phase_r_floats(int q, int n) {
  return (size_t)q * (n + 1) + (size_t)q * LDP + (size_t)n * LDP + RS * n + RS * PT + RS * q;
}
size_t phase_c_floats(int q, int n) {
  return (size_t)q * (n + 1) + (size_t)q * LDP + RS * n + RS * PT + 2 * RS * q;
}
size_t smem_bytes(int q, int n) {
  const size_t r = phase_r_floats(q, n), c = phase_c_floats(q, n);
  return sizeof(float) * ((size_t)n * LDP + NSCALAR * QMAX + 32 + (r > c ? r : c));
}

// rows [r0, r0 + rows) of a (., n) matrix into shared memory with pitch ld;
// rows past `rows` up to `pad` are zero
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, int rows, int pad,
                                          int n, int tid) {
  for (int idx = tid; idx < pad * n; idx += NTHREADS) {
    const int r = idx / n;
    const int c = idx % n;
    dst[r * ld + c] = r < rows ? to_float(src[(size_t)r * n + c]) : 0.f;
  }
}

// rows of a P-tile (pw valid columns of a row of p) with pitch ld
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int rows, int pad,
                                          int p, int pw, int tid) {
  for (int idx = tid; idx < pad * PT; idx += NTHREADS) {
    const int r = idx / PT;
    const int c = idx % PT;
    dst[r * ld + c] = (r < rows && c < pw) ? to_float(src[(size_t)r * p + c]) : 0.f;
  }
}

// Phase R, one strip of rows i0 .. i0+31 over column groups j = tx + 32k,
// k < KM: G and dW = dY X^T, then dG to shared memory and the row sums of
// dL o L = dW o W. Thread (ty, tx) owns rows ty*4 .. ty*4+3.
template <int KM>
__device__ __forceinline__ void strip_rows(const float* Bs, int ldb, const float* Xs,
                                           const float* Cst, const float* dYst, float* dGst,
                                           const float* cum, const float* dts, float* rowR,
                                           int n, int q, int i0, int rows, int jmax, int ty,
                                           int tx) {
  float g[4][KM], w[4][KM];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < KM; ++k) g[i][k] = w[i][k] = 0.f;
  int jr[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) jr[k] = min(tx + 32 * k, q - 1);
#pragma unroll 4
  for (int kk = 0; kk < n; ++kk) {
    float cv[4], bv[KM];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = Cst[(ty * 4 + i) * n + kk];  // broadcast
#pragma unroll
    for (int k = 0; k < KM; ++k) bv[k] = Bs[jr[k] * ldb + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < KM; ++k) g[i][k] = fmaf(cv[i], bv[k], g[i][k]);
  }
#pragma unroll 4
  for (int c = 0; c < PT; ++c) {
    float dv[4], xv[KM];
#pragma unroll
    for (int i = 0; i < 4; ++i) dv[i] = dYst[(ty * 4 + i) * PT + c];  // broadcast
#pragma unroll
    for (int k = 0; k < KM; ++k) xv[k] = Xs[jr[k] * LDP + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < KM; ++k) w[i][k] = fmaf(dv[i], xv[k], w[i][k]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int gi = i0 + r;
    float rsum = 0.f;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      const int j = tx + 32 * k;
      float dg = 0.f;
      if (r < rows && j <= gi) {  // select: exp is never taken above the diagonal
        const float l = expf(cum[gi] - cum[j]);
        const float wij = g[i][k] * l * dts[j];
        dg = w[i][k] * l * dts[j];
        rsum += w[i][k] * wij;
      }
      if (j < jmax) dGst[r * q + j] = dg;
    }
    rsum = warp_sum(rsum);
    if (tx == 0 && r < rows) rowR[gi] = rsum;
  }
}

// Phase C, one strip of rows j0 .. j0+31 (the columns of W) over row groups
// i = tx + 32(kb + k), k < KM: the transposed G and dW, then W and dG to
// shared memory, the column sums of dL o L and W's part of ddt,
// sum_i dW[i][j] G[i][j] L[i][j].
template <int KM>
__device__ __forceinline__ void strip_cols(const float* Cs, int ldc, const float* dYs,
                                           const float* Bst, const float* Xst, float* Wst,
                                           float* dGst, const float* cum, const float* dts,
                                           float* colR, float* ddtL, int n, int q, int j0,
                                           int rows, int kb, int ty, int tx) {
  float g[4][KM], w[4][KM];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < KM; ++k) g[i][k] = w[i][k] = 0.f;
  int ir[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) ir[k] = min(tx + 32 * (kb + k), q - 1);
#pragma unroll 4
  for (int kk = 0; kk < n; ++kk) {
    float bv[4], cv[KM];
#pragma unroll
    for (int i = 0; i < 4; ++i) bv[i] = Bst[(ty * 4 + i) * n + kk];  // broadcast
#pragma unroll
    for (int k = 0; k < KM; ++k) cv[k] = Cs[ir[k] * ldc + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < KM; ++k) g[i][k] = fmaf(bv[i], cv[k], g[i][k]);
  }
#pragma unroll 4
  for (int c = 0; c < PT; ++c) {
    float xv[4], dv[KM];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = Xst[(ty * 4 + i) * PT + c];  // broadcast
#pragma unroll
    for (int k = 0; k < KM; ++k) dv[k] = dYs[ir[k] * LDP + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < KM; ++k) w[i][k] = fmaf(xv[i], dv[k], w[i][k]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int gj = j0 + r;
    float csum = 0.f, dl = 0.f;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      const int ii = tx + 32 * (kb + k);
      float wv = 0.f, dg = 0.f;
      if (r < rows && ii < q && ii >= gj) {  // select, as in phase R
        const float l = expf(cum[ii] - cum[gj]);
        const float gl = g[i][k] * l;
        wv = gl * dts[gj];
        dg = w[i][k] * l * dts[gj];
        csum += w[i][k] * wv;
        dl += w[i][k] * gl;
      }
      if (ii < q) {
        Wst[r * q + ii] = wv;
        dGst[r * q + ii] = dg;
      }
    }
    csum = warp_sum(csum);
    dl = warp_sum(dl);
    if (tx == 0 && r < rows) {
      colR[gj] = csum;
      ddtL[gj] = dl;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    ssd_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const T* __restrict__ Bm,
                        const T* __restrict__ Cm, const float* __restrict__ init,
                        const T* __restrict__ dy, const float* __restrict__ dfinal,
                        T* __restrict__ dx, float* __restrict__ dinit,
                        float* __restrict__ states, float* __restrict__ part_bc,
                        float* __restrict__ part_dt, Params p) {
  const int q = p.chunk;
  const int n = p.n;
  const int ld = n + 1;  // odd pitch: lanes reading B or C rows hit distinct banks
  const int nc = p.seq / q;

  extern __shared__ float smem[];
  float* dS = smem;
  float* dts = dS + n * LDP;
  float* cum = dts + QMAX;
  float* decay = cum + QMAX;
  float* u = decay + QMAX;
  float* ecum = u + QMAX;
  float* rowR = ecum + QMAX;
  float* inter = rowR + QMAX;
  float* colR = inter + QMAX;
  float* v = colR + QMAX;
  float* ddtL = v + QMAX;
  float* red = ddtL + QMAX;
  float* big = red + 32;                 // B (phase R, state pass) or C (phase C)
  float* tile = big + q * ld;            // X (phase R, state pass) or dY (phase C)
  float* Sin = tile + q * LDP;           // phase R
  float* Cst = Sin + n * LDP;
  float* dYst = Cst + RS * n;
  float* dGr = dYst + RS * PT;
  float* Bst = tile + q * LDP;           // phase C
  float* Xst = Bst + RS * n;
  float* Wst = Xst + RS * PT;
  float* dGc = Wst + RS * q;

  const int row = blockIdx.x;
  const int ti = blockIdx.y;
  const int p0 = ti * PT;
  const int pw = min(PT, p.p - p0);
  const int tid = threadIdx.x;
  const int ty = tid >> 5;
  const int tx = tid & 31;
  const float a = A[row];

  const size_t row_off = (size_t)row * p.seq * p.p + p0;
  const T* xr = x + row_off;
  const T* dyr = dy + row_off;
  T* dxr = dx + row_off;
  const float* dtr = dt + (size_t)row * p.seq;
  const size_t grow = row / p.heads_per_group;
  const T* br = Bm + grow * p.seq * n;
  const T* cr = Cm + grow * p.seq * n;
  float* st_base = states + ((size_t)row * p.tiles + ti) * nc * n * PT;
  const size_t part = ((size_t)row * p.tiles + ti) * p.seq * n;
  float* pb = part_bc + part;
  float* pc = part_bc + (size_t)p.bh * p.tiles * p.seq * n + part;
  float* pdt = part_dt + ((size_t)row * p.tiles + ti) * (p.seq + 1);

  // the step scalars of chunk ci: dt, cum (f64 sum, rounded once),
  // exp(T - cum), u and exp(cum); ends synchronised
  auto scalars = [&](int ci) {
    if (tid < q) dts[tid] = dtr[(size_t)ci * q + tid];
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
      for (int j = 0; j < q; ++j) {
        s += (double)__fmul_rn(dts[j], a);
        cum[j] = (float)s;
      }
    }
    __syncthreads();
    if (tid < q) {
      const float d = expf(cum[q - 1] - cum[tid]);
      decay[tid] = d;
      u[tid] = d * dts[tid];
      ecum[tid] = expf(cum[tid]);
    }
    __syncthreads();
  };

  // -- forward state pass: the state entering each chunk, to scratch --------
  float st[NROW][2];
#pragma unroll
  for (int r = 0; r < NROW; ++r) {
    const int kk = ty + 8 * r;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int c = tx + 32 * m;
      st[r][m] = (init != nullptr && kk < n && c < pw)
                     ? init[((size_t)row * n + kk) * p.p + p0 + c] : 0.f;
    }
  }
  for (int ci = 0; ci < nc; ++ci) {
    const size_t t0 = (size_t)ci * q;
    __syncthreads();  // the previous chunk no longer reads B, X or the scalars
    load_rows(big, ld, br + t0 * n, q, q, n, tid);
    load_tile(tile, LDP, xr + t0 * p.p, q, q, p.p, pw, tid);
    scalars(ci);
    float* out = st_base + (size_t)ci * n * PT;
    float acc[NROW][2];
#pragma unroll
    for (int r = 0; r < NROW; ++r) {
      const int kk = ty + 8 * r;
      acc[r][0] = acc[r][1] = 0.f;
      if (kk < n) {
        out[kk * PT + tx] = st[r][0];
        out[kk * PT + tx + 32] = st[r][1];
      }
    }
#pragma unroll 2
    for (int j = 0; j < q; ++j) {
      const float w = u[j];
      const float x0 = tile[j * LDP + tx] * w;
      const float x1 = tile[j * LDP + tx + 32] * w;
      const float* bj = big + j * ld;
#pragma unroll
      for (int r = 0; r < NROW; ++r) {
        const int kk = ty + 8 * r;
        if (kk < n) {
          const float bv = bj[kk];  // broadcast
          acc[r][0] = fmaf(bv, x0, acc[r][0]);
          acc[r][1] = fmaf(bv, x1, acc[r][1]);
        }
      }
    }
    const float et = expf(cum[q - 1]);
#pragma unroll
    for (int r = 0; r < NROW; ++r)
#pragma unroll
      for (int m = 0; m < 2; ++m) st[r][m] = acc[r][m] + et * st[r][m];
  }

  // -- reverse pass ---------------------------------------------------------
  for (int idx = tid; idx < n * PT; idx += NTHREADS) {
    const int r = idx / PT;
    const int c = idx % PT;
    dS[r * LDP + c] = (dfinal != nullptr && c < pw)
                          ? dfinal[((size_t)row * n + r) * p.p + p0 + c] : 0.f;
  }
  double da = 0.0;  // thread 0: this row's dA over the chunks
  for (int ci = nc - 1; ci >= 0; --ci) {
    const size_t t0 = (size_t)ci * q;
    const float* s_in = st_base + (size_t)ci * n * PT;
    __syncthreads();  // the previous chunk is done with every buffer
    // phase R: B, X and s_in resident; strips of C and dY
    load_rows(big, ld, br + t0 * n, q, q, n, tid);
    load_tile(tile, LDP, xr + t0 * p.p, q, q, p.p, pw, tid);
    for (int idx = tid; idx < n * PT; idx += NTHREADS) {
      Sin[(idx / PT) * LDP + idx % PT] = s_in[idx];
    }
    scalars(ci);
    for (int i0 = 0; i0 < q; i0 += RS) {
      const int rows = min(RS, q - i0);
      const int jmax = min(q, i0 + RS);  // columns any row of the strip keeps
      load_rows(Cst, n, cr + (t0 + i0) * n, rows, RS, n, tid);
      load_tile(dYst, PT, dyr + (t0 + i0) * p.p, rows, RS, p.p, pw, tid);
      __syncthreads();
      switch ((jmax + 31) / 32) {
        case 1: strip_rows<1>(big, ld, tile, Cst, dYst, dGr, cum, dts, rowR, n, q, i0, rows, jmax, ty, tx); break;
        case 2: strip_rows<2>(big, ld, tile, Cst, dYst, dGr, cum, dts, rowR, n, q, i0, rows, jmax, ty, tx); break;
        case 3: strip_rows<3>(big, ld, tile, Cst, dYst, dGr, cum, dts, rowR, n, q, i0, rows, jmax, ty, tx); break;
        default: strip_rows<4>(big, ld, tile, Cst, dYst, dGr, cum, dts, rowR, n, q, i0, rows, jmax, ty, tx); break;
      }
      __syncthreads();
      // dC rows = dG B + diag(exp(cum)) dY s_in^T; cum's part from exp(cum)
      float acc[4][4], sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[i][m] = sc[i][m] = 0.f;
      int nn[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) nn[m] = min(tx + 32 * m, n - 1);
#pragma unroll 4
      for (int j = 0; j < jmax; ++j) {
        float gv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = dGr[(ty * 4 + i) * q + j];  // broadcast
#pragma unroll
        for (int m = 0; m < 4; ++m) bv[m] = big[j * ld + nn[m]];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[i][m] = fmaf(gv[i], bv[m], acc[i][m]);
      }
#pragma unroll 4
      for (int c = 0; c < PT; ++c) {
        float dv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = dYst[(ty * 4 + i) * PT + c];  // broadcast
#pragma unroll
        for (int m = 0; m < 4; ++m) sv[m] = Sin[nn[m] * LDP + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int m = 0; m < 4; ++m) sc[i][m] = fmaf(dv[i], sv[m], sc[i][m]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const int gi = i0 + r;
        const float e = r < rows ? ecum[gi] : 0.f;
        float dcum = 0.f;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int col = tx + 32 * m;
          if (r < rows && col < n) {
            const float s = sc[i][m] * e;
            pc[(t0 + gi) * n + col] = acc[i][m] + s;
            dcum += Cst[r * n + col] * s;
          }
        }
        dcum = warp_sum(dcum);
        if (tx == 0 && r < rows) inter[gi] = dcum;
      }
      __syncthreads();  // the strip's C, dY and dG are read
    }

    // phase C: C and dY resident; strips of B and X
    load_rows(big, ld, cr + t0 * n, q, q, n, tid);
    load_tile(tile, LDP, dyr + t0 * p.p, q, q, p.p, pw, tid);
    for (int j0 = 0; j0 < q; j0 += RS) {
      const int rows = min(RS, q - j0);
      const int kb = j0 / 32;
      load_rows(Bst, n, br + (t0 + j0) * n, rows, RS, n, tid);
      load_tile(Xst, PT, xr + (t0 + j0) * p.p, rows, RS, p.p, pw, tid);
      __syncthreads();
      switch ((q + 31) / 32 - kb) {
        case 1: strip_cols<1>(big, ld, tile, Bst, Xst, Wst, dGc, cum, dts, colR, ddtL, n, q, j0, rows, kb, ty, tx); break;
        case 2: strip_cols<2>(big, ld, tile, Bst, Xst, Wst, dGc, cum, dts, colR, ddtL, n, q, j0, rows, kb, ty, tx); break;
        case 3: strip_cols<3>(big, ld, tile, Bst, Xst, Wst, dGc, cum, dts, colR, ddtL, n, q, j0, rows, kb, ty, tx); break;
        default: strip_cols<4>(big, ld, tile, Bst, Xst, Wst, dGc, cum, dts, colR, ddtL, n, q, j0, rows, kb, ty, tx); break;
      }
      __syncthreads();
      const int ilo = 32 * kb;
      // dX rows = W^T dY + diag(u) B dS_out, this tile's columns
      {
        float acc[4][2], sb[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int m = 0; m < 2; ++m) acc[i][m] = sb[i][m] = 0.f;
#pragma unroll 4
        for (int ii = ilo; ii < q; ++ii) {
          float wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = Wst[(ty * 4 + i) * q + ii];  // broadcast
          const float d0 = tile[ii * LDP + tx];
          const float d1 = tile[ii * LDP + tx + 32];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] = fmaf(wv[i], d0, acc[i][0]);
            acc[i][1] = fmaf(wv[i], d1, acc[i][1]);
          }
        }
#pragma unroll 4
        for (int kk = 0; kk < n; ++kk) {
          float bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) bv[i] = Bst[(ty * 4 + i) * n + kk];  // broadcast
          const float s0 = dS[kk * LDP + tx];
          const float s1 = dS[kk * LDP + tx + 32];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sb[i][0] = fmaf(bv[i], s0, sb[i][0]);
            sb[i][1] = fmaf(bv[i], s1, sb[i][1]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          if (r < rows) {
            const float uj = u[j0 + r];
            T* out = dxr + (t0 + j0 + r) * p.p;
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const int c = tx + 32 * m;
              if (c < pw) out[c] = from_float<T>(acc[i][m] + uj * sb[i][m]);
            }
          }
        }
      }
      // dB rows = dG^T C + diag(u) X dS_out^T; u's gradient v = B . (X dS^T)
      {
        float acc[4][4], mx[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[i][m] = mx[i][m] = 0.f;
        int nn[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) nn[m] = min(tx + 32 * m, n - 1);
#pragma unroll 4
        for (int ii = ilo; ii < q; ++ii) {
          float gv[4], cv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[i] = dGc[(ty * 4 + i) * q + ii];  // broadcast
#pragma unroll
          for (int m = 0; m < 4; ++m) cv[m] = big[ii * ld + nn[m]];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int m = 0; m < 4; ++m) acc[i][m] = fmaf(gv[i], cv[m], acc[i][m]);
        }
#pragma unroll 4
        for (int c = 0; c < PT; ++c) {
          float xv[4], sv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = Xst[(ty * 4 + i) * PT + c];  // broadcast
#pragma unroll
          for (int m = 0; m < 4; ++m) sv[m] = dS[nn[m] * LDP + c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int m = 0; m < 4; ++m) mx[i][m] = fmaf(xv[i], sv[m], mx[i][m]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          const int gj = j0 + r;
          const float uj = r < rows ? u[gj] : 0.f;
          float vj = 0.f;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int col = tx + 32 * m;
            if (r < rows && col < n) {
              pb[(t0 + gj) * n + col] = acc[i][m] + uj * mx[i][m];
              vj += Bst[r * n + col] * mx[i][m];
            }
          }
          vj = warp_sum(vj);
          if (tx == 0 && r < rows) v[gj] = vj;
        }
      }
      __syncthreads();  // the strip's B, X, W and dG are read
    }

    // dS_in = exp(T) dS_out + C^T diag(exp(cum)) dY, and exp(T)'s gradient
    // sum(dS_out o s_in); thread owns state rows ty + 8r, columns tx, tx+32
    {
      const float et = expf(cum[q - 1]);
      float acc[NROW][2];
      float ts = 0.f;
#pragma unroll
      for (int r = 0; r < NROW; ++r) {
        const int kk = ty + 8 * r;
        acc[r][0] = acc[r][1] = 0.f;
        if (kk < n) {
          ts = fmaf(dS[kk * LDP + tx], s_in[kk * PT + tx], ts);
          ts = fmaf(dS[kk * LDP + tx + 32], s_in[kk * PT + tx + 32], ts);
        }
      }
#pragma unroll 2
      for (int i = 0; i < q; ++i) {
        const float e = ecum[i];
        const float d0 = tile[i * LDP + tx] * e;
        const float d1 = tile[i * LDP + tx + 32] * e;
        const float* ci_row = big + i * ld;
#pragma unroll
        for (int r = 0; r < NROW; ++r) {
          const int kk = ty + 8 * r;
          if (kk < n) {
            const float cv = ci_row[kk];  // broadcast
            acc[r][0] = fmaf(cv, d0, acc[r][0]);
            acc[r][1] = fmaf(cv, d1, acc[r][1]);
          }
        }
      }
      ts = warp_sum(ts);
      if (tx == 0) red[ty] = ts;
      __syncthreads();  // every thread has read dS_out
#pragma unroll
      for (int r = 0; r < NROW; ++r) {
        const int kk = ty + 8 * r;
        if (kk < n) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int c = tx + 32 * m;
            dS[kk * LDP + c] = acc[r][m] + et * dS[kk * LDP + c];
          }
        }
      }
      __syncthreads();  // rowR, inter, colR, v, ddtL and red are complete
    }

    // cum's gradient, its reverse cumulative sum, ddt and dA
    if (tid == 0) {
      float ts = 0.f;
      for (int w = 0; w < NTHREADS / 32; ++w) ts += red[w];
      float dT = expf(cum[q - 1]) * ts;
      for (int j = 0; j < q; ++j) dT = fmaf(u[j], v[j], dT);
      double rc = 0.0;
      for (int i = q - 1; i >= 0; --i) {
        float dc = rowR[i] - colR[i] + inter[i] - u[i] * v[i];
        if (i == q - 1) dc += dT;
        rc += (double)dc;
        pdt[t0 + i] = ddtL[i] + decay[i] * v[i] + a * (float)rc;
        da += (double)dts[i] * rc;
      }
    }
  }
  __syncthreads();
  if (dinit != nullptr) {
    for (int idx = tid; idx < n * PT; idx += NTHREADS) {
      const int r = idx / PT;
      const int c = idx % PT;
      if (c < pw) dinit[((size_t)row * n + r) * p.p + p0 + c] = dS[r * LDP + c];
    }
  }
  if (tid == 0) pdt[p.seq] = (float)da;
}

// The partials summed in a fixed order: dB and dC over the heads of a group
// and the P-tiles, rounded to T; ddt over the P-tiles; dA over the P-tiles.
template <typename T>
__global__ void ssd_scan_bwd_sum_kernel(const float* __restrict__ part_bc,
                                        const float* __restrict__ part_dt, T* __restrict__ dB,
                                        T* __restrict__ dC, float* __restrict__ ddt,
                                        float* __restrict__ dA, Params p) {
  const int g = p.heads_per_group;
  const size_t per = (size_t)p.seq * p.n;                      // one row's (S, N)
  const size_t bc = (size_t)(p.bh / g) * per;                  // one of dB, dC
  const size_t total = 2 * bc + (size_t)p.bh * p.seq + p.bh;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    if (idx < 2 * bc) {
      const size_t which = idx / bc;
      const size_t rem = idx % bc;
      const size_t grow = rem / per;
      const size_t tn = rem % per;
      const float* src = part_bc + which * (size_t)p.bh * p.tiles * per;
      float s = 0.f;
      for (int h = 0; h < g; ++h)
        for (int t = 0; t < p.tiles; ++t)
          s += src[((grow * g + h) * p.tiles + t) * per + tn];
      (which ? dC : dB)[rem] = from_float<T>(s);
    } else {
      const size_t r = idx - 2 * bc;
      const bool is_da = r >= (size_t)p.bh * p.seq;
      const size_t row = is_da ? r - (size_t)p.bh * p.seq : r / p.seq;
      const size_t t = is_da ? (size_t)p.seq : r % p.seq;
      float s = 0.f;
      for (int k = 0; k < p.tiles; ++k) s += part_dt[(row * p.tiles + k) * (p.seq + 1) + t];
      if (is_da) dA[row] = s;
      else ddt[r] = s;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* init, const void* dy, const void* dfinal, void* dx, void* ddt,
                   void* dA, void* dB, void* dC, void* dinit, void* states, void* part_bc,
                   void* part_dt, const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.chunk, p.n);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.bh, p.tiles);
  ssd_scan_bwd_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(init),
      static_cast<const T*>(dy), static_cast<const float*>(dfinal), static_cast<T*>(dx),
      static_cast<float*>(dinit), static_cast<float*>(states), static_cast<float*>(part_bc),
      static_cast<float*>(part_dt), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_scan_bwd_sum_kernel<T><<<132 * 8, 256, 0, stream>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_dt),
      static_cast<T*>(dB), static_cast<T*>(dC), static_cast<float*>(ddt),
      static_cast<float*>(dA), p);
  return cudaGetLastError();
}

}  // namespace

// The P columns one block takes; the wrapper sizes its scratch with it.
extern "C" int ssd_scan_bwd_p_tile() { return PT; }

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, dx, dB, dC). x, dy, dx
// (bh, seq, p); dt, ddt (bh, seq) f32; A, dA (bh,) f32; B, C, dB, dC
// (bh / heads_per_group, seq, n); init and dinit null or (bh, n, p) f32,
// both or neither; dfinal null (zero) or (bh, n, p) f32. Scratch, f32:
// states (bh, tiles, seq / chunk, n, 64), part_bc (2, bh, tiles, seq, n),
// part_dt (bh, tiles, seq + 1), tiles = ceil(p / 64). All contiguous.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, const void* init_state, const void* dy,
                            const void* dfinal, void* dx, void* ddt, void* dA, void* dB,
                            void* dC, void* dinit, void* states, void* part_bc, void* part_dt,
                            int dtype, int bh, int seq, int p, int n, int chunk,
                            int heads_per_group, void* stream) {
  if (bh <= 0 || seq <= 0 || p <= 0 || n <= 0 || n > NMAX || chunk <= 0 || chunk > QMAX ||
      seq % chunk || heads_per_group <= 0 || bh % heads_per_group ||
      (init_state == nullptr) != (dinit == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int tiles = (p + PT - 1) / PT;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const Params prm{bh, seq, p, n, chunk, heads_per_group, tiles};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, dt, A, B, C, init_state, dy, dfinal, dx, ddt, dA, dB, dC, dinit,
                           states, part_bc, part_dt, prm, st);
    case 1:
      return launch<__nv_bfloat16>(x, dt, A, B, C, init_state, dy, dfinal, dx, ddt, dA, dB, dC,
                                   dinit, states, part_bc, part_dt, prm, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
